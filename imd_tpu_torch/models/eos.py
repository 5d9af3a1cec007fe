"""Electron EOS (port of imd_tpu/models/eos.py): the closed-form
free-electron gas (``FEGEos``, :42-120) and the reference's tabulated EOS
(``TabulatedEOS``, :123-236).

Units match the reference: Ce in eV/(eV A^3), U in eV/atom, T in eV, dens
in kg/m^3, ne in 1/m^3.  kB*1e28 is folded host-side: kB^2 ~ 1.9e-46
underflows float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from imd_tpu_torch import units
from imd_tpu_torch.models import widerange as wr

EV_TO_K = wr.EV_TO_K
_KB28 = wr.BOLTZMAN * wr.N28


def _cv_mix_si(ne, T_K):
    """Mazhukin mixed heat capacity [J/(K m^3)] (imd_ttm.c:3388-3390)."""
    ne28 = ne * (1.0 / wr.N28)
    EF_eV = wr.fermi_E_eV(ne)
    T_eV = T_K / wr.EV_TO_K
    cv_class = ne28 * (1.5 * _KB28)
    cv_deg = (math.pi ** 2 / 2.0 * _KB28) * ne28 * T_eV / torch.clamp(
        EF_eV, min=1e-10)
    return 1.0 / torch.sqrt(1.0 / cv_deg ** 2 + 1.0 / cv_class ** 2)


def _tstar_K(ne):
    """Crossover temperature T* where Cv_deg == Cv_class: 3 EF/(pi^2 kB)."""
    return wr.fermi_E_eV(ne) * (3.0 * wr.EV_TO_K / math.pi ** 2)


@dataclasses.dataclass(frozen=True)
class FEGEos:
    """Closed-form free-electron-gas EOS; ``atomic_mass`` in amu."""
    atomic_mass: float = 26.9815

    def ce(self, dens, ne, Te_eV):
        """C_e in eV/(eV A^3) (FEG_cve_from_ne_te)."""
        cv = _cv_mix_si(ne, torch.clamp(Te_eV * EV_TO_K, min=1.0))
        return cv * EV_TO_K * 1e-30 * units.J_TO_EV

    def u_from_te(self, dens, ne, Te_eV):
        """Internal energy per atom [eV/atom] from T_e [eV]."""
        ts = _tstar_K(ne)
        x = Te_eV * EV_TO_K / ts
        n_atoms = torch.clamp(dens, min=1e-30) * (
            1.0 / (self.atomic_mass * wr.AMU * wr.N28))
        ne28 = ne * (1.0 / wr.N28)
        kb_ev = 1.0 / EV_TO_K
        return (ne28 / n_atoms) * (1.5 * kb_ev) * ts * (
            torch.sqrt(1.0 + x * x) - 1.0)

    def pe(self, dens, ne, Te_eV):
        """Electron pressure [eV/A^3]: the free-electron gas's P_e = (2/3)
        u_vol (EOS_pe_from_r_te stand-in, imd_ttm.c:2639)."""
        ts = _tstar_K(ne)
        x = Te_eV * EV_TO_K / ts
        ne28 = ne * (1.0 / wr.N28)
        kb_ev = 1.0 / EV_TO_K
        u_a3 = ne28 * (1e28 * 1e-30) * (1.5 * kb_ev) * ts * (
            torch.sqrt(1.0 + x * x) - 1.0)
        return (2.0 / 3.0) * u_a3

    def te_from_u(self, dens, ne, U_eV_atom):
        """Inverse of u_from_te, closed form, returns T_e [eV]."""
        ts = _tstar_K(ne)
        n_atoms = torch.clamp(dens, min=1e-30) * (
            1.0 / (self.atomic_mass * wr.AMU * wr.N28))
        ne28 = torch.clamp(ne * (1.0 / wr.N28), min=1e-30)
        kb_ev = 1.0 / EV_TO_K
        y = torch.clamp(U_eV_atom, min=0.0) * n_atoms / (
            ne28 * (1.5 * kb_ev) * ts) + 1.0
        T_K = ts * torch.sqrt(torch.clamp(y * y - 1.0, min=0.0))
        return T_K / EV_TO_K


@dataclasses.dataclass(eq=False)
class TabulatedEOS:
    """Regular-grid (rho, sqrt(T_e)) EOS tables with bilinear
    interpolation (imd_tpu/models/eos.py:123-236; the reference's EOS_*
    accessors, imd_ttm.c:2483-2699).  The reference's scattered Delaunay
    tables are resampled onto a regular grid at load time on the host;
    T(U) is a bisection of fixed depth in place of Brent (fminbnd3.c:6)."""
    rho_grid: torch.Tensor      # [nr] kg/m^3
    tsq_grid: torch.Tensor      # [nt] sqrt(T[K]) samples
    ee: torch.Tensor            # [nr, nt] J/kg (the reference's unit)
    cve: torch.Tensor           # [nr, nt] J/(K kg)
    atomic_mass: float

    BISECTIONS = 40

    def _interp2(self, table, r, tsq):
        rg, tg = self.rho_grid, self.tsq_grid
        r = torch.minimum(torch.maximum(r, rg[0]), rg[-1])
        tsq = torch.minimum(torch.maximum(tsq, tg[0]), tg[-1])
        ir = torch.clamp(torch.searchsorted(rg, r.contiguous()) - 1, 0,
                         len(rg) - 2)
        it = torch.clamp(torch.searchsorted(tg, tsq.contiguous()) - 1, 0,
                         len(tg) - 2)
        fr = (r - rg[ir]) / (rg[ir + 1] - rg[ir])
        ft = (tsq - tg[it]) / (tg[it + 1] - tg[it])
        v00 = table[ir, it]
        v01 = table[ir, it + 1]
        v10 = table[ir + 1, it]
        v11 = table[ir + 1, it + 1]
        return ((1 - fr) * (1 - ft) * v00 + (1 - fr) * ft * v01
                + fr * (1 - ft) * v10 + fr * ft * v11)

    def ce(self, dens, ne, Te_eV):
        """C_e in eV/(eV A^3): the table's J/(K kg) times dens, with the
        reference's chain (imd_ttm.c:2586-2589)."""
        tsq = torch.sqrt(torch.clamp(Te_eV, min=1e-10) * EV_TO_K)
        cve_kg = self._interp2(self.cve, dens, tsq)
        return cve_kg * dens * (EV_TO_K * 1e-30 * units.J_TO_EV)

    def u_from_te(self, dens, ne, Te_eV):
        """Internal energy per atom [eV/atom] from T_e [eV]."""
        tsq = torch.sqrt(torch.clamp(Te_eV, min=1e-10) * EV_TO_K)
        ee = self._interp2(self.ee, dens, tsq)
        return ee * self.atomic_mass * wr.AMU * units.J_TO_EV

    def pe(self, dens, ne, Te_eV):
        """Electron pressure [eV/A^3]: the free-electron gas's, as
        imd_tpu's tabulated EOS keeps it (EOS_pe_from_r_te stand-in,
        imd_ttm.c:2639)."""
        return FEGEos(atomic_mass=self.atomic_mass).pe(dens, ne, Te_eV)

    def te_from_u(self, dens, ne, U_eV_atom):
        """T_e [eV] from U: BISECTIONS fixed bisection steps on sqrt(T)
        over the table's range (no host read)."""
        target = U_eV_atom / (self.atomic_mass * wr.AMU * units.J_TO_EV)
        lo = torch.full_like(target, 1.0) * self.tsq_grid[0]
        hi = torch.full_like(target, 1.0) * self.tsq_grid[-1]
        for _ in range(self.BISECTIONS):
            mid = 0.5 * (lo + hi)
            too_low = self._interp2(self.ee, dens, mid) < target
            lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi,
                                                                mid)
        tsq = 0.5 * (lo + hi)
        return tsq * tsq / EV_TO_K

    @classmethod
    def load(cls, cve_path: str, ee_path: str, atomic_mass: float,
             nr: int = 128, nt: int = 128, dtype=torch.float32,
             device="cuda") -> "TabulatedEOS":
        """The reference's scattered ``x y z`` tables (nn_read_table,
        imd_interpol.c:1174: a two-line header ``is js`` / ``xmin xmax ymin
        ymax``, or none), resampled with scipy's linear ``griddata`` onto
        an ``nr`` x ``nt`` grid, NaN (outside the hull) -> 0.
        EOS_cve_from_r_te.txt: rho [kg/m^3], T_e [K], cve;
        EOS_ee_from_r_tesqrt.txt: rho, sqrt(T_e), ee [J/kg]."""
        import numpy as np
        from scipy.interpolate import griddata

        def load_xyz(path):
            with open(path) as f:
                first = f.readline().split()
            return np.loadtxt(path, skiprows=2 if len(first) == 2 else 0)

        cve_raw = load_xyz(cve_path)
        ee_raw = load_xyz(ee_path)
        rho = np.linspace(min(cve_raw[:, 0].min(), ee_raw[:, 0].min()),
                          max(cve_raw[:, 0].max(), ee_raw[:, 0].max()), nr)
        tsq_e = np.linspace(ee_raw[:, 1].min(), ee_raw[:, 1].max(), nt)
        RR, TT = np.meshgrid(rho, tsq_e, indexing="ij")
        ee = griddata(ee_raw[:, :2], ee_raw[:, 2], (RR, TT), method="linear")
        cve_pts = np.column_stack([cve_raw[:, 0], np.sqrt(cve_raw[:, 1])])
        cve = griddata(cve_pts, cve_raw[:, 2], (RR, TT), method="linear")

        def t(a):
            return torch.as_tensor(np.nan_to_num(a, nan=0.0),
                                   dtype=dtype).to(device)
        return cls(rho_grid=t(rho), tsq_grid=t(tsq_e), ee=t(ee), cve=t(cve),
                   atomic_mass=float(atomic_mass))
