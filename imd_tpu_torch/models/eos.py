"""Closed-form free-electron-gas EOS (port of imd_tpu/models/eos.py:42-120).

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
