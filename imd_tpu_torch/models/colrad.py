"""COLRAD: collisional-radiative plasma kinetics on the TTM grid (port of
imd_tpu/models/colrad.py; the reference's imd_colrad.c).

Per FD cell, the populations of the excited levels of the charge stages
Z = 0..MAXLEVEL, n_e and T_e evolve as a stiff ODE over each MD step.  The
rate coefficients are tables over log T_e built on the host
(``build_tables``: van Regemorter excitation with its detailed-balance
reverse, Lotz ionization with the Saha three-body reverse, Kramers
radiative recombination; or, with ``rates="ref"``, the reference's Mott /
Fermi-Dirac integrals of models/colrad_ref.py) and interpolated on the
device.  The integrator (``make_colrad_step``) is imd_tpu's adaptive
backward Euler with a damped Newton solve, batched over the cells.

Torch re-design:

- imd_tpu's ``vmap`` of a ``while_loop`` runs until every cell is done,
  the carry of a finished cell held by its own ``cond``.  Here the loop is
  a Python loop of batched tries, each cell's carry updated under
  ``torch.where`` on that cell's ``cond`` (t < dt_s (1 - 1e-9) and k <
  max_tries).  Since a finished cell is masked, the loop may run a few
  tries past the last cell's end without changing a bit: it reads "any
  cell still running" to the host after the fewest tries a cell can take
  and then every CHECK_EVERY tries, each read counted in
  ``StepCounters.host_syncs`` (tries in ``colrad_tries``).
- The RHS runs batched over the cells, and the Newton Jacobian is written
  out (``_network``'s derivatives of each transition's flow and power,
  assembled through dense incidence matrices) where imd_tpu takes
  ``jax.jacfwd`` under ``vmap``: torch.func's transforms cost ~50 ms of
  host time a Newton iteration, the written-out one a few ms.  The systems
  are solved with ``torch.linalg.solve_ex`` (no check, so no host read).
- The repeated-index scatters of the RHS are ``index_add``, as imd_tpu's
  ``.at[].add``.

Units: densities in N28 = 1e28/m^3 inside the solve, rate coefficients
premultiplied by N28 and the thermal de Broglie volume folded on the host,
so that nothing underflows float32.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from imd_tpu_torch import units

KB = units.KB_J
EV = units.EV_TO_J
EMASS = units.EMASS_KG
H_PLANCK = 6.62607015e-34
RY_EV = 13.605693122994

N28 = 1e28
_LAM3_N28 = (H_PLANCK ** 2 / (2.0 * math.pi * EMASS * KB
                              * units.EV_TO_K)) ** 1.5 * N28  # *Te^-1.5
# eV*N28/s -> IMD power density eV/(A^3 time-unit)
P_N28_TO_IMD = N28 * 1e-30 * units.IMD_TIME_S
_R0_28_A = (3.0 / (4.0 * math.pi * N28)) ** (1.0 / 3.0) * 1e10
_DEBYE_28_A = math.sqrt(units.EPS0 * EV / (N28 * units.ECHARGE_C ** 2)) \
    * 1e10
# Al ionization energies chi_z (eV), NIST ground states
AL_CHI = (5.98577, 18.82855, 28.44764, 119.9924, 153.8252)

# power-density diagnostic column order (the reference's .ttm extra
# COLRAD columns, imd_ttm.c:1885-1897)
POWER_KEYS = ("P_EE", "P_EI", "P_MPI2", "P_MPI3", "P_RR")


class States(NamedTuple):
    """Flattened level set over charge stages.

    z[i]: charge stage of level i; e_ev[i]: energy above the stage
    ground (eV); g[i]: degeneracy; chi_ev[z]: stage ionization energy;
    ground[z]: index of the stage-z ground level (-1 if absent).
    """
    z: np.ndarray
    e_ev: np.ndarray
    g: np.ndarray
    chi_ev: np.ndarray
    ground: np.ndarray


def aluminium_states(max_z: int = 3, nlev: int = 4) -> States:
    """Hydrogen-like excited ladder per stage: E_n relative to the stage
    ground approaches chi_z as (1 - 1/n^2); g_n = 2 n^2."""
    zs, es, gs = [], [], []
    ground = np.full(max_z + 2, -1, np.int64)
    for z in range(max_z + 1):
        ground[z] = len(zs)
        chi = AL_CHI[z]
        for k in range(nlev):
            n = k + 1
            zs.append(z)
            es.append(chi * (1.0 - 1.0 / n ** 2))
            gs.append(2.0 * n ** 2)
    # bare stage max_z+1: single "ground" with no excited structure
    ground[max_z + 1] = len(zs)
    zs.append(max_z + 1)
    es.append(0.0)
    gs.append(1.0)
    return States(np.asarray(zs), np.asarray(es, float),
                  np.asarray(gs, float),
                  np.asarray(AL_CHI[:max_z + 2], float), ground)


def read_states(dirname: str, element: str = "Al",
                chi_fallback=AL_CHI) -> States:
    """Read the reference's atomic state tables (colrad_read_states,
    imd_colrad.c:523): one ``{element}{z}_states.txt`` per charge stage,
    six columns per line; col 2 = level energy (eV, cumulative: the
    cross-stage differences are ionization energies), col 3 = statistical
    weight.  Per-stage energies relative to the stage ground, stage
    ionization energies from the ground-to-ground deltas; the stage after
    the last file gets ``chi_fallback``."""
    stages = []
    z = 0
    while True:
        path = os.path.join(dirname, f"{element}{z}_states.txt")
        if not os.path.exists(path):
            break
        rows = np.loadtxt(path, ndmin=2)
        if rows.shape[1] != 6:
            raise ValueError(
                f"{path}: expected 6 columns, got {rows.shape[1]}")
        stages.append(rows)
        z += 1
    if not stages:
        raise FileNotFoundError(
            f"no {element}0_states.txt under {dirname}")
    max_z = len(stages) - 1
    zs, es, gs = [], [], []
    ground = np.full(max_z + 2, -1, np.int64)
    chi = []
    for zi, rows in enumerate(stages):
        e0 = rows[0, 2]
        ground[zi] = len(zs)
        for r in rows:
            zs.append(zi)
            es.append(float(r[2] - e0))
            gs.append(float(r[3]))
        if zi + 1 < len(stages):
            chi.append(float(stages[zi + 1][0, 2] - e0))
        else:
            chi.append(float(chi_fallback[min(zi,
                                              len(chi_fallback) - 1)]))
    ground[max_z + 1] = len(zs)
    zs.append(max_z + 1)
    es.append(0.0)
    gs.append(1.0)
    chi.append(float(chi_fallback[min(max_z + 1, len(chi_fallback) - 1)]))
    return States(np.asarray(zs), np.asarray(es, float),
                  np.asarray(gs, float), np.asarray(chi, float), ground)


# ---------------------------------------------------------------------------
# rate coefficients (host-side tables over log T_e)
# ---------------------------------------------------------------------------

def _k_exc(de_ev, te_ev):
    """van Regemorter electron-impact excitation [m^3/s] with f ~ 1."""
    gaunt = 0.2
    k_cm3 = 3.2e-7 * gaunt / (de_ev * np.sqrt(np.maximum(te_ev, 1e-6))) \
        * np.exp(-de_ev / np.maximum(te_ev, 1e-6))
    return k_cm3 * 1e-6


def _k_ion(chi_ev, te_ev):
    """Lotz electron-impact ionization [m^3/s] (a=4.5e-14 cm^2 eV^2)."""
    from scipy.special import exp1
    x = chi_ev / np.maximum(te_ev, 1e-6)
    k_cm3 = 6.7e-7 / (chi_ev * np.sqrt(np.maximum(te_ev, 1e-6))) \
        * exp1(np.maximum(x, 1e-12))
    return k_cm3 * 1e-6


def _k_rr(z_ion, chi_ev, te_ev):
    """Kramers/Seaton radiative recombination [m^3/s]."""
    beta = chi_ev / np.maximum(te_ev, 1e-6)
    k_cm3 = 5.2e-14 * z_ion * np.sqrt(beta) * (
        0.43 + 0.5 * np.log(np.maximum(beta, 1e-12)) + 0.469 / np.maximum(
            beta, 1e-12) ** (1.0 / 3.0))
    return np.maximum(k_cm3, 0.0) * 1e-6


@dataclasses.dataclass(eq=False)
class ColradTables:
    """Device-side rate tables and level metadata."""
    log_te: torch.Tensor       # [nt] log10 Te(eV) grid
    k_exc: torch.Tensor        # [np_exc, nt] forward excitation rates
    exc_i: torch.Tensor        # [np_exc] lower level index (int64)
    exc_j: torch.Tensor        # [np_exc] upper level index
    exc_de: torch.Tensor       # [np_exc] dE (eV)
    k_ion: torch.Tensor        # [np_ion, nt]
    k_rr: torch.Tensor         # [np_ion, nt]
    ion_i: torch.Tensor        # [np_ion] level index
    ion_j: torch.Tensor        # [np_ion] target (ground of z+1)
    ion_chi: torch.Tensor      # [np_ion] effective chi (eV)
    g: torch.Tensor            # [nlev]
    zq: torch.Tensor           # [nlev] charge of each level
    e_ev: torch.Tensor         # [nlev]
    n_lev: int


def build_tables(st: States, te_lo: float = 0.02, te_hi: float = 1000.0,
                 nt: int = 256, dtype=torch.float32, device="cuda",
                 rates: str = "fit", ref_ne: float = 1.8e29) -> ColradTables:
    """The rate tables over a log-Te grid (imd_tpu build_tables).

    ``rates``: "fit" uses the van-Regemorter/Lotz closed forms; "ref"
    integrates the reference's Mott cross sections over the Fermi-Dirac
    distribution at electron density ``ref_ne`` (models/colrad_ref.py)."""
    te = np.logspace(math.log10(te_lo), math.log10(te_hi), nt)
    if rates == "ref":
        from imd_tpu_torch.models import colrad_ref as cr

        def rate_exc(de, te):
            return np.array([cr.k_exc_ref(ref_ne, t * units.EV_TO_K,
                                          de * EV, n=4001)
                             for t in te])

        def rate_ion(chi, te):
            return np.array([cr.k_ion_ref(ref_ne, t * units.EV_TO_K,
                                          chi * EV, n_outer=401,
                                          n_inner=101)
                             for t in te])
    elif rates == "fit":
        rate_exc, rate_ion = _k_exc, _k_ion
    else:
        raise ValueError(f"unknown COLRAD rate source {rates!r}")
    nlev = len(st.z)
    exc_i, exc_j, exc_de, kexc = [], [], [], []
    ion_i, ion_j, ion_chi, kion, krr = [], [], [], [], []
    for i in range(nlev):
        for j in range(nlev):
            if st.z[i] == st.z[j] and st.e_ev[j] > st.e_ev[i] + 1e-9:
                de = st.e_ev[j] - st.e_ev[i]
                exc_i.append(i)
                exc_j.append(j)
                exc_de.append(de)
                kexc.append(rate_exc(de, te))
        zi = int(st.z[i])
        if zi + 1 < len(st.ground) and st.ground[zi + 1] >= 0 \
                and zi < len(st.chi_ev):
            chi = st.chi_ev[zi] - st.e_ev[i]
            if chi > 0.1:
                ion_i.append(i)
                ion_j.append(int(st.ground[zi + 1]))
                ion_chi.append(chi)
                kion.append(rate_ion(chi, te))
                krr.append(_k_rr(zi + 1, chi, te))

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return ColradTables(
        log_te=f(np.log10(te)), k_exc=f(np.array(kexc) * N28),
        exc_i=i(exc_i), exc_j=i(exc_j), exc_de=f(exc_de),
        k_ion=f(np.array(kion) * N28), k_rr=f(np.array(krr) * N28),
        ion_i=i(ion_i), ion_j=i(ion_j), ion_chi=f(ion_chi),
        g=f(st.g), zq=f(st.z), e_ev=f(st.e_ev), n_lev=nlev)


def _interp_rates(tab2d, log_te_grid, te_ev):
    """Linear interpolation in log10 T_e of the rows of ``tab2d`` [n, nt]
    at ``te_ev`` [...] -> [..., n]; the grid index truncates before its
    clip, as imd_tpu's ``astype(int32)``.  Also returns the two table
    columns and df/dTe of the weight, for the Jacobian."""
    lo = 10.0 ** log_te_grid[0]
    hi = 10.0 ** log_te_grid[-1]
    te_c = torch.clamp(te_ev, lo, hi)
    lt = torch.log10(te_c)
    dlg = log_te_grid[1] - log_te_grid[0]
    x = (lt - log_te_grid[0]) / dlg
    k = torch.clamp(x.to(torch.int64), 0, log_te_grid.shape[0] - 2)
    f = (x - k.to(x.dtype))[..., None]
    rows = tab2d.T
    tk, tk1 = rows[k], rows[k + 1]
    # masked by select, not by a product: a product with a zero mask turns
    # an overflowed float32 factor into NaN (jax's derivatives select)
    inside = (te_ev > lo) & (te_ev < hi)
    df = torch.where(inside, 1.0 / (te_c * math.log(10.0)) / dlg,
                     0.0)[..., None]
    return tk * (1.0 - f) + tk1 * f, (tk, tk1, df)


# ---------------------------------------------------------------------------
# the rate network RHS and its Jacobian (batched over cells)
# ---------------------------------------------------------------------------

def _debye_ipd(z_ion, ntot28, ne28, te_ev, grad: bool = False):
    """Debye-sphere IPD [eV] per charge stage (imd_colrad.c:1558-1568),
    [..., n_ion], densities in N28 units; and, with ``grad``, its
    derivatives by (ntot, ne, te) as a tuple of [..., n_ion]."""
    nt = torch.clamp(ntot28, min=1e-10)
    r0_a = _R0_28_A * nt ** (-1.0 / 3.0)
    r0c = torch.clamp(r0_a, min=1e-3)
    s = torch.clamp(ne28 + ntot28, min=1e-10)
    q = te_ev / s
    debye_a = _DEBYE_28_A * torch.sqrt(q)
    x = debye_a / r0c
    fac = (1.0 + x ** 3) ** (2.0 / 3.0) - x * x
    zc = z_ion + 1.0
    ipd = zc * 1.5 / r0c[..., None] * 14.3996 * fac[..., None]
    if not grad:
        return ipd, None
    dr0 = torch.where((ntot28 > 1e-10) & (r0_a > 1e-3),
                      _R0_28_A * (-1.0 / 3.0) * nt ** (-4.0 / 3.0), 0.0)
    dq_n = torch.where(ne28 + ntot28 > 1e-10, -te_ev / (s * s), 0.0)
    dd_q = _DEBYE_28_A * 0.5 / torch.sqrt(q)
    dq = {"nt": dq_n, "ne": dq_n, "te": 1.0 / s}
    dr0c = {"nt": dr0, "ne": 0.0, "te": 0.0}
    dfac_dx = 2.0 * x * x * (1.0 + x ** 3) ** (-1.0 / 3.0) - 2.0 * x
    out = []
    for v in ("nt", "ne", "te"):
        dx = dd_q * dq[v] / r0c - debye_a / (r0c * r0c) * dr0c[v]
        dg = dfac_dx * dx / r0c - fac / (r0c * r0c) * dr0c[v]
        out.append(zc * (1.5 * 14.3996) * dg[..., None])
    return ipd, tuple(out)


def mpi_constants(lambda_m: float) -> Tuple[float, float, float]:
    """Host-side MULTIPHOTON prefactors for laser wavelength lambda_m:
    (hnu_ev, inv_nu, sig1ev2), sig1ev2 = sigma_tmp * EV^2 so that the
    device forms the Kramers photoionization cross section as sig1ev2 *
    chi_eV^2 without float32 underflow (imd_colrad.c:1530)."""
    c_light = 299792458.0
    eps0 = 8.8541878128e-12
    echarge = 1.602176634e-19
    nu = c_light / lambda_m
    hnu_j = H_PLANCK * nu
    # ordered so every float64 intermediate stays in range
    sigma_tmp = (64.0 * math.pi ** 4 / (3.0 * math.sqrt(3.0))
                 * (echarge * echarge / (4.0 * math.pi * eps0)) ** 5
                 * EMASS / H_PLANCK ** 6 / c_light / nu ** 3
                 / (13.6 * echarge) ** 2)
    return hnu_j / EV, 1.0 / nu, sigma_tmp * EV * EV


def colrad_rhs(c, te_ev, ne, tab: ColradTables, use_ipd: bool = True,
               laser=None):
    """dc/dt, dne/dt, the electron energy source P_e and the five power
    densities, in N28 units (densities in 1e28/m^3, powers in eV N28/s),
    for ``c`` [..., nlev], ``te_ev`` and ``ne`` [...].

    ``laser = (phi, hnu_ev, inv_nu, sig1ev2)`` adds the MULTIPHOTON 2- and
    3-photon ionization channels (imd_colrad.c:1934-1952) at the photon
    flux ``phi`` [1/m^2/s], with imd_tpu's documented deviation from the
    reference's sigma_MPI_2 (k2 = (sigma_1 phi)^2 / nu, k3 = (sigma_1
    phi)^3 / (2 nu^2))."""
    return _network(c, te_ev, ne, tab, use_ipd, laser, False)[0]


def _network(c, te_ev, ne, tab, use_ipd, laser, grad: bool):
    """colrad_rhs's result and, with ``grad``, the derivatives of the
    transitions' flows and powers for ``_jacobian``."""
    ntot = c.sum(-1)
    kexc, ex = _interp_rates(tab.k_exc, tab.log_te, te_ev)
    kion, ei = _interp_rates(tab.k_ion, tab.log_te, te_ev)
    krr, er = _interp_rates(tab.k_rr, tab.log_te, te_ev)
    te4 = torch.clamp(te_ev, min=1e-4)[..., None]
    ne_ = ne[..., None]
    last = c.dim() - 1

    # excitation / de-excitation (detailed balance reverse)
    gr = tab.g[tab.exc_i] / tab.g[tab.exc_j]
    ci, cj = c[..., tab.exc_i], c[..., tab.exc_j]
    kfwd = kexc * ne_ * ci
    arg = tab.exc_de / te4
    boltz = torch.exp(torch.clamp(arg, -60.0, 60.0))
    krev_coeff = kexc * gr * boltz
    krev = krev_coeff * ne_ * cj
    dc = torch.zeros_like(c).index_add(last, tab.exc_i, krev - kfwd)
    dc = dc.index_add(last, tab.exc_j, kfwd - krev)
    p_ee = ((krev - kfwd) * tab.exc_de).sum(-1)   # eV/m^3/s to electrons

    # ionization / three-body + radiative recombination
    chi_eff = tab.ion_chi
    zq = tab.zq[tab.ion_i]
    if use_ipd:
        ipd, dipd = _debye_ipd(zq, ntot, ne, te_ev, grad)
        chi_raw = tab.ion_chi - ipd
        chi_eff = torch.clamp(chi_raw, min=0.05)
    # Saha phase-space factor: (n_i / (n_j ne))_eq = g_i/(2 g_j) L^3
    # e^{chi/T}, the de Broglie volume folded on the host
    lam3_28 = _LAM3_N28 * te4 ** -1.5
    g2 = tab.g[tab.ion_i] / (2.0 * tab.g[tab.ion_j])
    sarg = chi_eff / te4
    sexp = torch.exp(torch.clamp(sarg, -60.0, 60.0))
    saha = g2 * lam3_28 * sexp
    di, dj = c[..., tab.ion_i], c[..., tab.ion_j]
    kf = kion * ne_ * di
    k3b = kion * saha * ne_ * ne_ * dj
    krad = krr * ne_ * dj
    dc = dc.index_add(last, tab.ion_i, k3b + krad - kf)
    dc = dc.index_add(last, tab.ion_j, kf - k3b - krad)
    dne = (kf - k3b - krad).sum(-1)
    p_ei = (-(kf - k3b) * chi_eff).sum(-1)        # ionization cools e-
    p_rr = (-krad * 1.5 * te_ev[..., None]).sum(-1)   # radiated away

    p_mpi2 = p_mpi3 = torch.zeros_like(ntot)
    if laser is not None:
        phi, hnu_ev, inv_nu, sig1ev2 = laser
        s1phi = sig1ev2 * chi_eff * chi_eff * phi      # sigma_1 * flux
        base2 = s1phi * s1phi * inv_nu                 # [1/s]
        m2 = 2.0 * hnu_ev >= chi_eff
        m3 = 3.0 * hnu_ev >= chi_eff
        k2 = torch.where(m2, base2, 0.0)
        k3 = torch.where(m3, base2 * (s1phi * inv_nu) * 0.5, 0.0)
        km2 = k2 * di
        km3 = k3 * di
        km = km2 + km3
        dc = dc.index_add(last, tab.ion_i, -km)
        dc = dc.index_add(last, tab.ion_j, km)
        dne = dne + km.sum(-1)
        # the excess photon energy above the (depressed) threshold heats
        # the electrons (imd_colrad.c:1950-1952)
        p_mpi2 = (km2 * (2.0 * hnu_ev - chi_eff)).sum(-1)
        p_mpi3 = (km3 * (3.0 * hnu_ev - chi_eff)).sum(-1)

    out = (dc, dne, p_ee + p_ei + p_mpi2 + p_mpi3,
           dict(P_EE=p_ee, P_EI=p_ei, P_RR=p_rr,
                P_MPI2=p_mpi2, P_MPI3=p_mpi3))
    if not grad:
        return out, None

    # derivatives by the direct populations (ci, cj: the transition's own
    # levels), ntot (every level), ne and te, each [..., n_transitions]
    zero = torch.zeros_like(kfwd)
    te_on = (te_ev > 1e-4)[..., None]

    def drate(parts):
        tk, tk1, df = parts
        return tk * (-df) + tk1 * df

    # excitation: flow kfwd - krev from exc_i to exc_j
    dboltz = torch.where((arg > -60.0) & (arg < 60.0) & te_on,
                         boltz * (-tab.exc_de / (te4 * te4)), 0.0)
    dkexc = drate(ex)
    dkc = dkexc * gr * boltz + kexc * gr * dboltz
    f_exc = {"ci": kexc * ne_, "cj": -krev_coeff * ne_, "nt": zero,
             "ne": kexc * ci - krev_coeff * cj,
             "te": dkexc * ne_ * ci - dkc * ne_ * cj}
    p_exc = {key: -v * tab.exc_de for key, v in f_exc.items()}

    # ionization: flow kf - k3b - krad + km from ion_i to ion_j
    zero_i = torch.zeros_like(kf)
    if use_ipd:
        dchi = {key: torch.where(chi_raw > 0.05, -d, 0.0)
                for key, d in zip(("nt", "ne", "te"), dipd)}
    else:
        dchi = {"nt": zero_i, "ne": zero_i, "te": zero_i}
    msarg = (sarg > -60.0) & (sarg < 60.0)
    dlam3 = torch.where(te_on, _LAM3_N28 * (-1.5) * te4 ** -2.5, 0.0)
    dsaha = {}
    for key in ("nt", "ne", "te"):
        dsarg = dchi[key] / te4
        if key == "te":
            dsarg = dsarg - torch.where(te_on, chi_eff / (te4 * te4), 0.0)
        dsaha[key] = g2 * (torch.where(msarg, lam3_28 * sexp * dsarg, 0.0)
                           + (dlam3 * sexp if key == "te" else 0.0))
    dkion, dkrr = drate(ei), drate(er)
    ne2 = ne_ * ne_
    dk3b = {"nt": kion * dsaha["nt"] * ne2 * dj,
            "ne": kion * saha * 2.0 * ne_ * dj
            + kion * dsaha["ne"] * ne2 * dj,
            "te": (dkion * saha + kion * dsaha["te"]) * ne2 * dj}
    dkf = {"nt": zero_i, "ne": kion * di, "te": dkion * ne_ * di}
    dkrad = {"nt": zero_i, "ne": krr * dj, "te": dkrr * ne_ * dj}
    f_ion = {"ci": kion * ne_, "cj": -kion * saha * ne2 - krr * ne_}
    p_ion = {"ci": -kion * ne_ * chi_eff,
             "cj": kion * saha * ne2 * chi_eff}
    for key in ("nt", "ne", "te"):
        f_ion[key] = dkf[key] - dk3b[key] - dkrad[key]
        p_ion[key] = -(dkf[key] - dk3b[key]) * chi_eff \
            - (kf - k3b) * dchi[key]
    if laser is not None:
        f_ion["ci"] = f_ion["ci"] + k2 + k3
        p_ion["ci"] = p_ion["ci"] + k2 * (2.0 * hnu_ev - chi_eff) \
            + k3 * (3.0 * hnu_ev - chi_eff)
        s1nu = s1phi * inv_nu
        for key in ("nt", "ne", "te"):
            # grouped as the forward products, so that float32 holds them
            ds = (sig1ev2 * dchi[key] * chi_eff
                  + sig1ev2 * chi_eff * dchi[key]) * phi
            db2 = (ds * s1phi + s1phi * ds) * inv_nu
            dk2 = torch.where(m2, db2, 0.0)
            dk3 = torch.where(m3, (db2 * s1nu + base2 * (ds * inv_nu))
                              * 0.5, 0.0)
            f_ion[key] = f_ion[key] + (dk2 + dk3) * di
            p_ion[key] = p_ion[key] + dk2 * di * (2.0 * hnu_ev - chi_eff) \
                - km2 * dchi[key] + dk3 * di * (3.0 * hnu_ev - chi_eff) \
                - km3 * dchi[key]
    return out, ((f_exc, p_exc), (f_ion, p_ion))


@dataclasses.dataclass(frozen=True)
class _Incidence:
    """The network's transitions as dense matrices: ``a`` [nlev, T] the
    signed scatter of a flow from level i to level j (-1 at i, +1 at j),
    ``pi``/``pj`` [T, nlev] the gathers of c_i and c_j."""
    a_exc: torch.Tensor
    pi_exc: torch.Tensor
    pj_exc: torch.Tensor
    a_ion: torch.Tensor
    pi_ion: torch.Tensor
    pj_ion: torch.Tensor


def _incidence(tab: ColradTables, dtype, device) -> _Incidence:
    eye = torch.eye(tab.n_lev, dtype=dtype, device=device)
    pe_i, pe_j = eye[tab.exc_i], eye[tab.exc_j]
    pi_i, pi_j = eye[tab.ion_i], eye[tab.ion_j]
    return _Incidence(a_exc=(pe_j - pe_i).T, pi_exc=pe_i, pj_exc=pe_j,
                      a_ion=(pi_j - pi_i).T, pi_ion=pi_i, pj_ion=pi_j)


def _rows(d, pi, pj):
    """d(sum over transitions)/d(c, ne, te) -> ([..., nlev], [...],
    [...])."""
    return (d["ci"] @ pi + d["cj"] @ pj + d["nt"].sum(-1, keepdim=True),
            d["ne"].sum(-1), d["te"].sum(-1))


def _block(d, a, pi, pj):
    """d(a @ flow)/d(c, ne, te) -> ([..., nlev, nlev], [..., nlev],
    [..., nlev])."""
    jc = (d["ci"][..., None, :] * a) @ pi + (d["cj"][..., None, :] * a) @ pj \
        + (d["nt"] @ a.T)[..., None]
    return jc, d["ne"] @ a.T, d["te"] @ a.T


# tries between the host reads of "any cell still running" (each a stall)
CHECK_EVERY = 2


def _fewest_tries(n_sub: int) -> int:
    """Tries of a cell whose every step is accepted: the least any cell
    takes before its ``cond`` turns false."""
    t, tau, n = 0.0, 1.0 / n_sub, 0
    while t < 1.0 - 1e-9:
        t += min(tau, 1.0 - t)
        tau = min(2.0 * tau, 1.0)
        n += 1
    return n


def make_colrad_step(tab: ColradTables, n_sub: int = 16,
                     newton_iters: int = 8, use_ipd: bool = True,
                     max_tries: int = 4096, rtol: float = 1e-6,
                     evolve_te: bool = False, mpi_const=None):
    """Returns step(c [.., nlev], te_ev [..], ne [..], dt_s[, ce][, phi],
    counters=None) -> (c', ne', P_e or te', diag) integrating the network
    over dt_s seconds (imd_tpu make_colrad_step).  Also ``step.rhs_jac(y,
    te, ce, phi) -> (rhs, jacobian)`` on the solver's state y [B, ndim]
    (N28 units).

    Adaptive backward Euler with ``newton_iters`` Newton iterations on the
    state and step halving (x0.25) on a rejected step (negative
    populations or an unconverged Newton), doubling on an accepted one;
    ``n_sub`` sets the first step dt_s / n_sub, ``max_tries`` bounds the
    tries of a cell.  With ``evolve_te`` the electron temperature joins the
    state (dTe/dt = P_e / C_e, ``ce`` in eV/(eV A^3)) and the step returns
    te'.  ``mpi_const = mpi_constants(lambda_m)`` arms the MULTIPHOTON
    channels at the photon flux ``phi`` (a 0-d tensor).  "Any cell still
    running" is read to the host after the fewest tries a cell takes, then
    every CHECK_EVERY tries.  ``live`` (bool, te_ev's shape) marks the
    cells whose result the caller keeps; the others are not integrated
    and come back as they went in.
    imd_tpu integrates every cell, and in float32 an empty cell's Jacobian
    overflows (its Saha term at 1e-3 eV), so its NaN holds imd_tpu's loop
    to ``max_tries``; ``apply_colrad`` passes its active mask, and the
    cells it keeps get the same bits."""
    nlev = tab.n_lev
    p_to_a3 = N28 * 1e-30          # eV*N28/s -> eV/A^3/s
    ndim = nlev + (2 if evolve_te else 1)
    fewest = _fewest_tries(n_sub)
    inc = {}

    def laser_of(phi):
        return None if mpi_const is None else (phi,) + tuple(mpi_const)

    def rhs_jac(y, te, ce, phi, grad: bool = True):
        """The RHS [B, ndim] at y and, with ``grad``, its Jacobian [B,
        ndim, ndim] (written out: imd_tpu takes jax.jacfwd)."""
        te_cur = y[:, nlev + 1] if evolve_te else te
        (dc, dne, pe, _), d = _network(y[:, :nlev], te_cur, y[:, nlev], tab,
                                       use_ipd, laser_of(phi), grad)
        cols = [dc, dne[:, None]]
        inv_ce = p_to_a3 / torch.clamp(ce, min=1e-12)
        if evolve_te:
            cols.append((pe * p_to_a3 / torch.clamp(ce, min=1e-12))[:, None])
        r = torch.cat(cols, 1)
        if not grad:
            return r, None
        key = (y.dtype, y.device)
        if key not in inc:
            inc[key] = _incidence(tab, *key)
        m = inc[key]
        (f_exc, p_exc), (f_ion, p_ion) = d
        jc_e, jn_e, jt_e = _block(f_exc, m.a_exc, m.pi_exc, m.pj_exc)
        jc_i, jn_i, jt_i = _block(f_ion, m.a_ion, m.pi_ion, m.pj_ion)
        rc, rn, rt = _rows(f_ion, m.pi_ion, m.pj_ion)
        top = [jc_e + jc_i, (jn_e + jn_i)[..., None]]
        mid = [rc[:, None, :], rn[:, None, None]]
        if evolve_te:
            top.append((jt_e + jt_i)[..., None])
            mid.append(rt[:, None, None])
        rows = [torch.cat(top, 2), torch.cat(mid, 2)]
        if evolve_te:
            ec, en, et = _rows(p_exc, m.pi_exc, m.pj_exc)
            ic, i_n, it = _rows(p_ion, m.pi_ion, m.pj_ion)
            w = inv_ce[:, None]
            rows.append(torch.cat([(ec + ic) * w, ((en + i_n) * inv_ce)
                                   [:, None], ((et + it) * inv_ce)[:, None]],
                                  1)[:, None, :])
        return r, torch.cat(rows, 1)

    def be_newton(y, tau, te, ce, phi):
        eye = torch.eye(ndim, dtype=y.dtype, device=y.device)
        yk = y
        for _ in range(newton_iters):
            r, jac = rhs_jac(yk, te, ce, phi)
            f = yk - y - tau[:, None] * r
            a = eye - tau[:, None, None] * jac
            yk = yk - torch.linalg.solve_ex(a, f[..., None])[0][..., 0]
        r, _ = rhs_jac(yk, te, ce, phi, grad=False)
        res = torch.linalg.vector_norm(yk - y - tau[:, None] * r, dim=-1)
        scale = torch.linalg.vector_norm(y, dim=-1) + 1.0
        ok = (res <= rtol * scale) & (yk.amin(-1) >= -1e-8 * scale)
        return torch.clamp(yk, min=0.0), ok

    def step(c, te_ev, ne, dt_s, ce=None, phi=None, counters=None,
             live=None):
        shape = te_ev.shape
        dtype, dev = te_ev.dtype, te_ev.device
        te = te_ev.reshape(-1)
        ce = torch.ones_like(te) if ce is None else ce.reshape(-1)
        if phi is None:
            phi = torch.zeros((), dtype=dtype, device=dev)
        if torch.is_tensor(dt_s):
            dt_s = dt_s.to(dtype)
        else:
            dt_s = torch.full((), dt_s, dtype=dtype, device=dev)
        # the public API is 1/m^3; the solve runs in N28 units
        cc = c.reshape(-1, nlev) * (1.0 / N28)
        nn = ne.reshape(-1) * (1.0 / N28)
        cols = [cc, nn[:, None]] + ([te[:, None]] if evolve_te else [])
        y = torch.cat(cols, 1)
        n = y.shape[0]
        tau_min = dt_s / (n_sub * 1024.0)
        end = dt_s * (1.0 - 1e-9)
        t = torch.zeros(n, dtype=dtype, device=dev)
        tau = (dt_s / n_sub).expand(n).clone()
        k = torch.zeros(n, dtype=torch.int32, device=dev)
        if live is not None:
            # a cell whose result the caller discards starts done
            t = torch.where(live.reshape(-1), t, dt_s)
        tries, burst = 0, fewest
        while True:
            for _ in range(burst):
                run = (t < end) & (k < max_tries)
                tau_eff = torch.minimum(tau, dt_s - t)
                y1, ok = be_newton(y, tau_eff, te, ce, phi)
                accept = ok | (tau <= tau_min)
                t2 = torch.where(accept, t + tau_eff, t)
                y2 = torch.where(accept[:, None], y1, y)
                tau2 = torch.where(accept, tau * 2.0, tau * 0.25)
                tau2 = torch.clamp(tau2, tau_min, dt_s)
                t = torch.where(run, t2, t)
                y = torch.where(run[:, None], y2, y)
                tau = torch.where(run, tau2, tau)
                k = torch.where(run, k + 1, k)
            tries += burst
            burst = CHECK_EVERY
            more = bool(((t < end) & (k < max_tries)).any())
            if counters is not None:
                counters.host_syncs += 1
            if not more:
                break
        if counters is not None:
            counters.colrad_tries += tries
        te_out = y[:, nlev + 1] if evolve_te else te
        _, _, pe, diag = colrad_rhs(y[:, :nlev], te_out, y[:, nlev], tab,
                                    use_ipd, laser_of(phi))
        third = te_out if evolve_te else pe
        return ((y[:, :nlev] * N28).reshape(c.shape),
                (y[:, nlev] * N28).reshape(shape), third.reshape(shape),
                {key: v.reshape(shape) for key, v in diag.items()})

    step.rhs_jac = rhs_jac
    return step


# ---------------------------------------------------------------------------
# TTM-grid coupling (do_colrad, imd_colrad.c:123-290)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class ColradGridState:
    """Per-FD-cell level populations [nx, nlev] in 1/m^3, and the last
    step's power densities [nx, 5] (POWER_KEYS, IMD units) for the .ttm
    columns (imd_colrad.c:282-292)."""
    c: torch.Tensor
    p: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "ColradGridState":
        return dataclasses.replace(self, **kw)


def init_grid_state(tab: ColradTables, nx: int, dtype=torch.float32,
                    device="cuda") -> ColradGridState:
    return ColradGridState(
        c=torch.zeros((nx, tab.n_lev), dtype=dtype, device=device),
        p=torch.zeros((nx, len(POWER_KEYS)), dtype=dtype, device=device))


def apply_colrad(grid, cstate: ColradGridState, tab: ColradTables,
                 params, step_fn, dt_imd, phi=None, counters=None):
    """One MD step of COLRAD kinetics on the TTM grid (imd_tpu
    apply_colrad): fresh active cells are seeded all-neutral-ground, the
    active cells evolve (c, ne, Te; the inactive ones, whose result is
    discarded, are not integrated), and Te, ne and Z = <Z> are written
    back (imd_colrad.c:277-279).  ``dt_imd`` is the MD step (a float).
    Returns (grid, cstate, diag)."""
    from imd_tpu_torch.models.ttm import active_mask

    dtype, dev = grid.temp.dtype, grid.temp.device
    act = active_mask(grid, params)
    ntot = grid.dens / (params.atomic_mass * units.AMU_TO_KG)   # 1/m^3
    fresh = act & (cstate.c.sum(-1) <= 0.0)
    seed = torch.cat([ntot[:, None], torch.zeros_like(cstate.c[:, 1:])], 1)
    c = torch.where(fresh[:, None], seed, cstate.c)
    ne0 = torch.where(fresh, torch.clamp(1e-4 * ntot, min=1e24), grid.ne)
    dt_s = torch.full((), dt_imd, dtype=dtype, device=dev) \
        * units.IMD_TIME_S
    c1, ne1, te1, diag = step_fn(c, torch.clamp(grid.temp, min=1e-3),
                                 torch.clamp(ne0, min=1e20), dt_s,
                                 torch.clamp(grid.Ce, min=1e-8), phi,
                                 counters=counters, live=act)
    zbar = mean_charge(c1, tab)
    new_grid = grid.replace(
        temp=torch.where(act, te1, grid.temp),
        ne=torch.where(act, ne1, grid.ne),
        Z=torch.where(act, zbar, grid.Z))
    # power-density columns in IMD units (eV/A^3/time)
    p = torch.stack([torch.where(act, diag[key] * P_N28_TO_IMD, 0.0)
                     for key in POWER_KEYS], -1).to(cstate.c.dtype)
    return new_grid, ColradGridState(
        c=torch.where(act[:, None], c1, cstate.c), p=p), diag


def mean_charge(c, tab: ColradTables):
    """<Z> = sum z c / sum c per cell."""
    num = (c * tab.zq).sum(-1)
    den = torch.clamp(c.sum(-1), min=1.0)
    return num / den
