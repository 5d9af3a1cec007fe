"""Wide-range electron transport models (port of
imd_tpu/models/widerange.py:85-240; imd_ttm.c:2191-2420).

``fermi_E``, ``numet``, ``numax`` and ``nupl`` keep the reference's SI
signatures (Te in K, nu in 1/s) for the TMM permittivity (models/tmm.py);
they wrap the scaled-unit forms below.

Inputs Te, Ti in eV, ne in 1/m^3, dens in kg/m^3; kappa and g come out in
IMD-internal units.  float32 safety is the JAX package's: all runtime
arithmetic runs in scaled units (eV, 1e28/m^3, 1e15/s, Angstrom) with every
constant product folded host-side in double precision, because constants
like hbar^2 (1e-68) and the gamma prefactor (3e-74) underflow float32.
"""

from __future__ import annotations

import math

import torch

from imd_tpu_torch import units

BOLTZMAN = units.KB_J
EMASS = units.EMASS_KG
ECHARGE = units.ECHARGE_C
ECONST = units.EPS0
HBAR = units.HBAR_J
AMU = units.AMU_TO_KG
EV_TO_K = 11604.5          # the reference's rounded conversion
EV = units.EV_TO_J

# Povarnitsyn fit constants (imd_ttm.c getKappa/getGamma)
A1T, A2T, A3T, A4T = 2.95, 0.5, 0.16, 1.2
A1G, A2G, A3G = 50.0, 20.0, 0.25

# scaled-unit constants, folded host-side in double precision
N28 = 1e28
NU15 = 1e15
_EF0_EV = (HBAR * HBAR * (3.0 * math.pi ** 2 * N28) ** (2.0 / 3.0)
           / (2.0 * EMASS)) / EV
_VUNIT = math.sqrt(EV / EMASS)
_R0_28_M = (3.0 / (4.0 * math.pi * N28)) ** (1.0 / 3.0)
_R0_28_A = _R0_28_M * 1e10
_WPL28_15 = math.sqrt(N28 * ECHARGE ** 2 / (EMASS * ECONST)) / NU15
_BMIN1_A = ECHARGE * 1e10
_BMIN2_A = HBAR / math.sqrt(2.0 * EMASS * EV) * 1e10
_NUMET15 = 1.309202957843054e+11 * EV_TO_K / NU15
_NUMAX15 = _VUNIT / _R0_28_M / NU15
_NUPL15 = 1.863839656495274e-40 * N28 / (EV ** 1.5) / NU15
_KMET = 6.884236239621913e-16 * N28 * EV_TO_K / NU15
_KPL = 4.428788911416808e+43 * (EV ** 2.5)
_GAM = 2.783313120645740e-74 / AMU * N28 * NU15

KAPPA_SI_TO_IMD = 0.073768115942029


def _max(x, v):
    return torch.clamp(x, min=v)


def fermi_E_eV(ne):
    """Fermi energy [eV] from electron density [1/m^3]."""
    return _EF0_EV * (ne * (1.0 / N28)) ** (2.0 / 3.0)


def fermi_E(ne):
    """Fermi energy [J] (imd_ttm.c:2191); f32-safe (result ~1e-18)."""
    return fermi_E_eV(ne) * EV


def _b_min_a(Z, Te_eV):
    """min impact parameter [Angstrom]."""
    return torch.maximum(Z * (_BMIN1_A / _max(Te_eV, 1e-10)),
                         _BMIN2_A / torch.sqrt(_max(Te_eV, 1e-10)))


def _b_max_a(omega_las15, Z, ni28, Te_eV, laser_active):
    tf = (2.0 / 3.0) * _EF0_EV * (ni28 * Z) ** (2.0 / 3.0)
    teff = torch.sqrt(Te_eV ** 2 + tf ** 2)
    wpl15 = _WPL28_15 * torch.sqrt(ni28 * Z)
    # a Python flag decides on the host: a tensor made of it on the card
    # would be a copy that waits for the stream
    if isinstance(laser_active, bool):
        om15 = _max(wpl15, omega_las15) if laser_active else wpl15
    else:
        om15 = torch.where(laser_active, _max(wpl15, omega_las15), wpl15)
    v_over_w = (_VUNIT / NU15 * 1e10) * torch.sqrt(teff) / _max(om15, 1e-10)
    return torch.maximum(_R0_28_A * ni28 ** (-1.0 / 3.0), v_over_w)


def _coulomb_log(omega_las15, Z, ni28, Te_eV, laser_active):
    return _max(torch.log(
        _b_max_a(omega_las15, Z, ni28, Te_eV, laser_active)
        / _b_min_a(Z, Te_eV)), 2.0)


def _numet15(A1, A2, Te_eV, Ti_eV, TF_eV):
    """Metallic e-ph collision frequency [1e15/s] (imd_ttm.c:2282)."""
    return _NUMET15 * (A1 * Ti_eV + A2 * Te_eV * Te_eV / _max(TF_eV, 1e-10))


def _numax15(A3, EF_eV, Te_eV, ni28):
    """Saturation collision frequency [1e15/s] (imd_ttm.c:2292)."""
    return A3 * _NUMAX15 * torch.sqrt(2.0 * EF_eV + Te_eV) \
        * ni28 ** (1.0 / 3.0)


def _nupl15(omega_las15, Z, ni28, ne28, Te_eV, laser_active):
    """Plasma (Spitzer) collision frequency [1e15/s] (imd_ttm.c:2297)."""
    cl = _coulomb_log(omega_las15, Z, ni28, Te_eV, laser_active)
    return _NUPL15 * Z * ne28 * cl / _max(Te_eV, 1e-10) ** 1.5


# reference-signature wrappers (Te in K, nu in 1/s)
def numet(A1, A2, Te_K, Ti_K, TF_K):
    return _numet15(A1, A2, Te_K / EV_TO_K, Ti_K / EV_TO_K,
                    TF_K / EV_TO_K) * NU15


def numax(A3, vf, Te_K, ni):
    # vf = sqrt(2 EF / m)  ->  EF_eV = (vf/vunit)^2 / 2
    ef = (vf / _VUNIT) ** 2 * 0.5
    return _numax15(A3, ef, Te_K / EV_TO_K, ni * (1.0 / N28)) * NU15


def nupl(omega_las, Z, ni, ne, Te_K, laser_active):
    return _nupl15(omega_las / NU15, Z, ni * (1.0 / N28), ne * (1.0 / N28),
                   Te_K / EV_TO_K, laser_active) * NU15


def mean_charge(Te_eV, dens, z0, am):
    """More-fit mean ionization <Z> (imd_ttm.c:2241 MeanCharge)."""
    temp_kK = Te_eV * (EV_TO_K * 1e-3)
    rho_gcc = dens * 1e-3
    YA1, YA2, YA3, YA4 = 0.003323, 0.971832, 0.926148e-5, 3.10165
    YB0, YB1, YB2 = -1.7630, 1.43175, 0.315463
    YC1, YC2 = 0.036666667, 0.983333333
    YAL, YBE = 0.143139e2, 0.6624e0
    t0 = _max(temp_kK / z0 ** (4.0 / 3.0), 1e-30)
    rr = _max(rho_gcc / (z0 * am), 1e-30)
    ytf = t0 / (1.0 + t0)
    ya = YA1 * t0 ** YA2 + YA3 * t0 ** YA4
    yb = -torch.exp(YB0 + YB1 * ytf + YB2 * ytf * ytf)
    yc = YC1 * ytf + YC2
    yq1 = ya * rr ** yb
    yq = (rr ** yc + yq1 ** yc) ** (1.0 / yc)
    yx = YAL * yq ** YBE
    return z0 * yx / (1.0 + yx + torch.sqrt(1.0 + 2.0 * yx))


def get_kappa(Te_eV, Ti_eV, ne, Z, omega_laser=0.0, laser_active=False):
    """Wide-range electronic kappa, IMD units (imd_ttm.c:2356 getKappa)."""
    Z = _max(Z, 1e-10)
    ne28 = ne * (1.0 / N28)
    ni28 = ne28 / Z
    om15 = omega_laser / NU15
    EF = _EF0_EV * ne28 ** (2.0 / 3.0)
    TF = (2.0 / 3.0) * EF
    nu15 = torch.minimum(_numet15(A1T, A2T, Te_eV, Ti_eV, TF),
                         _numax15(A3T, EF, Te_eV, ni28))
    cl = _coulomb_log(om15, Z, ni28, Te_eV, laser_active)
    kappa_met = _KMET * ne28 * Te_eV / _max(nu15, 1e-30)
    kappa_pl = _KPL * _max(Te_eV, 1e-10) ** 2.5 / (Z * cl)
    kappa_wr = kappa_pl + (kappa_met - kappa_pl) * torch.exp(-A4T * Te_eV
                                                             / TF)
    return kappa_wr * KAPPA_SI_TO_IMD


def get_gamma(Te_eV, Ti_eV, ne, Z, m_atom=26.9815, omega_laser=0.0,
              laser_active=False):
    """Wide-range e-ph coupling g, IMD units (imd_ttm.c:2310 getGamma)."""
    Z = _max(Z, 1e-10)
    ne28 = ne * (1.0 / N28)
    ni28 = ne28 / Z
    om15 = omega_laser / NU15
    EF = _EF0_EV * ne28 ** (2.0 / 3.0)
    TF = (2.0 / 3.0) * EF
    nu15 = torch.minimum(
        _numet15(A1G, A2G, Te_eV, Ti_eV, TF),
        torch.minimum(_numax15(A3G, EF, Te_eV, ni28),
                      _nupl15(om15, Z, ni28, ne28, Te_eV, laser_active)))
    return (_GAM / m_atom) * ne28 * nu15
