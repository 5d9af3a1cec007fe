"""Reference-parity COLRAD rate coefficients (host-side, numpy; a copy of
imd_tpu/models/colrad_ref.py, whose only import of the JAX package is its
units).

The reference evaluates electron-impact rates by integrating Mott-type
cross sections over the Fermi-Dirac electron distribution with an
adaptive Gauss-Kronrod scheme at every RHS call (colrad_GetCoeffs,
imd_colrad.c:2279; integrand_excitation:3464,
outer_integrand_ionization2:3629, chempot imd_ttm.c:3363).  This module
replicates those defining integrals (same cross sections, same Fermi/Pauli
factors, same Sommerfeld chemical potential, same integration windows)
with dense trapezoid quadrature: the rate source of
``models.colrad.build_tables(rates="ref")``.

All energies in Joule, temperatures in Kelvin, densities in 1/m^3;
returned rate coefficients in m^3/s.
"""

from __future__ import annotations

import math

import numpy as np

from imd_tpu_torch import units

KB = units.KB_J
EMASS = units.EMASS_KG
EV = units.EV_TO_J
A0SQ = 0.52917721e-10 ** 2                 # bohr_radius_sq
E_H_SQ = (13.605693122994 * EV) ** 2       # E_ion_H_sq_J
ALPHA_I = 0.3                              # imd_colrad.c:79
BETA_I = 0.9                               # imd_colrad.c:80
# (2m)^{3/2}/(2 hbar^3 pi^2): DOS prefactor (imd_colrad.c:3270 literal)
F_CONST = 1.062234185782204e56
# F_CONST * sqrt(2/m): folded ionization prefactor (imd_colrad.c:82)
IONIZ_CONST = 1.573949440579906e71


def chempot(ne, te_k):
    """Sommerfeld-expansion chemical potential (chempot, imd_ttm.c:3363)."""
    ef = 5.842256986370049e-38 * ne ** (2.0 / 3.0)
    return ef * (1.0 - (math.pi * KB * te_k / (2.0 * ef)) ** 2 / 3.0)


def _eupper(mu, te_k, de_j):
    # integration window exactly as the reference picks it
    if mu > 0:
        return (3.0 * te_k) ** 0.33 * EV + mu + de_j
    return 10.0 * te_k / 11604.0 * EV + de_j


def _fd(e, mu, kt):
    return 1.0 / (1.0 + np.exp(np.clip((e - mu) / kt, -600, 600)))


def k_exc_ref(ne, te_k, de_j, allowed=1, mu=None, n=20001):
    """Electron-impact excitation rate [m^3/s]
    (eval_excitation_integral / integrand_excitation)."""
    kt = KB * te_k
    if mu is None:
        mu = chempot(ne, te_k)
    e = np.linspace(de_j * 1.001, _eupper(mu, te_k, de_j), n)
    y = e / de_j
    vel = np.sqrt(2.0 * e / EMASS)
    fermi = _fd(e, mu, kt)
    # Pauli factor exactly as written in the reference (sign included)
    pauli = 1.0 - 1.0 / (1.0 + np.exp(
        np.clip((e - de_j + mu) / kt, -600, 600)))
    if allowed:
        sigma = (4.0 * math.pi * A0SQ * E_H_SQ / de_j ** 2 * ALPHA_I
                 * (y - 1.0) / y ** 2 * np.log(1.25 * BETA_I * y))
    else:
        sigma = 4.0 * math.pi * A0SQ * ALPHA_I * (y - 1.0) / y ** 2
    f_dist = F_CONST / ne * np.sqrt(e) * fermi
    val = np.trapezoid(vel * np.maximum(sigma, 0.0) * f_dist * pauli, e)
    return max(val, 0.0)


def k_dexc_ref(ne, te_k, de_j, allowed=1, n=20001):
    """De-excitation core (eval_dexcitation_integral: the excitation
    integrand at the shifted potential mu + dE; the caller multiplies
    the g_i/g_j ratio, imd_colrad.c:2520)."""
    mu = chempot(ne, te_k) + de_j
    return k_exc_ref(ne, te_k, de_j, allowed=allowed, mu=mu, n=n)


def k_ion_ref(ne, te_k, de_j, n_outer=1201, n_inner=301):
    """Electron-impact ionization rate [m^3/s]
    (double_integral_ionization2): outer over the incident energy E,
    inner over the secondary-electron split with double Pauli
    blocking."""
    kt = KB * te_k
    mu = chempot(ne, te_k)
    e = np.linspace(de_j * 1.001, _eupper(mu, te_k, de_j), n_outer)
    y = e / de_j
    fermi = _fd(e, mu, kt)
    sigma_deriv = ((y - 1.0) / y ** 2 * np.log(BETA_I * 1.25 * y)
                   / (e - de_j))
    inner = np.empty_like(e)
    for i, ei in enumerate(e):
        ep = np.linspace(1e-21, ei - de_j, n_inner)
        epp = ei - ep - de_j
        pauli = (1.0 - _fd(ep, mu, kt)) * (1.0 - _fd(epp, mu, kt))
        inner[i] = np.trapezoid(pauli, ep)
    outer = np.trapezoid(e * fermi * np.maximum(sigma_deriv, 0.0)
                         * inner, e)
    outer *= 2.0 * math.pi * A0SQ * E_H_SQ / de_j ** 2 * ALPHA_I
    outer *= IONIZ_CONST / ne
    return max(outer, 0.0)
