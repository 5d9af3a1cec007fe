"""1-D Yee-grid FDTD Maxwell solver with ADE Drude-Lorentz dispersion (port
of imd_tpu/models/fdtd.py:40-240, 466-481; the reference's imd_fdtd.c).

The 1-D z-polarized solver (do_fdtd, imd_fdtd.c:128-310): leapfrogged Ez /
Hy updates, auxiliary-differential-equation Drude + single Lorentz pole
currents Jz / Jlz with polarization Pz, the Berenger PML as a conductivity
profile sigma_y (init_pml, imd_fdtd.c:765-860), the soft source with its
total-field/scattered-field back-correction (fdtd_softsource:62-121 and
the Hy compensation at 292-304), and the Joule heating power density as
the TTM cell source in IMD units (270-283).  Per-cell Drude-Lorentz
parameters come from ``fit_dl``: DL[5] the plasma frequency of the cell's
n_e (imd_ttm.c:2912), DL[1] the wide-range effective Drude collision
frequency, the Lorentz pole the reference's static Al constants
(imd_ttm.c:2880-2885).

All torch ops on [nx] tensors, one Maxwell step a call; the 2-D TMZ solver
(``step_2d``) needs the 3-D TTM and is not ported (ROADMAP A7).  A source
column outside the grid injects nothing, as imd_tpu's ``.at[].add`` drops
an index out of bounds.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from imd_tpu_torch import units
from imd_tpu_torch.models import widerange as wr

EPS0 = units.EPS0
MU0 = 4.0e-7 * math.pi
C0 = units.C_SI
IMP0 = math.sqrt(MU0 / EPS0)
WM3_TO_IMD = 6.3538562638e-26      # same conversion as TMM (imd_fdtd.c:282)

# reference static Al Drude-Lorentz constants (imd_ttm.c:2880-2885)
DL_STATIC = (2.73, 1.1174e15, 7.6595e15, 2.4024e15, 4.5199e14, 2.2955e16)


@dataclasses.dataclass(frozen=True, eq=False)
class FDTDParams:
    """Static FDTD configuration and the host-made PML profile."""
    nx: int
    fd_dx_m: float
    dt_s: float
    sc: float
    bw: int
    srcx: int
    e0: float                       # V/m
    nlambda: float                  # points per wavelength
    t0_s: float
    sigma_t_s: float
    t1_s: float = 0.0
    sigma_t1_s: float = 0.0
    threshold: float = 1e-4
    fd_min_atoms: int = 1
    sigma_y: torch.Tensor = None    # [nx] PML conductivity along x


@dataclasses.dataclass(eq=False)
class FDTDState:
    """1-D field state ([nx] tensors)."""
    ezx: torch.Tensor
    hy: torch.Tensor
    jzx: torch.Tensor       # Drude current
    jlzx: torch.Tensor      # Lorentz current
    pzx: torch.Tensor       # Lorentz polarization
    source: torch.Tensor    # qe in IMD units

    def replace(self, **kw) -> "FDTDState":
        return dataclasses.replace(self, **kw)


def _pml_profile(n: int, bw: int, dx_m: float,
                 refl_coeff: float = 1.0e-12,
                 grading: float = 8.0) -> np.ndarray:
    """Polynomial-graded Berenger PML conductivity (init_pml,
    imd_fdtd.c:770-860), cell-integrated."""
    sigma_max = (-math.log10(refl_coeff) * (grading + 1.0) * EPS0 * C0) / (
        2.0 * bw * dx_m)
    bf = sigma_max / (bw ** grading * (grading + 1.0))
    g1 = grading + 1.0
    sig = np.zeros(n)
    i = np.arange(n)
    # right PML
    m = i >= n - bw
    idist = bw - ((n - 1) - i[m])
    inner = i[m] > n - 1 - bw
    sig[m] = bf * ((idist + 0.5) ** g1
                   - np.where(inner, (idist - 0.5), idist * 1.0) ** g1)
    # left PML
    m = i <= bw
    idist = (bw - i[m]).astype(float)
    inner = i[m] < bw
    sig[m] = bf * ((idist + 0.5) ** g1
                   - np.where(inner, (idist - 0.5), idist * 1.0) ** g1)
    return np.maximum(sig, 0.0)


def make_fdtd_params(cfg, ttm_params, dtype=torch.float32,
                     device="cuda") -> FDTDParams:
    """From an FDTDConfig and the TTMParams (init_fdtd, imd_fdtd.c:594)."""
    dx_m = ttm_params.fd_h_x * 1e-10
    nx = ttm_params.nx
    sc = min(1.0 if cfg.mode == 1 else 1.0 / math.sqrt(2.0), cfg.Sc)
    dt = sc * dx_m / C0
    freq = C0 / cfg.lambda_m
    nlam = C0 / (freq * dx_m)
    e0 = math.sqrt(2.0 * cfg.I0 * IMP0)
    bw = max(cfg.pml, 5)
    srcx = max(int(round(cfg.srcx / (ttm_params.fd_h_x))), bw + 10)
    return FDTDParams(
        nx=nx, fd_dx_m=dx_m, dt_s=dt, sc=sc, bw=bw, srcx=srcx, e0=e0,
        nlambda=nlam, t0_s=cfg.t0_s, sigma_t_s=max(cfg.sigma_t_s, 1e-30),
        fd_min_atoms=ttm_params.fd_min_atoms,
        sigma_y=torch.as_tensor(_pml_profile(nx, bw, dx_m), dtype=dtype,
                                device=device))


def make_state(params: FDTDParams, dtype=torch.float32,
               device="cuda") -> FDTDState:
    def z():
        return torch.zeros((params.nx,), dtype=dtype, device=device)
    return FDTDState(ezx=z(), hy=z(), jzx=z(), jlzx=z(), pzx=z(),
                     source=z())


def fit_dl(grid, ttm_params) -> torch.Tensor:
    """Per-cell Drude-Lorentz parameters [6, nx] (fitDL stand-in)."""
    te = torch.clamp(grid.temp, min=0.0259)
    ti = torch.clamp(grid.md_temp, min=0.0259)
    ne28 = torch.clamp(grid.ne, min=1e26) * (1.0 / wr.N28)
    Z = torch.clamp(grid.Z, min=1e-3)
    EF = wr._EF0_EV * ne28 ** (2.0 / 3.0)
    TF = (2.0 / 3.0) * EF
    nu15 = torch.minimum(wr._numet15(4.41, 0.8, te, ti, TF),
                         wr._numax15(0.7, EF, te, ne28 / Z))
    gamma_p = nu15 * wr.NU15
    omega_pl = (wr._WPL28_15 * wr.NU15) * torch.sqrt(ne28)
    ones = torch.ones_like(te)
    return torch.stack([DL_STATIC[0] * ones, gamma_p, DL_STATIC[2] * ones,
                        DL_STATIC[3] * ones, DL_STATIC[4] * ones, omega_pl])


def source_envelope(params: FDTDParams, t_si):
    """laser_timefun: the Gaussian field envelope E0 exp(-(t-t0)^2/(2 s^2))
    (+ a second pulse), imd_ttm_3D.c:95-101.  ``t_si`` a tensor or a
    float."""
    exp = torch.exp if torch.is_tensor(t_si) else math.exp
    env = params.e0 * exp(-0.5 * (t_si - params.t0_s) ** 2
                          / params.sigma_t_s ** 2)
    if params.sigma_t1_s > 0.0:
        env = env + params.e0 * exp(-0.5 * (t_si - params.t1_s) ** 2
                                    / params.sigma_t1_s ** 2)
    return env


def laser_on(params: FDTDParams, t_si: float) -> bool:
    """Whether the envelope at ``t_si`` (host seconds) reaches the
    threshold share of E0."""
    return source_envelope(params, t_si) >= params.e0 * params.threshold


def _add_at(a, i: int, v):
    """a with v added at index i; an index outside the grid adds nothing
    (the drop mode of imd_tpu's ``.at[i].add``)."""
    if not 0 <= i < a.shape[0]:
        return a
    a = a.clone()
    a[i] += v
    return a


def step_1d(state: FDTDState, params: FDTDParams, dl: torch.Tensor,
            active: torch.Tensor, t_si) -> FDTDState:
    """One 1-D FDTD step (do_fdtd FDTD1D branch, imd_fdtd.c:128-310).

    ``dl`` [6, nx] per-cell Drude-Lorentz parameters; ``active`` [nx]
    bool (natoms >= fd_min_atoms); ``t_si`` the time in seconds (a 0-d
    tensor)."""
    dt = params.dt_s
    dx = params.fd_dx_m
    eps_inf, gamma_p, wpl_l, w0_l, gamma_l, wpl_d = (dl[k] for k in range(6))
    ez, hy, jz, jlz, pz = (state.ezx, state.hy, state.jzx, state.jlzx,
                           state.pzx)
    jz_old, jlz_old = jz, jlz

    # --- Ez update: n -> n+1 -------------------------------------------
    # Hy_i - Hy_{i-1}, the field zeroed beyond the edge
    dhy = torch.cat([hy[:1], hy[1:] - hy[:-1]])
    cb = dt / (EPS0 * eps_inf)
    ez_disp = ez + cb * dhy / dx - cb * jz - cb * jlz
    # vacuum / PML branch
    den = EPS0 + 0.5 * dt * params.sigma_y
    ez_vac = ((EPS0 - 0.5 * dt * params.sigma_y) / den * ez
              + (dt / dx) / den * dhy)
    ez = torch.where(active, ez_disp, ez_vac)
    pz = torch.where(active, pz + dt * jlz, pz)

    # --- soft source (fdtd_softsource, imd_fdtd.c:113-119) --------------
    sine_next = torch.sin(2.0 * math.pi * (C0 / (dx * params.nlambda))
                          * (t_si + dt))
    hinc = source_envelope(params, t_si + dt) * sine_next / IMP0
    ez = _add_at(ez, params.srcx, (dt / dx / EPS0) * hinc)

    # --- Hy update: n+1/2 -> n+3/2 --------------------------------------
    sigstar = params.sigma_y * (MU0 / EPS0)
    denh = MU0 + 0.5 * dt * sigstar
    hy1 = (MU0 - 0.5 * dt * sigstar) / denh
    hy2 = (dt / dx) / denh
    dez = torch.cat([ez[1:] - ez[:-1], -ez[-1:]])
    hy = hy1 * hy + hy2 * dez

    # --- TF/SF back-correction (imd_fdtd.c:292-304) ----------------------
    sine_now = torch.sin(2.0 * math.pi * (C0 / (dx * params.nlambda))
                         * t_si)
    einc = source_envelope(params, t_si) * sine_now
    hy = _add_at(hy, params.srcx - 1, -(dt / dx / MU0) * einc)

    # --- ADE current updates (n+1/2 -> n+3/2) ----------------------------
    cd1 = (2.0 - dt * gamma_p) / (2.0 + dt * gamma_p)
    cd2 = 2.0 * dt / (2.0 + dt * gamma_p)
    cl1 = (2.0 - dt * gamma_l) / (2.0 + dt * gamma_l)
    cl2 = 2.0 * dt / (2.0 + dt * gamma_l)
    jz_new = cd1 * jz + cd2 * ((EPS0 * wpl_d ** 2) * ez)
    jlz_new = cl1 * jlz + cl2 * ((EPS0 * wpl_l ** 2) * ez - w0_l ** 2 * pz)
    jz = torch.where(active, jz_new, 0.0)
    jlz = torch.where(active, jlz_new, 0.0)

    # --- Joule heating power density (imd_fdtd.c:270-283), grouped as
    # (J/wp)^2 * (gamma/eps0): the literal gamma*J^2 ~ 1e45 overflows f32
    jz_mid = 0.5 * (jz + jz_old)
    jlz_mid = 0.5 * (jlz + jlz_old)
    qe = ((jz_mid / torch.clamp(wpl_d, min=1.0)) ** 2 * (gamma_p / EPS0)
          + (jlz_mid / torch.clamp(wpl_l, min=1.0)) ** 2 * (gamma_l / EPS0))
    source = torch.where(active, qe * WM3_TO_IMD, 0.0)
    return state.replace(ezx=ez, hy=hy, jzx=jz, jlzx=jlz, pzx=pz,
                         source=source)


def run_substeps(state: FDTDState, params: FDTDParams, dl, active,
                 t_si_start, n_steps: int) -> FDTDState:
    """``n_steps`` consecutive FDTD steps from ``t_si_start`` (the outer
    Maxwell loop of the coupled TTM scheme, imd_ttm_3D.c:163-180)."""
    for i in range(n_steps):
        state = step_1d(state, params, dl, active,
                        t_si_start + i * params.dt_s)
    return state


def fdtd_substeps_per_md(params: FDTDParams, md_dt_imd: float) -> int:
    """The static outer-loop count: MD step duration / dt_FDTD + 1
    (imd_ttm_3D.c:112)."""
    return int(md_dt_imd * units.IMD_TIME_S / params.dt_s + 1.0)
