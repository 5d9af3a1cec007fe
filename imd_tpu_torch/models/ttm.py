"""Two-temperature model on a 1-D electron FD grid (port of
imd_tpu/models/ttm.py; the reference's calc_ttm, imd_ttm.c:75-156).

  update_fd  -> per-column natoms / v_com / T_i / neighbour density / fluxes
  do_adv     -> donor-cell advection of electron energy with atom fluxes
  activation -> (de)activate cells at fd_min_atoms / RHOMIN thresholds
  fill_mesh  -> wide-range Z, n_e, C_e, kappa, g
  CFL        -> substep count; substep x N: laser source + explicit diffusion
  xi         -> e-ph coupling accumulated for the integrator

Torch re-design: the atom<->column sums are ``index_add_`` and the per-atom
gathers are indexing (the JAX package uses one-hot matmuls, a TPU
workaround).  The explicit solver's CFL substep count is read to the host
once per step (one sync) and drives a Python loop, where the JAX package
runs a traced fori_loop; the implicit solver runs ``n_sub`` substeps with
no host read, each a tridiagonal solve by cyclic reduction (log depth, where
imd_tpu's Thomas recurrence is a sequential scan).  Flags that are
host-known (``first_step``, ``init_done``, ``cfl_overflow``) are Python
bools.  TTM parameters stay Python floats so the state keeps its dtype.

The laser is the Lambert-Beer source (``laser_cfg``) or the TMM solver
(``tmm_params``, models/tmm.py), which recomputes the source every
substep, or the FDTD Maxwell solver (``calc_ttm_fdtd``, models/fdtd.py).
COLRAD (models/colrad.py) runs before the diffusion and then owns Z and
n_e; the virtual lattice (VLATTICE: ``vlat_substep``) continues the grid
behind its last active cell in every substep; ``electron_pressure_force``
is ELECPRESS's blast force.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from imd_tpu_torch import units
from imd_tpu_torch.models import colrad as colrad_mod
from imd_tpu_torch.models import fdtd as fdtd_mod
from imd_tpu_torch.models import tmm as tmm_mod
from imd_tpu_torch.models import widerange as wr
from imd_tpu_torch.models.eos import FEGEos
from imd_tpu_torch.ops.geometry import np_dtype

RHOMIN = 2.0         # kg/m^3 (imd_ttm.c:69)
TE_MIN_EV = 0.0026   # ~30 K: "Temin" sanity floor for fresh cells


@dataclasses.dataclass(frozen=True)
class TTMParams:
    """Static TTM configuration (host floats)."""
    nx: int
    fd_h_x: float        # cell width (A)
    fd_vol: float        # cell volume (A^3)
    neigh_vol: float     # 4/3 pi rcut^3 (A^3)
    atomic_mass: float
    atomic_z: float
    fd_min_atoms: int
    rho_min: float = RHOMIN
    max_substeps: int = 65536
    fd_n_timesteps: int = 1
    cfl_safety: float = 0.9
    const_kappa: float = 0.0
    const_gamma: float = 0.0
    const_ce: float = 0.0
    fix_t_el: bool = False
    omega_laser: float = 0.0
    solver: str = "explicit"
    n_sub: int = 10


@dataclasses.dataclass(eq=False)
class TTMGrid:
    """The 1-D electron grid state ([nx] tensors)."""
    temp: torch.Tensor        # T_e (eV)
    md_temp: torch.Tensor     # T_i (eV)
    U: torch.Tensor           # electron internal energy (eV/atom)
    natoms: torch.Tensor      # int32
    natoms_old: torch.Tensor  # int32
    dens: torch.Tensor        # ambient density (kg/m^3)
    vcom: torch.Tensor        # [nx,3] centre-of-mass velocity
    xi: torch.Tensor          # e-ph coupling accumulator (1/time-unit)
    source: torch.Tensor      # laser power density
    Z: torch.Tensor
    ne: torch.Tensor
    Ce: torch.Tensor
    fd_k: torch.Tensor
    fd_g: torch.Tensor
    flux_right: torch.Tensor  # int32: atoms received from +x
    flux_left: torch.Tensor   # int32: atoms received from -x
    eabs: torch.Tensor        # scalar: absorbed laser energy (eV)
    init_done: bool = False
    # the CFL-demanded substep count exceeded max_substeps (the explicit
    # scheme then ran beyond its stability limit); check like overflow
    cfl_overflow: bool = False

    def replace(self, **kw) -> "TTMGrid":
        return dataclasses.replace(self, **kw)


def active_mask(grid: TTMGrid, params: TTMParams) -> torch.Tensor:
    return (grid.natoms >= params.fd_min_atoms) & (grid.dens > params.rho_min)


def make_params(cfg_ttm, box, cutoff: float) -> TTMParams:
    """TTMParams from an imd_tpu.config.TTMConfig (init_ttm,
    imd_ttm.c:955-1200)."""
    bx = float(np.asarray(box.h)[0, 0])
    heights = box.heights()
    fd_h_x = float(bx / cfg_ttm.fd_nx)
    return TTMParams(
        nx=cfg_ttm.fd_nx, fd_h_x=fd_h_x,
        fd_vol=float(fd_h_x * heights[1] * heights[2]),
        neigh_vol=4.0 / 3.0 * math.pi * cutoff ** 3,
        atomic_mass=cfg_ttm.atomic_mass, atomic_z=cfg_ttm.atomic_z,
        fd_min_atoms=cfg_ttm.fd_min_atoms,
        max_substeps=cfg_ttm.max_substeps, cfl_safety=cfg_ttm.cfl_safety,
        const_kappa=cfg_ttm.fd_k, const_gamma=cfg_ttm.fd_g,
        const_ce=cfg_ttm.fd_c, fix_t_el=cfg_ttm.fix_t_el,
        solver=cfg_ttm.solver, n_sub=cfg_ttm.n_sub)


def make_grid(params: TTMParams, dtype=torch.float32,
              device="cuda") -> TTMGrid:
    nx = params.nx

    def z():
        return torch.zeros((nx,), dtype=dtype, device=device)

    def zi():
        return torch.zeros((nx,), dtype=torch.int32, device=device)

    return TTMGrid(temp=z(), md_temp=z(), U=z(), natoms=zi(),
                   natoms_old=zi(), dens=z(),
                   vcom=torch.zeros((nx, 3), dtype=dtype, device=device),
                   xi=z(), source=z(), Z=z(), ne=z(), Ce=z(), fd_k=z(),
                   fd_g=z(), flux_right=zi(), flux_left=zi(),
                   eabs=torch.zeros((), dtype=dtype, device=device))


def fd_index_from_x(x, params: TTMParams) -> torch.Tensor:
    """FD column index from x coordinates (any layout), clamped."""
    i = torch.floor(x / params.fd_h_x).to(torch.int32)
    return torch.clamp(i, 0, params.nx - 1)


def update_fd_flat(grid: TTMGrid, params: TTMParams, x, mom3, mass, mask,
                   num_neighs, fdi_prev, first_step: bool):
    """Atoms -> grid reductions + advection fluxes on flat component
    arrays (update_fd, imd_ttm.c:161-548).  Returns (grid, fdi_new)."""
    dtype = x.dtype
    nx = params.nx
    fm = mask.to(dtype)
    fdi = fd_index_from_x(x, params)
    seg = torch.where(mask, fdi, nx).to(torch.int64)  # dead -> bucket nx

    moved = mask & (fdi_prev >= 0) & (fdi_prev != fdi)
    if first_step:
        moved = torch.zeros_like(moved)
    from_right = (moved & (fdi_prev > fdi)).to(dtype)
    from_left = (moved & (fdi_prev < fdi)).to(dtype)
    mx, my, mz = (m * fm for m in mom3)
    fields = torch.stack([fm, num_neighs.to(dtype) * fm, mx, my, mz,
                          from_right, from_left], 1)
    sums = torch.zeros((nx + 1, 7), dtype=dtype, device=x.device)
    sums = sums.index_add_(0, seg, fields)[:nx]
    natoms = sums[:, 0].to(torch.int32)
    natf = natoms.to(dtype)
    totneighs = sums[:, 1]
    mom_sum = sums[:, 2:5]
    totmass = natf * params.atomic_mass
    vcom = torch.where(totmass[:, None] > 0,
                       mom_sum / totmass[:, None], 0.0)

    # md_temp: sum m (v - vcom)^2 / (3 N), vcom gathered back per atom
    vcom_atom = torch.cat([vcom, torch.zeros_like(vcom[:1])])[seg]
    inv_mass = 1.0 / torch.clamp(mass, min=1e-30)
    dv2 = sum((mom3[k] * inv_mass - vcom_atom[:, k]) ** 2 for k in range(3))
    mdt = torch.zeros((nx + 1,), dtype=dtype, device=x.device)
    mdt = mdt.index_add_(0, seg, dv2 * fm * fm * mass)[:nx]
    md_temp = torch.where(natoms > 0,
                          mdt / (3.0 * torch.clamp(natf, min=1.0)), 0.0)

    # ambient density from neighbour counts (imd_ttm.c:418); fallback:
    # nominal cell density when no neighbours were counted
    dens = torch.where(
        natoms > 0,
        totneighs / torch.clamp(natf, min=1.0)
        * params.atomic_mass / params.neigh_vol * 1660.53907, 0.0)
    dens = torch.where((natoms > 0) & (dens == 0.0),
                       natf * params.atomic_mass / params.fd_vol
                       * 1660.53907, dens)

    # first touch: initialize T_e = T_i on active cells (imd_ttm.c:500)
    if grid.init_done:
        temp = grid.temp
    else:
        act = (natoms >= params.fd_min_atoms) & (dens > params.rho_min)
        temp = torch.where(act, md_temp, 0.0)

    grid = grid.replace(
        temp=temp, md_temp=md_temp, natoms=natoms,
        natoms_old=natoms if first_step else grid.natoms,
        dens=dens, vcom=vcom, xi=torch.zeros_like(grid.xi),
        source=torch.zeros_like(grid.source),
        flux_right=sums[:, 5].to(torch.int32),
        flux_left=sums[:, 6].to(torch.int32), init_done=True)
    return grid, torch.where(mask, fdi, torch.full_like(fdi, -1))


def _ne(grid: TTMGrid, params: TTMParams) -> torch.Tensor:
    """Quasi-neutral electron density from the current Z (imd_ttm.c:678)."""
    dens = torch.clamp(grid.dens, min=1e-3)
    Z = wr.mean_charge(torch.clamp(grid.temp, min=1e-6), dens,
                       params.atomic_z, params.atomic_mass)
    return torch.clamp(Z, min=1e-3) * dens / (params.atomic_mass * wr.AMU)


def do_adv(grid: TTMGrid, params: TTMParams, eos: FEGEos,
           first_step: bool) -> TTMGrid:
    """Donor-cell advection of per-atom electron energy U (do_ADV,
    imd_ttm.c:1208)."""
    dtype = grid.U.dtype
    n_old = grid.natoms_old.to(dtype)
    n_new = grid.natoms.to(dtype)
    U = grid.U
    U_p = torch.roll(U, -1)
    U_m = torch.roll(U, 1)
    fr = grid.flux_right.to(dtype)
    fl = grid.flux_left.to(dtype)
    fr_m = torch.roll(fr, 1)
    fl_p = torch.roll(fl, -1)
    nn1 = torch.clamp(n_new, min=1.0)
    U2 = torch.where(
        n_new > 0,
        U * n_old / nn1
        + (fr * U_p - fl_p * U + fl * U_m - fr_m * U) / nn1, 0.0)
    if first_step:
        return grid.replace(U=U2)
    act = active_mask(grid, params)
    temp2 = torch.where(act, eos.te_from_u(grid.dens, _ne(grid, params), U2),
                        grid.temp)
    temp2 = torch.where(n_new > 0, temp2, 0.0)
    return grid.replace(U=U2, temp=temp2)


def cell_activation(grid: TTMGrid, params: TTMParams,
                    eos: FEGEos) -> TTMGrid:
    """Fresh cells with unusable T_e get the neighbour average or T_i
    (do_cell_activation, imd_ttm.c:1311-1425)."""
    act_now = active_mask(grid, params)
    was = grid.natoms_old >= params.fd_min_atoms
    fresh = ~was & (grid.natoms >= params.fd_min_atoms) \
        & (grid.dens > params.rho_min)
    bad = fresh & (torch.isnan(grid.temp) | (grid.temp <= TE_MIN_EV))
    t2 = torch.where(act_now, grid.temp ** 2, 0.0)
    cnt = act_now.to(grid.temp.dtype)
    t2_sum = torch.roll(t2, 1) + torch.roll(t2, -1)
    n_sum = torch.roll(cnt, 1) + torch.roll(cnt, -1)
    t_avg = torch.sqrt(t2_sum / torch.clamp(n_sum, min=1.0))
    t_new = torch.where(n_sum > 0, t_avg, grid.md_temp)
    t_new = torch.where(t_new < TE_MIN_EV, grid.md_temp, t_new)
    temp = torch.where(bad, t_new, grid.temp)
    ne = _ne(grid.replace(temp=temp), params)
    U = torch.where(bad, eos.u_from_te(grid.dens, ne, temp), grid.U)
    return grid.replace(temp=temp, U=U)


def fill_mesh(grid: TTMGrid, params: TTMParams, eos: FEGEos,
              laser_active=False, keep_zne: bool = False) -> TTMGrid:
    """Wide-range transport properties per cell (do_FILLMESH, ttm:629).
    ``keep_zne``: COLRAD owns Z and n_e, only Ce, kappa and g are
    refreshed."""
    act = active_mask(grid, params)
    temp = torch.clamp(grid.temp, min=1e-6)
    dens = torch.clamp(grid.dens, min=1e-3)
    md_temp = torch.clamp(grid.md_temp, min=1e-6)
    if keep_zne:
        Z = torch.clamp(grid.Z, min=1e-3)
        ne = torch.clamp(grid.ne, min=1.0)
    else:
        Z = torch.clamp(wr.mean_charge(temp, dens, params.atomic_z,
                                       params.atomic_mass), min=1e-3)
        ne = Z * dens / (params.atomic_mass * wr.AMU)
    if params.const_ce > 0:
        Ce = params.const_ce * temp
    else:
        Ce = eos.ce(dens, ne, temp)
    if params.const_kappa > 0:
        fd_k = torch.full_like(temp, params.const_kappa)
    else:
        fd_k = wr.get_kappa(temp, md_temp, ne, Z, params.omega_laser,
                            laser_active)
    if params.const_gamma > 0:
        fd_g = torch.full_like(temp, params.const_gamma)
    else:
        fd_g = wr.get_gamma(temp, md_temp, ne, Z, params.atomic_mass,
                            params.omega_laser, laser_active)
    return grid.replace(Z=torch.where(act, Z, 0.0),
                        ne=torch.where(act, ne, 0.0),
                        Ce=torch.where(act, Ce, 0.0),
                        fd_k=torch.where(act, fd_k, 0.0),
                        fd_g=torch.where(act, fd_g, 0.0))


def cfl_substeps(grid: TTMGrid, params: TTMParams, dt: float):
    """CFL substep count (CFL_maxdt, imd_ttm.c:2444) as a device int32
    scalar, and whether it exceeds max_substeps (bool tensor)."""
    act = active_mask(grid, params)
    act_p = torch.roll(act, -1)
    k_p = torch.where(act_p, torch.roll(grid.fd_k, -1), grid.fd_k)
    khalf = grid.fd_k + k_p
    dx2 = params.fd_h_x ** 2
    lim = torch.where(act & (khalf > 0),
                      grid.Ce * dx2 / torch.clamp(khalf, min=1e-30),
                      math.inf)
    max_dt = params.cfl_safety * lim.min()
    ratio = torch.clamp(dt / torch.clamp(max_dt, min=1e-12),
                        max=2.0 * params.max_substeps)
    sub = torch.clamp(torch.ceil(ratio).to(torch.int32),
                      min=params.fd_n_timesteps)
    return torch.clamp(sub, max=params.max_substeps), \
        sub > params.max_substeps


def _absorb(grid: TTMGrid, params: TTMParams, act, tau: float,
            laser_active):
    """eabs plus the laser energy the active cells took this substep while
    the laser is on (a Python flag or a device bool; a flag is decided on
    the host, where a tensor made of it would wait for the stream)."""
    if isinstance(laser_active, bool) and not laser_active:
        return grid.eabs
    absorbed = torch.where(act, grid.source, 0.0).sum() * params.fd_vol * tau
    if isinstance(laser_active, bool):
        return grid.eabs + absorbed
    return grid.eabs + torch.where(laser_active, absorbed, 0.0)


def diff_step(grid: TTMGrid, params: TTMParams, tau: float, substeps: int,
              laser_active) -> TTMGrid:
    """One explicit conservative variable-kappa diffusion substep
    (do_DIFF, imd_ttm.c:1473)."""
    act = active_mask(grid, params)
    T = grid.temp
    k = grid.fd_k
    act_p = torch.roll(act, -1)
    act_m = torch.roll(act, 1)
    T_p = torch.where(act_p, torch.roll(T, -1), T)
    T_m = torch.where(act_m, torch.roll(T, 1), T)
    k_p = torch.where(act_p, torch.roll(k, -1), k)
    k_m = torch.where(act_m, torch.roll(k, 1), k)
    inv_dx2 = 1.0 / params.fd_h_x ** 2
    Ce = torch.clamp(grid.Ce, min=1e-30)
    lap = ((k + k_p) * 0.5 * (T_p - T) - (k + k_m) * 0.5 * (T - T_m)) \
        * inv_dx2
    dT = tau / Ce * (lap - grid.fd_g * (T - grid.md_temp) + grid.source)
    T2 = T if params.fix_t_el else torch.where(act, T + dT, T)
    U2 = grid.U + torch.where(
        act, (T2 - T) * Ce * params.fd_vol
        / torch.clamp(grid.natoms, min=1), 0.0)
    xi_fac = params.atomic_mass * wr.AMU / 3.0 * 1e30 / max(substeps, 1)
    dxi = torch.where(act & (grid.md_temp > 1e-12) & (grid.dens > 0),
                      (T2 - grid.md_temp) * xi_fac * grid.fd_g
                      / torch.clamp(grid.md_temp, min=1e-12)
                      / torch.clamp(grid.dens, min=1e-12), 0.0)
    eabs = _absorb(grid, params, act, tau, laser_active)
    return grid.replace(temp=T2, U=U2, xi=grid.xi + dxi, eabs=eabs)


def tridiag_solve(a, b, c, d):
    """Solve the tridiagonal system a_i x_{i-1} + b_i x_i + c_i x_{i+1} =
    d_i ([n] tensors; a[0] and c[-1] are ignored) by cyclic reduction:
    each level folds the even rows into the odd ones, log2(n) levels down
    and back, no per-row loop.  Stable for diagonally dominant systems
    (|b| >= |a| + |c|: backward-Euler diffusion), like imd_tpu's Thomas
    recurrence (_thomas), whose result it equals up to rounding."""
    n = b.shape[0]
    a = torch.cat([a.new_zeros(1), a[1:]])
    c = torch.cat([c[:-1], c.new_zeros(1)])
    # pad to 2^k - 1 rows with decoupled identity rows (b 1, a = c = d 0)
    size = 1
    while size < n:
        size = 2 * size + 1
    pad = size - n
    if pad:
        zero = b.new_zeros(pad)
        a, c, d = (torch.cat([v, zero]) for v in (a, c, d))
        b = torch.cat([b, zero + 1.0])
    return _cr(a, b, c, d)[:n]


def _cr(a, b, c, d):
    """Cyclic reduction on 2^k - 1 rows (a[0] = c[-1] = 0)."""
    if b.shape[0] == 1:
        return d / b
    # the odd rows 1, 3, 5, ... take in their even neighbours i-1 and i+1
    # and form the next level
    ae, be, ce, de = a[1::2], b[1::2], c[1::2], d[1::2]
    al = -ae / b[0:-1:2]
    ga = -ce / b[2::2]
    a2 = al * a[0:-1:2]
    c2 = ga * c[2::2]
    b2 = be + al * c[0:-1:2] + ga * a[2::2]
    d2 = de + al * d[0:-1:2] + ga * d[2::2]
    x_odd = _cr(a2, b2, c2, d2)
    # the eliminated rows from their two solved neighbours
    zero = x_odd.new_zeros(1)
    x_l = torch.cat([zero, x_odd])
    x_r = torch.cat([x_odd, zero])
    x_even = (d[0::2] - a[0::2] * x_l - c[0::2] * x_r) / b[0::2]
    x = torch.stack([x_even[:-1], x_odd], 1).reshape(-1)
    return torch.cat([x, x_even[-1:]])


def diff_step_implicit(grid: TTMGrid, params: TTMParams, tau: float,
                       substeps: int, laser_active) -> TTMGrid:
    """One backward-Euler diffusion substep (imd_tpu
    diff_step_implicit, models/ttm.py:442): one tridiagonal solve of

        (Ce/tau + cm + cp + g) T' - cm T'_m - cp T'_p
            = Ce/tau T + g T_i + S

    with the face conductivities cm/cp = (k + k_nbr)/2 dx^-2 zeroed at
    inactive neighbours and at the ends of the (non-periodic) grid.  The
    coefficients lag at the substep start; the energy, xi and eabs
    bookkeeping is diff_step's."""
    act = active_mask(grid, params)
    T = grid.temp
    k = grid.fd_k
    act_p = torch.roll(act, -1)
    act_m = torch.roll(act, 1)
    k_p = torch.roll(k, -1)
    k_m = torch.roll(k, 1)
    inv_dx2 = 1.0 / params.fd_h_x ** 2
    nx = T.shape[0]
    idx = torch.arange(nx, device=T.device)
    cp = torch.where(act & act_p & (idx < nx - 1),
                     (k + k_p) * 0.5 * inv_dx2, 0.0)
    cm = torch.where(act & act_m & (idx > 0), (k + k_m) * 0.5 * inv_dx2, 0.0)
    Ce = torch.clamp(grid.Ce, min=1e-30)
    g = grid.fd_g
    a = torch.where(act, -cm, 0.0)
    c = torch.where(act, -cp, 0.0)
    b = torch.where(act, Ce / tau + cm + cp + g, 1.0)
    rhs = torch.where(act, Ce / tau * T + g * grid.md_temp + grid.source, T)
    T2 = T if params.fix_t_el else tridiag_solve(a, b, c, rhs)
    T2 = torch.where(act, T2, T)
    U2 = grid.U + torch.where(
        act, (T2 - T) * Ce * params.fd_vol
        / torch.clamp(grid.natoms, min=1), 0.0)
    xi_fac = params.atomic_mass * wr.AMU / 3.0 * 1e30 / max(substeps, 1)
    dxi = torch.where(act & (grid.md_temp > 1e-12) & (grid.dens > 0),
                      (T2 - grid.md_temp) * xi_fac * grid.fd_g
                      / torch.clamp(grid.md_temp, min=1e-12)
                      / torch.clamp(grid.dens, min=1e-12), 0.0)
    eabs = _absorb(grid, params, act, tau, laser_active)
    return grid.replace(temp=T2, U=U2, xi=grid.xi + dxi, eabs=eabs)


# ---------------------------------------------------------------------------
# the virtual lattice (VLATTICE, imd_ttm.c:41-59, 1602-1657)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VlatParams:
    """Virtual-lattice continuum tail: ``nv`` (vlatdim) continuum-only 2T
    cells behind the sample's rear (+x), the heat sink of the full target
    depth without its atoms."""
    nv: int
    dens0: float         # solid density kg/m^3
    ci: float            # lattice C_i, eV/(eV A^3)
    atomic_z: float = 13.0
    atomic_mass: float = 26.9815


@dataclasses.dataclass(eq=False)
class VlatState:
    te: torch.Tensor     # [nv] electron temperature (eV)
    ti: torch.Tensor     # [nv] lattice temperature (eV)


def make_vlat(nv: int, dens0: float = 2700.0, t0: float = 0.0253,
              ci: float | None = None, dtype=torch.float32, device="cuda",
              atomic_z: float = 13.0, atomic_mass: float = 26.9815):
    """(VlatParams, VlatState) at ``t0``; ``ci`` defaults to Dulong-Petit
    3 n k_B at ``dens0``."""
    n_a3 = dens0 / (atomic_mass * wr.AMU) * 1e-30    # atoms per A^3
    ci = ci if ci is not None else 3.0 * n_a3
    p = VlatParams(nv=nv, dens0=dens0, ci=ci, atomic_z=atomic_z,
                   atomic_mass=atomic_mass)
    s = VlatState(te=torch.full((nv,), t0, dtype=dtype, device=device),
                  ti=torch.full((nv,), t0, dtype=dtype, device=device))
    return p, s


def _vlat_props(vs: VlatState, vp: VlatParams, eos: FEGEos):
    """kappa, g and Ce of the virtual cells at the solid density."""
    dens = torch.full_like(vs.te, vp.dens0)
    te = torch.clamp(vs.te, min=1e-6)
    ti = torch.clamp(vs.ti, min=1e-6)
    Z = torch.clamp(wr.mean_charge(te, dens, vp.atomic_z, vp.atomic_mass),
                    min=1e-3)
    ne = Z * dens / (vp.atomic_mass * wr.AMU)
    kv = wr.get_kappa(te, ti, ne, Z)
    gv = wr.get_gamma(te, ti, ne, Z, vp.atomic_mass)
    cev = torch.clamp(eos.ce(dens, ne, te), min=1e-12)
    return kv, gv, cev


def vlat_substep(grid: TTMGrid, vs: VlatState, params: TTMParams,
                 vp: VlatParams, eos: FEGEos, tau: float):
    """One substep of the virtual lattice and its exchange with the last
    active MD cell (imd_tpu vlat_substep): the chain's T_e diffusion is one
    backward-Euler tridiagonal solve over nv + 1 cells, the last active
    cell (a ``max`` over the active mask, no host read) in front; the e-ph
    exchange of the virtual cells stays explicit.  Returns (grid, vs)."""
    kv, gv, cev = _vlat_props(vs, vp, eos)
    inv_dx2 = 1.0 / params.fd_h_x ** 2
    act = active_mask(grid, params)
    idx = torch.arange(params.nx, device=grid.temp.device)
    last = torch.where(act, idx, -1).max()
    has_edge = last >= 0
    li = torch.clamp(last, min=0)
    te_edge = grid.temp[li]
    k_edge = torch.where(has_edge, grid.fd_k[li], 0.0)
    ce_edge = torch.clamp(grid.Ce[li], min=1e-12)

    te_c = torch.cat([te_edge[None], vs.te])            # [nv+1]
    k_c = torch.cat([k_edge[None], kv])
    ce_c = torch.cat([ce_edge[None], cev])
    g_c = torch.cat([torch.zeros_like(gv[:1]), gv])     # edge e-ph in
    ti_c = torch.cat([vs.ti[:1], vs.ti])                # diff_step
    zero = torch.zeros_like(k_c[:1])
    k_m = torch.cat([zero, k_c[:-1]])
    k_p = torch.cat([k_c[1:], zero])
    w_m = (k_c + k_m) * 0.5 * inv_dx2 / ce_c
    w_p = (k_c + k_p) * 0.5 * inv_dx2 / ce_c
    # the edge's grid side is the grid solver's; zero flux at the far end
    w_m = torch.cat([zero, w_m[1:]])
    w_p = torch.cat([w_p[:-1], zero])
    a = -tau * w_m
    c = -tau * w_p
    b = 1.0 + tau * (w_m + w_p)
    rhs = te_c - tau / ce_c * g_c * (te_c - ti_c)
    te_new = tridiag_solve(a, b, c, rhs)
    dti = tau / vp.ci * gv * (vs.te - vs.ti)
    new_temp = torch.where((idx == li) & has_edge, te_new[0], grid.temp)
    return (grid.replace(temp=new_temp),
            VlatState(te=torch.where(has_edge, te_new[1:], vs.te),
                      ti=vs.ti + dti))


def lambert_beer_source(grid: TTMGrid, params: TTMParams, laser_cfg, t):
    """Exponential Lambert-Beer volumetric source on the FD grid
    (laser_rescale_ttm mode 4, imd_laser.c:715).  ``t`` is a 0-d tensor
    of the grid dtype.  Returns (grid, laser_active bool tensor)."""
    dtype = grid.temp.dtype
    mu = laser_cfg.mu
    sig_t = max(laser_cfg.sigma_t, 1e-30)
    p_peak = mu * laser_cfg.sigma_e / sig_t / math.sqrt(2.0 * math.pi)
    g_t = torch.exp(-((t - laser_cfg.t_0) ** 2) / (2.0 * sig_t ** 2)) \
        * p_peak
    if laser_cfg.sigma_e1 > 0:
        sig_t1 = max(laser_cfg.sigma_t1, 1e-30)
        p1 = mu * laser_cfg.sigma_e1 / sig_t1 / math.sqrt(2.0 * math.pi)
        g_t = g_t + torch.exp(-((t - laser_cfg.t_1) ** 2)
                              / (2.0 * sig_t1 ** 2)) * p1
    active = g_t >= p_peak * 0.001
    act = active_mask(grid, params)
    idx = torch.arange(params.nx, device=grid.temp.device)
    first_active = torch.where(act, idx, params.nx).min()
    x_cell = (idx.to(dtype) + 0.5) * params.fd_h_x
    depth = torch.clamp(x_cell - first_active.to(dtype) * params.fd_h_x
                        - laser_cfg.offset, min=0.0)
    src = torch.where(act, g_t * torch.exp(-mu * depth), 0.0)
    return grid.replace(source=src.to(dtype)), active


def calc_ttm(grid: TTMGrid, atoms, params: TTMParams, eos: FEGEos,
             num_neighs, fdi_prev, dt: float, t, laser_cfg=None,
             first_step: bool = False, tmm_params=None, colrad=None,
             vlat=None, counters=None):
    """One MD step of TTM (calc_ttm, imd_ttm.c:75): reductions,
    advection, activation, substepped diffusion.

    ``atoms`` = (x, (px, py, pz), mass, mask) flat component tensors;
    ``t`` the step time as a 0-d tensor.  The explicit solver takes the CFL
    substep count (one host read, counted in ``counters``); the implicit
    solver ``n_sub`` substeps.  With ``tmm_params`` (models/tmm.py) the TMM
    solver recomputes the source at every substep, at t + i tau in SI
    seconds (tmm_time, imd_ttm.c:117), and its own pulse gate switches the
    absorbed-energy count and the laser's Coulomb-log branch.

    ``colrad`` = (tables, step_fn, cstate[, phi_fn]) runs the COLRAD
    kinetics before the diffusion (the do_colrad hook, imd_ttm.c:101-103):
    ``fill_mesh`` for Ce first, then ``apply_colrad`` owns Z, n_e and T_e,
    and every later ``fill_mesh`` and the final U keep its Z and n_e;
    ``phi_fn(t_si)`` gives the MULTIPHOTON photon flux at the step time.
    ``vlat`` = (VlatParams, VlatState) runs ``vlat_substep`` after every
    diffusion substep.  Returns (grid, fdi_new[, cstate][, vstate])."""
    if params.solver not in ("explicit", "implicit"):
        raise ValueError(f"unknown TTM solver {params.solver!r}")
    x, mom3, mass, mask = atoms
    grid, fdi = update_fd_flat(grid, params, x, mom3, mass, mask,
                               num_neighs, fdi_prev, first_step)
    grid = do_adv(grid, params, eos, first_step)
    grid = cell_activation(grid, params, eos)
    keep_zne = colrad is not None
    cstate = None
    if colrad is not None:
        tab, colrad_step, cstate = colrad[:3]
        phi_fn = colrad[3] if len(colrad) > 3 else None
        phi = None if phi_fn is None else phi_fn(t * units.IMD_TIME_S)
        grid = fill_mesh(grid, params, eos, False)   # Ce for dTe/dt
        grid, cstate, _ = colrad_mod.apply_colrad(
            grid, cstate, tab, params, colrad_step, dt, phi,
            counters=counters)
    laser_active = False
    if laser_cfg is not None and laser_cfg.sigma_e > 0:
        grid, laser_active = lambert_beer_source(grid, params, laser_cfg, t)
    grid = fill_mesh(grid, params, eos, laser_active, keep_zne)
    if params.solver == "implicit":
        substeps = max(params.n_sub, 1)
        step_fn = diff_step_implicit
    else:
        sub_t, clamped_t = cfl_substeps(grid, params, dt)
        substeps, clamped = (int(v) for v in
                             torch.stack([sub_t, clamped_t.to(torch.int32)])
                             .tolist())
        if counters is not None:
            counters.host_syncs += 1
        grid = grid.replace(cfl_overflow=grid.cfl_overflow or bool(clamped))
        step_fn = diff_step
    if counters is not None:
        counters.cfl_substeps += substeps
    vparams, vstate = vlat if vlat is not None else (None, None)
    dt_np = np_dtype(grid.temp.dtype).type
    tau = float(dt_np(dt) / dt_np(substeps))
    on = laser_active
    for i in range(substeps):
        if tmm_params is not None:
            t_si = (t + i * tau) * units.IMD_TIME_S
            grid, diag = tmm_mod.do_tmm(grid, params, tmm_params, t_si)
            on = diag["laser_active"]
        grid = step_fn(grid, params, tau, substeps, on)
        if vparams is not None:
            grid, vstate = vlat_substep(grid, vstate, params, vparams, eos,
                                        tau)
        grid = fill_mesh(grid, params, eos, on, keep_zne)
    # final U consistent with T via the EOS (imd_ttm.c:131-145)
    act = active_mask(grid, params)
    ne = grid.ne if keep_zne else _ne(grid, params)
    U = torch.where(act, eos.u_from_te(grid.dens, ne, grid.temp), grid.U)
    out = (grid.replace(U=U), fdi)
    if colrad is not None:
        out = out + (cstate,)
    if vlat is not None:
        out = out + (vstate,)
    return out


def calc_ttm_fdtd(grid: TTMGrid, fdtd_state, atoms, params: TTMParams,
                  eos: FEGEos, fdtd_params, num_neighs, fdi_prev, dt: float,
                  t, t_host: float, first_step: bool = False,
                  counters=None):
    """calc_ttm with the FDTD Maxwell solver as the laser source (imd_tpu
    calc_ttm_fdtd; imd_ttm_3D.c:110-180): ``fdtd_substeps_per_md`` Maxwell
    steps at the light-CFL timestep (a static count), each followed by
    n_diff = ceil(CFL substeps / n_fdtd) explicit diffusion substeps.
    ``t`` is the step time as a 0-d tensor and ``t_host`` the same time as
    a float: the pulse's on/off switch (imd_tpu's ``lax.cond``) is decided
    on the host.  One host read a step, for the CFL count.  Returns (grid,
    fdi_new, fdtd_state)."""
    x, mom3, mass, mask = atoms
    grid, fdi = update_fd_flat(grid, params, x, mom3, mass, mask,
                               num_neighs, fdi_prev, first_step)
    grid = do_adv(grid, params, eos, first_step)
    grid = cell_activation(grid, params, eos)
    grid = fill_mesh(grid, params, eos, True)
    n_fdtd = fdtd_mod.fdtd_substeps_per_md(fdtd_params, dt)
    sub_t, clamped_t = cfl_substeps(grid, params, dt)
    sub_total, clamped = (int(v) for v in torch.stack(
        [sub_t, clamped_t.to(torch.int32)]).tolist())
    grid = grid.replace(cfl_overflow=grid.cfl_overflow or bool(clamped))
    # ceil, not floor: n_fdtd * n_diff must cover the CFL demand
    n_diff = max((sub_total + n_fdtd - 1) // n_fdtd, 1)
    dt_np = np_dtype(grid.temp.dtype).type
    tau = float(dt_np(dt) / dt_np(n_fdtd * n_diff))
    dl = fdtd_mod.fit_dl(grid, params)
    active = grid.natoms >= params.fd_min_atoms
    t_si0 = t * units.IMD_TIME_S
    laser_active = fdtd_mod.laser_on(fdtd_params,
                                     t_host * units.IMD_TIME_S)
    if counters is not None:
        counters.host_syncs += 1
        counters.cfl_substeps += n_fdtd * n_diff
        counters.maxwell_steps += n_fdtd if laser_active else 0
    for i in range(n_fdtd):
        if laser_active:
            fdtd_state = fdtd_mod.step_1d(fdtd_state, fdtd_params, dl,
                                          active,
                                          t_si0 + i * fdtd_params.dt_s)
        grid = grid.replace(source=fdtd_state.source)
        for _ in range(n_diff):
            grid = diff_step(grid, params, tau, n_fdtd * n_diff,
                             laser_active)
            grid = fill_mesh(grid, params, eos, laser_active)
    act = active_mask(grid, params)
    U = torch.where(act, eos.u_from_te(grid.dens, _ne(grid, params),
                                       grid.temp), grid.U)
    return grid.replace(U=U), fdi, fdtd_state


def electron_pressure_force(grid: TTMGrid, params: TTMParams,
                            eos: FEGEos) -> torch.Tensor:
    """Per-cell electron blast force [nx] (do_electronic_pressure,
    imd_ttm.c:554-625): F_x = -dP_e/dx / n_i by central differences, zero
    at the grid's ends; the integrator subtracts it from the x momentum
    update."""
    act = active_mask(grid, params)
    pe = torch.where(act, eos.pe(torch.clamp(grid.dens, min=1e-3),
                                 torch.clamp(grid.ne, min=1.0),
                                 torch.clamp(grid.temp, min=1e-6)), 0.0)
    pe_p = torch.roll(pe, -1)
    pe_m = torch.roll(pe, 1)
    ni = torch.clamp(grid.natoms.to(pe.dtype), min=1.0) / params.fd_vol
    f = (pe_p - pe_m) / (2.0 * params.fd_h_x) / ni
    f = torch.where(act, f, 0.0)
    zero = torch.zeros_like(f[:1])
    return torch.cat([zero, f[1:-1], zero])


def gather_atom_coupling_flat(grid: TTMGrid, fdi_flat, extra=None):
    """Per-atom xi [M] and v_com [M, 3] by indexing the column arrays
    (move_atoms_ttm, imd_integrate.c:738-748); with ``extra`` (a per-cell
    [nx] column, the ELECPRESS force) also its per-atom values."""
    idx = fdi_flat.to(torch.int64)
    if extra is not None:
        return grid.xi[idx], grid.vcom[idx], extra[idx]
    return grid.xi[idx], grid.vcom[idx]


def electron_energy_total(grid: TTMGrid, params: TTMParams) -> torch.Tensor:
    """Electron energy summed over the active cells: the .eng ttm_eng
    column (imd_tpu/models/ttm.py:878)."""
    act = active_mask(grid, params)
    return torch.where(act, grid.U * grid.natoms, 0.0).sum()
