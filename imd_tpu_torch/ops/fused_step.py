"""Fused cells-last MD steps: the production hot loop (port of
imd_tpu/ops/fused_step.py:38-415).

The state stays cells-last across steps,

    CLState.xi    [cap, 3, NC]  positions (dead slots = SENTINEL_DEAD)
    CLState.mom   [cap, 3, NC]
    CLState.mass  [cap, NC]
    CLState.alive [cap, NC] bool

so the force kernels read it as is.  A step: the EAM R and F passes (K1,
K2; with ``ntypes`` 2 to 4 the alloy pair K6, K7, which reads ``typ``),
then for the TTM step ``calc_ttm`` and the xi-coupled leapfrog
(move_atoms_ttm, imd_integrate.c:581), then the skin check, and on a
trigger the sort-free migration rebin (K3 inside).  The JAX package's
``lax.cond(need, rebin)`` is one host sync per step here, and calc_ttm adds
one for its substep count; both are counted in ``StepCounters``.

Only the windowed engine on one device is ported, for up to 4 species:
the ``engine``, ``mesh``, ``nrb_state``, TMM, VLAT, ELECPRESS, COLRAD and
FDTD arguments raise NotImplementedError unless left at their defaults,
and so does ``ntypes`` > 4 (not fused in imd_tpu either).
"""

from __future__ import annotations

import dataclasses

import torch

from imd_tpu_torch.models import ttm as ttm_mod
from imd_tpu_torch.ops.forces_fast import _from_cl, _to_cl
from imd_tpu_torch.kernels import MAX_NT
from imd_tpu_torch.ops.forces_win import (SENTINEL_DEAD, check_mt_tables,
                                          eam_kernels_win_split,
                                          eam_kernels_win_split_mt)
from imd_tpu_torch.ops.rebin_cl import make_rebin_cl
from imd_tpu_torch.phases import StepCounters, no_timer
from imd_tpu_torch.scene import Scene


@dataclasses.dataclass(eq=False)
class CLState:
    xi: torch.Tensor        # [cap, 3, NC] positions, dead slots = sentinel
    mom: torch.Tensor       # [cap, 3, NC]
    mass: torch.Tensor      # [cap, NC] (1e-30 where dead)
    alive: torch.Tensor     # [cap, NC] bool
    typ: torch.Tensor       # [cap, NC] int32, -1 = dead slot
    vtyp: torch.Tensor      # [cap, NC] int32
    ids: torch.Tensor       # [cap, NC] int32
    ref_xi: torch.Tensor    # positions at last rebin (skin check)
    overflow: torch.Tensor  # int32 scalar

    def replace(self, **kw) -> "CLState":
        return dataclasses.replace(self, **kw)


def scene_to_cl(scene: Scene) -> CLState:
    dims = scene.grid.dims

    def cl(a):
        return _to_cl(a, dims).contiguous()

    typ = cl(scene.type)
    alive = typ >= 0
    xi = torch.where(alive[:, None, :], cl(scene.pos), SENTINEL_DEAD)
    return CLState(xi=xi, mom=cl(scene.mom),
                   mass=torch.clamp(cl(scene.mass), min=1e-30),
                   alive=alive, typ=typ, vtyp=cl(scene.vtype),
                   ids=cl(scene.id), ref_xi=xi.clone(),
                   overflow=scene.overflow.clone())


def cl_to_scene(cl: CLState, template: Scene) -> Scene:
    """Rebuild a Scene from the current cells-last state (``template``
    supplies only the grid)."""
    dims = template.grid.dims
    alive3 = cl.alive[:, None, :]
    af = cl.alive.to(cl.mass.dtype)
    return template.replace(
        pos=_from_cl(torch.where(alive3, cl.xi, 0.0), dims),
        mom=_from_cl(cl.mom, dims), mass=_from_cl(cl.mass * af, dims),
        type=_from_cl(cl.typ, dims), vtype=_from_cl(cl.vtyp, dims),
        id=_from_cl(cl.ids, dims),
        nbl_ref_pos=_from_cl(torch.where(alive3, cl.ref_xi, 0.0), dims),
        overflow=cl.overflow)


def _only_ported(**set_args):
    """Raise for each argument of the JAX API that this slice does not
    port; ``set_args`` maps its name to True where the caller set it."""
    for name, is_set in set_args.items():
        if is_set:
            raise NotImplementedError(
                f"{name} is not ported (only the windowed engine on one "
                "device)")


def _make_forces(eam_run, grid, ntypes: int, timer):
    """forces(cl, count_neighbors) -> (F, nneigh): K1/K2 for one species,
    K6/K7 with the types for 2..MAX_NT (imd_tpu fused_step.py:143-155)."""
    if ntypes > MAX_NT:
        raise NotImplementedError(
            f"ntypes {ntypes} is not ported: the fused step takes up to "
            f"{MAX_NT} species, more run imd_tpu's general step (ROADMAP "
            "A9)")
    if ntypes > 1:
        check_mt_tables(eam_run, ntypes)

    def forces(cl, count_neighbors):
        if ntypes > 1:
            F, _, nn = eam_kernels_win_split_mt(
                cl.xi, cl.typ, cl.alive, eam_run, grid, ntypes,
                count_neighbors=count_neighbors, timer=timer)
        else:
            F, _, nn = eam_kernels_win_split(
                cl.xi, cl.alive, eam_run, grid,
                count_neighbors=count_neighbors, timer=timer)
        return F, nn

    return forces


def _leapfrog_skin(cl: CLState, mom2, skin2: float, dt: float,
                   counters: StepCounters):
    """x += dt p/m on live slots, then the skin check (forces_nbl:1062).
    Returns (cl', need_rebin) after one host sync."""
    xi2 = cl.xi + dt * mom2 / cl.mass[:, None, :]
    xi2 = torch.where(cl.alive[:, None, :], xi2, cl.xi)
    d = xi2 - cl.ref_xi
    d2 = (d * d).sum(1)
    need = bool(torch.where(cl.alive, d2, 0.0).max() > skin2)
    counters.host_syncs += 1
    return cl.replace(xi=xi2, mom=mom2), need


def make_fused_step(template: Scene, eam_run, timestep: float,
                    engine: str = "win", mesh=None, nrb_state=None,
                    ntypes: int = 1, timer=no_timer,
                    counters: StepCounters | None = None):
    """Returns (step, cl0): step(cl) -> (cl', nneigh [cap, NC], zero: the
    pure-MD step counts no neighbours).

    EAM forces (K1/K2, or K6/K7 for ``ntypes`` 2..4) + leapfrog + skin
    check with a migration rebin on trigger.  ``eam_run`` must be
    fastpoly."""
    _only_ported(engine=engine != "win", mesh=mesh is not None,
                 nrb_state=nrb_state is not None)
    grid = template.grid
    forces = _make_forces(eam_run, grid, ntypes, timer)
    dt = float(timestep)
    skin2 = (0.5 * grid.skin) ** 2
    rebin = make_rebin_cl(grid)
    counters = StepCounters() if counters is None else counters

    def step(cl: CLState):
        F, nn = forces(cl, False)
        with timer("leapfrog"):
            af = cl.alive.to(cl.xi.dtype)
            mom2 = (cl.mom + dt * F) * af[:, None, :]
            cl, need = _leapfrog_skin(cl, mom2, skin2, dt, counters)
        if need:
            with timer("rebin"):
                cl = rebin(cl)
            counters.rebins += 1
        counters.steps += 1
        return cl, nn

    return step, scene_to_cl(template)


def make_fused_ttm_step(template: Scene, eam_run, timestep: float, tp, eos,
                        laser_cfg, engine: str = "win", mesh=None,
                        nrb_state=None, tmm_params=None, vlat=None,
                        elecpress: bool = False, colrad=None,
                        fdtd_params=None, ntypes: int = 1,
                        timer=no_timer,
                        counters: StepCounters | None = None):
    """TTM-coupled fused step (the north-star configuration).

    Returns (step, cl0): step(cl, tgrid, fdi, k) -> (cl', tgrid', fdi',
    k+1) with ``fdi`` the flat [cap*NC] int32 stored FD index (-1 = no
    history) and ``k`` the host step number.  EAM forces with neighbour
    counts (K1/K2, or K6/K7 for ``ntypes`` 2..4), calc_ttm on flat
    component views of the cells-last state, xi-coupled leapfrog
    p += dt (F + xi m (v - vcom)), skin check, and on trigger the
    migration rebin carrying fdi with its atom."""
    _only_ported(engine=engine != "win", mesh=mesh is not None,
                 nrb_state=nrb_state is not None,
                 tmm_params=tmm_params is not None, vlat=vlat is not None,
                 elecpress=bool(elecpress), colrad=colrad is not None,
                 fdtd_params=fdtd_params is not None)
    grid = template.grid
    forces = _make_forces(eam_run, grid, ntypes, timer)
    dtype = template.pos.dtype
    dt = float(timestep)
    skin2 = (0.5 * grid.skin) ** 2
    rebin = make_rebin_cl(grid)
    counters = StepCounters() if counters is None else counters

    def step(cl: CLState, tgrid, fdi, k: int):
        F, nn = forces(cl, True)
        x = cl.xi[:, 0, :].reshape(-1)
        mom3 = tuple(cl.mom[:, c, :].reshape(-1) for c in range(3))
        massf = cl.mass.reshape(-1)
        with timer("calc_ttm"):
            t = torch.tensor(float(k), dtype=dtype, device=x.device) * dt
            tgrid, fdi = ttm_mod.calc_ttm(
                tgrid, (x, mom3, massf, cl.alive.reshape(-1)), tp, eos,
                nn.reshape(-1), fdi, dt, t, laser_cfg=laser_cfg,
                first_step=(k == 0), counters=counters)
        with timer("leapfrog"):
            fdidx = ttm_mod.fd_index_from_x(x, tp)
            xi_a, vcom_a = ttm_mod.gather_atom_coupling_flat(tgrid, fdidx)
            af = cl.alive.to(dtype)
            shape2 = cl.mass.shape
            mom_new = []
            for c in range(3):
                extra = (xi_a * (mom3[c] - massf * vcom_a[:, c])
                         ).reshape(shape2)
                upd = cl.mom[:, c, :] + dt * (F[:, c, :] + extra)
                mom_new.append(upd * af)
            cl, need = _leapfrog_skin(cl, torch.stack(mom_new, 1), skin2,
                                      dt, counters)
        if need:
            # the stored FD index rides the migration with its atom
            # (fdi through move_atom, types.h:327)
            with timer("rebin"):
                cl, fdi2 = rebin(cl, fdi.reshape(shape2))
                fdi = fdi2.reshape(-1)
            counters.rebins += 1
        counters.steps += 1
        return cl, tgrid, fdi, k + 1

    return step, scene_to_cl(template)
