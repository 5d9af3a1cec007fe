"""Fused cells-last MD steps: the production hot loop (port of
imd_tpu/ops/fused_step.py:38-415).

The state stays cells-last across steps,

    CLState.xi    [cap, 3, NC]  positions (dead slots = SENTINEL_DEAD)
    CLState.mom   [cap, 3, NC]
    CLState.mass  [cap, NC]
    CLState.alive [cap, NC] bool

so the force kernels read it as is.  A step: the EAM forces, then for the
TTM step ``calc_ttm`` and the xi-coupled leapfrog (move_atoms_ttm,
imd_integrate.c:581), then the skin check, and on a trigger the sort-free
migration rebin (K3 inside).  The JAX package's ``lax.cond(need, rebin)``
is one host sync per step here, and calc_ttm adds one for its substep
count; both are counted in ``StepCounters``.

``engine`` picks the force sweep, as in imd_tpu:

- ``"win"`` (the default): the R/F split with the windowed full stencil,
  K1 and K2 (ops/forces_win.py);
- ``"split"``: the R/F split over the 13 rolled half-stencil views built
  each step, K10 and K11 (ops/forces_pallas.py ``eam_kernels_cl_split``);
- ``"ab"``: the observables pair K4 and K5 (``eam_kernels_cl``), whose
  energies and stress the step does not read.

With ``ntypes`` 2 to 4 every engine runs the alloy pair K6, K7, which
reads ``typ`` (imd_tpu does the same).

``nrb_state`` (models/nrb.py) sets the rear-boundary momenta after the
forces, before the TTM reductions read them, and the boundary atoms keep
them through the leapfrog; ``tmm_params`` (models/tmm.py) makes calc_ttm
solve the TMM laser at every diffusion substep.  FILTER runs between
blocks, not in the step: ``make_filter_apply``.  Together these are the
reference's flagship build (eam_nve_nbl_nrb_stress_ttm_tmm_filter).  The
TTM step also carries the rest of the 1-D TTM physics: VLATTICE,
ELECPRESS, COLRAD and the FDTD laser (``make_fused_ttm_step``).  One device
only: ``mesh`` raises NotImplementedError, and so does ``ntypes`` > 4 (not
fused in imd_tpu either).
"""

from __future__ import annotations

import dataclasses

import torch

from imd_tpu_torch.models import ttm as ttm_mod
from imd_tpu_torch.models.filter import filter_atoms
from imd_tpu_torch.models.nrb import nrb_forces_cl
from imd_tpu_torch.ops.forces_fast import _from_cl, _to_cl
from imd_tpu_torch.kernels import MAX_NT
from imd_tpu_torch.ops.forces_win import (SENTINEL_DEAD, check_mt_tables,
                                          eam_kernels_win_split,
                                          eam_kernels_win_split_mt)
from imd_tpu_torch.ops.geometry import np_dtype
from imd_tpu_torch.ops.rebin_cl import make_rebin_cl
from imd_tpu_torch.phases import StepCounters, no_timer
from imd_tpu_torch.scene import Scene, rebin_with


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


ENGINES = ("win", "split", "ab")


def _only_ported(**set_args):
    """Raise for each argument of the JAX API that this slice does not
    port; ``set_args`` maps its name to True where the caller set it."""
    for name, is_set in set_args.items():
        if is_set:
            raise NotImplementedError(
                f"{name} is not ported (one device only)")


def _make_forces(eam_run, template: Scene, ntypes: int, timer,
                 engine: str = "win"):
    """forces(cl, count_neighbors) -> (F, nneigh) of ``engine`` for one
    species; K6/K7 with the types for 2..MAX_NT whatever the engine
    (imd_tpu fused_step.py:143-182)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: one of {ENGINES}")
    if ntypes > MAX_NT:
        raise NotImplementedError(
            f"ntypes {ntypes} is not ported: the fused step takes up to "
            f"{MAX_NT} species, more run imd_tpu's general step (ROADMAP "
            "A9)")
    grid = template.grid
    if ntypes > 1:
        check_mt_tables(eam_run, ntypes)

        def forces(cl, count_neighbors):
            F, _, nn = eam_kernels_win_split_mt(
                cl.xi, cl.typ, cl.alive, eam_run, grid, ntypes,
                count_neighbors=count_neighbors, timer=timer)
            return F, nn
        return forces
    if engine == "win":
        def forces(cl, count_neighbors):
            F, _, nn = eam_kernels_win_split(
                cl.xi, cl.alive, eam_run, grid,
                count_neighbors=count_neighbors, timer=timer)
            return F, nn
        return forces
    # imported here: forces_pallas imports this module
    from imd_tpu_torch.ops import forces_pallas as fp
    if engine == "ab":
        def forces(cl, count_neighbors):
            F, _, _, nn, _, _ = fp.eam_kernels_cl(cl.xi, cl.alive, eam_run,
                                                  grid, timer=timer)
            return F, nn if count_neighbors else torch.zeros_like(nn)
        return forces
    views = fp.make_neighbor_views(grid, template.pos.dtype,
                                   template.pos.device)

    def forces(cl, count_neighbors):
        with timer("views"):
            nbr = views(cl.xi)
        F, _, nn = fp.eam_kernels_cl_split(
            cl.xi, nbr, cl.alive, eam_run, grid,
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


def _nrb(cl: CLState, box, nrb_state, timer):
    """(mom_set, bnd): the boundary atoms' momenta set by the NRB rule, or
    the momenta as they are and None without ``nrb_state``."""
    if nrb_state is None:
        return cl.mom, None
    with timer("nrb"):
        return nrb_forces_cl(cl.xi, cl.mom, cl.alive, cl.ids, box, nrb_state)


def make_fused_step(template: Scene, eam_run, timestep: float,
                    engine: str = "win", mesh=None, nrb_state=None,
                    ntypes: int = 1, timer=no_timer,
                    counters: StepCounters | None = None):
    """Returns (step, cl0): step(cl) -> (cl', nneigh [cap, NC], zero: the
    pure-MD step counts no neighbours).

    EAM forces (the ``engine``'s kernels, or K6/K7 for ``ntypes`` 2..4),
    the NRB momenta with ``nrb_state``, leapfrog, skin check with a
    migration rebin on trigger.  ``eam_run`` must be fastpoly."""
    _only_ported(mesh=mesh is not None)
    grid = template.grid
    forces = _make_forces(eam_run, template, ntypes, timer, engine)
    dt = float(timestep)
    skin2 = (0.5 * grid.skin) ** 2
    rebin = make_rebin_cl(grid)
    counters = StepCounters() if counters is None else counters

    def step(cl: CLState):
        F, nn = forces(cl, False)
        mom_set, bnd = _nrb(cl, grid.box, nrb_state, timer)
        with timer("leapfrog"):
            af = cl.alive.to(cl.xi.dtype)
            mom2 = mom_set + dt * F
            if bnd is not None:
                # boundary atoms keep their set momenta
                # (imd_integrate.c:254-259)
                mom2 = torch.where(bnd[:, None, :], mom_set, mom2)
            cl, need = _leapfrog_skin(cl, mom2 * af[:, None, :], skin2, dt,
                                      counters)
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

    Returns (step, cl0): step(cl, tgrid, fdi[, cs][, vs], k) -> (cl',
    tgrid', fdi'[, cs'][, vs'], k+1) with ``fdi`` the flat [cap*NC] int32
    stored FD index (-1 = no history) and ``k`` the host step number.  EAM
    forces with neighbour counts (the ``engine``'s kernels, or K6/K7 for
    ``ntypes`` 2..4), the NRB momenta with ``nrb_state``, calc_ttm on flat
    component views of the cells-last state (the TMM laser with
    ``tmm_params``), xi-coupled leapfrog p += dt (F + xi m (v - vcom))
    where boundary atoms keep their set momenta, skin check, and on
    trigger the migration rebin carrying fdi with its atom.

    ``colrad`` = (tables, step_fn[, phi_fn]) runs COLRAD inside calc_ttm
    with its state ``cs``; ``vlat`` = (VlatParams, VlatState0) the virtual
    lattice with its state ``vs``; ``elecpress`` subtracts the electron
    blast force from the x momentum update, gathered per atom beside xi;
    ``fdtd_params`` switches to calc_ttm_fdtd, the FDTD field state taking
    the ``cs`` slot (imd_tpu's carry order, ops/fused_step.py:398-412).
    FDTD with TMM, COLRAD or VLAT raises ValueError, as imd_tpu's driver
    rule."""
    _only_ported(mesh=mesh is not None)
    if fdtd_params is not None:
        for name, arg in (("tmm_params", tmm_params), ("colrad", colrad),
                          ("vlat", vlat)):
            if arg is not None:
                raise ValueError(
                    f"FDTD is exclusive with TMM, COLRAD and VLAT (the "
                    f"driver rule): {name} is set")
    grid = template.grid
    forces = _make_forces(eam_run, template, ntypes, timer, engine)
    dtype = template.pos.dtype
    dt = float(timestep)
    skin2 = (0.5 * grid.skin) ** 2
    rebin = make_rebin_cl(grid)
    counters = StepCounters() if counters is None else counters
    dt_np = np_dtype(dtype).type

    def core(cl: CLState, tgrid, fdi, cs, vs, k: int):
        F, nn = forces(cl, True)
        # the NRB momenta are set before the TTM reductions read them
        # (nrb_forces ends calc_forces, imd_forces_nbl.c:1019-1048)
        mom_set, bnd = _nrb(cl, grid.box, nrb_state, timer)
        x = cl.xi[:, 0, :].reshape(-1)
        mom3 = tuple(mom_set[:, c, :].reshape(-1) for c in range(3))
        massf = cl.mass.reshape(-1)
        atoms = (x, mom3, massf, cl.alive.reshape(-1))
        with timer("calc_ttm"):
            t = torch.full((), float(k), dtype=dtype, device=x.device) * dt
            if fdtd_params is not None:
                tgrid, fdi, cs = ttm_mod.calc_ttm_fdtd(
                    tgrid, cs, atoms, tp, eos, fdtd_params, nn.reshape(-1),
                    fdi, dt, t, float(dt_np(k) * dt_np(dt)),
                    first_step=(k == 0), counters=counters)
            else:
                out = ttm_mod.calc_ttm(
                    tgrid, atoms, tp, eos, nn.reshape(-1), fdi, dt, t,
                    laser_cfg=laser_cfg, first_step=(k == 0),
                    tmm_params=tmm_params,
                    colrad=(None if colrad is None
                            else (colrad[0], colrad[1], cs)
                            + tuple(colrad[2:3])),
                    vlat=None if vlat is None else (vlat[0], vs),
                    counters=counters)
                tgrid, fdi = out[:2]
                rest = list(out[2:])
                cs = rest.pop(0) if colrad is not None else cs
                vs = rest.pop(0) if vlat is not None else vs
        with timer("leapfrog"):
            fdidx = ttm_mod.fd_index_from_x(x, tp)
            if elecpress:
                epf = ttm_mod.electron_pressure_force(tgrid, tp, eos)
                xi_a, vcom_a, ep_a = ttm_mod.gather_atom_coupling_flat(
                    tgrid, fdidx, extra=epf)
            else:
                xi_a, vcom_a = ttm_mod.gather_atom_coupling_flat(tgrid,
                                                                 fdidx)
                ep_a = None
            af = cl.alive.to(dtype)
            shape2 = cl.mass.shape
            mom_new = []
            for c in range(3):
                momc = mom_set[:, c, :]
                extra = (xi_a * (mom3[c] - massf * vcom_a[:, c])
                         ).reshape(shape2)
                Fc = F[:, c, :]
                if c == 0 and ep_a is not None:
                    # the electron blast pressure acts along x only
                    # (imd_integrate.c:741-743)
                    Fc = Fc - ep_a.reshape(shape2)
                upd = momc + dt * (Fc + extra)
                if bnd is not None:
                    upd = torch.where(bnd, momc, upd)
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
        return cl, tgrid, fdi, cs, vs, k + 1

    has_cs = colrad is not None or fdtd_params is not None
    has_vs = vlat is not None

    def step(cl: CLState, tgrid, fdi, *rest):
        rest = list(rest)
        cs = rest.pop(0) if has_cs else None
        vs = rest.pop(0) if has_vs else None
        cl, tgrid, fdi, cs, vs, k = core(cl, tgrid, fdi, cs, vs, rest[0])
        return (cl, tgrid, fdi) + ((cs,) if has_cs else ()) \
            + ((vs,) if has_vs else ()) + (k,)

    return step, scene_to_cl(template)


def make_filter_apply(template: Scene, filter_cfg, cutoff: float):
    """apply(cl[, fdi]) -> cl' [, fdi']: FILTER on the cells-last state
    (imd_tpu make_filter_apply, ops/fused_step.py:418).  The driver runs it
    at block boundaries every filter_int steps (imd_filter.c:151): to the
    Scene, ``filter_atoms`` with the bond cutoff ``cutoff``, a rebin that
    drops the deleted atoms (carrying the stored FD index ``fdi`` with its
    atom; a deleted atom's slot comes back -1), back to cells-last."""
    dims = template.grid.dims

    def apply(cl: CLState, fdi=None):
        sc, _ = filter_atoms(cl_to_scene(cl, template), filter_cfg, cutoff)
        if fdi is None:
            return scene_to_cl(rebin_with(sc, None)[0])
        cap = cl.mass.shape[0]
        sc2, ex = rebin_with(sc, {"fdi": _from_cl(fdi.reshape(cap, -1),
                                                  dims)})
        return scene_to_cl(sc2), _to_cl(ex["fdi"], dims).reshape(-1)

    return apply
