"""The param-file driver on the fused path (port of imd_tpu/simulation.py:
``Simulation`` for the configurations ``_fused_eligible`` sends to
``run_fused``, simulation.py:1791, 2463-3155).

A run reads its configuration (``SimConfig``), loads the EAM tables (the
reference's three files, or one DYNAMO setfl/funcfl file; up to 4 species)
and the atoms (an ``_fcc``-style generated lattice or a ``.chkpt``), bins them
on the host, and runs the fused cells-last hot loop (ops/fused_step.py)
in blocks that end on the next I/O step.  At every block end where some
output is due, ``observe`` evaluates the observables with the B4 kernels
(ops/forces_pallas.py: K4 ``eam_rho_e``, K5 ``eam_force_s``; with
``ntypes`` > 1 the alloy pair K8, K9) and the
driver writes ``.eng``, ``.chkpt``/``.itr``, ``.ttm`` and the ``.laser``
log at their intervals.  A rebin that overflows the cell capacity grows
the slot axis and retries the block from the pre-block state; past
``REGRID_CAPACITY`` slots the grid is first re-derived for the current
density (``_regrid_scene``).

The loop over steps is Python (the JAX package's ``fori_loop`` blocks);
the blocks stay, so output lands on the same steps as imd_tpu's.

Every setting that would take imd_tpu off the fused path, or onto a
feature this port does not have yet, raises NotImplementedError naming the
tag and the ROADMAP item (``UNPORTED``).  The port never silently computes
something else.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from imd_tpu_torch import integrate, units
from imd_tpu_torch.config import SimConfig
from imd_tpu_torch.io.chkpt import ChkptData, read_chkpt, read_itr, \
    write_chkpt, write_itr
from imd_tpu_torch.io.eng import EngWriter
from imd_tpu_torch.io.ttm_io import write_ttm
from imd_tpu_torch.models import ttm as ttm_mod
from imd_tpu_torch.models.eos import FEGEos
from imd_tpu_torch.kernels import MAX_NT
from imd_tpu_torch.models.potential import (EAMPotential, eam_to_fastpoly,
                                            read_eam, with_interpolation)
from imd_tpu_torch.models.setfl import maybe_read_dynamo
from imd_tpu_torch.ops.forces_fast import _from_cl
from imd_tpu_torch.ops.forces_pallas import eam_kernels_cl, eam_kernels_cl_mt
from imd_tpu_torch.ops.fused_step import (cl_to_scene, make_fused_step,
                                          make_fused_ttm_step)
from imd_tpu_torch.ops.geometry import (Box, CellGrid, choose_grid,
                                        measured_capacity, np_dtype,
                                        optimize_grid_dims, with_capacity)
from imd_tpu_torch.phases import StepCounters
from imd_tpu_torch.scene import (Scene, flatten_atoms, grow_capacity,
                                 make_scene, n_atoms, rebin)
from imd_tpu_torch.utils.generate import generate_atoms
from imd_tpu_torch.utils.timers import Timers

# Capacity past which an overflow first re-derives the cell grid for the
# current density.  In imd_tpu this was the Pallas sweeps' VMEM limit
# (simulation.py:398, 2680); the CUDA kernels take any capacity, so here it
# only bounds their cost, which grows with the 27*cap candidates per atom.
REGRID_CAPACITY = 32


def _any_set(cfg, names) -> bool:
    return any(bool(getattr(cfg, n)) for n in names)


_FLAT_INTERACTION_TAGS = (
    "stiweb_a", "stiweb_b", "stiweb_p", "stiweb_q", "ters_r_cut", "ters_a",
    "keating_alpha", "keating_beta", "keating_d", "ttbp_constant", "ttbp_sp",
    "ttbp_cut", "meam_e", "meam_a", "dp_alpha", "ms_D")

# (what, predicate, ROADMAP item): settings this port does not run yet
UNPORTED = (
    (f"ntypes > {MAX_NT} (imd_tpu's general step)",
     lambda c: c.ntypes > MAX_NT, "A9"),
    ("asympot with ntypes > 1 (imd_tpu's oracle engine)",
     lambda c: c.asympot and c.ntypes > 1, "A9"),
    ("pair potentials (potfile, lj_*, morse_*, buck_*)",
     lambda c: not c.core_potential_file
     or _any_set(c, ("potfile", "lj_epsilon", "morse_epsilon", "buck_a")),
     "A9"),
    ("analytic many-body interactions (stiweb/ters/keating/ttbp/meam/"
     "dipole tags)", lambda c: _any_set(c, _FLAT_INTERACTION_TAGS), "A9"),
    ("eeam_energy_file / adp_*potfile",
     lambda c: _any_set(c, ("eeam_energy_file", "adp_upotfile")), "A9"),
    ("charges / Ewald (charge, sm_chi_0)",
     lambda c: _any_set(c, ("charge", "sm_chi_0")), "A9"),
    ("ensembles other than nve and ttm",
     lambda c: c.ensemble not in ("nve", "ttm"), "A9"),
    ("the TTM under ensemble nve",
     lambda c: c.ensemble == "nve" and c.ttm.enabled, "A9"),
    ("endtemp ramps", lambda c: c.endtemp > 0 and c.endtemp != c.starttemp,
     "A9"),
    ("per-step drivers (getmin/getsaddle, nclones, ep_*, shock_mode, "
     "pdecay, restrictions, fbc_*, zapp, bend, rigid groups, "
     "HOMDEF/DEFORM, spring_rate, epitax, bb_*)",
     lambda c: _any_set(c, (
         "getmin", "getsaddle", "ep_n", "shock_mode", "pdecay_mode",
         "xipdecay", "restrictions", "fbc_forces", "zapp_threshold",
         "bend_nmoments", "rigid_groups", "fbc_endforces", "fbc_dforces",
         "fbc_bdforces", "relax_rate", "lindef_interval", "max_deform_int",
         "ep_max_int", "spring_rate", "bb_epscrit"))
     or c.nclones > 1 or any(r > 0 for r in c.epitax_rate), "A9"),
    ("laser_rescale_mode other than 0 and 4",
     lambda c: c.ttm.enabled and c.laser.rescale_mode not in (0, 4), "A9"),
    ("tmm", lambda c: c.tmm.enabled, "A7"),
    ("nrb_*", lambda c: c.nrb.enabled, "A7"),
    ("filter_*", lambda c: c.filter.enabled, "A7"),
    ("vlatdim", lambda c: c.ttm.enabled and c.ttm.vlatdim > 0, "A7"),
    ("elecpress", lambda c: c.ttm.enabled and c.ttm.elecpress, "A7"),
    ("colrad", lambda c: c.ttm.enabled and c.colrad, "A7"),
    ("fdtd", lambda c: c.fdtd.enabled, "A7"),
    ("3-D TTM (ttmdimy / ttmdimz > 1)",
     lambda c: c.ttm.enabled and (c.ttm.fd_ny > 1 or c.ttm.fd_nz > 1),
     "A7"),
    ("ttm_solver implicit",
     lambda c: c.ttm.enabled and c.ttm.solver != "explicit", "A5"),
    ("cpu_dim > 1 (several devices)",
     lambda c: int(np.prod(c.cpu_dim)) > 1, "A11"),
    ("a restart of a TTM run (-r with ensemble ttm)",
     lambda c: c.ttm.enabled and bool(c.restart_base), "A6"),
    ("outputs other than .eng/.chkpt/.itr/.ttm/.laser (dist_int, pic_int,"
     " socket_int, lb_frequency, force_int, press_int, nb_*, avpos/dsp/dem/"
     "nmoldyn/dsf/ef observers, hc_int, op_weight, relaxinfo)",
     lambda c: _any_set(c, (
         "dist_int", "pic_int", "socket_int", "lb_frequency", "force_int",
         "press_int", "nb_checkpt_int", "nb_rcut", "avpos_int", "dsp_int",
         "dem_int", "nmoldyn_int", "dsf_int", "ef_checkpt_int", "hc_int",
         "op_weight", "relaxinfo")), "A6"),
    ("shift*_front / shift*_rear vacuum margins",
     lambda c: any(getattr(c, f"shift{a}_{end}") > 0 for a in "xyz"
                   for end in ("front", "rear")), "A6"),
)


def check_ported(cfg: SimConfig) -> None:
    """Raise NotImplementedError for the first setting of ``UNPORTED``
    that ``cfg`` uses."""
    for what, pred, item in UNPORTED:
        if pred(cfg):
            raise NotImplementedError(
                f"{what} is not ported to imd_tpu_torch yet (ROADMAP {item})")


@dataclasses.dataclass(eq=False)
class SimState:
    """What the driver reports and writes at an output step."""
    scene: Scene                  # positions, momenta, per-atom epot
    step: int                     # global step (completed iterations)
    epot_total: float
    ekin: float
    virial: float
    presstens: np.ndarray         # [6] xx yy zz yz zx xy
    rho: torch.Tensor             # [gx,gy,gz,cap] host density
    ttm_grid: Optional[object] = None


def _iv_due(gstep: int, iv: int) -> bool:
    return iv > 0 and gstep % iv == 0


def _clamp_block(b: int, cur: int, intervals) -> int:
    """Shrink a block so that it ends on the next multiple of any active
    interval (imd_tpu simulation.py:78)."""
    cands = [i - cur % i for i in intervals if i > 0]
    return min([b] + cands)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Simulation:
    """Host-side driver owning config, potentials, atoms, I/O and the fused
    step.  ``device`` is where the state lives ("cuda" by default)."""

    def __init__(self, cfg: SimConfig, workdir: str = ".",
                 dtype=torch.float32, device="cuda"):
        check_ported(cfg)
        self.cfg = cfg
        self.workdir = workdir
        self.dtype = dtype
        self.device = torch.device(device)
        self.timers = Timers()
        self.counters = StepCounters()
        self.n_observe = 0
        self.eng: Optional[EngWriter] = None
        t0 = time.perf_counter()
        self._load_potential()
        self._load_atoms()
        self._select_engine()
        self._select_integrator()
        _sync(self.device)
        self.setup_seconds = time.perf_counter() - t0
        self.start_time = time.time()

    def _path(self, name: str) -> str:
        return name if os.path.isabs(name) else os.path.join(self.workdir,
                                                              name)

    # -- setup ----------------------------------------------------------
    def _load_potential(self):
        """The EAM-table branch of imd_tpu's _load_potential
        (simulation.py:180-207): a DYNAMO setfl/funcfl file by its suffix
        (one file carries all three tables), else the reference's three
        table files."""
        cfg = self.cfg
        dt = np_dtype(self.dtype)
        dyn = maybe_read_dynamo(self._path(cfg.core_potential_file), dt)
        if dyn is not None:
            eam, meta = dyn
            # the tables have nelem^2 columns with stride nelem; every
            # engine indexes col = s*ntypes + h, so another ntypes would
            # read wrong columns
            if meta["nelem"] != cfg.ntypes:
                raise ValueError(
                    f"{cfg.core_potential_file}: {meta['nelem']} "
                    f"element(s) but ntypes={cfg.ntypes}; set ntypes "
                    f"to the file's element count (or trim the file)")
        else:
            eam = read_eam(self._path(cfg.core_potential_file),
                           self._path(cfg.embedding_energy_file),
                           self._path(cfg.el_density_file), cfg.ntypes, dt)
        self.eam = EAMPotential(
            pair=with_interpolation(eam.pair, cfg.pot_interp),
            rho=with_interpolation(eam.rho, cfg.pot_interp),
            embed=with_interpolation(eam.embed, cfg.pot_interp,
                                     radial=False))
        self.cutoff = math.sqrt(self.eam.cutoff2)

    def _load_atoms(self):
        """Generated lattice or .chkpt start (simulation.py:483-605)."""
        cfg = self.cfg
        itr = {}
        if cfg.coordname.startswith("_"):
            pos, typ, box_diag = generate_atoms(cfg.coordname, cfg.box_param,
                                                cfg.box_unit, cfg.ntypes)
            number = np.arange(len(pos))
            mass = np.asarray(cfg.masses)[typ]
            vel = None
            box_x = [box_diag[0], 0, 0]
            box_y = [0, box_diag[1], 0]
            box_z = [0, 0, box_diag[2]]
            self.do_maxwell = True
        else:
            d = read_chkpt(self._path(cfg.coordname))
            if cfg.itrname:
                itr = read_itr(self._path(cfg.itrname))
            pos, vel, typ, number = d.pos, d.vel, d.type, d.number
            mass = d.mass
            box_x = itr.get("box_x", d.box_x if d.box_x is not None
                            else cfg.box_x)
            box_y = itr.get("box_y", d.box_y if d.box_y is not None
                            else cfg.box_y)
            box_z = itr.get("box_z", d.box_z if d.box_z is not None
                            else cfg.box_z)
            self.do_maxwell = cfg.do_maxwell or not d.have_vel
        if not np.any(np.asarray(box_x)):
            raise ValueError("no box: neither header #X/#Y/#Z nor box_x "
                             "params")
        dt = np_dtype(self.dtype)
        self.box = Box.create(box_x, box_y, box_z, pbc=cfg.pbc_dirs,
                              dtype=dt)
        self.grid = choose_grid(self.box, self.cutoff, cfg.nbl_margin,
                                len(pos), capacity=cfg.cell_capacity,
                                headroom=1.6 * cfg.nbl_size)
        if cfg.cell_capacity <= 0:
            dims, cap = optimize_grid_dims(self.box, self.cutoff,
                                           cfg.nbl_margin, pos, dtype=dt,
                                           headroom_slots=2)
            self.grid = CellGrid(box=self.box, dims=dims, capacity=cap,
                                 cutoff=self.cutoff, skin=cfg.nbl_margin)
        vtyp = np.asarray(typ, np.int32)
        types_map = np.asarray(cfg.types if cfg.types else
                               range(max(cfg.vtypes, vtyp.max() + 1)),
                               np.int32)
        rtyp = types_map[np.clip(vtyp, 0, len(types_map) - 1)]
        mom = None
        if vel is not None and not self.do_maxwell:
            mom = np.asarray(vel) * np.asarray(mass)[:, None]
        kw = dict(mom=mom, mass=mass, type=rtyp, vtype=vtyp, id=number,
                  dtype=self.dtype, device=self.device)
        self.scene = make_scene(self.grid, pos, **kw)
        # setup never drops atoms: grow the slot axis until all binned
        for _ in range(6):
            if int(self.scene.overflow) == 0:
                break
            new_cap = self.grid.capacity + 8
            print(f"# setup overflow {int(self.scene.overflow)}: growing "
                  f"capacity {self.grid.capacity} -> {new_cap}", flush=True)
            self.grid = self.grid.replace(capacity=new_cap)
            self.scene = make_scene(self.grid, pos, **kw)
        else:
            raise RuntimeError(
                f"make_scene still drops {int(self.scene.overflow)} atoms "
                f"at capacity {self.grid.capacity}")
        # the .itr holds the next step to execute (write_itr_file prints
        # steps+1, imd_io_3d.c:1007); step_count counts completed ones
        self.step_count = (int(itr["startstep"]) - 1 if "startstep" in itr
                           else cfg.startstep)
        if self.do_maxwell and cfg.starttemp > 0:
            # torch's generator: not the numbers of imd_tpu's jax.random
            gen = torch.Generator(device="cpu").manual_seed(cfg.seed)
            self.scene = integrate.maxwell(self.scene, cfg.starttemp, gen)

    def adopt_scene(self, prev: Scene):
        """Phase handover: re-bin another phase's atoms into this phase's
        grid (simulation.py:616)."""
        flat = {k: v.detach().cpu().numpy()
                for k, v in flatten_atoms(prev).items()}
        m = flat["mask"]
        if self.cfg.cell_capacity <= 0:
            self.grid = with_capacity(self.grid, measured_capacity(
                self.grid, flat["pos"][m], safety=1.2 * self.cfg.nbl_size,
                dtype=np_dtype(self.dtype)))
        self.scene = rebin(prev, self.grid)
        if int(self.scene.overflow):
            raise RuntimeError(
                f"phase handover: {int(self.scene.overflow)} atoms "
                f"overflowed cell capacity {self.grid.capacity}")
        if n_atoms(self.scene) != int(m.sum()):
            raise RuntimeError("phase handover lost atoms")

    def _select_engine(self):
        """Always the port's kernels on the fitted polynomials.  imd_tpu
        picks its Pallas engine only up to capacity 32 (a TPU VMEM limit,
        simulation.py:398); the CUDA kernels have no such limit."""
        self.eam_run = eam_to_fastpoly(self.eam)

    def _select_integrator(self):
        cfg = self.cfg
        self.ensemble = cfg.ensemble
        self.ttm_params = self.eos = None
        if self.ensemble != "ttm":
            return
        cfg.ttm.enabled = True
        self.ttm_params = ttm_mod.make_params(cfg.ttm, self.box, self.cutoff)
        self.eos = self._select_eos()

    def _select_eos(self) -> FEGEos:
        """The closed-form FEG EOS; the reference's tabulated EOS (EOS_*.txt
        under eos_dir, simulation.py:676) is not ported."""
        d = self.cfg.ttm.eos_dir
        for name in ("EOS_cve_from_r_te.txt", "EOS_ee_from_r_tesqrt.txt"):
            if os.path.exists(self._path(os.path.join(d, name))):
                raise NotImplementedError(
                    f"the tabulated EOS ({name} under eos_dir {d!r}) is not "
                    "ported to imd_tpu_torch yet (ROADMAP A5)")
        return FEGEos(atomic_mass=self.cfg.ttm.atomic_mass)

    def _initial_ttm_grid(self):
        grid = ttm_mod.make_grid(self.ttm_params, self.dtype, self.device)
        if self.cfg.ttm.init_t_el > 0:
            grid = grid.replace(temp=torch.full_like(
                grid.temp, self.cfg.ttm.init_t_el), init_done=True)
        return grid

    def _steps_to_run(self, steps: Optional[int]) -> int:
        """maxsteps is the ABSOLUTE last step (imd_main_3d.c:151); an
        explicit ``steps`` is a relative count."""
        if steps is not None:
            return steps
        return max(self.cfg.maxsteps - self.step_count, 0)

    # -- the run --------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> SimState:
        return self.run_fused(steps)

    def _build(self, template: Scene, ttm_grid, step0: int):
        """The fused step and its carry for ``template`` (rebuilt after a
        capacity growth or a re-grid).  The stored FD index restarts at
        -1, as imd_tpu's does when the slot layout changes."""
        cfg = self.cfg
        if self.ensemble == "ttm":
            laser = cfg.laser if cfg.laser.sigma_e > 0 else None
            step, cl = make_fused_ttm_step(
                template, self.eam_run, cfg.timestep, self.ttm_params,
                self.eos, laser, ntypes=cfg.ntypes, counters=self.counters)
            fdi = torch.full((cl.mass.numel(),), -1, dtype=torch.int32,
                             device=self.device)
            return step, (cl, ttm_grid, fdi, step0)
        step, cl = make_fused_step(template, self.eam_run, cfg.timestep,
                                   ntypes=cfg.ntypes, counters=self.counters)
        return (lambda c: (step(c)[0],)), (cl,)

    def observe(self, cl, template: Scene, gstep: int, ttm_grid):
        """Observables of a cells-last state with the B4 kernels (K4, K5;
        K8, K9 with ntypes > 1, simulation.py:2592): per-atom epot, host
        density, forces, virial and pressure tensor, plus the kinetic
        energy; sums in float64."""
        self.n_observe += 1
        nt = self.cfg.ntypes
        with self.timers.section("observe"):
            if nt > 1:
                F, epot, rho, _, virial, presstens = eam_kernels_cl_mt(
                    cl.xi, cl.typ, cl.alive, self.eam_run, template.grid, nt)
            else:
                F, epot, rho, _, virial, presstens = eam_kernels_cl(
                    cl.xi, cl.alive, self.eam_run, template.grid)
            af = cl.alive.to(torch.float64)
            ekin = 0.5 * ((cl.mom.double() ** 2).sum(1) * af
                          / cl.mass.double()).sum()
            dims = template.grid.dims
            scene = cl_to_scene(cl, template).replace(
                force=_from_cl(F, dims), epot=_from_cl(epot, dims))
            vals = torch.cat([epot.double().sum()[None], ekin[None],
                              virial[None], presstens]).tolist()
            _sync(self.device)
        return SimState(scene=scene, step=gstep, epot_total=vals[0],
                        ekin=vals[1], virial=vals[2],
                        presstens=np.asarray(vals[3:]),
                        rho=_from_cl(rho, dims), ttm_grid=ttm_grid)

    def run_fused(self, steps: Optional[int] = None) -> SimState:
        """The fused hot loop with periodic I/O (simulation.py:2463)."""
        cfg = self.cfg
        steps = self._steps_to_run(steps)
        ttm_on = self.ensemble == "ttm"
        intervals = [i for i in (cfg.eng_int, cfg.checkpt_int, cfg.ttm_int)
                     if i > 0]
        block = max(1, min([steps] + intervals) if intervals
                    else min(steps, 100))
        template = self.scene
        step, carry = self._build(
            template, self._initial_ttm_grid() if ttm_on else None,
            self.step_count)
        self.timers.start("total")
        nactive = integrate.count_active_dof(self.scene)
        if cfg.eng_int > 0 and self.eng is None:
            self.eng = EngWriter(self._path(cfg.outfiles + ".eng"),
                                 ttm=cfg.ttm.enabled,
                                 append=cfg.simulation_phase > 1)
        done = 0
        state = None
        grow_tries = 0
        regrid_at = -1
        while done < steps:
            prev_carry = carry
            b = _clamp_block(min(block, steps - done),
                             self.step_count + done, intervals)
            with self.timers.section("main"):
                for _ in range(b):
                    carry = step(*carry)
                _sync(self.device)
            if int(carry[0].overflow) > 0:
                # a rebin overflowed the cell capacity: grow the slot axis
                # (alloc_cell, imd_alloc.c:551) and retry the block
                grow_tries += 1
                if grow_tries > 6:
                    raise RuntimeError(
                        f"cell capacity overflow persists after "
                        f"{grow_tries - 1} growths (capacity "
                        f"{self.grid.capacity})")
                old = self.grid.capacity
                new_cap = ((old + 8 + 7) // 8) * 8
                print(f"# cell overflow: growing capacity {old} -> "
                      f"{new_cap} and retrying the block", flush=True)
                sc_prev = cl_to_scene(prev_carry[0], template).replace(
                    overflow=torch.zeros_like(prev_carry[0].overflow))
                regridded = None
                if new_cap > REGRID_CAPACITY and regrid_at != done:
                    regridded = self._regrid_scene(sc_prev)
                if regridded is not None:
                    regrid_at = done
                    grow_tries = 0
                    template = regridded
                else:
                    template = grow_capacity(sc_prev, new_cap)
                self.grid = template.grid
                self.scene = template
                step, carry = self._build(
                    template, prev_carry[1] if ttm_on else None,
                    self.step_count + done)
                continue
            done += b
            gstep = self.step_count + done
            stop = os.path.exists(self._path("stop"))
            force_write = os.path.exists(self._path("write"))
            walltime_up = (cfg.maxwalltime > 0 and
                           time.time() - self.start_time > cfg.maxwalltime)
            if not (any(_iv_due(gstep, i) for i in intervals) or stop
                    or force_write or walltime_up or done >= steps):
                continue
            state = self.observe(carry[0], template, gstep,
                                 carry[1] if ttm_on else None)
            with self.timers.section("io"):
                if _iv_due(gstep, cfg.eng_int):
                    self._write_eng(state, nactive)
                    if ttm_on:
                        self._write_laser_log(state, gstep)
                if _iv_due(gstep, cfg.checkpt_int):
                    self.write_checkpoint(state, gstep // cfg.checkpt_int)
                if ttm_on and _iv_due(gstep, cfg.ttm_int):
                    write_ttm(self._path(
                        f"{cfg.outfiles}.{gstep // cfg.ttm_int}.ttm"),
                        state.ttm_grid)
                if force_write:
                    os.remove(self._path("write"))
                    self.write_checkpoint(state, gstep)
                if stop:
                    os.remove(self._path("stop"))
                if stop or walltime_up:
                    self.write_checkpoint(state, gstep)
                    break
        if state is None:
            state = self.observe(carry[0], template, self.step_count + done,
                                 carry[1] if ttm_on else None)
        self.scene = state.scene
        self.step_count = state.step
        self.timers.stop("total")
        n = max(n_atoms(state.scene), 1)
        print(self.timers.report(n_atoms=n, n_steps=max(done, 1)),
              flush=True)
        return state

    def _regrid_scene(self, scene: Scene) -> Optional[Scene]:
        """Re-derive the cell grid for the current density under
        ``REGRID_CAPACITY`` and re-bin (simulation.py:1850); None when no
        grid fits or a re-bin could change nothing."""
        flat = {k: v.detach().cpu().numpy()
                for k, v in flatten_atoms(scene).items()}
        pos = flat["pos"][flat["mask"]].astype(np.float64)
        got = optimize_grid_dims(self.box, self.grid.cutoff, self.grid.skin,
                                 pos, dtype=np_dtype(self.dtype),
                                 headroom_slots=2,
                                 max_capacity=REGRID_CAPACITY)
        if got is None:
            return None
        dims, cap = got
        if tuple(dims) == tuple(self.grid.dims) \
                and cap <= self.grid.capacity:
            return None
        new_grid = CellGrid(box=self.box, dims=tuple(dims), capacity=cap,
                            cutoff=self.grid.cutoff, skin=self.grid.skin)
        new_scene = rebin(scene, new_grid)
        while int(new_scene.overflow) > 0:
            cap = ((cap + 8 + 7) // 8) * 8
            if cap > REGRID_CAPACITY:
                return None
            new_grid = new_grid.replace(capacity=cap)
            new_scene = rebin(scene, new_grid)
        print(f"# density re-grid: {tuple(self.grid.dims)} cap "
              f"{self.grid.capacity} -> {tuple(dims)} cap {cap} "
              f"({len(pos)} atoms)", flush=True)
        return new_scene

    # -- output ---------------------------------------------------------
    def _volume(self) -> float:
        return abs(float(np.linalg.det(np.asarray(self.box.h,
                                                  np.float64))))

    def _write_eng(self, state: SimState, nactive: float):
        """One .eng line (simulation.py:2960): the epot of the force call
        at the start of the last step, labelled (step-1)*dt."""
        n = max(n_atoms(state.scene), 1)
        if (state.ttm_grid is not None and state.ttm_grid.cfl_overflow
                and not getattr(self, "_cfl_warned", False)):
            self._cfl_warned = True
            print("# WARNING: TTM diffusion CFL demand exceeded "
                  "max_substeps — the electron grid is integrated at "
                  "the clamped substep count (raise ttm max_substeps "
                  "or coarsen ttmdimx)", flush=True)
        vol = self._volume()
        ttm_eng = None
        if self.cfg.ttm.enabled:
            ttm_eng = float(ttm_mod.electron_energy_total(state.ttm_grid,
                                                          self.ttm_params))
        self.eng.write(
            time=float(state.step - 1) * self.cfg.timestep,
            epot_per_atom=state.epot_total / n,
            temperature=2.0 * state.ekin / max(nactive, 1.0),
            pressure=(2.0 * state.ekin + state.virial) / (3.0 * vol),
            volume=vol, ttm_eng=ttm_eng)

    def _write_laser_log(self, state: SimState, gstep: int):
        """The .laser log line (simulation.py:3182) without a TMM solver:
        step, time, NaN intensity, absorbed fluence, NaN reflectivity."""
        cfg = self.cfg
        t_si = gstep * float(cfg.timestep) * units.TIME_UNIT_S
        hts = self.box.heights()
        area = float(hts[1] * hts[2]) * 1e-20          # A^2 -> m^2
        eabs = float(state.ttm_grid.eabs) * units.EV_TO_J / max(area,
                                                                 1e-300)
        nan = float("nan")
        path = self._path(cfg.outfiles + ".laser")
        header = not os.path.exists(path)
        with open(path, "a") as f:
            if header:
                f.write("# step t_fs I_t_Wm2 Eabs_Jm2 refl\n")
            f.write(f"{gstep} {t_si * 1e15:.4f} {nan:.6e} {eabs:.6e} "
                    f"{nan:.6e}\n")

    def _chkpt_data(self, state: SimState) -> ChkptData:
        """Checkpoint record: number type mass x y z vx vy vz Epot, and the
        host density eam_rho unless ``norhoh`` (simulation.py:3044)."""
        flat = {k: v.detach().cpu().numpy()
                for k, v in flatten_atoms(state.scene).items()}
        m = flat["mask"]
        mass = flat["mass"][m]
        columns = "number type mass x y z vx vy vz Epot".split()
        data = flat["epot"][m][:, None]
        if not self.cfg.norhoh:
            rho = state.rho.reshape(-1).detach().cpu().numpy()[m]
            data = np.concatenate([data, rho[:, None]], axis=1)
            columns.append("eam_rho")
        h = np.asarray(self.box.h)
        return ChkptData(number=flat["id"][m], type=flat["vtype"][m],
                         mass=mass, pos=flat["pos"][m],
                         vel=flat["mom"][m] / mass[:, None], data=data,
                         columns=columns, box_x=h[0], box_y=h[1],
                         box_z=h[2])

    def write_checkpoint(self, state: SimState, fzhlr: int):
        """<outfiles>.<fzhlr:05d>.{chkpt,itr[,ttm]}; fzhlr -1 names the
        end-of-run "-final" set (imd_io_3d.c:995).  The TTM restart
        sidecar (.ttmaux.npz) is not written: TTM restarts are not
        ported."""
        cfg = self.cfg
        d = self._chkpt_data(state)
        base = self._path(cfg.outfiles + "-final" if fzhlr == -1
                          else f"{cfg.outfiles}.{fzhlr:05d}")
        write_chkpt(base + ".chkpt", d, binary=bool(cfg.binary_output),
                    double=bool(cfg.hpo), precision=17 if cfg.hpo else 12)
        write_itr(base + ".itr", checkpoint=fzhlr, startstep=state.step + 1,
                  box_x=d.box_x, box_y=d.box_y, box_z=d.box_z)
        if cfg.ttm.enabled and state.ttm_grid is not None:
            write_ttm(base + ".ttm", state.ttm_grid)
