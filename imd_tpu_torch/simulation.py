"""The param-file driver (port of imd_tpu/simulation.py: ``Simulation``
for the configurations ``_fused_eligible`` sends to ``run_fused``,
simulation.py:1791, 2463-3155, and for those it sends to its general step,
simulation.py:1304, 2033, under ``ensemble nve``, ``nvt``, ``ber`` (with
the ``endtemp`` ramp), ``mik`` and ``glok``, and ``ensemble cg``,
simulation.py:1938: pair potentials of 1-4 species, and EAM sets off the
fused loop).

A run reads its configuration (``SimConfig``), loads the EAM tables (the
reference's three files, or one DYNAMO setfl/funcfl file; up to 4 species)
and the atoms (an ``_fcc``-style generated lattice or a ``.chkpt``), bins them
on the host, and runs the fused cells-last hot loop (ops/fused_step.py)
in blocks that end on the next I/O step.  At every block end where some
output is due, ``observe`` evaluates the observables with the B4 kernels
(ops/forces_pallas.py: K4 ``eam_rho_e``, K5 ``eam_force_s``; with
``ntypes`` > 1 the alloy pair K8, K9) and the
driver writes ``.eng``, ``.chkpt``/``.itr`` (with ``.nrb`` and the TTM's
``.ttm`` and ``.ttmaux.npz``), ``.ttm`` and the ``.laser`` log at their
intervals, and the interval outputs of imd_tpu's loops: ``.dist``
(io/distrib.py), ``.ppm`` (io/pictures.py), the selected-config observers
``.avp``/``.dsp``/``.dem``/``.ef`` and the ``.wf``/``.force``/``.stress``/
``.nb`` writers (io/select.py; the per-atom stress and the coordination
from the stencil oracles of ops/forces.py), the ORDPAR Epot column and the
RELAXINFO ``.eng`` columns.  ``-r N`` resumes a TTM run from its
checkpoint set: the grid, the COLRAD populations, the FDTD fields, the
virtual lattice and the per-atom FD index (``_initial_ttm_state``).  The
flagship physics rides the fused loop as in imd_tpu: the TMM laser
(``tmm``, models/tmm.py) inside calc_ttm, the NRB rear boundary
(``nrb_*``, models/nrb.py) inside the step, FILTER (``filter_*``,
models/filter.py) between blocks every ``filter_int`` steps, and
``ttm_solver implicit``; and the rest of the 1-D TTM physics: the FDTD
laser (``fdtd``, models/fdtd.py), COLRAD (``colrad``, ``colrad_mpi``;
models/colrad.py), the virtual lattice (``vlatdim``) and the electron
blast force (``elecpress``), whose states ride the step's carry and the
``.ttm`` files; the EOS is the FEG's or, where ``eos_dir`` holds the
reference's tables, ``TabulatedEOS``.  A rebin that overflows the cell
capacity grows the slot axis and retries the block from the
pre-block state; past ``REGRID_CAPACITY`` slots the grid is first
re-derived for the current density (``_regrid_scene``).

A pair potential (``potfile``, ``lj_*``/``ljg_*``, ``morse_*``,
``buck_*``) runs the general step instead (``make_step_fn``, ``run_general``),
and so does an EAM set under ``nvt``, ``ber``, ``mik``, ``glok`` or ``cg``
or with an ``endtemp`` ramp (``_fused_eligible``): the skin check (one host
read a step: eager torch has no ``lax.cond``), the device rebin when it
fires, the forces (pairs: B6, ``compute_pair_forces_pallas``, the 13 views
and K12 on the degree-12 fastpoly fit, as imd_tpu's TPU engine runs it, or
for 2-4 species K12-mt on the fit's column per type pair, as imd_tpu's XLA
engines evaluate it; EAM: K4/K5,
``compute_eam_forces_pallas``, or with 2-4 species K8/K9,
``compute_eam_forces_pallas_mt``, imd_tpu simulation.py:1022-1032) and the
ensemble's leapfrog (integrate.py; GLOK with relax.fire_update), its
thermostat's state (eta, FIRE's) carried on the device; ``.eng`` takes the
step's own sums, as imd_tpu's general loop does, with the Nose-Hoover
``eta*tau_eta`` column under nvt.  GLOK and MIK stop a phase at the first
block end where ``check_relaxed`` holds.  ``ensemble cg`` (``_run_cg``)
relaxes by Polak-Ribiere conjugate gradients (relax.cg_relax, two force
calls an iteration) in blocks, with the skin check, the .eng line and
``check_relaxed`` between blocks only.

The loop over steps is Python (the JAX package's ``fori_loop`` blocks);
the blocks stay, so output lands on the same steps as imd_tpu's.

Every setting that would take imd_tpu off the fused path, or onto a
feature this port does not have yet, raises NotImplementedError naming the
tag and the ROADMAP item (``UNPORTED``).  The port never silently computes
something else.  One recorded exception (ROADMAP C6): ``filter_int 0``
enables FILTER without a cadence, which moves imd_tpu off its fused loop
onto the general step where FILTER never fires; the port runs such a file
on the fused loop with FILTER off, the same result.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from imd_tpu_torch import integrate, relax, units
from imd_tpu_torch.config import SimConfig
from imd_tpu_torch.io import ttm_io
from imd_tpu_torch.io.chkpt import ChkptData, data_column, read_chkpt, \
    read_itr, write_chkpt, write_itr
from imd_tpu_torch.io.distrib import compute_distrib, write_distrib
from imd_tpu_torch.io.eng import EngWriter
from imd_tpu_torch.io.pictures import write_picture
from imd_tpu_torch.io.select import (SelectWriters, flat_host,
                                     write_force_potfit, write_nb,
                                     write_press, write_wf)
from imd_tpu_torch.io.ttm_io import write_ttm
from imd_tpu_torch.models import colrad as colrad_mod
from imd_tpu_torch.models import fdtd as fdtd_mod
from imd_tpu_torch.models import nrb as nrb_mod
from imd_tpu_torch.models import ttm as ttm_mod
from imd_tpu_torch.models.eos import FEGEos, TabulatedEOS
from imd_tpu_torch.models.tmm import do_tmm, make_tmm_params
from imd_tpu_torch.kernels import MAX_NT
from imd_tpu_torch.models.potential import (EAMPotential, buckingham_table,
                                            eam_to_fastpoly, lj_table,
                                            ljg_table, morse_table,
                                            read_eam, read_pot_table,
                                            to_fastpoly, with_interpolation)
from imd_tpu_torch.models.setfl import maybe_read_dynamo
from imd_tpu_torch.ops.forces import (compute_eam_forces, compute_nbanz,
                                      compute_ordpar, compute_pair_forces)
from imd_tpu_torch.ops.forces_fast import _from_cl, _to_cl
from imd_tpu_torch.ops.forces_pallas import (compute_eam_forces_pallas,
                                             compute_eam_forces_pallas_mt,
                                             compute_pair_forces_pallas,
                                             eam_kernels_cl,
                                             eam_kernels_cl_mt, eam_rho_e,
                                             eam_rho_e_mt,
                                             make_neighbor_views)
from imd_tpu_torch.ops.fused_step import (cl_inputs, cl_to_scene,
                                          make_filter_apply, make_fused_step,
                                          make_fused_ttm_step)
from imd_tpu_torch.ops.geometry import (Box, CellGrid, choose_grid,
                                        measured_capacity, np_dtype,
                                        optimize_grid_dims, with_capacity)
from imd_tpu_torch.phases import StepCounters, no_timer
from imd_tpu_torch.scene import (Scene, flatten_atoms, grow_capacity,
                                 make_scene, n_atoms, needs_rebin, rebin)
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

# the ensembles of the general step (make_step_fn; cg: _run_cg)
GENERAL_ENSEMBLES = ("nve", "nvt", "ber", "mik", "glok", "cg")


def _ramped(cfg) -> bool:
    """An endtemp ramp: the thermostat's target runs from starttemp to
    endtemp (imd_tpu simulation.py:1297-1302)."""
    return cfg.endtemp > 0 and cfg.endtemp != cfg.starttemp


# the tags of the pair potentials (lj_epsilon also starts ljg_*)
_PAIR_TAGS = ("potfile", "lj_epsilon", "morse_epsilon", "buck_a")


def _general_step(cfg) -> bool:
    """Whether a phase runs the general step (``_fused_eligible`` false): a
    pair potential, or an EAM set under a thermostat or relaxation or with
    an endtemp ramp."""
    return (_any_set(cfg, _PAIR_TAGS) or _ramped(cfg)
            or cfg.ensemble not in ("nve", "ttm"))


# ROADMAP C10: the fitted engine clamps a column past its end to the fit's
# end value, which is not zero (C2), so a column that ends before the grid
# cutoff would add a constant force shell out to it
UNEQUAL_ENDS = ("pair table columns that end at different radii (ntypes > "
                "1; r_cut, or 2.5 sigma per pair, ROADMAP C10)")


def _pair_rcut(cfg, sigma) -> tuple:
    """An analytic pair table's column ends, one per upper-triangular
    type pair: ``r_cut``, else 2.5 sigma (imd_tpu simulation.py:236-266)."""
    return tuple(cfg.r_cut or (2.5 * s for s in sigma))


def _analytic_pair_ends(cfg) -> tuple:
    """The column ends ``Simulation._pair_table`` gives an analytic pair
    table with ntypes > 1; () otherwise (a potfile's come from its file)."""
    if cfg.ntypes < 2 or cfg.potfile:
        return ()
    sigma = (cfg.lj_sigma if cfg.lj_epsilon else cfg.morse_sigma
             if cfg.morse_epsilon else cfg.buck_sigma if cfg.buck_a else ())
    return _pair_rcut(cfg, sigma)

# (what, predicate, ROADMAP item): settings this port does not run yet
UNPORTED = (
    (f"ntypes > {MAX_NT} (imd_tpu's general step)",
     lambda c: c.ntypes > MAX_NT, "A9c"),
    ("asympot with ntypes > 1 (imd_tpu's oracle engine)",
     lambda c: c.asympot and c.ntypes > 1, "A9c"),
    (UNEQUAL_ENDS, lambda c: len(set(_analytic_pair_ends(c))) > 1, "A9b"),
    ("pair potentials (potfile, lj_*, morse_*, buck_*) under ensemble ttm",
     lambda c: _any_set(c, _PAIR_TAGS) and c.ensemble == "ttm", "A9b"),
    ("analytic many-body interactions (stiweb/ters/keating/ttbp/meam/"
     "dipole tags)", lambda c: _any_set(c, _FLAT_INTERACTION_TAGS), "A9c"),
    ("eeam_energy_file / adp_*potfile",
     lambda c: _any_set(c, ("eeam_energy_file", "adp_upotfile")), "A9c"),
    ("charges / Ewald (charge, sm_chi_0)",
     lambda c: _any_set(c, ("charge", "sm_chi_0")), "A9c"),
    ("ensembles other than nve, nvt, ber, mik, glok, cg and ttm (lang, "
     "and, nvx, npt_iso, npt_axial, sllod, frac, ftg, finnis, stm, damp, "
     "...)", lambda c: c.ensemble not in GENERAL_ENSEMBLES + ("ttm",),
     "A9c"),
    ("the TTM under ensemble nve",
     lambda c: c.ensemble == "nve" and c.ttm.enabled, "A9c"),
    # imd_tpu runs a ramped TTM file on its general step, which carries
    # the TTM there (ROADMAP C6)
    ("endtemp ramps under ensemble ttm",
     lambda c: _ramped(c) and c.ensemble == "ttm", "A9c"),
    ("per-step drivers (getmin/getsaddle, nclones, ep_*, shock_mode, "
     "pdecay, restrictions, fbc_*, zapp, bend, rigid groups, "
     "HOMDEF/DEFORM, spring_rate, epitax, bb_*)",
     lambda c: _any_set(c, (
         "getmin", "getsaddle", "ep_n", "shock_mode", "pdecay_mode",
         "xipdecay", "restrictions", "fbc_forces", "zapp_threshold",
         "bend_nmoments", "rigid_groups", "fbc_endforces", "fbc_dforces",
         "fbc_bdforces", "relax_rate", "lindef_interval", "max_deform_int",
         "ep_max_int", "spring_rate", "bb_epscrit"))
     or c.nclones > 1 or any(r > 0 for r in c.epitax_rate), "A9c"),
    ("laser_rescale_mode other than 0 and 4",
     lambda c: c.ttm.enabled and c.laser.rescale_mode not in (0, 4), "A9c"),
    # the general step carries none of them (imd_tpu's does, under every
    # ensemble): they run on the fused EAM loop only (ROADMAP C6)
    ("the TTM (ttmdimx), tmm, fdtd, nrb_* or filter_* on the general step "
     "(a pair potential; EAM under nvt, ber, mik, glok, cg or an endtemp "
     "ramp)",
     lambda c: _general_step(c) and (
         c.ttm.enabled or c.tmm.enabled or c.fdtd.enabled
         or c.nrb.enabled or c.filter.enabled), "A9b"),
    # with fdtd (the 2-D FDTD), colrad or vlatdim on it
    ("3-D TTM (ttmdimy / ttmdimz > 1)",
     lambda c: c.ttm.enabled and (c.ttm.fd_ny > 1 or c.ttm.fd_nz > 1),
     "A7"),
    ("cpu_dim > 1 (several devices)",
     lambda c: int(np.prod(c.cpu_dim)) > 1, "A11"),
    ("socket_int (online steering, io/socket_io.py)",
     lambda c: c.socket_int > 0, "A6"),
    ("lb_frequency (LOADBALANCE)", lambda c: c.lb_frequency > 0, "A11"),
    ("hc_int (the heat-current profile of the nvx general step)",
     lambda c: c.hc_int > 0, "A9c"),
    ("nmoldyn_int / dsf_int (the trajectory observers, io/traj.py)",
     lambda c: c.nmoldyn_int > 0 or c.dsf_int > 0, "A6"),
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
    rho: Optional[torch.Tensor]   # [gx,gy,gz,cap] host density (EAM)
    ttm_grid: Optional[object] = None
    cstate: Optional[object] = None   # ColradGridState
    fdtd: Optional[object] = None     # FDTDState
    vstate: Optional[object] = None   # VlatState
    # [gx,gy,gz,cap] int32: the FD cell of each slot's last update_fd
    fdi: Optional[torch.Tensor] = None
    eta: Optional[float] = None       # the Nose-Hoover eta (nvt)


@dataclasses.dataclass(eq=False)
class StepState:
    """The general step's carry on the device (the fields of imd_tpu's
    SimState that its nve, nvt, ber, mik and glok steps read and
    write)."""
    scene: Scene
    step: int                     # global step (completed iterations)
    epot_total: torch.Tensor      # float64: sum of the last force call's
    virial: torch.Tensor          # epot, its virial and pressure tensor
    presstens: torch.Tensor
    stats: integrate.StepStats    # the last step's (ber reads its Ekin)
    nbl_count: int = 0            # skin-triggered rebins of the run
    eta: Optional[torch.Tensor] = None          # float64 0-d (nvt)
    fire: Optional[relax.FireState] = None      # glok


def _iv_pair(iv):
    """An interval as (interval, phase): AVPOS fires on the (steps -
    avpos_start) lattice (imd_main_3d.c:629-639) and passes a pair."""
    return iv if isinstance(iv, tuple) else (int(iv), 0)


def _iv_due(gstep: int, iv) -> bool:
    i, ph = _iv_pair(iv)
    return i > 0 and (gstep - ph) % i == 0


def _clamp_block(b: int, cur: int, intervals, specials=()) -> int:
    """Shrink a block so that it ends on the next due step of any active
    interval (on its phase lattice) or of a one-off step (imd_tpu
    simulation.py:78)."""
    cands = []
    for iv in intervals:
        i, ph = _iv_pair(iv)
        if i > 0:
            cands.append(i - (cur - ph) % i)
    cands += [s - cur for s in specials if s > cur]
    return min([b] + cands)


def _block_size(steps: int, intervals) -> int:
    """The dispatch block: the smallest interval, else 100 steps."""
    return max(1, min([steps] + [_iv_pair(i)[0] for i in intervals])
               if intervals else min(steps, 100))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _photon_flux(pulse, hnu_ev: float):
    """phi(t_si) [1/m^2/s]: the MULTIPHOTON photon flux I(t) / h nu of the
    wave solver's pulse tags at ``t_si`` (a tensor, seconds), with the
    TMM's second pulse (simulation.py:826-846; tmm.intensity's envelope,
    imd_tmm.c:197-198)."""
    inv_hnu_j = 1.0 / (hnu_ev * 1.602176634e-19)
    i0, t0 = pulse.I0, pulse.t0_s
    s2 = max(pulse.sigma_t_s, 1e-300) ** 2
    t1 = getattr(pulse, "t1_s", 0.0)
    s21 = getattr(pulse, "sigma_t1_s", 0.0) ** 2

    def phi(t_si):
        it = i0 * torch.exp(-(t_si - t0) ** 2 / s2)
        if s21 > 0.0:
            it = it + i0 * torch.exp(-(t_si - t1) ** 2 / s21)
        return it * inv_hnu_j
    return phi


class Simulation:
    """Host-side driver owning config, potentials, atoms, I/O and the
    step.  ``device`` is where the state lives ("cuda" by default);
    ``timer`` (phases.CudaPhaseTimer, or nothing) times the step's phases:
    the fused step's, or the general step's ``skin``, ``rebin``,
    ``views``, ``forces`` and ``integrate``."""

    def __init__(self, cfg: SimConfig, workdir: str = ".",
                 dtype=torch.float32, device="cuda", timer=no_timer):
        check_ported(cfg)
        self.cfg = cfg
        self.workdir = workdir
        self.dtype = dtype
        self.device = torch.device(device)
        self.timer = timer
        self.timers = Timers()
        self.counters = StepCounters()
        # (steps, seconds) of every block of the main loop that was kept
        self.block_seconds = []
        self.nbl_count = 0      # skin rebins of the general loop's run
        self.n_observe = 0
        self.n_filter = 0       # FILTER applications of the fused loop
        # seconds of the set-up parts that the flagship physics adds
        self.setup_parts = {}
        self.eng: Optional[EngWriter] = None
        t0 = time.perf_counter()
        self._load_potential()
        self._load_atoms()
        self._select_engine()
        self._select_integrator()
        self.nrb_state = self._init_nrb()
        _sync(self.device)
        self.setup_seconds = time.perf_counter() - t0
        self.start_time = time.time()

    def _path(self, name: str) -> str:
        return name if os.path.isabs(name) else os.path.join(self.workdir,
                                                              name)

    # -- setup ----------------------------------------------------------
    def _load_potential(self):
        """imd_tpu's _load_potential (simulation.py:180-275) for tables:
        an EAM set (``core_potential_file``) if one is named, else a pair
        table (``potfile``, or the analytic ``lj_*`` with ``ljg_*``,
        ``morse_*``, ``buck_*``; ``r_cut`` defaults to 2.5 sigma)."""
        cfg = self.cfg
        self.eam = self.pair = None
        if not cfg.core_potential_file:
            self.pair = with_interpolation(self._pair_table(),
                                           cfg.pot_interp)
            if cfg.ntypes > 1 and np.ptp(np.asarray(self.pair.end)) > 0:
                raise NotImplementedError(
                    f"{UNEQUAL_ENDS} is not ported to imd_tpu_torch yet "
                    f"(ROADMAP A9b)")
            self.cutoff = math.sqrt(self.pair.max_end)
            return
        self._load_eam()

    def _pair_table(self):
        cfg = self.cfg
        dt = np_dtype(self.dtype)
        nt = cfg.ntypes
        if cfg.potfile:
            return read_pot_table(self._path(cfg.potfile), nt * nt, True, dt)
        if cfg.lj_epsilon and any(cfg.ljg_eps):
            return ljg_table(list(cfg.lj_epsilon), list(cfg.lj_sigma),
                             list(cfg.ljg_eps), list(cfg.ljg_r0),
                             list(cfg.ljg_sig),
                             list(_pair_rcut(cfg, cfg.lj_sigma)), nt,
                             dtype=dt)
        if cfg.lj_epsilon:
            return lj_table(list(cfg.lj_epsilon), list(cfg.lj_sigma),
                            list(_pair_rcut(cfg, cfg.lj_sigma)), nt,
                            dtype=dt)
        if cfg.morse_epsilon:
            return morse_table(list(cfg.morse_epsilon), list(cfg.morse_alpha),
                               list(cfg.morse_sigma),
                               list(_pair_rcut(cfg, cfg.morse_sigma)), nt,
                               dtype=dt)
        if cfg.buck_a:
            return buckingham_table(list(cfg.buck_a), list(cfg.buck_c),
                                    list(cfg.buck_sigma),
                                    list(_pair_rcut(cfg, cfg.buck_sigma)),
                                    nt, dtype=dt)
        raise ValueError("no potential configured "
                         "(potfile / EAM files / lj_* parameters)")

    def _load_eam(self):
        """The EAM-table branch (simulation.py:180-207): a DYNAMO
        setfl/funcfl file by its suffix (one file carries all three
        tables), else the reference's three table files."""
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

    def _apply_generate_shifts(self, pos, typ, box_diag, shf, shr):
        """Vacuum margins on a generated lattice (imd_tpu
        simulation.py:444-484; imd_generate.c:314-365 and generate_fcc's
        margin filter, 533-540): x and y grow by front + rear, rounded up
        to whole lattice cells (the excess widens the rear margin), the
        grown box is filled and the atoms inside the x/y margins dropped;
        z only grows the box.  As imd_tpu, x/y round to whole box_unit
        cells, not to multiples of cpu_dim * box_unit."""
        cfg = self.cfg
        bp = np.asarray(cfg.box_param, int)
        if bp.size < 3 or np.any(bp[:3] <= 0) or \
                cfg.coordname.lstrip("_").lower() in ("qc", "quasi"):
            raise ValueError("shift*_front/rear need a 3-component "
                             "box_param cubic-family generator")
        bu_ax = box_diag[:3] / bp[:3]
        newbp = bp.copy()
        rear = shr.copy()
        for ax in (0, 1):
            enlarged = box_diag[ax] + shf[ax] + shr[ax]
            newbp[ax] = int(math.ceil(enlarged / bu_ax[ax] - 1e-9))
            rear[ax] += newbp[ax] * bu_ax[ax] - enlarged
        pos, typ, box_diag = generate_atoms(cfg.coordname, tuple(newbp),
                                            cfg.box_unit, cfg.ntypes)
        box_diag = np.asarray(box_diag, float)
        pos = np.asarray(pos, float)
        keep = np.ones(len(pos), bool)
        for ax in (0, 1):
            if shf[ax] > 0:
                keep &= pos[:, ax] >= shf[ax]
            if rear[ax] > 0:
                keep &= pos[:, ax] <= box_diag[ax] - rear[ax]
        box_diag[2] += shf[2] + shr[2]
        return pos[keep], np.asarray(typ)[keep], box_diag

    def _load_atoms(self):
        """Generated lattice or .chkpt start (simulation.py:483-605), with
        the shift*_front/rear vacuum margins; a checkpoint's DISLOC
        reference columns (x_ref y_ref z_ref Epot_ref) seed the .dsp/.dem
        observers."""
        cfg = self.cfg
        itr = {}
        self._disloc_ref = None
        shf = np.array([cfg.shiftx_front, cfg.shifty_front,
                        cfg.shiftz_front], float)
        shr = np.array([cfg.shiftx_rear, cfg.shifty_rear, cfg.shiftz_rear],
                       float)
        have_shift = bool(np.any(shf > 0) or np.any(shr > 0))
        if cfg.coordname.startswith("_"):
            pos, typ, box_diag = generate_atoms(cfg.coordname, cfg.box_param,
                                                cfg.box_unit, cfg.ntypes)
            if have_shift:
                pos, typ, box_diag = self._apply_generate_shifts(
                    pos, typ, np.asarray(box_diag, float), shf, shr)
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
            xr = [data_column(d, n) for n in ("x_ref", "y_ref", "z_ref")]
            er = data_column(d, "Epot_ref")
            have_xr = all(c is not None for c in xr)
            if have_xr or er is not None:
                self._disloc_ref = (number, np.stack(xr, axis=1)
                                    if have_xr else None, er)
            mass = d.mass
            box_x = itr.get("box_x", d.box_x if d.box_x is not None
                            else cfg.box_x)
            box_y = itr.get("box_y", d.box_y if d.box_y is not None
                            else cfg.box_y)
            box_z = itr.get("box_z", d.box_z if d.box_z is not None
                            else cfg.box_z)
            if have_shift:
                # the box diagonal grows by front + rear, the atoms move by
                # front (imd_io_3d.c:87-89, 341-345)
                box_x = [box_x[0] + shf[0] + shr[0], box_x[1], box_x[2]]
                box_y = [box_y[0], box_y[1] + shf[1] + shr[1], box_y[2]]
                box_z = [box_z[0], box_z[1], box_z[2] + shf[2] + shr[2]]
                pos = np.asarray(pos, float) + shf[None, :]
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
        # the NRB reference state keys on the handed-over atoms
        if self.nrb_state is not None:
            self.nrb_state = self._nrb_from_scene()

    def _select_engine(self):
        """Always the port's kernels on the fitted polynomials, the EAM
        set's or the pair table's (to_fastpoly with vcap 50, as imd_tpu's
        Pallas engine, simulation.py:424-431; the fit has a column per type
        pair, which K12-mt reads for ntypes > 1).  imd_tpu picks that
        engine only up to capacity 32 (a TPU VMEM limit,
        simulation.py:398); the CUDA kernels have no such limit."""
        self.eam_run = self.pair_run = None
        if self.eam is not None:
            self.eam_run = eam_to_fastpoly(self.eam)
        else:
            self.pair_run = to_fastpoly(self.pair, vcap=50.0)

    def _select_integrator(self):
        """The TTM and its physics (simulation.py:700-873): the laser (TMM
        or FDTD, not both), COLRAD, the virtual lattice; GLOK's FIRE knobs
        (simulation.py:873-887)."""
        cfg = self.cfg
        self.ensemble = cfg.ensemble
        self.ttm_params = self.eos = self.tmm_params = None
        self.fdtd_params = self.colrad_tab = self.colrad_step = None
        self.colrad_phi = self.vlat_params = self.vlat_state0 = None
        self.fire_cfg = None
        if self.ensemble == "glok":
            R = cfg.relax
            self.fire_cfg = relax.FireConfig(
                incfac=R.fire_incfac, decfac=R.fire_decfac,
                mix0=R.fire_mix, mixdec=R.fire_mixdec,
                minsteps=R.fire_minsteps,
                max_timestep=(R.fire_maxtimestep * cfg.timestep
                              if R.fire_maxtimestep > 0 else 0.0),
                ekin_threshold=(R.glok_ekin_threshold
                                if R.glok_ekin_threshold > 0 else 1e30))
        if self.ensemble != "ttm":
            return
        cfg.ttm.enabled = True
        self.ttm_params = ttm_mod.make_params(cfg.ttm, self.box, self.cutoff)
        self.eos = self._select_eos()
        if cfg.tmm.enabled:
            t0 = time.perf_counter()
            self.tmm_params = make_tmm_params(cfg.tmm, self.dtype,
                                              self.device)
            self.setup_parts["tmm_params"] = time.perf_counter() - t0
        if cfg.fdtd.enabled:
            if self.tmm_params is not None:
                raise ValueError("enable either TMM or FDTD, not both")
            self.fdtd_params = fdtd_mod.make_fdtd_params(
                cfg.fdtd, self.ttm_params, self.dtype, self.device)
        if cfg.colrad:
            t0 = time.perf_counter()
            self._select_colrad()
            self.setup_parts["colrad_tables"] = time.perf_counter() - t0
        if cfg.ttm.vlatdim > 0:
            # the solid density from the atomic mass at the fcc-Al volume;
            # the virtual lattice starts at starttemp, else at the
            # reference's room temperature (0.0264 eV, imd_ttm.c:1038)
            dens0 = (cfg.ttm.atomic_mass * 1.66054e-27
                     / (4.05e-10 ** 3 / 4.0))
            self.vlat_params, self.vlat_state0 = ttm_mod.make_vlat(
                cfg.ttm.vlatdim, dens0=dens0,
                t0=cfg.starttemp if cfg.starttemp > 0 else 0.0264,
                dtype=self.dtype, device=self.device,
                atomic_z=cfg.ttm.atomic_z, atomic_mass=cfg.ttm.atomic_mass)

    def _select_colrad(self):
        """COLRAD's rate tables, step and MULTIPHOTON flux
        (simulation.py:767-846).  The rates: the reference's Mott /
        Fermi-Dirac integrals over its state tables where ``Al0_states.txt``
        is on disk (``colrad_rates auto`` or ``ref``), else the closed-form
        fits.  The tables are float32 whatever the run's dtype, as
        imd_tpu builds them."""
        cfg = self.cfg
        mode = cfg.colrad_rates
        states_dir = None
        if mode in ("auto", "ref"):
            cands = ([cfg.colrad_states_dir] if cfg.colrad_states_dir
                     else [self.workdir, os.path.join(self.workdir, "..")])
            for d in cands:
                if d and os.path.exists(os.path.join(d, "Al0_states.txt")):
                    states_dir = d
                    break
            if mode == "ref" and states_dir is None:
                raise FileNotFoundError(
                    "colrad_rates ref: no Al0_states.txt under "
                    f"{cands} (colrad_read_states, imd_colrad.c:523)")
        if states_dir is not None:
            print(f"# COLRAD rates: reference Mott/Fermi-Dirac integrals "
                  f"over state tables in {states_dir}", flush=True)
            self.colrad_tab = colrad_mod.build_tables(
                colrad_mod.read_states(states_dir), rates="ref",
                dtype=torch.float32, device=self.device)
        else:
            print("# COLRAD rates: van-Regemorter/Lotz closed-form fits (no "
                  "reference state tables found)", flush=True)
            self.colrad_tab = colrad_mod.build_tables(
                colrad_mod.aluminium_states(cfg.colrad_maxz,
                                            cfg.colrad_nlev),
                dtype=torch.float32, device=self.device)
        mpi_const = None
        if cfg.colrad_mpi:
            pulse = (cfg.tmm if cfg.tmm.enabled
                     else cfg.fdtd if cfg.fdtd.enabled else None)
            if pulse is None or pulse.I0 <= 0:
                warnings.warn("colrad_mpi needs a wave-solver laser "
                              "(lambda/I0/laser_t_0/laser_sigma_t); "
                              "multiphoton channels disabled")
            else:
                mpi_const = colrad_mod.mpi_constants(pulse.lambda_m)
                self.colrad_phi = _photon_flux(pulse, mpi_const[0])
        # evolve_te: the step's third output is written into grid.temp
        # (imd_colrad.c:277)
        self.colrad_step = colrad_mod.make_colrad_step(
            self.colrad_tab, evolve_te=True, mpi_const=mpi_const)

    def _init_nrb(self):
        """The NRB tables (simulation.py:901-916): read from
        ``<restart_base>.nrb`` on a restart (the layer detection must not
        rerun on a deformed configuration, nrb_readrestart,
        imd_nrb.c:2217), else detected on the start configuration."""
        cfg = self.cfg
        if not cfg.nrb.enabled:
            return None
        t0 = time.perf_counter()
        path = (self._path(cfg.restart_base + ".nrb") if cfg.restart_base
                else "")
        if path and os.path.exists(path):
            state = nrb_mod.read_nrb(path, self.dtype, self.device)
        else:
            state = self._nrb_from_scene()
        self.setup_parts["init_nrb"] = time.perf_counter() - t0
        return state

    def _nrb_from_scene(self):
        cfg = self.cfg
        mass = float(cfg.masses[0]) if cfg.masses else 26.9815
        return nrb_mod.init_nrb(self.scene, cfg.nrb.alat, cfg.nrb.k,
                                cfg.nrb.eps, mass, cfg.pbc_dirs)

    def _select_eos(self):
        """The tabulated EOS when EOS_cve_from_r_te.txt and
        EOS_ee_from_r_tesqrt.txt exist under eos_dir (simulation.py:676-691;
        the reference loads them unconditionally, imd_ttm.c:1130-1135),
        else the closed-form FEG EOS.  A malformed table raises
        RuntimeError."""
        d = self.cfg.ttm.eos_dir
        cve = self._path(os.path.join(d, "EOS_cve_from_r_te.txt"))
        ee = self._path(os.path.join(d, "EOS_ee_from_r_tesqrt.txt"))
        if os.path.exists(cve) and os.path.exists(ee):
            try:
                return TabulatedEOS.load(cve, ee, self.cfg.ttm.atomic_mass,
                                         dtype=self.dtype,
                                         device=self.device)
            except Exception as e:
                raise RuntimeError(f"EOS table load failed: {e}") from e
        return FEGEos(atomic_mass=self.cfg.ttm.atomic_mass)

    def _initial_ttm_grid(self):
        grid = ttm_mod.make_grid(self.ttm_params, self.dtype, self.device)
        if self.cfg.ttm.init_t_el > 0:
            grid = grid.replace(temp=torch.full_like(
                grid.temp, self.cfg.ttm.init_t_el), init_done=True)
        return grid

    def _initial_ttm_state(self):
        """(grid, aux, fdi) the TTM starts from: fresh, or on a restart
        restored as imd_tpu's init_state does (simulation.py:1692-1745):
        the grid and the COLRAD populations from ``<restart_base>.ttm``
        (ttm_read, imd_ttm.c:1983; colrad_read, imd_colrad.c:3028), then
        from the ``.ttmaux.npz`` sidecar the grid at full precision, the
        per-atom FD index by atom id, the FDTD fields and the virtual
        lattice; a reference-written ``.ttm`` without a sidecar gives the
        virtual lattice from its natoms -2 rows.  ``fdi`` is the Scene
        layout's [gx,gy,gz,cap] index, or None (start at -1)."""
        grid = self._initial_ttm_grid()
        aux = self._initial_aux()
        rb = self.cfg.restart_base
        if not rb:
            return grid, aux, None
        states = self._aux_states((None,) * 3 + aux + (None,))
        cstate, fdtd, vstate = (states.get(k) for k in ("cstate", "fdtd",
                                                        "vstate"))
        fdi = None
        ttm_file = self._path(rb + ".ttm")
        aux_file = self._path(rb + ".ttmaux.npz")
        if os.path.exists(ttm_file):
            grid = ttm_io.grid_from_ttm(ttm_file, grid, self.dtype)
            if cstate is not None:
                c = ttm_io.colrad_from_ttm(ttm_file, self.colrad_tab.n_lev,
                                           self.dtype, self.device)
                if c is not None:
                    cstate = cstate.replace(c=c.reshape(cstate.c.shape))
        if os.path.exists(aux_file):
            grid = ttm_io.grid_overlay_from_aux(aux_file, grid)
            f = ttm_io.fdi_from_aux(aux_file, self.scene.id,
                                    self.scene.mask)
            if f is not None:
                fdi = torch.as_tensor(f).to(self.device)
            f2, v2 = ttm_io.read_ttm_aux(aux_file, fdtd_template=fdtd,
                                         vlat_template=vstate)
            fdtd = f2 if f2 is not None else fdtd
            vstate = v2 if v2 is not None else vstate
        elif vstate is not None and os.path.exists(ttm_file):
            v2 = ttm_io.vlat_from_ttm(ttm_file, vstate)
            vstate = v2 if v2 is not None else vstate
        aux = tuple(a for a in (cstate, fdtd, vstate) if a is not None)
        return grid, aux, fdi

    def _initial_aux(self) -> tuple:
        """The start of the step's extra carry, in imd_tpu's order: the
        COLRAD or the FDTD state, then the virtual lattice's."""
        aux = ()
        if self.colrad_tab is not None:
            aux += (colrad_mod.init_grid_state(
                self.colrad_tab, self.ttm_params.nx, self.dtype,
                self.device),)
        elif self.fdtd_params is not None:
            aux += (fdtd_mod.make_state(self.fdtd_params, self.dtype,
                                        self.device),)
        if self.vlat_params is not None:
            aux += (self.vlat_state0,)
        return aux

    def _aux_states(self, carry) -> dict:
        """The extra carry's states by SimState field."""
        aux = list(carry[3:-1])
        out = {}
        if self.colrad_tab is not None:
            out["cstate"] = aux.pop(0)
        elif self.fdtd_params is not None:
            out["fdtd"] = aux.pop(0)
        if self.vlat_params is not None:
            out["vstate"] = aux.pop(0)
        return out

    def _steps_to_run(self, steps: Optional[int]) -> int:
        """maxsteps is the ABSOLUTE last step (imd_main_3d.c:151); an
        explicit ``steps`` is a relative count."""
        if steps is not None:
            return steps
        return max(self.cfg.maxsteps - self.step_count, 0)

    # -- the run --------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> SimState:
        """``ensemble cg`` first, then the fused loop where
        ``_fused_eligible`` holds, else the general step (a pair potential;
        an EAM set under a thermostat, under relaxation or with a ramp), as
        imd_tpu's run() dispatches (simulation.py:2044-2046)."""
        if self.ensemble == "cg":
            return self._run_cg(steps)
        if self._fused_eligible():
            return self.run_fused(steps)
        return self.run_general(steps)

    def _run_cg(self, steps: Optional[int] = None) -> SimState:
        """``ensemble cg`` (imd_tpu simulation.py:1938-2032): Polak-Ribiere
        CG relaxation (``relax.cg_relax`` with the general step's force
        call) in blocks of ``eng_int`` iterations (else min(steps, 50)),
        beta restarted every iteration under ``cg_mode`` (the reference's
        ACG/steepest-descent variant), else every ``cg_reset_int`` (50).
        Between blocks only: the skin check and the rebin, the .eng line
        (temperature and pressure 0) and ``check_relaxed`` on the block's
        last energy and final sum F.F (``# relaxed at step N`` ends the
        phase); a rebin that overflows the cell capacity grows or
        re-grids the scene and bins it again (``_overflow_retry``).  One
        checkpoint at the end, when ``checkpt_int`` is set."""
        cfg = self.cfg
        R = cfg.relax
        steps = self._steps_to_run(steps)
        block = max(1, min(cfg.eng_int if cfg.eng_int > 0
                           else min(steps, 50), steps))
        restart_every = (1 if R.cg_mode else
                         cfg.cg_reset_int if cfg.cg_reset_int > 0 else 50)
        forces = self._force_fn()
        nactive = integrate.count_active_dof(self.scene)
        if cfg.eng_int > 0 and self.eng is None:
            self.eng = EngWriter(self._path(cfg.outfiles + ".eng"),
                                 append=cfg.simulation_phase > 1)
        timer, counters = self.timer, self.counters
        self.timers.start("total")
        self.relaxed_at = None
        scene = self.scene
        epot_prev = ep = None
        done = grow_tries = 0
        regrid_at = -1
        while done < steps:
            t0 = time.perf_counter()
            with self.timers.section("main"):
                scene, epots, fnorm = relax.cg_relax(
                    scene, forces, block, restart_every=restart_every)
                _sync(self.device)
            self.block_seconds.append((block, time.perf_counter() - t0))
            counters.steps += block
            with timer("skin"):
                do_it = bool(needs_rebin(scene, scene.grid.skin))
            counters.host_syncs += 1
            if do_it:
                with timer("rebin"):
                    moved = rebin(scene)
                # an overflow grows (or re-grids) the block's last scene
                # and bins it again; the block needs no rerun, its forces
                # were computed on the stale lists before the rebin
                while int(moved.overflow) > 0:
                    grown, grow_tries, regrid_at = self._overflow_retry(
                        scene, grow_tries, regrid_at, done, "rebin")
                    with timer("rebin"):
                        moved = rebin(grown)
                    forces = self._force_fn()
                scene = moved
                counters.rebins += 1
                self.nbl_count += 1
            done += block
            gstep = self.step_count + done
            ep = float(epots[-1])
            if cfg.eng_int > 0:
                self.eng.write(time=float(gstep) * cfg.timestep,
                               epot_per_atom=ep / max(n_atoms(scene), 1),
                               temperature=0.0, pressure=0.0,
                               volume=self._volume())
            z = torch.zeros_like(fnorm)
            stats = integrate.StepStats(tot_kin_energy=z, fnorm=fnorm,
                                        pnorm=z, pxf=z, ekin_new=z)
            if epot_prev is not None and bool(relax.check_relaxed(
                    stats, ep, epot_prev, nactive, R.fnorm_threshold, 0.0,
                    R.delta_epot_threshold)):
                print(f"# relaxed at step {gstep}", flush=True)
                self.relaxed_at = gstep
                break
            epot_prev = ep
        if ep is None:      # no iteration to run: the scene's own energy
            ep = float(scene.epot.sum(dtype=torch.float64))
        state = SimState(scene=scene, step=self.step_count + done,
                         epot_total=ep, ekin=0.0, virial=0.0,
                         presstens=np.zeros(6), rho=None)
        if cfg.checkpt_int > 0:
            self.write_checkpoint(state, state.step // cfg.checkpt_int)
        self.scene = scene
        self.step_count = state.step
        self.timers.stop("total")
        print(self.timers.report(n_atoms=max(n_atoms(scene), 1),
                                 n_steps=max(done, 1)), flush=True)
        return state

    def _fused_eligible(self) -> bool:
        """imd_tpu's _fused_eligible (simulation.py:1791-1848) as far as
        the port's settings reach: an EAM set under ``ensemble nve`` or
        ``ttm`` without an endtemp ramp.  Its other reasons to leave the
        fused loop are settings that UNPORTED refuses, and ``filter_int
        0``, which stays here with FILTER off (ROADMAP C6).  imd_tpu's
        capacity-32 engine rule is left out (ROADMAP C4)."""
        return self.eam_run is not None and not _general_step(self.cfg)

    def _filter_int(self) -> int:
        """FILTER's cadence; 0 (off) also for ``filter_int 0``, which
        enables FILTER but never fires (ROADMAP C6)."""
        f = self.cfg.filter
        return f.interval if f.enabled and f.interval > 0 else 0

    def _build(self, template: Scene, ttm_grid, step0: int,
               aux: tuple = (), fdi0: Optional[torch.Tensor] = None):
        """The fused step, its carry and the FILTER application (or None)
        for ``template`` (rebuilt after a capacity growth or a re-grid),
        the TTM step's carry (cl, grid, fdi, *aux, k) with ``aux`` the
        COLRAD or FDTD state and the virtual lattice's.  The stored FD
        index starts from ``fdi0`` (a restart's, in the Scene layout) in
        the cells-last layout when its shape is the template's, else at
        -1, as imd_tpu's does when the slot layout changes
        (simulation.py:2546-2555)."""
        cfg = self.cfg
        filt = (make_filter_apply(template, cfg.filter, self.cutoff)
                if self._filter_int() else None)
        if self.ensemble == "ttm":
            laser = cfg.laser if cfg.laser.sigma_e > 0 else None
            colrad = (None if self.colrad_tab is None else
                      (self.colrad_tab, self.colrad_step, self.colrad_phi))
            vlat = (None if self.vlat_params is None
                    else (self.vlat_params, self.vlat_state0))
            step, cl = make_fused_ttm_step(
                template, self.eam_run, cfg.timestep, self.ttm_params,
                self.eos, laser, nrb_state=self.nrb_state,
                tmm_params=self.tmm_params, vlat=vlat,
                elecpress=bool(cfg.ttm.elecpress), colrad=colrad,
                fdtd_params=self.fdtd_params, ntypes=cfg.ntypes,
                timer=self.timer, counters=self.counters)
            if fdi0 is not None and fdi0.shape == template.type.shape:
                fdi = _to_cl(fdi0.to(torch.int32),
                             template.grid.dims).reshape(-1).contiguous()
            else:
                fdi = torch.full((cl.mass.numel(),), -1, dtype=torch.int32,
                                 device=self.device)
            return step, (cl, ttm_grid, fdi, *aux, step0), filt
        step, cl = make_fused_step(template, self.eam_run, cfg.timestep,
                                   nrb_state=self.nrb_state,
                                   ntypes=cfg.ntypes, timer=self.timer,
                                   counters=self.counters)
        return (lambda c: (step(c)[0],)), (cl,), filt

    def _apply_filter(self, filt, carry):
        """FILTER on the carry at a block boundary (simulation.py:2825);
        the stored FD index travels with its atom."""
        self.n_filter += 1
        with self.timers.section("filter"):
            if len(carry) > 1:
                cl, fdi = filt(carry[0], carry[2])
                carry = (cl, carry[1], fdi, *carry[3:])
            else:
                carry = (filt(carry[0]),)
            _sync(self.device)
        return carry

    def observe(self, carry, template: Scene, gstep: int):
        """Observables of the carry's cells-last state with the B4 kernels
        (K4, K5; K8, K9 with ntypes > 1, simulation.py:2592): per-atom
        epot, host density, forces, virial and pressure tensor, plus the
        kinetic energy; sums in float64.  The state keeps the carry's TTM
        grid and the states of its physics."""
        self.n_observe += 1
        cl = carry[0]
        dims = template.grid.dims
        ttm = ({"ttm_grid": carry[1], **self._aux_states(carry),
                "fdi": _from_cl(carry[2].reshape(cl.alive.shape), dims)}
               if len(carry) > 1 else {})
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
            scene = cl_to_scene(cl, template).replace(
                force=_from_cl(F, dims), epot=_from_cl(epot, dims))
            vals = torch.cat([epot.double().sum()[None], ekin[None],
                              virial[None], presstens]).tolist()
            _sync(self.device)
        return SimState(scene=scene, step=gstep, epot_total=vals[0],
                        ekin=vals[1], virial=vals[2],
                        presstens=np.asarray(vals[3:]),
                        rho=_from_cl(rho, dims), **ttm)

    def run_fused(self, steps: Optional[int] = None) -> SimState:
        """The fused hot loop with periodic I/O (simulation.py:2463)."""
        cfg = self.cfg
        steps = self._steps_to_run(steps)
        ttm_on = self.ensemble == "ttm"
        filter_int = self._filter_int()
        sel = self._make_select()
        io_intervals = [i for i in (cfg.eng_int, cfg.checkpt_int,
                                    cfg.ttm_int) + self._output_intervals()
                        if i > 0] + (sel.intervals() if sel else [])
        specials = sel.special_steps() if sel else ()
        intervals = io_intervals + ([filter_int] if filter_int else [])
        block = _block_size(steps, intervals)
        template = self.scene
        grid0, aux0, fdi0 = None, (), None
        if ttm_on:
            t0 = time.perf_counter()
            grid0, aux0, fdi0 = self._initial_ttm_state()
            if cfg.restart_base:
                _sync(self.device)
                self.setup_parts["ttm_restore"] = time.perf_counter() - t0
        step, carry, filt = self._build(template, grid0, self.step_count,
                                        aux0, fdi0)
        self.timers.start("total")
        nactive = integrate.count_active_dof(self.scene)
        self._open_eng()
        if sel is not None:
            sel.init_refs(self.scene, self.step_count)
        done = 0
        state = None
        grow_tries = 0
        regrid_at = -1
        while done < steps:
            prev_carry = carry
            b = _clamp_block(min(block, steps - done),
                             self.step_count + done, intervals, specials)
            t0 = time.perf_counter()
            with self.timers.section("main"):
                for _ in range(b):
                    carry = step(*carry)
                _sync(self.device)
            if int(carry[0].overflow) > 0:
                sc_prev = cl_to_scene(prev_carry[0], template).replace(
                    overflow=torch.zeros_like(prev_carry[0].overflow))
                template, grow_tries, regrid_at = self._overflow_retry(
                    sc_prev, grow_tries, regrid_at, done)
                step, carry, filt = self._build(
                    template, prev_carry[1] if ttm_on else None,
                    self.step_count + done,
                    tuple(prev_carry[3:-1]) if ttm_on else ())
                continue
            self.block_seconds.append((b, time.perf_counter() - t0))
            done += b
            gstep = self.step_count + done
            control = self._control_files()
            if (any(_iv_due(gstep, i) for i in io_intervals)
                    or gstep in specials or any(control) or done >= steps):
                state = self.observe(carry, template, gstep)
                with self.timers.section("io"):
                    if _iv_due(gstep, cfg.eng_int):
                        self._write_eng(state, nactive)
                        if ttm_on:
                            self._write_laser_log(state, gstep)
                    if _iv_due(gstep, cfg.checkpt_int):
                        self.write_checkpoint(state,
                                              gstep // cfg.checkpt_int)
                    if ttm_on and _iv_due(gstep, cfg.ttm_int):
                        cs = state.cstate
                        write_ttm(self._path(
                            f"{cfg.outfiles}.{gstep // cfg.ttm_int}.ttm"),
                            state.ttm_grid,
                            colrad_c=None if cs is None else cs.c,
                            colrad_p=None if cs is None else cs.p)
                    self._write_outputs(state, gstep, sel)
                    if self._obey_control(state, gstep, *control):
                        break
            if filt is not None and done < steps \
                    and _iv_due(gstep, filter_int):
                # the next block starts from the filtered, rebinned state
                # (blocks end on multiples of filter_int)
                carry = self._apply_filter(filt, carry)
        if state is None:
            state = self.observe(carry, template, self.step_count + done)
        self.scene = state.scene
        self.step_count = state.step
        self.timers.stop("total")
        n = max(n_atoms(state.scene), 1)
        print(self.timers.report(n_atoms=n, n_steps=max(done, 1)),
              flush=True)
        return state

    def _control_files(self):
        """The graceful-stop machinery (check_stop/check_write/
        check_walltime, imd_main_3d.c:1938-1992): (a ``stop`` file, a
        ``write`` file, maxwalltime passed)."""
        cfg = self.cfg
        return (os.path.exists(self._path("stop")),
                os.path.exists(self._path("write")),
                cfg.maxwalltime > 0
                and time.time() - self.start_time > cfg.maxwalltime)

    def _obey_control(self, state: SimState, gstep: int, stop: bool,
                      force_write: bool, walltime_up: bool) -> bool:
        """A ``write`` file checkpoints now, a ``stop`` file or the
        walltime checkpoints and ends the run (True); the files are
        removed."""
        if force_write:
            os.remove(self._path("write"))
            self.write_checkpoint(state, gstep)
        if stop:
            os.remove(self._path("stop"))
        if stop or walltime_up:
            self.write_checkpoint(state, gstep)
            return True
        return False

    def _overflow_retry(self, sc_prev: Scene, grow_tries: int,
                        regrid_at: int, done: int, what: str = "block"):
        """A rebin of the last block overflowed the cell capacity: grow the
        slot axis of the pre-block scene ``sc_prev`` (alloc_cell,
        imd_alloc.c:551), or past ``REGRID_CAPACITY`` re-grid it, so that
        the caller retries ``what`` (the block; cg's rebin, from the
        block's last scene).  Returns (scene, grow_tries, regrid_at) and
        makes the scene the driver's."""
        grow_tries += 1
        if grow_tries > 6:
            raise RuntimeError(
                f"cell capacity overflow persists after {grow_tries - 1} "
                f"growths (capacity {self.grid.capacity})")
        old = self.grid.capacity
        new_cap = ((old + 8 + 7) // 8) * 8
        print(f"# cell overflow: growing capacity {old} -> {new_cap} and "
              f"retrying the {what}", flush=True)
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
        return template, grow_tries, regrid_at

    # -- the general step (pair potentials; EAM off the fused loop) -----
    def _ramp_temperature(self, step: int) -> float:
        """The thermostat's target at global ``step`` (simulation.py:
        1297-1302): from starttemp to endtemp over the ABSOLUTE step /
        maxsteps, as imd_tpu writes it, so a later phase's ramp starts
        part way (ROADMAP C8); else starttemp."""
        cfg = self.cfg
        if _ramped(cfg) and cfg.maxsteps > 0:
            frac = min(max(step / cfg.maxsteps, 0.0), 1.0)
            return cfg.starttemp + (cfg.endtemp - cfg.starttemp) * frac
        return max(cfg.starttemp, 0.0)

    def _force_fn(self):
        """The general step's force call (simulation.py:1022-1036): B6 for
        a pair potential, the 13 views and K12 for one species or K12-mt
        for 2-4 (each pair on its type pair's column, as imd_tpu's XLA
        engines evaluate it; its B6 would read column 0, ROADMAP C3); K4/K5
        for one EAM species, K8/K9 for 2-4."""
        timer, nt = self.timer, self.cfg.ntypes
        if self.pair_run is not None:
            pot = self.pair_run
            views = make_neighbor_views(self.grid, self.dtype, self.device)
            return lambda sc: compute_pair_forces_pallas(
                sc, pot, nt, timer=timer, views=views)
        eam = self.eam_run
        if nt > 1:
            return lambda sc: compute_eam_forces_pallas_mt(sc, eam, nt,
                                                           timer=timer)
        return lambda sc: compute_eam_forces_pallas(sc, eam, timer=timer)

    def make_step_fn(self):
        """The general step as imd_tpu's make_step_fn runs it without the
        TTM (simulation.py:1327-1371, 1495-1514): the skin check (one host
        read), the rebin when it fires, the forces, the ensemble's
        leapfrog: nve, nvt (eta carried), ber (the carried Ekin), mik, or
        glok (nve at FIRE's timestep, then fire_update).  Returns
        step(StepState) -> StepState."""
        cfg = self.cfg
        ens = self.ensemble
        base = integrate.IntegratorParams(
            timestep=cfg.timestep, isq_tau_eta=cfg.isq_tau_eta,
            tau_berendsen=cfg.tau_berendsen,
            viscous_friction=cfg.viscous_friction)
        nactive = integrate.count_active_dof(self.scene)
        timer, counters = self.timer, self.counters
        forces = self._force_fn()

        def step_fn(st: StepState) -> StepState:
            scene = st.scene
            with timer("skin"):
                do_it = bool(needs_rebin(scene, scene.grid.skin))
            counters.host_syncs += 1
            if do_it:
                with timer("rebin"):
                    scene = rebin(scene)
                counters.rebins += 1
            res = forces(scene)
            scene = scene.replace(force=res.force, epot=res.epot)
            params = dataclasses.replace(
                base, temperature=self._ramp_temperature(st.step))
            eta, fire = st.eta, st.fire
            with timer("integrate"):
                if ens == "glok":
                    scene, stats = integrate.nve(scene, dataclasses.replace(
                        params, timestep=fire.timestep))
                    scene, fire = relax.fire_update(scene, stats, fire,
                                                    self.fire_cfg, nactive)
                elif ens == "mik":
                    scene, stats = integrate.mik(scene, params)
                elif ens == "ber":
                    scene, stats = integrate.berendsen(
                        scene, params, nactive, st.stats.tot_kin_energy)
                elif ens == "nvt":
                    scene, stats, eta = integrate.nvt(scene, params,
                                                      nactive, eta)
                else:
                    scene, stats = integrate.nve(scene, params)
            counters.steps += 1
            return StepState(scene=scene, step=st.step + 1,
                             epot_total=res.epot.to(torch.float64).sum(),
                             virial=res.virial, presstens=res.presstens,
                             stats=stats, nbl_count=st.nbl_count + do_it,
                             eta=eta, fire=fire)

        return step_fn

    def init_state(self) -> StepState:
        """The general step's start (simulation.py:1670, no TTM): zero
        sums (so ber's first rescale reads Ekin 0), eta from the ``eta``
        tag (a ``-r`` restart too: the .itr holds none), FIRE afresh
        (simulation.py:1744-1747)."""
        z = torch.zeros((), dtype=torch.float64, device=self.device)
        fire = None
        if self.ensemble == "glok":
            fire = relax.fire_init(self.cfg.timestep, self.fire_cfg,
                                   self.dtype, self.device)
        return StepState(
            scene=self.scene, step=self.step_count, epot_total=z, virial=z,
            presstens=torch.zeros(6, dtype=torch.float64, device=self.device),
            stats=integrate.StepStats(tot_kin_energy=z, fnorm=z, pnorm=z,
                                      pxf=z, ekin_new=z),
            eta=torch.full((), self.cfg.eta, dtype=torch.float64,
                           device=self.device), fire=fire)

    def _sim_state(self, st: StepState) -> SimState:
        """The output record of a general-step carry: one host read."""
        vals = torch.cat([st.epot_total[None], st.stats.tot_kin_energy[None],
                          st.virial[None], st.eta.double()[None],
                          st.presstens]).tolist()
        return SimState(scene=st.scene, step=st.step, epot_total=vals[0],
                        ekin=vals[1], virial=vals[2],
                        presstens=np.asarray(vals[4:]), rho=None,
                        eta=vals[3])

    def _relax_check(self) -> bool:
        """GLOK and MIK stop at convergence when a threshold is set
        (simulation.py:2386-2400)."""
        R = self.cfg.relax
        return self.ensemble in ("glok", "mik") and (
            R.fnorm_threshold > 0 or R.ekin_threshold > 0
            or R.delta_epot_threshold > 0)

    def run_general(self, steps: Optional[int] = None) -> SimState:
        """The general loop with periodic I/O (simulation.py:2033-2461 as
        far as the port's ensembles without the TTM reach): blocks that end
        on the next output step, .eng from the step's sums, .chkpt/.itr,
        the interval outputs, ``check_relaxed`` at every block end under
        glok/mik (``# relaxed at step N`` ends the phase), the stop/write
        files and maxwalltime; a block whose rebin overflowed the capacity
        is retried from its start after ``_overflow_retry``.  Keeps FIRE's
        last state (``fire``) and the relaxed-at step (``relaxed_at``)."""
        cfg = self.cfg
        steps = self._steps_to_run(steps)
        sel = self._make_select()
        # ttm_int sets block ends here even without the TTM, as in
        # imd_tpu (simulation.py:2060-2064): check_relaxed runs there
        intervals = [i for i in (cfg.eng_int, cfg.checkpt_int, cfg.ttm_int)
                     + self._output_intervals()
                     if i > 0] + (sel.intervals() if sel else [])
        specials = sel.special_steps() if sel else ()
        block = _block_size(steps, intervals)
        step_fn = self.make_step_fn()
        st = self.init_state()
        self.timers.start("total")
        nactive = integrate.count_active_dof(self.scene)
        self._open_eng()
        if sel is not None:
            sel.init_refs(self.scene, self.step_count)
        relax_check = self._relax_check()
        R = cfg.relax
        epot_prev = None
        self.relaxed_at = None
        done = 0
        state = None
        grow_tries = 0
        regrid_at = -1
        while done < steps:
            prev = st
            b = _clamp_block(min(block, steps - done), st.step, intervals,
                             specials)
            t0 = time.perf_counter()
            with self.timers.section("main"):
                for _ in range(b):
                    st = step_fn(st)
                _sync(self.device)
            if int(st.scene.overflow) > 0:
                template, grow_tries, regrid_at = self._overflow_retry(
                    prev.scene, grow_tries, regrid_at, done)
                st = dataclasses.replace(prev, scene=template)
                step_fn = self.make_step_fn()
                continue
            self.block_seconds.append((b, time.perf_counter() - t0))
            done += b
            gstep = st.step
            control = self._control_files()
            if (any(_iv_due(gstep, i) for i in intervals)
                    or gstep in specials or any(control) or done >= steps):
                state = self._sim_state(st)
                with self.timers.section("io"):
                    if _iv_due(gstep, cfg.eng_int):
                        self._write_eng(state, nactive)
                    if _iv_due(gstep, cfg.checkpt_int):
                        self.write_checkpoint(state,
                                              gstep // cfg.checkpt_int)
                    self._write_outputs(state, gstep, sel)
            if relax_check:
                # quasistatic convergence (check_relaxed, main_3d.c:1787)
                ep_now = float(st.epot_total)
                if epot_prev is not None and bool(relax.check_relaxed(
                        st.stats, ep_now, epot_prev, nactive,
                        R.fnorm_threshold, R.ekin_threshold,
                        R.delta_epot_threshold)):
                    print(f"# relaxed at step {gstep}", flush=True)
                    self.relaxed_at = gstep
                    break
                epot_prev = ep_now
            if any(control) and self._obey_control(state, gstep, *control):
                break
        if state is None or state.step != st.step:
            state = self._sim_state(st)
        self.scene = state.scene
        self.step_count = state.step
        self.nbl_count = st.nbl_count
        self.fire = st.fire
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

    def _open_eng(self):
        """The .eng writer of the run (later phases append), with the
        Nose-Hoover column under nvt and the RELAXINFO columns when
        ``relaxinfo`` is set (simulation.py:2110-2114)."""
        cfg = self.cfg
        if cfg.eng_int > 0 and self.eng is None:
            self.eng = EngWriter(
                self._path(cfg.outfiles + ".eng"),
                nvt=(self.ensemble == "nvt"), ttm=cfg.ttm.enabled,
                extra_cols=(("delta_epot", "xnorm", "xmax")
                            if cfg.relaxinfo else ()),
                append=cfg.simulation_phase > 1)

    def _output_intervals(self) -> tuple:
        """The cadences of the interval outputs besides .eng, .chkpt and
        .ttm, which join the block-size rule (simulation.py:2478-2484)."""
        c = self.cfg
        return (c.dist_int, c.pic_int, c.force_int, c.press_int,
                c.nb_checkpt_int)

    def _make_select(self) -> Optional[SelectWriters]:
        """The selected-config observers (.avp/.dsp/.dem/.ef) when any is
        on, seeded with a checkpoint's DISLOC references."""
        self._sel = None
        if SelectWriters.wanted(self.cfg):
            self._sel = SelectWriters(self.cfg, self.box.h, self.box.pbc,
                                      self._path)
            if self._disloc_ref is not None:
                self._sel.preload_refs(*self._disloc_ref)
        return self._sel

    def _write_outputs(self, state: SimState, gstep: int, sel):
        """The interval outputs of imd_tpu's loops at ``gstep``
        (simulation.py:2776-2810): the .wf/.force/.stress/.nb writers, the
        .dist and .ppm snapshots and the selected-config observers (the
        ORDPAR column when one reads the epot).  Each writer's wall time
        goes to the timers as ``write_<suffix>``."""
        cfg = self.cfg
        self._write_periodic_extras(state, gstep)
        if _iv_due(gstep, cfg.dist_int):
            with self.timers.section("write_dist"):
                fields = compute_distrib(state.scene, cfg.dist_dim)
                names = [n for n, on in cfg.dist_flags.items()
                         if on and n in fields] or ["num", "Ekin", "Epot"]
                bh = np.abs(np.diag(np.asarray(self.box.h, np.float64)))
                write_distrib(
                    self._path(f"{cfg.outfiles}."
                               f"{gstep // cfg.dist_int}.dist"),
                    fields, names, cfg.dist_dim,
                    bh / np.asarray(cfg.dist_dim, np.float64),
                    mode="binary" if cfg.binary_output else "ascii")
        if _iv_due(gstep, cfg.pic_int):
            with self.timers.section("write_ppm"):
                write_picture(self._path(
                    f"{cfg.outfiles}.{gstep // cfg.pic_int}.ppm"),
                    state.scene)
        if sel is not None and (any(_iv_due(gstep, i)
                                    for i in sel.intervals())
                                or gstep in sel.special_steps()):
            with self.timers.section("write_select"):
                sel.step(self._with_ordpar(state.scene)
                         if sel.needs_epot(gstep) else state.scene, gstep)

    def _write_periodic_extras(self, state: SimState, gstep: int):
        """The `.wf` force dumps (WRITEF, imd_main_3d.c:436-440) with the
        potfit `.force` file, the per-atom `.stress` (STRESS_TENS,
        write_config_press, imd_io.c:1264; the stencil oracle on the
        potential's tables) and the `.nb` coordination-filtered configs
        (NNBR, imd_main_3d.c:750-752) (simulation.py:3216-3280)."""
        cfg = self.cfg
        wf_due = _iv_due(gstep, cfg.force_int)
        nb_due = _iv_due(gstep, cfg.nb_checkpt_int) and any(cfg.nb_rcut)
        press_due = _iv_due(gstep, cfg.press_int)
        if not (wf_due or nb_due or press_due):
            return
        fl = flat_host(state.scene)
        m = state.scene.mask.reshape(-1)
        h = np.asarray(self.box.h)
        if press_due:
            with self.timers.section("write_stress"):
                if self.eam is not None:
                    res = compute_eam_forces(state.scene, self.eam,
                                             ntypes=cfg.ntypes,
                                             per_atom_stress=True)
                else:
                    res = compute_pair_forces(state.scene, self.pair,
                                              ntypes=cfg.ntypes,
                                              per_atom_stress=True)
                pt = res.presstens_atom.reshape(-1, 6)[m].cpu().numpy()
                write_press(self._path(
                    f"{cfg.outfiles}.{gstep // cfg.press_int}.stress"),
                    fl, pt, h, self.box.pbc)
        if wf_due:
            with self.timers.section("write_wf"):
                write_wf(self._path(
                    f"{cfg.outfiles}.{gstep // cfg.force_int}.wf"),
                    fl, h, self.box.pbc, force_all=bool(cfg.force_all))
                if cfg.force_potfit:
                    n = max(len(fl["epot"]), 1)
                    write_force_potfit(self._path(
                        f"{cfg.outfiles}.{gstep // cfg.force_int}.force"),
                        fl, h, self.box.pbc, float(fl["epot"].sum()) / n,
                        presstens=np.asarray(state.presstens),
                        volume=self._volume())
        if nb_due:
            with self.timers.section("write_nb"):
                nb = compute_nbanz(state.scene, self._nb_rcut_table(),
                                   cfg.ntypes).reshape(-1)[m].cpu().numpy()
                write_nb(self._path(
                    f"{cfg.outfiles}.{gstep // cfg.nb_checkpt_int}.nb"),
                    fl, nb, h, self.box.pbc,
                    [int(v) for v in cfg.nb_cut_lower],
                    [int(v) for v in cfg.nb_cut_upper],
                    cfg.pic_ll, cfg.pic_ur)

    def _nb_rcut_table(self):
        """nb_rcut padded or clipped to [ntypes * ntypes]
        (imd_param.c:663)."""
        nn = self.cfg.ntypes * self.cfg.ntypes
        rc = list(self.cfg.nb_rcut)
        return (rc + [rc[-1] if rc else 0.0] * nn)[:nn]

    def _ordpar_active(self) -> bool:
        return bool(self.cfg.op_weight)

    def _with_ordpar(self, scene: Scene) -> Scene:
        """ORDPAR: the configuration outputs carry the weighted short-range
        order parameter in the Epot column (imd_io.c:3283; the reference
        computes it in every force call, imd_forces.c:195-198, here at the
        I/O steps; the .eng's total is unchanged)."""
        if not self._ordpar_active():
            return scene
        pot = self.pair if self.pair is not None else self.eam.pair
        nt = max(int(self.cfg.ntypes), 1)
        nn = nt * nt
        w = (list(self.cfg.op_weight) + [0.0] * nn)[:nn]
        rc = list(self.cfg.op_rcut) or [self.cutoff] * nn
        rc = (rc + [rc[-1]] * nn)[:nn]
        return scene.replace(epot=compute_ordpar(scene, pot, rc, w,
                                                 ntypes=nt))

    def _write_eng(self, state: SimState, nactive: float):
        """One .eng line (simulation.py:2960): the epot of the force call
        at the start of the last step, labelled (step-1)*dt; with
        ``relaxinfo`` the RELAXINFO columns (imd_io.c:2454-2457):
        |delta Epot| since the last line, sqrt(xnorm / nactive) and
        sqrt(x_max2) with the last step's displacement dt p / m."""
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
        extra = []
        if self.cfg.relaxinfo:
            ep_a = state.epot_total / n
            extra.append(ep_a - getattr(self, "_old_epot_eng", ep_a))
            self._old_epot_eng = ep_a
            fl = flat_host(state.scene)
            dx = self.cfg.timestep * fl["mom"] / fl["mass"][:, None]
            extra.append(float(np.sqrt((dx * dx).sum()
                                       / max(nactive, 1.0))))
            extra.append(float(np.sqrt((dx * dx).max(initial=0.0))))
        self.eng.write(
            time=float(state.step - 1) * self.cfg.timestep,
            epot_per_atom=state.epot_total / n,
            temperature=2.0 * state.ekin / max(nactive, 1.0),
            pressure=(2.0 * state.ekin + state.virial) / (3.0 * vol),
            volume=vol,
            eta=(state.eta * self.cfg.tau_eta if self.ensemble == "nvt"
                 else None), ttm_eng=ttm_eng, extra=extra)

    def _write_laser_log(self, state: SimState, gstep: int):
        """The .laser log line (simulation.py:3182; the reference's
        per-step printf, imd_ttm.c:150-155): step, time, intensity I_t,
        absorbed fluence (grid.eabs over the y*z area, eV -> J/m^2) and
        reflectivity, with the TMM solver also laser_active.  I_t, refl
        and laser_active come from a diagnostic do_tmm on the current
        grid; without the TMM they are NaN and the column is left out."""
        cfg = self.cfg
        g = state.ttm_grid
        t_si = gstep * float(cfg.timestep) * units.TIME_UNIT_S
        it = refl = float("nan")
        active = ""
        if self.tmm_params is not None:
            _, diag = do_tmm(g, self.ttm_params, self.tmm_params,
                             torch.tensor(t_si, dtype=g.temp.dtype,
                                          device=g.temp.device))
            it, refl, on = torch.stack([
                diag["I_t"], diag["refl"],
                diag["laser_active"].to(diag["refl"].dtype)]).tolist()
            active = f" {int(on)}"
        hts = self.box.heights()
        area = float(hts[1] * hts[2]) * 1e-20          # A^2 -> m^2
        eabs = float(g.eabs) * units.EV_TO_J / max(area, 1e-300)
        path = self._path(cfg.outfiles + ".laser")
        header = not os.path.exists(path)
        with open(path, "a") as f:
            if header:
                f.write("# step t_fs I_t_Wm2 Eabs_Jm2 refl"
                        + (" laser_active" if active else "") + "\n")
            f.write(f"{gstep} {t_si * 1e15:.4f} {it:.6e} {eabs:.6e} "
                    f"{refl:.6e}{active}\n")

    def _chkpt_data(self, state: SimState) -> ChkptData:
        """Checkpoint record with the reference's extra columns in its
        order (simulation.py:3044; write_header_config, imd_io.c:3266-3336):
        number type mass x y z vx vy vz, Epot (the order parameter
        ``ordpar`` with ORDPAR), ``n_nbr`` with nb_rcut, the DISLOC
        references x_ref y_ref z_ref Epot_ref of the .dsp/.dem observers,
        and the host density eam_rho unless ``norhoh`` (the observe()'s,
        where imd_tpu recomputes it from the tables)."""
        cfg = self.cfg
        scene = self._with_ordpar(state.scene)
        flat = {k: v.detach().cpu().numpy()
                for k, v in flatten_atoms(scene).items()}
        m = flat["mask"]
        mass = flat["mass"][m]
        pos = flat["pos"][m]
        epot = flat["epot"][m]
        columns = "number type mass x y z vx vy vz Epot".split()
        data = epot[:, None]
        if any(cfg.nb_rcut):
            nb = compute_nbanz(state.scene, self._nb_rcut_table(),
                               cfg.ntypes).reshape(-1).cpu().numpy()[m]
            data = np.concatenate([data, nb[:, None]], axis=1)
            columns.append("n_nbr")
        sel = getattr(self, "_sel", None)
        if sel is not None and (sel.ort_ref is not None
                                or sel.epot_ref is not None):
            # ids without a captured reference keep their current state
            ids = flat["id"][m].astype(int)
            n = ids.max() + 1 if len(ids) else 0
            oref = sel._ensure(sel.ort_ref, n, 3, fill=np.nan)[ids]
            miss = np.isnan(oref[:, 0])
            oref[miss] = pos[miss]
            eref = sel._ensure(sel.epot_ref, n, fill=np.nan)[ids]
            eref[np.isnan(eref)] = epot[np.isnan(eref)]
            data = np.concatenate([data, oref, eref[:, None]], axis=1)
            columns += "x_ref y_ref z_ref Epot_ref".split()
        rho = state.rho
        if rho is None and self.eam is not None and not cfg.norhoh:
            # the general step keeps no density: K4 (K8) on the state, as
            # imd_tpu recomputes it (simulation.py:3083-3091)
            xi, typ, alive = cl_inputs(state.scene)
            if cfg.ntypes > 1:
                rho = eam_rho_e_mt(xi, typ, self.eam_run, state.scene.grid,
                                   cfg.ntypes)[0]
            else:
                rho = eam_rho_e(xi, alive, self.eam_run,
                                state.scene.grid)[0]
            rho = _from_cl(rho, state.scene.grid.dims)
        if rho is not None and not cfg.norhoh:
            rho = rho.reshape(-1).detach().cpu().numpy()[m]
            data = np.concatenate([data, rho[:, None]], axis=1)
            columns.append("eam_rho")
        if self._ordpar_active():
            columns = ["ordpar" if c == "Epot" else c for c in columns]
        h = np.asarray(self.box.h)
        return ChkptData(number=flat["id"][m], type=flat["vtype"][m],
                         mass=mass, pos=pos,
                         vel=flat["mom"][m] / mass[:, None], data=data,
                         columns=columns, box_x=h[0], box_y=h[1],
                         box_z=h[2])

    def write_checkpoint(self, state: SimState, fzhlr: int):
        """<outfiles>.<fzhlr:05d>.{chkpt,itr[,ttm,ttmaux.npz][,nrb]};
        fzhlr -1 names the end-of-run "-final" set (imd_io_3d.c:995).  The
        .ttm carries the COLRAD columns and the virtual lattice's rows, the
        .ttmaux.npz sidecar the rest of the TTM's restart state
        (simulation.py:3141-3151), the FD index keyed by atom id."""
        cfg = self.cfg
        d = self._chkpt_data(state)
        base = self._path(cfg.outfiles + "-final" if fzhlr == -1
                          else f"{cfg.outfiles}.{fzhlr:05d}")
        write_chkpt(base + ".chkpt", d, binary=bool(cfg.binary_output),
                    double=bool(cfg.hpo), precision=17 if cfg.hpo else 12)
        write_itr(base + ".itr", checkpoint=fzhlr, startstep=state.step + 1,
                  box_x=d.box_x, box_y=d.box_y, box_z=d.box_z)
        if cfg.ttm.enabled and state.ttm_grid is not None:
            cs = state.cstate
            write_ttm(base + ".ttm", state.ttm_grid,
                      colrad_c=None if cs is None else cs.c,
                      colrad_p=None if cs is None else cs.p,
                      vlat=state.vstate)
            ttm_io.write_ttm_aux(base + ".ttmaux.npz", fdtd=state.fdtd,
                                 vlat=state.vstate, grid=state.ttm_grid,
                                 fdi=state.fdi, ids=state.scene.id,
                                 alive=state.scene.mask)
        if self.nrb_state is not None:
            nrb_mod.write_nrb(base + ".nrb", self.nrb_state)
