"""Run the port's main paths on one CUDA card and check its kernels.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels are built for sm_90a with nvcc)
and no JAX.  Phases, each of which fails the run loudly:

1. build the CUDA kernels of imd_tpu_torch/csrc into imd_tpu_torch/_build
   (one nvcc per source in parallel; printing nvcc's time and ptxas'
   registers, shared memory, spills per kernel; any spill of the eight
   full-stencil instantiations or of K10-K12 fails the run);
2. build the flagship configuration (imd_tpu_torch/flagship.py: bench.py's
   default TTM-coupled fcc Al EAM run, 1,000,188 atoms, float32), and its
   two-species twin (``ntypes=2``: types index % 2, tiled tables);
3. hold each kernel against its plain torch version at the main paths'
   shapes: K1 eam_rho and K2 eam_force, K4 eam_rho_e and K5 eam_force_s
   (the .eng observables, B4) on a jittered copy of the state and on the
   CPU tests' (3,2,2) grid (nn equal in all but 1e-5 of live slots, those
   holding a pair within an ulp of the cutoff; on the others rho and epot
   to 1e-5 and F to 1e-4 of their maxima, virial and pressure tensor to
   1e-4 relative beside the fit's jump at the flipped pairs; sum of forces
   ~0); the alloy kernels K6 eam_rho_mt, K7 eam_force_mt, K8 eam_rho_e_mt
   and K9 eam_force_s_mt the same way, to the same tolerances, on the
   jittered state with two species and genuinely different table columns
   (densities that depend on source and host) and on the (3,2,2) grid with
   four; K6/K7 with tiled (identical) columns against K1/K2 on the same
   state; K1/K2/K4/K5 and K6-K9 (two species) in a capacity sweep at cap
   17, 24, 31, 40 and the limit 128 (17 and 31 with padding lanes in the
   block's last warp) on a 3 x 4 x 11 grid with an open x face,
   every slot live and one cell squeezed so that its lists fill, to the
   same tolerances, and every one of the eight wrappers must raise
   ValueError at cap 129 before launching; each of K1/K2/K4/K5/K6-K9 gives
   the same bits twice; K3 compact exactly, through a whole migration
   rebin of a jittered copy against the same rebin on the CPU; the force
   kernels against the all-pairs float64 oracle on a small input, with
   one and with two species; and time each kernel beside its plain
   version;
4. drive the flagship main path from a warmed start (0.3 eV, so that the
   skin check fires and the rebin runs): 3 warm-up steps, then 3 x 20
   timed steps, with the launch counters set to 0 just before and read
   just after; every kernel of the step must have launched, the run must
   have rebinned, overflow must be 0, T_e finite, and the atom count and
   id set conserved.  Then the alloy main path the same way
   (``flagship.build(ntypes=2)``): K6 and K7 must launch once per step, K1
   and K2 not at all, K3 in its rebins, and every id must keep its type;
5. time bench.py's configuration as is (0.026 eV start) the same way;
6. drive the param-file driver, ``python -m imd_tpu_torch`` in process
   (``imd_tpu_torch.__main__.main``), on the 1,024,000-atom ablation
   geometry of examples/ablation/run1m (its start.chkpt and EAM tables, the
   open x axis, the TTM on 256 cells, the Lambert-Beer laser of the
   flagship in place of its TMM laser) for 20 steps with .eng every 10 and
   one checkpoint, launch counters set to 0 just before: K4 and K5 must
   launch once per observe() call (2), K1 and K2 every step, every .eng
   value must be finite, the atom count and id set conserved, and the
   checkpoint and .itr written.  K3 runs there only when the skin check
   fires, so phase 4 is the one that requires its launches.  Then the same
   film as a two-species run (``ntypes 2``: types by id parity in a
   rewritten start.chkpt, the tables tiled to 2x2 / 2 columns and written
   as files): K8 and K9 must launch once per observe(), K6 and K7 every
   step, K1/K2/K4/K5 not at all, and its .eng must equal the one-species
   run's at the same steps to 1e-5 relative per column (identical physics
   through other kernels).  Then K1, K2, K4 and K5 are held against their
   plain versions, as in phase 3, at the driver's shapes: on its last
   state (grid 446 x 24 x 24, cap 24, open x, the run1m tables), and on
   that state rolled along x so that the open face cuts the film (the
   kernels must skip the cells across it); and K6-K9 on the two-species
   run's last state with the run1m tables scaled per column.

Phase 3 also holds the rolled-view split (B7): K10 eam_rho_half and K11
eam_force_half, assembled, against their plain versions (the same
flip-aware tolerances) and against K1/K2 (flips and rho to 1e-4, F to 5e-4
of max: K1/K2 evaluate each pair from both sides, see ``check_half``) on
the jittered flagship state and on the (3,2,2) grid with an open x face,
and checks that two launches give the same bits; and B8:
``compute_eam_forces_pallas2`` on the flagship Scene with the jittered
positions equals ``compute_eam_forces_pallas`` (K4/K5), which are held
against their plain versions on that state.  Phase 4 then runs the
warmed main path twice more, with ``engine="split"`` (K10/K11 once per
step, K1/K2 never) and ``engine="ab"`` (K4/K5 once per step), after
holding each engine's forces on the start state against the ``"win"``
engine's.

Phase 3 also holds B6's K12 pair_half (csrc/eam_half.cu), assembled,
against its plain version (no cutoff flips; e to 1e-5, F and the stress
sums to 1e-4 of their maxima; the same bits twice) on phase 7's state with
0.1 A of jitter (grid 42^3, cap 16; and with 8 dead slots more a cell,
cap 24, as most of phase 7's launches run) and on the (3,2,2) grid with an
open x face, and B6's masked result (``compute_pair_forces_pallas``) against the
all-pairs float64 oracle on the small input.  K10, K11 and K12 then run a
capacity sweep of their own (cap 17, 24, 31, 32, 40 and 128, each with the
launch shape of ``forces_win.half_tile``; 17 and 31 leave padding
lanes) on the 3 x 4 x 11 grid with its open x face, a quarter of the slots
dead, one cell empty and one squeezed so that its lists fill: K10 against
its plain version on live slots with ``check_half``'s tolerances (the count
within the cutoff, and within 0.9 of it, where its j side recomputes r^2),
K11 to 1e-4 of max|F| against its plain version, K12 through the same
checks as above, all three the same bits twice; and the three wrappers
must raise ValueError at cap 129 before launching.  Phase 7 drives the general
pair step through the driver: ``python -m imd_tpu_torch`` in process on
examples/melt_quench's LJ (eps 0.35, sigma 2.62, r_cut 5.0) on the
flagship's fcc box of 63^3 cells (1,000,188 atoms), ensemble nve from 0.2
eV, 3 warm-up steps and 3 timed blocks of 20, launch counters set to 0
just before: K12 must launch once per step and no other kernel, the skin
check must have rebinned, no atom may be lost, the total energy per atom
over the timed .eng lines must spread less than twice the float64 run of
the same file on 16^3 cells (CPU, plain versions), and K12 must match its
plain version on the last state (the grid grown to cap 32), give the same
bits twice there, and is timed there beside its plain version and its
bound; the phase counts K12's launches by capacity.

Phase 8 runs examples/ablation/run1m/ablation_1m.imd as written (the TMM
laser at 800 nm and 2e17 W/m^2, NRB, FILTER, ``ttm_solver implicit`` with
10 substeps, 256 TTM cells, capacity 24) through ``cli.main`` in float32,
on a copy that differs only in maxsteps/startstep (20 steps from step 285,
across the pulse's peak at step ~295), eng_int 10, checkpt_int 20 and
filter_int 10, and whose start.chkpt holds 16 more atoms with new ids,
isolated in the front vacuum (x < 600 A), launch counters set to 0 just
before: rc 0, finite .eng and .laser, .chkpt/.itr/.nrb/.ttm written, K1/K2
once a step, K4/K5 once per observe(), K3 three per rebin and nothing else;
FILTER deletes exactly the 16 atoms; NRB holds the start file's layer
within alat/4 of the film's x-max, each atom with its 4 inward neighbours,
and the step reads the host as often as the same file without nrb_* (run
for 2 steps); the implicit solver runs 10 substeps a step with no CFL
read; on the last TTM grid the TMM solve in float32 (complex64) equals the
float64 one (refl/trans/absorb to 1e-5, the source to 1e-4 of its
maximum), its absorbed flux is below I_t and within 5e-3 of (1 - R - T)
I_t, tests/test_tmm.py's 320-cell thick film meets the same flux checks
in float32, and .laser's absorbed fluence rises; then K1/K2/K4/K5 are
held against their plain versions on the run's last state.

Phase 9 runs phase 8's file and start (20 -> 10 steps from step 285) with
``vlatdim 1000``, ``elecpress 1``, ``colrad`` and ``colrad_mpi 1`` added
(the closed-form rate fits: no state tables on disk) through ``cli.main``
in float32, launch counters set to 0 just before: rc 0, K1/K2 once a step,
K4/K5 once per observe(), K3 three per rebin and nothing else, a finite
state, the -final.ttm with 17 populations, 5 power columns and 1000
virtual rows; on the last state one calc_ttm, one COLRAD step (its tries
and host reads), one vlat_substep and the ELECPRESS force are timed, the
COLRAD step in float32 is held against float64 on the same grid, each
active cell's populations keep their sum through the step and sum to its
n_tot (1e-4), and
K1/K2/K4/K5 are held against their plain versions.  Phase 10 runs
run1m's file with ``fdtd`` in place of ``tmm`` for 4 steps from step 0
of start.chkpt (the envelope at 1.1% of E0): 649 Maxwell steps a step
with the explicit diffusion substeps the CFL count asks for, two host
reads a step (skin check, CFL count), .laser with I_t and refl NaN and a
positive absorbed fluence, finite fields; on the last state step_1d and
one diffusion substep are timed and 649 Maxwell steps in float32 are held
against float64 (E field and source as shares of their maxima).

Phase 11 resumes them: phase 9 writes its checkpoint set at step 290 and
phase 10 at step 2 (.chkpt, .itr, .nrb, .ttm, .ttmaux.npz; only the
cadence changes), and ``cli.main([... "-r", "1"])`` in float32 runs each
file again with ``do_maxwell 0`` from its set to its phase's last step,
launch counters set to 0 just before: the restored grid fields, virtual
lattice, FDTD fields and per-atom FD index (by id) must equal what the
straight run wrote, bit for bit, the COLRAD populations within the .ttm's
%e digits; K1/K2 once a step, K4/K5 once per observe(), K3 three per
rebin, nothing else; a finite state; T_e, T_i, the populations, the FDTD
fields and the positions against the straight run's at the same step
within RESTART_TOL (its comment justifies each).  The resumed phase 9 run
also writes .dist, .ppm, .wf, .stress and .nb at step 295 (the writers'
times printed); the per-atom stress on the degree-12 fit sums to K5's
pressure tensor of that step (STRESS_TOL of its largest component).  Then the
tabulated EOS: EOS_cve_from_r_te.txt and EOS_ee_from_r_tesqrt.txt written
from the port's FEGEos in the reference's nn format, 2 steps of phase 8's
file with ``eos_dir`` on them (launches as phase 8's, a finite state),
te_from_u(u_from_te(T)) within the bisection's resolution, one calc_ttm
with the tables against the FEG function they sample within 10 x their
interpolation error, and one calc_ttm with each EOS timed.

Phase 12 runs the general step's ensembles through ``cli.main``, launch
counts set to 0 just before each file: examples/melt_quench as written
but on the flagship's 63^3 fcc cells (1,000,188 atoms), its phases
ending at steps 60 / 120 / 200 and .eng every 20 (MQ_TAGS): nvt, ber
with the endtemp ramp, glok.  K12 must launch once per step run and no
other kernel, no atom may be lost, the .eng must hold the eta*tau_eta
column with non-zero values in phase 1, each ber block's ramp target
(printed) must be the reference's formula over the absolute step, and
FIRE's state must be consistent with its uphill count (printed): a
timestep moved after an uphill event, else 0.1 with MIX decayed once a
step.  A 10^3-cell copy from one .chkpt start runs in float32 on the
card and in float64 on the host (the kernels take float32 only); their
.eng lines must agree within MQ_LIMITS, one set per line (its comment
gives the reasons and the readings of planted faults).
Then the flagship's fcc Al 63^3 with the analytic EAM: nvt at 0.026 eV
for 40 steps on the general step (K4/K5 once a step, nothing else), nve
for 10 more back on the fused loop (K1/K2 once a step, K4/K5 once an
observe), and the L1_2 lattice as two species with SCALES2's columns
under ber for 20 steps (K8/K9 once a step); K1/K2/K4/K5 are held against
their plain versions on the nvt phase's last state and K6-K9 on the
two-species run's.

Phase 13 runs multi-species pairs and ``ensemble cg`` through ``cli.main``,
launch counts set to 0 just before each file: examples/binary_lj (the
binary Lennard-Jones with the Kob-Andersen ratios on the L1_2 lattice at
3.705 A) on the flagship's 63^3 cells (1,000,188 atoms), its phases ending
at steps 60 / 120 / 200 and .eng every 20 (BIN_TAGS): nvt, ber with the
endtemp ramp, cg (80 iterations).  K12-mt (``pair_half_mt``) must launch
once per step, twice per cg iteration and twice more per cg block, and no
other kernel (the single-species K12 not at all); no atom may be lost and
each keeps its type; the cg lines of the .eng have temperature and
pressure 0 and an energy that falls from block to block.  K12-mt is held
against its plain version on the run's last state (``k12mt_check``: no
cutoff flip, F and the stress sums to 1e-4 and e to 1e-5 of their maxima,
the pressure tensor to 1e-4; the same bits twice) and timed there.  A
10^3-cell copy from one .chkpt start runs in float32 on the card and in
float64 on the host; their .eng lines must agree within BIN_LIMITS, one
set per line (its comment gives the readings of planted faults).  Then
``ensemble cg`` on the flagship's fcc Al 63^3 with the analytic EAM,
displaced by 0.05 A from a seed, for 40 iterations: K4/K5 twice an
iteration and twice a block, nothing else, and the energy at every
iteration (recorded from the driver's ``relax.cg_relax`` calls) must fall,
within the float32 rounding of the summed energy (``run_eam_cg``).

Prints one JSON line each for the four main paths (one and two species,
"split", "ab"), the bench configuration, the two driver runs, the LJ
driver run, the ablation run, phases 9 and 10, the two restarts, the
EOS run, the general step's ensembles and phase 13's runs (atom-steps/s,
ms per step, CUDA-event
phase times with calc_ttm and nrb, calc_ttm by part and its CUDA kernels
under torch.profiler, ms per FILTER application, the set-up seconds of
init_nrb and the TMM tables, peak memory, launches), one
{"kernels": [...]} line (with each kernel's bound: the larger of its FLOPs
over the float32 peak and its bytes over the memory rate, counted from
this run's inputs, and its share, bound / ms; the half-stencil passes'
bytes from their live slots and view entries, since a dead slot's outputs
are unspecified; ptxas' registers, spill bytes and static shared memory;
for the full-stencil rows and K10-K12 the launch tile and its dynamic
shared memory at the table's shapes; K12's row also its launches by
capacity and its time at cap 24 and on phase 7's last state; the rows
of K1-K5 also their launches in phases 8, 9, 10 and 11, and those of
K1, K2, K4, K5, K8, K9 and K12 in phase 12, K4 and K5 in phase 13's EAM
cg; K12-mt's row its time and bound on phase 13's last state; B8's
rows carry K4/K5's times), the card's name and power limit, and last
{"ok": true, "device": {...}}.
Exits non-zero, printing no result, without a CUDA device.
"""

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
RUN1M = REPO / "examples" / "ablation" / "run1m"

# H100 SXM peaks (NVIDIA's data sheet): float32 outside the tensor cores,
# and the HBM3 rate
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# FLOPs per in-cutoff pair, each pair counted once: the distance (8), a
# degree-d value Horner with its window transform (2d + 2), a derivative
# Horner (2(d-1) + 2), the sums into both atoms
DEG = 12
_DIST, _HV, _HG = 8, 2 * DEG + 2, 2 * (DEG - 1) + 2
FLOPS_PER_PAIR = {
    "eam_rho": _DIST + _HV + 2 + 2,                  # rho, nn
    "eam_rho_e": _DIST + 2 * _HV + 2 + 2 + 3,        # + 1/2 phi
    "eam_force": _DIST + 2 * _HG + 3 + 6 + 3,        # grad, F_i, F_j
    "eam_force_s": _DIST + 2 * _HG + 3 + 6 + 3 + 18,  # + 6 stress terms
    # the alloy kernels: one column per table and pair; the gradient is
    # phi' + dF_i rho'(j->i) + dF_j rho'(i->j) (4 operations to combine)
    "eam_rho_mt": _DIST + _HV + 2 + 2,
    "eam_rho_e_mt": _DIST + 2 * _HV + 2 + 2 + 3,
    "eam_force_mt": _DIST + 2 * _HG + 4 + 6 + 3,
    "eam_force_s_mt": _DIST + 2 * _HG + 4 + 6 + 3 + 18,
    # the rolled-view split does the same work per pair, each pair once
    "eam_rho_half": _DIST + _HV + 2 + 2,
    "eam_force_half": _DIST + 2 * _HG + 3 + 6 + 3,
    # B6's K12: phi and its derivative, g d (3), the i and j force sums
    # with the j side's differences (3 + 6), six stress products and sums,
    # the two energy sums
    "pair_half": _DIST + _HV + _HG + 3 + 3 + 6 + 12 + 2,
    # K12-mt: K12 and the row index t_i * nt + t_j
    "pair_half_mt": _DIST + _HV + _HG + 3 + 3 + 6 + 12 + 2 + 2,
}
# a pair of unlike types reads two different density columns (source j at
# host i, source i at host j): one more density Horner than a like pair
FLOPS_PER_UNLIKE_PAIR = {"eam_rho_mt": _HV, "eam_rho_e_mt": _HV,
                         "eam_force_mt": _HG, "eam_force_s_mt": _HG}
MT_OF = {"eam_rho": "eam_rho_mt", "eam_force": "eam_force_mt",
         "eam_rho_e": "eam_rho_e_mt", "eam_force_s": "eam_force_s_mt"}

# column scales (pair [nt^2], rho [nt^2] source-first, embed [nt]) that
# make the type-pair columns genuinely different: symmetric pair tables,
# densities that depend on source and host
SCALES2 = ([1.0, 0.8, 0.8, 0.6], [1.0, 0.9, 0.7, 0.5], [1.0, 0.75])
SCALES4 = ([1.0 - 0.08 * (a + b) for a in range(4) for b in range(4)],
           [1.0 - 0.1 * s - 0.03 * h for s in range(4) for h in range(4)],
           [1.0, 0.75, 0.9, 0.85])


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, reps):
    """Mean ms of ``reps`` calls of ``fn`` after one warm-up (CUDA
    events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def profiled(fn) -> dict:
    """One call of ``fn`` under torch.profiler after a warm-up: the CUDA
    kernels it launches, their summed device time, the call's time (CUDA
    events) and whence the device's idle share in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(getattr(e, "self_device_time_total", 0) for e in kern) / 1e3
    ms = a.elapsed_time(b)
    return {"kernels": sum(e.count for e in kern), "device_ms": dev_ms,
            "ms": ms, "idle_share": 1.0 - dev_ms / ms if dev_ms > 0 else None}


def half_shape(cap: int, kind: str) -> dict:
    """K10-K12's launch shape at ``cap`` (forces_win.half_tile)."""
    from imd_tpu_torch.ops import forces_win as win
    t = win.half_tile(cap, kind)
    return {"cells": t.cpb, "threads": t.threads,
            "smem_dynamic_bytes": t.smem}


def roofline(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the FLOPs over
    the float32 peak and the bytes over the memory rate."""
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


# bytes a half-stencil pass moves for each live slot of xi, for each live
# entry of its 13 views, and the j-partial bytes of an entry in an invalid
# cell: the position and K11's dF in; the i-sums of a slot and the
# j-partials of an entry out (K10: rho, nn; K11: fx, fy, fz; K12 as the
# general step calls it: fx, fy, fz, e and, on the i side, the six stress
# sums; K12-mt as K12 with the type of each slot in: typ [cap, NC] is its
# one type input, read once a slot, since the kernel gathers a view entry's
# type from typ at the neighbour cell and no type views exist)
HALF_BYTES = {"eam_rho_half": (12 + 2 * 4, 12 + 2 * 4, 2 * 4),
              "eam_force_half": (12 + 4 + 3 * 4, 12 + 4 + 3 * 4, 3 * 4),
              "pair_half": (12 + 4 * 4 + 6 * 4, 12 + 4 * 4, 4 * 4),
              "pair_half_mt": (12 + 4 + 4 * 4 + 6 * 4, 12 + 4 * 4, 4 * 4)}


def half_bytes(name: str, xi, nbr) -> int:
    """Bytes the half-stencil pass ``name`` must move on these inputs:
    HALF_BYTES for each live slot of ``xi`` and each live entry of the
    views ``nbr``.  A dead slot or entry (at SENTINEL_DEAD) costs the x
    that tells it dead, and nothing more: its outputs are unspecified.  An
    entry of an invalid cell (at SENTINEL_CELL, across an open face) costs
    its x and its j-partials, which _assemble adds to the cell the roll
    wraps to, so they must be written (as zeros)."""
    from imd_tpu_torch.ops.forces_pallas import SENTINEL_CELL
    from imd_tpu_torch.ops.forces_win import SENTINEL_DEAD
    i_b, j_b, j_out = HALF_BYTES[name]
    x, xv = xi[:, 0], nbr[:, :, 0]
    li = int((x < SENTINEL_DEAD / 2).sum())
    lj = int((xv < SENTINEL_DEAD / 2).sum())
    inv = int((xv >= (SENTINEL_DEAD + SENTINEL_CELL) / 2).sum())
    return (i_b * li + j_b * lj + j_out * inv
            + 4 * (x.numel() + xv.numel() - li - lj))


# Maxwell start of the counted main-path run: at bench.py's 0.026 eV no
# atom moves more than ~0.03 A, so the skin check (0.25 A) never fires and
# the rebin (K3) never runs; from 0.3 eV it fires every few steps
WARM_EV = 0.3


def timed_run(fs, timer) -> dict:
    """3 warm-up steps, then 3 x 20 timed steps, each block synchronized;
    CUDA-event phase times and step counters of the timed steps."""
    import torch
    c0 = dataclasses.asdict(fs.counters)
    warm = fs.run(3)
    timer.reset()
    c1 = dataclasses.asdict(fs.counters)
    walls = [fs.run(20) for _ in range(3)]
    phases = timer.totals_ms()
    c2 = dataclasses.asdict(fs.counters)
    med = statistics.median(walls)
    tg = fs.carry[1]
    active = tg.natoms >= fs.tp.fd_min_atoms
    return {
        "config": "fcc Al EAM + 1-D TTM (FEG EOS, Lambert-Beer laser), "
                  "float32, fused cells-last step",
        "atoms": fs.n_atoms, "grid": list(fs.grid.dims),
        "capacity": fs.grid.capacity, "fd_nx": fs.tp.nx,
        "atom_steps_per_s": fs.n_atoms * 20 / med,
        "walls_s": walls, "warmup_s": warm,
        "spread_pct": 100.0 * (max(walls) - min(walls)) / med,
        "phase_ms_per_step": {k: v / 60 for k, v in phases.items()},
        "phase_calls": timer.counts(),
        "timed_counts": {k: c2[k] - c1[k] for k in c2},
        "run_counts": {k: c2[k] - c0[k] for k in c2},
        "T_e_active_eV": [float(v) for v in tg.temp[active]],
        "T_i_active_eV": [float(v) for v in tg.md_temp[active]],
        "finite": bool(torch.isfinite(tg.temp).all()),
    }


DRIVER_STEPS = 20
# examples/ablation/run1m/ablation_1m.imd without the TMM laser, NRB,
# FILTER and implicit solver, with the flagship's Lambert-Beer laser
DRIVER_PARAMS = """coordname {coord}
outfiles drv
ntypes {ntypes}
masses {masses}
pbc_dirs 0 1 1
core_potential_file {pot}/pair.pt
embedding_energy_file {pot}/embed.pt
el_density_file {pot}/rho.pt
do_maxwell 1
starttemp 0.026
ensemble ttm
timestep 0.1
maxsteps {steps}
ttmdimx 256
fd_min_atoms 8
wide_range 1
init_t_el 0.026
laser_rescale_mode 4
laser_sigma_e 0.05
laser_sigma_t 50
laser_t_0 100
laser_mu 0.01
eng_int 10
checkpt_int {steps}
cell_capacity 24
"""


def run_driver(dev_name: str, smi: str, ntypes: int = 1):
    """Phase 6: ``python -m imd_tpu_torch -p`` in process on the 1M-atom
    ablation geometry; checks and prints the ``driver`` line, and returns
    it with the run's Simulation and last state.  With ``ntypes`` > 1 the
    same film runs as an alloy of identical species: types by id parity
    in a rewritten start.chkpt, the run1m tables tiled to ntypes^2 /
    ntypes columns and written as table files."""
    import numpy as np
    import torch

    from imd_tpu_torch import __main__ as cli
    from imd_tpu_torch import kernels
    from imd_tpu_torch.io.chkpt import read_chkpt, write_chkpt
    from imd_tpu_torch.models import potential as pot

    mt = ntypes > 1
    with tempfile.TemporaryDirectory(prefix="imd_drv_") as tmp:
        d0 = read_chkpt(str(RUN1M / "start.chkpt"))
        coord, potdir = RUN1M / "start.chkpt", RUN1M
        if mt:
            coord, potdir = Path(tmp) / "start.chkpt", Path(tmp)
            d0 = dataclasses.replace(d0, type=d0.number % ntypes)
            write_chkpt(str(coord), d0, binary=True, double=True)
            eam1 = pot.read_eam(str(RUN1M / "pair.pt"),
                                str(RUN1M / "embed.pt"),
                                str(RUN1M / "rho.pt"), 1, np.float64)
            for name, n in (("pair", ntypes ** 2), ("rho", ntypes ** 2),
                            ("embed", ntypes)):
                pot.write_pot_table(
                    pot.tile_columns(getattr(eam1, name), [1.0] * n),
                    str(potdir / f"{name}.pt"))
        par = Path(tmp) / "drv.imd"
        par.write_text(DRIVER_PARAMS.format(
            coord=coord, pot=potdir, steps=DRIVER_STEPS, ntypes=ntypes,
            masses=" ".join(["26.9815"] * ntypes)))
        runs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["-p", str(par)],
                      on_phase=lambda sim, st: runs.append((sim, st)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(rc == 0 and len(runs) == 1, "driver run")
        sim, state = runs[0]
        n_obs = sim.n_observe
        check(n_obs == DRIVER_STEPS // 10, f"observe() calls {n_obs}")
        # the observables pair once per observe(), the hot-loop pair once
        # per step; the other species count's kernels not at all
        want = {"eam_rho_e": n_obs, "eam_force_s": n_obs,
                "eam_rho": DRIVER_STEPS, "eam_force": DRIVER_STEPS}
        for single, multi in MT_OF.items():
            on, off = (multi, single) if mt else (single, multi)
            check(launches[on] == want[single] and launches[off] == 0,
                  f"ntypes {ntypes}: {on} launched {launches[on]} times "
                  f"(expected {want[single]}), {off} {launches[off]} (0)")
        eng = np.loadtxt(Path(tmp) / "drv.eng", ndmin=2)
        check(eng.shape == (DRIVER_STEPS // 10, 6),
              f".eng shape {eng.shape}")
        check(bool(np.isfinite(eng).all()), ".eng values finite")
        n_atoms = len(d0.number)
        live = state.scene.mask
        order = torch.argsort(state.scene.id[live])
        ids = state.scene.id[live][order].cpu()
        check(len(ids) == n_atoms and torch.equal(
            ids, torch.as_tensor(np.sort(d0.number), dtype=ids.dtype)),
            "driver: atom count and id set conserved")
        check(torch.equal(state.scene.type[live][order].cpu(),
                          (ids % ntypes).to(torch.int32)),
              "driver: every id keeps its type")
        for name in ("drv.00001.chkpt", "drv.00001.itr", "drv-final.chkpt",
                     "drv-final.itr"):
            check((Path(tmp) / name).stat().st_size > 0, f"{name} written")
        d1 = read_chkpt(str(Path(tmp) / "drv.00001.chkpt"))
        check(len(d1.number) == n_atoms and bool(np.isfinite(d1.pos).all()),
              "driver checkpoint holds every atom")
        with open(Path(tmp) / "drv.eng") as f:
            eng_lines = f.read().splitlines()
        main_s = sim.timers.get("main")
        report = {
            "config": "examples/ablation/run1m geometry (fcc Al film, "
                      "1,024,000 atoms, pbc 0 1 1, EAM tables), TTM 256 "
                      "cells FEG EOS, Lambert-Beer laser, float32",
            "ntypes": ntypes,
            "atoms": n_atoms, "grid": list(sim.grid.dims),
            "capacity": sim.grid.capacity, "steps": DRIVER_STEPS,
            "setup_s": sim.setup_seconds,
            "main_loop_s": main_s,
            "atom_steps_per_s": n_atoms * DRIVER_STEPS / main_s,
            "ms_per_step": 1e3 * main_s / DRIVER_STEPS,
            "observe_calls": n_obs,
            "ms_per_observe": 1e3 * sim.timers.get("observe") / n_obs,
            "io_s": sim.timers.get("io"), "wall_s": wall,
            "eng_lines": eng_lines, "launches": launches,
            "max_memory_allocated_bytes": peak,
            "step_counts": dataclasses.asdict(sim.counters),
            "device": dev_name, "nvidia_smi": smi}
    print(json.dumps({"driver_alloy" if mt else "driver": report}))
    report["eng"] = eng
    return report, sim, state


ABL_START = 285     # run1m's pulse peaks at t0 = 300 fs, step ~295
ABL_STEPS = 20
ABL_N_SUB = 10      # ttm_substeps of ablation_1m.imd
# the tags of ablation_1m.imd that the ablation phase rewrites: 20 steps
# from step 285, .eng every 10, a checkpoint at step 300, FILTER every 10
ABL_TAGS = (("maxsteps 10000", f"maxsteps {ABL_START + ABL_STEPS}\n"
             f"startstep {ABL_START}"),
            ("eng_int 50", "eng_int 10"), ("checkpt_int 0", "checkpt_int 20"),
            ("filter_int 0", "filter_int 10"))
# 16 isolated atoms in the front vacuum (x < filter_min_x 600, > 40 A apart)
ABL_VAPOUR = [(x, y, z) for x in (100.0, 250.0, 400.0, 550.0)
              for y in (30.0, 90.0) for z in (30.0, 90.0)]
# the thick film of tests/test_tmm.py:170 (320 cells of 10 A, 10 vacuum,
# eps -60 + 40i)
THICK_NX, THICK_NVAC, THICK_EPS = 320, 10, complex(-60.0, 40.0)


def ablation_text(drop_nrb: bool = False, steps: int = ABL_STEPS) -> str:
    """examples/ablation/run1m/ablation_1m.imd with ABL_TAGS rewritten (and
    ``steps`` steps); with ``drop_nrb`` also without its nrb_* lines."""
    text = (RUN1M / "ablation_1m.imd").read_text()
    for a, b in ABL_TAGS:
        check(a in text, f"ablation_1m.imd holds {a!r}")
        text = text.replace(a, b)
    text = text.replace(f"maxsteps {ABL_START + ABL_STEPS}",
                        f"maxsteps {ABL_START + steps}")
    if drop_nrb:
        text = "\n".join(ln for ln in text.splitlines()
                         if not ln.startswith("nrb_")) + "\n"
    return text


def ablation_start(tmp: Path):
    """run1m's start.chkpt with ABL_VAPOUR's 16 atoms (new ids, at rest)
    written to ``tmp``, and the EAM tables linked there.  Returns run1m's
    start data and the sorted film ids."""
    import numpy as np

    from imd_tpu_torch.io.chkpt import read_chkpt, write_chkpt
    d0 = read_chkpt(str(RUN1M / "start.chkpt"))
    n_film = len(d0.number)
    nv = len(ABL_VAPOUR)
    vap_ids = np.arange(nv) + int(d0.number.max()) + 1
    d1 = dataclasses.replace(
        d0, number=np.concatenate([d0.number, vap_ids]),
        type=np.concatenate([d0.type, np.zeros(nv, d0.type.dtype)]),
        mass=np.concatenate([d0.mass, np.full(nv, d0.mass[0])]),
        pos=np.concatenate([d0.pos, np.asarray(ABL_VAPOUR)]),
        vel=np.concatenate([d0.vel, np.zeros((nv, 3))]),
        data=np.concatenate([d0.data.reshape(n_film, -1),
                             np.zeros((nv, d0.data.reshape(
                                 n_film, -1).shape[1]))]))
    write_chkpt(str(tmp / "start.chkpt"), d1, binary=True, double=True)
    for name in ("pair.pt", "embed.pt", "rho.pt"):
        (tmp / name).symlink_to(RUN1M / name)
    return d0, np.sort(d0.number)


def tmm_checks(sim, state) -> dict:
    """The TMM solver on the card, on the ablation run's last TTM grid at
    the pulse's peak: the float32 (complex64) solve against the float64
    (complex128) one on the same grid (refl, trans, absorb to 1e-5, the
    source to 1e-4 of its maximum), and in float32 the absorbed flux
    sum(qabs dx) below I_t and within 5e-3 of (1 - R - T) I_t; then
    tests/test_tmm.py's 320-cell thick film in float32 through the same
    flux checks, with its absorption cutoff inside the film.  A TF32 or
    otherwise reduced-precision product in the prefix scan fails them."""
    import numpy as np
    import torch

    from imd_tpu_torch.models import tmm as t_tmm
    g, tp = state.ttm_grid, sim.ttm_params
    tmm64 = t_tmm.make_tmm_params(sim.cfg.tmm, torch.float64, "cuda")
    t_si = sim.cfg.tmm.t0_s

    def solve(tmm, dtype):
        f = {k: getattr(g, k).to(dtype) for k in ("dens", "temp", "md_temp",
                                                   "Z", "ne")}
        return t_tmm.tmm_solve(tmm, g.natoms, f["dens"], f["temp"],
                               f["md_temp"], f["Z"], f["ne"], tp.fd_h_x,
                               torch.tensor(t_si, dtype=dtype,
                                            device="cuda"),
                               fd_min_atoms=tp.fd_min_atoms,
                               rho_min=tp.rho_min)

    def flux(src_imd, width_a):
        """sum(qabs dx) in W/m^2 from a source in IMD units."""
        return float(src_imd.double().sum()) / t_tmm.WM3_TO_IMD \
            * width_a * 1e-10

    r32 = solve(sim.tmm_params, torch.float32)
    r64 = solve(tmm64, torch.float64)
    check(bool(r32["laser_active"]) and bool(r64["laser_active"])
          and bool(r32["ok"]), "TMM: the pulse is on and the film absorbs")
    out = {f"d_{k}": abs(float(r32[k]) - float(r64[k]))
           for k in ("refl", "trans", "absorb")}
    src64 = r64["source"]
    out["d_source_rel"] = float((r32["source"].double() - src64).abs().max()
                                / src64.abs().max())
    it = float(r32["I_t"])
    absorbed = flux(r32["source"], tp.fd_h_x)
    want = (1.0 - float(r32["refl"]) - float(r32["trans"])) * it
    out.update(refl=float(r32["refl"]), trans=float(r32["trans"]),
               absorb=float(r32["absorb"]), ecut=int(r32["ecut"]),
               I_t=it, absorbed_flux=absorbed,
               flux_rel_err=abs(absorbed - want) / want)
    print(f"TMM on the ablation run's last grid: R {out['refl']:.6f}, "
          f"ecut {out['ecut']}; float32 vs float64 |d refl| "
          f"{out['d_refl']:.3e}, |d trans| {out['d_trans']:.3e}, |d absorb| "
          f"{out['d_absorb']:.3e}, |d source| / max {out['d_source_rel']:.3e}"
          f"; sum(qabs dx) / ((1-R-T) I_t) - 1 = {out['flux_rel_err']:.3e}")
    check(max(out["d_refl"], out["d_trans"], out["d_absorb"]) <= 1e-5,
          "TMM refl/trans/absorb: float32 against float64")
    check(out["d_source_rel"] <= 1e-4, "TMM source: float32 against float64")
    check(absorbed < it and out["flux_rel_err"] <= 5e-3,
          "TMM absorbed flux in float32")

    # the thick film: ~40 optical depths, prefix entries up to e^{+20}
    eps = torch.ones(THICK_NX, dtype=torch.complex64, device="cuda")
    eps[THICK_NVAC:] = THICK_EPS
    on = torch.arange(THICK_NX, device="cuda") >= THICK_NVAC
    k0 = float(np.float32(sim.tmm_params.k0_per_a))
    it_t = torch.tensor(1e16, dtype=torch.float32, device="cuda")
    res = t_tmm.solve_layers(k0, eps, on, 10.0, it_t, 20.0)
    absorbed = float(res["qabs_wm3"].double().sum()) * 10.0 * 1e-10
    want = 1e16 * float(res["absorb"])
    out["thick_film"] = {"ecut": int(res["ecut"]),
                         "refl": float(res["refl"]),
                         "absorbed_flux": absorbed,
                         "flux_rel_err": abs(absorbed - want) / want}
    print(f"TMM thick film (float32): {out['thick_film']}")
    check(int(res["ecut"]) < THICK_NX - 1 and absorbed < 1e16
          and out["thick_film"]["flux_rel_err"] <= 5e-3
          and 0.0 < float(res["refl"]) < 1.0, "TMM thick film in float32")
    return out


def calc_ttm_parts(sim, state) -> dict:
    """Where calc_ttm's time goes, on the ablation run's last state (CUDA
    events, 5 calls after one warm-up each): one calc_ttm with the run's
    settings (10 implicit substeps, the TMM at each), and one substep's
    parts: do_tmm, diff_step_implicit and fill_mesh.  Then one calc_ttm
    under torch.profiler: the CUDA kernels it launches and their summed
    device time, whence the device's idle share in it."""
    import torch

    from imd_tpu_torch import units
    from imd_tpu_torch.models import tmm as t_tmm
    from imd_tpu_torch.models import ttm as t_ttm
    from imd_tpu_torch.ops import forces_win as win
    from imd_tpu_torch.ops.fused_step import scene_to_cl

    cl = scene_to_cl(state.scene)
    _, nn = win.eam_rho(cl.xi, cl.alive, sim.eam_run, sim.grid)
    tp, g, dt = sim.ttm_params, state.ttm_grid, sim.cfg.timestep
    x = cl.xi[:, 0, :].reshape(-1)
    atoms = (x, tuple(cl.mom[:, c, :].reshape(-1) for c in range(3)),
             cl.mass.reshape(-1), cl.alive.reshape(-1))
    fdi = torch.full((x.numel(),), -1, dtype=torch.int32, device="cuda")
    t = torch.full((), (state.step - 1) * dt, dtype=x.dtype, device="cuda")

    def whole():
        return t_ttm.calc_ttm(g, atoms, tp, sim.eos, nn.reshape(-1), fdi, dt,
                              t, tmm_params=sim.tmm_params)

    tau = dt / tp.n_sub
    out = {"calc_ttm_ms": time_ms(whole, 5),
           "do_tmm_ms": time_ms(lambda: t_tmm.do_tmm(
               g, tp, sim.tmm_params, t * units.IMD_TIME_S), 5),
           "diff_step_implicit_ms": time_ms(lambda: t_ttm.diff_step_implicit(
               g, tp, tau, tp.n_sub, True), 5),
           "fill_mesh_ms": time_ms(lambda: t_ttm.fill_mesh(g, tp, sim.eos,
                                                           True), 5)}
    prof = profiled(whole)
    out["profiled_kernels"] = prof["kernels"]
    out["profiled_device_ms"] = prof["device_ms"]
    out["idle_share"] = (1.0 - prof["device_ms"] / out["calc_ttm_ms"]
                         if prof["device_ms"] > 0 else None)
    print(f"calc_ttm on the ablation run's last state: {out}")
    return out


def run_ablation(dev_name: str, smi: str):
    """Phase 8: examples/ablation/run1m/ablation_1m.imd through
    ``python -m imd_tpu_torch -p`` in process, in float32, on a copy that
    differs only in ABL_TAGS and in its start.chkpt (the run1m film and
    ABL_VAPOUR's 16 atoms with new ids): the TMM laser, NRB, FILTER and
    the implicit solver of the file as written, through the pulse's peak.
    Counters and launch counts are set to 0 just before.  Checks the run,
    its files and launches, FILTER (exactly the 16 atoms gone), NRB (its
    boundary layer, and the host reads a step of the same file without
    nrb_*), the implicit solver's substeps and the TMM (tmm_checks).
    Prints the ``ablation`` line; returns it, the Simulation and the last
    state."""
    import numpy as np
    import torch

    from imd_tpu_torch import __main__ as cli
    from imd_tpu_torch import kernels
    from imd_tpu_torch.phases import CudaPhaseTimer

    with tempfile.TemporaryDirectory(prefix="imd_abl_") as tmp:
        tmp = Path(tmp)
        d0, film_ids = ablation_start(tmp)
        n_film = len(film_ids)
        nv = len(ABL_VAPOUR)
        (tmp / "abl.imd").write_text(ablation_text())
        # NRB's layer: the atoms within alat/4 of the film's x-max
        alat = 4.05
        x = d0.pos[:, 0]
        n_bnd_want = int((x > x.max() - alat / 4.0).sum())

        timer = CudaPhaseTimer()
        runs = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["-p", str(tmp / "abl.imd")], timer=timer,
                      on_phase=lambda sim, st: runs.append((sim, st)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        phases = timer.totals_ms()
        check(rc == 0 and len(runs) == 1, "ablation run")
        sim, state = runs[0]
        c = sim.counters
        steps_run = c.steps
        check(state.step == ABL_START + ABL_STEPS and steps_run >= ABL_STEPS,
              f"ablation: {steps_run} steps to step {state.step}")
        n_obs = sim.n_observe
        check(n_obs == 3, f"ablation observe() calls {n_obs} (290, 300, 305)")
        launch_checks(launches, steps_run, n_obs, c.rebins, "ablation")
        # the implicit solver: n_sub substeps a step and no CFL read; the
        # one host read a step is the skin check
        check(c.cfl_substeps == ABL_N_SUB * steps_run,
              f"ablation: {c.cfl_substeps} TTM substeps in {steps_run} steps")
        check(c.host_syncs == steps_run,
              f"ablation: {c.host_syncs} host reads in {steps_run} steps")
        # the files
        eng = np.loadtxt(tmp / "ablation1m.eng", ndmin=2)
        laser = np.loadtxt(tmp / "ablation1m.laser", ndmin=2)
        check(eng.shape == (2, 6) and bool(np.isfinite(eng).all()),
              f"ablation .eng {eng.shape} finite")
        check(laser.shape == (2, 6) and bool(np.isfinite(laser).all()),
              f"ablation .laser {laser.shape} finite")
        check(laser[1, 3] > laser[0, 3] > 0.0,
              "ablation: the absorbed fluence rises over the run")
        for base in ("ablation1m.00015", "ablation1m-final"):
            for ext in (".chkpt", ".itr", ".nrb", ".ttm"):
                check((tmp / (base + ext)).stat().st_size > 0,
                      f"{base}{ext} written")
        with open(tmp / "ablation1m.laser") as f:
            laser_lines = f.read().splitlines()
        # FILTER: exactly the 16 vapour atoms are gone (at step 290)
        live = state.scene.mask
        ids = torch.sort(state.scene.id[live]).values.cpu().numpy()
        check(sim.n_filter == 2 and len(ids) == n_film
              and np.array_equal(ids, film_ids),
              f"FILTER: {n_film + nv - len(ids)} atoms deleted in "
              f"{sim.n_filter} applications; every film atom kept")
        # NRB: the boundary layer and its neighbours
        st = sim.nrb_state
        n_bnd = int(st.bnd_id.numel())
        n_nb = (st.neigh_id >= 0).sum(1)
        check(n_bnd == n_bnd_want and bool((n_nb == 4).all())
              and bool((st.bnd_type == 1).all()),
              f"NRB: {n_bnd} boundary atoms (the start file has "
              f"{n_bnd_want} within alat/4 of x-max), each with 4 inward "
              f"neighbours")
        tmm_out = tmm_checks(sim, state)
        ttm_parts = calc_ttm_parts(sim, state)

        # the same file without nrb_*, 2 steps: its host reads a step
        (tmp / "plain.imd").write_text(ablation_text(drop_nrb=True,
                                                     steps=2))
        plain = []
        check(cli.main(["-p", str(tmp / "plain.imd")],
                       on_phase=lambda s_, st_: plain.append(s_)) == 0,
              "ablation without nrb_*")
        pc = plain[0].counters
        check(plain[0].nrb_state is None
              and pc.host_syncs * steps_run == c.host_syncs * pc.steps,
              f"NRB adds no host read: {c.host_syncs}/{steps_run} against "
              f"{pc.host_syncs}/{pc.steps} without nrb_*")
        del plain

    main_s = sim.timers.get("main")
    report = {
        "config": "examples/ablation/run1m/ablation_1m.imd as written (fcc "
                  "Al film, 1,024,000 atoms + 16 vapour atoms, pbc 0 1 1, "
                  "TTM 256 cells FEG EOS, TMM 800 nm I0 2e17 W/m^2, NRB, "
                  "FILTER, ttm_solver implicit 10 substeps, cell_capacity "
                  "24) for 20 steps from step 285, .eng every 10, FILTER "
                  "every 10, float32",
        "atoms": n_film + nv, "atoms_end": len(ids),
        "grid": list(sim.grid.dims), "capacity": sim.grid.capacity,
        "steps": ABL_STEPS, "steps_run": steps_run,
        "setup_s": sim.setup_seconds, "setup_parts_s": sim.setup_parts,
        "main_loop_s": main_s, "wall_s": wall,
        "atom_steps_per_s": n_film * ABL_STEPS / main_s,
        "ms_per_step": 1e3 * main_s / ABL_STEPS,
        "phase_ms_per_step": {k: v / steps_run for k, v in phases.items()},
        "phase_calls": timer.counts(),
        "filter_applications": sim.n_filter,
        "ms_per_filter": 1e3 * sim.timers.get("filter") / sim.n_filter,
        "observe_calls": n_obs,
        "ms_per_observe": 1e3 * sim.timers.get("observe") / n_obs,
        "io_s": sim.timers.get("io"),
        "step_counts": dataclasses.asdict(c),
        "nrb_boundary_atoms": n_bnd,
        "host_syncs_per_step": c.host_syncs / steps_run,
        "host_syncs_per_step_without_nrb": pc.host_syncs / pc.steps,
        "tmm": tmm_out, "calc_ttm_parts": ttm_parts,
        "eng": eng.tolist(), "laser": laser_lines,
        "launches": launches, "max_memory_allocated_bytes": peak,
        "device": dev_name, "nvidia_smi": smi}
    print(json.dumps({"ablation": report}))
    return report, sim, state


PHYS_STEPS = 10     # phase 9: steps 285 -> 295, across the pulse's peak
PHYS_TAGS = "vlatdim 1000\nelecpress 1\ncolrad\ncolrad_mpi 1\n"
FDTD_STEPS = 4      # phase 10: steps 0 -> 4 of start.chkpt
FDTD_MAXWELL = 649  # Maxwell steps per MD step on run1m's 9.418 A cells
# phase 11: phase 9 writes its checkpoint set (number 1) at step 290 and
# phase 10 at step 2; each is resumed to its phase's last step
PHYS_RESTART_AT = 290
FDTD_RESTART_AT = 2
# the interval outputs of the resumed phase 9 run, due once, at step 295
# (nb_rcut between the first and second neighbour shells of fcc Al)
OUTPUT_TAGS = ("dist_int 5\ndist_dim 256 1 1\ndist_Ekin_flag 1\n"
               "dist_Epot_flag 1\ndist_mdtemp_flag 1\npic_int 5\n"
               "force_int 5\npress_int 5\nnb_checkpt_int 5\nnb_rcut 3.5\n"
               "nb_cut_lower 11\nnb_cut_upper 13\n")
# the restarted runs against the straight ones at the same step, float32.
# The restart itself is exact in float64 on the CPU (tests/
# test_torch_ttm_restart.py: 1e-9, COLRAD's populations through the .ttm's
# %e 1e-6); what is left is float32 rounding in another order: the restart
# bins the atoms afresh, so every cell sum adds its terms in another
# order (~1e-6 relative), and rounding then decides for some pairs within
# an ulp of the cutoff on which side they fall, where the degree-12 fit
# jumps by up to ~5 eV/A (ROADMAP C2): such an atom's velocity changes by
# up to 5 x 0.1 / 27 = 0.018 A per time unit in one step, half a thermal
# velocity at 0.03 eV, and its cell's T_i by ~m v dv / (1.5 N) (0.6% of
# T_i for one flip in a 160-atom cell of a 16,016-atom film when this
# script runs on the CPU, 3.8e-3 measured there).  COLRAD's float32 Newton amplifies a rounding
# difference in its inputs: one COLRAD step in float32 against float64 on
# the same grid reached 3.5e-3 of T_e and 1.9e-3 of the populations in
# cells that converge slowly (PERF.md, phase 9's COLRAD step), so the
# restart's reordered sums may move a COLRAD cell by as much.  Positions:
# 2e-3 A, 8 ulp of x at 2400 A (7.3e-4 measured on the CPU).  T_e and T_i
# 1e-2 relative on the straight run's active cells, the populations 1e-2
# of their cell's nuclei, the FDTD fields 1e-3 of their largest value.
# The per-atom stress (a float64 oracle on the fit) summed against K5's
# float32 pressure tensor: the same pairs, but K5's Horners round each
# value to ~2^-24 of the fit's coefficient mass (sum |c_k| ~ 1,510 for
# these EAM fits, ROADMAP C2), ~1e-4 of a term; 1.0e-4 of the largest
# component measured on the CPU (the 16,016-atom film) and on the H100
# (run1m's film), as large relative to the summed |terms| (no
# cancellation), so 1e-3
STRESS_TOL = 1e-3
RESTART_TOL = {"pos_A": 2e-3, "temp_rel": 1e-2, "md_temp_rel": 1e-2,
               "pops_of_total": 1e-2, "fields_of_max": 1e-3}


def launch_checks(launches, steps, n_obs, rebins, what):
    """K1/K2 once a step, K4/K5 once per observe(), K3 three per rebin,
    and nothing else."""
    want = {"eam_rho": steps, "eam_force": steps, "eam_rho_e": n_obs,
            "eam_force_s": n_obs, "compact": 3 * rebins}
    for k, v in want.items():
        check(launches[k] == v, f"{what}: {k} launched {launches[k]} times "
              f"(expected {v})")
    others = {k: v for k, v in launches.items() if v and k not in want}
    check(not others, f"{what}: other kernels launched {others}")


def colrad_parts(sim, state) -> dict:
    """Phase 9's parts on the run's last state (CUDA events): one calc_ttm
    with the run's settings (COLRAD with its MULTIPHOTON flux, 10
    implicit substeps with the TMM and the virtual lattice at each), one
    COLRAD step (apply_colrad) with its tries and host reads, one
    vlat_substep and the ELECPRESS force; then the COLRAD step on the last
    grid in float32 against float64 (T_e, n_e and the populations, the
    last per cell as a share of its total), and its conservation: each
    active cell's populations keep their sum within 1e-4 through the
    step (a fresh one is seeded with n_tot) and sum to the cell's current
    n_tot = dens / m_atom within 1e-4."""
    import torch

    from imd_tpu_torch import units
    from imd_tpu_torch.models import colrad as t_colrad
    from imd_tpu_torch.models import ttm as t_ttm
    from imd_tpu_torch.ops import forces_win as win
    from imd_tpu_torch.ops.fused_step import scene_to_cl
    from imd_tpu_torch.phases import StepCounters

    cl = scene_to_cl(state.scene)
    _, nn = win.eam_rho(cl.xi, cl.alive, sim.eam_run, sim.grid)
    tp, g, dt = sim.ttm_params, state.ttm_grid, sim.cfg.timestep
    cs, vs = state.cstate, state.vstate
    x = cl.xi[:, 0, :].reshape(-1)
    atoms = (x, tuple(cl.mom[:, c, :].reshape(-1) for c in range(3)),
             cl.mass.reshape(-1), cl.alive.reshape(-1))
    fdi = torch.full((x.numel(),), -1, dtype=torch.int32, device="cuda")
    t = torch.full((), (state.step - 1) * dt, dtype=x.dtype, device="cuda")
    phi = sim.colrad_phi(t * units.IMD_TIME_S)

    def whole():
        return t_ttm.calc_ttm(
            g, atoms, tp, sim.eos, nn.reshape(-1), fdi, dt, t,
            tmm_params=sim.tmm_params,
            colrad=(sim.colrad_tab, sim.colrad_step, cs, sim.colrad_phi),
            vlat=(sim.vlat_params, vs))

    gm = t_ttm.fill_mesh(g, tp, sim.eos, False)
    counters = StepCounters()

    def colrad_once(ctr=None):
        return t_colrad.apply_colrad(gm, cs, sim.colrad_tab, tp,
                                     sim.colrad_step, dt, phi, counters=ctr)

    colrad_once(counters)
    tau = dt / tp.n_sub
    out = {"calc_ttm_ms": time_ms(whole, 2),
           "colrad_step_ms": time_ms(colrad_once, 2),
           "colrad_tries": counters.colrad_tries,
           "colrad_host_reads": counters.host_syncs,
           "vlat_substep_ms": time_ms(lambda: t_ttm.vlat_substep(
               g, vs, tp, sim.vlat_params, sim.eos, tau), 5),
           "elecpress_ms": time_ms(lambda: t_ttm.electron_pressure_force(
               g, tp, sim.eos), 5)}
    # launches and the device's idle share: one calc_ttm, one COLRAD step
    # (its kernels over its tries), one vlat_substep
    out["calc_ttm_profiled"] = profiled(whole)
    prof = profiled(colrad_once)
    prof["kernels_per_try"] = prof["kernels"] / counters.colrad_tries
    out["colrad_step_profiled"] = prof
    out["vlat_substep_profiled"] = profiled(lambda: t_ttm.vlat_substep(
        g, vs, tp, sim.vlat_params, sim.eos, tau))

    # float32 against float64 on the same grid
    step64 = t_colrad.make_colrad_step(
        sim.colrad_tab, evolve_te=True,
        mpi_const=t_colrad.mpi_constants(sim.cfg.tmm.lambda_m))
    g64 = gm.replace(**{k: getattr(gm, k).double() for k in (
        "temp", "ne", "Z", "dens", "Ce", "md_temp")})
    cs64 = cs.replace(c=cs.c.double(), p=cs.p.double())
    g1, c1, _ = colrad_once()
    g2, c2, _ = t_colrad.apply_colrad(g64, cs64, sim.colrad_tab, tp, step64,
                                      dt, phi.double())
    act = t_ttm.active_mask(gm, tp)
    tot = c2.c.sum(1).clamp(min=1.0)
    out["f32_vs_f64"] = {
        "d_temp_rel": float(((g1.temp.double() - g2.temp).abs()
                             / g2.temp.abs().clamp(min=1e-30))[act].max()),
        "d_ne_rel": float(((g1.ne.double() - g2.ne).abs()
                           / g2.ne.abs().clamp(min=1e-30))[act].max()),
        "d_pops_of_total": float(((c1.c.double() - c2.c).abs().amax(1)
                                  / tot)[act].max())}
    # conservation through the step; the seed of a fresh cell
    before = cs64.c.sum(1)
    fresh = act & (before <= 0)
    ntot = g64.dens / (tp.atomic_mass * units.AMU_TO_KG)
    ref = torch.where(fresh, ntot, before)
    dev = ((c2.c.sum(1) - ref).abs() / ref.clamp(min=1.0))[act]
    out["populations_sum_rel_err"] = float(dev.max())
    out["populations_vs_current_ntot"] = float(
        ((c2.c.sum(1) - ntot).abs() / ntot.clamp(min=1.0))[act].max())
    print(f"COLRAD parts on phase 9's last state: {out}")
    check(out["populations_sum_rel_err"] <= 1e-4
          and out["populations_vs_current_ntot"] <= 1e-4,
          "COLRAD: the populations of each active cell keep their sum "
          "through the step and sum to its n_tot")
    check(bool(torch.isfinite(g1.temp).all()) and bool(
        torch.isfinite(c1.c).all()), "COLRAD float32 step finite")
    return out


def physics_text() -> str:
    """Phase 9's file: phase 8's with PHYS_TAGS, PHYS_STEPS steps and its
    checkpoint set at step PHYS_RESTART_AT."""
    text = ablation_text(steps=PHYS_STEPS)
    check("checkpt_int 20" in text, "phase 8's file holds checkpt_int 20")
    return text.replace("checkpt_int 20",
                        f"checkpt_int {PHYS_RESTART_AT}") + PHYS_TAGS


def fdi_by_id(scene, fdi):
    """(ids, FD index) of the live slots, sorted by id, on the device."""
    import torch
    m = scene.mask
    ids, order = torch.sort(scene.id[m].long())
    return ids, fdi[m][order].to(torch.int32)


class stash_checkpoints:
    """While active, keep a copy of the TTM state of each numbered
    checkpoint set the driver writes (``store[n]``: the grid's restart
    fields, the populations, the virtual lattice, the FDTD fields and the
    FD index with the ids), for phase 11 to hold the restored state to."""

    FIELDS = ("temp", "md_temp", "U", "natoms", "natoms_old", "dens",
              "source", "xi")

    def __init__(self, store: dict):
        self.store = store

    def __enter__(self):
        from imd_tpu_torch import simulation as t_sim
        self.cls, self.orig = t_sim.Simulation, \
            t_sim.Simulation.write_checkpoint
        store, orig, fields = self.store, self.orig, self.FIELDS

        def write_checkpoint(sim, state, fzhlr):
            if fzhlr > 0 and state.ttm_grid is not None:
                g = state.ttm_grid
                snap = {f"grid_{k}": getattr(g, k).clone() for k in fields}
                if state.cstate is not None:
                    snap["c"] = state.cstate.c.clone()
                if state.vstate is not None:
                    snap["vlat_te"] = state.vstate.te.clone()
                    snap["vlat_ti"] = state.vstate.ti.clone()
                if state.fdtd is not None:
                    for f in dataclasses.fields(state.fdtd):
                        snap[f"fdtd_{f.name}"] = getattr(state.fdtd,
                                                         f.name).clone()
                snap["fdi"] = fdi_by_id(state.scene, state.fdi)
                store[fzhlr] = snap
            return orig(sim, state, fzhlr)
        self.cls.write_checkpoint = write_checkpoint
        return self

    def __exit__(self, *exc):
        self.cls.write_checkpoint = self.orig


def run_physics(dev_name: str, smi: str, tmp: Path, stash: dict):
    """Phase 9: phase 8's run (run1m's ablation_1m.imd with ABL_TAGS and
    the 16 vapour atoms) plus VLATTICE (1000 virtual cells, 0.94 um of bulk
    behind the 1.01 um film), ELECPRESS and COLRAD with its MULTIPHOTON
    channels (rates ``auto``: the closed-form fits, no state tables on
    disk), PHYS_STEPS steps from step 285 through ``cli.main`` in float32
    in ``tmp``, launch counters set to 0 just before; its checkpoint set
    at step PHYS_RESTART_AT (written before that step's FILTER) goes to
    ``stash`` for phase 11.  Checks the run, its launches,
    files (the .ttm with the COLRAD columns and the virtual rows), that the
    state is finite, and the COLRAD step (colrad_parts).  Prints the
    ``physics`` line; returns it, the Simulation, the last state and the
    film's ids."""
    import numpy as np
    import torch

    from imd_tpu_torch import __main__ as cli
    from imd_tpu_torch import kernels
    from imd_tpu_torch.models import ttm as t_ttm
    from imd_tpu_torch.phases import CudaPhaseTimer

    _, film_ids = ablation_start(tmp)
    (tmp / "phys.imd").write_text(physics_text())
    timer = CudaPhaseTimer()
    runs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with stash_checkpoints(stash):
        rc = cli.main(["-p", str(tmp / "phys.imd")], timer=timer,
                      on_phase=lambda sim, st: runs.append((sim, st)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    phases = timer.totals_ms()
    check(rc == 0 and len(runs) == 1, "physics run")
    sim, state = runs[0]
    c = sim.counters
    check(state.step == ABL_START + PHYS_STEPS
          and c.steps >= PHYS_STEPS, f"physics: {c.steps} steps")
    launch_checks(launches, c.steps, sim.n_observe, c.rebins, "physics")
    check(sim.n_filter == 1 and sim.vlat_params.nv == 1000
          and sim.colrad_phi is not None, "physics: set-up")
    check(sorted(stash) == [1] and (tmp / "ablation1m.00001.ttmaux.npz")
          .exists(), f"physics: the checkpoint set at step "
          f"{PHYS_RESTART_AT}")
    g, cs, vs = state.ttm_grid, state.cstate, state.vstate
    finite = all(bool(torch.isfinite(a).all()) for a in (
        g.temp, g.ne, g.Z, g.U, g.xi, cs.c, cs.p, vs.te, vs.ti,
        state.scene.pos, state.scene.mom))
    check(finite, "physics: the finished state is finite")
    eng = np.loadtxt(tmp / "ablation1m.eng", ndmin=2)
    check(eng.shape == (1, 6) and bool(np.isfinite(eng).all()),
          f"physics .eng {eng.shape} finite")
    ttm = np.loadtxt(tmp / "ablation1m-final.ttm")
    check(ttm.shape == (256 + 1000, 40)
          and bool((ttm[256:, 3] == -2).all()),
          f"physics -final.ttm {ttm.shape}: 17 populations, 5 powers, "
          "1000 virtual rows")
    live = state.scene.mask
    ids = torch.sort(state.scene.id[live]).values.cpu().numpy()
    check(np.array_equal(ids, film_ids), "physics: FILTER kept the film")
    act = t_ttm.active_mask(g, sim.ttm_params)
    hot = int(torch.argmax(torch.where(act, g.temp, -1.0)))
    epf = t_ttm.electron_pressure_force(g, sim.ttm_params, sim.eos)
    psum = cs.p.double().sum(0).tolist()
    parts = colrad_parts(sim, state)

    main_s = sim.timers.get("main")
    n_atoms = len(film_ids) + len(ABL_VAPOUR)
    report = {
        "config": "phase 8's run (run1m's ablation_1m.imd, TMM, NRB, "
                  "FILTER, implicit solver, 1,024,000 atoms + 16 vapour) "
                  "with vlatdim 1000, elecpress 1, colrad (fit rates, "
                  "4 stages x 4 levels + bare), colrad_mpi 1; 10 steps from "
                  "step 285, float32",
        "atoms": n_atoms, "steps_run": c.steps,
        "grid": list(sim.grid.dims), "capacity": sim.grid.capacity,
        "setup_s": sim.setup_seconds, "setup_parts_s": sim.setup_parts,
        "main_loop_s": main_s, "wall_s": wall,
        "ms_per_step": 1e3 * main_s / PHYS_STEPS,
        "atom_steps_per_s": len(film_ids) * PHYS_STEPS / main_s,
        "phase_ms_per_step": {k: v / c.steps for k, v in phases.items()},
        "step_counts": dataclasses.asdict(c),
        "colrad_tries_per_step": c.colrad_tries / c.steps,
        "host_reads_per_step": c.host_syncs / c.steps,
        "hottest_cell": {"index": hot, "T_e_eV": float(g.temp[hot]),
                         "Z_mean": float(g.Z[hot]),
                         "n_e_per_m3": float(g.ne[hot])},
        "vlat_te_first_last_eV": [float(vs.te[0]), float(vs.te[-1])],
        "power_column_sums": dict(zip(("P_EE", "P_EI", "P_MPI2", "P_MPI3",
                                       "P_RR"), psum)),
        "elecpress_max_abs_eV_per_A": float(epf.abs().max()),
        "parts": parts, "eng": eng.tolist(), "launches": launches,
        "max_memory_allocated_bytes": peak, "device": dev_name,
        "nvidia_smi": smi}
    print(json.dumps({"physics": report}))
    return report, sim, state, film_ids


def fdtd_text(steps: int, checkpt: int = 0) -> str:
    """run1m's ablation_1m.imd with the FDTD laser in place of the TMM
    (lambda, I0, laser_t_0 and laser_sigma_t kept), ``steps`` steps from
    step 0, .eng at the end and a checkpoint set every ``checkpt`` steps
    (at the end by default)."""
    text = (RUN1M / "ablation_1m.imd").read_text()
    for a, b in (("\ntmm\n", "\nfdtd\n"), ("maxsteps 10000",
                                          f"maxsteps {steps}"),
                 ("eng_int 50", f"eng_int {steps}"),
                 ("checkpt_int 0", f"checkpt_int {checkpt or steps}")):
        check(a in text, f"ablation_1m.imd holds {a!r}")
        text = text.replace(a, b)
    return text


def fdtd_checks(sim, state) -> dict:
    """Phase 10's parts on the run's last state: one step_1d and one
    explicit diffusion substep with its fill_mesh (CUDA events), and
    FDTD_MAXWELL Maxwell steps from the last fields in float32 against
    float64 (the E field and the source as a share of their maxima)."""
    import torch

    from imd_tpu_torch import units
    from imd_tpu_torch.models import fdtd as t_fdtd
    from imd_tpu_torch.models import ttm as t_ttm

    tp, g, fs = sim.ttm_params, state.ttm_grid, state.fdtd
    fp = sim.fdtd_params
    dt = sim.cfg.timestep
    t_si = float(state.step * dt * units.IMD_TIME_S)
    dl = t_fdtd.fit_dl(g, tp)
    active = g.natoms >= tp.fd_min_atoms
    ts = torch.tensor(t_si, dtype=g.temp.dtype, device="cuda")
    tau = dt / FDTD_MAXWELL
    def maxwell_step():
        t_fdtd.step_1d(fs, fp, dl, active, ts)
        t_ttm.fill_mesh(t_ttm.diff_step(g, tp, tau, FDTD_MAXWELL, True), tp,
                        sim.eos, True)

    out = {"step_1d_ms": time_ms(lambda: t_fdtd.step_1d(fs, fp, dl, active,
                                                        ts), 20),
           "diffusion_substep_ms": time_ms(lambda: t_ttm.fill_mesh(
               t_ttm.diff_step(g, tp, tau, FDTD_MAXWELL, True), tp, sim.eos,
               True), 20),
           # a Maxwell step with its diffusion substep: launches, idle share
           "maxwell_step_profiled": profiled(maxwell_step)}
    fp64 = t_fdtd.make_fdtd_params(sim.cfg.fdtd, tp, torch.float64, "cuda")
    g64 = g.replace(**{k: getattr(g, k).double() for k in (
        "temp", "md_temp", "ne", "Z")})
    dl64 = t_fdtd.fit_dl(g64, tp)
    fs64 = fs.replace(**{k: getattr(fs, k).double() for k in (
        "ezx", "hy", "jzx", "jlzx", "pzx", "source")})
    a = t_fdtd.run_substeps(fs, fp, dl, active, ts, FDTD_MAXWELL)
    b = t_fdtd.run_substeps(fs64, fp64, dl64, active, ts.double(),
                            FDTD_MAXWELL)
    for name in ("ezx", "source"):
        ref = getattr(b, name)
        out[f"d_{name}_of_max"] = float(
            (getattr(a, name).double() - ref).abs().max()
            / ref.abs().max().clamp(min=1e-300))
    out["ezx_max_V_per_m"] = float(b.ezx.abs().max())
    print(f"FDTD parts on phase 10's last state: {out}")
    check(bool(torch.isfinite(a.ezx).all()) and bool(
        torch.isfinite(a.source).all()), "FDTD float32 fields finite")
    return out


def run_fdtd(dev_name: str, smi: str, tmp: Path, stash: dict):
    """Phase 10: run1m's ablation_1m.imd with the FDTD laser in place of
    the TMM (fdtd_text: 800 nm, 2e17 W/m^2, NRB, the FILTER tags without a
    cadence), FDTD_STEPS steps from step 0 of start.chkpt (the envelope at
    1.1% of E0, above the 1e-4 switch) through ``cli.main`` in float32,
    launch counters set to 0 just before: FDTD_MAXWELL Maxwell steps a step
    with the explicit diffusion substeps the CFL count asks for, one host
    read a step for it besides the skin check's; .laser with I_t and refl
    NaN and a rising absorbed fluence; finite fields.  Prints the ``fdtd``
    line; returns it, the Simulation and the last state.  Runs in ``tmp``
    with a checkpoint set every FDTD_RESTART_AT steps, the first of which
    goes to ``stash`` for phase 11."""
    import numpy as np
    import torch

    from imd_tpu_torch import __main__ as cli
    from imd_tpu_torch import kernels
    from imd_tpu_torch.phases import CudaPhaseTimer

    for name in ("pair.pt", "embed.pt", "rho.pt", "start.chkpt"):
        (tmp / name).symlink_to(RUN1M / name)
    (tmp / "fdtd.imd").write_text(fdtd_text(FDTD_STEPS,
                                            FDTD_RESTART_AT))
    timer = CudaPhaseTimer()
    runs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with stash_checkpoints(stash):
        rc = cli.main(["-p", str(tmp / "fdtd.imd")], timer=timer,
                      on_phase=lambda sim, st: runs.append((sim, st)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    phases = timer.totals_ms()
    check(rc == 0 and len(runs) == 1, "FDTD run")
    sim, state = runs[0]
    c = sim.counters
    check(state.step == FDTD_STEPS and c.steps == FDTD_STEPS,
          f"FDTD: {c.steps} steps")
    launch_checks(launches, c.steps, sim.n_observe, c.rebins, "FDTD")
    check(sim.fdtd_params is not None and sim.tmm_params is None
          and c.maxwell_steps == FDTD_MAXWELL * c.steps
          and c.host_syncs == 2 * c.steps,
          f"FDTD: {c.maxwell_steps} Maxwell steps and {c.host_syncs} "
          f"host reads in {c.steps} steps")
    g, fs = state.ttm_grid, state.fdtd
    check(all(bool(torch.isfinite(a).all()) for a in (
        g.temp, g.U, fs.ezx, fs.hy, fs.source)), "FDTD: finite state")
    laser = np.loadtxt(tmp / "ablation1m.laser", ndmin=2)
    check(laser.shape == (1, 5) and bool(np.isnan(laser[:, [2, 4]]).all())
          and laser[0, 3] > 0.0,
          f"FDTD .laser {laser.tolist()}: I_t and refl NaN, fluence > 0")
    eabs_ev = float(g.eabs)
    src_max = float(fs.source.max())
    parts = fdtd_checks(sim, state)

    main_s = sim.timers.get("main")
    report = {
        "config": "run1m's ablation_1m.imd with fdtd in place of tmm "
                  "(800 nm, I0 2e17 W/m^2, t0 300 fs, sigma 100 fs; NRB; "
                  "1,024,000 atoms; TTM 256 cells of 9.418 A), 4 steps from "
                  "step 0, float32",
        "atoms": int(state.scene.mask.sum()), "steps_run": c.steps,
        "setup_s": sim.setup_seconds, "main_loop_s": main_s, "wall_s": wall,
        "ms_per_step": 1e3 * main_s / c.steps,
        "atom_steps_per_s": int(state.scene.mask.sum()) * c.steps / main_s,
        "phase_ms_per_step": {k: v / c.steps for k, v in phases.items()},
        "step_counts": dataclasses.asdict(c),
        "maxwell_steps_per_step": c.maxwell_steps / c.steps,
        "diffusion_substeps_per_step": c.cfl_substeps / c.steps,
        "absorbed_eV": eabs_ev, "absorbed_fluence_J_m2": float(laser[0, 3]),
        "source_max": src_max, "parts": parts, "launches": launches,
        "max_memory_allocated_bytes": peak, "device": dev_name,
        "nvidia_smi": smi}
    print(json.dumps({"fdtd": report}))
    return report, sim, state


def drive(path: Path, label: str, *extra):
    """``cli.main(["-p", path, *extra])`` in float32, launch counters set
    to 0 just before and checked after (launch_checks): returns the
    Simulation, its last state, the launches, the CUDA-event phase times
    and the wall seconds."""
    import torch

    from imd_tpu_torch import __main__ as cli
    from imd_tpu_torch import kernels
    from imd_tpu_torch.phases import CudaPhaseTimer

    timer = CudaPhaseTimer()
    runs = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["-p", str(path), *extra], timer=timer,
                  on_phase=lambda sim, st: runs.append((sim, st)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check(rc == 0 and len(runs) == 1, f"{label}: the run")
    sim, state = runs[0]
    launch_checks(launches, sim.counters.steps, sim.n_observe,
                  sim.counters.rebins, label)
    return sim, state, launches, timer.totals_ms(), wall


def resume(tmp: Path, text: str, label: str):
    """``drive`` with ``-r 1`` on ``text``, written beside the set."""
    (tmp / "resume.imd").write_text(text)
    return drive(tmp / "resume.imd", label, "-r", "1")


def restored_vs_written(sim, tmp: Path, snap: dict) -> dict:
    """The TTM state a resumed Simulation restores from set 1 (again,
    ``_initial_ttm_state``) against the sidecar's arrays and the state
    the straight run wrote: the grid fields and the virtual lattice with
    the same bits, the FD index by id equal, the COLRAD populations within
    the .ttm's %e digits (5e-7 relative, 1e-12 of the cell's nuclei)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    grid, aux, fdi = sim._initial_ttm_state()
    torch.cuda.synchronize()
    out = {"restore_s": time.perf_counter() - t0}
    side = np.load(tmp / "ablation1m.00001.ttmaux.npz")
    same = {}
    for k in stash_checkpoints.FIELDS:
        v = getattr(grid, k).cpu().numpy()
        same[k] = bool(np.array_equal(v, side[f"grid_{k}"])
                       and np.array_equal(
                           v, snap[f"grid_{k}"].cpu().numpy()))
    states = sim._aux_states((None,) * 3 + aux + (None,))
    if "vstate" in states:
        for k in ("te", "ti"):
            v = getattr(states["vstate"], k).cpu().numpy()
            same[f"vlat_{k}"] = bool(np.array_equal(v, side[f"vlat_{k}"])
                                     and np.array_equal(
                                         v, snap[f"vlat_{k}"].cpu().numpy()))
    if "fdtd" in states:
        for f in dataclasses.fields(states["fdtd"]):
            v = getattr(states["fdtd"], f.name).cpu().numpy()
            same[f"fdtd_{f.name}"] = bool(np.array_equal(
                v, snap[f"fdtd_{f.name}"].cpu().numpy()))
    ids, vals = fdi_by_id(sim.scene, fdi)
    sids, svals = snap["fdi"]
    same["fdi_by_id"] = bool(torch.equal(ids, sids)) and bool(
        torch.equal(vals, svals))
    out["bits_equal"] = same
    if "cstate" in states:
        c, w = states["cstate"].c.double(), snap["c"].double()
        tot = w.sum(1, keepdim=True).clamp(min=1.0)
        dev = (c - w).abs() - 5e-7 * w.abs()
        out["pops_beyond_%e_of_total"] = float((dev / tot).max())
        same["pops_within_%e"] = out["pops_beyond_%e_of_total"] <= 1e-12
    print(f"restored vs written: {out}")
    check(all(same.values()), f"the restored state: {same}")
    return out


def deviations(straight, resumed, ids, tp) -> dict:
    """The resumed state against the straight one at the same step: T_e
    and T_i relative on the straight run's active cells, the populations
    as a share of their cell's nuclei, and the positions of the atoms
    ``ids`` (A, periodic axes by minimum image)."""
    import torch

    from imd_tpu_torch.models import ttm as t_ttm

    ga, gb = straight.ttm_grid, resumed.ttm_grid
    act = t_ttm.active_mask(ga, tp)
    out = {"active_cells": int(act.sum())}
    for k in ("temp", "md_temp"):
        a, b = getattr(ga, k).double()[act], getattr(gb, k).double()[act]
        rel = (b - a).abs() / a.abs()
        out[f"{k}_rel"] = float(rel.max())
        # the worst cell: its atoms, and its centre-of-mass kinetic energy
        # per atom beside T (T_i subtracts it from the atoms' sum)
        i = int(torch.nonzero(act).flatten()[int(torch.argmax(rel))])
        out[f"{k}_worst"] = {
            "cell": i, "natoms": int(ga.natoms[i]),
            "straight": float(getattr(ga, k)[i]),
            "resumed": float(getattr(gb, k)[i]),
            "com_ke_eV": float(0.5 * tp.atomic_mass
                               * (ga.vcom[i].double() ** 2).sum())}
    if straight.cstate is not None:
        a = straight.cstate.c.double()[act]
        b = resumed.cstate.c.double()[act]
        out["pops_of_total"] = float(((b - a).abs() / a.sum(1, keepdim=True)
                                      .clamp(min=1.0)).max())

    def pos_of(scene):
        m = scene.mask.reshape(-1)
        sid = scene.id.reshape(-1)[m].long()
        p = scene.pos.reshape(-1, 3)[m].double()
        keep = torch.isin(sid, ids)
        sid, p = sid[keep], p[keep]
        return p[torch.argsort(sid)], torch.sort(sid).values
    pa, ia = pos_of(straight.scene)
    pb, ib = pos_of(resumed.scene)
    check(torch.equal(ia, ib), "the resumed run holds the straight run's "
          "atoms")
    d = pb - pa
    h = torch.as_tensor(straight.scene.grid.box.h, dtype=d.dtype,
                        device=d.device)
    for ax in (1, 2):
        L = float(h[ax, ax])
        d[:, ax] -= torch.round(d[:, ax] / L) * L
    out["pos_max_A"] = float(d.abs().max())
    return out


def run_restart_physics(dev_name: str, smi: str, tmp: Path, straight,
                        snap: dict, film_ids):
    """Phase 11 on phase 9's set: ``-r 1`` on phase 9's file with
    ``do_maxwell 0`` (the velocities come from the checkpoint; imd_tpu's
    ``do_maxwell 1`` draws new ones on a restart too) and the interval
    outputs (OUTPUT_TAGS), step 290 -> 295.  Checks the restored state
    (restored_vs_written), the launches, a finite state, the deviations
    from phase 9's step 295 (RESTART_TOL; the 16 vapour atoms that phase
    9's FILTER deleted at step 290, after writing the set, stay: the
    restart resumes after that step), the outputs written once with their
    writers' times, and the per-atom stress: on the degree-12 fit that K5
    evaluates, its sum is K5's pressure tensor of step 295 (STRESS_TOL of
    its largest component); the .stress file's, from the tables as imd_tpu
    writes it, is printed beside it (ROADMAP C2)."""
    import numpy as np
    import torch

    from imd_tpu_torch.ops.forces import compute_eam_forces

    text = physics_text().replace("do_maxwell 1", "do_maxwell 0") \
        + OUTPUT_TAGS
    sim, state, launches, phases, wall = resume(tmp, text,
                                                "physics restart")
    c = sim.counters
    check(state.step == ABL_START + PHYS_STEPS
          and c.steps == ABL_START + PHYS_STEPS - PHYS_RESTART_AT,
          f"physics restart: {c.steps} steps to {state.step}")
    g, cs, vs = state.ttm_grid, state.cstate, state.vstate
    check(all(bool(torch.isfinite(a).all()) for a in (
        g.temp, g.U, cs.c, vs.te, state.scene.pos, state.scene.mom)),
        "physics restart: finite state")
    restored = restored_vs_written(sim, tmp, snap)
    dev = deviations(straight, state, torch.as_tensor(
        film_ids, device="cuda").long(), sim.ttm_params)
    print(f"physics restart vs phase 9 at step {state.step}: {dev} "
          f"(limits {RESTART_TOL})")
    check(dev["pos_max_A"] <= RESTART_TOL["pos_A"]
          and dev["temp_rel"] <= RESTART_TOL["temp_rel"]
          and dev["md_temp_rel"] <= RESTART_TOL["md_temp_rel"]
          and dev["pops_of_total"] <= RESTART_TOL["pops_of_total"],
          "physics restart: the deviations from the straight run")
    n = state.step // 5
    files = {ext: tmp / f"ablation1m.{n}.{ext}"
             for ext in ("dist", "ppm", "wf", "stress", "nb")}
    check(all(f.exists() for f in files.values()),
          f"physics restart: the outputs {sorted(files)}")
    writers_s = {k: sim.timers.get(f"write_{k}")
                 for k in ("dist", "ppm", "wf", "stress", "nb")}
    sizes = {k: f.stat().st_size for k, f in files.items()}
    body = files["stress"].read_bytes().split(b"#E\n", 1)[1]
    stress = np.fromstring(body.decode(), sep=" ").reshape(-1, 12)[:, 6:]
    n_atoms = int(state.scene.mask.sum())
    check(stress.shape == (n_atoms, 6), "physics restart: .stress rows")
    # the oracle in float64 on the run's float32 state: what is left is
    # K5's own float32 rounding
    scene = state.scene
    scene64 = scene.replace(pos=scene.pos.double(), mom=scene.mom.double(),
                            force=scene.force.double(),
                            epot=scene.epot.double(),
                            mass=scene.mass.double())
    t0 = time.perf_counter()
    fit = compute_eam_forces(scene64, sim.eam_run.at_host_precision(),
                             per_atom_stress=True)
    pt = fit.presstens_atom
    pt_sum = pt.sum(dim=(0, 1, 2, 3)).cpu().numpy()
    terms = pt.abs().sum(dim=(0, 1, 2, 3)).cpu().numpy()
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    del fit, pt, scene64
    torch.cuda.empty_cache()
    k5 = np.asarray(state.presstens)
    scale = float(np.abs(k5).max())
    stress_vs_k5 = float(np.abs(pt_sum - k5).max() / scale)
    stress_vs_k5_terms = float((np.abs(pt_sum - k5) / terms).max())
    file_vs_k5 = float(np.abs(stress.sum(0) - k5).max() / scale)
    print(f"per-atom stress summed over {n_atoms} atoms against K5's "
          f"presstens at step {state.step}: the fit {stress_vs_k5:.3e} of "
          f"its largest component ({stress_vs_k5_terms:.3e} of the summed "
          f"|terms|), the .stress file (tables) {file_vs_k5:.3e}")
    check(stress_vs_k5 <= STRESS_TOL, "the per-atom stress on the fit "
          "sums to K5's pressure tensor")
    main_s = sim.timers.get("main")
    report = {
        "config": "phase 9's set at step 290 resumed to 295 (-r 1, "
                  "do_maxwell 0) with .dist/.ppm/.wf/.stress/.nb at 295, "
                  "float32",
        "atoms": n_atoms, "steps_run": c.steps,
        "load_s": sim.setup_seconds + sim.setup_parts["ttm_restore"],
        "setup_s": sim.setup_seconds, "setup_parts_s": sim.setup_parts,
        "main_loop_s": main_s, "ms_per_step": 1e3 * main_s / c.steps,
        "wall_s": wall,
        "phase_ms_per_step": {k: v / c.steps for k, v in phases.items()},
        "restored": restored, "deviations": dev, "limits": RESTART_TOL,
        "writers_s": writers_s, "output_bytes": sizes,
        "stress_oracle_s": oracle_s, "stress_fit_vs_k5": stress_vs_k5,
        "stress_fit_vs_k5_of_terms": stress_vs_k5_terms,
        "stress_file_tables_vs_k5": file_vs_k5, "launches": launches,
        "device": dev_name, "nvidia_smi": smi}
    print(json.dumps({"restart_physics": report}))
    return report


def run_restart_fdtd(dev_name: str, smi: str, tmp: Path, straight,
                     snap: dict):
    """Phase 11 on phase 10's set: ``-r 1`` on phase 10's file with
    ``do_maxwell 0``, step 2 -> 4; the restored state, the launches, a
    finite state, and the FDTD fields and T_e against phase 10's step 4
    (RESTART_TOL)."""
    import torch

    text = fdtd_text(FDTD_STEPS, FDTD_RESTART_AT).replace("do_maxwell 1",
                                                          "do_maxwell 0")
    sim, state, launches, phases, wall = resume(tmp, text, "FDTD restart")
    c = sim.counters
    check(state.step == FDTD_STEPS
          and c.steps == FDTD_STEPS - FDTD_RESTART_AT,
          f"FDTD restart: {c.steps} steps to {state.step}")
    fs = state.fdtd
    check(all(bool(torch.isfinite(a).all()) for a in (
        state.ttm_grid.temp, fs.ezx, fs.hy, fs.source, state.scene.pos)),
        "FDTD restart: finite state")
    restored = restored_vs_written(sim, tmp, snap)
    ids = straight.scene.id[straight.scene.mask].long()
    dev = deviations(straight, state, ids, sim.ttm_params)
    for k in ("ezx", "hy", "jzx", "source"):
        a, b = getattr(straight.fdtd, k).double(), getattr(fs, k).double()
        dev[f"{k}_of_max"] = float((b - a).abs().max()
                                   / a.abs().max().clamp(min=1e-300))
    print(f"FDTD restart vs phase 10 at step {state.step}: {dev} (limits "
          f"{RESTART_TOL})")
    check(dev["pos_max_A"] <= RESTART_TOL["pos_A"]
          and dev["temp_rel"] <= RESTART_TOL["temp_rel"]
          and dev["md_temp_rel"] <= RESTART_TOL["md_temp_rel"]
          and all(dev[f"{k}_of_max"] <= RESTART_TOL["fields_of_max"]
                  for k in ("ezx", "hy", "jzx", "source")),
          "FDTD restart: the deviations from the straight run")
    main_s = sim.timers.get("main")
    report = {
        "config": "phase 10's set at step 2 resumed to 4 (-r 1, "
                  "do_maxwell 0), float32",
        "atoms": int(state.scene.mask.sum()), "steps_run": c.steps,
        "load_s": sim.setup_seconds + sim.setup_parts["ttm_restore"],
        "setup_s": sim.setup_seconds, "main_loop_s": main_s,
        "ms_per_step": 1e3 * main_s / c.steps, "wall_s": wall,
        "phase_ms_per_step": {k: v / c.steps for k, v in phases.items()},
        "restored": restored, "deviations": dev, "limits": RESTART_TOL,
        "launches": launches, "device": dev_name, "nvidia_smi": smi}
    print(json.dumps({"restart_fdtd": report}))
    return report


EOS_STEPS = 2       # phase 8's file with eos_dir, steps 285 -> 287
# make_ttm_fixture's grids (tools/refbuild/make_ttm_fixture.py:59-71)
EOS_RHO = (300.0, 8000.0, 150)
EOS_TE_K = ((20.0, 2000.0, 250), (2100.0, 5.8e4, 300))


def write_eos_tables(out: Path, atomic_mass: float, z: float = 3.0):
    """EOS_cve_from_r_te.txt and EOS_ee_from_r_tesqrt.txt in the
    reference's nn format (the header's bounds one grid line inside the
    data) from the port's FEGEos at n_e = z rho / m_atom, float64 on the
    host, as tools/refbuild/make_ttm_fixture.py:56-110 writes them."""
    import numpy as np
    import torch

    from imd_tpu_torch import units
    from imd_tpu_torch.models import widerange as wr
    from imd_tpu_torch.models.eos import FEGEos

    eos = FEGEos(atomic_mass=atomic_mass)
    m_kg = atomic_mass * wr.AMU
    rho = np.linspace(*EOS_RHO)
    te_k = np.concatenate([np.linspace(*a) for a in EOS_TE_K])

    def table(path, xs, ys, zfun):
        R, Y = np.meshgrid(xs, ys, indexing="ij")
        zs = zfun(torch.as_tensor(R), torch.as_tensor(Y)).numpy()
        x0 = xs[1] + 0.37 * (xs[2] - xs[1])
        x1 = xs[-2] - 0.37 * (xs[-2] - xs[-3])
        y0 = ys[1] + 0.37 * (ys[2] - ys[1])
        y1 = ys[-2] - 0.37 * (ys[-2] - ys[-3])
        body = np.column_stack([R.ravel(), Y.ravel(), zs.ravel()])
        with open(path, "w") as f:
            f.write(f"{len(xs)} {len(ys)}\n")
            f.write(f"{x0:.10e} {x1:.10e} {y0:.10e} {y1:.10e}\n")
            np.savetxt(f, body, fmt="%.10e")

    def cve(r, tk):
        ce = eos.ce(r, z * r / m_kg, tk / wr.EV_TO_K)
        return ce / (r * wr.EV_TO_K * 1e-30 * units.J_TO_EV)

    def ee(r, ts):
        u = eos.u_from_te(r, z * r / m_kg, ts * ts / wr.EV_TO_K)
        return u * units.EV_TO_J / m_kg
    table(out / "EOS_cve_from_r_te.txt", rho, te_k, cve)
    table(out / "EOS_ee_from_r_tesqrt.txt", rho, np.sqrt(te_k), ee)


@dataclasses.dataclass(frozen=True)
class SampledFEG:
    """The function write_eos_tables samples: the FEG EOS at n_e = z rho /
    m_atom whatever n_e the caller has (the electron pressure keeps it, as
    TabulatedEOS.pe does)."""
    feg: object
    z: float
    m_kg: float

    def _ne(self, dens):
        return self.z * dens / self.m_kg

    def ce(self, dens, ne, te):
        return self.feg.ce(dens, self._ne(dens), te)

    def u_from_te(self, dens, ne, te):
        return self.feg.u_from_te(dens, self._ne(dens), te)

    def te_from_u(self, dens, ne, u):
        return self.feg.te_from_u(dens, self._ne(dens), u)

    def pe(self, dens, ne, te):
        return self.feg.pe(dens, ne, te)


def run_eos(dev_name: str, smi: str):
    """Phase 11's tabulated EOS: the tables (write_eos_tables) under an
    ``eos_dir``, EOS_STEPS steps of phase 8's file with it through
    ``cli.main`` in float32 (launches as phase 8's); a finite state; on
    the last grid's active cells te_from_u(u_from_te(T)) within the
    bisection's resolution; the tables' own interpolation error against
    the function they sample (SampledFEG: ce and u at those cells' density
    and T_e); one calc_ttm with the tables against one with SampledFEG on
    the last state, T_e and U of the active cells held to 10 x that
    interpolation error; and the time of one calc_ttm with the tables and
    with the run's default FEG EOS."""
    import numpy as np
    import torch

    from imd_tpu_torch.models import ttm as t_ttm
    from imd_tpu_torch.models import widerange as wr
    from imd_tpu_torch.models.eos import FEGEos, TabulatedEOS
    from imd_tpu_torch.ops import forces_win as win
    from imd_tpu_torch.ops.fused_step import scene_to_cl

    with tempfile.TemporaryDirectory(prefix="imd_eos_") as tmp:
        tmp = Path(tmp)
        ablation_start(tmp)
        (tmp / "eos").mkdir()
        t0 = time.perf_counter()
        write_eos_tables(tmp / "eos", 26.9815)
        write_s = time.perf_counter() - t0
        (tmp / "eos.imd").write_text(ablation_text(steps=EOS_STEPS)
                                     + "eos_dir eos\n")
        sim, state, launches, phases, wall = drive(tmp / "eos.imd",
                                                   "EOS run")
    feg = FEGEos(atomic_mass=sim.cfg.ttm.atomic_mass)
    eos = sim.eos
    sampled = SampledFEG(feg, 3.0, sim.cfg.ttm.atomic_mass * wr.AMU)
    check(isinstance(eos, TabulatedEOS) and eos.ee.shape == (128, 128),
          "EOS run: the tabulated EOS")
    g, tp = state.ttm_grid, sim.ttm_params
    check(bool(torch.isfinite(g.temp).all()) and bool(torch.isfinite(
        state.scene.pos).all()), "EOS run: finite state")
    act = t_ttm.active_mask(g, tp)
    dens, temp = g.dens[act], g.temp[act]
    ne = 3.0 * dens / (tp.atomic_mass * wr.AMU)
    u = eos.u_from_te(dens, ne, temp)
    back = eos.te_from_u(dens, ne, u)
    # sqrt(T) bisected over the table's span 40 times: T's resolution is
    # 2 sqrt(T) span 2^-40 (float32 stops at its own ulp first)
    span = float(eos.tsq_grid[-1] - eos.tsq_grid[0])
    res = (2.0 * torch.sqrt(temp.double() * wr.EV_TO_K) * span
           * 2.0 ** -40 / wr.EV_TO_K)
    ulp = temp.double() * 2.0 ** -23
    rt = float(((back.double() - temp.double()).abs()
                / (4.0 * res + 8.0 * ulp)).max())
    interp = {k: float(((getattr(eos, k)(dens, ne, temp).double()
                         - getattr(sampled, k)(dens, ne, temp).double())
                        .abs() / getattr(sampled, k)(dens, ne, temp)
                        .double().abs()).max()) for k in ("ce", "u_from_te")}
    cl = scene_to_cl(state.scene)
    _, nn = win.eam_rho(cl.xi, cl.alive, sim.eam_run, sim.grid)
    x = cl.xi[:, 0, :].reshape(-1)
    atoms = (x, tuple(cl.mom[:, c, :].reshape(-1) for c in range(3)),
             cl.mass.reshape(-1), cl.alive.reshape(-1))
    fdi = torch.full((x.numel(),), -1, dtype=torch.int32, device="cuda")
    dt = sim.cfg.timestep
    t = torch.full((), (state.step - 1) * dt, dtype=x.dtype, device="cuda")

    def calc(e):
        return t_ttm.calc_ttm(g, atoms, tp, e, nn.reshape(-1), fdi, dt, t,
                              tmm_params=sim.tmm_params)[0]
    ga, gb = calc(eos), calc(sampled)
    ttm_dev = {k: float(((getattr(ga, k) - getattr(gb, k)).double().abs()
                         / getattr(gb, k).double().abs().clamp(min=1e-30))
                        [act].max()) for k in ("temp", "U")}
    ms = {"tabulated": time_ms(lambda: calc(eos), 3),
          "feg": time_ms(lambda: calc(feg), 3)}
    limit = 10.0 * max(interp.values())
    report = {
        "config": f"phase 8's file with eos_dir (FEG tables {EOS_RHO[2]} x "
                  f"{sum(a[2] for a in EOS_TE_K)}, resampled 128 x 128), "
                  f"{EOS_STEPS} steps from step 285, float32",
        "tables_write_s": write_s, "load_s": sim.setup_seconds,
        "ms_per_step": 1e3 * sim.timers.get("main") / sim.counters.steps,
        "wall_s": wall, "active_cells": int(act.sum()),
        "roundtrip_of_resolution": rt, "interp_rel": interp,
        "calc_ttm_tab_vs_feg_rel": ttm_dev, "calc_ttm_limit": limit,
        "calc_ttm_ms": ms, "launches": launches, "device": dev_name,
        "nvidia_smi": smi}
    print(json.dumps({"eos": report}))
    check(rt <= 1.0, "EOS: te_from_u(u_from_te(T)) within the bisection's "
          "resolution")
    check(max(ttm_dev.values()) <= limit, "EOS: calc_ttm with the tables "
          "against the FEG EOS within 10 x the tables' interpolation error")
    return report


LJ_STEPS = 63
LJ_CELLS = 63       # fcc cells per axis: 4 * 63^3 = 1,000,188 atoms
# examples/melt_quench's LJ physics (IMD's LJ, eps 0.35 eV, sigma 2.62 A,
# cut 5.0 A, Al masses, 1 fs steps, the melt's 0.2 eV start) on the
# flagship's fcc box of {cells}^3 cells under ensemble nve.  startstep 17
# makes the first block the 3 warm-up steps (blocks end on multiples of
# eng_int), then 3 timed blocks of 20.  The skin is 0.05 A: from 0.2 eV the
# degree-12 LJ fit's stiff wells keep the atoms within a few hundredths of
# an angstrom of their sites, so the default 0.4 A skin (a 0.2 A trigger)
# never rebins; a 0.025 A trigger does, and the grid stays imd_tpu's (42^3,
# capacity 16).
LJ_PARAMS = """coordname _fcc
box_param {cells} {cells} {cells}
box_unit 4.05
ntypes 1
masses 26.9815
outfiles lj
lj_epsilon 0.35
lj_sigma 2.62
r_cut 5.0
timestep 0.1
ensemble nve
starttemp 0.2
nbl_margin 0.05
startstep 17
maxsteps 80
eng_int 20
checkpt_int 80
"""
# the float64 reference of the energy check: the same file on 16^3 cells
LJ_REF_CELLS = 16


def lj_energy_spread(eng):
    """Largest minus smallest total energy per atom (epot + 3/2 T) over the
    .eng lines of the three timed blocks (the first line ends the warm-up,
    inside the leapfrog's start-up transient)."""
    etot = eng[1:, 1] + 1.5 * eng[1:, 2]
    return float(etot.max() - etot.min())


def run_lj(args, cells: int, timer=None):
    """``python -m imd_tpu_torch -p`` in process on LJ_PARAMS; returns the
    run's Simulation, last state and .eng."""
    import numpy as np

    from imd_tpu_torch import __main__ as cli
    with tempfile.TemporaryDirectory(prefix="imd_lj_") as tmp:
        par = Path(tmp) / "lj.imd"
        par.write_text(LJ_PARAMS.format(cells=cells))
        runs = []
        rc = cli.main(["-p", str(par), *args], timer=timer,
                      on_phase=lambda sim, st: runs.append((sim, st)))
        check(rc == 0 and len(runs) == 1, "LJ driver run")
        for name in ("lj.00001.chkpt", "lj.00001.itr", "lj-final.chkpt"):
            check((Path(tmp) / name).stat().st_size > 0, f"{name} written")
        eng = np.loadtxt(Path(tmp) / "lj.eng", ndmin=2)
    return runs[0][0], runs[0][1], eng


def run_lj_driver(dev_name: str, smi: str):
    """Phase 7: the general pair step through the driver at full width
    (63^3 fcc cells, 1,000,188 atoms), counters and launch counts set to 0
    just before.  K12 must launch once per step, the skin check must have
    rebinned, no atom may be lost, the energy spread must stay within
    twice the float64 reference's, and K12 must match its plain version on
    the last state.  Prints the ``driver_lj`` line and returns it."""
    import numpy as np
    import torch

    from imd_tpu_torch import kernels
    from imd_tpu_torch.ops import forces_pallas as b4
    from imd_tpu_torch.phases import CudaPhaseTimer

    timer = CudaPhaseTimer()
    # the capacity of each of K12's launches: the general step calls the
    # wrapper through the module, so a pass-through here sees every call
    # (the wrapper's own count stays the launch count)
    by_cap = {}
    wrapper = b4.pair_half

    def counted(xi, *args, **kw):
        by_cap[xi.shape[0]] = by_cap.get(xi.shape[0], 0) + 1
        return wrapper(xi, *args, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    b4.pair_half = counted
    t0 = time.perf_counter()
    try:
        sim, state, eng = run_lj([], LJ_CELLS, timer)
    finally:
        b4.pair_half = wrapper
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check(sum(by_cap.values()) == launches["pair_half"],
          f"K12 calls by capacity {by_cap} against its launches")
    peak = torch.cuda.max_memory_allocated()
    phases = timer.totals_ms()
    n_atoms = 4 * LJ_CELLS ** 3
    # one launch a step (a block retried after a capacity growth runs its
    # steps again: counters.steps counts every step run)
    steps_run = sim.counters.steps
    check(steps_run >= LJ_STEPS and launches["pair_half"] == steps_run,
          f"K12 launched {launches['pair_half']} times in {steps_run} steps")
    others = {k: v for k, v in launches.items() if k != "pair_half" and v}
    check(not others, f"other kernels launched on the pair path: {others}")
    check(sim.nbl_count >= 1,
          f"the pair path must rebin (skin check): {sim.nbl_count} rebins")
    live = state.scene.mask
    ids = torch.sort(state.scene.id[live]).values.cpu()
    check(len(ids) == n_atoms and torch.equal(
        ids, torch.arange(n_atoms, dtype=ids.dtype)) and int(
        state.scene.overflow) == 0, "LJ driver: no atom lost")
    blocks = sim.block_seconds
    check([b for b, _ in blocks] == [3, 20, 20, 20],
          f"LJ driver blocks {[b for b, _ in blocks]}")
    walls = [w for _, w in blocks[1:]]
    med = statistics.median(walls)
    check(eng.shape == (4, 5) and bool(np.isfinite(eng).all()),
          f"LJ .eng shape {eng.shape}, finite")
    # the energy check: leapfrog at dt = 0.1 on the degree-12 fit (stiffer
    # than the table: 5x its force at the nearest neighbour) makes the total
    # energy fluctuate by ~1e-2 eV per atom; float32 rounding adds ~1e-6
    # (positions of ~250 A round to 1.5e-5 A, times forces of ~5 eV/A, a
    # random walk over 1M atoms and 60 steps).  The bound is twice the
    # spread of the same file in float64 on 16^3 cells (the CPU, plain
    # versions), whose synchronized start oscillates as coherently and
    # whose random part is larger at 64x fewer atoms, plus 1e-5.
    t1 = time.perf_counter()
    _, _, eng_ref = run_lj(["--device", "cpu", "--dtype", "float64"],
                           LJ_REF_CELLS)
    ref_s = time.perf_counter() - t1
    spread = lj_energy_spread(eng)
    ref_spread = lj_energy_spread(eng_ref)
    bound = 2.0 * ref_spread + 1e-5
    print(f"LJ driver: total energy per atom over the timed .eng lines "
          f"spreads {spread:.3e} eV (float64 reference on "
          f"{4 * LJ_REF_CELLS ** 3} atoms {ref_spread:.3e}; bound "
          f"{bound:.3e})")
    check(spread <= bound, "LJ driver energy spread")
    # K12 against its plain version on the last state (not counted)
    xi, nbr, mask = b4.prep_neighbors(state.scene)
    out_k = b4.pair_half(xi, nbr, sim.pair_run, sim.grid, True)
    out_p = b4.pair_half_plain(xi, nbr, sim.pair_run, sim.grid, True)
    last = pair_errors(out_k, out_p, mask, sim.grid.dims)
    print(f"K12 on the LJ driver's last state: {last}")
    check(last["flips"] == 0 and last["F"] <= 1e-4 and last["e"] <= 1e-5
          and last["S"] <= 1e-4 and last["presstens"] <= 1e-4,
          "K12 against its plain version on the LJ driver's last state")
    again = b4.pair_half(xi, nbr, sim.pair_run, sim.grid, True)
    check(all(a is None and b is None or torch.equal(a, b)
              for a, b in zip(out_k, again)),
          "K12 gives the same bits twice on the LJ driver's last state")
    # K12 timed there as the general step calls it (energy and stress),
    # beside its plain version and its bound from this state's inputs
    nn = b4._assemble(sim.grid.dims, out_p[0][4], out_p[2][4])
    pairs = float(nn[mask].double().sum()) / 2.0
    cap = sim.grid.capacity
    last_state = {
        "capacity": cap, "pairs": pairs,
        "ms": time_ms(lambda: b4.pair_half(xi, nbr, sim.pair_run,
                                           sim.grid), 10),
        "plain_ms": time_ms(lambda: b4.pair_half_plain(
            xi, nbr, sim.pair_run, sim.grid), 2),
        **roofline(FLOPS_PER_PAIR["pair_half"] * pairs,
                   half_bytes("pair_half", xi, nbr)),
        "tile": half_shape(cap, "pair_energy")}
    last_state["share"] = last_state["bound_ms"] / last_state["ms"]
    print(f"K12 on the LJ driver's last state (cap {cap}): "
          f"{last_state['ms']:.4f} ms (plain {last_state['plain_ms']:.2f}, "
          f"bound {last_state['bound_ms']:.4f}, {last_state['bound_by']})")
    del out_k, out_p, again, nn, xi, nbr
    report = {
        "config": "examples/melt_quench LJ (eps 0.35, sigma 2.62, r_cut "
                  "5.0, fastpoly-12 fit) on fcc 63^3 Al, 1,000,188 atoms, "
                  "ensemble nve, 0.2 eV start, skin 0.05, float32, general "
                  "step (B6: 13 views + K12)",
        "atoms": n_atoms, "grid": list(sim.grid.dims),
        "capacity": sim.grid.capacity, "steps": LJ_STEPS,
        "setup_s": sim.setup_seconds, "wall_s": wall,
        "block_steps_s": blocks,
        "atom_steps_per_s": n_atoms * 20 / med,
        "spread_pct": 100.0 * (max(walls) - min(walls)) / med,
        "phase_ms_per_step": {k: v / steps_run for k, v in phases.items()},
        "phase_calls": timer.counts(),
        "step_counts": dataclasses.asdict(sim.counters),
        "skin_rebins": sim.nbl_count,
        "rebins_per_step": sim.counters.rebins / steps_run,
        "host_syncs_per_step": sim.counters.host_syncs / steps_run,
        "launches": launches, "k12_launches_by_capacity": by_cap,
        "k12_last_state": last_state,
        "max_memory_allocated_bytes": peak,
        "eng": eng.tolist(), "energy_spread_eV": spread,
        "float64_reference_spread_eV": ref_spread,
        "float64_reference_s": ref_s, "energy_bound_eV": bound,
        "k12_vs_plain_last_state": last,
        "device": dev_name, "nvidia_smi": smi}
    print(json.dumps({"driver_lj": report}))
    return report


# ---- phase 12: the general step's ensembles --------------------------------
# examples/melt_quench/melt_quench.imd as written but for these tags: the
# flagship's 63^3 fcc cells (1,000,188 atoms, phase 7's size), the phases
# ending at steps 60 / 120 / 200, .eng every 20 steps
MQ_TAGS = (("box_param 6 6 6", "box_param {cells} {cells} {cells}"),
           ("eng_int 25", "eng_int 20"), ("maxsteps 1000", "maxsteps 60"),
           ("maxsteps 2000", "maxsteps 120"),
           ("maxsteps 3000", "maxsteps 200"))
MQ_STEPS = (60, 60, 80)
# the float32-against-float64 copy: 10^3 cells from one .chkpt start with
# NumPy velocities of 0.2 eV (do_maxwell 0: torch draws Maxwell momenta
# in the run's dtype, so the two dtypes would start apart)
MQ_REF_CELLS = 10
# the phase of each of the copy's .eng lines (steps 20, 40, ..., 200)
MQ_LINES = ("nvt",) * 3 + ("ber",) * 3 + ("glok",) * 4
# The limits of that comparison, one set per .eng line: Epot (eV per atom)
# and pressure absolute, temperature and eta*tau_eta relative.  The two
# dtypes start from the same state and part as the liquid amplifies
# float32's rounding: on an H100 the temperature agreed to 8.7e-7 at step
# 20, 5.5e-6 at 40 and 1.4e-4 at 60, and the glok phase, which heats the
# quenched liquid, took the gap to 1e-2 by step 200.  Epot and pressure
# also carry a constant ~4.5e-4 and ~5.4e-4 from the LJ table sampled and
# fitted in float32.  Each limit sits about 5-50x above that sound reading
# (2-3x above the constant for Epot and pressure) and below what planted
# faults read in a float64 copy against the sound float64 run: eta not
# carried (eta*tau_eta 1.0, temperature 2.0e-4 / 8.5e-4 / 2.0e-3 at steps
# 20 / 40 / 60), ber reading Ekin 0 (temperature 8.0e-2 at step 80),
# FIRE's MIX steering lost (temperature 0.29 at step 140, 0.83 at 200).
_NVT = {"Epot": 1e-3, "pressure": 1.5e-3, "eta*tau_eta": 1e-4}
_BER = {"Epot": 1e-3, "temperature": 3e-3, "pressure": 1.5e-3}
MQ_LIMITS = (
    dict(_NVT, temperature=1e-5), dict(_NVT, temperature=5e-5),
    dict(_NVT, temperature=7e-4), _BER, _BER, _BER,
    {"Epot": 2e-3, "temperature": 5e-3, "pressure": 5e-3},
    {"Epot": 5e-3, "temperature": 3e-2, "pressure": 2e-2},
    {"Epot": 2e-2, "temperature": 5e-2, "pressure": 6e-2},
    {"Epot": 8e-2, "temperature": 1e-1, "pressure": 0.4})
# the EAM paths: nvt at the flagship's 0.026 eV on the general step (K4/K5),
# nve back on the fused loop (K1/K2); two species (L1_2, the tables scaled
# by SCALES2) under ber (K8/K9)
EAM_GEN = """coordname {coord}
box_param {cells} {cells} {cells}
box_unit 4.05
ntypes {nt}
masses {masses}
outfiles {out}
core_potential_file pair.pt
embedding_energy_file embed.pt
el_density_file rho.pt
timestep 0.1
eng_int 10
"""
EAM_NVT_STEPS, EAM_NVE_STEPS, EAM_BER_STEPS = 40, 10, 20
EAM_NVT = f"""ensemble nvt
starttemp 0.026
tau_eta 20.0
maxsteps {EAM_NVT_STEPS}

simulation 2
ensemble nve
maxsteps {EAM_NVT_STEPS + EAM_NVE_STEPS}
"""
EAM_BER = f"""ensemble ber
starttemp 0.026
tau_berendsen 20.0
maxsteps {EAM_BER_STEPS}
"""


def melt_quench_text(cells: int, start: str = "") -> str:
    """examples/melt_quench as written with MQ_TAGS at ``cells`` fcc cells
    per axis; with ``start`` a .chkpt start without Maxwell momenta."""
    text = (REPO / "examples" / "melt_quench" / "melt_quench.imd").read_text()
    for old, new in MQ_TAGS:
        check(text.count(old) == 1, f"melt_quench.imd holds {old!r} once")
        text = text.replace(old, new.format(cells=cells))
    if start:
        check("coordname _fcc" in text, "melt_quench.imd generates fcc")
        text = text.replace("coordname _fcc",
                            f"coordname {start}\ndo_maxwell 0")
    return text


def eng_rows(path: Path):
    """The .eng's column names and rows (rows of later phases may be
    narrower: the nvt column belongs to the file's first phase)."""
    import numpy as np
    lines = path.read_text().splitlines()
    return (lines[0].lstrip("# ").split(),
            [np.array(line.split(), float) for line in lines[1:]])


def per_step(run, n_atoms: int, skip_first: bool = True) -> dict:
    """ms a step and atom-steps/s over a phase's blocks (the first one,
    with its warm-up, left out where there are more), host syncs and
    rebins a step."""
    sim, phase_ms = run[0], run[3]
    blocks = sim.block_seconds[1:] if skip_first and \
        len(sim.block_seconds) > 1 else sim.block_seconds
    steps = sum(b for b, _ in blocks)
    secs = sum(w for _, w in blocks)
    c = sim.counters
    return {"ms_per_step": 1e3 * secs / steps,
            "atom_steps_per_s": n_atoms * steps / secs,
            "grid": list(sim.grid.dims), "capacity": sim.grid.capacity,
            "phase_ms_per_step": {k: v / max(c.steps, 1)
                                  for k, v in phase_ms.items()},
            "timed_steps": steps, "blocks": sim.block_seconds,
            "host_syncs_per_step": c.host_syncs / max(c.steps, 1),
            "rebins_per_step": c.rebins / max(c.steps, 1),
            "steps_run": c.steps}


def run_phases(par: Path, *args, timer=None):
    """``python -m imd_tpu_torch -p par`` in process; returns each phase's
    (Simulation, last state, launches at its end, the ms of its step's
    phases by ``timer``, a CudaPhaseTimer, or {})."""
    from imd_tpu_torch import __main__ as cli
    from imd_tpu_torch import kernels
    runs = []

    def on_phase(sim, st):
        ms = {}
        if timer is not None:
            ms = timer.totals_ms()
            timer.reset()
        runs.append((sim, st, dict(kernels.LAUNCHES), ms))

    rc = cli.main(["-p", str(par), *args], on_phase=on_phase, timer=timer)
    check(rc == 0, f"{par.name}: rc {rc}")
    return runs


def write_mq_start(tmp: Path) -> None:
    """The 10^3-cell copy's start: ``start.chkpt`` in ``tmp``, fcc Al with
    NumPy velocities of 0.2 eV (seed 12)."""
    import numpy as np

    from imd_tpu_torch.io.chkpt import ChkptData, write_chkpt
    from imd_tpu_torch.utils.generate import fcc

    pos, _, diag = fcc((MQ_REF_CELLS,) * 3, 4.05)
    n = len(pos)
    vel = np.random.default_rng(12).normal(size=pos.shape) \
        * np.sqrt(0.2 / 26.9815)
    vel -= vel.mean(0)
    write_chkpt(str(tmp / "start.chkpt"), ChkptData(
        number=np.arange(n), type=np.zeros(n, int), mass=np.full(n, 26.9815),
        pos=pos, vel=vel, data=np.zeros((n, 1)),
        box_x=np.array([diag[0], 0, 0]), box_y=np.array([0, diag[1], 0]),
        box_z=np.array([0, 0, diag[2]])), binary=True, double=True)


def run_mq_copy(tmp: Path, name: str, *args):
    """The 10^3-cell copy of melt_quench from ``tmp``'s start.chkpt in
    ``tmp/name`` with the driver's ``args``: ((columns, .eng rows),
    seconds)."""
    sub = tmp / name
    sub.mkdir()
    (sub / "start.chkpt").write_bytes((tmp / "start.chkpt").read_bytes())
    (sub / "mq.imd").write_text(melt_quench_text(MQ_REF_CELLS,
                                                 "start.chkpt"))
    t1 = time.perf_counter()
    run_phases(sub / "mq.imd", *args)
    return eng_rows(sub / "melt_quench.eng"), time.perf_counter() - t1


def compare_mq(cols, r32, r64, limits=MQ_LIMITS, lines=MQ_LINES):
    """The 10^3 copies' .eng lines against each other under ``limits``
    (MQ_LIMITS; phase 13's BIN_LIMITS), one set per line of the phases
    ``lines``: (the worst reading per phase and column, each line's
    readings, the readings beyond their limits).  Temperature and
    eta*tau_eta are relative, Epot (eV per atom) and pressure absolute."""
    check(len(r32) == len(r64) == len(limits),
          "the 10^3 copies' .eng lines")
    worst, diffs, bad = {}, [], []
    for k, (a, b) in enumerate(zip(r32, r64)):
        ens, row = lines[k], {}
        for c, name in enumerate(cols[:len(a)]):
            lim = limits[k].get(name)
            if lim is None:
                continue
            d = abs(a[c] - b[c])
            if name in ("temperature", "eta*tau_eta"):
                d /= abs(b[c])
            row[name] = d
            key = f"{ens} {name}"
            worst[key] = max(worst.get(key, 0.0), d)
            if not d <= lim:
                bad.append(f"line {k} ({ens}) {name}: {a[c]:.9e} against "
                           f"{b[c]:.9e} (limit {lim})")
        diffs.append(row)
    return worst, diffs, bad


def run_melt_quench(tmp: Path, smi: str) -> dict:
    """Phase 12a: melt_quench through the driver at 1,000,188 atoms, then
    its 10^3-cell copy in float32 on the card against float64 (the plain
    versions on the host: the kernels take float32 only)."""
    import numpy as np
    import torch

    from imd_tpu_torch import kernels
    from imd_tpu_torch.phases import CudaPhaseTimer

    cells = LJ_CELLS
    n_atoms = 4 * cells ** 3
    par = tmp / "mq.imd"
    par.write_text(melt_quench_text(cells))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    runs = run_phases(par, timer=CudaPhaseTimer())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    sims = [r[0] for r in runs]
    check([s.ensemble for s in sims] == ["nvt", "ber", "glok"]
          and [s.step_count for s in sims] == [60, 120, 200],
          f"melt_quench phases {[(s.ensemble, s.step_count) for s in sims]}")
    steps_run = sum(s.counters.steps for s in sims)
    check(steps_run >= sum(MQ_STEPS) and launches["pair_half"] == steps_run,
          f"melt_quench: K12 launched {launches['pair_half']} times in "
          f"{steps_run} steps")
    others = {k: v for k, v in launches.items() if k != "pair_half" and v}
    check(not others, f"other kernels launched on melt_quench: {others}")
    state = runs[-1][1]
    live = state.scene.mask
    ids = torch.sort(state.scene.id[live]).values.cpu()
    check(len(ids) == n_atoms and torch.equal(
        ids, torch.arange(n_atoms, dtype=ids.dtype))
        and int(state.scene.overflow) == 0, "melt_quench: no atom lost")
    cols, rows = eng_rows(tmp / "melt_quench.eng")
    check(cols[-1] == "eta*tau_eta" and [len(r) for r in rows]
          == [6] * 3 + [5] * 7 and all(np.isfinite(r).all() for r in rows),
          f"melt_quench .eng: columns {cols}, widths {[len(r) for r in rows]}")
    check(all(r[5] != 0.0 for r in rows[:3]),
          "melt_quench .eng: eta*tau_eta is non-zero in phase 1")
    # the ramp's target at the last step of each block of phase 2:
    # starttemp + (endtemp - starttemp) * step / maxsteps over the ABSOLUTE
    # step (ROADMAP C8)
    ber = sims[1]
    ends = sims[0].step_count + np.cumsum([b for b, _ in ber.block_seconds])
    ramp = [[int(e), ber._ramp_temperature(int(e) - 1)] for e in ends]
    check([e for e, _ in ramp] == [80, 100, 120],
          f"melt_quench ber block ends {[e for e, _ in ramp]}")
    for gstep, temp in ramp:
        want = 0.2 + (0.01 - 0.2) * (gstep - 1) / 120
        print(f"melt_quench ber block ending at step {gstep}: ramp target "
              f"{temp:.6f} eV")
        check(abs(temp - want) <= 1e-12, f"ramp target at step {gstep}")
    fire = sims[2].fire
    fire_report = {"timestep": float(fire.timestep), "mix": float(fire.mix),
                   "glok_int": int(fire.glok_int),
                   "uphill_events": int(fire.n_pxf),
                   "relaxed_at": sims[2].relaxed_at}
    print(f"melt_quench glok: FIRE timestep {fire_report['timestep']:.6f} "
          f"(start 0.1), {fire_report['uphill_events']} uphill events, mix "
          f"{fire_report['mix']:.6f}, {fire_report['glok_int']} steps since "
          f"the last reset, relaxed at {fire_report['relaxed_at']}")
    # FIRE's timestep shrinks on an uphill event and grows only after one
    # (min_n_pxf 1): with none, it must still be 0.1 and MIX must have
    # decayed once a step since the phase's start
    # (a float32 state: 0.1 to 1e-7)
    dt_moved = abs(fire_report["timestep"] - 0.1) > 1e-7
    if fire_report["uphill_events"]:
        check(dt_moved, "FIRE's timestep changed after its uphill events")
    else:
        check(not dt_moved
              and fire_report["glok_int"] == sims[2].counters.steps
              and abs(fire_report["mix"] - 0.1 * 0.99 **
                      fire_report["glok_int"]) <= 1e-6,
              "FIRE without an uphill event: timestep 0.1, MIX decayed "
              "once a step")
    paths = {r[0].ensemble: per_step(r, n_atoms) for r in runs}
    del runs, sims, state, ber
    torch.cuda.empty_cache()

    # the 10^3-cell copy, float32 on the card against float64 on the host
    write_mq_start(tmp)
    (cols, r32), s32 = run_mq_copy(tmp, "float32")
    (_, r64), s64 = run_mq_copy(tmp, "float64", "--device", "cpu",
                                "--dtype", "float64")
    worst, diffs, bad = compare_mq(cols, r32, r64)
    for k, row in enumerate(diffs):
        print(f"melt_quench 10^3 copy, .eng line {k} ({MQ_LINES[k]}), "
              "float32 on the card against float64 on the host: "
              + ", ".join(f"{n} {v:.3e}" for n, v in row.items()))
    check(not bad, f"10^3 copy beyond its limits: {bad}")
    return {"config": "examples/melt_quench/melt_quench.imd as written "
                      "(LJ eps 0.35, sigma 2.62, r_cut 5.0; nvt 0.2 eV "
                      "tau_eta 50, ber 0.2 -> 0.01 eV tau 20, glok) on "
                      "fcc 63^3 Al, 1,000,188 atoms, phases ending at "
                      "60/120/200, eng_int 20, float32, general step "
                      "(B6: 13 views + K12)",
            "atoms": n_atoms, "wall_s": wall, "paths": paths,
            "launches": launches, "fire": fire_report,
            "ramp_targets": ramp, "max_memory_allocated_bytes": peak,
            "f32_vs_f64_10cells": {"worst": worst, "lines": diffs,
                                   "limits": MQ_LIMITS,
                                   "float32_card_s": s32,
                                   "float64_host_s": s64},
            "nvidia_smi": smi}


def run_eam_general(tmp: Path, smi: str):
    """Phase 12b: the flagship's fcc Al 63^3 with the analytic EAM under
    nvt on the general step (K4/K5 once a step), then nve back on the
    fused loop (K1/K2 once a step), then two species (L1_2) under ber
    (K8/K9 once a step).  Returns the report and the last states of the
    nvt phase and of the two-species run (with their Simulations)."""
    import numpy as np
    import torch

    from imd_tpu_torch import flagship, kernels
    from imd_tpu_torch.models.potential import write_pot_table
    from imd_tpu_torch.phases import CudaPhaseTimer

    cells = LJ_CELLS
    n_atoms = 4 * cells ** 3
    out = {}
    for nt, body, coord in ((1, EAM_NVT, "_fcc"), (2, EAM_BER, "_l12")):
        d = tmp / f"eam{nt}"
        d.mkdir()
        tabs = flagship.eam_tables(nt, SCALES2 if nt > 1 else None,
                                   dtype=np.float64)
        for name in ("pair", "rho", "embed"):
            write_pot_table(getattr(tabs, name), str(d / f"{name}.pt"))
        (d / "eam.imd").write_text(EAM_GEN.format(
            coord=coord, cells=cells, nt=nt, out="eam",
            masses=" ".join(["26.9815"] * nt)) + body)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        runs = run_phases(d / "eam.imd", timer=CudaPhaseTimer())
        torch.cuda.synchronize()
        out[nt] = (runs, time.perf_counter() - t0,
                   torch.cuda.max_memory_allocated())
    (nvt_run, nve_run), wall1, peak1 = out[1]
    (ber_run,), wall2, peak2 = out[2]
    sim1, st1, l1, _ = nvt_run
    sim2, st2, l2, _ = nve_run
    sim3, st3, l3, _ = ber_run
    s1, s2, s3 = (s.counters.steps for s in (sim1, sim2, sim3))
    check(not sim1._fused_eligible() and sim2._fused_eligible()
          and not sim3._fused_eligible(),
          "EAM nvt and ber on the general step, nve on the fused loop")
    check(s1 >= EAM_NVT_STEPS and l1["eam_rho_e"] == s1
          and l1["eam_force_s"] == s1 and l1["eam_rho"] == 0
          and l1["eam_force"] == 0,
          f"EAM nvt: K4/K5 once a general step ({s1} steps): {l1}")
    n_obs = sim2.n_observe
    check(l2["eam_rho"] - l1["eam_rho"] == EAM_NVE_STEPS
          and l2["eam_force"] - l1["eam_force"] == EAM_NVE_STEPS
          and l2["eam_rho_e"] - l1["eam_rho_e"] == n_obs
          and l2["eam_force_s"] - l1["eam_force_s"] == n_obs,
          f"EAM nve after the handover: K1/K2 once a step, K4/K5 once an "
          f"observe ({n_obs}): {l2}")
    check(s3 >= EAM_BER_STEPS and l3["eam_rho_e_mt"] == s3
          and l3["eam_force_s_mt"] == s3 and l3["eam_rho_e"] == 0
          and l3["eam_rho_mt"] == 0,
          f"two-species ber: K8/K9 once a general step ({s3}): {l3}")
    for label, sim, st in (("nvt", sim1, st1), ("nve", sim2, st2),
                           ("ber", sim3, st3)):
        live = st.scene.mask
        ids = torch.sort(st.scene.id[live]).values.cpu()
        check(len(ids) == n_atoms and torch.equal(
            ids, torch.arange(n_atoms, dtype=ids.dtype)),
            f"EAM {label}: no atom lost")
    for d, nt in ((tmp / "eam1", 1), (tmp / "eam2", 2)):
        cols, rows = eng_rows(d / "eam.eng")
        check(all(np.isfinite(r).all() for r in rows) and len(rows) ==
              (5 if nt == 1 else 2), f"EAM ntypes {nt} .eng {len(rows)}")
        if nt == 1:
            check(cols[-1] == "eta*tau_eta" and all(r[5] != 0.0
                                                    for r in rows[:4]),
                  "EAM nvt .eng: eta*tau_eta non-zero")
    typ = st3.scene.type[st3.scene.mask]
    check(int((typ == 1).sum()) == n_atoms // 4
          and int((typ == 0).sum()) == 3 * n_atoms // 4,
          "L1_2: the faces type 0, the corners (a quarter) type 1")
    report = {
        "config": "flagship fcc Al 63^3 (1,000,188 atoms), analytic EAM "
                  "degree-12 fit: nvt 0.026 eV tau_eta 20 for 40 steps "
                  "(general step, K4/K5), nve 10 steps (fused loop, "
                  "K1/K2); L1_2 two species (SCALES2 columns) under ber "
                  "0.026 eV tau 20 for 20 steps (general step, K8/K9); "
                  "float32",
        "atoms": n_atoms,
        "paths": {"eam_nvt_general": per_step(nvt_run, n_atoms),
                  "eam_nve_fused": per_step(nve_run, n_atoms,
                                            skip_first=False),
                  "alloy_ber_general": per_step(ber_run, n_atoms)},
        "launches": {"nvt": l1, "nve": l2, "ber": l3},
        "wall_s": {"ntypes1": wall1, "ntypes2": wall2},
        "max_memory_allocated_bytes": {"ntypes1": peak1, "ntypes2": peak2},
        "nvidia_smi": smi}
    return report, (sim1, st1), (sim3, st3)


# ---- phase 13: multi-species pairs (K12-mt) and ensemble cg ----------------
# examples/binary_lj/binary_lj.imd as written but for these tags: the
# flagship's 63^3 cells (L1_2 at 3.705 A: 1,000,188 atoms, 75% A), the
# phases ending at steps 60 / 120 / 200 (nvt, ber with the ramp, cg: 80
# iterations), .eng every 20, no interval checkpoint
BIN_TAGS = (("box_param 8 8 8", "box_param {cells} {cells} {cells}"),
            ("eng_int 25", "eng_int 20"), ("checkpt_int 1000", "checkpt_int 0"),
            ("maxsteps 1000", "maxsteps 60"), ("maxsteps 2000", "maxsteps 120"),
            ("maxsteps 3000", "maxsteps 200"))
BIN_STEPS = (60, 60, 80)
# the float32-against-float64 copy: 10^3 L1_2 cells (4,000 atoms) from one
# .chkpt start with NumPy velocities of 0.2 eV
BIN_REF_CELLS = 10
BIN_LINES = ("nvt",) * 3 + ("ber",) * 3 + ("cg",) * 4
# The limits of that comparison, one set per .eng line (Epot in eV per
# atom and pressure absolute, temperature and eta*tau_eta relative; the cg
# lines hold Epot only, their temperature and pressure are 0).  The binary
# melt starts far from its equilibrium (the A-B bonds stretched to 1.25
# sigma_AB) and parts the two dtypes fast, and by how much depends on the
# order of the float32 sums.  Three sound readings (float32 against
# float64 on the CPU, with K12-mt's plain version summing densely and by
# lists, and on an H100 against the host): step 20 Epot 8.2e-5, T 5.1e-4,
# P 1.8e-3, eta*tau_eta 1.3e-4 in all three; steps 40 / 60 Epot <= 5.6e-3
# / 1.1e-2, T <= 6.1e-3 / 1.5e-2, P <= 2.2e-2 / 1.9e-2, eta*tau_eta <=
# 2.0e-3 / 6.0e-3; the ber lines Epot <= 2.8e-2, T <= 4.8e-2, P <= 0.117;
# the cg lines Epot <= 1.65e-2.  Planted faults in a float64 copy against
# the sound float64 run: eta not carried (eta*tau_eta 1.0 on every nvt
# line; T 9.2e-5 / 3.8e-3 / 3.8e-2, Epot up to 2.8e-2: within the sound
# scatter), ber reading Ekin 0 (steps 80 / 100 / 120: Epot 0.235 / 0.623 /
# 1.17, T 0.376 / 1.07 / 3.10, P 0.122 / 0.155 / 0.182, within the sound
# scatter of P; the cg lines Epot >= 0.405), the Polak-Ribiere beta lost
# (the cg lines Epot 7.5e-2 / 6.8e-2 / 6.0e-2 / 5.2e-2).  A line search
# without its max_move clamp reads 0 on every line: the clamp never binds
# in this run (tests/test_torch_cg.py holds cg_relax at 1e-12).  So eta
# is held by its own column, ber by Epot and T, cg by Epot (1.8x above
# the worst sound reading, 1.7x below the lost beta); the ber lines'
# pressure limit catches gross errors only.
_BIN_NVT = {"pressure": 0.1, "eta*tau_eta": 5e-2}
_BIN_BER = {"Epot": 0.1, "pressure": 0.3}
_BIN_CG = {"Epot": 3e-2}
BIN_LIMITS = (
    {"Epot": 1e-3, "temperature": 5e-3, "pressure": 2e-2,
     "eta*tau_eta": 2e-2},
    dict(_BIN_NVT, Epot=3e-2, temperature=3e-2),
    dict(_BIN_NVT, Epot=5e-2, temperature=5e-2),
    dict(_BIN_BER, temperature=0.15), dict(_BIN_BER, temperature=0.3),
    dict(_BIN_BER, temperature=0.5), _BIN_CG, _BIN_CG, _BIN_CG, _BIN_CG)
# cg on the flagship's EAM lattice: fcc Al 63^3 with seeded displacements
EAM_CG_ITERS = 40
EAM_CG_SHIFT = 0.05


def binary_text(cells: int, start: str = "") -> str:
    """examples/binary_lj as written with BIN_TAGS at ``cells`` L1_2 cells
    per axis; with ``start`` a .chkpt start without Maxwell momenta."""
    text = (REPO / "examples" / "binary_lj" / "binary_lj.imd").read_text()
    for old, new in BIN_TAGS:
        check(text.count(old) == 1, f"binary_lj.imd holds {old!r} once")
        text = text.replace(old, new.format(cells=cells))
    if start:
        check("coordname _l12" in text, "binary_lj.imd generates L1_2")
        text = text.replace("coordname _l12",
                            f"coordname {start}\ndo_maxwell 0")
    return text


def write_bin_start(tmp: Path) -> None:
    """The 10^3-cell copy's start: ``start.chkpt`` in ``tmp``, the L1_2
    lattice at 3.705 A with NumPy velocities of 0.2 eV (seed 13)."""
    import numpy as np

    from imd_tpu_torch.io.chkpt import ChkptData, write_chkpt
    from imd_tpu_torch.utils.generate import l12

    pos, typ, diag = l12((BIN_REF_CELLS,) * 3, 3.705)
    n = len(pos)
    vel = np.random.default_rng(13).normal(size=pos.shape) \
        * np.sqrt(0.2 / 26.9815)
    vel -= vel.mean(0)
    write_chkpt(str(tmp / "start.chkpt"), ChkptData(
        number=np.arange(n), type=np.asarray(typ), mass=np.full(n, 26.9815),
        pos=pos, vel=vel, data=np.zeros((n, 1)),
        box_x=np.array([diag[0], 0, 0]), box_y=np.array([0, diag[1], 0]),
        box_z=np.array([0, 0, diag[2]])), binary=True, double=True)


def run_bin_copy(tmp: Path, name: str, *args):
    """The 10^3-cell copy of the binary LJ from ``tmp``'s start.chkpt in
    ``tmp/name`` with the driver's ``args``: ((columns, .eng rows),
    seconds)."""
    sub = tmp / name
    sub.mkdir()
    (sub / "start.chkpt").write_bytes((tmp / "start.chkpt").read_bytes())
    (sub / "bin.imd").write_text(binary_text(BIN_REF_CELLS, "start.chkpt"))
    t1 = time.perf_counter()
    run_phases(sub / "bin.imd", *args)
    return eng_rows(sub / "binary_lj.eng"), time.perf_counter() - t1


def k12mt_check(sim, state, label: str, nt: int = 2) -> dict:
    """K12-mt against its plain version on ``state`` (not counted):
    pair_errors' readings, the same bits twice, and the times and bound
    of the call as the general step makes it (energy and stress)."""
    import torch

    from imd_tpu_torch.ops import forces_pallas as b4

    from imd_tpu_torch import kernels

    # K12's limits: the kernel and its plain version add the same float32
    # terms in other orders (read on an H100: F 1.2e-7, e 2.0e-7, S 9.5e-8,
    # the pressure tensor 4.8e-10, no flip), so the limits sit ~500x above
    # them, and far below what column 0 for every pair reads (the planted
    # C3 fault, run on the CPU against this check: F 0.42, e 0.31, S 0.46,
    # the pressure tensor 0.092)
    grid, pot = sim.grid, sim.pair_run
    xi, nbr, mask, typ = b4._prep(state.scene)
    out_k = b4.pair_half_mt(xi, nbr, typ, pot, grid, nt, True)
    out_p = b4.pair_half_mt_plain(xi, nbr, typ, pot, grid, nt, True)
    err = pair_errors(out_k, out_p, mask, grid.dims)
    print(f"K12-mt on {label}: {err}")
    check(err["flips"] == 0 and err["F"] <= 1e-4 and err["e"] <= 1e-5
          and err["S"] <= 1e-4 and err["presstens"] <= 1e-4,
          f"K12-mt against its plain version on {label}")
    again = b4.pair_half_mt(xi, nbr, typ, pot, grid, nt, True)
    check(all(a is None and b is None or torch.equal(a, b)
              for a, b in zip(out_k, again)),
          f"K12-mt gives the same bits twice on {label}")
    nn = b4._assemble(grid.dims, out_p[0][4], out_p[2][4])
    pairs = float(nn[mask].double().sum()) / 2.0
    cap = grid.capacity
    out = {"capacity": cap, "pairs": pairs, **err,
           "ms": time_ms(lambda: b4.pair_half_mt(xi, nbr, typ, pot, grid,
                                                 nt), 10),
           "plain_ms": time_ms(lambda: b4.pair_half_mt_plain(
               xi, nbr, typ, pot, grid, nt), 2),
           **roofline(FLOPS_PER_PAIR["pair_half_mt"] * pairs,
                      half_bytes("pair_half_mt", xi, nbr)
                      + 2 * nt * nt * (kernels.NPOLY + 2) * 4),
           "tile": half_shape(cap, "pair_energy_mt")}
    out["share"] = out["bound_ms"] / out["ms"]
    print(f"K12-mt on {label} (cap {cap}, {pairs:.0f} pairs): "
          f"{out['ms']:.4f} ms (plain {out['plain_ms']:.2f}, bound "
          f"{out['bound_ms']:.4f}, {out['bound_by']})")
    return out


def run_binary_lj(tmp: Path, smi: str) -> dict:
    """Phase 13a: the binary LJ through the driver at 1,000,188 atoms (nvt,
    ber with the ramp, cg on K12-mt), K12-mt against its plain version on
    its last state, and the 10^3-cell copy in float32 on the card against
    float64 on the host."""
    import numpy as np
    import torch

    from imd_tpu_torch import kernels
    from imd_tpu_torch.phases import CudaPhaseTimer

    cells = LJ_CELLS
    n_atoms = 4 * cells ** 3
    par = tmp / "bin.imd"
    par.write_text(binary_text(cells))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    runs = run_phases(par, timer=CudaPhaseTimer())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    sims = [r[0] for r in runs]
    check([s.ensemble for s in sims] == ["nvt", "ber", "cg"]
          and [s.step_count for s in sims] == [60, 120, 200],
          f"binary LJ phases "
          f"{[(s.ensemble, s.step_count) for s in sims]}")
    s_md = sims[0].counters.steps + sims[1].counters.steps
    cg = sims[2]
    blocks = len(cg.block_seconds)
    check(s_md >= sum(BIN_STEPS[:2]) and cg.counters.steps == BIN_STEPS[2]
          and blocks == BIN_STEPS[2] // 20,
          f"binary LJ: {s_md} MD steps, {cg.counters.steps} cg "
          f"iterations in {blocks} blocks")
    # one launch a step; cg: two an iteration, two more a block
    want = s_md + 2 * cg.counters.steps + 2 * blocks
    check(launches["pair_half_mt"] == want,
          f"binary LJ: K12-mt launched {launches['pair_half_mt']} "
          f"times, {want} expected")
    others = {k: v for k, v in launches.items()
              if k != "pair_half_mt" and v}
    check(not others, f"other kernels launched on the binary LJ (the "
          f"single-species K12 among them): {others}")
    state = runs[-1][1]
    live = state.scene.mask
    ids = torch.sort(state.scene.id[live]).values.cpu()
    check(len(ids) == n_atoms and torch.equal(
        ids, torch.arange(n_atoms, dtype=ids.dtype))
        and int(state.scene.overflow) == 0, "binary LJ: no atom lost")
    typ = state.scene.type[live]
    check(int((typ == 1).sum()) == n_atoms // 4
          and int((typ == 0).sum()) == 3 * n_atoms // 4,
          "binary LJ: a quarter B, three quarters A")
    cols, rows = eng_rows(tmp / "binary_lj.eng")
    check(cols[-1] == "eta*tau_eta" and [len(r) for r in rows]
          == [6] * 3 + [5] * 7 and all(np.isfinite(r).all()
                                       for r in rows),
          f"binary LJ .eng: columns {cols}, widths "
          f"{[len(r) for r in rows]}")
    cg_rows = rows[6:]
    check(all(r[2] == 0.0 and r[3] == 0.0 for r in cg_rows),
          "binary LJ .eng: the cg lines have temperature and "
          "pressure 0")
    cg_epot = [float(r[1]) for r in cg_rows]
    print(f"binary LJ cg: Epot per atom at the block ends "
          f"{cg_epot}")
    check(all(b < a for a, b in zip(cg_epot, cg_epot[1:])),
          "binary LJ cg: Epot falls from block to block")
    paths = {r[0].ensemble: per_step(r, n_atoms) for r in runs}
    for name, p in paths.items():
        print(f"binary LJ {name}: {p['ms_per_step']:.3f} ms a step "
              f"({p['atom_steps_per_s'] / 1e6:.2f} M atom-steps/s), "
              f"capacity {p['capacity']}, grid {p['grid']}, "
              f"{p['host_syncs_per_step']:.3f} host syncs a step")
    print(f"binary LJ: peak memory {peak / 1e9:.3f} GB, "
          f"wall {wall:.1f} s")
    k12mt = k12mt_check(cg, state, "the binary LJ's last state")
    del runs, sims, state, cg
    torch.cuda.empty_cache()

    # the 10^3-cell copy, float32 on the card against float64 on the host
    write_bin_start(tmp)
    (cols, r32), s32 = run_bin_copy(tmp, "float32")
    (_, r64), s64 = run_bin_copy(tmp, "float64", "--device", "cpu",
                                 "--dtype", "float64")
    worst, diffs, bad = compare_mq(cols, r32, r64, BIN_LIMITS, BIN_LINES)
    for k, row in enumerate(diffs):
        print(f"binary LJ 10^3 copy, .eng line {k} ({BIN_LINES[k]}), "
              "float32 on the card against float64 on the host: "
              + ", ".join(f"{n} {v:.3e}" for n, v in row.items()))
    check(not bad, f"binary 10^3 copy beyond its limits: {bad}")
    return {"config": "examples/binary_lj/binary_lj.imd as written (LJ "
                      "Kob-Andersen ratios eps 0.35/0.525/0.175, sigma "
                      "2.62/2.096/2.3056, r_cut 5.0; nvt 0.2 eV tau_eta "
                      "50, ber 0.2 -> 0.01 eV tau 20, cg) on L1_2 63^3 at "
                      "3.705 A, 1,000,188 atoms, phases ending at "
                      "60/120/200, eng_int 20, float32, general step (13 "
                      "views + K12-mt)",
            "atoms": n_atoms, "wall_s": wall, "paths": paths,
            "launches": launches, "cg_epot_per_atom": cg_epot,
            "max_memory_allocated_bytes": peak, "k12mt": k12mt,
            "f32_vs_f64_10cells": {"worst": worst, "lines": diffs,
                                   "limits": BIN_LIMITS,
                                   "float32_card_s": s32,
                                   "float64_host_s": s64},
            "nvidia_smi": smi}


def run_eam_cg(tmp: Path, smi: str) -> dict:
    """Phase 13b: ``ensemble cg`` on the flagship's fcc Al 63^3 with the
    analytic EAM (K4/K5), from the lattice displaced by EAM_CG_SHIFT A
    (seed 14), EAM_CG_ITERS iterations in blocks of 10: K4/K5 twice an
    iteration and twice more a block, nothing else; the energy at every
    iteration (the driver's cg_relax calls, recorded) must fall, within
    the float32 rounding of the summed energy: each in-cutoff pair's
    Horners round to 2^-24 of the fits' coefficient mass (sum |c_k| of the
    pair and density fits, ROADMAP C2), and the pairs' roundings add as a
    random walk, so three times 2^-24 mass sqrt(pairs).  (In float64 the
    same relaxation falls at every iteration to 5e-12 eV; in float32 it
    stalls once the forces reach their own rounding and then wanders by
    up to ~1e-2 eV on 864 atoms, the CPU rehearsal.)  The relaxation must
    lower the energy by more than a hundred such bounds."""
    import numpy as np
    import torch

    from imd_tpu_torch import flagship, kernels, relax
    from imd_tpu_torch.io.chkpt import ChkptData, write_chkpt
    from imd_tpu_torch.models.potential import write_pot_table
    from imd_tpu_torch.ops import forces_pallas as b4
    from imd_tpu_torch.ops.fused_step import cl_inputs
    from imd_tpu_torch.phases import CudaPhaseTimer
    from imd_tpu_torch.utils.generate import fcc

    cells = LJ_CELLS
    d = tmp / "eam_cg"
    d.mkdir()
    tabs = flagship.eam_tables(1, None, dtype=np.float64)
    for name in ("pair", "rho", "embed"):
        write_pot_table(getattr(tabs, name), str(d / f"{name}.pt"))
    pos, _, diag = fcc((cells,) * 3, 4.05)
    n_atoms = len(pos)
    pos = pos + np.random.default_rng(14).normal(scale=EAM_CG_SHIFT,
                                                 size=pos.shape)
    write_chkpt(str(d / "start.chkpt"), ChkptData(
        number=np.arange(n_atoms), type=np.zeros(n_atoms, int),
        mass=np.full(n_atoms, 26.9815), pos=pos, vel=np.zeros_like(pos),
        data=np.zeros((n_atoms, 1)), box_x=np.array([diag[0], 0, 0]),
        box_y=np.array([0, diag[1], 0]), box_z=np.array([0, 0, diag[2]])),
        binary=True, double=True)
    (d / "eam.imd").write_text(EAM_GEN.format(
        coord="start.chkpt", cells=cells, nt=1, out="eam",
        masses="26.9815") + f"do_maxwell 0\nensemble cg\n"
        f"maxsteps {EAM_CG_ITERS}\n")
    traces, fnorms = [], []
    cg_relax = relax.cg_relax

    def recorded(*args, **kw):
        scene, epots, fnorm = cg_relax(*args, **kw)
        traces.append(epots.cpu())
        fnorms.append(float(fnorm))
        return scene, epots, fnorm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    relax.cg_relax = recorded
    t0 = time.perf_counter()
    try:
        runs = run_phases(d / "eam.imd", timer=CudaPhaseTimer())
    finally:
        relax.cg_relax = cg_relax
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    sim, state = runs[0][0], runs[0][1]
    blocks = len(sim.block_seconds)
    want = 2 * EAM_CG_ITERS + 2 * blocks
    check(sim.ensemble == "cg" and sim.counters.steps == EAM_CG_ITERS
          and blocks == EAM_CG_ITERS // 10
          and launches["eam_rho_e"] == launches["eam_force_s"] == want,
          f"EAM cg: K4/K5 twice an iteration and twice a block ({want}): "
          f"{launches}")
    others = {k: v for k, v in launches.items()
              if k not in ("eam_rho_e", "eam_force_s") and v}
    check(not others, f"other kernels launched on the EAM cg: {others}")
    live = state.scene.mask
    ids = torch.sort(state.scene.id[live]).values.cpu()
    check(len(ids) == n_atoms and torch.equal(
        ids, torch.arange(n_atoms, dtype=ids.dtype)), "EAM cg: no atom lost")
    trace = torch.cat(traces).double().numpy()
    # the float32 rounding of the summed energy (above); K4's count of the
    # last state's neighbours gives the pairs (a launch not counted)
    xi, _, alive = cl_inputs(state.scene)
    pairs = float(b4.eam_rho_e(xi, alive, sim.eam_run, sim.grid)[1]
                  .double().sum()) / 2.0
    mass = sum(abs(c) for fit in (sim.eam_run.pair, sim.eam_run.rho)
               for c in fit.host[0][0])
    noise = 3.0 * 2.0 ** -24 * mass * pairs ** 0.5
    rises = np.diff(trace)
    print(f"EAM cg: Epot at each iteration {trace.tolist()}; sum F.F at "
          f"the block ends {fnorms}; largest rise {rises.max():.4e} eV "
          f"(noise bound {noise:.4e} eV)")
    check(len(trace) == EAM_CG_ITERS and bool((rises <= noise).all())
          and trace[0] - trace[-1] > 100.0 * noise
          and fnorms[-1] < fnorms[0],
          "EAM cg: the energy falls at every iteration")
    report = {
        "config": "flagship fcc Al 63^3 (1,000,188 atoms), analytic EAM "
                  f"degree-12 fit, displaced by {EAM_CG_SHIFT} A (seed "
                  f"14), ensemble cg {EAM_CG_ITERS} iterations, eng_int "
                  "10, float32 (K4/K5)",
        "atoms": n_atoms, "wall_s": wall,
        "path": per_step(runs[0], n_atoms),
        "epot_trace": trace.tolist(), "fnorm_block_ends": fnorms,
        "largest_rise_eV": float(rises.max()), "noise_eV": noise,
        "pairs": pairs, "coefficient_mass": mass,
        "launches": launches,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "nvidia_smi": smi}
    return report


def pair_errors(out_k, out_p, mask, dims) -> dict:
    """K12's outputs against its plain version's, assembled: cutoff flips
    (live slots whose count differs), max |d| / max over live slots of F
    and e, of the per-slot stress sums S, the pressure tensor's largest
    relative difference, and the max abs error over live slots."""
    import torch

    from imd_tpu_torch.ops import forces_pallas as b4

    def assembled(out):
        acc_i, acc_s, acc_j = out
        v = [b4._assemble(dims, acc_i[n], acc_j[n])
             for n in range(len(acc_i))]
        return torch.stack(v[:3], 1), v[3], v[4], acc_s

    F_k, e_k, nn_k, S_k = assembled(out_k)
    F_p, e_p, nn_p, S_p = assembled(out_p)
    agree = mask & (nn_k == nn_p)
    dF = (F_k - F_p).abs().amax(1)
    de = (e_k - e_p).abs()
    dS = (S_k - S_p).abs().amax(0)
    pt_k = S_k.double().sum(dim=(1, 2))
    pt_p = S_p.double().sum(dim=(1, 2))
    return {
        "flips": int((mask & ~agree).sum()),
        "F": float(dF[agree].max() / F_p.abs().amax(1)[mask].max()),
        "e": float(de[agree].max() / e_p[mask].abs().max()),
        "S": float(dS[agree].max() / S_p.abs().amax(0)[mask].max()),
        "presstens": float(((pt_k - pt_p).abs() / pt_p.abs().max()).max()),
        "max_abs": max(float(dF[mask].max()), float(de[mask].max()),
                       float(dS[mask].max()))}


def compare_eng(alloy, single, n_atoms: int):
    """The two-species driver run's .eng against the one-species run's, at
    the same steps: 1e-5 relative per column (of the column's largest
    value; the pressure, which is the small difference of the kinetic and
    the virial term in a relaxed film, relative to the larger of itself
    and the kinetic pressure N T / V)."""
    import numpy as np
    check(alloy.shape == single.shape, ".eng shapes of the two driver runs")
    check(bool((alloy[:, 0] == single[:, 0]).all()), ".eng times")
    worst = 0.0
    # columns: time epot temperature pressure volume ttm_energy
    for k in range(1, alloy.shape[1]):
        scale = np.abs(single[:, k]).max()
        if k == 3:
            scale = max(scale, float(
                (n_atoms * single[:, 2] / single[:, 4]).max()))
        worst = max(worst, float(np.abs(alloy[:, k] - single[:, k]).max()
                                 / scale))
    print(f"driver ntypes 2 vs ntypes 1: largest .eng difference "
          f"{worst:.3e} relative (limit 1e-5)")
    check(worst <= 1e-5, ".eng of the two-species run equals the "
          "one-species run's")
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    # full-precision float32 everywhere (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import numpy as np

    from imd_tpu_torch.utils.generate import fcc
    from imd_tpu_torch import flagship, kernels
    from imd_tpu_torch.ops import forces as t_forces
    from imd_tpu_torch.ops import forces_pallas as b4
    from imd_tpu_torch.ops import forces_win as win
    from imd_tpu_torch.ops import fused_step, rebin_cl
    from imd_tpu_torch.ops.forces_fast import _roll_cells, _to_cl
    from imd_tpu_torch.ops.fused_step import scene_to_cl
    from imd_tpu_torch.ops.geometry import (Box, CellGrid, choose_grid,
                                            measured_capacity, with_capacity)
    from imd_tpu_torch.models.potential import (EAMPotential,
                                                eam_to_fastpoly, tile_columns)
    from imd_tpu_torch.config import SimConfig, parse_param_text
    from imd_tpu_torch.phases import CudaPhaseTimer, no_timer
    from imd_tpu_torch.scene import make_scene
    from imd_tpu_torch.simulation import Simulation

    smi = nvidia_smi_line()
    dev_name = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi}")
    print(f"device: {dev_name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN")

    # ---- 1. build ------------------------------------------------------
    info = kernels.build()
    print(f"build: {info.seconds:.2f} s nvcc "
          f"({'reused' if info.reused else 'compiled'}) -> {info.path.name}")
    # -Xptxas -v: registers, stack, spills per kernel; shared memory
    # appears as "smem" only where a kernel uses any
    for line in info.log.splitlines():
        if line.strip():
            print("nvcc:", line.strip())
    kernels.lib()
    usage = kernels.ptxas_usage(info.log)
    for row in (*kernels.WIN_FLAGS, *kernels.OTHER_SYMBOLS):
        print(f"ptxas {row}: {usage.get(row)}")
    for row in (*kernels.WIN_FLAGS, "eam_rho_half", "eam_force_half",
                "pair_half", "pair_half_mt"):
        check(row in usage and usage[row]["spill_bytes"] == 0,
              f"{row}: -Xptxas -v shows no spills ({usage.get(row)})")

    # ---- 2. the flagship configuration --------------------------------
    t0 = time.perf_counter()
    timer = CudaPhaseTimer()
    fs = flagship.build(device="cuda", timer=timer, temperature=WARM_EV)
    torch.cuda.synchronize()
    grid = fs.grid
    print(f"flagship: {fs.n_atoms} atoms, grid {grid.dims} cap "
          f"{grid.capacity}, TTM fd_nx {fs.tp.nx}, set-up "
          f"{time.perf_counter() - t0:.1f} s")
    cl0 = fs.carry[0]
    eam = fs.eam
    # the two-species twin: the same atoms and momenta, types index % 2,
    # tiled (identical) table columns
    t0 = time.perf_counter()
    timer2 = CudaPhaseTimer()
    fs2 = flagship.build(device="cuda", timer=timer2, temperature=WARM_EV,
                         ntypes=2)
    torch.cuda.synchronize()
    typ0 = fs2.carry[0].typ
    check(torch.equal(fs2.carry[0].xi, cl0.xi)
          and torch.equal(typ0 >= 0, cl0.alive),
          "the two-species flagship holds the one-species state")
    print(f"flagship ntypes=2: set-up {time.perf_counter() - t0:.1f} s, "
          f"{int((typ0 == 0).sum())} + {int((typ0 == 1).sum())} atoms")
    # two species with genuinely different columns, for the kernel checks
    eam_s2 = eam_to_fastpoly(flagship.eam_tables(2, SCALES2), deg=12)

    # ---- 3. kernels vs their plain versions at the main-path shapes ---
    gen = torch.Generator(device="cuda").manual_seed(1)
    alive = cl0.alive

    def jittered(amp, frac=1.0):
        """Live positions + uniform(-amp, amp) on a fraction of atoms."""
        j = torch.empty_like(cl0.xi).uniform_(-amp, amp, generator=gen)
        pick = torch.rand(alive.shape, generator=gen, device=alive.device)
        pick = alive & (pick < frac)
        return torch.where(pick[:, None, :], cl0.xi + j, cl0.xi)

    # The degree-12 fit does not vanish at the cutoff (for the flagship's
    # fit rho_fit(rc^2) = 0.0117, 2 dphi/dr^2 = 1.29 there), so a pair
    # within an ulp of rc would count in one version and not the other if
    # r^2 rounded differently (the kernels round each multiply and add as
    # torch does, -fmad=false, so none is expected).  Slots whose
    # neighbour count agrees are held to the tolerances; the others must
    # differ by exactly the fit's jump at rc.
    def jumps(eam):
        """(rho, 1/2-less phi, gradient) jumps of the fit at rc^2, the
        largest over the table columns."""
        return (max(abs(sum(c[0])) for c in eam.rho.host),
                max(abs(sum(c[0])) for c in eam.pair.host),
                max(abs(sum(win._deriv_coefs(c))) for c in eam.pair.host)
                + max(abs(sum(win._deriv_coefs(c))) for c in eam.rho.host)
                * 2.0)

    def passes(eam, grid, typ, nt):
        """The four passes and their plain versions as functions of
        (xi, alive[, dF]), and the embedding: K1/K2/K4/K5 for one
        species, K6-K9 with ``typ`` for ``nt`` > 1 (``alive`` is then
        typ >= 0)."""
        if typ is None:
            return dict(
                names=("K1 eam_rho", "K2 eam_force", "K4 eam_rho_e",
                       "K5 eam_force_s"),
                rho=lambda x, a: win.eam_rho(x, a, eam, grid),
                rho_p=lambda x, a: win.eam_rho_plain(x, a, eam, grid),
                force=lambda x, a, d: win.eam_force(x, a, d, eam, grid),
                force_p=lambda x, a, d: win.eam_force_plain(x, a, d, eam,
                                                            grid),
                rho_e=lambda x, a: b4.eam_rho_e(x, a, eam, grid),
                rho_e_p=lambda x, a: b4.eam_rho_e_plain(x, a, eam, grid),
                force_s=lambda x, a, d: b4.eam_force_s(x, a, d, eam, grid),
                force_s_p=lambda x, a, d: b4.eam_force_s_plain(x, a, d, eam,
                                                               grid),
                embed=lambda rho: eam.embed.interp(0, rho))
        return dict(
            names=("K6 eam_rho_mt", "K7 eam_force_mt", "K8 eam_rho_e_mt",
                   "K9 eam_force_s_mt"),
            rho=lambda x, a: win.eam_rho_mt(x, typ, eam, grid, nt),
            rho_p=lambda x, a: win.eam_rho_mt_plain(x, typ, eam, grid, nt),
            force=lambda x, a, d: win.eam_force_mt(x, typ, d, eam, grid, nt),
            force_p=lambda x, a, d: win.eam_force_mt_plain(x, typ, d, eam,
                                                           grid, nt),
            rho_e=lambda x, a: b4.eam_rho_e_mt(x, typ, eam, grid, nt),
            rho_e_p=lambda x, a: b4.eam_rho_e_mt_plain(x, typ, eam, grid,
                                                       nt),
            force_s=lambda x, a, d: b4.eam_force_s_mt(x, typ, d, eam, grid,
                                                      nt),
            force_s_p=lambda x, a, d: b4.eam_force_s_mt_plain(x, typ, d,
                                                              eam, grid, nt),
            embed=lambda rho: win.embed_mt(eam, rho, typ, nt))

    def flip_residual(d, dnn, jump, flips, exact):
        """What a slot's difference leaves beside ``dnn`` flipped pairs of
        ``jump`` each: |d - dnn jump| with one table column (every flip
        jumps by the same amount), the excess of d over dnn times the
        largest column's jump with several."""
        if not bool(flips.any()):
            return 0.0
        r = (d - dnn * jump)[flips]
        return float((r.abs() if exact else r.clamp(min=0)).max())

    def check_eam(xi, alive, eam, grid, label, typ=None, nt=1):
        """K1 and K2 (K6 and K7 with ``typ``) against their plain versions
        on one input; returns the max abs errors of rho and F over live
        slots, and the dF the F pass took."""
        ops = passes(eam, grid, typ, nt)
        k1, k2 = ops["names"][:2]
        rho_jump, _, grad_jump = jumps(eam)
        live = int(alive.sum())
        rho_k, nn_k = ops["rho"](xi, alive)
        check(all(torch.equal(a, b) for a, b in zip(
            (rho_k, nn_k), ops["rho"](xi, alive))),
            f"{k1} gives the same bits twice ({label})")
        rho_p, nn_p = ops["rho_p"](xi, alive)
        agree = alive & (nn_k == nn_p)
        flips = alive & ~agree
        n_flip = int(flips.sum())
        rho_scale = float(rho_p[alive].abs().max())
        drho = (rho_k - rho_p).abs()
        rho_rel = float(drho[agree].max()) / rho_scale
        rho_abs = float(drho[alive].max())
        flip_off = flip_residual(drho, (nn_k - nn_p).abs(), rho_jump, flips,
                                 typ is None)
        print(f"{k1} ({label}): nn differs in {n_flip} of {live} live "
              f"slots (pairs at the cutoff); elsewhere max |drho| / max rho "
              f"= {rho_rel:.3e}; at those slots |drho| - |dnn| "
              f"rho_fit(rc^2) = {flip_off:.3e}; max abs {rho_abs:.3e}")
        check(n_flip <= 1e-5 * live, f"{k1} neighbour counts ({label})")
        check(rho_rel <= 1e-5, f"{k1} host density ({label})")
        check(flip_off <= 1e-5 * rho_scale,
              f"{k1} density at cutoff flips ({label})")

        dF = 0.5 * ops["embed"](rho_p)[1] * alive.to(xi.dtype)
        F_k = ops["force"](xi, alive, dF)
        check(torch.equal(F_k, ops["force"](xi, alive, dF)),
              f"{k2} gives the same bits twice ({label})")
        F_p = ops["force_p"](xi, alive, dF)
        f_max = float(F_p.abs().max())
        dFn = (F_k - F_p).abs().amax(1)
        f_rel = float(dFn[agree].max()) / f_max
        f_abs = float(dFn[alive].max())
        flip_bound = (grad_jump * float(dF.abs().max()) + grad_jump) \
            * grid.cutoff
        f_flip = float((dFn / (nn_k - nn_p).abs().clamp(min=1))[flips]
                       .max()) if n_flip else 0.0
        def fsum_rel(F):
            """|sum F| / (N mean|F|): each pair is evaluated from both
            sides, so what is left is float32 rounding."""
            F = F.double()
            return float(F.sum(dim=(0, 2)).abs().max()
                         / F.abs().sum())
        fs_k, fs_p = fsum_rel(F_k), fsum_rel(F_p)
        print(f"{k2} ({label}): elsewhere max |dF| / max|F| = "
              f"{f_rel:.3e} (max|F| {f_max:.3e}); at the flip slots |dF| per "
              f"flip {f_flip:.3e} (bound {flip_bound:.3e}); max abs "
              f"{f_abs:.3e}; |sum F| / (N mean|F|) = {fs_k:.3e} (plain "
              f"{fs_p:.3e})")
        check(f_rel <= 1e-4, f"{k2} forces ({label})")
        check(f_flip <= flip_bound, f"{k2} forces at cutoff flips ({label})")
        # momentum: as well conserved as by the plain version, which rounds
        # alike (a pair missed on one side would leave ~1e-2)
        check(fs_k <= 1e-6 or fs_k <= 1.5 * fs_p,
              f"{k2} momentum conservation ({label})")
        return rho_abs, f_abs, dF

    def check_b4(xi, alive, eam, grid, dF, label, typ=None, nt=1):
        """K4 and K5 (K8 and K9 with ``typ``) against their plain versions
        on one input, with the dF of the plain density (as K2 is checked);
        returns the max abs errors of (rho, e) and (F, S) over live slots,
        and the neighbour counts."""
        ops = passes(eam, grid, typ, nt)
        _, k2, k4, k5 = ops["names"]
        rho_jump, phi_jump, grad_jump = jumps(eam)
        live = int(alive.sum())
        rho_k, nn_k, e_k = ops["rho_e"](xi, alive)
        check(all(torch.equal(a, b) for a, b in zip(
            (rho_k, nn_k, e_k), ops["rho_e"](xi, alive))),
            f"{k4} gives the same bits twice ({label})")
        rho_p, nn_p, e_p = ops["rho_e_p"](xi, alive)
        agree = alive & (nn_k == nn_p)
        flips = alive & ~agree
        n_flip = int(flips.sum())
        dnn = (nn_k - nn_p).abs()
        rho_scale = float(rho_p[alive].abs().max())
        drho = (rho_k - rho_p).abs()
        de = (e_k - e_p).abs()
        af = alive.to(xi.dtype)
        epot_k = (e_k + ops["embed"](rho_k)[0]) * af
        epot_p = (e_p + ops["embed"](rho_p)[0]) * af
        ep_scale = float(epot_p[alive].abs().max())
        rho_rel = float(drho[agree].max()) / rho_scale
        ep_rel = float((epot_k - epot_p).abs()[agree].max()) / ep_scale
        e_flip = flip_residual(de, dnn, 0.5 * phi_jump, flips, typ is None)
        rho_flip = flip_residual(drho, dnn, rho_jump, flips, typ is None)
        print(f"{k4} ({label}): nn differs in {n_flip} of {live} "
              f"live slots; elsewhere max |drho| / max rho = {rho_rel:.3e}, "
              f"max |depot| / max|epot| = {ep_rel:.3e}; at those slots "
              f"|drho| - |dnn| rho_fit(rc^2) = {rho_flip:.3e}, |de| - "
              f"|dnn| phi_fit(rc^2)/2 = {e_flip:.3e}")
        check(n_flip <= 1e-5 * live, f"{k4} neighbour counts ({label})")
        check(rho_rel <= 1e-5 and ep_rel <= 1e-5,
              f"{k4} density and epot ({label})")
        check(rho_flip <= 1e-5 * rho_scale and e_flip <= 1e-5 * ep_scale,
              f"{k4} density and energy at cutoff flips ({label})")
        k4_err = max(float(drho[alive].max()), float(de[alive].max()))

        # K5 tests the cutoff as K1 does: its cutoff flips are K1's
        _, nn_k1 = ops["rho"](xi, alive)
        agree = alive & (nn_k1 == nn_p)
        flips = alive & ~agree
        dnn = (nn_k1 - nn_p).abs()
        F_k, S_k = ops["force_s"](xi, alive, dF)
        check(all(torch.equal(a, b) for a, b in zip(
            (F_k, S_k), ops["force_s"](xi, alive, dF))),
            f"{k5} gives the same bits twice ({label})")
        F_p, S_p = ops["force_s_p"](xi, alive, dF)
        f_max = float(F_p.abs().max())
        f_rel = float((F_k - F_p).abs().amax(1)[agree].max()) / f_max
        pt_k = S_k.double().sum(dim=(1, 2))
        pt_p = S_p.double().sum(dim=(1, 2))
        # a flipped pair moves each component by at most half its
        # gradient jump times rc^2 on each side it flipped on
        flip_pt = float(dnn[flips].sum()) * 0.5 * (
            grad_jump * float(dF.abs().max()) + grad_jump) * grid.cutoff ** 2
        dpt = (pt_k - pt_p).abs()
        pt_ok = bool((dpt <= 1e-4 * pt_p.abs().max() + flip_pt).all())
        vir_k, vir_p = float(pt_k[:3].sum()), float(pt_p[:3].sum())
        vir_ok = abs(vir_k - vir_p) <= 1e-4 * abs(vir_p) + 3 * flip_pt
        print(f"{k5} ({label}): nn (R pass) differs in "
              f"{int(flips.sum())} live slots; elsewhere max |dF| / max|F| = "
              f"{f_rel:.3e}; presstens kernel {pt_k.tolist()} plain "
              f"{pt_p.tolist()} (max |d| / max|p| "
              f"{float(dpt.max() / pt_p.abs().max()):.3e}, flip allowance "
              f"{flip_pt:.3e}); virial {vir_k:.6e} vs {vir_p:.6e}")
        check(f_rel <= 1e-4, f"{k5} forces ({label})")
        check(pt_ok and vir_ok, f"{k5} pressure tensor and virial ({label})")
        F_w = ops["force"](xi, alive, dF)
        check(float((F_k - F_w).abs().max()) <= 1e-6 * f_max,
              f"{k5} forces equal {k2}'s ({label})")
        k5_err = max(float((F_k - F_p).abs().amax(1)[alive].max()),
                     float((S_k - S_p).abs().amax(0)[alive].max()))
        return k4_err, k5_err, nn_k

    errs = dict.fromkeys(FLOPS_PER_PAIR, 0.0)   # max abs error per kernel

    def check_all(xi, alive, eam, grid, label, typ=None, nt=1,
                  record=True):
        """The R/F passes and the observables pair on one input; notes the
        errors under the kernels' names (unless not ``record``) and
        returns (dF, nn)."""
        rho_e, f_e, dF = check_eam(xi, alive, eam, grid, label, typ, nt)
        k4_e, k5_e, nn = check_b4(xi, alive, eam, grid, dF, label, typ, nt)
        for name, e in (("eam_rho", rho_e), ("eam_force", f_e),
                        ("eam_rho_e", k4_e), ("eam_force_s", k5_e)):
            name = name if typ is None else MT_OF[name]
            if record:
                errs[name] = max(errs[name], e)
        return dF, nn

    xi = jittered(0.1)
    dF, nn_main = check_all(xi, alive, eam, grid, "main path")
    # the alloy kernels on the same state: two species, different columns
    dF2, _ = check_all(xi, alive, eam_s2, grid,
                       "main path, ntypes 2, scaled columns", typ0, 2)

    # tiled (identical) columns: K6/K7 must give what K1/K2 give
    rho_1, nn_1 = win.eam_rho(xi, alive, eam, grid)
    rho_t, nn_t = win.eam_rho_mt(xi, typ0, fs2.eam, grid, 2)
    F_1 = win.eam_force(xi, alive, dF, eam, grid)
    F_t = win.eam_force_mt(xi, typ0, dF, fs2.eam, grid, 2)
    d_rho_t = float((rho_t - rho_1).abs().max())
    d_f_t = float((F_t - F_1).abs().max())
    print(f"tiled columns, ntypes 2: K6 vs K1 max |drho| = {d_rho_t:.3e} "
          f"(bitwise equal: {torch.equal(rho_t, rho_1)}), nn equal: "
          f"{torch.equal(nn_t, nn_1)}; K7 vs K2 max |dF| = {d_f_t:.3e} of "
          f"max|F| {float(F_1.abs().max()):.3e} (bitwise equal: "
          f"{torch.equal(F_t, F_1)}; K7 adds dF_i rho' and dF_j rho' "
          "separately, K2 multiplies their sum)")
    check(torch.equal(nn_t, nn_1) and d_rho_t <= 1e-5 * float(rho_1.max())
          and d_f_t <= 1e-5 * float(F_1.abs().max()),
          "K6/K7 with tiled columns against K1/K2")
    del rho_1, nn_1, rho_t, nn_t, F_1, F_t

    # the CPU parity tests' tiny grid: fcc 5x4x4 -> dims (3,2,2), where
    # the 2-cell axes reach one neighbour cell through two images
    tpos, _, tdiag = fcc((5, 4, 4), flagship.ALAT)
    tpos = tpos + np.random.default_rng(3).normal(scale=0.1,
                                                  size=tpos.shape)
    tbox = Box.create([tdiag[0], 0, 0], [0, tdiag[1], 0], [0, 0, tdiag[2]])
    tgrid = choose_grid(tbox, flagship.CUTOFF, flagship.SKIN, len(tpos))
    tgrid = with_capacity(tgrid, measured_capacity(tgrid, tpos))
    check(tgrid.dims == (3, 2, 2), f"tiny grid dims {tgrid.dims}")
    tcl = scene_to_cl(make_scene(tgrid, tpos, device="cuda"))
    tlabel = f"dims {tgrid.dims} cap {tgrid.capacity}"
    check_all(tcl.xi, tcl.alive, eam, tgrid, tlabel)
    # the same grid with four species (random types)
    ttyp = torch.from_numpy(np.random.default_rng(4).integers(
        0, 4, len(tpos)).astype(np.int32))
    tcl4 = scene_to_cl(make_scene(tgrid, tpos, type=ttyp, device="cuda"))
    eam_s4 = eam_to_fastpoly(flagship.eam_tables(4, SCALES4), deg=12)
    check_all(tcl4.xi, tcl4.alive, eam_s4, tgrid, tlabel + ", ntypes 4",
              tcl4.typ, 4)

    # the capacity sweep: both templates with all four flag pairs at cap
    # 17, 24, 31, 40 and the limit (17 and 31 leave padding lanes in the
    # block's last warp), on a 3 x 4 x 11 grid of 6 A cells with an open
    # x face (several tiles along y and z, the last ones partial), every
    # slot live at uniform random positions, and one cell's atoms squeezed
    # into 0.4 A so that its lists fill in one cell (up to cap - 1 of the
    # cap + WIN_LIST_SLACK entries); the same tolerances
    sdims, edge = (3, 4, 11), 6.0
    sbox = Box.create([sdims[0] * edge, 0, 0], [0, sdims[1] * edge, 0],
                      [0, 0, sdims[2] * edge], pbc=(0, 1, 1))
    ncs = sdims[0] * sdims[1] * sdims[2]
    cidx = torch.arange(ncs, device="cuda")
    ijk = torch.stack([cidx // (sdims[1] * sdims[2]),
                       (cidx // sdims[2]) % sdims[1], cidx % sdims[2]])
    squeezed = (1 * sdims[1] + 2) * sdims[2] + 5
    for cap in (17, 24, 31, 40, kernels.WIN_MAX_CAP):
        sgrid = CellGrid(box=sbox, dims=sdims, capacity=cap,
                         cutoff=flagship.CUTOFF, skin=flagship.SKIN)
        u = torch.rand((cap, 3, ncs), generator=gen, device="cuda")
        sxi = (ijk[None] + u) * edge
        sxi[:, :, squeezed] = ijk[:, squeezed] * edge + 0.2 + 0.4 * u[
            :, :, squeezed]
        sxi = sxi.float().contiguous()
        salive = torch.ones((cap, ncs), dtype=torch.bool, device="cuda")
        t = win.win_tile(cap, sdims, 1)
        slabel = (f"sweep cap {cap} (tile {t.tx} x {t.ty} x {t.tz} cells, "
                  f"{t.threads} threads, {t.smem} B)")
        check_all(sxi, salive, eam, sgrid, slabel, record=False)
        styp = torch.randint(0, 2, (cap, ncs), generator=gen, device="cuda",
                             dtype=torch.int32)
        check_all(sxi, salive, eam_s2, sgrid, slabel + ", ntypes 2", styp, 2,
                  record=False)
    # one slot above the limit: every wrapper raises before any launch
    over = kernels.WIN_MAX_CAP + 1
    ogrid = CellGrid(box=sbox, dims=sdims, capacity=over,
                     cutoff=flagship.CUTOFF, skin=flagship.SKIN)
    oxi = torch.zeros((over, 3, ncs), device="cuda")
    oal = torch.ones((over, ncs), dtype=torch.bool, device="cuda")
    otyp = torch.zeros((over, ncs), dtype=torch.int32, device="cuda")
    odF = torch.zeros((over, ncs), device="cuda")
    before = dict(kernels.LAUNCHES)
    for name, call in (
            ("eam_rho", lambda: win.eam_rho(oxi, oal, eam, ogrid)),
            ("eam_force", lambda: win.eam_force(oxi, oal, odF, eam, ogrid)),
            ("eam_rho_e", lambda: b4.eam_rho_e(oxi, oal, eam, ogrid)),
            ("eam_force_s",
             lambda: b4.eam_force_s(oxi, oal, odF, eam, ogrid)),
            ("eam_rho_mt",
             lambda: win.eam_rho_mt(oxi, otyp, eam_s2, ogrid, 2)),
            ("eam_force_mt",
             lambda: win.eam_force_mt(oxi, otyp, odF, eam_s2, ogrid, 2)),
            ("eam_rho_e_mt",
             lambda: b4.eam_rho_e_mt(oxi, otyp, eam_s2, ogrid, 2)),
            ("eam_force_s_mt",
             lambda: b4.eam_force_s_mt(oxi, otyp, odF, eam_s2, ogrid, 2))):
        try:
            call()
            raised = False
        except ValueError:
            raised = True
        check(raised, f"{name} at capacity {over} must raise ValueError")
    check(kernels.LAUNCHES == before, "no launch above the capacity limit")
    print(f"capacity {over} (the limit + 1): all eight wrappers raise "
          "ValueError before launching")
    del sxi, salive, styp, oxi, oal, otyp, odF

    # ---- B7: the rolled-view split, K10 and K11 ----------------------
    def hold_k10(rho_k, nn_k, rho_o, nn_o, alive, rho_jump, rho_scale, tol,
                 what):
        """K10's assembled (rho, nn) against another version's on the live
        slots: nn equal in all but ``tol`` of them; elsewhere |drho| to
        ``tol`` of ``rho_scale``, and at the flipped slots |drho| less the
        fit's jump per flip too.  Returns the slots where nn agrees."""
        live = int(alive.sum())
        agree = alive & (nn_k == nn_o)
        flips = alive & ~agree
        drho = (rho_k - rho_o).abs()
        rel = float(drho[agree].max()) / rho_scale
        off = flip_residual(drho, (nn_k - nn_o).abs(), rho_jump, flips,
                            True)
        print(f"K10 eam_rho_half vs {what}: nn differs in "
              f"{int(flips.sum())} of {live} live slots; elsewhere max "
              f"|drho| / max rho = {rel:.3e}; at those slots |drho| - "
              f"|dnn| rho_fit(rc^2) = {off:.3e}")
        check(int(flips.sum()) <= tol * live and rel <= tol
              and off <= tol * rho_scale, f"K10 against {what}")
        return agree

    def check_half(xi, alive, eam, grid, label):
        """K10/K11 (assembled) against their plain versions and against
        K1/K2 on one input, and two launches against each other; notes
        the max abs errors over live slots and returns (nbr, dF, dFn,
        max|F|).  Against the plain versions the tolerances are K1/K2's:
        both evaluate each pair from its i side with the same bits.  K1/K2
        evaluate each pair from both sides, and the two sides' r^2 differ
        in the last bit (x_i - (x_j + s) against x_j - (x_i - s)); the
        degree-12 fit's Horner (sum |c_k| ~ 2,400 for phi') turns that into
        ~1e-4 eV/A per pair term, and an atom sums ~40 terms of up to
        ~30 eV/A that cancel: so F is held to K2 at 5e-4 of max|F|."""
        dims = grid.dims
        rho_jump, _, grad_jump = jumps(eam)
        nbr = b4.make_neighbor_views(grid, xi.dtype, xi.device)(xi)
        out_k = b4.eam_rho_half(xi, nbr, eam, grid, True)
        again = b4.eam_rho_half(xi, nbr, eam, grid, True)
        check(all(torch.equal(a, b) for a, b in zip(out_k, again)),
              f"K10 gives the same bits twice ({label})")
        rho_k, nn_k = b4._rho_nn(dims, *out_k)
        rho_p, nn_p = b4._rho_nn(dims, *b4.eam_rho_half_plain(
            xi, nbr, eam, grid, True))
        rho_1, nn_1 = win.eam_rho(xi, alive, eam, grid)
        rho_scale = float(rho_p[alive].abs().max())
        agrees = []
        for other, (rho_o, nn_o) in (("plain", (rho_p, nn_p)),
                                     ("K1", (rho_1, nn_1))):
            # K10 books half its pairs from the partner's side, whose r^2
            # may differ from K1's in the last bit: more cutoff flips
            # (7 of 1,000,188 slots on the main path's state), and the
            # fit's Horner rounds each such pair differently (1.4e-5 of
            # max rho there): against K1, 1e-4 for both
            tol = 1e-5 if other == "plain" else 1e-4
            agrees.append(hold_k10(rho_k, nn_k, rho_o, nn_o, alive,
                                   rho_jump, rho_scale, tol,
                                   f"{other} ({label})"))
        errs["eam_rho_half"] = max(errs["eam_rho_half"],
                                   float((rho_k - rho_p).abs()[alive].max()))
        dF = 0.5 * eam.embed.interp(0, rho_p)[1] * alive.to(xi.dtype)
        dFn = b4._dF_views(dF, dims)
        out_k = b4.eam_force_half(xi, nbr, dF, dFn, eam, grid)
        again = b4.eam_force_half(xi, nbr, dF, dFn, eam, grid)
        check(all(torch.equal(a, b) for a, b in zip(out_k, again)),
              f"K11 gives the same bits twice ({label})")
        F_k = b4._forces(dims, *out_k)
        F_p = b4._forces(dims, *b4.eam_force_half_plain(xi, nbr, dF, dFn,
                                                        eam, grid))
        F_1 = win.eam_force(xi, alive, dF, eam, grid)
        f_max = float(F_p.abs().max())
        flip_bound = (grad_jump * float(dF.abs().max()) + grad_jump) \
            * grid.cutoff
        for (other, F_o, nn_o), agree in zip(
                (("plain", F_p, nn_p), ("K2", F_1, nn_1)), agrees):
            dFn_ = (F_k - F_o).abs().amax(1)
            rel = float(dFn_[agree].max()) / f_max
            flips = alive & ~agree
            f_flip = float((dFn_ / (nn_k - nn_o).abs().clamp(min=1))[flips]
                           .max()) if bool(flips.any()) else 0.0
            print(f"K11 eam_force_half ({label}) vs {other}: max |dF| / "
                  f"max|F| = {rel:.3e} (max|F| {f_max:.3e}); at flip slots "
                  f"|dF| per flip {f_flip:.3e} (bound {flip_bound:.3e})")
            check(rel <= (1e-4 if other == "plain" else 5e-4)
                  and f_flip <= flip_bound, f"K11 against {other} ({label})")
        errs["eam_force_half"] = max(
            errs["eam_force_half"],
            float((F_k - F_p).abs().amax(1)[alive].max()))
        return nbr, dF, dFn, f_max

    # the CPU tests' grid with the open x face of the ablation film
    tgrid_o = tgrid.replace(box=dataclasses.replace(tgrid.box, pbc=(0, 1, 1)))
    tcl_o = scene_to_cl(make_scene(tgrid_o, tpos, device="cuda"))
    check_half(tcl_o.xi, tcl_o.alive, eam, tgrid_o, tlabel + ", open x")
    nbr_main, dF_half, dFn_main, f_scale = check_half(xi, alive, eam, grid,
                                                      "main path")

    # ---- B6: K12 pair_half on the LJ main path's shapes ----------------
    # phase 7's set-up (the LJ fit, grid 42^3 cap 16 at 1,000,188 atoms);
    # the positions jittered by 0.1 A, whose forces set the scale
    lj = Simulation(SimConfig.from_params(parse_param_text(
        LJ_PARAMS.format(cells=LJ_CELLS))), device="cuda")
    lj_pot, lj_grid = lj.pair_run, lj.grid
    c_lj = lj_pot.host[0][0]
    r2_nn = flagship.ALAT ** 2 / 2.0          # the nearest neighbour
    t_v, t_g = lj.pair.interp(0, np.array([r2_nn]))
    f_v, f_g = lj_pot.at_host_precision().interp(
        0, torch.tensor([r2_nn], dtype=torch.float64))
    print(f"LJ fit (to_fastpoly, vcap 50): window r^2 in "
          f"[{lj_pot.host[0][1]:.4f}, {lj_pot.host[0][2]:.4f}], sum |c_k| = "
          f"{sum(abs(v) for v in c_lj):.1f}, phi_fit(rc^2) = {sum(c_lj):.4f} "
          f"eV, sum |c_k'| = "
          f"{sum(abs(v) for v in win._deriv_coefs(lj_pot.host[0])):.1f}; at "
          f"the nearest neighbour phi fit {float(f_v[0]):.4f} table "
          f"{float(t_v[0]):.4f} eV, 2 dphi/dr^2 fit {float(f_g[0]):.4f} "
          f"table {float(t_g[0]):.4f}; grid {lj_grid.dims} cap "
          f"{lj_grid.capacity}")
    xi_lj0, _, alive_lj = b4.prep_neighbors(lj.scene)
    lj_cap = lj_grid.capacity
    del lj
    xi_lj = torch.where(alive_lj[:, None, :], xi_lj0 + torch.empty_like(
        xi_lj0).uniform_(-0.1, 0.1, generator=gen), xi_lj0).contiguous()

    def check_pair(xi, alive, pot, grid, label):
        """K12 (assembled) against its plain version, with the count, the
        energy and the stress on: no cutoff flips (the kernel rounds as
        torch does, -fmad=false), e to 1e-5, F and the stress sums to 1e-4
        of their maxima (K10/K11's tolerances), the pressure tensor to
        1e-4; two launches give the same bits.  Returns (nbr, pairs)."""
        nbr = b4.make_neighbor_views(grid, xi.dtype, xi.device)(xi)
        out_k = b4.pair_half(xi, nbr, pot, grid, True)
        again = b4.pair_half(xi, nbr, pot, grid, True)
        check(all(torch.equal(a, b) for a, b in zip(out_k, again)),
              f"K12 gives the same bits twice ({label})")
        out_p = b4.pair_half_plain(xi, nbr, pot, grid, True)
        e = pair_errors(out_k, out_p, alive, grid.dims)
        print(f"K12 pair_half ({label}) vs plain: {e}")
        check(e["flips"] == 0 and e["F"] <= 1e-4 and e["e"] <= 1e-5
              and e["S"] <= 1e-4 and e["presstens"] <= 1e-4,
              f"K12 against its plain version ({label})")
        errs["pair_half"] = max(errs.get("pair_half", 0.0), e["max_abs"])
        nn = b4._assemble(grid.dims, out_p[0][4], out_p[2][4])
        return nbr, float(nn[alive].double().sum()) / 2.0

    check_pair(tcl_o.xi, tcl_o.alive, lj_pot, tgrid_o,
               tlabel + ", open x, LJ")
    nbr_lj, pairs_lj = check_pair(xi_lj, alive_lj, lj_pot, lj_grid,
                                  "LJ main path, jittered")
    # K12 at cap 24, where 43 of phase 7's launches run (its grid grows
    # from cap 16 to 24 and 32 and keeps its 42^3 cells): the jittered LJ
    # state with 8 dead slots more a cell, checked as above
    pad = 24 - lj_cap
    xi_lj24 = torch.cat([xi_lj, torch.full(
        (pad, 3, xi_lj.shape[2]), win.SENTINEL_DEAD,
        device="cuda")]).contiguous()
    alive_lj24 = torch.cat([alive_lj, torch.zeros(
        (pad, alive_lj.shape[1]), dtype=torch.bool, device="cuda")])
    lj_grid24 = CellGrid(box=lj_grid.box, dims=lj_grid.dims, capacity=24,
                         cutoff=lj_grid.cutoff, skin=lj_grid.skin)
    nbr_lj24, _ = check_pair(xi_lj24, alive_lj24, lj_pot, lj_grid24,
                             "LJ main path, jittered, 8 dead slots more: "
                             "cap 24")

    # the half-stencil capacity sweep: K10, K11 and K12 at cap 17, 24, 31,
    # 32, 40 and the limit 128 (17 and 31 leave padding lanes in a warp)
    # on the 3 x 4 x 11 grid of the full-stencil sweep with its open x
    # face; a quarter of the slots dead (at SENTINEL_DEAD, scattered over
    # the slots), one cell empty, and the squeezed cell full, so that its
    # lists fill.  K10 (the flagship's EAM fit) against its plain version
    # on live slots with check_half's tolerances, its count within the
    # cutoff and within 0.9 of it (its j side then recomputes r^2); K11
    # (dF from the plain density) to K11's tolerance against its plain
    # version, K12 (the LJ fit, cutoff 5 A) through check_pair; all three
    # the same bits twice
    empty = (2 * sdims[1] + 1) * sdims[2] + 7
    for cap in (17, 24, 31, 32, 40, kernels.HALF_MAX_CAP):
        u = torch.rand((cap, 3, ncs), generator=gen, device="cuda")
        hxi = (ijk[None] + u) * edge
        hxi[:, :, squeezed] = ijk[:, squeezed] * edge + 0.2 + 0.4 * u[
            :, :, squeezed]
        halive = torch.rand((cap, ncs), generator=gen, device="cuda") < 0.75
        halive[:, squeezed] = True
        halive[:, empty] = False
        hxi = torch.where(halive[:, None, :], hxi.float(),
                          win.SENTINEL_DEAD).contiguous()
        hgrid = CellGrid(box=sbox, dims=sdims, capacity=cap,
                         cutoff=flagship.CUTOFF, skin=flagship.SKIN)
        t11 = win.half_tile(cap, "force")
        t10 = win.half_tile(cap, "rho")
        hlabel = (f"half sweep cap {cap} (K10 {t10.cpb} cells, "
                  f"{t10.threads} threads, {t10.smem} B; K11 {t11.cpb}, "
                  f"{t11.threads}, {t11.smem} B)")
        hnbr = b4.make_neighbor_views(hgrid, hxi.dtype, hxi.device)(hxi)
        rho_h, _ = b4.eam_r_pass_plain(hxi, hnbr, eam, hgrid)
        rho_jump = jumps(eam)[0]
        for nr2 in (0.0, (0.9 * hgrid.cutoff) ** 2):
            out_k = b4.eam_rho_half(hxi, hnbr, eam, hgrid, True, nr2)
            again = b4.eam_rho_half(hxi, hnbr, eam, hgrid, True, nr2)
            check(all(torch.equal(a, b) for a, b in zip(out_k, again)),
                  f"K10 gives the same bits twice ({hlabel}, nr2 {nr2})")
            rho_k, nn_k = b4._rho_nn(sdims, *out_k)
            rho_p, nn_p = b4._rho_nn(sdims, *b4.eam_rho_half_plain(
                hxi, hnbr, eam, hgrid, True, nr2))
            hold_k10(rho_k, nn_k, rho_p, nn_p, halive, rho_jump,
                     float(rho_p[halive].abs().max()), 1e-5,
                     f"plain ({hlabel}, nr2 {nr2:.4f})")
        hdF = (0.5 * eam.embed.interp(0, rho_h)[1]
               * halive.to(hxi.dtype)).contiguous()
        hdFn = b4._dF_views(hdF, sdims).contiguous()
        out_k = b4.eam_force_half(hxi, hnbr, hdF, hdFn, eam, hgrid)
        again = b4.eam_force_half(hxi, hnbr, hdF, hdFn, eam, hgrid)
        check(all(torch.equal(a, b) for a, b in zip(out_k, again)),
              f"K11 gives the same bits twice ({hlabel})")
        F_k = b4._forces(sdims, *out_k)
        F_p = b4._forces(sdims, *b4.eam_force_half_plain(
            hxi, hnbr, hdF, hdFn, eam, hgrid))
        dF_h = (F_k - F_p).abs().amax(1)
        rel = float(dF_h[halive].max() / F_p.abs().amax(1)[halive].max())
        print(f"K11 eam_force_half ({hlabel}) vs plain: max |dF| / max|F| "
              f"= {rel:.3e}")
        check(rel <= 1e-4, f"K11 against its plain version ({hlabel})")
        lgrid = CellGrid(box=sbox, dims=sdims, capacity=cap,
                         cutoff=lj_grid.cutoff, skin=lj_grid.skin)
        check_pair(hxi, halive, lj_pot, lgrid,
                   f"half sweep cap {cap}, LJ")
    del hxi, halive, hnbr, hdF, hdFn, out_k, again, F_k, F_p
    del rho_k, nn_k, rho_p, nn_p
    # one slot above the limit: the three wrappers raise before any launch
    over = kernels.HALF_MAX_CAP + 1
    ogrid = CellGrid(box=sbox, dims=sdims, capacity=over,
                     cutoff=flagship.CUTOFF, skin=flagship.SKIN)
    oxi = torch.zeros((over, 3, ncs), device="cuda")
    onbr = torch.zeros((b4.NOF, over, 3, ncs), device="cuda")
    odF = torch.zeros((over, ncs), device="cuda")
    odFn = torch.zeros((b4.NOF, over, ncs), device="cuda")
    before = dict(kernels.LAUNCHES)
    for name, call in (
            ("eam_rho_half",
             lambda: b4.eam_rho_half(oxi, onbr, eam, ogrid, True)),
            ("eam_force_half",
             lambda: b4.eam_force_half(oxi, onbr, odF, odFn, eam, ogrid)),
            ("pair_half", lambda: b4.pair_half(oxi, onbr, lj_pot, ogrid))):
        try:
            call()
            raised = False
        except ValueError:
            raised = True
        check(raised, f"{name} at capacity {over} must raise ValueError")
    check(kernels.LAUNCHES == before, "no K10-K12 launch above the limit")
    print(f"capacity {over}: K10, K11 and K12 raise ValueError before "
          "launching")
    del oxi, onbr, odF, odFn

    # ---- B8: compute_eam_forces_pallas2 on the flagship Scene ------------
    # with phase 3's jittered positions: the start lattice's forces cancel
    # to ~1e-3 eV/A, where a relative comparison measures rounding only
    scene_j = fused_step.cl_to_scene(cl0.replace(xi=xi), fs.scene)
    kernels.reset_launches()
    res2 = b4.compute_eam_forces_pallas2(scene_j, eam, count_neighbors=True)
    b8_launches = {n: kernels.LAUNCHES[n] for n in ("eam_rho_e",
                                                    "eam_force_s")}
    check(b8_launches == {"eam_rho_e": 1, "eam_force_s": 1},
          f"B8 launches K4 and K5 once each: {b8_launches}")
    res1 = b4.compute_eam_forces_pallas(scene_j, eam)
    for name in ("force", "epot", "rho", "num_neighs"):
        check(torch.equal(getattr(res2, name), getattr(res1, name)),
              f"B8 {name} equals compute_eam_forces_pallas's")
    check(float(res2.virial) == 0.0 and not bool(res2.presstens.any()),
          "B8 leaves the virial and pressure tensor at zero, as imd_tpu")
    bcl = scene_to_cl(scene_j)
    rho_b8 = b4.eam_rho_e_plain(bcl.xi, bcl.alive, eam, grid)[0]
    dF_b8 = 0.5 * eam.embed.interp(0, rho_b8)[1] * bcl.alive.to(xi.dtype)
    k4_b8, k5_b8, _ = check_b4(bcl.xi, bcl.alive, eam, grid, dF_b8,
                               "B8, the flagship Scene, jittered")
    errs["eam_rho_e_b8"], errs["eam_force_s_b8"] = k4_b8, k5_b8
    print(f"B8 compute_eam_forces_pallas2: equals compute_eam_forces_pallas "
          f"bitwise; launches {b8_launches}")
    del res1, res2, bcl, rho_b8, dF_b8, scene_j

    # K3 through a whole rebin (3 phases, with the TTM fdi riding along);
    # lattice planes sit ~1 A from every cell face: 5% of the atoms jump
    # up to 1.3 A, so that some cross a face
    xi_m = jittered(1.3, frac=0.05)
    cl_m = cl0.replace(xi=xi_m)
    fdi = torch.randint(0, fs.tp.nx, alive.shape, generator=gen,
                        device="cuda", dtype=torch.int32)
    fdi = torch.where(alive, fdi, torch.full_like(fdi, -1))
    rebin = rebin_cl.make_rebin_cl(grid)
    n3 = kernels.LAUNCHES["compact"]
    cl_k, fdi_k = rebin(cl_m, fdi)
    check(kernels.LAUNCHES["compact"] - n3 == 3, "K3 launches per rebin")
    cl_c = cl_m.replace(**{f.name: getattr(cl_m, f.name).cpu()
                           for f in dataclasses.fields(cl_m)})
    cl_p, fdi_p = rebin(cl_c, fdi.cpu())
    for f in dataclasses.fields(cl_k):
        a, b = getattr(cl_k, f.name).cpu(), getattr(cl_p, f.name)
        check(torch.equal(a, b), f"K3 rebin field {f.name}")
    check(torch.equal(fdi_k.cpu(), fdi_p), "K3 rebin fdi")
    moved = int((cl_k.ids != cl_m.ids).sum())
    print(f"K3 compact: rebin of a jittered copy equals the CPU plain rebin "
          f"exactly ({moved} slots changed, overflow {int(cl_k.overflow)})")
    check(moved > 0, "K3 rebin moved atoms")

    # phase-1 compaction inputs at the main-path shapes, for timing
    ff, fi = rebin_cl._bin_fields(xi_m, cl0.mom, cl0.mass, cl0.typ,
                                  cl0.vtyp, cl0.ids, grid)
    fi = torch.cat([fi, fdi[None]], 0)
    gyz = grid.dims[1] * grid.dims[2]
    cur_x = torch.arange(grid.n_cells, device="cuda",
                         dtype=torch.int32) // gyz

    def shift_x(a, sgn):
        return _roll_cells(a, grid.dims, (-sgn, 0, 0))

    tgt, candf, candi, _, _ = rebin_cl._phase_targets(
        ff, fi, alive, 0, cur_x, grid.dims[0], 1, shift_x,
        grid.capacity + 8)
    of_k, oi_k = rebin_cl.compact(tgt, candf, candi, grid.capacity + 8)
    of_p, oi_p = rebin_cl._compact_plain(tgt, candf, candi,
                                         grid.capacity + 8)
    k3_err = max(float((of_k - of_p).abs().max()),
                 float((oi_k - oi_p).abs().max()))
    check(k3_err == 0.0, "K3 compact at phase-1 shapes")

    # small input against the all-pairs oracle (float64 reference)
    small = flagship.build(device="cuda", atoms=864, ttm=False)
    scl = small.carry[0]
    sxi = torch.where(scl.alive[:, None, :],
                      scl.xi + torch.empty_like(scl.xi).uniform_(
                          -0.1, 0.1, generator=gen), scl.xi)
    pos = sxi.permute(0, 2, 1)[scl.alive].double()
    # pairs within 1e-3 A^2 of the cutoff may count differently in f32;
    # atoms holding one are left out of the value comparison (see K1)
    dr = t_forces.min_image(small.grid.box, pos[:, None] - pos[None])
    near = int((((dr * dr).sum(-1) - small.grid.cutoff ** 2).abs()
                < 1e-3).sum())

    def check_oracle(label, out, eam_o, **types):
        """(F, rho, nn) of the hot-loop passes against the all-pairs
        oracle at the fit's host precision."""
        sF, srho, snn = out
        oF, orho, onn = t_forces.eam_forces_n2(
            pos, torch.ones(len(pos), dtype=torch.bool, device="cuda"),
            small.grid.box, eam_o.at_host_precision(), **types)
        same = snn[scl.alive].double() == onn
        o_nn = int((~same).sum())
        o_rho = float(((srho[scl.alive].double() - orho).abs() / orho)[same]
                      .max())
        o_f = float((sF.permute(0, 2, 1)[scl.alive].double() - oF)
                    .abs()[same].max() / oF.abs().max())
        print(f"oracle ({len(pos)} atoms, {label}): nn differs in {o_nn} "
              f"({near} pairs near the cutoff), elsewhere rho rel "
              f"{o_rho:.3e}, F rel {o_f:.3e}")
        check(o_nn <= near and o_rho <= 1e-5 and o_f <= 1e-4,
              f"force kernels vs the all-pairs oracle ({label})")

    check_oracle("one species", win.eam_kernels_win_split(
        sxi, scl.alive, small.eam, small.grid, count_neighbors=True),
        small.eam)
    # the same input with two species and the scaled columns
    styp = torch.where(scl.alive, scl.ids % 2, scl.typ)
    check_oracle("ntypes 2", win.eam_kernels_win_split_mt(
        sxi, styp, scl.alive, eam_s2, small.grid, 2, count_neighbors=True),
        eam_s2, typ=styp[scl.alive], ntypes=2)

    # K12's masked result (B6's Scene entry) against the all-pairs oracle,
    # a pair potential being an EAM with zero density and embedding
    zero = dataclasses.replace(lj_pot, coef=np.zeros_like(lj_pot.coef),
                               host=(((0.0,) * len(c_lj), 0.0, 1.0),))
    s_res = b4.compute_pair_forces_pallas(
        fused_step.cl_to_scene(scl.replace(xi=sxi), small.scene), lj_pot,
        count_neighbors=True)
    lj_h = lj_pot.at_host_precision()
    oF, _, onn = t_forces.eam_forces_n2(
        pos, torch.ones(len(pos), dtype=torch.bool, device="cuda"),
        small.grid.box, EAMPotential(pair=lj_h, rho=zero, embed=zero))
    r2 = (dr * dr).sum(-1)
    inside = (r2 < small.grid.cutoff ** 2) & ~torch.eye(
        len(pos), dtype=torch.bool, device="cuda")
    oe = 0.5 * torch.where(inside, lj_h.interp(0, r2.clamp(min=1.0))[0],
                           torch.zeros_like(r2)).sum(1)
    sdims = small.grid.dims     # the oracle's atoms are in cells-last order
    same = _to_cl(s_res.num_neighs, sdims)[scl.alive].double() == onn
    o_f = float((_to_cl(s_res.force, sdims).permute(0, 2, 1)[scl.alive]
                 .double() - oF).abs()[same].max() / oF.abs().max())
    o_e = float((_to_cl(s_res.epot, sdims)[scl.alive].double() - oe)
                .abs()[same].max() / oe.abs().max())
    o_nn = int((~same).sum())
    # the float32 Horner of phi rounds each term to ~2^-24 of the fit's
    # coefficient mass (sum |c_k| = 7,082 for this LJ fit, 4e-4 eV, where
    # the EAM fits' 1,510 give 1e-4): epot is held to 2 such roundings per
    # pair of the busiest atom, relative to the largest |epot|
    e_tol = (0.5 * float(onn.max()) * sum(abs(v) for v in c_lj) * 2.0 ** -23
             / float(oe.abs().max()))
    print(f"oracle ({len(pos)} atoms, K12 through compute_pair_forces_"
          f"pallas, LJ): nn differs in {o_nn} ({near} pairs near the "
          f"cutoff), elsewhere F rel {o_f:.3e}, epot rel {o_e:.3e} (limit "
          f"{e_tol:.3e})")
    check(o_nn <= near and o_f <= 1e-4 and o_e <= e_tol,
          "K12 vs the all-pairs oracle")
    del s_res, oF, onn, oe, r2, inside

    # kernel and plain-version times at the main-path shapes: one species,
    # then two with the scaled columns (K6-K9)
    ms, plain_ms = {}, {}
    for ops, d, reps in ((passes(eam, grid, None, 1), dF, 3),
                         (passes(eam_s2, grid, typ0, 2), dF2, 2)):
        for key, kname in zip(("rho", "force", "rho_e", "force_s"),
                              ops["names"]):
            args = (xi, alive, d) if "force" in key else (xi, alive)
            name = kname.split()[1]
            ms[name] = time_ms(lambda: ops[key](*args), 10)
            plain_ms[name] = time_ms(lambda: ops[key + "_p"](*args), reps)
    # K10/K11 on the main path's views
    for name, fn, fn_p in (
            ("eam_rho_half",
             lambda: b4.eam_rho_half(xi, nbr_main, eam, grid, True),
             lambda: b4.eam_rho_half_plain(xi, nbr_main, eam, grid, True)),
            ("eam_force_half",
             lambda: b4.eam_force_half(xi, nbr_main, dF_half, dFn_main, eam,
                                       grid),
             lambda: b4.eam_force_half_plain(xi, nbr_main, dF_half,
                                             dFn_main, eam, grid))):
        ms[name] = time_ms(fn, 10)
        plain_ms[name] = time_ms(fn_p, 2)
    # K12 as the general step calls it: energy and stress, no count
    ms["pair_half"] = time_ms(lambda: b4.pair_half(xi_lj, nbr_lj, lj_pot,
                                                   lj_grid), 10)
    plain_ms["pair_half"] = time_ms(lambda: b4.pair_half_plain(
        xi_lj, nbr_lj, lj_pot, lj_grid), 2)
    # and at cap 24 on the padded state, with its bound from those inputs
    # (the same pairs)
    k12_cap24 = {
        "capacity": 24,
        "ms": time_ms(lambda: b4.pair_half(xi_lj24, nbr_lj24, lj_pot,
                                           lj_grid24), 10),
        "plain_ms": time_ms(lambda: b4.pair_half_plain(
            xi_lj24, nbr_lj24, lj_pot, lj_grid24), 2),
        **roofline(FLOPS_PER_PAIR["pair_half"] * pairs_lj,
                   half_bytes("pair_half", xi_lj24, nbr_lj24)),
        "tile": half_shape(24, "pair_energy")}
    k12_cap24["share"] = k12_cap24["bound_ms"] / k12_cap24["ms"]
    print(f"K12 at cap 24 (the LJ state padded): {k12_cap24['ms']:.4f} ms "
          f"(plain {k12_cap24['plain_ms']:.2f}, bound "
          f"{k12_cap24['bound_ms']:.4f}, {k12_cap24['bound_by']})")
    oc = grid.capacity + 8
    ms["compact"] = time_ms(
        lambda: rebin_cl.compact(tgt, candf, candi, oc), 10)
    plain_ms["compact"] = time_ms(
        lambda: rebin_cl._compact_plain(tgt, candf, candi, oc), 3)

    # bounds at these inputs: each in-cutoff pair once (nn counts it from
    # both sides), each input byte read once, each output written once
    pairs = float(nn_main[alive].double().sum()) / 2.0
    # pairs of like types: the pairs within each species alone (K1 with
    # only that species alive)
    like = sum(float(win.eam_rho(xi, typ0 == p, eam, grid)[1].double().sum())
               for p in range(2)) / 2.0
    unlike = pairs - like
    print(f"pairs inside the cutoff: {pairs:.0f}, of unlike types "
          f"{unlike:.0f}")
    slots = alive.numel()
    # per slot: position 12, alive 1 (one species) or type 4 (alloy), dF 4,
    # and the outputs; the alloy kernels also read their coefficient buffer
    bytes_slot = {"eam_rho": 12 + 1 + 8, "eam_rho_e": 12 + 1 + 12,
                  "eam_force": 12 + 1 + 4 + 12,
                  "eam_force_s": 12 + 1 + 4 + 12 + 24}
    work = {n: (FLOPS_PER_PAIR[n] * pairs, bytes_slot[n] * slots)
            for n in bytes_slot}
    # K10/K11 on the flagship's views, K12 on the LJ state's: their bytes
    # from the live slots and view entries (half_bytes)
    for n in ("eam_rho_half", "eam_force_half"):
        work[n] = (FLOPS_PER_PAIR[n] * pairs, half_bytes(n, xi, nbr_main))
    print(f"LJ pairs inside the cutoff: {pairs_lj:.0f}")
    work["pair_half"] = (FLOPS_PER_PAIR["pair_half"] * pairs_lj,
                         half_bytes("pair_half", xi_lj, nbr_lj))
    tab_bytes = win._mt_table(eam_s2, xi.device).numel() * 4
    for n, m in MT_OF.items():
        work[m] = (FLOPS_PER_PAIR[m] * pairs
                   + FLOPS_PER_UNLIKE_PAIR[m] * unlike,
                   (bytes_slot[n] + 3) * slots + tab_bytes)
    k3_out = (candf.shape[0] + candi.shape[0]) * oc * tgt.shape[1] * 4
    work["compact"] = (0.0, sum(t.numel() * t.element_size()
                                for t in (tgt, candf, candi)) + k3_out)
    del xi, xi_m, cl_m, cl_c, cl_k, cl_p, small, scl, tcl, tcl4, dF, dF2
    del tcl_o, nbr_main, dF_half, dFn_main, xi_lj, xi_lj0, nbr_lj, alive_lj
    del xi_lj24, nbr_lj24, alive_lj24
    torch.cuda.empty_cache()

    # ---- 4. the main path (warmed so that the skin check triggers) -----
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    report = timed_run(fs, timer)
    launches = dict(kernels.LAUNCHES)
    report["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()

    cl, tg, _, k = fs.carry
    ids = torch.sort(cl.ids[cl.alive]).values
    check(k == 63, "step count")
    check(int(cl.overflow) == 0, "overflow")
    check(not tg.cfl_overflow, "TTM CFL overflow")
    check(bool(torch.isfinite(tg.temp).all()), "finite T_e")
    check(int(cl.alive.sum()) == fs.n_atoms, "atom count conserved")
    check(torch.equal(ids.cpu(), torch.arange(fs.n_atoms, dtype=torch.int32)),
          "atom id set conserved")
    check(report["run_counts"]["rebins"] > 0, "the main path must rebin "
          "(K3 runs only inside the skin-triggered rebin)")
    for name in ("eam_rho", "eam_force", "compact"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")
    print(json.dumps({"main_path": dict(
        report, start_temperature_eV=WARM_EV, launches=launches,
        device=dev_name, nvidia_smi=smi)}))
    main_rate, main_phases = (report["atom_steps_per_s"],
                              report["phase_ms_per_step"])
    del fs, cl, tg
    torch.cuda.empty_cache()

    # ---- 4b. the alloy main path: the same run with two species --------
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    report = timed_run(fs2, timer2)
    launches2 = dict(kernels.LAUNCHES)
    report["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    cl, tg, _, k = fs2.carry
    order = torch.argsort(cl.ids[cl.alive])
    ids = cl.ids[cl.alive][order]
    check(k == 63, "alloy step count")
    check(int(cl.overflow) == 0, "alloy overflow")
    check(not tg.cfl_overflow and bool(torch.isfinite(tg.temp).all()),
          "alloy TTM: CFL overflow or T_e not finite")
    check(int(cl.alive.sum()) == fs2.n_atoms and torch.equal(
        ids.cpu(), torch.arange(fs2.n_atoms, dtype=torch.int32)),
        "alloy: atom count and id set conserved")
    check(torch.equal(cl.typ[cl.alive][order], ids % 2),
          "alloy: every id keeps its type through the rebins")
    check(report["run_counts"]["rebins"] > 0 and launches2["compact"] > 0,
          "the alloy main path must rebin (K3)")
    for name in ("eam_rho_mt", "eam_force_mt"):
        check(launches2[name] == 63, f"{name} launched {launches2[name]} "
              "times in 63 steps of the alloy main path")
    for name in ("eam_rho", "eam_force"):
        check(launches2[name] == 0, f"{name} launched on the alloy path")
    launches.update({n: launches2[n] for n in ("eam_rho_mt", "eam_force_mt")})
    print(json.dumps({"main_path_alloy": dict(
        report, ntypes=2, start_temperature_eV=WARM_EV, launches=launches2,
        one_species_atom_steps_per_s=main_rate,
        one_species_phase_ms_per_step=main_phases,
        device=dev_name, nvidia_smi=smi)}))
    del fs2, cl, tg
    torch.cuda.empty_cache()

    # ---- 4c. the rolled-view engines: the warmed run with "split" (K10,
    # K11 over views built each step) and with "ab" (K4, K5) --------------
    engine_launches = {}
    for engine, on, off in (
            ("split", ("eam_rho_half", "eam_force_half"),
             ("eam_rho", "eam_force", "eam_rho_e", "eam_force_s")),
            ("ab", ("eam_rho_e", "eam_force_s"),
             ("eam_rho", "eam_force", "eam_rho_half", "eam_force_half"))):
        t0 = time.perf_counter()
        timer_e = CudaPhaseTimer()
        fse = flagship.build(device="cuda", timer=timer_e,
                             temperature=WARM_EV, engine=engine)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        cle = fse.carry[0]
        # the first step's forces against the "win" engine from this start.
        # The start is the perfect lattice, whose forces cancel to ~1e-3
        # eV/A, the size of float32 rounding of their pair terms (see
        # check_half): the difference is held to 5e-4 of the force scale
        # of the same lattice with 0.1 A of disorder (phase 3's max|F|)
        F_w, nn_w = fused_step._make_forces(fse.eam, fse.scene, 1, no_timer,
                                            "win")(cle, True)
        F_e, nn_e = fused_step._make_forces(fse.eam, fse.scene, 1, no_timer,
                                            engine)(cle, True)
        agree = cle.alive & (nn_w == nn_e)
        n_flip = int((cle.alive & ~agree).sum())
        f_abs = float((F_e - F_w).abs().amax(1)[agree].max())
        f_start = float(F_w.abs().max())
        print(f"engine {engine!r}: first step's forces vs 'win': nn differs "
              f"in {n_flip} live slots, elsewhere max |dF| = {f_abs:.3e} "
              f"eV/A (max|F| {f_start:.3e} at the start, {f_scale:.3e} on "
              f"the disordered lattice: {f_abs / f_scale:.3e} of it)")
        check(n_flip <= 1e-5 * fse.n_atoms and f_abs <= 5e-4 * f_scale,
              f"engine {engine!r} forces against the 'win' engine")
        del F_w, nn_w, F_e, nn_e, agree
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        report = timed_run(fse, timer_e)
        le = dict(kernels.LAUNCHES)
        report["max_memory_allocated_bytes"] = \
            torch.cuda.max_memory_allocated()
        cl, tg, _, k = fse.carry
        ids = torch.sort(cl.ids[cl.alive]).values
        check(k == 63 and int(cl.overflow) == 0, f"{engine}: steps, overflow")
        check(not tg.cfl_overflow and bool(torch.isfinite(tg.temp).all()),
              f"{engine}: TTM CFL overflow or T_e not finite")
        check(int(cl.alive.sum()) == fse.n_atoms and torch.equal(
            ids.cpu(), torch.arange(fse.n_atoms, dtype=torch.int32)),
            f"{engine}: atom count and id set conserved")
        check(report["run_counts"]["rebins"] > 0 and le["compact"] > 0,
              f"the {engine} main path must rebin (K3)")
        for name in on:
            check(le[name] == 63, f"{engine}: {name} launched {le[name]} "
                  "times in 63 steps")
        for name in off:
            check(le[name] == 0, f"{engine}: {name} launched {le[name]} "
                  "times (expected 0)")
        print(json.dumps({f"main_path_{engine}": dict(
            report, engine=engine, start_temperature_eV=WARM_EV,
            launches=le, setup_s=setup_s,
            first_step_vs_win={"nn_differs": n_flip, "max_dF": f_abs,
                                "max_F": f_start, "force_scale": f_scale},
            win_atom_steps_per_s=main_rate, win_phase_ms_per_step=main_phases,
            device=dev_name, nvidia_smi=smi)}))
        engine_launches[engine] = le
        del fse, cle, cl, tg
        torch.cuda.empty_cache()
    launches.update({n: engine_launches["split"][n]
                     for n in ("eam_rho_half", "eam_force_half")})

    # ---- 5. bench.py's configuration as is (0.026 eV): timed only -------
    timer = CudaPhaseTimer()
    fs = flagship.build(device="cuda", timer=timer)
    torch.cuda.reset_peak_memory_stats()
    report = timed_run(fs, timer)
    report["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    tg = fs.carry[1]
    check(bool(torch.isfinite(tg.temp).all()) and not tg.cfl_overflow
          and int(fs.carry[0].overflow) == 0, "bench configuration run")
    print(json.dumps({"bench_config": dict(
        report, start_temperature_eV=flagship.TEMPERATURE, device=dev_name,
        nvidia_smi=smi)}))

    # ---- 6. the param-file driver on the 1M-atom ablation geometry ----
    driver, sim, state = run_driver(dev_name, smi)
    launches.update({n: driver["launches"][n]
                     for n in ("eam_rho_e", "eam_force_s")})
    # the same film as a two-species run of identical species
    driver2, sim2, state2 = run_driver(dev_name, smi, ntypes=2)
    launches.update({n: driver2["launches"][n]
                     for n in ("eam_rho_e_mt", "eam_force_s_mt")})
    compare_eng(driver2["eng"], driver["eng"], driver["atoms"])
    print(f"driver ms per step: ntypes 1 {driver['ms_per_step']:.1f}, "
          f"ntypes 2 {driver2['ms_per_step']:.1f}; ms per observe(): "
          f"{driver['ms_per_observe']:.2f}, {driver2['ms_per_observe']:.2f}")
    dcl2 = scene_to_cl(state2.scene)
    del sim2, state2

    # K1/K2/K4/K5 against their plain versions at the driver's shapes
    # (its grid, capacity, open x axis and EAM tables), on its last state
    dcl = scene_to_cl(state.scene)
    dgrid, deam = sim.grid, sim.eam_run
    dlabel = f"driver end, dims {dgrid.dims} cap {dgrid.capacity} pbc " \
             f"{dgrid.box.pbc}"
    check_all(dcl.xi, dcl.alive, deam, dgrid, dlabel)
    # K6-K9 at these shapes: the two-species run's last state, the run1m
    # tables scaled per column
    deam2 = eam_to_fastpoly(EAMPotential(
        pair=tile_columns(sim.eam.pair, SCALES2[0]),
        rho=tile_columns(sim.eam.rho, SCALES2[1]),
        embed=tile_columns(sim.eam.embed, SCALES2[2])))
    check_all(dcl2.xi, dcl2.alive, deam2, dgrid,
              dlabel + ", ntypes 2, scaled columns", dcl2.typ, 2)
    del dcl2
    torch.cuda.empty_cache()
    # the same state rolled along x (positions shifted with their cells)
    # so that the open x face cuts the film in the middle of its occupied
    # cells: the kernels must skip the neighbour cells across it, as the
    # plain versions do
    gx = dgrid.dims[0]
    filled = dcl.alive.reshape(dgrid.capacity, gx, -1).sum(dim=(0, 2))
    filled = torch.nonzero(filled).flatten().tolist()
    k = (gx - (filled[0] + filled[-1]) // 2) % gx
    width = float(dgrid.box.h[0][0]) / gx
    shape = (dgrid.capacity, 3, gx, -1)
    xr = torch.roll(dcl.xi.reshape(shape), k, dims=2)
    ar = torch.roll(dcl.alive.reshape(dgrid.capacity, gx, -1), k, dims=1)
    shift = torch.full((gx,), k * width, device="cuda", dtype=xr.dtype)
    shift[:k] -= float(dgrid.box.h[0][0])
    xr[:, 0] += shift[None, :, None]
    ar = ar.reshape(dgrid.capacity, -1).contiguous()
    xr = torch.where(ar[:, None, :], xr.reshape(dcl.xi.shape),
                     dcl.xi.new_tensor(win.SENTINEL_DEAD)).contiguous()
    occ_x = ar.reshape(dgrid.capacity, gx, -1).sum(dim=(0, 2))
    check(bool(occ_x[0] > 0) and bool(occ_x[-1] > 0),
          "rolled driver state fills both x cells at the open face")
    periodic = dgrid.replace(box=dataclasses.replace(dgrid.box,
                                                     pbc=(1, 1, 1)))
    nn_open = float(win.eam_rho(xr, ar, deam, dgrid)[1].double().sum())
    nn_pbc = float(win.eam_rho(xr, ar, deam, periodic)[1].double().sum())
    print(f"rolled driver state: the open x face cuts "
          f"{(nn_pbc - nn_open) / 2:.0f} pairs that a periodic x would keep")
    check(nn_pbc > nn_open, "the open face cuts pairs of the rolled state")
    rlabel = dlabel + ", rolled across the open face"
    check_all(xr, ar, deam, dgrid, rlabel)
    del dcl, xr, ar, sim, state
    errs["compact"] = k3_err
    torch.cuda.empty_cache()

    # ---- 7. the general pair step through the driver ------------------
    lj_report = run_lj_driver(dev_name, smi)
    launches["pair_half"] = lj_report["launches"]["pair_half"]
    errs["pair_half"] = max(errs["pair_half"],
                            lj_report["k12_vs_plain_last_state"]["max_abs"])
    torch.cuda.empty_cache()

    # ---- 8. the ablation example as written (TMM, NRB, FILTER, implicit)
    abl, asim, astate = run_ablation(dev_name, smi)
    acl = scene_to_cl(astate.scene)
    check_all(acl.xi, acl.alive, asim.eam_run, asim.grid,
              f"ablation end, dims {asim.grid.dims} cap "
              f"{asim.grid.capacity}, after FILTER")
    del acl, asim, astate
    torch.cuda.empty_cache()

    # phases 9 and 10 write checkpoint sets that phase 11 resumes
    with tempfile.TemporaryDirectory(prefix="imd_phys_") as phys_dir, \
            tempfile.TemporaryDirectory(prefix="imd_fdtd_") as fdtd_dir:
        phys_dir, fdtd_dir = Path(phys_dir), Path(fdtd_dir)
        phys_stash, fdtd_stash = {}, {}
        # ---- 9. VLATTICE, ELECPRESS and COLRAD on phase 8's run --------
        phys, psim, pstate, film_ids = run_physics(dev_name, smi, phys_dir,
                                                   phys_stash)
        pcl = scene_to_cl(pstate.scene)
        check_all(pcl.xi, pcl.alive, psim.eam_run, psim.grid,
                  f"physics end, dims {psim.grid.dims} cap "
                  f"{psim.grid.capacity}")
        del pcl, psim
        torch.cuda.empty_cache()

        # ---- 10. the FDTD laser on run1m's film -------------------------
        fdtd, fsim, fstate = run_fdtd(dev_name, smi, fdtd_dir, fdtd_stash)
        del fsim
        torch.cuda.empty_cache()

        # ---- 11. the restarts of phases 9 and 10 ------------------------
        r_phys = run_restart_physics(dev_name, smi, phys_dir, pstate,
                                     phys_stash[1], film_ids)
        del pstate
        torch.cuda.empty_cache()
        r_fdtd = run_restart_fdtd(dev_name, smi, fdtd_dir, fstate,
                                  fdtd_stash[1])
        del fstate
        torch.cuda.empty_cache()
    # ---- 11b. the tabulated EOS -----------------------------------------
    eos_report = run_eos(dev_name, smi)
    torch.cuda.empty_cache()

    # ---- 12. the general step's ensembles -------------------------------
    t12 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="imd_gen_") as gen_dir:
        gen_dir = Path(gen_dir)
        mq = run_melt_quench(gen_dir, smi)
        torch.cuda.empty_cache()
        eam_gen, (gsim, gstate), (asim3, astate3) = run_eam_general(gen_dir,
                                                                    smi)
    # K4/K5 (with K1/K2) on the nvt phase's last state, K8/K9 (with K6/K7)
    # on the two-species ber run's, against their plain versions
    gcl = scene_to_cl(gstate.scene)
    check_all(gcl.xi, gcl.alive, gsim.eam_run, gsim.grid,
              f"EAM nvt end, dims {gsim.grid.dims} cap {gsim.grid.capacity}")
    acl3 = scene_to_cl(astate3.scene)
    check_all(acl3.xi, acl3.alive, asim3.eam_run, asim3.grid,
              f"two-species ber end, dims {asim3.grid.dims} cap "
              f"{asim3.grid.capacity}", acl3.typ, 2)
    del gcl, acl3, gsim, gstate, asim3, astate3
    torch.cuda.empty_cache()
    print(json.dumps({"general_ensembles": {
        "melt_quench": mq, "eam": eam_gen,
        "phase_wall_s": time.perf_counter() - t12,
        "host_threads": torch.get_num_threads(), "device": dev_name,
        "nvidia_smi": smi}}))
    gen_launches = {
        "pair_half": mq["launches"]["pair_half"],
        **{k: eam_gen["launches"]["nvt"][k]
           for k in ("eam_rho_e", "eam_force_s")},
        **{k: eam_gen["launches"]["nve"][k] for k in ("eam_rho", "eam_force")},
        **{k: eam_gen["launches"]["ber"][k]
           for k in ("eam_rho_e_mt", "eam_force_s_mt")}}

    # ---- 13. multi-species pairs (K12-mt) and ensemble cg ---------------
    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="imd_bin_") as bin_dir:
        bin_dir = Path(bin_dir)
        binr = run_binary_lj(bin_dir, smi)
        torch.cuda.empty_cache()
        eam_cg = run_eam_cg(bin_dir, smi)
    torch.cuda.empty_cache()
    print(json.dumps({"multi_species_cg": {
        "binary_lj": binr, "eam_cg": eam_cg,
        "phase_wall_s": time.perf_counter() - t13,
        "host_threads": torch.get_num_threads(), "device": dev_name,
        "nvidia_smi": smi}}))
    k12mt = binr["k12mt"]
    ms["pair_half_mt"] = k12mt["ms"]
    plain_ms["pair_half_mt"] = k12mt["plain_ms"]
    work["pair_half_mt"] = (k12mt["flops"], k12mt["bytes"])
    launches["pair_half_mt"] = binr["launches"]["pair_half_mt"]
    errs["pair_half_mt"] = k12mt["max_abs"]
    cg_launches = {k: eam_cg["launches"][k]
                   for k in ("eam_rho_e", "eam_force_s")}

    rows = [("eam_rho", "eam_win.cu", "imd_tpu/ops/forces_win.py:306"),
            ("eam_force", "eam_win.cu", "imd_tpu/ops/forces_win.py:411"),
            ("compact", "rebin_compact.cu", "imd_tpu/ops/rebin_cl.py:66"),
            ("eam_rho_e", "eam_win.cu", "imd_tpu/ops/forces_pallas.py:275"),
            ("eam_force_s", "eam_win.cu",
             "imd_tpu/ops/forces_pallas.py:345"),
            ("eam_rho_mt", "eam_win.cu", "imd_tpu/ops/forces_win.py:565"),
            ("eam_force_mt", "eam_win.cu", "imd_tpu/ops/forces_win.py:676"),
            ("eam_rho_e_mt", "eam_win.cu",
             "imd_tpu/ops/forces_pallas.py:1055"),
            ("eam_force_s_mt", "eam_win.cu",
             "imd_tpu/ops/forces_pallas.py:1158"),
            ("eam_rho_half", "eam_half.cu",
             "imd_tpu/ops/forces_pallas.py:641"),
            ("eam_force_half", "eam_half.cu",
             "imd_tpu/ops/forces_pallas.py:747"),
            ("pair_half", "eam_half.cu",
             "imd_tpu/ops/forces_pallas.py:487"),
            # K12's typed counterpart for 2-4 species (imd_tpu's B6 bakes
            # column 0, ROADMAP C3)
            ("pair_half_mt", "eam_half.cu",
             "imd_tpu/ops/forces_pallas.py:487"),
            # B8 (compute_eam_forces_pallas2) runs K4/K5: their times, its
            # launches and errors on the flagship Scene
            ("eam_rho_e_b8", "eam_win.cu",
             "imd_tpu/ops/forces_pallas.py:1299"),
            ("eam_force_s_b8", "eam_win.cu",
             "imd_tpu/ops/forces_pallas.py:1363")]
    # the full-stencil kernels' tile at the main paths' shapes: the
    # flagship's grid, one species or two
    tiles = {}
    for row, (_, _, mt) in kernels.WIN_FLAGS.items():
        t = win.win_tile(grid.capacity, grid.dims, 2 if mt else 1)
        tiles[row] = {"smem_dynamic_bytes": t.smem, "tile": {
            "cells": [t.tx, t.ty, t.tz], "threads": t.threads,
            "list_len": t.list_len}}
    # K10-K12's launch shape at the table's shapes; K12's launches on the
    # pair path by capacity, and its time on phase 7's last state
    for row, cap_, kind in (("eam_rho_half", grid.capacity, "rho"),
                            ("eam_force_half", grid.capacity, "force"),
                            ("pair_half", lj_cap, "pair_energy")):
        shape = half_shape(cap_, kind)
        tiles[row] = {"smem_dynamic_bytes": shape.pop("smem_dynamic_bytes"),
                      "tile": shape}
    tiles["pair_half"]["launches_by_capacity"] = lj_report[
        "k12_launches_by_capacity"]
    tiles["pair_half"]["cap24"] = k12_cap24
    tiles["pair_half"]["phase7_last_state"] = lj_report["k12_last_state"]
    tiles["pair_half_mt"] = {"smem_dynamic_bytes": k12mt["tile"][
        "smem_dynamic_bytes"], "tile": {k: v for k, v in k12mt["tile"].items()
                                        if k != "smem_dynamic_bytes"},
        "capacity": k12mt["capacity"], "pairs": k12mt["pairs"]}
    launches["eam_rho_e_b8"] = b8_launches["eam_rho_e"]
    launches["eam_force_s_b8"] = b8_launches["eam_force_s"]
    out = []
    for n, src, rep in rows:
        kern = n.removesuffix("_b8")
        b = roofline(*work[kern])
        extra = {}
        if n == kern:
            for key, rep_ in (("launches_ablation", abl),
                              ("launches_physics", phys),
                              ("launches_fdtd", fdtd),
                              ("launches_restart_physics", r_phys),
                              ("launches_restart_fdtd", r_fdtd),
                              ("launches_eos", eos_report)):
                if rep_["launches"].get(n):
                    extra[key] = rep_["launches"][n]
            if gen_launches.get(n):
                extra["launches_general_ensembles"] = gen_launches[n]
            if cg_launches.get(n):
                extra["launches_eam_cg"] = cg_launches[n]
        out.append({
            "name": n, "route": "cuda", "source": f"imd_tpu_torch/csrc/{src}",
            "replaces": rep, "launches": launches[n], **extra,
            "max_abs_err": errs[n], "ms": ms[kern],
            "plain_ms": plain_ms[kern], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None,
            "share": b["bound_ms"] / ms[kern], "flops": b["flops"],
            "bytes": b["bytes"], **usage.get(kern, {}),
            **tiles.get(kern, {})})
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
