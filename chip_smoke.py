"""Run the port's main paths on one CUDA card and check its kernels.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card (the kernels are built for sm_90a with nvcc)
and no JAX.  Phases, each of which fails the run loudly:

1. build the CUDA kernels of imd_tpu_torch/csrc into imd_tpu_torch/_build
   (one nvcc per source in parallel; printing nvcc's time and ptxas'
   registers, shared memory, spills);
2. build the flagship configuration (imd_tpu_torch/flagship.py: bench.py's
   default TTM-coupled fcc Al EAM run, 1,000,188 atoms, float32);
3. hold each kernel against its plain torch version at the main paths'
   shapes: K1 eam_rho and K2 eam_force, K4 eam_rho_e and K5 eam_force_s
   (the .eng observables, B4) on a jittered copy of the state and on the
   CPU tests' (3,2,2) grid (nn equal in all but 1e-5 of live slots, those
   holding a pair within an ulp of the cutoff; on the others rho and epot
   to 1e-5 and F to 1e-4 of their maxima, virial and pressure tensor to
   1e-4 relative beside the fit's jump at the flipped pairs; sum of forces
   ~0), K3 compact exactly, through a whole migration rebin of a jittered
   copy against the same rebin on the CPU; and the force kernels against
   the all-pairs oracle on a small input; and time each kernel beside its
   plain version;
4. drive the flagship main path from a warmed start (0.3 eV, so that the
   skin check fires and the rebin runs): 3 warm-up steps, then 3 x 20
   timed steps, with the launch counters set to 0 just before and read
   just after; every kernel of the step must have launched, the run must
   have rebinned, overflow must be 0, T_e finite, and the atom count and
   id set conserved;
5. time bench.py's configuration as is (0.026 eV start) the same way;
6. drive the param-file driver, ``python -m imd_tpu_torch`` in process
   (``imd_tpu_torch.__main__.main``), on the 1,024,000-atom ablation
   geometry of examples/ablation/run1m (its start.chkpt and EAM tables, the
   open x axis, the TTM on 256 cells, the Lambert-Beer laser of the
   flagship in place of its TMM laser) for 40 steps with .eng every 10 and
   one checkpoint, launch counters set to 0 just before: K4 and K5 must
   launch once per observe() call (4), K1 and K2 every step, every .eng
   value must be finite, the atom count and id set conserved, and the
   checkpoint and .itr written.  K3 runs there only when the skin check
   fires, so phase 4 is the one that requires its launches.  Then K1, K2,
   K4 and K5 are held against their plain versions, as in phase 3, at the
   driver's shapes: on its last state (grid 446 x 24 x 24, cap 24, open x,
   the run1m tables), and on that state rolled along x so that the open
   face cuts the film (the kernels must skip the cells across it).

Prints one JSON line each for the main path, the bench configuration and
the driver, one {"kernels": [...]} line (with each kernel's bound: the
larger of its FLOPs over the float32 peak and its bytes over the memory
rate, counted from this run's inputs), the card's name and power limit,
and last {"ok": true, "device": {...}}.
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
}


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


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


DRIVER_STEPS = 40
# examples/ablation/run1m/ablation_1m.imd without the TMM laser, NRB,
# FILTER and implicit solver, with the flagship's Lambert-Beer laser
DRIVER_PARAMS = """coordname {run1m}/start.chkpt
outfiles drv
ntypes 1
masses 26.9815
pbc_dirs 0 1 1
core_potential_file {run1m}/pair.pt
embedding_energy_file {run1m}/embed.pt
el_density_file {run1m}/rho.pt
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


def run_driver(dev_name: str, smi: str) -> dict:
    """Phase 6: ``python -m imd_tpu_torch -p`` in process on the 1M-atom
    ablation geometry; checks and prints the ``driver`` line, and returns
    it with the run's Simulation and last state."""
    import numpy as np
    import torch

    from imd_tpu_torch import __main__ as cli
    from imd_tpu_torch import kernels
    from imd_tpu_torch.io.chkpt import read_chkpt

    with tempfile.TemporaryDirectory(prefix="imd_drv_") as tmp:
        par = Path(tmp) / "drv.imd"
        par.write_text(DRIVER_PARAMS.format(run1m=RUN1M, steps=DRIVER_STEPS))
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
        for name in ("eam_rho_e", "eam_force_s"):
            check(launches[name] == n_obs,
                  f"{name} launched {launches[name]} times for {n_obs} "
                  "observe() calls")
        for name in ("eam_rho", "eam_force"):
            check(launches[name] == DRIVER_STEPS,
                  f"{name} launched {launches[name]} times in "
                  f"{DRIVER_STEPS} steps")
        eng = np.loadtxt(Path(tmp) / "drv.eng", ndmin=2)
        check(eng.shape == (DRIVER_STEPS // 10, 6),
              f".eng shape {eng.shape}")
        check(bool(np.isfinite(eng).all()), ".eng values finite")
        d0 = read_chkpt(str(RUN1M / "start.chkpt"))
        n_atoms = len(d0.number)
        ids = torch.sort(state.scene.id[state.scene.mask]).values.cpu()
        check(len(ids) == n_atoms and torch.equal(
            ids, torch.as_tensor(np.sort(d0.number), dtype=ids.dtype)),
            "driver: atom count and id set conserved")
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
    print(json.dumps({"driver": report}))
    return report, sim, state


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
    from imd_tpu_torch.ops import rebin_cl
    from imd_tpu_torch.ops.forces_fast import _roll_cells
    from imd_tpu_torch.ops.fused_step import scene_to_cl
    from imd_tpu_torch.ops.geometry import (Box, choose_grid,
                                            measured_capacity, with_capacity)
    from imd_tpu_torch.phases import CudaPhaseTimer
    from imd_tpu_torch.scene import make_scene

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

    # ---- 3. kernels vs their plain versions at the main-path shapes ---
    gen = torch.Generator(device="cuda").manual_seed(1)
    alive = cl0.alive

    def jittered(amp, frac=1.0):
        """Live positions + uniform(-amp, amp) on a fraction of atoms."""
        j = torch.empty_like(cl0.xi).uniform_(-amp, amp, generator=gen)
        pick = torch.rand(alive.shape, generator=gen, device=alive.device)
        pick = alive & (pick < frac)
        return torch.where(pick[:, None, :], cl0.xi + j, cl0.xi)

    def time_ms(fn, reps):
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

    # The degree-12 fit does not vanish at the cutoff (for the flagship's
    # fit rho_fit(rc^2) = 0.0117, 2 dphi/dr^2 = 1.29 there), so a pair
    # within an ulp of rc would count in one version and not the other if
    # r^2 rounded differently (the kernels round each multiply and add as
    # torch does, -fmad=false, so none is expected).  Slots whose
    # neighbour count agrees are held to the tolerances; the others must
    # differ by exactly the fit's jump at rc.
    def jumps(eam):
        """(rho, 1/2-less phi, gradient) jumps of the fit at rc^2."""
        rho_c, pair_c = eam.rho.host[0], eam.pair.host[0]
        return (abs(sum(rho_c[0])), abs(sum(pair_c[0])),
                abs(sum(win._deriv_coefs(pair_c)))
                + abs(sum(win._deriv_coefs(rho_c))) * 2.0)

    def check_eam(xi, alive, eam, grid, label):
        """K1 and K2 against their plain versions on one input; returns
        the max abs errors of rho and F over live slots, and the dF the F
        pass took."""
        rho_jump, _, grad_jump = jumps(eam)
        live = int(alive.sum())
        rho_k, nn_k = win.eam_rho(xi, alive, eam, grid)
        rho_p, nn_p = win.eam_rho_plain(xi, alive, eam, grid)
        agree = alive & (nn_k == nn_p)
        flips = alive & ~agree
        n_flip = int(flips.sum())
        rho_scale = float(rho_p[alive].abs().max())
        drho = (rho_k - rho_p).abs()
        rho_rel = float(drho[agree].max()) / rho_scale
        rho_abs = float(drho[alive].max())
        flip_off = float((drho - (nn_k - nn_p).abs() * rho_jump)[flips]
                         .abs().max()) if n_flip else 0.0
        print(f"K1 eam_rho ({label}): nn differs in {n_flip} of {live} live "
              f"slots (pairs at the cutoff); elsewhere max |drho| / max rho "
              f"= {rho_rel:.3e}; at those slots |drho| - |dnn| "
              f"rho_fit(rc^2) = {flip_off:.3e}; max abs {rho_abs:.3e}")
        check(n_flip <= 1e-5 * live, f"K1 neighbour counts ({label})")
        check(rho_rel <= 1e-5, f"K1 host density ({label})")
        check(flip_off <= 1e-5 * rho_scale,
              f"K1 density at cutoff flips ({label})")

        dF = (0.5 * eam.embed.interp(0, rho_p)[1] * alive.to(xi.dtype))
        F_k = win.eam_force(xi, alive, dF, eam, grid)
        F_p = win.eam_force_plain(xi, alive, dF, eam, grid)
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
        print(f"K2 eam_force ({label}): elsewhere max |dF| / max|F| = "
              f"{f_rel:.3e} (max|F| {f_max:.3e}); at the flip slots |dF| per "
              f"flip {f_flip:.3e} (bound {flip_bound:.3e}); max abs "
              f"{f_abs:.3e}; |sum F| / (N mean|F|) = {fs_k:.3e} (plain "
              f"{fs_p:.3e})")
        check(f_rel <= 1e-4, f"K2 forces ({label})")
        check(f_flip <= flip_bound, f"K2 forces at cutoff flips ({label})")
        # momentum: as well conserved as by the plain version, which rounds
        # alike (a pair missed on one side would leave ~1e-2)
        check(fs_k <= 1e-6 or fs_k <= 1.5 * fs_p,
              f"K2 momentum conservation ({label})")
        return rho_abs, f_abs, dF

    def check_b4(xi, alive, eam, grid, dF, label):
        """K4 and K5 against their plain versions on one input, with the
        dF of the plain density (as K2 is checked); returns the max abs
        errors of (rho, e) and (F, S) over live slots."""
        rho_jump, phi_jump, grad_jump = jumps(eam)
        t_embed = eam.embed
        live = int(alive.sum())
        rho_k, nn_k, e_k = b4.eam_rho_e(xi, alive, eam, grid)
        rho_p, nn_p, e_p = b4.eam_rho_e_plain(xi, alive, eam, grid)
        agree = alive & (nn_k == nn_p)
        flips = alive & ~agree
        n_flip = int(flips.sum())
        dnn = (nn_k - nn_p).abs()
        rho_scale = float(rho_p[alive].abs().max())
        drho = (rho_k - rho_p).abs()
        de = (e_k - e_p).abs()
        af = alive.to(xi.dtype)
        epot_k = (e_k + t_embed.interp(0, rho_k)[0]) * af
        epot_p = (e_p + t_embed.interp(0, rho_p)[0]) * af
        ep_scale = float(epot_p[alive].abs().max())
        rho_rel = float(drho[agree].max()) / rho_scale
        ep_rel = float((epot_k - epot_p).abs()[agree].max()) / ep_scale
        e_flip = float((de - 0.5 * dnn * phi_jump)[flips].abs().max()) \
            if n_flip else 0.0
        rho_flip = float((drho - dnn * rho_jump)[flips].abs().max()) \
            if n_flip else 0.0
        print(f"K4 eam_rho_e ({label}): nn differs in {n_flip} of {live} "
              f"live slots; elsewhere max |drho| / max rho = {rho_rel:.3e}, "
              f"max |depot| / max|epot| = {ep_rel:.3e}; at those slots "
              f"|drho| - |dnn| rho_fit(rc^2) = {rho_flip:.3e}, |de| - "
              f"|dnn| phi_fit(rc^2)/2 = {e_flip:.3e}")
        check(n_flip <= 1e-5 * live, f"K4 neighbour counts ({label})")
        check(rho_rel <= 1e-5 and ep_rel <= 1e-5,
              f"K4 density and epot ({label})")
        check(rho_flip <= 1e-5 * rho_scale and e_flip <= 1e-5 * ep_scale,
              f"K4 density and energy at cutoff flips ({label})")
        k4_err = max(float(drho[alive].max()), float(de[alive].max()))

        # K5 tests the cutoff as K1 does: its cutoff flips are K1's
        _, nn_k1 = win.eam_rho(xi, alive, eam, grid)
        agree = alive & (nn_k1 == nn_p)
        flips = alive & ~agree
        dnn = (nn_k1 - nn_p).abs()
        F_k, S_k = b4.eam_force_s(xi, alive, dF, eam, grid)
        F_p, S_p = b4.eam_force_s_plain(xi, alive, dF, eam, grid)
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
        print(f"K5 eam_force_s ({label}): nn (K1) differs in "
              f"{int(flips.sum())} live slots; elsewhere max |dF| / max|F| = "
              f"{f_rel:.3e}; presstens kernel {pt_k.tolist()} plain "
              f"{pt_p.tolist()} (max |d| / max|p| "
              f"{float(dpt.max() / pt_p.abs().max()):.3e}, flip allowance "
              f"{flip_pt:.3e}); virial {vir_k:.6e} vs {vir_p:.6e}")
        check(f_rel <= 1e-4, f"K5 forces ({label})")
        check(pt_ok and vir_ok, f"K5 pressure tensor and virial ({label})")
        F_w = win.eam_force(xi, alive, dF, eam, grid)
        check(float((F_k - F_w).abs().max()) <= 1e-6 * f_max,
              f"K5 forces equal K2's ({label})")
        k5_err = max(float((F_k - F_p).abs().amax(1)[alive].max()),
                     float((S_k - S_p).abs().amax(0)[alive].max()))
        return k4_err, k5_err, nn_k

    xi = jittered(0.1)
    rho_abs, f_abs, dF = check_eam(xi, alive, eam, grid, "main path")
    k4_abs, k5_abs, nn_main = check_b4(xi, alive, eam, grid, dF,
                                       "main path")

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
    t_rho, t_f, t_dF = check_eam(tcl.xi, tcl.alive, eam, tgrid, tlabel)
    t_k4, t_k5, _ = check_b4(tcl.xi, tcl.alive, eam, tgrid, t_dF, tlabel)
    rho_abs, f_abs = max(rho_abs, t_rho), max(f_abs, t_f)
    k4_abs, k5_abs = max(k4_abs, t_k4), max(k5_abs, t_k5)

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
    sF, srho, snn = win.eam_kernels_win_split(sxi, scl.alive, small.eam,
                                              small.grid,
                                              count_neighbors=True)
    pos = sxi.permute(0, 2, 1)[scl.alive].double()
    oF, orho, onn = t_forces.eam_forces_n2(
        pos, torch.ones(len(pos), dtype=torch.bool, device="cuda"),
        small.grid.box, small.eam.at_host_precision())
    # pairs within 1e-3 A^2 of the cutoff may count differently in f32;
    # atoms holding one are left out of the value comparison (see K1)
    dr = t_forces.min_image(small.grid.box, pos[:, None] - pos[None])
    near = int((((dr * dr).sum(-1) - small.grid.cutoff ** 2).abs()
                < 1e-3).sum())
    same = snn[scl.alive].double() == onn
    o_nn = int((~same).sum())
    o_rho = float(((srho[scl.alive].double() - orho).abs() / orho)[same]
                  .max())
    o_f = float((sF.permute(0, 2, 1)[scl.alive].double() - oF).abs()[same]
                .max() / oF.abs().max())
    print(f"oracle ({len(pos)} atoms): nn differs in {o_nn} ({near} pairs "
          f"near the cutoff), elsewhere rho rel {o_rho:.3e}, F rel "
          f"{o_f:.3e}")
    check(o_nn <= near and o_rho <= 1e-5 and o_f <= 1e-4,
          "force kernels vs the all-pairs oracle")

    # kernel and plain-version times at the main-path shapes
    t_k1 = time_ms(lambda: win.eam_rho(xi, alive, eam, grid), 10)
    t_p1 = time_ms(lambda: win.eam_rho_plain(xi, alive, eam, grid), 3)
    t_k2 = time_ms(lambda: win.eam_force(xi, alive, dF, eam, grid), 10)
    t_p2 = time_ms(lambda: win.eam_force_plain(xi, alive, dF, eam, grid), 3)
    t_k4 = time_ms(lambda: b4.eam_rho_e(xi, alive, eam, grid), 10)
    t_p4 = time_ms(lambda: b4.eam_rho_e_plain(xi, alive, eam, grid), 3)
    t_k5 = time_ms(lambda: b4.eam_force_s(xi, alive, dF, eam, grid), 10)
    t_p5 = time_ms(lambda: b4.eam_force_s_plain(xi, alive, dF, eam, grid),
                   3)
    oc = grid.capacity + 8
    t_k3 = time_ms(lambda: rebin_cl.compact(tgt, candf, candi, oc), 10)
    t_p3 = time_ms(lambda: rebin_cl._compact_plain(tgt, candf, candi, oc), 3)

    # bounds at these inputs: each in-cutoff pair once (nn counts it from
    # both sides), each input byte read once, each output written once
    pairs = float(nn_main[alive].double().sum()) / 2.0
    slots = alive.numel()
    bytes_slot = {"eam_rho": 12 + 1 + 8, "eam_rho_e": 12 + 1 + 12,
                  "eam_force": 12 + 1 + 4 + 12,
                  "eam_force_s": 12 + 1 + 4 + 12 + 24}
    work = {n: (FLOPS_PER_PAIR[n] * pairs, bytes_slot[n] * slots)
            for n in FLOPS_PER_PAIR}
    k3_out = (candf.shape[0] + candi.shape[0]) * oc * tgt.shape[1] * 4
    work["compact"] = (0.0, sum(t.numel() * t.element_size()
                                for t in (tgt, candf, candi)) + k3_out)
    del xi, xi_m, cl_m, cl_c, cl_k, cl_p, small, scl, tcl
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
    del fs, cl, tg
    torch.cuda.empty_cache()

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

    # K1/K2/K4/K5 against their plain versions at the driver's shapes
    # (its grid, capacity, open x axis and EAM tables), on its last state
    dcl = scene_to_cl(state.scene)
    dgrid, deam = sim.grid, sim.eam_run
    dlabel = f"driver end, dims {dgrid.dims} cap {dgrid.capacity} pbc " \
             f"{dgrid.box.pbc}"
    d_rho, d_f, d_dF = check_eam(dcl.xi, dcl.alive, deam, dgrid, dlabel)
    d_k4, d_k5, _ = check_b4(dcl.xi, dcl.alive, deam, dgrid, d_dF, dlabel)
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
    r_rho, r_f, r_dF = check_eam(xr, ar, deam, dgrid, rlabel)
    r_k4, r_k5, _ = check_b4(xr, ar, deam, dgrid, r_dF, rlabel)
    rho_abs, f_abs = max(rho_abs, d_rho, r_rho), max(f_abs, d_f, r_f)
    k4_abs = max(k4_abs, d_k4, r_k4)
    k5_abs = max(k5_abs, d_k5, r_k5)
    del dcl, xr, ar, sim, state

    rows = [("eam_rho", "eam_win.cu", "imd_tpu/ops/forces_win.py:306",
             rho_abs, t_k1, t_p1),
            ("eam_force", "eam_win.cu", "imd_tpu/ops/forces_win.py:411",
             f_abs, t_k2, t_p2),
            ("compact", "rebin_compact.cu", "imd_tpu/ops/rebin_cl.py:66",
             k3_err, t_k3, t_p3),
            ("eam_rho_e", "eam_win.cu", "imd_tpu/ops/forces_pallas.py:275",
             k4_abs, t_k4, t_p4),
            ("eam_force_s", "eam_win.cu",
             "imd_tpu/ops/forces_pallas.py:345", k5_abs, t_k5, t_p5)]
    out = []
    for n, src, rep, err, ms, pms in rows:
        flops, nbytes = work[n]
        t_ops = flops / PEAK_F32_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out.append({
            "name": n, "route": "cuda", "source": f"imd_tpu_torch/csrc/{src}",
            "replaces": rep, "launches": launches[n], "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": None, "flops": flops, "bytes": nbytes})
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
