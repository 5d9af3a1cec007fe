"""CLI driver: ``python -m imd_tpu_torch -p params.imd [-r N]`` (port of
imd_tpu/__main__.py; the reference's ``imd -p file -r N``,
imd_param.c:4077).

Usage:
    python -m imd_tpu_torch -p params.imd [-r N] [--dtype float32|float64]
                            [--steps-override N] [--device cuda|cpu]

The parameter file may hold ``simulation K`` sections; each phase re-reads
the file at that phase (imd_param.c:314-318) and continues from the
previous phase's atoms.  ``maxsteps`` is the absolute last step, so a
restart or a later phase runs on to it.  The run executes on the CUDA card
unless ``--device cpu`` is given.  The UNIAX and NEB main variants raise
NotImplementedError.
"""

from __future__ import annotations

import argparse
import os
import sys


def count_phases(text: str) -> int:
    mx = 1
    for line in text.splitlines():
        toks = line.split()
        if toks and toks[0].lower() == "simulation" and len(toks) > 1:
            try:
                mx = max(mx, int(toks[1]))
            except ValueError:
                pass
    return mx


def main(argv=None, on_phase=None, timer=None) -> int:
    """Run every phase of a parameter file; ``on_phase(sim, state)`` is
    called after each phase's run (a hook for drivers that report on the
    run, such as chip_smoke.py), and ``timer`` (phases.CudaPhaseTimer)
    times the step's phases."""
    ap = argparse.ArgumentParser(
        prog="imd_tpu_torch",
        description="imd_tpu's param-file driver on PyTorch and CUDA")
    ap.add_argument("-p", "--paramfile", required=True)
    ap.add_argument("-r", "--restart", type=int, default=None,
                    help="restart number: read <outfiles>.<N>.{chkpt,itr}")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--steps-override", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from imd_tpu_torch.config import SimConfig, parse_param_text
    from imd_tpu_torch.phases import no_timer
    from imd_tpu_torch.simulation import Simulation
    from imd_tpu_torch.scene import n_atoms

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")
    with open(args.paramfile) as f:
        text = f.read()
    n_phases = count_phases(text)
    dtype = getattr(torch, args.dtype)
    workdir = os.path.dirname(os.path.abspath(args.paramfile)) or "."

    cfg0 = SimConfig.from_params(parse_param_text(text, phase=1))
    if any(cfg0.uniax_sig) or cfg0.uniax_r_cut > 0:
        raise NotImplementedError("the UNIAX driver is not ported to "
                                  "imd_tpu_torch (ROADMAP A9)")
    if cfg0.neb_nrep > 1:
        raise NotImplementedError("the NEB driver is not ported to "
                                  "imd_tpu_torch (ROADMAP A9)")

    prev_scene = None
    prev_step = 0
    for phase in range(1, n_phases + 1):
        cfg = SimConfig.from_params(parse_param_text(text, phase=phase))
        cfg.simulation_phase = phase
        cfg.validate()
        if args.restart is not None and phase == 1:
            # the plain `%d` name first, then the zero-padded `%05d` form
            # (imd_param.c:4178/4184)
            for fz in (str(args.restart), f"{args.restart:05d}"):
                cand = os.path.join(workdir, f"{cfg.outfiles}.{fz}.chkpt")
                if os.path.exists(cand):
                    cfg.coordname = f"{cfg.outfiles}.{fz}.chkpt"
                    cfg.itrname = f"{cfg.outfiles}.{fz}.itr"
                    cfg.restart_base = f"{cfg.outfiles}.{fz}"
                    break
            else:
                raise SystemExit(
                    f"restart {args.restart}: neither "
                    f"{cfg.outfiles}.{args.restart}.chkpt nor "
                    f"{cfg.outfiles}.{args.restart:05d}.chkpt exists in "
                    f"{workdir}")
        sim = Simulation(cfg, workdir=workdir, dtype=dtype,
                         device=args.device,
                         timer=no_timer if timer is None else timer)
        if prev_scene is not None:
            sim.adopt_scene(prev_scene)
            sim.step_count = prev_step
        steps = args.steps_override
        n_run = steps if steps is not None else sim._steps_to_run(None)
        print(f"# phase {phase}/{n_phases}: ensemble={cfg.ensemble} "
              f"steps={n_run} device={args.device}", flush=True)
        state = sim.run(steps=steps)
        if phase == n_phases and cfg.checkpt_int > 0:
            sim.write_checkpoint(state, -1)
        if on_phase is not None:
            on_phase(sim, state)
        prev_scene, prev_step = sim.scene, sim.step_count
        n = n_atoms(prev_scene)
        print(f"# phase {phase} done: step={prev_step} atoms={n} "
              f"epot/atom={state.epot_total / max(n, 1):.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
