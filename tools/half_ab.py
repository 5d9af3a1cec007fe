"""Hold the half-stencil kernels K10-K12 of this tree against another
tree's build of ``csrc/eam_half.cu``, in one process on one CUDA card.

    python3 tools/half_ab.py --other DIR [--rounds 2] [--reps 20]
                             [--out FILE]

DIR is the root of another checkout of the port (an earlier commit
unpacked with ``git archive``) whose ``eam_half.cu`` has the same C entries
and whose ``eam_common.cuh`` has the same ``EamParams``.  The script builds
that source alone with ``kernels.NVCC_FLAGS`` into
``imd_tpu_torch/_build/``, binds its entries with ctypes, and runs both
builds on the same inputs: the flagship's state (1,000,188 atoms, grid
42^3 of capacity 16) with every live position jittered by up to 0.1 A
from a seed, and its 13 half-stencil views.

- K10 with the count within the cutoff (the main path's call) and within
  0.9 of it; K11 with dF from the plain density; K12 with the
  examples/melt_quench LJ fit (to_fastpoly, vcap 50), the energy and the
  stress, as the general step calls it.
- Live outputs (the i-sums of live slots, the j-partials of live view
  entries) compared bit for bit, as int32.
- CUDA-event ms of each kernel, ``--reps`` launches each, the builds in
  the order other, this, this, other in each of ``--rounds`` rounds.
- ptxas' registers and spills of both builds.

Prints the card's name and power limit and one JSON line; ``--out`` also
writes the JSON there.  Exits non-zero without a CUDA card, when a build
fails, or when a live output differs.
"""

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def build_other(root: Path):
    """Compile ``root``'s eam_half.cu alone into a shared library; returns
    (path, nvcc's log)."""
    from imd_tpu_torch import kernels
    csrc = root / "imd_tpu_torch" / "csrc"
    src = csrc / "eam_half.cu"
    h = hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
    for name in ("eam_half.cu", "eam_common.cuh"):
        h.update((csrc / name).read_bytes())
    so = kernels.BUILD_DIR / f"other_eam_half_{h.hexdigest()[:16]}.so"
    kernels.BUILD_DIR.mkdir(exist_ok=True)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(so),
           str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{res.stdout}"
                           f"\n{res.stderr}")
    return so, res.stdout + res.stderr


def bind(path):
    """The three half-stencil entries of a library, typed as
    kernels.lib() types them."""
    from imd_tpu_torch import kernels
    cdll = ctypes.CDLL(str(path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pp = ctypes.POINTER(kernels.EamParams)
    cdll.imd_eam_rho_half.argtypes = [vp, vp, vp, vp, ci, cf, pp, ci, vp]
    cdll.imd_eam_force_half.argtypes = [vp, vp, vp, vp, vp, vp, pp, ci, vp]
    cdll.imd_pair_half.argtypes = [vp, vp, vp, vp, vp, ci, ci, cf, pp, ci,
                                   vp]
    for fn in (cdll.imd_eam_rho_half, cdll.imd_eam_force_half,
               cdll.imd_pair_half):
        fn.restype = ci
    return cdll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("half_ab: no CUDA device", file=sys.stderr)
        return 1
    from imd_tpu_torch import flagship, kernels
    from imd_tpu_torch.models.potential import lj_table, to_fastpoly
    from imd_tpu_torch.ops import forces_pallas as b4
    from imd_tpu_torch.ops import forces_win as win

    smi = smi_line()
    print(f"nvidia-smi: {smi}")
    info = kernels.build()
    libs = {"this": kernels.lib()}
    other_so, other_log = build_other(args.other.resolve())
    libs["other"] = bind(other_so)
    usage = {"this": kernels.ptxas_usage(info.log),
             "other": kernels.ptxas_usage(other_log)}
    names = ("eam_rho_half", "eam_force_half", "pair_half")
    ptxas = {b: {n: usage[b].get(n) for n in names} for b in usage}
    print(f"ptxas: {ptxas}")

    fs = flagship.build(device="cuda")
    grid, eam = fs.grid, fs.eam
    cl = fs.carry[0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    jit = torch.empty_like(cl.xi).uniform_(-0.1, 0.1, generator=gen)
    xi = torch.where(cl.alive[:, None, :], cl.xi + jit, cl.xi).contiguous()
    alive = cl.alive
    del fs, cl, jit
    nbr = b4.make_neighbor_views(grid, xi.dtype, xi.device)(xi)
    cap, _, nc = xi.shape
    live_j = nbr[:, :, 0] < win.SENTINEL_DEAD / 2          # [13, cap, NC]
    rho, _ = b4.eam_r_pass_plain(xi, nbr, eam, grid)
    dF = (0.5 * eam.embed.interp(0, rho)[1] * alive.to(xi.dtype)).contiguous()
    dFn = b4._dF_views(dF, grid.dims).contiguous()
    del rho
    pot = to_fastpoly(lj_table(0.35, 2.62, grid.cutoff), vcap=50.0)
    stream = kernels.stream_ptr(xi.device)
    rc2 = float(grid.cutoff) ** 2

    def empty(*shape):
        return torch.empty(shape, dtype=xi.dtype, device=xi.device)

    def k10(nr2):
        p = win._params_for(eam, grid, cap, half="rho")

        def run(lib):
            oi, oj = empty(2, cap, nc), empty(2, b4.NOF, cap, nc)
            kernels.check(lib.imd_eam_rho_half(
                xi.data_ptr(), nbr.data_ptr(), oi.data_ptr(), oj.data_ptr(),
                1, nr2, p, nc, stream), "eam_rho_half")
            return oi, oj
        return run

    def k11(lib):
        p = win._params_for(eam, grid, cap, half="force")
        oi, oj = empty(3, cap, nc), empty(3, b4.NOF, cap, nc)
        kernels.check(lib.imd_eam_force_half(
            xi.data_ptr(), nbr.data_ptr(), dF.data_ptr(), dFn.data_ptr(),
            oi.data_ptr(), oj.data_ptr(), p, nc, stream), "eam_force_half")
        return oi, oj

    def k12(lib):
        p = win._pair_params(pot, grid, cap, "pair_energy")
        oi, os_, oj = (empty(4, cap, nc), empty(6, cap, nc),
                       empty(4, b4.NOF, cap, nc))
        kernels.check(lib.imd_pair_half(
            xi.data_ptr(), nbr.data_ptr(), oi.data_ptr(), os_.data_ptr(),
            oj.data_ptr(), 1, 0, rc2, p, nc, stream), "pair_half")
        return oi, oj, os_

    cases = {"eam_rho_half": k10(rc2),
             "eam_rho_half nr2 = (0.9 rc)^2": k10((0.9 * grid.cutoff) ** 2),
             "eam_force_half": k11, "pair_half": k12}

    def live_bits(outs):
        """The live outputs as int32: i-sums (and K12's stress) at live
        slots, j-partials at live view entries."""
        parts = []
        for o in outs:
            if o.dim() == 3:
                parts.append(o[:, alive].contiguous().view(torch.int32))
            else:
                parts.append(o[:, live_j].contiguous().view(torch.int32))
        return parts

    result = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
              "other": str(args.other), "atoms": int(alive.sum()),
              "grid": list(grid.dims), "capacity": cap, "ptxas": ptxas,
              "cases": {}}
    ok = True
    for name, run in cases.items():
        a = live_bits(run(libs["other"]))
        b = live_bits(run(libs["this"]))
        c = live_bits(run(libs["this"]))
        differ = sum(int((x != y).sum()) for x, y in zip(a, b))
        again = all(torch.equal(x, y) for x, y in zip(b, c))
        ok &= differ == 0 and again
        result["cases"][name] = {
            "live_outputs": sum(x.numel() for x in a),
            "differing_bits": differ, "same_bits_twice": again,
            "ms": {"other": [], "this": []}}
        del a, b, c

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(args.reps):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / args.reps

    for _ in range(args.rounds):
        for build in ("other", "this", "this", "other"):
            for name, run in cases.items():
                result["cases"][name]["ms"][build].append(
                    time_ms(lambda: run(libs[build])))
    for name, case in result["cases"].items():
        t = case["ms"]
        print(f"{name}: live outputs {case['live_outputs']}, differing "
              f"{case['differing_bits']}, same bits twice "
              f"{case['same_bits_twice']}; ms other {t['other']} this "
              f"{t['this']}")
    line = json.dumps({"half_ab": result})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(smi)
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
