"""Build and load the hand-written CUDA kernels of ``csrc/``.

Route: ``nvcc`` compiles every ``csrc/*.cu`` file for ``sm_90a`` (Hopper),
one process per source, all started together, and links the objects into
one shared library with a plain C interface, loaded with ``ctypes``.
Each C entry takes device pointers and the stream as ``c_void_p`` and
returns ``cudaGetLastError()``; ``check`` raises when that is not 0.

The library is built at first use into ``imd_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the sources and flags so a changed
source never loads a stale build.  Delete that directory to force a
rebuild.  Nothing here runs at import: the CPU tests import every module.

``LAUNCHES`` counts kernel launches per kernel.  Each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("eam_win.cu", "eam_half.cu", "rebin_compact.cu")
HEADERS = ("eam_common.cuh",)
# -fmad=false: no multiply-add contraction, so the kernels round like
# torch's eager mul + add (see eam_win.cu, "Rounding")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

NPOLY = 16            # padded Horner length baked per polynomial (deg <= 15)
MAX_GRID_Y = 65535    # CUDA's gridDim.y limit: candidates (K3)
MAX_NT = 4            # species the multi-type kernels take (eam_win.cu)
# the full-stencil kernels (eam_win.cu): their Horners stop at degree
# WIN_DEG (the derivatives at WIN_DEG - 1), and a block stages the halo
# tile of at most WIN_MAX_TXY x WIN_MAX_TXY x WIN_MAX_TZ cells with
# WIN_MAX_THREADS threads in at most WIN_MAX_SMEM bytes of shared memory
# (the H100's 227 KB), with a pair list of cap + WIN_LIST_SLACK entries
# per thread
WIN_DEG = 12
WIN_MAX_CAP = 128
WIN_MAX_TXY = 2
WIN_MAX_TZ = 8
WIN_MAX_THREADS = 512
WIN_MAX_SMEM = 232448
WIN_LIST_SLACK = 64
HALF_MAX_CAP = 128    # capacity the half-stencil kernels take: one cell's
                      # [cap][cap] scratches in shared memory (eam_half.cu)
# K10-K12's launch shape (ops/forces_win.py:half_tile): at most
# HALF_MAX_THREADS threads a block in at most HALF_MAX_SMEM bytes
HALF_MAX_THREADS = 256
HALF_MAX_SMEM = WIN_MAX_SMEM
# order of the tables in the multi-type coefficient buffer
# [4][ntypes^2][NPOLY + 2] (eam_win.cu: T_RHO_V ...)
MT_TABLES = ("rho_v", "pair_v", "pair_g", "rho_g")

LAUNCHES = {"eam_rho": 0, "eam_force": 0, "compact": 0, "eam_rho_e": 0,
            "eam_force_s": 0, "eam_rho_mt": 0, "eam_force_mt": 0,
            "eam_rho_e_mt": 0, "eam_force_s_mt": 0, "eam_rho_half": 0,
            "eam_force_half": 0, "pair_half": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Poly(ctypes.Structure):
    """Horner polynomial in t = clip(x*a - b0, -1, 1), coefficients c[k]
    of t^k (zero-padded to NPOLY).  Mirrors ``struct Poly`` in
    eam_common.cuh."""
    _fields_ = [("c", ctypes.c_float * NPOLY), ("a", ctypes.c_float),
                ("b0", ctypes.c_float)]


class WinTile(ctypes.Structure):
    """Mirrors ``struct WinTile`` in eam_common.cuh: the full-stencil
    kernels' launch tile (ops/forces_win.py:win_tile)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "tx", "ty", "tz", "ntx", "nty", "ntz", "threads", "list_len",
        "pos_off", "tab_off", "typ_off", "list_off", "smem")]


class HalfTile(ctypes.Structure):
    """Mirrors ``struct HalfTile`` in eam_common.cuh: K10-K12's launch
    shape and dead-slot threshold (ops/forces_win.py:half_tile)."""
    _fields_ = [*((name, ctypes.c_int) for name in (
        "cpb", "threads", "smem")), ("dead", ctypes.c_float)]


class EamParams(ctypes.Structure):
    """Mirrors ``struct EamParams`` in eam_common.cuh."""
    _fields_ = [("rho_v", Poly), ("pair_g", Poly), ("rho_g", Poly),
                ("pair_v", Poly), ("rcut2", ctypes.c_float),
                ("h", ctypes.c_float * 9), ("pbc", ctypes.c_int * 3),
                ("gx", ctypes.c_int), ("gy", ctypes.c_int),
                ("gz", ctypes.c_int), ("cap", ctypes.c_int),
                ("tile", WinTile), ("half", HalfTile)]


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float      # nvcc wall time (0 when an existing build was reused)
    log: str            # nvcc's output, including -Xptxas -v resource usage
                        # (kept beside the library, so a reused build has it)
    reused: bool


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((home + "/bin/nvcc") if home else None,
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "build only on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile csrc/*.cu into _build/ unless this exact build exists: one
    nvcc per source in parallel, then one link."""
    so = BUILD_DIR / f"libimd_tpu_torch_{_digest()}.so"
    log_file = so.with_suffix(".log")
    if so.exists():
        log = log_file.read_text() if log_file.exists() else ""
        return BuildInfo(so, 0.0, log, True)
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{tag}.{Path(name).stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC_DIR / name)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(obj)
    log = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    tmp = so.with_name(f"{tag}.so.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    seconds = time.perf_counter() - t0
    log_file.write_text("".join(log))
    os.replace(tmp, so)
    for o in objs:
        o.unlink()
    return BuildInfo(so, seconds, "".join(log), False)


_lib = None


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        cdll = ctypes.CDLL(str(build().path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        cdll.imd_eam_rho.argtypes = [vp, vp, vp, vp,
                                     ctypes.POINTER(EamParams), ci, vp]
        cdll.imd_eam_rho_e.argtypes = [vp, vp, vp, vp, vp,
                                       ctypes.POINTER(EamParams), ci, vp]
        cdll.imd_eam_force.argtypes = [vp, vp, vp, vp,
                                       ctypes.POINTER(EamParams), ci, vp]
        cdll.imd_eam_force_s.argtypes = [vp, vp, vp, vp, vp,
                                         ctypes.POINTER(EamParams), ci, vp]
        cdll.imd_compact.argtypes = [vp, vp, vp, vp, vp,
                                     ci, ci, ci, ci, ci, vp]
        # multi-type: xi, typ, tab, nt, [dF,] outputs, params, nc, stream
        pp = ctypes.POINTER(EamParams)
        cdll.imd_eam_rho_mt.argtypes = [vp, vp, vp, ci, vp, vp, pp, ci, vp]
        cdll.imd_eam_rho_e_mt.argtypes = [vp, vp, vp, ci, vp, vp, vp, pp,
                                          ci, vp]
        cdll.imd_eam_force_mt.argtypes = [vp, vp, vp, ci, vp, vp, pp, ci,
                                          vp]
        cdll.imd_eam_force_s_mt.argtypes = [vp, vp, vp, ci, vp, vp, vp, pp,
                                            ci, vp]
        # half stencil: xi, nbr, [dF, dFn,] out_i, out_j, [count, nr2,]
        # params, nc, stream
        cdll.imd_eam_rho_half.argtypes = [vp, vp, vp, vp, ci, ctypes.c_float,
                                          pp, ci, vp]
        cdll.imd_eam_force_half.argtypes = [vp, vp, vp, vp, vp, vp, pp, ci,
                                            vp]
        # pair: xi, nbr, out_i, out_s, out_j, energy, count, nr2, params,
        # nc, stream
        cdll.imd_pair_half.argtypes = [vp, vp, vp, vp, vp, ci, ci,
                                       ctypes.c_float, pp, ci, vp]
        for fn in (cdll.imd_eam_rho, cdll.imd_eam_rho_e, cdll.imd_eam_force,
                   cdll.imd_eam_force_s, cdll.imd_compact,
                   cdll.imd_eam_rho_mt, cdll.imd_eam_rho_e_mt,
                   cdll.imd_eam_force_mt, cdll.imd_eam_force_s_mt,
                   cdll.imd_eam_rho_half, cdll.imd_eam_force_half,
                   cdll.imd_pair_half):
            fn.restype = ci
        _lib = cdll
    return _lib


# the CUDA symbol of each kernel row: eam_win.cu's templates by their
# <ENERGY|STRESS, MT> flags, the others by name
WIN_FLAGS = {"eam_rho": ("rho", 0, 0), "eam_force": ("force", 0, 0),
             "eam_rho_e": ("rho", 1, 0), "eam_force_s": ("force", 1, 0),
             "eam_rho_mt": ("rho", 0, 1), "eam_force_mt": ("force", 0, 1),
             "eam_rho_e_mt": ("rho", 1, 1),
             "eam_force_s_mt": ("force", 1, 1)}
OTHER_SYMBOLS = {"compact": "compact_kernel",
                 "eam_rho_half": "eam_rho_half_kernel",
                 "eam_force_half": "eam_force_half_kernel",
                 "pair_half": "pair_half_kernel"}


def ptxas_usage(log: str) -> dict:
    """Per kernel row: registers, spill bytes (stores + loads) and static
    shared memory from nvcc's -Xptxas -v output."""
    entries, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = entries.setdefault(m.group(1), {})
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            cur = entries.get(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem_static_bytes"] = int(m.group(1)) if m else 0
    usage = {}
    for sym, u in entries.items():
        m = re.search(r"eam_(rho|force)_kernelILb([01])ELb([01])E", sym)
        for row, want in WIN_FLAGS.items():
            if m and (m.group(1), int(m.group(2)), int(m.group(3))) == want:
                usage[row] = u
        for row, name in OTHER_SYMBOLS.items():
            if re.search(rf"\d{name}\w*$", sym) and "ILb" not in sym:
                usage[row] = u
    return usage


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
