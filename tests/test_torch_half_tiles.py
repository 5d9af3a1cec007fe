"""The launch shape of the half-stencil kernels K10-K12 (csrc/eam_half.cu),
on the CPU.

``forces_win.half_tile`` chooses, per capacity and kind, the cells a
block, the threads and the shared memory; the C entries check it
(``half_ok``) and launch with it.  These tests hold every shape the
wrappers can ask for (capacity 1 to the limit, K10, K11, and K12 and its
typed twin K12-mt with and without the energy) to the rules of
``half_ok`` and to the H100's 227 KB,
walk the kernels' sweep loop and the threads' shared memory indices, and
check the wrappers' limits.  No JAX.
"""

import pytest
import torch

from imd_tpu_torch import kernels
from imd_tpu_torch.ops import forces_pallas as fp
from imd_tpu_torch.ops import forces_win as win
from imd_tpu_torch.ops.geometry import Box, CellGrid

KINDS = ("rho", "force", "pair", "pair_energy", "pair_mt", "pair_energy_mt")
NOF = fp.NOF


def half_ok(t, cap, nf, mt=False):
    """eam_half.cu's half_ok: what the C entries assume of the shape."""
    threads = -(-cap * t.cpb // 32) * 32
    return (1 <= cap <= kernels.HALF_MAX_CAP and t.cpb >= 1
            and t.threads == threads
            and threads <= kernels.HALF_MAX_THREADS
            and t.smem == win.half_smem(cap, t.cpb, threads, nf, mt)
            and t.smem <= kernels.HALF_MAX_SMEM)


def regions(t, cap, nf, mt=False):
    """Sizes in elements of the kernels' shared arrays (carve_half): the
    staged float4 slots (the own cell and two views), the scratch floats,
    the mask words, the limits and the list entries, and K12-mt's
    coefficient rows (two tables of MAX_NT^2 rows of Poly's floats); with
    their byte offsets."""
    words = -(-cap // 32)
    sizes = {"v": (16, 3 * cap * t.cpb),
             "sc": (4, nf * cap * (cap * t.cpb + 1)),
             "mask": (4, words * cap * t.cpb),
             "lim": (4, 3 * t.cpb),
             "list": (2, cap * t.threads)}
    if mt:
        sizes["tab"] = (4, 2 * kernels.MAX_NT ** 2 * (kernels.NPOLY + 2))
    offs, off = {}, 0
    for name, (width, n) in sizes.items():
        assert off % width == 0, (name, off)
        offs[name] = off
        off += width * n
    return {k: n for k, (_, n) in sizes.items()}, offs, off


@pytest.mark.parametrize("kind", KINDS)
def test_every_half_tile_fits_and_meets_half_ok(kind):
    """Capacity 1 to HALF_MAX_CAP: the shape meets half_ok, fits the
    H100's 227 KB and its layout has no gap or misaligned array; whole
    warps; the cells a block are the largest power of two whose threads
    fit and, halved once more, are the first whose shared memory fits; at
    least 8 cells wherever 8 cells fit the thread limit (a warp reads whole
    32-byte sectors); dead slots from half of SENTINEL_DEAD."""
    nf = win.HALF_FIELDS[kind]
    mt = kind.endswith("_mt")
    for cap in range(1, kernels.HALF_MAX_CAP + 1):
        t = win.half_tile(cap, kind)
        assert half_ok(t, cap, nf, mt), (cap, kind)
        assert t.smem <= 227 * 1024 and t.threads % 32 == 0
        _, _, end = regions(t, cap, nf, mt)
        assert end == t.smem
        assert t.cpb & (t.cpb - 1) == 0
        assert cap * t.cpb <= kernels.HALF_MAX_THREADS
        c2 = 2 * t.cpb
        assert (cap * c2 > kernels.HALF_MAX_THREADS
                or win.half_smem(cap, c2, -(-cap * c2 // 32) * 32, nf, mt)
                > kernels.HALF_MAX_SMEM), (cap, kind)
        if 8 * cap <= kernels.HALF_MAX_THREADS:
            assert t.cpb >= 8, (cap, kind)
        assert t.dead == win.SENTINEL_DEAD / 2


def test_main_path_half_tiles():
    """K10 and K11 on the flagship (grid 42^3, cap 16; K10's one scratch
    field gives K11's shape), K12 on the LJ state at cap 16, and on phase
    7's grown grid (cap 24 and 32), as PERF.md states them."""
    t = win.half_tile(16, "rho")
    assert (t.cpb, t.threads, t.smem) == (16, 256, 38144)
    t = win.half_tile(16, "force")
    assert (t.cpb, t.threads, t.smem) == (16, 256, 38144)
    t = win.half_tile(16, "pair_energy")
    assert (t.cpb, t.threads, t.smem) == (16, 256, 54592)
    t = win.half_tile(24, "pair_energy")
    assert (t.cpb, t.threads, t.smem) == (8, 192, 56352)
    t = win.half_tile(32, "pair_energy")
    assert (t.cpb, t.threads, t.smem) == (8, 256, 95584)


def sweeps():
    """eam_half.cu's sweep loop: (sweep, staged array it reads, view copied
    during it and the array that copy goes to) for the own cell (sweep 0,
    array 0; the prologue copies view 0 to array 1) and the 13 views."""
    out = []
    for m in range(NOF + 1):
        a = 1 + ((m - 1) & 1) if m else 0
        copy = (m, 1 + (m & 1)) if m and m < NOF else None
        out.append((m, a, copy))
    return out


def test_every_sweep_reads_its_view_once_double_buffered():
    """Sweep 0 reads the own cell (array 0) and sweep m >= 1 the view m - 1
    (array 1 or 2); every view is copied exactly once, during the sweep
    before the one that reads it (the prologue for view 0), into the array
    that sweep reads, and never into the array the copying sweep itself
    reads (double buffering)."""
    sw = sweeps()
    assert [m for m, _, _ in sw] == list(range(NOF + 1))
    assert sw[0][1] == 0
    copies = {0: 1}   # the prologue: view 0 -> array 1
    for m, a, copy in sw:
        if copy is not None:
            view, dst = copy
            assert view not in copies
            assert dst != a and dst in (1, 2)
            copies[view] = dst
    assert sorted(copies) == list(range(NOF))
    for m, a, _ in sw[1:]:
        assert a == copies[m - 1]


@pytest.mark.parametrize("cap,kind", [
    (1, "rho"), (16, "rho"), (17, "rho"), (32, "rho"), (33, "rho"),
    (128, "rho"),
    (1, "force"), (2, "pair"), (3, "force"), (5, "pair_energy"),
    (8, "force"), (12, "pair"), (16, "force"), (16, "pair_energy"),
    (17, "pair"), (24, "pair_energy"), (31, "pair_energy"), (32, "force"),
    (33, "pair"), (48, "pair_energy"), (64, "force"), (100, "force"),
    (127, "pair"), (128, "force"), (128, "pair_energy")])
def test_padding_lanes_read_nothing(cap, kind):
    """carve_half: thread t is slot t // cpb of cell t % cpb; the threads
    past cap * cpb are the padding lanes of the last warp.  A padding lane
    stages, scans, flushes and writes nothing (it is neither a slot nor
    live).  Every index a slot's thread forms stays in its array: its
    staged slot and candidates, its scratch row and column, its column
    masks, its cell's limits and its list."""
    nf = win.HALF_FIELDS[kind]
    t = win.half_tile(cap, kind)
    size, _, _ = regions(t, cap, nf)
    words, row = -(-cap // 32), cap * t.cpb + 1
    pads = 0
    for tid in range(t.threads):
        s, cl = tid // t.cpb, tid % t.cpb
        if s >= cap:
            pads += 1
            continue
        for a in range(3):
            for j in (0, cap - 1, s):
                assert (a * cap + j) * t.cpb + cl < size["v"]
            assert a * t.cpb + cl < size["lim"]
        for f in range(nf):
            for i, j in ((s, 0), (s, cap - 1), (0, s), (cap - 1, s)):
                assert (f * cap + i) * row + j * t.cpb + cl < size["sc"]
        for w in range(words):
            assert (w * cap + s) * t.cpb + cl < size["mask"]
        assert (cap - 1) * t.threads + tid < size["list"]
    assert pads == t.threads - cap * t.cpb
    assert (pads > 0) == ((cap * t.cpb) % 32 != 0)


def test_wrappers_refuse_cap_129_and_fits_above_degree_12():
    """Above HALF_MAX_CAP the wrappers raise ValueError before any launch
    (the input check runs on CPU tensors too), and so does the launch
    rule; K10-K12's Horners stop at degree 12, so a fit above it raises
    too.  The params the kernels take carry the rule's shape (K10's
    ``half_tile(cap, "rho")``), are built once per fit, grid and kind
    (cached), and leave the params without a shape apart."""
    lim = kernels.HALF_MAX_CAP
    grid = CellGrid(box=Box.create([12.0, 0, 0], [0, 12.0, 0],
                                   [0, 0, 12.0]),
                    dims=(2, 2, 2), capacity=lim, cutoff=5.0, skin=0.5)
    for cap in (lim, lim + 1):
        xi = torch.zeros((cap, 3, 8))
        nbr = torch.zeros((NOF, cap, 3, 8))
        if cap <= lim:
            fp._check_half_inputs(xi, nbr, grid)
            continue
        with pytest.raises(ValueError, match="limit of 128 slots"):
            fp._check_half_inputs(xi, nbr, grid)
        for kind in KINDS:
            with pytest.raises(ValueError, match="capacity 129 outside"):
                win.half_tile(cap, kind)

    class Fit:
        def __init__(self, deg):
            self.host = ((tuple([0.5] * (deg + 1)), 1.0, 30.0),)

    g16 = grid.replace(capacity=16)
    fit = Fit(12)
    p = win._pair_params(fit, g16, 16, "pair_energy")
    assert bytes(p.half) == bytes(win.half_tile(16, "pair_energy"))
    assert p is win._pair_params(fit, g16, 16, "pair_energy")
    base = win._pair_params(fit, g16, 16)
    assert base is not p
    assert bytes(base.half) == bytes(kernels.HalfTile())
    with pytest.raises(ValueError, match="degree 13"):
        win._pair_params(Fit(13), g16, 16, "pair")

    class Eam:
        def __init__(self, deg):
            self.rho = self.pair = Fit(deg)

    eam = Eam(12)
    for cap in (16, 17, 32, lim):
        g = grid.replace(capacity=cap)
        p = win._params_for(eam, g, cap, half="rho")
        assert bytes(p.half) == bytes(win.half_tile(cap, "rho"))
        assert p.cap == cap
        assert p is win._params_for(eam, g, cap, half="rho")
    base = win._params_for(eam, g16, 16)
    assert base is not win._params_for(eam, g16, 16, half="rho")
    assert bytes(base.half) == bytes(kernels.HalfTile())
    with pytest.raises(ValueError, match="degree 13"):
        win._params_for(Eam(13), g16, 16, half="rho")
