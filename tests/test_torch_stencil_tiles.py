"""The full-stencil kernels' launch tile (csrc/eam_win.cu), on the CPU.

``forces_win.win_tile`` chooses, per capacity, grid depth along z and
species count, the block's run of cells, its size, the pair-list length and
its shared-memory layout; the C entries check it (``tile_ok``) and launch
with it.  These tests hold every tile the wrappers can ask for (capacity 1
to the limit, 1 to 4 species, the four flag pairs) to the rules of
``tile_ok`` and to the H100's 227 KB, walk the kernel's staging loop, and
check the wrappers' capacity and degree limits.  No JAX.
"""

import types

import pytest
import torch

from imd_tpu_torch import kernels
from imd_tpu_torch.ops import forces_win as win
from imd_tpu_torch.ops.geometry import Box, CellGrid

PROW = kernels.NPOLY + 2
# grids the port builds (the flagship 42^3, the run1m film 446 x 24 x 24,
# the CPU tests' 3 x 2 x 2) and small, thin, prime and large ones
DIMS = ((1, 1, 1), (3, 2, 2), (2, 3, 7), (3, 4, 11), (446, 24, 24),
        (42, 42, 42), (5, 1, 97))
# the eight instantiations <ENERGY|STRESS, MT> by their wrappers' species
FLAG_PAIRS = [(flag, nt) for flag in (False, True) for nt in (1, 2, 3, 4)]


def tile_ok(w, cap, dims, nt):
    """eam_win.cu's tile_ok: what the C entries assume of the tile."""
    for t, nb, g in zip((w.tx, w.ty, w.tz), (w.ntx, w.nty, w.ntz), dims):
        if not (1 <= t <= g and nb >= 1 and t * nb >= g
                and (nb - 1) * t < g):
            return False
    tz2, rows = w.tz + 2, (w.tx + 2) * (w.ty + 2)
    nslots = rows * cap * tz2
    ok = (w.tx <= kernels.WIN_MAX_TXY and w.ty <= kernels.WIN_MAX_TXY
          and w.tz <= kernels.WIN_MAX_TZ and w.threads % 32 == 0
          and w.tx * w.ty * w.tz * cap <= w.threads
          <= kernels.WIN_MAX_THREADS and w.list_len >= cap
          and nslots <= 65536 and w.pos_off >= 16 * rows * tz2
          and w.pos_off % 16 == 0)
    end = w.pos_off + 16 * nslots
    if nt > 1:
        ok = ok and w.tab_off >= end and w.tab_off % 4 == 0 \
            and w.typ_off >= w.tab_off + 2 * nt * nt * PROW * 4
        end = w.typ_off + nslots
    return ok and w.list_off >= end and w.list_off % 4 == 0 \
        and w.smem >= w.list_off + 2 * w.threads * w.list_len \
        and w.smem <= kernels.WIN_MAX_SMEM


def fits(t, cap, nt, dims):
    w = win._tile_layout(t, cap, nt, dims)
    return (t[0] * t[1] * t[2] * cap <= kernels.WIN_MAX_THREADS
            and w.smem <= kernels.WIN_MAX_SMEM)


@pytest.mark.parametrize("flag,nt", FLAG_PAIRS)
def test_every_tile_fits_and_meets_tile_ok(flag, nt):
    """Capacity 1 to WIN_MAX_CAP: the tile meets tile_ok, fits the H100's
    227 KB, is laid out without gaps, and follows win_tile's rule: 2 x 2
    cells across (fewer on a thinner grid), 1 x 1 only where no 2 x 2 run
    fits; along z the fewest blocks a fitting run allows, with the
    shortest such run.  ``flag`` (energy or stress) does not change the
    tile: the wrappers of K1/K4 (K2/K5, and the alloy pairs) pass the same
    one."""
    for dims in DIMS:
        wide = (min(2, dims[0]), min(2, dims[1]))
        for cap in range(1, kernels.WIN_MAX_CAP + 1):
            w = win.win_tile(cap, dims, nt)
            assert tile_ok(w, cap, dims, nt), (cap, dims, nt)
            assert w.smem <= 227 * 1024
            assert w.list_len == cap + kernels.WIN_LIST_SLACK
            cells = (w.tx + 2) * (w.ty + 2) * (w.tz + 2)
            tab = 2 * nt * nt * PROW * 4 if nt > 1 else 0
            types_ = cells * cap if nt > 1 else 0
            body = 16 * cells + 16 * cells * cap + tab + types_
            assert w.smem == -(-body // 4) * 4 + 2 * w.threads * w.list_len
            zs = range(1, min(kernels.WIN_MAX_TZ, dims[2]) + 1)
            if (w.tx, w.ty) != wide:
                assert (w.tx, w.ty) == (1, 1)
                assert not any(fits((*wide, tz), cap, nt, dims) for tz in zs)
            fit = [tz for tz in zs if fits((w.tx, w.ty, tz), cap, nt, dims)]
            assert w.ntz == min(-(-dims[2] // tz) for tz in fit)
            assert w.tz == 1 or -(-dims[2] // (w.tz - 1)) > w.ntz
    grid = CellGrid(box=Box.create([60.0, 0, 0], [0, 60.0, 0], [0, 0, 66.0]),
                    dims=(10, 10, 11), capacity=40, cutoff=5.0, skin=0.5)
    p = win._params_for(None, grid, 40, nt)
    assert bytes(p.tile) == bytes(win.win_tile(40, (10, 10, 11), nt))


def test_main_path_tiles():
    """The flagship (grid 42^3, cap 16) and the run1m driver film (446 x 24
    x 24 cells, cap 24), as PERF.md states them."""
    w = win.win_tile(16, (42, 42, 42), 1)
    assert (w.tx, w.ty, w.tz, w.threads, w.list_len, w.smem) == \
        (2, 2, 7, 448, 80, 110848)
    assert (w.ntx, w.nty, w.ntz) == (21, 21, 6)
    w2 = win.win_tile(16, (42, 42, 42), 2)
    assert (w2.tx, w2.ty, w2.tz, w2.smem) == (2, 2, 7, 113728)
    w = win.win_tile(24, (446, 24, 24), 1)
    assert (w.tx, w.ty, w.tz, w.threads, w.smem) == (2, 2, 5, 480, 129280)


def carve(w, cap, thread):
    """eam_win.cu's carve(): (lx, ly, lz, s) of a thread, a padding thread
    (past tx*ty*tz*cap) at (0, 0, 0, 0)."""
    l0 = thread // cap
    if l0 >= w.tx * w.ty * w.tz:
        return 0, 0, 0, 0
    return l0 // (w.tz * w.ty), (l0 // w.tz) % w.ty, l0 % w.tz, thread % cap


@pytest.mark.parametrize("cap,dims,nt", [(16, (42, 42, 42), 1),
                                         (24, (3, 4, 11), 2),
                                         (40, (3, 4, 11), 4),
                                         (20, (2, 2, 7), 1),
                                         (17, (3, 4, 11), 1),
                                         (31, (5, 1, 97), 2),
                                         (128, (3, 4, 11), 3),
                                         (3, (1, 1, 1), 2)])
def test_staging_loop_covers_every_slot_once(cap, dims, nt):
    """eam_win.cu's stage(): thread k0 walks k = k0, k0 + threads, ...
    advancing (hz, t, r) by carries instead of dividing; every slot
    k = (r*cap + t)*(tz + 2) + hz of the tile is staged exactly once.  The
    scan's reads of every thread, the padding lanes of the last warp
    included (cap 17, 31 and 3 have them), stay in the tile: the cell
    (row (lx + ox)(ty + 2) + ly + oy, z lz + oz) and its slots q = (row*cap
    + t)*(tz + 2) + lz + oz."""
    w = win.win_tile(cap, dims, nt)
    tz2, nthr = w.tz + 2, w.threads
    rows = (w.tx + 2) * (w.ty + 2)
    nslots = rows * cap * tz2
    seen = [0] * nslots
    dhz, drow = nthr % tz2, nthr // tz2
    dt, dr = drow % cap, drow // cap
    for k0 in range(nthr):
        hz, row = k0 % tz2, k0 // tz2
        t, r = row % cap, row // cap
        for k in range(k0, nslots, nthr):
            assert k == (r * cap + t) * tz2 + hz
            seen[k] += 1
            hz, t, r = hz + dhz, t + dt, r + dr
            if hz >= tz2:
                hz, t = hz - tz2, t + 1
            if t >= cap:
                t, r = t - cap, r + 1
    assert seen == [1] * nslots and nslots <= 65536
    for thread in range(nthr):
        lx, ly, lz, s = carve(w, cap, thread)
        assert lx < w.tx and ly < w.ty and lz < w.tz and s < cap
        for o in range(27):
            row = (lx + o // 9) * (w.ty + 2) + ly + (o // 3) % 3
            z = lz + o % 3
            assert row < rows and z < tz2
            assert (row * cap + cap - 1) * tz2 + z < nslots
    padded = nthr > w.tx * w.ty * w.tz * cap
    assert padded == (cap in (17, 31, 3))


def test_check_cuda_inputs_limits_capacity():
    """Above WIN_MAX_CAP the wrappers raise ValueError before any launch
    (the check runs on CPU tensors too)."""
    lim = kernels.WIN_MAX_CAP
    assert lim >= kernels.HALF_MAX_CAP
    grid = CellGrid(box=Box.create([12.0, 0, 0], [0, 12.0, 0],
                                   [0, 0, 12.0]),
                    dims=(2, 2, 2), capacity=lim, cutoff=5.0, skin=0.5)
    for cap, alive_dtype in ((lim, torch.bool), (lim, torch.int32)):
        win._check_cuda_inputs(torch.zeros((cap, 3, 8)),
                               torch.zeros((cap, 8), dtype=alive_dtype),
                               grid, alive_dtype)
        with pytest.raises(ValueError, match="limit of 128 slots"):
            win._check_cuda_inputs(
                torch.zeros((cap + 1, 3, 8)),
                torch.zeros((cap + 1, 8), dtype=alive_dtype), grid,
                alive_dtype)
    with pytest.raises(ValueError, match="capacity 129 outside"):
        win.win_tile(lim + 1, (2, 2, 8), 1)


def test_fits_above_degree_12_are_refused():
    """The Horners stop at degree 12: a fit with a nonzero coefficient
    above it raises; trailing zeros (the NPOLY padding) do not."""
    def fit(deg, pad=0):
        host = ((tuple([0.5] * (deg + 1) + [0.0] * pad), 1.0, 30.0),)
        return types.SimpleNamespace(host=host)

    grid = CellGrid(box=Box.create([18.0, 0, 0], [0, 18.0, 0],
                                   [0, 0, 18.0]),
                    dims=(3, 3, 3), capacity=16, cutoff=5.0, skin=0.5)
    ok = types.SimpleNamespace(rho=fit(12, pad=3), pair=fit(12))
    assert win._params_for(ok, grid, 16, 1).tile.tz >= 1
    bad = types.SimpleNamespace(rho=fit(12), pair=fit(13))
    with pytest.raises(ValueError, match="degree 13"):
        win._params_for(bad, grid, 16, 1)
    # the half-stencil kernels (nt 0) keep their 15-step Horner
    assert win._params_for(bad, grid, 16).tile.tz == 0
