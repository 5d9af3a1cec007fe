"""Forces-only EAM on the cells-last layout (port of
imd_tpu/ops/forces_win.py:208 ``eam_kernels_win_split`` and :470
``eam_kernels_win_split_mt``).

Two passes, as in the JAX package: the R pass (K1, ``eam_rho``) sums the
host density rho_i and the neighbour count, the embedding derivative
dF = F'(rho) runs as plain torch, and the F pass (K2, ``eam_force``) sums
the combined pair + embedding force with grad = phi'(r^2) + (dF_i + dF_j)
rho'(r^2).

Alloys (2 <= ntypes <= 4) run the same two passes with one table column
per type pair (K6 ``eam_rho_mt``, K7 ``eam_force_mt``): the pair tables
read col = t_i*nt + t_j, the density at i from j reads the source-first
col = t_j*nt + t_i, so grad = phi'(t_i,t_j) + dF_i rho'(t_j,t_i) + dF_j
rho'(t_i,t_j), and the embedding is selected per type.  A slot is dead
where ``typ`` < 0.  The kernels evaluate each pair once from each side
with the column of that side, which equals the JAX package's half stencil
only for symmetric pair tables: the wrappers raise ValueError for an
asymmetric one (imd_tpu sends ``asympot`` runs to its oracle engine).
The density tables may be fully asymmetric.

Each pass is a hand-written CUDA kernel (csrc/eam_win.cu) with a plain
torch version of the same function beside it (``eam_rho_plain``,
``eam_force_plain``, ``eam_rho_mt_plain``, ``eam_force_mt_plain``): a full
27-offset stencil sweep over ``_roll_cells`` views.  The wrappers take the
plain version only for CPU tensors; on a CUDA tensor they launch the kernel
or raise.

The Horner helpers below mirror the constants the Pallas kernels bake
(imd_tpu/ops/forces_pallas.py:55-109, 554-575): the window transform clips
t to [-1, 1] (constant below the fit window, unlike
``PolyPotential.interp``), and the derivative polynomials carry the chain
factor 4/(e-b), giving 2 dV/dr^2.

Only the single-device mode is ported; the sharded ``owned_nc``/``passes``/
``dF_in`` mode waits for the multi-device slice.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imd_tpu_torch import kernels
from imd_tpu_torch.ops.forces import ALL_OFFSETS
from imd_tpu_torch.ops.forces_fast import _roll_cells, _wrap_shift_mask_cl
from imd_tpu_torch.phases import no_timer

SENTINEL_DEAD = 1.0e6     # dead atom slots (forces_pallas.py:50)


def _poly_consts(poly):
    """(coef tuple, begin, end) of the single-species column, as Python
    floats for kernel baking."""
    return poly.host[0]


def _cheb_t(x, b, e):
    """Window transform x*a - b0, clipped to [-1, 1]."""
    inv_half = 2.0 / (e - b)
    return torch.clamp(x * inv_half - (b * inv_half + 1.0), -1.0, 1.0)


def _horner_v(x, consts):
    """Value-only Horner with baked constants."""
    coef, b, e = consts
    t = _cheb_t(x, b, e)
    v = torch.full_like(t, coef[-1])
    for k in range(len(coef) - 2, -1, -1):
        v = v * t + coef[k]
    return v


def _deriv_coefs(consts):
    """Coefficients of t^0..t^(d-1) of 2 dV/dx, chain factor baked in."""
    coef, b, e = consts
    s = 2.0 * 2.0 / (e - b)
    return [coef[k] * k * s for k in range(1, len(coef))]


def _horner_g(x, consts):
    coef, b, e = consts
    t = _cheb_t(x, b, e)
    dc = _deriv_coefs(consts)
    g = torch.full_like(t, dc[-1])
    for k in range(len(dc) - 2, -1, -1):
        g = g * t + dc[k]
    return g


def _horner_g2(x, c1, c2):
    """2 dV/dx of two polynomials (the F pass's phi' and rho')."""
    return _horner_g(x, c1), _horner_g(x, c2)


def _stencil_pairs(xi, alive, grid):
    """Yield, per offset of the 27-stencil, the pair quantities
    (dx, dy, dz, r2 [cap_i, cap_j, NC], valid [cap_i, cap_j, NC], roll)
    where ``roll(a)`` is the neighbour view of a [cap, NC] array."""
    dims = grid.dims
    cap = xi.shape[0]
    rcut2 = float(grid.cutoff) ** 2
    not_self = ~torch.eye(cap, dtype=torch.bool, device=xi.device)[:, :, None]
    for off in ALL_OFFSETS:
        shift, ok = _wrap_shift_mask_cl(grid, off, xi.dtype, xi.device)
        xj = _roll_cells(xi, dims, off) + shift[None]
        aj = _roll_cells(alive, dims, off) & ok[None]
        d = [xi[:, None, c, :] - xj[None, :, c, :] for c in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        valid = alive[:, None, :] & aj[None, :, :] & (r2 < rcut2)
        if off == (0, 0, 0):
            valid = valid & not_self
        yield (*d, r2, valid,
               functools.partial(_roll_cells, dims=dims, off=off))


def eam_rho_plain(xi, alive, eam, grid):
    """Plain torch K1: (rho, nn) [cap, NC], zero in dead slots."""
    rho_c = _poly_consts(eam.rho)
    rho = torch.zeros_like(xi[:, 0])
    nn = torch.zeros_like(xi[:, 0])
    for _, _, _, r2, valid, _ in _stencil_pairs(xi, alive, grid):
        vf = valid.to(xi.dtype)
        rho = rho + (_horner_v(r2, rho_c) * vf).sum(1)
        nn = nn + vf.sum(1)
    return rho, nn


def eam_force_plain(xi, alive, dF, eam, grid):
    """Plain torch K2: F [cap, 3, NC], zero in dead slots."""
    pair_c = _poly_consts(eam.pair)
    rho_c = _poly_consts(eam.rho)
    F = torch.zeros_like(xi)
    for dx, dy, dz, r2, valid, roll in _stencil_pairs(xi, alive, grid):
        pg, rg = _horner_g2(r2, pair_c, rho_c)
        dfj = roll(dF)
        grad = (pg + (dF[:, None, :] + dfj[None, :, :]) * rg) \
            * valid.to(xi.dtype)
        F = F - torch.stack([(grad * d).sum(1) for d in (dx, dy, dz)], 1)
    return F


def check_mt_tables(eam, ntypes: int) -> None:
    """What the multi-type passes take: 2..MAX_NT species, ntypes^2 pair
    and density columns, ntypes embedding columns, and a symmetric pair
    table (see the module docstring)."""
    nt = ntypes
    if not 2 <= nt <= kernels.MAX_NT:
        raise ValueError(f"the multi-type EAM passes take 2 to "
                         f"{kernels.MAX_NT} species, got ntypes {nt}")
    for name, want in (("pair", nt * nt), ("rho", nt * nt), ("embed", nt)):
        have = len(getattr(eam, name).host)
        if have != want:
            raise ValueError(f"ntypes {nt} needs {want} {name} columns, "
                             f"the potential has {have}")
    pair = eam.pair.host
    for a in range(nt):
        for b in range(a + 1, nt):
            if pair[a * nt + b] != pair[b * nt + a]:
                raise ValueError(
                    f"asymmetric pair table: column ({a},{b}) differs "
                    f"from ({b},{a}); the full-stencil kernels evaluate "
                    "a pair from both sides and take symmetric pair "
                    "tables only")


def _select_cols(r2, col, consts, horner):
    """``horner(r2, consts[c])`` of the column ``col`` names per pair."""
    out = torch.zeros_like(r2)
    for c, cs in enumerate(consts):
        out = torch.where(col == c, horner(r2, cs), out)
    return out


def _mt_stencil_pairs(xi, typ, grid, nt):
    """``_stencil_pairs`` with the pair's two columns: yields (dx, dy, dz,
    r2, valid, roll, col_ij, col_ji) with col_ij = t_i*nt + t_j (the pair
    tables; the density at j from i) and col_ji = t_j*nt + t_i (the
    density at i from j)."""
    t = typ.clamp(0, nt - 1)
    for *pair, roll in _stencil_pairs(xi, typ >= 0, grid):
        ti, tj = t[:, None, :], roll(t)[None, :, :]
        yield (*pair, roll, ti * nt + tj, tj * nt + ti)


def eam_rho_mt_plain(xi, typ, eam, grid, ntypes):
    """Plain torch K6: (rho, nn) [cap, NC], zero in dead slots."""
    rho = torch.zeros_like(xi[:, 0])
    nn = torch.zeros_like(rho)
    for _, _, _, r2, valid, _, _, col_ji in _mt_stencil_pairs(
            xi, typ, grid, ntypes):
        vf = valid.to(xi.dtype)
        rho = rho + (_select_cols(r2, col_ji, eam.rho.host, _horner_v)
                     * vf).sum(1)
        nn = nn + vf.sum(1)
    return rho, nn


def _mt_grad_pairs(xi, typ, dF, eam, grid, nt):
    """Per stencil offset (dx, dy, dz, grad [cap_i, cap_j, NC]) of the
    multi-type F pass, grad zero outside the cutoff."""
    for dx, dy, dz, r2, valid, roll, col_ij, col_ji in _mt_stencil_pairs(
            xi, typ, grid, nt):
        pg = _select_cols(r2, col_ij, eam.pair.host, _horner_g)
        g_ij = _select_cols(r2, col_ji, eam.rho.host, _horner_g)
        g_ji = _select_cols(r2, col_ij, eam.rho.host, _horner_g)
        grad = (pg + dF[:, None, :] * g_ij + roll(dF)[None, :, :] * g_ji) \
            * valid.to(xi.dtype)
        yield dx, dy, dz, grad


def eam_force_mt_plain(xi, typ, dF, eam, grid, ntypes):
    """Plain torch K7: F [cap, 3, NC], zero in dead slots."""
    F = torch.zeros_like(xi)
    for dx, dy, dz, grad in _mt_grad_pairs(xi, typ, dF, eam, grid, ntypes):
        F = F - torch.stack([(grad * d).sum(1) for d in (dx, dy, dz)], 1)
    return F


def embed_mt(eam, rho, typ, ntypes):
    """(F(rho), 2 dF/drho) with the embedding column of each slot's type,
    at max(rho, 1e-12) (imd_tpu/ops/forces_win.py:642-648); plain torch,
    as it is XLA in the JAX package."""
    t = typ.clamp(0, ntypes - 1)
    rho_c = torch.clamp(rho, min=1e-12)
    v = torch.zeros_like(rho)
    g = torch.zeros_like(rho)
    for p in range(ntypes):
        vp, gp = eam.embed.interp(p, rho_c)
        v = torch.where(t == p, vp, v)
        g = torch.where(t == p, gp, g)
    return v, g


def _tile_layout(t, cap, nt, dims, list_len=None):
    """WinTile of ``t`` = (tx, ty, tz) cells a block on a grid of ``dims``,
    one thread per (cell, slot) in whole warps, with its shared-memory
    layout: the (tx + 2) (ty + 2) (tz + 2) source cells and their slots as
    float4, with ``nt`` > 1 the two coefficient tables and the int8 types,
    then the uint16 lists of ``list_len`` (cap + WIN_LIST_SLACK) entries."""
    tx, ty, tz = t
    list_len = list_len or cap + kernels.WIN_LIST_SLACK
    threads = -(-tx * ty * tz * cap // 32) * 32
    cells = (tx + 2) * (ty + 2) * (tz + 2)
    nslots = cells * cap
    pos_off = 16 * cells
    end = pos_off + 16 * nslots
    tab_off = typ_off = end
    if nt > 1:
        typ_off = tab_off + 2 * nt * nt * (kernels.NPOLY + 2) * 4
        end = typ_off + nslots
    list_off = -(-end // 4) * 4
    return kernels.WinTile(
        tx=tx, ty=ty, tz=tz, ntx=-(-dims[0] // tx), nty=-(-dims[1] // ty),
        ntz=-(-dims[2] // tz), threads=threads, list_len=list_len,
        pos_off=pos_off, tab_off=tab_off, typ_off=typ_off,
        list_off=list_off, smem=list_off + 2 * threads * list_len)


def win_tile(cap: int, dims, nt: int = 1):
    """Launch tile of the full-stencil kernels (csrc/eam_win.cu) at
    capacity ``cap`` on a grid of ``dims`` cells, for ``nt`` species (1:
    K1/K2/K4/K5, 2..4: K6-K9).

    A block takes tx x ty x tz cells, one thread per (cell, slot) in whole
    warps: tx = ty = 2 (1 along an axis of one cell), or 1 x 1 where no
    2 x 2 run fits WIN_MAX_THREADS and WIN_MAX_SMEM; tz covers the grid's
    z in as few blocks as a fitting run of at most WIN_MAX_TZ cells
    allows, and is the shortest run that does (the least overhang past the
    grid).  At the flagship (42^3, cap 16) this is 2 x 2 x 7 cells, 448
    threads."""
    if not 1 <= cap <= kernels.WIN_MAX_CAP:
        raise ValueError(f"capacity {cap} outside the full-stencil "
                         f"kernels' 1..{kernels.WIN_MAX_CAP}")
    for side in (kernels.WIN_MAX_TXY, 1):
        txy = (min(side, dims[0]), min(side, dims[1]))
        fits = [tz for tz in range(1, min(kernels.WIN_MAX_TZ, dims[2]) + 1)
                if txy[0] * txy[1] * tz * cap <= kernels.WIN_MAX_THREADS
                and _tile_layout((*txy, tz), cap, nt, dims).smem
                <= kernels.WIN_MAX_SMEM]
        if fits:
            nb = -(-dims[2] // max(fits))
            return _tile_layout((*txy, -(-dims[2] // nb)), cap, nt, dims)
    raise AssertionError(f"no tile fits capacity {cap}")


# scratch fields a pair keeps for K10-K12's j side, by launch kind: rho
# (K10; the count needs none), the gradient (K11, K12, K12-mt), and phi
# when K12 or K12-mt computes the energy
HALF_FIELDS = {"rho": 1, "force": 1, "pair": 1, "pair_energy": 2,
               "pair_mt": 1, "pair_energy_mt": 2}
# K12-mt's coefficient rows behind the lists (eam_half.cu:HALF_MT_TAB): two
# tables of MAX_NT^2 rows of NPOLY + 2 floats
HALF_MT_TAB = 2 * kernels.MAX_NT ** 2 * (kernels.NPOLY + 2) * 4


def half_smem(cap: int, cpb: int, threads: int, nf: int,
              mt: bool = False) -> int:
    """Shared-memory bytes of a K10-K12 block (eam_half.cu:half_smem): the
    own cell and two staged views as float4 per cell, ``nf`` scratches of
    cap rows of cap * cpb + 1 floats, the column masks per cell, a limit
    per staged cell, the uint16 lists of cap entries, and with ``mt``
    K12-mt's coefficient rows."""
    words = -(-cap // 32)
    return (16 * 3 * cap * cpb + 4 * nf * cap * (cap * cpb + 1)
            + 4 * words * cap * cpb + 4 * 3 * cpb + 2 * cap * threads
            + (HALF_MT_TAB if mt else 0))


@functools.lru_cache(maxsize=None)
def half_tile(cap: int, kind: str):
    """Launch shape of K10 (``kind`` "rho"), K11 ("force"), K12
    ("pair", or "pair_energy" when it computes the energy) and K12-mt
    ("pair_mt", "pair_energy_mt") at capacity ``cap``, a fixed
    rule: the most cells a block, a power of two, whose cap * cells
    threads fit HALF_MAX_THREADS, halved until the shared memory fits
    HALF_MAX_SMEM; threads rounded up to whole warps.  Slots with x at or
    above half of SENTINEL_DEAD are dead."""
    if not 1 <= cap <= kernels.HALF_MAX_CAP:
        raise ValueError(f"capacity {cap} outside the half-stencil "
                         f"kernels' 1..{kernels.HALF_MAX_CAP}")
    nf = HALF_FIELDS[kind]
    cpb = 1 << (kernels.HALF_MAX_THREADS // cap).bit_length() - 1
    while True:
        threads = -(-cap * cpb // 32) * 32
        smem = half_smem(cap, cpb, threads, nf, kind.endswith("_mt"))
        if smem <= kernels.HALF_MAX_SMEM:
            return kernels.HalfTile(cpb=cpb, threads=threads, smem=smem,
                                    dead=SENTINEL_DEAD / 2)
        cpb //= 2


def _check_win_degree(host) -> None:
    """The stencil kernels' Horners (K1-K12) stop at degree WIN_DEG."""
    for c, _, _ in host:
        deg = max((k for k, v in enumerate(c) if v != 0.0), default=0)
        if deg > kernels.WIN_DEG:
            raise ValueError(f"polynomial degree {deg} exceeds the "
                             f"stencil kernels' {kernels.WIN_DEG}")


@functools.lru_cache(maxsize=16)
def _eam_params(rho_h, pair_h, rcut2, h, pbc, dims, cap, nt=0, half=None):
    """ctypes EamParams from the baked host tuples (all hashable);
    ``rho_h``/``pair_h`` None leaves their polynomials empty (the multi-type
    kernels read theirs from ``_mt_table``); ``nt`` > 0 fills the
    full-stencil kernels' tile for ``nt`` species, ``half`` (a kind of
    ``half_tile``) K10-K12's launch shape; either holds the fits to their
    degree."""
    p = kernels.EamParams()

    def fill(dst, c, b, e):
        if len(c) > kernels.NPOLY:
            raise ValueError(f"polynomial degree {len(c) - 1} exceeds the "
                             f"kernel's {kernels.NPOLY - 1}")
        inv_half = 2.0 / (e - b)
        for k in range(kernels.NPOLY):
            dst.c[k] = c[k] if k < len(c) else 0.0
        dst.a = inv_half
        dst.b0 = b * inv_half + 1.0

    if rho_h is not None:
        fill(p.rho_v, *rho_h)
        fill(p.rho_g, _deriv_coefs(rho_h), *rho_h[1:])
    if pair_h is not None:
        fill(p.pair_g, _deriv_coefs(pair_h), *pair_h[1:])
        fill(p.pair_v, *pair_h)
    p.rcut2 = rcut2
    for k in range(9):
        p.h[k] = h[k]
    for k in range(3):
        p.pbc[k] = pbc[k]
    p.gx, p.gy, p.gz = dims
    p.cap = cap
    if nt or half:
        _check_win_degree(h for h in (rho_h, pair_h) if h is not None)
    if nt:
        p.tile = win_tile(cap, dims, nt)
    if half:
        p.half = half_tile(cap, half)
    return p


def _check_cuda_inputs(xi, alive, grid, alive_dtype=torch.bool):
    """``alive`` is the bool mask of the single-species kernels or, with
    ``alive_dtype`` int32, the types of the multi-type ones."""
    cap, _, nc = xi.shape
    if xi.dtype != torch.float32 or not xi.is_contiguous():
        raise TypeError("eam kernels take contiguous float32 xi [cap,3,NC]")
    if alive.dtype != alive_dtype or alive.shape != (cap, nc) \
            or not alive.is_contiguous() or alive.device != xi.device:
        raise TypeError(f"eam kernels take contiguous {alive_dtype} "
                        "alive/typ [cap,NC] on the device of xi")
    if nc != grid.n_cells:
        raise ValueError(f"xi has {nc} cells, grid {grid.dims} has "
                         f"{grid.n_cells}")
    if cap > kernels.WIN_MAX_CAP:
        raise ValueError(f"capacity {cap} exceeds the full-stencil "
                         f"kernels' limit of {kernels.WIN_MAX_CAP} slots "
                         "(a block's halo tile and pair lists in shared "
                         "memory)")


def _check_cuda_dF(dF, xi, name):
    cap, _, nc = xi.shape
    if dF.dtype != torch.float32 or dF.shape != (cap, nc) \
            or not dF.is_contiguous() or dF.device != xi.device:
        raise TypeError(f"{name} takes contiguous float32 dF [cap,NC] "
                        "on the device of xi")


def _pair_params(pot, grid, cap, half=None):
    """EamParams of a single-species pair fit (the density polynomials
    empty): K12's value and derivative Horners of phi; of the geometry
    alone for ``pot`` None (K12-mt reads its fits from
    ``_pair_mt_table``); ``half`` as in ``_params_for``."""
    h = tuple(float(v) for v in grid.box.h.reshape(-1))
    return _eam_params(None, None if pot is None else _poly_consts(pot),
                       float(grid.cutoff) ** 2, h, tuple(grid.box.pbc),
                       tuple(grid.dims), int(cap), half=half)


def _params_for(eam, grid, cap, nt=0, half=None):
    """EamParams of a single-species set; of the geometry alone for
    ``eam`` None.  ``nt`` > 0 adds the full-stencil kernels' tile for
    ``nt`` species, ``half`` K10-K12's launch shape of that kind (either
    holds the fits to their degree)."""
    h = tuple(float(v) for v in grid.box.h.reshape(-1))
    rho_h, pair_h = (None, None) if eam is None else \
        (_poly_consts(eam.rho), _poly_consts(eam.pair))
    return _eam_params(rho_h, pair_h, float(grid.cutoff) ** 2, h,
                       tuple(grid.box.pbc), tuple(grid.dims), int(cap),
                       int(nt), half)


def _deriv_rows(host):
    """The columns of 2 d/dr^2 of the fit ``host`` (window and ends
    kept)."""
    return tuple((_deriv_coefs(c), *c[1:]) for c in host)


def _coef_table(tables, device):
    """[len(tables), ncols, NPOLY + 2] float32 on ``device``: per column of
    each table (a host tuple of (coefs, begin, end)) the coefficients of
    t^k, then a and b0 of the window transform."""
    _check_win_degree(sum(tables, ()))
    tab = np.zeros((len(tables), len(tables[0]), kernels.NPOLY + 2),
                   np.float32)
    for k, rows in enumerate(tables):
        for col, (c, b, e) in enumerate(rows):
            if len(c) > kernels.NPOLY:
                raise ValueError(f"polynomial degree {len(c) - 1} exceeds "
                                 f"the kernel's {kernels.NPOLY - 1}")
            inv_half = 2.0 / (e - b)
            tab[k, col, :len(c)] = c
            tab[k, col, kernels.NPOLY:] = inv_half, b * inv_half + 1.0
    return torch.from_numpy(tab).to(device)


@functools.lru_cache(maxsize=8)
def _mt_table_cached(rho_h, pair_h, device):
    rows = {"rho_v": rho_h, "pair_v": pair_h, "pair_g": _deriv_rows(pair_h),
            "rho_g": _deriv_rows(rho_h)}
    return _coef_table(tuple(rows[name] for name in kernels.MT_TABLES),
                       device)


@functools.lru_cache(maxsize=8)
def _pair_mt_table_cached(pair_h, device):
    return _coef_table((pair_h, _deriv_rows(pair_h)), device)


def _pair_mt_table(pot, device):
    """K12-mt's coefficient buffer [2, ntypes^2, NPOLY + 2] float32 on
    ``device``: per type-pair column the rows of phi, then of 2 dphi/dr^2,
    laid out as the pair tables of ``_mt_table``'s buffer (made once per
    fit and device)."""
    return _pair_mt_table_cached(pot.host, str(device))


def _mt_table(eam, device):
    """The multi-type kernels' coefficient buffer [4, ntypes^2, NPOLY + 2]
    float32 on ``device`` (tables in the order of kernels.MT_TABLES; per
    row the coefficients of t^k, then a and b0 of the window transform),
    made once per potential and device."""
    return _mt_table_cached(eam.rho.host, eam.pair.host, str(device))


def eam_rho(xi, alive, eam, grid):
    """K1 wrapper: (rho, nn) [cap, NC] of the live slots, 0 where dead."""
    if not xi.is_cuda:
        if xi.device.type != "cpu":
            raise TypeError(f"unsupported device {xi.device}")
        return eam_rho_plain(xi, alive, eam, grid)
    _check_cuda_inputs(xi, alive, grid)
    cap, _, nc = xi.shape
    rho = torch.empty((cap, nc), dtype=xi.dtype, device=xi.device)
    nn = torch.empty_like(rho)
    err = kernels.lib().imd_eam_rho(
        xi.data_ptr(), alive.data_ptr(), rho.data_ptr(), nn.data_ptr(),
        _params_for(eam, grid, cap, 1), nc, kernels.stream_ptr(xi.device))
    kernels.check(err, "eam_rho")
    kernels.LAUNCHES["eam_rho"] += 1
    return rho, nn


def eam_force(xi, alive, dF, eam, grid):
    """K2 wrapper: F [cap, 3, NC] of the live slots, 0 where dead."""
    if not xi.is_cuda:
        if xi.device.type != "cpu":
            raise TypeError(f"unsupported device {xi.device}")
        return eam_force_plain(xi, alive, dF, eam, grid)
    _check_cuda_inputs(xi, alive, grid)
    _check_cuda_dF(dF, xi, "eam_force")
    cap, _, nc = xi.shape
    F = torch.empty_like(xi)
    err = kernels.lib().imd_eam_force(
        xi.data_ptr(), alive.data_ptr(), dF.data_ptr(), F.data_ptr(),
        _params_for(eam, grid, cap, 1), nc, kernels.stream_ptr(xi.device))
    kernels.check(err, "eam_force")
    kernels.LAUNCHES["eam_force"] += 1
    return F


def eam_rho_mt(xi, typ, eam, grid, ntypes):
    """K6 wrapper: (rho, nn) [cap, NC] of the slots with typ >= 0, 0 where
    dead; ``typ`` [cap, NC] int32."""
    check_mt_tables(eam, ntypes)
    if not xi.is_cuda:
        if xi.device.type != "cpu":
            raise TypeError(f"unsupported device {xi.device}")
        return eam_rho_mt_plain(xi, typ, eam, grid, ntypes)
    _check_cuda_inputs(xi, typ, grid, torch.int32)
    cap, _, nc = xi.shape
    rho = torch.empty((cap, nc), dtype=xi.dtype, device=xi.device)
    nn = torch.empty_like(rho)
    err = kernels.lib().imd_eam_rho_mt(
        xi.data_ptr(), typ.data_ptr(), _mt_table(eam, xi.device).data_ptr(),
        ntypes, rho.data_ptr(), nn.data_ptr(),
        _params_for(None, grid, cap, ntypes), nc,
        kernels.stream_ptr(xi.device))
    kernels.check(err, "eam_rho_mt")
    kernels.LAUNCHES["eam_rho_mt"] += 1
    return rho, nn


def eam_force_mt(xi, typ, dF, eam, grid, ntypes):
    """K7 wrapper: F [cap, 3, NC] of the slots with typ >= 0, 0 where
    dead."""
    check_mt_tables(eam, ntypes)
    if not xi.is_cuda:
        if xi.device.type != "cpu":
            raise TypeError(f"unsupported device {xi.device}")
        return eam_force_mt_plain(xi, typ, dF, eam, grid, ntypes)
    _check_cuda_inputs(xi, typ, grid, torch.int32)
    _check_cuda_dF(dF, xi, "eam_force_mt")
    cap, _, nc = xi.shape
    F = torch.empty_like(xi)
    err = kernels.lib().imd_eam_force_mt(
        xi.data_ptr(), typ.data_ptr(), _mt_table(eam, xi.device).data_ptr(),
        ntypes, dF.data_ptr(), F.data_ptr(),
        _params_for(None, grid, cap, ntypes), nc,
        kernels.stream_ptr(xi.device))
    kernels.check(err, "eam_force_mt")
    kernels.LAUNCHES["eam_force_mt"] += 1
    return F


def eam_kernels_win_split(xi, mask, eam, grid,
                          count_neighbors: bool = False, timer=no_timer):
    """Forces-only split EAM on cells-last views (single device).

    ``xi`` [cap, 3, NC] positions (dead slots at SENTINEL_DEAD), ``mask``
    [cap, NC] bool.  Returns (F [cap,3,NC], rho [cap,NC], nneigh [cap,NC]),
    the contract of imd_tpu's eam_kernels_win_split; nneigh is zero unless
    ``count_neighbors``.  ``timer`` wraps the R pass (K1) and the F pass
    (the embedding derivative and K2)."""
    with timer("r_pass"):
        rho, nn = eam_rho(xi, mask, eam, grid)
    with timer("f_pass"):
        maskf = mask.to(xi.dtype)
        _, emb_g = eam.embed.interp(0, rho)
        dF = 0.5 * emb_g * maskf
        F = eam_force(xi, mask, dF, eam, grid)
    if not count_neighbors:
        nn = torch.zeros_like(rho)
    return F, rho, nn


def eam_kernels_win_split_mt(xi, typ, mask, eam, grid, ntypes: int,
                             count_neighbors: bool = False, timer=no_timer):
    """Forces-only split EAM for 2..4 species (single device).

    ``typ`` [cap, NC] int32 with -1 in dead slots, ``mask`` = typ >= 0.
    Returns (F, rho, nneigh) as ``eam_kernels_win_split``, the contract of
    imd_tpu's eam_kernels_win_split_mt in its single-device mode."""
    with timer("r_pass"):
        rho, nn = eam_rho_mt(xi, typ, eam, grid, ntypes)
    with timer("f_pass"):
        _, emb_g = embed_mt(eam, rho, typ, ntypes)
        dF = 0.5 * emb_g * mask.to(xi.dtype)
        F = eam_force_mt(xi, typ, dF, eam, grid, ntypes)
    if not count_neighbors:
        nn = torch.zeros_like(rho)
    return F, rho, nn
