"""Forces-only single-species EAM on the cells-last layout (port of
imd_tpu/ops/forces_win.py:208 ``eam_kernels_win_split``).

Two passes, as in the JAX package: the R pass (K1, ``eam_rho``) sums the
host density rho_i and the neighbour count, the embedding derivative
dF = F'(rho) runs as plain torch, and the F pass (K2, ``eam_force``) sums
the combined pair + embedding force with grad = phi'(r^2) + (dF_i + dF_j)
rho'(r^2).

Each pass is a hand-written CUDA kernel (csrc/eam_win.cu) with a plain
torch version of the same function beside it (``eam_rho_plain``,
``eam_force_plain``): a full 27-offset stencil sweep over ``_roll_cells``
views.  The wrappers take the plain version only for CPU tensors; on a CUDA
tensor they launch the kernel or raise.

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


@functools.lru_cache(maxsize=16)
def _eam_params(rho_h, pair_h, rcut2, h, pbc, dims, cap):
    """ctypes EamParams from the baked host tuples (all hashable)."""
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

    fill(p.rho_v, *rho_h)
    fill(p.pair_g, _deriv_coefs(pair_h), *pair_h[1:])
    fill(p.rho_g, _deriv_coefs(rho_h), *rho_h[1:])
    fill(p.pair_v, *pair_h)
    p.rcut2 = rcut2
    for k in range(9):
        p.h[k] = h[k]
    for k in range(3):
        p.pbc[k] = pbc[k]
    p.gx, p.gy, p.gz = dims
    p.cap = cap
    return p


def _check_cuda_inputs(xi, alive, grid):
    cap, _, nc = xi.shape
    if xi.dtype != torch.float32 or not xi.is_contiguous():
        raise TypeError("eam kernels take contiguous float32 xi [cap,3,NC]")
    if alive.dtype != torch.bool or alive.shape != (cap, nc) \
            or not alive.is_contiguous() or alive.device != xi.device:
        raise TypeError("eam kernels take contiguous bool alive [cap,NC] "
                        "on the device of xi")
    if nc != grid.n_cells:
        raise ValueError(f"xi has {nc} cells, grid {grid.dims} has "
                         f"{grid.n_cells}")
    if cap > kernels.MAX_GRID_Y:
        raise ValueError(f"capacity {cap} exceeds the kernels' limit of "
                         f"{kernels.MAX_GRID_Y} slots (gridDim.y)")


def _params_for(eam, grid, cap):
    h = tuple(float(v) for v in grid.box.h.reshape(-1))
    return _eam_params(_poly_consts(eam.rho), _poly_consts(eam.pair),
                       float(grid.cutoff) ** 2, h, tuple(grid.box.pbc),
                       tuple(grid.dims), int(cap))


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
        _params_for(eam, grid, cap), nc, kernels.stream_ptr(xi.device))
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
    cap, _, nc = xi.shape
    if dF.dtype != torch.float32 or dF.shape != (cap, nc) \
            or not dF.is_contiguous() or dF.device != xi.device:
        raise TypeError("eam_force takes contiguous float32 dF [cap,NC] "
                        "on the device of xi")
    F = torch.empty_like(xi)
    err = kernels.lib().imd_eam_force(
        xi.data_ptr(), alive.data_ptr(), dF.data_ptr(), F.data_ptr(),
        _params_for(eam, grid, cap), nc, kernels.stream_ptr(xi.device))
    kernels.check(err, "eam_force")
    kernels.LAUNCHES["eam_force"] += 1
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
