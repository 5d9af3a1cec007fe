"""EAM observables and the pair engine on the cells-last layout: forces,
per-atom energy, host density, neighbour count, virial and pressure tensor
(port of imd_tpu/ops/forces_pallas.py:216 ``eam_kernels_cl`` and :395
``compute_eam_forces_pallas``, the kernel pair the driver calls at every
.eng interval, and of their alloy twins :933 ``eam_kernels_cl_mt`` and
:1210 ``compute_eam_forces_pallas_mt``).

The JAX package runs two Pallas kernels, kern_a (pair forces, rho, e, nn,
pair stress) and kern_b (embedding forces and stress), over 13 pre-rolled
half-stencil views, with the embedding applied by XLA in between.  Here the
same three phases run on the windowed engine's stencil family
(csrc/eam_win.cu) with the observables switched on:

- K4 ``eam_rho_e``: rho_i, nn_i and e_i = 1/2 sum_j phi(r^2);
- the embedding value F(rho) and dF = F'(rho)/2 in plain torch;
- K5 ``eam_force_s``: F_i and the per-atom partial sums
  s_i^ab = -1/2 sum_j grad d_a d_b (Voigt xx yy zz yz zx xy);
- the virial and pressure tensor as float64 sums of s_i in torch.

For 2 <= ntypes <= 4 species the same phases run with one table column
per type pair (K8 ``eam_rho_e_mt``, K9 ``eam_force_s_mt``, the embedding
selected per type; columns and the symmetric-pair rule as in
ops/forces_win.py).

The driver always asks for every observable, so the JAX package's
``need_energy``/``need_stress``/``count_neighbors`` switches are not ported:
the forces-only passes are the hot loop's K1/K2 (ops/forces_win.py).

Beside the wrappers sit the plain torch versions ``eam_rho_e_plain``,
``eam_force_s_plain``, ``eam_rho_e_mt_plain`` and ``eam_force_s_mt_plain``
(the 27-offset sweep of ``eam_rho_plain`` / ``eam_force_plain``).  The
wrappers take them only for CPU tensors; on a CUDA tensor they launch the
kernel or raise.

``compute_eam_forces_pallas2`` (imd_tpu :1243) is B4's numerics with the
TPU's 13 offsets on the Pallas grid: here it runs the same K4/K5.

The rolled-view R/F split (imd_tpu :112 ``prep_neighbors``, :134
``_assemble``, :590 ``eam_r_pass``, :685 ``eam_f_pass``, :786
``eam_kernels_cl_split``) keeps the TPU's contract: the passes read the 13
pre-rolled half-stencil views ``nbr`` [13, cap, 3, NC] (box shift added,
cells across an open face at SENTINEL_CELL), evaluate each pair once (the
own cell with i < j, then the 13 offsets), and return i-sums and per-offset
j-partials that ``_assemble`` rolls back and adds in torch.  The passes are
K10 ``eam_rho_half`` and K11 ``eam_force_half`` (csrc/eam_half.cu), beside
their plain versions ``eam_rho_half_plain`` and ``eam_force_half_plain``.
Their outputs are UNMASKED, as on the TPU: only live slots of the assembled
values are meaningful, and ``eam_kernels_cl_split`` masks them.  A dead
slot's values are unspecified: the plain versions pair two dead slots of
one cell (both at SENTINEL_DEAD, r^2 = 0), the kernels K10-K12 skip dead
slots and write zeros there.  K10-K12's launch shape comes from
``forces_win.half_tile``.
The TPU's lane padding (``_split_geometry``, ``block``, ``unroll``) has no
counterpart: those arguments are taken and ignored.

B6, ``compute_pair_forces_pallas`` (imd_tpu :431), the general step's pair
engine, runs the same contract for one pair table: K12 ``pair_half``
(csrc/eam_half.cu, beside ``pair_half_plain``) sweeps the own cell and the
13 views once per pair and returns the i-sums and j-partials of fx, fy, fz
(and of e = phi/2 to each side, and of the count) and six i-side stress
sums; ``_assemble`` rolls the j-partials back.
"""

from __future__ import annotations

import dataclasses

import torch

from imd_tpu_torch import kernels
from imd_tpu_torch.ops.forces import HALF_OFFSETS
from imd_tpu_torch.ops.forces_fast import (_from_cl, _roll_cells,
                                           _roll_cells_back, _to_cl,
                                           _wrap_shift_mask_cl)
from imd_tpu_torch.ops.forces_win import (SENTINEL_DEAD, _check_cuda_dF,
                                          _check_cuda_inputs, _horner_g,
                                          _horner_g2, _horner_v,
                                          _mt_grad_pairs, _mt_stencil_pairs,
                                          _mt_table, _pair_params,
                                          _params_for,
                                          _poly_consts, _select_cols,
                                          _stencil_pairs, check_mt_tables,
                                          embed_mt)
from imd_tpu_torch.ops.fused_step import scene_to_cl
from imd_tpu_torch.phases import no_timer
from imd_tpu_torch.scene import Scene

SENTINEL_CELL = 3.0e6     # invalid neighbour cells (open boundaries)
NOF = len(HALF_OFFSETS)   # 13

# Voigt order of the stress sums: xx yy zz yz zx xy
_VOIGT = ((0, 0), (1, 1), (2, 2), (1, 2), (2, 0), (0, 1))


@dataclasses.dataclass(eq=False)
class ForceResult:
    """Scene-layout result of ``compute_eam_forces_pallas`` (the fields of
    imd_tpu's ForceResult that this engine fills)."""
    force: torch.Tensor        # [gx,gy,gz,cap,3]
    epot: torch.Tensor         # [gx,gy,gz,cap]
    virial: torch.Tensor       # float64 scalar
    presstens: torch.Tensor    # float64 [6] xx yy zz yz zx xy
    num_neighs: torch.Tensor   # [gx,gy,gz,cap] int32
    rho: torch.Tensor = None   # [gx,gy,gz,cap] (EAM engines)


def eam_rho_e_plain(xi, alive, eam, grid):
    """Plain torch K4: (rho, nn, e) [cap, NC], zero in dead slots."""
    rho_c, pair_c = _poly_consts(eam.rho), _poly_consts(eam.pair)
    rho = torch.zeros_like(xi[:, 0])
    nn = torch.zeros_like(rho)
    e = torch.zeros_like(rho)
    for _, _, _, r2, valid, _ in _stencil_pairs(xi, alive, grid):
        vf = valid.to(xi.dtype)
        rho = rho + (_horner_v(r2, rho_c) * vf).sum(1)
        e = e + 0.5 * (_horner_v(r2, pair_c) * vf).sum(1)
        nn = nn + vf.sum(1)
    return rho, nn, e


def _force_stress_sums(xi, dF, grad_pairs):
    """(F [cap,3,NC], S [6,cap,NC]) from per-offset (dx, dy, dz, grad)."""
    F = torch.zeros_like(xi)
    S = torch.zeros((6,) + tuple(dF.shape), dtype=xi.dtype, device=xi.device)
    for dx, dy, dz, grad in grad_pairs:
        d = (dx, dy, dz)
        F = F - torch.stack([(grad * dc).sum(1) for dc in d], 1)
        S = S - 0.5 * torch.stack([(grad * d[a] * d[b]).sum(1)
                                   for a, b in _VOIGT])
    return F, S


def _grad_pairs(xi, alive, dF, eam, grid):
    pair_c, rho_c = _poly_consts(eam.pair), _poly_consts(eam.rho)
    for dx, dy, dz, r2, valid, roll in _stencil_pairs(xi, alive, grid):
        pg, rg = _horner_g2(r2, pair_c, rho_c)
        yield dx, dy, dz, (pg + (dF[:, None, :] + roll(dF)[None, :, :])
                           * rg) * valid.to(xi.dtype)


def eam_force_s_plain(xi, alive, dF, eam, grid):
    """Plain torch K5: (F [cap,3,NC], S [6,cap,NC]), zero in dead slots;
    S holds -1/2 sum_j grad d_a d_b in Voigt order."""
    return _force_stress_sums(xi, dF, _grad_pairs(xi, alive, dF, eam, grid))


def eam_rho_e_mt_plain(xi, typ, eam, grid, ntypes):
    """Plain torch K8: (rho, nn, e) [cap, NC], zero in dead slots."""
    rho = torch.zeros_like(xi[:, 0])
    nn = torch.zeros_like(rho)
    e = torch.zeros_like(rho)
    for _, _, _, r2, valid, _, col_ij, col_ji in _mt_stencil_pairs(
            xi, typ, grid, ntypes):
        vf = valid.to(xi.dtype)
        rho = rho + (_select_cols(r2, col_ji, eam.rho.host, _horner_v)
                     * vf).sum(1)
        e = e + 0.5 * (_select_cols(r2, col_ij, eam.pair.host, _horner_v)
                       * vf).sum(1)
        nn = nn + vf.sum(1)
    return rho, nn, e


def eam_force_s_mt_plain(xi, typ, dF, eam, grid, ntypes):
    """Plain torch K9: (F [cap,3,NC], S [6,cap,NC]) as K5."""
    return _force_stress_sums(
        xi, dF, _mt_grad_pairs(xi, typ, dF, eam, grid, ntypes))


def eam_rho_e(xi, alive, eam, grid):
    """K4 wrapper: (rho, nn, e) [cap, NC] of the live slots, 0 where
    dead."""
    if not xi.is_cuda:
        if xi.device.type != "cpu":
            raise TypeError(f"unsupported device {xi.device}")
        return eam_rho_e_plain(xi, alive, eam, grid)
    _check_cuda_inputs(xi, alive, grid)
    cap, _, nc = xi.shape
    rho = torch.empty((cap, nc), dtype=xi.dtype, device=xi.device)
    nn = torch.empty_like(rho)
    e = torch.empty_like(rho)
    err = kernels.lib().imd_eam_rho_e(
        xi.data_ptr(), alive.data_ptr(), rho.data_ptr(), nn.data_ptr(),
        e.data_ptr(), _params_for(eam, grid, cap, 1), nc,
        kernels.stream_ptr(xi.device))
    kernels.check(err, "eam_rho_e")
    kernels.LAUNCHES["eam_rho_e"] += 1
    return rho, nn, e


def eam_force_s(xi, alive, dF, eam, grid):
    """K5 wrapper: (F [cap,3,NC], S [6,cap,NC]) of the live slots, 0 where
    dead."""
    if not xi.is_cuda:
        if xi.device.type != "cpu":
            raise TypeError(f"unsupported device {xi.device}")
        return eam_force_s_plain(xi, alive, dF, eam, grid)
    _check_cuda_inputs(xi, alive, grid)
    _check_cuda_dF(dF, xi, "eam_force_s")
    cap, _, nc = xi.shape
    F = torch.empty_like(xi)
    S = torch.empty((6, cap, nc), dtype=xi.dtype, device=xi.device)
    err = kernels.lib().imd_eam_force_s(
        xi.data_ptr(), alive.data_ptr(), dF.data_ptr(), F.data_ptr(),
        S.data_ptr(), _params_for(eam, grid, cap, 1), nc,
        kernels.stream_ptr(xi.device))
    kernels.check(err, "eam_force_s")
    kernels.LAUNCHES["eam_force_s"] += 1
    return F, S


def eam_rho_e_mt(xi, typ, eam, grid, ntypes):
    """K8 wrapper: (rho, nn, e) [cap, NC] of the slots with typ >= 0, 0
    where dead; ``typ`` [cap, NC] int32."""
    check_mt_tables(eam, ntypes)
    if not xi.is_cuda:
        if xi.device.type != "cpu":
            raise TypeError(f"unsupported device {xi.device}")
        return eam_rho_e_mt_plain(xi, typ, eam, grid, ntypes)
    _check_cuda_inputs(xi, typ, grid, torch.int32)
    cap, _, nc = xi.shape
    rho = torch.empty((cap, nc), dtype=xi.dtype, device=xi.device)
    nn = torch.empty_like(rho)
    e = torch.empty_like(rho)
    err = kernels.lib().imd_eam_rho_e_mt(
        xi.data_ptr(), typ.data_ptr(), _mt_table(eam, xi.device).data_ptr(),
        ntypes, rho.data_ptr(), nn.data_ptr(), e.data_ptr(),
        _params_for(None, grid, cap, ntypes), nc,
        kernels.stream_ptr(xi.device))
    kernels.check(err, "eam_rho_e_mt")
    kernels.LAUNCHES["eam_rho_e_mt"] += 1
    return rho, nn, e


def eam_force_s_mt(xi, typ, dF, eam, grid, ntypes):
    """K9 wrapper: (F [cap,3,NC], S [6,cap,NC]) of the slots with
    typ >= 0, 0 where dead."""
    check_mt_tables(eam, ntypes)
    if not xi.is_cuda:
        if xi.device.type != "cpu":
            raise TypeError(f"unsupported device {xi.device}")
        return eam_force_s_mt_plain(xi, typ, dF, eam, grid, ntypes)
    _check_cuda_inputs(xi, typ, grid, torch.int32)
    _check_cuda_dF(dF, xi, "eam_force_s_mt")
    cap, _, nc = xi.shape
    F = torch.empty_like(xi)
    S = torch.empty((6, cap, nc), dtype=xi.dtype, device=xi.device)
    err = kernels.lib().imd_eam_force_s_mt(
        xi.data_ptr(), typ.data_ptr(), _mt_table(eam, xi.device).data_ptr(),
        ntypes, dF.data_ptr(), F.data_ptr(), S.data_ptr(),
        _params_for(None, grid, cap, ntypes), nc,
        kernels.stream_ptr(xi.device))
    kernels.check(err, "eam_force_s_mt")
    kernels.LAUNCHES["eam_force_s_mt"] += 1
    return F, S


def eam_kernels_cl(xi, mask, eam, grid, timer=no_timer):
    """Observables EAM on cells-last views (single device, one species).

    ``xi`` [cap,3,NC] positions (dead slots at SENTINEL_DEAD), ``mask``
    [cap,NC] bool.  Returns (F [cap,3,NC], epot, rho, nneigh [cap,NC],
    virial, presstens [6]), the contract of imd_tpu's eam_kernels_cl with
    every observable on; the virial and presstens are float64 sums.
    ``timer`` wraps K4 (``r_pass``) and the embedding with K5
    (``f_pass``), as the fused step's ``"ab"`` engine reads them."""
    maskf = mask.to(xi.dtype)
    with timer("r_pass"):
        rho, nn, e = eam_rho_e(xi, mask, eam, grid)
    with timer("f_pass"):
        emb_v, emb_g = eam.embed.interp(0, rho)
        dF = 0.5 * emb_g * maskf        # interp returns 2 dV/dx
        F, S = eam_force_s(xi, mask, dF, eam, grid)
    presstens = S.to(torch.float64).sum(dim=(1, 2))
    epot = (e + emb_v) * maskf
    return F, epot, rho * maskf, nn * maskf, presstens[:3].sum(), presstens


def eam_kernels_cl_mt(xi, typ, mask, eam, grid, ntypes: int):
    """Observables EAM for 2..4 species on cells-last views (single
    device): ``eam_kernels_cl`` with ``typ`` [cap,NC] int32 (-1 in dead
    slots, ``mask`` = typ >= 0), the contract of imd_tpu's
    eam_kernels_cl_mt with every observable on."""
    maskf = mask.to(xi.dtype)
    rho, nn, e = eam_rho_e_mt(xi, typ, eam, grid, ntypes)
    emb_v, emb_g = embed_mt(eam, rho, typ, ntypes)
    dF = 0.5 * emb_g * maskf
    F, S = eam_force_s_mt(xi, typ, dF, eam, grid, ntypes)
    presstens = S.to(torch.float64).sum(dim=(1, 2))
    epot = (e + emb_v) * maskf
    return F, epot, rho * maskf, nn * maskf, presstens[:3].sum(), presstens


def compute_eam_forces_pallas_mt(scene: Scene, eam,
                                 ntypes: int) -> ForceResult:
    """Scene entry of ``eam_kernels_cl_mt``."""
    cl = scene_to_cl(scene)
    return _force_result(eam_kernels_cl_mt(
        cl.xi, cl.typ, cl.alive, eam, scene.grid, ntypes), scene.grid.dims)


def compute_eam_forces_pallas(scene: Scene, eam) -> ForceResult:
    """Scene entry of ``eam_kernels_cl``."""
    cl = scene_to_cl(scene)
    return _force_result(eam_kernels_cl(cl.xi, cl.alive, eam, scene.grid),
                         scene.grid.dims)


def _force_result(out, dims) -> ForceResult:
    F, epot, rho, nn, virial, presstens = out
    return ForceResult(force=_from_cl(F, dims), epot=_from_cl(epot, dims),
                       virial=virial, presstens=presstens,
                       num_neighs=_from_cl(nn.to(torch.int32), dims),
                       rho=_from_cl(rho, dims))


def compute_eam_forces_pallas2(scene: Scene, eam, ntypes: int = 1,
                               count_neighbors: bool = False,
                               neigh_r2: float = 0.0, block: int = 512,
                               need_energy: bool = True) -> ForceResult:
    """B8's Scene entry (imd_tpu's v2 engine, bench.py --engine pallas2):
    B4's numerics, through K4/K5.  As in imd_tpu, the virial and pressure
    tensor are zero, epot is zero unless ``need_energy`` and the neighbour
    count zero unless ``count_neighbors``; ``block`` is the TPU's lane
    block and is ignored.  One species only (imd_tpu bakes table column 0
    whatever ``ntypes`` says; alloys take
    ``compute_eam_forces_pallas_mt``)."""
    if ntypes != 1:
        raise NotImplementedError(
            f"compute_eam_forces_pallas2 is single-species; ntypes "
            f"{ntypes} runs compute_eam_forces_pallas_mt")
    if count_neighbors and 0.0 < neigh_r2 < float(scene.grid.cutoff) ** 2:
        raise NotImplementedError(
            "K4 counts the neighbours within the cutoff; a shorter "
            "neigh_r2 is not ported for compute_eam_forces_pallas2")
    cl = scene_to_cl(scene)
    F, epot, rho, nn, _, _ = eam_kernels_cl(cl.xi, cl.alive, eam, scene.grid)
    zero = torch.zeros_like(rho)
    return _force_result(
        (F, epot if need_energy else zero, rho,
         nn if count_neighbors else zero,
         torch.zeros((), dtype=torch.float64, device=rho.device),
         torch.zeros(6, dtype=torch.float64, device=rho.device)),
        scene.grid.dims)


# ---------------------------------------------------------------------------
# the R/F split over pre-rolled half-stencil views (K10, K11)
# ---------------------------------------------------------------------------

def make_neighbor_views(grid, dtype, device="cpu"):
    """views(xi [cap,3,NC]) -> nbr [13,cap,3,NC]: the neighbour cell at
    each half-stencil offset, rolled, with its periodic box shift added
    and cells across an open face at SENTINEL_CELL (the per-step half of
    ``prep_neighbors``; the shifts and validity are made once here, as
    imd_tpu's fused step makes them at trace time)."""
    dims = grid.dims
    consts = [_wrap_shift_mask_cl(grid, off, dtype, device)
              for off in HALF_OFFSETS]

    def views(xi):
        nbr = torch.empty((NOF,) + tuple(xi.shape), dtype=xi.dtype,
                          device=xi.device)
        far = xi.new_tensor(SENTINEL_CELL)
        for m, (off, (shift, ok)) in enumerate(zip(HALF_OFFSETS, consts)):
            torch.where(ok[None, None, :],
                        _roll_cells(xi, dims, off) + shift[None], far,
                        out=nbr[m])
        return nbr

    return views


def prep_neighbors(scene: Scene, views=None):
    """Cells-last views with sentinel-pushed invalid positions: (xi
    [cap,3,NC] with dead slots at SENTINEL_DEAD, nbr [13,cap,3,NC],
    mask [cap,NC]).  ``views``: ``make_neighbor_views`` of the scene's
    grid, made once by a caller that steps (its shifts and validity come
    from the host), else made here."""
    grid = scene.grid
    mask = _to_cl(scene.type, grid.dims) >= 0
    xi = torch.where(mask[:, None, :], _to_cl(scene.pos, grid.dims),
                     SENTINEL_DEAD).contiguous()
    if views is None:
        views = make_neighbor_views(grid, xi.dtype, xi.device)
    return xi, views(xi), mask


def _assemble(dims, acc_i, accj):
    """Roll back the per-offset partner sums ``accj`` [13, ...] and add
    them to ``acc_i``."""
    total = acc_i
    for k, off in enumerate(HALF_OFFSETS):
        total = total + _roll_cells_back(accj[k], dims, off)
    return total


def _half_pairs(xi, nbr, rcut2):
    """The half stencil as the TPU kernels sweep it: yields (m, dx, dy, dz,
    r2, inside) [cap_i, cap_j, NC] for the own cell (m = -1, pairs with
    i < j) and then the 13 views (m = 0..12); ``inside`` is 0/1 in the
    dtype of xi."""
    cap = xi.shape[0]
    tri = torch.ones(cap, cap, dtype=torch.bool,
                     device=xi.device).triu(1)[:, :, None]
    for m in range(-1, NOF):
        xj = xi if m < 0 else nbr[m]
        d = [xi[:, None, k, :] - xj[None, :, k, :] for k in range(3)]
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        inside = r2 < rcut2
        if m < 0:
            inside = inside & tri
        yield (m, *d, r2, inside.to(xi.dtype))


def _nr2(grid, neigh_r2: float) -> float:
    """The neighbour-count radius^2: ``neigh_r2``, or the cutoff's."""
    return float(neigh_r2 if neigh_r2 > 0 else float(grid.cutoff) ** 2)


def _book(acc_i, acc_j, k, m, v):
    """Add the pair values ``v`` [cap_i, cap_j, NC] of sweep ``m`` to the
    i-sums and j-partials of output ``k`` (the own cell: both to i)."""
    if m < 0:
        acc_i[k] = v.sum(1) + v.sum(0)
    else:
        acc_i[k] += v.sum(1)
        acc_j[k, m] = v.sum(0)


def eam_rho_half_plain(xi, nbr, eam, grid, count_neighbors: bool = False,
                       neigh_r2: float = 0.0):
    """Plain torch K10: (acc_i [nk,cap,NC], acc_j [nk,13,cap,NC]), the
    i-sums and per-offset j-partials of rho (k = 0) and, when
    ``count_neighbors``, of the neighbour count within ``neigh_r2``
    (k = 1); unmasked."""
    rcut2 = float(grid.cutoff) ** 2
    nr2 = _nr2(grid, neigh_r2)
    rho_c = _poly_consts(eam.rho)
    cap, _, nc = xi.shape
    nk = 2 if count_neighbors else 1
    acc_i = xi.new_zeros((nk, cap, nc))
    acc_j = xi.new_zeros((nk, NOF, cap, nc))
    for m, _, _, _, r2, insf in _half_pairs(xi, nbr, rcut2):
        _book(acc_i, acc_j, 0, m, _horner_v(r2, rho_c) * insf)
        if count_neighbors:
            _book(acc_i, acc_j, 1, m, insf if nr2 >= rcut2
                  else insf * (r2 < nr2).to(xi.dtype))
    return acc_i, acc_j


def eam_force_half_plain(xi, nbr, dF, dFn, eam, grid):
    """Plain torch K11: (acc_i [3,cap,NC], acc_j [3,13,cap,NC]), the
    i-sums and j-partials of fx, fy, fz from grad = phi'(r^2) + (dF_i +
    dF_j) rho'(r^2), with ``dFn`` [13,cap,NC] the views of ``dF``;
    unmasked."""
    pair_c, rho_c = _poly_consts(eam.pair), _poly_consts(eam.rho)
    cap, _, nc = xi.shape
    acc_i = xi.new_zeros((3, cap, nc))
    acc_j = xi.new_zeros((3, NOF, cap, nc))
    for m, dx, dy, dz, r2, insf in _half_pairs(
            xi, nbr, float(grid.cutoff) ** 2):
        dfj = dF if m < 0 else dFn[m]
        pg, rg = _horner_g2(r2, pair_c, rho_c)
        grad = (pg + (dF[:, None, :] + dfj[None, :, :]) * rg) * insf
        for k, d in enumerate((dx, dy, dz)):
            gd = grad * d
            if m < 0:
                acc_i[k] = -gd.sum(1) + gd.sum(0)
            else:
                acc_i[k] += -gd.sum(1)
                acc_j[k, m] = gd.sum(0)
    return acc_i, acc_j


def _check_half_inputs(xi, nbr, grid):
    cap, _, nc = xi.shape
    if xi.dtype != torch.float32 or not xi.is_contiguous():
        raise TypeError("the half-stencil kernels take contiguous float32 "
                        "xi [cap,3,NC]")
    if nbr.dtype != torch.float32 or tuple(nbr.shape) != (NOF, cap, 3, nc) \
            or not nbr.is_contiguous() or nbr.device != xi.device:
        raise TypeError("the half-stencil kernels take contiguous float32 "
                        f"nbr [{NOF},cap,3,NC] on the device of xi")
    if nc != grid.n_cells:
        raise ValueError(f"xi has {nc} cells, grid {grid.dims} has "
                         f"{grid.n_cells}")
    if cap > kernels.HALF_MAX_CAP:
        raise ValueError(f"capacity {cap} exceeds the half-stencil kernels' "
                         f"limit of {kernels.HALF_MAX_CAP} slots")


def eam_rho_half(xi, nbr, eam, grid, count_neighbors: bool = False,
                 neigh_r2: float = 0.0):
    """K10 wrapper: ``eam_rho_half_plain``'s (acc_i, acc_j) at every
    live slot.  A dead slot's values are unspecified: the kernel skips
    slots at SENTINEL_DEAD (and writes zeros there) where the plain version
    pairs two dead slots of one cell."""
    if not xi.is_cuda:
        if xi.device.type != "cpu":
            raise TypeError(f"unsupported device {xi.device}")
        return eam_rho_half_plain(xi, nbr, eam, grid, count_neighbors,
                                  neigh_r2)
    _check_half_inputs(xi, nbr, grid)
    cap, _, nc = xi.shape
    nk = 2 if count_neighbors else 1
    acc_i = torch.empty((nk, cap, nc), dtype=xi.dtype, device=xi.device)
    acc_j = torch.empty((nk, NOF, cap, nc), dtype=xi.dtype,
                        device=xi.device)
    err = kernels.lib().imd_eam_rho_half(
        xi.data_ptr(), nbr.data_ptr(), acc_i.data_ptr(), acc_j.data_ptr(),
        int(bool(count_neighbors)), _nr2(grid, neigh_r2),
        _params_for(eam, grid, cap, half="rho"), nc,
        kernels.stream_ptr(xi.device))
    kernels.check(err, "eam_rho_half")
    kernels.LAUNCHES["eam_rho_half"] += 1
    return acc_i, acc_j


def eam_force_half(xi, nbr, dF, dFn, eam, grid):
    """K11 wrapper: ``eam_force_half_plain``'s (acc_i, acc_j) at every
    live slot.  A dead slot's values are unspecified: the kernel skips
    slots at SENTINEL_DEAD (and writes zeros there) where the plain version
    pairs two dead slots of one cell."""
    if not xi.is_cuda:
        if xi.device.type != "cpu":
            raise TypeError(f"unsupported device {xi.device}")
        return eam_force_half_plain(xi, nbr, dF, dFn, eam, grid)
    _check_half_inputs(xi, nbr, grid)
    _check_cuda_dF(dF, xi, "eam_force_half")
    cap, _, nc = xi.shape
    if dFn.dtype != torch.float32 or tuple(dFn.shape) != (NOF, cap, nc) \
            or not dFn.is_contiguous() or dFn.device != xi.device:
        raise TypeError(f"eam_force_half takes contiguous float32 dFn "
                        f"[{NOF},cap,NC] on the device of xi")
    acc_i = torch.empty((3, cap, nc), dtype=xi.dtype, device=xi.device)
    acc_j = torch.empty((3, NOF, cap, nc), dtype=xi.dtype, device=xi.device)
    err = kernels.lib().imd_eam_force_half(
        xi.data_ptr(), nbr.data_ptr(), dF.data_ptr(), dFn.data_ptr(),
        acc_i.data_ptr(), acc_j.data_ptr(),
        _params_for(eam, grid, cap, half="force"), nc,
        kernels.stream_ptr(xi.device))
    kernels.check(err, "eam_force_half")
    kernels.LAUNCHES["eam_force_half"] += 1
    return acc_i, acc_j


def _rho_nn(dims, acc_i, acc_j):
    """(rho, nn) assembled from K10's outputs; nn zero when not counted."""
    rho = _assemble(dims, acc_i[0], acc_j[0])
    nn = (_assemble(dims, acc_i[1], acc_j[1]) if len(acc_i) > 1
          else torch.zeros_like(rho))
    return rho, nn


def _forces(dims, acc_i, acc_j):
    """F [cap,3,NC] assembled from K11's outputs."""
    return torch.stack([_assemble(dims, acc_i[k], acc_j[k])
                        for k in range(3)], 1)


def _dF_views(dF, dims):
    """The 13 half-stencil views of dF [cap,NC] (no shift, no sentinel)."""
    return torch.stack([_roll_cells(dF, dims, off) for off in HALF_OFFSETS])


def eam_r_pass(xi, nbr, eam, grid, count_neighbors: bool = False,
               neigh_r2: float = 0.0, block: int = 128, unroll: int = 1):
    """The R pass of the split (K10, assembled): UNMASKED (rho, nneigh)
    [cap,NC]; nneigh is zero unless ``count_neighbors``.  Live slots hold
    the host density and the count within ``neigh_r2``; a dead slot's
    values are unspecified (K10 skips dead slots and writes zeros; the
    plain version pairs two dead slots of one cell), so the caller masks
    them.  ``block``/``unroll`` are the TPU's and ignored."""
    return _rho_nn(grid.dims, *eam_rho_half(xi, nbr, eam, grid,
                                            count_neighbors, neigh_r2))


def eam_r_pass_plain(xi, nbr, eam, grid, count_neighbors: bool = False,
                     neigh_r2: float = 0.0):
    """Plain torch ``eam_r_pass``."""
    return _rho_nn(grid.dims, *eam_rho_half_plain(xi, nbr, eam, grid,
                                                  count_neighbors, neigh_r2))


def eam_f_pass(xi, nbr, dF, eam, grid, block: int = 128, unroll: int = 1):
    """The F pass of the split (K11, assembled): UNMASKED forces
    [cap,3,NC] from the combined gradient phi' + (dF_i + dF_j) rho', with
    ``dF`` [cap,NC] the half embedding derivative, masked by the caller.
    A dead slot's values are unspecified (K11 skips dead slots; the plain
    version pairs two dead slots of one cell)."""
    return _forces(grid.dims, *eam_force_half(
        xi, nbr, dF, _dF_views(dF, grid.dims), eam, grid))


def eam_f_pass_plain(xi, nbr, dF, eam, grid):
    """Plain torch ``eam_f_pass``."""
    return _forces(grid.dims, *eam_force_half_plain(
        xi, nbr, dF, _dF_views(dF, grid.dims), eam, grid))


def eam_kernels_cl_split(xi, nbr, mask, eam, grid,
                         count_neighbors: bool = False,
                         neigh_r2: float = 0.0, block: int = 128,
                         unroll: int = 1, timer=no_timer):
    """Forces-only EAM via the R/F split over the given views (single
    device, one species): the R pass, the embedding derivative, the F pass
    with the combined gradient.  Returns MASKED (F [cap,3,NC], rho,
    nneigh), the contract of imd_tpu's eam_kernels_cl_split.  ``timer``
    wraps the R pass (``r_pass``) and the embedding with the F pass
    (``f_pass``)."""
    maskf = mask.to(xi.dtype)
    with timer("r_pass"):
        rho, nn = eam_r_pass(xi, nbr, eam, grid, count_neighbors, neigh_r2)
    with timer("f_pass"):
        _, emb_g = eam.embed.interp(0, rho)
        dF = 0.5 * emb_g * maskf
        F = eam_f_pass(xi, nbr, dF, eam, grid)
    return F * maskf[:, None, :], rho * maskf, nn * maskf


# ---------------------------------------------------------------------------
# B6: the pair engine over pre-rolled half-stencil views (K12)
# ---------------------------------------------------------------------------

def _pair_keys(need_energy: bool, count_neighbors: bool):
    """The per-pair outputs that get i-sums and j-partials, in K12's
    order."""
    return (("fx", "fy", "fz") + (("e",) if need_energy else ())
            + (("nn",) if count_neighbors else ()))


def pair_half_plain(xi, nbr, pot, grid, count_neighbors: bool = False,
                    neigh_r2: float = 0.0, need_energy: bool = True,
                    need_stress: bool = True):
    """Plain torch K12: (acc_i [nk,cap,NC], acc_s [6,cap,NC] or None,
    acc_j [nk,13,cap,NC]).  For every pair of the half stencil, with g =
    2 dphi/dr^2 of the fit: fx, fy, fz (-g d on the i side, +g d on the j
    side), e (phi/2 to each side) when ``need_energy``, the count within
    ``neigh_r2`` when ``count_neighbors``; and the six stress sums -g d_a
    d_b (Voigt xx yy zz yz zx xy), i side only, when ``need_stress``.
    Unmasked, as K10/K11."""
    rcut2 = float(grid.cutoff) ** 2
    nr2 = _nr2(grid, neigh_r2)
    pair_c = _poly_consts(pot)
    keys = _pair_keys(need_energy, count_neighbors)
    cap, _, nc = xi.shape
    acc_i = xi.new_zeros((len(keys), cap, nc))
    acc_j = xi.new_zeros((len(keys), NOF, cap, nc))
    acc_s = xi.new_zeros((6, cap, nc)) if need_stress else None
    for m, dx, dy, dz, r2, insf in _half_pairs(xi, nbr, rcut2):
        g = _horner_g(r2, pair_c) * insf
        d = (dx, dy, dz)
        gd = [g * dc for dc in d]
        for k in range(3):
            if m < 0:
                acc_i[k] = -gd[k].sum(1) + gd[k].sum(0)
            else:
                acc_i[k] += -gd[k].sum(1)
                acc_j[k, m] = gd[k].sum(0)
        if need_energy:
            _book(acc_i, acc_j, 3, m, 0.5 * (_horner_v(r2, pair_c) * insf))
        if count_neighbors:
            _book(acc_i, acc_j, len(keys) - 1, m, insf if nr2 >= rcut2
                  else insf * (r2 < nr2).to(xi.dtype))
        if need_stress:
            for k, (a, b) in enumerate(_VOIGT):
                acc_s[k] += -(gd[a] * d[b]).sum(1)
    return acc_i, acc_s, acc_j


def pair_half(xi, nbr, pot, grid, count_neighbors: bool = False,
              neigh_r2: float = 0.0, need_energy: bool = True,
              need_stress: bool = True):
    """K12 wrapper: ``pair_half_plain``'s (acc_i, acc_s, acc_j) at every
    live slot.  A dead slot's values are unspecified: the kernel skips
    slots at SENTINEL_DEAD (and writes zeros there) where the plain version
    pairs two dead slots of one cell."""
    if not xi.is_cuda:
        if xi.device.type != "cpu":
            raise TypeError(f"unsupported device {xi.device}")
        return pair_half_plain(xi, nbr, pot, grid, count_neighbors,
                               neigh_r2, need_energy, need_stress)
    _check_half_inputs(xi, nbr, grid)
    cap, _, nc = xi.shape
    nk = len(_pair_keys(need_energy, count_neighbors))
    acc_i = torch.empty((nk, cap, nc), dtype=xi.dtype, device=xi.device)
    acc_j = torch.empty((nk, NOF, cap, nc), dtype=xi.dtype,
                        device=xi.device)
    acc_s = (torch.empty((6, cap, nc), dtype=xi.dtype, device=xi.device)
             if need_stress else None)
    err = kernels.lib().imd_pair_half(
        xi.data_ptr(), nbr.data_ptr(), acc_i.data_ptr(),
        0 if acc_s is None else acc_s.data_ptr(), acc_j.data_ptr(),
        int(bool(need_energy)), int(bool(count_neighbors)),
        _nr2(grid, neigh_r2),
        _pair_params(pot, grid, cap,
                     "pair_energy" if need_energy else "pair"), nc,
        kernels.stream_ptr(xi.device))
    kernels.check(err, "pair_half")
    kernels.LAUNCHES["pair_half"] += 1
    return acc_i, acc_s, acc_j


def compute_pair_forces_pallas(scene: Scene, pot, ntypes: int = 1,
                               count_neighbors: bool = False,
                               neigh_r2: float = 0.0, block: int = 256,
                               need_energy: bool = True,
                               need_stress=None, timer=no_timer,
                               views=None) -> ForceResult:
    """B6 (imd_tpu/ops/forces_pallas.py:431): the pair engine of the
    general step, one species, on the fastpoly fit ``pot``
    (to_fastpoly(pair, vcap=50)).  Builds the 13 views (``prep_neighbors``,
    timed as ``views``), runs K12 and assembles (``forces``).  Returns the
    masked force, epot (zero unless ``need_energy``) and neighbour count
    (zero unless ``count_neighbors``), the virial and the pressure tensor
    (float64 sums of K12's i-side stress; zero unless ``need_stress``,
    which defaults to ``need_energy``).  imd_tpu bakes table column 0
    whatever ``ntypes`` says (ROADMAP C3); the port refuses ``ntypes`` > 1.
    ``views`` as in ``prep_neighbors``; ``block`` is the TPU's lane block
    and is ignored."""
    if ntypes > 1:
        raise ValueError(
            f"compute_pair_forces_pallas is single-species: imd_tpu's B6 "
            f"evaluates table column 0 for every pair whatever the types "
            f"(ROADMAP C3), so ntypes {ntypes} is refused")
    if need_stress is None:
        need_stress = need_energy
    grid = scene.grid
    dims = grid.dims
    with timer("views"):
        xi, nbr, mask = prep_neighbors(scene, views)
    with timer("forces"):
        acc_i, acc_s, acc_j = pair_half(xi, nbr, pot, grid, count_neighbors,
                                        neigh_r2, need_energy, need_stress)
        keys = _pair_keys(need_energy, count_neighbors)
        acc = {k: _assemble(dims, acc_i[n], acc_j[n])
               for n, k in enumerate(keys)}
        maskf = mask.to(xi.dtype)
        zero = torch.zeros_like(maskf)
        F = torch.stack([acc["fx"], acc["fy"], acc["fz"]], 1) \
            * maskf[:, None, :]
        epot = acc["e"] * maskf if need_energy else zero
        nn = acc["nn"] * maskf if count_neighbors else zero
        if need_stress:
            presstens = acc_s.to(torch.float64).sum(dim=(1, 2))
        else:
            presstens = torch.zeros(6, dtype=torch.float64,
                                    device=xi.device)
        out = ForceResult(force=_from_cl(F, dims), epot=_from_cl(epot, dims),
                          virial=presstens[:3].sum(), presstens=presstens,
                          num_neighs=_from_cl(nn.to(torch.int32), dims))
    return out
