"""EAM observables on the cells-last layout: forces, per-atom energy, host
density, neighbour count, virial and pressure tensor (port of
imd_tpu/ops/forces_pallas.py:216 ``eam_kernels_cl`` and :395
``compute_eam_forces_pallas``, the kernel pair the driver calls at every
.eng interval).

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

The driver always asks for every observable, so the JAX package's
``need_energy``/``need_stress``/``count_neighbors`` switches are not ported:
the forces-only passes are the hot loop's K1/K2 (ops/forces_win.py).

Beside the wrappers sit the plain torch versions ``eam_rho_e_plain`` and
``eam_force_s_plain`` (the 27-offset sweep of ``eam_rho_plain`` /
``eam_force_plain``).  The wrappers take them only for CPU tensors; on a
CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import dataclasses

import torch

from imd_tpu_torch import kernels
from imd_tpu_torch.ops.forces_fast import _from_cl
from imd_tpu_torch.ops.forces_win import (_check_cuda_inputs, _horner_g2,
                                          _horner_v, _params_for,
                                          _poly_consts, _stencil_pairs)
from imd_tpu_torch.ops.fused_step import scene_to_cl
from imd_tpu_torch.scene import Scene

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
    rho: torch.Tensor          # [gx,gy,gz,cap]


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


def eam_force_s_plain(xi, alive, dF, eam, grid):
    """Plain torch K5: (F [cap,3,NC], S [6,cap,NC]), zero in dead slots;
    S holds -1/2 sum_j grad d_a d_b in Voigt order."""
    pair_c, rho_c = _poly_consts(eam.pair), _poly_consts(eam.rho)
    F = torch.zeros_like(xi)
    S = torch.zeros((6,) + tuple(dF.shape), dtype=xi.dtype, device=xi.device)
    for dx, dy, dz, r2, valid, roll in _stencil_pairs(xi, alive, grid):
        pg, rg = _horner_g2(r2, pair_c, rho_c)
        grad = (pg + (dF[:, None, :] + roll(dF)[None, :, :]) * rg) \
            * valid.to(xi.dtype)
        d = (dx, dy, dz)
        F = F - torch.stack([(grad * dc).sum(1) for dc in d], 1)
        S = S - 0.5 * torch.stack([(grad * d[a] * d[b]).sum(1)
                                   for a, b in _VOIGT])
    return F, S


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
        e.data_ptr(), _params_for(eam, grid, cap), nc,
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
    cap, _, nc = xi.shape
    if dF.dtype != torch.float32 or dF.shape != (cap, nc) \
            or not dF.is_contiguous() or dF.device != xi.device:
        raise TypeError("eam_force_s takes contiguous float32 dF [cap,NC] "
                        "on the device of xi")
    F = torch.empty_like(xi)
    S = torch.empty((6, cap, nc), dtype=xi.dtype, device=xi.device)
    err = kernels.lib().imd_eam_force_s(
        xi.data_ptr(), alive.data_ptr(), dF.data_ptr(), F.data_ptr(),
        S.data_ptr(), _params_for(eam, grid, cap), nc,
        kernels.stream_ptr(xi.device))
    kernels.check(err, "eam_force_s")
    kernels.LAUNCHES["eam_force_s"] += 1
    return F, S


def eam_kernels_cl(xi, mask, eam, grid):
    """Observables EAM on cells-last views (single device, one species).

    ``xi`` [cap,3,NC] positions (dead slots at SENTINEL_DEAD), ``mask``
    [cap,NC] bool.  Returns (F [cap,3,NC], epot, rho, nneigh [cap,NC],
    virial, presstens [6]), the contract of imd_tpu's eam_kernels_cl with
    every observable on; the virial and presstens are float64 sums."""
    maskf = mask.to(xi.dtype)
    rho, nn, e = eam_rho_e(xi, mask, eam, grid)
    emb_v, emb_g = eam.embed.interp(0, rho)
    dF = 0.5 * emb_g * maskf        # interp returns 2 dV/dx
    F, S = eam_force_s(xi, mask, dF, eam, grid)
    presstens = S.to(torch.float64).sum(dim=(1, 2))
    epot = (e + emb_v) * maskf
    return F, epot, rho * maskf, nn * maskf, presstens[:3].sum(), presstens


def compute_eam_forces_pallas(scene: Scene, eam) -> ForceResult:
    """Scene entry of ``eam_kernels_cl``."""
    dims = scene.grid.dims
    cl = scene_to_cl(scene)
    F, epot, rho, nn, virial, presstens = eam_kernels_cl(
        cl.xi, cl.alive, eam, scene.grid)
    return ForceResult(force=_from_cl(F, dims), epot=_from_cl(epot, dims),
                       virial=virial, presstens=presstens,
                       num_neighs=_from_cl(nn.to(torch.int32), dims),
                       rho=_from_cl(rho, dims))
