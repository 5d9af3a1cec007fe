"""Stencil offsets and the all-pairs EAM oracle (port of
imd_tpu/ops/forces.py:34-39, 615).

``eam_forces_n2`` is the port's own reference for the force kernels: plain
torch over all N^2 minimum-image pairs, no cells, no kernels.
"""

from __future__ import annotations

import torch

from imd_tpu_torch.ops.geometry import Box

# 27-stencil offsets; HALF_OFFSETS = the 13 lexicographically positive ones
ALL_OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
               for k in (-1, 0, 1)]
HALF_OFFSETS = [o for o in ALL_OFFSETS if o > (0, 0, 0)]


def min_image(box: Box, dr: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement vectors [..., 3]."""
    h = torch.as_tensor(box.h, device=dr.device).to(dr.dtype)
    inv_h = torch.as_tensor(box.inv_h, device=dr.device).to(dr.dtype)
    frac = dr @ inv_h
    period = torch.tensor(box.pbc, dtype=dr.dtype, device=dr.device)
    frac = frac - torch.round(frac) * period
    return frac @ h


def _interp_cols(tab, cols, x):
    """(value, 2 dV/dx) of ``tab`` with a column index per element:
    each column is evaluated on all of ``x`` and selected where it
    applies (``interp`` takes one column at a time)."""
    v = torch.zeros_like(x)
    g = torch.zeros_like(x)
    for c in torch.unique(cols).tolist():
        vc, gc = tab.interp(c, x)
        sel = cols == c
        v = torch.where(sel, vc, v)
        g = torch.where(sel, gc, g)
    return v, g


def eam_forces_n2(pos, mask, box: Box, eam, typ=None, ntypes: int = 1):
    """All-pairs EAM oracle.  pos [N,3], mask [N] bool, ``typ`` [N] integer
    types for ``ntypes`` > 1 (columns as in EAMPotential: pair
    t_i*ntypes + t_j, density at i from j t_j*ntypes + t_i).

    Returns (F [N,3], rho [N], nneigh [N]) over pairs within the EAM
    cutoff.  Potentials are evaluated with ``interp`` (the JAX oracle's
    convention, linear continuation below the fit window)."""
    N = pos.shape[0]
    dr = min_image(box, pos[:, None, :] - pos[None, :, :])
    r2 = (dr * dr).sum(-1)
    eye = torch.eye(N, dtype=torch.bool, device=pos.device)
    valid = (~eye) & mask[:, None] & mask[None, :] & (r2 < eam.cutoff2)
    r2c = torch.clamp(r2, min=1e-12)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    if ntypes == 1:
        _, phig = eam.pair.interp(0, r2c)
        rho_ij, rho_g_ij = eam.rho.interp(0, r2c)
    else:
        t = torch.clamp(typ.to(torch.int64), 0, ntypes - 1)
        t_i, t_j = t[:, None], t[None, :]
        _, phig = _interp_cols(eam.pair, t_i * ntypes + t_j, r2c)
        rho_ij, rho_g_ij = _interp_cols(eam.rho, t_j * ntypes + t_i, r2c)
    phig = torch.where(valid, phig, zero)
    rho_ij = torch.where(valid, rho_ij, zero)
    rho_g_ij = torch.where(valid, rho_g_ij, zero)
    rho = rho_ij.sum(1)
    rho_c = torch.clamp(rho, min=1e-12)
    if ntypes == 1:
        _, df = eam.embed.interp(0, rho_c)
    else:
        _, df = _interp_cols(eam.embed, t, rho_c)
    df = torch.where(mask, 0.5 * df, zero)
    s = phig + df[:, None] * rho_g_ij + df[None, :] * rho_g_ij.T
    s = torch.where(valid, s, zero)
    F = -(s[..., None] * dr).sum(1)
    return F, rho, valid.to(pos.dtype).sum(1)
