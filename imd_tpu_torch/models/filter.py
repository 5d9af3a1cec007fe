"""FILTER: deletion of ablated atoms outside a keep-region (port of
imd_tpu/models/filter.py; the reference's imd_filter.c).

Atoms beyond the filter bounds (filter_min_x / filter_max_x / ...,
filter_init:36-72) are candidates; a candidate survives while a chain of
neighbours within the bond cutoff connects it to an atom inside the bounds
(filter_check_neighs:214-320 walks that chain up to NEIGHDEPTH).  As in
imd_tpu the connection is a flood fill of ``n_sweeps`` OR sweeps over the
27-cell stencil, each one bond deeper; deletion sets type = -1 and the next
rebin drops the atom.

Each sweep holds the [cells, cap, cap] distance block of one stencil
offset at a time, summed component by component (at run1m's 446 x 24 x 24
cells and capacity 24 one such block is ~0.6 GB in float32).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from imd_tpu_torch.ops.forces import (ALL_OFFSETS, _neighbor_view,
                                      _wrap_shift_and_mask)
from imd_tpu_torch.scene import Scene


def _neighbor_or(scene: Scene, flag: torch.Tensor, r2_cut: float):
    """Per slot: does any *other* live atom within sqrt(r2_cut) have
    ``flag``?"""
    pos = scene.pos
    grid = scene.grid
    mask = scene.mask
    acc = torch.zeros_like(mask)
    for off in ALL_OFFSETS:
        pos_n = _neighbor_view(grid, pos, off)
        flag_n = _neighbor_view(grid, flag, off)
        mask_n = _neighbor_view(grid, mask, off)
        shift, valid = _wrap_shift_and_mask(grid, off, pos.dtype, pos.device)
        pos_n = pos_n + shift
        d2 = None
        for c in range(3):
            d = pos[..., :, None, c] - pos_n[..., None, :, c]
            d2 = d * d if d2 is None else d2 + d * d
        ok = (d2 <= r2_cut) & (d2 > 1e-9)
        ok &= (flag_n & mask_n & valid)[..., None, :]
        acc |= ok.any(-1)
    return acc & mask


def filter_atoms(scene: Scene, bounds, r_cut: float,
                 n_sweeps: int = 8) -> Tuple[Scene, torch.Tensor]:
    """Delete the disconnected atoms outside the keep-region.

    ``bounds`` has min_x/max_x/min_y/max_y/min_z/max_z (an infinite bound
    is off); ``r_cut`` is the bond cutoff.  Returns (scene, n_deleted as a
    0-d device tensor)."""
    cand = torch.zeros_like(scene.mask)
    for ax, (lo, hi) in enumerate(((bounds.min_x, bounds.max_x),
                                   (bounds.min_y, bounds.max_y),
                                   (bounds.min_z, bounds.max_z))):
        c = scene.pos[..., ax]
        if lo is not None and math.isfinite(lo):
            cand |= c < lo
        if hi is not None and math.isfinite(hi):
            cand |= c > hi
    cand &= scene.mask
    keep = scene.mask & ~cand
    r2 = r_cut * r_cut
    for _ in range(n_sweeps):
        keep = keep | (cand & _neighbor_or(scene, keep, r2))
    delete = cand & ~keep
    return (scene.replace(type=torch.where(delete, -1, scene.type)),
            delete.sum())
