"""Box geometry and the linked-cell grid (port of imd_tpu/ops/geometry.py).

The box and the grid are static host-side metadata here: the fused hot loop
never changes the box, so ``Box.h``/``inv_h`` stay NumPy arrays rounded to
the storage dtype (exactly the values the JAX package holds on device), and
kernels and torch code read them as Python floats.  The host-side grid
choosers stay NumPy, as in the JAX package.

Not ported in this slice: the LOADBALANCE ``xbounds`` slabs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

_NP_OF_TORCH = {torch.float32: np.float32, torch.float64: np.float64}


def np_dtype(dtype) -> np.dtype:
    """NumPy dtype for a torch or NumPy float dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(_NP_OF_TORCH[dtype])
    return np.dtype(dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class Box:
    """Simulation box: rows of ``h`` are the box vectors (IMD box_x/y/z).

    ``h`` and ``inv_h`` are rounded to the storage dtype, like the JAX
    package's device arrays, so host binning sees identical values.
    """
    h: np.ndarray
    inv_h: np.ndarray
    pbc: Tuple[int, int, int] = (1, 1, 1)

    @classmethod
    def create(cls, box_x, box_y, box_z, pbc=(1, 1, 1),
               dtype=np.float32) -> "Box":
        h = np.asarray([box_x, box_y, box_z], np.float64)
        if abs(np.linalg.det(h)) < 1e-12:
            raise ValueError("box has zero volume")
        dt = np_dtype(dtype)
        return cls(h=h.astype(dt), inv_h=np.linalg.inv(h).astype(dt),
                   pbc=tuple(int(p) for p in pbc))

    def heights(self) -> np.ndarray:
        """Perpendicular heights of the box along each direction (host)."""
        h = np.asarray(self.h, np.float64)
        v = abs(np.linalg.det(h))
        out = np.empty(3)
        for i in range(3):
            a, b = h[(i + 1) % 3], h[(i + 2) % 3]
            out[i] = v / np.linalg.norm(np.cross(a, b))
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class CellGrid:
    """Static linked-cell grid metadata."""
    box: Box
    dims: Tuple[int, int, int]
    capacity: int
    cutoff: float      # interaction cutoff (A)
    skin: float        # nbl_margin (A)

    @property
    def n_cells(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    def replace(self, **kw) -> "CellGrid":
        return dataclasses.replace(self, **kw)


def choose_grid(box: Box, cutoff: float, skin: float, n_atoms: int,
                capacity: int = 0, headroom: float = 1.6) -> CellGrid:
    """Most cells with height >= cutoff + skin (init_cells,
    imd_geom_3d.c:118); ``capacity`` 0 sizes it from the mean density
    with ``headroom`` slack, rounded up to a multiple of 8."""
    reach = cutoff + skin
    dims = tuple(max(1, int(math.floor(h / reach))) for h in box.heights())
    if capacity <= 0:
        mean = n_atoms / (dims[0] * dims[1] * dims[2])
        capacity = max(4, int(math.ceil(mean * headroom)))
        capacity = ((capacity + 7) // 8) * 8
    return CellGrid(box=box, dims=dims, capacity=int(capacity),
                    cutoff=float(cutoff), skin=float(skin))


def host_bin_ijk(grid: CellGrid, pos, dtype=np.float32) -> np.ndarray:
    """Host-side cell indices [N,3], exactly as a Scene of ``dtype`` bins:
    positions rounded to the storage dtype first, wrapped in f64, the
    wrapped result rounded again, then binned (see the JAX twin for why
    both roundings matter on commensurate lattices)."""
    dt = np_dtype(dtype)
    p = np.asarray(pos, dt).astype(np.float64)
    h = np.asarray(grid.box.h, np.float64)
    inv_h = np.asarray(grid.box.inv_h, np.float64)
    period = np.asarray(grid.box.pbc, np.float64)
    frac = p @ inv_h
    frac = frac - np.floor(frac) * period
    wrapped = (frac @ h).astype(dt)
    gx, gy, gz = grid.dims
    frac2 = (wrapped.astype(np.float64) @ inv_h) * np.array([gx, gy, gz])
    return np.clip(np.floor(frac2).astype(np.int64), 0,
                   np.array([gx - 1, gy - 1, gz - 1]))


def measured_capacity(grid: CellGrid, pos, safety: float = 1.25,
                      extra: int = 2, multiple: int = 8,
                      dtype=np.float32) -> int:
    """Capacity from the MEASURED max cell occupancy (host-side, at setup)."""
    gx, gy, gz = grid.dims
    ijk = host_bin_ijk(grid, pos, dtype)
    flat = (ijk[:, 0] * gy + ijk[:, 1]) * gz + ijk[:, 2]
    occ = np.bincount(flat, minlength=gx * gy * gz)
    cap = int(np.ceil(occ.max() * safety)) + extra
    return max(multiple, ((cap + multiple - 1) // multiple) * multiple)


def optimize_grid_dims(box: Box, cutoff: float, skin: float, pos,
                       dtype=np.float32, max_capacity: int = 0,
                       headroom_slots: int = 1):
    """Cell dims minimizing the dense-sweep cost cap^2 * n_cells over the
    measured occupancy (+``headroom_slots`` migration slots, rounded up to
    a multiple of 8), searching cell edges within
    1/0.8 of the smallest; returns (dims, capacity), or None when
    ``max_capacity`` > 0 and no candidate fits."""
    reach = cutoff + skin
    heights = box.heights()
    n_max = [max(1, int(math.floor(heights[d] / reach))) for d in range(3)]
    best = None
    cand = set()
    for d in range(3):
        for n in range(max(1, int(n_max[d] * 0.80)), n_max[d] + 1):
            cand.add(heights[d] / n)
    for edge in sorted(cand):
        dims = []
        ok = True
        for d in range(3):
            n = min(n_max[d], int(math.floor(heights[d] / edge + 1e-9)))
            if n < 1 or heights[d] / n < reach - 1e-9:
                ok = False
                break
            dims.append(n)
        if not ok:
            continue
        dims = tuple(dims)
        g = CellGrid(box=box, dims=dims, capacity=8,
                     cutoff=float(cutoff), skin=float(skin))
        raw = measured_capacity(g, pos, safety=1.0, extra=0, multiple=1,
                                dtype=dtype)
        cap = max(8, ((raw + headroom_slots + 7) // 8) * 8)
        if max_capacity > 0 and cap > max_capacity:
            continue
        score = cap * cap * dims[0] * dims[1] * dims[2]
        if best is None or score < best[0]:
            best = (score, dims, cap)
    if best is None:
        if max_capacity > 0:
            return None
        raise ValueError("no feasible cell grid for the given box/cutoff")
    return best[1], best[2]


def with_capacity(grid: CellGrid, capacity: int) -> CellGrid:
    return grid.replace(capacity=int(capacity))
