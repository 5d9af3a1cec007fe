"""Scene: the atom state as fixed-capacity per-cell arrays (port of
imd_tpu/scene.py).

Layout is the JAX package's cell-major one,

    pos, mom, force : [gx, gy, gz, cap, 3]
    epot, mass      : [gx, gy, gz, cap]
    type, vtype, id : [gx, gy, gz, cap]  (int32; type == -1 marks empty slots)

so tests compare like with like.  The fused hot loop converts it once to the
cells-last ``CLState`` (ops/fused_step.py) and keeps it there.

Set-up bins on the host, as the JAX package does (``_bin_flat_host``,
bit-identical to it): one bulk host->device copy.  ``rebin`` re-bins on the
scene's device (``_bin_flat``, the JAX package's traced binning: a stable
argsort by cell, the rank within each run of one cell, a scatter to the
slots), so the general step's skin-triggered rebin moves no atom through the
host; it gives imd_tpu's slot order.  ``needs_rebin`` is the skin check.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from imd_tpu_torch.ops.forces import min_image
from imd_tpu_torch.ops.geometry import CellGrid, host_bin_ijk, np_dtype


@dataclasses.dataclass(eq=False)
class Scene:
    pos: torch.Tensor          # [gx, gy, gz, cap, 3]
    mom: torch.Tensor          # [gx, gy, gz, cap, 3]
    force: torch.Tensor        # [gx, gy, gz, cap, 3]
    epot: torch.Tensor         # [gx, gy, gz, cap]
    mass: torch.Tensor         # [gx, gy, gz, cap]
    type: torch.Tensor         # [gx, gy, gz, cap] int32, -1 = empty
    vtype: torch.Tensor        # [gx, gy, gz, cap] int32
    id: torch.Tensor           # [gx, gy, gz, cap] int32
    nbl_ref_pos: torch.Tensor  # positions at last rebin
    overflow: torch.Tensor     # int32 scalar: atoms dropped by overflow
    grid: CellGrid

    @property
    def mask(self) -> torch.Tensor:
        return self.type >= 0

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)


def _bin_flat_host(grid: CellGrid, pos, arrays, cap, dtype):
    """NumPy binning of flat per-atom arrays into the padded cell layout
    (twin of imd_tpu.scene._bin_flat_host).  Returns NumPy arrays."""
    gx, gy, gz = grid.dims
    n_cells = gx * gy * gz
    dt = np_dtype(dtype)
    pos = np.asarray(pos, np.float64)
    mask = np.asarray(arrays["mask"], bool)
    h = np.asarray(grid.box.h, np.float64)
    inv_h = np.asarray(grid.box.inv_h, np.float64)
    period = np.asarray(grid.box.pbc, np.float64)
    frac = pos @ inv_h
    frac = frac - np.floor(frac) * period
    wrapped = (frac @ h).astype(dt)
    ijk = host_bin_ijk(grid, pos, dt)
    cidx = (ijk[:, 0] * gy + ijk[:, 1]) * gz + ijk[:, 2]
    cidx = np.where(mask, cidx, n_cells)
    order = np.argsort(cidx, kind="stable")
    cidx_s = cidx[order]
    counts = np.bincount(cidx_s, minlength=n_cells + 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(cidx_s)) - starts[cidx_s]
    alive_s = cidx_s < n_cells
    keep = alive_s & (rank < cap)
    target = (cidx_s * cap + rank)[keep]
    overflow = int(np.sum(alive_s & (rank >= cap)))

    out = {}
    for name, a in arrays.items():
        if name == "mask":
            continue
        a = np.asarray(a)
        a_s = a[order][keep]
        fill_shape = (n_cells * cap,) + a.shape[1:]
        if np.issubdtype(a.dtype, np.integer):
            binned = np.full(fill_shape, -1, np.int32)
        else:
            binned = np.zeros(fill_shape, dt)
        binned[target] = a_s
        out[name] = binned.reshape((gx, gy, gz, cap) + a.shape[1:])
    pos_binned = np.zeros((n_cells * cap, 3), dt)
    pos_binned[target] = wrapped[order][keep]
    out["pos"] = pos_binned.reshape(gx, gy, gz, cap, 3)
    return out, overflow


def make_scene(grid: CellGrid, pos, *, mom=None, mass=None, type=None,
               vtype=None, id=None, dtype=torch.float32,
               device="cuda") -> Scene:
    """Build a Scene from flat host arrays (default: type 0, vtype = type,
    ids 0..N-1).  ``mom`` injects momenta (tests feed both packages the
    same NumPy momenta instead of either package's random generator)."""
    dt = np_dtype(dtype)
    pos = np.asarray(pos, dt)
    N = pos.shape[0]
    mom = np.zeros((N, 3), dt) if mom is None else np.asarray(mom, dt)
    mass = np.ones((N,), dt) if mass is None else np.asarray(mass, dt)
    type_ = (np.zeros((N,), np.int32) if type is None
             else np.asarray(type, np.int32))
    vtype = type_ if vtype is None else np.asarray(vtype, np.int32)
    id_ = (np.arange(N, dtype=np.int32) if id is None
           else np.asarray(id, np.int32))
    arrays = {"mask": np.ones((N,), bool), "mom": mom, "mass": mass,
              "type": type_, "vtype": vtype, "id": id_,
              "epot": np.zeros((N,), dt)}
    out, overflow = _bin_flat_host(grid, pos, arrays, grid.capacity, dt)
    t = {k: torch.as_tensor(v).to(device) for k, v in out.items()}
    return Scene(pos=t["pos"], mom=t["mom"],
                 force=torch.zeros_like(t["pos"]), epot=t["epot"],
                 mass=t["mass"], type=t["type"], vtype=t["vtype"],
                 id=t["id"], nbl_ref_pos=t["pos"].clone(),
                 overflow=torch.tensor(overflow, dtype=torch.int32,
                                       device=device),
                 grid=grid)


def flatten_atoms(scene: Scene) -> dict:
    """Flat [M, ...] views (M = n_cells * cap) of every field plus the
    mask (imd_tpu Scene.flatten_atoms)."""
    M = scene.grid.n_cells * scene.grid.capacity
    return {"pos": scene.pos.reshape(M, 3), "mom": scene.mom.reshape(M, 3),
            "force": scene.force.reshape(M, 3),
            "epot": scene.epot.reshape(M), "mass": scene.mass.reshape(M),
            "type": scene.type.reshape(M), "vtype": scene.vtype.reshape(M),
            "id": scene.id.reshape(M), "mask": scene.mask.reshape(M)}


def n_atoms(scene: Scene) -> int:
    return int(scene.mask.sum())


def _mat(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m, device=like.device).to(like.dtype)


def wrap(box, pos: torch.Tensor) -> torch.Tensor:
    """Positions wrapped into the box along its periodic axes (Box.wrap)."""
    frac = pos @ _mat(box.inv_h, pos)
    period = torch.tensor(box.pbc, dtype=frac.dtype, device=frac.device)
    return (frac - torch.floor(frac) * period) @ _mat(box.h, pos)


def cell_index(grid: CellGrid, pos: torch.Tensor) -> torch.Tensor:
    """Flat cell id (int64) of wrapped positions [N, 3] (CellGrid.
    cell_index)."""
    frac = pos @ _mat(grid.box.inv_h, pos)
    dims = torch.tensor(grid.dims, dtype=frac.dtype, device=frac.device)
    ijk = torch.floor(frac * dims).to(torch.int64)
    ijk = torch.minimum(ijk.clamp(min=0), torch.tensor(
        grid.dims, device=pos.device) - 1)
    gy, gz = grid.dims[1], grid.dims[2]
    return (ijk[:, 0] * gy + ijk[:, 1]) * gz + ijk[:, 2]


def _bin_flat(grid: CellGrid, pos, arrays, cap):
    """Scatter flat per-atom tensors into the padded cell layout on their
    device (twin of imd_tpu.scene._bin_flat).  ``arrays`` must hold
    'mask'.  Dead atoms and the atoms past a cell's capacity are dropped
    (written to one spare slot that is cut off).  Returns the cell-shaped
    dict and the overflow count as an int32 device scalar."""
    gx, gy, gz = grid.dims
    n_cells = gx * gy * gz
    n = pos.shape[0]
    wrapped = wrap(grid.box, pos)
    cidx = torch.where(arrays["mask"], cell_index(grid, wrapped), n_cells)
    order = torch.argsort(cidx, stable=True)
    cidx_s = cidx[order]
    ar = torch.arange(n, device=pos.device)
    is_start = torch.ones(n, dtype=torch.bool, device=pos.device)
    is_start[1:] = cidx_s[1:] != cidx_s[:-1]
    rank = ar - torch.cummax(torch.where(is_start, ar, 0), 0).values
    alive_s = cidx_s < n_cells
    target = torch.where(alive_s & (rank < cap), cidx_s * cap + rank,
                         n_cells * cap)
    out = {}
    for name, a in list(arrays.items()) + [("pos", wrapped)]:
        if name == "mask":
            continue
        fill = -1 if not a.is_floating_point() else 0
        binned = torch.full((n_cells * cap + 1,) + tuple(a.shape[1:]), fill,
                            dtype=a.dtype, device=a.device)
        binned[target] = a[order]
        out[name] = binned[:-1].reshape((gx, gy, gz, cap) + tuple(a.shape[1:]))
    overflow = (alive_s & (rank >= cap)).sum().to(torch.int32)
    return out, overflow


def rebin(scene: Scene, grid: CellGrid | None = None) -> Scene:
    """Re-sort every atom into its current cell of ``grid`` (default: the
    scene's own) on the scene's device, resetting the skin reference
    (fix_cells; imd_tpu/scene.py:225).  Epot travels with its atom,
    forces are zeroed; atoms past a cell's capacity are dropped and
    counted in ``overflow``."""
    return rebin_with(scene, None, grid)[0]


def rebin_with(scene: Scene, extra, grid: CellGrid | None = None):
    """``rebin`` that also carries the cell-shaped [gx, gy, gz, cap, ...]
    arrays of the dict ``extra`` with their atoms (dead and dropped
    slots: -1 for integer fields, 0 for floats), as the reference moves
    the TTM's stored FD index with its atom (imd_tpu/scene.py:237).
    Returns (scene', extra' or None)."""
    grid = scene.grid if grid is None else grid
    flat = flatten_atoms(scene)
    arrays = {k: flat[k] for k in ("mask", "mom", "mass", "type", "vtype",
                                   "id", "epot")}
    for name, a in (extra or {}).items():
        arrays[name] = a.reshape((-1,) + tuple(a.shape[4:]))
    out, overflow = _bin_flat(grid, flat["pos"], arrays, grid.capacity)
    scene = scene.replace(
        pos=out["pos"], mom=out["mom"], force=torch.zeros_like(out["pos"]),
        epot=out["epot"], mass=out["mass"], type=out["type"],
        vtype=out["vtype"], id=out["id"], nbl_ref_pos=out["pos"],
        overflow=scene.overflow + overflow, grid=grid)
    return scene, ({name: out[name] for name in extra} if extra else None)


def max_displacement2(scene: Scene) -> torch.Tensor:
    """Largest squared displacement of a live atom since the last rebin,
    minimum image (check_nblist, imd_forces_nbl.c:1062)."""
    d = min_image(scene.grid.box, scene.pos - scene.nbl_ref_pos)
    d2 = (d * d).sum(-1)
    return torch.where(scene.mask, d2, torch.zeros_like(d2)).max()


def needs_rebin(scene: Scene, margin: float) -> torch.Tensor:
    """True (a device bool) when an atom moved more than half the skin."""
    return max_displacement2(scene) > (0.5 * margin) ** 2


def grow_capacity(scene: Scene, new_cap: int) -> Scene:
    """The same Scene with the slot axis padded to ``new_cap`` (dead slots:
    -1 for int fields, 0 for floats); slot assignments stay valid
    (alloc_cell, imd_alloc.c:551)."""
    extra = new_cap - scene.grid.capacity
    if extra <= 0:
        return scene

    def pad(a):
        widths = [0, 0] * (a.ndim - 4) + [0, extra]
        fill = -1 if not a.is_floating_point() else 0
        return torch.nn.functional.pad(a, widths, value=fill)

    return scene.replace(
        pos=pad(scene.pos), mom=pad(scene.mom), force=pad(scene.force),
        epot=pad(scene.epot), mass=pad(scene.mass), type=pad(scene.type),
        vtype=pad(scene.vtype), id=pad(scene.id),
        nbl_ref_pos=pad(scene.nbl_ref_pos),
        grid=scene.grid.replace(capacity=new_cap))
