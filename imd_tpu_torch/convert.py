"""Carry state across from the JAX package, and back to NumPy.

The ``from_*`` functions take imd_tpu objects (Box, CellGrid, PotTable,
PolyPotential, EAMPotential with any number of type columns, Scene with
its types, CLState, TTMParams, TTMGrid) and read
every field through ``np.asarray``, so this module never imports jax: it
works on anything with those attributes.  ``to_numpy`` turns a port
dataclass back into a dict of NumPy arrays.  The parity tests use both so
that the two packages compute from identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from imd_tpu_torch.models.potential import (EAMPotential, PolyPotential,
                                            PotTable)
from imd_tpu_torch.models.ttm import TTMGrid, TTMParams
from imd_tpu_torch.ops.fused_step import CLState
from imd_tpu_torch.ops.geometry import Box, CellGrid
from imd_tpu_torch.scene import Scene


def _t(a, device):
    return torch.as_tensor(np.array(np.asarray(a))).to(device)


def from_box(box) -> Box:
    return Box(h=np.array(np.asarray(box.h)),
               inv_h=np.array(np.asarray(box.inv_h)),
               pbc=tuple(int(p) for p in box.pbc))


def from_grid(grid) -> CellGrid:
    if getattr(grid, "xbounds", None) is not None:
        raise NotImplementedError("LOADBALANCE xbounds are not ported")
    return CellGrid(box=from_box(grid.box),
                    dims=tuple(int(d) for d in grid.dims),
                    capacity=int(grid.capacity), cutoff=float(grid.cutoff),
                    skin=float(grid.skin))


def from_poly(poly) -> PolyPotential:
    return PolyPotential(coef=np.array(np.asarray(poly.coef)),
                         begin=np.array(np.asarray(poly.begin)),
                         end=np.array(np.asarray(poly.end)),
                         max_err=tuple(poly.max_err), host=poly.host)


def from_table(pt) -> PotTable:
    return PotTable(**{f.name: np.array(np.asarray(getattr(pt, f.name)))
                       for f in dataclasses.fields(PotTable)})


def from_eam(eam) -> EAMPotential:
    """An EAM set of tables or of fastpoly fits (the kernels' input), with
    all its type columns."""
    def one(p):
        return from_table(p) if hasattr(p, "table") else from_poly(p)
    return EAMPotential(pair=one(eam.pair), rho=one(eam.rho),
                        embed=one(eam.embed))


def from_scene(scene, device="cuda") -> Scene:
    kw = {f.name: _t(getattr(scene, f.name), device)
          for f in dataclasses.fields(Scene) if f.name != "grid"}
    return Scene(grid=from_grid(scene.grid), **kw)


def from_cl(cl, device="cuda") -> CLState:
    if getattr(cl, "xbounds", None) is not None:
        raise NotImplementedError("LOADBALANCE xbounds are not ported")
    return CLState(**{f.name: _t(getattr(cl, f.name), device)
                      for f in dataclasses.fields(CLState)})


def from_ttm_params(tp) -> TTMParams:
    return TTMParams(**{f.name: getattr(tp, f.name)
                        for f in dataclasses.fields(TTMParams)})


def from_ttm_grid(tg, device="cuda") -> TTMGrid:
    kw = {}
    for f in dataclasses.fields(TTMGrid):
        v = getattr(tg, f.name)
        kw[f.name] = (bool(np.asarray(v)) if f.type == "bool"
                      else _t(v, device))
    return TTMGrid(**kw)


def to_numpy(obj) -> dict:
    """Port dataclass -> {field: NumPy array or Python value}."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v.detach().cpu().numpy() if torch.is_tensor(v) else v
    return out
