"""Carry state across from the JAX package, and back to NumPy.

The ``from_*`` functions take imd_tpu objects (Box, CellGrid, PotTable,
PolyPotential, a pair potential or an EAMPotential with any number of type
columns, Scene with its types, CLState, TTMParams, TTMGrid, NRBState,
TMMParams, ColradTables and ColradGridState, FDTDParams and FDTDState,
VlatParams and VlatState, TabulatedEOS) and read
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
from imd_tpu_torch.models import colrad as colrad_mod
from imd_tpu_torch.models import fdtd as fdtd_mod
from imd_tpu_torch.models import nrb as nrb_mod
from imd_tpu_torch.models.eos import TabulatedEOS
from imd_tpu_torch.models.tmm import TMMParams
from imd_tpu_torch.models.ttm import (TTMGrid, TTMParams, VlatParams,
                                      VlatState)
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


def from_pot(pot):
    """A table (PotTable) or its fastpoly fit (PolyPotential, B6's and the
    kernels' input) with all its type columns: a pair potential, or one
    table of an EAM set."""
    return from_table(pot) if hasattr(pot, "table") else from_poly(pot)


def from_eam(eam) -> EAMPotential:
    """An EAM set of tables or of fastpoly fits, with all its type
    columns."""
    return EAMPotential(pair=from_pot(eam.pair), rho=from_pot(eam.rho),
                        embed=from_pot(eam.embed))


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


def nrb_state_from_jax(st, device="cuda") -> nrb_mod.NRBState:
    """imd_tpu's NRBState (its leaves read as NumPy arrays) as the port's,
    in the dtype of its reference positions."""
    ref = np.asarray(st.bnd_ref)
    return nrb_mod.make_state(
        np.asarray(st.bnd_id), np.asarray(st.bnd_type), ref,
        np.asarray(st.neigh_id), np.asarray(st.neigh_ref),
        float(np.asarray(st.nrbk)), float(np.asarray(st.mass)),
        int(st.n_ids), dtype=(torch.float64 if ref.dtype == np.float64
                               else torch.float32), device=device)


def tmm_params_from_jax(tp, device="cuda") -> TMMParams:
    """imd_tpu's TMMParams: its static fields and its tables (in their
    dtype) as the port's."""
    tables = ("k1_tab", "k2_tab", "bb_lam_um", "bb_re", "bb_im")
    kw = {f.name: getattr(tp, f.name) for f in dataclasses.fields(TMMParams)
          if f.init and f.name not in tables}
    return TMMParams(**kw, **{n: _t(getattr(tp, n), device)
                              for n in tables})


def colrad_tables_from_jax(tab, device="cuda") -> colrad_mod.ColradTables:
    """imd_tpu's ColradTables, each table in its dtype, indices as
    int64."""
    kw = {}
    for f in dataclasses.fields(colrad_mod.ColradTables):
        v = getattr(tab, f.name)
        if f.name == "n_lev":
            kw[f.name] = int(v)
        elif f.name in ("exc_i", "exc_j", "ion_i", "ion_j"):
            kw[f.name] = _t(np.asarray(v, np.int64), device)
        else:
            kw[f.name] = _t(v, device)
    return colrad_mod.ColradTables(**kw)


def colrad_state_from_jax(cs, device="cuda") -> colrad_mod.ColradGridState:
    return colrad_mod.ColradGridState(
        c=_t(cs.c, device), p=None if cs.p is None else _t(cs.p, device))


def fdtd_params_from_jax(fp, device="cuda") -> fdtd_mod.FDTDParams:
    """imd_tpu's 1-D FDTDParams: its static fields and its PML profile."""
    kw = {f.name: getattr(fp, f.name)
          for f in dataclasses.fields(fdtd_mod.FDTDParams)
          if f.name != "sigma_y"}
    return fdtd_mod.FDTDParams(**kw, sigma_y=_t(fp.sigma_y, device))


def fdtd_state_from_jax(fs, device="cuda") -> fdtd_mod.FDTDState:
    return fdtd_mod.FDTDState(**{
        f.name: _t(getattr(fs, f.name), device)
        for f in dataclasses.fields(fdtd_mod.FDTDState)})


def vlat_from_jax(vp, vs, device="cuda"):
    """imd_tpu's (VlatParams, VlatState) as the port's."""
    return (VlatParams(nv=int(vp.nv), dens0=float(vp.dens0),
                       ci=float(vp.ci), atomic_z=float(vp.atomic_z),
                       atomic_mass=float(vp.atomic_mass)),
            VlatState(te=_t(vs.te, device), ti=_t(vs.ti, device)))


def eos_from_jax(eos, device="cuda") -> TabulatedEOS:
    """imd_tpu's TabulatedEOS: its resampled tables in their dtype."""
    return TabulatedEOS(
        rho_grid=_t(eos.rho_grid, device), tsq_grid=_t(eos.tsq_grid, device),
        ee=_t(eos.ee, device), cve=_t(eos.cve, device),
        atomic_mass=float(eos.atomic_mass))


def to_numpy(obj) -> dict:
    """Port dataclass -> {field: NumPy array or Python value}."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v.detach().cpu().numpy() if torch.is_tensor(v) else v
    return out
