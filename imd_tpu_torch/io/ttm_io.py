"""`.ttm` grid output and the TTM restart input (port of
imd_tpu/io/ttm_io.py; ttm_writeout / ttm_read, imd_ttm.c:1683/1983).

Text table, one row per FD cell of the 1-D grid (y = z = 0), header
(imd_ttm.c:1885):
    #x y z natoms temp md_temp U xi source dens vx vy vz fd_k fd_g Z proc Ce
then, with COLRAD, the populations c0..c{nlev-1} and the five power
columns P_EE P_EI P_MPI2 P_MPI3 P_RR (imd_ttm.c:1885-1897); with the
virtual lattice its cells as extra rows with natoms = -2 (imd_ttm.c:1926).

Only the writer of the one-rank 1-D grid is ported: the multi-rank
``proc`` routing belongs to several devices.  A checkpoint also writes the
``.ttmaux.npz`` sidecar (``write_ttm_aux``): the FDTD fields, the virtual
lattice, the grid's restartable fields at full precision (the text keeps
``%e``, 7 digits) and the per-atom FD index keyed by atom id.  Its keys and
dtypes are imd_tpu's, so each package reads the other's files.  The COLRAD
populations come back through the text's ``c*`` columns only, as in
imd_tpu: a COLRAD restart continues to ~1e-6 relative.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from imd_tpu_torch.models.colrad import POWER_KEYS

COLUMNS = ("x", "y", "z", "natoms", "temp", "md_temp", "U", "xi", "source",
           "dens", "vx", "vy", "vz", "fd_k", "fd_g", "Z", "proc", "Ce")


def write_ttm(path: str, grid, colrad_c=None, colrad_p=None,
              vlat=None) -> None:
    """Write a 1-D TTMGrid (tensors on any device) in the reference's
    layout, one host transfer per field.  ``colrad_c`` [nx, nlev] and
    ``colrad_p`` [nx, 5]: the COLRAD columns; ``vlat`` (VlatState): the
    virtual cells' rows, with the last active cell's density."""
    def host(a):
        return a.detach().cpu().numpy()

    vcom = host(grid.vcom)
    natoms = host(grid.natoms).astype(np.int64)
    cols = {name: host(getattr(grid, name))
            for name in ("temp", "md_temp", "U", "xi", "source", "dens",
                         "fd_k", "fd_g", "Z", "Ce")}
    cols.update(vx=vcom[:, 0], vy=vcom[:, 1], vz=vcom[:, 2])
    names = list(COLUMNS)
    if colrad_c is not None:
        cc = host(colrad_c)
        for lev in range(cc.shape[1]):
            names.append(f"c{lev}")
            cols[f"c{lev}"] = cc[:, lev]
    if colrad_p is not None:
        pp = host(colrad_p)
        for k, key in enumerate(POWER_KEYS[:pp.shape[1]]):
            names.append(key)
            cols[key] = pp[:, k]
    active = np.nonzero(natoms > 0)[0]
    last_dens = float(cols["dens"][active[-1]]) if len(active) else 0.0
    with open(path, "w") as f:
        f.write("#" + " ".join(names) + "\n")
        for i in range(len(natoms)):
            vals = [str(i), "0", "0", str(int(natoms[i]))]
            for name in names[4:]:
                vals.append("0" if name == "proc"
                            else "%e" % float(cols[name][i]))
            f.write(" ".join(vals) + "\n")
        if vlat is not None:
            te, ti = host(vlat.te), host(vlat.ti)
            for k in range(len(te)):
                row = [str(len(natoms) + k), "0", "0", "-2", "%e" % te[k],
                       "%e" % ti[k]]
                for name in names[6:]:
                    if name == "dens":
                        row.append("%e" % last_dens)
                    elif name == "proc":
                        row.append("0")
                    else:
                        row.append("0.000000e+00")
                f.write(" ".join(row) + "\n")


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def read_ttm(path: str) -> dict:
    """A .ttm file as a dict of NumPy columns."""
    with open(path) as f:
        header = f.readline().lstrip("#").split()
        data = np.loadtxt(f)
    data = np.atleast_2d(data)
    return {name: data[:, i] for i, name in enumerate(header)}


def vlat_from_ttm(path: str, vlat_template):
    """The virtual lattice's T_e and T_i from the natoms = -2 rows the
    reference appends (imd_ttm.c:1926): the template with te/ti replaced,
    or None when the file has fewer such rows than the lattice."""
    d = read_ttm(path)
    m = np.asarray(d["natoms"]) == -2
    if not m.any():
        return None
    te = np.asarray(d["temp"])[m]
    ti = np.asarray(d["md_temp"])[m]
    nv = vlat_template.te.numel()
    if len(te) < nv:
        return None
    like = vlat_template.te
    return dataclasses.replace(
        vlat_template,
        te=torch.as_tensor(te[:nv], dtype=like.dtype).to(like.device),
        ti=torch.as_tensor(ti[:nv], dtype=like.dtype).to(like.device))


def colrad_from_ttm(path: str, nlev: int, dtype=torch.float32,
                    device="cuda"):
    """COLRAD populations [n, nlev] of the grid's cells from the c*
    columns, or None if the file has none (colrad_read,
    imd_colrad.c:3028).  The virtual lattice's natoms -2 rows are left
    out: imd_tpu keeps them and cannot restore a COLRAD run with
    ``vlatdim`` (ROADMAP C7)."""
    d = read_ttm(path)
    if "c0" not in d:
        return None
    rows = np.asarray(d["natoms"]) != -2
    cols = [d[f"c{k}"][rows] for k in range(nlev) if f"c{k}" in d]
    return torch.as_tensor(np.stack(cols, axis=-1), dtype=dtype).to(device)


def grid_from_ttm(path: str, grid, dtype=None):
    """The restartable fields of a TTMGrid from a .ttm file (natoms also
    as natoms_old; init_done set)."""
    d = read_ttm(path)
    n = grid.temp.numel()
    if len(d["temp"]) < n:
        raise ValueError(f".ttm file has {len(d['temp'])} cells, grid has "
                         f"{n}")
    dt = dtype or grid.temp.dtype
    dev = grid.temp.device
    shape = grid.temp.shape

    def a(name):
        return torch.as_tensor(d[name][:n], dtype=dt).to(dev).reshape(shape)

    nat = torch.as_tensor(d["natoms"][:n]).to(torch.int32).to(dev)
    return grid.replace(
        temp=a("temp"), md_temp=a("md_temp"), U=a("U"),
        natoms=nat.reshape(shape), natoms_old=nat.reshape(shape).clone(),
        dens=a("dens"), vcom=torch.stack([a("vx"), a("vy"), a("vz")], -1),
        xi=a("xi"), source=a("source"), Z=a("Z"), fd_k=a("fd_k"),
        fd_g=a("fd_g"), Ce=a("Ce"), init_done=True)


def write_ttm_aux(path: str, fdtd=None, vlat=None, grid=None, fdi=None,
                  ids=None, alive=None) -> None:
    """The restart sidecar (imd_tpu's write_ttm_aux): ``fdtd_*`` the FDTD
    fields, ``vlat_te``/``vlat_ti``, ``grid_*`` the grid's restartable
    fields at full precision (with natoms_old: the previous step's counts
    scale the first restarted step's advection, do_ADV, imd_ttm.c:1208),
    and ``fdi_ids``/``fdi_vals`` the per-atom FD index of the last
    update_fd over the live slots (``alive``), keyed by atom id."""
    arrs = {}
    if fdtd is not None:
        for f in dataclasses.fields(fdtd):
            arrs[f"fdtd_{f.name}"] = _host(getattr(fdtd, f.name))
    if vlat is not None:
        arrs["vlat_te"] = _host(vlat.te)
        arrs["vlat_ti"] = _host(vlat.ti)
    if grid is not None:
        for name in ("temp", "md_temp", "U", "natoms", "natoms_old", "dens",
                     "source", "xi"):
            arrs[f"grid_{name}"] = _host(getattr(grid, name))
    if fdi is not None and ids is not None:
        f = _host(fdi).ravel()
        i = _host(ids).ravel()
        keep = _host(alive).ravel() if alive is not None else i >= 0
        arrs["fdi_ids"] = i[keep]
        arrs["fdi_vals"] = f[keep]
    np.savez(path, **arrs)


def read_ttm_aux(path: str, fdtd_template=None, vlat_template=None):
    """(fdtd_state, vlat_state) restored onto the templates, None where
    the file has no entry."""
    d = np.load(path)
    fdtd = vlat = None
    if fdtd_template is not None and any(k.startswith("fdtd_")
                                         for k in d.files):
        kw = {}
        for f in dataclasses.fields(fdtd_template):
            key, ref = f"fdtd_{f.name}", getattr(fdtd_template, f.name)
            kw[f.name] = (torch.as_tensor(d[key], dtype=ref.dtype).to(
                ref.device) if key in d.files else ref)
        fdtd = type(fdtd_template)(**kw)
    if vlat_template is not None and "vlat_te" in d.files:
        like = vlat_template.te
        vlat = dataclasses.replace(
            vlat_template,
            te=torch.as_tensor(d["vlat_te"], dtype=like.dtype).to(
                like.device),
            ti=torch.as_tensor(d["vlat_ti"], dtype=like.dtype).to(
                like.device))
    return fdtd, vlat


def grid_overlay_from_aux(path: str, grid):
    """The sidecar's full-precision grid fields over a grid restored from
    the text .ttm (which a reference-written restart has alone)."""
    d = np.load(path)
    kw = {}
    dev = grid.temp.device
    for name in ("temp", "md_temp", "U", "dens", "source", "xi"):
        key = f"grid_{name}"
        if key in d.files:
            ref = getattr(grid, name)
            kw[name] = torch.as_tensor(d[key], dtype=ref.dtype).to(
                dev).reshape(ref.shape)
    if "grid_natoms" in d.files:
        nat = torch.as_tensor(d["grid_natoms"]).to(torch.int32).to(
            dev).reshape(grid.natoms.shape)
        kw["natoms"] = nat
        kw["natoms_old"] = nat.clone()
    if "grid_natoms_old" in d.files:
        kw["natoms_old"] = torch.as_tensor(d["grid_natoms_old"]).to(
            torch.int32).to(dev).reshape(grid.natoms.shape)
    return grid.replace(**kw) if kw else grid


def fdi_from_aux(path: str, scene_ids, scene_alive):
    """The per-atom FD index for the restart's slot layout, by atom id
    (NumPy int32 of ``scene_ids``' shape): -1 for dead slots and for ids
    the sidecar does not know (deleted by FILTER since); None if the
    sidecar has no index."""
    d = np.load(path)
    if "fdi_ids" not in d.files:
        return None
    saved_ids = np.asarray(d["fdi_ids"])
    order = np.argsort(saved_ids)
    sid = saved_ids[order]
    sfd = np.asarray(d["fdi_vals"])[order]
    ids = _host(scene_ids)
    flat = ids.ravel()
    pos = np.clip(np.searchsorted(sid, flat), 0, max(len(sid) - 1, 0))
    if len(sid) == 0:
        return np.full(ids.shape, -1, np.int32)
    ok = (sid[pos] == flat) & _host(scene_alive).ravel()
    return np.where(ok, sfd[pos], -1).astype(np.int32).reshape(ids.shape)
