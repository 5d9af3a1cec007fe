"""Spatial distribution (binned field) output (port of
imd_tpu/io/distrib.py; imd_distrib.c).

``compute_distrib`` bins per-atom quantities onto a dist_dim grid with
``index_add_`` on the scene's device (the reference loops atoms into float
arrays, make_distrib_density:400-440); ``write_distrib`` writes the
reference's format (write_distrib_header, imd_distrib.c:805):

    #F <A|B|L> dim n_coord n_data
    #C <contents>
    #D nx ny nz
    #S sx sy sz
    #E
    <data: x-major loop order, ASCII columns or float32 binary>

Fields: num, Ekin, Epot, mdtemp (the kinetic temperature with the bin's
centre-of-mass motion removed), vx/vy/vz (that motion).
"""

from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from imd_tpu_torch.scene import flatten_atoms


def compute_distrib(scene, dist_dim: Tuple[int, int, int], ll=None,
                    ur=None) -> Dict[str, np.ndarray]:
    """Bin the scene's atoms onto the dist grid: float32 NumPy fields
    [nx, ny, nz]."""
    nx, ny, nz = dist_dim
    n_bins = nx * ny * nz
    dt, dev = scene.pos.dtype, scene.pos.device

    def vec(a):
        return torch.as_tensor(np.array(a, np.float64), dtype=dt,
                               device=dev)
    ll = torch.zeros(3, dtype=dt, device=dev) if ll is None else vec(ll)
    ur = vec(np.diag(np.asarray(scene.grid.box.h)) if ur is None else ur)
    dims = torch.as_tensor(dist_dim, device=dev)
    width = (ur - ll) / dims.to(dt)

    flat = flatten_atoms(scene)
    m = flat["mask"]
    ijk = torch.floor((flat["pos"] - ll) / width).to(torch.int32)
    ijk = torch.minimum(torch.clamp(ijk, min=0), (dims - 1).to(torch.int32))
    b = (ijk[:, 0] * ny + ijk[:, 1]) * nz + ijk[:, 2]
    seg = torch.where(m, b, n_bins).to(torch.int64)

    def ssum(x):
        out = torch.zeros((n_bins + 1,) + x.shape[1:], dtype=x.dtype,
                          device=dev)
        return out.index_add_(0, seg, x)[:n_bins]

    fm = m.to(dt)
    mass_a, mom_a = flat["mass"], flat["mom"]
    num = ssum(fm)
    inv_mass = torch.where(m, 1.0 / torch.clamp(mass_a, min=1e-30), 0.0)
    ekin = ssum(0.5 * (mom_a ** 2).sum(-1) * inv_mass)
    epot = ssum(flat["epot"] * fm)
    mom = ssum(mom_a * fm[:, None])
    mass = ssum(mass_a * fm)
    vcom = torch.where(mass[:, None] > 0, mom / mass[:, None], 0.0)
    v = mom_a * inv_mass[:, None]
    dv = (v - vcom[torch.clamp(seg, 0, n_bins - 1)]) * fm[:, None]
    mdt = ssum((dv * dv).sum(-1) * mass_a)
    mdtemp = torch.where(num > 0, mdt / (3.0 * torch.clamp(num, min=1.0)),
                         0.0)
    out = {"num": num, "Ekin": ekin, "Epot": epot, "mdtemp": mdtemp,
           "vx": vcom[:, 0], "vy": vcom[:, 1], "vz": vcom[:, 2]}
    return {k: a.detach().cpu().numpy().astype(np.float32).reshape(dist_dim)
            for k, a in out.items()}


def write_distrib(path: str, fields: Dict[str, np.ndarray],
                  names: Sequence[str], dist_dim, bin_size,
                  mode: str = "ascii") -> None:
    """The selected fields in the reference layout (one file, n_data
    columns); ``mode`` 'ascii', 'ascii_coord' or 'binary'."""
    nx, ny, nz = dist_dim
    n = len(names)
    fmt = {"binary": ("L" if np.little_endian else "B"),
           "ascii": "A", "ascii_coord": "A"}[mode]
    n_coord = 3 if mode == "ascii_coord" else 0
    with open(path, "wb") as f:
        hdr = (f"#F {fmt} 3 {n_coord} {n}\n"
               + ("#C x y z " if n_coord else "#C ")
               + " ".join(names) + "\n"
               + f"#D {nx} {ny} {nz}\n"
               + "#S " + " ".join(f"{s:e}" for s in bin_size) + "\n"
               + f"## Generated on {time.ctime()}\n"
               + "## by imd_tpu\n#E\n")
        f.write(hdr.encode())
        data = np.stack([np.asarray(fields[k], np.float32).reshape(-1)
                         for k in names], axis=1)
        if mode == "binary":
            f.write(data.astype("<f4" if fmt == "L" else ">f4").tobytes())
            return
        lines = []
        for idx in range(data.shape[0]):
            row = ""
            if n_coord:
                row = f"{idx // (ny * nz)} {(idx // nz) % ny} {idx % nz} "
            row += " ".join(f"{v:.6e}" for v in data[idx])
            lines.append(row)
        f.write(("\n".join(lines) + "\n").encode())


def read_distrib(path: str):
    """A distribution file (either format): (meta, data [nx,ny,nz,n])."""
    with open(path, "rb") as f:
        raw = f.read()
    head, _, rest = raw.partition(b"#E\n")
    meta = {}
    for line in head.decode().splitlines():
        if line.startswith("#F"):
            tok = line.split()
            meta["fmt"], meta["n"] = tok[1], int(tok[4])
            meta["n_coord"] = int(tok[3])
        elif line.startswith("#D"):
            meta["dim"] = tuple(int(x) for x in line.split()[1:])
        elif line.startswith("#S"):
            meta["size"] = tuple(float(x) for x in line.split()[1:])
        elif line.startswith("#C"):
            meta["contents"] = line.split()[1:]
    if meta["fmt"] in ("L", "B"):
        dt = "<f4" if meta["fmt"] == "L" else ">f4"
        data = np.frombuffer(rest, dt).reshape(-1, meta["n"])
    else:
        data = np.loadtxt(rest.decode().splitlines(), ndmin=2)
        if meta["n_coord"]:
            data = data[:, meta["n_coord"]:]
    return meta, data.reshape(meta["dim"] + (meta["n"],))
