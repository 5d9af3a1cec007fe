"""`.ttm` grid output (port of imd_tpu/io/ttm_io.py:24 ``write_ttm``;
ttm_writeout, imd_ttm.c:1683).

Text table, one row per FD cell of the 1-D grid (y = z = 0), header
(imd_ttm.c:1885):
    #x y z natoms temp md_temp U xi source dens vx vy vz fd_k fd_g Z proc Ce
then, with COLRAD, the populations c0..c{nlev-1} and the five power
columns P_EE P_EI P_MPI2 P_MPI3 P_RR (imd_ttm.c:1885-1897); with the
virtual lattice its cells as extra rows with natoms = -2 (imd_ttm.c:1926).

Only the writer of the one-rank 1-D grid is ported: the multi-rank
``proc`` routing belongs to several devices, and reading a ``.ttm`` back
for a TTM restart waits for the restart slice.
"""

from __future__ import annotations

import numpy as np

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
