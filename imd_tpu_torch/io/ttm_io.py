"""`.ttm` grid output (port of imd_tpu/io/ttm_io.py:24 ``write_ttm``;
ttm_writeout, imd_ttm.c:1683).

Text table, one row per FD cell of the 1-D grid (y = z = 0), header
(imd_ttm.c:1885):
    #x y z natoms temp md_temp U xi source dens vx vy vz fd_k fd_g Z proc Ce

Only the writer of the plain 1-D grid is ported: the COLRAD columns, the
VLATTICE rows and the multi-rank ``proc`` routing belong to features this
port does not run yet, and reading a ``.ttm`` back for a TTM restart waits
for the restart slice.
"""

from __future__ import annotations

import numpy as np

COLUMNS = ("x", "y", "z", "natoms", "temp", "md_temp", "U", "xi", "source",
           "dens", "vx", "vy", "vz", "fd_k", "fd_g", "Z", "proc", "Ce")


def write_ttm(path: str, grid) -> None:
    """Write a 1-D TTMGrid (tensors on any device) in the reference's
    layout, one host transfer per field."""
    def host(name):
        return getattr(grid, name).detach().cpu().numpy()

    vcom = host("vcom")
    natoms = host("natoms").astype(np.int64)
    cols = {"temp": host("temp"), "md_temp": host("md_temp"), "U": host("U"),
            "xi": host("xi"), "source": host("source"), "dens": host("dens"),
            "vx": vcom[:, 0], "vy": vcom[:, 1], "vz": vcom[:, 2],
            "fd_k": host("fd_k"), "fd_g": host("fd_g"), "Z": host("Z"),
            "Ce": host("Ce")}
    with open(path, "w") as f:
        f.write("#" + " ".join(COLUMNS) + "\n")
        for i in range(len(natoms)):
            vals = [str(i), "0", "0", str(int(natoms[i]))]
            for name in COLUMNS[4:]:
                vals.append("0" if name == "proc"
                            else "%e" % float(cols[name][i]))
            f.write(" ".join(vals) + "\n")
