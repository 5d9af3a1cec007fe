"""2-D projection pictures (port of imd_tpu/io/pictures.py;
imd_pictures_3d.c): ``write_picture`` bins atoms onto an (nx, ny) screen
along a projection axis and writes an ASCII matrix or a PPM image with a
black-red-yellow-white map."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from imd_tpu_torch.io.distrib import compute_distrib


def project(scene, dims: Tuple[int, int] = (256, 256), axis: int = 2,
            field: str = "Ekin"):
    """[nx, ny] projected field sum and counts."""
    d3 = [1, 1, 1]
    keep = [a for a in range(3) if a != axis]
    d3[keep[0]], d3[keep[1]] = dims
    fields = compute_distrib(scene, tuple(d3))
    return fields[field].sum(axis=axis), fields["num"].sum(axis=axis)


def write_picture(path: str, scene, dims=(256, 256), axis: int = 2,
                  field: str = "Ekin", fmt: str = "ppm"):
    f, _ = project(scene, dims, axis, field)
    if fmt == "ascii":
        with open(path, "w") as out:
            out.write(f"# pic {field} {dims[0]} {dims[1]} axis={axis}\n")
            np.savetxt(out, f, fmt="%.6e")
        return
    v = np.sqrt(np.clip(f / max(f.max(), 1e-30), 0, 1))
    r = np.clip(3 * v, 0, 1)
    g = np.clip(3 * v - 1, 0, 1)
    b = np.clip(3 * v - 2, 0, 1)
    img = (np.stack([r, g, b], -1) * 255).astype(np.uint8)
    with open(path, "wb") as out:
        out.write(f"P6\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        out.write(img.tobytes())
