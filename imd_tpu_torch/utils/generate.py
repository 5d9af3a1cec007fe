"""Copy of imd_tpu/utils/generate.py (the quasicrystal branch raises
NotImplementedError), so the port never imports the JAX package.

Internal lattice generators (imd_generate.c, imd_qc.c).

The reference generates start configurations when ``coordname`` starts with
an underscore: `_fcc`, `_nacl`, `_hex`, `_bcc` (via cubic generators), etc.
(generate_atoms, imd_generate.c:51).  Positions are produced host-side as
NumPy arrays; callers bin them into a Scene.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def fcc(box_param: Tuple[int, int, int], alat: float,
        ntypes: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """FCC lattice: box_param cubic unit cells of lattice constant alat.

    Returns (pos [N,3], type [N], box_diag [3]).  For ntypes == 2 the two
    sublattices alternate as in the reference's NaCl option
    (generate_fcc, imd_generate.c:370).
    """
    nx, ny, nz = box_param
    basis = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                      [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                 indexing="ij"), axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * alat
    n = pos.shape[0]
    if ntypes >= 2:
        # alternate types on the two interpenetrating sc sublattices (NaCl)
        s = (cells[:, None, 0] * 0 + np.arange(4)[None, :]) % 2
        typ = s.reshape(-1).astype(np.int32)
    else:
        typ = np.zeros(n, np.int32)
    box = np.array([nx, ny, nz], np.float64) * alat
    return pos, typ, box


def bcc(box_param: Tuple[int, int, int], alat: float
        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    nx, ny, nz = box_param
    basis = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    cells = np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                                 indexing="ij"), axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * alat
    typ = np.zeros(pos.shape[0], np.int32)
    box = np.array([nx, ny, nz], np.float64) * alat
    return pos, typ, box


def _cells(box_param):
    nx, ny, nz = box_param
    return np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                np.arange(nz), indexing="ij"),
                    axis=-1).reshape(-1, 3)


def _from_basis(box_param, alat, basis, types):
    cells = _cells(box_param)
    basis = np.asarray(basis, np.float64)
    pos = (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3) * alat
    typ = np.tile(np.asarray(types, np.int32), len(cells))
    box = np.array(box_param, np.float64) * alat
    return pos, typ, box


def b2(box_param, alat):
    """B2 (CsCl) structure: bcc with alternating types
    (init_cubic/generate_lav family, imd_generate.c)."""
    return _from_basis(box_param, alat,
                       [[0, 0, 0], [0.5, 0.5, 0.5]], [0, 1])


def l12(box_param, alat):
    """L1_2 (Cu3Au): fcc with corner type 1, faces type 0."""
    return _from_basis(box_param, alat,
                       [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                        [0, 0.5, 0.5]], [1, 0, 0, 0])


def nacl(box_param, alat):
    """NaCl: two interpenetrating fcc lattices."""
    basis = [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5],
             [0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5], [0.5, 0.5, 0.5]]
    return _from_basis(box_param, alat, basis, [0, 0, 0, 0, 1, 1, 1, 1])


def sio2(box_param, alat=1.0):
    """Alpha-quartz SiO2 (generate_SiO2, imd_generate.c:714-790): the
    18-atom orthorhombic cell (4.9134 x 8.51026 x 5.4052 A), types
    0 = Si (6), 1 = O (12).  ``alat`` scales the cell uniformly."""
    cell_sz = np.asarray([4.9134, 8.51025844, 5.4052]) * alat
    typ18 = np.asarray([0] * 6 + [1] * 12, np.int32)
    basis = np.asarray([
        [0.677893, 5.145130, 0.900000], [3.134590, 0.890000, 0.900000],
        [1.684400, 2.889490, 2.701730], [4.141100, 7.144610, 2.701730],
        [1.684400, 7.400770, 4.503470], [4.141100, 3.145640, 4.503470],
        [4.067400, 8.259460, 1.541777], [1.610700, 4.004330, 1.541777],
        [2.205960, 1.511250, 2.059960], [4.662660, 5.766380, 2.059960],
        [0.230040, 2.652050, 3.343510], [2.686740, 6.907180, 3.343510],
        [2.686740, 3.383080, 3.861690], [0.230040, 7.638210, 3.861690],
        [2.205960, 0.268752, 5.145240], [4.662660, 4.523880, 5.145240],
        [1.610700, 6.285930, 0.258220], [4.067400, 2.030800, 0.258220],
    ]) * alat
    nx, ny, nz = (box_param if hasattr(box_param, "__len__")
                  else (box_param,) * 3)
    cells = np.stack(np.meshgrid(np.arange(nx), np.arange(ny),
                                 np.arange(nz), indexing="ij"),
                     axis=-1).reshape(-1, 3)
    pos = (cells[:, None, :] * cell_sz + basis[None, :, :]).reshape(-1, 3)
    typ = np.tile(typ18, len(cells))
    box_diag = np.asarray([nx, ny, nz]) * cell_sz
    return pos, typ, box_diag


def diamond(box_param, alat):
    """Diamond cubic (plus the sio2 quartz generator for the silica
    models; diamond serves the covalent potentials)."""
    basis = [[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5],
             [0.25, 0.25, 0.25], [0.75, 0.75, 0.25],
             [0.75, 0.25, 0.75], [0.25, 0.75, 0.75]]
    return _from_basis(box_param, alat, basis, [0] * 8)


def hex_lattice(box_param, alat):
    """Hexagonal close-packed layers (generate_hex analog) in an
    orthorhombic cell: a, a*sqrt(3), c = a*sqrt(8/3)."""
    nx, ny, nz = box_param
    a = alat
    b = alat * np.sqrt(3.0)
    c = alat * np.sqrt(8.0 / 3.0)
    basis = np.array([[0, 0, 0], [0.5, 0.5, 0],
                      [0.5, 5.0 / 6.0, 0.5], [0.0, 1.0 / 3.0, 0.5]])
    cells = _cells(box_param).astype(np.float64)
    pos = (cells[:, None, :] + basis[None, :, :]).reshape(-1, 3)
    pos *= np.array([a, b, c])
    typ = np.zeros(pos.shape[0], np.int32)
    box = np.array([nx * a, ny * b, nz * c])
    return pos, typ, box


def laves(box_param, alat):
    """C15 (MgCu2) cubic Laves phase (generate_lav, imd_generate.c)."""
    mg = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0.5, 0.5, 0],
                   [0.75, 0.75, 0.25], [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                   [0, 0.5, 0.5], [0.25, 0.75, 0.75]])
    cu0 = np.array([[5, 5, 5], [5, 7, 7], [7, 5, 7], [7, 7, 5]]) / 8.0
    cu = np.concatenate([cu0 + s for s in
                         ([0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                          [0, 0.5, 0.5])]) % 1.0
    basis = np.concatenate([mg, cu])
    types = [0] * len(mg) + [1] * len(cu)
    return _from_basis(box_param, alat, basis, types)


def generate_atoms(coordname: str, box_param, box_unit: float, ntypes: int = 1):
    """Dispatch on the reference's `_name` convention (imd_generate.c:51)."""
    name = coordname.lstrip("_").lower()
    if name == "fcc":
        return fcc(box_param, box_unit, 1)
    if name == "nacl":
        return nacl(box_param, box_unit)
    if name == "bcc":
        return bcc(box_param, box_unit)
    if name in ("cscl", "b2"):
        return b2(box_param, box_unit)
    if name in ("l12", "cu3au"):
        return l12(box_param, box_unit)
    if name in ("hex", "hcp"):
        return hex_lattice(box_param, box_unit)
    if name in ("lav", "laves"):
        return laves(box_param, box_unit)
    if name in ("diamond", "dia"):
        return diamond(box_param, box_unit)
    if name == "sio2":
        return sio2(box_param, box_unit)
    if name in ("qc", "quasi"):
        raise NotImplementedError(
            "the quasicrystal generator (imd_tpu/utils/qc.py) is not ported")
    raise ValueError(f"unknown internal lattice '{coordname}'")
