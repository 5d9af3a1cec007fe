"""DYNAMO/LAMMPS EAM parameter files: setfl (eam.alloy / eam.fs), funcfl
(NumPy port of imd_tpu/models/setfl.py:52-257).

Why here: the reference's OpenKIM bridge (imd_forces_kim.c) exists
largely to run published EAM parameterizations; the bulk of the KIM
``EAM_Dynamo_*`` model family is literally a DYNAMO setfl file plus
glue.  Parsing the file natively lets those parameterizations run on the
port's engines directly, with no KIM library.

Formats (all r-sampled, converted here to the framework's r²-sampled
``PotTable`` layout, potaccess.h analog):

setfl / eam.alloy::

    3 comment lines
    Nelem  El1 El2 ...
    nrho  drho  nr  dr  cutoff
    per element: (Z mass alat lattice) ; F(rho) nrho values ;
                 rho(r) nr values
    per pair (i from 0..Nelem-1, j from 0..i): r*phi_ij(r) nr values

eam.fs: like setfl but element block i carries Nelem rho arrays —
sub-array j is the density SOURCE element i contributes at a type-j
HOST (LAMMPS pair_eam_fs orientation: rho at itype from jtype reads
the file's block jtype, sub-array itype).

funcfl (single element)::

    1 comment line
    Z mass alat lattice
    nrho drho nr dr cutoff
    F(rho) ; Z(r) ; rho(r)
    with phi(r) = hartree * bohr * Z(r)^2 / r  (27.2 * 0.529 eV*A)

The embedding table is copied verbatim (already equidistant in rho);
the radial arrays are resampled onto an equidistant r² grid by cubic
(Catmull-Rom) interpolation of the dense source samples.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from imd_tpu_torch.models.potential import EAMPotential, _make_table

HARTREE_BOHR = 27.2 * 0.529   # funcfl Z(r) -> eV*A pair prefactor


def _tokens(text: str, skip: int):
    lines = text.splitlines()
    head = lines[:skip]
    toks = " ".join(lines[skip:]).split()
    return head, toks


def _catmull_rom(xs, ys, x):
    """Cubic interpolation of equidistant samples (dense source grids)."""
    n = len(ys)
    dx = xs[1] - xs[0]
    t = np.clip((x - xs[0]) / dx, 0.0, n - 1.0)
    k = np.clip(np.floor(t).astype(int), 0, n - 2)
    f = t - k
    ym = ys[np.maximum(k - 1, 0)]
    y0 = ys[k]
    y1 = ys[k + 1]
    y2 = ys[np.minimum(k + 2, n - 1)]
    return (y0
            + 0.5 * f * (y1 - ym
                         + f * (2 * ym - 5 * y0 + 4 * y1 - y2
                                + f * (3 * (y0 - y1) + y2 - ym))))


def _radial_to_r2(rs, vals, r2_begin, r2_end, nsteps):
    """Resample a radial table onto nsteps equidistant r² samples."""
    step = (r2_end - r2_begin) / (nsteps - 1)
    r2 = r2_begin + step * np.arange(nsteps)
    out = _catmull_rom(rs, vals, np.sqrt(r2))
    return out, step


def read_setfl(path_or_text: str, dtype=np.float32,
               nsteps: int = 2000) -> Tuple[EAMPotential, dict]:
    """Parse a setfl / eam.alloy / eam.fs text into an EAMPotential.

    Returns (eam, meta) with meta = {elements, masses, nelem, cutoff,
    lattice, alat}.  Column layout is the ENGINE convention (see the
    EAMPotential docstring): pair col i*nt+j = phi_ij (symmetric); rho
    col s*nt+h = density a SOURCE atom of type s contributes at a host
    of type h (for eam.alloy that column depends on s only; eam.fs
    carries all nt² functions).  embed has [ntypes] columns.

    ``path_or_text`` is treated as literal file text only when it
    contains a newline; otherwise it must be a readable path (open()
    errors propagate).
    """
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    _, toks = _tokens(text, 3)
    pos = 0

    def take(n):
        nonlocal pos
        out = toks[pos:pos + n]
        pos += n
        return out

    nelem = int(take(1)[0])
    elements = take(nelem)
    nrho, drho, nr, dr, cutoff = take(5)
    nrho, nr = int(nrho), int(nr)
    drho, dr, cutoff = float(drho), float(dr), float(cutoff)
    rs = dr * np.arange(nr)

    # eam.fs carries nelem rho arrays per element block; detect by
    # token count: setfl total = nelem*(4+nrho+nr) + npair*nr,
    # fs total = nelem*(4+nrho+nelem*nr) + npair*nr
    npair = nelem * (nelem + 1) // 2
    remaining = len(toks) - pos
    n_setfl = nelem * (4 + nrho + nr) + npair * nr
    n_fs = nelem * (4 + nrho + nelem * nr) + npair * nr
    if remaining == n_setfl or nelem == 1:
        is_fs = False
    elif remaining == n_fs:
        is_fs = True
    else:
        raise ValueError(
            f"setfl body has {remaining} numbers; expected {n_setfl} "
            f"(eam.alloy) or {n_fs} (eam.fs) for nelem={nelem}, "
            f"nrho={nrho}, nr={nr}")

    masses, alats, lattices = [], [], []
    embed_cols = []
    rho_raw = {}           # (host i, source j) -> rho samples
    for i in range(nelem):
        _z, mass, alat, lat = take(4)
        masses.append(float(mass))
        alats.append(float(alat))
        lattices.append(lat)
        embed_cols.append(np.array(take(nrho), np.float64))
        if is_fs:
            # fs block for element i: nelem arrays, sub-array j = density
            # element i (source) contributes at a type-j host (the
            # LAMMPS pair_eam_fs type2rhor[jtype][itype] orientation)
            for j in range(nelem):
                rho_raw[(i, j)] = np.array(take(nr), np.float64)
        else:
            # eam.alloy: one rho per element = the density that element
            # CONTRIBUTES, independent of the host -> same column for
            # every host type (source-first key (i, host))
            col = np.array(take(nr), np.float64)
            for i2 in range(nelem):
                rho_raw[(i, i2)] = col      # host-independent source rho
    rphi = {}
    for i in range(nelem):
        for j in range(i + 1):
            col = np.array(take(nr), np.float64)
            rphi[(i, j)] = col
            rphi[(j, i)] = col
    if pos > len(toks):
        raise ValueError("setfl file truncated: "
                         f"needed {pos} numbers, found {len(toks)}")

    # radial begin: skip the r=0 sample (r*phi/r undefined there)
    r_begin = max(dr, 1e-3)
    r2_begin, r2_end = r_begin * r_begin, cutoff * cutoff
    nt = nelem
    pair_cols, rho_cols = [], []
    pair_step = rho_step = None
    for i in range(nt):
        for j in range(nt):
            rv, pair_step = _radial_to_r2(rs, rphi[(i, j)],
                                          r2_begin, r2_end, nsteps)
            with np.errstate(divide="ignore", invalid="ignore"):
                phi = rv / np.sqrt(r2_begin + pair_step
                                   * np.arange(nsteps))
            pair_cols.append(phi)
            rho_cols.append(_radial_to_r2(rs, rho_raw[(i, j)],
                                          r2_begin, r2_end, nsteps)[0])
    rho_step = pair_step
    pair = _make_table(pair_cols, [r2_begin] * nt * nt,
                       [r2_end] * nt * nt, [pair_step] * nt * nt, dtype)
    rho = _make_table(rho_cols, [r2_begin] * nt * nt,
                      [r2_end] * nt * nt, [rho_step] * nt * nt, dtype)
    embed = _make_table(embed_cols, [0.0] * nt,
                        [drho * (nrho - 1)] * nt, [drho] * nt, dtype)
    meta = {"elements": elements, "masses": masses, "nelem": nelem,
            "cutoff": cutoff, "alat": alats, "lattice": lattices,
            "fs": is_fs}
    return EAMPotential(pair=pair, rho=rho, embed=embed), meta


def read_funcfl(path_or_text: str, dtype=np.float32,
                nsteps: int = 2000) -> Tuple[EAMPotential, dict]:
    """Parse a single-element DYNAMO funcfl file (eam.fd style)."""
    if "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    _, toks = _tokens(text, 1)
    pos = 0

    def take(n):
        nonlocal pos
        out = toks[pos:pos + n]
        pos += n
        return out

    _z, mass, alat, lat = take(4)
    nrho, drho, nr, dr, cutoff = take(5)
    nrho, nr = int(nrho), int(nr)
    drho, dr, cutoff = float(drho), float(dr), float(cutoff)
    embed_col = np.array(take(nrho), np.float64)
    zr = np.array(take(nr), np.float64)
    rho_r = np.array(take(nr), np.float64)
    if len(embed_col) != nrho or len(zr) != nr or len(rho_r) != nr \
            or pos != len(toks):
        raise ValueError(
            f"funcfl body has {len(toks) - 9} numbers; expected "
            f"{nrho + 2 * nr} for nrho={nrho}, nr={nr}")
    rs = dr * np.arange(nr)

    r_begin = max(dr, 1e-3)
    r2_begin, r2_end = r_begin * r_begin, cutoff * cutoff
    z2, step = _radial_to_r2(rs, zr, r2_begin, r2_end, nsteps)
    r_samples = np.sqrt(r2_begin + step * np.arange(nsteps))
    phi = HARTREE_BOHR * z2 * z2 / r_samples
    rho_col, _ = _radial_to_r2(rs, rho_r, r2_begin, r2_end, nsteps)
    pair = _make_table([phi], [r2_begin], [r2_end], [step], dtype)
    rho = _make_table([rho_col], [r2_begin], [r2_end], [step], dtype)
    embed = _make_table([embed_col], [0.0], [drho * (nrho - 1)],
                        [drho], dtype)
    meta = {"elements": ["X"], "masses": [float(mass)], "nelem": 1,
            "cutoff": cutoff, "alat": [float(alat)], "lattice": [lat],
            "fs": False}
    return EAMPotential(pair=pair, rho=rho, embed=embed), meta


SETFL_SUFFIXES = (".setfl", ".eam.alloy", ".alloy", ".eam.fs", ".fs")
FUNCFL_SUFFIXES = (".funcfl", ".eam.fd", ".fd")


def maybe_read_dynamo(path: str, dtype=np.float32):
    """Return (eam, meta) when ``path`` names a DYNAMO-format file by
    suffix, else None (caller falls through to the IMD table readers)."""
    low = path.lower()
    if low.endswith(SETFL_SUFFIXES):
        return read_setfl(path, dtype)
    if low.endswith(FUNCFL_SUFFIXES):
        return read_funcfl(path, dtype)
    return None
