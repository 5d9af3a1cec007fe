"""Potentials for the fused hot loop (port of imd_tpu/models/potential.py).

What the slice needs: the tabulated ``PotTable`` with the reference's
3-point interpolation (host NumPy, used only to fit), the IMD table files
(``read_pot_table`` for formats 1 and 2, ``read_eam`` with the alloy
column transpose, ``write_pot_table``), ``analytic_eam``, ``tile_columns``
(type-pair column sets made from one column), and the single-window
monomial-Horner ``PolyPotential`` that the kernels evaluate, fitted per
column by ``to_fastpoly`` in NumPy float64.
Only the reference's default 3-point interpolation is ported
(``with_interpolation``); the 4-point and spline modes raise
NotImplementedError.

Precision mirrors the JAX package exactly: tables and the PolyPotential's
``coef``/``begin``/``end`` are stored rounded to their dtype (float32 by
default, as ``to_fastpoly`` does), the 3-point differences are taken in the
table dtype, and the kernels bake the float64 ``host`` tuples.
"""

from __future__ import annotations

import dataclasses
import io
from typing import Sequence

import numpy as np
import torch

from imd_tpu_torch.ops.geometry import np_dtype

POT_TAIL = 0.05  # fraction of r2_cut smoothed to zero (reference config.h:124)


@dataclasses.dataclass(eq=False)
class PotTable:
    """An equidistantly sampled function table (usually of r^2), host-side.

    ``table`` [ncols, maxsteps+2] (two quadratic continuation samples per
    column); per-column ``begin``/``end``/``step``/``invstep``/``length``.
    """
    table: np.ndarray
    begin: np.ndarray
    end: np.ndarray
    step: np.ndarray
    invstep: np.ndarray
    length: np.ndarray

    @property
    def ncols(self) -> int:
        return self.table.shape[0]

    @property
    def max_end(self) -> float:
        return float(np.max(self.end))

    def interp(self, col: int, x):
        """Quadratic interpolation of column ``col`` at NumPy ``x``;
        returns (value, 2*d/dx) like PAIR_INT2 (potaccess.h:323)."""
        x = np.asarray(x)
        begin = self.begin[col]
        invstep = self.invstep[col]
        is_short = x < begin
        xa = np.minimum(x, self.end[col]) - begin
        xa = np.maximum(xa, 0.0) * invstep
        k = np.floor(xa).astype(np.int32)
        k = np.minimum(k, self.table.shape[1] - 3)
        chi = xa - k
        tab = self.table[col]
        p0, p1, p2 = tab[k], tab[k + 1], tab[k + 2]
        dv = p1 - p0
        d2v = p2 - 2.0 * p1 + p0
        val = p0 + chi * dv + 0.5 * chi * (chi - 1.0) * d2v
        grad = 2.0 * invstep * (dv + (chi - 0.5) * d2v)
        return val, np.where(is_short, np.zeros_like(grad), grad)


@dataclasses.dataclass(eq=False)
class EAMPotential:
    """EAM2 set: pair phi(r^2), transfer rho(r^2), embedding F(rho).

    Column layout for ``ntypes`` species (imd_tpu's EAMPotential):

    - ``pair``: [ntypes^2] columns, col = t_i*ntypes + t_j (as the
      reference's files);
    - ``rho``: [ntypes^2] columns in the ENGINE convention, col =
      s*ntypes + h: the density a source atom of type s contributes at a
      host atom of type h.  This is the transpose of the reference's file
      layout (col = host*ntypes + source, imd_forces_nbl.c:468/551);
      ``read_eam`` transposes on load, so every engine indexes
      col = t_j*ntypes + t_i for the density at i from j;
    - ``embed``: [ntypes] columns (not radial).
    """
    pair: object
    rho: object
    embed: object

    @property
    def cutoff2(self) -> float:
        return max(self.pair.max_end, self.rho.max_end)

    def at_host_precision(self) -> "EAMPotential":
        """A fastpoly set evaluated at the float64 fit the kernels bake."""
        return EAMPotential(pair=self.pair.at_host_precision(),
                            rho=self.rho.at_host_precision(),
                            embed=self.embed.at_host_precision())


def _with_continuation(cols: Sequence[np.ndarray]) -> np.ndarray:
    """Pad columns to a common length + 2 continuation samples."""
    maxlen = max(len(c) for c in cols)
    out = np.zeros((len(cols), maxlen + 2), dtype=np.float64)
    for i, c in enumerate(cols):
        n = len(c)
        out[i, :n] = c
        if n >= 3:
            out[i, n] = 3 * c[n - 1] - 3 * c[n - 2] + c[n - 3]
            out[i, n + 1] = 6 * c[n - 1] - 8 * c[n - 2] + 3 * c[n - 3]
    return out


def _make_table(cols, begin, end, step, dtype=np.float32) -> PotTable:
    dt = np_dtype(dtype)
    step = np.asarray(step, np.float64)
    return PotTable(
        table=_with_continuation(cols).astype(dt),
        begin=np.asarray(begin, np.float64).astype(dt),
        end=np.asarray(end, np.float64).astype(dt),
        step=step.astype(dt),
        invstep=(1.0 / np.where(step == 0, 1.0, step)).astype(dt),
        length=np.asarray([len(c) for c in cols], np.int32))


def with_interpolation(pt: PotTable, mode: str, radial: bool = True):
    """The table in interpolation ``mode`` (``pot_interp``): only the
    reference's default '3point' is ported."""
    if mode in ("3point", "", None):
        return pt
    if mode in ("4point", "spline"):
        raise NotImplementedError(
            f"pot_interp {mode} is not ported (only 3point)")
    raise ValueError(f"unknown interpolation mode {mode!r} "
                     "(3point | 4point | spline)")


def read_pot_table(path: str, ncols: int, radial: bool = True,
                   dtype=np.float32) -> PotTable:
    """Read an IMD potential table (format 1 or 2, from the #F header)."""
    with open(path) as f:
        lines = f.read().splitlines()
    fmt = 1
    body_start = 0
    have_header = False
    for i, line in enumerate(lines):
        if line.startswith("#"):
            have_header = True
            if len(line) > 1 and line[1] == "F":
                parts = line[2:].split()
                fmt = int(parts[0])
                if int(parts[1]) != ncols:
                    raise ValueError(f"potential table has {parts[1]} "
                                     f"columns, expected {ncols}")
            if len(line) > 1 and line[1] == "E":
                body_start = i + 1
                break
        elif have_header:
            raise ValueError("corrupted potential file header")
        else:
            break
    body = "\n".join(lines[body_start:])
    if fmt == 1:
        return _read_format1(body, ncols, radial, dtype)
    if fmt == 2:
        return _read_format2(body, ncols, dtype)
    raise ValueError(f"unknown potential format {fmt}")


def _read_format1(body: str, ncols: int, radial: bool, dtype) -> PotTable:
    """r^2 column + ncols value columns; a radial column is shifted so its
    last sample is zero."""
    data = np.atleast_2d(np.loadtxt(io.StringIO(body)))
    if data.shape[1] != ncols + 1:
        raise ValueError(f"format-1 table rows have {data.shape[1]} values,"
                         f" expected {ncols + 1}")
    r2 = data[:, 0]
    npot = len(r2)
    r2_step = (r2[-1] - r2[0]) / (npot - 1)
    cols, end = [], []
    for i in range(ncols):
        col = data[:, i + 1].copy()
        nz = np.nonzero(col)[0]
        n = int(nz[-1]) + 1 if len(nz) else 0
        end.append(r2[n - 1] if n else 0.0)
        if radial and n and col[npot - 1] != 0.0:
            col[:npot] -= col[npot - 1]
        cols.append(col)
    return _make_table(cols, [r2[0]] * ncols, end, [r2_step] * ncols, dtype)


def _read_format2(body: str, ncols: int, dtype) -> PotTable:
    """ncols (begin, end, step) triples, then each column's samples."""
    vals = [float(t) for t in body.split()]
    begin, end, step, length = [], [], [], []
    pos = 0
    for _ in range(ncols):
        b, e, s = vals[pos:pos + 3]
        pos += 3
        begin.append(b)
        end.append(e)
        step.append(s)
        length.append(int(1 + (e - b) / s + 0.49))
    cols = []
    for i in range(ncols):
        cols.append(np.asarray(vals[pos:pos + length[i]], np.float64))
        pos += length[i]
    return _make_table(cols, begin, end, step, dtype)


def write_pot_table(pt: PotTable, path: str):
    """Write a table in IMD format 2 (readable by the reference)."""
    table = np.asarray(pt.table, np.float64)
    with open(path, "w") as f:
        f.write(f"#F 2 {pt.ncols}\n#E\n")
        for i in range(pt.ncols):
            f.write(f"{float(pt.begin[i]):.16e} {float(pt.end[i]):.16e} "
                    f"{float(pt.step[i]):.16e}\n")
        for i in range(pt.ncols):
            for v in table[i, :pt.length[i]]:
                f.write(f"{v:.16e}\n")
            f.write("\n")


def _take_columns(tab: PotTable, cols) -> PotTable:
    cols = np.asarray(cols)
    return PotTable(table=tab.table[cols], begin=tab.begin[cols],
                    end=tab.end[cols], step=tab.step[cols],
                    invstep=tab.invstep[cols], length=tab.length[cols])


def transpose_pair_columns(tab: PotTable, ntypes: int) -> PotTable:
    """Reorder [ntypes^2] type-pair columns by (i,j) -> (j,i): the
    reference's host-first rho layout (col = host*ntypes + source) into
    the engine's source-first one.  No-op for ntypes == 1."""
    if ntypes <= 1:
        return tab
    return _take_columns(
        tab, np.arange(ntypes * ntypes).reshape(ntypes, ntypes).T.ravel())


def tile_columns(tab: PotTable, scales) -> PotTable:
    """``len(scales)`` copies of a one-column table, copy k scaled by
    ``scales[k]`` (in the table's dtype): type-pair column sets with the
    physics of one species (all scales 1, as bench.py --ntypes tiles
    them) or with genuinely different columns."""
    if tab.ncols != 1:
        raise ValueError(f"tile_columns takes a one-column table, got "
                         f"{tab.ncols} columns")
    out = _take_columns(tab, np.zeros(len(scales), np.int64))
    scale = np.asarray(scales, np.float64).astype(tab.table.dtype)
    return dataclasses.replace(out, table=out.table * scale[:, None])


def read_eam(core_potential_file: str, embedding_energy_file: str,
             el_density_file: str, ntypes: int,
             dtype=np.float32) -> EAMPotential:
    """The reference's three EAM2 tables (setup_potentials,
    imd_potential.c:43).  The el_density_file's columns are host-first
    (col = it*ntypes + jt: the density at a host of type it from a source
    of type jt); they are transposed here into the engine's source-first
    layout (see EAMPotential)."""
    nc = ntypes * ntypes
    return EAMPotential(
        pair=read_pot_table(core_potential_file, nc, True, dtype),
        rho=transpose_pair_columns(
            read_pot_table(el_density_file, nc, True, dtype), ntypes),
        embed=read_pot_table(embedding_energy_file, ntypes, False, dtype))


def _smoothed_samples(fn, dfn_dr2, r2: np.ndarray, r2_cut: float):
    """Sample fn(r2) with the reference's quadratic smoothing tail
    (imd_potential.c:858-863)."""
    x0 = (1.0 - POT_TAIL) * r2_cut
    dv0 = dfn_dr2(x0)
    A = -dv0 / (2.0 * POT_TAIL * r2_cut)
    shift = fn(x0) - A * (r2_cut - x0) ** 2
    inner = fn(r2) - shift
    tail = A * np.maximum(r2_cut - r2, 0.0) ** 2
    return np.where(r2 < x0, inner, np.where(r2 <= r2_cut, tail, 0.0))


def analytic_eam(r_cut: float = 5.0, r0: float = 2.86, E_c: float = 3.39,
                 beta: float = 6.0, A: float = 0.25, alpha: float = 2.0,
                 rho_scale: float = 1.0, res: int = 2000,
                 dtype=np.float32) -> EAMPotential:
    """Johnson-style analytic single-species EAM, tabulated (twin of
    imd_tpu.models.potential.analytic_eam)."""
    r2b, r2c = (0.5 * r0) ** 2, r_cut * r_cut
    r2 = np.linspace(r2b, r2c, res)

    def pair(x):
        r = np.sqrt(x)
        ex = np.exp(-alpha * (r - r0))
        return A * E_c * ((1.0 - ex) ** 2 - 1.0)

    def dpair(x):
        r = np.sqrt(x)
        ex = np.exp(-alpha * (r - r0))
        return A * E_c * alpha * ex * (1.0 - ex) / r

    def rho_f(x):
        r = np.sqrt(x)
        return rho_scale * np.exp(-beta * (r / r0 - 1.0))

    def drho(x):
        r = np.sqrt(x)
        return -0.5 * rho_scale * beta / (r0 * r) * np.exp(
            -beta * (r / r0 - 1.0))

    step = [(r2c - r2b) / (res - 1)]
    pair_tab = _make_table([_smoothed_samples(pair, dpair, r2, r2c)],
                           [r2b], [r2c], step, dtype)
    rho_tab = _make_table([_smoothed_samples(rho_f, drho, r2, r2c)],
                          [r2b], [r2c], step, dtype)
    rho_ref = 12.0 * rho_scale
    rho_max = 4.0 * rho_ref
    rr = np.linspace(0.0, rho_max, res)
    embed_col = -E_c * np.sqrt(np.maximum(rr, 0.0) / rho_ref)
    embed_tab = _make_table([embed_col], [0.0], [rho_max],
                            [rho_max / (res - 1)], dtype)
    return EAMPotential(pair=pair_tab, rho=rho_tab, embed=embed_tab)


@dataclasses.dataclass(eq=False)
class PolyPotential:
    """Single-window monomial-Horner potential.

    Fit window [begin, end] in the r^2 abscissa; ``interp`` continues
    linearly below the window and clamps above.  ``coef``/``begin``/``end``
    are stored rounded to their dtype; ``host`` holds the float64 fit,
    (((coef...), begin, end), ...) per column, which the kernels bake.
    """
    coef: np.ndarray      # [ncols, deg+1] monomial coeffs in t in [-1,1]
    begin: np.ndarray     # [ncols]
    end: np.ndarray       # [ncols]
    max_err: tuple
    host: tuple

    @property
    def max_end(self) -> float:
        return float(np.max(self.end))

    def at_host_precision(self) -> "PolyPotential":
        """This fit with coef/begin/end at the float64 ``host`` values
        (the stored ones are rounded to their dtype)."""
        return dataclasses.replace(
            self, coef=np.array([c for c, _, _ in self.host]),
            begin=np.array([b for _, b, _ in self.host]),
            end=np.array([e for _, _, e in self.host]))

    def interp(self, col: int, x: torch.Tensor):
        """(value, 2*dV/dx) of column ``col`` at tensor ``x``."""
        b, e = self.begin[col], self.end[col]
        inv_half = float(2.0 / (e - b))      # in the stored dtype
        b, e = float(b), float(e)
        t = (torch.clamp(x, b, e) - b) * inv_half - 1.0
        cf = [float(v) for v in self.coef[col]]
        v = torch.full_like(t, cf[-1])
        g = torch.zeros_like(t)
        for k in range(len(cf) - 2, -1, -1):
            g = g * t + v
            v = v * t + cf[k]
        dv_dx = g * inv_half
        v = torch.where(x < b, v + dv_dx * (x - b), v)
        return v, 2.0 * dv_dx


def to_fastpoly(pt: PotTable, deg: int = 12, vcap: float = 50.0,
                dtype=np.float32) -> PolyPotential:
    """Fit a PolyPotential to a PotTable's columns (host, NumPy float64).

    The window starts where |V| first drops below ``vcap``, ends at the
    table end."""
    import numpy.polynomial.chebyshev as cheb

    dt = np_dtype(dtype)
    coefs, begins, ends, errs = [], [], [], []
    for c in range(pt.ncols):
        b = float(pt.begin[c])
        e = float(pt.end[c])
        xs = np.linspace(b, e, 8001)
        ref = np.asarray(pt.interp(c, xs)[0], np.float64)
        ok = np.abs(ref) <= vcap
        b_fit = xs[np.argmax(ok)] if ok.any() else b
        xs = np.linspace(b_fit, e, 4001)
        ref = np.asarray(pt.interp(c, xs)[0], np.float64)
        t = (xs - b_fit) / (e - b_fit) * 2.0 - 1.0
        cf = cheb.cheb2poly(cheb.chebfit(t, ref, deg))
        fit = np.polyval(cf[::-1], t)
        errs.append(float(np.max(np.abs(fit - ref)
                                 / np.maximum(np.abs(ref), 1.0))))
        coefs.append(cf)
        begins.append(b_fit)
        ends.append(e)
    host = tuple((tuple(float(v) for v in cf), float(b2), float(e2))
                 for cf, b2, e2 in zip(coefs, begins, ends))
    return PolyPotential(coef=np.stack(coefs).astype(dt),
                         begin=np.asarray(begins).astype(dt),
                         end=np.asarray(ends).astype(dt),
                         max_err=tuple(errs), host=host)


def eam_to_fastpoly(eam: EAMPotential, deg: int = 12) -> EAMPotential:
    """EAM set with all three tables in fast-Horner form."""
    return EAMPotential(pair=to_fastpoly(eam.pair, deg),
                        rho=to_fastpoly(eam.rho, deg),
                        embed=to_fastpoly(eam.embed, deg, vcap=1e9))
