"""Stencil offsets, the Scene-layout neighbour views, the stencil oracles
and the all-pairs EAM oracle (port of imd_tpu/ops/forces.py:34-84,
130-410, 615).

``eam_forces_n2`` is the port's own reference for the force kernels: plain
torch over all N^2 minimum-image pairs, no cells, no kernels.

The stencil oracles (``compute_pair_forces``, ``compute_eam_forces`` with
the per-atom stress, ``compute_nbanz``, ``compute_ordpar``) visit the own
cell and the 13 half-stencil offsets by rolling the Scene-layout arrays, as
imd_tpu's do; they serve the outputs at their I/O cadence (``.stress``,
``.nb`` and the ``n_nbr`` column, the ORDPAR Epot column), not the step.
Each offset's ``[gx, gy, gz, cap, cap]`` block is made and dropped in turn:
at 1M atoms one such block of 3-vectors takes 1-2 GB in float32.  Tables
are evaluated on the device (``pot_eval``): a PotTable by its quadratic
interpolation (potaccess.h PAIR_INT2), a fastpoly fit by its Horner.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from imd_tpu_torch.ops.geometry import Box

# 27-stencil offsets; HALF_OFFSETS = the 13 lexicographically positive ones
ALL_OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
               for k in (-1, 0, 1)]
HALF_OFFSETS = [o for o in ALL_OFFSETS if o > (0, 0, 0)]


def _neighbor_view(grid, arr: torch.Tensor, off) -> torch.Tensor:
    """Roll a Scene-layout [gx, gy, gz, ...] array so that cell c sees cell
    c+off's data at its own index (an axis of one cell is not rolled)."""
    shifts, axes = [], []
    for ax, o in enumerate(off):
        if o and arr.shape[ax] > 1:
            shifts.append(-o)
            axes.append(ax)
    return torch.roll(arr, shifts, axes) if axes else arr


def _wrap_shift_and_mask(grid, off, dtype, device):
    """For the +off neighbour of every cell: the Cartesian shift
    [gx, gy, gz, 1, 3] of a neighbour reached across a periodic face (its
    positions seen from the cell) and the validity [gx, gy, gz, 1] (False
    across an open face)."""
    valid = torch.ones(tuple(grid.dims), dtype=torch.bool, device=device)
    h = torch.as_tensor(np.asarray(grid.box.h), device=device).to(dtype)
    terms = []
    for ax, (g, o) in enumerate(zip(grid.dims, off)):
        wrap = torch.div(torch.arange(g, device=device) + o, g,
                         rounding_mode="floor")         # -1, 0 or +1
        shape = [1, 1, 1]
        shape[ax] = g
        wrap = wrap.reshape(shape)
        terms.append(wrap.to(dtype)[..., None] * h[ax])
        if not grid.box.pbc[ax]:
            valid = valid & (wrap == 0)
    shift = terms[0] + terms[1] + terms[2]              # [gx, gy, gz, 3]
    return shift[..., None, :], valid[..., None]


def min_image(box: Box, dr: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement vectors [..., 3]."""
    h = torch.as_tensor(box.h, device=dr.device).to(dr.dtype)
    inv_h = torch.as_tensor(box.inv_h, device=dr.device).to(dr.dtype)
    frac = dr @ inv_h
    period = torch.tensor(box.pbc, dtype=dr.dtype, device=dr.device)
    frac = frac - torch.round(frac) * period
    return frac @ h


def _interp_cols(tab, cols, x):
    """(value, 2 dV/dx) of ``tab`` with a column index per element:
    each column is evaluated on all of ``x`` and selected where it
    applies (``interp`` takes one column at a time)."""
    v = torch.zeros_like(x)
    g = torch.zeros_like(x)
    for c in torch.unique(cols).tolist():
        vc, gc = tab.interp(c, x)
        sel = cols == c
        v = torch.where(sel, vc, v)
        g = torch.where(sel, gc, g)
    return v, g


def eam_forces_n2(pos, mask, box: Box, eam, typ=None, ntypes: int = 1):
    """All-pairs EAM oracle.  pos [N,3], mask [N] bool, ``typ`` [N] integer
    types for ``ntypes`` > 1 (columns as in EAMPotential: pair
    t_i*ntypes + t_j, density at i from j t_j*ntypes + t_i).

    Returns (F [N,3], rho [N], nneigh [N]) over pairs within the EAM
    cutoff.  Potentials are evaluated with ``interp`` (the JAX oracle's
    convention, linear continuation below the fit window)."""
    N = pos.shape[0]
    dr = min_image(box, pos[:, None, :] - pos[None, :, :])
    r2 = (dr * dr).sum(-1)
    eye = torch.eye(N, dtype=torch.bool, device=pos.device)
    valid = (~eye) & mask[:, None] & mask[None, :] & (r2 < eam.cutoff2)
    r2c = torch.clamp(r2, min=1e-12)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    if ntypes == 1:
        _, phig = eam.pair.interp(0, r2c)
        rho_ij, rho_g_ij = eam.rho.interp(0, r2c)
    else:
        t = torch.clamp(typ.to(torch.int64), 0, ntypes - 1)
        t_i, t_j = t[:, None], t[None, :]
        _, phig = _interp_cols(eam.pair, t_i * ntypes + t_j, r2c)
        rho_ij, rho_g_ij = _interp_cols(eam.rho, t_j * ntypes + t_i, r2c)
    phig = torch.where(valid, phig, zero)
    rho_ij = torch.where(valid, rho_ij, zero)
    rho_g_ij = torch.where(valid, rho_g_ij, zero)
    rho = rho_ij.sum(1)
    rho_c = torch.clamp(rho, min=1e-12)
    if ntypes == 1:
        _, df = eam.embed.interp(0, rho_c)
    else:
        _, df = _interp_cols(eam.embed, t, rho_c)
    df = torch.where(mask, 0.5 * df, zero)
    s = phig + df[:, None] * rho_g_ij + df[None, :] * rho_g_ij.T
    s = torch.where(valid, s, zero)
    F = -(s[..., None] * dr).sum(1)
    return F, rho, valid.to(pos.dtype).sum(1)


def _table_interp(pt, col, x):
    """PotTable.interp on the device: quadratic interpolation of column
    ``col`` (an int, or an integer tensor broadcast with ``x``); returns
    (value, 2 dV/dx), the gradient zero below the table start."""
    dt, dev = x.dtype, x.device
    L = pt.table.shape[1]

    def per_col(a):
        if isinstance(col, int):
            return float(a[col])
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)[col]
    begin, invstep, end = (per_col(pt.begin), per_col(pt.invstep),
                           per_col(pt.end))
    is_short = x < begin
    xa = torch.clamp(torch.minimum(x, torch.as_tensor(end, dtype=dt,
                                                      device=dev)) - begin,
                     min=0.0) * invstep
    k = torch.clamp(torch.floor(xa), max=L - 3)
    chi = xa - k
    ki = k.to(torch.int64)
    tab = torch.as_tensor(np.asarray(pt.table), dtype=dt, device=dev)
    if isinstance(col, int):
        t = tab[col]
        p0, p1, p2 = t[ki], t[ki + 1], t[ki + 2]
    else:
        base = col.to(torch.int64) * L + ki
        flat = tab.reshape(-1)
        p0, p1, p2 = flat[base], flat[base + 1], flat[base + 2]
    dv = p1 - p0
    d2v = p2 - 2.0 * p1 + p0
    val = p0 + chi * dv + 0.5 * chi * (chi - 1.0) * d2v
    grad = 2.0 * invstep * (dv + (chi - 0.5) * d2v)
    return val, torch.where(is_short, torch.zeros_like(grad), grad)


def pot_eval(pot, col, x):
    """(value, 2 dV/dx) of a table (PotTable) or a fastpoly fit
    (PolyPotential) at ``x`` in column ``col`` (an int or a tensor)."""
    if hasattr(pot, "table"):
        return _table_interp(pot, col, x)
    if isinstance(col, int):
        return pot.interp(col, x)
    return _interp_cols(pot, torch.broadcast_to(col, x.shape), x)


def _reverse_roll(grid, arr: torch.Tensor, off) -> torch.Tensor:
    """Send per-neighbour-cell sums back: the inverse of _neighbor_view."""
    return _neighbor_view(grid, arr, tuple(-o for o in off))


@dataclasses.dataclass(eq=False)
class ForceResult:
    """The stencil oracles' result (imd_tpu ForceResult)."""
    force: torch.Tensor             # [gx, gy, gz, cap, 3]
    epot: torch.Tensor              # [gx, gy, gz, cap]
    virial: torch.Tensor            # scalar
    presstens: torch.Tensor         # [6] xx yy zz yz zx xy
    rho: Optional[torch.Tensor] = None
    embed_dF: Optional[torch.Tensor] = None
    # [gx, gy, gz, cap, 6]: half of each pair's dr (x) f to each atom
    # (STRESS_TENS, imd_forces_nbl.c:955-975), on request
    presstens_atom: Optional[torch.Tensor] = None


_COMPS = ((0, 0), (1, 1), (2, 2), (1, 2), (2, 0), (0, 1))


def _stencil(scene):
    """Yields (off, dr, r2, valid, ntyp) for the own cell (off None, each
    pair once) and the 13 half-stencil offsets: dr = x_i - (x_j + shift),
    valid within the grid's cutoff between live slots."""
    grid = scene.grid
    dtype, dev = scene.pos.dtype, scene.pos.device
    pos, typ, mask = scene.pos, scene.type, scene.mask
    cap = pos.shape[3]
    rcut2 = grid.cutoff ** 2
    for off in [None] + HALF_OFFSETS:
        if off is None:
            npos, ntyp, nmask = pos, typ, mask
            dr = pos[..., :, None, :] - npos[..., None, :, :]
            cell_ok = None
        else:
            npos = _neighbor_view(grid, pos, off)
            ntyp = _neighbor_view(grid, typ, off)
            nmask = _neighbor_view(grid, mask, off)
            shift, cell_ok = _wrap_shift_and_mask(grid, off, dtype, dev)
            dr = pos[..., :, None, :] - (npos[..., None, :, :]
                                         + shift[..., None, :, :])
        r2 = (dr * dr).sum(-1)
        valid = mask[..., :, None] & nmask[..., None, :] & (r2 < rcut2)
        if off is None:
            ii = torch.arange(cap, device=dev)
            valid = valid & (ii[:, None] < ii[None, :])
        else:
            valid = valid & cell_ok[..., None]
        yield off, dr, r2, valid, ntyp


def _add_pair(grid, acc, a_i, a_j, off):
    """acc + the i-side sums + the j-side sums sent back to their cells."""
    if off is None:
        return acc + a_i + a_j
    return acc + a_i + _reverse_roll(grid, a_j, off)


def _pair_cols(ntypes, t_i, t_j):
    if ntypes == 1:
        return 0
    return torch.clamp(t_i.to(torch.int64) * ntypes + t_j.to(torch.int64),
                       0, ntypes * ntypes - 1)


def _virial_terms(grid, gv, dr, r2, off, pt_atom):
    """(virial, [6] presstens, per-atom stress) contributions of the
    pairs' gradient factors ``gv`` (force = -gv dr)."""
    virial = -(gv * r2).sum()
    pts = torch.stack([gv * dr[..., a] * dr[..., b] for a, b in _COMPS], -1)
    pt = -pts.sum(dim=tuple(range(pts.dim() - 1)))
    if pt_atom is not None:
        pt_atom = _add_pair(grid, pt_atom, -0.5 * pts.sum(-2),
                            -0.5 * pts.sum(-3), off)
    return virial, pt, pt_atom


def compute_pair_forces(scene, pot, ntypes: int = 1,
                        per_atom_stress: bool = False) -> ForceResult:
    """Pair forces with Newton's third law over the 14-offset stencil
    (imd_tpu's compute_pair_forces; calc_forces for PAIR,
    imd_forces_nbl.c:419-672), with the per-atom stress on request."""
    grid = scene.grid
    typ = scene.type
    F = torch.zeros_like(scene.pos)
    epot = torch.zeros_like(scene.epot)
    virial = torch.zeros((), dtype=F.dtype, device=F.device)
    presstens = torch.zeros(6, dtype=F.dtype, device=F.device)
    pt_atom = (torch.zeros(epot.shape + (6,), dtype=F.dtype,
                           device=F.device) if per_atom_stress else None)
    for off, dr, r2, valid, ntyp in _stencil(scene):
        col = _pair_cols(ntypes, typ[..., :, None], ntyp[..., None, :])
        phi, grad = pot_eval(pot, col, torch.clamp(r2, min=1e-12))
        phi = torch.where(valid, phi, 0.0)
        grad = torch.where(valid, grad, 0.0)
        fv = grad[..., None] * dr
        F = _add_pair(grid, F, -fv.sum(-2), fv.sum(-3), off)
        epot = _add_pair(grid, epot, 0.5 * phi.sum(-1), 0.5 * phi.sum(-2),
                         off)
        v, pt, pt_atom = _virial_terms(grid, grad, dr, r2, off, pt_atom)
        virial = virial + v
        presstens = presstens + pt
    return ForceResult(force=F, epot=epot, virial=virial,
                       presstens=presstens, presstens_atom=pt_atom)


def compute_eam_forces(scene, eam, ntypes: int = 1,
                       per_atom_stress: bool = False) -> ForceResult:
    """EAM2 forces (imd_tpu's compute_eam_forces; imd_forces_nbl.c:295):
    pass 1 the pair terms and the host density, the embedding F(rho) and
    dF, pass 2 the density-mediated forces with dF_i + dF_j.  Density
    columns in the engine convention (at i from j: t_j*ntypes + t_i)."""
    grid = scene.grid
    typ, mask = scene.type, scene.mask
    F = torch.zeros_like(scene.pos)
    epot = torch.zeros_like(scene.epot)
    rho = torch.zeros_like(scene.epot)
    virial = torch.zeros((), dtype=F.dtype, device=F.device)
    presstens = torch.zeros(6, dtype=F.dtype, device=F.device)
    pt_atom = (torch.zeros(epot.shape + (6,), dtype=F.dtype,
                           device=F.device) if per_atom_stress else None)

    def rho_terms(t_i, t_j, r2c, valid):
        v_ij, g_ij = pot_eval(eam.rho, _pair_cols(ntypes, t_j, t_i), r2c)
        if ntypes == 1:
            v_ji, g_ji = v_ij, g_ij
        else:
            v_ji, g_ji = pot_eval(eam.rho, _pair_cols(ntypes, t_i, t_j), r2c)
        return tuple(torch.where(valid, a, 0.0)
                     for a in (v_ij, g_ij, v_ji, g_ji))

    for off, dr, r2, valid, ntyp in _stencil(scene):
        t_i, t_j = typ[..., :, None], ntyp[..., None, :]
        r2c = torch.clamp(r2, min=1e-12)
        phi, grad = pot_eval(eam.pair, _pair_cols(ntypes, t_i, t_j), r2c)
        phi = torch.where(valid, phi, 0.0)
        grad = torch.where(valid, grad, 0.0)
        rho_ij, _, rho_ji, _ = rho_terms(t_i, t_j, r2c, valid)
        fv = grad[..., None] * dr
        F = _add_pair(grid, F, -fv.sum(-2), fv.sum(-3), off)
        epot = _add_pair(grid, epot, 0.5 * phi.sum(-1), 0.5 * phi.sum(-2),
                         off)
        rho = _add_pair(grid, rho, rho_ij.sum(-1), rho_ji.sum(-2), off)
        v, pt, pt_atom = _virial_terms(grid, grad, dr, r2, off, pt_atom)
        virial = virial + v
        presstens = presstens + pt

    rho_c = torch.clamp(rho, min=1e-12)
    ecol = 0 if ntypes == 1 else torch.clamp(typ.to(torch.int64), 0,
                                             ntypes - 1)
    f_emb, df_emb = pot_eval(eam.embed, ecol, rho_c)
    # the embedding table is a direct function of rho: halve the radial
    # convention's 2 dF/dx
    epot = epot + torch.where(mask, f_emb, 0.0)
    dF = torch.where(mask, 0.5 * df_emb, 0.0)

    for off, dr, r2, valid, ntyp in _stencil(scene):
        t_i, t_j = typ[..., :, None], ntyp[..., None, :]
        _, g_ij, _, g_ji = rho_terms(t_i, t_j, torch.clamp(r2, min=1e-12),
                                     valid)
        dF_j = dF if off is None else _neighbor_view(grid, dF, off)
        s = torch.where(valid, dF[..., :, None] * g_ij
                        + dF_j[..., None, :] * g_ji, 0.0)
        fv = s[..., None] * dr
        F = _add_pair(grid, F, -fv.sum(-2), fv.sum(-3), off)
        v, pt, pt_atom = _virial_terms(grid, s, dr, r2, off, pt_atom)
        virial = virial + v
        presstens = presstens + pt
    return ForceResult(force=F, epot=epot, virial=virial,
                       presstens=presstens, rho=rho, embed_dF=dF,
                       presstens_atom=pt_atom)


def compute_nbanz(scene, nb_rcut, ntypes: int = 1) -> torch.Tensor:
    """Per-atom coordination number NBANZ (NNBR, imd_forces_nbl.c:509-511):
    neighbours within nb_rcut[t_i*ntypes + t_j] (the transposed column for
    j), pairs beyond the stencil's reach unseen.  int32
    [gx, gy, gz, cap]."""
    grid = scene.grid
    typ, mask = scene.type, scene.mask
    dev = scene.pos.device
    nb_r2 = torch.as_tensor(np.asarray(nb_rcut, np.float64),
                            dtype=scene.pos.dtype, device=dev) ** 2
    nb = torch.zeros(typ.shape, dtype=torch.int32, device=dev)
    nt = ntypes
    for off, dr, r2, valid, ntyp in _stencil(scene):
        ti = torch.clamp(typ[..., :, None].to(torch.int64), 0, nt - 1)
        tj = torch.clamp(ntyp[..., None, :].to(torch.int64), 0, nt - 1)
        n_i = (valid & (r2 < nb_r2[ti * nt + tj])).sum(-1, dtype=torch.int32)
        n_j = (valid & (r2 < nb_r2[tj * nt + ti])).sum(-2, dtype=torch.int32)
        nb = _add_pair(grid, nb, n_i, n_j, off)
    return nb * mask.to(torch.int32)


def compute_ordpar(scene, pot, op_rcut, op_weight,
                   ntypes: int = 1) -> torch.Tensor:
    """Per-atom order parameter (ORDPAR, imd_forces.c:195-198): each half
    pair energy adds op_weight[col] * phi / 2 to atom i when r^2 <
    op_rcut[col]^2, col = t_i*ntypes + t_j (the transpose for j)."""
    grid = scene.grid
    typ, mask = scene.type, scene.mask
    dt, dev = scene.pos.dtype, scene.pos.device
    op_r2 = torch.as_tensor(np.asarray(op_rcut, np.float64), dtype=dt,
                            device=dev) ** 2
    op_w = torch.as_tensor(np.asarray(op_weight, np.float64), dtype=dt,
                           device=dev)
    op = torch.zeros_like(scene.epot)
    nt = ntypes
    for off, dr, r2, valid, ntyp in _stencil(scene):
        ti = torch.clamp(typ[..., :, None].to(torch.int64), 0, nt - 1)
        tj = torch.clamp(ntyp[..., None, :].to(torch.int64), 0, nt - 1)
        col, colj = ti * nt + tj, tj * nt + ti
        phi, _ = pot_eval(pot, _pair_cols(nt, typ[..., :, None],
                                          ntyp[..., None, :]),
                          torch.clamp(r2, min=1e-12))
        half = torch.where(valid, 0.5 * phi, 0.0)
        op_i = torch.where(valid & (r2 < op_r2[col]), op_w[col] * half,
                           0.0).sum(-1)
        op_j = torch.where(valid & (r2 < op_r2[colj]), op_w[colj] * half,
                           0.0).sum(-2)
        op = _add_pair(grid, op, op_i, op_j, off)
    return op * mask.to(dt)
