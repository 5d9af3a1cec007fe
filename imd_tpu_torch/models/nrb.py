"""Non-reflecting boundary conditions (NRB) (port of imd_tpu/models/nrb.py;
the reference's imd_nrb.c, an impedance-matching boundary after Comput.
Mech. 50:645-655 (2012), fcc(100), in-plane atoms).

``init_nrb`` finds the boundary layers of the (perfect) fcc lattice once,
on the host: atoms within alat/4 of the global x-max are type 1, of the
y-min/y-max type 2/3 when y is open (init_nrb, imd_nrb.c:210-265); each
boundary atom keeps its reference position and the ids of its 4 inward
fcc nearest neighbours (component-wise +-alat/2 offset match within eps,
imd_nrb.c:330-520).  Every step after the force pass each boundary atom's
momentum is set (not integrated),

    p_bnd/m = -k' D U_self + k' sum_r W U_r - 0.25 sum_r V_r

with k' = sqrt(nrb_k/m), D = diag(4, 2 sqrt2, 2 sqrt2) and W = diag(1,
sqrt2/2, sqrt2/2) for x-boundaries (axes permuted for y), U the
displacement from the reference position and V a neighbour's velocity
(nrb_forces, imd_nrb.c:792-1130); the integrator skips p += dt F there
(imd_integrate.c:254-259).

Torch re-design: ``nrb_forces_cl`` builds the id -> slot map with one
scatter over the cells-last ids each step (atoms move between slots, ids do
not).  Out-of-range targets go to one spare row that is cut off, where
imd_tpu scatters with ``mode="drop"``: on CUDA an out-of-range index is a
device-side assert.  No boolean-mask indexing, so no host read in the
step.  Only the cells-last form is ported: the Scene form ``nrb_forces``
serves imd_tpu's general step, which the port runs for pair potentials
only (NRB with a pair potential is refused, ROADMAP A9b).

Restart: ``write_nrb`` / ``read_nrb`` keep imd_tpu's text format
(nrb_writerestart/readrestart, imd_nrb.c:2143/2217).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from imd_tpu_torch.ops.forces import min_image
from imd_tpu_torch.ops.geometry import np_dtype
from imd_tpu_torch.scene import Scene, flatten_atoms

SQRT2HALF = 0.70710678118655     # globals.h:426
DBLSQRT2 = 2.82842712474619      # globals.h:427

# per-boundary-type neighbour sites, offsets in units of alat/2: each
# boundary atom couples to its 4 INWARD fcc nearest neighbours (slots of
# the reference's 12-wide NRBI array, imd_nrb.c:340-520)
_TYPE_SITES = {
    1: [(0, (-1, 1, 0)), (1, (-1, -1, 0)),
        (8, (-1, 0, 1)), (9, (-1, 0, -1))],          # x-hi: inward = -x
    2: [(0, (-1, 1, 0)), (3, (1, 1, 0)),
        (7, (0, 1, 1)), (6, (0, 1, -1))],            # y-lo: inward = +y
    3: [(1, (-1, -1, 0)), (2, (1, -1, 0)),
        (4, (0, -1, 1)), (5, (0, -1, -1))],          # y-hi: inward = -y
}


@dataclasses.dataclass(eq=False)
class NRBState:
    """The boundary tables (tensors on the run's device; shapes fixed at
    set-up)."""
    bnd_id: torch.Tensor      # [nb] int32 atom ids of boundary atoms
    bnd_type: torch.Tensor    # [nb] int32 1=x-hi, 2=y-lo, 3=y-hi
    bnd_ref: torch.Tensor     # [nb, 3] reference positions
    neigh_id: torch.Tensor    # [nb, 12] int32, -1 = missing
    neigh_ref: torch.Tensor   # [nb, 12, 3]
    nrbk: torch.Tensor        # 0-d: sqrt(nrb_k / mass)
    mass: torch.Tensor        # 0-d
    n_ids: int                # id-space size
    # the (D, W) weight rows [nb, 3] times nrbk, made once (_weights)
    d_row: torch.Tensor = dataclasses.field(init=False)
    w_row: torch.Tensor = dataclasses.field(init=False)

    def __post_init__(self):
        self.d_row, self.w_row = _weights(self.bnd_type, self.nrbk,
                                          self.nrbk.dtype)


def make_state(bnd_id, bnd_type, bnd_ref, neigh_id, neigh_ref, nrbk: float,
               mass: float, n_ids: int, dtype=torch.float32,
               device="cuda") -> NRBState:
    """NRBState from host arrays."""
    def ints(a):
        return torch.as_tensor(np.array(a, np.int32), device=device)

    def reals(a):
        return torch.as_tensor(np.array(a, np_dtype(dtype)), device=device)

    return NRBState(bnd_id=ints(bnd_id), bnd_type=ints(bnd_type),
                    bnd_ref=reals(bnd_ref), neigh_id=ints(neigh_id),
                    neigh_ref=reals(neigh_ref), nrbk=reals(nrbk),
                    mass=reals(mass), n_ids=int(n_ids))


def init_nrb(scene: Scene, alat: float, nrb_k: float, eps: float = 0.1,
             mass: float = 26.9815,
             pbc: Tuple[int, int, int] = (0, 1, 1)) -> Optional[NRBState]:
    """Detect the boundary layers and capture the neighbour ids (host,
    NumPy and scipy's cKDTree, once; the reference does this serially at
    init, imd_nrb.c:125-791).  None when no atom is on a boundary."""
    from scipy.spatial import cKDTree

    flat = {k: v.detach().cpu().numpy()
            for k, v in flatten_atoms(scene).items()}
    mask = flat["mask"]
    pos = flat["pos"][mask]
    ids = flat["id"][mask]
    n_ids = int(ids.max()) + 1 if ids.size else 0

    xhi = pos[:, 0].max() - alat / 4.0
    btype = np.zeros(len(pos), np.int32)
    btype[pos[:, 0] > xhi] = 1
    if not pbc[1]:
        ylo = pos[:, 1].min() + alat / 4.0
        yhi = pos[:, 1].max() - alat / 4.0
        btype[(btype == 0) & (pos[:, 1] < ylo)] = 2
        btype[(btype == 0) & (pos[:, 1] > yhi)] = 3

    bnd = np.nonzero(btype > 0)[0]
    if len(bnd) == 0:
        return None

    box_diag = np.diag(np.asarray(scene.grid.box.h))
    pbc_b = np.asarray(pbc, bool)
    if pbc_b.any():
        # cKDTree needs a finite box: a huge period on the open axes is
        # no period (positions are wrapped into the box)
        tree = cKDTree(pos, boxsize=np.where(pbc_b, box_diag,
                                             1e6 * box_diag.max()))
    else:
        tree = cKDTree(pos)
    nd = alat / 2.0
    r_neigh = alat / math.sqrt(2.0) + eps * 3
    neigh_id = np.full((len(bnd), 12), -1, np.int32)
    neigh_ref = np.zeros((len(bnd), 12, 3))
    cand = tree.query_ball_point(pos[bnd], r_neigh)
    for b, (ai, cands) in enumerate(zip(bnd, cand)):
        d = pos[cands] - pos[ai]
        for ax in range(3):
            if pbc[ax]:
                d[:, ax] -= box_diag[ax] * np.round(d[:, ax] / box_diag[ax])
        for s, off in _TYPE_SITES[int(btype[ai])]:
            hit = np.all(np.abs(d - np.asarray(off, float) * nd) < eps,
                         axis=1)
            j = np.nonzero(hit)[0]
            if len(j):
                cj = cands[j[0]]
                neigh_id[b, s] = ids[cj]
                neigh_ref[b, s] = pos[cj]

    return make_state(ids[bnd], btype[bnd], pos[bnd], neigh_id, neigh_ref,
                      math.sqrt(nrb_k / mass), mass, n_ids,
                      dtype=scene.pos.dtype, device=scene.pos.device)


def _weights(btype, nrbk, dtype):
    """Per boundary atom (D, W) diagonal weight rows [nb, 3]."""
    dev = btype.device
    is_x = (btype == 1)[:, None]
    d_x = torch.tensor([4.0, DBLSQRT2, DBLSQRT2], dtype=dtype, device=dev)
    d_y = torch.tensor([DBLSQRT2, 4.0, DBLSQRT2], dtype=dtype, device=dev)
    w_x = torch.tensor([1.0, SQRT2HALF, SQRT2HALF], dtype=dtype, device=dev)
    w_y = torch.tensor([SQRT2HALF, 1.0, SQRT2HALF], dtype=dtype, device=dev)
    return (torch.where(is_x, d_x, d_y) * nrbk,
            torch.where(is_x, w_x, w_y) * nrbk)


def nrb_forces_cl(xi, mom, alive, ids, box, state: NRBState):
    """The boundary momenta on the cells-last state (imd_tpu
    nrb_forces_cl, models/nrb.py:218): ``xi``/``mom`` [cap, 3, NC],
    ``alive``/``ids`` [cap, NC].  Call after the forces, before the
    integrator.

    Returns (mom_set [cap, 3, NC], bnd [cap, NC] bool): ``mom_set`` holds
    the computed p_bnd at the boundary atoms; the integrator keeps those
    values (skips p += dt F) where ``bnd``."""
    cap, _, nc = xi.shape
    M = cap * nc
    dev = xi.device
    ids_f = ids.reshape(M).to(torch.int64)
    alive_f = alive.reshape(M) & (ids_f >= 0) & (ids_f < state.n_ids)
    # id -> slot, -1 where the id is absent; row n_ids takes the rest
    idx = torch.full((state.n_ids + 1,), -1, dtype=torch.int64, device=dev)
    idx[torch.where(alive_f, ids_f, state.n_ids)] = torch.where(
        alive_f, torch.arange(M, device=dev), -1)
    idx = idx[:state.n_ids]
    pos_f = [xi[:, c, :].reshape(M) for c in range(3)]
    mom_f = [mom[:, c, :].reshape(M) for c in range(3)]

    b_slot = idx[state.bnd_id.to(torch.int64)]           # [nb]
    b_ok = b_slot >= 0
    bs = torch.clamp(b_slot, min=0)
    b_pos = torch.stack([p[bs] for p in pos_f], -1)      # [nb, 3]
    b_mom = torch.stack([p[bs] for p in mom_f], -1)
    u_self = min_image(box, b_pos - state.bnd_ref)

    n_slot = idx[torch.clamp(state.neigh_id, min=0).to(torch.int64)]
    n_ok = (state.neigh_id >= 0) & (n_slot >= 0)         # [nb, 12]
    ns = torch.clamp(n_slot, min=0)
    n_pos = torch.stack([p[ns] for p in pos_f], -1)      # [nb, 12, 3]
    n_mom = torch.stack([p[ns] for p in mom_f], -1)
    u_n = min_image(box, n_pos - state.neigh_ref)
    okf = n_ok.to(xi.dtype)[..., None]

    u_dot = (-state.d_row * u_self
             + (state.w_row[:, None, :] * u_n * okf).sum(1)
             - 0.25 * (n_mom / state.mass * okf).sum(1))
    p_new = torch.where(b_ok[:, None], u_dot * state.mass, b_mom)

    tgt = torch.where(b_ok, b_slot, M)
    mom_out = []
    for c in range(3):
        m = torch.cat([mom_f[c], mom_f[c].new_zeros(1)])
        m[tgt] = p_new[:, c]
        mom_out.append(m[:M].reshape(cap, nc))
    bnd = torch.zeros(M + 1, dtype=torch.bool, device=dev)
    bnd.index_fill_(0, tgt, True)
    return torch.stack(mom_out, 1), bnd[:M].reshape(cap, nc)


def write_nrb(path: str, state: NRBState) -> None:
    """Text format: ``#NRB nb n_ids``, then per boundary atom id type refx
    refy refz n0..n11 and the 36 neighbour reference coordinates, then
    ``#K nrbk mass`` (imd_tpu's, like the reference's .nrb files)."""
    def host(t):
        return t.detach().cpu().numpy()

    bid = host(state.bnd_id)
    bt = host(state.bnd_type)
    br = host(state.bnd_ref)
    ni = host(state.neigh_id)
    nr = host(state.neigh_ref).reshape(len(bid), -1)
    with open(path, "w") as f:
        f.write(f"#NRB {len(bid)} {state.n_ids}\n")
        for k in range(len(bid)):
            f.write(f"{bid[k]} {bt[k]} "
                    + " ".join(f"{x:.10g}" for x in br[k]) + " "
                    + " ".join(str(x) for x in ni[k]) + " "
                    + " ".join(f"{x:.10g}" for x in nr[k]) + "\n")
        f.write(f"#K {float(state.nrbk):.12g} {float(state.mass):.12g}\n")


def read_nrb(path: str, dtype=torch.float32, device="cuda") -> NRBState:
    with open(path) as f:
        header = f.readline().split()
        nb, n_ids = int(header[1]), int(header[2])
        bid = np.zeros(nb, np.int32)
        bt = np.zeros(nb, np.int32)
        br = np.zeros((nb, 3))
        ni = np.zeros((nb, 12), np.int32)
        nr = np.zeros((nb, 36))
        for k in range(nb):
            tok = f.readline().split()
            bid[k] = int(tok[0])
            bt[k] = int(tok[1])
            br[k] = [float(x) for x in tok[2:5]]
            ni[k] = [int(x) for x in tok[5:17]]
            nr[k] = [float(x) for x in tok[17:53]]
        tail = f.readline().split()
    return make_state(bid, bt, br, ni, nr.reshape(nb, 12, 3), float(tail[1]),
                      float(tail[2]), n_ids, dtype=dtype, device=device)
