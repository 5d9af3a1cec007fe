"""K3 (per-cell slot compaction) and the migration rebin: the port vs
imd_tpu's make_rebin_cl (XLA scatter on the CPU) and its Pallas compaction
kernel (interpret mode, at a tiny size only), float64.

Atoms are displaced by a hot (0.6 eV) free flight so that they migrate
across cell faces; per-cell bags of (id, pos, mom, mass, type, fdi) and
the overflow count must be exactly equal (slot order inside a cell is
free, rebin_cl.py:30-33).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.ops import geometry as j_geom
from imd_tpu.ops import rebin_cl as j_rebin
from imd_tpu.ops.fused_step import scene_to_cl as j_scene_to_cl
from imd_tpu.scene import make_scene as j_make_scene
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import convert, kernels
from imd_tpu_torch.ops import rebin_cl as t_rebin


def _hot_cl(far_mover: bool):
    """Cells-last state after a 4-time-unit free flight at 0.6 eV, plus a
    random stored FD index per slot: fcc 5x4x4 (dims (3,2,2)), or with
    ``far_mover`` fcc 6x4x4 (dims (4,2,2), where a 2-cell jump along x is
    not a periodic +-1) with one atom pushed two cells along x."""
    pos, _, diag = fcc((6, 4, 4) if far_mover else (5, 4, 4), 4.05)
    box = j_geom.Box.create([diag[0], 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], dtype=jnp.float64)
    grid = j_geom.choose_grid(box, 5.0, skin=0.5, n_atoms=len(pos))
    grid = j_geom.with_capacity(grid, j_geom.measured_capacity(
        grid, pos, dtype=np.float64))
    mass = np.full(len(pos), 26.9815)
    rng = np.random.default_rng(11)
    mom = rng.normal(size=pos.shape) * np.sqrt(mass[:, None] * 0.6)
    scene = j_make_scene(grid, pos, mom=mom, mass=mass, dtype=jnp.float64)
    cl = j_scene_to_cl(scene)
    xi = np.array(cl.xi)
    alive = np.asarray(cl.alive)
    xi = np.where(alive[:, None, :],
                  xi + 4.0 * np.asarray(cl.mom) / np.asarray(cl.mass)[
                      :, None, :], xi)
    if far_mover:
        s, c = np.argwhere(alive)[0]
        xi[s, 0, c] += 2.0 * diag[0] / grid.dims[0]
    cl = cl.replace(xi=jnp.asarray(xi))
    fdi = np.where(alive, rng.integers(0, 8, alive.shape), -1)
    return grid, cl, fdi.astype(np.int32)


def _bags(ids, alive, fields):
    """{cell: sorted rows of (id, fields...)} over live slots."""
    ids = np.asarray(ids)
    out = {}
    for c in range(ids.shape[-1]):
        live = np.asarray(alive)[:, c]
        rows = np.concatenate([ids[live, c, None].astype(np.float64)]
                              + [np.asarray(f)[live, ..., c]
                                 .reshape(live.sum(), -1) for f in fields],
                              axis=1)
        out[c] = rows[np.argsort(rows[:, 0])]
    return out


@pytest.mark.parametrize("far_mover", [False, True])
def test_rebin_matches_jax(far_mover):
    torch.set_num_threads(1)
    jgrid, jcl, fdi = _hot_cl(far_mover)
    jcl2, jfdi2 = jax.jit(j_rebin.make_rebin_cl(jgrid))(jcl,
                                                        jnp.asarray(fdi))
    tcl2, tfdi2 = t_rebin.make_rebin_cl(convert.from_grid(jgrid))(
        convert.from_cl(jcl, device="cpu"), torch.as_tensor(fdi))
    assert int(tcl2.overflow) == int(jcl2.overflow) == int(far_mover)
    n_moved = int((np.asarray(jcl2.ids) != np.asarray(jcl.ids)).sum())
    assert n_moved > 20, "the free flight must move atoms across cells"
    jb = _bags(jcl2.ids, jcl2.alive, [jcl2.xi, jcl2.mom, jcl2.mass,
                                      jcl2.typ, jfdi2])
    tb = _bags(tcl2.ids, tcl2.alive, [tcl2.xi, tcl2.mom, tcl2.mass,
                                      tcl2.typ, tfdi2])
    assert jb.keys() == tb.keys()
    for c in jb:
        np.testing.assert_array_equal(tb[c], jb[c], err_msg=f"cell {c}")
    np.testing.assert_array_equal(tcl2.ref_xi.numpy(), tcl2.xi.numpy())
    # dead slots: sentinel positions, -1 ids and fdi
    dead = ~tcl2.alive.numpy()
    assert (tcl2.xi.numpy().transpose(0, 2, 1)[dead] == 1.0e6).all()
    assert (tcl2.ids.numpy()[dead] == -1).all()
    assert (tfdi2.numpy()[dead] == -1).all()


def _random_compaction(cap, nc, seed):
    """K = 3*cap candidates per cell, each valid with probability 1/2 and
    ranked exclusively (targets are unique; out_cap = dropped)."""
    rng = np.random.default_rng(seed)
    K = 3 * cap
    valid = rng.random((K, nc)) < 0.5
    rank = np.cumsum(valid, 0) - valid
    tgt = np.where(valid & (rank < cap), rank, cap).astype(np.int32)
    ff = rng.normal(size=(7, K, nc))
    fi = rng.integers(-1, 1000, (6, K, nc)).astype(np.int32)
    return tgt, ff, fi


def test_compact_plain_matches_jax_xla_scatter():
    tgt, ff, fi = _random_compaction(cap=16, nc=50, seed=1)
    jo = j_rebin._compact_xla(jnp.asarray(tgt),
                              [jnp.asarray(f) for f in (*ff, *fi)], 16,
                              [0.0] * 7 + [-1] * 6)
    of, oi = t_rebin.compact(torch.as_tensor(tgt), torch.as_tensor(ff),
                             torch.as_tensor(fi), 16)
    np.testing.assert_array_equal(of.numpy(), np.stack(jo[:7]))
    np.testing.assert_array_equal(oi.numpy(), np.stack(jo[7:]))


def test_compact_plain_matches_pallas_kernel_interpret():
    tgt, ff, fi = _random_compaction(cap=2, nc=8, seed=2)
    jo = j_rebin._compact_pallas(jnp.asarray(tgt),
                                 [jnp.asarray(f) for f in (*ff, *fi)], 2,
                                 [0.0] * 7 + [-1] * 6, block=128,
                                 force_interpret=True)
    kernels.reset_launches()
    of, oi = t_rebin.compact(torch.as_tensor(tgt), torch.as_tensor(ff),
                             torch.as_tensor(fi), 2)
    assert kernels.LAUNCHES["compact"] == 0   # CPU tensors: plain version
    np.testing.assert_array_equal(of.numpy(), np.stack(jo[:7]))
    np.testing.assert_array_equal(oi.numpy(), np.stack(jo[7:]))

