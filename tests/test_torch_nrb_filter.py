"""NRB and FILTER, port vs imd_tpu, float64 on the CPU.

The same scenes (built by imd_tpu, carried across by imd_tpu_torch.convert)
go through both packages: ``init_nrb`` on an fcc rod with an open x face
(ids equal, reference positions and weights equal), ``nrb_forces_cl`` on
the rod's cells-last state with positions jittered and momenta drawn from
a seed (1e-12), the ``.nrb`` restart file written and read by either
package, ``filter_atoms`` on a film with a connected finger and isolated
vapour atoms beyond the bound (the same deleted set), and
``make_filter_apply`` with the stored FD index (the same atoms and FD
indices, by id).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.models import filter as j_filter
from imd_tpu.models import nrb as j_nrb
from imd_tpu.ops import fused_step as j_fused
from imd_tpu.ops.geometry import Box, choose_grid, measured_capacity, \
    with_capacity
from imd_tpu.scene import make_scene
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import convert
from imd_tpu_torch.models import filter as t_filter
from imd_tpu_torch.models import nrb as t_nrb
from imd_tpu_torch.ops import fused_step as t_fused

ALAT = 4.05
TOL = 1e-12


def _scene(pos, pad_x, ids=None):
    """A float64 Scene of ``pos`` in a box padded by ``pad_x`` along the
    open x axis (pbc 0 1 1), Al masses."""
    hi = pos.max(0)
    box = Box.create([hi[0] + pad_x, 0, 0], [0, hi[1] + ALAT / 2, 0],
                     [0, 0, hi[2] + ALAT / 2], pbc=(0, 1, 1),
                     dtype=jnp.float64)
    grid = choose_grid(box, 5.0, skin=0.5, n_atoms=len(pos))
    grid = with_capacity(grid, measured_capacity(grid, pos))
    return make_scene(grid, pos, mass=np.full(len(pos), 26.9815),
                      id=ids, dtype=jnp.float64)


@pytest.fixture(scope="module")
def rod():
    """fcc 10 x 3 x 3 rod 2 A from the box's low x, 20 A of vacuum
    beyond; the two packages' NRB tables of it."""
    torch.set_num_threads(1)
    pos, _, _ = fcc((10, 3, 3), ALAT)
    pos[:, 0] += 2.0
    jscene = _scene(pos, 20.0, ids=np.arange(len(pos))[::-1] + 7)
    tscene = convert.from_scene(jscene, device="cpu")
    jst = j_nrb.init_nrb(jscene, ALAT, nrb_k=2.0, eps=0.1, pbc=(0, 1, 1))
    tst = t_nrb.init_nrb(tscene, ALAT, nrb_k=2.0, eps=0.1, pbc=(0, 1, 1))
    return jscene, tscene, jst, tst


def _same_state(got, want):
    for k in ("bnd_id", "bnd_type", "neigh_id"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)
    for k in ("bnd_ref", "neigh_ref", "nrbk", "mass"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), k)
    assert got.n_ids == want.n_ids


def test_init_nrb_matches_jax(rod):
    """The x-max layer (2 atoms per cell face, 3 x 3 faces), each with its
    4 inward neighbours; the tables equal imd_tpu's exactly (ids and the
    copied positions) and equal what convert carries across."""
    _, _, jst, tst = rod
    _same_state(tst, jst)
    assert len(tst.bnd_id) == 18 and bool((tst.bnd_type == 1).all())
    assert bool(((tst.neigh_id >= 0).sum(1) == 4).all())
    _same_state(convert.nrb_state_from_jax(jst, device="cpu"), jst)


def _cl_inputs(jscene, seed):
    """Cells-last xi/mom/alive/ids of ``jscene`` with live positions
    jittered by up to 0.15 A and momenta of ~0.1 eV, from a seed."""
    jcl = j_fused.scene_to_cl(jscene)
    rng = np.random.default_rng(seed)
    alive = np.array(jcl.alive)
    xi = np.asarray(jcl.xi).copy()
    xi += np.where(alive[:, None, :],
                   rng.uniform(-0.15, 0.15, xi.shape), 0.0)
    mom = rng.normal(size=xi.shape) * np.sqrt(26.9815 * 0.1) \
        * alive[:, None, :]
    return xi, mom, alive, np.array(jcl.ids)


def test_nrb_forces_cl_matches_jax(rod):
    """The set momenta and the boundary mask on the jittered rod: momenta
    to 1e-12 of their maximum, the mask equal; only boundary atoms are
    touched."""
    jscene, tscene, jst, tst = rod
    xi, mom, alive, ids = _cl_inputs(jscene, 3)
    jm, jb = j_nrb.nrb_forces_cl(jnp.asarray(xi), jnp.asarray(mom),
                                 jnp.asarray(alive), jnp.asarray(ids),
                                 jscene.grid.box, jst)
    tm, tb = t_nrb.nrb_forces_cl(torch.as_tensor(xi), torch.as_tensor(mom),
                                 torch.as_tensor(alive),
                                 torch.as_tensor(ids), tscene.grid.box, tst)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert int(tb.sum()) == 18
    want = np.asarray(jm)
    np.testing.assert_allclose(tm.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())
    untouched = ~np.asarray(jb)[:, None, :].repeat(3, 1)
    np.testing.assert_array_equal(tm.numpy()[untouched], mom[untouched])
    assert np.abs(want[~untouched] - mom[~untouched]).max() > 0.0


def test_nrb_restart_files_cross_read(rod, tmp_path):
    """write_nrb / read_nrb round trips, and each package reads the
    other's file: the same text from both writers, the same tables back."""
    _, _, jst, tst = rod
    t_nrb.write_nrb(str(tmp_path / "t.nrb"), tst)
    j_nrb.write_nrb(str(tmp_path / "j.nrb"), jst)
    assert (tmp_path / "t.nrb").read_text() == (tmp_path / "j.nrb").read_text()
    back = t_nrb.read_nrb(str(tmp_path / "t.nrb"), torch.float64, "cpu")
    _same_state(back, j_nrb.read_nrb(str(tmp_path / "t.nrb"), jnp.float64))
    _same_state(t_nrb.read_nrb(str(tmp_path / "j.nrb"), torch.float64,
                               "cpu"), j_nrb.read_nrb(str(tmp_path / "j.nrb"),
                                                      jnp.float64))
    # the text keeps 10 significant digits of the positions
    for k in ("bnd_id", "bnd_type", "neigh_id"):
        assert torch.equal(getattr(back, k), getattr(tst, k)), k
    for k in ("bnd_ref", "neigh_ref", "nrbk", "mass"):
        np.testing.assert_allclose(getattr(back, k).numpy(),
                                   getattr(tst, k).numpy(), rtol=1e-9,
                                   err_msg=k)


class Bounds:
    min_x, max_x = 28.0, np.inf
    min_y, max_y = -np.inf, np.inf
    min_z, max_z = -np.inf, np.inf


@pytest.fixture(scope="module")
def plume():
    """A 6 x 3 x 3 fcc film right of x = 30, a finger of 6 atoms 2 A apart
    poking left across the bound at x = 28 (connected), and 3 isolated
    vapour atoms far left (deleted)."""
    pos, _, _ = fcc((6, 3, 3), ALAT)
    pos[:, 0] += 30.0
    extra = [[30.0 - 2.0 * (k + 1), 6.0, 6.0] for k in range(6)]
    extra += [[5.0, 2.0, 2.0], [8.0, 9.0, 4.0], [3.0, 11.0, 9.0]]
    allpos = np.vstack([pos, np.array(extra)])
    jscene = _scene(allpos, 12.0)
    return jscene, convert.from_scene(jscene, device="cpu")


def test_filter_atoms_matches_jax(plume):
    """The same deleted set (the 3 vapour atoms, ids 222-224) with the
    driver's sweep count (8) and a 3 A bond cutoff."""
    jscene, tscene = plume
    js, jn = j_filter.filter_atoms(jscene, Bounds, r_cut=3.0, n_sweeps=8)
    ts, tn = t_filter.filter_atoms(tscene, Bounds, r_cut=3.0, n_sweeps=8)
    assert int(tn) == int(jn) == 3
    np.testing.assert_array_equal(ts.type.numpy(), np.asarray(js.type))
    gone = ts.id[(ts.type < 0) & (tscene.type >= 0)]
    assert sorted(gone.tolist()) == [222, 223, 224]


def test_filter_apply_matches_jax(plume):
    """make_filter_apply on the cells-last state with the stored FD index:
    the survivors, their positions and FD indices by id equal imd_tpu's
    (deleted atoms gone, the grid's slots rebinned)."""
    jscene, tscene = plume
    jcl = j_fused.scene_to_cl(jscene)
    tcl = t_fused.scene_to_cl(tscene)
    rng = np.random.default_rng(1)
    fdi = np.where(np.asarray(jcl.alive).reshape(-1),
                   rng.integers(0, 12, jcl.alive.size), -1).astype(np.int32)
    jcl2, jfdi = j_fused.make_filter_apply(jscene, Bounds, 3.0)(
        jcl, jnp.asarray(fdi))
    tcl2, tfdi = t_fused.make_filter_apply(tscene, Bounds, 3.0)(
        tcl, torch.as_tensor(fdi))
    for got, want in ((tcl2.ids, jcl2.ids), (tcl2.alive, jcl2.alive),
                      (tcl2.xi, jcl2.xi), (tfdi, jfdi)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(tcl2.alive.sum()) == int(tcl.alive.sum()) - 3
    # without the FD index
    tcl3 = t_fused.make_filter_apply(tscene, Bounds, 3.0)(tcl)
    assert torch.equal(tcl3.ids, tcl2.ids)
