"""The pieces of the general pair step, port vs imd_tpu on the CPU: the
analytic pair tables, the device rebin with the skin check, the NVE
leapfrog, and B6 (``compute_pair_forces_pallas``, with K12's plain version
``pair_half_plain``).

Inputs come from NumPy seeds.  The tables must be exactly equal, the rebin
slot for slot.  The leapfrog runs on one scene with random momenta and
forces: positions, momenta and the step's sums to 1e-13.  B6 runs on fcc
5x4x4 Al jittered by 0.1 A (grid (3,2,2), capacity 48) with the degree-12
fastpoly fit of melt_quench's LJ, once periodic with the neighbour count
inside neigh_r2 = 4.5^2, once with an open x face, each against one jitted
interpret-mode JAX reference made in the test that reads it: the masked
forces, energies, counts, virial and pressure tensor, and the unmasked
i-sums of live slots (imd_tpu's own sweep, ``_make_sweep``, over the same
views) to 1e-9 of each quantity's largest value (the sums run in another
order), counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu import integrate as j_int
from imd_tpu.models import potential as j_pot
from imd_tpu.ops import forces_pallas as j_fp
from imd_tpu.ops import geometry as j_geom
from imd_tpu.scene import make_scene as j_make_scene
from imd_tpu.scene import max_displacement2 as j_max_displacement2
from imd_tpu.scene import needs_rebin as j_needs_rebin
from imd_tpu.scene import rebin as j_rebin
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import convert, integrate
from imd_tpu_torch import scene as t_scene
from imd_tpu_torch.models import potential as t_pot
from imd_tpu_torch.ops import forces_pallas as t_fp
from imd_tpu_torch.ops.forces import HALF_OFFSETS

TOL = 1e-9

# (ntypes 2 parameters: the upper triangle 00 01 11; ntypes 1 takes the
# first of each)
TABLES = {
    "lj_table": ((0.35, 0.3, 0.4), (2.62, 2.5, 2.7), (5.0, 4.8, 5.2)),
    "morse_table": ((0.3, 0.2, 0.25), (1.5, 1.4, 1.6), (2.8, 2.9, 3.0),
                    (6.0, 6.0, 6.0)),
    "ljg_table": ((0.35, 0.3, 0.4), (2.62, 2.5, 2.7), (0.1, 0.2, 0.15),
                  (3.0, 3.1, 3.2), (0.3, 0.2, 0.25), (5.0, 5.0, 5.0)),
    "buckingham_table": ((1000.0, 900.0, 800.0), (10.0, 12.0, 14.0),
                         (0.3, 0.31, 0.32), (5.0, 5.0, 5.0)),
}


@pytest.mark.parametrize("ntypes", [1, 2])
@pytest.mark.parametrize("name", sorted(TABLES))
def test_pair_tables_match_jax(name, ntypes):
    """The analytic tables with their smoothing tail equal imd_tpu's."""
    k = ntypes * (ntypes + 1) // 2
    args = [list(v[:k]) for v in TABLES[name]]
    j = getattr(j_pot, name)(*args, ntypes=ntypes)
    t = getattr(t_pot, name)(*args, ntypes=ntypes)
    assert t.ncols == ntypes * ntypes
    for f in ("table", "begin", "end", "step", "invstep", "length"):
        np.testing.assert_array_equal(getattr(t, f), np.asarray(getattr(j, f)),
                                      err_msg=f)


def _fcc_scene(pbc, capacity):
    """fcc 5x4x4 Al with 1 A of vacuum along x, jittered from a seed, with
    random momenta, epot and ids: grid (3,2,2)."""
    pos, _, diag = fcc((5, 4, 4), 4.05)
    pos = pos + 0.3 + np.random.default_rng(3).normal(scale=0.1,
                                                      size=pos.shape)
    box = j_geom.Box.create([diag[0] + 1.0, 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], pbc=pbc, dtype=jnp.float64)
    grid = j_geom.choose_grid(box, 5.0, skin=0.5, n_atoms=len(pos),
                              capacity=capacity)
    rng = np.random.default_rng(4)
    kw = dict(mom=rng.normal(size=pos.shape),
              mass=np.full(len(pos), 26.9815), id=rng.permutation(len(pos)),
              epot=rng.normal(size=len(pos)))
    return j_make_scene(grid, pos, dtype=jnp.float64, **kw)


def _same_scene(t, j):
    assert t.grid.dims == j.grid.dims and t.grid.capacity == j.grid.capacity
    for f in ("pos", "mom", "mass", "epot", "type", "vtype", "id",
              "nbl_ref_pos", "force"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert int(t.overflow) == int(j.overflow)


@pytest.mark.parametrize("capacity", [48, 28], ids=["fits", "overflows"])
def test_device_rebin_and_skin_check_match_jax(capacity):
    """Atoms moved up to 1.6 A (some leave their cells, some cross the
    periodic faces; dead slots at 0): the device rebin gives imd_tpu's
    slots with epot riding along, and at capacity 28 (~28 atoms a cell)
    drops the same atoms and counts them; the skin check reads the same
    displacement."""
    jscene = _fcc_scene((0, 1, 1), capacity=capacity)
    step = np.random.default_rng(5).uniform(-1.6, 1.6, jscene.pos.shape)
    moved = jscene.replace(pos=jnp.where(jscene.mask[..., None],
                                         jscene.pos + step, 0.0))
    tmoved = convert.from_scene(moved, device="cpu")
    np.testing.assert_allclose(t_scene.max_displacement2(tmoved).item(),
                               float(j_max_displacement2(moved)), rtol=1e-13)
    for margin in (0.5, 6.0):
        assert bool(t_scene.needs_rebin(tmoved, margin)) \
            == bool(j_needs_rebin(moved, margin))
    tr = t_scene.rebin(tmoved)
    _same_scene(tr, jax.jit(j_rebin)(moved))
    assert (int(tr.overflow) > int(tmoved.overflow)) == (capacity < 48)
    assert not bool(t_scene.needs_rebin(tr, 0.5))


def test_nve_matches_jax():
    """One leapfrog step with viscous friction on: positions, momenta and
    the step's sums."""
    jscene = _fcc_scene((1, 1, 1), capacity=48)
    rng = np.random.default_rng(6)
    jscene = jscene.replace(force=jnp.where(
        jscene.mask[..., None], rng.normal(size=jscene.force.shape), 0.0))
    jp = j_int.IntegratorParams(timestep=jnp.float64(0.1),
                                viscous_friction=jnp.float64(0.02))
    js, jstats = j_int.nve(jscene, jp)
    ts, tstats = integrate.nve(
        convert.from_scene(jscene, device="cpu"),
        integrate.IntegratorParams(timestep=0.1, viscous_friction=0.02))
    for f in ("pos", "mom"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-13,
                                   atol=1e-13, err_msg=f)
    for f in ("tot_kin_energy", "fnorm", "pnorm", "pxf", "ekin_new"):
        np.testing.assert_allclose(getattr(tstats, f).item(),
                                   float(getattr(jstats, f)), rtol=1e-13,
                                   err_msg=f)


def _jlj():
    return j_pot.to_fastpoly(j_pot.lj_table(0.35, 2.62, 5.0,
                                            dtype=jnp.float32), vcap=50.0)


def _j_isums(jscene, pot, count, nr2):
    """imd_tpu's unmasked i-sums (fx, fy, fz, e[, nn]), assembled: its own
    sweep (the body of B6's kernel) over prep_neighbors' views."""
    xi, nbr, _ = j_fp.prep_neighbors(jscene)
    rcut2 = float(jscene.grid.cutoff) ** 2
    sweep = j_fp._make_sweep(rcut2, nr2 if nr2 > 0 else rcut2, "P",
                             j_fp._poly_consts(pot), None, want_nn=count)
    keys = ["fx", "fy", "fz", "e"] + (["nn"] if count else [])
    cap = xi.shape[0]
    tri = (jnp.arange(cap)[:, None] < jnp.arange(cap)[None, :])[..., None]
    o = sweep(xi[:, 0], xi[:, 1], xi[:, 2], xi, tri, None, None)
    acc = {k: o[k + "_i"] + o[k + "_j"] for k in keys}
    accj = {k: [] for k in keys}
    for m in range(len(HALF_OFFSETS)):
        o = sweep(xi[:, 0], xi[:, 1], xi[:, 2], nbr[m], None, None, None)
        for k in keys:
            acc[k] = acc[k] + o[k + "_i"]
            accj[k].append(o[k + "_j"])
    dims = jscene.grid.dims
    return {k: j_fp._assemble(dims, acc[k], jnp.stack(accj[k]))
            for k in keys}


@pytest.mark.parametrize("geom", ["periodic", "open_x"])
def test_pair_forces_match_jax(geom):
    """B6 with K12's plain version against imd_tpu's B6 in interpret mode
    (the reference is made here, in the one test that reads it)."""
    torch.set_num_threads(1)
    pbc, count, nr2 = {"periodic": ((1, 1, 1), True, 4.5 ** 2),
                       "open_x": ((0, 1, 1), False, 0.0)}[geom]
    jscene = _fcc_scene(pbc, capacity=48)
    assert jscene.grid.dims == (3, 2, 2)
    jpot = _jlj()
    # one jit for both (eager, the sweeps cost ~5 s of dispatch)
    jres, isums = jax.jit(lambda s: (j_fp.compute_pair_forces_pallas(
        s, jpot, count_neighbors=count, neigh_r2=nr2),
        _j_isums(s, jpot, count, nr2)))(jscene)
    tscene = convert.from_scene(jscene, device="cpu")
    tpot = convert.from_pot(jpot)
    tres = t_fp.compute_pair_forces_pallas(tscene, tpot, count_neighbors=count,
                                           neigh_r2=nr2)
    for f in ("force", "epot", "presstens"):
        want = np.asarray(getattr(jres, f))
        np.testing.assert_allclose(getattr(tres, f).numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max(), err_msg=f)
    np.testing.assert_allclose(tres.virial.item(), float(jres.virial),
                               rtol=TOL)
    np.testing.assert_array_equal(tres.num_neighs.numpy(),
                                  np.asarray(jres.num_neighs))
    assert bool(tres.num_neighs.any()) == count
    # the unmasked i-sums and j-partials of K12's plain version, assembled,
    # on the live slots
    xi, nbr, mask = t_fp.prep_neighbors(tscene)
    acc_i, acc_s, acc_j = t_fp.pair_half_plain(xi, nbr, tpot, tscene.grid,
                                               count, nr2)
    live = mask.numpy()
    for n, k in enumerate(t_fp._pair_keys(True, count)):
        got = t_fp._assemble(tscene.grid.dims, acc_i[n], acc_j[n]).numpy()
        want = np.asarray(isums[k])[live]
        np.testing.assert_allclose(got[live], want, rtol=0,
                                   atol=TOL * np.abs(want).max(), err_msg=k)
    np.testing.assert_allclose(acc_s.sum(dim=(1, 2)).numpy(),
                               np.asarray(jres.presstens), rtol=0,
                               atol=TOL * float(np.abs(jres.presstens).max()))


def test_pair_forces_switches_and_types():
    """Energy, stress and count off give zeros, as imd_tpu's switches do;
    ntypes > 1 is refused (imd_tpu would evaluate column 0, ROADMAP C3)."""
    tscene = convert.from_scene(_fcc_scene((1, 1, 1), capacity=48),
                                device="cpu")
    tpot = convert.from_pot(_jlj())
    full = t_fp.compute_pair_forces_pallas(tscene, tpot)
    bare = t_fp.compute_pair_forces_pallas(tscene, tpot, need_energy=False)
    assert torch.equal(bare.force, full.force)
    assert not bool(bare.epot.any()) and not bool(bare.presstens.any())
    assert float(bare.virial) == 0.0 and not bool(full.num_neighs.any())
    with pytest.raises(ValueError, match="C3"):
        t_fp.compute_pair_forces_pallas(tscene, tpot, ntypes=2)
