"""B7 and B8, port vs imd_tpu on the CPU in float64: the rolled-view
helpers (``prep_neighbors``, ``_assemble``, ``_roll_cells_back``), the
split passes ``eam_r_pass``/``eam_f_pass`` with ``eam_kernels_cl_split``
(the plain versions of K10/K11), and ``compute_eam_forces_pallas2`` (K4/K5).

Inputs come from NumPy seeds.  The view helpers run on a (3,4,5) grid of
random atoms, periodic and with an open x face, and must be exactly equal.
The passes run on fcc 5x4x4 Al jittered by 0.1 A (grid (3,2,2), capacity
48: the 2-cell axes reach one neighbour cell through two offsets), once
periodic with the neighbour count inside neigh_r2 = 4.5^2 < rcut^2, once
with the open x face (the film's end planes lie within the cutoff of the
face), each against ONE jitted JAX reference per geometry (interpret-mode
Pallas, as imd_tpu's own tests run it) in a module fixture.  The passes'
outputs are unmasked: two dead slots of one cell count as a pair, so the
unmasked values are compared on live slots and the masked ones everywhere.
Tolerance 1e-9 of each quantity's largest value (the sums run in another
order), neighbour counts exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.models import potential as j_pot
from imd_tpu.ops import forces_fast as j_ff
from imd_tpu.ops import forces_pallas as j_fp
from imd_tpu.ops import geometry as j_geom
from imd_tpu.ops.forces import HALF_OFFSETS as J_HALF_OFFSETS
from imd_tpu.scene import make_scene as j_make_scene
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import convert, kernels
from imd_tpu_torch.ops import forces_fast as t_ff
from imd_tpu_torch.ops import forces_pallas as t_fp
from imd_tpu_torch.ops import forces_win as t_win
from imd_tpu_torch.ops import geometry as t_geom
from imd_tpu_torch.models import potential as t_pot
from imd_tpu_torch.scene import make_scene as t_make_scene
from imd_tpu_torch.utils.generate import fcc as t_fcc
from imd_tpu_torch.ops.forces import ALL_OFFSETS, HALF_OFFSETS

TOL = 1e-9
PBC = {"periodic": (1, 1, 1), "open_x": (0, 1, 1)}
# per geometry: (pbc, count_neighbors, neigh_r2)
PASSES = {"periodic": ((1, 1, 1), True, 4.5 ** 2),
          "open_x": ((0, 1, 1), False, 0.0)}


def _jeam():
    return j_pot.eam_to_fastpoly(j_pot.analytic_eam(
        r_cut=5.0, r0=4.05 / math.sqrt(2.0), E_c=3.39, dtype=jnp.float32),
        deg=12)


def _fcc_scene(pbc):
    """fcc 5x4x4 Al, jittered from a seed: grid (3,2,2), capacity 48."""
    pos, _, diag = fcc((5, 4, 4), 4.05)
    pos = pos + np.random.default_rng(3).normal(scale=0.1, size=pos.shape)
    box = j_geom.Box.create([diag[0], 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], pbc=pbc, dtype=jnp.float64)
    grid = j_geom.choose_grid(box, 5.0, skin=0.5, n_atoms=len(pos))
    grid = j_geom.with_capacity(grid, j_geom.measured_capacity(
        grid, pos, dtype=np.float64))
    return j_make_scene(grid, pos, mass=np.full(len(pos), 26.9815),
                        dtype=jnp.float64)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * np.max(np.abs(want)),
                               err_msg=err_msg)


# ---- the view helpers: exact, no Pallas ------------------------------------

def _random_scene(pbc):
    """200 atoms, uniform from a seed, in a box of (3,4,5) cells."""
    rng = np.random.default_rng(11)
    L = np.array([3, 4, 5]) * 5.6
    pos = rng.uniform(0.0, 1.0, (200, 3)) * L
    box = j_geom.Box.create([L[0], 0, 0], [0, L[1], 0], [0, 0, L[2]],
                            pbc=pbc, dtype=jnp.float64)
    grid = j_geom.choose_grid(box, 5.0, skin=0.5, n_atoms=len(pos))
    grid = j_geom.with_capacity(grid, j_geom.measured_capacity(
        grid, pos, dtype=np.float64))
    assert grid.dims == (3, 4, 5)
    return j_make_scene(grid, pos, dtype=jnp.float64)


@pytest.mark.parametrize("pbc", sorted(PBC))
def test_view_helpers_match_jax(pbc):
    """prep_neighbors, _assemble and _roll_cells_back equal imd_tpu's
    bit for bit on (3,4,5) cells; roll and roll-back are exact inverses
    over all 27 offsets."""
    assert [tuple(o) for o in J_HALF_OFFSETS] == HALF_OFFSETS
    jscene = _random_scene(PBC[pbc])
    dims = jscene.grid.dims
    rng = np.random.default_rng(12)
    nc = int(np.prod(dims))
    acc_i = rng.normal(size=(7, nc))
    accj = rng.normal(size=(13, 7, nc))
    a = rng.normal(size=(2, 3, nc))

    @jax.jit
    def helpers(scene, acc_i, accj, a):
        return (j_fp.prep_neighbors(scene), j_fp._assemble(dims, acc_i, accj),
                [j_ff._roll_cells_back(a, dims, off) for off in ALL_OFFSETS])

    want, want_sum, want_back = jax.tree_util.tree_map(
        np.asarray, helpers(jscene, acc_i, accj, a))
    got = t_fp.prep_neighbors(convert.from_scene(jscene, device="cpu"))
    for name, g, w in zip(("xi", "nbr", "mask"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[0].is_contiguous() and got[1].is_contiguous()
    np.testing.assert_array_equal(
        t_fp._assemble(dims, torch.from_numpy(acc_i),
                       torch.from_numpy(accj)).numpy(), want_sum)
    for off, w in zip(ALL_OFFSETS, want_back):
        back = t_ff._roll_cells_back(torch.from_numpy(a), dims, off)
        np.testing.assert_array_equal(back.numpy(), w, err_msg=str(off))
        there = t_ff._roll_cells(back, dims, off)
        np.testing.assert_array_equal(there.numpy(), a)


# ---- the split passes against one JAX reference per geometry ---------------

@pytest.fixture(scope="module", params=sorted(PASSES))
def ref(request):
    """imd_tpu's eam_r_pass, eam_f_pass and eam_kernels_cl_split on one
    geometry, in one jitted call (interpret-mode Pallas), and the port's
    scene and EAM made from the same inputs."""
    torch.set_num_threads(1)
    pbc, count, nr2 = PASSES[request.param]
    jscene = _fcc_scene(pbc)
    jeam = _jeam()
    grid = jscene.grid

    @jax.jit
    def run(scene):
        xi, nbr, mask = j_fp.prep_neighbors(scene)
        rho, nn = j_fp.eam_r_pass(xi, nbr, jeam, grid,
                                  count_neighbors=count, neigh_r2=nr2)
        dF = 0.5 * jeam.embed.interp(0, rho)[1] * mask.astype(rho.dtype)
        F = j_fp.eam_f_pass(xi, nbr, dF, jeam, grid)
        split = j_fp.eam_kernels_cl_split(xi, nbr, mask, jeam, grid,
                                          count_neighbors=count,
                                          neigh_r2=nr2)
        return dict(nbr=nbr, mask=mask, rho=rho, nn=nn, dF=dF, F=F,
                    split=split)

    out = jax.tree_util.tree_map(np.asarray, run(jscene))
    tscene = convert.from_scene(jscene, device="cpu")
    return dict(out=out, count=count, nr2=nr2, scene=tscene,
                eam=convert.from_eam(jeam), views=t_fp.prep_neighbors(tscene))


def test_r_pass_matches_jax(ref):
    """Unmasked rho and nn of the R pass (plain K10, assembled) on the
    live slots; the CPU wrapper launches nothing."""
    out, (xi, nbr, mask) = ref["out"], ref["views"]
    np.testing.assert_array_equal(nbr.numpy(), out["nbr"])
    grid = ref["scene"].grid
    kernels.reset_launches()
    rho, nn = t_fp.eam_r_pass(xi, nbr, ref["eam"], grid,
                              count_neighbors=ref["count"],
                              neigh_r2=ref["nr2"])
    assert not any(kernels.LAUNCHES.values())
    m = mask.numpy()
    _close(rho.numpy()[m], out["rho"][m], "rho")
    np.testing.assert_array_equal(nn.numpy()[m], out["nn"][m])
    assert bool(nn[mask].any()) == ref["count"]
    p_rho, p_nn = t_fp.eam_r_pass_plain(xi, nbr, ref["eam"], grid,
                                        ref["count"], ref["nr2"])
    assert torch.equal(p_rho, rho) and torch.equal(p_nn, nn)
    if ref["count"]:
        # a radius below the cutoff counts fewer neighbours
        _, nn_rc = t_fp.eam_r_pass(xi, nbr, ref["eam"], grid, True)
        assert bool((nn_rc[mask] > nn[mask]).any())
        assert bool((nn_rc >= nn).all())


def test_f_pass_matches_jax(ref):
    """Unmasked F of the F pass (plain K11, assembled) on the live slots,
    from imd_tpu's dF."""
    out, (xi, nbr, mask) = ref["out"], ref["views"]
    dF = _t(out["dF"])
    kernels.reset_launches()
    F = t_fp.eam_f_pass(xi, nbr, dF, ref["eam"], ref["scene"].grid)
    assert not any(kernels.LAUNCHES.values())
    m = mask.numpy()
    _close(np.moveaxis(F.numpy(), 1, -1)[m],
           np.moveaxis(out["F"], 1, -1)[m], "F")
    assert F.shape == xi.shape
    assert torch.equal(t_fp.eam_f_pass_plain(xi, nbr, dF, ref["eam"],
                                             ref["scene"].grid), F)


def test_cl_split_matches_jax(ref):
    """Masked (F, rho, nn) of eam_kernels_cl_split on every slot; dead
    slots are zero."""
    out, (xi, nbr, mask) = ref["out"], ref["views"]
    got = t_fp.eam_kernels_cl_split(xi, nbr, mask, ref["eam"],
                                    ref["scene"].grid,
                                    count_neighbors=ref["count"],
                                    neigh_r2=ref["nr2"])
    dead = ~mask.numpy()
    for name, g, w in zip(("F", "rho", "nn"), got, out["split"]):
        if name == "nn":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            _close(g.numpy(), w, name)
        g = np.moveaxis(g.numpy(), 1, -1) if name == "F" else g.numpy()
        assert not g[dead].any(), name


@pytest.mark.parametrize("pbc", sorted(PBC))
def test_split_equals_the_windowed_engine(pbc):
    """The half stencil over rolled views and the windowed full stencil
    (K1/K2's plain versions) give the same masked F, rho and nn."""
    torch.set_num_threads(1)
    scene = convert.from_scene(_fcc_scene(PBC[pbc]), device="cpu")
    eam = convert.from_eam(_jeam())
    xi, nbr, mask = t_fp.prep_neighbors(scene)
    F, rho, nn = t_fp.eam_kernels_cl_split(xi, nbr, mask, eam, scene.grid,
                                           count_neighbors=True)
    Fw, rho_w, nn_w = t_win.eam_kernels_win_split(xi, mask, eam,
                                                  scene.grid,
                                                  count_neighbors=True)
    assert torch.equal(nn, nn_w)
    for got, want in ((F, Fw), (rho, rho_w)):
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())


@pytest.mark.parametrize("pbc", sorted(PBC))
def test_cl_split_masks_the_dead_slots_away(pbc, monkeypatch):
    """The R pass's dead-slot outputs are unspecified (K10 skips dead
    slots and writes zeros, the plain version pairs two dead slots of one
    cell): with the plain version's dead-slot outputs replaced by zeros,
    as K10 writes them, eam_kernels_cl_split's masked F, rho and nn do not
    change.  The port alone (float64, no JAX), on the fcc 5x4x4 lattice
    jittered from a seed (grid (3,2,2), capacity 48: dead slots in every
    cell)."""
    torch.set_num_threads(1)
    pos, _, diag = t_fcc((5, 4, 4), 4.05)
    pos = pos + np.random.default_rng(3).normal(scale=0.1, size=pos.shape)
    box = t_geom.Box.create([diag[0], 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], pbc=PBC[pbc],
                            dtype=torch.float64)
    grid = t_geom.choose_grid(box, 5.0, skin=0.5, n_atoms=len(pos))
    grid = t_geom.with_capacity(grid, t_geom.measured_capacity(
        grid, pos, dtype=np.float64))
    scene = t_make_scene(grid, pos, dtype=torch.float64, device="cpu")
    eam = t_pot.eam_to_fastpoly(t_pot.analytic_eam(
        r_cut=5.0, r0=4.05 / math.sqrt(2.0), E_c=3.39), deg=12)
    xi, nbr, mask = t_fp.prep_neighbors(scene)
    assert bool((~mask).sum(0).min() >= 2)
    want = t_fp.eam_kernels_cl_split(xi, nbr, mask, eam, grid,
                                     count_neighbors=True)
    plain = t_fp.eam_rho_half_plain
    dead_i = xi[:, 0] >= t_win.SENTINEL_DEAD / 2              # [cap, NC]
    dead_j = nbr[:, :, 0] >= t_win.SENTINEL_DEAD / 2          # [13, cap, NC]
    seen = {}

    def zeroed(*args, **kw):
        acc_i, acc_j = plain(*args, **kw)
        seen["nonzero"] = bool(acc_i[:, dead_i].any()
                               or acc_j[:, dead_j].any())
        return (acc_i.masked_fill(dead_i, 0.0),
                acc_j.masked_fill(dead_j, 0.0))

    monkeypatch.setattr(t_fp, "eam_rho_half_plain", zeroed)
    rho_z, _ = t_fp.eam_r_pass(xi, nbr, eam, grid, True)
    assert seen["nonzero"]
    assert not rho_z[~mask].any()
    got = t_fp.eam_kernels_cl_split(xi, nbr, mask, eam, grid,
                                    count_neighbors=True)
    for name, g, w in zip(("F", "rho", "nn"), got, want):
        assert torch.equal(g, w), name


def test_half_wrappers_check_their_inputs():
    """What the K10/K11 wrappers refuse before a launch."""
    scene = convert.from_scene(_fcc_scene((1, 1, 1)), device="cpu")
    xi, nbr, _ = t_fp.prep_neighbors(scene)
    grid = scene.grid
    with pytest.raises(TypeError, match="float32"):
        t_fp._check_half_inputs(xi, nbr, grid)
    x32, n32 = xi.float(), nbr.float()
    t_fp._check_half_inputs(x32, n32, grid)
    with pytest.raises(TypeError, match="nbr"):
        t_fp._check_half_inputs(x32, n32[:12].contiguous(), grid)
    with pytest.raises(ValueError, match="cells"):
        t_fp._check_half_inputs(x32, n32, grid.replace(dims=(3, 2, 1)))
    big = kernels.HALF_MAX_CAP + 1
    with pytest.raises(ValueError, match="capacity"):
        t_fp._check_half_inputs(
            torch.zeros((big, 3, grid.n_cells)),
            torch.zeros((13, big, 3, grid.n_cells)), grid)


# ---- B8: compute_eam_forces_pallas2 ----------------------------------------

@pytest.fixture(scope="module")
def pallas2_ref():
    """imd_tpu's compute_eam_forces_pallas2 (interpret mode) with
    need_energy and count_neighbors, on the open-x geometry."""
    torch.set_num_threads(1)
    jscene = _fcc_scene((0, 1, 1))
    jeam = _jeam()
    want = jax.jit(lambda s: j_fp.compute_eam_forces_pallas2(
        s, jeam, count_neighbors=True, need_energy=True))(jscene)
    return dict(want=want, scene=convert.from_scene(jscene, device="cpu"),
                eam=convert.from_eam(jeam), mask=np.asarray(jscene.mask))


def test_pallas2_matches_jax(pallas2_ref):
    want, m = pallas2_ref["want"], pallas2_ref["mask"]
    kernels.reset_launches()
    res = t_fp.compute_eam_forces_pallas2(
        pallas2_ref["scene"], pallas2_ref["eam"], count_neighbors=True,
        need_energy=True)
    assert not any(kernels.LAUNCHES.values())
    np.testing.assert_array_equal(res.num_neighs.numpy(),
                                  np.asarray(want.num_neighs))
    for name in ("force", "epot", "rho"):
        _close(getattr(res, name).numpy(), getattr(want, name), name)
        assert not getattr(res, name).numpy()[~m].any(), name
    assert float(res.virial) == float(want.virial) == 0.0
    np.testing.assert_array_equal(res.presstens.numpy(),
                                  np.asarray(want.presstens))


def test_pallas2_is_b4_with_its_switches(pallas2_ref):
    """pallas2 gives compute_eam_forces_pallas's F, rho, epot and nn; epot
    and nn are zero when not asked for; what it does not port raises."""
    scene, eam = pallas2_ref["scene"], pallas2_ref["eam"]
    b4 = t_fp.compute_eam_forces_pallas(scene, eam)
    full = t_fp.compute_eam_forces_pallas2(scene, eam, count_neighbors=True)
    for name in ("force", "epot", "rho", "num_neighs"):
        assert torch.equal(getattr(full, name), getattr(b4, name)), name
    bare = t_fp.compute_eam_forces_pallas2(scene, eam, need_energy=False)
    assert torch.equal(bare.force, b4.force)
    assert not bare.epot.any() and not bare.num_neighs.any()
    with pytest.raises(NotImplementedError, match="ntypes"):
        t_fp.compute_eam_forces_pallas2(scene, eam, ntypes=2)
    with pytest.raises(NotImplementedError, match="neigh_r2"):
        t_fp.compute_eam_forces_pallas2(scene, eam, count_neighbors=True,
                                        neigh_r2=4.0 ** 2)
