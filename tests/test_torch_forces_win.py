"""K1/K2 (EAM R and F passes): the port's plain versions vs imd_tpu's
eam_kernels_win_split (Pallas, interpret mode on the CPU) and vs the port's
own all-pairs oracle, float64.

Two grids: fcc 5x4x4 -> dims (3,2,2), capacity 48, where a 2-cell axis
reaches the same neighbour cell through two images; and fcc 6x6x6 ->
dims (4,4,4).  Positions are jittered so forces are non-trivial.
Tolerance: nn exact; rho and F to 1e-10 of their scale (only the order of
the sums differs, as in imd_tpu's win-vs-split tests).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.models import potential as j_pot
from imd_tpu.ops import forces as j_forces
from imd_tpu.ops import geometry as j_geom
from imd_tpu.ops.forces_win import eam_kernels_win_split as j_win_split
from imd_tpu.ops.fused_step import scene_to_cl as j_scene_to_cl
from imd_tpu.scene import make_scene as j_make_scene
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import convert, kernels
from imd_tpu_torch.ops import forces as t_forces
from imd_tpu_torch.ops import forces_win as t_win

TOL = 1e-10
# name: (fcc unit cells, expected grid dims, expected capacity or None)
GRIDS = {"dims322_cap48": ((5, 4, 4), (3, 2, 2), 48),
         "dims444": ((6, 6, 6), (4, 4, 4), None)}


@pytest.fixture(scope="module")
def jeam():
    """The fitted EAM, shared by both grids."""
    return j_pot.eam_to_fastpoly(j_pot.analytic_eam(
        r_cut=5.0, r0=4.05 / math.sqrt(2.0), E_c=3.39, dtype=jnp.float32),
        deg=12)


def _setup(cells, dtype):
    pos, _, diag = fcc(cells, 4.05)
    pos = pos + np.random.default_rng(3).normal(scale=0.1, size=pos.shape)
    box = j_geom.Box.create([diag[0], 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], dtype=dtype)
    grid = j_geom.choose_grid(box, 5.0, skin=0.5, n_atoms=len(pos))
    # the dims (4,4,4) grid takes the smallest fitting capacity: the
    # interpret-mode Pallas reference costs ~cap^2 to compile and run
    safety, extra = (1.25, 2) if cells == (5, 4, 4) else (1.0, 1)
    grid = j_geom.with_capacity(grid, j_geom.measured_capacity(
        grid, pos, safety=safety, extra=extra, dtype=np.dtype(dtype)))
    return j_make_scene(grid, pos, mass=np.full(len(pos), 26.9815),
                        dtype=dtype)


@pytest.fixture(scope="module", params=sorted(GRIDS))
def case(request, jeam):
    torch.set_num_threads(1)
    cells, dims, cap = GRIDS[request.param]
    scene = _setup(cells, jnp.float64)
    jcl = j_scene_to_cl(scene)
    return dict(want=(dims, cap), grid=convert.from_grid(scene.grid),
                jgrid=scene.grid, eam=convert.from_eam(jeam), jeam=jeam,
                jcl=jcl, cl=convert.from_cl(jcl, device="cpu"))


def _plain(case):
    cl = case["cl"]
    return t_win.eam_kernels_win_split(cl.xi, cl.alive, case["eam"],
                                       case["grid"], count_neighbors=True)


def _close(got, want):
    scale = np.max(np.abs(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)


def test_grid_shapes(case):
    dims, cap = case["want"]
    assert case["grid"].dims == dims
    assert cap is None or case["grid"].capacity == cap


def test_eam_plain_matches_jax_win_split(case):
    # the interpret-mode Pallas reference costs ~9 s to trace and compile:
    # computed here, in the one test that reads it, so that no other
    # pytest-xdist worker pays for it
    jcl, jeam, jgrid = case["jcl"], case["jeam"], case["jgrid"]
    jF, jrho, jnn = (np.asarray(a) for a in jax.jit(
        lambda xi, m: j_win_split(xi, m, jeam, jgrid, count_neighbors=True))(
            jcl.xi, jcl.alive))
    F, rho, nn = (t.numpy() for t in _plain(case))
    np.testing.assert_array_equal(nn, jnn)
    _close(rho, jrho)
    _close(F, jF)
    dead = ~case["cl"].alive.numpy()
    assert not F.transpose(0, 2, 1)[dead].any()
    assert not rho[dead].any() and not nn[dead].any()


def test_eam_plain_matches_n2_oracle(case):
    cl = case["cl"]
    # the oracle evaluates the float64 fit the kernels bake (the stored
    # coefficients are float32-rounded)
    eam = case["eam"].at_host_precision()
    alive = cl.alive
    F, rho, nn = t_win.eam_kernels_win_split(cl.xi, alive, eam, case["grid"],
                                             count_neighbors=True)
    pos = cl.xi.permute(0, 2, 1)[alive]
    oF, orho, onn = t_forces.eam_forces_n2(
        pos, torch.ones(len(pos), dtype=torch.bool), case["grid"].box, eam)
    np.testing.assert_array_equal(nn[alive].numpy(), onn.numpy())
    _close(rho[alive].numpy(), orho.numpy())
    _close(F.permute(0, 2, 1)[alive].numpy(), oF.numpy())


@pytest.mark.parametrize("case", ["dims322_cap48"], indirect=True)
def test_n2_oracle_matches_jax(case):
    """The port's all-pairs oracle is the JAX one (same float32-stored
    fit); on the smaller grid only, to keep the JAX compile cheap."""
    cl = case["cl"]
    pos = cl.xi.permute(0, 2, 1)[cl.alive]
    oF, _, _ = t_forces.eam_forces_n2(pos, torch.ones(len(pos),
                                                      dtype=torch.bool),
                                      case["grid"].box, case["eam"])
    jF, _, _ = jax.jit(lambda p: j_forces.eam_forces_n2(
        p, jnp.zeros(len(pos), jnp.int32), jnp.ones(len(pos), bool),
        case["jgrid"].box, case["jeam"]))(jnp.asarray(pos.numpy()))
    _close(oF.numpy(), np.asarray(jF))


def test_cpu_tensors_take_the_plain_version(case):
    kernels.reset_launches()
    cl = case["cl"]
    rho, nn = t_win.eam_rho(cl.xi, cl.alive, case["eam"], case["grid"])
    prho, pnn = t_win.eam_rho_plain(cl.xi, cl.alive, case["eam"],
                                    case["grid"])
    assert torch.equal(rho, prho) and torch.equal(nn, pnn)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
    assert {"eam_rho", "eam_force", "compact"} <= set(kernels.LAUNCHES)

