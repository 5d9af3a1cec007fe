"""B4 (the .eng observables kernels K4/K5): the port's plain versions vs
imd_tpu's compute_eam_forces_pallas (Pallas eam_kernels_cl, interpret mode
on the CPU), float64.

Grid: fcc 5x4x4 -> dims (3,2,2), capacity 48, jittered with NumPy from a
seed; periodic, and with the open x axis of the 1M-atom ablation geometry
(pbc_dirs 0 1 1).  Tolerance: nn exact; F, epot, rho, virial and presstens
to 1e-9 of their scale (the sums run in another order: the TPU kernels
sweep a half stencil and book each pair once, the port a full one).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.models import potential as j_pot
from imd_tpu.ops import geometry as j_geom
from imd_tpu.ops.forces_pallas import compute_eam_forces_pallas as j_b4
from imd_tpu.scene import make_scene as j_make_scene
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import convert, kernels
from imd_tpu_torch.models import potential as t_pot
from imd_tpu_torch.ops import forces_pallas as t_b4
from imd_tpu_torch.ops import forces_win as t_win
from imd_tpu_torch.ops import geometry as t_geom
from imd_tpu_torch.ops.fused_step import scene_to_cl
from imd_tpu_torch.scene import make_scene as t_make_scene

TOL = 1e-9


PBC = {"periodic": (1, 1, 1), "open_x": (0, 1, 1)}


def _positions():
    pos, _, diag = fcc((5, 4, 4), 4.05)
    pos = pos + np.random.default_rng(3).normal(scale=0.1, size=pos.shape)
    return pos, diag


def _jeam():
    return j_pot.eam_to_fastpoly(j_pot.analytic_eam(
        r_cut=5.0, r0=4.05 / math.sqrt(2.0), E_c=3.39, dtype=jnp.float32),
        deg=12)


@pytest.fixture(scope="module", params=sorted(PBC))
def case(request):
    """The port's own scene and EAM (no JAX run: under pytest-xdist every
    worker that takes one of these tests builds the fixture)."""
    torch.set_num_threads(1)
    pos, diag = _positions()
    box = t_geom.Box.create([diag[0], 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], pbc=PBC[request.param],
                            dtype=np.float64)
    grid = t_geom.choose_grid(box, 5.0, 0.5, len(pos))
    grid = t_geom.with_capacity(grid, t_geom.measured_capacity(
        grid, pos, dtype=np.float64))
    scene = t_make_scene(grid, pos, mass=np.full(len(pos), 26.9815),
                         dtype=torch.float64, device="cpu")
    eam = t_pot.eam_to_fastpoly(t_pot.analytic_eam(
        r_cut=5.0, r0=4.05 / math.sqrt(2.0), E_c=3.39), deg=12)
    return dict(scene=scene, eam=eam,
                res=t_b4.compute_eam_forces_pallas(scene, eam))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.max(np.abs(want)))


def test_grid_is_the_tiny_one(case):
    assert case["scene"].grid.dims == (3, 2, 2)
    assert case["scene"].grid.capacity == 48


@pytest.mark.parametrize("pbc", sorted(PBC))
def test_b4_plain_matches_jax(pbc):
    """The JAX reference (interpret mode, ~4 s) is computed here, in the
    one test that reads it."""
    torch.set_num_threads(1)
    pos, diag = _positions()
    box = j_geom.Box.create([diag[0], 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], pbc=PBC[pbc],
                            dtype=jnp.float64)
    grid = j_geom.choose_grid(box, 5.0, skin=0.5, n_atoms=len(pos))
    grid = j_geom.with_capacity(grid, j_geom.measured_capacity(
        grid, pos, dtype=np.float64))
    jscene = j_make_scene(grid, pos, mass=np.full(len(pos), 26.9815),
                          dtype=jnp.float64)
    jeam = _jeam()
    want = jax.jit(lambda s: j_b4(s, jeam, count_neighbors=True,
                                  need_energy=True, need_stress=True))(jscene)
    kernels.reset_launches()
    res = t_b4.compute_eam_forces_pallas(
        convert.from_scene(jscene, device="cpu"), convert.from_eam(jeam))
    assert not any(kernels.LAUNCHES.values())   # CPU: the plain versions
    m = np.asarray(jscene.mask)
    np.testing.assert_array_equal(res.num_neighs.numpy(),
                                  np.asarray(want.num_neighs))
    for name in ("force", "epot", "rho"):
        _close(getattr(res, name).numpy()[m],
               np.asarray(getattr(want, name))[m])
        assert not getattr(res, name).numpy()[~m].any(), name
    _close(res.presstens.numpy(), np.asarray(want.presstens))
    assert float(res.virial) == pytest.approx(float(want.virial), rel=TOL)
    assert float(res.virial) == pytest.approx(
        float(res.presstens[:3].sum()), rel=1e-14)


def test_k4_k5_plain_versions_on_cpu(case):
    """The wrappers hand CPU tensors to the plain versions; K5's six
    per-atom sums add up to the pressure tensor."""
    scene, eam = case["scene"], case["eam"]
    cl = scene_to_cl(scene)
    xi, mask = cl.xi, cl.alive
    kernels.reset_launches()
    rho, nn, e = t_b4.eam_rho_e(xi, mask, eam, scene.grid)
    for got, want in zip((rho, nn, e),
                         t_b4.eam_rho_e_plain(xi, mask, eam, scene.grid)):
        assert torch.equal(got, want)
    dF = 0.5 * eam.embed.interp(0, rho)[1] * mask.to(rho.dtype)
    F, S = t_b4.eam_force_s(xi, mask, dF, eam, scene.grid)
    assert not any(kernels.LAUNCHES.values())
    assert S.shape == (6,) + tuple(mask.shape)
    assert not S[:, ~mask].any()
    assert torch.equal(S.double().sum(dim=(1, 2)), case["res"].presstens)
    F_w = t_win.eam_force(xi, mask, dF, eam, scene.grid)
    assert torch.equal(F, F_w)
