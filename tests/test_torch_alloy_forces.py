"""The alloy EAM passes (K6/K7 hot loop, K8/K9 observables): the port's
plain versions vs imd_tpu's eam_kernels_win_split_mt and eam_kernels_cl_mt
(Pallas, interpret mode on the CPU), float64.

Grid: fcc 5x4x4 -> dims (3,2,2), jittered with NumPy from a seed, where a
2-cell axis reaches the same neighbour cell through two images; periodic,
and with the open x axis of the ablation geometry.  Two table sets made by
scaling the analytic EAM's columns: ntypes 2 with densities that depend on
source AND host (not source-only), and ntypes 3 with eam.alloy-style
source-only densities (imd_tpu then takes its pruned column path); pair
tables symmetric, random types.  Tolerance: nn exact; F, rho, epot, virial
and presstens to 1e-9 of their scale (the sums run in another order: the
TPU kernels sweep a half stencil with one-hot column weights, the port a
full one with the selected column).

The interpret-mode references cost their compile (eam_kernels_win_split_mt
~15 s, eam_kernels_cl_mt ~5 s), so each kernel pair meets imd_tpu directly
once, at ntypes 3: K6/K7 with the open x axis, K8/K9 periodic.  At ntypes 2
both pairs meet imd_tpu in the driver test
(tests/test_torch_alloy_driver.py: open x; forces through the trajectory,
per-atom energy and density through the checkpoint columns, the virial
through the pressure); here K6/K7 and K8/K9 are held to each other exactly
and to the port's typed all-pairs oracle, periodic and open.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.models import potential as j_pot
from imd_tpu.ops import geometry as j_geom
from imd_tpu.ops.forces_pallas import eam_kernels_cl_mt as j_cl_mt
from imd_tpu.ops.forces_win import eam_kernels_win_split_mt as j_win_mt
from imd_tpu.ops.fused_step import scene_to_cl as j_scene_to_cl
from imd_tpu.scene import make_scene as j_make_scene
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import convert, kernels
from imd_tpu_torch.models import potential as t_pot
from imd_tpu_torch.ops import forces as t_forces
from imd_tpu_torch.ops import forces_pallas as t_b4
from imd_tpu_torch.ops import forces_win as t_win

TOL = 1e-9
PBC = {"periodic": (1, 1, 1), "open_x": (0, 1, 1)}
# column scales of (pair [nt^2], rho [nt^2] source-first, embed [nt])
SCALES = {
    2: ([1.0, 0.8, 0.8, 0.6], [1.0, 0.9, 0.7, 0.5], [1.0, 0.75]),
    3: ([1.0, 0.8, 0.7, 0.8, 0.6, 0.9, 0.7, 0.9, 0.5],
        [1.0, 1.0, 1.0, 0.8, 0.8, 0.8, 0.6, 0.6, 0.6],
        [1.0, 0.75, 0.9]),
}


def _scaled_eam(nt, module):
    """The analytic EAM's columns scaled per type pair, tabulated and
    fitted by ``module`` (imd_tpu's potential module or the port's)."""
    e1 = module.analytic_eam(r_cut=5.0, r0=2.864, E_c=3.39)
    pair, rho, embed = SCALES[nt]
    if module is t_pot:
        tile = t_pot.tile_columns
    else:
        def tile(pt, scales):
            n = len(scales)
            tab = np.asarray(pt.table)

            def rep(a):
                return jnp.asarray(np.concatenate([np.asarray(a)] * n))
            return j_pot.PotTable(
                table=jnp.asarray(np.concatenate([tab * s for s in scales])),
                begin=rep(pt.begin), end=rep(pt.end), step=rep(pt.step),
                invstep=rep(pt.invstep), length=rep(pt.length))
    return module.eam_to_fastpoly(module.EAMPotential(
        pair=tile(e1.pair, pair), rho=tile(e1.rho, rho),
        embed=tile(e1.embed, embed)))


def _case(nt, pbc):
    """Matching inputs of both packages: the JAX cells-last state and EAM,
    and their copies in the port."""
    torch.set_num_threads(1)
    pos, _, diag = fcc((5, 4, 4), 4.05)
    rng = np.random.default_rng(3)
    pos = pos + rng.normal(scale=0.1, size=pos.shape)
    typ = rng.integers(0, nt, len(pos))
    box = j_geom.Box.create([diag[0], 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], pbc=PBC[pbc], dtype=jnp.float64)
    grid = j_geom.choose_grid(box, 5.0, skin=0.5, n_atoms=len(pos))
    grid = j_geom.with_capacity(grid, j_geom.measured_capacity(
        grid, pos, safety=1.0, extra=1, dtype=np.float64))
    scene = j_make_scene(grid, pos, type=typ, mass=np.full(len(pos), 26.9815),
                         dtype=jnp.float64)
    assert int(scene.overflow) == 0, grid.dims
    jcl = j_scene_to_cl(scene)
    jeam = _scaled_eam(nt, j_pot)
    return dict(nt=nt, jcl=jcl, jeam=jeam, jgrid=grid,
                cl=convert.from_cl(jcl, device="cpu"),
                eam=convert.from_eam(jeam), grid=convert.from_grid(grid))


def _close(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=TOL * np.max(np.abs(want)), err_msg=name)


# each JAX reference (interpret mode: its cost is the compile) is computed
# inside the one test that reads it
@pytest.mark.parametrize("nt,pbc", [(3, "open_x")])
def test_k6_k7_plain_match_jax_win_split_mt(nt, pbc):
    c = _case(nt, pbc)
    jcl, jeam, jgrid = c["jcl"], c["jeam"], c["jgrid"]
    jF, jrho, jnn = jax.jit(lambda xi, t, m: j_win_mt(
        xi, t, m, jeam, jgrid, nt, count_neighbors=True))(
            jcl.xi, jcl.typ, jcl.alive)
    cl = c["cl"]
    kernels.reset_launches()
    F, rho, nn = t_win.eam_kernels_win_split_mt(
        cl.xi, cl.typ, cl.alive, c["eam"], c["grid"], nt,
        count_neighbors=True)
    assert not any(kernels.LAUNCHES.values())   # CPU: the plain versions
    np.testing.assert_array_equal(nn.numpy(), np.asarray(jnn))
    _close(rho.numpy(), jrho, "rho")
    _close(F.numpy(), jF, "F")
    dead = ~cl.alive.numpy()
    assert not F.numpy().transpose(0, 2, 1)[dead].any()
    assert not rho.numpy()[dead].any() and not nn.numpy()[dead].any()


@pytest.mark.parametrize("nt,pbc", [(3, "periodic")])
def test_k8_k9_plain_match_jax_cl_mt(nt, pbc):
    c = _case(nt, pbc)
    jcl, jeam, jgrid = c["jcl"], c["jeam"], c["jgrid"]
    want = jax.jit(lambda xi, t, m: j_cl_mt(
        xi, t, m, jeam, jgrid, nt, count_neighbors=True, need_energy=True,
        need_stress=True))(jcl.xi, jcl.typ, jcl.alive)
    cl = c["cl"]
    kernels.reset_launches()
    got = t_b4.eam_kernels_cl_mt(cl.xi, cl.typ, cl.alive, c["eam"],
                                 c["grid"], nt)
    assert not any(kernels.LAUNCHES.values())
    names = ("F", "epot", "rho", "nn", "virial", "presstens")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for name, g, w in zip(names, got, want):
        _close(g.numpy(), w, name)
    assert float(got[4]) == pytest.approx(float(got[5][:3].sum()), rel=1e-14)
    dead = ~cl.alive.numpy()
    assert not got[0].numpy().transpose(0, 2, 1)[dead].any()
    assert not got[1].numpy()[dead].any()


@pytest.fixture(scope="module")
def port_case(request):
    """The port's own nt = 2 inputs, periodic unless parametrised (no JAX
    run: under pytest-xdist every worker that takes one of these tests
    builds the fixture)."""
    c = _case(2, getattr(request, "param", "periodic"))
    rho = c["eam"].rho.host
    assert rho[0] != rho[1] and rho[2] != rho[3]   # not source-only
    return {k: c[k] for k in ("nt", "cl", "eam", "grid")}


@pytest.mark.parametrize("port_case", sorted(PBC), indirect=True)
def test_mt_plain_matches_typed_n2_oracle(port_case):
    """K6/K7's plain versions against the port's all-pairs oracle with
    types, at the float64 fit the kernels bake."""
    cl, grid, nt = port_case["cl"], port_case["grid"], port_case["nt"]
    eam = port_case["eam"].at_host_precision()
    alive = cl.alive
    F, rho, nn = t_win.eam_kernels_win_split_mt(
        cl.xi, cl.typ, alive, eam, grid, nt, count_neighbors=True)
    pos = cl.xi.permute(0, 2, 1)[alive]
    oF, orho, onn = t_forces.eam_forces_n2(
        pos, torch.ones(len(pos), dtype=torch.bool), grid.box, eam,
        typ=cl.typ[alive], ntypes=nt)
    np.testing.assert_array_equal(nn[alive].numpy(), onn.numpy())
    _close(rho[alive].numpy(), orho.numpy())
    _close(F.permute(0, 2, 1)[alive].numpy(), oF.numpy())


@pytest.mark.parametrize("port_case", sorted(PBC), indirect=True)
def test_mt_wrappers_on_cpu_and_k9_equals_k7(port_case):
    """The wrappers hand CPU tensors to the plain versions; K9's forces
    are K7's and its six per-atom sums add up to the pressure tensor; a
    dead slot is one with typ < 0, whatever its position."""
    cl, eam, grid, nt = (port_case[k] for k in ("cl", "eam", "grid", "nt"))
    kernels.reset_launches()
    rho, nn = t_win.eam_rho_mt(cl.xi, cl.typ, eam, grid, nt)
    rho_e, nn_e, e = t_b4.eam_rho_e_mt(cl.xi, cl.typ, eam, grid, nt)
    assert torch.equal(rho, rho_e) and torch.equal(nn, nn_e)
    _, emb_g = t_win.embed_mt(eam, rho, cl.typ, nt)
    dF = 0.5 * emb_g * cl.alive.to(rho.dtype)
    F = t_win.eam_force_mt(cl.xi, cl.typ, dF, eam, grid, nt)
    F_s, S = t_b4.eam_force_s_mt(cl.xi, cl.typ, dF, eam, grid, nt)
    assert not any(kernels.LAUNCHES.values())
    assert {"eam_rho_mt", "eam_force_mt", "eam_rho_e_mt",
            "eam_force_s_mt"} <= set(kernels.LAUNCHES)
    assert torch.equal(F, F_s)
    assert S.shape == (6,) + tuple(cl.typ.shape) and not S[:, ~cl.alive].any()
    out = t_b4.eam_kernels_cl_mt(cl.xi, cl.typ, cl.alive, eam, grid, nt)
    assert torch.equal(S.double().sum(dim=(1, 2)), out[5])
    # dead slots moved off the sentinel change nothing
    xi2 = torch.where(cl.alive[:, None, :], cl.xi, torch.zeros_like(cl.xi))
    rho2, nn2 = t_win.eam_rho_mt(xi2, cl.typ, eam, grid, nt)
    assert torch.equal(rho2, rho) and torch.equal(nn2, nn)


def test_embedding_floor_and_type_select(port_case):
    eam, nt = port_case["eam"], port_case["nt"]
    rho = torch.tensor([[0.0, 5.0, 5.0, 0.0]], dtype=torch.float64)
    typ = torch.tensor([[0, 0, 1, -1]], dtype=torch.int32)
    v, g = t_win.embed_mt(eam, rho, typ, nt)
    for k, (p, r) in enumerate([(0, 1e-12), (0, 5.0), (1, 5.0), (0, 1e-12)]):
        wv, wg = eam.embed.interp(p, torch.tensor(r, dtype=torch.float64))
        assert float(v[0, k]) == float(wv) and float(g[0, k]) == float(wg)
    assert float(v[0, 1]) != float(v[0, 2])


@pytest.mark.parametrize("entry", ["eam_rho_mt", "eam_force_mt",
                                   "eam_rho_e_mt", "eam_force_s_mt",
                                   "make_fused_step"])
def test_asymmetric_pair_table_raises(port_case, entry):
    """phi(0,1) != phi(1,0): no full-stencil kernel gives the half
    stencil's result, so every multi-type entry refuses the table; an
    asymmetric density table is fine (the cases above)."""
    import dataclasses

    from imd_tpu_torch.ops import fused_step as t_fused
    cl, eam, grid, nt = (port_case[k] for k in ("cl", "eam", "grid", "nt"))
    host = list(eam.pair.host)
    host[1], host[2] = host[0], host[3]
    bad = dataclasses.replace(eam, pair=dataclasses.replace(
        eam.pair, host=tuple(host)))
    dF = torch.zeros_like(cl.mass)
    calls = {
        "eam_rho_mt": lambda: t_win.eam_rho_mt(cl.xi, cl.typ, bad, grid, nt),
        "eam_force_mt": lambda: t_win.eam_force_mt(cl.xi, cl.typ, dF, bad,
                                                   grid, nt),
        "eam_rho_e_mt": lambda: t_b4.eam_rho_e_mt(cl.xi, cl.typ, bad, grid,
                                                  nt),
        "eam_force_s_mt": lambda: t_b4.eam_force_s_mt(cl.xi, cl.typ, dF,
                                                      bad, grid, nt),
        "make_fused_step": lambda: t_fused.make_fused_step(
            t_fused.cl_to_scene(cl, _template(cl, grid)), bad, 0.1,
            ntypes=nt),
    }
    with pytest.raises(ValueError, match="asymmetric pair table"):
        calls[entry]()


def _template(cl, grid):
    from imd_tpu_torch.scene import make_scene
    return make_scene(grid, np.zeros((1, 3)), dtype=cl.xi.dtype,
                      device="cpu")


def test_ntypes_out_of_range_raises(port_case):
    from imd_tpu_torch.ops import fused_step as t_fused
    cl, eam, grid = (port_case[k] for k in ("cl", "eam", "grid"))
    with pytest.raises(ValueError, match="2 to 4 species"):
        t_win.eam_rho_mt(cl.xi, cl.typ, eam, grid, 5)
    with pytest.raises(ValueError, match="needs 9 pair columns"):
        t_win.eam_rho_mt(cl.xi, cl.typ, eam, grid, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        t_fused.make_fused_step(
            t_fused.cl_to_scene(cl, _template(cl, grid)), eam, 0.1, ntypes=5)
