"""The fused hot loop, port vs imd_tpu: the TTM-coupled step (the slice)
and its pure-MD twin, float64 on the CPU, with at least one in-loop rebin.

Both packages start from the same Scene (binned by imd_tpu, carried
across by imd_tpu_torch.convert) with the same NumPy momenta; the JAX side
runs its Pallas kernels in interpret mode and its rebin through the XLA
scatter, as its own tests do.  Atoms are compared by id (slot order inside
a cell is free after a rebin), the TTM grid per FD cell.  The rolled-view
engines: ``engine="split"`` against imd_tpu's split step; ``"ab"`` and the
TTM step under both against the port's own ``"win"`` engine (no JAX call,
1e-10: the engines sum in other orders); two species under ``"split"``
run the alloy kernels, bit for bit as under ``"win"``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.config import LaserConfig, TTMConfig
from imd_tpu.models import eos as j_eos
from imd_tpu.models import potential as j_pot
from imd_tpu.models import ttm as j_ttm
from imd_tpu.ops import fused_step as j_fused
from imd_tpu.ops import geometry as j_geom
from imd_tpu.scene import make_scene as j_make_scene
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import convert, flagship
from imd_tpu_torch.models import potential as t_pot
from imd_tpu_torch.models import ttm as t_ttm
from imd_tpu_torch.models.eos import FEGEos
from imd_tpu_torch.ops import fused_step as t_fused
from imd_tpu_torch.phases import StepCounters

NSTEPS = 12
DT = 0.1
LASER = LaserConfig(rescale_mode=4, sigma_e=0.05, sigma_t=50.0, t_0=100.0,
                    mu=0.01)
TOL = 1e-9


def _hot_scene():
    """fcc 5x4x4 Al (grid (3,2,2), cap 48), f64, Maxwell-like 0.6 eV
    momenta from NumPy so that atoms migrate within a few steps."""
    pos, _, diag = fcc((5, 4, 4), 4.05)
    box = j_geom.Box.create([diag[0], 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], dtype=jnp.float64)
    grid = j_geom.choose_grid(box, 5.0, skin=0.5, n_atoms=len(pos))
    grid = j_geom.with_capacity(grid, j_geom.measured_capacity(
        grid, pos, dtype=np.float64))
    mass = np.full(len(pos), 26.9815)
    rng = np.random.default_rng(7)
    mom = rng.normal(size=pos.shape) * np.sqrt(mass[:, None] * 0.6)
    mom -= mom.mean(0)
    return j_make_scene(grid, pos, mom=mom, mass=mass, dtype=jnp.float64)


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    jscene = _hot_scene()
    jeam = j_pot.eam_to_fastpoly(j_pot.analytic_eam(
        r_cut=5.0, r0=4.05 / math.sqrt(2.0), E_c=3.39, dtype=jnp.float32),
        deg=12)
    return (jscene, jeam, convert.from_scene(jscene, device="cpu"),
            convert.from_eam(jeam))


def _by_id(ids, arr):
    ids = np.asarray(ids).reshape(-1)
    a = np.asarray(arr).reshape(len(ids), -1)
    keep = ids >= 0
    return ids[keep][np.argsort(ids[keep])], a[keep][np.argsort(ids[keep])]


def _assert_same_atoms(jcl, tcl):
    """Same atoms (by id) with the same positions and momenta."""
    assert int(tcl.overflow) == int(np.asarray(jcl.overflow)) == 0
    j_ids = np.asarray(jcl.ids)
    t_ids = tcl.ids.numpy()
    for jf, tf in ((jcl.xi, tcl.xi), (jcl.mom, tcl.mom)):
        # [cap, 3, NC] -> per slot [cap*NC, 3]
        ja = np.moveaxis(np.asarray(jf), 1, -1)
        ta = np.moveaxis(tf.numpy(), 1, -1)
        ids_a, va = _by_id(j_ids, ja)
        ids_b, vb = _by_id(t_ids, ta)
        np.testing.assert_array_equal(ids_a, ids_b)
        np.testing.assert_allclose(vb, va, rtol=0, atol=TOL)


def test_fused_ttm_step_matches_jax(setup):
    jscene, jeam, tscene, team = setup
    tcfg = TTMConfig(enabled=True, fd_nx=4, fd_min_atoms=8)
    jtp = j_ttm.make_params(tcfg, jscene.grid.box, 5.0, jnp.float64)
    tp = convert.from_ttm_params(jtp)
    assert tp == t_ttm.make_params(tcfg, tscene.grid.box, 5.0)

    jstep, jcl = j_fused.make_fused_ttm_step(jscene, jeam, DT, jtp,
                                             j_eos.FEGEos(), LASER)
    jstep = jax.jit(jstep)
    jgrid0 = j_ttm.make_grid(jtp, jnp.float64)
    jcarry = (jcl, jgrid0, -jnp.ones(jcl.mass.size, jnp.int32),
              jnp.zeros((), jnp.int32))
    counters = StepCounters()
    tstep, tcl = t_fused.make_fused_ttm_step(tscene, team, DT, tp, FEGEos(),
                                             LASER, counters=counters)
    tgrid0 = convert.from_ttm_grid(jgrid0, device="cpu")
    for name, v in convert.to_numpy(t_ttm.make_grid(tp, torch.float64,
                                                    device="cpu")).items():
        np.testing.assert_array_equal(v, convert.to_numpy(tgrid0)[name])
    tcarry = (tcl, tgrid0,
              torch.full((tcl.mass.numel(),), -1, dtype=torch.int32), 0)
    for _ in range(NSTEPS):
        jcarry = jstep(*jcarry)
        tcarry = tstep(*tcarry)
    assert counters.rebins >= 1, "the run must exercise an in-loop rebin"
    assert counters.steps == NSTEPS
    _assert_same_atoms(jcarry[0], tcarry[0])

    jg, tg = jcarry[1], convert.to_numpy(tcarry[1])
    for name in ("temp", "U", "xi", "md_temp", "dens"):
        np.testing.assert_allclose(tg[name], np.asarray(getattr(jg, name)),
                                   rtol=TOL, atol=1e-300, err_msg=name)
    np.testing.assert_array_equal(tg["natoms"], np.asarray(jg.natoms))
    assert tg["cfl_overflow"] == bool(jg.cfl_overflow) is False
    assert float(tg["eabs"]) == pytest.approx(float(jg.eabs), rel=TOL)

    # the stored FD index rode every rebin with its atom
    ids_a, fa = _by_id(np.asarray(jcarry[0].ids), np.asarray(jcarry[2]))
    ids_b, fb = _by_id(tcarry[0].ids.numpy(), tcarry[2].numpy())
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(fa, fb)


def test_fused_md_step_matches_jax(setup):
    jscene, jeam, tscene, team = setup
    jstep, jcl = j_fused.make_fused_step(jscene, jeam, DT)
    jstep = jax.jit(jstep)
    counters = StepCounters()
    tstep, tcl = t_fused.make_fused_step(tscene, team, DT,
                                         counters=counters)
    for _ in range(NSTEPS):
        jcl, _ = jstep(jcl)
        tcl, _ = tstep(tcl)
    assert counters.rebins >= 1, "the run must exercise an in-loop rebin"
    _assert_same_atoms(jcl, tcl)


def test_fused_md_step_split_matches_jax(setup):
    """engine="split" (K10/K11's plain versions over rolled views) against
    imd_tpu's split step (eam_r_pass/eam_f_pass in interpret mode)."""
    jscene, jeam, tscene, team = setup
    jstep, jcl = j_fused.make_fused_step(jscene, jeam, DT, engine="split")
    jstep = jax.jit(jstep)
    counters = StepCounters()
    tstep, tcl = t_fused.make_fused_step(tscene, team, DT, engine="split",
                                         counters=counters)
    for _ in range(NSTEPS):
        jcl, _ = jstep(jcl)
        tcl, _ = tstep(tcl)
    assert counters.rebins >= 1, "the run must exercise an in-loop rebin"
    _assert_same_atoms(jcl, tcl)


TTM_CFG = TTMConfig(enabled=True, fd_nx=4, fd_min_atoms=8)


def _run_port(tscene, team, engine, ttm, ntypes=1, nsteps=NSTEPS):
    """``nsteps`` of the port's fused step; returns (final carry,
    counters)."""
    counters = StepCounters()
    if not ttm:
        step, cl = t_fused.make_fused_step(tscene, team, DT, engine=engine,
                                           ntypes=ntypes, counters=counters)
        for _ in range(nsteps):
            cl, _ = step(cl)
        return (cl,), counters
    tp = t_ttm.make_params(TTM_CFG, tscene.grid.box, 5.0)
    step, cl = t_fused.make_fused_ttm_step(tscene, team, DT, tp, FEGEos(),
                                           LASER, engine=engine,
                                           ntypes=ntypes, counters=counters)
    carry = (cl, t_ttm.make_grid(tp, torch.float64, device="cpu"),
             torch.full((cl.mass.numel(),), -1, dtype=torch.int32), 0)
    for _ in range(nsteps):
        carry = step(*carry)
    return carry, counters


@pytest.fixture(scope="module")
def win_runs(setup):
    """The port's "win" runs, pure MD and TTM-coupled, by ``ttm``."""
    _, _, tscene, team = setup
    return {ttm: _run_port(tscene, team, "win", ttm) for ttm in (False, True)}


@pytest.mark.parametrize("ttm,engine", [(False, "ab"), (True, "split"),
                                        (True, "ab")])
def test_engine_matches_the_windowed_engine(setup, win_runs, ttm, engine):
    """The rolled-view engines move the same atoms as "win" to 1e-10, with
    the same rebins, and for the TTM step the same electron grid."""
    _, _, tscene, team = setup
    want, c_want = win_runs[ttm]
    got, c_got = _run_port(tscene, team, engine, ttm)
    assert c_got.rebins == c_want.rebins >= 1
    assert int(got[0].overflow) == int(want[0].overflow) == 0
    for f in ("xi", "mom"):
        ids_a, va = _by_id(want[0].ids.numpy(),
                           np.moveaxis(getattr(want[0], f).numpy(), 1, -1))
        ids_b, vb = _by_id(got[0].ids.numpy(),
                           np.moveaxis(getattr(got[0], f).numpy(), 1, -1))
        np.testing.assert_array_equal(ids_a, ids_b)
        np.testing.assert_allclose(vb, va, rtol=0, atol=1e-10, err_msg=f)
    if ttm:
        np.testing.assert_allclose(got[1].temp.numpy(),
                                   want[1].temp.numpy(), rtol=1e-10)
        assert torch.equal(got[1].natoms, want[1].natoms)


def test_two_species_split_runs_the_alloy_kernels(setup):
    """ntypes=2 takes K6/K7 whatever the engine: "split" equals "win"."""
    _, _, tscene, _ = setup
    typ = torch.where(tscene.mask, tscene.id % 2, -1).to(torch.int32)
    scene2 = tscene.replace(type=typ)
    eam2 = t_pot.eam_to_fastpoly(flagship.eam_tables(2, dtype=np.float64),
                                 deg=12)
    want, _ = _run_port(scene2, eam2, "win", True, ntypes=2, nsteps=3)
    got, _ = _run_port(scene2, eam2, "split", True, ntypes=2, nsteps=3)
    for f in ("xi", "mom", "typ", "ids"):
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert torch.equal(got[1].temp, want[1].temp)


def _flagship_inputs(jscene, tscene):
    """The NRB tables of the hot scene's x-max layer (imd_tpu's, and the
    port's copy) and the TMM laser of a pulse that peaks inside the run
    (t0 6 fs, sigma 5 fs, 1e17 W/m^2)."""
    from imd_tpu.config import TMMConfig
    from imd_tpu.models import nrb as j_nrb
    from imd_tpu.models import tmm as j_tmm
    jst = j_nrb.init_nrb(jscene, 4.05, nrb_k=2.0, pbc=(1, 1, 1))
    jtmm = j_tmm.make_tmm_params(TMMConfig(
        enabled=True, lambda_m=800e-9, I0=1e17, t0_s=6e-15,
        sigma_t_s=5e-15), jnp.float64)
    return (jst, convert.nrb_state_from_jax(jst, device="cpu"), jtmm,
            convert.tmm_params_from_jax(jtmm, device="cpu"))


FLAG_STEPS = 6


def test_flagship_fused_ttm_step_matches_jax(setup):
    """The flagship step: TTM with the implicit solver (10 substeps) and
    the TMM laser, NRB momenta on the x-max layer, against imd_tpu's fused
    step for 6 steps through the pulse (atoms by id to 1e-9, the grid to
    1e-9 relative); the boundary atoms keep their set momenta through the
    rebins, and the step reads nothing but the skin check to the host."""
    jscene, jeam, tscene, team = setup
    jst, tst, jtmm, ttmm = _flagship_inputs(jscene, tscene)
    cfg = TTMConfig(enabled=True, fd_nx=4, fd_min_atoms=8,
                    solver="implicit", n_sub=10)
    jtp = j_ttm.make_params(cfg, jscene.grid.box, 5.0, jnp.float64)
    tp = convert.from_ttm_params(jtp)
    jstep, jcl = j_fused.make_fused_ttm_step(
        jscene, jeam, DT, jtp, j_eos.FEGEos(), None, nrb_state=jst,
        tmm_params=jtmm)
    jstep = jax.jit(jstep)
    jgrid0 = j_ttm.make_grid(jtp, jnp.float64)
    jcarry = (jcl, jgrid0, -jnp.ones(jcl.mass.size, jnp.int32),
              jnp.zeros((), jnp.int32))
    counters = StepCounters()
    tstep, tcl = t_fused.make_fused_ttm_step(
        tscene, team, DT, tp, FEGEos(), None, nrb_state=tst,
        tmm_params=ttmm, counters=counters)
    tcarry = (tcl, convert.from_ttm_grid(jgrid0, device="cpu"),
              torch.full((tcl.mass.numel(),), -1, dtype=torch.int32), 0)
    for _ in range(FLAG_STEPS):
        jcarry = jstep(*jcarry)
        tcarry = tstep(*tcarry)
    assert counters.rebins >= 1, "the run must exercise an in-loop rebin"
    assert counters.host_syncs == FLAG_STEPS
    assert counters.cfl_substeps == 10 * FLAG_STEPS
    _assert_same_atoms(jcarry[0], tcarry[0])
    jg, tg = jcarry[1], convert.to_numpy(tcarry[1])
    for name in ("temp", "U", "xi", "md_temp", "dens", "source"):
        np.testing.assert_allclose(tg[name], np.asarray(getattr(jg, name)),
                                   rtol=TOL, atol=1e-300, err_msg=name)
    assert float(tg["eabs"]) == pytest.approx(float(jg.eabs), rel=TOL)
    assert float(tg["eabs"]) > 0.0


def test_flagship_fused_md_step_matches_jax(setup):
    """The pure-MD twin with NRB: 6 steps against imd_tpu's, atoms by id to
    1e-9."""
    jscene, jeam, tscene, team = setup
    jst, tst, _, _ = _flagship_inputs(jscene, tscene)
    jstep, jcl = j_fused.make_fused_step(jscene, jeam, DT, nrb_state=jst)
    jstep = jax.jit(jstep)
    tstep, tcl = t_fused.make_fused_step(tscene, team, DT, nrb_state=tst)
    for _ in range(FLAG_STEPS):
        jcl, _ = jstep(jcl)
        tcl, _ = tstep(tcl)
    _assert_same_atoms(jcl, tcl)


def test_unported_arguments_raise(setup):
    """mesh raises (one device only); FDTD together with TMM, COLRAD or
    VLAT raises ValueError, as imd_tpu's driver rule; calc_ttm refuses an
    unknown solver.  VLAT, ELECPRESS, COLRAD and FDTD themselves run
    (tests/test_torch_ttm_physics_driver.py)."""
    _, _, tscene, team = setup
    with pytest.raises(NotImplementedError, match="mesh"):
        t_fused.make_fused_step(tscene, team, DT, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        t_fused.make_fused_ttm_step(tscene, team, DT, None, FEGEos(), LASER,
                                    mesh=object())
    with pytest.raises(ValueError, match="engine"):
        t_fused.make_fused_step(tscene, team, DT, engine="pallas2")
    for name in ("tmm_params", "colrad", "vlat"):
        with pytest.raises(ValueError, match=f"exclusive.*{name}"):
            t_fused.make_fused_ttm_step(tscene, team, DT, None, FEGEos(),
                                        LASER, fdtd_params=object(),
                                        **{name: object()})
    tp = t_ttm.TTMParams(nx=4, fd_h_x=1.0, fd_vol=1.0, neigh_vol=1.0,
                         atomic_mass=26.9815, atomic_z=13.0, fd_min_atoms=1,
                         solver="crank")
    with pytest.raises(ValueError, match="solver"):
        t_ttm.calc_ttm(None, None, tp, None, None, None, DT, None)
