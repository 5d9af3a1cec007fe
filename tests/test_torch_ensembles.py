"""The general step's thermostats and relaxation, port vs imd_tpu on the
CPU in float64: ``mik``, ``berendsen`` and ``nvt`` (integrate.py),
``fire_update`` and ``check_relaxed`` (relax.py) and the driver's
``_ramp_temperature``.

Each case builds one scene from NumPy seeds through ``make_scene`` in both
packages (fcc 5x4x4 Al jittered by 0.1 A, 1 A of vacuum along x, random
momenta and forces; grid (3,2,2)), runs the function in both and holds
positions, momenta, the step's sums and the carried scalars to 1e-12.  No
kernel and no driver run here.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu import integrate as j_int
from imd_tpu import relax as j_relax
from imd_tpu.config import SimConfig as JSimConfig
from imd_tpu.ops import geometry as j_geom
from imd_tpu.scene import make_scene as j_make_scene
from imd_tpu.simulation import Simulation as JSimulation
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import convert, integrate, relax
from imd_tpu_torch import simulation as t_sim
from imd_tpu_torch.config import SimConfig as TSimConfig
from imd_tpu_torch.config import parse_param_text
from imd_tpu_torch.scene import make_scene as t_make_scene

TOL = 1e-12
STATS = ("tot_kin_energy", "fnorm", "pnorm", "pxf", "ekin_new")


def _scenes(mom_scale=1.0, seed=4):
    """The same scene in both packages: (imd_tpu's, the port's)."""
    pos, _, diag = fcc((5, 4, 4), 4.05)
    pos = pos + 0.3 + np.random.default_rng(3).normal(scale=0.1,
                                                      size=pos.shape)
    box = j_geom.Box.create([diag[0] + 1.0, 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], pbc=(0, 1, 1),
                            dtype=jnp.float64)
    jgrid = j_geom.choose_grid(box, 5.0, skin=0.5, n_atoms=len(pos),
                               capacity=48)
    rng = np.random.default_rng(seed)
    kw = dict(mom=mom_scale * rng.normal(size=pos.shape),
              mass=np.full(len(pos), 26.9815), id=rng.permutation(len(pos)))
    force = rng.normal(size=pos.shape)
    js = j_make_scene(jgrid, pos, dtype=jnp.float64, **kw)
    ts = t_make_scene(convert.from_grid(jgrid), pos, dtype=torch.float64,
                      device="cpu", **kw)
    # the forces in the slots make_scene chose (the same in both)
    fj = j_make_scene(jgrid, pos, mom=force, dtype=jnp.float64).mom
    js = js.replace(force=fj)
    ts = ts.replace(force=torch.tensor(np.asarray(fj)))
    assert jgrid.dims == (3, 2, 2)
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    return js, ts


def _same(ts, js, tstats=None, jstats=None):
    for f in ("pos", "mom"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=TOL,
                                   atol=TOL, err_msg=f)
    if tstats is not None:
        for f in STATS:
            np.testing.assert_allclose(getattr(tstats, f).item(),
                                       float(getattr(jstats, f)), rtol=TOL,
                                       err_msg=f)


def _params(**kw):
    """The same knobs for both packages."""
    jp = j_int.IntegratorParams(**{k: jnp.float64(v) for k, v in kw.items()})
    return jp, integrate.IntegratorParams(**kw)


def test_mik_matches_jax():
    """The leapfrog with p zeroed where p.F < 0: some atoms are reset."""
    js, ts = _scenes()
    jp, tp = _params(timestep=0.1, viscous_friction=0.01)
    jn, jstats = j_int.mik(js, jp)
    tn, tstats = integrate.mik(ts, tp)
    _same(tn, jn, tstats, jstats)
    zeroed = (tn.mom == 0).all(-1) & tn.mask
    assert 0 < int(zeroed.sum()) < int(tn.mask.sum())


# (previous step's Ekin, tau_berendsen): cc^2 clipped at 2 (Ekin 0, a
# phase's first step), inside the clip, and clipped at 0.5 (too hot)
BER = {"start": (0.0, 0.2), "inside": (9.0, 20.0), "hot": (200.0, 0.2)}


@pytest.mark.parametrize("case", sorted(BER))
def test_berendsen_matches_jax(case):
    ekin_prev, tau = BER[case]
    js, ts = _scenes(mom_scale=0.5)
    nactive = float(3 * int(ts.mask.sum()))
    jp, tp = _params(timestep=0.1, temperature=0.05, tau_berendsen=tau)
    jn, jstats = j_int.berendsen(js, jp, nactive, jnp.float64(ekin_prev))
    tn, tstats = integrate.berendsen(
        ts, tp, nactive, torch.tensor(ekin_prev, dtype=torch.float64))
    _same(tn, jn, tstats, jstats)


@pytest.mark.parametrize("eta", [0.0, 0.3, -0.2])
def test_nvt_matches_jax(eta):
    """The half-implicit friction and eta's update from this step's
    time-centred Ekin."""
    js, ts = _scenes(mom_scale=0.5)
    nactive = float(3 * int(ts.mask.sum()))
    jp, tp = _params(timestep=0.1, temperature=0.05, isq_tau_eta=1 / 50.0 ** 2)
    jn, jstats, jeta = j_int.nvt(js, jp, nactive, jnp.float64(eta))
    tn, tstats, teta = integrate.nvt(
        ts, tp, nactive, torch.tensor(eta, dtype=torch.float64))
    _same(tn, jn, tstats, jstats)
    np.testing.assert_allclose(teta.item(), float(jeta), rtol=TOL, atol=TOL)
    assert teta.item() != eta


def _fire(cfg, timestep, mix, glok_int, n_pxf, j):
    """A FIRE state in one package (``j``: imd_tpu's)."""
    if j:
        return j_relax.FireState(timestep=jnp.float64(timestep),
                                 mix=jnp.float64(mix),
                                 glok_int=jnp.int32(glok_int),
                                 n_pxf=jnp.int32(n_pxf))
    st = relax.fire_init(timestep, cfg, torch.float64, "cpu")
    return dataclasses.replace(st, mix=torch.tensor(mix, dtype=torch.float64),
                               glok_int=torch.tensor(glok_int,
                                                     dtype=torch.int32),
                               n_pxf=torch.tensor(n_pxf, dtype=torch.int32))


# (FIRE state: glok_int, n_pxf; the step's pxf sign; knobs) -> what the
# update must do to the timestep
FIRE = {
    # P.F < 0: half a step back, momenta zeroed, dt shrinks, mix resets
    "uphill": (3, 2, -1.0, {}),
    # downhill before minsteps: dt stays, momenta mixed toward F
    "downhill": (3, 2, 1.0, {}),
    # downhill after minsteps with an uphill event seen: dt grows
    "grows": (6, 1, 1.0, {}),
    # ... but not past max_timestep
    "capped": (6, 1, 1.0, {"max_timestep": 0.105}),
    # no uphill event yet: dt stays (min_n_pxf 1)
    "no_pxf_yet": (9, 0, 1.0, {}),
    # the kinetic temperature above glok_ekin_threshold counts as uphill
    "ekin_threshold": (6, 1, 1.0, {"ekin_threshold": 1e-4}),
}


@pytest.mark.parametrize("case", sorted(FIRE))
def test_fire_update_matches_jax(case):
    glok_int, n_pxf, sign, knobs = FIRE[case]
    js, ts = _scenes(mom_scale=0.5)
    nactive = float(3 * int(ts.mask.sum()))
    jcfg = j_relax.FireConfig(**knobs)
    tcfg = relax.FireConfig(**knobs)
    jst = _fire(jcfg, 0.1, 0.08, glok_int, n_pxf, True)
    tst = _fire(tcfg, 0.1, 0.08, glok_int, n_pxf, False)
    jp, tp = _params(timestep=0.1)
    jn, jstats = j_int.nve(js, jp.replace(timestep=jst.timestep))
    tn, tstats = integrate.nve(ts, dataclasses.replace(
        tp, timestep=tst.timestep))
    _same(tn, jn, tstats, jstats)
    # the sign of P.F that the case asks for
    pxf = sign * abs(float(jstats.pxf))
    jstats = jstats.replace(pxf=jnp.float64(pxf))
    tstats = dataclasses.replace(tstats, pxf=torch.tensor(
        pxf, dtype=torch.float64))
    jn2, jst2 = j_relax.fire_update(jn, jstats, jst, jcfg, nactive)
    tn2, tst2 = relax.fire_update(tn, tstats, tst, tcfg, nactive)
    _same(tn2, jn2)
    for f in ("timestep", "mix", "glok_int", "n_pxf"):
        np.testing.assert_allclose(getattr(tst2, f).item(),
                                   float(getattr(jst2, f)), rtol=TOL,
                                   err_msg=f)
    dt = tst2.timestep.item()
    want = {"uphill": 0.05, "downhill": 0.1, "grows": 0.11,
            "capped": 0.105, "no_pxf_yet": 0.1, "ekin_threshold": 0.05}
    assert dt == pytest.approx(want[case], rel=1e-12)
    if want[case] == 0.05:
        assert bool((tn2.mom == 0).all())


# (fnorm, ekin, delta epot thresholds), each met or not on the scene below
RELAXED = {"fnorm_met": (2.0, 0.0, 0.0), "fnorm_not": (0.5, 0.0, 0.0),
           "ekin_met": (0.0, 0.1, 0.0), "ekin_not": (0.0, 1e-4, 0.0),
           "depot_met": (0.0, 0.0, 1e-3), "depot_not": (0.0, 0.0, 1e-6),
           "any_of_three": (0.5, 1e-4, 1e-3), "none_set": (0.0, 0.0, 0.0)}


@pytest.mark.parametrize("case", sorted(RELAXED))
def test_check_relaxed_matches_jax(case):
    js, ts = _scenes(mom_scale=0.5)
    nactive = float(3 * int(ts.mask.sum()))
    jp, tp = _params(timestep=0.1)
    _, jstats = j_int.nve(js, jp)
    _, tstats = integrate.nve(ts, tp)
    epot, epot_prev = -1000.0, -1000.1
    got = relax.check_relaxed(tstats, epot, epot_prev, nactive,
                              *RELAXED[case])
    want = j_relax.check_relaxed(jstats, epot, epot_prev, nactive,
                                 *RELAXED[case])
    assert got.dtype == torch.bool and bool(got) == bool(want)
    assert bool(got) == case.endswith(("_met", "three"))


RAMP = """ntypes 1
masses 26.9815
lj_epsilon 0.35
lj_sigma 2.62
starttemp 0.20
{tags}
"""


@pytest.mark.parametrize("tags", [
    "endtemp 0.01\nmaxsteps 2000", "endtemp 0.4\nmaxsteps 300",
    "maxsteps 100", "endtemp 0.2\nmaxsteps 100",
    "endtemp 0.01\nmaxsteps 0"], ids=["quench", "heat", "no_endtemp",
                                       "endtemp_equal", "no_maxsteps"])
def test_ramp_temperature_matches_jax(tags):
    """The target over the ABSOLUTE step / maxsteps (melt_quench's phase
    2 starts its ramp half way), clipped past maxsteps."""
    text = RAMP.format(tags=tags)
    jcfg = JSimConfig.from_params(parse_param_text(text))
    tcfg = TSimConfig.from_params(parse_param_text(text))
    jself = types.SimpleNamespace(cfg=jcfg, dtype=jnp.float64)
    tself = types.SimpleNamespace(cfg=tcfg)
    for step in (0, 1, 50, 150, 999, 1000, 1500, 2000, 2500):
        want = float(JSimulation._ramp_temperature(jself, jnp.int32(step)))
        got = t_sim.Simulation._ramp_temperature(tself, step)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=str(step))
