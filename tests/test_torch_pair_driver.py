"""The general pair step through both drivers on the CPU in float64:
melt_quench's LJ (eps 0.35, sigma 2.62, r_cut 5.0, Al masses, timestep
0.1) on its 6x6x6 fcc box (864 atoms, grid (4,4,4), capacity 16) under
``ensemble nve``, 30 steps, .eng every 10, checkpoints every 15.

Both start from one .chkpt with seeded NumPy velocities of 0.4 eV
(``do_maxwell 0``: the two packages draw Maxwell momenta from different
generators).  The skin is 0.1 A so that the skin check fires (at the
default 0.4 A no atom moves 0.2 A in 40 steps from 0.2 eV); the first
rebins overflow the start capacity, and both drivers grow it to 24 and
retry the block.  imd_tpu runs ``Simulation(..., engine="pallas")``, its
TPU engine (B6 on the degree-12 fastpoly fit, interpret mode here); the
port runs ``python -m imd_tpu_torch ... --device cpu --dtype float64``.
The .eng, every checkpoint and .itr agree to 1e-9 (the sums run in
another order), and both count the same skin rebins.
"""

import math

import jax.numpy as jnp
import numpy as np
import torch

from imd_tpu.io.chkpt import ChkptData, read_chkpt, write_chkpt
from imd_tpu.simulation import Simulation as JSimulation
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import __main__ as cli

TOL = 1e-9

PARAMS = """coordname start.chkpt
outfiles {out}
ntypes 1
masses 26.9815
do_maxwell 0
lj_epsilon 0.35
lj_sigma 2.62
r_cut 5.0
timestep 0.1
ensemble nve
nbl_margin 0.1
eng_int 10
checkpt_int 15
maxsteps 30
"""


def _by_number(path):
    d = read_chkpt(str(path))
    order = np.argsort(d.number)
    return d, {k: np.asarray(getattr(d, k))[order]
               for k in ("number", "type", "mass", "pos", "vel", "data")}


def test_lj_nve_run_matches_jax(tmp_path):
    torch.set_num_threads(1)
    pos, _, diag = fcc((6, 6, 6), 4.05)
    n = len(pos)
    vel = np.random.default_rng(7).normal(size=pos.shape) \
        * math.sqrt(0.4 / 26.9815)
    vel -= vel.mean(0)
    write_chkpt(str(tmp_path / "start.chkpt"), ChkptData(
        number=np.arange(n), type=np.zeros(n, int), mass=np.full(n, 26.9815),
        pos=pos, vel=vel, data=np.zeros((n, 1)),
        box_x=np.array([diag[0], 0, 0]), box_y=np.array([0, diag[1], 0]),
        box_z=np.array([0, 0, diag[2]])), precision=17)
    (tmp_path / "j.imd").write_text(PARAMS.format(out="j"))
    (tmp_path / "t.imd").write_text(PARAMS.format(out="t"))

    jsim = JSimulation.from_param_file(str(tmp_path / "j.imd"),
                                       dtype=jnp.float64, engine="pallas")
    assert not jsim._fused_eligible() and jsim.pair_run is not None
    assert jsim.grid.dims == (4, 4, 4) and jsim.grid.capacity == 16
    jstate = jsim.run()
    jsim.write_checkpoint(jstate, -1)
    sims = []
    assert cli.main(["-p", str(tmp_path / "t.imd"), "--device", "cpu",
                     "--dtype", "float64"],
                    on_phase=lambda s, st: sims.append(s)) == 0
    tsim = sims[0]
    assert tsim.grid.dims == (4, 4, 4)
    assert tsim.grid.capacity == jsim.grid.capacity == 24
    assert tsim.nbl_count == int(jstate.nbl_count) >= 1
    assert tsim.step_count == 30 and tsim.counters.steps >= 30

    want = np.loadtxt(tmp_path / "j.eng")
    got = np.loadtxt(tmp_path / "t.eng")
    assert got.shape == want.shape == (3, 5)
    assert (tmp_path / "t.eng").read_text().splitlines()[0] \
        == (tmp_path / "j.eng").read_text().splitlines()[0]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
    period = np.asarray(diag, float)
    for name in (".00001", ".00002", "-final"):
        jd, j = _by_number(tmp_path / f"j{name}.chkpt")
        td, t = _by_number(tmp_path / f"t{name}.chkpt")
        assert td.columns == jd.columns == \
            "number type mass x y z vx vy vz Epot".split()
        for k in ("number", "type", "mass"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        d_pos = t["pos"] - j["pos"]
        t["pos"] = j["pos"] + d_pos - period * np.round(d_pos / period)
        for k in ("pos", "vel", "data"):
            np.testing.assert_allclose(t[k], j[k], rtol=0,
                                       atol=TOL * np.abs(j[k]).max(),
                                       err_msg=f"{name} {k}")
        assert (tmp_path / f"t{name}.itr").read_text() \
            == (tmp_path / f"j{name}.itr").read_text()
