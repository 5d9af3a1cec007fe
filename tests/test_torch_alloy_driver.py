"""The alloy slice as a whole: one ``ntypes 2`` EAM+TTM parameter file
through both drivers, on the CPU in float64.

fcc 5x4x4 read from a .chkpt with random types (0/1), two masses and
seeded NumPy velocities; the three EAM table files hold 4 / 4 / 2 columns
scaled from the analytic EAM, the density file in the reference's
host-first order with columns that depend on source AND host, so
``read_eam``'s transpose matters; open x axis, ``cell_capacity 32`` so both
pick the (3,2,2) grid, Lambert-Beer laser, 8 steps with .eng every 4 and
a .chkpt and .ttm at the end.  imd_tpu runs it through ``Simulation``
(engine "pallas": eam_kernels_win_split_mt in the fused loop, eam_kernels_cl_mt in observe,
interpret mode); the port through ``python -m imd_tpu_torch --device cpu
--dtype float64`` (the plain versions of K6/K7 and K8/K9).  The .eng
columns, the checkpoints with each atom's type, and the .ttm files agree
to 1e-9 (the sums run in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.io.chkpt import read_chkpt
from imd_tpu.simulation import Simulation as JSimulation
from imd_tpu_torch import __main__ as cli
from imd_tpu_torch import simulation as t_sim
from imd_tpu_torch.config import SimConfig, parse_param_text
from imd_tpu_torch.io.chkpt import ChkptData, write_chkpt
from imd_tpu_torch.models import potential as t_pot
from imd_tpu_torch.utils.generate import fcc

TOL = 1e-9
MASSES = (26.9815, 30.0)

PARAMS = """coordname start.chkpt
outfiles {out}
ntypes 2
masses 26.9815 30.0
pbc_dirs 0 1 1
nbl_margin 0.5
cell_capacity 32
core_potential_file pair.pt
embedding_energy_file embed.pt
el_density_file rho.pt
do_maxwell 0
timestep 0.1
maxsteps 8
eng_int 4
checkpt_int 8
ensemble ttm
ttmdimx 6
fd_min_atoms 4
init_t_el 0.1
ttm_int 8
laser_rescale_mode 4
laser_sigma_e 0.05
laser_sigma_t 50
laser_t_0 100
laser_mu 0.01
"""


def _write_inputs(d):
    """Tables and start.chkpt; returns the types by atom number."""
    eam = t_pot.analytic_eam(r_cut=5.0, r0=2.864, E_c=3.39)
    t_pot.write_pot_table(t_pot.tile_columns(eam.pair, [1.0, 0.8, 0.8, 0.6]),
                          str(d / "pair.pt"))
    # file order host*2 + source: the density at host h from source s
    t_pot.write_pot_table(t_pot.tile_columns(eam.rho, [1.0, 0.7, 0.9, 0.5]),
                          str(d / "rho.pt"))
    t_pot.write_pot_table(t_pot.tile_columns(eam.embed, [1.0, 0.75]),
                          str(d / "embed.pt"))
    pos, _, diag = fcc((5, 4, 4), 4.05)
    n = len(pos)
    rng = np.random.default_rng(7)
    typ = rng.integers(0, 2, n)
    mass = np.asarray(MASSES)[typ]
    vel = rng.normal(size=pos.shape) * np.sqrt(0.1 / mass)[:, None]
    vel -= (vel * mass[:, None]).sum(0) / mass.sum()
    write_chkpt(str(d / "start.chkpt"), ChkptData(
        number=np.arange(n), type=typ, mass=mass, pos=pos + 0.5, vel=vel,
        data=np.zeros((n, 1)), box_x=np.array([diag[0] + 1.0, 0, 0]),
        box_y=np.array([0, diag[1], 0]), box_z=np.array([0, 0, diag[2]])),
        precision=17)
    return typ


def _by_number(path):
    d = read_chkpt(str(path))
    order = np.argsort(d.number)
    return d, {k: np.asarray(getattr(d, k))[order]
               for k in ("number", "type", "mass", "pos", "vel", "data")}


def test_ntypes2_ttm_run_matches_jax(tmp_path):
    """imd_tpu's run (interpret mode) is made here, in the one test that
    reads it."""
    torch.set_num_threads(1)
    d = tmp_path
    typ = _write_inputs(d)
    for out in "jt":
        (d / f"{out}.imd").write_text(PARAMS.format(out=out))
    sim = JSimulation.from_param_file(str(d / "j.imd"), dtype=jnp.float64,
                                      engine="pallas")
    assert sim._fused_eligible() and sim.grid.dims == (3, 2, 2)
    sim.write_checkpoint(sim.run(), -1)
    runs = []
    assert cli.main(["-p", str(d / "t.imd"), "--device", "cpu",
                     "--dtype", "float64"],
                    on_phase=lambda s, st: runs.append((s, st))) == 0

    want, got = np.loadtxt(d / "j.eng"), np.loadtxt(d / "t.eng")
    assert want.shape == got.shape == (2, 6)
    assert (d / "t.eng").read_text().splitlines()[0] \
        == (d / "j.eng").read_text().splitlines()[0]
    for k in range(6):
        np.testing.assert_allclose(got[:, k], want[:, k], rtol=TOL,
                                   atol=TOL * np.abs(want[:, k]).max(),
                                   err_msg=f".eng column {k}")
    for name in (".00001", "-final"):
        jd, jw = _by_number(d / f"j{name}.chkpt")
        td, tg = _by_number(d / f"t{name}.chkpt")
        assert td.columns == jd.columns
        for k in ("number", "type", "mass"):
            np.testing.assert_array_equal(tg[k], jw[k], err_msg=k)
        np.testing.assert_array_equal(tg["type"], typ)
        for k in ("pos", "vel", "data"):
            np.testing.assert_allclose(tg[k], jw[k], rtol=0,
                                       atol=TOL * np.abs(jw[k]).max(),
                                       err_msg=f"{name} {k}")
        assert (d / f"t{name}.itr").read_text() \
            == (d / f"j{name}.itr").read_text()
    for name in (".1.ttm", ".00001.ttm", "-final.ttm"):
        # %e keeps 7 digits
        np.testing.assert_allclose(np.loadtxt(d / f"t{name}"),
                                   np.loadtxt(d / f"j{name}"), rtol=2e-6,
                                   atol=1e-300, err_msg=name)
    tsim, state = runs[0]
    assert tsim.n_observe == 2 and state.step == 8
    assert t_sim.n_atoms(state.scene) == 320
    # both species are there and the type decides the physics: the two
    # species' mean host densities differ
    rho = np.loadtxt(d / "t-final.chkpt", comments="#")[:, -1]
    t_fin = np.loadtxt(d / "t-final.chkpt", comments="#")[:, 1].astype(int)
    assert abs(rho[t_fin == 0].mean() - rho[t_fin == 1].mean()) > 0.1


def test_setfl_nelem_must_equal_ntypes(tmp_path):
    """A DYNAMO file by its suffix: nelem 1 under ntypes 2 raises
    (imd_tpu/simulation.py:194)."""
    _write_inputs(tmp_path)
    nrho, nr = 20, 30
    body = "\n".join(f"{v:.6e}" for v in np.linspace(0.0, 1.0, nrho + 2 * nr))
    (tmp_path / "al.eam.alloy").write_text(
        f"a\nb\nc\n1 Al\n{nrho} 0.5 {nr} 0.18 5.0\n13 26.98 4.05 fcc\n"
        + body + "\n")
    cfg = SimConfig.from_params(parse_param_text(
        PARAMS.format(out="u").replace("pair.pt", "al.eam.alloy")))
    with pytest.raises(ValueError, match="1 element.s. but ntypes=2"):
        t_sim.Simulation(cfg, workdir=str(tmp_path), device="cpu")


def test_nve_alloy_run_keeps_types_and_momentum(tmp_path):
    """The pure-MD fused step with ntypes 2 (K6/K7's plain versions) over 8
    steps: each atom keeps its type, and the total momentum stays zero,
    which the two-sided density terms dF_i rho'(t_j,t_i) + dF_j
    rho'(t_i,t_j) must pair up for with host-dependent densities."""
    torch.set_num_threads(1)
    typ = _write_inputs(tmp_path)
    text = PARAMS.format(out="n").split("ensemble ttm")[0] + "ensemble nve\n"
    (tmp_path / "n.imd").write_text(text)
    assert cli.main(["-p", str(tmp_path / "n.imd"), "--device", "cpu",
                     "--dtype", "float64"]) == 0
    eng = np.loadtxt(tmp_path / "n.eng")
    assert eng.shape == (2, 5) and np.isfinite(eng).all()
    _, fin = _by_number(tmp_path / "n-final.chkpt")
    np.testing.assert_array_equal(fin["type"], typ)
    mom = fin["vel"] * fin["mass"][:, None]
    assert np.abs(mom.sum(0)).max() < 1e-9 * np.abs(mom).sum()
    start = read_chkpt(str(tmp_path / "start.chkpt"))
    vel0 = start.vel[np.argsort(start.number)]
    assert np.abs(fin["vel"] - vel0).max() > 0.01
