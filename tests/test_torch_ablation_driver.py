"""The flagship ablation example through both drivers, float64 on the CPU.

examples/ablation/ablation.imd miniaturized as tests/test_ablation_demo.py
does it (fcc 10 x 3 x 3 Al with 50% vacuum in front, TTM on 12 cells, the
TMM laser, the NRB rear boundary, FILTER every 7 steps, 14 steps), with
seeded NumPy velocities in place of ``do_maxwell 1`` (the packages draw
other random numbers) and three isolated vapour atoms beyond
``filter_min_x`` that FILTER deletes at step 7.  imd_tpu runs it through
``Simulation`` (engine "pallas": its fused loop, asserted; interpret mode),
the port through ``python -m imd_tpu_torch ... --device cpu --dtype
float64``.  ``.eng``, ``.laser`` (the TMM's I_t, refl and laser_active),
``.nrb`` and the checkpoints agree to 1e-9, ``.ttm`` to 2e-6 (its %e keeps
7 digits; values below 1e-12 of their column's largest are rounding
noise), and the same ids are gone.  Then the port alone: the same file
with ``filter_int 0`` (FILTER enabled without a cadence, which imd_tpu
runs off its fused loop, ROADMAP C6) gives exactly the outputs of the
file without the ``filter_*`` tags; and an NVE run with NRB restarted
with ``-r`` continues the straight run, its boundary tables read from the
``.nrb`` file.
"""

import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.io.chkpt import ChkptData, read_chkpt, write_chkpt
from imd_tpu.models.potential import analytic_eam, write_pot_table
from imd_tpu.simulation import Simulation as JSimulation
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import __main__ as cli

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-9
ALAT = 4.05
VAPOUR = [[4.0, 1.0, 1.0], [10.0, 7.0, 5.0], [16.0, 2.0, 9.0]]


def _mini_text(out: str) -> str:
    """The shipped ablation.imd with test_ablation_demo's smaller numbers,
    the start velocities from the .chkpt, ``outfiles out`` and the cell
    capacity fixed at 24 (as run1m's file does), where the film's
    compression would otherwise grow it from 16 in the first block."""
    text = (REPO / "examples" / "ablation" / "ablation.imd").read_text()
    for a, b in (("ttmdimx 48", "ttmdimx 12"),
                 ("maxsteps 2000", "maxsteps 14"),
                 ("filter_min_x 150.0", "filter_min_x 20.0"),
                 ("filter_int 50", "filter_int 7"),
                 ("eng_int 20", "eng_int 7"),
                 ("ttm_int 100", "ttm_int 7"),
                 ("checkpt_int 1000", "checkpt_int 7"),
                 ("I0 2.0e17", "I0 5.0e17"),
                 ("laser_t_0 300e-15", "laser_t_0 60e-15"),
                 ("laser_sigma_t 100e-15", "laser_sigma_t 40e-15"),
                 ("do_maxwell 1", "do_maxwell 0"),
                 ("outfiles ablation", f"outfiles {out}")):
        assert a in text, a
        text = text.replace(a, b)
    return text + "cell_capacity 24\n"


@pytest.fixture(scope="module")
def demo_dir(tmp_path_factory):
    """Tables and start.chkpt: the film at the rear of a box twice its
    length (x open), 0.026 eV NumPy velocities, three vapour atoms (ids
    360-362) more than 6 A apart in front of x = 20."""
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("ablation")
    eam = analytic_eam(r_cut=5.0, r0=ALAT / math.sqrt(2.0), E_c=3.39)
    for name in ("pair", "rho", "embed"):
        write_pot_table(getattr(eam, name), str(d / f"{name}.pt"))
    pos, _, diag = fcc((10, 3, 3), ALAT)
    box_x = diag[0] * 2.0
    pos = pos + np.array([box_x - diag[0], 0.0, 0.0])
    pos[:, 0] = np.minimum(pos[:, 0], box_x - 1e-3)
    pos = np.vstack([pos, np.array(VAPOUR)])
    n = len(pos)
    vel = np.random.default_rng(3).normal(size=pos.shape) \
        * math.sqrt(0.026 / 26.9815)
    vel -= vel.mean(0)
    write_chkpt(str(d / "start.chkpt"), ChkptData(
        number=np.arange(n), type=np.zeros(n, int),
        mass=np.full(n, 26.9815), pos=pos, vel=vel, data=np.zeros((n, 1)),
        box_x=np.array([box_x, 0, 0]), box_y=np.array([0, diag[1], 0]),
        box_z=np.array([0, 0, diag[2]])), precision=17)
    return d


def _run_port(path):
    sims = []
    assert cli.main(["-p", str(path), "--device", "cpu", "--dtype",
                     "float64"],
                    on_phase=lambda s, st: sims.append((s, st))) == 0
    return sims[0]


def _by_number(path):
    d = read_chkpt(str(path))
    order = np.argsort(d.number)
    return {k: np.asarray(getattr(d, k))[order]
            for k in ("number", "type", "mass", "pos", "vel", "data")}


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def test_ablation_run_matches_jax(demo_dir):
    """The miniaturized ablation.imd through both drivers.  imd_tpu's run
    (interpret mode) is made here, in the one test that reads it."""
    d = demo_dir
    (d / "j.imd").write_text(_mini_text("j"))
    (d / "t.imd").write_text(_mini_text("t"))
    sim = JSimulation.from_param_file(str(d / "j.imd"), dtype=jnp.float64,
                                      engine="pallas")
    assert sim._fused_eligible()
    assert sim.tmm_params is not None and sim.nrb_state is not None
    sim.write_checkpoint(sim.run(), -1)
    tsim, state = _run_port(d / "t.imd")
    assert tsim.n_filter == 1 and tsim.counters.steps == state.step == 14

    # .eng: step 7 and 14, six columns
    want, got = np.loadtxt(d / "j.eng"), np.loadtxt(d / "t.eng")
    assert want.shape == got.shape == (2, 6)
    for k in range(6):
        _close(got[:, k], want[:, k], f".eng column {k}")
    # .laser: step t_fs I_t Eabs refl laser_active, from the TMM
    header = (d / "t.laser").read_text().splitlines()[0]
    assert header == (d / "j.laser").read_text().splitlines()[0]
    assert header.endswith("refl laser_active")
    want, got = np.loadtxt(d / "j.laser"), np.loadtxt(d / "t.laser")
    assert want.shape == got.shape == (2, 6)
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert np.isfinite(got).all() and got[1, 3] > got[0, 3] > 0.0
    # checkpoints, their .itr and .nrb
    for name in (".00001", ".00002", "-final"):
        want, got = _by_number(d / f"j{name}.chkpt"), \
            _by_number(d / f"t{name}.chkpt")
        for k in ("number", "type", "mass"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("pos", "vel", "data"):
            _close(got[k], want[k], f"{name} {k}")
        assert (d / f"t{name}.itr").read_text() \
            == (d / f"j{name}.itr").read_text()
        assert (d / f"t{name}.nrb").read_text() \
            == (d / f"j{name}.nrb").read_text()
    # FILTER deleted the vapour atoms at step 7, and only them
    n0 = 360 + len(VAPOUR)
    kept = _by_number(d / "t-final.chkpt")["number"]
    assert sorted(set(range(n0)) - set(kept.tolist())) == [360, 361, 362]
    assert len(_by_number(d / "t.00001.chkpt")["number"]) == n0
    # the electron grid
    # (per column; a cell that holds one vapour atom has T_i = 0 up to
    # rounding, ~1e-35 eV in imd_tpu, hence the floor at 1e-12 of the
    # column's largest value)
    for name in (".1.ttm", ".2.ttm", ".00002.ttm", "-final.ttm"):
        want, got = np.loadtxt(d / f"j{name}"), np.loadtxt(d / f"t{name}")
        for k in range(want.shape[1]):
            np.testing.assert_allclose(
                got[:, k], want[:, k], rtol=2e-6,
                atol=1e-12 * max(np.abs(want[:, k]).max(), 1e-300),
                err_msg=f"{name} column {k}")
    assert float(state.ttm_grid.temp.max()) > 0.1


def test_filter_int_0_runs_without_filter(demo_dir, tmp_path):
    """``filter_int 0`` enables FILTER but sets no cadence: the port runs
    the file on its fused loop with FILTER off, and every output equals
    the run of the same file without the filter_* tags (ROADMAP C6)."""
    for name in ("pair.pt", "rho.pt", "embed.pt", "start.chkpt"):
        (tmp_path / name).write_bytes((demo_dir / name).read_bytes())
    text = _mini_text("z").replace("filter_int 7", "filter_int 0")
    (tmp_path / "z.imd").write_text(text)
    lines = [ln for ln in _mini_text("n").splitlines()
             if not ln.startswith("filter_")]
    (tmp_path / "n.imd").write_text("\n".join(lines) + "\n")
    zsim, _ = _run_port(tmp_path / "z.imd")
    nsim, _ = _run_port(tmp_path / "n.imd")
    assert zsim.cfg.filter.enabled and not nsim.cfg.filter.enabled
    assert zsim.n_filter == nsim.n_filter == 0
    for ext in (".eng", ".laser", ".00002.chkpt", ".00002.nrb", ".2.ttm"):
        assert (tmp_path / f"z{ext}").read_bytes() \
            == (tmp_path / f"n{ext}").read_bytes(), ext
    assert len(_by_number(tmp_path / "z.00002.chkpt")["number"]) \
        == 360 + len(VAPOUR)


NVE_NRB = """coordname start.chkpt
outfiles {out}
ntypes 1
masses 26.9815
pbc_dirs 0 1 1
core_potential_file pair.pt
embedding_energy_file embed.pt
el_density_file rho.pt
do_maxwell 0
ensemble nve
timestep 0.1
maxsteps {steps}
eng_int 4
checkpt_int 4
cell_capacity 24
nrb_alat 4.05
nrb_k 5.0
"""


def test_nrb_restart_reads_the_nrb_file(demo_dir, tmp_path):
    """NRB under ensemble nve (make_fused_step with nrb_state): 4 steps,
    then ``-r 1`` on to step 8 continues the straight 8-step run's .eng
    (the checkpoint's 12 digits set the tolerance, 1e-9), and the restart
    takes its boundary tables from ``<outfiles>.00001.nrb`` (reference
    positions of the start lattice, not the moved atoms of step 4)."""
    for name in ("pair.pt", "rho.pt", "embed.pt", "start.chkpt"):
        (tmp_path / name).write_bytes((demo_dir / name).read_bytes())
    (tmp_path / "s.imd").write_text(NVE_NRB.format(out="s", steps=8))
    straight, _ = _run_port(tmp_path / "s.imd")
    (tmp_path / "r.imd").write_text(NVE_NRB.format(out="r", steps=4))
    _run_port(tmp_path / "r.imd")
    first = np.loadtxt(tmp_path / "r.eng", ndmin=2)
    (tmp_path / "r.imd").write_text(NVE_NRB.format(out="r", steps=8))
    sims = []
    assert cli.main(["-p", str(tmp_path / "r.imd"), "--device", "cpu",
                     "--dtype", "float64", "-r", "1"],
                    on_phase=lambda s, st: sims.append(s)) == 0
    got = np.concatenate([first, np.loadtxt(tmp_path / "r.eng", ndmin=2)])
    want = np.loadtxt(tmp_path / "s.eng")
    assert got.shape == want.shape == (2, 5)
    for k in range(5):
        _close(got[:, k], want[:, k], f".eng column {k}")
    st, ref = sims[0].nrb_state, straight.nrb_state
    assert torch.equal(st.bnd_id, ref.bnd_id) and len(st.bnd_id) == 18
    np.testing.assert_allclose(st.bnd_ref.numpy(), ref.bnd_ref.numpy(),
                               rtol=1e-10)
    # the layer detected anew at the restart would hold step 4's positions
    at4 = _by_number(tmp_path / "r.00001.chkpt")
    pos4 = at4["pos"][np.searchsorted(at4["number"], st.bnd_id.numpy())]
    assert np.abs(pos4 - st.bnd_ref.numpy()).max() > 1e-6
