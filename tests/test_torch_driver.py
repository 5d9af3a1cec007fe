"""The param-file driver, port vs imd_tpu, on the CPU.

One tiny EAM+TTM run drives both: fcc 5x4x4 Al read from a .chkpt with
seeded NumPy velocities (``do_maxwell 0``), tables from ``analytic_eam``,
the open x axis of the 1M-atom ablation geometry (``pbc_dirs 0 1 1``,
1 A of vacuum beyond the film), ``cell_capacity 32`` so both pick the
(3,2,2) grid, the Lambert-Beer laser, 8 steps with .eng, .chkpt and .ttm
every 4.  imd_tpu runs it through ``Simulation`` (engine "pallas", its
fused loop, in float64: interpret mode); the port through
``python -m imd_tpu_torch ... --device cpu --dtype float64``.  The .eng
columns and the final checkpoint agree to 1e-9 (the sums run in another
order).  Then: an NVE run stopped at step 4 and restarted with ``-r 1``
continues the straight run's .eng, and so does a two-phase file
(``simulation 2`` re-bins the atoms into a grid of another capacity); a
hot start whose rebin overflows the cell capacity grows the slot axis, or
re-grids, and retries the block with the same result as a run that never
overflowed; every unported setting raises NotImplementedError; the port's
config copy parses every example file as imd_tpu's does.
"""

import dataclasses
import math
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.config import SimConfig as JSimConfig
from imd_tpu.io.chkpt import ChkptData, read_chkpt, write_chkpt
from imd_tpu.models import potential as j_pot
from imd_tpu.models.potential import analytic_eam, write_pot_table
from imd_tpu.ops import forces_fast as j_ff
from imd_tpu.ops import geometry as j_geom
from imd_tpu.scene import grow_capacity as j_grow_capacity
from imd_tpu.scene import make_scene as j_make_scene
from imd_tpu.scene import rebin as j_rebin
from imd_tpu.simulation import Simulation as JSimulation
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import __main__ as cli
from imd_tpu_torch import convert
from imd_tpu_torch import scene as t_scene
from imd_tpu_torch import simulation as t_sim
from imd_tpu_torch.config import SimConfig as TSimConfig
from imd_tpu_torch.config import parse_param_text
from imd_tpu_torch.io import chkpt as t_chkpt
from imd_tpu_torch.models import potential as t_pot
from imd_tpu_torch.ops import forces_pallas as t_fp
from imd_tpu_torch.ops import geometry as t_geom

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-9

BASE = """coordname start.chkpt
outfiles {out}
ntypes 1
masses 26.9815
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
checkpt_int 4
ensemble {ens}
"""
TTM = """ttmdimx 6
fd_min_atoms 4
init_t_el 0.1
ttm_int 4
laser_rescale_mode 4
laser_sigma_e 0.05
laser_sigma_t 50
laser_t_0 100
laser_mu 0.01
"""


def _write_start(d, cells, shift, pad, ev):
    """start.chkpt: fcc Al ``cells`` shifted ``shift`` A off the cell
    faces, box_x ``pad`` A longer than the film (the open face), ``ev`` eV
    NumPy velocities without drift."""
    pos, _, diag = fcc(cells, 4.05)
    n = len(pos)
    vel = np.random.default_rng(7).normal(size=pos.shape) \
        * math.sqrt(ev / 26.9815)
    vel -= vel.mean(0)
    write_chkpt(str(d / "start.chkpt"), ChkptData(
        number=np.arange(n), type=np.zeros(n, int),
        mass=np.full(n, 26.9815), pos=pos + shift, vel=vel,
        data=np.zeros((n, 1)), box_x=np.array([diag[0] + pad, 0, 0]),
        box_y=np.array([0, diag[1], 0]), box_z=np.array([0, 0, diag[2]])),
        precision=17)


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    """Tables and a .chkpt start: fcc 5x4x4 0.5 A off the cell faces, one
    angstrom of vacuum, 0.1 eV."""
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("driver")
    eam = analytic_eam(r_cut=5.0, r0=2.864, E_c=3.39)
    for name in ("pair", "rho", "embed"):
        write_pot_table(getattr(eam, name), str(d / f"{name}.pt"))
    _write_start(d, (5, 4, 4), 0.5, 1.0, 0.1)
    return d


def _run(path, *args):
    """The port's CLI on the CPU in float64; returns the phases' Simulations."""
    sims = []
    assert cli.main(["-p", str(path), "--device", "cpu", "--dtype",
                     "float64", *args],
                    on_phase=lambda s, st: sims.append(s)) == 0
    return sims


def _by_number(path):
    d = read_chkpt(str(path))
    order = np.argsort(d.number)
    return d, {k: np.asarray(getattr(d, k))[order]
               for k in ("number", "type", "mass", "pos", "vel", "data")}


def _same_eng(got_path, want_path):
    want = np.loadtxt(want_path)
    got = np.loadtxt(got_path)
    assert want.shape == got.shape == (2, 6)
    header = got_path.read_text().splitlines()[0]
    assert header == want_path.read_text().splitlines()[0]
    for k, name in enumerate(header.lstrip("# ").split()):
        np.testing.assert_allclose(got[:, k], want[:, k], rtol=TOL,
                                   atol=TOL * np.abs(want[:, k]).max(),
                                   err_msg=name)


def _same_checkpoint(d, name, want_base="j", got_base="t", period=None):
    """``period``: the box lengths of the periodic axes (0 where open);
    positions then compare modulo them, as runs that rebin at other steps
    wrap an atom at other steps."""
    sep = "" if name.startswith("-") else "."
    jd, want = _by_number(d / f"{want_base}{sep}{name}.chkpt")
    td, got = _by_number(d / f"{got_base}{sep}{name}.chkpt")
    assert td.columns == jd.columns
    assert [list(v) for v in (td.box_x, td.box_y, td.box_z)] \
        == [list(v) for v in (jd.box_x, jd.box_y, jd.box_z)]
    for k in ("number", "type", "mass"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if period is not None:
        p = np.asarray(period)
        d_pos = got["pos"] - want["pos"]
        got["pos"] = want["pos"] + d_pos - p * np.round(
            d_pos / np.where(p > 0, p, 1.0))
    for k in ("pos", "vel", "data"):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=TOL * np.abs(want[k]).max(),
                                   err_msg=f"{name} {k}")
    assert (d / f"{got_base}{sep}{name}.itr").read_text() \
        == (d / f"{want_base}{sep}{name}.itr").read_text()


def test_ttm_run_matches_jax(rundir):
    """The TTM run through both drivers.  imd_tpu's run (~30 s, interpret
    mode) is made here, in the one test that reads it, so that no other
    pytest-xdist worker repeats it."""
    d = rundir
    (d / "j.imd").write_text(BASE.format(out="j", ens="ttm") + TTM)
    (d / "t.imd").write_text(BASE.format(out="t", ens="ttm") + TTM)
    sim = JSimulation.from_param_file(str(d / "j.imd"), dtype=jnp.float64,
                                      engine="pallas")
    assert sim._fused_eligible() and sim.grid.dims == (3, 2, 2)
    sim.write_checkpoint(sim.run(), -1)
    runs = []
    assert cli.main(["-p", str(d / "t.imd"), "--device", "cpu",
                     "--dtype", "float64"],
                    on_phase=lambda s, st: runs.append((s, st))) == 0

    _same_eng(d / "t.eng", d / "j.eng")
    for name in ("00001", "00002", "-final"):
        _same_checkpoint(d, name)
    for name in (".1.ttm", ".2.ttm", ".00002.ttm", "-final.ttm"):
        # %e keeps 7 digits
        np.testing.assert_allclose(np.loadtxt(d / f"t{name}"),
                                   np.loadtxt(d / f"j{name}"), rtol=2e-6,
                                   atol=1e-300, err_msg=name)
    np.testing.assert_allclose(np.loadtxt(d / "t.laser"),
                               np.loadtxt(d / "j.laser"), rtol=TOL,
                               equal_nan=True)
    tsim, state = runs[0]
    # observe() (K4/K5, their plain versions on the CPU) ran at steps 4
    # and 8, and every atom survived
    assert tsim.n_observe == 2 and state.step == 8
    assert tsim.counters.steps == 8
    assert t_sim.n_atoms(state.scene) == 320


@pytest.fixture(scope="module")
def nve_straight(rundir):
    """The straight 8-step NVE run ``s`` that the restart and the two-phase
    runs must reproduce."""
    (rundir / "s.imd").write_text(BASE.format(out="s", ens="nve"))
    _run(rundir / "s.imd")
    return np.loadtxt(rundir / "s.eng")


def _same_rows(got, want):
    assert got.shape == want.shape == (2, 5)
    for k in range(5):
        np.testing.assert_allclose(got[:, k], want[:, k], rtol=TOL,
                                   atol=TOL * np.abs(want[:, k]).max())


def test_nve_restart_continues_the_eng(rundir, nve_straight):
    """4 steps, then -r 1 on to maxsteps 8, gives the straight run's
    .eng lines (the checkpoint's 12 digits set the tolerance)."""
    (rundir / "r.imd").write_text(BASE.format(out="r", ens="nve")
                                  .replace("maxsteps 8", "maxsteps 4"))
    _run(rundir / "r.imd")
    first = np.loadtxt(rundir / "r.eng", ndmin=2)
    (rundir / "r.imd").write_text(BASE.format(out="r", ens="nve"))
    _run(rundir / "r.imd", "-r", "1")
    second = np.loadtxt(rundir / "r.eng", ndmin=2)
    _same_rows(np.concatenate([first, second]), nve_straight)


def test_two_phase_file_continues_the_run(rundir, nve_straight):
    """``simulation 2`` with maxsteps 8 and cell_capacity 40 after a
    4-step phase 1: phase 2 re-bins phase 1's atoms into its own grid
    (adopt_scene), appends to the .eng and ends where the straight run
    does."""
    (rundir / "p.imd").write_text(
        BASE.format(out="p", ens="nve").replace("maxsteps 8", "maxsteps 4")
        + "simulation 2\nmaxsteps 8\ncell_capacity 40\n")
    sims = _run(rundir / "p.imd")
    assert [s.grid.capacity for s in sims] == [32, 40]
    assert [s.step_count for s in sims] == [4, 8]
    _same_rows(np.loadtxt(rundir / "p.eng"), nve_straight)
    for name in ("00002", "-final"):
        _same_checkpoint(rundir, name, want_base="s", got_base="p")


def test_capacity_over_32_deviates_from_imd_tpu_xla_engine():
    """ROADMAP C4, recorded: above capacity 32 imd_tpu's CLI leaves its
    fused Pallas loop for the XLA engine on degree-24 Chebyshev fits
    (imd_tpu/simulation.py:394-398, 429-439); the port keeps the fused
    loop on the degree-12 fastpoly.  One capacity-40 state of the driver
    tests' film (fcc 5x4x4, jittered 0.1 A from a seed, open x with 1 A
    of vacuum, the analytic EAM tables in float64), both ways: the port's
    K4/K5 plain versions against imd_tpu's compute_eam_forces_fast (run
    eagerly: jitted it compiles for ~30 s here).  Measured: max|dF| /
    max|F| = 0.7530 (max|F| 13.77 eV/A), total epot -2565.974 vs
    -2540.884 eV, -0.0784 eV per atom.  The Chebyshev fit meets the
    all-pairs oracle on the raw tables to 2.5e-5 of max|F|: the gap is
    the degree-12 fit's (the same fit imd_tpu's Pallas engine runs below
    capacity 32; ROADMAP C2).  Bounds: 0.8 and 0.1 eV per atom."""
    torch.set_num_threads(1)
    pos, _, diag = fcc((5, 4, 4), 4.05)
    pos = pos + np.random.default_rng(3).normal(scale=0.1, size=pos.shape)
    box = j_geom.Box.create([diag[0] + 1.0, 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], pbc=(0, 1, 1),
                            dtype=jnp.float64)
    grid = j_geom.with_capacity(j_geom.choose_grid(
        box, 5.0, skin=0.5, n_atoms=len(pos)), 40)
    jscene = j_make_scene(grid, pos + 0.5, mass=np.full(len(pos), 26.9815),
                          dtype=jnp.float64)
    assert int(jscene.overflow) == 0 and grid.capacity == 40
    tables = analytic_eam(r_cut=5.0, r0=4.05 / math.sqrt(2.0), E_c=3.39,
                          dtype=jnp.float64)
    want = j_ff.compute_eam_forces_fast(
        jscene, j_pot.eam_to_chebyshev(tables, deg=24), 1)
    got = t_fp.compute_eam_forces_pallas(
        convert.from_scene(jscene, device="cpu"),
        t_pot.eam_to_fastpoly(convert.from_eam(tables)))
    m = np.asarray(jscene.mask)
    F_want = np.asarray(want.force)[m]
    dF = np.abs(got.force.numpy()[m] - F_want).max() / np.abs(F_want).max()
    gap = (got.epot.numpy()[m].sum() - np.asarray(want.epot)[m].sum()) \
        / m.sum()
    assert dF < 0.8, dF
    assert abs(gap) < 0.1, gap


@pytest.fixture(scope="module")
def hotdir(rundir, tmp_path_factory):
    """A 3 eV start on fcc 6x4x4 whose film fills box_x (0.3 A off the
    faces): every (4,2,2) cell holds 24 atoms at the start and atoms cross
    cell faces within the 8 steps.  Holds the run ``a`` at capacity 48,
    which never overflows."""
    d = tmp_path_factory.mktemp("hot")
    for name in ("pair.pt", "rho.pt", "embed.pt"):
        shutil.copy(rundir / name, d / name)
    _write_start(d, (6, 4, 4), 0.3, 0.0, 3.0)
    (d / "a.imd").write_text(BASE.format(out="a", ens="nve")
                             .replace("cell_capacity 32", "cell_capacity 48"))
    assert [s.grid.capacity for s in _run(d / "a.imd")] == [48]
    return d


@pytest.mark.parametrize("cap, message", [
    (24, "# cell overflow: growing capacity 24 -> 32 and retrying the "
         "block"),
    (26, "# density re-grid: (4, 2, 2) cap 26 -> (4, 2, 2) cap 32 "
         "(384 atoms)")], ids=["grow", "regrid"])
def test_overflow_grows_and_retries_the_block(hotdir, capsys, cap,
                                              message):
    """A rebin overflows the start capacity: the driver grows the slot
    axis (24 -> 32), or past REGRID_CAPACITY re-derives the grid for the
    current density (26 -> 40 asks for a re-grid, which fits 32), and
    retries the block from the pre-block state.  The .eng and every
    checkpoint equal those of the run that never overflowed."""
    name = f"c{cap}"
    (hotdir / f"{name}.imd").write_text(
        BASE.format(out=name, ens="nve")
        .replace("cell_capacity 32", f"cell_capacity {cap}"))
    capsys.readouterr()
    sims = _run(hotdir / f"{name}.imd")
    out = capsys.readouterr().out
    assert message in out and "setup overflow" not in out
    assert sims[0].grid.dims == (4, 2, 2) and sims[0].grid.capacity == 32
    want = np.loadtxt(hotdir / "a.eng")
    got = np.loadtxt(hotdir / f"{name}.eng")
    assert got.shape == want.shape == (2, 5)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)
    period = [0.0, 16.2, 16.2]      # pbc_dirs 0 1 1, fcc 6x4x4 at 4.05
    for ck in ("00001", "00002", "-final"):
        _same_checkpoint(hotdir, ck, want_base="a", got_base=name,
                         period=period)


def test_scene_rebin_and_grow_capacity_match_jax():
    """The Scene helpers of the grow-and-retry and the phase handover:
    ``grow_capacity`` pads as imd_tpu's does, the host ``rebin`` into
    another grid bins as imd_tpu's traced one, and the re-grid's search
    (``optimize_grid_dims`` under a capacity cap) picks the same grid."""
    pos, _, diag = fcc((6, 4, 4), 4.05)
    pos = pos + 0.3 + np.random.default_rng(11).normal(scale=0.4,
                                                        size=pos.shape)
    n = len(pos)
    rng = np.random.default_rng(12)
    kw = dict(mom=rng.normal(size=(n, 3)), mass=np.full(n, 26.9815),
              id=rng.permutation(n))
    jbox = j_geom.Box.create([diag[0], 0, 0], [0, diag[1], 0],
                             [0, 0, diag[2]], pbc=(0, 1, 1),
                             dtype=jnp.float64)
    jgrid = j_geom.choose_grid(jbox, 5.0, skin=0.5, n_atoms=n, capacity=40)
    jscene = j_make_scene(jgrid, pos, dtype=jnp.float64, **kw)
    tscene = convert.from_scene(jscene, device="cpu")
    fields = ("pos", "mom", "mass", "type", "vtype", "id", "nbl_ref_pos")

    def same(t, j):
        assert t.grid.dims == j.grid.dims
        assert t.grid.capacity == j.grid.capacity
        for f in fields:
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)),
                                          err_msg=f)
        assert int(t.overflow) == int(j.overflow)

    same(t_scene.grow_capacity(tscene, 48), j_grow_capacity(jscene, 48))
    # the in-loop rebin of a scene whose atoms left their cells
    moved = jscene.replace(pos=jnp.where(jscene.mask[..., None],
                                         jscene.pos + 1.5, 0.0))
    same(t_scene.rebin(convert.from_scene(moved, device="cpu")),
         jax.jit(j_rebin)(moved))       # eager: ~4x the compile time
    # into another grid (handover, re-grid): imd_tpu bins the flat atoms
    jgrid2 = j_geom.CellGrid(box=jbox, dims=(3, 2, 2), capacity=48,
                             cutoff=5.0, skin=0.5)
    same(t_scene.rebin(tscene, convert.from_grid(jgrid2)),
         j_make_scene(jgrid2, np.asarray(jscene.pos)[np.asarray(
             jscene.mask)], dtype=jnp.float64,
             **{k: np.asarray(getattr(jscene, f))[np.asarray(jscene.mask)]
                for k, f in (("mom", "mom"), ("mass", "mass"),
                             ("id", "id"))}))
    tbox = convert.from_grid(jgrid).box
    for cap in (32, 40):
        assert t_geom.optimize_grid_dims(
            tbox, 5.0, 0.5, pos, dtype=np.float64, headroom_slots=2,
            max_capacity=cap) == j_geom.optimize_grid_dims(
            jbox, 5.0, 0.5, pos, dtype=np.float64, headroom_slots=2,
            max_capacity=cap)


def test_stop_file_ends_the_run_with_a_checkpoint(rundir, tmp_path):
    """A `stop` file in the run directory ends the run at the next block
    boundary with a checkpoint named by the step (check_stop,
    imd_main_3d.c:1938), as in imd_tpu's run_fused."""
    for name in ("pair.pt", "rho.pt", "embed.pt", "start.chkpt"):
        shutil.copy(rundir / name, tmp_path / name)
    (tmp_path / "x.imd").write_text(BASE.format(out="x", ens="nve"))
    (tmp_path / "stop").write_text("")
    sims = _run(tmp_path / "x.imd")
    assert not (tmp_path / "stop").exists()
    assert sims[0].step_count == 4
    assert (tmp_path / "x.00004.chkpt").exists()
    assert np.loadtxt(tmp_path / "x.eng", ndmin=2).shape == (1, 5)


UNPORTED = {
    "ntypes": ("ntypes 5\nmasses 26.98 26.98 26.98 26.98 26.98\n", "A9"),
    "asympot": ("ntypes 2\nmasses 26.98 26.98\nasympot 1\n", "A9"),
    # two species run (K12-mt), but not on columns that end apart (C10):
    # r_cut defaults to 2.5 sigma per pair
    "pair_unequal_ends": ("ntypes 2\nmasses 26.98 26.98\nlj_epsilon 0.35 "
                          "0.3 0.4\nlj_sigma 2.62 2.5 2.7\n", "A9b"),
    "pair_unequal_r_cut": ("ntypes 2\nmasses 26.98 26.98\nlj_epsilon 0.35 "
                           "0.3 0.4\nlj_sigma 2.62 2.62 2.62\nr_cut 5.0 4.5 "
                           "5.0\n", "A9b"),
    # ensemble cg runs the general step: no TTM there, and no quasistatic
    # loading driver (imd_tpu warns and relaxes without them)
    "cg_ttm": ("ensemble cg\nttmdimx 4\ninit_t_el 0.03\n", "A9b"),
    "cg_lindef": ("ensemble cg\nlindef_int 4\nlindef_x 0.01 0 0\n",
                  "A9c"),
    "pair_ttm": ("ensemble ttm\nlj_epsilon 0.35\nlj_sigma 2.62\n", "A9b"),
    "stiweb": ("stiweb_a 1.0\n", "A9"),
    "ensemble_lang": ("ensemble lang\n", "A9c"),
    "shock": ("shock_mode 1\n", "A9"),
    # the flagship physics runs on the fused EAM loop; the general step
    # of a pair potential carries none of it
    "tmm": ("lj_epsilon 0.35\nlj_sigma 2.62\ntmm\nlambda 800e-9\n"
            "I0 2e17\nlaser_t_0 300e-15\nlaser_sigma_t 100e-15\n", "A9b"),
    "nrb": ("lj_epsilon 0.35\nlj_sigma 2.62\nnrb_alat 4.05\nnrb_k 5.0\n",
            "A9b"),
    "filter": ("lj_epsilon 0.35\nlj_sigma 2.62\nfilter_int 4\n"
               "filter_min_x 1.0\n", "A9b"),
    # nor does an EAM set's general step (a thermostat, a ramp)
    "eam_nvt_nrb": ("ensemble nvt\nnrb_alat 4.05\nnrb_k 5.0\n", "A9b"),
    "eam_ber_filter": ("ensemble ber\nfilter_int 4\nfilter_min_x 1.0\n",
                       "A9b"),
    "eam_ramp_nrb": ("starttemp 0.1\nendtemp 0.01\nnrb_alat 4.05\n"
                     "nrb_k 5.0\n", "A9b"),
    "eam_nvt_ttm": ("ensemble nvt\nttmdimx 4\ninit_t_el 0.03\n", "A9b"),
    # the virtual lattice, COLRAD and the (2-D) FDTD on the 3-D TTM
    "vlattice": ("ensemble ttm\nvlatdim 4\nttmdimy 2\n", "A7"),
    "colrad_3d": ("ensemble ttm\ncolrad\nttmdimz 2\n", "A7"),
    "fdtd_3d": ("ensemble ttm\nfdtd\nlambda 800e-9\nI0 1e16\n"
                "laser_t_0 50e-15\nlaser_sigma_t 20e-15\nttmdimy 2\n", "A7"),
    "ttm_3d": ("ensemble ttm\nttmdimy 2\n", "A7"),
    "implicit": ("ensemble ttm\nttm_solver implicit\nlj_epsilon 0.35\n"
                 "lj_sigma 2.62\n", "A9b"),
    "cpu_dim": ("cpu_dim 2 1 1\n", "A11"),
    "socket_int": ("socket_int 4\n", "A6"),
    "lb_frequency": ("lb_frequency 4\n", "A11"),
    "hc_int": ("hc_int 4\n", "A9c"),
    "nmoldyn_int": ("nmoldyn_int 4\n", "A6"),
    "dsf_int": ("dsf_int 4\n", "A6"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_settings_raise(name):
    extra, item = UNPORTED[name]
    text = BASE.format(out="u", ens="nve") + extra
    cfg = TSimConfig.from_params(parse_param_text(text))
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        t_sim.Simulation(cfg, device="cpu")


def test_ttm_restart_and_eos_tables_raise(rundir, tmp_path):
    """A TTM restart and the tabulated EOS are ported: ``-r`` with no such
    checkpoint raises, and so does a malformed EOS table (RuntimeError, as
    imd_tpu's _select_eos)."""
    (tmp_path / "u.imd").write_text(BASE.format(out="u", ens="ttm") + TTM)
    with pytest.raises(SystemExit, match="restart 7"):
        cli.main(["-p", str(tmp_path / "u.imd"), "-r", "7", "--device",
                  "cpu"])
    (tmp_path / "eos").mkdir()
    for name in ("EOS_cve_from_r_te.txt", "EOS_ee_from_r_tesqrt.txt"):
        (tmp_path / "eos" / name).write_text("0\n")
    for name in ("pair.pt", "rho.pt", "embed.pt", "start.chkpt"):
        shutil.copy(rundir / name, tmp_path / name)
    cfg = TSimConfig.from_params(parse_param_text(
        BASE.format(out="u", ens="ttm") + TTM + "eos_dir eos\n"))
    with pytest.raises(RuntimeError, match="EOS table load failed"):
        t_sim.Simulation(cfg, workdir=str(tmp_path), device="cpu")


@pytest.mark.parametrize("binary", [False, True], ids=["ascii", "binary"])
def test_chkpt_files_cross_read(tmp_path, binary):
    """A checkpoint written by either package reads back the same in the
    other (ASCII at 17 digits, binary little-endian doubles)."""
    rng = np.random.default_rng(5)
    n = 40
    d = ChkptData(number=np.arange(n)[::-1].copy(),
                  type=rng.integers(0, 2, n), mass=np.full(n, 26.9815),
                  pos=rng.normal(size=(n, 3)), vel=rng.normal(size=(n, 3)),
                  data=rng.normal(size=(n, 2)),
                  columns="number type mass x y z vx vy vz Epot "
                          "eam_rho".split(),
                  box_x=np.array([9.0, 0, 0]), box_y=np.array([0, 8.0, 0]),
                  box_z=np.array([0, 0, 7.0]))
    kw = dict(binary=binary, double=True, precision=17)
    write_chkpt(str(tmp_path / "j.chkpt"), d, **kw)
    t_chkpt.write_chkpt(str(tmp_path / "t.chkpt"), d, **kw)
    for name in ("j", "t"):
        for read in (read_chkpt, t_chkpt.read_chkpt):
            got = read(str(tmp_path / f"{name}.chkpt"))
            for k in ("number", "type", "mass", "pos", "vel", "data",
                      "box_x", "box_y", "box_z"):
                np.testing.assert_array_equal(getattr(got, k),
                                              getattr(d, k), err_msg=k)
            assert got.columns == d.columns


def test_pot_tables_read_and_write_like_jax(rundir, tmp_path):
    """Format-2 tables (written by imd_tpu) and format-1 tables read to the
    same PotTable in both packages; the port's writer round-trips a
    format-2 table (format 1 keeps samples past a column's last nonzero
    value, which format 2 does not store)."""
    r2 = np.linspace(4.0, 25.0, 50)
    (tmp_path / "f1.pt").write_text(
        "#F 1 1\n#E\n" + "".join(f"{a:.17g} {np.exp(-a) - np.exp(-25):.17g}"
                                   f"\n" for a in r2))
    for path in (rundir / "pair.pt", rundir / "embed.pt", tmp_path / "f1.pt"):
        want = j_pot.read_pot_table(str(path), 1, True, jnp.float64)
        got = t_pot.read_pot_table(str(path), 1, True, np.float64)
        t_pot.write_pot_table(got, str(tmp_path / "w.pt"))
        again = t_pot.read_pot_table(str(tmp_path / "w.pt"), 1, True,
                                     np.float64)
        for k in ("table", "begin", "end", "step", "invstep", "length"):
            np.testing.assert_array_equal(getattr(got, k),
                                          np.asarray(getattr(want, k)),
                                          err_msg=f"{path.name} {k}")
            if path.name != "f1.pt":
                np.testing.assert_allclose(getattr(again, k),
                                           getattr(got, k), rtol=1e-15,
                                           err_msg=f"{path.name} {k}")


EXAMPLES = sorted(str(p.relative_to(REPO))
                  for p in REPO.glob("examples/**/*.imd"))


@pytest.mark.parametrize("path", EXAMPLES)
def test_config_copy_parses_examples_like_jax(path):
    text = (REPO / path).read_text()
    for phase in range(1, cli.count_phases(text) + 1):
        want = JSimConfig.from_file(str(REPO / path), phase)
        got = TSimConfig.from_file(str(REPO / path), phase)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config_copy_is_the_jax_module():
    """config.py is copied whole: below its header the text is imd_tpu's."""
    jtext = (REPO / "imd_tpu" / "config.py").read_text()
    ttext = (REPO / "imd_tpu_torch" / "config.py").read_text()
    assert ttext.endswith(jtext[3:])
    assert os.path.getsize(REPO / "imd_tpu_torch" / "config.py") \
        > os.path.getsize(REPO / "imd_tpu" / "config.py")
