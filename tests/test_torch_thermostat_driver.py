"""The general step's ensembles through both drivers, on the CPU in
float64: imd_tpu's ``python -m imd_tpu --engine pallas`` in process (its
TPU engines, interpret mode here) and the port's ``python -m imd_tpu_torch
--device cpu --dtype float64`` (the plain versions of K12, K4/K5, K8/K9).

Four files, each run once through both drivers by a module-scoped fixture
that one test reads:

- melt_quench miniaturized: its LJ on its 6x6x6 box from a .chkpt with
  0.4 eV NumPy velocities, ``nvt`` (steps 0-8), ``ber`` with the endtemp
  ramp (8-16: the ramp starts half way, over the absolute step; tau 0.5
  in place of 20 so that 8 steps quench, from 0.30 to 0.06 eV) and
  ``glok`` (16-40) with a force threshold that stops it at step 28 (the
  force norm per degree of freedom reads 13.7, 15.4 and 15.2 at the block
  ends 20, 24 and 28), .eng every 4 steps, a checkpoint every 8; a 0.1 A
  skin makes the first blocks' rebins overflow the start capacity, so
  both drivers grow it and retry;
- one-species EAM (fcc 5x4x4, analytic EAM, open x) under ``nvt`` on the
  general step (K4/K5), then ``nve`` on the fused loop (K1/K2);
- the same EAM under ``glok`` with ``fire_maxtimestep 1.5``: two uphill
  resets (steps 2 and 11) shrink FIRE's timestep, downhill runs grow it
  to the cap, and the force threshold 0.85 stops it at step 36 (the norm
  per degree of freedom reads 0.88, 1.10, 0.94, 0.91 and 0.81 at the
  block ends 20-36);
- two-species EAM (4/4/2 table columns) under ``ber`` with a ramp (K8/K9).

The .eng lines (an nvt phase has the ``eta*tau_eta`` column, a later phase
appends without it), every checkpoint and .itr and the relaxed-at step
agree to 1e-9 (the sums run in another order).
"""

import contextlib
import io
import math

import numpy as np
import pytest
import torch

from imd_tpu import __main__ as jcli
from imd_tpu.io.chkpt import ChkptData, read_chkpt, write_chkpt
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import __main__ as cli
from imd_tpu_torch.models.potential import analytic_eam, tile_columns, \
    write_pot_table

TOL = 1e-9
MASSES = (26.9815, 30.0)

MELT_QUENCH = """coordname start.chkpt
outfiles {out}
ntypes 1
masses 26.9815
do_maxwell 0
lj_epsilon 0.35
lj_sigma 2.62
r_cut 5.0
timestep 0.1
nbl_margin 0.1
eng_int 4
checkpt_int 8
ensemble nvt
starttemp 0.20
tau_eta 50.0
maxsteps 8

simulation 2
ensemble ber
starttemp 0.20
endtemp 0.01
tau_berendsen 0.5
maxsteps 16

simulation 3
ensemble glok
maxsteps 40
fire_incfac 1.1
fire_decfac 0.5
ekin_threshold 1e-8
fnorm_threshold 15.3
"""

EAM = """coordname start.chkpt
outfiles {out}
ntypes {nt}
masses {masses}
pbc_dirs 0 1 1
nbl_margin 0.5
cell_capacity 32
core_potential_file pair.pt
embedding_energy_file embed.pt
el_density_file rho.pt
do_maxwell 0
timestep 0.1
eng_int 4
checkpt_int 4
"""
EAM_NVT = """ensemble nvt
starttemp 0.05
tau_eta 20.0
maxsteps 8

simulation 2
ensemble nve
maxsteps 16
"""
EAM_GLOK = """ensemble glok
maxsteps 40
fire_maxtimestep 1.5
fnorm_threshold 0.85
"""
EAM_BER = """ensemble ber
starttemp 0.1
endtemp 0.02
tau_berendsen 10.0
maxsteps 12
"""


def _write_lj_start(d):
    """melt_quench's fcc 6x6x6, 0.4 eV NumPy velocities without drift."""
    pos, _, diag = fcc((6, 6, 6), 4.05)
    n = len(pos)
    vel = np.random.default_rng(7).normal(size=pos.shape) \
        * math.sqrt(0.4 / 26.9815)
    vel -= vel.mean(0)
    write_chkpt(str(d / "start.chkpt"), ChkptData(
        number=np.arange(n), type=np.zeros(n, int), mass=np.full(n, 26.9815),
        pos=pos, vel=vel, data=np.zeros((n, 1)),
        box_x=np.array([diag[0], 0, 0]), box_y=np.array([0, diag[1], 0]),
        box_z=np.array([0, 0, diag[2]])), precision=17)


def _write_eam_start(d, nt):
    """The analytic EAM's tables (with ``nt`` 2 scaled 4/4/2 columns, the
    density host-first) and fcc 5x4x4 0.5 A off the cell faces with one
    angstrom of vacuum along x, 0.1 eV NumPy velocities, random types."""
    eam = analytic_eam(r_cut=5.0, r0=2.864, E_c=3.39)
    if nt == 1:
        tabs = (eam.pair, eam.rho, eam.embed)
    else:
        tabs = (tile_columns(eam.pair, [1.0, 0.8, 0.8, 0.6]),
                tile_columns(eam.rho, [1.0, 0.7, 0.9, 0.5]),
                tile_columns(eam.embed, [1.0, 0.75]))
    for name, tab in zip(("pair", "rho", "embed"), tabs):
        write_pot_table(tab, str(d / f"{name}.pt"))
    pos, _, diag = fcc((5, 4, 4), 4.05)
    n = len(pos)
    rng = np.random.default_rng(7)
    typ = rng.integers(0, nt, n)
    mass = np.asarray(MASSES)[typ]
    vel = rng.normal(size=pos.shape) * np.sqrt(0.1 / mass)[:, None]
    vel -= (vel * mass[:, None]).sum(0) / mass.sum()
    write_chkpt(str(d / "start.chkpt"), ChkptData(
        number=np.arange(n), type=typ, mass=mass, pos=pos + 0.5, vel=vel,
        data=np.zeros((n, 1)), box_x=np.array([diag[0] + 1.0, 0, 0]),
        box_y=np.array([0, diag[1], 0]), box_z=np.array([0, 0, diag[2]])),
        precision=17)


def _run_both(d, text):
    """``text`` (with ``{out}``) through imd_tpu's CLI as j.imd and the
    port's as t.imd; returns (imd_tpu's stdout, the port's stdout, the
    port's Simulations by phase)."""
    torch.set_num_threads(1)
    for out in "jt":
        (d / f"{out}.imd").write_text(text.format(out=out))
    jout, tout = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jout):
        assert jcli.main(["-p", str(d / "j.imd"), "--engine", "pallas",
                          "--dtype", "float64"]) == 0
    sims = []
    with contextlib.redirect_stdout(tout):
        assert cli.main(["-p", str(d / "t.imd"), "--device", "cpu",
                         "--dtype", "float64"],
                        on_phase=lambda s, st: sims.append(s)) == 0
    return jout.getvalue(), tout.getvalue(), sims


def _eng_rows(path):
    """The .eng's header and rows (a later phase may append rows of
    another width: the nvt column belongs to the file's first phase)."""
    lines = path.read_text().splitlines()
    return lines[0], [np.array(line.split(), float) for line in lines[1:]]


def _same_eng(d):
    jh, want = _eng_rows(d / "j.eng")
    th, got = _eng_rows(d / "t.eng")
    assert th == jh and len(got) == len(want) > 0
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=f".eng row {k}")
    return jh, want


def _by_number(path):
    d = read_chkpt(str(path))
    order = np.argsort(d.number)
    return d, {k: np.asarray(getattr(d, k))[order]
               for k in ("number", "type", "mass", "pos", "vel", "data")}


def _same_checkpoints(d, period):
    """Every checkpoint and .itr of imd_tpu's run has the port's twin;
    positions compare modulo the periodic box lengths (0: open)."""
    names = sorted(p.name[1:-len(".chkpt")] for p in d.glob("j*.chkpt"))
    assert names and names == sorted(
        p.name[1:-len(".chkpt")] for p in d.glob("t*.chkpt"))
    p = np.asarray(period, float)
    for name in names:
        jd, want = _by_number(d / f"j{name}.chkpt")
        td, got = _by_number(d / f"t{name}.chkpt")
        assert td.columns == jd.columns, name
        for k in ("number", "type", "mass"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        dp = got["pos"] - want["pos"]
        got["pos"] = want["pos"] + dp - p * np.round(
            dp / np.where(p > 0, p, 1.0))
        for k in ("pos", "vel", "data"):
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=TOL * np.abs(want[k]).max(),
                                       err_msg=f"{name} {k}")
        assert (d / f"t{name}.itr").read_text() \
            == (d / f"j{name}.itr").read_text()
    return names


def _block_targets(sim, start: int):
    """(end step, the ramp's target at its last step) of each block of
    ``sim``'s phase, which began at global step ``start``."""
    ends = start + np.cumsum([b for b, _ in sim.block_seconds])
    return [(int(e), sim._ramp_temperature(int(e) - 1)) for e in ends]


def _relaxed_at(out):
    return [line for line in out.splitlines()
            if line.startswith("# relaxed at step")]


@pytest.fixture(scope="module")
def melt_quench(tmp_path_factory):
    d = tmp_path_factory.mktemp("melt_quench")
    _write_lj_start(d)
    return d, *_run_both(d, MELT_QUENCH)


def test_melt_quench_phases_match_jax(melt_quench):
    """nvt -> ber with the ramp -> glok: .eng (eta column in phase 1),
    checkpoints, the capacity growth and the relaxed-at step."""
    d, jout, tout, sims = melt_quench
    header, rows = _same_eng(d)
    assert header.split()[-1] == "eta*tau_eta"
    assert [len(r) for r in rows[:2]] == [6, 6] and len(rows[2]) == 5
    assert rows[0][5] != 0.0
    names = _same_checkpoints(d, fcc((6, 6, 6), 4.05)[2])
    assert names == ["-final", ".00001", ".00002", ".00003"]
    assert _relaxed_at(jout) == _relaxed_at(tout) == [
        "# relaxed at step 28"] and sims[2].relaxed_at == 28
    assert [s.ensemble for s in sims] == ["nvt", "ber", "glok"]
    assert sims[0].grid.capacity > 16 and sims[0].nbl_count >= 1
    # the ramp over the absolute step: phase 2 starts half way
    assert _block_targets(sims[1], sims[0].step_count) == [
        (12, pytest.approx(0.2 - 0.19 * 11 / 16)),
        (16, pytest.approx(0.2 - 0.19 * 15 / 16))]
    # the quenched liquid's global P.F stays positive: no uphill reset, so
    # FIRE's timestep stays (it grows only after one) and MIX decays
    fire = sims[2].fire
    assert int(fire.n_pxf) == 0 and int(fire.glok_int) == 12
    assert float(fire.timestep) == 0.1 and float(fire.mix) == \
        pytest.approx(0.1 * 0.99 ** 12)


@pytest.fixture(scope="module")
def eam_nvt(tmp_path_factory):
    d = tmp_path_factory.mktemp("eam_nvt")
    _write_eam_start(d, 1)
    return d, *_run_both(d, EAM.format(out="{out}", nt=1, masses=MASSES[0])
                         + EAM_NVT)


def test_eam_nvt_then_nve_across_the_handover(eam_nvt):
    """Phase 1 on the general step (K4/K5), phase 2 back on the fused loop
    (K1/K2) from the handed-over atoms."""
    d, _, _, sims = eam_nvt
    header, rows = _same_eng(d)
    assert header.split()[-1] == "eta*tau_eta"
    assert [len(r) for r in rows] == [6, 6, 5, 5]
    _same_checkpoints(d, (0.0, 4 * 4.05, 4 * 4.05))
    assert [s._fused_eligible() for s in sims] == [False, True]
    assert sims[0].n_observe == 0 and sims[1].n_observe == 2
    assert sims[0].counters.steps == 8


@pytest.fixture(scope="module")
def eam_glok(tmp_path_factory):
    d = tmp_path_factory.mktemp("eam_glok")
    _write_eam_start(d, 1)
    return d, *_run_both(d, EAM.format(out="{out}", nt=1, masses=MASSES[0])
                         + EAM_GLOK)


def test_eam_glok_matches_jax(eam_glok):
    """FIRE's resets, timestep adaptation and the relaxed-at step on K4/K5;
    the checkpoints carry K4's density (eam_rho)."""
    d, jout, tout, sims = eam_glok
    _same_eng(d)
    names = _same_checkpoints(d, (0.0, 4 * 4.05, 4 * 4.05))
    assert names[0] == "-final" and len(names) == 10
    assert read_chkpt(str(d / "t-final.chkpt")).columns[-1] == "eam_rho"
    assert _relaxed_at(jout) == _relaxed_at(tout) == [
        "# relaxed at step 36"] and sims[0].relaxed_at == 36
    fire = sims[0].fire
    assert int(fire.n_pxf) == 2 and float(fire.timestep) == \
        pytest.approx(0.15)


@pytest.fixture(scope="module")
def eam_ber(tmp_path_factory):
    d = tmp_path_factory.mktemp("eam_ber")
    _write_eam_start(d, 2)
    return d, *_run_both(d, EAM.format(
        out="{out}", nt=2, masses=" ".join(map(str, MASSES))) + EAM_BER)


def test_two_species_eam_ber_ramp_matches_jax(eam_ber):
    """K8/K9 on the general step under ber with the endtemp ramp; every
    atom keeps its type."""
    d, _, _, sims = eam_ber
    _same_eng(d)
    _same_checkpoints(d, (0.0, 4 * 4.05, 4 * 4.05))
    assert not sims[0]._fused_eligible()
    temps = [t for _, t in _block_targets(sims[0], 0)]
    assert temps == sorted(temps, reverse=True) and temps[-1] == \
        pytest.approx(0.1 - 0.08 * 11 / 12)
