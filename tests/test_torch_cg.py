"""``ensemble cg`` and the typed pair engine through the drivers, port vs
imd_tpu on the CPU in float64.

``relax.cg_relax`` as a function: a perturbed two-species LJ crystal
(tests/test_torch_pair_mt.py's periodic input, 0.1 A of jitter, the
binary model's fit; imd_tpu's force call ``compute_pair_forces_fast``, the
port's B6 with K12-mt's plain version) and a perturbed EAM crystal (fcc
5x4x4 Al, 0.1 A, open x; the analytic EAM fitted to degree 12 at float64,
imd_tpu's ``compute_eam_forces_fast`` against K4/K5's plain versions), with
``restart_every`` 1 and 50, 3 iterations: positions, the energy trace and
the final sum F.F to 1e-12, and 2 force calls an iteration plus 2.
imd_tpu's ``cg_relax`` runs under ``jax.disable_jit`` (its scan would
compile for seconds to run for less).

The drivers, each run once by a module-scoped fixture:

- examples/binary_lj/binary_lj.imd on an L1_2 box of 5^3 cells (500
  atoms) from a .chkpt with 0.2 eV NumPy velocities: nvt (steps 0-8), ber
  with the endtemp ramp (8-16, tau 0.5), cg (16-40, .eng every 4, its
  force threshold 3.5 met at step 36: sqrt(F.F / 3N) reads 5.59, 4.10,
  3.79, 3.29 at the block ends 24-36), skin 0.1 A.  The reference is
  imd_tpu's ``Simulation(cfg, fast=False, engine="xla")`` phase by phase
  as its CLI runs them, with its ``pair`` replaced here by
  ``to_fastpoly(pair, vcap=50.0)`` at float64 (``_select_engine`` makes
  that fit for its TPU engine, simulation.py:431; at float64 its
  coefficients equal the host tuple the port's kernels bake), so that its
  oracle ``compute_pair_forces`` evaluates the typed fit; the port runs
  ``python -m imd_tpu_torch --device cpu --dtype float64`` (K12-mt's
  plain version).
- an EAM crystal (tests/test_torch_thermostat_driver.py's tables, fcc
  5x4x4, open x, seeded 0.1 A displacements) under ``ensemble cg`` for 12
  iterations with one species (K4/K5) and with two (K8/K9), through
  ``python -m imd_tpu --engine pallas`` (interpret mode) and the port's
  CLI.

The .eng rows, every checkpoint and .itr and the relaxed-at step agree to
1e-9 (the sums run in another order).
"""

import contextlib
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu import relax as j_relax
from imd_tpu.config import SimConfig as JSimConfig
from imd_tpu.config import parse_param_text as j_parse
from imd_tpu.io.chkpt import ChkptData, read_chkpt, write_chkpt
from imd_tpu.models import potential as j_pot
from imd_tpu.ops import forces_fast as j_ff
from imd_tpu.ops import geometry as j_geom
from imd_tpu.scene import make_scene as j_make_scene
from imd_tpu.simulation import Simulation as JSimulation
from imd_tpu.utils.generate import fcc, l12
from imd_tpu_torch import __main__ as cli
from imd_tpu_torch import convert, relax
from imd_tpu_torch.ops import forces_pallas as t_fp
from test_torch_pair_mt import typed_fit, typed_scene
from test_torch_thermostat_driver import (EAM, MASSES, _by_number,
                                          _relaxed_at, _run_both,
                                          _same_checkpoints, _same_eng,
                                          _write_eam_start)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-12
CG_STEPS = 3

# examples/binary_lj/binary_lj.imd cut to a miniature
BINARY = (("coordname _l12", "coordname start.chkpt\ndo_maxwell 0"),
          ("box_param 8 8 8", "box_param 5 5 5"),
          ("eng_int 25", "eng_int 4"),
          ("checkpt_int 1000", "checkpt_int 8\nnbl_margin 0.1"),
          ("maxsteps 1000", "maxsteps 8"), ("maxsteps 2000", "maxsteps 16"),
          ("maxsteps 3000", "maxsteps 40"),
          ("tau_berendsen 20.0", "tau_berendsen 0.5"),
          ("fnorm_threshold 1e-4", "fnorm_threshold 3.5"))
EAM_CG = """ensemble cg
maxsteps 12
"""


def _lj_case():
    js = typed_scene((1, 1, 1), 2, jitter=0.1)
    jpot = typed_fit(2)
    tpot = convert.from_pot(jpot)
    return (js, lambda s: j_ff.compute_pair_forces_fast(s, jpot, 2),
            lambda s: t_fp.compute_pair_forces_pallas(s, tpot, 2))


def _eam_case():
    pos, _, diag = fcc((5, 4, 4), 4.05)
    pos = pos + 0.3 + np.random.default_rng(5).normal(scale=0.1,
                                                      size=pos.shape)
    box = j_geom.Box.create([diag[0] + 1.0, 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], pbc=(0, 1, 1),
                            dtype=jnp.float64)
    grid = j_geom.choose_grid(box, 5.0, skin=0.5, n_atoms=len(pos),
                              capacity=48)
    js = j_make_scene(grid, pos, dtype=jnp.float64,
                      mass=np.full(len(pos), 26.9815))
    e = j_pot.analytic_eam(r_cut=5.0, r0=2.864, E_c=3.39)
    f64 = jnp.float64
    fit = j_pot.EAMPotential(
        pair=j_pot.to_fastpoly(e.pair, 12, dtype=f64),
        rho=j_pot.to_fastpoly(e.rho, 12, dtype=f64),
        embed=j_pot.to_fastpoly(e.embed, 12, vcap=1e9, dtype=f64))
    tfit = convert.from_eam(fit)
    return (js, lambda s: j_ff.compute_eam_forces_fast(s, fit, 1),
            lambda s: t_fp.compute_eam_forces_pallas(s, tfit))


@pytest.mark.parametrize("restart_every", [1, 50])
@pytest.mark.parametrize("case", ["lj2", "eam"])
def test_cg_relax_matches_jax(case, restart_every):
    torch.set_num_threads(1)
    js, jforce, tforce = {"lj2": _lj_case, "eam": _eam_case}[case]()
    with jax.disable_jit():
        jscene, jep, jfn = j_relax.cg_relax(js, jforce, CG_STEPS,
                                            restart_every=restart_every)
    calls = []

    def counted(s):
        calls.append(1)
        return tforce(s)
    tscene, tep, tfn = relax.cg_relax(convert.from_scene(js, device="cpu"),
                                      counted, CG_STEPS,
                                      restart_every=restart_every)
    assert len(calls) == 2 * CG_STEPS + 2
    np.testing.assert_allclose(tscene.pos.numpy(), np.asarray(jscene.pos),
                               rtol=0, atol=TOL * np.abs(jscene.pos).max())
    for f in ("force", "epot"):
        want = np.asarray(getattr(jscene, f))
        np.testing.assert_allclose(getattr(tscene, f).numpy(), want,
                                   rtol=0, atol=TOL * np.abs(want).max(),
                                   err_msg=f)
    np.testing.assert_allclose(tep.numpy(), np.asarray(jep), rtol=TOL)
    np.testing.assert_allclose(tfn.item(), float(jfn), rtol=TOL)
    assert np.all(np.diff(np.asarray(jep)) < 0)


@pytest.fixture(scope="module")
def binary_lj(tmp_path_factory):
    """The binary LJ miniature through imd_tpu's typed oracle run and the
    port's CLI: (dir, the port's Simulations by phase, relaxed-at lines
    of both)."""
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("binary_lj")
    text = (REPO / "examples" / "binary_lj" / "binary_lj.imd").read_text()
    for old, new in BINARY:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    pos, typ, diag = l12((5, 5, 5), 3.705)
    n = len(pos)
    vel = np.random.default_rng(7).normal(size=pos.shape) \
        * np.sqrt(0.2 / 26.9815)
    vel -= vel.mean(0)
    write_chkpt(str(d / "start.chkpt"), ChkptData(
        number=np.arange(n), type=np.asarray(typ), mass=np.full(n, 26.9815),
        pos=pos, vel=vel, data=np.zeros((n, 1)),
        box_x=np.array([diag[0], 0, 0]), box_y=np.array([0, diag[1], 0]),
        box_z=np.array([0, 0, diag[2]])), precision=17)
    for out in "jt":
        (d / f"{out}.imd").write_text(
            text.replace("outfiles binary_lj", f"outfiles {out}"))
    # imd_tpu's CLI loop (imd_tpu/__main__.py:99-146) on its oracle engine
    # with the typed fit in place of the table
    jout, tout = io.StringIO(), io.StringIO()
    prev, step = None, 0
    with contextlib.redirect_stdout(jout):
        for phase in (1, 2, 3):
            cfg = JSimConfig.from_params(j_parse((d / "j.imd").read_text(),
                                                 phase=phase))
            cfg.simulation_phase = phase
            cfg.validate()
            sim = JSimulation(cfg, workdir=str(d), dtype=jnp.float64,
                              fast=False, engine="xla")
            sim.pair = j_pot.to_fastpoly(sim.pair, vcap=50.0,
                                         dtype=jnp.float64)
            if prev is not None:
                sim.adopt_scene(prev)
                sim.step_count = step
            state = sim.run()
            if phase == 3:
                sim.write_checkpoint(state, -1)
            prev, step = sim.scene, sim.step_count
    sims = []
    with contextlib.redirect_stdout(tout):
        assert cli.main(["-p", str(d / "t.imd"), "--device", "cpu",
                         "--dtype", "float64"],
                        on_phase=lambda s, st: sims.append(s)) == 0
    return d, sims, _relaxed_at(jout.getvalue()), \
        _relaxed_at(tout.getvalue())


def test_binary_lj_nvt_ber_cg_matches_jax(binary_lj):
    """nvt -> ber with the ramp -> cg on K12-mt's plain version against
    imd_tpu's typed oracle: .eng (cg lines: temperature and pressure 0),
    every checkpoint, the relaxed-at step."""
    d, sims, jrel, trel = binary_lj
    header, rows = _same_eng(d)
    assert header.split()[-1] == "eta*tau_eta"
    assert [len(r) for r in rows] == [6, 6] + [5] * 7
    assert all(r[2] == 0.0 and r[3] == 0.0 for r in rows[4:])
    energies = [r[1] for r in rows[4:]]
    assert energies == sorted(energies, reverse=True)
    names = _same_checkpoints(d, l12((5, 5, 5), 3.705)[2])
    assert names == ["-final", ".00001", ".00002", ".00004"]
    assert jrel == trel == ["# relaxed at step 36"]
    assert [s.ensemble for s in sims] == ["nvt", "ber", "cg"]
    assert sims[2].relaxed_at == 36 and sims[2].counters.steps == 20
    assert {s.pair_run is not None and len(s.pair_run.host) for s in sims} \
        == {4}


@pytest.fixture(scope="module", params=[1, 2], ids=["ntypes1", "ntypes2"])
def eam_cg(request, tmp_path_factory):
    nt = request.param
    d = tmp_path_factory.mktemp(f"eam_cg{nt}")
    _write_eam_start(d, nt)
    # seeded displacements of 0.1 A for the relaxation to undo
    c = read_chkpt(str(d / "start.chkpt"))
    c.pos = c.pos + np.random.default_rng(11).normal(scale=0.1,
                                                     size=c.pos.shape)
    write_chkpt(str(d / "start.chkpt"), c, precision=17)
    return nt, d, *_run_both(d, EAM.format(
        out="{out}", nt=nt, masses=" ".join(map(str, MASSES[:nt])))
        + EAM_CG)


def test_eam_cg_matches_jax(eam_cg):
    """cg on K4/K5 (one species) and K8/K9 (two) against imd_tpu's Pallas
    engines in interpret mode: .eng, the one checkpoint and -final."""
    nt, d, _, _, sims = eam_cg
    _, rows = _same_eng(d)
    assert len(rows) == 3 and all(r[2] == r[3] == 0.0 for r in rows)
    assert rows[2][1] < rows[1][1] < rows[0][1]
    names = _same_checkpoints(d, (0.0, 4 * 4.05, 4 * 4.05))
    assert names == ["-final", ".00003"]
    assert read_chkpt(str(d / "t-final.chkpt")).columns[-1] == "eam_rho"
    assert sims[0].ensemble == "cg" and sims[0].counters.steps == 12


def test_cg_rebin_overflow_grows_and_bins_again(tmp_path, capsys):
    """A rebin between cg blocks overflows the cell capacity: the driver
    grows the slot axis (13 -> 24) and bins the block's last scene again,
    with no rerun of the block; the .eng and the final checkpoint equal
    those of the run that starts at capacity 24.  The start is the EAM
    crystal of ``eam_cg`` (one species, no displacements) at a 0.05 A
    skin, on a (4,3,3) grid whose fullest cells hold 14 atoms: in each,
    the atom nearest the upper x face is moved 0.3 A past it, so that no
    cell holds more than 13 at the start and cg's first rebin brings the
    14th back."""
    torch.set_num_threads(1)
    _write_eam_start(tmp_path, 1)
    c = read_chkpt(str(tmp_path / "start.chkpt"))
    pos = np.asarray(c.pos).copy()
    dims = np.array([4, 3, 3])
    width = np.array([c.box_x[0], c.box_y[1], c.box_z[2]]) / dims

    def cells(p):
        return np.ravel_multi_index(np.floor(p / width).astype(int).T, dims)
    cell = cells(pos)
    count = np.bincount(cell, minlength=dims.prod())
    assert count.max() == 14
    for full in np.nonzero(count == 14)[0]:
        at = np.nonzero(cell == full)[0]
        gap = width[0] - pos[at, 0] % width[0]
        pos[at[np.argmin(gap)], 0] += gap.min() + 0.3
    assert np.bincount(cells(pos)).max() == 13
    c.pos = pos
    write_chkpt(str(tmp_path / "start.chkpt"), c, precision=17)
    sims = {}
    for out, cap in (("a", 24), ("b", 13)):
        (tmp_path / f"{out}.imd").write_text(
            EAM.format(out=out, nt=1, masses=MASSES[0])
            .replace("cell_capacity 32", f"cell_capacity {cap}")
            .replace("nbl_margin 0.5", "nbl_margin 0.05")
            + "ensemble cg\nmaxsteps 12\n")
        capsys.readouterr()
        assert cli.main(["-p", str(tmp_path / f"{out}.imd"), "--device",
                         "cpu", "--dtype", "float64"],
                        on_phase=lambda s, st: sims.update({out: s})) == 0
    out = capsys.readouterr().out
    assert ("# cell overflow: growing capacity 13 -> 24 and retrying the "
            "rebin") in out and "setup overflow" not in out
    a, b = sims["a"], sims["b"]
    assert a.grid.dims == b.grid.dims == (4, 3, 3)
    assert a.grid.capacity == b.grid.capacity == 24
    assert a.counters.rebins == b.counters.rebins > 0
    want = np.loadtxt(tmp_path / "a.eng")
    got = np.loadtxt(tmp_path / "b.eng")
    assert got.shape == want.shape == (3, 5)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    _, want = _by_number(tmp_path / "a-final.chkpt")
    _, got = _by_number(tmp_path / "b-final.chkpt")
    for k in ("number", "pos"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12,
                                   err_msg=k)
