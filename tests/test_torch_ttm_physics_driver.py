"""The rest of the 1-D TTM physics, port vs imd_tpu, float64 on the CPU:
ELECPRESS, VLATTICE, and two miniatures of the ablation file through both
drivers.

Module tests: ``electron_pressure_force`` and ``vlat_substep`` (ten
substeps, with the last active cell in front of the chain and without
one) on grids made from a seed, 1e-10 relative.

Driver tests, in the style of tests/test_torch_ablation_driver.py (fcc 10
x 3 x 3 Al at the rear of an open box, three vapour atoms that FILTER
deletes, seeded NumPy velocities, imd_tpu through ``Simulation`` with
engine "pallas" in interpret mode, asserted on its fused path; the port
through ``python -m imd_tpu_torch ... --device cpu --dtype float64``):

- ``examples/ablation/ablation.imd`` miniaturized as that test does (TTM
  on 12 cells, the TMM laser, NRB, FILTER every 7 steps, 14 steps) plus
  ``vlatdim 4``, ``elecpress 1``, ``colrad`` and ``colrad_mpi 1``;
- the same film in a box three times its length, TTM on 24 cells, the
  ``fdtd`` laser in place of the TMM (``pml 5``: the soft source sits in
  the last vacuum cell before the film), 8 steps of 0.02 (242 Maxwell
  steps each).

``.eng`` and the checkpoints agree to 1e-9, ``.ttm`` to 2e-6 (its %e keeps
7 digits) with its COLRAD columns and the virtual lattice's rows, values
below 1e-12 of their column's largest (of their cell's total nuclei for
the populations) counted as rounding noise, and the final COLRAD
populations to 1e-8 of their cell's total.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.io.chkpt import ChkptData, read_chkpt, write_chkpt
from imd_tpu.models import eos as j_eos
from imd_tpu.models import ttm as j_ttm
from imd_tpu.models.potential import analytic_eam, write_pot_table
from imd_tpu.simulation import Simulation as JSimulation
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import __main__ as cli
from imd_tpu_torch import convert
from imd_tpu_torch.models import fdtd as t_fdtd
from imd_tpu_torch.models import ttm as t_ttm
from imd_tpu_torch.models.eos import FEGEos

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
TOL = 1e-9
ALAT = 4.05
VAPOUR = [[4.0, 1.0, 1.0], [10.0, 7.0, 5.0], [16.0, 2.0, 9.0]]


def _grid(seed, nx=16, lo=3, hi=13):
    """imd_tpu's TTMParams and a TTMGrid whose cells lo..hi-1 are active
    (T_e 0.1-5 eV, n_e, densities and atom counts from a seed)."""
    rng = np.random.default_rng(seed)
    tp = j_ttm.TTMParams(nx=nx, fd_h_x=6.0, fd_vol=600.0, neigh_vol=523.6,
                         atomic_mass=26.9815, atomic_z=13.0, fd_min_atoms=8)
    on = (np.arange(nx) >= lo) & (np.arange(nx) < hi)

    def field(a, b):
        return jnp.asarray(np.where(on, rng.uniform(a, b, nx), 0.0))

    g = j_ttm.make_grid(tp, jnp.float64)
    g = g.replace(temp=field(0.1, 5.0), md_temp=field(0.03, 0.5),
                  dens=field(2000.0, 3000.0), ne=field(1e29, 3e29),
                  Z=field(1.0, 3.0), fd_k=field(0.1, 5.0),
                  fd_g=field(1e-4, 1e-3), Ce=field(1e-5, 1e-4),
                  natoms=jnp.asarray(np.where(on, rng.integers(30, 60, nx),
                                              rng.integers(0, 4, nx)),
                                     jnp.int32))
    return tp, g


def _rel(got, want, what, tol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def test_electron_pressure_force_matches_jax():
    """ELECPRESS's per-cell force -dP_e/dx / n_i (FEGEos.pe) on a grid
    with inactive cells at both ends, and its per-atom gather beside xi and
    v_com: 1e-10 relative."""
    torch.set_num_threads(1)
    jtp, jg = _grid(1)
    tp, tg = convert.from_ttm_params(jtp), convert.from_ttm_grid(jg, "cpu")
    want = j_ttm.electron_pressure_force(jg, jtp, j_eos.FEGEos())
    got = t_ttm.electron_pressure_force(tg, tp, FEGEos())
    _rel(got.numpy(), want, "force")
    assert float(got.abs().max()) > 0.0 and float(got[0]) == 0.0
    pe = FEGEos().pe(tg.dens, tg.ne, tg.temp)
    _rel(pe.numpy(), j_eos.FEGEos().pe(jg.dens, jg.ne, jg.temp), "pe")
    fdi = np.random.default_rng(2).integers(0, jtp.nx, 50).astype(np.int32)
    jx, jv, je = j_ttm.gather_atom_coupling_flat(jg, jnp.asarray(fdi),
                                                 extra=want)
    tx, tv, te = t_ttm.gather_atom_coupling_flat(tg, torch.as_tensor(fdi),
                                                 extra=got)
    for a, b, name in ((tx, jx, "xi"), (tv, jv, "vcom"), (te, je, "ep")):
        _rel(a.numpy(), b, name)


@pytest.mark.parametrize("edge", [True, False])
def test_vlat_substep_matches_jax(edge):
    """Ten VLATTICE substeps of 0.01 behind the grid (the backward-Euler
    chain over nv + 1 = 9 cells, the port's cyclic reduction against
    imd_tpu's Thomas scan), from a hot last active cell into a cold chain
    (0.03 eV) or with no active cell at all: the grid's T_e and the
    chain's T_e and T_i to 1e-10 relative."""
    torch.set_num_threads(1)
    jtp, jg = _grid(3, lo=3, hi=13 if edge else 3)
    tp, tg = convert.from_ttm_params(jtp), convert.from_ttm_grid(jg, "cpu")
    jvp, jvs = j_ttm.make_vlat(8, dens0=2700.0, t0=0.03, dtype=jnp.float64)
    vp, vs = convert.vlat_from_jax(jvp, jvs, device="cpu")
    assert vp == t_ttm.make_vlat(8, dens0=2700.0, t0=0.03, device="cpu")[0]
    for _ in range(10):
        jg, jvs = j_ttm.vlat_substep(jg, jvs, jtp, jvp, j_eos.FEGEos(), 0.01)
        tg, vs = t_ttm.vlat_substep(tg, vs, tp, vp, FEGEos(), 0.01)
    _rel(tg.temp.numpy(), jg.temp, "grid T_e")
    _rel(vs.te.numpy(), jvs.te, "vlat T_e")
    _rel(vs.ti.numpy(), jvs.ti, "vlat T_i")
    heated = float(vs.te[0]) > 0.031
    assert heated == edge


# ---------------------------------------------------------------------------
# the two drivers
# ---------------------------------------------------------------------------

def _write_start(d, box_factor):
    """Tables and start.chkpt: the film at the rear of a box
    ``box_factor`` times its length (x open), 0.026 eV NumPy velocities,
    the three vapour atoms in front."""
    eam = analytic_eam(r_cut=5.0, r0=ALAT / math.sqrt(2.0), E_c=3.39)
    for name in ("pair", "rho", "embed"):
        write_pot_table(getattr(eam, name), str(d / f"{name}.pt"))
    pos, _, diag = fcc((10, 3, 3), ALAT)
    box_x = diag[0] * box_factor
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


def _mini_text(out: str, rewrites) -> str:
    """The shipped ablation.imd with ``rewrites``, the start velocities
    from the .chkpt, ``outfiles out`` and cell capacity 24."""
    text = (REPO / "examples" / "ablation" / "ablation.imd").read_text()
    for a, b in rewrites + (("do_maxwell 1", "do_maxwell 0"),
                            ("outfiles ablation", f"outfiles {out}")):
        assert a in text, a
        text = text.replace(a, b)
    return text + "cell_capacity 24\n"


COLRAD_REWRITES = (("ttmdimx 48", "ttmdimx 12"),
                   ("maxsteps 2000", "maxsteps 14"),
                   ("filter_min_x 150.0", "filter_min_x 20.0"),
                   ("filter_int 50", "filter_int 7"),
                   ("eng_int 20", "eng_int 7"),
                   ("ttm_int 100", "ttm_int 7"),
                   ("checkpt_int 1000", "checkpt_int 7"),
                   ("I0 2.0e17", "I0 5.0e17"),
                   ("laser_t_0 300e-15", "laser_t_0 60e-15"),
                   ("laser_sigma_t 100e-15", "laser_sigma_t 40e-15"))
COLRAD_TAGS = "vlatdim 4\nelecpress 1\ncolrad\ncolrad_mpi 1\n"

FDTD_REWRITES = (("ttmdimx 48", "ttmdimx 24"),
                 ("timestep 0.1", "timestep 0.02"),
                 ("maxsteps 2000", "maxsteps 8"),
                 ("filter_min_x 150.0", "filter_min_x 20.0"),
                 ("filter_int 50", "filter_int 4"),
                 ("eng_int 20", "eng_int 4"),
                 ("ttm_int 100", "ttm_int 4"),
                 ("checkpt_int 1000", "checkpt_int 4"),
                 ("I0 2.0e17", "I0 5.0e17"),
                 ("laser_t_0 300e-15", "laser_t_0 60e-15"),
                 ("laser_sigma_t 100e-15", "laser_sigma_t 40e-15"),
                 ("\ntmm\n", "\nfdtd\npml 5\n"))


def _run_both(d, rewrites, extra):
    """imd_tpu's run (fused, interpret mode) and the port's of the same
    file; returns imd_tpu's Simulation and last state, the port's."""
    (d / "j.imd").write_text(_mini_text("j", rewrites) + extra)
    (d / "t.imd").write_text(_mini_text("t", rewrites) + extra)
    sim = JSimulation.from_param_file(str(d / "j.imd"), dtype=jnp.float64,
                                      engine="pallas")
    assert sim._fused_eligible()
    jstate = sim.run()
    sim.write_checkpoint(jstate, -1)
    sims = []
    assert cli.main(["-p", str(d / "t.imd"), "--device", "cpu", "--dtype",
                     "float64"],
                    on_phase=lambda s, st: sims.append((s, st))) == 0
    return sim, jstate, sims[0][0], sims[0][1]


def _by_number(path):
    d = read_chkpt(str(path))
    order = np.argsort(d.number)
    return {k: np.asarray(getattr(d, k))[order]
            for k in ("number", "type", "mass", "pos", "vel", "data")}


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def _compare_files(d, chkpts, ttms):
    """.eng, the checkpoints (by id, with .itr) and the .ttm files."""
    want, got = np.loadtxt(d / "j.eng"), np.loadtxt(d / "t.eng")
    assert want.shape == got.shape == (2, 6)
    for k in range(6):
        _close(got[:, k], want[:, k], f".eng column {k}")
    for name in chkpts:
        want, got = _by_number(d / f"j{name}.chkpt"), \
            _by_number(d / f"t{name}.chkpt")
        for k in ("number", "type", "mass"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("pos", "vel", "data"):
            _close(got[k], want[k], f"{name} {k}")
        assert (d / f"t{name}.itr").read_text() \
            == (d / f"j{name}.itr").read_text()
    for name in ttms:
        with open(d / f"j{name}") as f:
            header = f.readline()
        assert (d / f"t{name}").read_text().splitlines()[0] \
            == header.rstrip("\n")
        cols = header.lstrip("#").split()
        want, got = np.loadtxt(d / f"j{name}"), np.loadtxt(d / f"t{name}")
        assert want.shape == got.shape
        pops = [k for k, c in enumerate(cols) if c[0] == "c" and c[1:]
                .isdigit()]
        total = want[:, pops].sum(1) if pops else None
        for k, c in enumerate(cols):
            floor = (1e-12 * total if k in pops
                     else 1e-12 * max(np.abs(want[:, k]).max(), 1e-300))
            bad = np.abs(got[:, k] - want[:, k]) \
                > floor + 2e-6 * np.abs(want[:, k])
            assert not bad.any(), (name, c, np.nonzero(bad)[0],
                                   got[bad, k], want[bad, k])


def test_colrad_vlat_elecpress_run_matches_jax(tmp_path):
    """The miniature ablation file with the TMM laser, NRB, FILTER and
    ``vlatdim 4``, ``elecpress 1``, ``colrad``, ``colrad_mpi 1`` through
    both drivers: .eng, checkpoints, .ttm (the 17 populations and 5 power
    columns; the checkpoint .ttm with the 4 virtual cells as natoms -2
    rows), the final populations and the virtual lattice."""
    torch.set_num_threads(1)
    _write_start(tmp_path, 2.0)
    jsim, jst, tsim, tst = _run_both(tmp_path, COLRAD_REWRITES, COLRAD_TAGS)
    assert jsim.colrad_tab is not None and jsim.colrad_phi is not None
    assert tsim.colrad_phi is not None and tsim.vlat_params.nv == 4
    assert tsim.n_filter == 1 and tst.step == 14
    _compare_files(tmp_path, (".00001", ".00002", "-final"),
                   (".1.ttm", ".2.ttm", ".00002.ttm", "-final.ttm"))
    ttm = np.loadtxt(tmp_path / "t-final.ttm")
    assert ttm.shape == (16, 40) and (ttm[12:, 3] == -2).all()
    wc = np.asarray(jst.cstate.c)
    tot = np.maximum(wc.sum(1), 1.0)[:, None]
    np.testing.assert_allclose(tst.cstate.c.numpy() / tot, wc / tot, rtol=0,
                               atol=1e-8)
    _close(tst.vstate.te.numpy(), jst.vstate.te, "vlat T_e")
    _close(tst.vstate.ti.numpy(), jst.vstate.ti, "vlat T_i")
    # the film ionized, the virtual lattice warmed, MULTIPHOTON fired
    act = tst.ttm_grid.natoms >= 8
    assert float(tst.ttm_grid.Z[act].max()) > 0.0
    assert float(tst.vstate.te[0]) > 0.026
    assert float(tst.cstate.p[:, 2].abs().max()) > 0.0
    assert tsim.counters.colrad_tries >= 14 * 5


def test_fdtd_run_matches_jax(tmp_path):
    """The film in a box three times its length with the FDTD laser in
    place of the TMM, NRB and FILTER, 8 steps of 0.02 through both
    drivers: .eng, checkpoints, .ttm and the final FDTD fields (1e-9 of
    their largest value); .laser's I_t and refl are NaN, its absorbed
    fluence imd_tpu's."""
    torch.set_num_threads(1)
    _write_start(tmp_path, 3.0)
    jsim, jst, tsim, tst = _run_both(tmp_path, FDTD_REWRITES, "")
    assert jsim.fdtd_params is not None and jsim.tmm_params is None
    tpar = tsim.fdtd_params
    assert tpar.srcx == 15 and tsim.n_filter == 1 and tst.step == 8
    _compare_files(tmp_path, (".00001", ".00002", "-final"),
                   (".1.ttm", ".2.ttm", "-final.ttm"))
    for name in ("ezx", "hy", "jzx", "jlzx", "pzx", "source"):
        _close(getattr(tst.fdtd, name).numpy(), getattr(jst.fdtd, name),
               name)
    want, got = np.loadtxt(tmp_path / "j.laser"), \
        np.loadtxt(tmp_path / "t.laser")
    assert want.shape == got.shape == (2, 5)
    assert np.isnan(got[:, [2, 4]]).all() and np.isnan(want[:, [2, 4]]).all()
    np.testing.assert_allclose(got[:, [0, 1, 3]], want[:, [0, 1, 3]],
                               rtol=TOL)
    assert got[1, 3] > got[0, 3] > 0.0
    n_fdtd = t_fdtd.fdtd_substeps_per_md(tpar, 0.02)
    assert n_fdtd == 242 and tsim.counters.maxwell_steps == 8 * n_fdtd
