"""The TTM restart (``-r N`` from ``.ttm`` + ``.ttmaux.npz``), port vs
imd_tpu, float64 on the CPU.

- The restart files cross-read: a grid, COLRAD populations, a virtual
  lattice, FDTD fields and a per-atom FD index made from a seed are written
  by each package (``write_ttm``, ``write_ttm_aux``) and read back by both
  (``read_ttm``, ``grid_from_ttm``, ``colrad_from_ttm``, ``vlat_from_ttm``,
  ``read_ttm_aux``, ``grid_overlay_from_aux``, ``fdi_from_aux``): the same
  bits, the FD index exact.
- The miniature ablation file of tests/test_torch_ttm_physics_driver.py
  (fcc 10 x 3 x 3 Al, TMM, NRB, FILTER) with ``vlatdim 4`` and
  ``elecpress 1``, with COLRAD on top, and the FDTD variant, run 8 steps
  through the port's CLI with a checkpoint set at step 4.  Both packages
  restore the set (imd_tpu's ``Simulation(...).init_state()`` with
  ``restart_base``, the port's ``_initial_ttm_state``): the grid, the
  COLRAD populations, the virtual lattice, the FDTD fields and the FD index
  by atom id to 1e-12.  Then ``-r 1`` continues the port's run to step 8:
  its .eng line (the temperature scaled by the two runs' start atom
  counts) and final checkpoint equal the straight run's to 1e-9; with
  COLRAD the populations come back through the .ttm's ``%e`` columns (7
  significant digits, 5e-7 relative; imd_tpu's behaviour) and the run
  continues to 1e-6 (the measured deviations are printed).

FILTER fires at steps 3 and 6 (``filter_int 3``), not at the checkpoint:
a checkpoint is written before the same step's FILTER, so a restart from a
FILTER step would keep atoms the straight run deletes.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.config import SimConfig as JSimConfig
from imd_tpu.io import ttm_io as j_io
from imd_tpu.io.chkpt import read_chkpt
from imd_tpu.models import fdtd as j_fdtd
from imd_tpu.models import ttm as j_ttm
from imd_tpu.simulation import Simulation as JSimulation
from imd_tpu_torch import __main__ as cli
from imd_tpu_torch import convert
from imd_tpu_torch.config import SimConfig as TSimConfig
from imd_tpu_torch.io import ttm_io as t_io
from imd_tpu_torch.models import ttm as t_ttm
from imd_tpu_torch.simulation import Simulation as TSimulation
from test_torch_ttm_physics_driver import (COLRAD_REWRITES, COLRAD_TAGS,
                                           FDTD_REWRITES, _mini_text,
                                           _write_start)

TOL = 1e-9


def _grid(rng, nx=12):
    """imd_tpu's TTMGrid with every restartable field drawn from ``rng``
    (natoms_old unlike natoms)."""
    tp = j_ttm.TTMParams(nx=nx, fd_h_x=6.0, fd_vol=600.0, neigh_vol=523.6,
                         atomic_mass=26.9815, atomic_z=13.0, fd_min_atoms=8)
    g = j_ttm.make_grid(tp, jnp.float64)

    def f(a, b, *shape):
        return jnp.asarray(rng.uniform(a, b, (nx,) + shape))
    return g.replace(
        temp=f(0.1, 5.0), md_temp=f(0.03, 0.5), U=f(0.0, 3.0),
        natoms=jnp.asarray(rng.integers(0, 60, nx), jnp.int32),
        natoms_old=jnp.asarray(rng.integers(0, 60, nx), jnp.int32),
        dens=f(0.0, 3000.0), vcom=f(-1e-2, 1e-2, 3), xi=f(0.0, 1e-3),
        source=f(0.0, 1e-2), Z=f(1.0, 3.0), ne=f(1e29, 3e29),
        Ce=f(1e-5, 1e-4), fd_k=f(0.1, 5.0), fd_g=f(1e-4, 1e-3))


def test_ttm_restart_files_cross_read(tmp_path):
    """Each package reads the other's .ttm (with COLRAD columns and
    virtual rows) and .ttmaux.npz to the same bits; the FD index comes back
    by id onto a shuffled layout with dead slots and an unknown id."""
    rng = np.random.default_rng(11)
    jg = _grid(rng)
    nx, nlev, nv = 12, 5, 4
    c = rng.uniform(0.0, 1e27, (nx, nlev))
    p = rng.uniform(-1e3, 1e3, (nx, 5))
    jvs = j_ttm.VlatState(te=jnp.asarray(rng.uniform(0.02, 1.0, nv)),
                          ti=jnp.asarray(rng.uniform(0.02, 0.1, nv)))
    jfs = j_fdtd.FDTDState(**{k: jnp.asarray(rng.normal(size=nx + 10))
                              for k in ("ezx", "hy", "jzx", "jlzx", "pzx",
                                        "source")})
    ids = rng.permutation(40).astype(np.int32).reshape(2, 2, 1, 10)
    alive = rng.uniform(size=ids.shape) < 0.8
    fdi = rng.integers(-1, nx, ids.shape).astype(np.int32)
    tg = convert.from_ttm_grid(jg, "cpu")
    _, tvs = convert.vlat_from_jax(
        j_ttm.make_vlat(nv, dtype=jnp.float64)[0], jvs, device="cpu")
    tfs = convert.fdtd_state_from_jax(jfs, "cpu")
    j_io.write_ttm(str(tmp_path / "j.ttm"), jg, colrad_c=c, colrad_p=p,
                   vlat=jvs)
    j_io.write_ttm_aux(str(tmp_path / "j.ttmaux.npz"), fdtd=jfs, vlat=jvs,
                       grid=jg, fdi=fdi, ids=ids, alive=alive)
    t_io.write_ttm(str(tmp_path / "t.ttm"), tg, colrad_c=torch.as_tensor(c),
                   colrad_p=torch.as_tensor(p), vlat=tvs)
    t_io.write_ttm_aux(str(tmp_path / "t.ttmaux.npz"), fdtd=tfs, vlat=tvs,
                       grid=tg, fdi=torch.as_tensor(fdi),
                       ids=torch.as_tensor(ids), alive=torch.as_tensor(alive))
    assert (tmp_path / "t.ttm").read_text() == \
        (tmp_path / "j.ttm").read_text()
    ja, ta = np.load(tmp_path / "j.ttmaux.npz"), \
        np.load(tmp_path / "t.ttmaux.npz")
    assert sorted(ja.files) == sorted(ta.files)
    for k in ja.files:
        assert ta[k].dtype == ja[k].dtype, k
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)

    # a restart layout: the ids in another order, one id not in the file
    ids2 = ids.reshape(-1)[::-1].copy()
    ids2[0] = 99
    ids2 = ids2.reshape(1, 2, 2, 10)
    alive2 = np.ones(ids2.shape, bool)
    alive2[0, 0, 0, 3] = False
    jfresh = j_ttm.make_grid(j_ttm.TTMParams(
        nx=nx, fd_h_x=6.0, fd_vol=600.0, neigh_vol=523.6,
        atomic_mass=26.9815, atomic_z=13.0, fd_min_atoms=8), jnp.float64)
    tfresh = convert.from_ttm_grid(jfresh, "cpu")
    jv0 = j_ttm.VlatState(te=jnp.zeros(nv), ti=jnp.zeros(nv))
    tv0 = t_ttm.VlatState(te=torch.zeros(nv, dtype=torch.float64),
                          ti=torch.zeros(nv, dtype=torch.float64))
    jf0 = j_fdtd.FDTDState(**{k: jnp.zeros(nx + 10) for k in (
        "ezx", "hy", "jzx", "jlzx", "pzx", "source")})
    tf0 = convert.fdtd_state_from_jax(jf0, "cpu")
    for name in ("j", "t"):
        path, aux = str(tmp_path / f"{name}.ttm"), \
            str(tmp_path / f"{name}.ttmaux.npz")
        want = j_io.read_ttm(path)
        got = t_io.read_ttm(path)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        jgr = j_io.grid_overlay_from_aux(aux, j_io.grid_from_ttm(path,
                                                                 jfresh))
        tgr = t_io.grid_overlay_from_aux(aux, t_io.grid_from_ttm(path,
                                                                 tfresh))
        assert tgr.init_done
        for k in ("temp", "md_temp", "U", "natoms", "natoms_old", "dens",
                  "vcom", "xi", "source", "Z", "fd_k", "fd_g", "Ce"):
            np.testing.assert_array_equal(getattr(tgr, k).numpy(),
                                          np.asarray(getattr(jgr, k)),
                                          err_msg=f"{name} {k}")
        np.testing.assert_array_equal(getattr(tgr, "natoms_old").numpy(),
                                      np.asarray(jg.natoms_old))
        # imd_tpu keeps the virtual rows' zeros (ROADMAP C7)
        np.testing.assert_array_equal(
            t_io.colrad_from_ttm(path, nlev, torch.float64, "cpu").numpy(),
            np.asarray(j_io.colrad_from_ttm(path, nlev, jnp.float64))[:nx])
        for a, b in ((t_io.vlat_from_ttm(path, tv0),
                      j_io.vlat_from_ttm(path, jv0)),
                     (t_io.read_ttm_aux(aux, vlat_template=tv0)[1],
                      j_io.read_ttm_aux(aux, vlat_template=jv0)[1])):
            np.testing.assert_array_equal(a.te.numpy(), np.asarray(b.te))
            np.testing.assert_array_equal(a.ti.numpy(), np.asarray(b.ti))
        tf, _ = t_io.read_ttm_aux(aux, fdtd_template=tf0)
        jf, _ = j_io.read_ttm_aux(aux, fdtd_template=jf0)
        for k in ("ezx", "hy", "jzx", "jlzx", "pzx", "source"):
            np.testing.assert_array_equal(getattr(tf, k).numpy(),
                                          np.asarray(getattr(jf, k)))
        got = t_io.fdi_from_aux(aux, torch.as_tensor(ids2),
                                torch.as_tensor(alive2))
        want = j_io.fdi_from_aux(aux, ids2, alive2)
        np.testing.assert_array_equal(got, want)
        assert got[0, 0, 0, 0] == -1 and got[0, 0, 0, 3] == -1
        by_id = dict(zip(ids[alive], fdi[alive]))
        live = (got.reshape(-1) != -1)
        assert live.sum() > 20 and all(
            by_id[i] == v for i, v in zip(ids2.reshape(-1)[live],
                                          got.reshape(-1)[live]))


RESTART = (("maxsteps 2000", "maxsteps 8"), ("filter_int 50", "filter_int 3"),
           ("eng_int 20", "eng_int 4"), ("ttm_int 100", "ttm_int 4"),
           ("checkpt_int 1000", "checkpt_int 4"))
CASES = {
    "tmm_vlat": (COLRAD_REWRITES, "vlatdim 4\nelecpress 1\n", 2.0),
    "colrad": (COLRAD_REWRITES, COLRAD_TAGS, 2.0),
    "fdtd": (FDTD_REWRITES, "", 3.0),
}


def _restart_text(case: str, out: str) -> str:
    rewrites, tags, _ = CASES[case]
    keep = tuple((a, b) for a, b in rewrites
                 if not any(a == r[0] for r in RESTART))
    return _mini_text(out, keep + RESTART) + tags + "hpo 1\n"


def _cli(path, *extra):
    sims = []
    assert cli.main(["-p", str(path), "--device", "cpu", "--dtype",
                     "float64", *extra],
                    on_phase=lambda s, st: sims.append((s, st))) == 0
    return sims[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_restart_restores_like_jax_and_continues(tmp_path, case):
    """The port's run writes the set at step 4; both packages restore it
    (1e-12, the FD index by id exact); ``-r 1`` continues to step 8 as the
    straight run does (1e-9; COLRAD 1e-6, its populations through %e)."""
    torch.set_num_threads(1)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    _write_start(a, CASES[case][2])
    (a / "t.imd").write_text(_restart_text(case, "t"))
    sim, st = _cli(a / "t.imd")
    assert st.step == 8 and sim.n_filter == 2
    for name in ("pair.pt", "rho.pt", "embed.pt", "t.imd"):
        shutil.copy(a / name, b / name)
    for ext in ("chkpt", "itr", "ttm", "ttmaux.npz", "nrb"):
        shutil.copy(a / f"t.00001.{ext}", b / f"t.00001.{ext}")

    # both packages restore the set
    def restart_cfg(cls, base):
        cfg = cls.from_file(str(b / "t.imd"))
        cfg.coordname, cfg.itrname = f"{base}.chkpt", f"{base}.itr"
        cfg.restart_base = base
        return cfg
    tcfg = restart_cfg(TSimConfig, "t.00001")
    jbase = "t.00001"
    if case == "colrad":
        # imd_tpu reads the populations of the virtual rows too and cannot
        # restore COLRAD with vlatdim (ROADMAP C7): it gets the set with
        # the .ttm's natoms -2 rows left out (the sidecar has the lattice)
        with pytest.raises(TypeError, match="reshape"):
            JSimulation(restart_cfg(JSimConfig, jbase), workdir=str(b),
                        dtype=jnp.float64, engine="pallas").init_state()
        jbase = "s.00001"
        for ext in ("chkpt", "itr", "ttmaux.npz", "nrb"):
            shutil.copy(b / f"t.00001.{ext}", b / f"{jbase}.{ext}")
        lines = (b / "t.00001.ttm").read_text().splitlines(True)
        (b / f"{jbase}.ttm").write_text("".join(
            ln for ln in lines if ln.split()[3] != "-2"))
    jsim = JSimulation(restart_cfg(JSimConfig, jbase), workdir=str(b),
                       dtype=jnp.float64, engine="pallas")
    j0 = jsim.init_state()
    tsim = TSimulation(tcfg, workdir=str(b), dtype=torch.float64,
                       device="cpu")
    tgrid, taux, tfdi = tsim._initial_ttm_state()
    tst = tsim._aux_states((None,) * 3 + taux + (None,))
    for k in ("temp", "md_temp", "U", "natoms", "natoms_old", "dens",
              "vcom", "xi", "source", "Z", "fd_k", "fd_g", "Ce"):
        np.testing.assert_allclose(getattr(tgrid, k).numpy(),
                                   np.asarray(getattr(j0.ttm_grid, k)),
                                   rtol=1e-12, atol=0, err_msg=k)
    assert tgrid.init_done
    pairs = [("vstate", ("te", "ti")), ("cstate", ("c",)),
             ("fdtd", ("ezx", "hy", "jzx", "jlzx", "pzx", "source"))]
    for field, keys in pairs:
        want = getattr(j0, field)
        assert (field in tst) == (want is not None), field
        for k in keys if want is not None else ():
            np.testing.assert_allclose(getattr(tst[field], k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       rtol=1e-12, atol=0, err_msg=k)
    # the FD index by atom id, against the straight run's at step 4
    jmap = dict(zip(np.asarray(jsim.scene.id)[np.asarray(jsim.scene.mask)],
                    np.asarray(j0.fdi)[np.asarray(jsim.scene.mask)]))
    tm = tsim.scene.mask.numpy()
    tmap = dict(zip(tsim.scene.id.numpy()[tm], tfdi.numpy()[tm]))
    assert tmap == jmap and len(tmap) == int(tm.sum())
    assert min(tmap.values()) >= 0
    saved = np.load(a / "t.00001.ttmaux.npz")
    assert tmap == dict(zip(saved["fdi_ids"], saved["fdi_vals"]))

    # -r 1 continues to step 8
    rsim, rst = _cli(b / "t.imd", "-r", "1")
    assert rst.step == 8 and rsim.setup_parts["ttm_restore"] > 0
    tol = 1e-6 if case == "colrad" else TOL
    want, got = np.loadtxt(a / "t.eng"), np.loadtxt(b / "t.eng", ndmin=2)
    assert got.shape == (1, want.shape[1])
    # the temperature column is 2 Ekin over the degrees of freedom counted
    # at the run's start: 3 x 363 atoms before FILTER took the 3 vapour
    # atoms in the straight run, 3 x 360 in the restarted one
    n_a = len(read_chkpt(str(a / "start.chkpt")).number)
    n_b = len(read_chkpt(str(b / "t.00001.chkpt")).number)
    assert (n_a, n_b) == (363, 360)
    got[0, 2] *= n_b / n_a
    dev = np.abs(got[0] - want[1]) / np.maximum(np.abs(want[1]), 1e-300)
    print(f"{case}: .eng relative deviation {dev.max():.3e}")
    np.testing.assert_allclose(got[0], want[1], rtol=tol, atol=0)
    da, db = read_chkpt(str(a / "t-final.chkpt")), \
        read_chkpt(str(b / "t-final.chkpt"))
    oa, ob = np.argsort(da.number), np.argsort(db.number)
    np.testing.assert_array_equal(db.number[ob], da.number[oa])
    for k in ("pos", "vel", "data"):
        x, y = getattr(db, k)[ob], getattr(da, k)[oa]
        err = np.abs(x - y).max() / np.abs(y).max()
        print(f"{case}: final {k} deviation {err:.3e} of max")
        assert err <= tol, (k, err)
    tt, ta = np.loadtxt(b / "t-final.ttm"), np.loadtxt(a / "t-final.ttm")
    cols = (a / "t-final.ttm").read_text().split("\n", 1)[0][1:].split()
    pops = [k for k, c in enumerate(cols) if c[0] == "c" and c[1:].isdigit()]
    # the populations as a share of their cell's total nuclei, the rest
    # to their %e digits beside the tolerance of their column's largest
    scale = np.maximum(np.abs(ta).max(0), 1e-300)[None, :].repeat(len(ta), 0)
    if pops:
        scale[:, pops] = np.maximum(ta[:, pops].sum(1), 1.0)[:, None]
    dev = np.abs(tt - ta) - 2e-6 * np.abs(ta)
    print(f"{case}: final .ttm deviation {(dev / scale).max():.3e} beyond "
          "the %e digits, of the column's largest (populations: of the "
          "cell's total)")
    assert (dev <= max(tol, 1e-12) * scale).all()
