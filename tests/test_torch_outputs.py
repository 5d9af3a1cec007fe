"""The interval outputs, port vs imd_tpu, float64 on the CPU.

Scenes from a seed: a jittered fcc Al crystal (5 x 4 x 4 cells, x open
with 1 A of vacuum, seeded NumPy momenta, two types by id parity, a few
slots left empty), binned by imd_tpu's ``make_scene`` and carried across
with ``convert.from_scene``.

- ``compute_distrib``/``write_distrib`` (ascii and binary) and
  ``write_picture``: the files byte for byte (the header's time stamp
  fixed).
- The stencil oracles: ``compute_eam_forces`` (analytic EAM tables) and
  ``compute_pair_forces`` (two-type LJ) with the per-atom stress at 1e-10
  relative; the per-atom stress sums to the pressure tensor;
  ``compute_nbanz`` exact; ``compute_ordpar`` at 1e-10.
- ``write_wf``, ``write_force_potfit``, ``write_press`` and ``write_nb``
  on the live atoms: byte for byte.
- ``SelectWriters`` (.avp, .dsp, .dem, .ef) over six seeded scenes with
  moving atoms: every file byte for byte.
- ``_apply_generate_shifts``: the same atoms and box.
- A run of the port's CLI with every one of these outputs on.
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.config import SimConfig as JSimConfig
from imd_tpu.config import parse_param_text as j_parse
from imd_tpu.io import distrib as j_distrib
from imd_tpu.io import pictures as j_pictures
from imd_tpu.io import select as j_select
from imd_tpu.models.potential import analytic_eam, lj_table, \
    write_pot_table
from imd_tpu.ops import forces as j_forces
from imd_tpu.ops.geometry import Box, choose_grid
from imd_tpu.scene import make_scene
from imd_tpu.simulation import Simulation as JSimulation
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import __main__ as cli
from imd_tpu_torch import convert
from imd_tpu_torch.config import SimConfig as TSimConfig
from imd_tpu_torch.config import parse_param_text as t_parse
from imd_tpu_torch.io import distrib as t_distrib
from imd_tpu_torch.io import pictures as t_pictures
from imd_tpu_torch.io import select as t_select
from imd_tpu_torch.ops import forces as t_forces
from imd_tpu_torch.simulation import Simulation as TSimulation
from test_torch_driver import BASE
from test_torch_driver import _write_start as driver_start

ALAT = 4.05


def _scene(seed=0, jitter=0.1):
    """imd_tpu's Scene and the port's of the same seeded crystal."""
    rng = np.random.default_rng(seed)
    pos, _, diag = fcc((5, 4, 4), ALAT)
    pos = pos + rng.normal(scale=jitter, size=pos.shape)
    pos[:, 0] = np.clip(pos[:, 0], 0.0, diag[0] + 0.9)
    n = len(pos)
    box = Box.create([diag[0] + 1.0, 0, 0], [0, diag[1], 0], [0, 0, diag[2]],
                     pbc=(0, 1, 1), dtype=jnp.float64)
    grid = choose_grid(box, 5.0, 0.5, n_atoms=n, capacity=24)
    typ = (np.arange(n) % 2).astype(np.int32)
    vtyp = typ.copy()
    vtyp[::7] += 2                      # some boundary atoms (vtype != type)
    js = make_scene(grid, pos, mom=rng.normal(scale=0.3, size=(n, 3)),
                    mass=np.full(n, 26.9815), type=typ, vtype=vtyp,
                    id=rng.permutation(n), epot=rng.normal(-3.4, 0.2, n),
                    dtype=jnp.float64)
    js = js.replace(force=jnp.asarray(rng.normal(size=js.pos.shape)))
    return js, convert.from_scene(js, "cpu")


def _fix_time(monkeypatch):
    for mod in (j_distrib, t_distrib):
        monkeypatch.setattr(mod.time, "ctime", lambda *a: "Thu Jan  1 1970")


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode", ["ascii", "ascii_coord", "binary"])
def test_distrib_and_picture_files_match_jax(tmp_path, monkeypatch, mode):
    _fix_time(monkeypatch)
    js, ts = _scene(1)
    dims = (4, 3, 2)
    jf = j_distrib.compute_distrib(js, dims)
    tf = t_distrib.compute_distrib(ts, dims)
    assert sorted(tf) == sorted(jf)
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    names = ["num", "Ekin", "Epot", "mdtemp", "vx"]
    bh = np.abs(np.diag(np.asarray(js.grid.box.h))) / np.asarray(dims)
    j_distrib.write_distrib(str(tmp_path / "j.dist"), jf, names, dims, bh,
                            mode=mode)
    t_distrib.write_distrib(str(tmp_path / "t.dist"), tf, names, dims, bh,
                            mode=mode)
    assert _bytes(tmp_path / "t.dist") == _bytes(tmp_path / "j.dist")
    meta, data = t_distrib.read_distrib(str(tmp_path / "t.dist"))
    assert meta["contents"][-len(names):] == names
    np.testing.assert_array_equal(data[..., 0], tf["num"])
    fmt = "ascii" if mode != "binary" else "ppm"
    j_pictures.write_picture(str(tmp_path / "j.pic"), js, dims=(16, 12),
                             axis=2, fmt=fmt)
    t_pictures.write_picture(str(tmp_path / "t.pic"), ts, dims=(16, 12),
                             axis=2, fmt=fmt)
    assert _bytes(tmp_path / "t.pic") == _bytes(tmp_path / "j.pic")


def _rel(got, want, what, tol=1e-10):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


@pytest.mark.parametrize("kind", ["eam", "pair"])
def test_stencil_oracles_match_jax(kind):
    """Forces, energies, virial, pressure tensor, host density and the
    per-atom stress of the 14-offset oracles; the per-atom stress sums to
    the pressure tensor."""
    js, ts = _scene(2)
    if kind == "eam":
        jpot = analytic_eam(r_cut=5.0, r0=ALAT / math.sqrt(2.0),
                            dtype=jnp.float64)
        want = j_forces.compute_eam_forces(js, jpot, ntypes=1,
                                           per_atom_stress=True)
        got = t_forces.compute_eam_forces(ts, convert.from_eam(jpot),
                                          ntypes=1, per_atom_stress=True)
        _rel(got.rho.numpy(), want.rho, "rho")
        _rel(got.embed_dF.numpy(), want.embed_dF, "dF")
    else:
        jpot = lj_table([0.35, 0.3, 0.3, 0.4], [2.62, 2.5, 2.5, 2.7],
                        [5.0] * 4, ntypes=2, dtype=jnp.float64)
        want = j_forces.compute_pair_forces(js, jpot, ntypes=2,
                                            per_atom_stress=True)
        got = t_forces.compute_pair_forces(ts, convert.from_table(jpot),
                                           ntypes=2, per_atom_stress=True)
    for k in ("force", "epot", "virial", "presstens", "presstens_atom"):
        _rel(getattr(got, k).numpy(), getattr(want, k), k)
    total = got.presstens_atom.sum(dim=(0, 1, 2, 3))
    _rel(total.numpy(), got.presstens.numpy(), "sum of the per-atom stress")
    assert float(got.force.abs().max()) > 0.1


def test_nbanz_and_ordpar_match_jax():
    js, ts = _scene(3)
    rc = [2.9, 3.1, 3.1, 3.3]
    want = j_forces.compute_nbanz(js, rc, ntypes=2)
    got = t_forces.compute_nbanz(ts, rc, ntypes=2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 8 <= int(got.max()) <= 12
    jpot = lj_table([0.35, 0.3, 0.3, 0.4], [2.62, 2.5, 2.5, 2.7], [5.0] * 4,
                    ntypes=2, dtype=jnp.float64)
    w = [1.0, -0.5, 0.25, 2.0]
    want = j_forces.compute_ordpar(js, jpot, rc, w, ntypes=2)
    got = t_forces.compute_ordpar(ts, convert.from_table(jpot), rc, w,
                                  ntypes=2)
    _rel(got.numpy(), want, "ordpar")
    assert float(got.abs().max()) > 0.0


def _j_flat(js):
    flat = js.flatten_atoms()
    m = np.asarray(flat["mask"])
    return {k: np.asarray(v)[m] for k, v in flat.items() if k != "mask"}


def test_config_writers_match_jax(tmp_path):
    """.wf (boundary atoms, and all), .force, .stress and .nb from the
    flattened live atoms of each package's scene."""
    js, ts = _scene(4)
    jf, tf = _j_flat(js), t_select.flat_host(ts)
    for k in jf:
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    h, pbc = np.asarray(js.grid.box.h), js.grid.box.pbc
    rng = np.random.default_rng(5)
    pt = rng.normal(size=(len(jf["id"]), 6))
    nb = rng.integers(6, 14, len(jf["id"]))
    pten = rng.normal(size=6)
    for mod, f, tag in ((j_select, jf, "j"), (t_select, tf, "t")):
        mod.write_wf(str(tmp_path / f"{tag}.wf"), f, h, pbc)
        mod.write_wf(str(tmp_path / f"{tag}.all.wf"), f, h, pbc,
                     force_all=True)
        mod.write_force_potfit(str(tmp_path / f"{tag}.force"), f, h, pbc,
                               -3.4, presstens=pten, volume=1234.5)
        mod.write_press(str(tmp_path / f"{tag}.stress"), f, pt, h, pbc)
        mod.write_nb(str(tmp_path / f"{tag}.nb"), f, nb, h, pbc, [9, 8],
                     [12, 13], [2.0, 0.0, 0.0], [15.0, 20.0, 20.0])
    for name in ("wf", "all.wf", "force", "stress", "nb"):
        t = _bytes(tmp_path / f"t.{name}")
        assert t == _bytes(tmp_path / f"j.{name}"), name
        assert t.count(b"\n") > 10, name


SELECT = """avpos_int 4
avpos_res 2
avpos_start 1
dsp_int 2
update_ort_ref 1
min_dsp2 0.001
dem_int 3
calc_Epot_ref 1
reset_Epot_step 1
min_dpot 0.05
ef_checkpt_int 2
e_pot_lower -3.5 -3.6
e_pot_upper -3.2 -3.3
outfiles o
"""


def test_select_writers_match_jax(tmp_path):
    """The .avp/.dsp/.dem/.ef observers over steps 0..8 of scenes whose
    atoms move (and cross the periodic y face): the cadences, the special
    steps and every file byte for byte."""
    jcfg = JSimConfig.from_params(j_parse(SELECT))
    tcfg = TSimConfig.from_params(t_parse(SELECT))
    js0, ts0 = _scene(6)
    h, pbc = np.asarray(js0.grid.box.h), js0.grid.box.pbc
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jw = j_select.SelectWriters(jcfg, h, pbc, lambda p: str(tmp_path / "j"
                                                            / p))
    tw = t_select.SelectWriters(tcfg, h, pbc, lambda p: str(tmp_path / "t"
                                                            / p))
    assert tw.intervals() == jw.intervals()
    assert tw.special_steps() == jw.special_steps()
    jw.init_refs(js0, 0)
    tw.init_refs(ts0, 0)
    rng = np.random.default_rng(7)
    js, ts = js0, ts0
    for gstep in range(1, 9):
        d = rng.normal(scale=0.3, size=js.pos.shape) * np.asarray(
            js.mask)[..., None]
        d[..., 1] += 0.8                       # drift across the y face
        pos = np.asarray(js.pos) + d
        pos[..., 1] %= h[1, 1]
        epot = np.asarray(js.epot) + rng.normal(scale=0.1,
                                                size=js.epot.shape)
        js = js.replace(pos=jnp.asarray(pos), epot=jnp.asarray(epot))
        ts = convert.from_scene(js, "cpu")
        assert tw.needs_epot(gstep) == jw.needs_epot(gstep)
        jw.step(js, gstep)
        tw.step(ts, gstep)
    files = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert {f.split(".")[-1] for f in files} == {"avp", "dsp", "dem", "ef"}
    for name in files:
        assert _bytes(tmp_path / "t" / name) == _bytes(tmp_path / "j"
                                                       / name), name


@pytest.mark.parametrize("shifts", [(3.0, 0.0, 0.0, 5.0, 0.0, 2.0),
                                    (0.0, 4.5, 1.0, 0.0, 7.0, 0.0)])
def test_generate_shifts_match_jax(shifts):
    text = ("coordname _fcc\nbox_param 5 4 3\nbox_unit 4.05\nntypes 1\n"
            "masses 26.98\n" + "".join(
                f"shift{a}_{e} {v}\n" for (a, e), v in zip(
                    [(a, e) for e in ("front", "rear") for a in "xyz"],
                    shifts)))
    jcfg = JSimConfig.from_params(j_parse(text))
    tcfg = TSimConfig.from_params(t_parse(text))
    shf, shr = np.asarray(shifts[:3]), np.asarray(shifts[3:])
    pos, typ, diag = fcc((5, 4, 3), 4.05)
    want = JSimulation._apply_generate_shifts(
        types.SimpleNamespace(cfg=jcfg), pos, typ, np.asarray(diag, float),
        shf, shr)
    got = TSimulation._apply_generate_shifts(
        types.SimpleNamespace(cfg=tcfg), pos, typ, np.asarray(diag, float),
        shf, shr)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (got[2] > np.asarray(diag)).any()


OUTPUTS = """dist_int 4
dist_dim 4 2 2
dist_Ekin_flag 1
dist_Epot_flag 1
pic_int 4
force_int 4
force_all 1
force_potfit 1
press_int 4
nb_checkpt_int 4
nb_rcut 3.2
nb_cut_lower 11
nb_cut_upper 13
op_weight 1.0
op_rcut 3.2
relaxinfo 1
dsp_int 4
update_ort_ref 0
"""


def test_outputs_run_through_the_cli(tmp_path):
    """The port's driver with every interval output on (the fused EAM
    loop of tests/test_torch_driver.py's file, ``ensemble nve``): the files
    are written at step 4 and 8, the .eng has the RELAXINFO columns, the
    checkpoint the ordpar, n_nbr and x_ref columns; the .stress file's
    per-atom stress sums to the tables' pressure tensor (imd_tpu writes it
    from the tables), and the oracle on the degree-12 fit gives the
    observe()'s tensor of the same step (1e-8 of its largest
    component)."""
    torch.set_num_threads(1)
    rundir = tmp_path
    eam = analytic_eam(r_cut=5.0, r0=2.864, E_c=3.39)
    for name in ("pair", "rho", "embed"):
        write_pot_table(getattr(eam, name), str(rundir / f"{name}.pt"))
    driver_start(rundir, (5, 4, 4), 0.5, 1.0, 0.1)
    (rundir / "o.imd").write_text(BASE.format(out="o", ens="nve") + OUTPUTS)
    sims = []
    assert cli.main(["-p", str(rundir / "o.imd"), "--device", "cpu",
                     "--dtype", "float64"],
                    on_phase=lambda s, st: sims.append((s, st))) == 0
    sim, st = sims[0]
    for n in (1, 2):
        for ext in ("dist", "ppm", "wf", "force", "stress", "nb"):
            assert (rundir / f"o.{n}.{ext}").exists(), (n, ext)
    assert (rundir / "o.4.dsp").exists() and (rundir / "o.8.dsp").exists()
    eng = np.loadtxt(rundir / "o.eng")
    assert eng.shape == (2, 8) and np.isfinite(eng).all()
    hdr = (rundir / "o.00002.chkpt").read_text().splitlines()
    cols = next(ln for ln in hdr if ln.startswith("#C")).split()[1:]
    assert cols[9:] == ["ordpar", "n_nbr", "x_ref", "y_ref", "z_ref",
                        "Epot_ref", "eam_rho"]
    stress = np.loadtxt(rundir / "o.2.stress")
    total = stress[:, 6:].sum(0)
    tab = t_forces.compute_eam_forces(st.scene, sim.eam).presstens.numpy()
    assert np.abs(total - tab).max() <= 1e-9 * np.abs(tab).max()
    # the same pairs on the degree-12 fit give the observe()'s tensor;
    # the tables' differs by tens of percent (the fit, ROADMAP C2)
    fit = t_forces.compute_eam_forces(st.scene,
                                      sim.eam_run.at_host_precision())
    scale = np.abs(st.presstens).max()
    assert np.abs(fit.presstens.numpy() - st.presstens).max() \
        <= 1e-8 * scale
    assert np.abs(tab - st.presstens).max() > 0.1 * scale
