"""The port's building blocks vs imd_tpu, on the CPU: cells-last helpers,
grid choice and binning, the potential fit, the wide-range TTM models and
EOS; plus the rule that imd_tpu_torch never imports jax.
"""

import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.models import eos as j_eos
from imd_tpu.models import potential as j_pot
from imd_tpu.models import widerange as j_wr
from imd_tpu.ops import forces as j_forces
from imd_tpu.ops import forces_fast as j_ff
from imd_tpu.ops import fused_step as j_fused
from imd_tpu.ops import geometry as j_geom
from imd_tpu.scene import make_scene as j_make_scene
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import convert, integrate
from imd_tpu_torch.models import eos as t_eos
from imd_tpu_torch.models import potential as t_pot
from imd_tpu_torch.models import widerange as t_wr
from imd_tpu_torch.ops import forces as t_forces
from imd_tpu_torch.ops import forces_fast as t_ff
from imd_tpu_torch.ops import fused_step as t_fused
from imd_tpu_torch.ops import geometry as t_geom
from imd_tpu_torch.scene import make_scene as t_make_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grid_pair(dims, pbc):
    """Matching JAX and port CellGrids of the given dims (f64 box)."""
    L = [5.5 * d + 0.3 for d in dims]
    jbox = j_geom.Box.create([L[0], 0, 0], [0, L[1], 0], [0, 0, L[2]],
                             pbc=pbc, dtype=jnp.float64)
    jgrid = j_geom.CellGrid(box=jbox, dims=dims, capacity=3, cutoff=5.0,
                            skin=0.5)
    return jgrid, convert.from_grid(jgrid)


@pytest.mark.parametrize("dims,pbc", [((1, 2, 3), (1, 1, 1)),
                                      ((3, 2, 2), (1, 1, 1)),
                                      ((2, 3, 1), (0, 1, 1)),
                                      ((4, 3, 5), (1, 0, 1))])
def test_cells_last_helpers_match_jax(dims, pbc):
    jgrid, tgrid = _grid_pair(dims, pbc)
    a = np.random.default_rng(0).normal(size=dims + (3, 3))
    cl = t_ff._to_cl(torch.as_tensor(a), dims)
    np.testing.assert_array_equal(cl.numpy(), j_ff._to_cl(jnp.asarray(a),
                                                          dims))
    np.testing.assert_array_equal(t_ff._from_cl(cl, dims).numpy(), a)
    for off in t_forces.ALL_OFFSETS:
        rolled = t_ff._roll_cells(cl, dims, off)
        np.testing.assert_array_equal(
            rolled.numpy(),
            j_ff._roll_cells(jnp.asarray(cl.numpy()), dims, off),
            err_msg=str(off))
        np.testing.assert_array_equal(
            t_ff._roll_cells_back(rolled, dims, off).numpy(), cl.numpy())
        shift, ok = t_ff._wrap_shift_mask_cl(tgrid, off, torch.float64)
        jshift, jok = j_ff._wrap_shift_mask_cl(jgrid, off, jnp.float64)
        np.testing.assert_array_equal(shift.numpy(), jshift)
        np.testing.assert_array_equal(ok.numpy(), jok)
    assert t_forces.HALF_OFFSETS == j_forces.HALF_OFFSETS


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grid_and_binning_match_jax(dtype):
    pos, _, diag = fcc((6, 5, 5), 4.05)
    pos = pos + 1.0
    jbox = j_geom.Box.create([diag[0], 0, 0], [0, diag[1], 0],
                             [0, 0, diag[2]], dtype=dtype)
    tbox = t_geom.Box.create([diag[0], 0, 0], [0, diag[1], 0],
                             [0, 0, diag[2]], dtype=dtype)
    np.testing.assert_array_equal(tbox.h, np.asarray(jbox.h))
    np.testing.assert_array_equal(tbox.inv_h, np.asarray(jbox.inv_h))
    jg = j_geom.choose_grid(jbox, 5.0, skin=0.5, n_atoms=len(pos))
    tg = t_geom.choose_grid(tbox, 5.0, skin=0.5, n_atoms=len(pos))
    assert (tg.dims, tg.capacity) == (jg.dims, jg.capacity)
    jg = j_geom.with_capacity(jg, j_geom.measured_capacity(jg, pos,
                                                           dtype=dtype))
    tg = t_geom.with_capacity(tg, t_geom.measured_capacity(tg, pos,
                                                           dtype=dtype))
    assert tg.capacity == jg.capacity
    assert t_geom.optimize_grid_dims(tbox, 5.0, 0.5, pos, dtype=dtype,
                                     max_capacity=32) \
        == j_geom.optimize_grid_dims(jbox, 5.0, 0.5, pos, dtype=dtype,
                                     max_capacity=32)
    mass = np.full(len(pos), 26.9815)
    mom = np.random.default_rng(1).normal(size=pos.shape)
    js = j_make_scene(jg, pos, mom=mom, mass=mass, dtype=dtype)
    ts = t_make_scene(tg, pos, mom=mom, mass=mass,
                      dtype={np.float32: torch.float32,
                             np.float64: torch.float64}[dtype],
                      device="cpu")
    for name in ("pos", "mom", "mass", "type", "vtype", "id",
                 "nbl_ref_pos", "overflow"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    jcl, tcl = j_fused.scene_to_cl(js), t_fused.scene_to_cl(ts)
    for name, v in convert.to_numpy(tcl).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jcl, name)),
                                      err_msg=name)
    back = t_fused.cl_to_scene(tcl, ts)
    np.testing.assert_array_equal(back.pos.numpy(), ts.pos.numpy())
    np.testing.assert_array_equal(back.id.numpy(), ts.id.numpy())


def test_fastpoly_fit_matches_jax():
    kw = dict(r_cut=5.0, r0=4.05 / math.sqrt(2.0), E_c=3.39)
    jeam = j_pot.eam_to_fastpoly(j_pot.analytic_eam(dtype=jnp.float32, **kw))
    team = t_pot.eam_to_fastpoly(t_pot.analytic_eam(dtype=np.float32, **kw))
    for name in ("pair", "rho", "embed"):
        (jc, jb, je), = getattr(jeam, name).host
        (tc, tb, te), = getattr(team, name).host
        assert (tb, te) == (jb, je)
        np.testing.assert_allclose(tc, jc, rtol=1e-12, atol=0)
        x = torch.linspace(tb - 1.0, te + 1.0, 257, dtype=torch.float64)
        for got, want in zip(getattr(team, name).interp(0, x),
                             getattr(jeam, name).interp(0, jnp.asarray(
                                 x.numpy()))):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                       atol=1e-12)


def test_widerange_and_eos_match_jax():
    rng = np.random.default_rng(5)
    te = 10.0 ** rng.uniform(-2.5, 1.5, 64)
    ti = 10.0 ** rng.uniform(-2.5, 0.0, 64)
    dens = rng.uniform(50.0, 3000.0, 64)
    T = [torch.as_tensor(v) for v in (te, ti, dens)]
    Z = t_wr.mean_charge(T[0], T[2], 13.0, 26.9815)
    np.testing.assert_allclose(
        Z.numpy(), j_wr.mean_charge(te, dens, 13.0, 26.9815), rtol=1e-12)
    ne = Z * T[2] / (26.9815 * t_wr.AMU)
    ne_np = ne.numpy()
    for active in (False, True):
        np.testing.assert_allclose(
            t_wr.get_kappa(T[0], T[1], ne, Z, 2.3e15, active).numpy(),
            j_wr.get_kappa(te, ti, ne_np, Z.numpy(), 2.3e15, active),
            rtol=1e-12)
        np.testing.assert_allclose(
            t_wr.get_gamma(T[0], T[1], ne, Z, 26.9815, 2.3e15,
                           active).numpy(),
            j_wr.get_gamma(te, ti, ne_np, Z.numpy(), 26.9815, 2.3e15,
                           active), rtol=1e-12)
    # u_from_te = ... (sqrt(1+x^2) - 1) cancels at small x: absolute
    # agreement there is at the scale of the largest value
    teos, jeos = t_eos.FEGEos(), j_eos.FEGEos()
    for fn in ("ce", "u_from_te", "te_from_u"):
        want = np.asarray(getattr(jeos, fn)(dens, ne_np, te))
        np.testing.assert_allclose(
            getattr(teos, fn)(T[2], ne, T[0]).numpy(), want, rtol=1e-12,
            atol=1e-12 * np.abs(want).max(), err_msg=fn)


def test_maxwell_is_exact_and_drift_free():
    pos, _, diag = fcc((4, 4, 4), 4.05)
    box = t_geom.Box.create([diag[0], 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], dtype=np.float64)
    grid = t_geom.choose_grid(box, 5.0, skin=0.5, n_atoms=len(pos))
    s = t_make_scene(grid, pos, mass=np.full(len(pos), 26.9815),
                     dtype=torch.float64, device="cpu")
    s = integrate.maxwell(s, 0.026, torch.Generator().manual_seed(4))
    p = s.mom[s.mask]
    assert p.sum(0).abs().max() < 1e-12
    ekin = 0.5 * (p * p).sum() / 26.9815
    assert float(2.0 * ekin / p.numel()) == pytest.approx(0.026, rel=1e-12)


def test_port_never_imports_jax():
    """The card's machine has no JAX: importing every module of the port
    and the CLI, and running a tiny fused TTM step and the driver's entry
    point on the CPU, must load neither jax nor any module of imd_tpu."""
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import imd_tpu_torch\n"
        "for m in pkgutil.walk_packages(imd_tpu_torch.__path__,\n"
        "                               'imd_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from imd_tpu_torch import __main__ as cli, flagship\n"
        "try:\n"
        "    cli.main(['--help'])\n"
        "except SystemExit:\n"
        "    pass\n"
        "f = flagship.build(device='cpu', atoms=864)\n"
        "f.run(2)\n"
        "assert f.counters.steps == 2\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'imd_tpu' or m.startswith('imd_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stdout + res.stderr
