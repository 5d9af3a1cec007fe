"""The 1-D FDTD Maxwell laser, port vs imd_tpu, float64 on the CPU.

The same inputs, made from a seed with NumPy, go through imd_tpu's
models/fdtd.py and ``calc_ttm_fdtd`` and the port's: the parameters and
the PML profile (1e-12), 200 Maxwell steps through the left PML, a vacuum
gap and a Drude-Lorentz slab with the soft source on (each field to 1e-10
of its largest value), a source column beyond the grid (nothing injected,
as imd_tpu's ``.at[].add`` drops it), and ``calc_ttm_fdtd`` over one MD
step on a film behind a vacuum gap: the Maxwell steps and the explicit
diffusion substeps between them (every grid field and every field of the
FDTD state to 1e-10 of its largest value).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu import units as j_units
from imd_tpu.config import FDTDConfig, TTMConfig
from imd_tpu.models import eos as j_eos
from imd_tpu.models import fdtd as j_fdtd
from imd_tpu.models import ttm as j_ttm
from imd_tpu.ops import geometry as j_geom
from imd_tpu_torch import convert
from imd_tpu_torch.config import FDTDConfig as TFDTDConfig
from imd_tpu_torch.models import fdtd as t_fdtd
from imd_tpu_torch.models import ttm as t_ttm
from imd_tpu_torch.models.eos import FEGEos
from imd_tpu_torch.phases import StepCounters

T0 = 30e-15
SIGMA = 20e-15
TOL = 1e-10


def _cfgs(**kw):
    args = dict(enabled=True, lambda_m=800e-9, I0=5e16, t0_s=T0,
                sigma_t_s=SIGMA, **kw)
    return FDTDConfig(**args), TFDTDConfig(**args)


def _close(got, want, what, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def _fields_close(ts, js, what):
    for name in ("ezx", "hy", "jzx", "jlzx", "pzx", "source"):
        _close(getattr(ts, name).numpy(), getattr(js, name),
               f"{what} {name}")


def _slab_grid(jtp, lo, hi, seed):
    """imd_tpu's TTMGrid with cells lo..hi-1 a warm, partly ionized Al
    slab (T_e 0.1-3 eV, n_e, Z, densities from a seed) and vacuum
    elsewhere."""
    rng = np.random.default_rng(seed)
    nx = jtp.nx
    on = (np.arange(nx) >= lo) & (np.arange(nx) < hi)
    te = np.where(on, rng.uniform(0.1, 3.0, nx), 0.0)
    natoms = np.where(on, rng.integers(40, 60, nx), 0).astype(np.int32)
    g = j_ttm.make_grid(jtp, jnp.float64)
    return g.replace(temp=jnp.asarray(te), md_temp=jnp.asarray(0.5 * te),
                     natoms=jnp.asarray(natoms),
                     dens=jnp.asarray(np.where(on, 2700.0, 0.0)),
                     ne=jnp.asarray(np.where(on, rng.uniform(1e29, 3e29, nx),
                                             0.0)),
                     Z=jnp.asarray(np.where(on, rng.uniform(2.0, 3.5, nx),
                                            0.0)))


def _params(nx=80, fd_h_x=8.0, **kw):
    tp = j_ttm.TTMParams(nx=nx, fd_h_x=fd_h_x, fd_vol=fd_h_x * 100.0,
                         neigh_vol=523.6, atomic_mass=26.9815,
                         atomic_z=13.0, fd_min_atoms=8)
    jc, tc = _cfgs(**kw)
    jp = j_fdtd.make_fdtd_params(jc, tp, jnp.float64)
    return tp, jp, t_fdtd.make_fdtd_params(tc, convert.from_ttm_params(tp),
                                           torch.float64, "cpu")


def test_params_match_jax():
    """make_fdtd_params, the PML profile, the outer-loop count and the
    pulse switch: the port's equal imd_tpu's."""
    torch.set_num_threads(1)
    tp, jp, tpar = _params()
    conv = convert.fdtd_params_from_jax(jp, device="cpu")
    for name in ("nx", "fd_dx_m", "dt_s", "sc", "bw", "srcx", "e0",
                 "nlambda", "t0_s", "sigma_t_s", "threshold",
                 "fd_min_atoms"):
        assert getattr(tpar, name) == getattr(jp, name) \
            == getattr(conv, name), name
    _close(tpar.sigma_y.numpy(), jp.sigma_y, "sigma_y", 1e-12)
    assert float(tpar.sigma_y[0]) > 0.0 and float(tpar.sigma_y[40]) == 0.0
    for dt in (0.01, 0.1, 0.35):
        assert t_fdtd.fdtd_substeps_per_md(tpar, dt) \
            == j_fdtd.fdtd_substeps_per_md(jp, dt)
    for t_s in (-60e-15, 0.0, T0, 100e-15, 200e-15):
        assert t_fdtd.laser_on(tpar, t_s) == bool(j_fdtd.laser_on(jp, t_s))
    _close(t_fdtd.source_envelope(tpar, torch.tensor(T0 + 5e-15,
                                                     dtype=torch.float64)),
           j_fdtd.source_envelope(jp, jnp.float64(T0 + 5e-15)), "envelope",
           1e-14)


@pytest.mark.parametrize("srcx", ["inside", "beyond"])
def test_step_1d_matches_jax(srcx):
    """200 Maxwell steps from the pulse's rise on 80 cells of 8 A: the soft
    source at cell 18 (or, with ``pml 90``, beyond the grid: no field at
    all), the left PML, vacuum and a 20-cell Drude-Lorentz slab (fit_dl of
    a warm slab) whose currents heat it.  Every field to 1e-10 of its
    largest value after 50 and after 200 steps."""
    torch.set_num_threads(1)
    kw = {} if srcx == "inside" else {"pml": 90}
    tp, jp, tpar = _params(**kw)
    jg = _slab_grid(tp, 40, 60, 7)
    tg = convert.from_ttm_grid(jg, device="cpu")
    jdl = j_fdtd.fit_dl(jg, tp)
    tdl = t_fdtd.fit_dl(tg, convert.from_ttm_params(tp))
    _close(tdl.numpy(), jdl, "fit_dl", 1e-12)
    jact = jg.natoms >= tp.fd_min_atoms
    tact = tg.natoms >= tp.fd_min_atoms
    js = j_fdtd.make_state(jp, jnp.float64)
    ts = convert.fdtd_state_from_jax(js, device="cpu")
    for name in ("ezx", "hy", "source"):
        assert torch.equal(getattr(ts, name), getattr(
            t_fdtd.make_state(tpar, torch.float64, "cpu"), name))
    t_start = T0 - 1.5 * SIGMA
    for n0, n in ((0, 50), (50, 150)):
        t1 = t_start + n0 * jp.dt_s
        js = j_fdtd.run_substeps(js, jp, jdl, jact, jnp.float64(t1), n)
        ts = t_fdtd.run_substeps(ts, tpar, tdl, tact,
                                 torch.tensor(t1, dtype=torch.float64), n)
        _fields_close(ts, js, f"after {n0 + n} steps")
    peak = float(ts.ezx.abs().max())
    if srcx == "inside":
        assert peak > 1e7 and float(ts.source[40:60].max()) > 0.0
    else:
        assert tpar.srcx >= tpar.nx and peak == 0.0


def _film(seed):
    """Flat atoms of a 6 x 4 x 4 fcc Al film (384 atoms) behind 110 A of
    vacuum, 0.05 eV NumPy momenta, 10-14 neighbours each; the box."""
    from imd_tpu.utils.generate import fcc
    pos, _, diag = fcc((6, 4, 4), 4.05)
    pos[:, 0] += 110.0
    box = j_geom.Box.create([diag[0] + 114.0, 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], pbc=(0, 1, 1),
                            dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    n = len(pos)
    mass = np.full(n, 26.9815)
    mom = rng.normal(size=(n, 3)) * np.sqrt(mass[:, None] * 0.05)
    nn = rng.integers(10, 15, n).astype(np.int32)
    return box, pos[:, 0], mom, mass, nn


def test_calc_ttm_fdtd_matches_jax():
    """calc_ttm_fdtd over one MD step of 0.05 (about 570 Maxwell steps on
    24 cells of 5.9 A, each followed by the explicit diffusion substeps
    the CFL count asks for) at the pulse's peak, the film warm: every grid
    field and every FDTD field to 1e-10 of its largest value, the FD index
    equal; one host read, the Maxwell steps and substeps counted."""
    torch.set_num_threads(1)
    box, x, mom, mass, nn = _film(3)
    tcfg = TTMConfig(enabled=True, fd_nx=24, fd_min_atoms=8)
    jtp = j_ttm.make_params(tcfg, box, 5.0, jnp.float64)
    tp = convert.from_ttm_params(jtp)
    jc, tc = _cfgs()
    jp = j_fdtd.make_fdtd_params(jc, jtp, jnp.float64)
    tpar = t_fdtd.make_fdtd_params(tc, tp, torch.float64, "cpu")
    assert tpar.srcx == 18 and x.min() > 18 * tp.fd_h_x
    jgrid = j_ttm.make_grid(jtp, jnp.float64)
    jgrid = jgrid.replace(temp=jnp.full_like(jgrid.temp, 0.3),
                          init_done=jnp.ones((), bool))
    tgrid = convert.from_ttm_grid(jgrid, device="cpu")
    js = j_fdtd.make_state(jp, jnp.float64)
    ts = t_fdtd.make_state(tpar, torch.float64, "cpu")
    n = len(x)
    dt = 0.05
    t = T0 / j_units.IMD_TIME_S
    jgrid, jfdi, js = j_ttm.calc_ttm_fdtd(
        jgrid, js, (jnp.asarray(x), tuple(jnp.asarray(mom[:, c])
                                          for c in range(3)),
                    jnp.asarray(mass), jnp.ones(n, bool)),
        jtp, j_eos.FEGEos(), jp, jnp.asarray(nn), jnp.full(n, -1, jnp.int32),
        dt, jnp.float64(t), first_step=True)
    counters = StepCounters()
    tgrid, tfdi, ts = t_ttm.calc_ttm_fdtd(
        tgrid, ts, (torch.as_tensor(x), tuple(torch.as_tensor(mom[:, c])
                                              for c in range(3)),
                    torch.as_tensor(mass), torch.ones(n, dtype=torch.bool)),
        tp, FEGEos(), tpar, torch.as_tensor(nn),
        torch.full((n,), -1, dtype=torch.int32), dt,
        torch.tensor(t, dtype=torch.float64), t, first_step=True,
        counters=counters)
    _fields_close(ts, js, "FDTD state")
    for name, v in convert.to_numpy(tgrid).items():
        w = np.asarray(getattr(jgrid, name))
        if name in ("init_done", "cfl_overflow"):
            assert bool(v) == bool(w), name
        elif np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(v, w, err_msg=name)
        else:
            _close(v, w, name)
    np.testing.assert_array_equal(tfdi.numpy(), np.asarray(jfdi))
    n_fdtd = t_fdtd.fdtd_substeps_per_md(tpar, dt)
    assert counters.host_syncs == 1 and counters.maxwell_steps == n_fdtd
    assert counters.cfl_substeps % n_fdtd == 0
    assert float(tgrid.eabs) > 0.0 and float(ts.source.max()) > 0.0
    assert math.isfinite(float(tgrid.temp.max()))
