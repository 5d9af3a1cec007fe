"""The TMM laser and the implicit TTM solver, port vs imd_tpu, float64 on
the CPU.

The same inputs, made from a seed with NumPy, go through imd_tpu's
models/tmm.py and models/ttm.py and the port's: the K1/K2 tables, the
wide-range permittivity, ``tmm_solve`` on random column profiles (vacuum
cells in front and holes, an active and an inactive pulse, a film thick
enough for the absorption cutoff and one too thin for it), the tridiagonal
solve of the implicit solver, and ``calc_ttm`` over two MD steps with the
TMM laser and with ``ttm_solver implicit``.  The port's prefix scan
associates the interface-matrix products in another order than imd_tpu's
``associative_scan`` (doubling against odd-even recursion), and gives the
vacuum in front of the film zero thickness (a phase only); both change
the last bits only, well within the stated 1e-9 and 1e-12.  The
thick-film float32 energy check of tests/test_tmm.py runs on the port.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu import units as j_units
from imd_tpu.config import TMMConfig, TTMConfig
from imd_tpu.models import eos as j_eos
from imd_tpu.models import tmm as j_tmm
from imd_tpu.models import ttm as j_ttm
from imd_tpu.ops import geometry as j_geom
from imd_tpu_torch import convert
from imd_tpu_torch.models import tmm as t_tmm
from imd_tpu_torch.models import ttm as t_ttm
from imd_tpu_torch.models.eos import FEGEos
from imd_tpu_torch.phases import StepCounters

T0 = 100e-15
SIGMA = 50e-15


def _cfg():
    return TMMConfig(enabled=True, lambda_m=800e-9, I0=1e17, t0_s=T0,
                     sigma_t_s=SIGMA)


@pytest.fixture(scope="module")
def tmm():
    """imd_tpu's TMMParams and the port's from the same tables."""
    torch.set_num_threads(1)
    jt = j_tmm.make_tmm_params(_cfg(), jnp.float64)
    return jt, convert.tmm_params_from_jax(jt, device="cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_k12_tables_and_params(tmm):
    """The quadrature tables are the same numbers; make_tmm_params builds
    what the converted imd_tpu parameters hold."""
    for a, b in zip(t_tmm.k12_tables(), j_tmm.k12_tables()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_tmm.default_bb_table(),
                                  j_tmm.default_bb_table())
    jt, tt = tmm
    made = t_tmm.make_tmm_params(_cfg(), torch.float64, device="cpu")
    for name in ("k1_tab", "k2_tab", "bb_lam_um", "bb_re", "bb_im"):
        assert torch.equal(getattr(made, name), getattr(tt, name)), name
    assert made.eps_bb == tt.eps_bb
    assert (made.omega, made.k0_per_a) == (jt.omega, jt.k0_per_a)


def _profile(nx, seed, n_vac=4, holes=True):
    """Random column profile: vacuum cells in front (and, with ``holes``,
    two empty cells inside the film), T_e up to 5 eV, Z 1..3, solid to
    half-solid density."""
    rng = np.random.default_rng(seed)
    natoms = rng.integers(20, 200, nx).astype(np.int32)
    natoms[:n_vac] = 0
    dens = rng.uniform(1350.0, 2700.0, nx)
    dens[:n_vac] = 0.0
    if holes:
        natoms[nx // 2] = 0
        dens[nx // 2 + 2] = 1.0
    te = rng.uniform(0.02, 5.0, nx)
    ti = rng.uniform(0.02, 0.5, nx)
    z = rng.uniform(1.0, 3.0, nx)
    ne = z * dens / (26.9815 * j_units.AMU_TO_KG)
    return natoms, dens, te, ti, z, ne


def test_wide_range_epsilon_matches_jax(tmm):
    """The permittivity on random cells (Te 0.02-5 eV, Z 1-3) to 1e-12 of
    |eps|, with the interband term on and switched off in half the
    cells."""
    jt, tt = tmm
    _, dens, te, ti, z, ne = _profile(64, 3, n_vac=0)
    off = np.arange(64) % 2 == 0
    for bb_off in (None, off):
        want = np.asarray(j_tmm.wide_range_epsilon(
            jt, te, ti, z, ne, None if bb_off is None else jnp.asarray(off)))
        got = t_tmm.wide_range_epsilon(
            tt, _t(te), _t(ti), _t(z), _t(ne),
            None if bb_off is None else _t(off)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())


# (cells, cell width A, t_si): a ~3000 A film passes the absorption
# threshold, a 20 A one does not
CASES = {"film_active": (64, 50.0, T0),
         "film_inactive": (64, 50.0, T0 - 8 * SIGMA),
         "thin_active": (10, 2.0, T0)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tmm_solve_matches_jax(tmm, case):
    """tmm_solve on a random profile: the source to 1e-9 of its maximum,
    refl/trans/absorb to 1e-12, ecut, ok and laser_active equal, I_t to
    1e-14 relative.  "thin" is too short for the absorption threshold
    (ok False: the cutoff falls back to the last layer)."""
    jt, tt = tmm
    nx, fd_h, t_si = CASES[case]
    natoms, dens, te, ti, z, ne = _profile(nx, 11 + nx)
    want = j_tmm.tmm_solve(jt, jnp.asarray(natoms), jnp.asarray(dens),
                           jnp.asarray(te), jnp.asarray(ti), jnp.asarray(z),
                           jnp.asarray(ne), jnp.float64(fd_h),
                           jnp.float64(t_si), fd_min_atoms=8)
    got = t_tmm.tmm_solve(tt, _t(natoms), _t(dens), _t(te), _t(ti), _t(z),
                          _t(ne), fd_h, torch.tensor(t_si, dtype=torch.float64),
                          fd_min_atoms=8)
    assert bool(got["laser_active"]) == bool(want["laser_active"]) \
        == case.endswith("_active")
    assert bool(got["ok"]) == bool(want["ok"]) == case.startswith("film")
    assert int(got["ecut"]) == int(want["ecut"])
    np.testing.assert_allclose(float(got["I_t"]), float(want["I_t"]),
                               rtol=1e-14)
    for k in ("refl", "trans", "absorb"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0,
                                   atol=1e-12, err_msg=k)
    src = np.asarray(want["source"])
    np.testing.assert_allclose(got["source"].numpy(), src, rtol=0,
                               atol=1e-9 * max(np.abs(src).max(), 1e-300))
    np.testing.assert_allclose(got["eps"].numpy(), np.asarray(want["eps"]),
                               rtol=0, atol=1e-12 * np.abs(
                                   np.asarray(want["eps"])).max())
    if case == "film_active":
        assert src.max() > 0.0 and 0.0 < float(got["refl"]) < 1.0


def test_thick_film_f32_energy_conservation(tmm):
    """tests/test_tmm.py's thick film on the port in float32 (complex64):
    320 cells, a ~40-optical-depth metal.  The prefix entries grow like
    e^{+kappa x/2} and the amplitudes are their cancellation, so a
    reduced-precision product or a missing depth cutoff absorbs far more
    than arrives; the cutoff must engage inside the film and the absorbed
    flux must match (1 - R - T) I to 5e-3 (the JAX test's bound)."""
    _, tt = tmm
    nx, nvac = 320, 10
    eps = torch.ones(nx, dtype=torch.complex64)
    eps[nvac:] = complex(-60.0, 40.0)
    on = torch.arange(nx) >= nvac
    k0 = float(np.float32(tt.k0_per_a))
    it = torch.tensor(1e16, dtype=torch.float32)
    res = t_tmm.solve_layers(k0, eps, on, 10.0, it, 20.0)
    assert res["qabs_wm3"].dtype == torch.float32
    assert int(res["ecut"]) < nx - 1
    absorbed_flux = float(res["qabs_wm3"].double().sum()) * 10.0 * 1e-10
    incident = float(it)
    assert absorbed_flux < incident
    assert absorbed_flux == pytest.approx(incident * float(res["absorb"]),
                                          rel=5e-3)
    assert 0.0 < float(res["refl"]) < 1.0


@pytest.mark.parametrize("n", [1, 2, 3, 12, 48, 256])
def test_tridiag_solve_matches_thomas(n):
    """The cyclic-reduction solve against imd_tpu's Thomas recurrence on a
    random diagonally dominant system (a[0] and c[-1] zero, as the
    implicit solver builds it): 1e-12 of max |x|."""
    rng = np.random.default_rng(n)
    a = -rng.uniform(0.0, 3.0, n)
    c = -rng.uniform(0.0, 3.0, n)
    a[0] = 0.0
    c[-1] = 0.0
    b = np.abs(a) + np.abs(c) + rng.uniform(1e-3, 2.0, n)
    d = rng.normal(size=n)
    want = np.asarray(j_ttm._thomas(*(jnp.asarray(v) for v in (a, b, c, d))))
    got = t_ttm.tridiag_solve(*(_t(v) for v in (a, b, c, d))).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def _film_atoms(seed):
    """Flat atoms of a 6 x 4 x 4 fcc Al film (384) behind 40 A of vacuum,
    with 0.05 eV NumPy momenta and 10-14 neighbours each; the box."""
    from imd_tpu.utils.generate import fcc
    pos, _, diag = fcc((6, 4, 4), 4.05)
    pos[:, 0] += 40.0
    box = j_geom.Box.create([diag[0] + 44.0, 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], pbc=(0, 1, 1),
                            dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    n = len(pos)
    mass = np.full(n, 26.9815)
    mom = rng.normal(size=(n, 3)) * np.sqrt(mass[:, None] * 0.05)
    nn = rng.integers(10, 15, n).astype(np.int32)
    return box, pos[:, 0], mom, mass, nn


def _grid_close(tg, jg, what):
    """Every field of the port's TTMGrid against imd_tpu's: 1e-9 of the
    field's largest value (integer fields equal)."""
    want = {k: np.asarray(getattr(jg, k)) for k in convert.to_numpy(tg)}
    for k, v in convert.to_numpy(tg).items():
        w = want[k]
        if k in ("init_done", "cfl_overflow"):
            assert bool(v) == bool(w), (what, k)
        elif np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(v, w, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(
                v, w, rtol=0, atol=1e-9 * max(np.abs(w).max(), 1e-300),
                err_msg=f"{what} {k}")


@pytest.mark.parametrize("solver", ["explicit_tmm", "implicit",
                                    "implicit_tmm"])
def test_calc_ttm_matches_jax(tmm, solver):
    """calc_ttm over two MD steps (dt 0.1) on the same flat atoms, the
    second at the pulse peak: with the TMM laser (explicit CFL substeps),
    with ``ttm_solver implicit`` (10 substeps, Lambert-Beer laser) and with
    both.  Every grid field to 1e-9 of its maximum, the stored FD index
    equal; the implicit solver reads no CFL count to the host."""
    from imd_tpu.config import LaserConfig
    jt, tt = tmm
    implicit = solver.startswith("implicit")
    use_tmm = solver.endswith("tmm")
    box, x, mom, mass, nn = _film_atoms(5)
    tcfg = TTMConfig(enabled=True, fd_nx=12, fd_min_atoms=8,
                     solver="implicit" if implicit else "explicit",
                     n_sub=10)
    jtp = j_ttm.make_params(tcfg, box, 5.0, jnp.float64)
    tp = convert.from_ttm_params(jtp)
    laser = None if use_tmm else LaserConfig(
        rescale_mode=4, sigma_e=5.0, sigma_t=5.0, t_0=0.1, mu=0.01)
    jgrid = j_ttm.make_grid(jtp, jnp.float64)
    jgrid = jgrid.replace(temp=jnp.full_like(jgrid.temp, 0.03),
                          init_done=jnp.ones((), bool))
    tgrid = convert.from_ttm_grid(jgrid, device="cpu")
    n = len(x)
    mask = np.ones(n, bool)
    jfdi = jnp.full(n, -1, jnp.int32)
    tfdi = torch.full((n,), -1, dtype=torch.int32)
    counters = StepCounters()
    t_peak = T0 / j_units.IMD_TIME_S
    for k, t in enumerate((t_peak - 0.1, t_peak)):
        xk = x + 0.3 * k
        jgrid, jfdi = j_ttm.calc_ttm(
            jgrid, (jnp.asarray(xk), tuple(jnp.asarray(mom[:, c])
                                           for c in range(3)),
                    jnp.asarray(mass), jnp.asarray(mask)),
            jtp, j_eos.FEGEos(), jnp.asarray(nn), jfdi, jnp.float64(0.1),
            jnp.float64(t), laser_cfg=laser, first_step=(k == 0),
            tmm_params=jt if use_tmm else None)
        tgrid, tfdi = t_ttm.calc_ttm(
            tgrid, (_t(xk), tuple(_t(mom[:, c]) for c in range(3)),
                    _t(mass), _t(mask)),
            tp, FEGEos(), _t(nn), tfdi, 0.1,
            torch.tensor(t, dtype=torch.float64), laser_cfg=laser,
            first_step=(k == 0), tmm_params=tt if use_tmm else None,
            counters=counters)
        _grid_close(tgrid, jgrid, f"step {k}")
        np.testing.assert_array_equal(tfdi.numpy(), np.asarray(jfdi))
    assert float(tgrid.eabs) > 0.0 and float(tgrid.temp.max()) > 0.05
    if implicit:
        assert counters.host_syncs == 0 and counters.cfl_substeps == 20
    else:
        assert counters.host_syncs == 2
