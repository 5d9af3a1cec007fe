"""COLRAD, port vs imd_tpu, float64 on the CPU.

The same inputs, made from a seed with NumPy, go through imd_tpu's
models/colrad.py and the port's: the rate tables of the closed-form fits
(1e-12) and of the reference's integrals at a small ``nt`` (1e-12), the
RHS of the rate network with and without the MULTIPHOTON channels (1e-12
of each output's largest value), the written-out Newton Jacobian against
``jax.jacfwd`` (1e-10 of its largest entry), the adaptive backward-Euler
step on six cells (1e-8 of each cell's total), and ``apply_colrad`` on a
TTM grid of hot, cold, fresh and inactive cells (1e-8 of each cell's
total; T_e, n_e and <Z> to 1e-8 relative).  The port's loop reads "any
cell still running" to the host every few tries; the tries it runs past
the last cell's end change nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.models import colrad as jc
from imd_tpu.models import ttm as j_ttm
from imd_tpu_torch import convert
from imd_tpu_torch.models import colrad as tc
from imd_tpu_torch.phases import StepCounters

MPI = jc.mpi_constants(800e-9)
PHI = 2e35          # photons / m^2 / s: ~5e16 W/m^2 at 800 nm
DT_S = 0.1 * 10.18e-15


@pytest.fixture(scope="module")
def tables():
    """imd_tpu's fit tables (float64) and the port's built from the same
    level set, and the port's converted from imd_tpu's."""
    torch.set_num_threads(1)
    st = jc.aluminium_states(3, 4)
    jt = jc.build_tables(st, dtype=jnp.float64)
    tt = tc.build_tables(tc.aluminium_states(3, 4), dtype=torch.float64,
                         device="cpu")
    return jt, tt


def _f64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _assert_tables(tt, jt, rtol):
    for name in ("log_te", "k_exc", "exc_de", "k_ion", "k_rr", "ion_chi",
                 "g", "zq", "e_ev"):
        want = np.asarray(getattr(jt, name))
        got = getattr(tt, name).numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                   err_msg=name)
    for name in ("exc_i", "exc_j", "ion_i", "ion_j"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(),
                                      np.asarray(getattr(jt, name)),
                                      err_msg=name)
    assert tt.n_lev == jt.n_lev


def test_fit_tables_match_jax(tables):
    """The closed-form fits (van Regemorter, Lotz, Kramers) on the
    256-point log grid: the same numbers, the same transitions."""
    jt, tt = tables
    _assert_tables(tt, jt, 1e-12)
    assert tt.k_exc.shape == (24, 256) and tt.k_ion.shape == (16, 256)


def test_ref_tables_match_jax():
    """``rates="ref"``: the reference's Mott / Fermi-Dirac integrals
    (models/colrad_ref.py) at nt 3 on two stages of two levels."""
    jt = jc.build_tables(jc.aluminium_states(1, 2), nt=3, dtype=jnp.float64,
                         rates="ref")
    tt = tc.build_tables(tc.aluminium_states(1, 2), nt=3,
                         dtype=torch.float64, device="cpu", rates="ref")
    _assert_tables(tt, jt, 1e-12)
    assert float(tt.k_ion.max()) > 0.0


def _cells(n, seed):
    """n cells of populations (N28 units), T_e from 0.02 to 80 eV and n_e,
    one cell all-neutral-ground."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 6.0, (n, 17)) * rng.uniform(0, 1, (n, 17)) ** 3
    c[0] = 0.0
    c[0, 0] = 6.0
    te = np.exp(rng.uniform(np.log(0.02), np.log(80.0), n))
    ne = rng.uniform(0.01, 20.0, n)
    return c, te, ne


@pytest.mark.parametrize("laser", [False, True])
def test_rhs_matches_jax(tables, laser):
    """colrad_rhs on 8 cells, batched in the port, cell by cell in
    imd_tpu: dc/dt, dne/dt, P_e and the five power densities to 1e-12 of
    each output's largest value."""
    jt, tt = tables
    c, te, ne = _cells(8, 1)
    jl = (jnp.asarray(PHI),) + MPI if laser else None
    tl = (_f64(PHI),) + MPI if laser else None
    dc, dne, pe, diag = tc.colrad_rhs(_f64(c), _f64(te), _f64(ne), tt, True,
                                      tl)
    out = jax.jit(jax.vmap(
        lambda a, b, d: jc.colrad_rhs(a, b, d, jt, True, jl)))(
        jnp.asarray(c), jnp.asarray(te), jnp.asarray(ne))
    want = [(out[0][i], out[1][i], out[2][i],
             {k: v[i] for k, v in out[3].items()}) for i in range(len(te))]

    def close(got, w, what):
        w = np.asarray(w)
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=1e-12 * max(np.abs(w).max(), 1e-300),
                                   err_msg=what)

    close(dc.numpy(), [w[0] for w in want], "dc")
    close(dne.numpy(), [w[1] for w in want], "dne")
    close(pe.numpy(), [w[2] for w in want], "P_e")
    for key in tc.POWER_KEYS:
        close(diag[key].numpy(), [w[3][key] for w in want], key)
    mpi = diag["P_MPI2"].numpy() + diag["P_MPI3"].numpy()
    assert (mpi > 0).any() == laser


@pytest.mark.parametrize("case", ["evolve_te_laser", "fixed_te", "no_ipd"])
def test_jacobian_matches_jacfwd(tables, case):
    """The written-out Jacobian of the solver's RHS (``step.rhs_jac``)
    against ``jax.jacfwd`` of imd_tpu's per-cell RHS, 1e-10 of its largest
    entry per cell: with T_e in the state and the MULTIPHOTON channels,
    with T_e fixed, and without the IPD."""
    jt, tt = tables
    evolve = case == "evolve_te_laser"
    ipd = case != "no_ipd"
    mpi = MPI if evolve else None
    c, te, ne = _cells(6, 2)
    ce = np.random.default_rng(3).uniform(1e-6, 1e-4, len(te))
    nlev = jt.n_lev
    y = np.concatenate([c, ne[:, None]] + ([te[:, None]] if evolve else []),
                       1)
    step = tc.make_colrad_step(tt, use_ipd=ipd, evolve_te=evolve,
                               mpi_const=mpi)
    r, jac = step.rhs_jac(_f64(y), _f64(te), _f64(ce), _f64(PHI))

    def rhs(yy, te_i, ce_i):
        te_cur = yy[nlev + 1] if evolve else te_i
        dc, dne, pe, _ = jc.colrad_rhs(
            yy[:nlev], te_cur, yy[nlev], jt, ipd,
            None if mpi is None else (jnp.asarray(PHI),) + mpi)
        out = [dc, dne[None]]
        if evolve:
            out.append((pe * 1e-2 / jnp.maximum(ce_i, 1e-12))[None])
        return jnp.concatenate(out)

    args = (jnp.asarray(y), jnp.asarray(te), jnp.asarray(ce))
    want = np.asarray(jax.jit(jax.vmap(jax.jacfwd(rhs)))(*args))
    val = np.asarray(jax.jit(jax.vmap(rhs))(*args))
    for i in range(len(te)):
        np.testing.assert_allclose(jac[i].numpy(), want[i], rtol=0,
                                   atol=1e-10 * np.abs(want[i]).max(),
                                   err_msg=f"cell {i}")
        np.testing.assert_allclose(r[i].numpy(), val[i], rtol=0,
                                   atol=1e-12 * np.abs(val[i]).max())


NTOT = 6e28         # 1/m^3, solid aluminium


def _pops(stage_share):
    """Populations (1/m^3) with the given share of NTOT per charge stage
    (0..4), 90% of a stage in its ground level and the rest spread over
    its three excited levels; and n_e = sum z c."""
    c = np.zeros(17)
    for z, share in enumerate(stage_share):
        if z == 4:
            c[16] = share * NTOT
        else:
            c[4 * z] = 0.9 * share * NTOT
            c[4 * z + 1:4 * z + 4] = share * NTOT * np.array([0.06, 0.03,
                                                              0.01])
    zq = np.repeat(np.arange(5), [4, 4, 4, 4, 1])
    return c, float((zq * c).sum())


def _six_cells():
    """Populations (1/m^3), T_e, n_e, C_e (eV/(eV A^3)) of six cells: a hot
    one, a cold one, a fresh one (all-neutral-ground with apply_colrad's
    seed n_e), a warm one, an empty one and a very hot one; C_e of the
    order the FEG EOS gives at that T_e."""
    rows = [_pops([0.1, 0.5, 0.3, 0.1, 0.0]),
            _pops([0.9999, 1e-4, 0.0, 0.0, 0.0]),
            (np.eye(17)[0] * NTOT, 1e-4 * NTOT),
            _pops([0.99, 0.01, 0.0, 0.0, 0.0]),
            (np.zeros(17), 1e20),
            _pops([0.0, 0.05, 0.25, 0.5, 0.2])]
    c = np.stack([r[0] for r in rows])
    ne = np.array([r[1] for r in rows])
    te = np.array([8.0, 0.03, 1.5, 0.5, 2.0, 40.0])
    ce = np.array([2e-4, 3e-6, 1e-4, 4e-5, 1e-4, 3e-4])
    return c, te, ne, ce


@pytest.mark.parametrize("evolve_te", [False, True])
def test_colrad_step_matches_jax(tables, evolve_te):
    """make_colrad_step over one MD step (0.1 IMD time units) on six
    cells: with T_e fixed (P_e out) and with T_e in the state and the
    MULTIPHOTON channels (T_e out).  Populations to 1e-8 of each cell's
    total, n_e and the third output to 1e-8 relative, the power
    densities to 1e-8 of their largest; the host reads and the tries are
    counted."""
    jt, tt = tables
    c, te, ne, ce = _six_cells()
    mpi = MPI if evolve_te else None
    js = jc.make_colrad_step(jt, evolve_te=evolve_te, mpi_const=mpi)
    ts = tc.make_colrad_step(tt, evolve_te=evolve_te, mpi_const=mpi)
    want = js(jnp.asarray(c), jnp.asarray(te), jnp.asarray(ne),
              jnp.asarray(DT_S), jnp.asarray(ce), jnp.asarray(PHI))
    counters = StepCounters()
    got = ts(_f64(c), _f64(te), _f64(ne), _f64(DT_S), _f64(ce), _f64(PHI),
             counters=counters)
    wc = np.asarray(want[0])
    tot = np.maximum(wc.sum(1), 1.0)[:, None]
    np.testing.assert_allclose(got[0].numpy() / tot, wc / tot, rtol=0,
                               atol=1e-8)
    for k in (1, 2):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-8,
                                   atol=1e-8 * np.abs(w).max() * (k == 2))
    for key in tc.POWER_KEYS:
        w = np.asarray(want[3][key])
        np.testing.assert_allclose(got[3][key].numpy(), w, rtol=0,
                                   atol=1e-8 * max(np.abs(w).max(), 1e-300),
                                   err_msg=key)
    # the fresh cell ionizes, the populations stay non-negative
    assert got[1][2] > ne[2] and bool((got[0] >= 0).all())
    assert counters.colrad_tries >= tc._fewest_tries(16)
    assert counters.host_syncs == 1 + (counters.colrad_tries
                                       - tc._fewest_tries(16)) // 2


def test_apply_colrad_matches_jax(tables):
    """apply_colrad on a 6-cell TTM grid: a hot cell, a cold one, a fresh
    active one (no populations yet: seeded all-neutral-ground), a warm
    one, an inactive one (too few atoms: left as it was) and a hot dense
    one, with the MULTIPHOTON flux.  The grid's T_e, n_e, Z and the
    populations and power columns against imd_tpu's (converted tables
    and state)."""
    jt, _ = tables
    tt = convert.colrad_tables_from_jax(jt, device="cpu")
    c, te, ne, ce = _six_cells()
    c[2] = 0.0
    jtp = j_ttm.TTMParams(nx=6, fd_h_x=10.0, fd_vol=1e3, neigh_vol=523.6,
                          atomic_mass=26.9815, atomic_z=13.0, fd_min_atoms=8)
    tp = convert.from_ttm_params(jtp)
    jgrid = j_ttm.make_grid(jtp, jnp.float64)
    jgrid = jgrid.replace(
        temp=jnp.asarray(te), ne=jnp.asarray(ne), Ce=jnp.asarray(ce),
        Z=jnp.full(6, 2.0), dens=jnp.asarray([2700.0, 2650.0, 2400.0,
                                              2700.0, 2700.0, 3000.0]),
        natoms=jnp.asarray([60, 58, 50, 61, 3, 66], jnp.int32))
    tgrid = convert.from_ttm_grid(jgrid, device="cpu")
    jcs = jc.ColradGridState(c=jnp.asarray(c), p=jnp.zeros((6, 5)))
    tcs = convert.colrad_state_from_jax(jcs, device="cpu")
    js = jc.make_colrad_step(jt, evolve_te=True, mpi_const=MPI)
    ts = tc.make_colrad_step(tt, evolve_te=True, mpi_const=MPI)
    jg, jcs2, _ = jc.apply_colrad(jgrid, jcs, jt, jtp, js, jnp.float64(0.1),
                                  jnp.asarray(PHI))
    tg, tcs2, _ = tc.apply_colrad(tgrid, tcs, tt, tp, ts, 0.1, _f64(PHI))
    for name in ("temp", "ne", "Z"):
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   np.asarray(getattr(jg, name)), rtol=1e-8,
                                   atol=0, err_msg=name)
    wc = np.asarray(jcs2.c)
    tot = np.maximum(wc.sum(1), 1.0)[:, None]
    np.testing.assert_allclose(tcs2.c.numpy() / tot, wc / tot, rtol=0,
                               atol=1e-8)
    wp = np.asarray(jcs2.p)
    np.testing.assert_allclose(tcs2.p.numpy(), wp, rtol=0,
                               atol=1e-8 * np.abs(wp).max())
    # the fresh cell was seeded and ionized; the inactive one kept its state
    assert tcs2.c[2].sum() > 0 and float(tg.Z[2]) > 0.0
    np.testing.assert_array_equal(tcs2.c[4].numpy(), c[4])
    assert float(tg.temp[4]) == te[4]
