"""The tabulated EOS (``TabulatedEOS``), port vs imd_tpu, float64 on the
CPU.

The test writes the reference's ``nn`` tables (EOS_cve_from_r_te.txt: rho,
T_e [K], cve [J/(K kg)]; EOS_ee_from_r_tesqrt.txt: rho, sqrt(T_e), ee
[J/kg]) from the free-electron gas, as tools/refbuild/make_ttm_fixture.py
does, with the two-line header and without it.  Both packages load them
(scipy's ``griddata`` onto 128 x 128): the same grids and tables bit for
bit; ``ce``, ``u_from_te``, ``pe`` and ``te_from_u`` (40 bisections) on
seeded densities and temperatures, some outside the tables, agree to
1e-12 relative.  A run of the miniature ablation file with ``eos_dir``
pointing at the tables goes through the port's CLI on the tabulated EOS;
a malformed table raises RuntimeError (tests/test_torch_driver.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imd_tpu.models import eos as j_eos
from imd_tpu_torch import __main__ as cli
from imd_tpu_torch import convert, units
from imd_tpu_torch.models import widerange as wr
from imd_tpu_torch.models.eos import FEGEos, TabulatedEOS
from test_torch_ttm_physics_driver import (COLRAD_REWRITES, _mini_text,
                                           _write_start)

MASS = 26.9815
Z = 3.0


def write_feg_tables(out, header=True, nr=40, nt=60):
    """The two tables from FEGEos on a (rho, T_e) grid, in the reference's
    format (the header's bounds one grid line inside the data)."""
    eos = FEGEos(atomic_mass=MASS)
    m_kg = MASS * wr.AMU
    rho = np.linspace(300.0, 8000.0, nr)
    te_k = np.concatenate([np.linspace(20.0, 2000.0, nt // 2),
                           np.linspace(2100.0, 5.8e4, nt - nt // 2)])

    def table(path, xs, ys, zfun):
        R, Y = np.meshgrid(xs, ys, indexing="ij")
        zs = zfun(torch.as_tensor(R), torch.as_tensor(Y)).numpy()
        with open(path, "w") as f:
            if header:
                f.write(f"{len(xs)} {len(ys)}\n")
                f.write(f"{xs[1]:.10e} {xs[-2]:.10e} {ys[1]:.10e} "
                        f"{ys[-2]:.10e}\n")
            for x, y, z in zip(R.ravel(), Y.ravel(), zs.ravel()):
                f.write(f"{x:.10e} {y:.10e} {z:.10e}\n")

    def cve(r, tk):
        ce = eos.ce(r, Z * r / m_kg, tk / wr.EV_TO_K)
        return ce / (r * wr.EV_TO_K * 1e-30 * units.J_TO_EV)

    def ee(r, ts):
        u = eos.u_from_te(r, Z * r / m_kg, ts * ts / wr.EV_TO_K)
        return u * units.EV_TO_J / m_kg
    table(out / "EOS_cve_from_r_te.txt", rho, te_k, cve)
    table(out / "EOS_ee_from_r_tesqrt.txt", rho, np.sqrt(te_k), ee)


@pytest.mark.parametrize("header", [True, False], ids=["header", "bare"])
def test_tabulated_eos_matches_jax(tmp_path, header):
    write_feg_tables(tmp_path, header)
    paths = (str(tmp_path / "EOS_cve_from_r_te.txt"),
             str(tmp_path / "EOS_ee_from_r_tesqrt.txt"))
    je = j_eos.TabulatedEOS.load(*paths, MASS, dtype=jnp.float64)
    te = TabulatedEOS.load(*paths, MASS, dtype=torch.float64, device="cpu")
    for k in ("rho_grid", "tsq_grid", "ee", "cve"):
        np.testing.assert_array_equal(getattr(te, k).numpy(),
                                      np.asarray(getattr(je, k)), err_msg=k)
    assert te.ee.shape == (128, 128)
    via = convert.eos_from_jax(je, "cpu")
    np.testing.assert_array_equal(via.ee.numpy(), te.ee.numpy())

    rng = np.random.default_rng(4)
    n = 200
    dens = rng.uniform(100.0, 9000.0, n)          # some outside the table
    t_ev = np.exp(rng.uniform(np.log(1e-3), np.log(8.0), n))
    ne = Z * dens / (MASS * wr.AMU)
    jd, jn, jt = (jnp.asarray(a) for a in (dens, ne, t_ev))
    td, tn, tt = (torch.as_tensor(a) for a in (dens, ne, t_ev))
    u = te.u_from_te(td, tn, tt)
    for name, got, want in (
            ("ce", te.ce(td, tn, tt), je.ce(jd, jn, jt)),
            ("u_from_te", u, je.u_from_te(jd, jn, jt)),
            ("pe", te.pe(td, tn, tt), je.pe(jd, jn, jt)),
            ("te_from_u", te.te_from_u(td, tn, u),
             je.te_from_u(jd, jn, jnp.asarray(u.numpy())))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=name)
    # the round trip inside the table, within the bisection's resolution
    inside = (dens > 300.0) & (dens < 8000.0) & (t_ev > 0.01) \
        & (t_ev < 4.9)
    back = te.te_from_u(td, tn, u).numpy()
    tsq_span = float(te.tsq_grid[-1] - te.tsq_grid[0])
    res = 2.0 * np.sqrt(t_ev * wr.EV_TO_K) * tsq_span * 2.0 ** -40 \
        / wr.EV_TO_K
    assert (np.abs(back - t_ev)[inside] <= 4.0 * res[inside] + 1e-12
            * t_ev[inside]).all()


def test_eos_tables_run_through_the_cli(tmp_path):
    """The miniature ablation file with ``eos_dir`` on the tables: the run
    takes the tabulated EOS and stays finite."""
    torch.set_num_threads(1)
    _write_start(tmp_path, 2.0)
    (tmp_path / "eos").mkdir()
    write_feg_tables(tmp_path / "eos")
    rewrites = tuple((a, b) for a, b in COLRAD_REWRITES
                     if a.startswith(("ttmdimx", "filter", "I0", "laser")))
    (tmp_path / "t.imd").write_text(
        _mini_text("t", rewrites + (("maxsteps 2000", "maxsteps 4"),
                                    ("eng_int 20", "eng_int 2")))
        + "eos_dir eos\n")
    sims = []
    assert cli.main(["-p", str(tmp_path / "t.imd"), "--device", "cpu",
                     "--dtype", "float64"],
                    on_phase=lambda s, st: sims.append((s, st))) == 0
    sim, st = sims[0]
    assert isinstance(sim.eos, TabulatedEOS) and st.step == 4
    g = st.ttm_grid
    act = g.natoms >= 8
    assert bool(act.any()) and bool(torch.isfinite(g.temp).all())
    assert bool(torch.isfinite(st.scene.pos).all())
    eng = np.loadtxt(tmp_path / "t.eng")
    assert eng.shape == (2, 6) and np.isfinite(eng).all()
