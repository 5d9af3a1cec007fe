"""The typed pair engine, port vs imd_tpu on the CPU: B6 for 2-4 species
(``compute_pair_forces_pallas(..., ntypes=nt)``, assembled from K12-mt's
plain version ``pair_half_mt_plain``) against imd_tpu's XLA engine
``compute_pair_forces_fast`` (ops/forces_fast.py:136) fed the same
degree-12 fastpoly fit, whose typed ``interp`` reads column t_i * nt + t_j
(models/potential.py:943-953).

The fit is made at float64 (``to_fastpoly(..., dtype=float64)``), so that
the coefficients imd_tpu's ``interp`` evaluates are the float64 ``host``
tuple that the port's kernels and plain versions bake.  Inputs come from
NumPy seeds: fcc 5x4x4 at the binary model's 3.705 A (grid (3,2,2),
capacity 48), with 1 A of vacuum along x where that face is open,
jittered by 0.02 A (about the rms
thermal displacement at the binary model's quench temperature of 0.01
eV: 0.01 eV over the A-A well's curvature 72 eps / sigma^2, 3.7 eV/A^2,
summed over a few bonds), the types shuffled over the atoms (two species
75/25 as the binary model, a random alloy as its quenched glass is; more
in equal shares), periodic and with an open x face; two species take the
Kob-Andersen ratios of the binary model, three and four seeded LJ columns
(r_cut 5.0 for every pair: the columns end together, ROADMAP C10).  In
float64: force and per-atom energy to 1e-12 of their largest value, the
neighbour count (within 4.5 A) exact, the virial and the pressure tensor
to 1e-12 of the summed magnitudes of their pair terms (the sums cancel to
a few percent of those: the two packages round the fit's Horner in
different orders, ~1e-16 of each term).  imd_tpu's reference runs eagerly
(a jit costs 3-10 s of compile, the eager run 0.2-0.5 s).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.models import potential as j_pot
from imd_tpu.ops import forces_fast as j_ff
from imd_tpu.ops import geometry as j_geom
from imd_tpu.scene import make_scene as j_make_scene
from imd_tpu.utils.generate import fcc
from imd_tpu_torch import convert
from imd_tpu_torch import simulation as t_sim
from imd_tpu_torch.config import SimConfig as TSimConfig
from imd_tpu_torch.config import parse_param_text
from imd_tpu_torch.models import potential as t_pot
from imd_tpu_torch.models.potential import write_pot_table
from imd_tpu_torch.ops import forces_pallas as t_fp
from imd_tpu_torch.ops import forces_win as t_win
from imd_tpu_torch.ops.forces import HALF_OFFSETS
from imd_tpu_torch.ops.forces_fast import _roll_cells

TOL = 1e-12
NR2 = 4.5 ** 2
# the binary model's pairs AA, AB, BB (IMD's LJ: sigma at the minimum)
KA_EPS = (0.35, 0.525, 0.175)
KA_SIG = (2.62, 2.096, 2.3056)


def lj_params(nt: int):
    """Upper-triangular (eps, sigma) of ``nt`` species."""
    if nt == 2:
        return list(KA_EPS), list(KA_SIG)
    k = nt * (nt + 1) // 2
    rng = np.random.default_rng(10 + nt)
    return list(rng.uniform(0.2, 0.5, k)), list(rng.uniform(2.1, 2.7, k))


def typed_fit(nt: int):
    """imd_tpu's degree-12 fastpoly fit (vcap 50) of the LJ table, at
    float64 so that its coefficients are its host tuple."""
    eps, sig = lj_params(nt)
    k = nt * (nt + 1) // 2
    tab = j_pot.lj_table(eps, sig, [5.0] * k, ntypes=nt, dtype=jnp.float64)
    return j_pot.to_fastpoly(tab, vcap=50.0, dtype=jnp.float64)


def typed_scene(pbc, nt: int, seed: int = 3, jitter: float = 0.02):
    """fcc 5x4x4 at 3.705 A, jittered (0.02 A), 1 A of vacuum along x if
    that face is open, types shuffled: 75/25 for two species, else equal
    shares."""
    pos, _, diag = fcc((5, 4, 4), 3.705)
    rng = np.random.default_rng(seed)
    pos = pos + 0.3 + rng.normal(scale=jitter, size=pos.shape)
    vac = 0.0 if pbc[0] else 1.0
    box = j_geom.Box.create([diag[0] + vac, 0, 0], [0, diag[1], 0],
                            [0, 0, diag[2]], pbc=pbc, dtype=jnp.float64)
    grid = j_geom.choose_grid(box, 5.0, skin=0.5, n_atoms=len(pos),
                              capacity=48)
    typ = rng.permutation((np.arange(len(pos)) % 4 == 3).astype(int)
                          if nt == 2 else np.arange(len(pos)) % nt)
    return j_make_scene(grid, pos, type=typ, dtype=jnp.float64,
                        mass=np.full(len(pos), 26.9815),
                        id=rng.permutation(len(pos)))


def term_scale(tscene, tpot, nt: int) -> np.ndarray:
    """Per Voigt component, the sum over the in-cutoff pairs of live slots
    of |g d_a d_b| (g = 2 dphi/dr^2 on the pair's column): what the
    pressure tensor and the virial sum before they cancel."""
    xi, nbr, mask, typ = t_fp._prep(tscene)
    dims = tscene.grid.dims
    t = typ.clamp(0, nt - 1)
    out = np.zeros(6)
    for m, dx, dy, dz, r2, insf in t_fp._half_pairs(
            xi, nbr, float(tscene.grid.cutoff) ** 2):
        tj = t if m < 0 else _roll_cells(t, dims, HALF_OFFSETS[m])
        mj = mask if m < 0 else _roll_cells(mask, dims, HALF_OFFSETS[m])
        live = (mask[:, None, :] & mj[None, :, :]).to(xi.dtype) * insf
        g = t_win._select_cols(r2, t[:, None, :] * nt + tj[None, :, :],
                               tpot.host, t_win._horner_g) * live
        d = (dx, dy, dz)
        for k, (a, b) in enumerate(t_fp._VOIGT):
            out[k] += float((g * d[a] * d[b]).abs().sum())
    return out


@pytest.mark.parametrize("geom", ["periodic", "open_x"])
@pytest.mark.parametrize("nt", [2, 3, 4])
def test_typed_pair_matches_compute_pair_forces_fast(nt, geom):
    torch.set_num_threads(1)
    pbc = {"periodic": (1, 1, 1), "open_x": (0, 1, 1)}[geom]
    jpot = typed_fit(nt)
    jscene = typed_scene(pbc, nt)
    assert jscene.grid.dims == (3, 2, 2)
    jres = j_ff.compute_pair_forces_fast(jscene, jpot, nt,
                                         count_neighbors=True, neigh_r2=NR2)
    tscene = convert.from_scene(jscene, device="cpu")
    tpot = convert.from_pot(jpot)
    assert tpot.host == jpot.host and len(tpot.host) == nt * nt
    # the table crosses with every column too
    k = nt * (nt + 1) // 2
    jtab = j_pot.lj_table(*lj_params(nt), [5.0] * k, ntypes=nt,
                          dtype=jnp.float64)
    ttab = convert.from_pot(jtab)
    assert ttab.ncols == nt * nt
    np.testing.assert_array_equal(ttab.table, np.asarray(jtab.table))
    tres = t_fp.compute_pair_forces_pallas(tscene, tpot, ntypes=nt,
                                           count_neighbors=True,
                                           neigh_r2=NR2)
    for f in ("force", "epot"):
        want = np.asarray(getattr(jres, f))
        np.testing.assert_allclose(getattr(tres, f).numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max(), err_msg=f)
    np.testing.assert_array_equal(tres.num_neighs.numpy(),
                                  np.asarray(jres.num_neighs))
    assert int(tres.num_neighs.sum()) > 0
    scale = term_scale(tscene, tpot, nt)
    np.testing.assert_allclose(tres.presstens.numpy(),
                               np.asarray(jres.presstens), rtol=0,
                               atol=TOL * scale.max(), err_msg="presstens")
    np.testing.assert_allclose(tres.virial.item(), float(jres.virial),
                               rtol=0, atol=TOL * scale[:3].sum())


def test_potfile_columns_ending_apart_are_refused(tmp_path):
    """A two-species potfile whose columns end at different radii raises
    NotImplementedError naming ROADMAP A9b (C10): the fitted engine would
    hold the short column at its nonzero end value out to the cutoff."""
    write_pot_table(t_pot.lj_table([0.35, 0.3, 0.4], [2.62, 2.62, 2.62],
                                   [5.0, 4.5, 5.0], ntypes=2),
                    str(tmp_path / "pair.pt"))
    text = ("coordname _fcc\nbox_param 3 3 3\nbox_unit 3.705\nntypes 2\n"
            "masses 26.98 26.98\npotfile pair.pt\noutfiles u\n"
            "timestep 0.1\nmaxsteps 4\nensemble nve\n")
    cfg = TSimConfig.from_params(parse_param_text(text))
    t_sim.check_ported(cfg)
    with pytest.raises(NotImplementedError, match="C10.*ROADMAP A9b"):
        t_sim.Simulation(cfg, workdir=str(tmp_path), device="cpu")
