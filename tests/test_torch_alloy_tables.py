"""Alloy potential tables, port vs imd_tpu, from the same synthetic text:
``read_eam`` with ntypes 2 (the host-first density file transposed into
the engine's source-first columns), the DYNAMO readers ``read_setfl``
(eam.alloy and eam.fs) and ``read_funcfl``, ``tile_columns``, and the
carry-over of a 4-column set through ``convert``.  Every table field is
compared exactly (both packages run the same NumPy float64 arithmetic and
round to the same dtype); interpolated values to 1e-12.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imd_tpu.models import potential as j_pot
from imd_tpu.models import setfl as j_setfl
from imd_tpu_torch import convert
from imd_tpu_torch.models import potential as t_pot
from imd_tpu_torch.models import setfl as t_setfl

RC = 5.0
FIELDS = ("table", "begin", "end", "step", "invstep", "length")


def _rho_a(r):
    return 1.2 * (r - RC) ** 2 * np.exp(-0.8 * r)


def _rho_b(r):
    return 0.6 * (r - RC) ** 2 * np.exp(-0.5 * r)


def _phi(a, b):
    return lambda r: a * (r - RC) ** 2 * np.exp(-b * r)


PHI = {(0, 0): _phi(0.4, 0.9), (1, 0): _phi(0.3, 1.1), (1, 1): _phi(0.5, 1.0)}


def _alloy_text(fs, nrho=120, nr=300):
    """A two-element setfl text (as tests/test_eam_alloy_columns.py builds
    it); the fs form carries a host-dependent density per source."""
    drho, dr = 40.0 / (nrho - 1), RC / (nr - 1)
    rs, qs = dr * np.arange(nr), drho * np.arange(nrho)
    out = io.StringIO()
    out.write("two-element synthetic\nalloy columns test\n#\n2 A B\n")
    out.write(f"{nrho} {drho:.10e} {nr} {dr:.10e} {RC:.10e}\n")
    for el, (emb, rho) in enumerate(((-1.3, _rho_a), (-0.9, _rho_b))):
        out.write(f"{13 + el} {26.98 + el} 4.05 fcc\n")
        out.write("\n".join(f"{v:.10e}" for v in emb * np.sqrt(qs)) + "\n")
        for host in range(2 if fs else 1):
            out.write("\n".join(f"{v:.10e}"
                                for v in (1.0 - 0.2 * host) * rho(rs)) + "\n")
    for i in range(2):
        for j in range(i + 1):
            out.write("\n".join(f"{v:.10e}" for v in PHI[(i, j)](rs) * rs)
                      + "\n")
    return out.getvalue()


def _same_table(got, want, name=""):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{name}.{f}")


def _same_eam(got, want):
    for name in ("pair", "rho", "embed"):
        _same_table(getattr(got, name), getattr(want, name), name)


@pytest.mark.parametrize("fs", [False, True], ids=["eam_alloy", "eam_fs"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_read_setfl_matches_jax(fs, dtype):
    text = _alloy_text(fs)
    want, jmeta = j_setfl.read_setfl(text, dtype=getattr(jnp, dtype))
    got, meta = t_setfl.read_setfl(text, dtype=np.dtype(dtype))
    assert meta == jmeta and meta["fs"] == fs and meta["nelem"] == 2
    _same_eam(got, want)
    assert got.pair.ncols == got.rho.ncols == 4 and got.embed.ncols == 2
    # source-first columns: col = s*2 + h; an eam.alloy density ignores h
    tab = got.rho.table
    assert np.array_equal(tab[0], tab[1]) != fs
    assert not np.array_equal(tab[0], tab[2])


def test_read_funcfl_matches_jax_and_bad_counts_raise():
    nrho, nr, drho = 40, 90, 0.1
    dr = RC / (nr - 1)
    rs = dr * np.arange(nr)
    nums = np.concatenate([-np.sqrt(drho * np.arange(nrho)), np.exp(-rs),
                           np.exp(-2 * rs)])
    head = f"funcfl test\n13 26.98 4.05 fcc\n{nrho} {drho} {nr} {dr} {RC}\n"
    text = head + "\n".join(f"{v:.8e}" for v in nums)
    want, jmeta = j_setfl.read_funcfl(text, dtype=jnp.float64)
    got, meta = t_setfl.read_funcfl(text, dtype=np.float64)
    assert meta == jmeta
    _same_eam(got, want)
    v, _ = got.pair.interp(0, np.float64(4.0))
    assert float(v) == pytest.approx(27.2 * 0.529 * np.exp(-2.0) ** 2 / 2.0,
                                     rel=2e-3)
    with pytest.raises(ValueError, match="funcfl body"):
        t_setfl.read_funcfl(head + "\n".join(f"{v:.8e}" for v in nums[:-7]))
    with pytest.raises(ValueError, match="expected"):
        t_setfl.read_setfl(_alloy_text(False).rsplit("\n", 40)[0])
    with pytest.raises(OSError):
        t_setfl.read_setfl("no/such/dir/al.setfl")


def test_maybe_read_dynamo_goes_by_suffix(tmp_path):
    (tmp_path / "ab.eam.alloy").write_text(_alloy_text(False))
    (tmp_path / "ab.eam.fs").write_text(_alloy_text(True))
    for name, fs in (("ab.eam.alloy", False), ("ab.eam.fs", True)):
        eam, meta = t_setfl.maybe_read_dynamo(str(tmp_path / name))
        assert meta["fs"] == fs and eam.pair.table.dtype == np.float32
    assert t_setfl.maybe_read_dynamo(str(tmp_path / "pair.pt")) is None
    assert t_setfl.SETFL_SUFFIXES == j_setfl.SETFL_SUFFIXES
    assert t_setfl.FUNCFL_SUFFIXES == j_setfl.FUNCFL_SUFFIXES


def _three_files(d):
    """The reference's three files for two species, the density file
    host-first: [h0s0, h0s1, h1s0, h1s1] (tests/test_eam_alloy_columns.py
    :166)."""
    r2 = np.linspace(0.25, RC * RC, 600)
    r = np.sqrt(r2)
    step = r2[1] - r2[0]

    def radial(cols):
        return t_pot._make_table(cols, [r2[0]] * 4, [RC * RC] * 4,
                                 [step] * 4, np.float64)
    rho = radial([_rho_a(r), _rho_b(r), 0.8 * _rho_a(r), 0.8 * _rho_b(r)])
    pair = radial([PHI[(0, 0)](r), PHI[(1, 0)](r), PHI[(1, 0)](r),
                   PHI[(1, 1)](r)])
    qs = np.linspace(0.0, 40.0, 400)
    emb = t_pot._make_table([-1.3 * np.sqrt(qs), -0.9 * np.sqrt(qs)],
                            [0.0] * 2, [qs[-1]] * 2, [qs[1] - qs[0]] * 2,
                            np.float64)
    for name, t in (("pair.pt", pair), ("rho.pt", rho), ("emb.pt", emb)):
        t_pot.write_pot_table(t, str(d / name))
    return [str(d / n) for n in ("pair.pt", "emb.pt", "rho.pt")]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_read_eam_ntypes2_matches_jax(tmp_path, dtype):
    files = _three_files(tmp_path)
    want = j_pot.read_eam(*files, ntypes=2, dtype=getattr(jnp, dtype))
    got = t_pot.read_eam(*files, ntypes=2, dtype=np.dtype(dtype))
    _same_eam(got, want)
    # engine col s*2 + h is the SOURCE's function, scaled by the host
    rs = np.linspace(1.5, 4.5, 30)
    for col, fn in enumerate((_rho_a, lambda r: 0.8 * _rho_a(r), _rho_b,
                              lambda r: 0.8 * _rho_b(r))):
        np.testing.assert_allclose(got.rho.interp(col, rs * rs)[0], fn(rs),
                                   rtol=1e-4 if dtype == "float32" else 1e-5)
    with pytest.raises(ValueError, match="4 columns, expected 9"):
        t_pot.read_eam(*files, ntypes=3)


def test_transpose_and_tile_columns():
    e1 = t_pot.analytic_eam()
    scales = [1.0, 0.9, 0.7, 0.5]
    t4 = t_pot.tile_columns(e1.rho, scales)
    assert t4.ncols == 4 and t4.table.dtype == np.float32
    for k, s in enumerate(scales):
        np.testing.assert_array_equal(t4.table[k],
                                      e1.rho.table[0] * np.float32(s))
        assert t4.begin[k] == e1.rho.begin[0] and t4.length[k] \
            == e1.rho.length[0]
    tt = t_pot.transpose_pair_columns(t4, 2)
    _same_table(tt, j_pot.transpose_pair_columns(
        j_pot.PotTable(**{f: jnp.asarray(getattr(t4, f)) for f in FIELDS}),
        2))
    np.testing.assert_array_equal(tt.table, t4.table[[0, 2, 1, 3]])
    assert t_pot.transpose_pair_columns(e1.rho, 1) is e1.rho
    with pytest.raises(ValueError, match="one-column"):
        t_pot.tile_columns(t4, [1.0, 1.0])


def test_convert_carries_a_4_column_set(tmp_path):
    """imd_tpu tables and fits with 4 / 4 / 2 columns, and a typed Scene,
    arrive in the port unchanged and go back to NumPy."""
    from imd_tpu.ops import geometry as j_geom
    from imd_tpu.scene import make_scene as j_make_scene
    jeam = j_pot.read_eam(*_three_files(tmp_path), ntypes=2,
                          dtype=jnp.float64)
    _same_eam(convert.from_eam(jeam), jeam)
    jfit = j_pot.eam_to_fastpoly(jeam)
    fit = convert.from_eam(jfit)
    tfit = t_pot.eam_to_fastpoly(convert.from_eam(jeam))
    x = torch.linspace(1.0, 26.0, 101, dtype=torch.float64)
    for name, ncols in (("pair", 4), ("rho", 4), ("embed", 2)):
        jp, p, tp = (getattr(e, name) for e in (jfit, fit, tfit))
        assert p.host == jp.host and len(p.host) == ncols
        np.testing.assert_array_equal(p.coef, np.asarray(jp.coef))
        for col in range(ncols):
            # the port's own fit of the carried tables is imd_tpu's fit
            assert tp.host[col][1:] == jp.host[col][1:]
            np.testing.assert_allclose(tp.host[col][0], jp.host[col][0],
                                       rtol=1e-12, atol=0)
            for g, w in zip(p.interp(col, x),
                            jp.interp(col, jnp.asarray(x.numpy()))):
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-12,
                                           atol=1e-12)
    pos = np.random.default_rng(2).uniform(0.0, 11.0, (50, 3))
    typ = np.arange(50) % 2
    box = j_geom.Box.create([11.5, 0, 0], [0, 11.5, 0], [0, 0, 11.5],
                            dtype=jnp.float64)
    js = j_make_scene(j_geom.choose_grid(box, 5.0, skin=0.5, n_atoms=50),
                      pos, type=typ, dtype=jnp.float64)
    ts = convert.from_scene(js, device="cpu")
    np.testing.assert_array_equal(ts.type.numpy(), np.asarray(js.type))
    back = convert.to_numpy(ts)
    assert sorted(back["type"][back["type"] >= 0].tolist()) \
        == sorted(typ.tolist())
