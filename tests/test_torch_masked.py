"""Parity of the port's masked arrays with the JAX package, on the CPU.

Each case of ``tests/test_masked.py`` has a counterpart here: the same
seeded numpy inputs go through ``spartan_tpu.array.masked`` on the
virtual CPU mesh (4x2 unless the JAX case uses 8x1) and through
``spartan_tpu_torch.array.masked`` on a logical mesh of the same shape.
Masks, counts, sorts, argsorts and medians must agree bit for bit;
float results within 1e-6 relative, except where a case says why not
(a reduction or a product summed in another order).
"""

import jax
import numpy as np
import numpy.ma as ma
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.array import masked as masked_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu_torch.array import masked as masked_t
from spartan_tpu_torch.expr import base as base_t
from spartan_tpu_torch.parallel import mesh as mesh_t

torch.set_num_threads(1)

# a reduction or a product of float32 summed in another order (per
# shard, then across shards, in the JAX package): a few ulps of the
# result for the sizes below
SUM_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)


def _both(run, mesh=(4, 2)):
    """``run(st, M)`` with the JAX package (M its masked module) under
    its CPU mesh, then with the port under the logical mesh."""
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=mesh)):
        out_j = run(st_j, masked_j)
    with mesh_t.use_mesh(mesh_t.build_mesh(mesh)):
        out_t = run(st_t, masked_t)
    return out_j, out_t


def _agree(got, want, rtol=None):
    """``got`` (port) against ``want`` (JAX): masks exact, data exact
    when ``rtol`` is None, else within ``rtol`` (a float, or a pair
    (rtol, atol)); NaN where NaN."""
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _agree(g, w, rtol)
        return
    if isinstance(want, ma.MaskedArray):
        assert isinstance(got, ma.MaskedArray)
        np.testing.assert_array_equal(ma.getmaskarray(got),
                                      ma.getmaskarray(want))
        got, want = ma.getdata(got), ma.getdata(want)
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if rtol is None:
        np.testing.assert_array_equal(got, want)
    else:
        rtol, atol = rtol if isinstance(rtol, tuple) else (rtol, 1e-7)
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   equal_nan=True)


def _data(shape, seed, frac=0.3, offset=0.0):
    rng = np.random.RandomState(seed)
    data = rng.rand(*shape).astype(np.float32) + offset
    mask = rng.rand(*shape) < frac
    return data, mask


def _pair(M, seed=0):
    """tests/test_masked.py's ``pair`` fixture."""
    rng = np.random.RandomState(seed)
    data = rng.rand(12, 10).astype(np.float32) + 0.5
    mask = rng.rand(12, 10) < 0.3
    return (ma.masked_array(data, mask),
            M.MaskedDistArray.from_numpy(ma.masked_array(data, mask)))


def _glom(x):
    return x.glom() if hasattr(x, "glom") else x


# -- the counterparts of tests/test_masked.py, in its order ----------------


def _roundtrip(st, M):
    return [_pair(M)[1].glom()]


def _arithmetic_mask_union(st, M):
    _, a = _pair(M)
    d2, m2 = _data((12, 10), 1, frac=0.2, offset=0.5)
    b = M.MaskedDistArray.from_numpy(ma.masked_array(d2, m2))
    return [x.glom() for x in (a + b, a * b, a - b, a / b, a + 2.0,
                               3.0 * a, -a)]


def _reductions(st, M):
    _, s = _pair(M)
    return [_glom(x) for x in (s.sum(), s.sum(axis=0), s.sum(axis=1),
                               s.mean(), s.mean(axis=1), s.max(),
                               s.min(axis=0), s.count(), s.count(axis=1))]


def _var_std(st, M):
    _, s = _pair(M)
    return [s.var().glom(), s.std().glom()]


def _filled(st, M):
    return [_pair(M)[1].filled(7.0).glom()]


def _masked_invalid(st, M):
    data = np.array([[1.0, np.nan], [np.inf, 4.0]], np.float32)
    s = M.MaskedDistArray.masked_invalid(st.from_numpy(data))
    return [s.glom(), s.sum().glom()]


def _masked_where(st, M):
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    s = M.MaskedDistArray.masked_where(st.from_numpy(data) > 6.0,
                                       st.from_numpy(data))
    return [s.glom(), s.sum().glom()]


def _evaluate_one_program(st, M):
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    s = M.MaskedDistArray.from_numpy(ma.masked_array(data, data > 3))
    if st is st_t:
        base_t.clear_plan_cache()
        base_t.reset_plan_stats()
        out = (s + 1.0).evaluate()
        # both halves evaluated as one plan
        assert base_t.plan_stats()["plan_misses"] == 1
    else:
        out = (s + 1.0).evaluate()
    return [out.glom()]


def _fully_masked_slice_max(st, M):
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    mask = np.zeros((3, 4), bool)
    mask[1, :] = True
    s = M.MaskedDistArray.from_numpy(ma.masked_array(data, mask))
    return [s.max(axis=1).glom(), s.min(axis=1).glom()]


def _force_second_carry_first(st, M):
    ea = st.from_numpy(np.ones((4, 4), np.float32))
    eb = st.from_numpy(np.full((4, 4), 2.0, np.float32))
    fa, fb = st.loop(3, lambda a, b: (b, a + b), ea, eb)
    gb = fb.glom()
    return [gb, fa.glom()]


def _bool_masked_max_min(st, M):
    a = M.MaskedDistArray.from_numpy(ma.masked_array(
        np.array([False, True, False]), np.array([False, True, False])))
    b = M.MaskedDistArray.from_numpy(ma.masked_array(
        np.array([True, False, True]), np.array([False, True, False])))
    return [x.glom() for x in (a.max(), a.min(), b.min(), b.max())]


def _var_std_per_axis(st, M):
    _, s = _pair(M)
    return [s.var(0).glom(), s.var(1).glom(), s.std(0).glom(),
            s.std(1).glom()]


def _var_std_fully_masked_slice(st, M):
    rng = np.random.RandomState(9)
    data = rng.rand(8, 4).astype(np.float32)
    mask = np.zeros((8, 4), bool)
    mask[:, 2] = True
    mask[0, 0] = True
    s = M.MaskedDistArray(data, mask)
    return [s.var(axis=0).glom(), s.std(axis=1).glom()]


def _average_weighted(st, M):
    nma, s = _pair(M)
    w = np.linspace(1.0, 2.0, nma.size).reshape(nma.shape).astype(
        np.float32)
    w0 = np.linspace(0.5, 1.5, nma.shape[0]).astype(np.float32)
    return [s.average(weights=w).glom(), s.average(axis=0, weights=w).glom(),
            s.average(axis=1, weights=w).glom(),
            s.average(axis=0, weights=w0).glom()]


def _anom(st, M):
    _, s = _pair(M)
    return [s.anom(axis=a).glom() for a in (None, 0, 1)]


def _compressed(st, M):
    return [_pair(M)[1].compressed()]


def _mean_keepdims_consistency(st, M):
    _, s = _pair(M)
    mask = np.zeros((4, 3), bool)
    mask[:, 1] = True
    m2 = M.MaskedDistArray(np.ones((4, 3), np.float32), mask)
    return [s.mean(axis=0, keepdims=True).glom(), s.mean(axis=0).glom(),
            s.mean(keepdims=True).glom(), m2.mean(axis=0).glom(),
            m2.mean(axis=0, keepdims=True).glom()]


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the case compares the class
        return type(e).__name__, str(e)
    return None, ""


def _average_rejects_bad_weights(st, M):
    nma, s = _pair(M)
    d1 = M.MaskedDistArray(np.arange(6, dtype=np.float32),
                           np.zeros(6, bool))
    out = [
        _raised(lambda: s.average(
            axis=1, weights=np.ones(nma.shape[1] + 1, np.float32))),
        _raised(lambda: s.average(weights=np.ones(nma.shape[0],
                                                  np.float32))),
        _raised(lambda: d1.average(weights=np.ones(4, np.float32)))]
    return [np.array(k) for k, _ in out] + [
        np.array("not compatible" in out[0][1]),
        np.array("Axis must be specified" in out[1][1]),
        np.array("not compatible" in out[2][1])]


def _masked_dot_oracle(st, M):
    da, ma_ = _data((24, 16), 41)
    db, mb = _data((16, 20), 42)
    a, b = M.MaskedDistArray(da, ma_), M.MaskedDistArray(db, mb)
    return [st.dot(a, b).glom(), st.dot(a, db).glom()]


def _masked_dot_fully_masked_cell(st, M):
    a = M.MaskedDistArray(np.ones((2, 3), np.float32),
                          np.array([[True] * 3, [False] * 3]))
    return [st.dot(a, np.ones((3, 2), np.float32)).glom()]


def _masked_sort_and_argsort(st, M):
    d, m = _data((8, 12), 43)
    s = M.MaskedDistArray(d, m)
    return ([st.sort(s, axis=ax).glom() for ax in (0, 1, -1)]
            + [st.argsort(s, axis=1).glom()])


def _masked_median_oracle(st, M):
    d1, m1 = _data((64,), 44)
    d2, m2 = _data((6, 10), 45)
    full = M.MaskedDistArray(np.ones((2, 4), np.float32),
                             np.array([[True] * 4, [False] * 4]))
    dn = np.array([[1.0, np.nan, 3.0], [1.0, np.nan, 3.0]], np.float32)
    mn = np.array([[False, False, True], [False, True, False]])
    return [st.median(M.MaskedDistArray(d1, m1)).glom(),
            st.median(M.MaskedDistArray(d2, m2), axis=1).glom(),
            st.median(full, axis=1).glom(),
            st.median(M.MaskedDistArray(dn, mn), axis=1).glom()]


def _masked_sort_axis_out_of_range(st, M):
    d, m = _data((4, 4), 51)
    s = M.MaskedDistArray(d, m)
    out = [_raised(lambda: st.sort(s, axis=2)),
           _raised(lambda: st.argsort(s, axis=-3))]
    return [np.array(k) for k, _ in out] + [
        np.array("out of range" in msg) for _, msg in out]


def _masked_concatenate(st, M):
    da, ma_ = _data((5, 4), 46)
    db, mb = _data((3, 4), 47)
    a, b = M.MaskedDistArray(da, ma_), M.MaskedDistArray(db, mb)
    return [st.concatenate([a, b], axis=0).glom(),
            st.concatenate([a, np.ones((2, 4), np.float32)],
                           axis=0).glom()]


def _masked_map_expr_propagates(st, M):
    da, ma_ = _data((16,), 48)
    db, mb = _data((16,), 49)
    got = st.map(lambda a, b: a * 2.0 + b, M.MaskedDistArray(da, ma_),
                 M.MaskedDistArray(db, mb))
    assert isinstance(got, M.MaskedDistArray)
    return [got.glom()]


def _masked_unsupported_op_raises(st, M):
    d, m = _data((16,), 50)
    s = M.MaskedDistArray(d, m)
    out = [_raised(lambda: st.cumsum(s)),
           _raised(lambda: st.einsum("i,i->", s, s))]
    return [np.array(k) for k, _ in out] + [
        np.array("MaskedDistArray" in out[0][1]),
        np.array("mask-aware" in out[1][1])]


# name -> (case, mesh, rtol); rtol None = bit-equal
CASES = {
    "roundtrip": (_roundtrip, (4, 2), None),
    "arithmetic_mask_union": (_arithmetic_mask_union, (4, 2), 1e-6),
    "reductions": (_reductions, (4, 2), SUM_RTOL),
    "var_std": (_var_std, (4, 2), SUM_RTOL),
    "filled": (_filled, (4, 2), None),
    "masked_invalid": (_masked_invalid, (4, 2), None),
    "masked_where": (_masked_where, (4, 2), None),
    "evaluate_one_program": (_evaluate_one_program, (4, 2), None),
    "fully_masked_slice_max": (_fully_masked_slice_max, (4, 2), None),
    "force_second_carry_first": (_force_second_carry_first, (4, 2), None),
    "bool_masked_max_min": (_bool_masked_max_min, (4, 2), None),
    "var_std_per_axis": (_var_std_per_axis, (4, 2), SUM_RTOL),
    "var_std_fully_masked_slice": (_var_std_fully_masked_slice, (4, 2),
                                   SUM_RTOL),
    "average_weighted": (_average_weighted, (4, 2), SUM_RTOL),
    # data minus a mean near 1.0: an ulp of the mean (1.2e-7) shows as
    # an absolute error of the small anomalies
    "anom": (_anom, (4, 2), (SUM_RTOL, 1e-6)),
    "compressed": (_compressed, (4, 2), None),
    "mean_keepdims_consistency": (_mean_keepdims_consistency, (4, 2),
                                  SUM_RTOL),
    "average_rejects_bad_weights": (_average_rejects_bad_weights, (4, 2),
                                    None),
    # a 16-term product sum per cell, summed in another order
    "masked_dot_oracle": (_masked_dot_oracle, (4, 2), SUM_RTOL),
    "masked_dot_fully_masked_cell": (_masked_dot_fully_masked_cell, (4, 2),
                                     None),
    "masked_sort_and_argsort": (_masked_sort_and_argsort, (4, 2), None),
    "masked_median_oracle": (_masked_median_oracle, (8, 1), None),
    "masked_sort_axis_out_of_range": (_masked_sort_axis_out_of_range,
                                      (8, 1), None),
    "masked_concatenate": (_masked_concatenate, (8, 1), None),
    "masked_map_expr_propagates": (_masked_map_expr_propagates, (8, 1),
                                   1e-6),
    "masked_unsupported_op_raises": (_masked_unsupported_op_raises, (8, 1),
                                     None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_masked_case_matches_jax(name):
    run, mesh, rtol = CASES[name]
    out_j, out_t = _both(run, mesh)
    _agree(out_t, out_j, rtol)


def test_case_table_covers_the_jax_tests():
    import ast
    import os

    src = os.path.join(os.path.dirname(__file__), "test_masked.py")
    with open(src) as f:
        names = [n.name[len("test_"):] for n in ast.parse(f.read()).body
                 if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("test_")]
    assert len(names) == 26
    assert sorted(names) == sorted(CASES)


# -- beyond tests/test_masked.py ------------------------------------------


def test_numpy_ma_oracle_for_the_port():
    """The port against numpy.ma itself on the pair fixture."""
    nma, s = _pair(masked_t)
    np.testing.assert_allclose(float(s.sum().glom()), nma.sum(), rtol=1e-6)
    np.testing.assert_array_equal(s.count(axis=1).glom(), nma.count(axis=1))
    g = st_t.sort(s, axis=1).glom()
    r = ma.sort(nma, axis=1)
    np.testing.assert_array_equal(ma.getmaskarray(g), ma.getmaskarray(r))
    np.testing.assert_array_equal(g.filled(-1), r.filled(-1))
    np.testing.assert_allclose(np.asarray(st_t.median(s, axis=1).glom()),
                               ma.median(nma, axis=1).astype(np.float32),
                               rtol=0)


def test_even_count_median_averages_the_middles():
    """[1, 2, 3, 4] gives 2.5 (jnp.nanmedian, numpy.ma.median), not the
    lower middle torch.median returns; per row too, with masks."""
    d = np.array([[1, 2, 3, 4, 9], [4, 1, 3, 2, 7], [5, 6, 7, 8, 1]],
                 np.float32)
    m = np.array([[0, 0, 0, 0, 1], [0, 0, 0, 0, 1], [0, 0, 0, 0, 0]],
                 bool)

    def run(st, M):
        return [st.median(M.MaskedDistArray(d[0, :4], m[0, :4])).glom(),
                st.median(M.MaskedDistArray(d, m), axis=1).glom(),
                st.median(M.MaskedDistArray(d, m), axis=0).glom(),
                st.median(M.MaskedDistArray(d, m)).glom()]

    out_j, out_t = _both(run, (8, 1))
    _agree(out_t, out_j)
    assert float(out_t[0]) == 2.5
    np.testing.assert_array_equal(out_t[1], [2.5, 2.5, 6.0])
    assert float(out_t[3]) == float(ma.median(ma.masked_array(d, m)))


def _nan_data():
    neg_nan = np.array(0xFFC00000, np.uint32).view(np.float32)
    d = np.array([[np.nan, 1.0, neg_nan, np.inf, 2.0, -0.0, 0.0, -np.inf],
                  [3.0, neg_nan, 1.0, 1.0, np.nan, 0.0, -0.0, 5.0]],
                 np.float32)
    m = np.array([[0, 0, 0, 0, 1, 0, 0, 0], [0, 0, 0, 1, 0, 0, 1, 0]], bool)
    return d, m


def test_valid_nan_and_negative_nan_in_sort_argsort_median():
    """Valid NaNs (either sign) sort after +inf and before the masked
    entries, ties keep their index order, and a valid NaN makes its
    median NaN: the same bits as the JAX package."""
    d, m = _nan_data()

    def run(st, M):
        s = M.MaskedDistArray(d, m)
        srt = st.sort(s, axis=1).glom()
        return [ma.getdata(srt).view(np.uint32), ma.getmaskarray(srt),
                st.argsort(s, axis=1).glom(),
                st.median(s, axis=1).glom(),
                st.median(M.MaskedDistArray(d, m | np.isnan(d)),
                          axis=1).glom()]

    out_j, out_t = _both(run, (8, 1))
    _agree(out_t, out_j)
    assert np.isnan(out_t[3]).all()
    # with the NaNs masked the medians are finite
    assert np.isfinite(out_t[4]).all()


@pytest.mark.parametrize("dtype", ["int32", "uint8", "int16", "bool"])
def test_integer_and_bool_masked_max_min(dtype):
    rng = np.random.RandomState(7)
    d = (rng.randint(0, 2, (6, 8)) if dtype == "bool"
         else rng.randint(0, 100, (6, 8))).astype(dtype)
    m = rng.rand(6, 8) < 0.4
    m[2] = True  # a fully masked row

    def run(st, M):
        s = M.MaskedDistArray(d, m)
        return [s.max().glom(), s.min().glom(), s.max(axis=1).glom(),
                s.min(axis=1).glom(), s.max(axis=0).glom()]

    out_j, out_t = _both(run, (8, 1))
    _agree(out_t, out_j)
    want = ma.masked_array(d, m).max(axis=1)
    np.testing.assert_array_equal(ma.getmaskarray(out_t[2]),
                                  ma.getmaskarray(want))
    np.testing.assert_array_equal(out_t[2].compressed(), want.compressed())


def test_general_ops_dispatch_masked_operands():
    """st.dot / st.sort / st.argsort / st.median / st.concatenate /
    st.map take the mask-aware paths, the same as calling them."""
    d, m = _data((6, 6), 60)
    s = masked_t.MaskedDistArray(d, m)
    pairs = [(st_t.dot(s, s), masked_t.masked_dot(s, s)),
             (st_t.sort(s, axis=0), masked_t.masked_sort(s, axis=0)),
             (st_t.concatenate([s, s], 1),
              masked_t.masked_concatenate([s, s], 1))]
    for via_st, direct in pairs:
        assert isinstance(via_st, masked_t.MaskedDistArray)
        _agree(via_st.glom(), direct.glom())
    np.testing.assert_array_equal(st_t.argsort(s, 0).glom(),
                                  masked_t.masked_argsort(s, 0).glom())
    np.testing.assert_array_equal(st_t.median(s, 1).glom(),
                                  masked_t.masked_median(s, 1).glom())
    mp = st_t.map(lambda v: v + 1.0, s)
    assert isinstance(mp, masked_t.MaskedDistArray)
    np.testing.assert_array_equal(mp.mask.glom(), m)


def test_as_expr_refuses_masked_operands():
    d, m = _data((4,), 61)
    s = masked_t.MaskedDistArray(d, m)
    with pytest.raises(TypeError, match="does not support MaskedDistArray "
                                        "operands") as info:
        base_t.as_expr(s)
    assert "mask-aware" in str(info.value)
    with pytest.raises(TypeError, match="MaskedDistArray"):
        st_t.exp(s)
