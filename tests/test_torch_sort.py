"""Parity of the PyTorch port's sort/select slice with the JAX package, on
the CPU: the sample sort and argsort (1-D, ragged, skewed, batched),
order statistics, unique, top-k, histogram, bincount and the blocked
scan, each through the builtins a user calls.

The same seeded numpy inputs go through both packages. The JAX side runs
on the 8x1 mesh under ``FLAGS.native_kernels`` ``on`` (its Pallas kernels
in interpret mode) and ``off``; the port runs on the CPU under a logical
8x1 mesh with the same flag (its kernel wrappers run their plain
versions). Tolerances: sorts, argsorts, top-k, counts and unique are
exact (bit for bit where NaN or -0.0 is involved); interpolated order
statistics and float prefix sums are compared with a stated tolerance.
"""

import numpy as np
import pytest
import torch

import spartan_tpu as st_j
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J
import spartan_tpu_torch as st_t
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.expr.builtins import (BlockedScanExpr, SampleSortExpr,
                                             TopKExpr)
from spartan_tpu_torch.expr.optimize import dag_nodes
from spartan_tpu_torch.kernels import exchange as kex_t
from spartan_tpu_torch.kernels import histogram as khist_t
from spartan_tpu_torch.kernels import topk as ktopk_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)

FLAG = pytest.mark.parametrize("flag", ["on", "off"])


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev_dev = mesh_t.get_default_device()
    snap_j, snap_t = FLAGS_J.snapshot(), FLAGS_T.snapshot()
    mesh_t.set_default_device("cpu")
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        yield
    for name, value in snap_j.items():
        setattr(FLAGS_J, name, value)
    for name, value in snap_t.items():
        setattr(FLAGS_T, name, value)
    mesh_t.set_default_device(prev_dev)


def _flags(flag):
    FLAGS_J.native_kernels = flag
    FLAGS_T.native_kernels = flag


def _both(fn_j, fn_t, a, tiling_axes=None):
    """Run a builtin on the same numpy data in both packages; glom."""
    xj = (st_j.from_numpy(a, tiling=tiling_j.Tiling(tiling_axes))
          if tiling_axes is not None else st_j.from_numpy(a))
    xt = (st_t.from_numpy(a, tiling=tiling_t.Tiling(tiling_axes))
          if tiling_axes is not None else st_t.from_numpy(a))
    out_j, out_t = fn_j(xj), fn_t(xt)
    if isinstance(out_j, tuple):
        return (tuple(np.asarray(o.glom()) for o in out_j),
                tuple(o.glom() for o in out_t))
    return np.asarray(out_j.glom()), out_t.glom()


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(np.ascontiguousarray(a).view(np.uint8),
                                  np.ascontiguousarray(b).view(np.uint8))


# -- sort / argsort --------------------------------------------------------------


def _sort_data(case, rng):
    if case == "ragged":
        return rng.rand(1001).astype(np.float32)
    if case == "tiny":
        return rng.rand(13).astype(np.float32)
    if case == "skewed":
        a = np.concatenate([np.zeros(1600, np.float32),
                            rng.zipf(1.5, 1600).astype(np.float32),
                            rng.rand(896).astype(np.float32) * 1e-3])
        rng.shuffle(a)
        return a
    if case == "int":
        return rng.randint(-1000, 1000, 4000).astype(np.int32)
    if case == "inf":
        a = rng.rand(4096).astype(np.float32)
        a[::100], a[::173] = np.inf, -np.inf
        return a
    if case == "nan_and_signed_zeros":
        a = rng.randn(1013).astype(np.float32)
        a[[3, 500, 1012]] = np.nan
        a[[7, 8]] = -0.0
        a[[9, 10]] = 0.0
        a[11] = np.array(0xFFC12345, np.uint32).view(np.float32)
        return a
    raise KeyError(case)


@FLAG
@pytest.mark.parametrize("case", ["ragged", "tiny", "skewed", "int", "inf",
                                  "nan_and_signed_zeros"])
def test_sort_matches_jax(mesh1d, flag, case):
    _flags(flag)
    a = _sort_data(case, np.random.RandomState(len(case)))
    e = st_t.sort(st_t.from_numpy(a))
    assert isinstance(e, SampleSortExpr)
    ref = np.asarray(st_j.sort(st_j.from_numpy(a)).glom())
    _bits_equal(e.glom(), ref)


@FLAG
@pytest.mark.parametrize("case", ["ragged", "skewed", "int",
                                  "nan_and_signed_zeros"])
def test_argsort_matches_jax(mesh1d, flag, case):
    """Every sort is stable, so the indices equal the JAX package's
    exactly, duplicates included, and form a permutation."""
    _flags(flag)
    a = _sort_data(case, np.random.RandomState(len(case) + 1))
    ref, out = _both(st_j.argsort, st_t.argsort, a)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(np.sort(out), np.arange(a.size))
    _bits_equal(a[out], np.sort(a, kind="stable"))


@FLAG
def test_sort_2d_along_tiled_axis(mesh1d, flag):
    """Axis 1 tiled: every row is a row of the batched program; axis 0
    tiled: the movedim path."""
    _flags(flag)
    rng = np.random.RandomState(61)
    a = rng.rand(6, 1032).astype(np.float32)
    e = st_t.sort(st_t.from_numpy(a, tiling=tiling_t.Tiling((None, "x"))),
                  axis=1)
    assert isinstance(e, SampleSortExpr)
    ref = np.asarray(st_j.sort(st_j.from_numpy(
        a, tiling=tiling_j.Tiling((None, tiling_j.AXIS_ROW))), axis=1).glom())
    _bits_equal(e.glom(), ref)
    b = rng.rand(1032, 5).astype(np.float32)
    ref, out = _both(lambda x: st_j.sort(x, axis=0),
                     lambda x: st_t.sort(x, axis=0), b, ("x", None))
    _bits_equal(out, ref)
    ref, out = _both(lambda x: st_j.argsort(x, axis=0),
                     lambda x: st_t.argsort(x, axis=0), b, ("x", None))
    np.testing.assert_array_equal(out, ref)


def test_sort_local_axis_and_errors(mesh1d):
    a = np.random.RandomState(6).rand(16, 8).astype(np.float32)
    e = st_t.sort(st_t.from_numpy(a, tiling=tiling_t.row(2)), axis=1)
    assert not isinstance(e, SampleSortExpr)
    np.testing.assert_array_equal(e.glom(), np.sort(a, axis=1))
    with pytest.raises(ValueError, match="out of range"):
        st_t.sort(st_t.from_numpy(a), axis=2)
    with pytest.raises(ValueError, match="out of range"):
        st_t.argsort(st_t.from_numpy(a), axis=-3)


@pytest.mark.parametrize("flag", ["on", "off"])
def test_sort_path_launch_accounting(mesh1d, flag):
    """``on`` packs through the kernel module (on the CPU its plain
    version, which counts no launch), ``off`` through the scatter; both
    give the same bits."""
    FLAGS_T.native_kernels = flag
    a = np.random.RandomState(9).rand(777).astype(np.float32)
    calls = []
    real = kex_t.partition_pack
    kex_t.partition_pack = lambda *args: calls.append(1) or real(*args)
    try:
        out = st_t.sort(st_t.from_numpy(a)).glom()
    finally:
        kex_t.partition_pack = real
    assert bool(calls) == (flag == "on")
    np.testing.assert_array_equal(out, np.sort(a))


# -- order statistics -------------------------------------------------------------

# Interpolated order statistics: (1 - f) * a + f * b in f32 in both
# packages; XLA may contract it into one FMA where torch rounds the
# products, so allow a few ulps (rtol 1e-6).
RTOL = 1e-6


@FLAG
def test_median_percentile_match_jax(mesh1d, flag):
    _flags(flag)
    rng = np.random.RandomState(11)
    for n in (8192, 1001):
        a = rng.rand(n).astype(np.float32)
        ref, out = _both(st_j.median, st_t.median, a)
        np.testing.assert_allclose(out, ref, rtol=RTOL)
        for q in (0.0, 25.0, 90.5, 100.0):
            ref, out = _both(lambda x: st_j.percentile(x, q),
                             lambda x: st_t.percentile(x, q), a)
            np.testing.assert_allclose(out, ref, rtol=RTOL)
        q = [0.0, 12.5, 50.0, 87.3, 100.0]
        ref, out = _both(lambda x: st_j.percentile(x, q),
                         lambda x: st_t.percentile(x, q), a)
        assert out.shape == (5,)
        np.testing.assert_allclose(out, ref, rtol=RTOL)
        np.testing.assert_allclose(out, np.percentile(a, q), rtol=1e-5)
    ref, out = _both(lambda x: st_j.quantile(x, 0.3),
                     lambda x: st_t.quantile(x, 0.3), a)
    np.testing.assert_allclose(out, ref, rtol=RTOL)


@FLAG
def test_order_stats_nan_poison_and_int(mesh1d, flag):
    _flags(flag)
    rng = np.random.RandomState(12)
    a = rng.rand(4096).astype(np.float32)
    a[137] = np.nan
    assert np.isnan(st_t.median(st_t.from_numpy(a)).glom())
    assert np.all(np.isnan(st_t.percentile(st_t.from_numpy(a),
                                           [10.0, 90.0]).glom()))
    c = np.arange(128, dtype=np.float32)
    c[3], c[100] = -np.inf, np.inf  # inf never poisons
    ref, out = _both(st_j.median, st_t.median, c)
    np.testing.assert_allclose(out, ref, rtol=RTOL)
    big = np.full(4096, 2_000_000_000, np.int32)  # int middles promote
    ref, out = _both(st_j.median, st_t.median, big)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=RTOL)
    ints = rng.randint(-50, 50, 1001).astype(np.int32)
    ref, out = _both(lambda x: st_j.percentile(x, 30.0),
                     lambda x: st_t.percentile(x, 30.0), ints)
    np.testing.assert_allclose(out, ref, rtol=RTOL)


@FLAG
def test_median_nd_along_tiled_axis(mesh1d, flag):
    _flags(flag)
    rng = np.random.RandomState(15)
    a = rng.rand(6, 1032).astype(np.float32)
    a[2, 17] = np.nan  # poisons its own row only
    e = st_t.median(st_t.from_numpy(a, tiling=tiling_t.Tiling((None, "x"))),
                    axis=1)
    assert any(isinstance(n, SampleSortExpr) for n in dag_nodes(e))
    ref = np.asarray(st_j.median(st_j.from_numpy(
        a, tiling=tiling_j.Tiling((None, tiling_j.AXIS_ROW))),
        axis=1).glom())
    out = e.glom()
    assert np.isnan(out[2]) and np.isnan(ref[2])
    np.testing.assert_allclose(out, ref, rtol=RTOL)
    ref, out = _both(lambda x: st_j.percentile(x, 37.5, axis=0),
                     lambda x: st_t.percentile(x, 37.5, axis=0),
                     a[:, :800].T.copy(), ("x", None))
    np.testing.assert_allclose(out, ref, rtol=RTOL)


def test_percentile_rejects_bad_q(mesh1d):
    x = st_t.from_numpy(np.arange(16, dtype=np.float32))
    with pytest.raises(NotImplementedError, match="1-D"):
        st_t.percentile(x, [[25.0], [75.0]])
    with pytest.raises(ValueError, match="outside"):
        st_t.percentile(x, 101.0)
    with pytest.raises(ValueError, match="outside"):
        st_t.quantile(x, 1.5)


# -- unique --------------------------------------------------------------------


@FLAG
def test_unique_with_counts_matches_jax(mesh1d, flag):
    _flags(flag)
    rng = np.random.RandomState(16)
    for n in (8192, 1001):
        a = rng.randint(0, 200, n).astype(np.int32)
        ref, out = _both(
            lambda x: st_j.unique(x, size=220, fill_value=-1,
                                  return_counts=True),
            lambda x: st_t.unique(x, size=220, fill_value=-1,
                                  return_counts=True), a)
        for o, r in zip(out, ref):
            assert o.dtype == r.dtype
            np.testing.assert_array_equal(o, r)
        rv, rc = np.unique(a, return_counts=True)
        np.testing.assert_array_equal(out[0][:rv.size], rv)
        np.testing.assert_array_equal(out[1][:rv.size], rc)
    b = rng.choice(np.linspace(0, 1, 37).astype(np.float32), 4096)
    ref, out = _both(lambda x: st_j.unique(x, size=10),
                     lambda x: st_t.unique(x, size=10), b)
    np.testing.assert_array_equal(out, ref)  # truncation
    d = rng.randint(0, 9, (16, 8)).astype(np.int32)  # N-d flattens
    ref, out = _both(lambda x: st_j.unique(x, size=16, fill_value=-1,
                                           return_counts=True),
                     lambda x: st_t.unique(x, size=16, fill_value=-1,
                                           return_counts=True), d)
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[1], ref[1])
    e5 = st_t.unique(st_t.from_numpy(np.array([3.0, 1.0, 3.0], np.float32)),
                     size=4, fill_value=9)
    np.testing.assert_array_equal(e5.glom(), [1, 3, 9, 9])


# -- top-k ----------------------------------------------------------------------


@FLAG
@pytest.mark.parametrize("largest", [True, False])
def test_topk_ties_and_ragged_match_jax(mesh1d, flag, largest):
    _flags(flag)
    rng = np.random.RandomState(2)
    v = np.repeat(rng.rand(173).astype(np.float32), 3)[:515]
    for k in (1, 9, 64):
        ref, out = _both(lambda x: st_j.topk(x, k, largest=largest),
                         lambda x: st_t.topk(x, k, largest=largest), v)
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[1], ref[1])
        assert out[1].dtype == np.int32
    # k beyond the shard budget: the argsort slice
    ref, out = _both(lambda x: st_j.topk(x, 100, largest=largest),
                     lambda x: st_t.topk(x, 100, largest=largest), v)
    np.testing.assert_array_equal(out[0], ref[0])


@FLAG
def test_topk_ints_smallest_match_jax(mesh1d, flag):
    _flags(flag)
    rng = np.random.RandomState(3)
    vi = rng.randint(-2 ** 31 + 1, 2 ** 31 - 1, 512).astype(np.int32)
    vi[7] = np.iinfo(np.int32).min
    vi[8] = np.iinfo(np.int32).max
    for largest in (True, False):
        ref, out = _both(lambda x: st_j.topk(x, 5, largest=largest),
                         lambda x: st_t.topk(x, 5, largest=largest), vi)
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[1], ref[1])


@FLAG
def test_topk_sentinel_extreme_ragged(mesh1d, flag):
    """tests/test_sort.py::test_topk_sentinel_extreme_ragged on both
    packages: the padding carries the sentinel, real data equals it."""
    _flags(flag)
    n = 13
    cases = []
    a = np.full(n, -np.inf, np.float32)
    a[3] = 1.0
    cases.append((a, True))
    cases.append((np.full(n, -np.inf, np.float32), True))
    c = np.full(n, np.iinfo(np.int32).min, np.int32)
    c[7] = 5
    cases.append((c, True))
    d = np.full(n, np.inf, np.float32)
    d[11] = -2.0
    cases.append((d, False))
    for data, largest in cases:
        ref, out = _both(lambda x: st_j.topk(x, 2, largest=largest),
                         lambda x: st_t.topk(x, 2, largest=largest), data)
        assert out[1].min() >= 0 and out[1].max() < n
        np.testing.assert_array_equal(out[1], ref[1])
        np.testing.assert_array_equal(out[0], ref[0])


def test_topk_nan_keys_follow_lax_top_k(mesh1d):
    """NaN and signed-zero keys: the port follows the JAX package's
    ``off`` path (``lax.top_k``'s total order: +NaN first for largest,
    -NaN first for smallest). Its ``on`` path (the Pallas kernel)
    returns one index repeatedly on these keys instead."""
    v = np.array([0.0, -0.0, 1.0, np.nan, -np.nan, 1.0, -np.inf, np.nan] * 40,
                 np.float32)
    FLAGS_J.native_kernels = "off"
    for flag in ("on", "off"):
        FLAGS_T.native_kernels = flag
        for largest in (True, False):
            ref, out = _both(lambda x: st_j.topk(x, 7, largest=largest),
                             lambda x: st_t.topk(x, 7, largest=largest), v)
            np.testing.assert_array_equal(out[1], ref[1])
            _bits_equal(out[0], ref[0])


def test_topk_path_and_errors(mesh1d):
    x = st_t.from_numpy(np.random.RandomState(0).rand(800).astype(
        np.float32))
    _, idx = st_t.topk(x, 5)
    assert isinstance(idx, TopKExpr)
    calls = []
    real = ktopk_t.shard_topk
    ktopk_t.shard_topk = lambda *a: calls.append(1) or real(*a)
    try:
        idx.glom()
    finally:
        ktopk_t.shard_topk = real
    assert calls == [1]
    with pytest.raises(ValueError, match="1 <= k"):
        st_t.topk(x, 0)
    with pytest.raises(ValueError, match="1-D"):
        st_t.topk(st_t.from_numpy(np.zeros((4, 4), np.float32)), 2)


# -- histogram / bincount ----------------------------------------------------------


@FLAG
@pytest.mark.parametrize("lo,hi,bins", [(0.0, 1.0, 64), (0.1, 0.7, 10),
                                        (-3.3, 2.9, 32)])
def test_histogram_values_on_edges(mesh1d, flag, lo, hi, bins):
    """Values exactly on every edge (and just outside the range). For
    these ranges both packages' f32 edges are bit-equal (for some others
    XLA rewrites jnp.linspace's arithmetic and the edges differ by an
    ulp), so the counts agree exactly; each package's counts follow its
    own returned edges."""
    _flags(flag)
    edges = np.asarray(st_j.histogram(np.zeros(8, np.float32), bins=bins,
                                      range=(lo, hi))[1].glom())
    x = np.concatenate([edges, edges, np.nextafter(edges, np.inf),
                        np.float32([lo - 1, hi + 1, np.nan])]
                       ).astype(np.float32)
    ref, out = _both(lambda a: st_j.histogram(a, bins=bins, range=(lo, hi)),
                     lambda a: st_t.histogram(a, bins=bins, range=(lo, hi)),
                     x)
    _bits_equal(out[1], ref[1])
    np.testing.assert_array_equal(out[0], ref[0])
    assert out[0].dtype == np.int32
    want = np.histogram(x[np.isfinite(x)], bins=out[1].astype(np.float64))[0]
    np.testing.assert_array_equal(out[0], want)


@FLAG
def test_histogram_autorange_and_constant(mesh1d, flag):
    _flags(flag)
    rng = np.random.RandomState(1)
    x = rng.randn(2000).astype(np.float32)
    ref, out = _both(lambda a: st_j.histogram(a, bins=32),
                     lambda a: st_t.histogram(a, bins=32), x)
    np.testing.assert_array_equal(out[0], ref[0])
    # runtime edges: XLA may rewrite the linspace arithmetic; f32 edges
    # agree to a few ulps of the range
    np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        out[0], np.histogram(x, bins=out[1].astype(np.float64))[0])
    c = np.full(64, 7.0, np.float32)
    ref, out = _both(lambda a: st_j.histogram(a, bins=4),
                     lambda a: st_t.histogram(a, bins=4), c)
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out[0], np.histogram(c, bins=4)[0])
    ref, out = _both(lambda a: st_j.histogram(a, bins=3, range=(2.0, 2.0)),
                     lambda a: st_t.histogram(a, bins=3, range=(2.0, 2.0)),
                     c)
    np.testing.assert_array_equal(out[0], ref[0])
    with pytest.raises(ValueError, match="finite"):
        st_t.histogram(st_t.from_numpy(c), range=(0.0, np.inf))
    with pytest.raises(ValueError, match="bins"):
        st_t.histogram(st_t.from_numpy(c), bins=0)


@FLAG
def test_bincount_negatives_and_overflow_ids(mesh1d, flag):
    _flags(flag)
    ids = np.random.RandomState(0).randint(-3, 14, 1003).astype(np.int32)
    ref, out = _both(lambda a: st_j.bincount(a, length=10),
                     lambda a: st_t.bincount(a, length=10), ids)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    ref, out = _both(st_j.bincount, st_t.bincount,
                     np.array([0, 3, 3, 9], np.int32))
    np.testing.assert_array_equal(out, ref)
    ref, out = _both(lambda a: st_j.unique_counts(a, 12),
                     lambda a: st_t.unique_counts(a, 12), ids)
    np.testing.assert_array_equal(out, ref)


def test_bincount_path_runs_the_kernel_module(mesh1d):
    calls = []
    real = khist_t.bincount_sharded
    khist_t.bincount_sharded = lambda *a: calls.append(1) or real(*a)
    try:
        out = st_t.bincount(np.arange(100, dtype=np.int32) % 7,
                            length=7).glom()
        FLAGS_T.native_kernels = "off"
        off = st_t.bincount(np.arange(100, dtype=np.int32) % 7,
                            length=7).glom()
    finally:
        khist_t.bincount_sharded = real
    assert calls == [1]
    np.testing.assert_array_equal(out, off)


# -- scans, counting, gathers, linspace -----------------------------------------


def test_cumsum_blocked_matches_jax(mesh1d):
    rng = np.random.RandomState(5)
    ints = rng.randint(-9, 9, 4096).astype(np.int32)
    e = st_t.cumsum(st_t.from_numpy(ints))
    assert isinstance(e, BlockedScanExpr)
    ref = np.asarray(st_j.cumsum(st_j.from_numpy(ints)).glom())
    out = e.glom()
    assert out.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    for op in ("max", "min", "mul"):
        small = (rng.randint(1, 3, 64) if op == "mul"
                 else rng.randint(-50, 50, 64)).astype(np.int32)
        ref, out = _both(lambda a: st_j.scan(a, op=op),
                         lambda a: st_t.scan(a, op=op), small)
        np.testing.assert_array_equal(out, ref)
    f = rng.rand(4096, 3).astype(np.float32)
    ref, out = _both(st_j.cumsum, st_t.cumsum, f, ("x", None))
    # float sums: the same blocks, another order inside a block (XLA's
    # associative scan vs a sequential one): ~sqrt(512) * 2^-24 of a sum
    # of 512 values in [0, 1), rtol 1e-5
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    b = rng.rand(100) > 0.5  # bool promotes to int32 on the local path
    ref, out = _both(st_j.cumsum, st_t.cumsum, b)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)
    ref, out = _both(lambda a: st_j.cumprod(a, axis=1),
                     lambda a: st_t.cumprod(a, axis=1), f[:8] + 0.5)
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_counting_take_and_linspace(mesh1d):
    rng = np.random.RandomState(8)
    a = rng.randint(-2, 3, (40, 5)).astype(np.int32)
    for fn in ("count_nonzero", "count_zero"):
        ref, out = _both(getattr(st_j, fn), getattr(st_t, fn), a)
        assert int(out) == int(ref)
    assert st_t.size(st_t.from_numpy(a)) == st_j.size(st_j.from_numpy(a))
    idx = np.array([0, -1, 7, 3])
    ref, out = _both(lambda x: st_j.take(x, idx),
                     lambda x: st_t.take(x, idx), a)
    np.testing.assert_array_equal(out, ref)
    ref, out = _both(lambda x: st_j.take(x, idx, axis=0),
                     lambda x: st_t.take(x, idx, axis=0), a)
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(IndexError):
        st_t.take(st_t.from_numpy(a), [200])
    for args in ((0.0, 1.0, 11), (-3.0, 7.5, 64, False), (2.0, 2.0, 1)):
        ref = np.asarray(st_j.linspace(*args).glom())
        out = st_t.linspace(*args).glom()
        assert out.shape == ref.shape and out.dtype == ref.dtype
        # start + step * i in f32: XLA may fuse it into one FMA
        np.testing.assert_allclose(out, ref, rtol=0, atol=4e-6)
        np.testing.assert_allclose(out, np.linspace(*args), rtol=0,
                                   atol=4e-6)
