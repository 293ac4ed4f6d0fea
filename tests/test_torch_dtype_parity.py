"""Dtype parity of the PyTorch port with the JAX package, on the CPU.

The JAX package stores and computes the way JAX does with 64-bit types
off; these cases hold the port to the same result dtype and the same
values (exactly, for integers and bool) on the same seeded numpy inputs:
the dtype table (uint16, uint32, uint64 stored as uint32, ml_dtypes'
bfloat16), unsigned arithmetic computed wider and cast back, integer
sums and products (uint32 for unsigned, int32 for signed), scans that
keep narrow integer types and flatten for ``axis=None``, bool operands
of argmax/argmin, var/std, subtraction and contractions, and integer
pooling.

Inputs hold no NaN (the JAX package's sharded max/min drop a NaN-holding
shard), lengths divide both meshes, and no global changes between
evaluations.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax

import spartan_tpu as st_j
from spartan_tpu.parallel import mesh as mesh_j
import spartan_tpu_torch as st_t
from spartan_tpu_torch.parallel import mesh as mesh_t

torch.set_num_threads(1)

MESHES = [(8, 1), (4, 2)]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)


def _inputs(dtype, shape=(8, 4), seed=0):
    """Seeded values spanning ``dtype``'s range (and wrapping when
    summed or multiplied)."""
    rng = np.random.RandomState(seed)
    dt = np.dtype(dtype)
    if dt == np.bool_:
        return rng.rand(*shape) > 0.5
    if dt.name == "bfloat16":
        return rng.randn(*shape).astype(dt)
    if dt == np.uint64:
        return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64)
    info = np.iinfo(dt)
    return rng.randint(info.min, int(info.max) + 1, size=shape,
                       dtype=np.int64).astype(dt)


def _both(build, *arrays, mesh=(8, 1)):
    """``build(st, *exprs)`` glommed from the JAX package and the port,
    each on a ``mesh`` mesh over the same numpy arrays."""
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=mesh)):
        want = np.asarray(build(st_j, *[st_j.from_numpy(a)
                                        for a in arrays]).glom())
    with mesh_t.use_mesh(mesh_t.build_mesh(mesh)):
        got = build(st_t, *[st_t.from_numpy(a) for a in arrays]).glom()
    return got, want


def _same(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _close(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# -- the dtype table ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.uint64,
                                   ml_dtypes.bfloat16])
def test_from_numpy_stores_like_jax(dtype):
    a = _inputs(dtype)
    got, want = _both(lambda st, x: x, a)
    _same(got, want)
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        part = st_t.from_numpy(a).evaluate().fetch((slice(2, 5), slice(1, 3)))
    _same(part, want[2:5, 1:3])


_UNSIGNED_OPS = {
    "add": lambda st, x, y: x + y,
    "subtract": lambda st, x, y: x - y,
    "multiply": lambda st, x, y: x * y,
    "maximum": lambda st, x, y: st.maximum(x, y),
    "less": lambda st, x, y: x < y,
    "add_scalar": lambda st, x, y: x + 7,
    "max": lambda st, x, y: st.max(x, axis=0),
    "min": lambda st, x, y: st.min(y),
}


@pytest.mark.parametrize("op", sorted(_UNSIGNED_OPS))
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_unsigned_ops_compute_wider_and_wrap(dtype, op):
    got, want = _both(_UNSIGNED_OPS[op], _inputs(dtype, seed=1),
                      _inputs(dtype, seed=2))
    _same(got, want)


# -- integer sums and products --------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("op", ["sum", "prod"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.int8,
                                   np.int16, np.bool_])
def test_integer_sum_and_prod_dtype(dtype, op, axis, mesh):
    got, want = _both(lambda st, x: getattr(st, op)(x, axis=axis),
                      _inputs(dtype, seed=3), mesh=mesh)
    _same(got, want)


# -- scans -----------------------------------------------------------------------


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("fn", ["cumsum", "cumprod"])
@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.uint8, np.uint16,
                                   np.bool_, np.int32])
def test_scan_keeps_narrow_integer_dtypes(dtype, fn, axis):
    got, want = _both(lambda st, x: getattr(st, fn)(x, axis=axis),
                      _inputs(dtype, seed=4))
    _same(got, want)


@pytest.mark.parametrize("build", [
    lambda st, x: st.cumsum(x, axis=None),
    lambda st, x: st.cumprod(x, axis=None),
    lambda st, x: st.scan(x > 0, axis=None, op="add"),
], ids=["cumsum", "cumprod", "scan_bool"])
def test_scan_axis_none_flattens(build):
    a = np.random.RandomState(5).randint(-3, 4, size=(6, 4)).astype(np.int32)
    got, want = _both(build, a)
    assert got.shape == (24,)
    _same(got, want)


# -- bool operands ----------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("op", ["argmax", "argmin"])
def test_bool_argmax_argmin(op, axis, mesh):
    got, want = _both(lambda st, x: getattr(st, op)(x, axis=axis),
                      _inputs(np.bool_, seed=6), mesh=mesh)
    _same(got, want)


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("fn", ["var", "std"])
def test_bool_var_std(fn, axis):
    got, want = _both(lambda st, x: getattr(st, fn)(x, axis=axis),
                      _inputs(np.bool_, seed=7))
    _close(got, want)


_BOOL_SUB = {
    "bool-int32": (lambda st, b, i: b - i, np.int32),
    "int32-bool": (lambda st, b, i: i - b, np.int32),
    "bool-uint8": (lambda st, b, i: b - i, np.uint8),
    "bool-1": (lambda st, b, i: b - 1, np.int32),
    "bool-1.5": (lambda st, b, i: b - 1.5, np.int32),
    "1-bool": (lambda st, b, i: 1 - b, np.int32),
}


@pytest.mark.parametrize("case", sorted(_BOOL_SUB))
def test_bool_subtraction_promotes(case):
    build, other = _BOOL_SUB[case]
    got, want = _both(build, _inputs(np.bool_, seed=8),
                      _inputs(other, seed=9))
    _same(got, want)


_BOOL_CONTRACT = {
    "dot": lambda st, b, c, i: st.dot(b, st.transpose(c)),
    "dot_int32": lambda st, b, c, i: st.dot(b, i),
    "einsum": lambda st, b, c, i: st.einsum("ij,kj->ik", b, c),
    "einsum_chain": lambda st, b, c, i: st.einsum("ij,kj,kl->il", b, c, c),
    "einsum_trace": lambda st, b, c, i: st.einsum("ii->i",
                                                  st.dot(b, st.transpose(c))),
    "tensordot": lambda st, b, c, i: st.tensordot(b, c, axes=([1], [1])),
}


@pytest.mark.parametrize("case", sorted(_BOOL_CONTRACT))
def test_bool_contractions(case):
    b = np.random.RandomState(10).rand(8, 4) > 0.7
    c = np.random.RandomState(11).rand(8, 4) > 0.7
    i = np.random.RandomState(12).randint(-5, 6, size=(4, 3)).astype(
        np.int32)
    got, want = _both(_BOOL_CONTRACT[case], b, c, i)
    _same(got, want)


# -- integer pooling ----------------------------------------------------------------


_POOLS = {
    "maxpool_same": lambda st, x: st.maxpool(x, 3, 2, padding="SAME"),
    "maxpool_valid": lambda st, x: st.maxpool(x, 2),
    "avgpool_same": lambda st, x: st.avgpool(x, 3, 2, padding="SAME"),
    "avgpool_valid": lambda st, x: st.avgpool(x, 2),
    "avgpool_int16": lambda st, x: st.avgpool(x.astype(np.int16), (2, 3), 1),
}


@pytest.mark.parametrize("case", sorted(_POOLS))
def test_integer_pooling(case):
    """maxpool keeps the integer dtype; avgpool gives float32, equal up to
    the rounding of the division (XLA multiplies by the reciprocal). The
    int16 sums stay in range: the JAX package sums in the input dtype,
    which wraps for narrow types, where the port sums in float32."""
    x = np.random.RandomState(13).randint(-1000, 1000, size=(2, 16, 11, 3))
    got, want = _both(_POOLS[case], x.astype(np.int32))
    if case.startswith("maxpool"):
        _same(got, want)
    else:
        _close(got, want)


# -- C24: bool operands of unary ops, power and square --------------------------


_BOOL_UNARY = ["abs", "absolute", "ceil", "floor", "rint", "square"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("fn", _BOOL_UNARY)
def test_bool_unary_ops(fn, mesh):
    got, want = _both(lambda st, x: getattr(st, fn)(x),
                      _inputs(np.bool_, seed=14), mesh=mesh)
    _same(got, want)


def test_bool_power_is_int32():
    got, want = _both(lambda st, x, y: st.power(x, y),
                      _inputs(np.bool_, seed=15), _inputs(np.bool_, seed=16))
    assert want.dtype == np.int32
    _same(got, want)


def test_masked_abs_of_bool():
    import numpy.ma as ma
    from spartan_tpu.array import masked as masked_j
    from spartan_tpu_torch.array import masked as masked_t

    data = _inputs(np.bool_, seed=17)
    mask = _inputs(np.bool_, seed=18)
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=(4, 2))):
        mj = abs(masked_j.MaskedDistArray.from_numpy(
            ma.masked_array(data, mask)))
        want_d, want_m = np.asarray(mj.data.glom()), np.asarray(
            mj.mask.glom())
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        mt = abs(masked_t.MaskedDistArray.from_numpy(
            ma.masked_array(data, mask)))
        got_d, got_m = mt.data.glom(), mt.mask.glom()
    _same(got_d, want_d)
    _same(got_m, want_m)


# -- C25: rint of integers is float32 ----------------------------------------------


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.uint8,
                                   np.uint16, np.uint32])
def test_rint_of_integers_is_float32(dtype):
    got, want = _both(lambda st, x: st.rint(x), _inputs(dtype, seed=19))
    assert want.dtype == np.float32
    _same(got, want)


# -- C26: uint16/uint32 where torch has no kernel ------------------------------------


_NARROW_SELECT = {
    "sort0": lambda st, x: st.sort(x, axis=0),
    "sort1": lambda st, x: st.sort(x, axis=1),
    "tril": lambda st, x: st.tril(x),
    "triu1": lambda st, x: st.triu(x, 1),
    "percentile_axis1": lambda st, x: st.percentile(x, 30, axis=1),
    "quantile_axis0": lambda st, x: st.quantile(x, 0.75, axis=0),
    "topk": lambda st, x: st.topk(st.ravel(x), 5)[0],
    "topk_idx": lambda st, x: st.topk(st.ravel(x), 5, largest=False)[1],
}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", sorted(_NARROW_SELECT))
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32])
def test_unsigned_sort_select_and_triangles(dtype, case, mesh):
    # distinct values: top-k ties would be legal in either order
    rng = np.random.RandomState(20)
    step = (60000 if dtype == np.uint16 else 2 ** 32 - 1) // 64
    vals = np.arange(64, dtype=np.int64) * step + rng.randint(0, step, 64)
    a = rng.permutation(vals).astype(dtype).reshape(8, 8)
    got, want = _both(_NARROW_SELECT[case], a, mesh=mesh)
    if case.startswith(("percentile", "quantile")):
        _close(got, want)
    else:
        _same(got, want)


_MIXED_CONTRACT = [(np.uint8, np.uint16), (np.int32, np.uint32),
                   (np.int8, np.uint16), (np.uint16, np.float32),
                   (np.uint32, np.int16)]


@pytest.mark.parametrize("pair", _MIXED_CONTRACT,
                         ids=lambda p: f"{np.dtype(p[0])}-{np.dtype(p[1])}")
@pytest.mark.parametrize("fn", ["inner", "einsum"])
def test_mixed_unsigned_inner_and_einsum(fn, pair):
    rng = np.random.RandomState(21)
    a = rng.randint(0, 5, size=(8, 4)).astype(pair[0])
    b = rng.randint(0, 5, size=(6, 4)).astype(pair[1])
    if fn == "inner":
        build = lambda st, x, y: st.inner(x, y)  # noqa: E731
    else:
        build = lambda st, x, y: st.einsum("ij,kj->ik", x, y)  # noqa: E731
    got, want = _both(build, a, b)
    _same(got, want)


# -- C27: result dtypes of trace and of float16 order statistics ----------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32])
def test_unsigned_trace_is_uint32(dtype):
    got, want = _both(lambda st, x: st.trace(x),
                      _inputs(dtype, shape=(8, 8), seed=22))
    assert want.dtype == np.uint32
    _same(got, want)


_F16_STATS = {
    "median": lambda st, x, ax: st.median(x, axis=ax),
    "quantile": lambda st, x, ax: st.quantile(x, 0.3, axis=ax),
    "var": lambda st, x, ax: st.var(x, axis=ax),
    "std": lambda st, x, ax: st.std(x, axis=ax),
}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("fn", sorted(_F16_STATS))
def test_float16_order_stats_and_moments(fn, axis, mesh):
    a = np.random.RandomState(23).rand(8, 4).astype(np.float16)
    got, want = _both(lambda st, x: _F16_STATS[fn](st, x, axis), a,
                      mesh=mesh)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=2e-3)


# -- C28: mixed-dtype dot/matmul promote as JAX does ----------------------------------


_DOT_PAIRS = [(np.float32, np.int32), (np.float32, np.uint32),
              (np.float16, np.int16), (np.float16, np.uint16),
              (np.float16, np.int32), (np.float16, np.uint32),
              (np.int8, np.uint32), (np.int16, np.uint32),
              (np.int32, np.uint32)]


@pytest.mark.parametrize("pair", _DOT_PAIRS,
                         ids=lambda p: f"{np.dtype(p[0])}-{np.dtype(p[1])}")
@pytest.mark.parametrize("fn", ["dot", "matmul"])
def test_mixed_dot_matmul_promote_like_jax(fn, pair):
    rng = np.random.RandomState(24)
    a = (rng.randint(-4, 5, size=(8, 4)) if np.dtype(pair[0]).kind != "f"
         else rng.rand(8, 4) * 2 - 1).astype(pair[0])
    if np.dtype(pair[0]).kind == "u":
        a = np.abs(a)
    b = rng.randint(0, 5, size=(4, 6)).astype(pair[1])
    got, want = _both(lambda st, x, y: getattr(st, fn)(x, y), a, b)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind == "f":
        tol = 2e-3 if want.dtype == np.float16 else 1e-6
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), rtol=tol,
                                   atol=tol)
    else:
        _same(got, want)


# -- C29: integer mod by zero --------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.uint8, np.uint16,
                                   np.uint32])
def test_integer_mod_by_zero_is_zero(dtype, mesh):
    rng = np.random.RandomState(25)
    x = rng.randint(0, 100, size=(8, 4)).astype(dtype)
    y = rng.randint(0, 3, size=(8, 4)).astype(dtype)  # a third are 0
    if np.dtype(dtype).kind == "i":
        x = x - 50
    got, want = _both(lambda st, a, b: st.mod(a, b), x, y, mesh=mesh)
    _same(got, want)


_MOD_BOOL = {
    "bool-bool": (lambda st, a, b: st.mod(a, b), np.bool_),
    "int-bool": (lambda st, a, b: a % b, np.int32),
    "bool-int": (lambda st, a, b: b % a, np.int32),
    "int-scalar0": (lambda st, a, b: b % 0, np.int32),
    "int-False": (lambda st, a, b: b % False, np.int32),
}


@pytest.mark.parametrize("case", sorted(_MOD_BOOL))
def test_mod_by_false_and_of_bools(case):
    build, other = _MOD_BOOL[case]
    b = _inputs(np.bool_, seed=26)
    o = (_inputs(np.bool_, seed=27) if other == np.bool_ else
         np.random.RandomState(27).randint(-9, 9, size=(8, 4)).astype(other))
    got, want = _both(build, b, o)
    _same(got, want)
