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
