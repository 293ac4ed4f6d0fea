"""The fixed-order reduction (``kernels/reduce.py``) and the incremental
engine's restricted sums, means and products, on the CPU.

The plain version carries the kernel's order: the operand viewed as
(P, R, Q), slices of ``KS`` along R, each a fold from the identity in
ascending r, the slices folded in order, a mean divided once. It is held
to a float32 numpy loop of that order, to ``fixed_order_dot_plain(ones,
A)`` bit for bit on sums of a matrix along axis 0, to the bits of the
whole reduction in every window of its kept axes (under ``hypothesis``,
across layouts, keepdims and non-adjacent reduced axes), and to float64
numpy and the JAX package's ``jnp.sum``/``jnp.mean``/``jnp.prod`` within
1e-5.

On the CPU ``expr/reduce.py`` keeps torch's reductions; the engine cases
monkeypatch ``kernels.reduce.routes`` to answer as on the card, so the
lowering runs the plain version and ``incremental.reduce_granule``
answers 1 for a float32 sum, mean or product. A column stream of a 2-D
sum along axis 0, every C39 shape (three kept axes' worth of 3-D sums
that torch's CPU sums cannot restrict), fused and keepdims forms, a mean
and a product are then served at every warm evaluate on logical meshes,
bit-equal to the flag-off run, with the JAX package's ``incremental_*``
counters and modes on the same numpy stream and values within 1e-5 of
it. Integer and bool sums are served without the route, on every
device. Gloo worlds of 2 and 4 CPU processes run the column stream on
group meshes: a line of two ranks serves every warm sum, bit-equal to
its flag-off run; a line of four keeps ``reduction-order``.
"""

import functools
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu_torch.kernels import gemv
from spartan_tpu_torch.kernels import reduce as kr
from spartan_tpu_torch.parallel import mesh as mesh_t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUM = 1e-5
_COUNTERS = ("incremental_hits", "incremental_fallbacks",
             "incremental_recomputed_tiles")
GROUP_JOIN_S = 240


def _rand(shape, seed, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * np.random.RandomState(seed).rand(*shape)
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the plain version's order ---------------------------------------------


def _documented_loop(a, op, dims):
    """The module docstring's order in float32 numpy: (P, R, Q), slices
    of KS along R from the identity, then the slices from the identity,
    then one division for a mean."""
    kept = [d for d in range(a.ndim) if d not in dims]
    before = [d for d in kept if d < dims[0]]
    after = [d for d in kept if d > dims[0]]
    v = np.transpose(a, before + list(dims) + after)
    p = int(np.prod([a.shape[d] for d in before]))
    r = int(np.prod([a.shape[d] for d in dims]))
    q = int(np.prod([a.shape[d] for d in after]))
    v = v.reshape(p, r, q)
    ident = np.float32(1.0 if op == "prod" else 0.0)
    fn = np.multiply if op == "prod" else np.add
    out = np.full((p, q), ident, np.float32)
    for s0 in range(0, r, kr.KS):
        acc = np.full((p, q), ident, np.float32)
        for j in range(s0, min(r, s0 + kr.KS)):
            acc = fn(acc, v[:, j])
        out = fn(out, acc)
    if op == "mean":
        out = out / np.float32(r)
    return out.reshape([a.shape[d] for d in kept])


@pytest.mark.parametrize("op", kr.OPS)
@pytest.mark.parametrize("shape,dims", [
    ((1000, 7), (0,)), ((7, 1000), (1,)), ((3, 257, 5), (1,)),
    ((4, 5, 6), (0, 2)), ((2, 3, 300, 2), (1, 2)), ((5, 1, 6), (0, 1))])
def test_plain_order_is_the_documented_loop(shape, dims, op):
    a = _rand(shape, sum(shape), 0.9, 1.1)
    np.testing.assert_array_equal(
        kr.fixed_order_reduce(_t(a), op, dims).numpy(),
        _documented_loop(a, op, dims))


@pytest.mark.parametrize("k", [1, 255, 256, 257, 1000])
def test_axis0_sum_is_fixed_order_dot_of_ones(k):
    a = _t(_rand((k, 301), k, -1.0, 1.0))
    np.testing.assert_array_equal(
        kr.fixed_order_reduce(a, "sum", 0).numpy(),
        gemv.fixed_order_dot_plain(torch.ones(k), a).numpy())


def _window_case(shape, dims, keepdim, lo, w, axis, seed, op):
    """The whole reduction's window along kept axis ``axis`` against the
    reduction of the matching window view of the operand."""
    a = _t(_rand(shape, seed, 0.5, 1.5))
    full = kr.fixed_order_reduce(a, op, dims, keepdim)
    kept = [d for d in range(len(shape)) if d not in dims]
    d = kept[axis % len(kept)]
    lo = lo % shape[d]
    hi = min(shape[d], lo + w)
    sl = [slice(None)] * len(shape)
    sl[d] = slice(lo, hi)
    out_d = d if keepdim else kept.index(d)
    osl = [slice(None)] * full.ndim
    osl[out_d] = slice(lo, hi)
    np.testing.assert_array_equal(
        full[tuple(osl)].numpy(),
        kr.fixed_order_reduce(a[tuple(sl)], op, dims, keepdim).numpy())


@pytest.mark.parametrize("op", kr.OPS)
@pytest.mark.parametrize("shape,dims,axis", [
    ((600, 301), (0,), 0), ((301, 600), (1,), 0), ((3, 300, 40), (1,), 1),
    ((3, 300, 40), (1,), 0), ((300, 3, 200), (0,), 1),
    ((20, 30, 40), (0, 2), 0), ((6, 7, 8, 9), (1, 3), 2)])
def test_windows_are_bit_equal(shape, dims, axis, op):
    for keepdim in (False, True):
        for lo, w in ((0, 10 ** 6), (1, 1), (3, 40), (17, 5)):
            _window_case(shape, dims, keepdim, lo, w, axis, 7, op)


@settings(max_examples=40, deadline=None)
@given(shape=hst.lists(hst.integers(1, 40), min_size=2, max_size=4),
       data=hst.data(), keepdim=hst.booleans(),
       lo=hst.integers(0, 39), w=hst.integers(1, 40),
       axis=hst.integers(0, 3), seed=hst.integers(0, 2 ** 16),
       op=hst.sampled_from(kr.OPS))
def test_windows_hypothesis(shape, data, keepdim, lo, w, axis, seed, op):
    n = len(shape)
    dims = tuple(sorted(data.draw(hst.sets(hst.integers(0, n - 1),
                                           min_size=1, max_size=n - 1))))
    if kr.split(shape, dims)[1] < 300:
        # a long reduced run, so windows cross the slices' boundaries
        shape = list(shape)
        shape[dims[0]] *= -(-300 // kr.split(shape, dims)[1])
    _window_case(tuple(shape), dims, keepdim, lo, w, axis, seed, op)


@pytest.mark.parametrize("op", kr.OPS)
@pytest.mark.parametrize("shape,dims", [
    ((845, 301), (0,)), ((64, 4096), (1,)), ((40, 30, 20), (0, 2)),
    ((7, 1000, 3), (1,))])
def test_values_match_float64_and_jax(shape, dims, op):
    a = _rand(shape, 11, 0.99, 1.01)
    got = kr.fixed_order_reduce(_t(a), op, dims).numpy()
    ref = {"sum": np.sum, "mean": np.mean, "prod": np.prod}[op](
        a.astype(np.float64), axis=dims)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    want = np.asarray(getattr(jnp, op)(jnp.asarray(a), axis=dims))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_empty_operands_and_bad_arguments():
    assert kr.fixed_order_reduce(torch.ones(0, 5), "sum", 0).tolist() == \
        [0.0] * 5
    assert kr.fixed_order_reduce(torch.ones(0, 5), "prod", 0).tolist() == \
        [1.0] * 5
    assert torch.isnan(kr.fixed_order_reduce(torch.ones(0, 5), "mean",
                                             0)).all()
    assert kr.fixed_order_reduce(torch.ones(5, 0), "sum", 0).shape == (0,)
    with pytest.raises(TypeError):
        kr.fixed_order_reduce(torch.ones(3, 4, dtype=torch.float64), "sum", 0)
    with pytest.raises(ValueError):
        kr.fixed_order_reduce(torch.ones(3, 4), "max", 0)
    with pytest.raises(ValueError):
        kr.fixed_order_reduce(torch.ones(3, 4), "sum", ())


def test_routes_only_on_the_card():
    """``routes`` holds for a float32 sum, mean or product along some but
    not all axes of a CUDA operand (an integer mean too), and nowhere
    else."""
    cuda, f32 = torch.device("cuda"), torch.float32
    assert not kr.routes(torch.device("cpu"), f32, "sum", (0,), 2)
    for op in kr.OPS:
        assert kr.routes(cuda, f32, op, (0,), 2)
        assert kr.routes(cuda, f32, op, (0, 2), 3)
        assert not kr.routes(cuda, f32, op, None, 2)
        assert not kr.routes(cuda, f32, op, (0, 1), 2)
        for dt in (torch.float16, torch.bfloat16, torch.float64):
            assert not kr.routes(cuda, dt, op, (0,), 2)
    assert kr.routes(cuda, torch.int32, "mean", (1,), 2)
    assert kr.routes(cuda, torch.bool, "mean", (1,), 2)
    assert not kr.routes(cuda, torch.int32, "sum", (1,), 2)
    assert not kr.routes(cuda, f32, "max", (0,), 2)


def test_layout_reads_windows_in_place():
    """A window of the kept axes is read through its strides (no copy);
    a reduced set that is not one run is moved together, and the memory
    model counts that copy and the slice buffer."""
    a = torch.rand(700, 300)
    kind, g, args, copied = kr.layout(a[:, 5:90], (0,))
    assert (kind, args, copied) == ("outer", (0, 300, 1, 700, 85), False)
    assert g.data_ptr() == a[:, 5:90].data_ptr()
    kind, g, args, copied = kr.layout(a[3:40], (1,))
    assert (kind, args, copied) == ("inner", (300, 37, 300), False)
    # a transposed matrix is made contiguous first
    kind, g, args, copied = kr.layout(a.t(), (1,))
    assert (kind, args, copied) == ("inner", (700, 300, 700), True)
    b = torch.rand(40, 30, 20)
    assert kr.layout(b, (0, 2))[3] and kr.moves(b.shape, (0, 2))
    assert not kr.moves((40, 1, 20), (0, 2))
    assert kr.scratch_shape((700, 300), (0,)) == (3, 1, 320)
    assert kr.scratch_shape((300, 200), (0,)) == (2, 1, 224)
    assert kr.scratch_shape((200, 300), (0,)) == (0,)
    assert kr.scratch_bytes((40, 300, 20), (0, 2)) == 4 * (
        4 * 1 * 320 + 40 * 300 * 20)


def test_operator_shape_rule_on_meta():
    x = torch.empty(4, 5, 6, device="meta")
    for keepdim, want in ((False, (5,)), (True, (1, 5, 1))):
        got = kr.fixed_order_reduce(x, "sum", (0, 2), keepdim)
        assert got.device.type == "meta" and tuple(got.shape) == want


def test_operator_batching_rule_is_a_loop_of_solo_calls():
    x = _t(_rand((3, 300, 7), 13))
    calls = []
    plain = kr.fixed_order_reduce_plain

    def counted(*args):
        calls.append(1)
        return plain(*args)

    kr.fixed_order_reduce_plain = counted
    try:
        got = torch.func.vmap(lambda t: kr.fixed_order_reduce(t, "mean",
                                                              0))(x)
    finally:
        kr.fixed_order_reduce_plain = plain
    assert len(calls) == 3
    np.testing.assert_array_equal(
        got.numpy(), torch.stack([plain(t, "mean", (0,)) for t in x]))


# -- the engine with the card's route ------------------------------------


def _pkg(name):
    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, st=st_j if name == "spartan_tpu" else st_t,
        base=m("expr.base"), inc=m("expr.incremental"),
        prof=m("utils.profiling"), FLAGS=m("utils.config").FLAGS,
        lazify=m("expr.base").lazify, evaluate=m("expr.base").evaluate)


J = _pkg("spartan_tpu")
T = _pkg("spartan_tpu_torch")


def _route_on(monkeypatch):
    monkeypatch.setattr(kr, "routes", lambda device, dtype, op, axis, ndim:
                        kr.takes(dtype, op, axis, ndim))


@pytest.fixture()
def port(monkeypatch):
    """The port on the CPU, counting the plain reduction's calls (the
    route left as it is: a test turns it on with ``_route_on``)."""
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    calls = [0]
    plain = kr.fixed_order_reduce_plain

    def counted(*args):
        calls[0] += 1
        return plain(*args)

    monkeypatch.setattr(kr, "fixed_order_reduce_plain", counted)
    saved = (T.FLAGS.incremental, J.FLAGS.incremental)
    try:
        yield calls
    finally:
        T.FLAGS.incremental, J.FLAGS.incremental = saved
        T.inc.clear()
        J.inc.clear()
        mesh_t.set_default_device(prev)


@pytest.fixture()
def routed(port, monkeypatch):
    """The port on the CPU with the card's route."""
    _route_on(monkeypatch)
    return port


def _use(P, shape):
    if P is J:
        n = shape[0] * shape[1]
        return mesh_j.use_mesh(mesh_j.build_mesh(jax.devices()[:n],
                                                 shape=shape))
    return mesh_t.use_mesh(mesh_t.build_mesh(shape))


def _counts(P):
    c = P.prof.counters()
    return {k: int(c.get(k, 0)) for k in _COUNTERS}


def _mode(P, expr):
    plan = P.base.lookup_plan(P.base.plan_signature(expr)[0])
    inc = (plan.report or {}).get("incremental") or {}
    return inc.get("mode"), inc.get("fallback")


def _stream(P, shape, on, first, updates, build):
    """``build(P, arr)`` over the array ``first`` and after each of
    ``updates`` ((region, values) writes), the flag on or off: the warm
    results, the counter deltas and each warm evaluate's mode."""
    P.FLAGS.incremental = on
    P.inc.clear()
    with _use(P, shape):
        arr = P.st.from_numpy(first).evaluate()
        P.evaluate(build(P, arr))
        c0 = _counts(P)
        outs, modes = [], []
        for region, vals in updates:
            arr = arr.update(region, vals)
            outs.append(np.asarray(P.evaluate(build(P, arr)).glom()))
            modes.append(_mode(P, build(P, arr)))
        c1 = _counts(P)
    P.inc.clear()
    return outs, {k: c1[k] - c0[k] for k in _COUNTERS}, modes


def _served(shape, first, updates, build, tol=SUM):
    """The stream served at every warm evaluate, bit-equal to the
    flag-off run, with the JAX package's counters and modes and values
    within ``tol`` of it; returns the counter deltas."""
    outs, counts, modes = _stream(T, shape, True, first, updates, build)
    off = _stream(T, shape, False, first, updates, build)[0]
    jax_on = _stream(J, shape, True, first, updates, build)
    steps = len(updates)
    assert counts["incremental_hits"] == steps, (counts, modes)
    assert counts["incremental_fallbacks"] == 0, (counts, modes)
    assert modes == [("incremental", None)] * steps
    for got, want in zip(outs, off):
        np.testing.assert_array_equal(got, want)
    assert counts == jax_on[1]
    assert modes == jax_on[2]
    for got, want in zip(outs, jax_on[0]):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    return counts


def _columns(shape, seed, lo=0.0, hi=1.0, dtype=np.float32, width=5):
    rng = np.random.RandomState(seed)
    rows, cols = shape
    return [((slice(0, rows), slice(c, c + width)),
             (lo + (hi - lo) * rng.rand(rows, width)).astype(dtype))
            for c in (1, cols // 2 - 3, cols - width)]


def _col_sum(P, arr):
    return P.lazify(arr).sum(axis=0)


def _col_mean(P, arr):
    return P.lazify(arr).mean(axis=0)


def _col_prod(P, arr):
    return P.st.prod(P.lazify(arr), axis=0)


@pytest.mark.parametrize("shape", [(1, 1), (8, 1), (4, 2)])
def test_column_sum_stream_is_served_as_in_jax(shape, routed):
    """Each warm sum restricted to the rewritten columns (one plain call
    a warm evaluate), bit-equal to the flag-off run."""
    first = _rand((512, 384), 70)
    _served(shape, first, _columns((512, 384), 71), _col_sum)
    assert routed[0] >= 1 + 3


def test_column_sum_without_the_route_keeps_the_cpu_window(port):
    """Without the route the CPU's torch sum serves the same stream at
    windows of 32 columns, and the plain version never runs."""
    first = _rand((512, 384), 70)
    _served((8, 1), first, _columns((512, 384), 71), _col_sum)
    assert port[0] == 0


@pytest.mark.parametrize("build,lo,hi", [(_col_mean, 0.0, 1.0),
                                         (_col_prod, 0.99, 1.01)])
@pytest.mark.parametrize("shape", [(1, 1), (8, 1), (4, 2)])
def test_mean_and_prod_streams_are_served(shape, build, lo, hi, routed):
    first = _rand((512, 384), 72, lo, hi)
    _served(shape, first, _columns((512, 384), 73, lo, hi), build)


# C39's shapes: 3-D sums whose windows touch the tail of the flattened
# kept run, which torch's CPU sums cannot restrict; the kernel's order
# can. (kind, shape, region written with 1.0)
C39_MESHES = [(1, 1), (4, 2), (8, 1), (2, 4)]
C39_CASES = [
    ("sum", (300, 3, 200), (slice(10, 12), slice(0, 3), slice(161, 190))),
    ("sum", (300, 5, 100), (slice(10, 12), slice(0, 5), slice(70, 90))),
    ("sum", (50, 3, 1000), (slice(10, 12), slice(0, 3), slice(965, 1000))),
    ("fused", (300, 3, 200), (slice(10, 12), slice(0, 3),
                              slice(161, 190))),
    ("keepdims", (300, 3, 200), (slice(10, 12), slice(0, 3),
                                 slice(161, 190))),
]


def _c39_build(kind):
    def build(P, arr):
        e = P.lazify(arr)
        if kind == "fused":
            return (e * 2 + 1).sum(axis=0)
        if kind == "keepdims":
            return e.sum(axis=0, keepdims=True)
        return e.sum(axis=0)
    return build


@pytest.mark.parametrize("case", range(len(C39_CASES)))
@pytest.mark.parametrize("mesh", C39_MESHES)
def test_c39_shapes_are_served_through_the_route(mesh, case, routed):
    kind, shape, region = C39_CASES[case]
    vals = np.ones([s.stop - s.start for s in region], np.float32)
    _served(mesh, _rand(shape, 74), [(region, vals)], _c39_build(kind))


def _mean_3d(P, arr):
    return P.lazify(arr).mean(axis=0)


@pytest.mark.parametrize("mesh", [(1, 1), (8, 1)])
def test_3d_mean_along_axis0_is_served(mesh, routed):
    """The card's 3-D case at a small size: a mean along the first axis
    after 1% of the last axis is rewritten."""
    shape = (64, 8, 400)
    rng = np.random.RandomState(75)
    updates = [((slice(0, 64), slice(0, 8), slice(c, c + 4)),
                rng.rand(64, 8, 4).astype(np.float32)) for c in (3, 396)]
    _served(mesh, _rand(shape, 76), updates, _mean_3d)


@pytest.mark.parametrize("dtype", [np.int32, np.bool_])
@pytest.mark.parametrize("mesh", [(1, 1), (8, 1), (4, 2)])
def test_int_and_bool_sums_are_served_without_the_route(mesh, dtype, port):
    """Exact in any order: served on every device, no route needed, and
    the plain float32 reduction never runs."""
    rng = np.random.RandomState(77)
    first = (rng.randint(-50, 50, (300, 3, 200)) if dtype is np.int32
             else rng.rand(300, 3, 200) > 0.5).astype(dtype)
    updates = [((slice(0, 300), slice(0, 3), slice(c, c + 29)),
                (rng.randint(-50, 50, (300, 3, 29)) if dtype is np.int32
                 else rng.rand(300, 3, 29) > 0.5).astype(dtype))
               for c in (161, 7)]
    _served(mesh, first, updates, _col_sum, tol=0)
    assert port[0] == 0


def _row_sum(P, arr):
    return P.lazify(arr).sum(axis=1)


def test_inner_sum_rows_are_served_through_the_route(routed):
    rng = np.random.RandomState(78)
    updates = [((slice(r, r + 7), slice(0, 600)),
                rng.rand(7, 600).astype(np.float32)) for r in (3, 200)]
    _served((8, 1), _rand((384, 600), 79), updates, _row_sum)


@pytest.mark.parametrize("op,dtype,want", [
    ("sum", torch.float32, 1), ("mean", torch.float32, 1),
    ("prod", torch.float32, 1), ("sum", torch.int32, 1),
    ("mean", torch.int32, 1), ("sum", torch.bool, 1),
    ("sum", torch.float64, None), ("mean", torch.float64, None),
    ("sum", torch.float16, None), ("sum", torch.bfloat16, None)])
def test_card_holds_every_cut_axis_of_a_sum(port, op, dtype, want):
    """C47: on the card a row window of an inner-axis reduction is held
    to the whole reduction's order as a column window of an outer one
    is. A float32 sum, mean or product takes the kernel and an integer
    or bool sum is exact (granule 1); a float16, bfloat16 or float64 one
    keeps ``reduction-order`` (None) for either cut. On the CPU only the
    outer cut is held."""
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.array.extent import TileExtent

    card = types.SimpleNamespace(device=torch.device("cuda"),
                                 is_group=False)
    cpu = torch.device("cpu")
    with mesh_t.use_mesh(mesh_t.build_mesh((1, 1))):
        x = T.lazify(from_tensor(torch.ones((64, 48), dtype=dtype)))
        for axis, kept in ((1, 64), (0, 48)):
            n = getattr(T.st, op)(x, axis=axis)
            box = TileExtent((5,), (12,), (kept,))
            assert T.inc._ordered_cut(n, box, card.device) == [1 - axis]
            assert T.inc._ordered_cut(n, box, cpu) == \
                ([1] if axis == 0 else [])
            assert T.inc._ordered_cut(
                n, TileExtent((0,), (kept,), (kept,)), card.device) == []
            assert T.inc.reduce_granule(n, card) == want


# -- group meshes ------------------------------------------------------------

_GROUP_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(2)
import torch.distributed as dist
import spartan_tpu_torch as st
from spartan_tpu_torch.expr import base, incremental
from spartan_tpu_torch.kernels import reduce as kr
from spartan_tpu_torch.parallel import mesh as mesh_mod
from spartan_tpu_torch.utils import profiling as prof
from spartan_tpu_torch.utils.config import FLAGS

kr.routes = lambda device, dtype, op, axis, ndim: kr.takes(
    dtype, op, axis, ndim)
st.set_default_device("cpu")
assert st.initialize_distributed() is True
shape = tuple(json.loads(os.environ["SHAPE"]))
mesh = mesh_mod.Mesh(shape, torch.device("cpu"), group=dist.group.WORLD)


def counts():
    c = prof.counters()
    return [int(c.get(k, 0)) for k in ("incremental_hits",
                                       "incremental_fallbacks")]


def mode(expr):
    plan = base.lookup_plan(base.plan_signature(expr)[0])
    inc = (plan.report or {}).get("incremental") or {}
    return [inc.get("mode"), inc.get("fallback")]


arrays, facts = {}, {}
with mesh_mod.use_mesh(mesh):
    for on in (True, False):
        FLAGS.incremental = on
        incremental.clear()
        rng = np.random.RandomState(80)
        arr = st.from_numpy(rng.rand(512, 384).astype(np.float32)).evaluate()
        base.evaluate(st.lazify(arr).sum(axis=0))
        c0, modes = counts(), []
        for i, c in enumerate((1, 189, 379)):
            arr = arr.update((slice(0, 512), slice(c, c + 5)),
                             rng.rand(512, 5).astype(np.float32))
            got = base.evaluate(st.lazify(arr).sum(axis=0))
            arrays[f"{on}/{i}"] = np.asarray(got.glom())
            modes.append(mode(st.lazify(arr).sum(axis=0)))
        facts[str(on)] = [[x - y for x, y in zip(counts(), c0)], modes]
FLAGS.incremental = False
incremental.clear()
st.shutdown()
out = os.environ["OUT"]
np.savez(os.path.join(out, f"rank{mesh.rank}.npz"), **arrays)
with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
    json.dump(facts, f)
print("CHILD_OK", mesh.rank, flush=True)
# every result is written: skip the interpreter's teardown, where gloo's
# threads can abort a rank whose peer has already exited
os._exit(0)
"""


@functools.lru_cache(maxsize=None)
def _group_run(shape):
    """Every rank's (arrays, facts) of _GROUP_CHILD on a gloo group of
    the mesh ``shape``."""
    world = shape[0] * shape[1]
    tmp = tempfile.mkdtemp(prefix="reduce_group_")
    procs = []
    for rank in range(world):
        env = dict(os.environ, REPO=REPO, OUT=tmp, SHAPE=json.dumps(shape),
                   COORDINATOR_ADDRESS=f"file://{tmp}/store",
                   WORLD_SIZE=str(world), RANK=str(rank),
                   OMP_NUM_THREADS="1")
        for key in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
            env.pop(key, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _GROUP_CHILD], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GROUP_JOIN_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:  # a hung rank fails the test
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"CHILD_OK {rank}" in log, log[-3000:]
    outs = []
    for rank in range(world):
        arrays = dict(np.load(os.path.join(tmp, f"rank{rank}.npz")))
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            outs.append((arrays, json.load(f)))
    shutil.rmtree(tmp, ignore_errors=True)
    return outs


def test_group_line_of_two_serves_column_sums():
    """A (2, 1) world: the rows split over two ranks, whose partial sums
    meet in one add; every warm sum served on every rank, bit-equal to
    the group's flag-off run."""
    for arrays, facts in _group_run((2, 1)):
        assert facts["True"][0] == [3, 0]
        assert facts["True"][1] == [["incremental", None]] * 3
        assert facts["False"][0] == [0, 0]
        for i in range(3):
            np.testing.assert_array_equal(arrays[f"True/{i}"],
                                          arrays[f"False/{i}"])


def test_group_line_of_four_keeps_reduction_order():
    """A (4, 1) world: the partial sums of four ranks meet in an
    all-reduce whose order may follow the message's length, so every warm
    sum falls back under ``reduction-order``, bit-equal to the flag-off
    run."""
    for arrays, facts in _group_run((4, 1)):
        assert facts["True"][0] == [0, 3]
        assert facts["True"][1] == [["full", "reduction-order"]] * 3
        for i in range(3):
            np.testing.assert_array_equal(arrays[f"True/{i}"],
                                          arrays[f"False/{i}"])
