"""Served plans that reach kernel rows 4-7 stay in one vmap walk, on the
CPU.

``shard_topk``, ``bincount``, ``partition_pack`` and ``conv_block`` are
torch custom operators (``spartan_tpu_torch::...``), each with a shape
rule and a batching rule that runs the kernel (here its plain version)
once a client. The serve coalescer's ``torch.func.vmap`` walk of a
top-k, sort, argsort, histogram-with-a-range or H-tiled stencil plan
then stays in ``vmap`` mode, as the JAX package's batched program does
through ``pallas_call``'s batching rule.

For each plan, 8 seeded numpy requests go through both packages'
``ServeEngine``s on a logical (8, 1) mesh (``native_kernels=on``; the
port's stencil under ``auto``, where the registry selects the kernel):

* the port coalesces them as ``[8] * 8``, keeps the plan in ``vmap``
  with no demotion and no solo fallback, and calls the plain twin once a
  client through the operator's rule, never on a batched tensor;
* each served result is bit-equal to its serial ``evaluate()``;
* each equals the JAX package's served result, whose plan is in
  ``vmap`` too: bit for bit, but the stencil, held within
  ``tests/test_torch_stencil.py``'s rtol 1e-4 / atol 1e-5 (f32 sums of
  KH*KW*C products in different orders).

Then each operator alone: ``torch.func.vmap`` against a loop of solo
calls, with batched and shared operands, bit for bit; and its shape rule
on ``meta`` tensors in the plan audit's dry walk, which computes no
value.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.expr import base as base_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.serve import coalesce as coalesce_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J

import spartan_tpu_torch as st_t
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.expr import base
from spartan_tpu_torch.kernels import build as build_mod
from spartan_tpu_torch.kernels import exchange as kex
from spartan_tpu_torch.kernels import histogram as khist
from spartan_tpu_torch.kernels import registry as reg_t
from spartan_tpu_torch.kernels import stencil as kst
from spartan_tpu_torch.kernels import topk as ktopk
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.serve import coalesce
from spartan_tpu_torch.utils.config import FLAGS

torch.set_num_threads(1)

WAIT_S = 120
N_REQ = 8
H_PINNED = (None, "x", None, None)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _setup(mesh1d):
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    snap_t, snap_j = FLAGS.snapshot(), FLAGS_J.snapshot()
    FLAGS.retry_backoff_s = 0.0
    coalesce.reset_modes()
    coalesce_j.reset_modes()
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        yield
    st_t.serve.shutdown_default()
    st_j.serve.shutdown_default()
    coalesce.reset_modes()
    coalesce_j.reset_modes()
    for name, value in snap_t.items():
        setattr(FLAGS, name, value)
    for name, value in snap_j.items():
        setattr(FLAGS_J, name, value)
    mesh_t.set_default_device(prev)


def _serve_all(st, builds):
    """Queue every request before the worker starts, so that they form
    one batch; returns (results, futures)."""
    eng = st.ServeEngine(workers=1, batch_window_s=0.05, max_batch=N_REQ)
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    eng._threads.append(t)  # looks running: submissions stay queued
    futs = [eng.submit(b) for b in builds]
    eng._threads.clear()
    eng.start()
    try:
        return [f.glom(timeout=WAIT_S) for f in futs], futs
    finally:
        eng.stop()


def _arrays(out):
    return [np.asarray(o) for o in out] if isinstance(out, (tuple, list)) \
        else [np.asarray(out)]


# -- the five plans --------------------------------------------------------


def _keys(seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(4096).astype(np.float32) for _ in range(N_REQ)]


def _images(seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(2, 32, 16, 4).astype(np.float32) for _ in range(N_REQ)]


_FILTER = np.random.RandomState(41).rand(3, 3, 4, 8).astype(np.float32)


def _stencil_t(img):
    x = st_t.from_numpy(img, tiling=tiling_t.Tiling(H_PINNED))
    return st_t.stencil(x, _FILTER)


def _stencil_j(img):
    xe = st_j.as_expr(img)
    xe._forced_tiling = tiling_j.Tiling(H_PINNED)
    return st_j.stencil(xe, _FILTER)


# name -> (port build, JAX build, inputs, port's native_kernels, the
# plain twin the operator's rule calls: (module, attribute))
CASES = {
    "topk": (lambda x: st_t.tuple_of(*st_t.topk(st_t.from_numpy(x), 8)),
             lambda x: st_j.tuple_of(*st_j.topk(st_j.as_expr(x), 8)),
             lambda: _keys(30), "on", (ktopk, "shard_topk_plain")),
    "sort": (lambda x: st_t.sort(st_t.from_numpy(x)),
             lambda x: st_j.sort(st_j.as_expr(x)),
             lambda: _keys(31), "on", (kex, "partition_pack_plain")),
    "argsort": (lambda x: st_t.argsort(st_t.from_numpy(x)),
                lambda x: st_j.argsort(st_j.as_expr(x)),
                lambda: _keys(32), "on", (kex, "partition_pack_plain")),
    "histogram": (
        lambda x: st_t.histogram(st_t.from_numpy(x), 8, range=(0, 1))[0],
        lambda x: st_j.histogram(st_j.as_expr(x), 8, range=(0, 1))[0],
        lambda: _keys(33), "on", (khist, "bincount_shards_plain")),
    "stencil": (_stencil_t, _stencil_j, lambda: _images(34), "auto",
                (kst, "conv_block_plain")),
}


def _count_calls(monkeypatch, mod, twin):
    """Wrap the plain twin ``mod.twin``: the returned list records, a
    call each, whether its first operand was a batched tensor."""
    calls = []
    plain = getattr(mod, twin)

    def counted(*args):
        calls.append(torch._C._functorch.is_batchedtensor(args[0]))
        return plain(*args)

    monkeypatch.setattr(mod, twin, counted)
    return calls


def _demotions():
    return st_t.metrics()["counters"].get("serve_mode_demotions", 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_served_plan_stays_in_vmap_and_matches_jax(case, monkeypatch):
    build_t, build_j, inputs, mode, (mod, twin) = CASES[case]
    xs = inputs()
    FLAGS.native_kernels = mode
    FLAGS_J.native_kernels = "on"
    if case == "stencil":
        sel = reg_t.node_selection(build_t(xs[0]))
        assert sel.native, sel.reason

    calls = _count_calls(monkeypatch, mod, twin)
    serial = [_arrays(build_t(x).glom()) for x in xs]
    per_request = len(calls) // N_REQ
    assert per_request >= 1 and len(calls) == per_request * N_REQ
    del calls[:]
    dem = _demotions()
    got, futs = _serve_all(st_t, [build_t(x) for x in xs])

    assert [f.coalesced for f in futs] == [N_REQ] * N_REQ
    plan = base.lookup_plan(base.plan_signature(build_t(xs[0]))[0])
    assert coalesce.mode_for(plan) == "vmap"
    assert plan.report["serve"]["mode"] == "vmap"
    assert _demotions() == dem
    rec = st_t.flightrec()
    assert not any("fallback" in rec["requests"][f.rid]["events"]
                   for f in futs)
    # the rule: one plain call a client (as a solo walk makes), each on
    # that client's own unbatched tensors
    assert calls == [False] * (per_request * N_REQ)
    got = [_arrays(g) for g in got]
    for a, b in zip(serial, got):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)

    build_j(xs[0]).glom()  # the plan cached, as the port's serial runs do
    got_j, futs_j = _serve_all(st_j, [build_j(x) for x in xs])
    plan_j = base_j.lookup_plan(base_j.plan_signature(build_j(xs[0]))[0])
    assert coalesce_j.mode_for(plan_j) == "vmap"
    assert [f.coalesced for f in futs_j] == [N_REQ] * N_REQ
    for a, b in zip(got, [_arrays(g) for g in got_j]):
        for u, v in zip(a, b):
            assert u.shape == v.shape
            if case == "stencil":
                np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL)
            else:
                np.testing.assert_array_equal(u, v.astype(u.dtype))


# -- the expr paths: plans whose lowerings build their outputs out of place


def _ints(seed, lo, hi):
    rng = np.random.RandomState(seed)
    return [rng.randint(lo, hi, 4096).astype(np.int32) for _ in range(N_REQ)]


def _grid(seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(64, 48).astype(np.float32) for _ in range(N_REQ)]


# Each reads its block's shape and upper-left corner: exact integers, so
# the packages agree bit for bit.


def _location_j(b, ul):
    r = jnp.arange(b.shape[0], dtype=jnp.int32)[:, None] + ul[0]
    c = jnp.arange(b.shape[1], dtype=jnp.int32)[None, :] + ul[1]
    return ((b > 0.5).astype(jnp.int32) + r * 100 + c
            + b.shape[0] * 1000 + b.shape[1] * 10000)


def _location_t(b, ul):
    r = torch.arange(b.shape[0], dtype=torch.int32,
                     device=b.device)[:, None] + ul[0]
    c = torch.arange(b.shape[1], dtype=torch.int32,
                     device=b.device)[None, :] + ul[1]
    return ((b > 0.5).to(torch.int32) + r * 100 + c
            + b.shape[0] * 1000 + b.shape[1] * 10000)


def _both(fn):
    """One build for both packages: ``fn(st, x)`` on ``st.from_numpy``."""
    return (lambda x: fn(st_t, st_t.from_numpy(x)),
            lambda x: fn(st_j, st_j.from_numpy(x)))


# name -> (port build, JAX build, inputs): each under native_kernels=off,
# where the reshape reads no data pointer, the located blocks join with a
# concatenation, and the unique scatter and the counts' scatter-add are
# out of place
EXPR_CASES = {
    "reshape": (*_both(lambda st, x: st.reshape(x, (48, 64))),
                lambda: _grid(60)),
    "ravel": (*_both(lambda st, x: st.ravel(x)), lambda: _grid(61)),
    "map_with_location": (
        lambda x: st_t.map_with_location(st_t.from_numpy(x), _location_t),
        lambda x: st_j.map_with_location(st_j.from_numpy(x), _location_j),
        lambda: _grid(62)),
    "unique": (*_both(lambda st, x: st.tuple_of(
        *st.unique(x, 16, fill_value=-1.0, return_counts=True))),
        lambda: [v.astype(np.float32) for v in _ints(63, 0, 24)]),
    "bincount": (*_both(lambda st, x: st.bincount(x, length=16)),
                 lambda: _ints(64, -2, 20)),
    "histogram_range": (*_both(lambda st, x: st.tuple_of(
        *st.histogram(x, 8, range=(0.125, 0.875)))), lambda: _keys(65)),
    "histogram": (*_both(lambda st, x: st.tuple_of(*st.histogram(x, 8))),
                  lambda: _keys(66)),
}


_EXPR_RUNS = ([(c, (8, 1)) for c in EXPR_CASES]
              + [(c, (4, 2)) for c in ("reshape", "ravel",
                                       "map_with_location")])


@pytest.mark.parametrize("case,shape", _EXPR_RUNS,
                         ids=[f"{c}-{a}x{b}" for c, (a, b) in _EXPR_RUNS])
def test_served_expr_path_stays_in_vmap_and_matches_jax(case, shape):
    """The port coalesces the 8 requests as one batch in ``vmap`` mode with
    no demotion and no solo fallback; each served result is bit-equal to
    its serial ``evaluate()`` and to the JAX package's served result, whose
    plan is in ``vmap`` too."""
    build_t, build_j, inputs = EXPR_CASES[case]
    xs = inputs()
    FLAGS.native_kernels = "off"
    FLAGS_J.native_kernels = "off"
    with mesh_t.use_mesh(mesh_t.build_mesh(shape)), \
            mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)):
        serial = [_arrays(build_t(x).glom()) for x in xs]
        dem = _demotions()
        got, futs = _serve_all(st_t, [build_t(x) for x in xs])
        assert [f.coalesced for f in futs] == [N_REQ] * N_REQ
        plan = base.lookup_plan(base.plan_signature(build_t(xs[0]))[0])
        assert coalesce.mode_for(plan) == "vmap"
        assert plan.report["serve"]["mode"] == "vmap"
        assert _demotions() == dem
        rec = st_t.flightrec()
        assert not any("fallback" in rec["requests"][f.rid]["events"]
                       for f in futs)
        got = [_arrays(g) for g in got]
        for a, b in zip(serial, got):
            assert len(a) == len(b)
            for u, v in zip(a, b):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)

        build_j(xs[0]).glom()
        got_j, futs_j = _serve_all(st_j, [build_j(x) for x in xs])
        plan_j = base_j.lookup_plan(base_j.plan_signature(build_j(xs[0]))[0])
        assert coalesce_j.mode_for(plan_j) == "vmap"
        assert [f.coalesced for f in futs_j] == [N_REQ] * N_REQ
    for a, b in zip(got, [_arrays(g) for g in got_j]):
        for j, (u, v) in enumerate(zip(a, b)):
            assert u.shape == v.shape and u.dtype == v.dtype
            if case == "histogram" and j == 1:
                # edges from the data's range: XLA may rewrite
                # jnp.linspace's arithmetic, so they agree to a few ulps
                # (tests/test_torch_sort.py's autorange tolerance)
                np.testing.assert_allclose(u, v, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
def test_reshape_result_owns_its_storage(layout):
    """A solo reshape never hands back a view of its operand: where the
    strides allow a view it is cloned, and where they do not the reshape
    has copied. Either way the values are the operand's, in row-major
    order."""
    a = np.random.RandomState(67).rand(16, 12).astype(np.float32)
    x = st_t.from_numpy(a if layout == "contiguous" else a.T.copy())
    src = x if layout == "contiguous" else st_t.transpose(x)
    operand = src.evaluate()
    out = st_t.reshape(operand, (12, 16)).evaluate()
    assert (out.tensor.untyped_storage().data_ptr()
            != operand.tensor.untyped_storage().data_ptr())
    np.testing.assert_array_equal(out.glom(), a.reshape(12, 16))


# -- each operator under torch.func.vmap -----------------------------------


def _equal(a, b):
    if isinstance(a, tuple):
        return all(torch.equal(u, v) for u, v in zip(a, b))
    return torch.equal(a, b)


def _stacked(outs):
    if isinstance(outs[0], tuple):
        return tuple(torch.stack([o[j] for o in outs])
                     for j in range(len(outs[0])))
    return torch.stack(outs)


@pytest.mark.parametrize("sentinel,dtype", [(float("-inf"), torch.float32),
                                            (-2 ** 31, torch.int32)])
def test_shard_topk_vmap_rule_matches_solo_calls(monkeypatch, sentinel,
                                                 dtype):
    g = torch.Generator().manual_seed(50)
    keys = (torch.rand((5, 3, 40), generator=g) * 7).to(dtype)
    calls = _count_calls(monkeypatch, ktopk, "shard_topk_plain")
    got = torch.func.vmap(lambda k: ktopk.shard_topk(k, 6, sentinel))(keys)
    assert calls == [False] * 5
    want = _stacked([ktopk.shard_topk(keys[i], 6, sentinel)
                     for i in range(5)])
    assert _equal(got, want)
    assert got[1].dtype == torch.int32
    # a batch along another dim: the rule takes each client's slice
    got2 = torch.func.vmap(lambda k: ktopk.shard_topk(k, 6, sentinel),
                           in_dims=1)(keys.transpose(0, 1))
    assert _equal(got2, want)


@pytest.mark.parametrize("shards", [1, 8])
def test_bincount_vmap_rule_matches_solo_calls(monkeypatch, shards):
    g = torch.Generator().manual_seed(51)
    ids = torch.randint(-3, 14, (6, 1003), generator=g, dtype=torch.int32)
    calls = _count_calls(monkeypatch, khist, "bincount_shards_plain")
    if shards == 1:
        def fn(i):
            return khist.bincount_block(i, 10)
    else:
        def fn(i):
            return khist.bincount_sharded(i, 10)
    got = torch.func.vmap(fn)(ids)
    assert calls == [False] * 6
    want = torch.stack([fn(ids[i]) for i in range(6)])
    assert torch.equal(got, want) and got.dtype == torch.int32
    np.testing.assert_array_equal(
        got[2].numpy(), np.bincount(np.clip(ids[2].numpy(), 0, None),
                                    minlength=14)[:10])


@pytest.mark.parametrize("batched", ["xs", "runs", "all"])
def test_partition_pack_vmap_rule_matches_solo_calls(monkeypatch, batched):
    rng = np.random.RandomState(52)
    xs = torch.from_numpy(rng.rand(4, 6, 50).astype(np.float32))
    counts = torch.from_numpy(rng.randint(0, 7, (4, 6, 8)).astype(np.int32))
    starts = (torch.cumsum(counts, -1) - counts).to(torch.int32)
    x_d = None if batched == "runs" else 0
    r_d = None if batched == "xs" else 0
    xs_in = xs if x_d == 0 else xs[0]
    s_in, c_in = (starts, counts) if r_d == 0 else (starts[0], counts[0])
    calls = _count_calls(monkeypatch, kex, "partition_pack_plain")
    got = torch.func.vmap(kex.partition_pack, in_dims=(x_d, r_d, r_d))(
        xs_in, s_in, c_in)
    assert calls == [False] * 4
    want = torch.stack([kex.partition_pack(
        xs[i] if x_d == 0 else xs[0], starts[i] if r_d == 0 else starts[0],
        counts[i] if r_d == 0 else counts[0]) for i in range(4)])
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("c", [3, 8])
@pytest.mark.parametrize("form", ["blocks", "images", "both_batched"])
def test_conv_block_vmap_rule_matches_solo_calls(monkeypatch, form, c):
    """Both routes' channel counts (C <= 4, C > 4), halo blocks and
    plain images, the filter shared or batched."""
    g = torch.Generator().manual_seed(53)
    if form == "blocks":
        x = torch.stack([kst.halo_exchange(
            torch.rand((2, 16, 8, c), generator=g), 3, 3, 4)
            for _ in range(3)])
    else:
        x = torch.rand((3, 2, 10, 9, c), generator=g)
    w = torch.rand((3, 3, 3, c, 5), generator=g)
    w_d = 0 if form == "both_batched" else None
    w_in = w if w_d == 0 else w[0]
    calls = _count_calls(monkeypatch, kst, "conv_block_plain")
    got = torch.func.vmap(kst.conv_block, in_dims=(0, w_d))(x, w_in)
    # each client's call (a 5-D call adds its 4-D one): never batched
    assert calls and not any(calls)
    assert len(calls) == 3 * (2 if form == "blocks" else 1)
    want = torch.stack([kst.conv_block(x[i], w[i] if w_d == 0 else w[0])
                        for i in range(3)])
    assert torch.equal(got, want)


def test_halo_exchange_under_vmap_matches_solo_calls():
    """The halo blocks are built out of place: a batched walk takes
    them, each client's blocks bit-equal to its solo blocks."""
    x = torch.rand((4, 2, 16, 8, 3), generator=torch.Generator()
                   .manual_seed(54))
    got = torch.func.vmap(lambda t: kst.halo_exchange(t, 3, 2, 4))(x)
    want = torch.stack([kst.halo_exchange(x[i], 3, 2, 4) for i in range(4)])
    assert torch.equal(got, want)


# -- the shape rules on meta tensors ---------------------------------------


def _meta(t):
    return t.to("meta")


@pytest.mark.parametrize("op", ["shard_topk", "bincount", "partition_pack",
                                "conv_block", "conv_block_halo"])
def test_operator_shape_rule_on_meta(op, monkeypatch):
    """In the plan audit's dry walk (``build.SHAPES_ONLY``) a wrapper
    given ``meta`` tensors answers with the operator's shape rule: the
    shapes and dtypes of the CPU call, and no plain version runs. The
    operator itself answers on ``meta`` tensors anywhere."""
    g = torch.Generator().manual_seed(55)
    if op == "shard_topk":
        args = (torch.rand((3, 40), generator=g), 6, float("-inf"))
        fn, mod, twin = ktopk.shard_topk, ktopk, "shard_topk_plain"
        direct = torch.ops.spartan_tpu_torch.shard_topk
    elif op == "bincount":
        args = (torch.randint(0, 9, (1001,), generator=g), 12)
        fn, mod, twin = khist.bincount_sharded, khist, \
            "bincount_shards_plain"
        direct = None
    elif op == "partition_pack":
        counts = torch.full((4, 8), 2, dtype=torch.int32)
        args = (torch.rand((4, 30), generator=g),
                (torch.cumsum(counts, 1) - counts).to(torch.int32), counts)
        fn, mod, twin = kex.partition_pack, kex, "partition_pack_plain"
        direct = torch.ops.spartan_tpu_torch.partition_pack
    else:
        x = torch.rand((2, 16, 8, 5), generator=g)
        if op == "conv_block_halo":
            x = kst.halo_exchange(x, 3, 3, 4)
        args = (x, torch.rand((3, 3, 5, 7), generator=g))
        fn, mod, twin = kst.conv_block, kst, "conv_block_plain"
        direct = torch.ops.spartan_tpu_torch.conv_block
    want = fn(*args)
    metas = tuple(_meta(a) if isinstance(a, torch.Tensor) else a
                  for a in args)
    calls = _count_calls(monkeypatch, mod, twin)
    build_mod.SHAPES_ONLY.on = True
    try:
        got = fn(*metas)
    finally:
        build_mod.SHAPES_ONLY.on = False
    assert calls == []
    for u, v in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert v.device.type == "meta"
        assert (tuple(v.shape), v.dtype) == (tuple(u.shape), u.dtype)
    if op == "bincount":
        direct_out = torch.ops.spartan_tpu_torch.bincount(
            metas[0], 12, 8, 512)
        assert tuple(direct_out.shape) == (12,)
        assert direct_out.dtype == torch.int32
    else:
        direct_out = direct(*metas)
        for u, v in zip(want if isinstance(want, tuple) else (want,),
                        direct_out if isinstance(direct_out, tuple)
                        else (direct_out,)):
            assert (tuple(v.shape), v.dtype) == (tuple(u.shape), u.dtype)
    # outside the dry walk a meta tensor is still refused by the wrapper
    with pytest.raises(ValueError, match="kernel for device meta"):
        fn(*metas)
