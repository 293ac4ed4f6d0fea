"""Parity of the PyTorch port's segment sums with the JAX package, on the
CPU: ``segment_sum`` on every path, ``segment_count``, the kernel
registry's ``segment_sum`` selection, ``SegmentPlan``'s layout and naive
Bayes.

The same seeded numpy inputs go through both packages. The JAX side
runs its Pallas kernel in interpret mode under
``FLAGS.native_kernels="on"`` on the 8x1 mesh, as tests/test_kernels.py
does; the port runs on a logical mesh of the same shape on the CPU,
where the kernel wrappers run their plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.examples import naive_bayes as nb_j
from spartan_tpu.kernels import registry as reg_j
from spartan_tpu.ops import segment as seg_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.examples import naive_bayes as nb_t
from spartan_tpu_torch.kernels import registry as reg_t
from spartan_tpu_torch.kernels import segment as kseg_t
from spartan_tpu_torch.ops import segment as seg_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU, on a logical 8x1 mesh; every FLAGS value a
    test sets (in either package) restored afterwards."""
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


def _int_stream(e, d, k, seed):
    """Integer-valued f32 values and ids out of range at both ends: every
    path sums them exactly, so all agree bit for bit."""
    rng = np.random.RandomState(seed)
    shape = (e,) if d is None else (e, d)
    vals = rng.randint(-8, 9, shape).astype(np.float32)
    ids = rng.randint(-2, k + 8, e).astype(np.int32)
    return vals, ids


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("impl", ["xla", "onehot", "pallas", "auto"])
@pytest.mark.parametrize("d,k", [(16, 12), (16, 16), (None, 12), (130, 5)])
def test_segment_sum_matches_jax_pallas(mesh1d, impl, d, k):
    FLAGS_J.native_kernels = "on"
    FLAGS_T.native_kernels = "on"
    vals, ids = _int_stream(1000, d, k, seed=7 + k)
    ref = seg_j.segment_sum(jnp.asarray(vals), jnp.asarray(ids), k,
                            impl="pallas")
    out = seg_t.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids),
                            k, impl=impl)
    assert out.dtype == torch.float32
    assert tuple(out.shape) == tuple(np.asarray(ref).shape)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


def test_segment_sum_non_integer_tolerance(mesh1d):
    """Non-integer values: the paths add in other orders. Each output is
    a sum of ~80 terms in [0, 1): two f32 orders differ by at most
    2 * 80 * 2^-24 * 80 ~ 8e-4 absolute; a few ulps in practice."""
    FLAGS_J.native_kernels = "on"
    rng = np.random.RandomState(3)
    vals = rng.rand(1000, 8).astype(np.float32)
    ids = rng.randint(0, 12, 1000)
    ref = np.asarray(seg_j.segment_sum(jnp.asarray(vals), jnp.asarray(ids),
                                       12, impl="pallas"))
    for impl in ("xla", "onehot", "pallas"):
        out = seg_t.segment_sum(torch.from_numpy(vals),
                                torch.from_numpy(ids), 12, impl=impl)
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6, atol=1e-5)


@pytest.mark.parametrize("impl", [None, "xla", "onehot", "pallas"])
def test_segment_count_matches_jax(mesh1d, impl):
    FLAGS_J.native_kernels = "on"
    rng = np.random.RandomState(5)
    ids = rng.randint(-3, 40, 777).astype(np.int32)
    ref = np.asarray(seg_j.segment_count(jnp.asarray(ids), 33, impl=impl))
    out = seg_t.segment_count(torch.from_numpy(ids), 33, impl=impl)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)
    keep = (ids >= 0) & (ids < 33)
    np.testing.assert_array_equal(out.numpy(),
                                  np.bincount(ids[keep], minlength=33))


def test_block_plain_is_the_onehot_path():
    """The plain version of the block kernel is the port's onehot path,
    and the wrapper runs it for CPU tensors."""
    vals, ids = _int_stream(500, 8, 10, seed=1)
    v, i = torch.from_numpy(vals), torch.from_numpy(ids)
    before = dict(kseg_t.LAUNCHES)
    a = kseg_t.segment_sum_block(v, i, 10)
    assert kseg_t.LAUNCHES == before  # the plain version counts no launch
    b = seg_t.segment_sum(v, i, 10, impl="onehot")
    assert torch.equal(a, b)
    assert torch.equal(kseg_t.segment_sum_block(v[:, 0], i, 10), b[:, 0])


def test_block_wrapper_rejects_bad_inputs():
    v = torch.zeros((8, 4))
    with pytest.raises(TypeError):
        kseg_t.segment_sum_block(v.double(), torch.zeros(8, dtype=torch.int64),
                                 3)
    with pytest.raises(TypeError):
        kseg_t.segment_sum_block(v, torch.zeros(8), 3)
    with pytest.raises(ValueError):
        kseg_t.segment_sum_block(v, torch.zeros(7, dtype=torch.int64), 3)
    # a meta tensor is a trace, not a device: the operator's shape rule
    # answers (the row proof of expr/partition.py records the kernel)
    out = kseg_t.segment_sum_block(v.to("meta"),
                                   torch.zeros(8, dtype=torch.int64,
                                               device="meta"), 3)
    assert out.device.type == "meta" and tuple(out.shape) == (3, 4)


# -- selection -----------------------------------------------------------

_SHAPES = [(512, 8), (1000, 16), (4096, 128), (4096, 2048), (262144, 2048),
           (1_000_000, 128), (100,), (4096,), (262144,), (1000, 3, 2), (0, 8),
           (16, 0)]


@pytest.mark.parametrize("mesh_shape", [(1, 1), (8, 1), (4, 2)])
@pytest.mark.parametrize("flag", ["auto", "on", "off"])
@pytest.mark.parametrize("force", [False, True])
def test_selection_agrees_with_jax(mesh_shape, flag, force):
    """The port's select("segment_sum") makes the JAX package's decision
    on every shape, dtype, segment count, flag and mesh shape."""
    FLAGS_J.native_kernels = flag
    FLAGS_T.native_kernels = flag
    devs = jax.devices()[:mesh_shape[0] * mesh_shape[1]]
    mj = mesh_j.build_mesh(devs, shape=mesh_shape)
    mt = mesh_t.build_mesh(mesh_shape)
    seen = set()
    for shape in _SHAPES:
        for dtype in (np.float32, np.float64, np.int32):
            for k in (1, 12, 20, 64, 1000, 4000, 20000):
                tj = tiling_j.row(max(len(shape), 1))
                tt = tiling_t.row(max(len(shape), 1))
                sj = reg_j.select("segment_sum", shape, dtype, tj, mj,
                                  force=force, num_segments=k)
                st = reg_t.select("segment_sum", shape, dtype, tt, mt,
                                  force=force, num_segments=k)
                assert st.native == sj.pallas, (shape, dtype, k, sj, st)
                if force or flag == "on":
                    # constraint fallbacks give the JAX package's reason
                    assert st.reason == sj.reason, (shape, dtype, k)
                seen.add(st.native)
    assert seen == ({False} if flag != "on" and not force
                    else {True, False})


def test_auto_keeps_library_scatter_with_reason():
    sel = reg_t.select("segment_sum", (512, 8), np.float32, None,
                       num_segments=16)
    assert not sel.native and "native_kernels=auto" in sel.reason
    # the JAX package's chip timings are not the port's: none is quoted
    assert "v5e" not in sel.reason
    assert not any(ch.isdigit() for ch in sel.reason)
    FLAGS_T.native_kernels = "on"
    assert reg_t.select("segment_sum", (512, 8), np.float32, None,
                        num_segments=16).native
    FLAGS_T.native_kernels = "off"
    assert reg_t.select("segment_sum", (512, 8), np.float32, None,
                        force=True, num_segments=16).native


def test_naive_bayes_shape_selects_kernel_for_counts_only():
    """At the naive-Bayes shape the 2-D counts take the kernel and the
    1-D class counts (lifted to rows of 128) fall back, in both
    packages."""
    FLAGS_T.native_kernels = "on"
    mt = mesh_t.build_mesh((1, 1))
    assert reg_t.select("segment_sum", (262144, 2048), np.float32, None, mt,
                        num_segments=20).native
    lifted = reg_t.select("segment_sum", (262144,), np.float32, None, mt,
                          num_segments=20)
    assert not lifted.native and "working set" in lifted.reason


def test_block_geometry_fits_shared_memory():
    for e, d, k in [(1_000_000, 128, 64), (262144, 2048, 20), (1000, 1, 12),
                    (10, 300, 37), (4096, 16, 15000), (0, 8, 3)]:
        d_tile, threads, n_chunks, rows = kseg_t._block_geometry(e, d, k, 132)
        assert 4 * k * d_tile <= 232448
        assert threads % 32 == 0 and threads >= d_tile
        assert n_chunks * rows >= e and n_chunks >= 1
        assert (n_chunks - 1) * rows < max(e, 1)
    assert kseg_t._block_geometry(1_000_000, 128, 64, 132)[0] == 128
    assert kseg_t.cuda_limits(58112) == "" and kseg_t.cuda_limits(58113)


# -- SegmentPlan ---------------------------------------------------------

_PLAN_CASES = {
    "random": (np.sort(np.random.RandomState(3).randint(0, 3000, 20000)),
               3000),
    "out_of_range": (np.array([0, 1, 1, 5, 7, 9, 9]), 6),
    "partial_trailing_block": (np.array([5, 139999]), 140000),
    "skewed": (np.zeros(24576, np.int64), 256 * 1024),
    "negative": (np.array([-3, -1, 0, 2, 2, 5, 9]), 6),
    "window_edges": (np.sort(np.r_[np.arange(0, 5000, 7), [1023, 1024,
                                                            2047, 2048]]),
                     5000),
}


@pytest.mark.parametrize("case", sorted(_PLAN_CASES))
def test_segment_plan_layout_matches_jax(case):
    ids, n = _PLAN_CASES[case]
    ids = ids.astype(np.int32)
    pj = seg_j.SegmentPlan(ids, n)
    pt = seg_t.SegmentPlan(ids, n)
    np.testing.assert_array_equal(pt._ids2d.numpy(), np.asarray(pj._ids2d))
    np.testing.assert_array_equal(pt._wb.numpy(), np.asarray(pj._wb))
    np.testing.assert_array_equal(pt.perm, pj.perm)
    for attr in ("padded_size", "nsteps", "rows_pad", "outblk", "n_pad",
                 "num_segments", "_lo"):
        assert getattr(pt, attr) == getattr(pj, attr), attr
    # the port's extra array: each window's region in subblocks
    starts = pt._starts.numpy()
    wb = pt._wb.numpy()
    assert starts[0] == 0 and starts.size == pt.n_pad // 1024 + 1
    for w in range(starts.size - 1):
        assert (wb[starts[w]:starts[w + 1]] == w).all()
    vals = np.arange(ids.size, dtype=np.float32)
    np.testing.assert_array_equal(pt.reorder(vals), pj.reorder(vals))


# -- naive Bayes ----------------------------------------------------------


def _nb_data(n, d, c, seed):
    rng = np.random.RandomState(seed)
    rates = rng.uniform(0.5, 4.0, (c, d))
    y = rng.randint(0, c, n).astype(np.int32)
    x = rng.poisson(rates[y]).astype(np.float32)
    return x, y


@pytest.mark.parametrize("flag", ["on", "off"])
def test_naive_bayes_matches_jax(mesh1d, flag):
    """fit/predict through both packages on the same counts: the
    segment sums are integer-valued (exact on every path), so the tables
    agree bit for bit; the predictions agree."""
    FLAGS_J.native_kernels = flag
    FLAGS_T.native_kernels = flag
    x, y = _nb_data(2048, 64, 5, seed=9)
    lp_j, ll_j = nb_j.fit(st_j.from_numpy(x), st_j.from_numpy(y), 5)
    xt, yt = st_t.from_numpy(x), st_t.from_numpy(y)
    lp_t, ll_t = nb_t.fit(xt, yt, 5)
    np.testing.assert_array_equal(lp_t, np.asarray(lp_j))
    np.testing.assert_array_equal(ll_t, np.asarray(ll_j))
    pred_j = np.asarray(nb_j.predict(st_j.from_numpy(x), lp_j, ll_j).glom())
    pred_t = nb_t.predict(xt, lp_t, ll_t).glom()
    assert pred_t.dtype == pred_j.dtype == np.int32
    np.testing.assert_array_equal(pred_t, pred_j)
    assert (pred_t == y).mean() > 0.95


def test_naive_bayes_two_class_example():
    """tests/test_examples.py::test_naive_bayes on the port."""
    rng = np.random.RandomState(4)
    n_per, d = 128, 12
    x0 = rng.poisson(5, (n_per, d)) * np.r_[np.ones(6), np.ones(6) * 0.2]
    x1 = rng.poisson(5, (n_per, d)) * np.r_[np.ones(6) * 0.2, np.ones(6)]
    X = np.concatenate([x0, x1]).astype(np.float32)
    y = np.concatenate([np.zeros(n_per), np.ones(n_per)]).astype(np.int32)
    FLAGS_T.native_kernels = "on"
    lp, ll = nb_t.fit(st_t.from_numpy(X), st_t.from_numpy(y), n_classes=2)
    pred = nb_t.predict(st_t.from_numpy(X), lp, ll).glom()
    assert (pred == y).mean() > 0.9


# -- the block kernel's operator ----------------------------------------


def test_block_kernel_traces_to_one_operator_node():
    """``make_fx`` records the block kernel as one node of the
    ``spartan_tpu_torch`` namespace (its shape rule answers on ``meta``
    tensors), so the row proof of ``expr/partition.py`` sees the kernel
    the replay calls."""
    from torch.fx.experimental.proxy_tensor import make_fx

    v = torch.empty((64, 5), device="meta")
    i = torch.empty((64,), dtype=torch.int32, device="meta")
    gm = make_fx(lambda a, b: kseg_t.segment_sum_block(a, b, 7))(v, i)
    ops = [str(n.target) for n in gm.graph.nodes
           if n.op == "call_function"]
    assert ops == ["spartan_tpu_torch.segment_sum_block.default"]
    assert tuple(gm(v, i).shape) == (7, 5)


@pytest.mark.parametrize("in_dims", [(0, 0), (0, None), (None, 0),
                                     (1, 0)])
def test_block_operator_batching_rule_is_the_solo_calls(in_dims):
    """``torch.func.vmap`` reaches the operator's batching rule: one call
    a client on that client's slice (a shared operand whole), stacked,
    bit-equal to the solo calls."""
    rng = np.random.RandomState(11)
    b, e, d, k = 3, 200, 6, 9
    vd, idd = in_dims
    vshape = {0: (b, e, d), None: (e, d), 1: (e, b, d)}[vd]
    vals = torch.from_numpy(rng.randn(*vshape).astype(np.float32))
    ids = torch.from_numpy(rng.randint(-2, k + 2, (b, e) if idd == 0
                                       else (e,)))
    got = torch.func.vmap(lambda v, i: kseg_t.segment_sum_block(v, i, k),
                          in_dims=in_dims)(vals, ids)
    for c in range(b):
        v = vals if vd is None else vals.select(vd, c)
        i = ids if idd is None else ids.select(idd, c)
        assert torch.equal(got[c], kseg_t.segment_sum_block(v, i, k))
