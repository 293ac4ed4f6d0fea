"""Parity of the PyTorch port's sort/select kernels with the JAX package,
on the CPU: each kernel's plain version against the JAX package's Pallas
kernel run in interpret mode, the wrappers' contracts, and the kernel
registry's ``topk``, ``bincount`` and ``sort_exchange`` selections.

The same seeded numpy inputs go through both packages; the JAX side runs
under ``FLAGS.native_kernels="on"`` on the 8x1 mesh, as
tests/test_kernels.py does. Every comparison here is exact: the kernels
copy, count or select, so no tolerance applies.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.kernels import exchange as kex_j
from spartan_tpu.kernels import histogram as khist_j
from spartan_tpu.kernels import registry as reg_j
from spartan_tpu.kernels import topk as ktopk_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J
import spartan_tpu_torch as st_t
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.kernels import exchange as kex_t
from spartan_tpu_torch.kernels import histogram as khist_t
from spartan_tpu_torch.kernels import registry as reg_t
from spartan_tpu_torch.kernels import topk as ktopk_t
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


# -- partition_pack ---------------------------------------------------------


def _runs(counts):
    counts = np.asarray(counts, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    return starts, counts


_PACK_CASES = {
    "mixed": (37, [10, 0, 20, 2, 0, 1, 3, 1]),
    "one_takes_all": (37, [0, 0, 0, 37, 0, 0, 0, 0]),
    "ragged_prefix": (130, [0, 40, 1, 0, 0, 17, 0, 0]),
    "all_empty": (16, [0] * 8),
}


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("case", sorted(_PACK_CASES))
def test_partition_pack_plain_matches_jax_kernel(mesh1d, dtype, case):
    """Bit for bit over hostile 32-bit patterns (NaN payloads, -0.0,
    denormals), like tests/test_kernels.py's unit."""
    m, counts = _PACK_CASES[case]
    p = 8
    rng = np.random.RandomState(m + sum(counts))
    bits = rng.randint(0, 2 ** 32, m, np.uint64).astype(np.uint32)
    bits[:3] = [0x80000000, 0x7FC00001, 0xFFC12345]
    xs = bits.view(np.float32) if dtype == np.float32 else bits.view(
        np.int32)
    starts, counts = _runs(counts)
    FLAGS_J.native_kernels = "on"
    sel = reg_j.select("sort_exchange", (p * m,), dtype, tiling_j.row(1),
                       p=p, m=m)
    assert sel.pallas
    ref = np.asarray(kex_j.partition_pack(
        jnp.asarray(xs), jnp.asarray(starts), jnp.asarray(counts), p, sel))
    out = kex_t.partition_pack(torch.from_numpy(xs)[None],
                               torch.from_numpy(starts)[None],
                               torch.from_numpy(counts)[None])
    assert tuple(out.shape) == (1, p, m)
    np.testing.assert_array_equal(out[0].numpy().view(np.uint32),
                                  ref.view(np.uint32))


def test_partition_pack_batched_rows_are_independent():
    rng = np.random.RandomState(1)
    xs = torch.from_numpy(rng.rand(6, 50).astype(np.float32))
    counts = torch.from_numpy(rng.randint(0, 7, (6, 8)).astype(np.int32))
    starts = torch.cumsum(counts, 1) - counts
    out = kex_t.partition_pack(xs, starts.int(), counts)
    for b in range(6):
        one = kex_t.partition_pack(xs[b:b + 1], starts[b:b + 1].int(),
                                   counts[b:b + 1])
        assert torch.equal(out[b:b + 1], one)


def test_partition_pack_wrapper_contract():
    xs = torch.zeros((2, 8))
    runs = torch.zeros((2, 4), dtype=torch.int32)
    before = dict(kex_t.LAUNCHES)
    kex_t.partition_pack(xs, runs, runs)
    assert kex_t.LAUNCHES == before  # the plain version counts no launch
    with pytest.raises(TypeError, match="4-byte"):
        kex_t.partition_pack(xs.double(), runs, runs)
    with pytest.raises(ValueError, match="runs"):
        kex_t.partition_pack(xs, runs[:1], runs[:1])
    with pytest.raises(ValueError, match="no partition_pack kernel"):
        kex_t.partition_pack(xs.to("meta"), runs.to("meta"),
                             runs.to("meta"))


# -- shard_topk ---------------------------------------------------------------


def _topk_keys(case, rng):
    if case == "random":
        return rng.rand(1000).astype(np.float32), float("-inf")
    if case == "ties_f32":
        return rng.randint(0, 5, 777).astype(np.float32), float("-inf")
    if case == "ties_i32":
        return rng.randint(-3, 3, 777).astype(np.int32), -2 ** 31
    if case == "sentinel_f32":
        k = np.full(300, -np.inf, np.float32)
        k[[4, 150]] = 2.0
        return k, float("-inf")
    if case == "sentinel_i32":
        k = np.full(300, np.iinfo(np.int32).min, np.int32)
        k[299] = 7
        return k, -2 ** 31
    if case == "short":  # fewer keys than k: padding fills the tail
        return rng.rand(50).astype(np.float32), float("-inf")
    raise KeyError(case)


@pytest.mark.parametrize("k", [1, 9, 128])
@pytest.mark.parametrize("case", ["random", "ties_f32", "ties_i32",
                                  "sentinel_f32", "sentinel_i32", "short"])
def test_shard_topk_plain_matches_jax_kernel(mesh1d, case, k):
    """Equal keys and equal indices: best first, ties to the lowest
    index, padding (sentinel, 2**30) clamped to m - 1."""
    rng = np.random.RandomState(3)
    key, sentinel = _topk_keys(case, rng)
    m = key.size
    FLAGS_J.native_kernels = "on"
    sel = reg_j.select("topk", (8 * m,), key.dtype, tiling_j.row(1), k=k)
    assert sel.pallas
    ref_k, ref_i = ktopk_j.shard_topk(jnp.asarray(key), k,
                                      key.dtype.type(sentinel), sel)
    out_k, out_i = ktopk_t.shard_topk(torch.from_numpy(key)[None], k,
                                      sentinel)
    assert out_i.dtype == torch.int32
    np.testing.assert_array_equal(out_k[0].numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(out_i[0].numpy(), np.asarray(ref_i))


def test_topk_order_is_lax_top_k_total_order():
    """``top_k`` (the plain version's order) is ``lax.top_k``'s: +NaN
    above +inf, +0.0 above -0.0, -NaN below -inf, ties to the lowest
    index. The JAX package's Pallas kernel compares with ``==`` and
    ``max`` instead, so it disagrees on NaN and signed zeros; the port
    follows ``lax.top_k``."""
    v = np.array([0.0, -0.0, 1.0, np.nan, -np.nan, 1.0, -np.inf, np.nan],
                 np.float32)
    ref_k, ref_i = jax.lax.top_k(jnp.asarray(v), 8)
    out_k, out_i = ktopk_t.top_k(torch.from_numpy(v), 8)
    np.testing.assert_array_equal(out_i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(out_k.numpy().view(np.uint32),
                                  np.asarray(ref_k).view(np.uint32))
    vi = np.array([3, 5, 5, 1, 5, -2 ** 31, 2 ** 31 - 1], np.int32)
    np.testing.assert_array_equal(
        ktopk_t.top_k(torch.from_numpy(vi), 7)[1].numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(vi), 7)[1]))


def test_shard_topk_wrapper_contract():
    key = torch.rand((3, 40))
    before = dict(ktopk_t.LAUNCHES)
    keys, idx = ktopk_t.shard_topk(key, 5, float("-inf"))
    assert ktopk_t.LAUNCHES == before
    assert keys.shape == idx.shape == (3, 5) and idx.dtype == torch.int32
    with pytest.raises(ValueError, match=r"\(B, m\)"):
        ktopk_t.shard_topk(key[0], 5, float("-inf"))
    with pytest.raises(ValueError, match="no shard_topk kernel"):
        ktopk_t.shard_topk(key.to("meta"), 5, float("-inf"))
    assert ktopk_t.cuda_limits(torch.float32, 40, 129)
    assert ktopk_t.cuda_limits(torch.float16, 40, 5)
    assert ktopk_t.cuda_limits(np.int32, 40, 128) == ""


# -- bincount_block -------------------------------------------------------------

_BINCOUNT_CASES = {
    "oob_both_ends": (-3, 14, 1003, 10),
    "length_4096": (-50, 4200, 5003, 4096),
    "block_multiple": (0, 64, 2048, 64),
    "length_1": (0, 3, 7, 1),
}


@pytest.mark.parametrize("case", sorted(_BINCOUNT_CASES))
def test_bincount_plain_matches_jax_kernel(mesh1d, case):
    """Equal counts: negatives in bucket 0, ids >= length dropped."""
    lo, hi, e, length = _BINCOUNT_CASES[case]
    ids = np.random.RandomState(e).randint(lo, hi, e).astype(np.int32)
    ref = np.asarray(khist_j.bincount_block(jnp.asarray(ids), length,
                                            interpret=True))
    out = khist_t.bincount_block(torch.from_numpy(ids), length)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int32))
    np.testing.assert_array_equal(
        out.numpy(), np.bincount(np.clip(ids, 0, None)[ids < length],
                                 minlength=length))


@pytest.mark.parametrize("case", sorted(_BINCOUNT_CASES))
def test_bincount_sharded_matches_jax(mesh1d, case):
    lo, hi, e, length = _BINCOUNT_CASES[case]
    ids = np.random.RandomState(e + 1).randint(lo, hi, e).astype(np.int32)
    FLAGS_J.native_kernels = "on"
    sel = reg_j.select("bincount", ids.shape, ids.dtype, tiling_j.row(1),
                       length=length)
    if not sel.pallas:  # the TPU budget refuses it: the kernel alone
        sel = reg_j.Selection("bincount", "pallas", "", None, True)
    ref = np.asarray(khist_j.bincount_sharded(jnp.asarray(ids), length,
                                              sel))
    out = khist_t.bincount_sharded(torch.from_numpy(ids), length)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_bincount_wrapper_contract():
    before = dict(khist_t.LAUNCHES)
    khist_t.bincount_block(torch.arange(5), 3)
    assert khist_t.LAUNCHES == before
    with pytest.raises(TypeError, match="integers"):
        khist_t.bincount_block(torch.zeros(4), 3)
    with pytest.raises(ValueError, match="no bincount_block kernel"):
        khist_t.bincount_block(torch.zeros(4, dtype=torch.int32,
                                           device="meta"), 3)
    assert khist_t.cuda_limits(58112, 10) == ""
    assert khist_t.cuda_limits(58113, 10)


# -- selection -------------------------------------------------------------------

_SHAPES = [(0,), (1,), (13,), (1000,), (4096,), (65536,), (2 ** 23,),
           (2 ** 26,), (64, 4)]
_DTYPES = [np.float32, np.int32, np.float16, np.int8, np.bool_, np.float64]


def _vmem_only(reason: str) -> bool:
    return "VMEM budget" in reason and "4096" not in reason


def _agree(sj, st):
    """The port takes the JAX package's decision, except where the JAX
    package refuses for its TPU working-set budget alone: there the CUDA
    kernel takes the shape."""
    if _vmem_only(sj.reason) and not sj.pallas:
        assert st.native, (sj, st)
        return
    assert st.native == sj.pallas, (sj, st)


@pytest.mark.parametrize("mesh_shape", [(1, 1), (8, 1), (4, 2)])
@pytest.mark.parametrize("flag", ["auto", "on", "off"])
@pytest.mark.parametrize("force", [False, True])
def test_selection_agrees_with_jax(mesh_shape, flag, force):
    """topk, bincount and sort_exchange over shapes, dtypes, k, length, p,
    flags and mesh shapes. The port's ``auto`` is the JAX package's
    ``auto`` on its own chip, i.e. its ``on``."""
    FLAGS_J.native_kernels = "on" if flag == "auto" else flag
    FLAGS_T.native_kernels = flag
    devs = jax.devices()[:mesh_shape[0] * mesh_shape[1]]
    mj = mesh_j.build_mesh(devs, shape=mesh_shape)
    mt = mesh_t.build_mesh(mesh_shape)
    seen = set()
    for shape in _SHAPES:
        tj, tt = tiling_j.row(len(shape)), tiling_t.row(len(shape))
        for dtype in _DTYPES:
            for k in (1, 64, 128, 129):
                sj = reg_j.select("topk", shape, dtype, tj, mj, force=force,
                                  k=k)
                st = reg_t.select("topk", shape, dtype, tt, mt, force=force,
                                  k=k)
                _agree(sj, st)
                seen.add(st.native)
            for length in (1, 64, 2048, 4096, 4097):
                sj = reg_j.select("bincount", shape, dtype, tj, mj,
                                  force=force, length=length)
                st = reg_t.select("bincount", shape, dtype, tt, mt,
                                  force=force, length=length)
                _agree(sj, st)
            for p in (1, 2, 8):
                m = -(-shape[0] // p)
                sj = reg_j.select("sort_exchange", shape[:1], dtype,
                                  tiling_j.row(1), mj, force=force, p=p,
                                  m=m)
                st = reg_t.select("sort_exchange", shape[:1], dtype,
                                  tiling_t.row(1), mt, force=force, p=p,
                                  m=m)
                _agree(sj, st)
    assert seen == ({False} if flag == "off" and not force
                    else {True, False})


def test_selection_reasons_match_jax_under_on(mesh1d):
    FLAGS_J.native_kernels = FLAGS_T.native_kernels = "on"
    for op, shape, dtype, params in [
            ("topk", (512,), np.float16, {"k": 4}),
            ("topk", (512,), np.float32, {"k": 200}),
            ("topk", (64, 4), np.float32, {"k": 4}),
            ("bincount", (64, 4), np.int32, {"length": 8}),
            ("bincount", (512,), np.float32, {"length": 8}),
            ("bincount", (512,), np.int32, {"length": 65536}),
            ("sort_exchange", (512,), np.float32, {"p": 1, "m": 512}),
            ("sort_exchange", (512,), np.float16, {"p": 8, "m": 64})]:
        sj = reg_j.select(op, shape, dtype, tiling_j.row(len(shape)),
                          **params)
        st = reg_t.select(op, shape, dtype, tiling_t.row(len(shape)),
                          **params)
        assert not sj.pallas and not st.native
        assert st.reason == sj.reason


def test_main_path_shapes_select_the_kernels():
    """At the card's main-path shapes (2^26 elements over 8 logical
    shards) the CUDA kernels are selected; the JAX package's TPU
    working-set budget, which would refuse bincount and the exchange
    there, is not carried."""
    m = 2 ** 23
    assert reg_t.select("topk", (2 ** 26,), np.float32, None, k=128).native
    assert reg_t.select("bincount", (2 ** 26,), np.int32, None,
                        length=4096).native
    assert reg_t.select("sort_exchange", (2 ** 26,), np.float32, None, p=8,
                        m=m).native
    FLAGS_T.native_kernels = "off"
    sel = reg_t.select("topk", (2 ** 26,), np.float32, None, k=128)
    assert not sel.native and "off" in sel.reason


def test_node_selection_for_the_slice_exprs():
    x = st_t.from_numpy(np.random.RandomState(0).rand(1001).astype(
        np.float32))
    ids = st_t.from_numpy(np.arange(64, dtype=np.int32))
    from spartan_tpu_torch.expr.builtins import (BincountExpr,
                                                 SampleSortExpr, TopKExpr)

    assert reg_t.node_selection(SampleSortExpr(x)).native
    assert reg_t.node_selection(TopKExpr(x, 5, True)).native
    assert reg_t.node_selection(BincountExpr(ids, 64)).native
    assert not reg_t.node_selection(TopKExpr(x, 200, True)).native
    assert reg_t.node_selection(x) is None
