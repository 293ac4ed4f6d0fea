"""The port's CUDA kernels on the card: each against its plain torch
version, and the wrapper's refusal to fall back.

These tests need an NVIDIA card and ``nvcc``; elsewhere they skip. The
file imports no JAX, so on a machine with a card and without JAX it
runs on its own::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from spartan_tpu_torch.kernels import kmeans as kk

torch.set_num_threads(1)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _clustered(n, d, k, seed):
    rng = np.random.RandomState(seed)
    true = (rng.rand(k, d) * 4.0).astype(np.float32)
    pts = (true[rng.randint(0, k, n)]
           + 0.05 * rng.randn(n, d)).astype(np.float32)
    c0 = (true + 0.05 * rng.randn(k, d)).astype(np.float32)
    return pts, c0


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,valid", [
    (8192, 128, 8, None), (8192, 128, 8, 7000), (4096, 128, 128, None),
    (4096, 128, 1, 4000), (4096, 256, 64, None), (4096, 1024, 16, 100),
    (1024, 128, 4, 0)])
def test_kernel_matches_plain(card, n, d, k, valid):
    pts, c0 = _clustered(n, d, k, seed=n + d + k)
    p, c = torch.from_numpy(pts).to(card), torch.from_numpy(c0).to(card)
    before = kk.LAUNCHES
    s_k, n_k = kk.assign_accumulate(p, c, k, valid)
    torch.cuda.synchronize()
    assert kk.LAUNCHES == before + 1
    s_p, n_p = kk.assign_accumulate_plain(p, c, k, valid)
    # well-separated clusters: identical assignments; sums differ only
    # in summation order (f32, at most a few thousand terms per sum)
    torch.testing.assert_close(n_k, n_p, rtol=0, atol=0)
    torch.testing.assert_close(s_k, s_p, rtol=2e-5, atol=1e-3)


@pytest.mark.cuda
def test_kernel_is_deterministic(card):
    pts, c0 = _clustered(65536, 128, 32, seed=1)
    p, c = torch.from_numpy(pts).to(card), torch.from_numpy(c0).to(card)
    a = kk.assign_accumulate(p, c, 32, 60000)
    b = kk.assign_accumulate(p, c, 32, 60000)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(128, 1), (128, 7), (128, 128), (256, 1),
                                 (256, 7), (256, 112)])
@pytest.mark.parametrize("valid", [None, 5_001])
def test_kernel_center_and_row_edges(card, d, k, valid):
    """Center counts off the 64-center register block, both staging
    routes (d = 256 or k = 128 read the rows from global memory) and a
    valid_rows that ends inside a 128-row tile. At d = 256, k = 112 is
    the most centers the kernel's limits take (k = 128 raises)."""
    pts, c0 = _clustered(6144, d, k, seed=10 * d + k)
    p, c = torch.from_numpy(pts).to(card), torch.from_numpy(c0).to(card)
    before = kk.LAUNCHES
    s_k, n_k = kk.assign_accumulate(p, c, k, valid)
    torch.cuda.synchronize()
    assert kk.LAUNCHES == before + 1
    s_p, n_p = kk.assign_accumulate_plain(p, c, k, valid)
    torch.testing.assert_close(n_k, n_p, rtol=0, atol=0)
    torch.testing.assert_close(s_k, s_p, rtol=2e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("k,twin", [(2, 1), (64, 37), (64, 63), (70, 65)])
def test_kernel_first_of_identical_centers_wins(card, k, twin):
    """Center `twin` repeats center `twin - 1`: their scores tie, and the
    lower index takes every row of that cluster (as argmin does). The
    reference is the plain version without the twin, with an empty
    cluster in its place."""
    pts, c0 = _clustered(4096, 128, k, seed=k + twin)
    c0[twin] = c0[twin - 1]
    p, c = torch.from_numpy(pts).to(card), torch.from_numpy(c0).to(card)
    s_k, n_k = kk.assign_accumulate(p, c, k)
    keep = [i for i in range(k) if i != twin]
    s_p, n_p = kk.assign_accumulate_plain(p, c[keep], k - 1)
    s_p = torch.cat([s_p[:twin], torch.zeros_like(s_p[:1]), s_p[twin:]])
    n_p = torch.cat([n_p[:twin], torch.zeros_like(n_p[:1]), n_p[twin:]])
    assert n_k[twin].item() == 0 and n_k[twin - 1].item() > 0
    torch.testing.assert_close(n_k, n_p, rtol=0, atol=0)
    torch.testing.assert_close(s_k, s_p, rtol=2e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(100, 8), (512, 128)])
def test_cuda_tensor_never_falls_back(card, d, k):
    """A shape the kernel cannot take raises on the card; it never
    quietly runs the plain version."""
    p = torch.zeros((1024, d), device=card)
    before = kk.LAUNCHES
    with pytest.raises(ValueError, match="k-means kernel cannot take"):
        kk.assign_accumulate(p, p[:k].clone(), k)
    assert kk.LAUNCHES == before


# -- segment kernels (csrc/segment.cu) -------------------------------------


def _plan_cases():
    """The windowed cases of tests/test_sparse.py:138-232, plus a window
    boundary case: ids, n, values."""
    rng = np.random.RandomState(3)
    edges = np.sort(np.r_[np.arange(0, 5000, 7), [1023, 1024, 2047, 2048]])
    return {
        "random": (np.sort(rng.randint(0, 3000, 20000)), 3000,
                   rng.rand(20000)),
        "out_of_range": (np.array([0, 1, 1, 5, 7, 9, 9]), 6,
                         np.arange(1, 8)),
        "partial_trailing_block": (np.array([5, 139999]), 140000,
                                   np.array([1.5, 2.0])),
        "skewed": (np.zeros(24576, np.int64), 256 * 1024, np.ones(24576)),
        "negative": (np.array([-3, -1, 0, 2, 2, 5, 9]), 6, np.arange(1, 8)),
        "window_edges": (edges, 5000, rng.rand(edges.size)),
    }


def _windowed(case, card):
    from spartan_tpu_torch.ops.segment import SegmentPlan

    ids, n, vals = _plan_cases()[case]
    plan = SegmentPlan(ids.astype(np.int32), n, device=card)
    v = torch.from_numpy(plan.reorder(vals.astype(np.float32))).to(card)
    return plan, v


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_plan_cases()))
def test_windowed_kernel_matches_plain(card, case):
    from spartan_tpu_torch.kernels import segment as ks

    plan, v = _windowed(case, card)
    kw = dict(rows_pad=plan.rows_pad, nsteps=plan.nsteps,
              outblk=plan.outblk, sub=plan.SUB)
    before = ks.LAUNCHES["windowed_segsum"]
    out = ks.windowed_segsum(v, plan._ids2d, plan._wb, starts=plan._starts,
                             **kw)
    torch.cuda.synchronize()
    assert ks.LAUNCHES["windowed_segsum"] == before + 1
    ref = ks.windowed_segsum_plain(v, plan._ids2d, plan._wb, plan.rows_pad)
    assert out.shape == ref.shape == (plan.rows_pad, 128)
    if case in ("random", "window_edges"):
        # a few values in [0, 1) per slot, summed in another order
        torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(out, ref)  # integer-valued: exact
    again = ks.windowed_segsum(v, plan._ids2d, plan._wb,
                               starts=plan._starts, **kw)
    assert torch.equal(out, again)  # deterministic


def _block_data(e, d, k, seed, card, integer=True):
    rng = np.random.RandomState(seed)
    shape = (e,) if d is None else (e, d)
    vals = (rng.randint(-8, 9, shape) if integer else rng.rand(*shape))
    ids = rng.randint(-2, k + 3, e)
    return (torch.from_numpy(vals.astype(np.float32)).to(card),
            torch.from_numpy(ids).to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("e,d,k,id_dtype", [
    (100_000, 128, 64, torch.int32), (100_000, 128, 64, torch.int64),
    (1000, 16, 12, torch.int64), (1000, None, 12, torch.int32),
    (4096, 300, 37, torch.int32), (8192, 2048, 20, torch.int32),
    (0, 8, 3, torch.int64), (5000, 4, 15000, torch.int32)])
def test_block_kernel_matches_plain(card, e, d, k, id_dtype):
    from spartan_tpu_torch.kernels import segment as ks

    vals, ids = _block_data(e, d, k, seed=e + k, card=card)
    ids = ids.to(id_dtype)
    before = ks.LAUNCHES["segment_sum_block"]
    out = ks.segment_sum_block(vals, ids, k)
    torch.cuda.synchronize()
    assert ks.LAUNCHES["segment_sum_block"] == before + 1
    ref = ks.segment_sum_block_plain(vals, ids, k)
    assert out.shape == ref.shape
    assert torch.equal(out, ref)  # integer-valued: exact on both paths
    assert torch.equal(out, ks.segment_sum_block(vals, ids, k))


@pytest.mark.cuda
def test_block_kernel_non_integer(card):
    """Sums of ~1,500 values in [0, 1) in another order: at most
    2 * 1500 * 2^-24 relative."""
    from spartan_tpu_torch.kernels import segment as ks

    vals, ids = _block_data(100_000, 128, 64, seed=3, card=card,
                            integer=False)
    out = ks.segment_sum_block(vals, ids, 64)
    ref = ks.segment_sum_block_plain(vals, ids, 64)
    torch.testing.assert_close(out, ref, rtol=2e-4, atol=1e-3)


@pytest.mark.cuda
def test_segment_kernels_never_fall_back(card):
    """What a kernel cannot take raises on the card; it never quietly
    runs the plain version."""
    from spartan_tpu_torch.kernels import segment as ks

    plan, v = _windowed("out_of_range", card)
    before = dict(ks.LAUNCHES)
    with pytest.raises(ValueError, match="starts"):
        ks.windowed_segsum(v, plan._ids2d, plan._wb, rows_pad=plan.rows_pad,
                           nsteps=plan.nsteps, outblk=plan.outblk,
                           sub=plan.SUB)
    vals = torch.zeros((16, 4), device=card)
    with pytest.raises(ValueError, match="cannot take k"):
        ks.segment_sum_block(vals, torch.zeros(16, dtype=torch.int64,
                                               device=card), 60000)
    assert ks.LAUNCHES == before


@pytest.mark.cuda
def test_block_operator_vmap_rule_one_launch_a_client(card):
    """``torch.func.vmap`` over the block kernel reaches the operator's
    batching rule: one launch a client, each bit-equal to the solo
    launch and to the plain version on integer values."""
    from spartan_tpu_torch.kernels import segment as ks

    vals = torch.stack([_block_data(20_000, 64, 20, seed=80 + i,
                                    card=card)[0] for i in range(5)])
    ids = _block_data(20_000, 64, 20, seed=79, card=card)[1]
    solo = [ks.segment_sum_block(vals[i], ids, 20) for i in range(5)]
    before = ks.LAUNCHES["segment_sum_block"]
    got = torch.func.vmap(lambda v: ks.segment_sum_block(v, ids, 20))(vals)
    torch.cuda.synchronize()
    assert ks.LAUNCHES["segment_sum_block"] - before == 5
    for i in range(5):
        assert torch.equal(got[i], solo[i])
        assert torch.equal(got[i], ks.segment_sum_block_plain(vals[i], ids,
                                                              20))


@pytest.mark.cuda
def test_naive_bayes_fit_replays_the_kernel_on_each_rows_block(card):
    """The row proof's replay of the fit under ``native_kernels=on`` on
    two row blocks of the card: the block kernel once a block for the
    2-D counts, and the blocks' partials summed equal the whole fit on
    integer counts."""
    from spartan_tpu_torch.examples import naive_bayes
    from spartan_tpu_torch.expr import partition as pt
    from spartan_tpu_torch.kernels import segment as ks
    from spartan_tpu_torch.utils.config import FLAGS

    rng = np.random.RandomState(81)
    n, d, k = 65536, 256, 20
    x = torch.from_numpy(rng.poisson(2.0, (n, d)).astype(np.float32)).to(card)
    y = torch.from_numpy(rng.randint(0, k, n).astype(np.int32)).to(card)
    prev = FLAGS.native_kernels
    FLAGS.native_kernels = "on"
    try:
        plan = pt.rows(naive_bayes._fit_kern(k),
                       [((n, d), torch.float32), ((n,), torch.int32)],
                       (0, 0), n)
        assert not isinstance(plan, str), plan
        whole = naive_bayes._fit_kern(k)(x, y)
        before = ks.LAUNCHES["segment_sum_block"]
        h = n // 2
        parts = [plan.run([x[lo:lo + h], y[lo:lo + h]], h, lambda t: t)
                 for lo in (0, h)]
        torch.cuda.synchronize()
    finally:
        FLAGS.native_kernels = prev
    launched = ks.LAUNCHES["segment_sum_block"] - before
    ops = [str(s.node.target) for s in plan.steps]
    assert launched == 2 * ops.count(
        "spartan_tpu_torch.segment_sum_block.default")
    assert torch.equal(parts[0] + parts[1], whole)


def _ratings(n, items, seed):
    rng = np.random.RandomState(seed)
    return ((np.floor(rng.rand(n, items) * 5.0 + 1.0)
             * (rng.rand(n, items) > 0.4)).astype(np.float32),
            (0.1 * rng.rand(items, 16)).astype(np.float32))


@pytest.mark.cuda
def test_als_half_step_and_flip_replay_on_row_blocks_of_the_card(card):
    """The row proof's replay of ALS's half-step (one batched solve a
    block) and of a flip (each block's mirrored rows brought to it) on
    two row blocks of 2048 rows on the card. The flip is bit-equal to
    ``torch.flip``. The half-step's batched normal matrices and solves
    are bit-equal to the whole's, but the right-hand sides' GEMM of a
    row block sums in the order cuBLAS picks for its row count (1.9e-5
    apart at these shapes on an H100), so the solves are held within
    1e-4 of the largest value, ALS's tolerance against float64."""
    from spartan_tpu_torch.examples import als
    from spartan_tpu_torch.expr import partition as pt

    r_np, v_np = _ratings(4096, 512, 82)
    r, v = torch.from_numpy(r_np).to(card), torch.from_numpy(v_np).to(card)
    n, h = r.shape[0], r.shape[0] // 2
    solve = (lambda a, b: als._solve_side(a, b, 0.1))
    plan = pt.rows(solve, [(tuple(r.shape), r.dtype),
                           (tuple(v.shape), v.dtype)], (0, None), n)
    assert not isinstance(plan, str), plan
    parts = torch.cat([plan.run([r[lo:lo + h], v], h, lambda t: t, start=lo)
                       for lo in (0, h)], 0)
    whole = solve(r, v)
    assert float((parts - whole).abs().max() / whole.abs().max()) <= 1e-4
    # the normal matrices alone: one batched product a block, bit-equal
    normal = pt.rows(lambda a, b: ((a != 0).float()[:, :, None]
                                   * b[None]).transpose(1, 2) @ b,
                     [(tuple(r.shape), r.dtype), (tuple(v.shape), v.dtype)],
                     (0, None), n)
    blocks = [normal.run([r[lo:lo + h], v], h, lambda t: t, start=lo)
              for lo in (0, h)]
    w = (r != 0).float()
    assert torch.equal(torch.cat(blocks, 0),
                       (w[:, :, None] * v[None]).transpose(1, 2) @ v)
    flip = pt.rows(lambda a: a.flip(0), [(tuple(r.shape), r.dtype)], (0,), n)
    assert len(flip.moves) == 1
    rev = [flip.run([r[lo:lo + h]], h, lambda t: t, start=lo,
                    move=lambda t, d: t) for lo in (0, h)]
    # each block's reversed rows are the other block's mirrored ones
    assert torch.equal(torch.cat(rev[::-1], 0), torch.flip(r, (0,)))


@pytest.mark.cuda
def test_als_half_step_and_flip_on_a_one_rank_nccl_group(card, tmp_path):
    """ALS's half-step and a flip through ``map2`` on a one-rank nccl
    group (its one block is the whole) and on a logical (2, 1) mesh on
    the card: bit-equal to ``_solve_side`` and ``torch.flip`` run whole,
    nothing gathered."""
    import torch.distributed as dist

    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_numpy
    from spartan_tpu_torch.array.tiling import Tiling
    from spartan_tpu_torch.examples import als
    from spartan_tpu_torch.obs.metrics import collective_totals
    from spartan_tpu_torch.parallel import mesh as mesh_mod

    if not dist.is_nccl_available():
        pytest.skip("this torch build has no NCCL")
    r_np, v_np = _ratings(4096, 512, 83)
    r, v = torch.from_numpy(r_np).to(card), torch.from_numpy(v_np).to(card)
    want = (als._solve_side(r, v, 0.1).cpu().numpy(),
            torch.flip(r, (0,)).cpu().numpy())

    def run():
        re = st.as_expr(from_numpy(r_np))
        ve = st.as_expr(from_numpy(v_np, tiling=Tiling((None, None))))
        return (st.map2([re, ve], als._solve_side, fn_kw={"reg": 0.1},
                        out_tiling=Tiling(("x", None))).glom(),
                st.map2([re], lambda t: t.flip(0)).glom())

    prev = mesh_mod.get_default_device()
    mesh_mod.set_default_device(card)
    try:
        with mesh_mod.use_mesh(mesh_mod.build_mesh((2, 1), card)):
            logical = run()
        assert mesh_mod.initialize_distributed(
            f"file://{tmp_path / 'store'}", num_processes=1, process_id=0,
            backend="nccl", device=card, timeout_s=120)
        try:
            assert mesh_mod.get_mesh().is_group
            before = collective_totals()
            got = run()
            after = collective_totals()
        finally:
            mesh_mod.shutdown()
    finally:
        mesh_mod.set_default_device(prev)
    assert after["group_materialize_calls"] == \
        before["group_materialize_calls"]
    for g, l_, w in zip(got, logical, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(l_, w)


# -- sort/select kernels (csrc/exchange.cu, topk.cu, histogram.cu) ---------


@pytest.mark.cuda
@pytest.mark.parametrize("shards,p,m,dtype", [
    (8, 8, 1 << 20, torch.float32), (8, 8, 1000, torch.int32),
    (512, 8, 613, torch.float32), (3, 2, 1, torch.float32)])
def test_partition_pack_matches_plain(card, shards, p, m, dtype):
    from spartan_tpu_torch.kernels import exchange as kx

    rng = np.random.RandomState(m)
    bits = rng.randint(0, 2 ** 32, (shards, m), np.uint64).astype(np.uint32)
    xs = torch.from_numpy(bits.view(np.float32 if dtype == torch.float32
                                    else np.int32)).to(card)
    counts = rng.multinomial(m, np.ones(p) / p, shards).astype(np.int32)
    counts[0] = 0
    counts[0, -1] = m  # one destination takes a whole shard
    starts = (np.cumsum(counts, 1) - counts).astype(np.int32)
    s, c = torch.from_numpy(starts).to(card), torch.from_numpy(counts).to(card)
    before = kx.LAUNCHES["partition_pack"]
    out = kx.partition_pack(xs, s, c)
    torch.cuda.synchronize()
    assert kx.LAUNCHES["partition_pack"] == before + 1
    ref = kx.partition_pack_plain(xs, s, c)
    # bit for bit: NaN payloads and -0.0 survive the copy
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "ties", "ints", "sentinel",
                                  "short", "total_order"])
@pytest.mark.parametrize("k", [1, 128])
def test_shard_topk_matches_plain(card, case, k):
    from spartan_tpu_torch.kernels import topk as kt

    gen = torch.Generator(device=card)
    gen.manual_seed(k)
    ninf = float("-inf")
    sentinel = ninf
    if case == "uniform":
        key = torch.rand((8, 200_003), generator=gen, device=card)
    elif case == "ties":
        key = torch.randint(0, 4, (8, 70_000), generator=gen,
                            device=card).float()
    elif case == "ints":
        key = torch.randint(-5, 5, (8, 70_000), generator=gen, device=card,
                            dtype=torch.int32)
        sentinel = -2 ** 31
    elif case == "sentinel":
        key = torch.full((4, 33_000), ninf, device=card)
        key[:, 32_999] = 0.5
    elif case == "short":
        key = torch.rand((3, 60), generator=gen, device=card)
    else:
        key = torch.tensor([0.0, -0.0, float("nan"), -float("nan"), 1.0,
                            float("inf"), ninf], device=card).repeat(2, 500)
    before = kt.LAUNCHES["shard_topk"]
    out_k, out_i = kt.shard_topk(key, k, sentinel)
    torch.cuda.synchronize()
    assert kt.LAUNCHES["shard_topk"] == before + 1
    ref_k, ref_i = kt.shard_topk_plain(key, k, sentinel)
    assert torch.equal(out_i, ref_i)  # ties to the lowest index
    assert torch.equal(out_k.view(torch.int32), ref_k.view(torch.int32))
    again = kt.shard_topk(key, k, sentinel)
    assert torch.equal(again[1], out_i)


def _topk_hard_rows(case, gen, card):
    """Rows that stress the kernel's seed, scan and merges: (keys,
    sentinel)."""
    ninf = float("-inf")
    if case == "ascending":
        return torch.sort(torch.rand((4, 300_001), generator=gen,
                                     device=card), 1).values, ninf
    if case == "descending":
        return torch.sort(torch.rand((4, 300_001), generator=gen,
                                     device=card), 1,
                          descending=True).values, ninf
    if case == "odd_length":  # rows start off 16-byte boundaries
        return torch.rand((5, 131_075), generator=gen, device=card), ninf
    if case == "unaligned_view":
        flat = torch.rand(3 * 250_000 + 1, generator=gen, device=card)
        return flat[1:].view(3, 250_000), ninf
    if case == "shorter_than_a_chunk":
        return torch.rand((6, 3_001), generator=gen, device=card), ninf
    if case == "shorter_than_the_sample":
        return torch.rand((6, 1_000), generator=gen, device=card), ninf
    if case == "max_ties":  # 10,000 equal maximal keys per row
        key = torch.rand((4, 400_000), generator=gen, device=card)
        pos = torch.randperm(400_000, generator=gen, device=card)[:10_000]
        key[:, pos] = 2.0
        return key, ninf
    if case == "all_equal_int32":
        return torch.full((2, 500_000), 7, dtype=torch.int32,
                          device=card), -2 ** 31
    if case in ("burst_after_zeros", "burst_after_noise"):
        shape = (8, 1 << 23)
        back = (torch.zeros(shape, device=card) if case == "burst_after_zeros"
                else torch.rand(shape, generator=gen, device=card))
        return _topk_burst(back, gen), ninf
    raise ValueError(case)


def _topk_burst(key, gen):
    """In every chunk of the kernel's first pass: 10 keys of 1.5 in the
    step before a step-aligned burst of 8192 keys in [2, 3) that lies
    between two sampled runs, so that one merge takes the 10 waiting
    words and a whole step of survivors, more than 4096 words."""
    from spartan_tpu_torch.kernels import topk as kt

    rows, m = key.shape
    step, run = kt._STEP, kt._RUN_LEN
    sms = torch.cuda.get_device_properties(key.device).multi_processor_count
    chunk, chunks = kt._chunking(rows, m, sms)
    for c in range(chunks):
        lo, n = c * chunk, min(chunk, m - c * chunk)
        runs = kt._sample_runs(n)

        def clear(a, b):
            return not any(r < b and a < r + run for r in runs)

        starts = [s for s in range(step, n - 2 * step + 1, step)
                  if clear(s, s + 2 * step) and clear(s - step, s - step + 10)]
        assert starts, "the chunk has no room for the burst"
        s = lo + starts[0]
        key[:, s - step:s - step + 10] = 1.5
        key[:, s:s + 2 * step] = 2.0 + torch.rand(
            (rows, 2 * step), generator=gen, device=key.device)
    return key


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "ascending", "descending", "odd_length", "unaligned_view",
    "shorter_than_a_chunk", "shorter_than_the_sample", "max_ties",
    "all_equal_int32", "burst_after_zeros", "burst_after_noise"])
@pytest.mark.parametrize("k", [1, 7, 128])
def test_shard_topk_hard_rows(card, case, k):
    from spartan_tpu_torch.kernels import topk as kt

    gen = torch.Generator(device=card)
    gen.manual_seed(100 + k)
    key, sentinel = _topk_hard_rows(case, gen, card)
    before = kt.LAUNCHES["shard_topk"]
    out_k, out_i = kt.shard_topk(key, k, sentinel)
    torch.cuda.synchronize()
    assert kt.LAUNCHES["shard_topk"] == before + 1
    ref_k, ref_i = kt.shard_topk_plain(key, k, sentinel)
    assert torch.equal(out_i, ref_i)
    assert torch.equal(out_k.view(torch.int32), ref_k.view(torch.int32))


@pytest.mark.cuda
def test_shard_topk_is_deterministic(card):
    """Two launches on the same keys give the same bits (the order is
    total, so there is one answer whatever the merges' timing)."""
    from spartan_tpu_torch.kernels import topk as kt

    gen = torch.Generator(device=card)
    gen.manual_seed(7)
    key = torch.randint(0, 50, (8, 1 << 21), generator=gen, device=card,
                        dtype=torch.int32)
    a = kt.shard_topk(key, 128, -2 ** 31)
    b = kt.shard_topk(key, 128, -2 ** 31)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _bincount_ref(ids: torch.Tensor, length: int) -> torch.Tensor:
    """jnp.bincount's rule by torch.bincount: ids as int32, negatives in
    bucket 0, ids >= length dropped."""
    ids = ids.reshape(-1).to(torch.int32).clamp_min(0).long()
    return torch.bincount(ids[ids < length], minlength=length)[
        :length].to(torch.int32)


# csrc/histogram.cu keeps one int32 sub-histogram per warp up to 512
# buckets and fewer, down to one, above
@pytest.mark.cuda
@pytest.mark.parametrize("lo,hi,e,length", [
    (0, 64, 1 << 22, 64), (-50, 4200, 1_000_003, 4096), (0, 1, 7, 1),
    (-3, 14, 1003, 10),
    # one hot bucket, with eight sub-histograms and with one
    (5, 6, 1 << 22, 64), (7, 8, 1 << 22, 4096),
    # all negative ids: bucket 0 takes them all
    (-100, 0, 1 << 20, 64), (-100, 0, 1 << 20, 4096),
    # e below one 16-byte vector, and one vector and one id
    (0, 10, 1, 10), (0, 10, 3, 10), (0, 10, 5, 10), (0, 5000, 3, 4096),
    # the last length with eight sub-histograms and the first with
    # four, and 4096
    (-5, 520, 1_000_003, 512), (-5, 520, 1_000_003, 513),
    (0, 4096, 1 << 22, 4096), (1, 2, 100_000, 1)])
def test_bincount_matches_plain(card, lo, hi, e, length):
    from spartan_tpu_torch.kernels import histogram as kh

    gen = torch.Generator(device=card)
    gen.manual_seed(e)
    ids = torch.randint(lo, hi, (e,), generator=gen, device=card,
                        dtype=torch.int32)
    before = kh.LAUNCHES["bincount_block"]
    out = kh.bincount_block(ids, length)
    torch.cuda.synchronize()
    assert kh.LAUNCHES["bincount_block"] == before + 1
    assert torch.equal(out, kh.bincount_block_plain(ids, length))
    sorted_ids = torch.sort(ids).values  # runs: aggregated adds
    assert torch.equal(kh.bincount_block(sorted_ids, length), out)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3, 4])
@pytest.mark.parametrize("length", [64, 4096])
def test_bincount_misaligned_view(card, offset, length):
    """A view whose first id is not at a 16-byte boundary (the kernel's
    scalar head) and whose end is not either (its scalar tail)."""
    from spartan_tpu_torch.kernels import histogram as kh

    gen = torch.Generator(device=card)
    gen.manual_seed(offset)
    base = torch.randint(-3, length + 3, (1_000_006,), generator=gen,
                         device=card, dtype=torch.int32)
    ids = base[offset:]
    assert ids.data_ptr() % 16 == 4 * offset % 16
    out = kh.bincount_block(ids, length)
    assert torch.equal(out, kh.bincount_block_plain(ids, length))
    assert torch.equal(out, _bincount_ref(ids, length))


@pytest.mark.cuda
@pytest.mark.parametrize("length", [64, 4096])
def test_bincount_int64_ids_wrap(card, length):
    """int64 ids count as their int32 wrap, as astype does: 2**32 + 5
    counts in bucket 5, 2**31 wraps negative and counts in bucket 0."""
    from spartan_tpu_torch.kernels import histogram as kh

    rng = np.random.RandomState(length)
    ids = rng.randint(-2, length + 2, 50_001).astype(np.int64)
    ids += rng.choice([0, 2 ** 32, -2 ** 32, 2 ** 33], ids.size)
    ids[:7] = [2 ** 31, 2 ** 32 + 5, -2 ** 32 + 3, 2 ** 32 - 1, 0, -1,
               length]
    t = torch.from_numpy(ids).to(card)
    out = kh.bincount_block(t, length)
    want = np.bincount(np.clip(ids.astype(np.int32), 0, None)[
        ids.astype(np.int32) < length], minlength=length)
    assert np.array_equal(out.cpu().numpy(), want)
    assert torch.equal(out, kh.bincount_block_plain(t, length))


@pytest.mark.cuda
@pytest.mark.parametrize("length", [64, 4096])
def test_bincount_is_deterministic(card, length):
    """Integer adds in any order: two launches give the same bits."""
    from spartan_tpu_torch.kernels import histogram as kh

    gen = torch.Generator(device=card)
    gen.manual_seed(length)
    ids = torch.randint(-1, length + 1, (1 << 24,), generator=gen,
                        device=card, dtype=torch.int32)
    assert torch.equal(kh.bincount_block(ids, length),
                       kh.bincount_block(ids, length))


@pytest.mark.cuda
def test_bincount_every_accepted_length_launches(card):
    """Every length the selection's bincount rule accepts (1 to 4096)
    launches the kernel and counts right: no layout of sub-histograms
    is refused."""
    from spartan_tpu_torch.kernels import histogram as kh

    gen = torch.Generator(device=card)
    gen.manual_seed(4096)
    raw = torch.randint(0, 1 << 30, (4099,), generator=gen, device=card,
                        dtype=torch.int32)
    before = kh.LAUNCHES["bincount_block"]
    for length in range(1, 4097):
        ids = raw % (length + 4) - 2
        assert torch.equal(kh.bincount_block(ids, length),
                           _bincount_ref(ids, length)), length
    assert kh.LAUNCHES["bincount_block"] == before + 4096


@pytest.mark.cuda
def test_select_kernels_never_fall_back(card):
    from spartan_tpu_torch.kernels import histogram as kh
    from spartan_tpu_torch.kernels import topk as kt

    before = (dict(kt.LAUNCHES), dict(kh.LAUNCHES))
    with pytest.raises(ValueError, match="cannot take"):
        kt.shard_topk(torch.zeros((2, 300), device=card), 129, 0.0)
    with pytest.raises(ValueError, match="cannot take"):
        kt.shard_topk(torch.zeros((2, 300), device=card,
                                  dtype=torch.float64), 4, 0.0)
    with pytest.raises(ValueError, match="cannot take"):
        kh.bincount_block(torch.zeros(16, dtype=torch.int32, device=card),
                          60_000)
    assert (dict(kt.LAUNCHES), dict(kh.LAUNCHES)) == before


@pytest.mark.cuda
def test_sort_topk_histogram_builtins_on_the_card(card):
    """The three builtins end to end under a logical (8, 1) mesh: the
    kernels run on their paths and the results match torch/numpy."""
    import spartan_tpu_torch as st
    from spartan_tpu_torch.kernels import exchange as kx
    from spartan_tpu_torch.kernels import histogram as kh
    from spartan_tpu_torch.kernels import topk as kt

    gen = torch.Generator(device=card)
    gen.manual_seed(7)
    x = torch.rand(1_000_003, generator=gen, device=card)
    before = (kx.LAUNCHES["partition_pack"], kt.LAUNCHES["shard_topk"],
              kh.LAUNCHES["bincount_block"])
    with st.use_mesh(st.build_mesh((8, 1), device=card)):
        X = st.from_numpy(x.cpu().numpy(), device=card)
        s = st.sort(X).glom()
        idx = st.argsort(X).glom()
        vals, top = st.topk(X, 100)
        counts, edges = st.histogram(X, bins=50, range=(0.0, 1.0))
        top, vals = top.glom(), vals.glom()
        counts = counts.glom()
    after = (kx.LAUNCHES["partition_pack"], kt.LAUNCHES["shard_topk"],
             kh.LAUNCHES["bincount_block"])
    assert all(a > b for a, b in zip(after, before))
    want = torch.sort(x).values.cpu().numpy()
    np.testing.assert_array_equal(s, want)
    np.testing.assert_array_equal(x.cpu().numpy()[idx], want)
    oracle = torch.sort(x.double(), descending=True, stable=True).indices
    np.testing.assert_array_equal(top, oracle[:100].cpu().numpy())
    assert counts.sum() == x.numel() and counts.dtype == np.int32


# -- stencil kernel (csrc/stencil.cu) ------------------------------------------


def _conv_tol(kst, c, k, mag):
    """Max |kernel - plain| for K = k products per output of magnitude
    at most ``mag``. Both sum in f32 in different orders: 2 K 2^-24 mag.
    The tensor-core route adds its 3xTF32 split: with hi = tf32(v) and
    lo = tf32(v - hi), |v - hi| <= 2^-11 |v| and lo is off by at most
    2^-11 |v - hi| <= 2^-22 |v|; the dropped a_lo b_lo (<= 2^-22 |ab|)
    and the rounding of a_lo and of b_lo (each <= 2^-22 |ab|) give at
    most 3 * 2^-22 = 12 * 2^-24 |ab| per product, so (2 + 12) K 2^-24
    mag."""
    return (2 + (12 if kst.route(c) == "mma" else 0)) * k * 2.0 ** -24 * mag


@pytest.mark.cuda
@pytest.mark.parametrize("n,hs,w,c,o,kh,kw,p", [
    (3, 2, 17, 3, 10, 2, 2, 2), (3, 2, 17, 3, 10, 2, 2, 8),
    (2, 5, 17, 3, 10, 5, 5, 2), (2, 5, 17, 3, 10, 5, 5, 8),
    (2, 5, 33, 13, 70, 3, 3, 8), (4, 28, 224, 64, 64, 3, 3, 8),
    (1, 9, 1, 4, 1, 3, 1, 1), (2, 8, 40, 200, 130, 1, 3, 3),
    # the tensor-core route: whole and ragged channel chunks (C = 8, 16,
    # 13), whole and ragged channel tiles (O = 8, 70), and filters whose
    # taps leave room for 3, 2 and 1 staging slots (3x3, 6x6, 7x7)
    (2, 5, 17, 8, 8, 3, 3, 2), (2, 5, 17, 16, 70, 5, 5, 2),
    (2, 5, 33, 13, 8, 3, 3, 8), (3, 2, 17, 8, 70, 2, 2, 8),
    (2, 6, 40, 16, 64, 6, 6, 2), (2, 7, 40, 16, 64, 7, 7, 2)])
def test_conv_block_matches_plain(card, n, hs, w, c, o, kh, kw, p):
    from spartan_tpu_torch.kernels import stencil as kst

    gen = torch.Generator(device=card)
    gen.manual_seed(n * hs + w)
    x = torch.randn((n, hs * p, w, c), generator=gen, device=card)
    wt = torch.randn((kh, kw, c, o), generator=gen, device=card)
    blocks = kst.halo_exchange(x, kh, kw, p)
    before = kst.LAUNCHES["conv_block"]
    out = kst.conv_block(blocks, wt)
    torch.cuda.synchronize()
    assert kst.LAUNCHES["conv_block"] == before + 1
    ref = kst.conv_block_plain(blocks, wt)
    assert out.shape == ref.shape == (n, hs * p, w, o)
    mag = kst.conv_block_plain(blocks.abs(), wt.abs()).max().item()
    tol = _conv_tol(kst, c, kh * kw * c, mag)
    assert (out - ref).abs().max().item() <= tol
    assert torch.equal(kst.conv_block(blocks, wt), out)  # deterministic
    # a 4-D batch of blocks gives the per-block results
    flat = blocks.reshape(p * n, *blocks.shape[2:])
    one = kst.conv_block(flat, wt)
    assert one.shape == (p * n, hs, w, o)
    assert torch.equal(one.reshape(p, n, hs, w, o).transpose(0, 1).reshape(
        n, p * hs, w, o), out)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [0x7FC00000, 0x7FFFFFFF, -1])
@pytest.mark.parametrize("c", [3, 16])
def test_conv_block_propagates_nan(card, c, bits):
    """A NaN input (any payload: CUDA's own 0x7fffffff and an all-ones
    pattern included, whose rounding would carry into the sign) makes
    NaN exactly the outputs whose window holds it, on both routes."""
    from spartan_tpu_torch.kernels import stencil as kst

    gen = torch.Generator(device=card)
    gen.manual_seed(c)
    x = torch.randn((2, 1, 12, 20, c), generator=gen, device=card)
    x.view(torch.int32)[1, 0, 5, 7, c - 1] = bits
    w = torch.randn((3, 3, c, 8), generator=gen, device=card)
    out = kst.conv_block(x, w)
    ref = kst.conv_block_plain(x, w)
    torch.cuda.synchronize()
    assert int(out.isnan().sum()) == 9 * 8
    assert torch.equal(out.isnan(), ref.isnan())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 4, 5, 8, 64])
def test_conv_block_route_by_channels(card, c):
    """C <= 4 launches the SIMT kernel, C > 4 the tensor-core kernel: the
    route's counter moves with the total."""
    from spartan_tpu_torch.kernels import stencil as kst

    x = torch.ones((2, 1, 6, 9, c), device=card)
    w = torch.ones((3, 3, c, 8), device=card)
    before = dict(kst.LAUNCHES)
    out = kst.conv_block(x, w)
    torch.cuda.synchronize()
    mma = kst.LAUNCHES["conv_block_mma"] - before["conv_block_mma"]
    assert kst.LAUNCHES["conv_block"] == before["conv_block"] + 1
    assert mma == (1 if c > 4 else 0) and kst.route(c) == (
        "mma" if c > 4 else "simt")
    assert torch.equal(out, torch.full_like(out, 9.0 * c))


@pytest.mark.cuda
def test_stencil_launches_twice_per_vgg_forward(card):
    """conv, bias+ReLU, conv, bias+ReLU, maxpool under a logical (8, 1)
    mesh with H tiled: the H tiling carries through the map, so both
    convolutions launch the kernel; the result matches float64."""
    import torch.nn.functional as F

    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.kernels import stencil as kst

    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    x = torch.randn((2, 32, 32, 3), generator=gen, device=card)
    params = [(torch.randn((3, 3, ci, co), generator=gen, device=card)
               * (2.0 / (9 * ci)) ** 0.5,
               0.01 * torch.randn((co,), generator=gen, device=card))
              for ci, co in ((3, 16), (16, 16))]
    with st.use_mesh(st.build_mesh((8, 1), device=card)):
        h = from_tensor(x, tiling=st.Tiling((None, "x", None, None)))
        for w, b in params:
            h = st.maximum(st.stencil(h, from_tensor(w)) + from_tensor(b),
                           0.0)
        before = kst.LAUNCHES["conv_block"]
        out = st.maxpool(h, 2).evaluate().tensor
        assert kst.LAUNCHES["conv_block"] == before + 2
    ref = x.double().permute(0, 3, 1, 2)
    for w, b in params:
        ref = F.conv2d(ref, w.double().permute(3, 2, 0, 1), b.double(),
                       padding=1).clamp_min(0.0)
    ref = F.max_pool2d(ref, 2).permute(0, 2, 3, 1)
    err = ((out.double() - ref).abs().max() / ref.abs().max()).item()
    assert err <= 1e-5


def _tf32(t):
    """``t`` rounded to TF32 (10 mantissa bits), toward zero."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


@pytest.mark.cuda
def test_stencil_paths_stay_off_tf32(card):
    """Both stencil paths hold float64 to 1e-5 relative on inputs where
    rounding the operands to TF32 alone moves the result by more than
    that, so a path that rounded through TF32 would fail here."""
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.ops.stencil import conv_nhwc

    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    gen = torch.Generator(device=card)
    gen.manual_seed(6)
    # values just above 1 with mantissa bits below TF32's last one set
    x = 1.0 + torch.rand((4, 32, 32, 64), generator=gen, device=card) * 1e-3
    w = 1.0 + torch.rand((3, 3, 64, 32), generator=gen, device=card) * 1e-3
    ref = conv_nhwc(x.double(), w.double(), (1, 1), "SAME")
    scale = ref.abs().max().item()
    rounded = conv_nhwc(_tf32(x).double(), _tf32(w).double(), (1, 1),
                        "SAME")
    assert (rounded - ref).abs().max().item() / scale > 1e-5
    for mode in ("auto", "off"):
        prev = st.FLAGS.native_kernels
        st.FLAGS.native_kernels = mode
        try:
            with st.use_mesh(st.build_mesh((8, 1), device=card)):
                X = from_tensor(x, tiling=st.Tiling((None, "x", None, None)))
                out = st.stencil(X, from_tensor(w)).evaluate().tensor
        finally:
            st.FLAGS.native_kernels = prev
        assert (out.double() - ref).abs().max().item() / scale <= 1e-5


@pytest.mark.cuda
def test_stencil_kernel_never_falls_back(card, monkeypatch, tmp_path):
    """A filter the kernel cannot take, and a kernel that cannot be
    built, raise on the card: neither quietly runs the plain version or
    F.conv2d."""
    from spartan_tpu_torch.kernels import build as build_mod
    from spartan_tpu_torch.kernels import stencil as kst

    x = torch.zeros((1, 2, 40, 40, 8), device=card)
    before = kst.LAUNCHES["conv_block"]
    with pytest.raises(ValueError, match="cannot take"):
        kst.conv_block(x, torch.zeros((15, 15, 8, 64), device=card))
    with pytest.raises(TypeError, match="float32"):
        kst.conv_block(x.double(), torch.zeros((3, 3, 8, 4), device=card,
                                               dtype=torch.float64))

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build_mod, "_libs", {})
    monkeypatch.setattr(build_mod, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build_mod, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kst.conv_block(x, torch.zeros((3, 3, 8, 4), device=card))
    assert kst.LAUNCHES["conv_block"] == before


# -- dtypes on the card ---------------------------------------------------------


@pytest.mark.cuda
def test_dtype_rules_on_card(card):
    """The dtype rules the CPU parity tests hold against the JAX package
    (tests/test_torch_dtype_parity.py) give the same results on the card:
    uint16/uint32 computed wider and cast back, bfloat16 host data,
    unsigned sums, narrow scans, bool contractions and integer pooling."""
    import spartan_tpu_torch as st
    from spartan_tpu_torch.parallel import mesh as mesh_mod

    prev = mesh_mod.get_default_device()
    mesh_mod.set_default_device(card)
    try:
        rng = np.random.RandomState(0)
        u32 = rng.randint(0, 2 ** 32, size=(8, 4), dtype=np.uint64).astype(
            np.uint32)
        x = st.from_numpy(u32)
        got = (x + x).glom()
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, u32 + u32)
        assert st.sum(st.from_numpy(u32.astype(np.uint8))).glom().dtype \
            == np.uint32
        i8 = rng.randint(-128, 128, size=(8, 4)).astype(np.int8)
        got = st.cumsum(st.from_numpy(i8), axis=0).glom()
        np.testing.assert_array_equal(got, np.cumsum(i8, axis=0,
                                                     dtype=np.int8))
        b = rng.rand(8, 4) > 0.5
        got = st.dot(st.from_numpy(b), st.from_numpy(b.T)).glom()
        np.testing.assert_array_equal(got, (b.astype(np.int64)
                                            @ b.T.astype(np.int64)) > 0)
        im = rng.randint(-1000, 1000, size=(2, 16, 11, 3)).astype(np.int32)
        got = st.maxpool(st.from_numpy(im), 3, 2, padding="SAME").glom()
        assert got.dtype == np.int32 and got.shape == (2, 8, 6, 3)
        assert got.max() == im.max()
        try:
            import ml_dtypes
        except ImportError:
            return
        bf = rng.randn(8, 4).astype(ml_dtypes.bfloat16)
        got = st.from_numpy(bf).glom()
        assert got.dtype == bf.dtype
        np.testing.assert_array_equal(got.view(np.uint16),
                                      bf.view(np.uint16))
    finally:
        mesh_mod.set_default_device(prev)


# -- the state tier on the card ----------------------------------------


@pytest.fixture()
def on_card(card):
    """The port's default device set to the card for one test."""
    from spartan_tpu_torch.parallel import mesh as mesh_mod

    prev = mesh_mod.get_default_device()
    mesh_mod.set_default_device(card)
    yield card
    mesh_mod.set_default_device(prev)


@pytest.mark.cuda
@pytest.mark.parametrize("staging", ["pinned", "pageable"])
def test_checkpoint_save_and_load_from_the_card(on_card, tmp_path, staging,
                                                monkeypatch):
    """Tiles staged through the cached page-locked buffer, or through
    pageable memory when the array is above the cached size; blobs
    through the pool; the load lands on the card bit-equal, and a
    flipped byte raises."""
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.utils import checkpoint as ckpt

    if staging == "pageable":
        monkeypatch.setattr(ckpt, "_PINNED_KEEP", 0)
    gen = torch.Generator(device=on_card)
    gen.manual_seed(7)
    x = torch.rand((4096, 256), generator=gen, device=on_card)
    with st.use_mesh(st.build_mesh((8, 1))):
        arr = from_tensor(x, tiling=st.Tiling(("x", None)))
        ckpt.save(str(tmp_path / "c"), arr)
        back = ckpt.load(str(tmp_path / "c"))
        assert back.device.type == "cuda"
        assert torch.equal(back.tensor, x)
        blobs = sorted(p for p in os.listdir(tmp_path / "c")
                       if p.endswith(".bin"))
        assert len(blobs) == 8
        with open(tmp_path / "c" / blobs[3], "r+b") as f:
            f.seek(11)
            b = f.read(1)
            f.seek(11)
            f.write(bytes([b[0] ^ 1]))
        with pytest.raises(ValueError, match=blobs[3]):
            ckpt.load(str(tmp_path / "c"))


@pytest.mark.cuda
def test_donation_frees_card_memory(on_card):
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_tensor

    a = from_tensor(torch.ones((4096, 4096), device=on_card))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(on_card)
    out = (st.as_expr(a) * 2.0).evaluate(donate=[a])
    torch.cuda.synchronize()
    # the result was allocated and the donated input released
    assert torch.cuda.memory_allocated(on_card) == before
    assert a.is_donated and float(out.tensor[0, 0]) == 2.0
    with pytest.raises(RuntimeError, match="used after donation"):
        a.glom()


@pytest.mark.cuda
def test_checkpointed_kmeans_loop_on_the_card(on_card, tmp_path):
    """20 iterations in segments of 5 through the fused kernel: 20
    launches, the uninterrupted loop's bits, and one restore after an
    injected transient fault with the same bits."""
    import spartan_tpu_torch as st
    from spartan_tpu_torch.examples.kmeans import kmeans_step

    pts_np, c0_np = _clustered(65536, 128, 16, seed=5)
    pts = st.from_numpy(pts_np)

    def body(c):
        return kmeans_step(pts, c, 16)

    ref = st.loop(20, body, st.from_numpy(c0_np)).glom()
    before = kk.LAUNCHES
    out = st.loop(20, body, st.from_numpy(c0_np), checkpoint_every=5,
                  checkpoint_path=str(tmp_path / "a"))
    got = out.glom()
    assert kk.LAUNCHES - before == 20
    np.testing.assert_array_equal(got, ref)
    calls = [0]

    def flaky(c):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("UNAVAILABLE: injected")
        return body(c)

    out = st.loop(20, flaky, st.from_numpy(c0_np), checkpoint_every=5,
                  checkpoint_path=str(tmp_path / "b"))
    np.testing.assert_array_equal(out.glom(), ref)
    assert out._resilience["restores"] == 1


@pytest.mark.cuda
def test_from_coo_device_on_the_card_matches_cpu(on_card):
    from spartan_tpu_torch.array.sparse import SparseDistArray

    rng = np.random.RandomState(3)
    rows = torch.from_numpy(rng.randint(0, 5000, 200000).astype(np.int32))
    cols = torch.from_numpy(rng.randint(0, 3000, 200000).astype(np.int32))
    data = torch.from_numpy(rng.rand(200000).astype(np.float32))
    cpu = SparseDistArray.from_coo_device(rows, cols, data, (4990, 3000),
                                          device="cpu")
    gpu = SparseDistArray.from_coo_device(rows, cols, data, (4990, 3000),
                                          device=on_card)
    assert gpu.nnz == cpu.nnz
    for a, b in ((gpu.data, cpu.data), (gpu.rows, cpu.rows),
                 (gpu.cols, cpu.cols)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_from_coo_device_heavy_duplicate_on_the_card_matches_cpu(on_card):
    """One coordinate repeated 100,000 times: the pairwise sums are the
    same bits on the card as on the CPU, and the same on a second run."""
    from spartan_tpu_torch.array.sparse import SparseDistArray

    rng = np.random.RandomState(4)
    heavy, rest = 100_000, 5000
    rows = np.concatenate([np.full(heavy, 17), rng.randint(0, 900, rest)])
    cols = np.concatenate([np.full(heavy, 5), rng.randint(0, 700, rest)])
    perm = rng.permutation(heavy + rest)
    rows = torch.from_numpy(rows[perm].astype(np.int32))
    cols = torch.from_numpy(cols[perm].astype(np.int32))
    data = torch.from_numpy(rng.rand(heavy + rest).astype(np.float32))
    cpu = SparseDistArray.from_coo_device(rows, cols, data, (900, 700),
                                          device="cpu")
    for _ in range(2):
        gpu = SparseDistArray.from_coo_device(rows, cols, data, (900, 700),
                                              device=on_card)
        assert gpu.nnz == cpu.nnz
        for a, b in ((gpu.data, cpu.data), (gpu.rows, cpu.rows),
                     (gpu.cols, cpu.cols)):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_masked_ops_on_the_card_match_cpu(on_card):
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.masked import MaskedDistArray

    rng = np.random.RandomState(9)
    d = rng.rand(64, 100).astype(np.float32)
    d[rng.rand(64, 100) < 0.01] = np.nan
    m = rng.rand(64, 100) < 0.05

    def run(dev):
        s = MaskedDistArray(st.from_numpy(d, device=dev),
                            st.from_numpy(m, device=dev))
        s = MaskedDistArray.masked_invalid(s.filled(np.nan))
        return [st.median(s, axis=1).glom(), st.sort(s, axis=1).glom(),
                st.argsort(s, axis=1).glom(), s.count(axis=1).glom()]

    for g, c in zip(run(on_card), run("cpu")):
        if isinstance(c, np.ma.MaskedArray):
            np.testing.assert_array_equal(np.ma.getmaskarray(g),
                                          np.ma.getmaskarray(c))
            g, c = np.ma.getdata(g), np.ma.getdata(c)
        np.testing.assert_array_equal(g, c)


# -- the planner tier on the card -------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", [(4, 2), (8, 1), (2, 4)])
def test_explicit_redistribution_is_bit_exact_on_the_card(card, mesh):
    from spartan_tpu_torch.array import tiling as tl
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.parallel import redistribute as rd

    m = mesh_mod.build_mesh(mesh, card)
    val = torch.randn((512, 256), device=card)
    cands = [tl.row(2), tl.col(2), tl.block(2), tl.replicated(2),
             tl.row_t(2), tl.col_t(2), tl.block_t(2)]
    ran = 0
    for s in cands:
        for d in cands:
            for sched in rd.schedules(s, d, m):
                out = rd.apply_schedule(val, sched, s, d, m)
                assert out.device == val.device and torch.equal(out, val)
                ran += 1
    assert ran > 0


@pytest.mark.cuda
def test_planned_chain_is_bit_equal_to_the_unplanned_on_the_card(card):
    import spartan_tpu_torch as st

    prev = st.get_default_device()
    st.set_default_device(card)
    try:
        a = np.random.RandomState(3).rand(256, 256).astype(np.float32)

        def chain():
            x = st.from_numpy(a)
            return (st.dot(st.transpose(x) + 1.0, x) * 0.5).glom()

        with st.use_mesh(st.build_mesh((4, 2))):
            st.FLAGS.opt_auto_tiling = False
            off = chain()
            st.FLAGS.opt_auto_tiling = True
            on = chain()
            st.FLAGS.redistribution_planner = True
            try:
                planned = chain()
            finally:
                st.FLAGS.redistribution_planner = False
    finally:
        st.set_default_device(prev)
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(planned, off)


@pytest.mark.cuda
def test_map_shards_and_retile_on_the_card(card):
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_tensor

    t = torch.arange(64 * 32, dtype=torch.float32, device=card).reshape(
        64, 32)
    with st.use_mesh(st.build_mesh((4, 2), card)):
        x = from_tensor(t, tiling=st.Tiling(("x", "y")))
        y = x.map_shards(lambda b: b - b.min())
        r = x.retile(st.Tiling((None, "x")))
    want = t.clone()
    for i in range(4):
        for j in range(2):
            blk = want[i * 16:(i + 1) * 16, j * 16:(j + 1) * 16]
            blk -= blk.min().clone()
    assert torch.equal(y.tensor, want)
    assert r.tensor.data_ptr() == t.data_ptr()


# -- the explicit SPMD layer on the card --------------------------------


@pytest.mark.cuda
def test_thread_runner_collectives_on_the_card(card):
    from spartan_tpu_torch.array.tiling import Tiling
    from spartan_tpu_torch.parallel import collectives as coll
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.parallel import shard_map as smap

    mesh = mesh_mod.build_mesh((8, 1), card)
    x = torch.randn(8 * 64, 32, device=card,
                    generator=torch.Generator(device=card).manual_seed(5))
    blocks = list(x.chunk(8))
    got = smap.shard_map(
        lambda v: torch.stack([coll.all_reduce(v, "x"),
                               coll.ring_permute(v, "x", 1),
                               coll.all_gather(v, "x")[:64]])[None],
        mesh, (Tiling(("x", None)),), Tiling(("x", None, None, None)))(x)
    acc = blocks[0]
    for b in blocks[1:]:
        acc = acc + b
    for i in range(8):
        assert torch.equal(got[i, 0], acc)
        assert torch.equal(got[i, 1], blocks[(i - 1) % 8])
        assert torch.equal(got[i, 2], blocks[0])


@pytest.mark.cuda
def test_group_forms_launch_per_position_and_logical_once(card):
    """Under the thread runner each position launches its own kernel;
    the logical-mesh wrappers keep one launch over all shards."""
    from spartan_tpu_torch.array.tiling import Tiling
    from spartan_tpu_torch.kernels import histogram as kh
    from spartan_tpu_torch.kernels import stencil as kst
    from spartan_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.build_mesh((4, 1), card)
    pts, c0 = _clustered(4 * 1024, 128, 8, seed=12)
    p, c = torch.from_numpy(pts).to(card), torch.from_numpy(c0).to(card)
    before = kk.LAUNCHES
    s_g, n_g = kk.assign_accumulate_sharded(p, c, 8, None, mesh)
    torch.cuda.synchronize()
    assert kk.LAUNCHES == before + 4
    s_1, n_1 = kk.assign_accumulate(p, c, 8)
    torch.testing.assert_close(n_g, n_1, rtol=0, atol=0)
    torch.testing.assert_close(s_g, s_1, rtol=2e-5, atol=1e-3)

    ids = torch.randint(0, 64, (1 << 20,), device=card, dtype=torch.int32)
    before = kh.LAUNCHES["bincount_block"]
    one = kh.bincount_sharded(ids, 64, mesh)
    assert kh.LAUNCHES["bincount_block"] == before + 1
    grp = kh.bincount_group(ids, 64, mesh)
    assert kh.LAUNCHES["bincount_block"] == before + 5
    assert torch.equal(one, grp)

    x = torch.randn(2, 64, 16, 8, device=card)
    w = torch.randn(3, 3, 8, 16, device=card)
    t = Tiling((None, "x", None, None))
    before = kst.LAUNCHES["conv_block"]
    a = kst.halo_stencil(x, w, t, mesh)
    assert kst.LAUNCHES["conv_block"] == before + 1
    b = kst.halo_stencil_sharded(x, w, t, mesh)
    assert kst.LAUNCHES["conv_block"] == before + 5
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_one_rank_nccl_group(card, tmp_path):
    import torch.distributed as dist

    from spartan_tpu_torch.array.tiling import Tiling
    from spartan_tpu_torch.obs.metrics import collective_totals
    from spartan_tpu_torch.parallel import collectives as coll
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.parallel import shard_map as smap

    if not dist.is_nccl_available():
        pytest.skip("this torch build has no NCCL")
    assert mesh_mod.initialize_distributed(
        f"file://{tmp_path / 'store'}", num_processes=1, process_id=0,
        backend="nccl", device=card, timeout_s=120)
    try:
        mesh = mesh_mod.get_mesh()
        assert mesh.is_group and mesh_mod.backend(mesh) == "nccl"
        before = collective_totals()
        x = torch.randn(16, 8, device=card)
        t = Tiling(("x", "y"))
        for body in (lambda v: coll.all_reduce(v, "x"),
                     lambda v: coll.all_gather(v, "y", gather_axis=1),
                     lambda v: coll.reduce_scatter(v, "x"),
                     lambda v: coll.all_to_all(v, "x", split_axis=1,
                                               concat_axis=0),
                     lambda v: coll.ring_permute(v, "y", 1)):
            assert torch.equal(smap.shard_map(body, mesh, (t,), t)(x), x)
        after = collective_totals()
        assert after["collective_host_staged_calls"] == \
            before["collective_host_staged_calls"]
        with pytest.raises(ValueError, match="CUDA tensors"):
            smap.shard_map(lambda v: coll.all_reduce(v, "x"), mesh, (t,),
                           t)(x.cpu())
    finally:
        mesh_mod.shutdown()
    assert not dist.is_initialized()


@pytest.mark.cuda
def test_one_rank_nccl_group_local_storage(card, tmp_path):
    """Local-shard storage on a one-rank nccl group: the arrays' blocks
    live on the card, and config-3-shaped k-means through ``st.loop``
    and a GEMM through ``st.dot`` equal the logical mesh's bit for bit,
    with nothing gathered whole and nothing staged through the host."""
    import torch.distributed as dist

    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_numpy
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.obs.metrics import collective_totals
    from spartan_tpu_torch.parallel import mesh as mesh_mod

    if not dist.is_nccl_available():
        pytest.skip("this torch build has no NCCL")
    pts, c0 = _clustered(16384, 128, 16, seed=13)
    rng = np.random.RandomState(14)
    a = rng.rand(512, 384).astype(np.float32)
    b = rng.rand(384, 256).astype(np.float32)

    def run():
        p = st.as_expr(from_numpy(pts))
        centers = st.loop(5, lambda c: km.kmeans_step(p, c, 16),
                          from_numpy(c0)).glom()
        return centers, st.dot(from_numpy(a), from_numpy(b)).glom()

    prev = mesh_mod.get_default_device()
    mesh_mod.set_default_device(card)
    try:
        with mesh_mod.use_mesh(mesh_mod.build_mesh((1, 1), card)):
            want = run()
        assert mesh_mod.initialize_distributed(
            f"file://{tmp_path / 'store'}", num_processes=1, process_id=0,
            backend="nccl", device=card, timeout_s=120)
        try:
            mesh = mesh_mod.get_mesh()
            assert mesh.is_group and mesh_mod.backend(mesh) == "nccl"
            assert from_numpy(pts).local.device.type == "cuda"
            before = collective_totals()
            launches = kk.LAUNCHES
            got = run()
            after = collective_totals()
            assert kk.LAUNCHES == launches + 5
        finally:
            mesh_mod.shutdown()
    finally:
        mesh_mod.set_default_device(prev)
    for key in ("group_materialize_calls", "collective_host_staged_calls"):
        assert after[key] == before[key], key
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.cuda
def test_chaos_on_the_card_retries_degrades_and_rebuilds(card, tmp_path):
    """The resilience ladder on the card: a transient fault is retried
    (the k-means kernel still runs every iteration, centers bit-equal),
    an injected OOM takes the finer_tiling rung, and a device loss
    rebuilds the logical (4, 2) mesh to (7, 1) and resumes the
    checkpointed loop bit-equal to a clean resume on (7, 1)."""
    import json
    import shutil

    import spartan_tpu_torch as st
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.resilience import loop_ckpt

    pts, c0 = _clustered(65536, 128, 16, seed=15)
    prev = mesh_mod.get_default_device()
    keep = loop_ckpt._KEEP_SNAPSHOTS
    mesh_mod.set_default_device(card)
    loop_ckpt._KEEP_SNAPSHOTS = 16
    try:
        with mesh_mod.use_mesh(mesh_mod.build_mesh((4, 2), card)):
            p = st.from_numpy(pts)

            def run(path, points=p, **kw):
                return st.loop(20, lambda c: km.kmeans_step(points, c, 16),
                               st.from_numpy(c0), checkpoint_every=5,
                               checkpoint_path=path, **kw)

            ref = run(str(tmp_path / "clean")).glom()
            launches = kk.LAUNCHES
            with st.chaos("transient@1"):
                got = run(str(tmp_path / "t")).glom()
            assert kk.LAUNCHES == launches + 20
            np.testing.assert_array_equal(got, ref)
            with st.chaos("oom@1"):
                out = run(str(tmp_path / "o"))
                got = out.glom()
            assert out._resilience["rung"] == "finer_tiling"
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
            loss = tmp_path / "loss"
            with st.chaos("device_loss@2"):
                got = run(str(loss)).glom()
            assert dict(mesh_mod.get_mesh().shape) == {"x": 7, "y": 1}
            ref_dir = tmp_path / "ref"
            shutil.copytree(loss, ref_dir)
            for d in os.listdir(ref_dir):
                if d.startswith("step_") and int(d[5:]) > 10:
                    shutil.rmtree(ref_dir / d)
            (ref_dir / "LATEST.json").write_text(
                json.dumps({"step": 10, "dir": "step_00000010"}))
            p2 = st.from_numpy(pts)
            launches = kk.LAUNCHES
            ref2 = run(str(ref_dir), points=p2, resume=str(ref_dir)).glom()
            assert kk.LAUNCHES == launches + 10
            np.testing.assert_array_equal(got, ref2)
    finally:
        st.chaos_clear()
        loop_ckpt._KEEP_SNAPSHOTS = keep
        mesh_mod.reset_epoch_for_tests()
        mesh_mod.set_default_device(prev)


@pytest.mark.cuda
def test_real_out_of_memory_is_classified_oom(card):
    """An allocation larger than the card inside an
    evaluate raises torch.cuda.OutOfMemoryError, which the classifier
    calls oom and the ladder recovers; the next evaluate succeeds."""
    import spartan_tpu_torch as st
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.resilience import classify as cls

    prev = mesh_mod.get_default_device()
    mesh_mod.set_default_device(card)
    armed = [True]
    caught = []

    def grab(t):
        if armed[0] and t.device.type != "meta":
            armed[0] = False
            # larger than the card, so larger than its free memory and
            # the allocator's cache
            _, total = torch.cuda.mem_get_info(t.device)
            try:
                torch.empty(total + (1 << 30), dtype=torch.uint8,
                            device=t.device)
            except torch.cuda.OutOfMemoryError as e:
                caught.append(cls.classify(e))
                raise
        return t + 1.0

    try:
        x = np.arange(64, dtype=np.float32).reshape(8, 8)
        e = st.map(grab, st.from_numpy(x))
        np.testing.assert_array_equal(e.glom(), x + 1.0)
        assert caught == ["oom"]
        assert e._resilience["faults"][0]["class"] == "oom"
        assert e._resilience["rung"] == "finer_tiling"
        np.testing.assert_array_equal(
            st.map(grab, st.from_numpy(x)).glom(), x + 1.0)
    finally:
        mesh_mod.set_default_device(prev)


# -- observability on the card (obs/profile.py, obs/numerics.py) -----------


@pytest.mark.cuda
def test_capture_tier_names_the_kmeans_kernels_node(card):
    import spartan_tpu_torch as st
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.parallel import mesh as mesh_mod

    pts, c0 = _clustered(65536, 128, 16, seed=3)
    with mesh_mod.use_mesh(mesh_mod.build_mesh((4, 2), device=card)):
        step = km.kmeans_step(st.from_numpy(pts), st.from_numpy(c0), 16)
        prof = st.profile(step, tier="capture")
    # answered from the profiler's device records, joined to the node
    assert prof.tier == "capture" and prof.note is None
    node = prof.node("KMeansStepExpr")
    assert len(node) == 1 and node[0]["seconds"] > 0
    assert any("assign_accumulate" in k for k in node[0]["kernels"])
    assert any("assign_accumulate" in e["name"]
               and e["node"] == node[0]["node"] for e in prof.events)
    assert prof.attributed_s <= prof.wall_s + 1e-9


@pytest.mark.cuda
def test_health_words_on_the_card_equal_the_cpus(card):
    from spartan_tpu_torch.obs import numerics

    rng = np.random.RandomState(4)
    for dtype in (np.float32, np.float16, np.int32, np.bool_):
        a = (rng.rand(257, 33) * 10 - 5).astype(dtype)
        if dtype in (np.float32, np.float16):
            a[3, 4], a[7, 1], a[9, 9] = np.nan, np.inf, 0
        t = torch.from_numpy(a)
        w_cpu = numerics._health_word(t).numpy()
        w_card = numerics._health_word(t.to(card)).cpu().numpy()
        np.testing.assert_array_equal(w_card, w_cpu)


@pytest.mark.cuda
def test_early_exit_reads_once_an_iteration_and_health_never(card,
                                                             monkeypatch):
    import spartan_tpu_torch as st
    from spartan_tpu_torch.parallel import mesh as mesh_mod

    calls = []
    real = torch.Tensor.item

    def counted(self):
        calls.append(1)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "item", counted)
    w0 = np.linspace(0.5, 1.5, 4096).astype(np.float32)
    with mesh_mod.use_mesh(mesh_mod.build_mesh((1, 1), device=card)):
        st.loop(20, lambda w: w * 0.5, st.from_numpy(w0),
                health=True).glom()
        health_reads = len(calls)
        del calls[:]
        st.loop(20, lambda w: w * 0.5, st.from_numpy(w0),
                early_exit=True).glom()
    assert health_reads == 0
    assert len(calls) == 20


@pytest.mark.cuda
def test_validate_plan_measures_the_card_peak(card):
    """The memory governor's validation on the card: a map-and-reduce
    plan's measured walk against its predicted card peak (the fused
    map's intermediate and output beside the operands)."""
    import spartan_tpu_torch as st
    from spartan_tpu_torch.expr import base
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.resilience import memory

    rng = np.random.RandomState(8)
    x = rng.rand(2048, 1024).astype(np.float32)
    with mesh_mod.use_mesh(mesh_mod.build_mesh((4, 2), card)) as mesh:
        a, b = st.from_numpy(x), st.from_numpy(x * 2.0)
        e = (a + b) * 3.0 - a
        key, rctx = base.plan_signature(e, mesh)
        plan, _, _ = base._build_plan(e, mesh, rctx, key)
        val = memory.validate_plan(plan, mesh)
    assert val is not None and val["measured_peak_bytes"] > 0
    assert 0.75 <= val["error_ratio"] <= 1.25, val
    assert plan.report["memory"]["validation"] is val


@pytest.mark.cuda
def test_governor_picks_a_rung_on_the_card_without_oom(card):
    """A budget below the plan's predicted card peak: the governor takes
    the chunked rung before the walk (the only rung that changes what
    one card holds for a map), no OOM raised, bit-equal to the rung
    forced."""
    import spartan_tpu_torch as st
    from spartan_tpu_torch.expr import base
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.resilience import degrade, memory

    x = np.random.RandomState(9).rand(4096, 512).astype(np.float32)
    prev = st.FLAGS.hbm_budget_bytes
    with mesh_mod.use_mesh(mesh_mod.build_mesh((4, 2), card)):
        a = st.from_numpy(x)
        need = memory.predict((a + 1.0) * 2.0)["peak_bytes_card"]
        base.clear_plan_cache()
        oom0 = st.metrics()["counters"].get("resilience_oom_events", 0)
        st.FLAGS.hbm_budget_bytes = need - 1
        try:
            e = (a + 1.0) * 2.0
            got = e.glom()
        finally:
            st.FLAGS.hbm_budget_bytes = prev
        assert e._resilience["rung"] == "chunked"
        assert e._resilience["origin"] == "predictive"
        assert st.metrics()["counters"].get("resilience_oom_events",
                                            0) == oom0
        forced = degrade._chunked_evaluate((a + 1.0) * 2.0,
                                           mesh_mod.get_mesh()).glom()
    np.testing.assert_array_equal(got, forced)


@pytest.mark.cuda
def test_block_checksums_on_the_card_equal_the_cpus(card):
    from spartan_tpu_torch.array import tiling as tiling_mod
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.resilience import integrity

    t = torch.from_numpy(np.random.RandomState(10).rand(64, 48)
                         .astype(np.float32))
    for shape, axes in (((8, 1), ("x", None)), ((4, 2), ("x", "y")),
                        ((4, 2), (None, None))):
        mesh = mesh_mod.build_mesh(shape, "cpu")
        tl = tiling_mod.Tiling(axes)
        assert integrity.shard_checksums(t.to(card), tl, mesh) == \
            integrity.shard_checksums(t, tl, mesh)
        flip = integrity.flip_bit(t.to(card), 3, 5, 1, [tl], mesh)
        np.testing.assert_array_equal(
            flip.cpu().numpy(),
            integrity.flip_bit(t, 3, 5, 1, [tl], mesh).numpy())


@pytest.mark.cuda
def test_kmeans_vmap_rule_bit_equal_to_solo_launches(card):
    """``torch.func.vmap`` over the pass reaches the kernel through the
    operator's batching rule: one launch a client, each bit-equal to the
    solo launch on that client's centers."""
    pts, c0 = _clustered(65536, 128, 16, seed=71)
    p = torch.from_numpy(pts).to(card)
    g = torch.Generator(device=card)
    g.manual_seed(72)
    cs = (torch.from_numpy(c0).to(card)[None]
          + 0.1 * torch.randn((6, 16, 128), generator=g, device=card))
    solo = [kk.assign_accumulate(p, cs[i], 16, 60000) for i in range(6)]
    before = kk.LAUNCHES
    sums, cnt = torch.func.vmap(
        lambda c: kk.assign_accumulate(p, c, 16, 60000))(cs)
    torch.cuda.synchronize()
    assert kk.LAUNCHES - before == 6
    for i in range(6):
        assert torch.equal(sums[i], solo[i][0])
        assert torch.equal(cnt[i], solo[i][1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_shard_topk_vmap_rule_one_launch_a_client(card, dtype):
    """``torch.func.vmap`` over ``shard_topk`` reaches the operator's
    batching rule: one launch a client, each bit-equal to its solo
    launch, the batch along dim 0 or dim 1."""
    from spartan_tpu_torch.kernels import topk as kt

    gen = torch.Generator(device=card)
    gen.manual_seed(81)
    if dtype == torch.float32:
        keys, sentinel = torch.rand((5, 8, 70_001), generator=gen,
                                    device=card), float("-inf")
    else:
        keys, sentinel = torch.randint(-9, 9, (5, 8, 70_001), generator=gen,
                                       device=card, dtype=dtype), -2 ** 31
    solo = [kt.shard_topk(keys[i], 128, sentinel) for i in range(5)]
    for dim in (0, 1):
        before = kt.LAUNCHES["shard_topk"]
        got = torch.func.vmap(lambda k: kt.shard_topk(k, 128, sentinel),
                              in_dims=dim)(keys.movedim(0, dim))
        torch.cuda.synchronize()
        assert kt.LAUNCHES["shard_topk"] - before == 5
        for i in range(5):
            assert torch.equal(got[0][i].view(torch.int32),
                               solo[i][0].view(torch.int32))
            assert torch.equal(got[1][i], solo[i][1])


@pytest.mark.cuda
def test_bincount_vmap_rule_one_launch_a_client(card):
    """``torch.func.vmap`` over ``bincount_block`` and over
    ``bincount_sharded`` on a logical (8, 1) mesh: one launch a client,
    each bit-equal to its solo launch and to the plain version."""
    from spartan_tpu_torch.kernels import histogram as kh
    from spartan_tpu_torch.parallel import mesh as mesh_mod

    gen = torch.Generator(device=card)
    gen.manual_seed(82)
    ids = torch.randint(-5, 300, (6, 1_000_003), generator=gen, device=card,
                        dtype=torch.int32)
    with mesh_mod.use_mesh(mesh_mod.build_mesh((8, 1), card)):
        for fn in (lambda i: kh.bincount_block(i, 257),
                   lambda i: kh.bincount_sharded(i, 257)):
            solo = [fn(ids[i]) for i in range(6)]
            before = kh.LAUNCHES["bincount_block"]
            got = torch.func.vmap(fn)(ids)
            torch.cuda.synchronize()
            assert kh.LAUNCHES["bincount_block"] - before == 6
            for i in range(6):
                assert torch.equal(got[i], solo[i])
                assert torch.equal(got[i], kh.bincount_block_plain(ids[i],
                                                                   257))


@pytest.mark.cuda
@pytest.mark.parametrize("batched", ["xs", "runs", "all"])
def test_partition_pack_vmap_rule_one_launch_a_client(card, batched):
    """``torch.func.vmap`` over ``partition_pack`` with the streams, the
    runs or both batched: one launch a client, each bit-equal to its
    solo launch."""
    from spartan_tpu_torch.kernels import exchange as kx

    rng = np.random.RandomState(83)
    xs = torch.from_numpy(rng.rand(4, 8, 30_000).astype(np.float32)).to(card)
    counts = np.stack([rng.multinomial(30_000, np.ones(8) / 8, 8)
                       for _ in range(4)]).astype(np.int32)
    starts = (np.cumsum(counts, -1) - counts).astype(np.int32)
    s, c = torch.from_numpy(starts).to(card), torch.from_numpy(counts).to(card)
    x_d = None if batched == "runs" else 0
    r_d = None if batched == "xs" else 0

    def pick(t, d, i):
        return t[i] if d == 0 else t[0]

    solo = [kx.partition_pack(pick(xs, x_d, i), pick(s, r_d, i),
                              pick(c, r_d, i)) for i in range(4)]
    before = kx.LAUNCHES["partition_pack"]
    got = torch.func.vmap(kx.partition_pack, in_dims=(x_d, r_d, r_d))(
        xs if x_d == 0 else xs[0], s if r_d == 0 else s[0],
        c if r_d == 0 else c[0])
    torch.cuda.synchronize()
    assert kx.LAUNCHES["partition_pack"] - before == 4
    for i in range(4):
        assert torch.equal(got[i].view(torch.int32),
                           solo[i].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 64])
@pytest.mark.parametrize("shared_w", [True, False])
def test_conv_block_vmap_rule_one_launch_a_client(card, c, shared_w):
    """``torch.func.vmap`` over ``conv_block`` on halo blocks, both
    routes (C = 3 SIMT, C = 64 tensor cores), the filter shared or
    batched: one launch a client on the route's counter, each bit-equal
    to its solo launch."""
    from spartan_tpu_torch.kernels import stencil as kst

    gen = torch.Generator(device=card)
    gen.manual_seed(84 + c)
    x = torch.stack([kst.halo_exchange(torch.randn(
        (2, 64, 40, c), generator=gen, device=card), 3, 3, 8)
        for _ in range(3)])
    w = torch.randn((3, 3, 3, c, 64), generator=gen, device=card)
    w_d = None if shared_w else 0
    solo = [kst.conv_block(x[i], w[0] if shared_w else w[i])
            for i in range(3)]
    before = dict(kst.LAUNCHES)
    got = torch.func.vmap(kst.conv_block, in_dims=(0, w_d))(
        x, w[0] if shared_w else w)
    torch.cuda.synchronize()
    assert kst.LAUNCHES["conv_block"] - before["conv_block"] == 3
    assert kst.LAUNCHES["conv_block_mma"] - before["conv_block_mma"] == \
        (3 if kst.route(c) == "mma" else 0)
    for i in range(3):
        assert torch.equal(got[i], solo[i])


@pytest.mark.cuda
def test_one_served_kmeans_batch_on_the_card(card):
    """A coalesced batch of k-means steps through one ``ServeEngine``:
    mode ``vmap``, one launch a request, each bit-equal to its serial
    ``evaluate()``."""
    import threading

    import spartan_tpu_torch as st
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.expr import base
    from spartan_tpu_torch.serve import coalesce

    st.set_default_device(card)
    pts, c0 = _clustered(131072, 128, 16, seed=73)
    points = st.from_numpy(pts)
    rng = np.random.RandomState(74)
    cs = [st.from_numpy((c0 + 0.1 * rng.randn(*c0.shape))
                        .astype(np.float32)) for _ in range(8)]
    serial = [km.kmeans_step(points, c, 16).glom() for c in cs]
    eng = st.ServeEngine(workers=1, batch_window_s=0.05, max_batch=8)
    park = threading.Thread(target=lambda: None)
    park.start()
    park.join()
    eng._threads.append(park)  # queue the whole batch first
    futs = [eng.submit(km.kmeans_step(points, c, 16)) for c in cs]
    eng._threads.clear()
    before = kk.LAUNCHES
    with eng:
        got = [f.glom(timeout=120) for f in futs]
    assert kk.LAUNCHES - before == 8
    assert [f.coalesced for f in futs] == [8] * 8
    for a, b in zip(serial, got):
        np.testing.assert_array_equal(a, b)
    plan = base.lookup_plan(base.plan_signature(
        km.kmeans_step(points, cs[0], 16))[0])
    assert coalesce.mode_for(plan) == "vmap"
    assert plan.report["serve"]["mode"] == "vmap"


@pytest.mark.cuda
def test_incremental_splice_on_the_card_is_bit_equal(card):
    """The incremental engine on the card: a map stream is served by a
    restricted walk spliced into a clone of the cached result, bit-equal
    to the full walk; a vector-matrix product's warm step is served too,
    its product restricted to the rewritten columns through the
    fixed-order kernel (one launch), bit-equal to the full walk."""
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array import distarray as da
    from spartan_tpu_torch.expr import base, incremental as inc
    from spartan_tpu_torch.expr.base import evaluate, lazify
    from spartan_tpu_torch.kernels import gemv as kg
    from spartan_tpu_torch.utils import profiling as prof
    from spartan_tpu_torch.utils.config import FLAGS

    st.set_default_device(card)
    prev = FLAGS.incremental
    FLAGS.incremental = True
    inc.clear()
    try:
        rng = np.random.RandomState(90)
        x_np = rng.rand(4096, 256).astype(np.float32)
        x = da.from_numpy(x_np)

        def build(a):
            return lazify(a) * 3.0 + 0.5

        cached = evaluate(build(x))
        kept = cached.tensor.clone()
        x2 = x.update((slice(100, 140), slice(0, 256)), 7.0)
        h0 = prof.counters().get("incremental_hits", 0)
        got = evaluate(build(x2)).tensor
        assert prof.counters().get("incremental_hits", 0) == h0 + 1
        x2_np = x_np.copy()
        x2_np[100:140] = 7.0
        FLAGS.incremental = False
        want = evaluate(build(da.from_numpy(x2_np))).tensor
        FLAGS.incremental = True
        assert torch.equal(got, want)
        assert torch.equal(cached.tensor, kept)  # never written in place

        n = 4096
        r = da.from_numpy(rng.rand(n).astype(np.float32))
        a = da.from_numpy(rng.rand(n, n).astype(np.float32))

        def step(m):
            return lazify(r).dot(lazify(m)) * 0.85 + 0.15 / n

        evaluate(step(a))
        a2 = a.update((slice(0, n), slice(512, 768)),
                      rng.rand(n, 256).astype(np.float32))
        h0 = prof.counters().get("incremental_hits", 0)
        l0 = kg.LAUNCHES["fixed_order_dot"]
        got = evaluate(step(a2)).tensor
        assert prof.counters().get("incremental_hits", 0) == h0 + 1
        assert kg.LAUNCHES["fixed_order_dot"] == l0 + 1
        plan = base.lookup_plan(base.plan_signature(step(a2))[0])
        assert plan.report["incremental"]["mode"] == "incremental"
        assert plan.report["incremental"].get("fallback") is None
        FLAGS.incremental = False
        assert torch.equal(got, evaluate(step(da.from_numpy(
            a2.glom()))).tensor)
    finally:
        FLAGS.incremental = prev
        inc.clear()


@pytest.mark.cuda
def test_monitor_sampler_thread_starts_and_stops_on_the_card(card):
    """The sampler thread ticks while k-means steps run on the card, and
    stops; its health and ``st.status()`` show it."""
    import spartan_tpu_torch as st
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.obs import monitor
    from spartan_tpu_torch.utils.config import FLAGS

    st.set_default_device(card)
    prev = (FLAGS.monitor, FLAGS.monitor_interval_s)
    monitor.MONITOR.stop()
    monitor.MONITOR.reset()
    FLAGS.monitor, FLAGS.monitor_interval_s = True, 0.02
    try:
        pts, c0 = _clustered(65536, 128, 16, seed=91)
        points, c = st.from_numpy(pts), st.from_numpy(c0)
        monitor.start()
        for _ in range(5):
            c = km.kmeans_step(points, c, 16).evaluate()
        torch.cuda.synchronize()
        assert monitor.MONITOR.ticked.wait(30)
        s = st.status()
        assert s["monitor"]["running"] and s["monitor"]["samples"] >= 1
        assert s["platform"] == "gpu"
    finally:
        monitor.stop()
        FLAGS.monitor, FLAGS.monitor_interval_s = prev
    assert monitor.MONITOR.health()["running"] is False
    monitor.MONITOR.reset()


# -- the local rules' kernels on two gloo ranks sharing the card ----------

_LOCAL_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import spartan_tpu_torch as st
from spartan_tpu_torch.array.distarray import from_numpy
from spartan_tpu_torch.kernels import exchange as kx
from spartan_tpu_torch.kernels import histogram as kh
from spartan_tpu_torch.kernels import stencil as kst
from spartan_tpu_torch.obs.metrics import collective_totals
from spartan_tpu_torch.parallel import mesh as mesh_mod

dev = torch.device("cuda", 0)
st.set_default_device(dev)
assert mesh_mod.initialize_distributed(
    "file://" + os.environ["STORE"], num_processes=2,
    process_id=int(os.environ["RANK"]), backend="gloo", device=dev,
    timeout_s=120)
case = os.environ["CASE"]
rng = np.random.RandomState(5)
kernels = {"sort": (kx.LAUNCHES, "partition_pack"),
           "histogram": (kh.LAUNCHES, "bincount_block"),
           "stencil": (kst.LAUNCHES, "conv_block")}
if case == "sort":
    data, tiling = rng.randn(6, 4096).astype(np.float32), (None, "x")
    build = lambda: st.tuple_of(st.sort(x), st.argsort(x))
elif case == "histogram":
    data, tiling = rng.rand(257, 96).astype(np.float32), ("x", None)
    build = lambda: st.histogram(x, 64)[0]
else:
    data, tiling = rng.randn(3, 32, 20, 8).astype(np.float32), (
        None, "x", None, None)
    w = rng.randn(3, 3, 8, 16).astype(np.float32) * 0.2
    build = lambda: st.maxpool(st.maximum(st.stencil(x, from_numpy(w)), 0.0),
                               2)
x = st.as_expr(from_numpy(data, tiling=st.Tiling(tiling)))
table, name = kernels[case]
st.FLAGS.native_kernels = "on"
before, m0 = table[name], collective_totals()["group_materialize_calls"]
got = build().evaluate()
got = got if isinstance(got, tuple) else (got,)
torch.cuda.synchronize()
out = {"launches": table[name] - before,
       "mat": collective_totals()["group_materialize_calls"] - m0,
       "vals": [g.local.cpu().numpy().tolist() for g in got]}
mesh = mesh_mod.get_mesh()
exts = [g.tiling.block_extent(g.shape, mesh).to_slice() for g in got]
# the plain versions: the same expression on a logical 1 x 1 mesh with
# the kernels off, cut to this rank's blocks
st.FLAGS.native_kernels = "off"
with st.use_mesh(st.build_mesh((1, 1), dev)):
    x = st.as_expr(from_numpy(data))
    before = table[name]
    ref = build().evaluate()
    ref = ref if isinstance(ref, tuple) else (ref,)
    out["plain_launches"] = table[name] - before
    out["plain"] = [r.local[e].cpu().numpy().tolist()
                    for r, e in zip(ref, exts)]
mesh_mod.shutdown()
with open(os.environ["OUT"], "w") as f:
    json.dump(out, f)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("case,launches", [("sort", 3), ("histogram", 1),
                                           ("stencil", 1)])
def test_local_rule_kernels_on_stored_blocks(card, tmp_path, case, launches):
    """Two gloo ranks sharing the card, each holding its blocks: the
    batched sort and argsort of rows along their tiled axis pack with
    ``partition_pack`` (one launch for the sort, two for the argsort, a
    rank), the histogram of a 2-D array counts each rank's raveled block
    with ``bincount_block``, and the conv of an H-tiled image with
    ``conv_block`` before the pool pools each block; each rank's blocks
    equal the plain versions' (``native_kernels=off`` on a logical 1 x 1
    mesh), nothing gathered whole."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ, REPO=repo, STORE=str(tmp_path / "store"),
                   RANK=str(rank), CASE=case,
                   OUT=str(tmp_path / f"rank{rank}.json"),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", _LOCAL_CHILD],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    import json

    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            got = json.load(f)
        assert got["launches"] == launches, (rank, got["launches"])
        assert got["plain_launches"] == 0 and got["mat"] == 0
        for a, b in zip(got["vals"], got["plain"]):
            if case == "stencil":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(a, b)


# -- the integrity check on a group mesh: two gloo ranks on the card ------

_INTEGRITY_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import spartan_tpu_torch as st
from spartan_tpu_torch.examples import kmeans as km
from spartan_tpu_torch.kernels import kmeans as kk
from spartan_tpu_torch.parallel import mesh as mesh_mod
from spartan_tpu_torch.resilience import integrity

dev = torch.device("cuda", 0)
st.set_default_device(dev)
assert mesh_mod.initialize_distributed(
    "file://" + os.environ["STORE"], num_processes=2,
    process_id=int(os.environ["RANK"]), backend="gloo", device=dev,
    timeout_s=120)
rng = np.random.RandomState(9)
pts = rng.rand(65536, 128).astype(np.float32)
c0 = pts[:16].copy()
st.FLAGS.opt_auto_tiling = False  # the centers stay replicated
st.FLAGS.retry_backoff_s = 0.0
p = st.from_numpy(pts).evaluate()
off = km.kmeans_step(p, st.from_numpy(c0), 16).evaluate().glom()
st.FLAGS.integrity_check = True
st.FLAGS.profile_sample_every = 1
verdicts = []
stamp = integrity._stamp
integrity._stamp = lambda d, pl, v: (verdicts.append(
    {k: v[k] for k in v if k not in ("t", "plan")}), stamp(d, pl, v))[1]
# the profiler samples at the same cadence: its walks' launches apart
import importlib
profile_mod = importlib.import_module("spartan_tpu_torch.obs.profile")
impl, sampled = profile_mod._profile_impl, [0]


def counted(*a, **kw):
    before = kk.LAUNCHES
    try:
        return impl(*a, **kw)
    finally:
        sampled[0] += kk.LAUNCHES - before


profile_mod._profile_impl = counted
before = kk.LAUNCHES
on = km.kmeans_step(p, st.from_numpy(c0), 16).evaluate().glom()
torch.cuda.synchronize()
out = {"launches": kk.LAUNCHES - before - sampled[0],
       "equal": bool((on == off).all()), "clean": list(verdicts)}
verdicts.clear()
with st.chaos("sdc@0#1", seed=2):
    again = km.kmeans_step(p, st.from_numpy(c0), 16).evaluate().glom()
out["fault"] = list(verdicts)
out["retry_equal"] = bool((again == off).all())
mesh_mod.shutdown()
with open(os.environ["OUT"], "w") as f:
    json.dump(out, f)
"""


@pytest.mark.cuda
def test_group_integrity_leaf_move_and_vote(card, tmp_path):
    """Two gloo ranks sharing the card check a k-means step: each rank's
    block of the points moves to the rank holding its coordinates on the
    rotated mesh, the re-walk launches the kernel again there (2 launches
    a rank), the verdicts are the same on both ranks, and a bit flipped
    in rank 1's copy of the replicated centers implicates rank 1 alone;
    the clean retry returns the flag-off centers."""
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for rank in range(2):
        env = dict(os.environ, REPO=repo, STORE=str(tmp_path / "store"),
                   RANK=str(rank), OUT=str(tmp_path / f"rank{rank}.json"),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c",
                                       _INTEGRITY_CHILD], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = []
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            got.append(json.load(f))
    for g in got:
        assert g["launches"] == 2 and g["equal"] and g["retry_equal"]
        (clean,) = g["clean"]
        assert clean["verdict"] == "ok"
        # the points' block (32768 x 128 f32) is what moves
        assert clean["moved_sent"] == clean["moved_recv"] >= 32768 * 128 * 4
        assert g["fault"][0]["suspects"] == [1]
        assert [v["verdict"] for v in g["fault"]] == ["violation", "ok"]
    assert got[0]["clean"] == got[1]["clean"]
    assert got[0]["fault"] == got[1]["fault"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,dtype,params", [
    ("uniform", torch.float32, (0, 0)), ("randint", torch.int32, (-9, 1000)),
    ("normal", torch.float32, (0, 0))])
def test_counter_draw_on_the_card_equals_the_host(card, kind, dtype, params):
    """A counter-based draw (``utils/philox.py``) of a block on the card
    against the same block drawn on the host: the integer words and the
    uniform's exact scaling give the same bits; the normal's float64
    log and cos round to within one float32 ulp."""
    from spartan_tpu_torch.array.extent import TileExtent
    from spartan_tpu_torch.utils import philox

    flat = (2 * philox.CHUNK + 4097,)  # three chunks
    for shape, ul, lr in (((1001, 37, 3), (0, 0, 0), (1001, 37, 3)),
                          ((1001, 37, 3), (500, 3, 1), (1001, 30, 3)),
                          (flat, (0,), flat),
                          (flat, (philox.CHUNK - 3,), flat)):
        ext = TileExtent(ul, lr, shape)
        on_card = philox.draw(kind, 2 ** 40 + 5, shape, ext, dtype, card,
                              params).cpu()
        host = philox.draw(kind, 2 ** 40 + 5, shape, ext, dtype, "cpu",
                           params)
        if kind == "normal":
            torch.testing.assert_close(on_card, host, rtol=1.2e-7,
                                       atol=1e-7)
        else:
            assert torch.equal(on_card, host)


# -- the fixed-order vector product (csrc/gemv.cu) ---------------------------


def _gemv_operands(card, orient, k, m, seed):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    vec = torch.rand((k,), generator=gen, device=card) * 2 - 1
    shape = (k, m) if orient == "vecmat" else (m, k)
    mat = torch.rand(shape, generator=gen, device=card) * 2 - 1
    return (vec, mat) if orient == "vecmat" else (mat, vec)


# each path of the kernel: M from one column to just past a warp, and K
# of S = 1, 2, 64 and 16,384 slices (no fold, and folds of one to 128
# stages)
_GEMV_PATHS = [(k, m) for m in (1, 3, 4, 32, 33)
               for k in (256, 300, 16_384, 2 ** 22)]


@pytest.mark.cuda
@pytest.mark.parametrize("orient", ["vecmat", "matvec"])
@pytest.mark.parametrize("k,m", [(1, 1), (100, 301), (256, 4096),
                                 (257, 33), (845, 1000), (16384, 4096),
                                 (70_000, 32), (32, 100_000)] + _GEMV_PATHS)
def test_gemv_matches_plain_bit_for_bit(card, orient, k, m):
    from spartan_tpu_torch.kernels import gemv as kg

    a, b = _gemv_operands(card, orient, k, m, seed=k + m)
    before = kg.LAUNCHES["fixed_order_dot"]
    got = kg.fixed_order_dot(a, b)
    torch.cuda.synchronize()
    assert kg.LAUNCHES["fixed_order_dot"] == before + 1
    assert torch.equal(got, kg.fixed_order_dot_plain(a, b))
    assert torch.equal(got, kg.fixed_order_dot(a, b))  # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("orient", ["vecmat", "matvec"])
@pytest.mark.parametrize("k,m", [(300, 32), (16_384, 33), (2 ** 20, 32),
                                 (16_384, 4096)])
def test_gemv_unaligned_window_matches_plain(card, orient, k, m):
    """A window whose rows are not 16-byte aligned (a view one row and one
    column into a matrix with an odd row stride) takes the 4-byte loads
    and copies, in the same order: bit-equal to the plain version and to
    the product of its contiguous copy."""
    from spartan_tpu_torch.kernels import gemv as kg

    ops = _gemv_operands(card, orient, k + 1, m + 1, seed=k + 3 * m)
    vec, mat = ops if orient == "vecmat" else ops[::-1]
    view = mat[1:, 1:]
    vec = vec[1:]
    pair = (vec, view) if orient == "vecmat" else (view, vec)
    kind, *_, lda = kg.layout(*pair)
    assert kind == orient and lda % 4 != 0
    before = kg.LAUNCHES["fixed_order_dot"]
    got = kg.fixed_order_dot(*pair)
    torch.cuda.synchronize()
    assert kg.LAUNCHES["fixed_order_dot"] == before + 1
    assert torch.equal(got, kg.fixed_order_dot_plain(*pair))
    dense = (vec, view.contiguous()) if orient == "vecmat" \
        else (view.contiguous(), vec)
    assert torch.equal(got, kg.fixed_order_dot(*dense))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [255, 4096, 5000])
def test_gemv_windows_are_bit_equal_on_the_card(card, k):
    """Column windows of x @ A (views at odd, unaligned offsets, which
    take the one-column route) and row windows of A @ x give the whole
    product's bits."""
    from spartan_tpu_torch.kernels import gemv as kg

    x, a = _gemv_operands(card, "vecmat", k, 3001, seed=k)
    full = kg.fixed_order_dot(x, a)
    rows = kg.fixed_order_dot(a.t(), x)  # the other entry point
    assert torch.equal(full, rows)
    for lo, hi in ((0, 3001), (1, 2), (3, 40), (777, 941), (2999, 3001),
                   (4, 1028)):
        assert torch.equal(full[lo:hi], kg.fixed_order_dot(x, a[:, lo:hi]))
        at = a.t().contiguous()
        assert torch.equal(full[lo:hi], kg.fixed_order_dot(at[lo:hi], x))


@pytest.mark.cuda
def test_gemv_is_the_route_of_vector_products(card):
    """``st.dot`` of a float32 vector and matrix on the card launches the
    kernel once and gives its bits, with the incremental flag on or off;
    a matrix-matrix product and a float16 one keep ``torch.matmul`` (a
    float64 one is float32, as with JAX's 64-bit types off, and takes
    the kernel); a float64 operand is refused by the kernel, not run
    elsewhere."""
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.kernels import gemv as kg
    from spartan_tpu_torch.utils.config import FLAGS

    st.set_default_device(card)
    x, a = _gemv_operands(card, "vecmat", 4096, 2048, seed=5)
    want = kg.fixed_order_dot(x, a)
    prev = FLAGS.incremental
    try:
        for on in (False, True):
            FLAGS.incremental = on
            before = kg.LAUNCHES["fixed_order_dot"]
            got = st.dot(from_tensor(x), from_tensor(a)).evaluate()
            assert kg.LAUNCHES["fixed_order_dot"] == before + 1
            assert torch.equal(got.tensor, want)
            got = st.dot(from_tensor(a.t().contiguous()),
                         from_tensor(x)).evaluate()
            assert torch.equal(got.tensor, want)
    finally:
        FLAGS.incremental = prev
    before = kg.LAUNCHES["fixed_order_dot"]
    st.dot(from_tensor(a.t().contiguous()), from_tensor(a)).evaluate()
    st.dot(from_tensor(x.half()), from_tensor(a.half())).evaluate()
    torch.cuda.synchronize()
    assert kg.LAUNCHES["fixed_order_dot"] == before
    got = st.dot(from_tensor(x.double()), from_tensor(a.double()))
    assert got.dtype == np.float32
    assert torch.equal(got.evaluate().tensor, want)
    assert kg.LAUNCHES["fixed_order_dot"] == before + 1
    with pytest.raises(TypeError):
        kg.fixed_order_dot(x.double(), a.double())


@pytest.mark.cuda
def test_gemv_batching_rule_launches_once_a_client(card):
    from spartan_tpu_torch.kernels import gemv as kg

    gen = torch.Generator(device=card)
    gen.manual_seed(6)
    xs = torch.rand((4, 1000), generator=gen, device=card)
    a = torch.rand((1000, 513), generator=gen, device=card)
    before = kg.LAUNCHES["fixed_order_dot"]
    got = torch.func.vmap(kg.fixed_order_dot, in_dims=(0, None))(xs, a)
    torch.cuda.synchronize()
    assert kg.LAUNCHES["fixed_order_dot"] == before + 4
    assert torch.equal(got, torch.stack([kg.fixed_order_dot(x, a)
                                         for x in xs]))


# -- the fixed-order reduction (kernels/reduce.py) ------------------------

# (shape, reduced axes): the outer pass with one and several batches,
# four columns a thread and one, folds of one to 4096 slices; the inner
# pass; non-adjacent axes (a moved copy)
_REDUCE_CASES = [((1000, 7), (0,)), ((7, 1000), (1,)), ((16_384, 33), (0,)),
                 ((33, 16_384), (1,)), ((3, 300, 40), (1,)),
                 ((40, 30, 20), (0, 2)), ((2 ** 20, 3), (0,)),
                 ((4, 256, 4096), (1,)), ((5, 257, 33), (1,)),
                 ((2 ** 16, 32), (1,)), ((1, 70_000), (1,)),
                 ((6, 7, 8, 9), (1, 3))]


def _reduce_operand(card, shape, seed):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    return 0.99 + 0.02 * torch.rand(shape, generator=gen, device=card)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "prod", "mean"])
@pytest.mark.parametrize("shape,dims", _REDUCE_CASES)
def test_reduce_matches_plain_bit_for_bit(card, shape, dims, op):
    from spartan_tpu_torch.kernels import reduce as kr

    x = _reduce_operand(card, shape, sum(shape))
    for keepdim in (False, True):
        before = kr.LAUNCHES["fixed_order_reduce"]
        got = kr.fixed_order_reduce(x, op, dims, keepdim)
        torch.cuda.synchronize()
        assert kr.LAUNCHES["fixed_order_reduce"] == before + 1
        assert torch.equal(got, kr.fixed_order_reduce_plain(x, op, dims,
                                                            keepdim))
        assert torch.equal(got, kr.fixed_order_reduce(x, op, dims,
                                                      keepdim))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 255, 256, 257, 1000, 16_384])
def test_reduce_axis0_sum_is_fixed_order_dot_of_ones(card, k):
    from spartan_tpu_torch.kernels import gemv as kg
    from spartan_tpu_torch.kernels import reduce as kr

    a = _reduce_operand(card, (k, 301), k) * 2 - 1
    ones = torch.ones(k, device=card)
    assert torch.equal(kr.fixed_order_reduce(a, "sum", 0),
                       kg.fixed_order_dot(ones, a))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["sum", "mean"])
def test_reduce_windows_are_bit_equal_on_the_card(card, op):
    """Column windows of a sum along axis 0 (views at odd, unaligned
    offsets: the one-column route), row windows of a sum along axis 1
    and windows of the last axis of a 3-D sum along axis 0 give the
    whole reduction's bits."""
    from spartan_tpu_torch.kernels import reduce as kr

    a = _reduce_operand(card, (5000, 3001), 7)
    full0 = kr.fixed_order_reduce(a, op, 0)
    full1 = kr.fixed_order_reduce(a, op, 1)
    for lo, hi in ((0, 3001), (1, 2), (3, 40), (777, 941), (2999, 3001),
                   (4, 1028)):
        assert torch.equal(full0[lo:hi], kr.fixed_order_reduce(
            a[:, lo:hi], op, 0))
        assert torch.equal(full1[lo:hi], kr.fixed_order_reduce(
            a[lo:hi], op, 1))
    b = _reduce_operand(card, (1024, 6, 700), 8)
    full = kr.fixed_order_reduce(b, op, 0)
    for lo, hi in ((0, 7), (161, 190), (693, 700)):
        assert torch.equal(full[:, lo:hi], kr.fixed_order_reduce(
            b[:, :, lo:hi], op, 0))


@pytest.mark.cuda
def test_reduce_is_the_route_of_float32_sums(card):
    """``st.sum``/``st.mean``/``st.prod`` of float32 along an axis on the
    card launch the kernel once and give its bits, the incremental flag
    on or off; an integer mean takes it in its float32 cast; a whole
    reduction, an integer sum and float16 and float64 sums keep torch's
    reductions; a float64 operand is refused by the kernel."""
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.kernels import reduce as kr
    from spartan_tpu_torch.utils.config import FLAGS

    st.set_default_device(card)
    a = _reduce_operand(card, (4096, 2048), 9)
    prev = FLAGS.incremental
    try:
        for on in (False, True):
            FLAGS.incremental = on
            for op in ("sum", "mean", "prod"):
                for axis in (0, 1):
                    before = kr.LAUNCHES["fixed_order_reduce"]
                    got = getattr(st, op)(from_tensor(a), axis=axis)
                    got = got.evaluate().tensor
                    assert kr.LAUNCHES["fixed_order_reduce"] == before + 1
                    assert torch.equal(got, kr.fixed_order_reduce(a, op,
                                                                  axis))
    finally:
        FLAGS.incremental = prev
    ints = (a * 100).to(torch.int32)
    before = kr.LAUNCHES["fixed_order_reduce"]
    got = st.mean(from_tensor(ints), axis=0).evaluate().tensor
    assert kr.LAUNCHES["fixed_order_reduce"] == before + 1
    assert torch.equal(got, kr.fixed_order_reduce(ints.float(), "mean", 0))
    before = kr.LAUNCHES["fixed_order_reduce"]
    st.sum(from_tensor(a)).evaluate()
    st.sum(from_tensor(ints), axis=0).evaluate()
    st.sum(from_tensor(a.half()), axis=0).evaluate()
    # from_tensor keeps a float64 tensor's dtype (from_numpy casts it)
    got = st.sum(from_tensor(a.double()), axis=0).evaluate().tensor
    torch.cuda.synchronize()
    assert kr.LAUNCHES["fixed_order_reduce"] == before
    assert got.dtype == torch.float64
    with pytest.raises(TypeError):
        kr.fixed_order_reduce(a.double(), "sum", 0)


@pytest.mark.cuda
def test_reduce_batching_rule_launches_once_a_client(card):
    from spartan_tpu_torch.kernels import reduce as kr

    xs = _reduce_operand(card, (4, 1000, 513), 10)
    before = kr.LAUNCHES["fixed_order_reduce"]
    got = torch.func.vmap(lambda t: kr.fixed_order_reduce(t, "sum", 0))(xs)
    torch.cuda.synchronize()
    assert kr.LAUNCHES["fixed_order_reduce"] == before + 4
    assert torch.equal(got, torch.stack([kr.fixed_order_reduce(x, "sum", 0)
                                         for x in xs]))


@pytest.mark.cuda
def test_served_inner_sums_keep_the_full_walks_bits(card):
    """C47: torch's own sum along the inner axis of a 16,384^2 operand
    on the card need not give a few rows the bits the whole sum gives
    them (a narrow output splits each row over blocks), and the engine
    restricts an inner sum to its dirty rows. Through the fixed-order
    kernel every warm sum, restricted to windows of 1, 7 and 164 rows, is
    served bit-equal to a full walk, one launch each."""
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.expr import incremental as inc
    from spartan_tpu_torch.kernels import reduce as kr
    from spartan_tpu_torch.utils.config import FLAGS

    st.set_default_device(card)
    n = 16_384
    gen = torch.Generator(device=card)
    gen.manual_seed(11)
    prev = (FLAGS.incremental, FLAGS.result_cache_bytes)
    FLAGS.incremental, FLAGS.result_cache_bytes = True, 4 << 30
    try:
        arr = from_tensor(torch.rand((n, n), generator=gen, device=card))
        st.sum(arr, 1).evaluate()
        hits = st.metrics()["counters"].get("incremental_hits", 0)
        for lo, w in ((5, 1), (777, 7), (3000, 164)):
            arr = arr.update((slice(lo, lo + w), slice(0, n)),
                             torch.rand((w, n), generator=gen, device=card))
            before = kr.LAUNCHES["fixed_order_reduce"]
            got = st.sum(arr, 1).evaluate().tensor
            assert kr.LAUNCHES["fixed_order_reduce"] == before + 1
            FLAGS.incremental = False
            want = st.sum(from_tensor(arr.tensor.clone()), 1).evaluate()
            FLAGS.incremental = True
            assert torch.equal(got, want.tensor)
        assert st.metrics()["counters"]["incremental_hits"] == hits + 3
    finally:
        FLAGS.incremental, FLAGS.result_cache_bytes = prev
        inc.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_inner_sums_outside_the_kernel_keep_reduction_order(card, dtype):
    """C47 beyond float32: an inner-axis sum the kernel does not take
    (torch's reduction, which may split a row over blocks by the
    output's size) is not restricted on the card. Each warm sum after a
    write of 7 rows falls back under ``reduction-order``, launches no
    kernel and gives the full walk's bits. (bfloat16 takes the same
    rule, ``tests/test_torch_fixed_reduce.py``; a bfloat16 array's
    numpy dtype needs ``ml_dtypes`` registered, which the card's
    environment does not promise.)"""
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.expr import base
    from spartan_tpu_torch.expr import incremental as inc
    from spartan_tpu_torch.kernels import reduce as kr
    from spartan_tpu_torch.utils.config import FLAGS

    st.set_default_device(card)
    n = 4096
    gen = torch.Generator(device=card)
    gen.manual_seed(12)
    prev = (FLAGS.incremental, FLAGS.result_cache_bytes)
    FLAGS.incremental, FLAGS.result_cache_bytes = True, 4 << 30
    try:
        arr = from_tensor(torch.rand((n, n), generator=gen,
                                     device=card).to(dtype))
        st.sum(arr, 1).evaluate()
        for lo in (5, 777):
            arr = arr.update((slice(lo, lo + 7), slice(0, n)),
                             torch.rand((7, n), generator=gen,
                                        device=card).to(dtype))
            before = kr.LAUNCHES["fixed_order_reduce"]
            got = st.sum(arr, 1).evaluate().tensor
            assert kr.LAUNCHES["fixed_order_reduce"] == before
            plan = base.lookup_plan(base.plan_signature(st.sum(arr, 1))[0])
            rep = (plan.report or {}).get("incremental") or {}
            assert rep.get("fallback") == "reduction-order", rep
            FLAGS.incremental = False
            want = st.sum(from_tensor(arr.tensor.clone()), 1).evaluate()
            FLAGS.incremental = True
            assert torch.equal(got, want.tensor)
    finally:
        FLAGS.incremental, FLAGS.result_cache_bytes = prev
        inc.clear()
