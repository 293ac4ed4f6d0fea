"""The port's CUDA kernels on the card: each against its plain torch
version, and the wrapper's refusal to fall back.

These tests need an NVIDIA card and ``nvcc``; elsewhere they skip. The
file imports no JAX, so on a machine with a card and without JAX it
runs on its own::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

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
