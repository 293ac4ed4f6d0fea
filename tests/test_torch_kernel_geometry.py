"""The launch geometry of the port's hand-written kernels, computed in
Python on the CPU: the top-k kernel's chunking, the k-means kernel's
staging, shared memory and grid, and the histogram kernel's plan."""

import pytest

from spartan_tpu_torch.kernels import build as kbuild
from spartan_tpu_torch.kernels import histogram as khist
from spartan_tpu_torch.kernels import kmeans as kkm
from spartan_tpu_torch.kernels import topk as ktopk


@pytest.mark.parametrize("rows,m,sms", [
    (8, 2 ** 23, 132), (8, 2 ** 23, 114), (1, 7, 132), (3, 60, 132),
    (2, 3 * 16384 + 5, 132), (5, 131_075, 132), (65535, 100, 132),
    (600, 50_000, 132), (1, 2 ** 31 - 1, 132), (4, 4096, 132),
    (4, 4097, 132), (16, 1_000_003, 1)])
def test_topk_chunks_cover_every_key_once(rows, m, sms):
    chunk, chunks = ktopk._chunking(rows, m, sms)
    assert chunk % ktopk._STEP == 0 and chunks >= 1
    # chunk c takes keys [c * chunk, min((c + 1) * chunk, m)): together
    # every key once, and no chunk is empty
    assert (chunks - 1) * chunk < m <= chunks * chunk
    # about _CTAS_PER_SM CTAs per SM over all rows (one wave), one per
    # row when rows alone fill the card
    assert rows * chunks <= max(rows, ktopk._CTAS_PER_SM * sms)
    # pass 2 weighs chunks * k words per row, within the kernel's limit
    assert chunks * ktopk.MAX_K < 2 ** 31


def test_topk_chunking_at_the_main_path_shape():
    # 2^26 keys over 8 logical shards on a 132-SM H100: 64 chunks of
    # 2^17 keys per row, 512 CTAs (four per SM), and 8,192 pass-2 words
    # per row, 8 CTAs of 1024 words and then one
    assert ktopk._chunking(8, 2 ** 23, 132) == (2 ** 17, 64)


@pytest.mark.parametrize("n", [1025, 3001, 2 ** 17, 147_456, 2 ** 31 - 1])
def test_topk_sample_spans_the_chunk(n):
    # runs of keys inside the chunk, the first at its first key and the
    # last at its last, so a sorted chunk has its answer in the sample
    runs = ktopk._sample_runs(n)
    assert len(runs) == ktopk._RUNS and runs == sorted(runs)
    assert runs[0] == 0 and runs[-1] + ktopk._RUN_LEN == n
    assert all(b - a >= ktopk._RUN_LEN for a, b in zip(runs, runs[1:]))


def test_topk_small_chunk_seeds_from_every_key():
    assert ktopk._sample_runs(ktopk._RUNS * ktopk._RUN_LEN) == []


# -- the k-means pass (csrc/kmeans.cu) ---------------------------------


def test_kmeans_limits_are_unchanged():
    # the selection rule's answers (registry._sel_kmeans reads them)
    for d, k in [(128, 64), (128, 128), (128, 224), (256, 64), (1024, 16),
                 (1024, 28)]:
        assert kkm.cuda_limits(d, k) == ""
    for d, k in [(128, 225), (512, 128), (1024, 29)]:
        assert "shared memory" in kkm.cuda_limits(d, k)
    assert kkm.cuda_limits(1152, 1)


@pytest.mark.parametrize("d,k", [(128, 1), (128, 64), (128, 224),
                                 (256, 112), (640, 40), (1024, 28)])
def test_kmeans_kernel_fits_where_the_rule_accepts(d, k):
    # the kernel's footprint without the staged ring never exceeds the
    # rule's, so a shape the selection accepts always launches
    assert kkm.cuda_limits(d, k) == ""
    assert kkm._smem_bytes(d, k) <= kkm._rule_bytes(d, k) <= kkm._SMEM_LIMIT


@pytest.mark.parametrize("rows,per_sm,sms", [
    (1_000_000, 1, 132), (0, 1, 132), (1, 1, 132), (128, 2, 132),
    (129, 1, 132), (131_072, 3, 114)])
def test_kmeans_grid_covers_every_tile(rows, per_sm, sms):
    grid = kkm._grid_size(rows, per_sm, sms)
    tiles = -(-rows // kkm._TILE)
    assert 1 <= grid <= max(1, per_sm * sms)
    # grid-stride over tiles: CTA b takes tiles b, b + grid, ...; each
    # tile once, and no CTA without a tile unless there are none
    taken = sorted(t for b in range(grid) for t in range(b, tiles, grid))
    assert taken == list(range(tiles))
    assert grid <= max(tiles, 1)


# -- the histogram kernel (csrc/histogram.cu) ----------------------------

# the last length that keeps one sub-histogram per warp, and the first
# that does not
_L = khist._SHARED_BUDGET // (4 * khist._WARPS)


@pytest.mark.parametrize("length", [1, 64, _L, _L + 1, 4096])
@pytest.mark.parametrize("e", [1, 2 ** 26, 2 ** 31 - 1])
def test_bincount_plan(length, e):
    # the selection accepts this length, so its sub-histograms fit the
    # shared memory one block may have
    assert khist.cuda_limits(length, e) == ""
    # misalignments and card sizes (one CTA, an H100 SXM's, an H100
    # PCIe's) as a few explicit cases
    for misalign, slots in ((0, 8 * 132), (1, 1), (3, 6 * 114)):
        plan = khist._plan(length, e, misalign, slots)
        assert 1 <= plan.copies <= khist._WARPS
        assert 4 * length * plan.copies <= kbuild.SMEM_PER_BLOCK
        # every id once: the head up to the first 16-byte boundary,
        # whole vectors from there, then fewer than one vector
        assert plan.head + 4 * plan.nvec + plan.tail == e
        assert 0 <= plan.head < 4 and 0 <= plan.tail < 4
        assert (misalign + plan.head) % 4 == 0 or plan.head == e
        # chunks of _THREADS * _VECS vectors walked grid-stride: CTA b
        # takes chunks b, b + ctas, ...; each chunk once, every CTA at
        # least one chunk when there are any, no more CTAs than fit
        chunk = khist._THREADS * khist._VECS
        chunks = -(-plan.nvec // chunk)
        assert 1 <= plan.ctas <= max(1, min(slots, chunks))
        if chunks <= 4096:
            taken = sorted(c for b in range(plan.ctas)
                           for c in range(b, chunks, plan.ctas))
            assert taken == list(range(chunks))
    # int32 counters: the wrapper refuses 2**31 ids, so no counter can
    # pass its width
    assert khist.cuda_limits(length, 2 ** 31) != ""


def test_bincount_routes():
    # one route counts every length: every accepted length has a layout
    # of sub-histograms that fits, and the histogram path's 64 buckets
    # keep one per warp
    for length in range(1, 4097):
        assert khist.cuda_limits(length, 10) == ""
        assert 4 * length * khist._copies(length) <= kbuild.SMEM_PER_BLOCK
    assert khist._copies(64) == khist._WARPS
    assert khist._copies(_L) == khist._WARPS > khist._copies(_L + 1)
    # direct calls the limits accept, up to 58,112 buckets, fit too
    assert khist.cuda_limits(58112, 10) == ""
    assert 4 * 58112 * khist._copies(58112) <= kbuild.SMEM_PER_BLOCK
