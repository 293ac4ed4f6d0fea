"""Drive the PyTorch/CUDA port (``spartan_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the result line:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every CUDA source of ``spartan_tpu_torch/csrc`` with
   nvcc for sm_90a, one nvcc per source, all at once, and prints each
   kernel's registers and spills, and the bincount kernel's
   sub-histograms and CTAs an SM at the path's lengths;
3. kernel vs plain: each kernel against its plain torch version on the
   card, at the main paths' shapes and at edge shapes, and each kernel
   rerun against its first run bit for bit;
4. main path, dense dot chain: bench.py's 4096^2 f32 chain through
   ``st.loop``/``evaluate``/``glom``, checked against float64 numpy;
5. main path, k-means: ``examples.kmeans.kmeans`` at 1M x 128, k = 64,
   20 iterations, with the kernel's launch count proving the kernel ran,
   checked against the same run driven through the plain version;
6. main path, PageRank (BASELINE config 5 at bench.py's size: 1M pages x
   16 links, 10 iterations): windowed-kernel launches, ranks against the
   same iterations in float64, iterations per second and where an
   iteration's time goes;
7. main path, naive Bayes (20 classes, 2,048 features, 262,144 rows of
   counts) under ``native_kernels=on``: segment-kernel launches, tables
   bit-equal to the plain-driven fit, prediction accuracy, and the
   kernel's time at that shape beside its bound and ``index_add_``'s;
8. the segment-sum A/B at 1M x 128, k = 64 (kernel, ``index_add_``,
   one-hot product);
9. main path, sort (2^26 uniform f32 keys under a logical (8, 1) mesh):
   ``st.sort``, ``st.argsort``, ``st.median`` and ``st.percentile``
   through the sample sort, with ``partition_pack`` launches, against
   ``torch.sort`` and float64 numpy;
10. main path, top-k on the same keys: ``st.topk(x, 128)`` against a
    float64 stable-sort oracle (ties to the lowest index) and smallest-k
    on int32 data dense with ties, with ``shard_topk`` launches;
11. main path, histogram: ``st.histogram`` with and without a range and
    ``st.unique(..., return_counts=True)`` on 2^26 int32 ids, against
    numpy, with ``bincount_block`` launches; the kernel's time at each
    shape the path launches (and at two more) beside its bound and
    ``torch.bincount``'s, and a torch reduction over the same ids as
    the read floor;
12. the stencil (VGG-16 block 1) and the structure ops;
13. the application tier (``[examples]``): logistic regression at
    bench.py's size (10,000,000 x 32, 10 iterations through ``st.loop``)
    against float64 numpy, with iterations per second beside its bound
    and a device split, then linear, ridge and SVM on the same X; SSVD
    of 8192 x 512 at rank 32 (seconds, device split) and Lanczos SVD of
    the same matrix; the ``KMeans`` estimator (k-means kernel launches
    equal to ``max_iter``) and ``MultinomialNB`` (segment kernel, tables
    bit-equal to ``examples.naive_bayes.fit``); CG, fuzzy k-means,
    Cholesky, QR and TSQR; ALS, Netflix SGD and sparse SGD matrix
    factorization at MovieLens-100K's shape; LDA and LSH; each against
    float64 or its plain-version run;
14. ``[masked]``: a sensor matrix of 8 x 2^23 f32 with 1% NaN
    (``masked_invalid``) and 5% more masked (``masked_where``): count,
    sum, mean, var, std, min and max per row and whole, the median, sort
    and argsort per row, and a masked GEMM of two 4096^2 matrices, against
    float64 on the card and ``numpy.ma`` for one whole row, with ms per
    call and the peak memory;
15. ``[checkpoint]``: save and load of the k-means points (8 blobs on a
    logical (8, 1) mesh) and of a replicated 4096^2 matrix (1 blob):
    bit-equal round trips, CRCs verified, a flipped byte refused, GB/s by
    host clock, through the blob I/O pool built with g++;
16. ``[ckpt_loop]``: BASELINE config 3 through ``st.loop(...,
    checkpoint_every=5)``: exactly 20 k-means launches and the
    uninterrupted loop's bits, one restore after an injected transient
    fault, and a child process killed by SIGKILL after its iteration-10
    snapshot, resumed to 20 here, all bit-equal; iterations per second
    with and without snapshots;
17. ``[streaming]``: ``OnlineKMeans`` (16 mini-batches, then ``refine``
    over the 1M points: 5 k-means launches, against the plain-driven
    refine), ``SlidingWindowStats`` over a 512 MiB window and
    ``IncrementalPageRank`` on a dense 16,384^2 transition, against
    float64;
18. ``[planner]``: bench.py's dot chain (4096^2, K = 64) and BASELINE
    config 3 k-means under logical (4, 2) and (8, 1) meshes with the
    smart-tiling pass on and off: bit-equal results, exactly 20 k-means
    launches each, the chosen tilings, one plan miss per structure and
    hits after it, the planning ms per miss, GFLOPS and iterations per
    second; k-means with spans and metrics on against both off; an
    explicit redistribution (``apply_schedule``) of the k-means points
    from rows to columns, bit-equal; and the host split (``sign``,
    ``optimize``, ``build``, ``dispatch``) of one ``st.histogram`` call
    and one VGG-block forward from the span ring, exported as a Chrome
    trace and parsed back;
18a. ``[obs]``: observability on config 3 (the ``[kmeans]`` points) on
    a logical (4, 2) mesh: ``st.explain`` of one ``kmeans_step`` (the
    kernel node on ``cuda``, the committed tilings, the counted
    ``cost_analysis`` whose kernel share must equal ``[kmeans]``'s
    count) and of the 4096^2 chain's first miss; ``st.profile`` of the
    step in the capture and replay tiers (the k-means node within 25% of
    ``[kmeans]``'s CUDA-event time; the captures, of the step and of the
    VGG forward, in a young child process, which must answer from the
    profiler's device records) and of the VGG forward (each
    ``conv_block`` in its node within 25% of the ``[stencil]`` time);
    ``st.audit`` clean and with one planted NaN (named at its leaf);
    ``st.loop(health=True)`` over 20 iterations (20 launches, bit-equal,
    a 20-long series) and ``early_exit`` at a ``stall_tol`` set from that
    series; config-3 iterations/s with trace + metrics + ledger on
    against off (at most 5% apart) and at ``profile_sample_every=10``;
    a calibration from the ledger (one plan miss, bit-equal);
19. ``[spmd]``: the explicit SPMD layer. On the thread runner
    (``parallel/shard_map.py``, one thread per position of a logical
    mesh): ``dot_shardmap`` of bench.py's 4096^2 pair on (4, 2) against
    float64, with GFLOPS beside ``st.dot``'s; ``shard_map2`` with a
    per-row-block nearest-center argmin over the config-3 points on
    (8, 1), equal to the whole-array kernel; every collective on (8, 1)
    and (4, 2), bit-equal to its definition (sums to a left fold in
    position order). Ring, Ulysses and blockwise attention at L = 16,384,
    H = 16, D = 128 f32 on (8, 1), causal and not, against blockwise in
    float64, with ms and peak memory. The GPipe pipeline (8 stages of
    width 4096, 32 microbatches of 512 rows): ``pipeline_apply`` and
    ``pipeline_grad`` against the sequential stack in float64. The group
    runner: two processes sharing the card over gloo (``--spmd-child``)
    run config-3 k-means (20 launches per rank, centers bit-equal across
    ranks and to the thread runner's (2, 1) run), ``segment_sum_sharded``
    at the naive-Bayes shape, ``bincount_sharded`` on 2^26 ids and the
    VGG-16 block with H split over the ranks, each kernel launched once
    per rank per call, with the host-staged collective counts; then a
    one-rank nccl group in this process: every collective, nothing
    staged, config-3 k-means bit-equal to the one-pass run and a 4096^2
    ``st.dot`` under local-shard storage bit-equal to the logical mesh's,
    nothing gathered whole;
20. ``[local]``: local-shard storage at full width, two processes
    sharing the card over gloo (``--local-child``), each holding only
    its blocks: config-3 k-means (1,000,448 x 128, k = 64, 20
    iterations through ``st.from_numpy`` -> ``st.loop`` -> ``glom``):
    the points' bytes on each rank (its 500,224 rows), 20 launches per
    rank, centers bit-equal across ranks and within 1e-4 of the
    one-process run; BASELINE config 2's 8192^2 ``st.dot`` under the
    committed plan (the plan, the bytes received, the peak memory
    against the one-process peak, GFLOPS, the error against float64 on
    1024 rows); ``st.sort``/``st.argsort``/``st.topk(x, 128)`` of 2^26
    keys bit-equal to ``torch.sort`` and the one-pass top-k, with 1, 2
    and 1 kernel launches per rank; 10 PageRank iterations over the
    sharded SpMV (10 ``windowed_segsum`` launches per rank) within 1e-6
    of the one-process run; ``retile`` of a 4096^2 array between every
    pair of {row, col, block, replicated}, bit-equal, with the bytes
    each rank received; ``calibrate_flop_weight`` over the group. No
    path gathers an array whole (``group_materialize_calls`` stays 0);
21. ``[resilience]``: config 3 (1,000,448 x 128, k = 64, 20 iterations,
    a snapshot every 5) on a logical (4, 2) mesh under ``st.chaos``:
    ``transient@1`` retried by the policy engine (bit-equal),
    ``oom@1`` through the ladder's ``finer_tiling`` rung (within 1e-5),
    one real ``torch.cuda.OutOfMemoryError`` inside an evaluate
    (classified ``oom``; the next evaluate succeeds) and
    ``device_loss@2``: the mesh rebuilt to (7, 1) at epoch 1, the
    points rehomed through ``plan_rehome`` (route and modelled bytes
    printed), the loop resumed from its iteration-10 snapshot, bit-equal
    to a clean resume of a copy of it on (7, 1), with the k-means
    launches of both counted and the recovery's spans in ms;
22. ``[elastic_group]``: two gloo ranks sharing the card
    (``--elastic-child``, local storage) run config 3 with its labels as
    a second carry, checkpointed every 5; rank 1 is SIGKILLed once
    ``LATEST.json`` reads step 10, rank 0 must exit nonzero within the
    group's timeout with the failure classified ``fatal_mesh``; the
    snapshot holds a blob of each rank and no gather at site
    ``checkpoint``; a one-process survivor world resumes it (a
    ``restore`` migration from {x: 2, y: 1} to {x: 1, y: 1}, 10 k-means
    launches), bit-equal to a clean one-process resume of a copy;
23. ``[guards]``, the plan guards. ``[audit]``: two gloo ranks sharing
    the card (``--guards-child``) audit config 2's 8192^2 ``st.dot``,
    ``st.sort`` of 2^26 keys and a config-3 k-means step; each audit's
    collectives and operand bytes must equal what the walk then counts
    in ``collective_calls``/``collective_bytes``, its ``full_gather``
    findings the walk's ``group_materialize_calls`` sites (none for
    k-means). ``[memory]``: predicted ``peak_bytes_card`` against the
    measured walk (within 25%) for the dot on each rank, a config-3
    ``kmeans_step`` on (4, 2), the 4096^2 chain's first plan, the 8192^2
    dot on a logical (4, 2) mesh and the VGG-16 block-1 forward, each
    walk measured keeping every value and freeing each at its last
    consumer; then on the ranks a budget between the dot's predicted
    peak and the ``finer_tiling`` rung's: the governor takes the rung
    before the walk, no OOM raised, bit-equal to the rung forced.
    ``[persist]``: three fresh processes on one store
    (``--persist-child``) each run the 4096^2 chain and config-3
    ``kmeans()`` on (4, 2) and (8, 1): the first stores, the second
    reads every plan back with 0 DP runs, bit-equal (planning ms cold
    and warm), and after one stored file is corrupted the third rejects
    that entry (``crc``) and plans it again, bit-equal.
    ``[integrity]``: config-3 k-means on (4, 2) under
    ``FLAGS.integrity_check`` (every 5th walk re-walked on a rotated
    mesh) with position 6 corrupting three sampled walks: each caught,
    no corrupt result returned, the position quarantined at 3 strikes,
    the arrays rehomed, the centers bit-equal to a clean run through the
    same quarantine, the k-means launches equal to walks + re-walks;
    iterations/s with the check on and off;
23a. ``[serve]``, the serving front end. 16 client threads each submit
    4 config-3 ``kmeans_step`` requests (the ``[kmeans]`` points, shared;
    each client's centers the initial centers plus a seeded
    perturbation) through one ``ServeEngine``: every served result
    bit-equal to its serial ``evaluate()``, the plan still in ``vmap``
    mode with no demotion or solo fallback, every batch of a
    power-of-two size, and exactly one k-means launch per served
    request in the served window (the operator's batching rule). The
    4096^2 dot chain's ``(x @ y).sum() * s`` with shared ``x``, ``y`` and
    a scalar per request, served and in a serial loop: values bit-equal,
    requests/s of each and their ratio, and the p50/p99 of each
    request's queue wait, coalesce wait, dispatch and fetch seconds from
    the flight records (printed, not gated). Admission: ``Backpressure``
    past the high-water mark (with a positive ``retry_after_s``), a
    memory reject under a budget below the k-means plan's
    ``request_bytes``, a shed at a 1 us deadline and a
    ``CommBudgetExceeded`` for an audited k-split dot at
    ``comm_budget_bytes = 1``, each named in its flight record. The
    elastic drain: ``device_loss`` chaos on a logical (4, 2) mesh fails
    the queued requests with ``MeshReconfiguring``; resubmitted on the
    rehomed inputs they equal a clean serial run on the rebuilt mesh.
    ``st.skew`` of a config-3 step on a logical (8, 1) mesh and in two
    gloo ranks sharing the card (``--skew-child``), each rank's seconds
    folded: per-position seconds, the imbalance ratio and the points'
    data skew;
24. the ``kernels`` line (times, launches, bounds; rows 1, 3, 4 and 7
    with their launches per rank on the group path, rows 1, 2, 5 and 6
    with their launches per rank under local-shard storage, row 1 with
    the faulted run's, the survivor's, the integrity run's and the
    served window's launches) and the result line.

``python3 chip_smoke.py --ckpt-child DIR`` is the child process of
``[ckpt_loop]``, and ``python3 chip_smoke.py --spmd-child DIR RANK``,
``--local-child DIR RANK``, ``--elastic-child DIR RANK``,
``--guards-child DIR RANK`` and ``--skew-child DIR RANK`` one rank of
``[spmd]``'s, ``[local]``'s, ``[elastic_group]``'s, ``[guards]``'s and
``[serve]``'s groups, ``--obs-child DIR``
the process of ``[obs]``'s captures and ``--persist-child DIR I`` one
of ``[guards]``'s store processes; they are not meant to be run by
hand.

Imports torch, numpy and the port only.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_T_IMPORT = time.perf_counter()  # the process's age, less its start-up

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# FP32 outside the tensor cores, HBM bandwidth, TF32 on the tensor cores.
_PEAKS = {
    "H100 PCIe": (51e12, 2.0e12, 378e12),
    "H100": (67e12, 3.35e12, 495e12),  # SXM
}

KM_N, KM_D, KM_K, KM_ITERS = 1_000_000, 128, 64, 20
DOT_N, DOT_K = 4096, 64
PR_N, PR_DEG, PR_ITERS = 1_000_000, 16, 10
NB_ROWS, NB_FEATURES, NB_CLASSES = 262_144, 2048, 20
SEG_E, SEG_D, SEG_K = 1_000_000, 128, 64
SORT_N, SORT_MESH, TOPK_K = 2 ** 26, (8, 1), 128
HIST_BINS, UNIQ_SIZE, UNIQ_HIGH = 64, 4096, 3000
# VGG-16 (configuration D) block 1: batch, image side, channel widths
VGG_N, VGG_HW, VGG_WIDTHS, VGG_MESH = 32, 224, (3, 64, 64), (8, 1)
STRUCT_N, OUTER_N, EINSUM_B, EINSUM_N, SHUFFLE_N = 8192, 16384, 64, 512, 4096
# bench.py's guard sizes (BASELINE configs 4-5): logistic regression on
# 10,000,000 x 32 f32 for 10 iterations, SSVD of 8192 x 512 at rank 32
EX_LR_N, EX_LR_D, EX_LR_ITERS = 10_000_000, 32, 10
EX_SSVD_M, EX_SSVD_N, EX_SSVD_RANK = 8192, 512, 32
# smaller, stated sizes for the rest of the application tier
EX_KM_N, EX_KM_K, EX_KM_ITERS = 262_144, 64, 10
EX_CG_N, EX_CG_ITERS = 4096, 20
EX_FZ_N, EX_FZ_D, EX_FZ_K, EX_FZ_ITERS = 65_536, 32, 16, 10
EX_QR_M, EX_QR_N, EX_QR_MESH = 131_072, 64, (8, 1)
# MovieLens-100K's shape: 943 users x 1,682 items, 100,000 ratings
EX_ML_USERS, EX_ML_ITEMS, EX_ML_RATINGS, EX_ML_K = 943, 1682, 100_000, 16
EX_LDA_DOCS, EX_LDA_WORDS, EX_LDA_K, EX_LDA_ITERS = 8192, 16_384, 4, 2
EX_LSH_N, EX_LSH_D, EX_LSH_BITS, EX_LSH_PAIRS_N = 1_000_000, 128, 64, 4096
# [planner]: the logical meshes the tiling DP plans for, timed reps, and
# the steady-state calls the host split of a plan walk averages over
PLAN_MESHES, PLAN_REPS, SPLIT_CALLS = ((4, 2), (8, 1)), 3, 5
# [spmd]: the thread runner's meshes and collective blocks, attention,
# the pipeline, and the group of processes sharing the card
SPMD_DOT_MESH, SPMD_KM_MESH = (4, 2), (8, 1)
SPMD_COLL_MESHES, SPMD_COLL_BLOCK = ((8, 1), (4, 2)), (1024, 1024)
ATT_L, ATT_H, ATT_D, ATT_MESH, ATT_BLOCK = 16384, 16, 128, (8, 1), 512
PIPE_STAGES, PIPE_WIDTH, PIPE_MICRO, PIPE_ROWS = 8, 4096, 32, 512
GROUP_RANKS, GROUP_TIMEOUT_S = 2, 600
# [local]: BASELINE config 3's points padded to whole 1024-row blocks of
# 8 row shards (1,000,448 rows, 500,224 a rank of 2), BASELINE config
# 2's 8192^2 product, the retile array and its layouts on the 2 x 1
# group mesh (block is ("x", "y") with one rank on y)
LOCAL_KM_N, LOCAL_DOT_N, LOCAL_RETILE_N = 1_000_448, 8192, 4096
LOCAL_LAYOUTS = {"row": ("x", None), "col": (None, "x"),
                 "block": ("x", "y"), "rep": (None, None)}
LOCAL_CAL_N = 1024
# [resilience]: config 3 on a logical (4, 2) mesh; [elastic_group]: the
# gloo group's timeout, the parent's wait for a world, and the sleep
# each dispatch of the world that loses a rank takes (so the kill lands
# inside the loop)
RES_MESH = (4, 2)
ELASTIC_TIMEOUT_S, ELASTIC_JOIN_S, ELASTIC_SLOW_S = 60, 240, 0.5
# [guards]: the memory model's gate (|predicted / measured - 1| of a
# card peak, the JAX package's tests/test_memory_governor.py:72-100), the
# integrity sentinel's cadence, strike count and corrupting position; the
# cadence samples the k-means step plan's 5th, 10th and 15th runs, and a
# violation's retry is a run, so walk occurrences 4, 9 and 14 are sampled
GUARD_MEM_TOL = 0.25
GUARD_SAMPLE, GUARD_STRIKES, GUARD_VICTIM = 5, 3, 6
GUARD_SDC = "sdc@4#6,sdc@9#6,sdc@14#6"
# pairs of 20-iteration runs, check off then on, for its cost
GUARD_IPS_PAIRS = 5
# [serve]: client threads and requests each (k-means, then the dot), the
# waits of a served request and of the gloo children
SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_WAIT_S = 16, 4, 300


def _say(*args) -> None:
    print(*args, flush=True)


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _peak_row(name: str):
    for key, peaks in _PEAKS.items():
        if key in name:
            return peaks
    _fail(f"no published peaks for {name!r}")


def _peaks(name: str):
    """FP32 FLOP/s and HBM bytes/s of the card."""
    return _peak_row(name)[:2]


def _tf32_peak(name: str) -> float:
    """Dense TF32 FLOP/s of the card's tensor cores."""
    return _peak_row(name)[2]


def _event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one ``fn()`` over ``reps`` back-to-back
    calls, by CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 1 ------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    _say(card)
    _say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
         f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


# -- phase 2 ------------------------------------------------------------


def phase_build(build_mod, libs) -> None:
    t0 = time.perf_counter()
    names = build_mod.sources()
    paths = build_mod.build_all(names)
    for load in libs:
        load()
    _say(f"[build] {len(names)} sources ({', '.join(names)}) in "
         f"{time.perf_counter() - t0:.2f} s, one nvcc each, in parallel")
    for name in names:
        _say(f"[build] {os.path.relpath(paths[name])}")
        for line in build_mod.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling entry" in line:
                _say(f"[build] {name}: {line.strip()}")
    _say("[build] stencil routes: C <= 4 -> conv_kernel (SIMT, FP32 FMAs); "
         "C > 4 -> conv_mma_kernel<S> (3xTF32 mma.sync, S cp.async "
         "staging slots, 2 where they fit)")


def _histogram_layout(kh, dev) -> None:
    """The bincount kernel at the path's lengths and at the last and first
    length of the copy count's step: its int32 sub-histograms a CTA and
    CTAs an SM (the occupancy query); the ptxas lines above give its
    registers."""
    lib = kh._load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    last = kh._SHARED_BUDGET // (4 * kh._WARPS)
    for length in (HIST_BINS, last, last + 1, UNIQ_SIZE):
        slots = kh._card_slots(lib, dev, length)
        plan = kh._plan(length, SORT_N, 0, slots)
        _say(f"[build] histogram length {length}: bincount_kernel, "
             f"{plan.copies} int32 sub-histogram(s) of {length} a CTA, "
             f"{slots // sms} CTAs an SM, {plan.ctas} CTAs at e = {SORT_N}")


# -- phase 3 ------------------------------------------------------------


def _data(n: int, d: int, k: int, kind: str, seed: int):
    """Points, initial centers and the true labels (None for uniform
    data)."""
    rng = np.random.RandomState(seed)
    if kind == "clustered":
        # well separated: true centers ~18 apart, noise radius ~0.6,
        # one initial center per cluster
        true = (rng.rand(k, d) * 4.0).astype(np.float32)
        lab = rng.randint(0, k, n)
        pts = true[lab] + (0.05 * rng.randn(n, d)).astype(np.float32)
        cen = true + (0.05 * rng.randn(k, d)).astype(np.float32)
    else:
        lab = None
        pts = rng.rand(n, d).astype(np.float32)
        cen = pts[rng.choice(n, k, replace=False)].copy()
    return pts.astype(np.float32), cen.astype(np.float32), lab


def _near_ties(p: torch.Tensor, c: torch.Tensor, valid: int) -> int:
    """Rows whose two best scores are closer than twice the float32
    error bound of a score (d * 2^-24 * (|c|^2 + 2 sum|p_i c_i|)): only
    there may two correct float32 evaluations pick different centers."""
    if c.shape[0] < 2:
        return 0
    n_tie = 0
    cd = c.double()
    for lo in range(0, valid, 1 << 18):
        q = p[lo:min(valid, lo + (1 << 18))].double()
        score = (cd * cd).sum(1)[None, :] - 2.0 * (q @ cd.T)
        mag = (cd * cd).sum(1)[None, :] + 2.0 * (q.abs() @ cd.abs().T)
        two = torch.topk(score, 2, dim=1, largest=False)
        err = p.shape[1] * 2.0 ** -24 * mag.gather(1, two.indices).max(1)[0]
        gap = two.values[:, 1] - two.values[:, 0]
        n_tie += int((gap <= 2.0 * err).sum().item())
    return n_tie


def _check_kernel(kk, n, d, k, valid, kind, seed, dev) -> dict:
    pts, cen, _ = _data(n, d, k, kind, seed)
    p = torch.from_numpy(pts).to(dev)
    c = torch.from_numpy(cen).to(dev)
    v = n if valid is None else valid
    s_k, n_k = kk.assign_accumulate(p, c, k, valid)
    torch.cuda.synchronize()
    again = kk.assign_accumulate(p, c, k, valid)
    rerun = bool(torch.equal(again[0], s_k) and torch.equal(again[1], n_k))
    s_p, n_p = kk.assign_accumulate_plain(p, c, k, valid)
    torch.cuda.synchronize()
    moved = int((n_k - n_p).abs().sum().item()) // 2
    err = float((s_k - s_p).abs().max().item())
    # summation order differs (blocked partials vs index_add_'s
    # atomics): the rounding error of an f32 sum of N terms grows like
    # sqrt(N) * 2^-24 * |sum|; allow four times that at the largest N
    n_max = float(n_p.max().item())
    order_tol = (4.0 * n_max ** 0.5 * 2.0 ** -24
                 * float(s_p.abs().max().item()))
    if kind == "clustered":
        allowed, tol = 0, order_tol
    else:
        allowed = _near_ties(p, c, v)
        tol = order_tol + allowed * float(p[:v].abs().max().item())
    ok = (moved <= allowed and err <= tol and rerun
          and int(n_k.sum().item()) == v)
    _say(f"[kernel] n={n} d={d} k={k} valid={v} {kind}: moved rows "
         f"{moved} (allowed {allowed}), max |sum err| {err:.3g} "
         f"(tol {tol:.3g}), rerun bit-equal {rerun} -> "
         f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        _fail(f"kernel disagrees with its plain version at n={n} d={d} "
              f"k={k} valid={v} ({kind})")
    return {"err": err}


def phase_kernel_vs_plain(kk, dev) -> float:
    main = _check_kernel(kk, 1_000_448, KM_D, KM_K, KM_N, "clustered", 1,
                         dev)
    _check_kernel(kk, 1_000_448, KM_D, KM_K, KM_N, "uniform", 2, dev)
    _check_kernel(kk, 131_072, 128, 64, 130_001, "uniform", 3, dev)
    _check_kernel(kk, 131_072, 128, 128, None, "uniform", 4, dev)
    _check_kernel(kk, 131_072, 128, 1, None, "uniform", 5, dev)
    _check_kernel(kk, 131_072, 256, 64, None, "uniform", 6, dev)
    _check_kernel(kk, 131_072, 256, 64, 100_000, "clustered", 7, dev)
    _check_kernel(kk, 131_072, 128, 7, 100_003, "clustered", 8, dev)
    _check_kernel(kk, 131_072, 1024, 16, 100_003, "clustered", 9, dev)
    return main["err"]


# -- phase 4 ------------------------------------------------------------


def _build_chain(st, ea, eb, k):
    """bench.py's ``_build``: the dot chain with a renorm every 8th
    hop (every hop when k is not a multiple of 8)."""
    def renorm(c):
        return c / st.absolute(c).max()

    if k % 8 == 0:
        def body8(c):
            for _ in range(8):
                c = st.dot(c, eb)
            return renorm(c)

        return st.loop(k // 8, body8, ea).sum()

    def body(c):
        return renorm(st.dot(c, eb))

    return st.loop(k, body, ea).sum()


def phase_dot(st, card: str) -> None:
    rng = np.random.RandomState(0)
    a = rng.rand(DOT_N, DOT_N).astype(np.float32)
    b = rng.rand(DOT_N, DOT_N).astype(np.float32)
    ea, eb = st.from_numpy(a), st.from_numpy(b)

    # correctness: K = 2 against float64 numpy; the float32 chain
    # carries ~1e-6 relative error per product, so rtol 1e-4
    got = float(_build_chain(st, ea, eb, 2).glom())
    ref = a.astype(np.float64)
    for _ in range(2):
        ref = ref @ b.astype(np.float64)
        ref = ref / np.abs(ref).max()
    want = float(ref.sum())
    rel = abs(got - want) / abs(want)
    _say(f"[dot] K=2 chain sum {got!r} vs float64 {want!r}: rel err "
         f"{rel:.3g} (rtol 1e-4)")
    if not rel <= 1e-4:
        _fail("dot chain disagrees with float64 numpy")

    def run() -> float:
        t0 = time.perf_counter()
        val = float(_build_chain(st, ea, eb, DOT_K).glom())
        if not np.isfinite(val):
            _fail(f"dot chain result {val} is not finite")
        return time.perf_counter() - t0

    st.reset_plan_stats()
    run()  # first run: plan miss
    best = min(run() for _ in range(3))
    stats = st.plan_stats()
    if stats["plan_hits"] < 3 or stats["plan_misses"] != 1:
        _fail(f"dot chain did not hit the plan cache: {stats}")
    gflops = 2.0 * DOT_N ** 3 * DOT_K / best / 1e9
    _say(f"[dot] {DOT_N}^2 f32 chain K={DOT_K}: {gflops:.1f} GFLOPS "
         f"(best of 3, {best * 1e3:.1f} ms) on {card}; plan hits "
         f"{stats['plan_hits']} misses {stats['plan_misses']}")


# -- phase 5 ------------------------------------------------------------


def _plain_kmeans(kk, pts, c0, k, iters, valid):
    c = c0
    for _ in range(iters):
        s, n = kk.assign_accumulate_plain(pts, c, k, valid)
        c = s / torch.clamp_min(n, 1.0)[:, None]
    return c


def _library(p, c, k, valid):
    """Composite yardstick (no single PyTorch call computes the fused
    pass): cdist + argmin + index_add_."""
    q = p[:valid]
    a = torch.cdist(q, c).argmin(1)
    s = torch.zeros_like(c).index_add_(0, a, q)
    n = torch.zeros((k,), device=p.device).index_add_(
        0, a, torch.ones((valid,), device=p.device))
    return s, n


def phase_kmeans(st, kk, km, card: str, dev) -> dict:
    # BASELINE config 3's size on well-separated clusters with one
    # initial center per cluster: every row has one clear nearest
    # center, so the kernel-driven and the plain-driven runs assign
    # alike in every iteration (on uniform data, near-tie rows flip
    # and the two 20-step trajectories drift apart by ~1e-2)
    pts_np, c0_np, labels = _data(KM_N, KM_D, KM_K, "clustered", 0)
    points = st.from_numpy(pts_np)

    _reset_counts(kk)
    t0 = time.perf_counter()
    centers, assign = km.kmeans(points, KM_K, num_iter=KM_ITERS,
                                centers=c0_np)
    wall = time.perf_counter() - t0
    launches = kk.LAUNCHES
    _say(f"[kmeans] kmeans() {KM_N}x{KM_D} k={KM_K} {KM_ITERS} iters: "
         f"{wall:.3f} s wall, kernel launches {launches}")
    if launches < KM_ITERS:
        _fail(f"the k-means kernel ran {launches} times, want >= "
              f"{KM_ITERS}")
    if centers.shape != (KM_K, KM_D) or not np.isfinite(centers).all():
        _fail("k-means centers have the wrong shape or are not finite")
    if not np.array_equal(assign, labels):
        _fail(f"k-means did not recover the clusters: "
              f"{int((assign != labels).sum())} rows mislabelled")

    # the same run through the plain version on the card
    npad = km._kernel_pad(KM_N)
    pts = points.value.tensor
    p = torch.cat([pts, pts.new_zeros((npad - KM_N, KM_D))])
    c0 = torch.from_numpy(c0_np).to(dev)
    ref = _plain_kmeans(kk, p, c0, KM_K, KM_ITERS, KM_N).cpu().numpy()
    diff = float(np.abs(centers - ref).max())
    # same assignments; each center is a sum of ~15,600 rows taken in
    # another order: 4 * sqrt(15,600) * 2^-24 relative of |c| <= 4.2
    _say(f"[kmeans] all {KM_N} rows in their true cluster; final centers "
         f"vs plain-driven run: max |diff| {diff:.3g} (atol 1e-4)")
    if not diff <= 1e-4:
        _fail("k-means centers disagree with the plain-driven run")

    # iterations per second of the k-means loop (bench.py's measure)
    def loop_s() -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        kk.run(p, c0, KM_K, KM_ITERS, valid_rows=KM_N)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    loop_s()
    best = min(loop_s() for _ in range(3))
    ips = KM_ITERS / best
    # kmeans() itself: one st.loop over kmeans_step, same kernel launches
    c0_e = st.from_numpy(c0_np)
    loop_ips = KM_ITERS / (_wall_ms(lambda: st.loop(
        KM_ITERS, lambda c: km.kmeans_step(points, c, KM_K),
        c0_e).evaluate()) / 1e3)
    ms = _event_ms(lambda: kk.assign_accumulate(p, c0, KM_K, KM_N), 20)
    plain_ms = _event_ms(
        lambda: kk.assign_accumulate_plain(p, c0, KM_K, KM_N), 20)
    lib_ms = _event_ms(lambda: _library(p, c0, KM_K, KM_N), 20)
    flops_peak, bw_peak = _peaks(card)
    # the kernel's own count (kernels/kmeans.cost), which st.explain's
    # cost_analysis reports for the k-means node too
    ops, nbytes = kk.cost(KM_N, KM_D, KM_K)
    t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
    bound_ms = max(t_ops, t_bytes)
    _say(f"[kmeans] {ips:.2f} iters/s ({KM_ITERS}-iteration loop, best of 3); "
         f"st.loop over kmeans_step (kmeans()'s path) {loop_ips:.2f} "
         f"iters/s on {card}")
    _say(f"[kmeans] "
         f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
         f"{lib_ms:.4f} (composite cdist+argmin+index_add_) bound_ms "
         f"{bound_ms:.4f} ({'operations' if t_ops >= t_bytes else 'bytes'}"
         f"; ops {t_ops:.4f} ms, bytes {t_bytes:.4f} ms), kernel at "
         f"{100.0 * bound_ms / ms:.1f}% of its bound on {card}")
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "nbytes": nbytes, "loop_ips": loop_ips,
            "points": points, "padded": p, "c0": c0_np, "ref": centers}


# -- phase 3, segment kernels ---------------------------------------------

_U = 2.0 ** -24  # f32 unit roundoff


# the kernel modules whose LAUNCHES dicts count launches per kernel
# (filled by main)
_COUNTED: list = []


def _reset_counts(kk) -> None:
    """Every kernel's launch count to 0 (just before a main path)."""
    kk.LAUNCHES = 0
    for mod in _COUNTED:
        for name in mod.LAUNCHES:
            mod.LAUNCHES[name] = 0


def _windowed_args(plan) -> dict:
    return dict(rows_pad=plan.rows_pad, nsteps=plan.nsteps,
                outblk=plan.outblk, sub=plan.SUB, starts=plan._starts)


def _check_windowed(ks, plan, vals, label: str, integer: bool) -> float:
    """The windowed kernel against its plain version on one plan-ordered
    stream, and a rerun against the first run. Integer-valued streams
    must agree bit for bit; otherwise each slot is a sum of at most m
    nonnegative terms whose sum is at most S, and two f32 summation
    orders differ by at most 2 (m - 1) 2^-24 S."""
    out = ks.windowed_segsum(vals, plan._ids2d, plan._wb,
                             **_windowed_args(plan))
    torch.cuda.synchronize()
    again = ks.windowed_segsum(vals, plan._ids2d, plan._wb,
                               **_windowed_args(plan))
    ref = ks.windowed_segsum_plain(vals, plan._ids2d, plan._wb,
                                   plan.rows_pad)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max().item())
    if integer:
        tol = 0.0
    else:
        m = float(ks.windowed_segsum_plain(
            torch.ones_like(vals), plan._ids2d, plan._wb,
            plan.rows_pad).max().item())
        s_max = float(ks.windowed_segsum_plain(
            vals.abs(), plan._ids2d, plan._wb, plan.rows_pad).max().item())
        tol = 2.0 * max(m - 1.0, 0.0) * _U * s_max
    same = bool(torch.equal(out, again))
    ok = err <= tol and same and bool(torch.isfinite(out).all())
    _say(f"[kernel] windowed_segsum {label}: P={plan.padded_size} "
         f"rows_pad={plan.rows_pad} max |kernel - plain| {err:.3g} "
         f"(tol {tol:.3g}), rerun bit-equal {same} -> "
         f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        _fail(f"windowed_segsum disagrees with its plain version ({label})")
    return err


def _windowed_edge_cases(seg, dev):
    """The cases of tests/test_sparse.py:138-232 and a window-boundary
    case: (label, plan, stream, integer-valued)."""
    rng = np.random.RandomState(3)
    edges = np.sort(np.r_[np.arange(0, 5000, 7), [1023, 1024, 2047, 2048]])
    cases = [
        ("random", np.sort(rng.randint(0, 3000, 20000)), 3000,
         rng.rand(20000), False),
        ("out of range above", np.array([0, 1, 1, 5, 7, 9, 9]), 6,
         np.arange(1, 8), True),
        ("partial trailing block", np.array([5, 139999]), 140000,
         np.array([1.5, 2.0]), True),
        ("skewed into window 0", np.zeros(24576, np.int64), 256 * 1024,
         np.ones(24576), True),
        ("out of range below", np.array([-3, -1, 0, 2, 2, 5, 9]), 6,
         np.arange(1, 8), True),
        ("window edges", edges, 5000, rng.rand(edges.size), False),
    ]
    for label, ids, n, vals, integer in cases:
        plan = seg.SegmentPlan(ids.astype(np.int32), n, device=dev)
        v = torch.from_numpy(plan.reorder(vals.astype(np.float32))).to(dev)
        yield label, plan, v, integer


def _block_case(ks, e, d, k, seed, dev, integer=True,
                id_dtype=torch.int32, label="") -> float:
    """The block kernel against its plain version (the one-hot product)
    and a rerun against the first run. Integer-valued data is exact on
    both: bit-equal. Otherwise each output is a sum of at most e terms
    in [0, 1): 2 e 2^-24 |sum| bounds two orders."""
    rng = np.random.RandomState(seed)
    shape = (e,) if d is None else (e, d)
    vals = rng.randint(-8, 9, shape) if integer else rng.rand(*shape)
    v = torch.from_numpy(vals.astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.randint(-2, k + 3, e)).to(dev, id_dtype)
    out = ks.segment_sum_block(v, ids, k)
    torch.cuda.synchronize()
    again = ks.segment_sum_block(v, ids, k)
    ref = ks.segment_sum_block_plain(v, ids, k)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max().item()) if out.numel() else 0.0
    tol = 0.0 if integer else \
        2.0 * e * _U * float(ref.abs().max().item())
    same = bool(torch.equal(out, again))
    ok = err <= tol and same and tuple(out.shape) == tuple(ref.shape)
    _say(f"[kernel] segment_sum_block {label or ''}e={e} d={d} k={k} "
         f"ids {str(id_dtype).split('.')[-1]} "
         f"{'integer' if integer else 'uniform'}: max |kernel - plain| "
         f"{err:.3g} (tol {tol:.3g}), rerun bit-equal {same} -> "
         f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        _fail(f"segment_sum_block disagrees with its plain version at "
              f"e={e} d={d} k={k}")
    return err


def phase_segment_kernels(ks, seg, T, dev) -> dict:
    plan = T._ensure_plan()
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.rand(T.shape[1]).astype(np.float32)).to(dev)
    contrib = T._pdata * torch.index_select(x, 0, T._pcols)
    w_err = _check_windowed(ks, plan, contrib,
                            "PageRank plan, data * x[cols]", False)
    _check_windowed(ks, plan, torch.ones_like(contrib),
                    "PageRank plan, ones", True)
    for label, p, v, integer in _windowed_edge_cases(seg, dev):
        _check_windowed(ks, p, v, label, integer)
    b_err = _block_case(ks, SEG_E, SEG_D, SEG_K, 11, dev,
                        label="main shape ")
    _block_case(ks, 1000, 16, 12, 12, dev, id_dtype=torch.int64)
    _block_case(ks, 1000, None, 12, 13, dev)
    _block_case(ks, 4096, 300, 37, 14, dev, integer=False)
    _block_case(ks, 8192, NB_FEATURES, NB_CLASSES, 15, dev)
    return {"windowed_err": w_err, "block_err": b_err}


# -- phase 6, PageRank -----------------------------------------------------


def pagerank_links(SparseDistArray):
    """bench.py's config-5 graph (bench.py:367-372): 1M pages, 16
    out-links each from RandomState(4), weight 1."""
    rng = np.random.RandomState(4)
    rows = np.repeat(np.arange(PR_N), PR_DEG)
    cols = rng.randint(0, PR_N, PR_N * PR_DEG)
    return SparseDistArray.from_coo(rows, cols,
                                    np.ones(PR_N * PR_DEG, np.float32),
                                    (PR_N, PR_N))


def _pagerank_float64(T, iters: int, damping: float = 0.85) -> np.ndarray:
    """The same iterations in float64 on the card (index_add_ over the
    transition's f32 entries widened to float64)."""
    n = T.shape[0]
    keep = T.rows < n
    rows = T.rows[keep].long()
    cols = T.cols[keep].long()
    data = T.data[keep].double()
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=T.device)
    for _ in range(iters):
        y = torch.zeros_like(r).index_add_(0, rows, data * r[cols])
        new = damping * y + (1.0 - damping) / n
        r = new + (1.0 - new.sum()) / n
    return r.cpu().numpy()


def phase_pagerank(kk, ks, pr, links, card: str, dev) -> dict:
    T = links.transition()
    plan = T._ensure_plan()
    _reset_counts(kk)
    t0 = time.perf_counter()
    ranks = pr.pagerank(links, num_iter=PR_ITERS)
    wall = time.perf_counter() - t0
    launches = ks.LAUNCHES["windowed_segsum"]
    _say(f"[pagerank] pagerank() {PR_N} pages x {PR_DEG} links, "
         f"{PR_ITERS} iterations: {wall:.3f} s wall, windowed-kernel "
         f"launches {launches}; T: nnz {T.nnz} nse {T.nse}, plan "
         f"padded_size {plan.padded_size} rows_pad {plan.rows_pad} "
         f"nsteps {plan.nsteps}")
    if launches < PR_ITERS:
        _fail(f"the windowed kernel ran {launches} times, want >= "
              f"{PR_ITERS}")
    if ranks.shape != (PR_N,) or not np.isfinite(ranks).all():
        _fail("PageRank ranks have the wrong shape or are not finite")
    ref = _pagerank_float64(T, PR_ITERS)
    err = float(np.abs(ranks.astype(np.float64) - ref).max())
    rel = err / float(ref.max())
    total = float(ranks.astype(np.float64).sum())
    # Tolerance 1e-5 of the largest rank: an iteration rounds each rank
    # in f32 about 20 times (16 products and sums, the teleport), ~20 *
    # 2^-24 = 1.2e-6 relative; ten iterations, each error damped by 0.85
    # per step, stay below 1e-5 unless every rounding has one sign.
    _say(f"[pagerank] ranks vs float64 on the card: max |diff| {err:.3g} "
         f"= {rel:.3g} of the largest rank (tol 1e-5); sum {total!r} "
         f"(tol 1e-5 of 1)")
    if not (rel <= 1e-5 and abs(total - 1.0) <= 1e-5):
        _fail("PageRank ranks disagree with the float64 iterations")

    def run_s() -> float:
        t = time.perf_counter()
        pr.pagerank(links, num_iter=PR_ITERS)  # ends in a host fetch
        return time.perf_counter() - t

    run_s()
    best = min(run_s() for _ in range(3))
    ips = PR_ITERS / best

    # where one iteration's time goes, by CUDA events
    rank = torch.from_numpy(ranks).to(dev)
    damp = torch.tensor(0.85, dtype=torch.float32, device=dev)
    contrib = T._pdata * torch.index_select(rank, 0, T._pcols)
    args = _windowed_args(plan)
    gather_ms = _event_ms(
        lambda: T._pdata * torch.index_select(rank, 0, T._pcols), 20)
    ms = _event_ms(lambda: ks.windowed_segsum(contrib, plan._ids2d,
                                              plan._wb, **args), 20)
    y = ks.windowed_segsum(contrib, plan._ids2d, plan._wb,
                           **args).reshape(-1)[:PR_N]
    teleport_ms = _event_ms(lambda: pr._teleport_body(y, damp, PR_N), 20)
    plain_ms = _event_ms(lambda: ks.windowed_segsum_plain(
        contrib, plan._ids2d, plan._wb, plan.rows_pad), 20)
    # library yardstick: one index_add_ of the same products by row
    keep = T.rows < PR_N
    lib_vals = (T.data * torch.index_select(rank, 0, T.cols))[keep]
    lib_ids = T.rows[keep]
    lib_ms = _event_ms(lambda: torch.zeros(
        PR_N, device=dev).index_add_(0, lib_ids, lib_vals), 20)
    _, bw_peak = _peaks(card)
    p = plan.padded_size
    nbytes = 4.0 * (p + p + p // 1024 + plan.rows_pad * 128)
    bound_ms = nbytes / bw_peak * 1e3
    parts_ms = PR_ITERS * (gather_ms + ms + teleport_ms)
    _say(f"[pagerank] {ips:.2f} iters/s ({PR_ITERS}-iteration pagerank(), "
         f"best of 3, {best * 1e3:.2f} ms); per iteration: gather "
         f"pdata*x[pcols] {gather_ms:.4f} ms, windowed kernel {ms:.4f} ms, "
         f"teleport {teleport_ms:.4f} ms; the parts of {PR_ITERS} "
         f"iterations fill {parts_ms:.3f} ms of the call's "
         f"{best * 1e3:.3f} ms; kernel plain_ms {plain_ms:.4f} "
         f"library_ms {lib_ms:.4f} (index_add_) bound_ms {bound_ms:.4f} "
         f"(bytes: {nbytes / 1e6:.1f} MB) on {card}")
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": "bytes"}


# -- phase 7, naive Bayes ---------------------------------------------------


def _nb_data(dev):
    """20 classes (as 20 Newsgroups has), 2,048 hashed features, 262,144
    rows of Poisson counts with mean 2: each class scales the rate of
    every feature by its own factor in [0.25, 1.75], renormalised to a
    mean of 2. Labels and rates from RandomState(6); the counts are
    drawn on the card from a seeded generator."""
    rng = np.random.RandomState(6)
    u = rng.uniform(0.25, 1.75, (NB_CLASSES, NB_FEATURES))
    rates = (2.0 * u / u.mean(axis=1, keepdims=True)).astype(np.float32)
    y = rng.randint(0, NB_CLASSES, NB_ROWS).astype(np.int32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    yt = torch.from_numpy(y).to(dev)
    x = torch.poisson(torch.from_numpy(rates).to(dev)[yt.long()],
                      generator=gen)
    return x, yt, y


def phase_naive_bayes(st, kk, ks, nb, card: str, dev) -> dict:
    from spartan_tpu_torch.array.distarray import from_tensor

    x, yt, y = _nb_data(dev)
    X, Y = from_tensor(x), from_tensor(yt)
    prev = (st.FLAGS.native_kernels, st.FLAGS.segment_impl)
    try:
        st.FLAGS.native_kernels = "on"
        _reset_counts(kk)
        t0 = time.perf_counter()
        lp, ll = nb.fit(X, Y, NB_CLASSES)
        wall = time.perf_counter() - t0
        launches = ks.LAUNCHES["segment_sum_block"]
        _say(f"[naive_bayes] fit() {NB_ROWS} x {NB_FEATURES} counts "
             f"({x.numel() * 4 / 1e9:.2f} GB f32), {NB_CLASSES} classes, "
             f"native_kernels=on: {wall:.3f} s wall, segment-kernel "
             f"launches {launches} (the 2-D counts; the 1-D class counts "
             f"are lifted to rows of 128 and take the one-hot product)")
        if launches < 1:
            _fail("the segment kernel did not run in naive Bayes' fit")
        st.FLAGS.segment_impl = "onehot"  # the kernel's plain version
        lp_p, ll_p = nb.fit(X, Y, NB_CLASSES)
        st.FLAGS.segment_impl = "auto"
        same = np.array_equal(lp, lp_p) and np.array_equal(ll, ll_p)
        _say(f"[naive_bayes] tables vs the fit driven through the plain "
             f"version: bit-equal {same} (integer counts below 2^24)")
        if not same:
            _fail("naive Bayes tables differ from the plain-driven fit")
        if not (np.isfinite(lp).all() and np.isfinite(ll).all()):
            _fail("naive Bayes tables are not finite")
        pred = nb.predict(X, lp, ll).glom()
        acc = float((pred == y).mean())
        _say(f"[naive_bayes] predict() accuracy against the generating "
             f"labels {acc:.6f} (want >= 0.99)")
        if not acc >= 0.99:
            _fail(f"naive Bayes accuracy {acc} < 0.99")

        def fit_s() -> float:
            t = time.perf_counter()
            nb.fit(X, Y, NB_CLASSES)
            return time.perf_counter() - t

        fit_s()
        best = min(fit_s() for _ in range(3))
        ms = _event_ms(lambda: ks.segment_sum_block(x, yt, NB_CLASSES), 10)
        lib_ms = _event_ms(lambda: torch.zeros(
            (NB_CLASSES, NB_FEATURES), device=dev).index_add_(0, yt, x), 10)
        flops_peak, bw_peak = _peaks(card)
        nbytes = 4.0 * (NB_ROWS * NB_FEATURES + NB_ROWS
                        + NB_CLASSES * NB_FEATURES)
        t_bytes = nbytes / bw_peak * 1e3
        t_ops = NB_ROWS * NB_FEATURES / flops_peak * 1e3
        bound_ms = max(t_bytes, t_ops)
        _say(f"[naive_bayes] fit {best * 1e3:.2f} ms (best of 3); "
             f"segment kernel at {NB_ROWS} x {NB_FEATURES}, k = "
             f"{NB_CLASSES}: {ms:.4f} ms, index_add_ {lib_ms:.4f} ms, "
             f"bound {bound_ms:.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}; "
             f"bytes {nbytes / 1e9:.4f} GB in {t_bytes:.4f} ms, additions "
             f"{t_ops:.4f} ms) on {card}")
    finally:
        st.FLAGS.native_kernels, st.FLAGS.segment_impl = prev
    return {"launches": launches, "ms": ms, "library_ms": lib_ms,
            "bound_ms": bound_ms}


# -- phase 8, segment A/B ---------------------------------------------------


def phase_segment_ab(ks, card: str, dev) -> dict:
    """The JAX package's measured shape (ops/segment.py: 1M x 128, k =
    64): the block kernel, one index_add_ and the one-hot product. Data
    for Hopper's ``auto`` policy; it changes no policy here."""
    rng = np.random.RandomState(8)
    vals = torch.from_numpy(rng.rand(SEG_E, SEG_D).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.randint(0, SEG_K, SEG_E).astype(
        np.int32)).to(dev)
    ms = _event_ms(lambda: ks.segment_sum_block(vals, ids, SEG_K), 20)
    lib_ms = _event_ms(lambda: torch.zeros(
        (SEG_K, SEG_D), device=dev).index_add_(0, ids, vals), 20)
    plain_ms = _event_ms(
        lambda: ks.segment_sum_block_plain(vals, ids, SEG_K), 20)
    flops_peak, bw_peak = _peaks(card)
    nbytes = 4.0 * (SEG_E * SEG_D + SEG_E + SEG_K * SEG_D)
    t_bytes = nbytes / bw_peak * 1e3
    t_ops = SEG_E * SEG_D / flops_peak * 1e3
    bound_ms = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    _say(f"[segment] {SEG_E} x {SEG_D} f32, k = {SEG_K}: kernel "
         f"{ms:.4f} ms, index_add_ {lib_ms:.4f} ms, one-hot product "
         f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({by}; bytes "
         f"{t_bytes:.4f} ms, additions {t_ops:.4f} ms) on {card}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": by}


# -- phase 3, sort/select kernels ------------------------------------------


def _pack_runs(rng, b: int, p: int, m: int, fill: float):
    """starts/counts (b, p) of sorted runs: each shard cuts the first
    ``fill`` of its m slots at p - 1 random points."""
    valid = np.full(b, int(m * fill))
    cuts = np.sort(rng.randint(0, m + 1, (b, p - 1)) * fill, axis=1)
    edges = np.concatenate([np.zeros((b, 1)), np.minimum(
        cuts.astype(np.int64), valid[:, None]), valid[:, None]], axis=1)
    counts = np.diff(edges, axis=1).astype(np.int32)
    starts = edges[:, :-1].astype(np.int32)
    return starts, counts


def _pack_case(kx, xs, starts, counts, label: str, dev) -> float:
    """partition_pack against its plain version, bit for bit, and a
    rerun against the first run."""
    x = xs.to(dev)
    st_t = torch.from_numpy(np.ascontiguousarray(starts)).to(dev)
    ct_t = torch.from_numpy(np.ascontiguousarray(counts)).to(dev)
    out = kx.partition_pack(x, st_t, ct_t)
    torch.cuda.synchronize()
    again = kx.partition_pack(x, st_t, ct_t)
    ref = kx.partition_pack_plain(x, st_t, ct_t)
    torch.cuda.synchronize()
    words = torch.int32
    bad = int((out.view(words) != ref.view(words)).sum().item())
    same = bool(torch.equal(out.view(words), again.view(words)))
    ok = bad == 0 and same and tuple(out.shape) == tuple(ref.shape)
    _say(f"[kernel] partition_pack {label}: shards={x.shape[0]} "
         f"p={starts.shape[1]} m={x.shape[1]} {str(x.dtype)[6:]}: words "
         f"differing from plain {bad} (want 0, bit for bit), rerun "
         f"bit-equal {same} -> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        _fail(f"partition_pack disagrees with its plain version ({label})")
    return 0.0


def phase_pack_kernel(kx, dev) -> None:
    rng = np.random.RandomState(21)
    p, m = SORT_MESH[0], SORT_N // SORT_MESH[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    xs = torch.rand((p, m), generator=gen, device=dev)
    s, c = _pack_runs(rng, p, p, m, 1.0)
    _pack_case(kx, xs, s, c, "sort phase shape", dev)
    # ragged last shard: its valid prefix ends before m
    xs = torch.from_numpy(rng.rand(p, 1000).astype(np.float32))
    s, c = _pack_runs(rng, p, p, 1000, 1.0)
    s2, c2 = _pack_runs(rng, 1, p, 1000, 0.37)
    s[-1], c[-1] = s2[0], c2[0]
    _pack_case(kx, xs, s, c, "ragged last shard", dev)
    # counts of 0 and of m: one destination takes a whole shard
    s = np.zeros((p, p), np.int32)
    c = np.zeros((p, p), np.int32)
    c[np.arange(p), rng.randint(0, p, p)] = 1000
    _pack_case(kx, xs, s, c, "counts 0 and m", dev)
    # every bit pattern: NaN payloads, -0.0, denormals
    bits = rng.randint(0, 2 ** 32, (p, 4099), np.uint64).astype(np.uint32)
    bits[:, :4] = [0x80000000, 0x7FC00001, 0xFFC12345, 0x00000001]
    s, c = _pack_runs(rng, p, p, 4099, 1.0)
    _pack_case(kx, torch.from_numpy(bits.view(np.float32)), s, c,
               "NaN payloads and -0.0", dev)
    _pack_case(kx, torch.from_numpy(bits.view(np.int32)), s, c,
               "int32 data", dev)
    # batched rows of shards (a batched sort's 64 rows x 8 shards)
    xs = torch.from_numpy(rng.rand(512, 613).astype(np.float32))
    s, c = _pack_runs(rng, 512, p, 613, 1.0)
    _pack_case(kx, xs, s, c, "batched 64 rows x 8 shards", dev)


def _topk_case(kt, key, k: int, sentinel, label: str) -> float:
    """shard_topk against its plain version: keys bit-equal and indices
    equal; a rerun bit-equal to the first."""
    out_k, out_i = kt.shard_topk(key, k, sentinel)
    torch.cuda.synchronize()
    again_k, again_i = kt.shard_topk(key, k, sentinel)
    ref_k, ref_i = kt.shard_topk_plain(key, k, sentinel)
    torch.cuda.synchronize()
    words = torch.int32
    same_keys = bool(torch.equal(out_k.view(words), ref_k.view(words)))
    same_idx = bool(torch.equal(out_i, ref_i))
    rerun = bool(torch.equal(out_k.view(words), again_k.view(words))
                 and torch.equal(out_i, again_i))
    finite = torch.isfinite(ref_k.float()) & torch.isfinite(out_k.float())
    err = float((out_k.double() - ref_k.double())[finite].abs().max()
                .item()) if bool(finite.any()) else 0.0
    ok = same_keys and same_idx and rerun
    _say(f"[kernel] shard_topk {label}: rows={key.shape[0]} "
         f"m={key.shape[1]} k={k} {str(key.dtype)[6:]}: keys bit-equal "
         f"{same_keys}, indices equal {same_idx}, rerun bit-equal {rerun} "
         f"-> {'ok' if ok else 'MISMATCH'}")
    if not ok:
        _fail(f"shard_topk disagrees with its plain version ({label})")
    return err


def _topk_burst_rows(kt, key: torch.Tensor, gen) -> torch.Tensor:
    """``key`` (rows, m), m % 4 == 0, in [0, 1), made so that one merge
    of the top-k kernel's first pass takes more than a step's 4096
    words: in every chunk, 10 keys of 1.5 in the step before a burst of
    8192 keys in [2, 3) that starts on a step and lies between two
    sampled runs. The 10 wait for a merge; the burst's first step then
    appends all 4096 of its keys beside them."""
    rows, m = key.shape
    step, run = kt._STEP, kt._RUN_LEN
    sms = torch.cuda.get_device_properties(key.device).multi_processor_count
    chunk, chunks = kt._chunking(rows, m, sms)
    for c in range(chunks):
        lo, n = c * chunk, min(chunk, m - c * chunk)
        runs = kt._sample_runs(n)

        def clear(a: int, b: int) -> bool:
            return not any(r < b and a < r + run for r in runs)

        starts = [s for s in range(step, n - 2 * step + 1, step)
                  if clear(s, s + 2 * step) and clear(s - step, s - step + 10)]
        if not starts:
            _fail(f"a top-k chunk of {n} keys has no room for the burst")
        s = lo + starts[0]
        key[:, s - step:s - step + 10] = 1.5
        key[:, s:s + 2 * step] = 2.0 + torch.rand(
            (rows, 2 * step), generator=gen, device=key.device)
    return key


def phase_topk_kernel(kt, dev) -> float:
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    p, m = SORT_MESH[0], SORT_N // SORT_MESH[0]
    ninf, imin = float("-inf"), int(np.iinfo(np.int32).min)
    main = _topk_case(kt, torch.rand((p, m), generator=gen, device=dev),
                      TOPK_K, ninf, "topk phase shape")
    ties = torch.randint(0, 10, (p, 100_003), generator=gen, device=dev,
                         dtype=torch.int32)
    _topk_case(kt, ties, TOPK_K, imin, "heavy ties, int32 in [0, 10)")
    _topk_case(kt, ties.float(), TOPK_K, ninf, "heavy ties, f32")
    _topk_case(kt, ties.float(), 1, ninf, "k = 1")
    sent = torch.full((p, 40_000), ninf, device=dev)
    sent[:, 17] = 1.0
    _topk_case(kt, sent, TOPK_K, ninf, "-inf data (the sentinel)")
    isent = torch.full((p, 40_000), imin, dtype=torch.int32, device=dev)
    isent[:, 39_999] = 5
    _topk_case(kt, isent, TOPK_K, imin, "INT_MIN data (the sentinel)")
    odd = torch.tensor([0.0, -0.0, float("nan"), -float("nan"), 1.0,
                        float("inf"), ninf, 1.0], device=dev)
    _topk_case(kt, odd.repeat(3, 1000), TOPK_K, ninf,
               "NaN, -NaN, -0.0, +-inf (IEEE total order)")
    _topk_case(kt, torch.rand((5, 50), generator=gen, device=dev),
               TOPK_K, ninf, "rows shorter than k")
    _topk_case(kt, torch.rand((2, 3 * 16384 + 5), generator=gen,
                              device=dev), TOPK_K, ninf,
               "odd row length")
    _topk_case(kt, torch.rand((6, 1_000), generator=gen, device=dev),
               TOPK_K, ninf, "rows within one sample")
    flat = torch.rand(3 * 250_000 + 1, generator=gen, device=dev)
    _topk_case(kt, flat[1:].view(3, 250_000), TOPK_K, ninf,
               "rows off 16-byte boundaries")
    up = torch.sort(torch.rand((p, m), generator=gen, device=dev), 1).values
    _topk_case(kt, up, TOPK_K, ninf, "ascending rows")
    _topk_case(kt, up.flip(1), TOPK_K, ninf, "descending rows")
    del up
    most = torch.rand((p, 400_000), generator=gen, device=dev)
    most[:, torch.randperm(400_000, generator=gen, device=dev)[:10_000]] = 2.0
    _topk_case(kt, most, TOPK_K, ninf, "10,000 equal maximal keys a row")
    del most
    for label, back in (("zeros", torch.zeros((p, m), device=dev)),
                        ("uniform noise",
                         torch.rand((p, m), generator=gen, device=dev))):
        _topk_case(kt, _topk_burst_rows(kt, back, gen), TOPK_K, ninf,
                   f"a step of survivors beside waiting words ({label})")
    return main


def _bincount_case(kh, ids, length: int, label: str) -> float:
    out = kh.bincount_block(ids, length)
    torch.cuda.synchronize()
    again = kh.bincount_block(ids, length)
    ref = kh.bincount_block_plain(ids, length)
    torch.cuda.synchronize()
    err = float((out.double() - ref.double()).abs().max().item())
    same = bool(torch.equal(out, again))
    ok = err == 0.0 and same and out.dtype == ref.dtype == torch.int32
    _say(f"[kernel] bincount_block {label}: e={ids.numel()} "
         f"length={length} ids {str(ids.dtype)[6:]}: max |kernel - plain| "
         f"{err:.3g} (want 0: integer counts), rerun bit-equal {same} -> "
         f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        _fail(f"bincount_block disagrees with its plain version ({label})")
    return err


def phase_bincount_kernel(kh, dev) -> float:
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)

    def ids(lo, hi, e, dtype=torch.int32):
        return torch.randint(lo, hi, (e,), generator=gen, device=dev,
                             dtype=dtype)

    main = _bincount_case(kh, ids(0, HIST_BINS, SORT_N), HIST_BINS,
                          "histogram phase shape")
    _bincount_case(kh, torch.sort(ids(0, UNIQ_HIGH, SORT_N)).values,
                   UNIQ_SIZE, "unique phase shape (sorted ranks)")
    _bincount_case(kh, ids(0, UNIQ_SIZE, SORT_N), UNIQ_SIZE,
                   "uniform ids over 4096 buckets")
    _bincount_case(kh, torch.full((SORT_N,), HIST_BINS - 1,
                                  dtype=torch.int32, device=dev), HIST_BINS,
                   "all ids in one bucket")
    _bincount_case(kh, torch.full((1 << 20,), 5, dtype=torch.int32,
                                  device=dev), UNIQ_SIZE,
                   "all ids in one bucket, one sub-histogram")
    for length in (HIST_BINS, UNIQ_SIZE):
        _bincount_case(kh, ids(-1000, 0, 1 << 22), length,
                       "all ids negative")
        _bincount_case(kh, ids(-3, length + 3, 1_000_004)[1:], length,
                       "int32 view at a 4-byte offset (ids[1:])")
    for e in (1, 3, 5):
        _bincount_case(kh, ids(-1, 11, e), 10, f"e = {e}")
    # L: the last length with a sub-histogram per warp
    last = kh._SHARED_BUDGET // (4 * kh._WARPS)
    for length in (last, last + 1):
        _bincount_case(kh, ids(-5, length + 10, 1_000_003), length,
                       f"length {'L' if length == last else 'L + 1'}")
    _bincount_case(kh, ids(-50, 4200, 1_000_003), 4096,
                   "negatives, ids >= length, length 4096, e % 512 != 0")
    _bincount_case(kh, ids(-3, 14, 1003, torch.int64), 10, "int64 ids")
    _bincount_case(kh, ids(0, 1, 7), 1, "length 1")
    return main



# -- phases 9-11, sort / top-k / histogram -----------------------------------


def _wall_ms(fn, reps: int = 3, warm: bool = True) -> float:
    """Best host-clock time of ``fn()`` ending in a synchronise, after one
    warm-up call unless ``warm`` is False."""
    if warm:
        fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def _device_split(fn, label: str, card: str, top: int = 5) -> None:
    """Where one ``fn()`` spends its device time: a torch.profiler trace
    of one call after a warm-up, the device kernels' summed time against
    the call's host-clock time (the rest is launch gaps and host work),
    and the ``top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    # record_function ranges (the expr nodes' annotations under
    # FLAGS.trace_annotations) carry the device time of the kernels
    # inside them: count kernels only
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.self_device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "Expr#" not in e.key and e.key != "st_loop_body"]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        _say(f"[{label}] device split: the profiler recorded no device "
             f"time (not measured)")
        return
    parts = "; ".join(f"{name[:48]} x{count} {ms:.3f} ms"
                      for ms, count, name in rows[:top])
    _say(f"[{label}] device split of one call (torch.profiler, traced "
         f"{wall:.2f} ms host clock): kernels busy {busy:.3f} ms "
         f"({100.0 * busy / wall:.1f}%); top: {parts} on {card}")


def _f32_close(got, want, what: str) -> None:
    """An f32 order statistic against float64 numpy: the interpolation
    rounds three times in f32 (two products, one sum) and its weights
    once, so allow 4 ulps of the value."""
    got = np.atleast_1d(np.asarray(got, np.float64))
    want = np.atleast_1d(np.asarray(want, np.float64))
    tol = 4.0 * _U * np.abs(want)
    err = np.abs(got - want)
    _say(f"[sort] {what}: {got.tolist()} vs float64 numpy "
         f"{want.tolist()}: max |diff| {float(err.max()):.3g} (tol 4 ulps "
         f"of f32, {float(tol.max()):.3g})")
    if not (err <= tol).all():
        _fail(f"{what} disagrees with float64 numpy")


def phase_sort(st, kk, kx, x, card: str, dev) -> dict:
    from spartan_tpu_torch.array.distarray import from_tensor

    n = x.numel()
    X = from_tensor(x)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(kk)
    t0 = time.perf_counter()
    got = st.sort(X).glom()
    idx = st.argsort(X).glom()
    med = float(st.median(X).glom())
    pct = st.percentile(X, [1.0, 50.0, 99.0]).glom()
    wall = time.perf_counter() - t0
    launches = kx.LAUNCHES["partition_pack"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    _say(f"[sort] sort, argsort, median, percentile of {n} uniform f32 "
         f"keys under a logical {SORT_MESH} mesh: {wall:.3f} s wall, "
         f"partition_pack launches {launches}, peak device memory "
         f"{peak:.2f} GB")
    if launches < 1:
        _fail("the partition_pack kernel did not run on the sort path")
    want = torch.sort(x).values
    same = np.array_equal(got.view(np.uint32),
                          want.cpu().numpy().view(np.uint32))
    it = torch.from_numpy(idx).to(dev).long()
    hits = torch.zeros(n, dtype=torch.int32, device=dev).scatter_add_(
        0, it, torch.ones_like(it, dtype=torch.int32))
    perm = bool((hits == 1).all().item())
    gathered = bool(torch.equal(x[it].view(torch.int32),
                                want.view(torch.int32)))
    _say(f"[sort] st.sort bit-equal to torch.sort: {same}; st.argsort a "
         f"permutation: {perm}, x[idx] bit-equal to the sorted keys: "
         f"{gathered}")
    if not (same and perm and gathered and got.shape == (n,)):
        _fail("the sample sort disagrees with torch.sort")
    x64 = x.double().cpu().numpy()
    _f32_close(med, np.median(x64), "median")
    _f32_close(pct, np.percentile(x64, [1.0, 50.0, 99.0]),
               "percentile [1, 50, 99]")
    sort_ms = _wall_ms(lambda: st.sort(X).evaluate())
    argsort_ms = _wall_ms(lambda: st.argsort(X).evaluate())
    torch_ms = _wall_ms(lambda: torch.sort(x))
    _say(f"[sort] per call: st.sort {sort_ms:.2f} ms, st.argsort "
         f"{argsort_ms:.2f} ms, torch.sort {torch_ms:.2f} ms (best of 3) "
         f"on {card}")
    _device_split(lambda: st.sort(X).evaluate(), "sort", card)

    # the kernel at the path's shape: 8 shards' sorted streams cut into
    # 8 runs each
    p, m = SORT_MESH[0], n // SORT_MESH[0]
    xs = torch.sort(x.view(p, m), dim=1).values
    s, c = _pack_runs(np.random.RandomState(25), p, p, m, 1.0)
    s_t, c_t = torch.from_numpy(s).to(dev), torch.from_numpy(c).to(dev)
    ms = _event_ms(lambda: kx.partition_pack(xs, s_t, c_t), 10)
    plain_ms = _event_ms(lambda: kx.partition_pack_plain(xs, s_t, c_t), 3,
                         warmup=1)
    # yardstick: the composite scatter_ of the expr path (no single
    # PyTorch call packs runs)
    tt = torch.arange(m, device=dev)
    dst = torch.searchsorted(s_t.long(), tt.expand(p, m).contiguous(),
                             right=True) - 1
    flat = dst * m + tt - s_t.long().gather(1, dst)
    lib_ms = _event_ms(lambda: torch.zeros((p, p * m), device=dev).scatter_(
        1, flat, xs), 10)
    _, bw_peak = _peaks(card)
    nbytes = 4.0 * (p * m + p * p * m)
    bound_ms = nbytes / bw_peak * 1e3
    _say(f"[sort] partition_pack at {p} shards x {m}: kernel {ms:.4f} ms, "
         f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms (composite "
         f"scatter_), bound {bound_ms:.4f} ms (bytes, "
         f"{nbytes / 1e9:.2f} GB) on {card}")
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": "bytes"}


def phase_topk(st, kk, kt, x, card: str, dev) -> dict:
    from spartan_tpu_torch.array.distarray import from_tensor

    n = x.numel()
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    ints = torch.randint(0, 1000, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    X, I = from_tensor(x), from_tensor(ints)
    _reset_counts(kk)
    t0 = time.perf_counter()
    vals, idx = st.topk(X, TOPK_K)
    gi, gv = idx.glom(), vals.glom()
    ivals, iidx = st.topk(I, TOPK_K, largest=False)
    gii, giv = iidx.glom(), ivals.glom()
    wall = time.perf_counter() - t0
    launches = kt.LAUNCHES["shard_topk"]
    _say(f"[topk] st.topk(x, {TOPK_K}) on {n} f32 keys and smallest-"
         f"{TOPK_K} on {n} int32 in [0, 1000): {wall:.3f} s wall, "
         f"shard_topk launches {launches}")
    if launches < 1:
        _fail("the shard_topk kernel did not run on the top-k path")
    # oracle: a float64 stable sort, ties to the lowest index
    want = torch.sort(x.double(), descending=True, stable=True).indices[
        :TOPK_K].cpu().numpy()
    wi = torch.sort(ints.long(), stable=True).indices[:TOPK_K].cpu().numpy()
    tied = int(np.unique(gv, return_counts=True)[1].max())
    ok_f = (np.array_equal(gi, want) and gv.dtype == np.float32
            and np.array_equal(gv, x[torch.from_numpy(want).to(dev)]
                               .cpu().numpy()))
    ok_i = (np.array_equal(gii, wi) and np.array_equal(
        giv, ints[torch.from_numpy(wi).to(dev)].cpu().numpy()))
    _say(f"[topk] largest-{TOPK_K}: indices equal to the float64 stable-"
         f"sort oracle {ok_f} (up to {tied} winners share a key, so the "
         f"lowest-index rule decides); int32 smallest-{TOPK_K}: indices "
         f"equal {ok_i} (all values {int(giv.max())} or less)")
    if not (ok_f and ok_i):
        _fail("st.topk disagrees with the stable-sort oracle")

    def both():
        v, i = st.topk(X, TOPK_K)
        i.evaluate()
        v.evaluate()

    topk_ms = _wall_ms(both)
    torch_ms = _wall_ms(lambda: torch.topk(x, TOPK_K))
    _say(f"[topk] per call: st.topk {topk_ms:.2f} ms, torch.topk "
         f"{torch_ms:.2f} ms (best of 3) on {card}")
    _device_split(both, "topk", card)
    p, m = SORT_MESH[0], n // SORT_MESH[0]
    key = x.view(p, m)
    ninf = float("-inf")
    ms = _event_ms(lambda: kt.shard_topk(key, TOPK_K, ninf), 10)
    plain_ms = _event_ms(lambda: kt.shard_topk_plain(key, TOPK_K, ninf), 3,
                         warmup=1)
    lib_ms = _event_ms(lambda: torch.topk(key, TOPK_K, dim=1), 10)
    _, bw_peak = _peaks(card)
    nbytes = 4.0 * p * m + 8.0 * p * TOPK_K
    bound_ms = nbytes / bw_peak * 1e3
    _say(f"[topk] shard_topk at {p} x {m}, k = {TOPK_K}: kernel "
         f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
         f"(torch.topk on the (p, m) view), bound {bound_ms:.4f} ms (bytes)"
         f" on {card}")
    # the same shape on harder rows: the int32 keys of the smallest-k
    # call (2^23 / 1000 copies of each value a row, so thousands of
    # maximal keys tie) and ascending rows (every key beats the last)
    imin = int(np.iinfo(np.int32).min)
    for label, hard, sent in (
            ("int32 in [0, 1000), heavy ties", ints.view(p, m), imin),
            ("ascending f32 rows", torch.sort(key, 1).values, ninf)):
        hard_ms = _event_ms(lambda: kt.shard_topk(hard, TOPK_K, sent), 10)
        hard_lib = _event_ms(lambda: torch.topk(hard, TOPK_K, dim=1), 10)
        _say(f"[topk] shard_topk at {p} x {m}, k = {TOPK_K}, {label}: "
             f"kernel {hard_ms:.4f} ms ({hard_ms / ms:.2f}x the uniform "
             f"rows), torch.topk {hard_lib:.4f} ms on {card}")
        del hard
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": "bytes"}


def _np_edges(lo, hi, bins: int) -> np.ndarray:
    """The port's f32 edge formula in numpy f32 arithmetic."""
    f32 = np.float32
    lo, hi = f32(lo), f32(hi)
    step = np.arange(bins, dtype=f32) / f32(bins)
    return np.append(lo * (f32(1) - step) + hi * step, hi).astype(f32)


def phase_histogram(st, kk, kh, x, card: str, dev) -> dict:
    from spartan_tpu_torch.array.distarray import from_tensor

    n = x.numel()
    gen = torch.Generator(device=dev)
    gen.manual_seed(27)
    ids = torch.randint(0, UNIQ_HIGH, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    X, ID = from_tensor(x), from_tensor(ids)
    _reset_counts(kk)
    t0 = time.perf_counter()
    c1, e1 = (a.glom() for a in st.histogram(X, bins=HIST_BINS,
                                              range=(0.0, 1.0)))
    c2, e2 = (a.glom() for a in st.histogram(X, bins=HIST_BINS))
    u, uc = (a.glom() for a in st.unique(ID, size=UNIQ_SIZE, fill_value=-1,
                                         return_counts=True))
    wall = time.perf_counter() - t0
    launches = kh.LAUNCHES["bincount_block"]
    _say(f"[histogram] histogram(bins={HIST_BINS}) with and without a "
         f"range on {n} f32 keys, unique(size={UNIQ_SIZE}, "
         f"return_counts=True) on {n} int32 ids: {wall:.3f} s wall, "
         f"bincount_block launches {launches}")
    if launches < 1:
        _fail("the bincount_block kernel did not run on the histogram path")
    xn = x.cpu().numpy()
    ok = True
    for label, counts, edges, lo, hi, ranged in (
            ("range=(0, 1)", c1, e1, 0.0, 1.0, True),
            ("range=None", c2, e2, xn.min(), xn.max(), False)):
        want_e = _np_edges(lo, hi, HIST_BINS)
        b = np.searchsorted(want_e, xn, side="right") - 1
        if ranged:
            b[xn == want_e[-1]] = HIST_BINS - 1
            b = b[(xn >= want_e[0]) & (xn <= want_e[-1])]
        else:
            b = np.clip(b, 0, HIST_BINS - 1)
        want_c = np.bincount(b, minlength=HIST_BINS)
        good = (np.array_equal(counts, want_c) and np.array_equal(
            edges.view(np.uint32), want_e.view(np.uint32)))
        _say(f"[histogram] {label}: counts equal numpy's on the same f32 "
             f"edges {np.array_equal(counts, want_c)}, edges bit-equal "
             f"{np.array_equal(edges.view(np.uint32), want_e.view(np.uint32))}"
             f", total {int(counts.sum())}")
        ok = ok and good
    rv, rc = np.unique(ids.cpu().numpy(), return_counts=True)
    k = rv.size
    good_u = (k <= UNIQ_SIZE and np.array_equal(u[:k], rv)
              and (u[k:] == -1).all() and np.array_equal(uc[:k], rc)
              and (uc[k:] == 0).all())
    _say(f"[histogram] unique: {k} distinct values, values and counts "
         f"equal np.unique's {good_u}")
    if not (ok and good_u):
        _fail("histogram or unique disagrees with numpy")

    hist_ms = _wall_ms(lambda: st.histogram(X, bins=HIST_BINS,
                                            range=(0.0, 1.0))[0].evaluate())
    bucket = torch.clamp((x * HIST_BINS).to(torch.int32), 0, HIST_BINS - 1)
    torch_ms = _wall_ms(lambda: torch.bincount(bucket, minlength=HIST_BINS))
    _say(f"[histogram] per call: st.histogram counts {hist_ms:.2f} ms, "
         f"torch.bincount of the bucket ids {torch_ms:.2f} ms (best of 3) "
         f"on {card}")
    _device_split(lambda: st.histogram(X, bins=HIST_BINS, range=(
        0.0, 1.0))[0].evaluate(), "histogram", card)
    _, bw_peak = _peaks(card)
    ranks = torch.sort(ids).values
    shapes = {}
    # the path's two shapes (64 buckets x2, sorted ranks x1), then two
    # more for the design: uniform over 4096 buckets, one hot bucket
    for label, ids_s, length in (
            ("64 buckets (histogram)", bucket, HIST_BINS),
            ("4096 buckets, sorted ranks (unique)", ranks, UNIQ_SIZE),
            ("4096 buckets, uniform", torch.randint(
                0, UNIQ_SIZE, (n,), generator=gen, device=dev,
                dtype=torch.int32), UNIQ_SIZE),
            ("64 buckets, one hot bucket", torch.full_like(bucket, 7),
             HIST_BINS)):
        ms = _event_ms(lambda: kh.bincount_block(ids_s, length), 20)
        lib_ms = _event_ms(
            lambda: torch.bincount(ids_s, minlength=length), 10)
        bound_ms = 4.0 * (n + length) / bw_peak * 1e3
        shapes[label] = (ms, lib_ms, bound_ms)
        _say(f"[histogram] bincount_block at {n} ids, {label}: kernel "
             f"{ms:.4f} ms, library {lib_ms:.4f} ms (torch.bincount), "
             f"bound {bound_ms:.4f} ms (bytes; {100.0 * bound_ms / ms:.1f}% "
             f"of it) on {card}")
    read_ms = _event_ms(lambda: bucket.max(), 20)
    _say(f"[histogram] read floor: torch's max over the same {n} int32 "
         f"ids {read_ms:.4f} ms ({4.0 * n / read_ms / 1e9:.2f} TB/s) on "
         f"{card}")
    plain_ms = _event_ms(lambda: kh.bincount_block_plain(bucket, HIST_BINS),
                         3, warmup=1)
    _say(f"[histogram] bincount_block_plain at {n} ids, 64 buckets: "
         f"{plain_ms:.4f} ms on {card}")
    ms, lib_ms, bound_ms = shapes["64 buckets (histogram)"]
    u_ms, u_lib, u_bound = shapes["4096 buckets, sorted ranks (unique)"]
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "unique_ms": u_ms, "unique_library_ms": u_lib,
            "unique_bound_ms": u_bound}


# -- stencil: conv_block against its plain version --------------------------


def _stencil_case(kst, blocks, wt, label: str) -> float:
    """conv_block on the card against its plain version on the same halo
    blocks, and a rerun against the first run bit for bit. Both sum the
    same K = KH*KW*C products in f32 in different orders, so they differ
    by at most 2 K 2^-24 max conv(|x|, |w|); the tensor-core route (C > 4)
    adds at most 12 K 2^-24 max conv(|x|, |w|) for its 3xTF32 split (the
    derivation is in tests/test_torch_cuda.py::_conv_tol). Both are also
    held against the float64 conv of the same blocks, for the record."""
    out = kst.conv_block(blocks, wt)
    torch.cuda.synchronize()
    again = kst.conv_block(blocks, wt)
    ref = kst.conv_block_plain(blocks, wt)
    mag = float(kst.conv_block_plain(blocks.abs(), wt.abs()).max().item())
    exact = kst.conv_block_plain(blocks.double(), wt.double())
    torch.cuda.synchronize()
    kh, kw, c, o = wt.shape
    route = kst.route(c)
    tol = (2.0 + (12.0 if route == "mma" else 0.0)) * kh * kw * c * _U * mag
    err = float((out - ref).abs().max().item())
    err64 = float((out.double() - exact).abs().max().item()) / mag
    plain64 = float((ref.double() - exact).abs().max().item()) / mag
    same = bool(torch.equal(out, again))
    ok = err <= tol and same and out.shape == ref.shape
    _say(f"[stencil] conv_block {label} ({route} route): blocks "
         f"{tuple(blocks.shape)} filter {tuple(wt.shape)} -> "
         f"{tuple(out.shape)}: max |kernel - plain| {err:.3g} (tol "
         f"{tol:.3g}), max |x - float64| / max conv(|x|, |w|): kernel "
         f"{err64:.3g}, plain {plain64:.3g}; rerun bit-equal {same} -> "
         f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        _fail(f"conv_block disagrees with its plain version ({label})")
    return err


def _halo_blocks(kst, n, h, w, c, kh, kw, p, gen, dev):
    x = torch.randn((n, h, w, c), generator=gen, device=dev)
    return kst.halo_exchange(x, kh, kw, p)


def phase_stencil_kernel(kst, dev) -> float:
    """At both VGG-16 block-1 widths (conv1_1 on the SIMT route, conv1_2
    on the tensor-core route) and at edge shapes: 2x2 and 5x5 filters,
    C = 3 and C = 16 (one per route), O = 10 and 70, W = 17, shard
    height = KH, p = 2 and 8; C = 13 (a ragged channel chunk) to O = 70
    (a ragged channel tile); C = O = 8 (one chunk, one ragged tile)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    p = VGG_MESH[0]
    main = 0.0
    for cin, cout in zip(VGG_WIDTHS[:-1], VGG_WIDTHS[1:]):
        blocks = _halo_blocks(kst, VGG_N, VGG_HW, VGG_HW, cin, 3, 3, p, gen,
                              dev)
        wt = torch.randn((3, 3, cin, cout), generator=gen, device=dev)
        main = max(main, _stencil_case(kst, blocks, wt,
                                       f"VGG width {cin}->{cout}"))
        del blocks
    for cin, cout in ((3, 10), (16, 70)):
        for k in (2, 5):
            for shards in (2, 8):
                blocks = _halo_blocks(kst, 3, k * shards, 17, cin, k, k,
                                      shards, gen, dev)
                wt = torch.randn((k, k, cin, cout), generator=gen,
                                 device=dev)
                _stencil_case(kst, blocks, wt, f"{k}x{k}, C={cin}, "
                              f"O={cout}, p={shards}, hs=KH")
    for cin, cout in ((13, 70), (8, 8)):
        blocks = _halo_blocks(kst, 2, 8 * 5, 33, cin, 3, 3, 8, gen, dev)
        wt = torch.randn((3, 3, cin, cout), generator=gen, device=dev)
        _stencil_case(kst, blocks, wt, f"C={cin}, O={cout}, W=33")
    return main


# -- stencil: the VGG-16 block-1 forward --------------------------------------


def _vgg_params(dev):
    """Seeded He-scaled 3x3 filters (HWIO) and small biases for the block's
    two convolutions, and the batch of images (NHWC)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(30)
    params = []
    for cin, cout in zip(VGG_WIDTHS[:-1], VGG_WIDTHS[1:]):
        w = torch.randn((3, 3, cin, cout), generator=gen, device=dev) \
            * (2.0 / (9 * cin)) ** 0.5
        b = 0.01 * torch.randn((cout,), generator=gen, device=dev)
        params.append((w, b))
    x = torch.randn((VGG_N, VGG_HW, VGG_HW, VGG_WIDTHS[0]), generator=gen,
                    device=dev)
    return x, params


def vgg_block1(st, x, params):
    """conv3-64, ReLU, conv3-64, ReLU, maxpool 2x2 stride 2 (VGG-16
    configuration D, block 1) as port expressions."""
    h = x
    for w, b in params:
        h = st.maximum(st.stencil(h, w) + b, 0.0)
    return st.maxpool(h, 2)


def _vgg_float64(x, params, pool: bool = True, bias: bool = True):
    import torch.nn.functional as F

    h = x.double().permute(0, 3, 1, 2)
    for w, b in params:
        h = F.conv2d(h, w.double().permute(3, 2, 0, 1),
                     b.double() if bias else None, padding=1).clamp_min(0.0)
    if pool:
        h = F.max_pool2d(h, 2)
    return h.permute(0, 2, 3, 1)


def phase_vgg(st, kk, kst, card: str, dev) -> dict:
    import torch.nn.functional as F
    from spartan_tpu_torch.array.distarray import from_tensor

    x, params = _vgg_params(dev)
    X = from_tensor(x, tiling=st.Tiling((None, "x", None, None)))
    P = [(from_tensor(w), from_tensor(b)) for w, b in params]

    def forward():
        return vgg_block1(st, X, P).evaluate()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    _reset_counts(kk)
    t0 = time.perf_counter()
    out = forward().tensor
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = kst.LAUNCHES["conv_block"]
    mma = kst.LAUNCHES["conv_block_mma"]
    peak = (torch.cuda.max_memory_allocated() - live) / 1e9
    _say(f"[stencil] VGG-16 block 1 (conv3-64, ReLU, conv3-64, ReLU, maxpool"
         f" 2) on {VGG_N} x {VGG_HW}x{VGG_HW}x{VGG_WIDTHS[0]} f32 under a "
         f"logical {VGG_MESH} mesh, H tiled: first forward {first:.3f} s, "
         f"conv_block launches {launches} (want 2), of them on the "
         f"tensor-core route {mma} (want 1: conv1_2), peak device memory "
         f"{peak:.2f} GB above the {live / 1e9:.2f} GB live before it")
    if launches != 2:
        _fail(f"conv_block ran {launches} times in one forward, not 2")
    if mma != 1:
        _fail(f"conv1_2 did not take the tensor-core route ({mma} launches)")
    want_shape = (VGG_N, VGG_HW // 2, VGG_HW // 2, VGG_WIDTHS[-1])
    if tuple(out.shape) != want_shape or not bool(out.isfinite().all()):
        _fail(f"VGG block output {tuple(out.shape)} is not finite "
              f"{want_shape}")
    ref = _vgg_float64(x[:2], [(w, b) for w, b in params])
    rel = float(((out[:2].double() - ref).abs().max()
                 / ref.abs().max()).item())
    _say(f"[stencil] two images against a float64 conv2d forward: "
         f"max |err| / max |ref| {rel:.3g} (want <= 1e-5)")
    if rel > 1e-5:
        _fail("the VGG block disagrees with its float64 forward")
    st.FLAGS.native_kernels = "off"
    _reset_counts(kk)
    off = forward().tensor
    off_launches = kst.LAUNCHES["conv_block"]
    st.FLAGS.native_kernels = "auto"
    # rtol 1e-4 plus an atol of 1e-6 of the largest output, for outputs
    # that sit near 0 where ReLU cut most of a sum away
    atol = 1e-6 * float(off.abs().max().item())
    diff = (out - off).abs()
    bad = int((diff > 1e-4 * off.abs() + atol).sum().item())
    _say(f"[stencil] whole batch against the native_kernels=off forward "
         f"(F.conv2d, TF32 off; {off_launches} kernel launches): max |diff| "
         f"{float(diff.max().item()):.3g}, {bad} of {off.numel()} outside "
         f"rtol 1e-4 + atol {atol:.3g}")
    if bad or off_launches:
        _fail("the VGG block disagrees with its native_kernels=off forward")
    ms = _wall_ms(forward)
    _say(f"[stencil] per forward: {ms:.2f} ms, {VGG_N / ms * 1e3:.1f} "
         f"images/s (best of 3, host clock to a synchronise) on {card}")
    _device_split(forward, "stencil", card, top=6)

    flops_peak, bw_peak = _peaks(card)
    tf32_peak = _tf32_peak(card)
    per_width = []
    h = x
    for (w, b) in params:
        kh, kw, c, o = w.shape
        blocks = kst.halo_exchange(h, kh, kw, VGG_MESH[0])
        p, n = blocks.shape[:2]
        flat = blocks.reshape(p * n, *blocks.shape[2:])
        ms_k = _event_ms(lambda: kst.conv_block(blocks, w), 10)
        plain = _event_ms(lambda: kst.conv_block_plain(flat, w), 3,
                          warmup=1)
        xc = flat.permute(0, 3, 1, 2)  # channels_last view, no copy
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = _event_ms(lambda: F.conv2d(xc, wc), 10)
        # the launch's own count (kernels/stencil.cost), which
        # st.explain's cost_analysis reports for the stencil node too
        flops, nbytes = kst.cost(tuple(blocks.shape), tuple(w.shape))
        # f32-accurate operations: FP32 FMAs on the CUDA cores, or on the
        # tensor-core route three TF32 products per product (3xTF32)
        route = kst.route(c)
        f_ms = flops / flops_peak * 1e3
        t_ms = 3.0 * flops / tf32_peak * 1e3
        b_ms = nbytes / bw_peak * 1e3
        ops = t_ms if route == "mma" else f_ms
        bound, by = (ops, "operations") if ops >= b_ms else (b_ms, "bytes")
        _say(f"[stencil] conv_block {c}->{o} at {tuple(blocks.shape)} "
             f"({route} route): kernel {ms_k:.4f} ms ({flops / ms_k / 1e9:.2f}"
             f" TFLOP/s), plain {plain:.4f} ms, library {lib:.4f} ms "
             f"(F.conv2d on the same blocks, TF32 off), bound {bound:.4f} ms "
             f"({by}{', 3xTF32' if route == 'mma' and by != 'bytes' else ''};"
             f" 3xTF32 {t_ms:.4f}, FP32 {f_ms:.4f}, bytes {b_ms:.4f}: "
             f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e9:.3f} GB) on {card}")
        per_width.append({"ms": ms_k, "plain_ms": plain, "library_ms": lib,
                          "bound_ms": bound, "bound_by": by,
                          "bound_fp32_ms": max(f_ms, b_ms)})
        h = (kst.conv_block(blocks, w) + b).clamp_min(0.0)
        del blocks, flat, xc
    res = dict(per_width[-1])
    res["launches"] = launches
    # [obs] profiles this forward: its inputs and each width's kernel ms
    res["conv_ms"] = [pw["ms"] for pw in per_width]
    return res


# -- the structure ops ---------------------------------------------------------


def _structure_case(label: str, build, want, card: str, rtol=None) -> None:
    """``build()`` evaluated and fetched against numpy's ``want`` (bit for
    bit, or within ``rtol`` of the largest entry of a float64 ``want``),
    then its wall time per evaluate."""
    got = build().glom()
    if rtol is None:
        ok = got.shape == want.shape and got.dtype == want.dtype and \
            np.array_equal(got, want)
        how = "bit-equal to numpy"
    else:
        # normwise: entries of randn products cancel to near 0, where an
        # elementwise relative error means nothing
        err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        ok = got.shape == want.shape and err <= rtol
        how = (f"max |err| / max |float64| {err:.3g} (want <= {rtol:g})")
    ms = _wall_ms(lambda: build().evaluate())
    _say(f"[structure] {label}: {how} -> {'ok' if ok else 'MISMATCH'}, "
         f"{ms:.2f} ms per evaluate (best of 3) on {card}")
    if not ok:
        _fail(f"structure op {label} disagrees with numpy")


def _shuffle_transposed(ext, block):
    yield ((ext.ul[1], ext.ul[0]), (ext.lr[1], ext.lr[0])), block.T


def phase_structure(st, card: str, dev) -> None:
    """transpose / reshape / ravel / concatenate / assign / write_array /
    outer / einsum / tensordot / shuffle at sizes users run, each against
    numpy. No hand-written kernel runs here: the JAX package has no
    Pallas kernel for these ops."""
    from spartan_tpu_torch.array.distarray import from_tensor

    gen = torch.Generator(device=dev)
    gen.manual_seed(31)
    n = STRUCT_N
    a = torch.rand((n, n), generator=gen, device=dev)
    b = torch.rand((n, n), generator=gen, device=dev)
    A, B = st.as_expr(from_tensor(a)), st.as_expr(from_tensor(b))
    an, bn = a.cpu().numpy(), b.cpu().numpy()
    _structure_case(f"transpose {n}^2 f32", lambda: A.T, an.T, card)
    _structure_case(f"reshape {n}^2 -> ({n // 4}, {4 * n})",
                    lambda: st.reshape(A, (n // 4, 4 * n)),
                    an.reshape(n // 4, 4 * n), card)
    _structure_case(f"ravel {n}^2", lambda: st.ravel(A), an.ravel(), card)
    _structure_case(f"concatenate two {n}^2 along axis 0",
                    lambda: st.concatenate([A, B]),
                    np.concatenate([an, bn]), card)
    _structure_case(f"concatenate two {n}^2 along axis 1",
                    lambda: st.concatenate([A, B], axis=1),
                    np.concatenate([an, bn], axis=1), card)
    region = (slice(1000, 5000), slice(2048, 8192))
    want = an.copy()
    want[region] += bn[region]
    _structure_case("assign(A, region, B[region], reducer='add')",
                    lambda: st.assign(A, region, B[region], reducer="add"),
                    want, card)
    want = np.zeros((n, n), np.float32)
    want[region] = bn[region]
    _structure_case(f"write_array({n}^2, region, B[region])",
                    lambda: st.write_array((n, n), region, B[region]),
                    want, card)
    del want, bn
    u = torch.rand(OUTER_N, generator=gen, device=dev)
    v = torch.rand(OUTER_N, generator=gen, device=dev)
    U, V = st.as_expr(from_tensor(u)), st.as_expr(from_tensor(v))
    un, vn = u.cpu().numpy(), v.cpu().numpy()
    _structure_case(f"outer of two {OUTER_N}-vectors", lambda: st.outer(U, V),
                    np.outer(un, vn), card)
    _structure_case(f"outer of two {OUTER_N}-vectors, fn=minimum",
                    lambda: st.outer(U, V, torch.minimum),
                    np.minimum.outer(un, vn), card)
    bi = torch.randn((EINSUM_B, EINSUM_N, EINSUM_N), generator=gen,
                     device=dev)
    bj = torch.randn((EINSUM_B, EINSUM_N, EINSUM_N), generator=gen,
                     device=dev)
    BI, BJ = from_tensor(bi), from_tensor(bj)
    _structure_case(
        f"einsum('bij,bjk->bik') at {EINSUM_B}x{EINSUM_N}x{EINSUM_N}",
        lambda: st.einsum("bij,bjk->bik", BI, BJ),
        torch.einsum("bij,bjk->bik", bi.double(), bj.double()).cpu().numpy(),
        card, rtol=1e-4)
    p3 = torch.randn((1024, 64, 256), generator=gen, device=dev)
    q3 = torch.randn((256, 64, 512), generator=gen, device=dev)
    P3, Q3 = from_tensor(p3), from_tensor(q3)
    _structure_case(
        "tensordot((1024, 64, 256), (256, 64, 512), axes=([1, 2], [1, 0]))",
        lambda: st.tensordot(P3, Q3, axes=([1, 2], [1, 0])),
        torch.tensordot(p3.double(), q3.double(),
                        dims=([1, 2], [1, 0])).cpu().numpy(), card,
        rtol=1e-4)
    m = SHUFFLE_N
    s = torch.rand((m, m), generator=gen, device=dev)
    sn = s.cpu().numpy()
    with st.use_mesh(st.build_mesh(VGG_MESH)):
        S = from_tensor(s, tiling=st.Tiling(("x", None)))
        _structure_case(
            f"shuffle of {m}^2 over (8, 1) tiles, each tile emitted "
            f"transposed under 'add'",
            lambda: st.shuffle(S, _shuffle_transposed, target_shape=(m, m),
                               combiner="add"), sn.T, card)


# -- the application tier ---------------------------------------------------


def _rel(got, want) -> float:
    """Normwise relative error in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        _fail(f"shape {got.shape} where {want.shape} was expected")
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-300))


def _check_rel(label: str, got, want, rtol: float, what: str) -> None:
    err = _rel(got, want)
    finite = bool(np.isfinite(np.asarray(got, np.float64)).all())
    _say(f"[examples] {label}: vs {what}: normwise rel err {err:.3g} "
         f"(rtol {rtol:g}){'' if finite else ', NOT FINITE'}")
    if not (finite and err <= rtol):
        _fail(f"{label} disagrees with {what}")


def _logreg_f64(x, y, iters: int, lr: float) -> np.ndarray:
    """logistic_regression's steps in float64 numpy."""
    w = np.zeros(x.shape[1])
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-(x @ w)))
        w = w - lr * (x.T @ (p - y) / x.shape[0])
    return w


def _gd_f64(x, y, iters: int, lr: float, grad) -> np.ndarray:
    """``iters`` steps of ``w -= lr * grad(x, y, w)`` from 0 in float64 on
    the card (plain torch; a host pass over 10M x 32 takes ~0.3 s)."""
    w = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    for _ in range(iters):
        w = w - lr * grad(x, y, w)
    return w.cpu().numpy()


def _examples_regression(st, card: str, dev) -> dict:
    """Logistic regression at bench.py's size (fused through st.loop),
    then linear, ridge and SVM on the same X."""
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.examples import regression, svm

    n, d, iters = EX_LR_N, EX_LR_D, EX_LR_ITERS
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    # bench.py's X (uniform f32); labels from a planted direction
    x = torch.rand((n, d), generator=gen, device=dev)
    w_true = torch.randn((d,), generator=gen, device=dev)
    y01 = ((x - 0.5) @ w_true > 0).float()
    X, Y = from_tensor(x), from_tensor(y01)

    t0 = time.perf_counter()
    w = regression.logistic_regression(X, Y, num_iter=iters)
    first = time.perf_counter() - t0
    x64 = x.cpu().numpy().astype(np.float64)
    ref = _logreg_f64(x64, y01.cpu().numpy().astype(np.float64), iters, 0.1)
    del x64
    _check_rel(f"logistic_regression {n} x {d}, {iters} iterations "
               f"(first call {first:.3f} s)", w, ref, 1e-4,
               "the same steps in float64 numpy")

    def fit() -> None:
        regression.logistic_regression(X, Y, num_iter=iters)

    best = _wall_ms(fit)
    ips = iters / (best / 1e3)
    flops_peak, bw_peak = _peaks(card)
    two_pass = 2.0 * n * d * 4 / bw_peak * 1e3  # X @ w, then X.T @ err
    one_pass = n * d * 4 / bw_peak * 1e3
    ops_ms = 4.0 * n * d / flops_peak * 1e3
    _say(f"[examples] logreg {ips:.2f} iters/s ({best:.3f} ms per "
         f"{iters}-iteration fit, best of 3 after a warm-up; "
         f"{best / iters:.4f} ms an iteration) against a bound of "
         f"{two_pass:.4f} ms an iteration ({1e3 / two_pass:.1f} iters/s: "
         f"X read twice, by X @ w and X.T @ err; bytes, operations "
         f"{ops_ms:.4f} ms; a one-pass fused step's bound {one_pass:.4f} "
         f"ms) on {card}")
    _device_split(fit, f"examples: logreg fit of {iters} iterations", card)

    x64 = x.double()
    y_lin = x @ w_true
    ypm = 2.0 * y01 - 1.0
    cases = [
        ("linear_regression", lambda: regression.linear_regression(
            X, from_tensor(y_lin), num_iter=iters),
         lambda a, b, w: a.T @ (a @ w - b) / a.shape[0], y_lin, 1e-2),
        ("ridge_regression", lambda: regression.ridge_regression(
            X, from_tensor(y_lin), num_iter=iters),
         lambda a, b, w: a.T @ (a @ w - b) / a.shape[0] + 1.0 * w, y_lin,
         1e-2),
        ("svm", lambda: svm.svm(X, from_tensor(ypm), num_iter=iters),
         lambda a, b, w: -(a.T @ ((b * (a @ w) < 1.0).double() * b))
         / a.shape[0] + 1e-3 * w, ypm, 0.1),
    ]
    for name, run, grad, target, lr in cases:
        t0 = time.perf_counter()
        got = run()
        wall = time.perf_counter() - t0
        ref = _gd_f64(x64, target.double(), iters, lr, grad)
        _check_rel(f"{name} on the same X, {iters} iterations ({wall:.3f} "
                   f"s wall)", got, ref, 1e-4,
                   "the same steps in float64 on the card")
    return {"logreg_iters_per_sec": ips, "logreg_ms": best}


def _ssvd_f64(a, rank: int, k: int, power: int, seed: int):
    """ssvd's steps in float64 numpy, from the same Omega."""
    omega = np.random.RandomState(seed).randn(a.shape[1], k).astype(
        np.float32).astype(np.float64)
    q = np.linalg.qr(a @ omega)[0]
    for _ in range(power):
        q = np.linalg.qr(a @ np.linalg.qr(a.T @ q)[0])[0]
    u_b, s, vt = np.linalg.svd(q.T @ a, full_matrices=False)
    return (q @ u_b)[:, :rank], s[:rank], vt[:rank]


def _lanczos_host(a, steps: int, rank: int, seed: int, dt) -> np.ndarray:
    """lanczos_svd's recurrence on the host in ``dt`` (the port's and the
    JAX package's is float32), with float64 products rounded to ``dt``:
    the top ``rank`` singular values of its bidiagonal B."""
    u = np.random.RandomState(seed).randn(a.shape[0]).astype(
        np.float32).astype(dt)
    u /= np.linalg.norm(u)
    us, vs, alphas, betas = [u], [], [], []
    for _ in range(steps):
        v = (a.T @ us[-1].astype(np.float64)).astype(dt)
        for prev in vs:
            v -= prev * (prev @ v)
        alphas.append(np.linalg.norm(v))
        vs.append(v / alphas[-1])
        u = (a @ vs[-1].astype(np.float64)).astype(dt)
        for prev in us:
            u -= prev * (prev @ u)
        betas.append(np.linalg.norm(u))
        us.append(u / betas[-1])
    b = np.zeros((steps + 1, steps), dt)
    for j in range(steps):
        b[j, j], b[j + 1, j] = alphas[j], betas[j]
    return np.linalg.svd(b, compute_uv=False)[:rank]


def _residual(a, u, s, vt) -> float:
    a = np.asarray(a, np.float64)
    return float(np.linalg.norm(a - (u * s[None, :]) @ vt))


def _examples_svd(st, card: str, dev) -> dict:
    """SSVD at bench.py's size, and Lanczos SVD of the same matrix."""
    from spartan_tpu_torch.examples import lanczos, ssvd

    m, n, rank = EX_SSVD_M, EX_SSVD_N, EX_SSVD_RANK
    a_np = np.random.RandomState(44).rand(m, n).astype(np.float32)
    a64 = a_np.astype(np.float64)
    A = st.from_numpy(a_np)
    k = min(rank + 10, m, n)

    u, s, vt = ssvd.ssvd(A, rank=rank)
    u_r, s_r, vt_r = _ssvd_f64(a64, rank, k, 2, 0)
    # the same steps in float64: each QR is backward stable, so Q carries
    # ~eps_f32 * cond(Y) (cond ~ s_1/s_k ~ 31 here) and, by Weyl, each
    # singular value moves by at most ~|dB| ~ 1e-6 |A|: 1e-4 relative
    _check_rel(f"ssvd {m} x {n} rank {rank} (k = {k}, 2 power iterations) "
               f"singular values", s, s_r, 1e-4,
               "the same steps in float64 numpy (same Omega)")
    res, res_r = _residual(a64, u, s, vt), _residual(a64, u_r, s_r, vt_r)
    _check_rel("ssvd residual |A - U S V^T|_F", res, res_r, 1e-4,
               f"float64's {res_r:.6g}")
    sec = _wall_ms(lambda: ssvd.ssvd(A, rank=rank)) / 1e3
    _say(f"[examples] ssvd {sec:.4f} s ({m} x {n}, rank {rank}, best of 3 "
         f"after a warm-up) on {card}")
    _device_split(lambda: ssvd.ssvd(A, rank=rank), "examples: ssvd", card)

    steps = rank + 6
    t0 = time.perf_counter()
    _, s_l, _ = lanczos.lanczos_svd(A, rank=rank)
    wall = time.perf_counter() - t0
    # the device computes only the products: against the same float32
    # host recurrence fed float64 products, agreement is the products'
    # rounding (3e-7 on the CPU)
    _check_rel(f"lanczos_svd rank {rank} ({steps} steps, {wall:.3f} s "
               f"wall) singular values", s_l,
               _lanczos_host(a64, steps, rank, 0, np.float32), 1e-4,
               "the same float32 host recurrence with float64 products")
    # the float32 host recurrence itself (the JAX package's) moves the
    # unconverged values away from a float64 recurrence's (1.7% at the
    # tail on the CPU); the converged top value must hold
    s64 = _lanczos_host(a64, steps, rank, 0, np.float64)
    tail = float(np.max(np.abs(s_l - s64) / s64))
    _say(f"[examples] lanczos_svd vs the float64 recurrence: top value "
         f"rel err {abs(s_l[0] - s64[0]) / s64[0]:.3g} (rtol 1e-5), the "
         f"unconverged rest up to {tail:.3g} (the float32 host "
         f"recurrence's own drift, not gated)")
    if not abs(s_l[0] - s64[0]) <= 1e-5 * s64[0]:
        _fail("lanczos_svd's converged top value disagrees with float64")
    return {"ssvd_s": sec}


def _blobs(n: int, d: int, k: int, scale: float, seed: int, first_rows):
    """Points around k well-separated centers; row ``first_rows[j]`` is
    in cluster j (an estimator seeded to pick those rows starts with one
    center a cluster)."""
    rng = np.random.RandomState(seed)
    true = (rng.rand(k, d) * scale).astype(np.float32)
    lab = rng.randint(0, k, n)
    lab[first_rows] = np.arange(k)
    pts = true[lab] + (0.05 * scale / 4.0 * rng.randn(n, d)).astype(
        np.float32)
    return pts.astype(np.float32), lab


def _examples_estimators(st, kk, ks, nb, card: str, dev) -> dict:
    """KMeans through the fused k-means kernel, MultinomialNB through the
    segment kernel, each against its run through the plain version."""
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.examples.sklearn import KMeans, MultinomialNB

    n, d, k, iters = EX_KM_N, KM_D, EX_KM_K, EX_KM_ITERS
    first = np.sort(np.random.RandomState(0).choice(n, k, replace=False))
    pts, lab = _blobs(n, d, k, 4.0, 45, first)
    P = st.from_numpy(pts)
    _reset_counts(kk)
    t0 = time.perf_counter()
    est = KMeans(n_clusters=k, max_iter=iters, random_state=0).fit(P)
    wall = time.perf_counter() - t0
    km_launches = kk.LAUNCHES
    _say(f"[examples] KMeans(n_clusters={k}, max_iter={iters}).fit() "
         f"{n} x {d}: {wall:.3f} s wall, k-means kernel launches "
         f"{km_launches} (want {iters})")
    if km_launches != iters:
        _fail(f"KMeans.fit launched the k-means kernel {km_launches} "
              f"times, want {iters}")
    if not np.array_equal(est.labels_, lab):
        _fail(f"KMeans mislabelled {int((est.labels_ != lab).sum())} rows")
    p = P.value.tensor
    npad = km._kernel_pad(n)
    if npad != n:
        p = torch.cat([p, p.new_zeros((npad - n, d))])
    ref = _plain_kmeans(kk, p, torch.from_numpy(pts[first]).to(dev), k,
                        iters, n).cpu().numpy()
    diff = float(np.abs(est.cluster_centers_ - ref).max())
    _say(f"[examples] KMeans: every row in its true cluster; centers vs "
         f"the plain-driven run: max |diff| {diff:.3g} (atol 1e-4)")
    if not diff <= 1e-4:
        _fail("KMeans centers disagree with the plain-driven run")
    if not np.array_equal(est.predict(P), est.labels_):
        _fail("KMeans.predict disagrees with labels_")

    x, yt, _ = _nb_data(dev)
    X, Y = from_tensor(x), from_tensor(yt)
    prev = st.FLAGS.native_kernels
    try:
        st.FLAGS.native_kernels = "on"
        _reset_counts(kk)
        t0 = time.perf_counter()
        nbe = MultinomialNB().fit(X, Y)
        wall = time.perf_counter() - t0
        nb_launches = ks.LAUNCHES["segment_sum_block"]
        lp, ll = nb.fit(X, Y, NB_CLASSES)
    finally:
        st.FLAGS.native_kernels = prev
    same = (np.array_equal(nbe.class_log_prior_, lp)
            and np.array_equal(nbe.feature_log_prob_, ll))
    _say(f"[examples] MultinomialNB().fit() {NB_ROWS} x {NB_FEATURES}, "
         f"{NB_CLASSES} classes, native_kernels=on: {wall:.3f} s wall, "
         f"segment-kernel launches {nb_launches}; tables bit-equal to "
         f"examples.naive_bayes.fit: {same}")
    if nb_launches < 1:
        _fail("MultinomialNB.fit did not launch the segment kernel")
    if not same:
        _fail("MultinomialNB tables differ from examples.naive_bayes.fit")
    return {"kmeans_launches": km_launches, "nb_launches": nb_launches}


def _cg_f64(a, b, iters: int, tol: float) -> np.ndarray:
    """conj_gradient's steps in float64 numpy."""
    x = np.zeros_like(b)
    r = b - a @ x
    p = r
    rs_old = r @ r
    for _ in range(iters):
        ap = a @ p
        alpha = rs_old / (p @ ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = r @ r
        if np.sqrt(rs_new) < tol:
            break
        p = r + (rs_new / rs_old) * p
        rs_old = rs_new
    return x


def _fuzzy_f64(pts, centers, iters: int, m: float) -> np.ndarray:
    """fuzzy_kmeans' steps in float64 numpy."""
    p, c = pts.astype(np.float64), centers.astype(np.float64)
    for _ in range(iters):
        d2 = ((p * p).sum(1)[:, None] - 2.0 * p @ c.T
              + (c * c).sum(1)[None, :])
        inv = np.maximum(d2, 1e-12) ** (-1.0 / (m - 1.0))
        um = (inv / inv.sum(1, keepdims=True)) ** m
        c = (um.T @ p) / np.maximum(um.sum(0), 1e-12)[:, None]
    return c


def _qr_check(label: str, q, r, a64, r64) -> None:
    """Sign-free: Q R against A, Q^T Q against I, |R| against float64's."""
    q64, rr = np.asarray(q, np.float64), np.asarray(r, np.float64)
    _check_rel(f"{label}: Q R", q64 @ rr, a64, 1e-5, "A")
    _check_rel(f"{label}: Q^T Q", q64.T @ q64, np.eye(q64.shape[1]), 1e-5,
               "I")
    _check_rel(f"{label}: |R|", np.abs(rr), np.abs(r64), 1e-5,
               "float64 numpy's |R|")


def _examples_solvers(st, card: str, dev) -> None:
    """CG, fuzzy k-means and the decompositions."""
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.examples import (conj_gradient, decomposition,
                                            fuzzy_kmeans)

    n = EX_CG_N
    gen = torch.Generator(device=dev)
    gen.manual_seed(46)
    g = torch.randn((n, n), generator=gen, device=dev)
    spd = g @ g.T / n + torch.eye(n, device=dev)  # eigenvalues in ~[1, 5]
    x_true = torch.randn((n,), generator=gen, device=dev)
    b = spd @ x_true
    spd64 = spd.cpu().numpy().astype(np.float64)
    t0 = time.perf_counter()
    x = conj_gradient.conj_gradient(from_tensor(spd), from_tensor(b),
                                    num_iter=EX_CG_ITERS)
    wall = time.perf_counter() - t0
    _check_rel(f"conj_gradient {n}^2 SPD, {EX_CG_ITERS} iterations "
               f"({wall:.3f} s wall)", x,
               _cg_f64(spd64, b.cpu().numpy().astype(np.float64),
                       EX_CG_ITERS, 1e-6), 1e-4,
               "the same steps in float64 numpy")

    fn, fd, fk = EX_FZ_N, EX_FZ_D, EX_FZ_K
    first = np.sort(np.random.RandomState(0).choice(fn, fk, replace=False))
    pts, _ = _blobs(fn, fd, fk, 40.0, 47, first)
    t0 = time.perf_counter()
    c = fuzzy_kmeans.fuzzy_kmeans(st.from_numpy(pts), fk,
                                  num_iter=EX_FZ_ITERS)
    wall = time.perf_counter() - t0
    _check_rel(f"fuzzy_kmeans {fn} x {fd}, k = {fk}, {EX_FZ_ITERS} "
               f"iterations ({wall:.3f} s wall)", c,
               _fuzzy_f64(pts, pts[first], EX_FZ_ITERS, 2.0), 1e-4,
               "the same steps in float64 numpy")

    with st.use_mesh(st.build_mesh(EX_QR_MESH)):
        t0 = time.perf_counter()
        chol = decomposition.cholesky(from_tensor(spd)).glom()
        wall = time.perf_counter() - t0
        _check_rel(f"cholesky {n}^2 ({wall:.3f} s wall)", chol,
                   np.linalg.cholesky(spd64), 1e-5,
                   "float64 numpy (the factor is unique)")
        qm, qn = EX_QR_M, EX_QR_N
        a_np = np.random.RandomState(48).randn(qm, qn).astype(np.float32)
        a64 = a_np.astype(np.float64)
        r64 = np.linalg.qr(a64)[1]
        for name in ("qr", "tsqr"):
            t0 = time.perf_counter()
            q, r = getattr(decomposition, name)(st.from_numpy(a_np))
            wall = time.perf_counter() - t0
            _qr_check(f"{name} {qm} x {qn} under a logical {EX_QR_MESH} "
                      f"mesh ({wall:.3f} s wall)", q, r, a64, r64)


def _movielens():
    """MovieLens-100K's shape, synthetic: 100,000 distinct (user, item)
    pairs, integer ratings 1-5 from a rank-5 model plus noise."""
    rng = np.random.RandomState(49)
    nu, ni = EX_ML_USERS, EX_ML_ITEMS
    flat = rng.choice(nu * ni, EX_ML_RATINGS, replace=False)
    rows, cols = flat // ni, flat % ni
    score = (rng.randn(nu, 5) @ rng.randn(5, ni)) / np.sqrt(5.0)
    vals = np.clip(np.rint(3.0 + score[rows, cols]
                           + 0.5 * rng.randn(rows.size)), 1, 5)
    dense = np.zeros((nu, ni), np.float32)
    dense[rows, cols] = vals
    return rows, cols, vals.astype(np.float32), dense


def _als_f64(r, k: int, iters: int, reg: float, seed: int):
    """als' steps in float64 numpy (batched normal equations)."""
    v = (np.random.RandomState(seed).rand(r.shape[1], k).astype(np.float32)
         * 0.1).astype(np.float64)
    r = r.astype(np.float64)

    def side(rr, other):
        w = (rr != 0).astype(np.float64)
        a = np.einsum("mn,nk,nl->mkl", w, other, other) + reg * np.eye(k)
        return np.linalg.solve(a, ((w * rr) @ other)[:, :, None])[:, :, 0]

    for _ in range(iters):
        u = side(r, v)
        v = side(r.T, u)
    return u, v


def _netflix_f64(r, k: int, iters: int, lr: float, reg: float, seed: int):
    """netflix_sgd's steps in float64 numpy."""
    rng = np.random.RandomState(seed)
    u = (rng.rand(r.shape[0], k).astype(np.float32) * 0.1).astype(np.float64)
    v = (rng.rand(r.shape[1], k).astype(np.float32) * 0.1).astype(np.float64)
    mask = (r != 0).astype(np.float64)
    for _ in range(iters):
        err = (u @ v.T - r) * mask
        cnt = max(mask.sum(), 1.0)
        u, v = (u - lr * (err @ v / cnt + reg * u),
                v - lr * (err.T @ u / cnt + reg * v))
    return u, v


def _mf_f64(ratings, k: int, epochs: int, lr: float, reg: float,
            batch: int, seed: int):
    """sgd_matrix_factorization's epochs in float64 numpy over the same
    permuted entry stream; padding entries skipped."""
    nu, ni = ratings.shape
    rng = np.random.RandomState(seed)
    scale = 1.0 / np.sqrt(k)
    u = (rng.rand(nu, k).astype(np.float32) * scale).astype(np.float64)
    v = (rng.rand(ni, k).astype(np.float32) * scale).astype(np.float64)
    perm = rng.permutation(ratings.nse)
    rows = ratings.rows.cpu().numpy()[perm]
    cols = ratings.cols.cpu().numpy()[perm]
    vals = ratings.data.cpu().numpy()[perm].astype(np.float64)
    batch = min(batch, rows.size)
    for _ in range(epochs):
        for s in range(0, rows.size, batch):
            r, c, x = rows[s:s + batch], cols[s:s + batch], vals[s:s + batch]
            ok = (r < nu) & (c < ni)
            r, c, x = r[ok], c[ok], x[ok]
            ur, vr = u[r], v[c]
            err = (ur * vr).sum(1) - x
            np.add.at(u, r, -lr * (err[:, None] * vr + reg * ur))
            np.add.at(v, c, -lr * (err[:, None] * ur + reg * vr))
    return u, v


def _examples_factorizations(st, card: str, dev) -> None:
    """ALS, Netflix SGD and sparse SGD matrix factorization at
    MovieLens-100K's shape."""
    from spartan_tpu_torch.examples import als, decomposition, matrix_fact

    rows, cols, vals, dense = _movielens()
    k = EX_ML_K
    what = "the same steps in float64 numpy"
    R = st.from_numpy(dense)
    t0 = time.perf_counter()
    u, v = als.als(R, k=k, num_iter=5, reg=0.1)
    wall = time.perf_counter() - t0
    u_r, v_r = _als_f64(dense, k, 5, 0.1, 0)
    # normal equations of ~106 ratings a user: entries differ from
    # float64's by summation order; the solves amplify by their condition
    # (2.3e-6 measured through torch on the CPU)
    _check_rel(f"als {EX_ML_USERS} x {EX_ML_ITEMS}, {EX_ML_RATINGS} "
               f"ratings, k = {k}, 5 iterations ({wall:.3f} s wall): "
               f"U V^T", u @ v.T, u_r @ v_r.T, 1e-4, what)

    t0 = time.perf_counter()
    u, v = decomposition.netflix_sgd(R, k=k, num_iter=10)
    wall = time.perf_counter() - t0
    u_r, v_r = _netflix_f64(dense.astype(np.float64), k, 10, 0.01, 0.05, 0)
    _check_rel(f"netflix_sgd same ratings, 10 iterations ({wall:.3f} s "
               f"wall): U", u, u_r, 1e-5, what)
    _check_rel("netflix_sgd: V", v, v_r, 1e-5, what)

    ratings = st.SparseDistArray.from_coo(rows, cols, vals,
                                          (EX_ML_USERS, EX_ML_ITEMS))
    t0 = time.perf_counter()
    u, v = matrix_fact.sgd_matrix_factorization(ratings, k=k, num_epochs=5)
    wall = time.perf_counter() - t0
    u_r, v_r = _mf_f64(ratings, k, 5, 0.02, 0.02, 4096, 0)
    # index_add_ on the card sums a batch's duplicate rows atomically in
    # any order: float32 rounding of a few terms a row per step
    _check_rel(f"sgd_matrix_factorization {ratings.nnz} ratings (nse "
               f"{ratings.nse}), 5 epochs of batches of 4096 ({wall:.3f} s "
               f"wall): U", u, u_r, 1e-4, what)
    _check_rel("sgd_matrix_factorization: V", v, v_r, 1e-4, what)
    err = matrix_fact.rmse(ratings, u, v)
    _check_rel("rmse", err, np.sqrt(np.mean(
        ((u_r[rows] * v_r[cols]).sum(1) - vals) ** 2)), 1e-4,
        "float64 of the oracle's factors")


def _lda_f64(counts, k: int, iters: int, alpha: float, beta: float,
             seed: int):
    """lda's EM steps in float64 on the card (plain torch: the (D, W)
    slices of 8192 x 16,384 take seconds a pass in numpy)."""
    d, w = counts.shape
    rng = np.random.RandomState(seed)
    theta = rng.rand(d, k).astype(np.float32) + 0.5
    theta /= theta.sum(axis=1, keepdims=True)
    phi = rng.rand(k, w).astype(np.float32) + 0.5
    phi /= phi.sum(axis=1, keepdims=True)
    c = counts.double()
    th = torch.from_numpy(theta).double().to(c.device)
    ph = torch.from_numpy(phi).double().to(c.device)
    for _ in range(iters):
        denom = torch.clamp_min(th @ ph, 1e-30)
        new_th, new_ph = torch.empty_like(th), torch.empty_like(ph)
        for t in range(k):
            r_t = c * th[:, t, None] * ph[None, t, :] / denom
            new_ph[t], new_th[:, t] = r_t.sum(0), r_t.sum(1)
        th = new_th + alpha
        th = th / th.sum(1, keepdim=True)
        ph = new_ph + beta
        ph = ph / ph.sum(1, keepdim=True)
    return th.cpu().numpy(), ph.cpu().numpy()


def _examples_text(st, card: str, dev) -> None:
    """LDA on an 8,192 x 16,384 count matrix; LSH signatures at 1M x 128
    and candidate pairs on a few thousand points with planted
    near-duplicates."""
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.examples import lda, lsh

    nd, nw, k = EX_LDA_DOCS, EX_LDA_WORDS, EX_LDA_K
    gen = torch.Generator(device=dev)
    gen.manual_seed(50)
    # k topics on disjoint quarters of the vocabulary; a document draws
    # ~0.1 of a count per word of its topic's quarter, ~0.01 elsewhere
    topic = torch.arange(nd, device=dev) % k
    block = torch.arange(nw, device=dev) // (nw // k)
    rate = torch.where(topic[:, None] == block[None, :], 0.1, 0.01)
    counts = torch.poisson(rate, generator=gen)
    del rate
    C = from_tensor(counts)
    t0 = time.perf_counter()
    theta, phi = lda.lda(C, k, num_iter=EX_LDA_ITERS)
    wall = time.perf_counter() - t0
    th_r, ph_r = _lda_f64(counts, k, EX_LDA_ITERS, 0.1, 0.01, 0)
    what = "the same EM steps in float64 on the card"
    _check_rel(f"lda {nd} x {nw} counts, k = {k}, {EX_LDA_ITERS} iterations "
               f"({wall:.3f} s wall): theta", theta, th_r, 1e-4, what)
    _check_rel("lda: phi", phi, ph_r, 1e-4, what)
    del C, counts

    n, d, nbits = EX_LSH_N, EX_LSH_D, EX_LSH_BITS
    x = torch.randn((n, d), generator=gen, device=dev)
    t0 = time.perf_counter()
    bits = lsh.signatures(from_tensor(x), n_bits=nbits, seed=0)
    wall = time.perf_counter() - t0
    r = np.random.RandomState(0).randn(d, nbits).astype(np.float32)
    r64 = torch.from_numpy(r).double().to(dev)
    proj = x.double() @ r64
    # a float32 dot of length d errs by at most d * 2^-24 * |x| |r|
    # (7.6e-6 |x| |r| at d = 128): bits agree wherever |x . r| exceeds
    # 1e-5 |x| |r|
    margin = 1e-5 * (x.double().norm(dim=1)[:, None]
                     * r64.norm(dim=0)[None, :])
    clear = (proj.abs() > margin).cpu().numpy()
    want = (proj > 0).cpu().numpy()
    agree = bool((bits[clear] == want[clear]).all())
    _say(f"[examples] lsh.signatures {n} x {d}, {nbits} bits ({wall:.3f} s "
         f"wall): {clear.mean():.6f} of the bits clear of the rounding "
         f"margin, all of those equal to float64's signs: {agree}")
    if bits.shape != (n, nbits) or not agree or clear.mean() < 0.999:
        _fail("LSH signatures disagree with float64's signs")

    pn, bands = EX_LSH_PAIRS_N, 4
    rng = np.random.RandomState(51)
    pts = rng.randn(pn, d).astype(np.float32)
    planted = {(2 * i, 2 * i + 1) for i in range(64)}
    for i, j in planted:
        pts[j] = pts[i] + 0.01 * rng.randn(d).astype(np.float32)
    t0 = time.perf_counter()
    pairs = lsh.candidate_pairs(st.from_numpy(pts), n_bits=nbits,
                                bands=bands, seed=0)
    wall = time.perf_counter() - t0
    proj = pts.astype(np.float64) @ r.astype(np.float64)
    margin = 1e-5 * np.outer(np.linalg.norm(pts, axis=1),
                             np.linalg.norm(r, axis=0))
    sure = (np.abs(proj) > margin).all(axis=1)
    keys = (proj > 0).reshape(pn, bands, nbits // bands)
    want_pairs = set()
    for b in range(bands):
        groups = {}
        for i in np.flatnonzero(sure):
            groups.setdefault(keys[i, b].tobytes(), []).append(int(i))
        for members in groups.values():
            want_pairs.update((p, q) for ix, p in enumerate(members)
                              for q in members[ix + 1:])
    got = {(i, j) for i, j in pairs if sure[i] and sure[j]}
    _say(f"[examples] lsh.candidate_pairs {pn} points, {bands} bands "
         f"({wall:.3f} s wall): {len(pairs)} pairs, {len(planted & pairs)}"
         f" of {len(planted)} planted near-duplicates; on the "
         f"{int(sure.sum())} rows clear of the margin, equal to float64's "
         f"banding: {got == want_pairs}")
    if got != want_pairs or not planted <= pairs:
        _fail("LSH candidate pairs disagree with float64's banding")


def phase_examples(st, kk, ks, nb, card: str, dev) -> dict:
    """The application tier through the entry points a user calls: the
    examples, the sklearn-style estimators, each against float64 (or,
    where a kernel runs, against its plain-version run)."""
    t0 = time.perf_counter()
    out = _examples_regression(st, card, dev)
    out.update(_examples_svd(st, card, dev))
    out.update(_examples_estimators(st, kk, ks, nb, card, dev))
    _examples_solvers(st, card, dev)
    _examples_factorizations(st, card, dev)
    _examples_text(st, card, dev)
    _say(f"[examples] phase {time.perf_counter() - t0:.1f} s on {card}")
    return out


# -- phases 14-17: the state tier -----------------------------------------

# sensor matrix of [masked]: 8 rows of 2^23 f32 with 1% NaN (masked
# through masked_invalid) and a further 5% masked through masked_where;
# masked_dot of two 4096^2 matrices with 10% masked
MASK_ROWS, MASK_COLS, MASK_SEED = 8, 2 ** 23, 50
MASK_NAN, MASK_WHERE, MDOT_N, MDOT_MASKED = 0.01, 0.05, 4096, 0.10
# [checkpoint]: the k-means points (padded rows) on a logical (8, 1) mesh
# and a replicated 4096^2 matrix
CKPT_MESH, CKPT_REP_N = (8, 1), 4096
# [ckpt_loop]: BASELINE config 3 in segments of 5
CKL_EVERY = 5
# [streaming]
OKM_BATCHES, OKM_BATCH, OKM_REFINE = 16, 65_536, 5
SW_WINDOW, SW_DIM, SW_PUSHES, SW_PUSH = 1_048_576, 128, 20, 65_536
PR_DENSE_N, PR_INSERTS, PR_INSERT_COLS, PR_REBASE = 16_384, 4, 256, 4


def _rel_t(got: torch.Tensor, want: torch.Tensor) -> float:
    """Normwise relative error of a tensor against a float64 tensor."""
    if tuple(got.shape) != tuple(want.shape):
        _fail(f"shape {tuple(got.shape)} where {tuple(want.shape)} was "
              f"expected")
    d = got.to(torch.float64) - want
    return float(d.norm() / want.norm().clamp_min(1e-300))


def _expect(label: str, err: float, tol: float, what: str) -> None:
    _say(f"[{label}] {what}: normwise rel err {err:.3g} (tol {tol:g})")
    if not err <= tol:
        _fail(f"[{label}] {what} off by {err:.3g} > {tol:g}")


def _masked_f64(x: torch.Tensor, valid: torch.Tensor, dim):
    """count, sum, mean, var, std, min, max of the valid entries in
    float64 (over ``dim``, or everything when None)."""
    x64 = torch.where(valid, x.to(torch.float64), 0.0)
    kw = {} if dim is None else {"dim": dim}
    cnt = valid.sum(**kw).to(torch.float64)
    tot = x64.sum(**kw)
    mean = tot / cnt
    dev_ = torch.where(valid, x.to(torch.float64) - (
        mean if dim is None else mean.unsqueeze(dim)), 0.0)
    var = (dev_ * dev_).sum(**kw) / cnt
    lo = torch.where(valid, x.to(torch.float64), float("inf"))
    hi = torch.where(valid, x.to(torch.float64), float("-inf"))
    mn = lo.amin(**kw)
    mx = hi.amax(**kw)
    return {"count": cnt, "sum": tot, "mean": mean, "var": var,
            "std": var.sqrt(), "min": mn, "max": mx}


def phase_masked(st, card: str, dev) -> None:
    """Masked reductions, median, sort and argsort of a sensor matrix
    and a masked GEMM, against float64 on the card and numpy.ma."""
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.array.masked import MaskedDistArray

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(MASK_SEED)
    shape = (MASK_ROWS, MASK_COLS)
    x = torch.rand(shape, generator=gen, device=dev)
    x[torch.rand(shape, generator=gen, device=dev) < MASK_NAN] = float("nan")
    extra = torch.rand(shape, generator=gen, device=dev) < MASK_WHERE
    xe = from_tensor(x)
    invalid = MaskedDistArray.masked_invalid(xe)
    s = MaskedDistArray.masked_where(invalid.mask | from_tensor(extra),
                                     xe).evaluate()
    mask = s.mask.evaluate().tensor
    valid = ~mask
    want_mask = torch.isnan(x) | extra
    if not torch.equal(mask, want_mask):
        _fail("[masked] the mask is not NaN | the masked_where condition")
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)

    ops = {"count": lambda a: s.count(axis=a), "sum": lambda a: s.sum(a),
           "mean": lambda a: s.mean(a), "var": lambda a: s.var(a),
           "std": lambda a: s.std(a), "min": lambda a: s.min(a).data,
           "max": lambda a: s.max(a).data}
    times = {}
    for axis, label in ((1, "per row"), (None, "whole")):
        want = _masked_f64(x, valid, axis)
        for name, op in ops.items():
            got = op(axis).evaluate().tensor
            if name == "count":
                if not torch.equal(got.to(torch.float64), want[name]):
                    _fail(f"[masked] count {label} is not exact")
            else:
                _expect("masked", _rel_t(got, want[name]), 1e-5,
                        f"{name} {label} vs float64")
            times[f"{name} {label}"] = _wall_ms(
                lambda: op(axis).evaluate())
        if axis is not None:
            for name in ("min", "max"):
                m = getattr(s, name)(axis).mask.evaluate().tensor
                if bool(m.any()):
                    _fail(f"[masked] {name} per row masked a row with "
                          f"valid entries")
    med = st.median(s, axis=1).evaluate().tensor
    srt = st.sort(s, axis=1)
    srt_d, srt_m = srt.data.evaluate().tensor, srt.mask.evaluate().tensor
    arg = st.argsort(s, axis=1).evaluate().tensor
    times["median per row"] = _wall_ms(
        lambda: st.median(s, axis=1).evaluate())
    times["sort per row"] = _wall_ms(
        lambda: st.tuple_of(st.sort(s, axis=1).data,
                            st.sort(s, axis=1).mask).evaluate())
    times["argsort per row"] = _wall_ms(
        lambda: st.argsort(s, axis=1).evaluate())
    peak = torch.cuda.max_memory_allocated(dev) - base

    # numpy.ma on the host for one whole row: exact
    r = 3
    row = np.ma.masked_array(x[r].cpu().numpy(), mask[r].cpu().numpy())
    k = int(row.count())
    want_sorted = np.sort(row.compressed(), kind="stable")
    want_arg = np.ma.argsort(row, kind="stable")[:k]
    got_sorted = srt_d[r].cpu().numpy()
    if not (np.array_equal(got_sorted[:k], want_sorted)
            and not srt_m[r, :k].any() and bool(srt_m[r, k:].all())):
        _fail("[masked] sorted row differs from numpy.ma.sort")
    if not np.array_equal(arg[r, :k].cpu().numpy(), want_arg):
        _fail("[masked] argsort row differs from numpy.ma.argsort "
              "(stable)")
    want_med = np.float32(np.ma.median(row))
    if float(med[r]) != float(want_med):
        _fail(f"[masked] median of row {r}: {float(med[r])!r} vs "
              f"numpy.ma {float(want_med)!r}")
    if int(s.count(axis=1).evaluate().tensor[r]) != k:
        _fail("[masked] count of the row differs from numpy.ma")
    _say(f"[masked] row {r} against numpy.ma: {k} valid of {MASK_COLS}; "
         f"sort, argsort (stable), median {float(want_med)!r} and count "
         f"exact")

    # masked GEMM: filled data and valid-pair counts
    a = torch.rand((MDOT_N, MDOT_N), generator=gen, device=dev)
    b = torch.rand((MDOT_N, MDOT_N), generator=gen, device=dev)
    ma_ = torch.rand((MDOT_N, MDOT_N), generator=gen, device=dev) \
        < MDOT_MASKED
    mb = torch.rand((MDOT_N, MDOT_N), generator=gen, device=dev) \
        < MDOT_MASKED
    sa = MaskedDistArray(from_tensor(a), from_tensor(ma_))
    sb = MaskedDistArray(from_tensor(b), from_tensor(mb))
    prod = st.dot(sa, sb)
    pd, pm = st.tuple_of(prod.data, prod.mask).evaluate()
    va, vb = (~ma_).to(torch.float64), (~mb).to(torch.float64)
    want = (a.to(torch.float64) * va) @ (b.to(torch.float64) * vb)
    cnt = va @ vb
    if not torch.equal(pm.tensor, cnt == 0):
        _fail("[masked] masked_dot's mask is not (valid pairs == 0)")
    _expect("masked", _rel_t(pd.tensor, want), 1e-4,
            f"masked_dot {MDOT_N}^2 data vs float64")
    times["masked_dot"] = _wall_ms(
        lambda: st.tuple_of(st.dot(sa, sb).data,
                            st.dot(sa, sb).mask).evaluate())
    _say("[masked] ms per call (host clock to a synchronise, best of 3 "
         "after a warm-up): "
         + "; ".join(f"{k} {v:.3f}" for k, v in times.items())
         + f" on {card}")
    _say(f"[masked] peak device memory above the inputs during the "
         f"{MASK_ROWS}x{MASK_COLS} ops: {peak / 2 ** 30:.2f} GiB "
         f"(torch.cuda.max_memory_allocated) on {card}")
    _say(f"[masked] phase {time.perf_counter() - t0:.1f} s on {card}")


def phase_checkpoint(st, card: str, dev, padded: torch.Tensor,
                     workdir: str) -> None:
    """save/load of the k-means points on a logical (8, 1) mesh (8
    blobs) and of a replicated 4096^2 matrix (1 blob): bit-equal round
    trips, CRCs verified, a flipped byte refused."""
    import spartan_tpu_torch.native as native
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.utils import checkpoint as ckpt

    t0 = time.perf_counter()
    _say(f"[checkpoint] blob route: {native.route()} (built with g++ "
         f"from spartan_tpu_torch/native/blob_io.cpp)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(51)
    rep = torch.rand((CKPT_REP_N, CKPT_REP_N), generator=gen, device=dev)
    with st.use_mesh(st.build_mesh(CKPT_MESH)):
        cases = [("points", padded, st.Tiling(("x", None)), 8),
                 ("replicated", rep, st.Tiling((None, None)), 1)]
        for name, t, tiling, blobs in cases:
            arr = from_tensor(t, tiling=tiling)
            path = os.path.join(workdir, name)
            nbytes = t.numel() * t.element_size()
            first_ms = _wall_ms(lambda: ckpt.save(path, arr), reps=1,
                                warm=False)
            save_ms = _wall_ms(lambda: ckpt.save(path, arr), reps=2)
            files = sorted(f for f in os.listdir(path) if f.endswith(".bin"))
            if len(files) != blobs:
                _fail(f"[checkpoint] {name}: {len(files)} blobs, want "
                      f"{blobs}")
            holder = []
            load_ms = _wall_ms(
                lambda: holder.append(ckpt.load(path)), reps=2)
            back = holder[-1]
            if back.device != t.device or not torch.equal(back.tensor, t):
                _fail(f"[checkpoint] {name}: the round trip is not "
                      f"bit-equal on the card")
            _say(f"[checkpoint] {name} {tuple(t.shape)} f32 "
                 f"({nbytes / 2 ** 20:.0f} MiB, {len(files)} blob"
                 f"{'s' if len(files) > 1 else ''}): save {save_ms:.1f} ms "
                 f"({nbytes / save_ms / 1e6:.2f} GB/s), load {load_ms:.1f} "
                 f"ms ({nbytes / load_ms / 1e6:.2f} GB/s) by host clock, "
                 f"CRC32 verified, bit-equal; first save {first_ms:.1f} ms "
                 f"(no warm-up) on {card}")
            del holder, back
        # the pageable branch (arrays above the cached page-locked size)
        keep, ckpt._PINNED_KEEP = ckpt._PINNED_KEEP, 0
        try:
            arr = from_tensor(padded, tiling=st.Tiling(("x", None)))
            path = os.path.join(workdir, "pageable")
            nbytes = padded.numel() * padded.element_size()
            save_ms = _wall_ms(lambda: ckpt.save(path, arr), reps=2)
            holder = []
            load_ms = _wall_ms(
                lambda: holder.append(ckpt.load(path)), reps=2)
            if not torch.equal(holder[-1].tensor, padded):
                _fail("[checkpoint] the pageable round trip is not "
                      "bit-equal")
            del holder
        finally:
            ckpt._PINNED_KEEP = keep
        shutil.rmtree(path, ignore_errors=True)
        _say(f"[checkpoint] points through pageable staging (above the "
             f"cached size): save {save_ms:.1f} ms ({nbytes / save_ms / 1e6:.2f}"
             f" GB/s), load {load_ms:.1f} ms ({nbytes / load_ms / 1e6:.2f} "
             f"GB/s), bit-equal, on {card}")
        victim = os.path.join(workdir, "points", sorted(
            f for f in os.listdir(os.path.join(workdir, "points"))
            if f.endswith(".bin"))[5])
        at = os.path.getsize(victim) // 2
        with open(victim, "r+b") as f:
            f.seek(at)
            byte = f.read(1)
            f.seek(at)
            f.write(bytes([byte[0] ^ 0x40]))
        try:
            ckpt.load(os.path.join(workdir, "points"))
        except ValueError as e:
            if os.path.basename(victim) not in str(e):
                _fail(f"[checkpoint] the CRC error does not name the "
                      f"shard: {e}")
            _say(f"[checkpoint] flipped byte in "
                 f"{os.path.basename(victim)}: refused ({str(e)[:60]}...)")
        else:
            _fail("[checkpoint] a flipped byte loaded without error")
    shutil.rmtree(os.path.join(workdir, "replicated"), ignore_errors=True)
    _say(f"[checkpoint] phase {time.perf_counter() - t0:.1f} s on {card}")


def ckpt_child(workdir: str) -> None:
    """The process [ckpt_loop] kills: the checkpointed k-means loop from
    the points and centers saved under ``workdir``, killed with SIGKILL
    when it builds segment 3, after its iteration-10 snapshot."""
    import signal

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spartan_tpu_torch as st
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.utils import checkpoint as ckpt

    st.set_default_device("cuda")
    points = st.as_expr(ckpt.load(os.path.join(workdir, "child_points")))
    c0 = ckpt.load(os.path.join(workdir, "child_c0"))
    calls = [0]

    def body(c):
        calls[0] += 1
        if calls[0] == 3:
            os.kill(os.getpid(), signal.SIGKILL)
        return km.kmeans_step(points, c, KM_K)

    st.loop(KM_ITERS, body, c0, checkpoint_every=CKL_EVERY,
            checkpoint_path=os.path.join(workdir, "killed"))
    _fail("the child was not killed")


def phase_ckpt_loop(st, kk, km, card: str, dev, points, c0_np,
                    workdir: str) -> dict:
    """BASELINE config 3 through ``st.loop(..., checkpoint_every=5)``:
    exactly 20 k-means kernel launches and the uninterrupted loop's
    bits; one injected transient fault restores once with the same
    bits; a child killed by SIGKILL after its iteration-10 snapshot,
    resumed here to 20, gives the same bits."""
    from spartan_tpu_torch.resilience import loop_ckpt
    from spartan_tpu_torch.utils import checkpoint as ckpt

    t0 = time.perf_counter()

    def body(c):
        return km.kmeans_step(points, c, KM_K)

    def c0():
        return st.from_numpy(c0_np)

    if not isinstance(body(c0()), km.KMeansStepExpr):
        _fail("[ckpt_loop] kmeans_step did not select the fused pass")
    _reset_counts(kk)
    ref = st.loop(KM_ITERS, body, c0()).glom()
    if kk.LAUNCHES != KM_ITERS:
        _fail(f"[ckpt_loop] uninterrupted loop: {kk.LAUNCHES} launches")
    plain_s = _wall_ms(lambda: st.loop(KM_ITERS, body, c0()).glom()) / 1e3

    _reset_counts(kk)
    out = st.loop(KM_ITERS, body, c0(), checkpoint_every=CKL_EVERY,
                  checkpoint_path=os.path.join(workdir, "a"))
    got = out.glom()
    launches = kk.LAUNCHES
    _say(f"[ckpt_loop] {KM_N}x{KM_D} k={KM_K} {KM_ITERS} iters in segments "
         f"of {CKL_EVERY}: kernel launches {launches}, "
         f"{out._resilience['segments']} segments")
    if launches != KM_ITERS:
        _fail(f"[ckpt_loop] {launches} k-means launches, want {KM_ITERS}")
    if not np.array_equal(got, ref):
        _fail("[ckpt_loop] checkpointed centers differ from the "
              "uninterrupted loop's")
    ckpt_s = _wall_ms(lambda: st.loop(
        KM_ITERS, body, c0(), checkpoint_every=CKL_EVERY,
        checkpoint_path=os.path.join(workdir, "t")).glom()) / 1e3
    carry = st.from_numpy(ref)
    snap_ms = _wall_ms(lambda: loop_ckpt.save_snapshot(
        os.path.join(workdir, "s"), CKL_EVERY, [carry]), reps=5)

    calls = [0]

    def flaky(c):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("UNAVAILABLE: fault injected in segment 3")
        return body(c)

    out = st.loop(KM_ITERS, flaky, c0(), checkpoint_every=CKL_EVERY,
                  checkpoint_path=os.path.join(workdir, "b"))
    restores = out._resilience["restores"]
    if restores != 1 or not np.array_equal(out.glom(), ref):
        _fail(f"[ckpt_loop] injected fault: {restores} restores, "
              f"bit-equal {np.array_equal(out.glom(), ref)}")
    _say("[ckpt_loop] one transient fault injected in segment 3: 1 "
         "restore from the iteration-10 snapshot, centers bit-equal")

    ckpt.save(os.path.join(workdir, "child_points"), points.evaluate())
    ckpt.save(os.path.join(workdir, "child_c0"), c0())
    t1 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--ckpt-child", workdir],
        capture_output=True, text=True, timeout=300)
    if child.returncode != -9:
        _fail(f"[ckpt_loop] the child exited {child.returncode}, not by "
              f"SIGKILL:\n{child.stdout[-2000:]}\n{child.stderr[-2000:]}")
    killed = os.path.join(workdir, "killed")
    with open(os.path.join(killed, "LATEST.json")) as f:
        step = json.load(f)["step"]
    if step != 2 * CKL_EVERY:
        _fail(f"[ckpt_loop] the child's last snapshot is iteration {step}")
    _reset_counts(kk)
    out = st.loop(KM_ITERS, body, c0(), checkpoint_every=CKL_EVERY,
                  checkpoint_path=killed, resume=killed)
    resumed = out.glom()
    if kk.LAUNCHES != KM_ITERS - step or not np.array_equal(resumed, ref):
        _fail(f"[ckpt_loop] resume from {step}: {kk.LAUNCHES} launches, "
              f"bit-equal {np.array_equal(resumed, ref)}")
    _say(f"[ckpt_loop] child killed by SIGKILL after its iteration-{step} "
         f"snapshot ({time.perf_counter() - t1:.1f} s with its start-up), "
         f"resumed here to {KM_ITERS} ({kk.LAUNCHES} launches): centers "
         f"bit-equal")
    _say(f"[ckpt_loop] {KM_ITERS / plain_s:.2f} iters/s uninterrupted, "
         f"{KM_ITERS / ckpt_s:.2f} iters/s with a snapshot every "
         f"{CKL_EVERY} ({KM_ITERS // CKL_EVERY} snapshots), "
         f"{snap_ms:.2f} ms per snapshot of the ({KM_K}, {KM_D}) centers "
         f"(host clock, best of 3 and 5 after a warm-up) on {card}")
    _say(f"[ckpt_loop] phase {time.perf_counter() - t0:.1f} s on {card}")
    return {"launches": launches}


def _refine_plain(kk, pts: torch.Tensor, c: torch.Tensor, k: int,
                  iters: int) -> torch.Tensor:
    for _ in range(iters):
        s, n = kk.assign_accumulate_plain(pts, c, k)
        c = s / torch.clamp_min(n, 1.0)[:, None]
    return c


def phase_streaming(st, kk, card: str, dev, points, c0_np) -> dict:
    """The three streaming classes at full width: OnlineKMeans (16
    mini-batches, then refine over the 1M points: 5 k-means launches),
    SlidingWindowStats over a 512 MiB window, IncrementalPageRank on a
    dense 16,384^2 transition (1 GiB)."""
    from spartan_tpu_torch.examples import streaming

    t0 = time.perf_counter()
    pts = points.evaluate().tensor
    gen = torch.Generator(device=dev)
    gen.manual_seed(52)
    # one start center per cluster (as [kmeans]): every row keeps one
    # clear nearest center, so the kernel-driven and the plain-driven
    # refine assign alike (from random points, near-tie rows flip
    # between the two roundings and the centers drift ~1e-3 apart)
    okm = streaming.OnlineKMeans(torch.from_numpy(c0_np).to(dev))
    tb = time.perf_counter()
    for i in range(OKM_BATCHES):
        okm.partial_fit(pts[i * OKM_BATCH:(i + 1) * OKM_BATCH])
    torch.cuda.synchronize()
    fit_ms = (time.perf_counter() - tb) * 1e3 / OKM_BATCHES
    before = okm.centers.tensor.clone()
    _reset_counts(kk)
    tr = time.perf_counter()
    got = okm.refine(points, iters=OKM_REFINE).tensor
    torch.cuda.synchronize()
    refine_ms = (time.perf_counter() - tr) * 1e3
    launches = kk.LAUNCHES
    if launches != OKM_REFINE:
        _fail(f"[streaming] refine launched the k-means kernel "
              f"{launches} times, want {OKM_REFINE}")
    want = _refine_plain(kk, pts, before, KM_K, OKM_REFINE)
    diff = float((got - want).abs().max())
    _say(f"[streaming] OnlineKMeans: {OKM_BATCHES} partial_fit of "
         f"{OKM_BATCH}x{KM_D} ({fit_ms:.2f} ms each), refine "
         f"{OKM_REFINE} iters over {pts.shape[0]}x{KM_D} ({refine_ms:.1f} "
         f"ms, {launches} kernel launches): max |diff| vs the plain-driven "
         f"refine {diff:.3g} (atol 1e-4) on {card}")
    if not diff <= 1e-4:
        _fail("[streaming] refine disagrees with the plain-driven run")

    sw = streaming.SlidingWindowStats(SW_WINDOW, SW_DIM, device=dev)
    pushed = []
    tp = time.perf_counter()
    for _ in range(SW_PUSHES):
        rows = torch.randn((SW_PUSH, SW_DIM), generator=gen, device=dev)
        sw.push(rows)
        pushed.append(rows)
    torch.cuda.synchronize()
    push_ms = (time.perf_counter() - tp) * 1e3 / SW_PUSHES
    ts = time.perf_counter()
    mean, std = sw.stats()
    torch.cuda.synchronize()
    stats_ms = (time.perf_counter() - ts) * 1e3
    window = torch.cat(pushed)[-SW_WINDOW:]
    head = sw._head
    ring = torch.cat([window[SW_WINDOW - head:], window[:SW_WINDOW - head]])
    if not torch.equal(sw.buf.tensor, ring):
        _fail("[streaming] the window does not hold the last pushed rows")
    w64 = window.to(torch.float64)
    m64 = w64.mean(0)
    s64 = ((w64 - m64) ** 2).mean(0).sqrt()
    _expect("streaming", _rel_t(mean.tensor, m64), 1e-5,
            "SlidingWindowStats mean vs float64")
    _expect("streaming", _rel_t(std.tensor, s64), 1e-5,
            "SlidingWindowStats std vs float64")
    _say(f"[streaming] SlidingWindowStats {SW_WINDOW}x{SW_DIM} f32: "
         f"{SW_PUSHES} pushes of {SW_PUSH} rows ({push_ms:.2f} ms each), "
         f"stats {stats_ms:.2f} ms on {card}")
    del sw, pushed, window, ring, w64

    n = PR_DENSE_N
    a = torch.rand((n, n), generator=gen, device=dev)
    a /= a.sum(1, keepdim=True)
    pr = streaming.IncrementalPageRank(a, rebase_every=PR_INSERTS + 1)
    a64 = a.to(torch.float64)
    r0 = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    d = pr.damping
    inserts = [torch.rand((n, PR_INSERT_COLS), generator=gen,
                          device=dev) / n for _ in range(PR_INSERTS)]
    spans = [slice(j * PR_INSERT_COLS, (j + 1) * PR_INSERT_COLS)
             for j in range(PR_INSERTS)]
    # the port's calls alone in the timed window; the float64 reference
    # runs after it
    torch.cuda.synchronize()
    tp = time.perf_counter()
    steps = []
    for cols, vals in zip(spans, inserts):
        pr.insert_edges(cols, vals)
        steps.append(pr.step().tensor)
    before = pr.ranks.tensor
    reb = pr.rebase(PR_REBASE).tensor
    torch.cuda.synchronize()
    pr_ms = (time.perf_counter() - tp) * 1e3
    worst = 0.0
    for cols, vals, got in zip(spans, inserts, steps):
        a64[:, cols] = vals.to(torch.float64)
        worst = max(worst, _rel_t(got, d * (r0 @ a64) + (1.0 - d) / n))
    r = before.to(torch.float64)
    for _ in range(PR_REBASE):
        r = d * (r @ a64) + (1.0 - d) / n
    _expect("streaming", worst, 1e-5,
            f"IncrementalPageRank {PR_INSERTS} steps (worst) vs float64")
    _expect("streaming", _rel_t(reb, r), 1e-5,
            f"IncrementalPageRank rebase({PR_REBASE}) vs float64")
    _say(f"[streaming] IncrementalPageRank dense {n}^2 f32: "
         f"{PR_INSERTS} insert_edges of {PR_INSERT_COLS} columns with a "
         f"step after each, then rebase({PR_REBASE}): {pr_ms:.1f} ms on "
         f"{card}")
    _say(f"[streaming] phase {time.perf_counter() - t0:.1f} s on {card}")
    return {"launches": launches}


# -- phase 18 -------------------------------------------------------------


def _bits(a) -> np.ndarray:
    """The bit pattern of a float32 array or scalar."""
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _plan_ms(prof) -> tuple:
    """Planning ms recorded since the last reset: the ``pass:auto_tiling``
    and ``tiling`` phase sums (spartan_tpu_torch.obs REGISTRY)."""
    ps = prof.phase_seconds()
    return (ps.get("pass:auto_tiling", 0.0) * 1e3,
            ps.get("tiling", 0.0) * 1e3)


def _plan_check(label: str, prof, runs: int) -> None:
    stats = prof.plan_cache_stats()
    if stats["plan_misses"] != 1 or stats["plan_hits"] != runs - 1:
        _fail(f"[planner] {label}: want 1 plan miss and {runs - 1} hits "
              f"over {runs} evaluations of one structure, got {stats}")


def _explain(st, tc, expr, label: str) -> None:
    """The tilings the DP committed on ``expr``'s optimized DAG (only
    nodes with a committed tiling or GEMM plan, to keep it short)."""
    dag = st.optimize(expr)
    lines = tc.explain(dag).splitlines()
    nodes = st.dag_nodes(dag)
    keep = [ln for ln, n in zip(lines, nodes)
            if n._forced_tiling is not None
            or getattr(n, "_dot_plan", None) is not None]
    plans = sorted({(type(n).__name__, n._dot_plan[0].axes, n._dot_plan[1])
                    for n in nodes if getattr(n, "_dot_plan", None)})
    _say(f"[planner] {label} tilings: {'; '.join(keep) or 'none forced'}"
         f"; GEMM plans (grid, contraction axis): {plans}")


def _dot_planned(st, prof, tc, ea_np, eb_np, mesh, on: bool, card: str):
    """The dot chain on ``mesh`` with the pass on or off: its result
    bits, GFLOPS (best of PLAN_REPS) and the planning ms of its miss."""
    st.FLAGS.opt_auto_tiling = on
    with st.use_mesh(st.build_mesh(mesh)):
        ea, eb = st.from_numpy(ea_np), st.from_numpy(eb_np)
        if on:
            _explain(st, tc, _build_chain(st, ea, eb, DOT_K),
                     f"dot chain {mesh}")
        prof.reset_counters()
        times, val = [], None
        for _ in range(1 + PLAN_REPS):
            t0 = time.perf_counter()
            val = _build_chain(st, ea, eb, DOT_K).glom()
            times.append(time.perf_counter() - t0)
        _plan_check(f"dot chain {mesh} pass {'on' if on else 'off'}",
                    prof, 1 + PLAN_REPS)
        plan = _plan_ms(prof)
    if not np.isfinite(val).all():
        _fail(f"[planner] dot chain {mesh} result {val} is not finite")
    gflops = 2.0 * DOT_N ** 3 * DOT_K / min(times[1:]) / 1e9
    return _bits(val), gflops, plan, times[0]


def _kmeans_planned(st, prof, tc, kk, km, pts, c0_np, mesh, on: bool):
    """Config 3 k-means on ``mesh`` with the pass on or off: centers and
    assignment, launches, iterations per second and the planning ms."""
    from spartan_tpu_torch.array.distarray import from_tensor

    st.FLAGS.opt_auto_tiling = on
    with st.use_mesh(st.build_mesh(mesh)):
        points = from_tensor(pts)
        prof.reset_counters()
        _reset_counts(kk)
        centers, assign = km.kmeans(points, KM_K, num_iter=KM_ITERS,
                                    centers=c0_np)
        launches = kk.LAUNCHES
        # kmeans() evaluates two structures: the loop and the assignment
        misses = prof.plan_cache_stats()["plan_misses"]
        plan = tuple(v / max(misses, 1) for v in _plan_ms(prof))
        if launches != KM_ITERS:
            _fail(f"[planner] k-means {mesh} pass {'on' if on else 'off'}:"
                  f" {launches} kernel launches, want {KM_ITERS}")
        c0_e = st.from_numpy(c0_np)
        pe = st.as_expr(points)

        def fit():
            return st.loop(KM_ITERS, lambda c: km.kmeans_step(pe, c, KM_K),
                           c0_e).evaluate()

        if on:
            _explain(st, tc, st.loop(KM_ITERS, lambda c: km.kmeans_step(
                pe, c, KM_K), c0_e), f"k-means {mesh}")
        ms = _wall_ms(fit, reps=PLAN_REPS)
        stats = prof.plan_cache_stats()
        if (misses, stats["plan_misses"], stats["plan_hits"]) != (
                2, 2, 1 + PLAN_REPS):
            _fail(f"[planner] k-means {mesh}: want one miss per structure "
                  f"(2) and {1 + PLAN_REPS} hits of the loop after them, "
                  f"got {misses} misses in kmeans(), then {stats}")
    return (_bits(centers), assign), launches, KM_ITERS / (ms / 1e3), plan


def _phase_means(events, calls: int) -> dict:
    """Host ms per call of each evaluate phase in a span window."""
    out = {}
    for sp in events:
        if sp.name in ("evaluate", "sign", "optimize", "build", "dispatch",
                       "fetch"):
            out[sp.name] = out.get(sp.name, 0.0) + sp.dur / 1e3 / calls
    return out


def _host_split(st, fn, label: str, card: str) -> None:
    """Where one call's host time goes, from the span ring: a plan miss
    (the plan cache cleared first), then SPLIT_CALLS steady calls."""
    st.clear_plan_cache()
    st.trace_clear()
    fn()
    torch.cuda.synchronize()
    miss = _phase_means(st.trace_events(), 1)
    fn()
    torch.cuda.synchronize()
    st.trace_clear()
    t0 = time.perf_counter()
    for _ in range(SPLIT_CALLS):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / SPLIT_CALLS
    hit = _phase_means(st.trace_events(), SPLIT_CALLS)
    evals = sum(1 for sp in st.trace_events() if sp.name == "evaluate")
    # host waits inside the walk: torch's sync debug mode warns once per
    # synchronizing call (a .item(), a copy from pageable host memory)
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    torch.cuda.synchronize()

    def fmt(d):
        return ", ".join(f"{k} {d.get(k, 0.0):.4f}" for k in (
            "evaluate", "sign", "optimize", "build", "dispatch"))

    _say(f"[planner] host split of one {label} ({evals // SPLIT_CALLS} "
         f"evaluate(s) a call), ms a call by host clock: steady {fmt(hit)}"
         f"; wall with the device {wall:.4f}; plan miss {fmt(miss)}; "
         f"synchronizing calls in one steady call: {syncs} on {card}")


def phase_planner(st, kk, km, card: str, dev, points, c0_np) -> None:
    """The planner tier at full width: the smart-tiling DP on and off
    over bench.py's dot chain and config 3 k-means on logical (4, 2) and
    (8, 1) meshes, the trace/metrics cost, an explicit redistribution
    and the host split of two plan walks."""
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.expr import tiling_cost as tc
    from spartan_tpu_torch.parallel import redistribute as rd
    from spartan_tpu_torch.utils import profiling as prof

    rng = np.random.RandomState(0)
    a = rng.rand(DOT_N, DOT_N).astype(np.float32)
    b = rng.rand(DOT_N, DOT_N).astype(np.float32)
    pts = points.value.tensor
    prev = st.FLAGS.opt_auto_tiling
    try:
        for mesh in PLAN_MESHES:
            on = _dot_planned(st, prof, tc, a, b, mesh, True, card)
            off = _dot_planned(st, prof, tc, a, b, mesh, False, card)
            if not np.array_equal(on[0], off[0]):
                _fail(f"[planner] dot chain {mesh}: pass on and off "
                      f"differ in bits")
            _say(f"[planner] dot chain {DOT_N}^2 K={DOT_K} on {mesh}: pass "
                 f"on {on[1]:.1f} GFLOPS, off {off[1]:.1f} GFLOPS (best of "
                 f"{PLAN_REPS}), bit-equal; planning per miss: "
                 f"pass:auto_tiling {on[2][0]:.3f} ms, tiling "
                 f"{on[2][1]:.3f} ms; first (miss) run {on[3] * 1e3:.1f} "
                 f"ms; 1 miss then {PLAN_REPS} hits on {card}")
            kon = _kmeans_planned(st, prof, tc, kk, km, pts, c0_np, mesh,
                                  True)
            koff = _kmeans_planned(st, prof, tc, kk, km, pts, c0_np, mesh,
                                   False)
            if not (np.array_equal(kon[0][0], koff[0][0])
                    and np.array_equal(kon[0][1], koff[0][1])):
                _fail(f"[planner] k-means {mesh}: pass on and off differ")
            _say(f"[planner] k-means {KM_N}x{KM_D} k={KM_K} on {mesh}: "
                 f"{kon[1]} and {koff[1]} kernel launches (pass on, off), "
                 f"bit-equal centers and assignment; {kon[2]:.2f} iters/s "
                 f"on, {koff[2]:.2f} off (st.loop, best of {PLAN_REPS}); "
                 f"planning per miss: pass:auto_tiling {kon[3][0]:.3f} ms,"
                 f" tiling {kon[3][1]:.3f} ms; 1 miss per structure, then "
                 f"hits on {card}")
        st.FLAGS.opt_auto_tiling = True

        # spans and metrics on against both off, alternated
        with st.use_mesh(st.build_mesh(PLAN_MESHES[0])):
            pe = st.as_expr(from_tensor(pts))
            c0_e = st.from_numpy(c0_np)

            def fit():
                return st.loop(KM_ITERS, lambda c: km.kmeans_step(
                    pe, c, KM_K), c0_e).evaluate()

            best = {True: float("inf"), False: float("inf")}
            for _ in range(PLAN_REPS):
                for obs_on in (True, False):
                    st.FLAGS.trace = st.FLAGS.metrics = obs_on
                    best[obs_on] = min(best[obs_on],
                                       _wall_ms(fit, reps=PLAN_REPS))
            st.FLAGS.trace = st.FLAGS.metrics = True
        ips_on, ips_off = KM_ITERS / best[True] * 1e3, \
            KM_ITERS / best[False] * 1e3
        _say(f"[planner] k-means on {PLAN_MESHES[0]}: {ips_on:.2f} iters/s "
             f"with trace and metrics on, {ips_off:.2f} with both off: "
             f"{100.0 * (ips_off - ips_on) / ips_off:+.2f}% (budget 5%) "
             f"on {card}")

        # the redistribution planner: rows -> columns on (4, 2)
        mesh = st.build_mesh(PLAN_MESHES[0])
        src, dst = st.Tiling(("x", None)), st.Tiling((None, "x"))
        st.FLAGS.redistribution_planner = True
        try:
            prof.reset_counters()
            moved = rd.constrain(pts, dst, mesh, src=src)
            torch.cuda.synchronize()
            explicit = prof.counters().get("redistribute_explicit", 0)
            if explicit != 1 or not torch.equal(moved, pts):
                _fail(f"[planner] explicit redistribution: {explicit} "
                      f"schedules run, bit-equal {torch.equal(moved, pts)}")
            dec = rd.decide(src, dst, tuple(pts.shape), np.float32, mesh)
            ms = _event_ms(lambda: rd.constrain(pts, dst, mesh, src=src),
                           PLAN_REPS)
        finally:
            st.FLAGS.redistribution_planner = False
        with st.use_mesh(mesh):
            arr = from_tensor(pts, tiling=src)
            if arr.retile(dst).tensor.data_ptr() != pts.data_ptr():
                _fail("[planner] retile copied the tensor")
        gbs = 2.0 * pts.numel() * 4 / (ms / 1e3) / 1e9
        _say(f"[planner] redistribution of the k-means points {src.axes} "
             f"-> {dst.axes} on {PLAN_MESHES[0]}: {dec.schedule.describe()}"
             f" (explicit: {dec.reason}), redistribute_explicit "
             f"{explicit}, bit-equal; {ms:.3f} ms ({gbs:.1f} GB/s read + "
             f"written) on {card}; retile shares the tensor")
    finally:
        st.FLAGS.opt_auto_tiling = prev

    # the host split of two plan walks (PERF.md section 7's question)
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    keys = torch.rand(SORT_N, generator=gen, device=dev)
    with st.use_mesh(st.build_mesh(SORT_MESH)):
        X = from_tensor(keys)
        _host_split(st, lambda: [e.evaluate() for e in st.histogram(
            X, bins=HIST_BINS, range=(0.0, 1.0))],
            f"st.histogram(x, {HIST_BINS}, range=(0, 1)) on {SORT_N} keys",
            card)
    del keys, X
    x, params = _vgg_params(dev)
    with st.use_mesh(st.build_mesh(VGG_MESH)):
        XV = from_tensor(x, tiling=st.Tiling((None, "x", None, None)))
        P = [(from_tensor(w), from_tensor(bb)) for w, bb in params]
        _host_split(st, lambda: vgg_block1(st, XV, P).evaluate(),
                    f"VGG-block forward (batch {VGG_N})", card)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="chip_smoke_trace_")
    os.close(fd)
    try:
        doc = st.trace_export(path)
        with open(path) as f:
            back = json.load(f)
    finally:
        os.unlink(path)
    names = {e["name"] for e in back["traceEvents"]}
    if back != json.loads(json.dumps(doc)) or not {
            "evaluate", "sign", "build", "dispatch"} <= names:
        _fail(f"[planner] the exported Chrome trace did not parse back: "
              f"{sorted(names)[:10]}")
    _say(f"[planner] Chrome trace of the split: {len(back['traceEvents'])} "
         f"events, parsed back; span names {sorted(names)}")


# -- phase 19, [spmd] ------------------------------------------------------

# the collectives of parallel/collectives.py as shard_map bodies, each
# against its definition on the blocks of one line of positions
_COLL_CASES = ("all_reduce_add", "all_reduce_mean", "all_reduce_max",
               "all_reduce_min", "all_gather_0", "all_gather_1",
               "reduce_scatter_0", "reduce_scatter_1", "all_to_all",
               "ring_permute_fwd", "ring_permute_back")


def _coll_body(coll, name: str, axis: str):
    def body(v):
        if name.startswith("all_reduce"):
            out = coll.all_reduce(v, axis, name.split("_")[-1])
        elif name.startswith("all_gather"):
            out = coll.all_gather(v, axis, gather_axis=int(name[-1]))
        elif name.startswith("reduce_scatter"):
            out = coll.reduce_scatter(v, axis, scatter_axis=int(name[-1]))
        elif name == "all_to_all":
            out = coll.all_to_all(v, axis, split_axis=1, concat_axis=0)
        else:
            out = coll.ring_permute(v, axis, 1 if name.endswith("fwd")
                                    else -1)
        return out[None]
    return body


def _coll_expected(name: str, line, me: int) -> torch.Tensor:
    """The definition: ``line`` is the blocks of the positions along the
    axis in position order, ``me`` this position's index. Sums fold left
    in position order."""
    n = len(line)

    def fold(op):
        acc = line[0]
        for v in line[1:]:
            acc = op(acc, v)
        return acc

    if name == "all_reduce_add":
        return fold(torch.add)
    if name == "all_reduce_mean":
        return fold(torch.add) / n if n > 1 else line[0]
    if name == "all_reduce_max":
        return fold(torch.maximum)
    if name == "all_reduce_min":
        return fold(torch.minimum)
    if name.startswith("all_gather"):
        return torch.cat(line, int(name[-1]))
    if name.startswith("reduce_scatter"):
        return fold(torch.add).chunk(n, int(name[-1]))[me]
    if name == "all_to_all":
        return torch.cat([v.chunk(n, 1)[me] for v in line], 0)
    shift = 1 if name.endswith("fwd") else -1
    return line[(me - shift) % n]


def _check_collectives(st, coll, smap, mesh, dev, label: str) -> None:
    """Every collective over both axes of ``mesh``, bit-equal to its
    definition at every position."""
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    rows, cols = SPMD_COLL_BLOCK
    gen = torch.Generator(device=dev)
    gen.manual_seed(63)
    x = torch.randn((nx * rows, ny * cols), generator=gen, device=dev)
    blocks = [[x[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols]
               for j in range(ny)] for i in range(nx)]
    t_in = st.Tiling(("x", "y"))
    t_out = st.Tiling((("x", "y"), None, None))
    checked = 0
    t0 = time.perf_counter()
    for axis in ("x", "y"):
        for name in _COLL_CASES:
            got = smap.shard_map(_coll_body(coll, name, axis), mesh, (t_in,),
                                 t_out)(x)
            for f in range(nx * ny):
                i, j = divmod(f, ny)
                if axis == "x":
                    line, me = [blocks[a][j] for a in range(nx)], i
                else:
                    line, me = [blocks[i][b] for b in range(ny)], j
                want = _coll_expected(name, line, me)
                if not torch.equal(got[f], want):
                    _fail(f"[spmd] {label} {name} over {axis!r} at position "
                          f"({i}, {j}) differs from its definition")
                checked += 1
    torch.cuda.synchronize()
    _say(f"[spmd] {label}: {len(_COLL_CASES)} collectives x 2 axes on "
         f"{nx}x{ny} ({rows}x{cols} f32 blocks), {checked} position "
         f"blocks bit-equal to their definitions (sums to a left fold in "
         f"position order) in {time.perf_counter() - t0:.2f} s")


def _spmd_dot(st, card: str, dev) -> None:
    rng = np.random.RandomState(0)
    a = rng.rand(DOT_N, DOT_N).astype(np.float32)
    b = rng.rand(DOT_N, DOT_N).astype(np.float32)
    ea, eb = st.from_numpy(a), st.from_numpy(b)
    ref = (torch.from_numpy(a).to(dev).double()
           @ torch.from_numpy(b).to(dev).double())
    with st.use_mesh(st.build_mesh(SPMD_DOT_MESH)):
        got = st.dot_shardmap(ea, eb).evaluate().tensor
        rel = float((got.double() - ref).abs().max() / ref.abs().max())
        smap_ms = _wall_ms(lambda: st.dot_shardmap(ea, eb).evaluate())
        dot_ms = _wall_ms(lambda: st.dot(ea, eb).evaluate())
    # the same blocks, products, folds and assembly from one thread: the
    # work without the thread runner (the profiler does not see every
    # worker thread's launches, so no device split here)
    at, bt = ea.evaluate().tensor, eb.evaluate().tensor
    nx, ny = SPMD_DOT_MESH
    r, k = DOT_N // nx, DOT_N // ny

    def serial():
        rows = []
        for i in range(nx):
            acc = at[i * r:(i + 1) * r, :k] @ bt[:k]
            for j in range(1, ny):
                acc = acc + at[i * r:(i + 1) * r, j * k:(j + 1) * k] @ \
                    bt[j * k:(j + 1) * k]
            rows.append(acc)
        return torch.cat(rows)

    serial_ms = _wall_ms(serial)
    flops = 2.0 * DOT_N ** 3
    _say(f"[spmd] dot_shardmap {DOT_N}^2 f32 on a logical {SPMD_DOT_MESH} "
         f"mesh (thread runner: A (x, y), B (y, None), all_reduce over y): "
         f"max |err| / max |ref| {rel:.3g} against float64 (limit 1e-4); "
         f"{flops / smap_ms / 1e6:.1f} GFLOPS ({smap_ms:.3f} ms) against "
         f"st.dot's {flops / dot_ms / 1e6:.1f} GFLOPS ({dot_ms:.3f} ms) on "
         f"the same pair (host clock to a synchronise, best of 3) on {card};"
         f" the same block products, folds and assembly from one thread "
         f"{serial_ms:.3f} ms: the thread runner adds "
         f"{smap_ms - serial_ms:.3f} ms")
    if not rel <= 1e-4:
        _fail("[spmd] dot_shardmap disagrees with float64")


def _nearest(p, c):
    score = (c * c).sum(1)[None, :] - 2.0 * (p @ c.T)
    return score.argmin(1).to(torch.int32)


def _spmd_shard_map2(st, card: str, dev, points, c0_np) -> None:
    c0 = st.from_numpy(c0_np)
    with st.use_mesh(st.build_mesh(SPMD_KM_MESH)):
        expr = st.shard_map2([points, c0], _nearest,
                             [st.Tiling(("x", None)),
                              st.Tiling((None, None))],
                             st.Tiling(("x",)), (KM_N,), np.int32)
        got = expr.evaluate().tensor
        ms = _wall_ms(lambda: st.shard_map2(
            [points, c0], _nearest,
            [st.Tiling(("x", None)), st.Tiling((None, None))],
            st.Tiling(("x",)), (KM_N,), np.int32).evaluate())
    pts, cen = points.evaluate().tensor, c0.evaluate().tensor
    want = _nearest(pts, cen)
    whole_ms = _wall_ms(lambda: _nearest(pts, cen))
    blocks = pts.chunk(SPMD_KM_MESH[0])
    serial_ms = _wall_ms(lambda: torch.cat([_nearest(b, cen)
                                            for b in blocks]))
    if not torch.equal(got, want):
        _fail(f"[spmd] shard_map2 nearest centers differ from the whole-array "
              f"kernel at {int((got != want).sum())} rows")
    _say(f"[spmd] shard_map2 per-row-block nearest-center argmin over the "
         f"{KM_N}x{KM_D} config-3 points on {SPMD_KM_MESH}: equal to the "
         f"whole-array kernel; {ms:.3f} ms against {whole_ms:.3f} ms whole "
         f"and {serial_ms:.3f} ms for the same blocks from one thread "
         f"(host clock, best of 3) on {card}")


def phase_spmd_threads(st, card: str, dev, points, c0_np) -> None:
    """[spmd], thread runner: dot_shardmap, shard_map2 and every
    collective on logical meshes of the card."""
    from spartan_tpu_torch.parallel import collectives as coll
    from spartan_tpu_torch.parallel import shard_map as smap

    _spmd_dot(st, card, dev)
    _spmd_shard_map2(st, card, dev, points, c0_np)
    for shape in SPMD_COLL_MESHES:
        _check_collectives(st, coll, smap, st.build_mesh(shape), dev,
                           f"thread runner {shape}")


def phase_spmd_attention(st, card: str, dev) -> None:
    """[spmd] attention at L = 16,384, H = 16, D = 128 f32 on (8, 1):
    ring, Ulysses and blockwise against blockwise in float64."""
    from spartan_tpu_torch.ops import attention as att

    gen = torch.Generator(device=dev)
    gen.manual_seed(60)
    q, k, v = (torch.randn((ATT_L, ATT_H, ATT_D), generator=gen, device=dev)
               for _ in range(3))
    flops = 4.0 * ATT_L * ATT_L * ATT_H * ATT_D
    with st.use_mesh(st.build_mesh(ATT_MESH)):
        for causal in (False, True):
            ref = att.blockwise_attention(q.double(), k.double(), v.double(),
                                          ATT_BLOCK, causal)
            for name, fn in (
                    ("ring", lambda c=causal: att.ring_attention(q, k, v, c)),
                    ("ulysses",
                     lambda c=causal: att.ulysses_attention(q, k, v, c)),
                    ("blockwise", lambda c=causal: att.blockwise_attention(
                        q, k, v, ATT_BLOCK, c))):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                live = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = fn()
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - live) / 2 ** 30
                err = float((out.double() - ref).abs().max())
                del out
                ms = _wall_ms(fn, reps=2, warm=False)
                _say(f"[spmd] attention {name} causal={causal} L={ATT_L} "
                     f"H={ATT_H} D={ATT_D} f32 on {ATT_MESH}: max |err| "
                     f"{err:.3g} against float64 blockwise (limit 1e-4); "
                     f"{ms:.2f} ms ({flops / ms / 1e9:.1f} TFLOP/s of the "
                     f"dense product count), peak {peak:.2f} GiB above the "
                     f"live set (host clock, best of 2) on {card}")
                if not err <= 1e-4:
                    _fail(f"[spmd] {name} attention (causal={causal}) "
                          "disagrees with float64")
            del ref


def phase_spmd_pipeline(st, card: str, dev) -> None:
    """[spmd] the GPipe pipeline: 8 tanh(x W + b) stages of width 4096 on
    (8, 1), 32 microbatches of 512 rows, against the sequential stack in
    float64."""
    from spartan_tpu_torch.parallel import pipeline as pipe

    gen = torch.Generator(device=dev)
    gen.manual_seed(61)
    s, w, m, r = PIPE_STAGES, PIPE_WIDTH, PIPE_MICRO, PIPE_ROWS
    ws = torch.randn((s, w, w), generator=gen, device=dev) / w ** 0.5
    bs = 0.1 * torch.randn((s, w), generator=gen, device=dev)
    x = torch.randn((m, r, w), generator=gen, device=dev)
    tgt = 0.1 * torch.randn((m, r, w), generator=gen, device=dev)

    def stage(p, a):
        return torch.tanh(a @ p[0] + p[1])

    def sq(a, b):
        return torch.mean((a - b) ** 2)

    w64 = ws.double().requires_grad_(True)
    b64 = bs.double().requires_grad_(True)
    h = x.double().reshape(m * r, w)
    for i in range(s):
        h = torch.tanh(h @ w64[i] + b64[i])
    loss64 = torch.mean((h - tgt.double().reshape(m * r, w)) ** 2)
    loss64.backward()
    ref = h.detach().reshape(m, r, w)
    del h
    with st.use_mesh(st.build_mesh((s, 1))):
        out = pipe.pipeline_apply(stage, (ws, bs), x)
        err = float((out.double() - ref).abs().max())
        del out
        loss, (gw, gb) = pipe.pipeline_grad(stage, sq, (ws, bs), x, tgt)
        apply_ms = _wall_ms(lambda: pipe.pipeline_apply(stage, (ws, bs), x),
                            reps=2, warm=False)
        grad_ms = _wall_ms(lambda: pipe.pipeline_grad(stage, sq, (ws, bs),
                                                      x, tgt),
                           reps=2, warm=False)
    gerr = max(float((gw.double() - w64.grad).abs().max()
                     / w64.grad.abs().max()),
               float((gb.double() - b64.grad).abs().max()
                     / b64.grad.abs().max()))
    lerr = abs(loss.item() - loss64.item()) / abs(loss64.item())
    _say(f"[spmd] pipeline {s} stages x width {w}, {m} microbatches of {r} "
         f"rows on ({s}, 1), {m + s - 1} ticks: pipeline_apply max |err| "
         f"{err:.3g} (limit 1e-4), pipeline_grad loss rel err {lerr:.3g}, "
         f"grads max |err| / max |grad| {gerr:.3g} (limit 1e-4) against "
         f"the sequential stack in float64; apply {apply_ms:.1f} ms, grad "
         f"{grad_ms:.1f} ms (host clock, best of 2) on {card}")
    if not (err <= 1e-4 and lerr <= 1e-4 and gerr <= 1e-4):
        _fail("[spmd] the pipeline disagrees with the float64 stack")


def _child_device() -> torch.device:
    """The card both ranks of the group share."""
    return torch.device("cuda", 0)


def spmd_child(workdir: str, rank: int) -> None:
    """One rank of [spmd]'s two-process gloo group on the one card: the
    group forms of the k-means, segment, histogram and stencil kernels,
    each through the port's entry points, on stored DistArray blocks and
    on whole tensors (cut to the rank's block); results to ``workdir``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.kernels import histogram as kh
    from spartan_tpu_torch.kernels import kmeans as kk
    from spartan_tpu_torch.kernels import segment as ks
    from spartan_tpu_torch.kernels import stencil as kst
    from spartan_tpu_torch.obs.metrics import collective_totals
    from spartan_tpu_torch.parallel import mesh as mesh_mod

    dev = _child_device()
    st.set_default_device(dev)
    if not mesh_mod.initialize_distributed(
            "file://" + os.path.join(workdir, "store"),
            num_processes=GROUP_RANKS, process_id=rank, backend="gloo",
            device=dev, timeout_s=GROUP_TIMEOUT_S):
        _fail("[spmd] child: no process group")
    res = {"rank": rank, "status": mesh_mod.status()["mesh"]}
    whole = torch.load(os.path.join(workdir, "points.pt")).to(dev)
    points = from_tensor(whole)
    c0 = np.load(os.path.join(workdir, "c0.npy"))
    kk.LAUNCHES = 0
    centers, _ = km.kmeans(points, KM_K, num_iter=KM_ITERS, centers=c0)
    res["km_launches"] = kk.LAUNCHES
    np.save(os.path.join(workdir, f"centers{rank}.npy"), centers)
    res["km_ms_per_iter"] = _wall_ms(lambda: st.loop(
        KM_ITERS, lambda c: km.kmeans_step(points, c, KM_K),
        st.from_numpy(c0)).evaluate(), reps=2) / KM_ITERS
    # one step on the whole tensor under the group: the rank's rows only
    c0_t = torch.from_numpy(c0).to(dev)
    kk.LAUNCHES = 0
    step_t = kk.step(whole, c0_t, KM_K)
    res["km_tensor_launches"] = kk.LAUNCHES
    res["km_tensor_equal"] = bool(torch.equal(
        step_t, kk.step(points, c0_t, KM_K)))
    del whole, step_t

    # the group forms on the blocks each rank stores (local-shard
    # storage: from_tensor keeps the rank's rows), and on whole tensors
    x, yt, _ = _nb_data(dev)
    ks.LAUNCHES["segment_sum_block"] = 0
    tables_t = ks.segment_sum_sharded(x, yt, NB_CLASSES)
    res["seg_tensor_launches"] = ks.LAUNCHES["segment_sum_block"]
    xd = from_tensor(x, tiling=st.Tiling(("x", None)))
    yd = from_tensor(yt, tiling=st.Tiling(("x",)))
    del x, yt
    ks.LAUNCHES["segment_sum_block"] = 0
    tables = ks.segment_sum_sharded(xd, yd, NB_CLASSES)
    res["seg_launches"] = ks.LAUNCHES["segment_sum_block"]
    res["seg_tensor_equal"] = bool(torch.equal(tables_t, tables))
    np.save(os.path.join(workdir, f"seg{rank}.npy"), tables.cpu().numpy())
    res["seg_ms"] = _wall_ms(lambda: ks.segment_sum_sharded(xd, yd,
                                                            NB_CLASSES))
    del xd, yd, tables, tables_t

    gen = torch.Generator(device=dev)
    gen.manual_seed(62)
    ids = torch.randint(0, HIST_BINS, (SORT_N,), generator=gen, device=dev,
                        dtype=torch.int32)
    want = torch.bincount(ids.long(), minlength=HIST_BINS)
    kh.LAUNCHES["bincount_block"] = 0
    counts_t = kh.bincount_sharded(ids, HIST_BINS)
    res["hist_tensor_launches"] = kh.LAUNCHES["bincount_block"]
    idd = from_tensor(ids, tiling=st.Tiling(("x",)))
    kh.LAUNCHES["bincount_block"] = 0
    counts = kh.bincount_sharded(idd, HIST_BINS)
    res["hist_launches"] = kh.LAUNCHES["bincount_block"]
    res["hist_equal"] = bool(torch.equal(counts.long(), want)
                             and torch.equal(counts_t.long(), want))
    res["hist_ms"] = _wall_ms(lambda: kh.bincount_sharded(idd, HIST_BINS))
    del ids, idd, counts_t, want

    xv, params = _vgg_params(dev)
    h_tiling = st.Tiling((None, "x", None, None))
    kst.LAUNCHES["conv_block"] = 0
    conv_t = kst.halo_stencil(xv, params[0][0], h_tiling)
    res["conv_tensor_launches"] = kst.LAUNCHES["conv_block"]
    ref1 = _vgg_float64(xv[:2], params[:1], pool=False, bias=False)
    res["conv_tensor_err"] = float((conv_t[:2].double().clamp_min(0.0)
                                    - ref1).abs().max())
    del conv_t, ref1
    X = from_tensor(xv, tiling=h_tiling)
    P = [(from_tensor(w), from_tensor(b)) for w, b in params]
    kst.LAUNCHES["conv_block"] = 0
    out = vgg_block1(st, X, P).evaluate().tensor
    res["vgg_launches"] = kst.LAUNCHES["conv_block"]
    ref = _vgg_float64(xv[:2], params)
    res["vgg_err"] = float((out[:2].double() - ref).abs().max())
    res["vgg_ms"] = _wall_ms(lambda: vgg_block1(st, X, P).evaluate(),
                             reps=2)
    res["totals"] = collective_totals()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    mesh_mod.shutdown()


def phase_spmd_group(st, kk, ks, card: str, dev, kmr: dict,
                     workdir: str) -> dict:
    """[spmd] group runner: two processes on the one card over gloo."""
    torch.save(kmr["points"].evaluate().tensor.cpu(),
               os.path.join(workdir, "points.pt"))
    np.save(os.path.join(workdir, "c0.npy"), kmr["c0"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--spmd-child", workdir, str(r)])
             for r in range(GROUP_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=GROUP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _fail(f"[spmd] a group child did not finish in {GROUP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        _fail(f"[spmd] group children exited "
              f"{[p.returncode for p in procs]}")
    res = []
    for r in range(GROUP_RANKS):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    centers = [np.load(os.path.join(workdir, f"centers{r}.npy"))
               for r in range(GROUP_RANKS)]
    tables = [np.load(os.path.join(workdir, f"seg{r}.npy"))
              for r in range(GROUP_RANKS)]

    # the thread runner's (2, 1) run and the one-pass run, here
    pts = kmr["points"].evaluate().tensor
    c = torch.from_numpy(kmr["c0"]).to(dev)
    mesh2 = st.build_mesh((GROUP_RANKS, 1))
    for _ in range(KM_ITERS):
        s, n = kk.assign_accumulate_sharded(pts, c, KM_K, None, mesh2)
        c = s / torch.clamp_min(n, 1.0)[:, None]
    thread = c.cpu().numpy()
    x, yt, _ = _nb_data(dev)
    one = ks.segment_sum_block(x, yt, NB_CLASSES).cpu().numpy()
    del x, yt
    for r, rr in enumerate(res):
        for key, want in (("km_launches", KM_ITERS), ("seg_launches", 1),
                          ("hist_launches", 1), ("vgg_launches", 2),
                          ("km_tensor_launches", 1),
                          ("seg_tensor_launches", 1),
                          ("hist_tensor_launches", 1),
                          ("conv_tensor_launches", 1)):
            if rr[key] != want:
                _fail(f"[spmd] rank {r}: {key} {rr[key]}, want {want}")
        if not rr["hist_equal"]:
            _fail(f"[spmd] rank {r}: bincount_sharded differs from "
                  "torch.bincount")
        if not (rr["km_tensor_equal"] and rr["seg_tensor_equal"]):
            _fail(f"[spmd] rank {r}: a whole-tensor call differs from the "
                  f"same call on stored blocks (k-means step "
                  f"{rr['km_tensor_equal']}, segment {rr['seg_tensor_equal']})")
        if not rr["vgg_err"] <= 1e-5 or not rr["conv_tensor_err"] <= 1e-5:
            _fail(f"[spmd] rank {r}: VGG block max |err| {rr['vgg_err']}, "
                  f"halo_stencil on the whole tensor "
                  f"{rr['conv_tensor_err']}, against float64 (limit 1e-5)")
    if not all(np.array_equal(c_, centers[0]) for c_ in centers[1:]):
        _fail("[spmd] the ranks' k-means centers differ")
    if not np.array_equal(centers[0], thread):
        _fail("[spmd] the group's centers differ from the thread runner's "
              f"(2, 1) run: max |diff| {np.abs(centers[0] - thread).max()}")
    km_diff = float(np.abs(centers[0] - kmr["ref"]).max())
    if not km_diff <= 1e-4:
        _fail(f"[spmd] group k-means differs from the one-pass run by "
              f"{km_diff} (atol 1e-4)")
    if not (all(np.array_equal(t, tables[0]) for t in tables[1:])
            and np.array_equal(tables[0], one)):
        _fail("[spmd] segment_sum_sharded's tables differ across ranks or "
              "from the one-launch kernel's (integer-valued sums: exact)")
    staged = [rr["totals"]["collective_host_staged_calls"] for rr in res]
    staged_b = [rr["totals"]["collective_host_staged_bytes"] for rr in res]
    _say(f"[spmd] group runner: {GROUP_RANKS} processes on the one card over "
         f"gloo ({wall:.1f} s with their start-up): config-3 k-means "
         f"{KM_ITERS} launches per rank, centers bit-equal across ranks and "
         f"to the thread runner's ({GROUP_RANKS}, 1) run, max |diff| "
         f"{km_diff:.3g} to the one-pass run (atol 1e-4); "
         f"segment_sum_sharded {NB_ROWS}x{NB_FEATURES}, {NB_CLASSES} classes:"
         f" 1 launch per rank, tables bit-equal to the one-launch kernel's; "
         f"bincount_sharded of {SORT_N} ids into {HIST_BINS}: 1 launch per "
         f"rank,"
         f" bit-equal to torch.bincount; VGG-16 block 1 (H split over the "
         f"ranks): 2 conv_block launches per rank, max |err| "
         f"{max(rr['vgg_err'] for rr in res):.3g} (limit 1e-5); on whole "
         f"tensors (each rank keeps its block): one k-means step, the "
         f"segment sum and the bincount 1 launch per rank, bit-equal to "
         f"the stored blocks' and torch.bincount, halo_stencil conv1_1 1 "
         f"launch per rank, max |err| "
         f"{max(rr['conv_tensor_err'] for rr in res):.3g} (limit 1e-5)")
    for rr in res:
        _say(f"[spmd] rank {rr['rank']}: k-means "
             f"{rr['km_ms_per_iter']:.3f} ms per iteration, segment "
             f"{rr['seg_ms']:.3f} ms, bincount {rr['hist_ms']:.3f} ms, VGG "
             f"forward {rr['vgg_ms']:.1f} ms (host clock; two processes "
             f"time-slice one card); collective calls "
             f"{rr['totals']['collective_calls']}, staged through host "
             f"memory {rr['totals']['collective_host_staged_calls']} calls "
             f"{rr['totals']['collective_host_staged_bytes']} bytes on {card}")
    return {"kmeans": res[0]["km_launches"], "segment": res[0]["seg_launches"],
            "bincount": res[0]["hist_launches"],
            "conv_block": res[0]["vgg_launches"], "staged": staged,
            "staged_bytes": staged_b}


def phase_spmd_nccl(st, kk, km, card: str, dev, kmr: dict,
                    workdir: str) -> None:
    """[spmd] a one-rank nccl group in this process: every collective,
    no staging, and config-3 k-means through the group path bit-equal to
    the one-pass run."""
    from spartan_tpu_torch.obs.metrics import collective_totals
    from spartan_tpu_torch.parallel import collectives as coll
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.parallel import shard_map as smap

    rng = np.random.RandomState(5)
    a = rng.rand(DOT_N, DOT_N).astype(np.float32)
    b = rng.rand(DOT_N, DOT_N).astype(np.float32)
    want = st.dot(st.from_numpy(a), st.from_numpy(b)).glom()
    if not mesh_mod.initialize_distributed(
            "file://" + os.path.join(workdir, "nccl_store"),
            num_processes=1, process_id=0, backend="nccl", device=dev,
            timeout_s=300):
        _fail("[spmd] no nccl group")
    try:
        mesh = st.get_mesh()
        if not mesh.is_group or mesh_mod.backend(mesh) != "nccl":
            _fail(f"[spmd] the ambient mesh is not an nccl group: {mesh}")
        before = collective_totals()
        _check_collectives(st, coll, smap, mesh, dev, "one-rank nccl group")
        _reset_counts(kk)
        centers, _ = km.kmeans(kmr["points"], KM_K, num_iter=KM_ITERS,
                               centers=kmr["c0"])
        launches = kk.LAUNCHES
        # local-shard storage: the blocks on the card, the dot planned
        ea = st.from_numpy(a)
        on_card = ea.value.local.device.type == "cuda"
        prod = st.dot(ea, st.from_numpy(b)).glom()
        after = collective_totals()
    finally:
        mesh_mod.shutdown()
    staged = (after["collective_host_staged_calls"]
              - before["collective_host_staged_calls"])
    calls = after["collective_calls"] - before["collective_calls"]
    gathered = (after["group_materialize_calls"]
                - before["group_materialize_calls"])
    if staged or gathered:
        _fail(f"[spmd] {staged} collective calls staged and {gathered} "
              "arrays gathered whole on nccl")
    if launches != KM_ITERS or not np.array_equal(centers, kmr["ref"]):
        _fail(f"[spmd] nccl group k-means: {launches} launches, bit-equal "
              f"{np.array_equal(centers, kmr['ref'])}")
    if not on_card or not np.array_equal(prod, want):
        _fail(f"[spmd] nccl group dot: blocks on the card {on_card}, "
              f"bit-equal to the logical mesh's {np.array_equal(prod, want)}")
    _say(f"[spmd] one-rank nccl group, local-shard storage: {calls} "
         f"collective calls, 0 staged, 0 gathered whole; config-3 k-means "
         f"through the group path: {launches} launches, centers bit-equal "
         f"to the one-pass run; {DOT_N}^2 st.dot bit-equal to the logical "
         f"mesh's on {card}")


def local_child(workdir: str, rank: int) -> None:
    """One rank of [local]'s two-process gloo group on the one card,
    with local-shard storage at full width: config-3 k-means through
    ``st.from_numpy`` -> ``st.loop(kmeans_step)`` -> ``glom``, config
    2's 8192^2 ``st.dot``, ``st.sort``/``st.argsort``/``st.topk`` of
    2^26 keys, PageRank over the sharded SpMV, retile between every
    pair of layouts and the FLOP-weight calibration; results to
    ``workdir``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.examples import pagerank as pr
    from spartan_tpu_torch.expr import tiling_cost as tc
    from spartan_tpu_torch.kernels import exchange as kx
    from spartan_tpu_torch.kernels import kmeans as kk
    from spartan_tpu_torch.kernels import segment as ks
    from spartan_tpu_torch.kernels import topk as kt
    from spartan_tpu_torch.obs.metrics import (collective_totals,
                                               materialize_sites)
    from spartan_tpu_torch.parallel import mesh as mesh_mod

    dev = _child_device()
    st.set_default_device(dev)
    if not mesh_mod.initialize_distributed(
            "file://" + os.path.join(workdir, "store"),
            num_processes=GROUP_RANKS, process_id=rank, backend="gloo",
            device=dev, timeout_s=GROUP_TIMEOUT_S):
        _fail("[local] child: no process group")
    mesh = st.get_mesh()
    res = {"rank": rank, "mesh": [mesh.shape["x"], mesh.shape["y"]]}

    def total(key):
        return collective_totals()[key]

    def path(name, fn):
        """``fn()`` with the materializations and received bytes it
        caused."""
        m0, r0 = total("group_materialize_calls"), total(
            "group_received_bytes")
        out = fn()
        res[f"{name}_mat"] = total("group_materialize_calls") - m0
        res[f"{name}_recv"] = total("group_received_bytes") - r0
        return out

    # config-3 k-means: the points' bytes on this rank, 20 launches
    pts_np = np.load(os.path.join(workdir, "km_points.npy"), mmap_mode="r")
    c0 = np.load(os.path.join(workdir, "km_c0.npy"))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)

    def kmeans():
        points = st.from_numpy(pts_np)
        torch.cuda.synchronize()
        res["points_bytes"] = torch.cuda.memory_allocated(dev) - before
        res["points_local"] = list(points.value.local.shape)
        kk.LAUNCHES = 0
        out = st.loop(KM_ITERS, lambda c: km.kmeans_step(points, c, KM_K),
                      st.from_numpy(c0)).glom()
        res["km_launches"] = kk.LAUNCHES
        return points, out

    points, centers = path("km", kmeans)
    np.save(os.path.join(workdir, f"centers{rank}.npy"), centers)
    res["km_ms"] = _wall_ms(lambda: st.loop(
        KM_ITERS, lambda c: km.kmeans_step(points, c, KM_K),
        st.from_numpy(c0)).evaluate(), reps=2) / KM_ITERS
    del points

    # BASELINE config 2's dot through st.dot and the committed plan
    a_np = np.load(os.path.join(workdir, "dot_a.npy"), mmap_mode="r")
    b_np = np.load(os.path.join(workdir, "dot_b.npy"), mmap_mode="r")
    # the peak over what the operands and the product add
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ea, eb = st.from_numpy(a_np), st.from_numpy(b_np)
    nodes = st.dag_nodes(st.optimize(st.dot(ea, eb)))
    res["dot_plan"] = sorted(str((n._dot_plan[0].axes, n._dot_plan[1]))
                             for n in nodes
                             if getattr(n, "_dot_plan", None) is not None)
    c0_calls = total("collective_bytes")
    prod = path("dot", lambda: st.dot(ea, eb).evaluate())
    torch.cuda.synchronize()
    res["dot_peak"] = torch.cuda.max_memory_allocated(dev) - base
    res["dot_coll_bytes"] = total("collective_bytes") - c0_calls
    best = _wall_ms(lambda: st.dot(ea, eb).evaluate(), reps=2) / 1e3
    res["dot_gflops"] = 2.0 * LOCAL_DOT_N ** 3 / best / 1e9
    c = prod.glom()
    sl = np.asarray(a_np[:1024], np.float64)
    ref = (torch.from_numpy(sl).to(dev)
           @ torch.from_numpy(np.asarray(b_np, np.float64)).to(dev)).cpu()
    res["dot_err"] = float((torch.from_numpy(c[:1024]).double() - ref)
                           .abs().max() / ref.abs().max())
    del ea, eb, prod, c, ref

    # sort, argsort and top-k of 2^26 keys on the stored row blocks
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    keys = torch.rand(SORT_N, generator=gen, device=dev)
    x = st.as_expr(from_tensor(keys))
    for name, fn, want in (
            ("sort", lambda: st.sort(x).glom(),
             lambda: torch.sort(keys).values),
            ("argsort", lambda: st.argsort(x).glom(),
             lambda: torch.sort(keys, stable=True).indices.to(torch.int32))):
        kx.LAUNCHES["partition_pack"] = 0
        got = path(name, fn)
        res[f"{name}_launches"] = kx.LAUNCHES["partition_pack"]
        res[f"{name}_equal"] = bool(np.array_equal(
            got.view(np.int32), want().cpu().numpy().view(np.int32)))
        del got
        res[f"{name}_ms"] = _wall_ms(
            lambda: (st.sort if name == "sort" else st.argsort)(x)
            .evaluate(), reps=2)
    kt.LAUNCHES["shard_topk"] = 0
    vals, idx = st.topk(x, TOPK_K)
    # values and indices in one plan: one top-k, one launch a rank
    tv, ti = path("topk", lambda: st.tuple_of(vals, idx).glom())
    res["topk_launches"] = kt.LAUNCHES["shard_topk"]
    wv, wi = kt.top_k(keys, TOPK_K)
    res["topk_equal"] = bool(
        np.array_equal(ti, wi.to(torch.int32).cpu().numpy())
        and np.array_equal(tv.view(np.int32),
                           wv.cpu().numpy().view(np.int32)))
    res["topk_ms"] = _wall_ms(lambda: st.topk(x, TOPK_K)[1].evaluate(),
                              reps=2)
    del x, keys, vals, idx

    # PageRank at the [pagerank] plan over the sharded SpMV
    links = pagerank_links(st.SparseDistArray)
    links.transition()._ensure_plan()
    ks.LAUNCHES["windowed_segsum"] = 0
    ranks = path("pagerank", lambda: pr.pagerank(links, num_iter=PR_ITERS))
    res["pagerank_launches"] = ks.LAUNCHES["windowed_segsum"]
    np.save(os.path.join(workdir, f"ranks{rank}.npy"), ranks)
    res["pagerank_ms"] = _wall_ms(lambda: pr.pagerank(links,
                                                      num_iter=PR_ITERS),
                                  reps=2)
    del links

    # retile between every pair of layouts: each rank's block, bit-equal
    gen.manual_seed(31)
    whole = torch.rand(LOCAL_RETILE_N, LOCAL_RETILE_N, generator=gen,
                       device=dev)
    res["retile"] = {}
    for s_name, s_axes in LOCAL_LAYOUTS.items():
        src = from_tensor(whole, tiling=st.Tiling(s_axes))
        for d_name, d_axes in LOCAL_LAYOUTS.items():
            t = st.Tiling(d_axes)
            r0 = total("group_received_bytes")
            out = src.retile(t)
            torch.cuda.synchronize()
            recv = total("group_received_bytes") - r0
            ext = t.block_extent(src.shape, mesh)
            res["retile"][f"{s_name}->{d_name}"] = [
                bool(torch.equal(out.local, whole[ext.to_slice()])), recv]
    del whole, src, out

    res["flop_weight"] = tc.calibrate_flop_weight(LOCAL_CAL_N, mesh=mesh)
    # the plan the DP gives config 2's dot at the calibrated weight
    # (planned only; every rank has the same weight)
    prev = st.FLAGS.tiling_flop_weight
    st.FLAGS.tiling_flop_weight = res["flop_weight"]
    try:
        za, zb = (st.zeros((LOCAL_DOT_N, LOCAL_DOT_N)) for _ in range(2))
        res["dot_plan_calibrated"] = sorted(
            str((n._dot_plan[0].axes, n._dot_plan[1]))
            for n in st.dag_nodes(st.optimize(st.dot(za, zb)))
            if getattr(n, "_dot_plan", None) is not None)
        del za, zb
    finally:
        st.FLAGS.tiling_flop_weight = prev
    res["sites"] = materialize_sites()
    res["totals"] = collective_totals()
    with open(os.path.join(workdir, f"local{rank}.json"), "w") as f:
        json.dump(res, f)
    mesh_mod.shutdown()


def phase_local(st, kk, km, pr, links, card: str, dev, workdir: str) -> dict:
    """[local]: local-shard storage on two gloo processes sharing the
    card, each holding only its blocks, against one-process runs here."""
    t0 = time.perf_counter()
    pts_np, c0_np, _ = _data(LOCAL_KM_N, KM_D, KM_K, "clustered", 0)
    np.save(os.path.join(workdir, "km_points.npy"), pts_np)
    np.save(os.path.join(workdir, "km_c0.npy"), c0_np)
    rng = np.random.RandomState(2)
    a_np = rng.rand(LOCAL_DOT_N, LOCAL_DOT_N).astype(np.float32)
    b_np = rng.rand(LOCAL_DOT_N, LOCAL_DOT_N).astype(np.float32)
    np.save(os.path.join(workdir, "dot_a.npy"), a_np)
    np.save(os.path.join(workdir, "dot_b.npy"), b_np)
    # the one-process runs on this process's logical 1 x 1 mesh
    points = st.from_numpy(pts_np)
    one_km = st.loop(KM_ITERS, lambda c: km.kmeans_step(points, c, KM_K),
                     st.from_numpy(c0_np)).glom()
    one_km_ms = _wall_ms(lambda: st.loop(
        KM_ITERS, lambda c: km.kmeans_step(points, c, KM_K),
        st.from_numpy(c0_np)).evaluate(), reps=2) / KM_ITERS
    del points
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ea, eb = st.from_numpy(a_np), st.from_numpy(b_np)
    st.dot(ea, eb).evaluate()
    torch.cuda.synchronize()
    one_dot_peak = torch.cuda.max_memory_allocated() - base
    one_dot_gflops = 2.0 * LOCAL_DOT_N ** 3 / (_wall_ms(
        lambda: st.dot(ea, eb).evaluate(), reps=2) / 1e3) / 1e9
    del ea, eb, a_np, b_np, pts_np
    one_ranks = pr.pagerank(links, num_iter=PR_ITERS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--local-child", workdir, str(r)])
             for r in range(GROUP_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=GROUP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _fail(f"[local] a group child did not finish in {GROUP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t1
    if any(p.returncode != 0 for p in procs):
        _fail(f"[local] group children exited "
              f"{[p.returncode for p in procs]}")
    res = []
    for r in range(GROUP_RANKS):
        with open(os.path.join(workdir, f"local{r}.json")) as f:
            res.append(json.load(f))
    centers = [np.load(os.path.join(workdir, f"centers{r}.npy"))
               for r in range(GROUP_RANKS)]
    ranks = [np.load(os.path.join(workdir, f"ranks{r}.npy"))
             for r in range(GROUP_RANKS)]
    block = LOCAL_KM_N // GROUP_RANKS * KM_D * 4
    for r, rr in enumerate(res):
        want = {"km_launches": KM_ITERS, "sort_launches": 1,
                "argsort_launches": 2, "topk_launches": 1,
                "pagerank_launches": PR_ITERS}
        for key, n in want.items():
            if rr[key] != n:
                _fail(f"[local] rank {r}: {key} {rr[key]}, want {n}")
        for name in ("km", "dot", "sort", "argsort", "topk", "pagerank"):
            if rr[f"{name}_mat"] != 0:
                _fail(f"[local] rank {r}: the {name} path gathered "
                      f"{rr[f'{name}_mat']} arrays whole "
                      f"({rr['sites']})")
        if rr["points_bytes"] != block or rr["points_local"] != [
                LOCAL_KM_N // GROUP_RANKS, KM_D]:
            _fail(f"[local] rank {r} holds {rr['points_bytes']} bytes "
                  f"{rr['points_local']} of the points, want its block of "
                  f"{block}")
        for key in ("sort_equal", "argsort_equal", "topk_equal"):
            if not rr[key]:
                _fail(f"[local] rank {r}: {key} is False")
        if not rr["dot_err"] <= 1e-5:
            _fail(f"[local] rank {r}: 8192^2 dot rel err {rr['dot_err']} "
                  "against float64 (limit 1e-5)")
        bad = [k for k, (ok, _) in rr["retile"].items() if not ok]
        if bad:
            _fail(f"[local] rank {r}: retile {bad} not bit-equal")
    if len({(rr["flop_weight"], str(rr["dot_plan_calibrated"]))
            for rr in res}) != 1:
        _fail("[local] the ranks' calibrated FLOP weights or their plans "
              "differ")
    if not all(np.array_equal(c, centers[0]) for c in centers[1:]):
        _fail("[local] the ranks' k-means centers differ")
    km_diff = float(np.abs(centers[0] - one_km).max())
    if not km_diff <= 1e-4:
        _fail(f"[local] k-means differs from the one-process run by "
              f"{km_diff} (atol 1e-4)")
    pr_err = max(float(np.abs(rk - one_ranks).max()) for rk in ranks) \
        / float(one_ranks.max())
    if not pr_err <= 1e-6:
        _fail(f"[local] PageRank differs from the one-process run by "
              f"{pr_err} of the largest rank (limit 1e-6)")
    r0 = res[0]
    _say(f"[local] {GROUP_RANKS} gloo processes on the one card, mesh "
         f"{tuple(r0['mesh'])}, local-shard storage ({wall:.1f} s with "
         f"their start-up): config-3 k-means {LOCAL_KM_N}x{KM_D} k={KM_K}: "
         f"each rank holds {r0['points_bytes']} bytes of points "
         f"({r0['points_bytes'] / 1e6:.1f} MB, its {LOCAL_KM_N // 2} "
         f"rows; whole storage held {2 * block / 1e6:.1f} MB), "
         f"{KM_ITERS} launches per rank, 0 gathered whole, centers "
         f"bit-equal across ranks, max |diff| {km_diff:.3g} to the "
         f"one-process run (atol 1e-4)")
    for rr in res:
        _say(f"[local] rank {rr['rank']}: k-means {rr['km_ms']:.3f} ms per "
             f"iteration (one process here: {one_km_ms:.3f} ms); dot "
             f"{LOCAL_DOT_N}^2 plan {rr['dot_plan']}, {rr['dot_gflops']:.1f}"
             f" GFLOPS (one process here: {one_dot_gflops:.1f}), received "
             f"{rr['dot_recv']} bytes ({rr['dot_coll_bytes']} into "
             f"collectives), peak over the operands and the product "
             f"{rr['dot_peak'] / 1e6:.1f} MB (one process: "
             f"{one_dot_peak / 1e6:.1f} MB), rel err "
             f"{rr['dot_err']:.3g} vs float64 on 1024 rows; sort "
             f"{rr['sort_ms']:.1f} ms (1 partition_pack launch), argsort "
             f"{rr['argsort_ms']:.1f} ms (2), top-{TOPK_K} "
             f"{rr['topk_ms']:.1f} ms (1 shard_topk launch), bit-equal to "
             f"torch.sort and the one-pass top-k; PageRank "
             f"{PR_ITERS} iterations {rr['pagerank_ms']:.1f} ms "
             f"({PR_ITERS} windowed_segsum launches), max |diff| "
             f"{pr_err:.3g} of the largest rank to the one-process run; "
             f"0 gathered whole on each path (host clock; two processes "
             f"time-slice one card) on {card}")
        _say(f"[local] rank {rr['rank']}: retile {LOCAL_RETILE_N}^2 f32 "
             f"between {list(LOCAL_LAYOUTS)} (bit-equal; bytes received): "
             + ", ".join(f"{k} {v[1]}" for k, v in rr["retile"].items()))
        _say(f"[local] rank {rr['rank']}: calibrate_flop_weight "
             f"({LOCAL_CAL_N}^2 matmul against a row -> replicated gather "
             f"over the gloo group, host-staged) = {rr['flop_weight']:.4g},"
             f" the DP's plan for the {LOCAL_DOT_N}^2 dot at that weight "
             f"{rr['dot_plan_calibrated']};"
             f" gathered whole by site over the whole child: "
             f"{rr['sites']}; staged through host memory "
             f"{rr['totals']['collective_host_staged_calls']} calls "
             f"{rr['totals']['collective_host_staged_bytes']} bytes")
    _say(f"[local] phase {time.perf_counter() - t0:.1f} s on {card}")
    return {"kmeans": r0["km_launches"], "partition_pack": r0["sort_launches"],
            "shard_topk": r0["topk_launches"],
            "windowed_segsum": r0["pagerank_launches"]}


# -- [resilience] and [elastic_group] -------------------------------------


def _counter(st, name: str) -> int:
    return st.metrics()["counters"].get(name, 0)


def _span_ms(st, names) -> dict:
    """ms by the host clock of the last span of each name in the ring."""
    out = {}
    for sp in st.trace_events():
        if sp.name in names:
            out[sp.name] = sp.seconds * 1e3
    return out


def _copy_snapshot(src: str, dst: str, step: int) -> None:
    """A copy of a loop's snapshot directory that stops at ``step``."""
    shutil.copytree(src, dst)
    for d in os.listdir(dst):
        if d.startswith("step_") and int(d[5:]) > step:
            shutil.rmtree(os.path.join(dst, d))
    with open(os.path.join(dst, "LATEST.json"), "w") as f:
        json.dump({"step": step, "dir": f"step_{step:08d}"}, f)


def phase_resilience(st, kk, km, card: str, dev, workdir: str) -> dict:
    """[resilience]: BASELINE config 3 (1,000,448 x 128, k = 64, 20
    iterations, a snapshot every 5) on a logical (4, 2) mesh through
    ``st.chaos``: a transient fault (retried, bit-equal), an OOM (the
    ladder's finer_tiling rung, within 1e-5), a real
    ``torch.cuda.OutOfMemoryError`` inside an evaluate (classified oom),
    and a device loss (the mesh rebuilt to (7, 1) at epoch 1, the points
    rehomed through the migration planner, the loop resumed from its
    iteration-10 snapshot, bit-equal to a clean resume of a copy of that
    snapshot on (7, 1)). Ends at epoch 0."""
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.resilience import classify as cls
    from spartan_tpu_torch.resilience import elastic, loop_ckpt

    t0 = time.perf_counter()
    pts_np, c0_np, _ = _data(LOCAL_KM_N, KM_D, KM_K, "clustered", 0)
    keep = loop_ckpt._KEEP_SNAPSHOTS
    loop_ckpt._KEEP_SNAPSHOTS = 16  # keep the iteration-10 restore point
    try:
        with st.use_mesh(st.build_mesh(RES_MESH)):
            points = st.from_numpy(pts_np)

            def run(tag, pts=None, **kw):
                """The loop writing snapshots under ``tag``, or resuming
                ``resume=`` when given."""
                p = pts if pts is not None else points
                if tag is not None:
                    kw["checkpoint_path"] = os.path.join(workdir, tag)
                return st.loop(KM_ITERS, lambda c: km.kmeans_step(p, c, KM_K),
                               st.from_numpy(c0_np),
                               checkpoint_every=CKL_EVERY, **kw)

            _reset_counts(kk)
            ref = run("clean").glom()
            if kk.LAUNCHES != KM_ITERS:
                _fail(f"[resilience] clean loop: {kk.LAUNCHES} launches")

            r0 = _counter(st, "resilience_retries")
            _reset_counts(kk)
            with st.chaos("transient@1") as plan:
                out = run("transient")
                got = out.glom()
            retries = _counter(st, "resilience_retries") - r0
            if (kk.LAUNCHES != KM_ITERS or retries < 1
                    or not np.array_equal(got, ref)):
                _fail(f"[resilience] transient@1: {kk.LAUNCHES} launches, "
                      f"{retries} retries, bit-equal "
                      f"{np.array_equal(got, ref)}")
            _say(f"[resilience] transient@1 ({plan.fired}): "
                 f"{retries} retry, {kk.LAUNCHES} launches, centers "
                 "bit-equal to the clean loop's")

            d0 = _counter(st, "resilience_degrade_finer_tiling")
            _reset_counts(kk)
            with st.chaos("oom@1") as plan:
                out = run("oom")
                got = out.glom()
            rung = out._resilience["rung"]
            err = float(np.abs(got - ref).max() / np.abs(ref).max())
            if (rung != "finer_tiling" or not err <= 1e-5
                    or _counter(st, "resilience_degrade_finer_tiling") != d0 + 1
                    or kk.LAUNCHES != KM_ITERS):
                _fail(f"[resilience] oom@1: rung {rung}, rel err {err}, "
                      f"{kk.LAUNCHES} launches")
            _say(f"[resilience] oom@1 ({plan.fired}): the ladder took "
                 f"{rung}, {kk.LAUNCHES} launches, max rel diff {err:.3g} "
                 "to the clean loop (limit 1e-5)")

            armed = [True]

            def grab(t):
                # one allocation larger than the card (so larger than its
                # free memory and the allocator's cache) on the first real
                # run: the build calls it on meta tensors
                if armed[0] and t.device.type != "meta":
                    armed[0] = False
                    _, total = torch.cuda.mem_get_info(t.device)
                    torch.empty(total + (1 << 30), dtype=torch.uint8,
                                device=t.device)
                return t * 2.0

            small = st.from_numpy(c0_np)
            e = st.map(grab, small)
            got = e.glom()
            rec = e._resilience
            first = rec["faults"][0]
            if (first["class"] != cls.OOM
                    or "OutOfMemoryError" not in first["error"]
                    or not np.array_equal(got, c0_np * 2.0)):
                _fail(f"[resilience] real OOM: {rec}")
            again = st.map(grab, st.from_numpy(c0_np)).glom()
            if not np.array_equal(again, c0_np * 2.0):
                _fail("[resilience] the evaluate after the real OOM differs")
            _say(f"[resilience] a real torch.cuda.OutOfMemoryError inside an "
                 f"evaluate: classified {first['class']}, the ladder took "
                 f"{rec['rung']}; the next evaluate succeeded")

            st.trace_clear()
            ev0 = _counter(st, "elastic_plans_evicted")
            _reset_counts(kk)
            with st.chaos("device_loss@2") as plan:
                t1 = time.perf_counter()
                out = run("loss")
                got = out.glom()
                loss_s = time.perf_counter() - t1
            launches = kk.LAUNCHES
            rec = out._resilience
            mesh = mesh_mod.get_mesh()
            spans = _span_ms(st, ("drain", "rebuild", "evict", "migrate",
                                  "elastic_recover", "elastic_rehome"))
            evicted = _counter(st, "elastic_plans_evicted") - ev0
            rehomed = elastic.last_rehome_report()
            if (dict(mesh.shape) != {"x": 7, "y": 1}
                    or mesh_mod.mesh_epoch() != 1 or not rec["mesh_rebuilt"]
                    or rec["restores"] != 1 or launches != KM_ITERS
                    or len(rehomed) != 1):
                _fail(f"[resilience] device_loss@2: mesh {mesh}, epoch "
                      f"{mesh_mod.mesh_epoch()}, record {rec}, {launches} "
                      f"launches, rehomed {rehomed}")
            ref_dir = os.path.join(workdir, "loss_ref")
            _copy_snapshot(os.path.join(workdir, "loss"), ref_dir,
                           2 * CKL_EVERY)
            points2 = st.from_numpy(pts_np)
            _reset_counts(kk)
            ref2 = run(None, pts=points2, resume=ref_dir).glom()
            ref_launches = kk.LAUNCHES
            if ref_launches != KM_ITERS - 2 * CKL_EVERY or \
                    not np.array_equal(got, ref2):
                _fail(f"[resilience] device_loss@2: clean resume "
                      f"{ref_launches} launches, bit-equal "
                      f"{np.array_equal(got, ref2)}")
            mig = rehomed[0]
            _say(f"[resilience] device_loss@2 ({plan.fired}): mesh "
                 f"{RES_MESH} -> (7, 1) at epoch {mesh_mod.mesh_epoch()}; the "
                 f"points rehomed through plan_rehome: route {mig['route']}, "
                 f"{mig['bytes']} modeled wire bytes ({mig['schedule']}; the "
                 f"logical positions share the card, so no byte moved); "
                 f"restored from the iteration-{2 * CKL_EVERY} snapshot "
                 f"({len(rec.get('migrations', []))} carry migration "
                 f"record, {rec['migrations'][0]['route']}); {launches} "
                 f"k-means launches in the faulted run, {ref_launches} in the "
                 f"clean resume of a copy on (7, 1): centers bit-equal; "
                 f"{loss_s:.2f} s for the faulted run")
            _say(f"[resilience] recovery spans (ms, host clock): drain "
                 f"{spans.get('drain', 0):.3f}, rebuild "
                 f"{spans.get('rebuild', 0):.3f}, evict "
                 f"{spans.get('evict', 0):.3f} ({evicted} plans evicted), "
                 f"migrate {spans.get('migrate', 0):.3f}; elastic_recover "
                 f"{spans.get('elastic_recover', 0):.3f}, elastic_rehome "
                 f"{spans.get('elastic_rehome', 0):.3f} on {card}")
    finally:
        st.chaos_clear()
        loop_ckpt._KEEP_SNAPSHOTS = keep
        mesh_mod.reset_epoch_for_tests()
    _say(f"[resilience] phase {time.perf_counter() - t0:.1f} s on {card}")
    return {"launches": launches, "ref_launches": ref_launches}


def elastic_child(workdir: str, rank: int) -> None:
    """One rank of an [elastic_group] world on the card (gloo, local
    storage): config-3 k-means with its labels as a second carry,
    checkpointed every 5 under ``job.json``'s ``mode`` (``run`` writes
    the snapshots, ``resume`` resumes them). A failure prints its class
    and exits 3."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spartan_tpu_torch as st
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.kernels import kmeans as kk
    from spartan_tpu_torch.obs.metrics import materialize_sites
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.resilience import classify as cls

    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    dev = _child_device()
    st.set_default_device(dev)
    if not mesh_mod.initialize_distributed(
            "file://" + os.path.join(workdir, "store"),
            num_processes=job["world"], process_id=rank, backend="gloo",
            device=dev, timeout_s=ELASTIC_TIMEOUT_S):
        _fail("[elastic_group] child: no process group")
    pts_np = np.load(job["points"], mmap_mode="r")
    points = st.from_numpy(pts_np)
    labels0 = st.from_numpy(np.zeros(pts_np.shape[0], np.int32))
    c0 = st.from_numpy(np.load(job["c0"]))
    if job.get("slow"):
        st.chaos(f"slow:1.0={job['slow']}")
    kw = ({"resume": job["ck"]} if job["mode"] == "resume"
          else {"checkpoint_path": job["ck"]})
    kk.LAUNCHES = 0
    t = time.perf_counter()
    try:
        c, lab = st.loop(
            KM_ITERS, lambda c, lab: (km.kmeans_step(points, c, KM_K),
                                      km.assign_points(points, c)),
            c0, labels0, checkpoint_every=CKL_EVERY, **kw)
        centers, labels = c.glom(), lab.glom()
        torch.cuda.synchronize()
    except Exception as exc:
        print(f"[elastic_group] rank {rank}: {type(exc).__name__} "
              f"classified {cls.classify(exc)}; gathers at site checkpoint "
              f"{materialize_sites().get('checkpoint', 0)}: "
              f"{str(exc)[:160]}", flush=True)
        os._exit(3)
    secs = time.perf_counter() - t
    rec = c._resilience
    spans = {name: [round(sp.seconds * 1e3, 3) for sp in st.trace_events()
                    if sp.name == name]
             for name in ("loop_segment", "loop_checkpoint")}
    np.save(os.path.join(workdir, f"centers{rank}.npy"), centers)
    np.save(os.path.join(workdir, f"labels{rank}.npy"), labels)
    with open(os.path.join(workdir, f"result{rank}.json"), "w") as f:
        json.dump({"launches": kk.LAUNCHES, "seconds": secs,
                   "segment_ms": spans["loop_segment"],
                   "snapshot_ms": spans["loop_checkpoint"],
                   "resumed_from": rec["resumed_from"],
                   "migrations": [{k: m[k] for k in ("route", "src_mesh",
                                                     "dst_mesh", "bytes")}
                                  for m in rec.get("migrations", [])],
                   "checkpoint_gathers": materialize_sites().get(
                       "checkpoint", 0)}, f)
    st.shutdown()


def _elastic_world(workdir: str, job: dict) -> list:
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "job.json"), "w") as f:
        json.dump(job, f)
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--elastic-child", workdir, str(r)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for r in range(job["world"])]


def _elastic_join(procs: list, label: str) -> list:
    try:
        logs = [p.communicate(timeout=ELASTIC_JOIN_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        _fail(f"[elastic_group] {label}: a child did not finish in "
              f"{ELASTIC_JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return logs


def phase_elastic_group(st, card: str, workdir: str) -> dict:
    """[elastic_group]: two gloo ranks sharing the card run config-3
    k-means checkpointed every 5 with local storage; rank 1 is SIGKILLed
    once ``LATEST.json`` reads step 10, and rank 0 must exit nonzero
    within the group's timeout with the failure classified fatal_mesh. A
    one-process survivor world resumes the snapshot (a ``restore``
    migration from (2, 1) to (1, 1), 10 k-means launches), bit-equal to a
    clean one-process resume of a copy of it."""
    import signal

    t0 = time.perf_counter()
    pts_np, c0_np, _ = _data(LOCAL_KM_N, KM_D, KM_K, "clustered", 0)
    pts_path = os.path.join(workdir, "points.npy")
    np.save(pts_path, pts_np)
    np.save(os.path.join(workdir, "c0.npy"), c0_np)
    del pts_np
    base = {"points": pts_path, "c0": os.path.join(workdir, "c0.npy")}
    ck = os.path.join(workdir, "ck")
    victim_dir = os.path.join(workdir, "victim")
    procs = _elastic_world(victim_dir, dict(base, world=2, mode="run", ck=ck,
                                            slow=ELASTIC_SLOW_S))
    marker = os.path.join(ck, "LATEST.json")
    deadline = time.monotonic() + ELASTIC_JOIN_S
    killed_at = None
    while time.monotonic() < deadline and all(p.poll() is None
                                              for p in procs):
        try:
            with open(marker) as f:
                if json.load(f)["step"] >= 2 * CKL_EVERY:
                    procs[1].send_signal(signal.SIGKILL)
                    killed_at = time.monotonic()
                    break
        except (OSError, ValueError, KeyError):
            pass
        time.sleep(0.02)
    logs = _elastic_join(procs, "the victim world")
    if killed_at is None:
        _fail(f"[elastic_group] rank 1 was not killed at step 10 "
              f"(exit codes {[p.returncode for p in procs]}):\n"
              f"{logs[0][-2000:]}\n{logs[1][-2000:]}")
    exit_s = time.monotonic() - killed_at
    line = [ln for ln in logs[0].splitlines() if "classified" in ln]
    if (procs[0].returncode == 0 or not line
            or "classified fatal_mesh" not in line[-1]
            or "site checkpoint 0" not in line[-1]
            or exit_s > ELASTIC_TIMEOUT_S):
        _fail(f"[elastic_group] rank 0 exited {procs[0].returncode} after "
              f"{exit_s:.1f} s:\n{logs[0][-3000:]}")
    with open(marker) as f:
        step = json.load(f)["step"]
    if step != 2 * CKL_EVERY:
        _fail(f"[elastic_group] LATEST.json names step {step}")
    snap = os.path.join(ck, f"step_{step:08d}", "carry1")
    with open(os.path.join(snap, "manifest.json")) as f:
        shards = json.load(f)["shards"]
    if (len(shards) != 2 or not all(os.path.exists(os.path.join(
            snap, r["file"])) for r in shards)
            or sum("crc32" in r for r in shards) != 1):
        _fail(f"[elastic_group] the labels' snapshot is not one blob per "
              f"rank: {shards}")
    _say(f"[elastic_group] 2 gloo ranks on the card, rank 1 SIGKILLed after "
         f"the iteration-{step} snapshot; rank 0 exited "
         f"{procs[0].returncode} {exit_s:.2f} s later: {line[-1].strip()}")
    _say(f"[elastic_group] snapshot at step {step}: the labels' 2 blobs, "
         f"one written by each rank (rank 1's without a CRC, as in the JAX "
         f"package's multi-process writer), 0 gathers at site checkpoint")
    ref_ck = os.path.join(workdir, "ref_ck")
    _copy_snapshot(ck, ref_ck, step)
    surv_dir = os.path.join(workdir, "survivor")
    clean_dir = os.path.join(workdir, "clean")
    survivor = _elastic_world(surv_dir, dict(base, world=1, mode="resume",
                                             ck=ck))
    clean = _elastic_world(clean_dir, dict(base, world=1, mode="resume",
                                           ck=ref_ck))
    s_log = _elastic_join(survivor, "the survivor world")
    c_log = _elastic_join(clean, "the clean world")
    res = {}
    for tag, d, p, log in (("survivor", surv_dir, survivor, s_log),
                           ("clean", clean_dir, clean, c_log)):
        if p[0].returncode != 0:
            _fail(f"[elastic_group] the {tag} world exited "
                  f"{p[0].returncode}:\n{log[0][-3000:]}")
        with open(os.path.join(d, "result0.json")) as f:
            res[tag] = json.load(f)
        res[tag]["centers"] = np.load(os.path.join(d, "centers0.npy"))
        res[tag]["labels"] = np.load(os.path.join(d, "labels0.npy"))
    sv = res["survivor"]
    want = {"route": "restore", "src_mesh": {"x": 2, "y": 1},
            "dst_mesh": {"x": 1, "y": 1}}
    migs = [{k: m[k] for k in want} for m in sv["migrations"]]
    if (sv["resumed_from"] != step or want not in migs
            or sv["launches"] != KM_ITERS - step
            or sv["checkpoint_gathers"] != 0):
        _fail(f"[elastic_group] survivor: {sv}")
    if not (np.array_equal(sv["centers"], res["clean"]["centers"])
            and np.array_equal(sv["labels"], res["clean"]["labels"])):
        _fail("[elastic_group] the survivor's centers or labels differ from "
              "the clean resume's")
    its = (KM_ITERS - step) / sv["seconds"]
    _say(f"[elastic_group] one-process survivor world resumed from step "
         f"{sv['resumed_from']}: migration records "
         f"{sv['migrations']}, {sv['launches']} k-means launches, "
         f"{its:.2f} iterations/s over its {KM_ITERS - step} iterations "
         f"(the resume's load, snapshots at 15 and 20 and the final glom "
         f"included, host clock): segments {sv['segment_ms']} ms, "
         f"snapshots {sv['snapshot_ms']} ms (the first segment plans and "
         f"warms a fresh process); centers and labels bit-equal to a clean "
         f"one-process resume of a copy of the snapshot, on {card}")
    _say(f"[elastic_group] phase {time.perf_counter() - t0:.1f} s on {card}")
    return {"survivor_launches": sv["launches"],
            "survivor_its": its, "exit_s": exit_s}


# -- phase [obs] ----------------------------------------------------------


def _within(label: str, got: float, want: float, tol: float) -> None:
    """Fail unless ``got`` is within ``tol`` (relative) of ``want``."""
    rel = abs(got - want) / want
    _say(f"[obs] {label}: {got:.4f} ms against {want:.4f} ms "
         f"({100.0 * rel:.1f}% off; limit +/-{100.0 * tol:.0f}%)")
    if not rel <= tol:
        _fail(f"[obs] {label} is {100.0 * rel:.1f}% off its CUDA-event "
              f"time")


# how far a replay's per-node times may sum past its measured walk: each
# node and the walk are timed apart with CUDA events, best of 3, and a
# kernel's time spreads by about 1% from call to call on the card; a
# capture's kernels lie inside its walk, so its sum is held to the wall
REPLAY_SUM_TOL = 0.05


def _kernel_ms(prof: dict, node_prefix: str, names) -> list:
    """Per node of ``prof`` (``DeviceProfile.to_dict()``) whose label
    starts with ``node_prefix``, in walk order: the ms of its device
    events whose name contains one of ``names`` (the capture tier: the
    kernels the wrapper launches), else the node's ms (the replay
    tier)."""
    out = []
    for n in sorted((n for n in prof["nodes"]
                     if n["node"].startswith(node_prefix)),
                    key=lambda n: n.get("topo", 0)):
        ks = n.get("kernels")
        if ks:
            out.append(sum(s for k, s in ks.items()
                           if any(p in k for p in names)) * 1e3)
        else:
            out.append(n["seconds"] * 1e3)
    return out


def _show_profile(prof: dict, label: str, top: int = 4) -> None:
    """Print a profile's top nodes and hold its per-node sum to its wall
    (exactly for a capture, within ``REPLAY_SUM_TOL`` for a replay)."""
    rows = ", ".join(f"{n['node']} {n['seconds'] * 1e3:.4f} ms"
                     for n in prof["nodes"][:top])
    tol = REPLAY_SUM_TOL if prof["tier"] == "replay" else 0.0
    _say(f"[obs] {label} profile [{prof['tier']}]: wall "
         f"{prof['wall_s'] * 1e3:.4f} ms, attributed "
         f"{prof['attributed_s'] * 1e3:.4f} ms "
         f"({100.0 * prof['attributed_fraction']:.1f}%, past the wall by "
         f"{prof['excess_s'] * 1e3:.4f} ms; limit {100.0 * tol:.0f}% of "
         f"the wall); top: {rows}"
         + (f"; note: {prof['note']}" if prof["note"] else ""))
    # node seconds are kept to the nanosecond (DeviceProfile rounds them)
    if prof["excess_s"] > tol * prof["wall_s"] + 1e-9 * len(prof["nodes"]):
        _fail(f"[obs] {label}: the per-node sum exceeds the wall time")


def _capture_dict(prof, capture_s: float, age_s: float) -> dict:
    """A capture's report for the parent: the profile's fields, how many
    device events it joined, its host cost and the process's age."""
    return dict(prof.to_dict(), events=len(prof.events),
                capture_s=capture_s, age_s=age_s)


def obs_child(workdir: str) -> None:
    """The ``[obs]`` phase's captures in a young process, where the
    profiler keeps the device records (PERF.md section 7): one config-3
    ``kmeans_step`` on ``RES_MESH`` and the VGG-16 block-1 forward on
    ``VGG_MESH``, each through ``st.profile(tier="capture")``, their
    reports written to ``workdir/obs.json``."""
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.examples import kmeans as km

    dev = _child_device()
    st.set_default_device(dev)
    pts_np, c0_np, _ = _data(KM_N, KM_D, KM_K, "clustered", 0)
    points = st.from_numpy(pts_np)
    c0 = st.from_numpy(c0_np)
    out = {}
    with st.use_mesh(st.build_mesh(RES_MESH)):
        step = km.kmeans_step(points, c0, KM_K)
        step.evaluate()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = st.profile(step, tier="capture")
        out["kmeans"] = _capture_dict(prof, time.perf_counter() - t0,
                                      t0 - t_start)
    x, params = _vgg_params(dev)
    X = from_tensor(x, tiling=st.Tiling((None, "x", None, None)))
    P = [(from_tensor(w), from_tensor(b)) for w, b in params]
    with st.use_mesh(st.build_mesh(VGG_MESH)):
        vgg_block1(st, X, P).evaluate()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof = st.profile(vgg_block1(st, X, P), tier="capture")
        out["vgg"] = _capture_dict(prof, time.perf_counter() - t0,
                                   t0 - t_start)
    with open(os.path.join(workdir, "obs.json"), "w") as f:
        json.dump(out, f)


def _obs_captures() -> dict:
    """Run :func:`obs_child` and return its reports."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--obs-child",
             workdir], capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            _fail(f"[obs] the capture child exited {res.returncode}: "
                  f"{(res.stdout + res.stderr)[-2000:]}")
        with open(os.path.join(workdir, "obs.json")) as f:
            caps = json.load(f)
        _say(f"[obs] the capture child ran in "
             f"{time.perf_counter() - t0:.1f} s; its captures at "
             f"{caps['kmeans']['age_s']:.1f} s and "
             f"{caps['vgg']['age_s']:.1f} s of its age")
        return caps
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _hold_capture(cap: dict, label: str) -> None:
    """Fail unless the capture tier answered from the profiler's device
    records: tier 'capture', no note, device events joined."""
    if cap["tier"] != "capture" or cap["note"] is not None or \
            not cap["events"]:
        _fail(f"[obs] {label}: the capture tier did not answer from the "
              f"profiler's device records: tier {cap['tier']}, note "
              f"{cap['note']}, {cap['events']} device events")


def _loop_ips(st, km, points, c0, reps: int = 3) -> float:
    """Config-3 iterations per second of one 20-iteration st.loop
    evaluation (host clock to a synchronise), best of ``reps``."""
    ms = _wall_ms(lambda: st.loop(KM_ITERS, lambda c: km.kmeans_step(
        points, c, KM_K), c0).evaluate(), reps=reps)
    return KM_ITERS / (ms / 1e3)


def phase_obs(st, kk, km, card: str, kmr: dict, vggr: dict) -> None:
    """Observability and static analysis on the card: st.explain with
    its counted cost, st.profile in both tiers, st.audit, the loop's
    health series and early exit, the instrumentation's cost, and a
    calibration from the ledger."""
    from spartan_tpu_torch.obs import ledger as led
    from spartan_tpu_torch.obs import numerics as num
    from spartan_tpu_torch.obs import profile as oprof
    from spartan_tpu_torch.utils import profiling as prof

    t_phase = time.perf_counter()
    points = kmr["points"]
    c0 = st.from_numpy(kmr["c0"])
    flags = st.FLAGS
    with st.use_mesh(st.build_mesh(RES_MESH)):
        # -- explain: the kernel node, the tilings, the counted cost
        rep = st.explain(km.kmeans_step(points, c0, KM_K))
        kern = [k for k in rep.kernels or () if k["op"] == "kmeans"]
        _say(f"[obs] explain kmeans_step on {RES_MESH}: kernel nodes "
             f"{rep.kernels}; tilings "
             f"{[(t['node'], t['tiling']) for t in rep.tilings]}")
        if [k["backend"] for k in kern] != ["cuda"]:
            _fail(f"[obs] the k-means step's kernel node is not on the "
                  f"cuda backend: {rep.kernels}")
        ca = rep.cost_analysis
        node = [n for n in ca["nodes"] if "kernel" in n]
        _say(f"[obs] cost_analysis: {ca['flops']:.6g} FLOPs, "
             f"{ca['bytes accessed']:.6g} bytes per device of "
             f"{ca['devices']}; program {ca['program']['flops']:.6g} FLOPs,"
             f" {ca['program']['bytes accessed']:.6g} bytes; kernel node "
             f"{node[0]['kernel'] if node else None} against [kmeans]'s "
             f"ops {kmr['ops']!r} nbytes {kmr['nbytes']!r} (limit: equal)")
        if len(node) != 1 or node[0]["kernel"]["flops"] != kmr["ops"] or \
                node[0]["kernel"]["bytes accessed"] != kmr["nbytes"]:
            _fail("[obs] the k-means node's cost_analysis is not the "
                  "kernel's count")
        rng = np.random.RandomState(0)
        ea = st.from_numpy(rng.rand(DOT_N, DOT_N).astype(np.float32))
        eb = st.from_numpy(rng.rand(DOT_N, DOT_N).astype(np.float32))
        drep = st.explain(_build_chain(st, ea, eb, DOT_K))
        _say(f"[obs] explain of the {DOT_N}^2 dot chain [cache "
             f"{drep.cache}]: passes "
             f"{[(p['name'], p['nodes_before'], p['nodes_after']) for p in drep.passes]}"
             f"; dp_cost {drep.dp_cost!r} {drep.cost_components}")
        if drep.cache != "miss" or not drep.passes:
            _fail("[obs] the dot chain's explain is not a first miss")

    # -- profile: the kernel node's device ms in both tiers; the
    # captures run in a young child process
    caps = _obs_captures()
    with st.use_mesh(st.build_mesh(RES_MESH)):
        step = km.kmeans_step(points, c0, KM_K)
        t0 = time.perf_counter()
        prep = st.profile(step, tier="replay").to_dict()
        rep_s = time.perf_counter() - t0
        walk_ms = _wall_ms(lambda: km.kmeans_step(points, c0,
                                                  KM_K).evaluate())
        # what answers in this aged process (a report, not a check)
        aged = st.profile(step, tier="auto")
        _say(f"[obs] the step profiled with tier='auto' in this process "
             f"at {time.perf_counter() - _T_IMPORT:.1f} s of its age: the "
             f"{aged.tier} tier answered, {len(aged.events)} device events "
             f"joined")
    pcap, pv = caps["kmeans"], caps["vgg"]
    _say(f"[obs] host time of a capture: the child's first (the step, "
         f"the profiler's start-up in the process included) "
         f"{pcap['capture_s'] * 1e3:.1f} ms, its second (the VGG forward) "
         f"{pv['capture_s'] * 1e3:.1f} ms; a replay of the step "
         f"{rep_s * 1e3:.1f} ms, against {walk_ms:.4f} ms for one step "
         f"evaluated")
    _hold_capture(pcap, "kmeans_step")
    for p, label in ((pcap, "capture"), (prep, "replay")):
        _show_profile(p, f"kmeans_step ({label})")
        # the wrapper's two launches, which [kmeans]'s CUDA events
        # time together
        got = _kernel_ms(p, "KMeansStepExpr",
                         ("assign_accumulate", "reduce_partials"))
        if len(got) != 1:
            _fail(f"[obs] the {label} tier did not attribute the "
                  f"k-means node: {p['nodes']}")
        _within(f"kmeans node ({label} tier)", got[0], kmr["ms"], 0.25)
    _hold_capture(pv, "VGG-16 block 1 forward")
    _show_profile(pv, "VGG-16 block 1 forward", top=6)
    convs = _kernel_ms(pv, "StencilExpr", ("conv_kernel",
                                           "conv_mma_kernel"))
    if len(convs) != 2:
        _fail(f"[obs] the VGG profile holds {len(convs)} conv nodes")
    for got, want, name in zip(convs, vggr["conv_ms"],
                               ("conv1_1", "conv1_2")):
        _within(f"{name} conv_block in its StencilExpr node", got,
                want, 0.25)
    other = pv["wall_s"] * 1e3 - sum(convs)
    _say(f"[obs] VGG forward outside the two conv kernels: "
         f"{other:.4f} ms of its {pv['wall_s'] * 1e3:.4f} ms device wall")

    with st.use_mesh(st.build_mesh(RES_MESH)):
        # -- audit: clean points, then one NaN in a copy of them
        ms_plain = _wall_ms(lambda: km.kmeans_step(points, c0,
                                                   KM_K).evaluate())
        arep = st.audit(km.kmeans_step(points, c0, KM_K))
        ms_audit = _wall_ms(lambda: st.audit(km.kmeans_step(points, c0,
                                                            KM_K)))
        _say(f"[obs] audit of the clean step: {len(arep.records)} health "
             f"words, ok={arep.ok}; audited step {ms_audit:.4f} ms against "
             f"{ms_plain:.4f} ms plain")
        if not arep.ok or not arep.records:
            _fail("[obs] the clean k-means step audits unhealthy")
        from spartan_tpu_torch.array.distarray import from_tensor

        bad_t = points.value.tensor.clone()
        bad_t[KM_N // 8 + 1, 17] = float("nan")
        bad = st.as_expr(from_tensor(bad_t))
        brep = st.audit(km.kmeans_step(bad, c0, KM_K))
        fb = brep.first_bad
        want = f"ValExpr#{bad._id}"
        _say(f"[obs] audit with one NaN planted: first_bad "
             f"{fb and fb['node']} (want {want}), nan_count "
             f"{fb and fb['nan_count']}")
        if fb is None or fb["node"] != want or fb["nan_count"] != 1:
            _fail("[obs] the planted NaN was not named at its leaf")
        del bad_t, bad

        # -- the loop's health series over 20 k-means iterations
        def km_loop(n, **kw):
            return st.loop(n, lambda c: km.kmeans_step(points, c, KM_K),
                           c0, **kw)

        _reset_counts(kk)
        hl = km_loop(KM_ITERS, health=True)
        hc = hl.glom()
        launches = kk.LAUNCHES
        series = num.loop_health(hl.loop.label)
        plain = km_loop(KM_ITERS).glom()
        _say(f"[obs] st.loop(health=True) over {KM_ITERS} iterations: "
             f"{launches} launches (want {KM_ITERS}), series of "
             f"{len(series)}, carries bit-equal to health=False: "
             f"{np.array_equal(_bits(hc), _bits(plain))}; update norms "
             f"{[round(r['update_norm'], 6) for r in series]}")
        if launches != KM_ITERS or len(series) != KM_ITERS or \
                not np.array_equal(_bits(hc), _bits(plain)):
            _fail("[obs] the health loop is not the plain loop")
        un = [r["update_norm"] for r in series]
        stop = next((j for j in range(1, len(un))
                     if un[j] * 2.0 <= min(un[:j])), None)
        if stop is None:
            _fail(f"[obs] no well-separated update norm in {un}")
        tol = (min(un[:stop]) + un[stop]) / 2.0
        _reset_counts(kk)
        el = km_loop(KM_ITERS, early_exit=True, stall_tol=tol)
        ec = el.glom()
        e_launch = kk.LAUNCHES
        e_series = num.loop_health(el.loop.label)
        ref = km_loop(stop + 1).glom()
        _say(f"[obs] early_exit with stall_tol {tol:.6g} (midpoint of "
             f"{min(un[:stop]):.6g} and {un[stop]:.6g}): stopped after "
             f"{len(e_series)} iterations (want {stop + 1}) with "
             f"{e_launch} launches, carries bit-equal to a "
             f"{stop + 1}-iteration loop: "
             f"{np.array_equal(_bits(ec), _bits(ref))}")
        if len(e_series) != stop + 1 or e_launch != stop + 1 or \
                not np.array_equal(_bits(ec), _bits(ref)):
            _fail("[obs] early_exit did not stop where its series says")

        # -- what the instrumentation costs (config-3 iterations/s)
        knobs = ("trace", "metrics", "cost_ledger")
        prev = {k: getattr(flags, k) for k in knobs}
        prev["profile_sample_every"] = flags.profile_sample_every

        def setting(on: bool, ledger_only: bool = False, sample: int = 0):
            for k in knobs:
                setattr(flags, k, on if not ledger_only
                        else k == "cost_ledger")
            flags.profile_sample_every = sample

        ips = {"off": 0.0, "ledger": 0.0, "all": 0.0}
        for _ in range(3):  # alternate, best of 3
            for name in ("off", "ledger", "all"):
                setting(name != "off", ledger_only=name == "ledger")
                ips[name] = max(ips[name], _loop_ips(st, km, points, c0,
                                                     reps=1))
        setting(True, sample=10)
        # 11 evaluations: the 10th is sampled
        t0 = time.perf_counter()
        for _ in range(11):
            st.loop(KM_ITERS, lambda c: km.kmeans_step(points, c, KM_K),
                    c0).evaluate()
        torch.cuda.synchronize()
        sampled = (time.perf_counter() - t0) / 11
        for k, v in prev.items():
            setattr(flags, k, v)
        cost = 1.0 - ips["all"] / ips["off"]
        _say(f"[obs] config-3 iterations/s: all off {ips['off']:.2f}, "
             f"ledger only {ips['ledger']:.2f}, trace+metrics+ledger+"
             f"profile_sample_every=0 {ips['all']:.2f}: cost "
             f"{100.0 * cost:.2f}% (limit 5%); profile_sample_every=10 "
             f"{KM_ITERS / sampled:.2f} iters/s on average over 11 "
             f"evaluations, {100.0 * (1.0 - KM_ITERS / sampled / ips['all']):.1f}"
             f"% below all on, on {card}")
        if cost > 0.05:
            _fail("[obs] trace + metrics + ledger cost more than 5% of "
                  "config-3 iterations/s")

        # -- calibration from the ledger
        fit = led.fit_profile()
        if fit is None:
            _fail("[obs] fit_profile found nothing in the ledger")
        base = km_loop(KM_ITERS).glom()
        led.set_profile(fit)
        flags.cost_calibration = True
        try:
            prof.reset_counters()
            cal = km_loop(KM_ITERS).glom()
            misses = prof.plan_cache_stats()["plan_misses"]
            crep = st.explain(km.kmeans_step(points, c0, KM_K), cost=False)
        finally:
            flags.cost_calibration = False
            led.set_profile(None)
        _say(f"[obs] calibration {fit} (source {fit.meta['source']}, "
             f"{fit.meta['fitted_from_plans']} rows): {misses} plan miss "
             f"(want 1), committed tilings "
             f"{[(t['node'], t['tiling']) for t in crep.tilings]}, carries "
             f"bit-equal: {np.array_equal(_bits(cal), _bits(base))}")
        if misses != 1 or not np.array_equal(_bits(cal), _bits(base)):
            _fail("[obs] calibration did not re-key the plan or changed "
                  "a value")
        oprof.reset()
    _say(f"[obs] phase {time.perf_counter() - t_phase:.1f} s on {card}")


# -- [guards]: the plan audit, the memory governor, the warm-start store
# -- and the integrity sentinel ---------------------------------------------

_KIND_OF = {"all_reduce": "all-reduce", "all_gather": "all-gather",
            "all_to_all": "all-to-all", "ring_permute": "collective-permute",
            "reduce_scatter": "reduce-scatter"}


def _counted(metrics_mod, fn):
    """``fn()`` and what it added to ``collective_calls``/``_bytes`` (by
    the audit's kind names) and ``group_materialize_calls`` (by site)."""
    before = dict(metrics_mod.REGISTRY.counter_values())
    out = fn()
    torch.cuda.synchronize()
    got = {"calls": {}, "bytes": {}, "sites": {}}
    names = {"collective_calls": "calls", "collective_bytes": "bytes",
             "group_materialize_calls": "sites"}
    for key, v in metrics_mod.REGISTRY.counter_values().items():
        d = v - before.get(key, 0)
        base, labels = metrics_mod.parse_labels(key)
        if d and base in names:
            lab = labels.get("op", labels.get("site", ""))
            got[names[base]][_KIND_OF.get(lab, lab)] = d
    return out, got


def _audit_record(audit) -> dict:
    gathers = {}
    for f in audit.findings:
        if f.kind == "full_gather":
            site = f.message.split(" for ")[1].split(",")[0]
            gathers[site] = gathers.get(site, 0) + 1
    return {"multiset": audit.multiset, "operand_bytes": audit.operand_bytes(),
            "comm_bytes": audit.comm_bytes, "gathers": gathers,
            "findings": [str(f) for f in audit.findings]}


def _plan_of(st, expr):
    """The plan ``expr`` evaluates with, built (not run) on a miss."""
    from spartan_tpu_torch.expr import base

    mesh = st.get_mesh()
    key, rctx = base.plan_signature(expr, mesh)
    plan = base.lookup_plan(key)
    if plan is None:
        plan, _, _ = base._build_plan(expr, mesh, rctx, key)
    return plan


def guards_child(workdir: str, rank: int) -> None:
    """One rank of [guards]'s two-process gloo group on the one card:
    the plan audit of config 2's 8192^2 ``st.dot``, ``st.sort`` of 2^26
    keys and a config-3 k-means step against the collectives and whole
    gathers their walks count; the dot's predicted card peak against
    its measured walk; the governor picking a rung under a budget set
    between the dot's and the rung's predicted peaks; results to
    ``workdir``."""
    import importlib

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spartan_tpu_torch as st
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.expr import base
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.resilience import degrade, memory

    metrics_mod = importlib.import_module("spartan_tpu_torch.obs.metrics")
    dev = _child_device()
    st.set_default_device(dev)
    if not mesh_mod.initialize_distributed(
            "file://" + os.path.join(workdir, "store"),
            num_processes=GROUP_RANKS, process_id=rank, backend="gloo",
            device=dev, timeout_s=GROUP_TIMEOUT_S):
        _fail("[guards] child: no process group")
    res = {"rank": rank, "audit": {}}
    a_np = np.load(os.path.join(workdir, "dot_a.npy"), mmap_mode="r")
    b_np = np.load(os.path.join(workdir, "dot_b.npy"), mmap_mode="r")
    ea, eb = st.from_numpy(a_np), st.from_numpy(b_np)
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    keys = st.as_expr(from_tensor(torch.rand(SORT_N, generator=gen,
                                             device=dev)))
    pts = st.from_numpy(np.load(os.path.join(workdir, "km_points.npy"),
                                mmap_mode="r"))
    c0 = st.from_numpy(np.load(os.path.join(workdir, "km_c0.npy")))
    cases = {"dot": lambda: st.dot(ea, eb), "sort": lambda: st.sort(keys),
             "kmeans": lambda: km.kmeans_step(pts, c0, KM_K)}
    for name, build in cases.items():
        audit = st.audit_plan(build())
        _, got = _counted(metrics_mod, lambda: build().evaluate())
        res["audit"][name] = dict(_audit_record(audit), counted=got)
    del keys, pts, c0

    # the dot's card peak, predicted and measured on this rank
    plan = _plan_of(st, st.dot(ea, eb))
    val = memory.validate_plan(plan)
    res["dot_mem"] = dict(val or {}, peak_bytes_per_chip=plan.report[
        "memory"]["peak_bytes_per_chip"])
    # the governor: a budget below the dot's predicted peak and above
    # the finer_tiling rung's
    normal = plan.report["memory"]["peak_bytes_card"]
    finer = memory._rung_estimate(st.dot(ea, eb), "finer_tiling",
                                  st.get_mesh())[1]
    budget = (normal + finer) // 2
    base.clear_plan_cache()  # the governor judges a plan on its miss
    oom0 = _counter(st, "resilience_oom_events")
    st.FLAGS.hbm_budget_bytes = budget
    try:
        e = st.dot(ea, eb)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = e.evaluate()
        torch.cuda.synchronize()
        rec = getattr(e, "_resilience", None) or {}
        # the rung's walk over what was resident, plus the operands
        gov_peak = (torch.cuda.max_memory_allocated(dev) - resident
                    + plan.report["memory"]["card_args_bytes"])
        got = out.glom()
    finally:
        st.FLAGS.hbm_budget_bytes = 0
    with degrade._RungCtx("finer_tiling"):
        forced = base.evaluate(degrade.clone_for_replan(
            st.dot(ea, eb))).glom()
    res["governor"] = {
        "normal": normal, "finer": finer, "budget": budget,
        "rung": rec.get("rung"), "origin": rec.get("origin"),
        "rung_predicted": rec.get("rung_predicted_bytes"),
        "oom": _counter(st, "resilience_oom_events") - oom0,
        "bit_equal": bool(np.array_equal(got, forced)),
        "measured_peak": int(gov_peak)}
    with open(os.path.join(workdir, f"guards{rank}.json"), "w") as f:
        json.dump(res, f)
    mesh_mod.shutdown()


def _guards_group(st, card: str, workdir: str) -> None:
    """[audit] and the group half of [memory]: two gloo processes."""
    pts_np, c0_np, _ = _data(LOCAL_KM_N, KM_D, KM_K, "clustered", 0)
    np.save(os.path.join(workdir, "km_points.npy"), pts_np)
    np.save(os.path.join(workdir, "km_c0.npy"), c0_np)
    del pts_np
    rng = np.random.RandomState(2)
    for name in ("dot_a", "dot_b"):
        np.save(os.path.join(workdir, f"{name}.npy"),
                rng.rand(LOCAL_DOT_N, LOCAL_DOT_N).astype(np.float32))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--guards-child", workdir, str(r)])
             for r in range(GROUP_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=GROUP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _fail(f"[guards] a group child did not finish in "
              f"{GROUP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        _fail(f"[guards] group children exited "
              f"{[p.returncode for p in procs]}")
    res = []
    for r in range(GROUP_RANKS):
        with open(os.path.join(workdir, f"guards{r}.json")) as f:
            res.append(json.load(f))
    for rr in res:
        r = rr["rank"]
        for name, a in rr["audit"].items():
            c = a["counted"]
            if a["multiset"] != c["calls"] or \
                    a["operand_bytes"] != c["bytes"]:
                _fail(f"[audit] rank {r} {name}: audit {a['multiset']} "
                      f"{a['operand_bytes']} against counted {c['calls']} "
                      f"{c['bytes']}")
            if a["gathers"] != c["sites"]:
                _fail(f"[audit] rank {r} {name}: full_gather findings "
                      f"{a['gathers']} against group_materialize_calls "
                      f"{c['sites']}")
            _say(f"[audit] rank {r} {name}: {a['multiset']} with operand "
                 f"bytes {a['operand_bytes']}, equal to the walk's "
                 f"collective_calls/collective_bytes (limit: equal); "
                 f"full_gather {a['gathers']} = group_materialize_calls "
                 f"{c['sites']}; comm_bytes {a['comm_bytes']:.0f} modeled "
                 f"per rank")
        if rr["audit"]["kmeans"]["gathers"]:
            _fail(f"[audit] rank {r}: config-3 k-means gathers whole "
                  f"arrays: {rr['audit']['kmeans']['findings']}")
        if rr["audit"]["dot"]["multiset"].get("all-reduce", 0) < 1 or \
                rr["audit"]["sort"]["multiset"].get("all-to-all", 0) < 2:
            _fail(f"[audit] rank {r}: want the dot's k-split all-reduce "
                  f"and the sort's exchanges, got {rr['audit']}")
        m = rr["dot_mem"]
        if not m.get("measured_peak_bytes"):
            _fail(f"[memory] rank {r}: the dot's walk was not measured")
        ratio = m["predicted_bytes"] / m["measured_peak_bytes"]
        _say(f"[memory] {LOCAL_DOT_N}^2 st.dot, gloo rank {r} of "
             f"{GROUP_RANKS}: predicted peak_bytes_card "
             f"{m['predicted_bytes']}, measured {m['measured_peak_bytes']}"
             f" (ratio {ratio:.4f}, limit 1 +- {GUARD_MEM_TOL}); the JAX "
             f"model's peak_bytes_per_chip {m['peak_bytes_per_chip']}")
        if abs(ratio - 1.0) > GUARD_MEM_TOL:
            _fail(f"[memory] rank {r}: predicted/measured {ratio:.4f}")
        g = rr["governor"]
        if (g["rung"] != "finer_tiling" or g["origin"] != "predictive"
                or g["oom"] != 0 or not g["bit_equal"]):
            _fail(f"[memory] rank {r}: governor {g}")
        _say(f"[memory] rank {r}: budget {g['budget']} between the dot's "
             f"predicted {g['normal']} and finer_tiling's {g['finer']}: "
             f"the governor took {g['rung']} before the walk, 0 OOM "
             f"raised (limit 0), result bit-equal to the rung forced; the "
             f"rung's walk measured {g['measured_peak']}")
    _say(f"[guards] group children {time.perf_counter() - t0:.1f} s on "
         f"{card}")


def _walk_peak(st, memory, plan, free: bool):
    from spartan_tpu_torch.expr import base

    prev = base.FREE_AT_LAST_USE
    base.FREE_AT_LAST_USE = free
    try:
        val = memory.validate_plan(plan)
    finally:
        base.FREE_AT_LAST_USE = prev
    if val is None:
        _fail("[memory] the walk was not measured on the card")
    return val


def _guards_memory(st, km, card: str) -> None:
    """[memory] in this process: four plans' predicted card peaks
    against their measured walks, the walk keeping every value and
    freeing each at its last consumer."""
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.resilience import memory

    dev = torch.device("cuda")
    pts_np, c0_np, _ = _data(KM_N, KM_D, KM_K, "clustered", 0)
    rng = np.random.RandomState(0)
    cases = []
    with st.use_mesh(st.build_mesh(RES_MESH)) as mesh:
        points = st.from_numpy(pts_np)
        cases.append((f"config-3 kmeans_step {RES_MESH}",
                      _plan_of(st, km.kmeans_step(
                          points, st.from_numpy(c0_np), KM_K)), mesh))
    del pts_np
    ea = st.from_numpy(rng.rand(DOT_N, DOT_N).astype(np.float32))
    eb = st.from_numpy(rng.rand(DOT_N, DOT_N).astype(np.float32))
    cases.append((f"{DOT_N}^2 chain (K={DOT_K}) first plan",
                   _plan_of(st, _build_chain(st, ea, eb, DOT_K)),
                   st.get_mesh()))
    with st.use_mesh(st.build_mesh(RES_MESH)) as mesh:
        a = st.from_numpy(np.random.RandomState(2).rand(
            LOCAL_DOT_N, LOCAL_DOT_N).astype(np.float32))
        cases.append((f"{LOCAL_DOT_N}^2 st.dot {RES_MESH}",
                      _plan_of(st, st.dot(a, a)), mesh))
    x, params = _vgg_params(dev)
    with st.use_mesh(st.build_mesh(VGG_MESH)) as mesh:
        X = from_tensor(x, tiling=st.Tiling((None, "x", None, None)))
        P = [(from_tensor(w), from_tensor(b)) for w, b in params]
        cases.append(("VGG-16 block-1 forward", _plan_of(
            st, vgg_block1(st, X, P)), mesh))
    for label, plan, mesh in cases:
        with st.use_mesh(mesh):
            keep = _walk_peak(st, memory, plan, False)
            free = _walk_peak(st, memory, plan, True)
        pred = free["predicted_bytes"]
        ratio = pred / free["measured_peak_bytes"]
        _say(f"[memory] {label}: predicted peak_bytes_card {pred}, "
             f"measured {free['measured_peak_bytes']} freeing at the last "
             f"consumer (ratio {ratio:.4f}, limit 1 +- {GUARD_MEM_TOL}), "
             f"{keep['measured_peak_bytes']} keeping every value; the JAX "
             f"model's peak_bytes_per_chip "
             f"{plan.report['memory']['peak_bytes_per_chip']} on {card}")
        if abs(ratio - 1.0) > GUARD_MEM_TOL:
            _fail(f"[memory] {label}: predicted/measured {ratio:.4f}")
    del cases, points, ea, eb, a, X, P, x, params
    torch.cuda.empty_cache()


def persist_child(workdir: str, idx: int) -> None:
    """One fresh process on [guards]'s store: the 4096^2 chain and
    config-3 ``kmeans()`` on (4, 2) and (8, 1); results, DP runs,
    planning ms and the store's counters to ``workdir``."""
    import hashlib
    import importlib

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spartan_tpu_torch as st
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.utils import profiling as prof

    metrics_mod = importlib.import_module("spartan_tpu_torch.obs.metrics")
    dev = torch.device("cuda")
    st.set_default_device(dev)
    st.FLAGS.persist_cache_dir = os.path.join(workdir, "plans")
    rng = np.random.RandomState(0)
    a_np = rng.rand(DOT_N, DOT_N).astype(np.float32)
    b_np = rng.rand(DOT_N, DOT_N).astype(np.float32)
    pts_np, c0_np, _ = _data(KM_N, KM_D, KM_K, "clustered", 0)
    res = {"bits": {}, "plan_ms": {}}

    def planning(fn):
        """``fn()`` and the planning ms of its misses."""
        before = _plan_ms(prof)
        out = fn()
        after = _plan_ms(prof)
        return out, [a - b for a, b in zip(after, before)]

    for shape in PLAN_MESHES:
        with st.use_mesh(st.build_mesh(shape)):
            ea, eb = st.from_numpy(a_np), st.from_numpy(b_np)
            val, res["plan_ms"][f"chain{shape}"] = planning(
                lambda: _build_chain(st, ea, eb, DOT_K).glom())
            res["bits"][f"chain{shape}"] = _bits(val).tolist()
            points = st.from_numpy(pts_np)
            (centers, assign), res["plan_ms"][f"kmeans{shape}"] = planning(
                lambda: km.kmeans(points, KM_K, num_iter=KM_ITERS,
                                  centers=c0_np))
            res["bits"][f"kmeans{shape}"] = hashlib.sha256(
                _bits(centers).tobytes() + assign.tobytes()).hexdigest()
            del points
    res["dp_runs"] = metrics_mod.REGISTRY.counter_values().get(
        "tiling_dp_runs", 0)
    res["persist"] = {k: v for k, v in
                      metrics_mod.REGISTRY.counter_values().items()
                      if k.startswith("persist")}
    with open(os.path.join(workdir, f"persist{idx}.json"), "w") as f:
        json.dump(res, f)


def _persist_run(workdir: str, idx: int) -> dict:
    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--persist-child", workdir, str(idx)],
                       timeout=GROUP_TIMEOUT_S)
    if p.returncode != 0:
        _fail(f"[persist] child {idx} exited {p.returncode}")
    with open(os.path.join(workdir, f"persist{idx}.json")) as f:
        return json.load(f)


def _guards_persist(card: str, workdir: str) -> None:
    """[persist]: a cold child builds and stores, a warm one reads every
    plan back with no DP run, and after one stored file is corrupted a
    third rejects that entry and plans it again, all bit-equal."""
    import zlib

    t0 = time.perf_counter()
    cold = _persist_run(workdir, 0)
    warm = _persist_run(workdir, 1)
    if warm["bits"] != cold["bits"]:
        _fail("[persist] the warm child's results differ from the cold's")
    hits = warm["persist"].get("persist_hits", 0)
    errors = {k: v for k, v in warm["persist"].items() if "errors" in k}
    stores = cold["persist"].get("persist_stores", 0)
    if (warm["dp_runs"] != 0 or cold["dp_runs"] != stores or hits != stores
            or errors):
        _fail(f"[persist] DP runs cold {cold['dp_runs']} warm "
              f"{warm['dp_runs']}, warm counters {warm['persist']}")
    for key in cold["plan_ms"]:
        c, w = cold["plan_ms"][key], warm["plan_ms"][key]
        _say(f"[persist] {key}: pass:auto_tiling {c[0]:.3f} ms cold, "
             f"{w[0]:.3f} ms warm; tiling {c[1]:.3f} ms cold, {w[1]:.3f} "
             f"ms warm (the planning of its misses) on {card}")
    store = os.path.join(workdir, "plans")
    entries = sorted(e for e in os.listdir(store) if e.startswith("entry_")
                     and "." not in e)
    _say(f"[persist] warm child: {hits} disk hits, {warm['dp_runs']} DP "
         f"runs (limit 0; the cold child ran {cold['dp_runs']}), results "
         f"bit-equal; {len(entries)} entries stored")
    # corrupt one CRC'd file: a byte of the first entry's plan
    path = os.path.join(store, entries[0], "plan.json")
    with open(path, "r+b") as f:
        head = f.read(1)
        f.seek(0)
        f.write(bytes([head[0] ^ 0x20]))
    with open(path, "rb") as f:
        if zlib.crc32(f.read()) == json.load(open(os.path.join(
                store, entries[0], "manifest.json")))["files"][
                    "plan.json"]["crc32"]:
            _fail("[persist] the corrupted file still passes its CRC")
    third = _persist_run(workdir, 2)
    crc = {k: v for k, v in third["persist"].items() if "errors" in k}
    if third["bits"] != cold["bits"] or list(crc.values()) != [1] or \
            "crc" not in next(iter(crc)) or third["dp_runs"] != 1:
        _fail(f"[persist] after the corruption: {third['persist']}, DP "
              f"runs {third['dp_runs']}, bit-equal "
              f"{third['bits'] == cold['bits']}")
    _say(f"[persist] one corrupted plan.json: rejected ({crc}), planned "
         f"again (1 DP run), results bit-equal; the three children "
         f"{time.perf_counter() - t0:.1f} s on {card}")


def _km_steps(st, km, pe, c, first: int, last: int):
    """Iterations ``first``..``last - 1`` of k-means, one evaluate each."""
    for _ in range(first, last):
        c = km.kmeans_step(pe, c, KM_K).evaluate()
    return c


def _guards_integrity(st, kk, km, card: str) -> int:
    """[integrity]: config-3 k-means on (4, 2) under the sentinel with
    position GUARD_VICTIM corrupting sampled walks: caught every time,
    quarantined at the strike count, the caller rehomes its arrays and
    finishes bit-equal to a clean run through the same quarantine.
    Returns the k-means launches of the checked run."""
    import importlib

    from spartan_tpu_torch.expr import base
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.resilience import elastic, integrity

    profile_mod = importlib.import_module("spartan_tpu_torch.obs.profile")
    pts_np, c0_np, _ = _data(LOCAL_KM_N, KM_D, KM_K, "clustered", 0)
    names = ("integrity_check", "profile_sample_every",
             "sdc_quarantine_strikes", "retry_backoff_s")
    saved = {n: getattr(st.FLAGS, n) for n in names}

    def run(chaos: bool):
        mesh_mod.reset_epoch_for_tests()
        base.clear_plan_cache()
        integrity.reset()
        with st.use_mesh(st.build_mesh(RES_MESH)):
            pe = st.from_numpy(pts_np).evaluate()
            # the centers in the step's output tiling: every step walks
            # one plan, whose runs the cadence counts
            c = st.from_numpy(c0_np, tiling=st.Tiling(("x", "y"))).evaluate()
            if not chaos:
                c = _km_steps(st, km, pe, c, 0, 12)
                elastic.quarantine_device(GUARD_VICTIM, reason="sdc")
                elastic.rehome([pe, c])
                return _km_steps(st, km, pe, c, 12, KM_ITERS).glom(), None
            with st.chaos(GUARD_SDC, seed=3) as plan:
                c = _km_steps(st, km, pe, c, 0, 12)
                try:
                    _km_steps(st, km, pe, c, 12, 13)
                    _fail("[integrity] no quarantine at the third strike")
                except mesh_mod.StaleMeshError:
                    pass
                elastic.rehome([pe, c])
                out = _km_steps(st, km, pe, c, 12, KM_ITERS).glom()
            return out, plan

    try:
        st.FLAGS.retry_backoff_s = 0.0
        st.FLAGS.integrity_check = False
        clean, _ = run(False)
        st.FLAGS.integrity_check = True
        st.FLAGS.profile_sample_every = GUARD_SAMPLE
        st.FLAGS.sdc_quarantine_strikes = GUARD_STRIKES
        v0 = _counter(st, "integrity_violations")
        # the cadence also samples the profiler (every 5th successful
        # warm walk of a plan): its walks' launches are counted apart
        sampled = [0, 0]
        impl = profile_mod._profile_impl

        def counted_impl(*a, **kw):
            before = kk.LAUNCHES
            try:
                return impl(*a, **kw)
            finally:
                sampled[0] += 1
                sampled[1] += kk.LAUNCHES - before

        profile_mod._profile_impl = counted_impl
        _reset_counts(kk)
        try:
            got, plan = run(True)
        finally:
            profile_mod._profile_impl = impl
        launches = kk.LAUNCHES
        status = integrity.status()
        hist = integrity.quarantine_history()
        walks = plan.counts()["dispatch"]
        # the step plan runs 12 iterations plus one retry per clean
        # violation and the quarantined run; the rebuilt mesh's plan
        # runs the last KM_ITERS - 12; each plan re-walks every
        # GUARD_SAMPLE-th of its runs
        old, new = 12 + GUARD_STRIKES, KM_ITERS - 12
        want_walks = old + new
        want_checks = old // GUARD_SAMPLE + new // GUARD_SAMPLE
        # the profiler samples successful walks after each plan's first
        want_samples = ((old - 1 - GUARD_STRIKES) // GUARD_SAMPLE
                        + (new - 1) // GUARD_SAMPLE)
        if (walks != want_walks or status["checks"] != want_checks
                or sampled[0] != want_samples
                or launches != walks + status["checks"] + sampled[1]):
            _fail(f"[integrity] {walks} walks (want {want_walks}), "
                  f"{status['checks']} checks (want {want_checks}), "
                  f"{sampled[0]} profiler samples (want {want_samples}), "
                  f"{launches} k-means launches (want walks + checks + "
                  f"the samples' {sampled[1]})")
        if (_counter(st, "integrity_violations") - v0 != GUARD_STRIKES
                or [h["device"] for h in hist] != [GUARD_VICTIM]
                or [f["kind"] for f in plan.fired] != ["sdc"] * 3):
            _fail(f"[integrity] violations/quarantine: {status}, {hist}, "
                  f"fired {plan.fired}")
        if not np.array_equal(_bits(got), _bits(clean)):
            _fail("[integrity] the centers differ from the clean run's")
        _say(f"[integrity] config-3 k-means {LOCAL_KM_N}x{KM_D} on "
             f"{RES_MESH} with {GUARD_SDC}: {GUARD_STRIKES} violations "
             f"caught at sampled walks (every {GUARD_SAMPLE}th), no "
             f"corrupt result returned, position {GUARD_VICTIM} "
             f"quarantined at {hist[0]['strikes']} strikes (limit "
             f"{GUARD_STRIKES}), mesh epoch {hist[0]['epoch_from']} -> "
             f"{hist[0]['epoch_to']}; final centers bit-equal to a clean "
             f"run through the same quarantine; {launches} k-means "
             f"launches = {walks} walks + {status['checks']} re-walks + "
             f"{sampled[1]} in the profiler's {sampled[0]} samples at the "
             f"same cadence (limit: equal)")

        # the check on and off, alternated over one plan (the flag is
        # not in the plan key), with the profiler sampling alike in both
        mesh_mod.reset_epoch_for_tests()
        base.clear_plan_cache()
        integrity.reset()
        ips = {False: [], True: []}
        with st.use_mesh(st.build_mesh(RES_MESH)):
            pe = st.from_numpy(pts_np).evaluate()
            c0 = st.from_numpy(c0_np,
                               tiling=st.Tiling(("x", "y"))).evaluate()
            _km_steps(st, km, pe, c0, 0, 2)
            for _ in range(GUARD_IPS_PAIRS):
                for check in (False, True):
                    st.FLAGS.integrity_check = check
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    _km_steps(st, km, pe, c0, 0, KM_ITERS)
                    torch.cuda.synchronize()
                    ips[check].append(KM_ITERS / (time.perf_counter() - t1))
        off, on = (float(np.median(ips[k])) for k in (False, True))
        _say(f"[integrity] k-means iters/s (one evaluate an iteration, "
             f"{GUARD_IPS_PAIRS} alternated pairs, medians): check off "
             f"{off:.2f}, on with no chaos {on:.2f} "
             f"({(1 - on / off) * 100:.1f}% lower; every "
             f"{GUARD_SAMPLE}th walk re-walked, the profiler sampling "
             f"alike in both); off {[round(v, 2) for v in ips[False]]}, "
             f"on {[round(v, 2) for v in ips[True]]} on {card}")
    finally:
        for n, v in saved.items():
            setattr(st.FLAGS, n, v)
        mesh_mod.reset_epoch_for_tests()
        base.clear_plan_cache()
        integrity.reset()
    return launches


def phase_guards(st, kk, km, card: str, workdir: str) -> dict:
    """[guards]: the plan guards on the card — [audit], [memory],
    [persist] and [integrity] (module docstring)."""
    t0 = time.perf_counter()
    _guards_group(st, card, workdir)
    _guards_memory(st, km, card)
    _guards_persist(card, workdir)
    launches = _guards_integrity(st, kk, km, card)
    _say(f"[guards] {time.perf_counter() - t0:.1f} s")
    return {"integrity_launches": launches}


# -- [serve] -------------------------------------------------------------


def _serve_parked(st, **kw):
    """A ``ServeEngine`` whose workers are held off: ``submit`` starts
    workers unless the engine looks running, so it is given one finished
    thread; submissions stay queued until ``_serve_unpark``."""
    import threading

    eng = st.ServeEngine(**kw)
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    eng._threads.append(t)
    return eng


def _serve_unpark(eng) -> None:
    eng._threads.clear()
    eng.start()


def _serve_clients(st, eng, builds, label: str) -> list:
    """``SERVE_CLIENTS`` threads, client ``c`` submitting ``builds[c]``
    (a list of zero-argument expression builders) back to back, then
    fetching each; returns the fetched values in the same nesting."""
    import threading

    out = [[None] * len(b) for b in builds]
    futs = [[None] * len(b) for b in builds]
    errors = []
    barrier = threading.Barrier(len(builds))

    def client(c):
        try:
            barrier.wait()
            fs = [eng.submit(build()) for build in builds[c]]
            for i, f in enumerate(fs):
                futs[c][i] = f
                out[c][i] = f.glom(timeout=SERVE_WAIT_S)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(builds))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * SERVE_WAIT_S)
    if errors or any(t.is_alive() for t in threads):
        _fail(f"[serve] {label}: client errors {errors[:3]}, "
              f"{sum(t.is_alive() for t in threads)} client(s) stuck")
    return out, futs


def _serve_kmeans(st, kk, km, card: str, dev, kmr: dict) -> dict:
    """16 clients x 4 config-3 k-means steps through one engine."""
    from spartan_tpu_torch.expr import base
    from spartan_tpu_torch.obs import flight
    from spartan_tpu_torch.serve import coalesce

    points = kmr["points"]
    c0 = torch.from_numpy(kmr["c0"]).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    centers = [[st.as_expr(c0 + 0.05 * torch.randn(
        c0.shape, generator=gen, device=dev))
        for _ in range(SERVE_PER_CLIENT)] for _ in range(SERVE_CLIENTS)]
    probe = km.kmeans_step(points, centers[0][0], KM_K)
    if type(probe).__name__ != "KMeansStepExpr":
        _fail(f"[serve] kmeans_step is {type(probe).__name__}, not the "
              "fused node")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = [[km.kmeans_step(points, c, KM_K).evaluate().glom()
               for c in row] for row in centers]
    serial_s = time.perf_counter() - t0
    n = SERVE_CLIENTS * SERVE_PER_CLIENT
    dem0 = _counter(st, "serve_mode_demotions")
    fb0 = _counter(st, "serve_solo_fallbacks")
    flight.clear()
    builds = [[(lambda c=c: km.kmeans_step(points, c, KM_K)) for c in row]
              for row in centers]
    with st.ServeEngine() as eng:
        _reset_counts(kk)
        t0 = time.perf_counter()
        got, futs = _serve_clients(st, eng, builds, "k-means")
        served_s = time.perf_counter() - t0
        launches = kk.LAUNCHES
    plan = base.lookup_plan(base.plan_signature(probe)[0])
    mode = coalesce.mode_for(plan)
    sv = plan.report.get("serve") or {}
    equal = sum(np.array_equal(a, b) for ra, rb in zip(serial, got)
                for a, b in zip(ra, rb))
    batches = _serve_flight(st, futs, "k-means", card)
    sizes = sorted({b for b in batches})
    _say(f"[serve] k-means {KM_N}x{KM_D} k={KM_K}: {n} requests from "
         f"{SERVE_CLIENTS} clients: {equal}/{n} bit-equal to serial "
         f"evaluate() (limit: all); mode {mode} (report {sv.get('mode')}, "
         f"{sv.get('batches')} batch(es)); batch sizes {sizes} (limit: "
         f"powers of two); {launches} kernel launches in the served "
         f"window (limit: {n}); demotions "
         f"{_counter(st, 'serve_mode_demotions') - dem0}, solo fallbacks "
         f"{_counter(st, 'serve_solo_fallbacks') - fb0} (limit 0)")
    _say(f"[serve] k-means served {n / served_s:.1f} requests/s, serial "
         f"evaluate() {n / serial_s:.1f} requests/s (host clock, fetch "
         f"included) on {card}")
    if equal != n:
        _fail("[serve] served k-means steps differ from the serial ones")
    if mode != "vmap" or sv.get("mode") != "vmap":
        _fail(f"[serve] the k-means plan left vmap mode: {mode}, {sv}")
    if any(b & (b - 1) for b in batches):
        _fail(f"[serve] a batch is not a power of two: {sizes}")
    if launches != n:
        _fail(f"[serve] {launches} k-means launches for {n} served "
              "requests")
    if _counter(st, "serve_mode_demotions") != dem0 or \
            _counter(st, "serve_solo_fallbacks") != fb0:
        _fail("[serve] a k-means batch fell back or demoted")
    if not any(b > 1 for b in batches):
        _fail("[serve] no k-means request was coalesced")
    _serve_batch_alone(st, [b for row in builds for b in row][:32],
                       "k-means", card)
    return {"launches": launches}


def _serve_batch_alone(st, builds, label: str, card: str) -> None:
    """One coalesced batch of ``builds`` through ``dispatch_batch`` on
    this thread, with no client thread running: the walk's host time,
    its time to a synchronise, and the synchronising calls torch's sync
    debug mode flags inside it (the served window's ``dispatch``
    seconds hold this walk stretched by the clients' threads)."""
    import warnings

    from spartan_tpu_torch.expr import base
    from spartan_tpu_torch.serve import coalesce
    from spartan_tpu_torch.serve import engine as serve_engine

    def requests():
        return [serve_engine._Request(b(), [], None, None, st.get_mesh())
                for b in builds]

    reqs = requests()
    plan = base.lookup_plan(reqs[0].plan_key)
    coalesce.dispatch_batch(plan, reqs, st.get_mesh())  # the variant
    reqs = requests()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            coalesce.dispatch_batch(plan, reqs, st.get_mesh())
            host = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = [w for w in caught if "ynchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    _say(f"[serve] {label}: one batch of {len(builds)} alone: host "
         f"{host * 1e3:.3f} ms, {wall * 1e3:.3f} ms to a synchronise, "
         f"{len(syncs)} synchronising call(s) flagged by torch's sync "
         f"debug mode on {card}")


def _pct(vals, q: float) -> float:
    return float(np.percentile(np.asarray(vals, np.float64), q))


def _serve_flight(st, futs, label: str, card: str) -> list:
    """Print the p50/p99 of each served request's queue-wait,
    coalesce-wait, dispatch and fetch seconds from its flight record,
    and the batches by dispatch span; returns the requests' batch
    sizes."""
    rec = st.flightrec()["requests"]
    reqs = [rec[f.rid] for row in futs for f in row]
    phases = {k: [q[k] for q in reqs if q.get(k) is not None]
              for k in ("queue_wait_s", "coalesce_wait_s", "dispatch_s",
                        "fetch_s")}
    spans = {}
    for q in reqs:
        spans[q.get("dispatch_span")] = q.get("batch")
    _say(f"[serve] {label} flight records, p50/p99 ms: " + ", ".join(
        f"{k[:-2]} {_pct(v, 50) * 1e3:.3f}/{_pct(v, 99) * 1e3:.3f}"
        for k, v in phases.items())
        + f"; {len(spans)} dispatches of "
        f"{sorted(spans.values(), reverse=True)} requests on {card}")
    return [q["batch"] for q in reqs]


def _serve_dot(st, card: str, dev) -> None:
    """``(x @ y).sum() * s`` at DOT_N, served and in a serial loop."""
    from spartan_tpu_torch.obs import flight

    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    ex = st.as_expr(torch.rand((DOT_N, DOT_N), generator=gen, device=dev))
    ey = st.as_expr(torch.rand((DOT_N, DOT_N), generator=gen, device=dev))
    n = SERVE_CLIENTS * SERVE_PER_CLIENT
    scales = [float(v) for v in np.random.RandomState(27).rand(n) + 0.5]
    float(((ex @ ey).sum() * 1.0).glom())  # the plan, built once
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = [float(((ex @ ey).sum() * s).glom()) for s in scales]
    serial_s = time.perf_counter() - t0
    flight.clear()
    builds = [[(lambda s=scales[c * SERVE_PER_CLIENT + i]:
                (ex @ ey).sum() * s) for i in range(SERVE_PER_CLIENT)]
              for c in range(SERVE_CLIENTS)]
    with st.ServeEngine() as eng:
        t0 = time.perf_counter()
        got, futs = _serve_clients(st, eng, builds, "dot")
        served_s = time.perf_counter() - t0
    flat = [float(v) for row in got for v in row]
    diff = [abs(a - b) for a, b in zip(flat, serial)]
    _say(f"[serve] dot ({DOT_N}^2 @ {DOT_N}^2).sum() * s: {n} requests, "
         f"max |served - serial| {max(diff)!r} (limit 0)")
    _say(f"[serve] dot served {n / served_s:.1f} requests/s, serial loop "
         f"{n / serial_s:.1f} requests/s, ratio "
         f"{serial_s / served_s:.2f} (host clock, fetch included) on "
         f"{card}")
    _serve_flight(st, futs, "dot", card)
    _serve_batch_alone(st, [b for row in builds for b in row][:32], "dot",
                       card)
    if max(diff) != 0.0:
        _fail("[serve] served dot values differ from the serial loop's")


def _last_reject(st) -> dict:
    from spartan_tpu_torch.obs import flight

    ev = [e for e in flight.events() if e.kind in ("reject", "shed")]
    return dict(ev[-1].args or {}, kind=ev[-1].kind) if ev else {}


def _serve_admission(st, km, card: str, dev, kmr: dict) -> None:
    """The four admission refusals, each named in its flight record."""
    from spartan_tpu_torch.expr import base
    from spartan_tpu_torch.resilience import memory
    from spartan_tpu_torch.serve import CommBudgetExceeded

    points = kmr["points"]
    c0 = st.from_numpy(kmr["c0"])

    def step():
        return km.kmeans_step(points, c0, KM_K)

    # Backpressure past the high-water mark
    eng = _serve_parked(st, queue_max=4)
    for _ in range(4):
        eng.submit(step())
    try:
        eng.submit(step())
        _fail("[serve] a submission past the high-water mark was admitted")
    except st.Backpressure as e:
        bp = e
    why = _last_reject(st)
    eng.stop()
    _say(f"[serve] admission: the 5th submission on a 4-deep queue raised "
         f"Backpressure(retry_after_s={bp.retry_after_s:.6f}) (limit > 0), "
         f"flight record {why.get('kind')}/{why.get('reason')}")
    if not bp.retry_after_s > 0 or why.get("reason") != "backpressure":
        _fail(f"[serve] backpressure: {bp.retry_after_s}, {why}")

    # memory: a budget below the k-means plan's request_bytes
    key, ctx = base.plan_signature(step())
    need = memory.request_bytes(base.lookup_plan(key), ctx.leaves,
                                st.get_mesh())
    st.FLAGS.hbm_budget_bytes = need - 1
    try:
        with st.ServeEngine() as eng:
            try:
                eng.submit(step())
                _fail("[serve] a request over the memory budget was "
                      "admitted")
            except st.Backpressure:
                pass
    finally:
        st.FLAGS.hbm_budget_bytes = 0
    why = _last_reject(st)
    _say(f"[serve] admission: memory_governor on, hbm_budget_bytes "
         f"{need - 1} below the k-means plan's request_bytes {need}: "
         f"Backpressure, flight record {why.get('kind')}/"
         f"{why.get('reason')}")
    if why.get("reason") != "memory":
        _fail(f"[serve] memory admission: {why}")

    # a 1 us deadline
    with st.ServeEngine() as eng:
        fut = eng.submit(step(), deadline_s=1e-6)
        try:
            fut.result(timeout=SERVE_WAIT_S)
            _fail("[serve] a request past its 1 us deadline was served")
        except st.DeadlineExceeded:
            pass
    why = st.flightrec()["requests"][fut.rid]
    _say(f"[serve] admission: a 1 us deadline: DeadlineExceeded, flight "
         f"record {why.get('status')}/{why.get('reason')}")
    if why.get("status") != "shed" or \
            why.get("reason") not in ("deadline", "predicted"):
        _fail(f"[serve] deadline shed: {why}")

    # the communication budget: an audited k-split dot on (8, 1)
    with st.use_mesh(st.build_mesh((8, 1))):
        gen = torch.Generator(device=dev)
        gen.manual_seed(28)
        a = st.as_expr(st.DistArray(torch.rand(
            (1024, 4096), generator=gen, device=dev),
            st.Tiling((None, "x")), st.get_mesh()))
        b = st.as_expr(st.DistArray(torch.rand(
            (4096, 1024), generator=gen, device=dev),
            st.Tiling(("x", None)), st.get_mesh()))
        audit = st.audit_plan(st.dot(a, b))
        st.FLAGS.comm_budget_bytes = 1
        try:
            with st.ServeEngine() as eng:
                try:
                    eng.submit(st.dot(a, b))
                    _fail("[serve] a plan over the communication budget "
                          "was admitted")
                except CommBudgetExceeded as e:
                    cb = e
        finally:
            st.FLAGS.comm_budget_bytes = 0
    why = _last_reject(st)
    _say(f"[serve] admission: the audited k-split dot "
         f"({audit.multiset}, ~{audit.comm_bytes:.0f} bytes/position "
         f"modeled) at comm_budget_bytes=1: CommBudgetExceeded, flight "
         f"record {why.get('kind')}/{why.get('reason')} ({why.get('finding')})")
    if not audit.comm_bytes > 0 or why.get("reason") != "comm_budget" or \
            cb.comm_bytes != audit.comm_bytes:
        _fail(f"[serve] communication admission: {audit.multiset}, {why}")


def _serve_drain(st, card: str, dev) -> None:
    """``device_loss`` chaos while requests are queued on the default
    engine: they fail with MeshReconfiguring; resubmitted after the
    rebuild they equal a clean serial run on the rebuilt mesh."""
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.resilience import elastic
    from spartan_tpu_torch.serve import engine as serve_engine

    st.serve.shutdown_default()
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    try:
        with st.use_mesh(st.build_mesh(RES_MESH)):
            mesh0 = st.get_mesh()
            xa = st.DistArray(torch.rand((2048, 2048), generator=gen,
                                         device=dev), st.Tiling(("x", "y")),
                              mesh0)
            ya = st.DistArray(torch.rand((2048, 2048), generator=gen,
                                         device=dev), st.Tiling(("x", "y")),
                              mesh0)

            def req(i):
                return (st.dot(st.as_expr(xa), st.as_expr(ya)).sum()
                        * float(i + 1))

            eng = _serve_parked(st)
            serve_engine._default = eng  # the engine recovery drains
            queued = [eng.submit(req(i)) for i in range(4)]
            with st.chaos("device_loss@0") as plan:
                try:
                    (st.as_expr(xa) * 2.0).sum().evaluate()
                except Exception:  # noqa: BLE001 - stale inputs raise
                    pass
            errs = [f.exception(timeout=SERVE_WAIT_S) for f in queued]
            rec = st.flightrec()["requests"]
            reasons = {rec[f.rid].get("reason") for f in queued}
            epoch = mesh_mod.mesh_epoch()
            if epoch != 1 or not all(
                    isinstance(e, st.MeshReconfiguring)
                    and e.retry_after_s > 0 for e in errs) or \
                    reasons != {"reconfiguring"}:
                _fail(f"[serve] drain: epoch {epoch}, {errs}, {reasons}")
            _serve_unpark(eng)
            elastic.rehome([xa, ya])
            rebuilt = st.get_mesh()
            clean = [float(req(i).glom()) for i in range(4)]
            again = [float(eng.submit(req(i)).glom(timeout=SERVE_WAIT_S))
                     for i in range(4)]
            eng.stop()
        _say(f"[serve] drain ({plan.fired}): {len(queued)} queued requests "
             f"failed with MeshReconfiguring(retry_after_s="
             f"{errs[0].retry_after_s}), flight reason {reasons}; mesh "
             f"{dict(mesh0.shape)} -> {dict(rebuilt.shape)} at epoch "
             f"{epoch}; resubmitted on the rehomed inputs: "
             f"{sum(a == b for a, b in zip(clean, again))}/4 equal to a "
             f"clean serial run on the rebuilt mesh (limit: all)")
        if clean != again:
            _fail("[serve] resubmitted requests differ from the clean run")
    finally:
        serve_engine._default = None
        st.chaos_clear()
        mesh_mod.reset_epoch_for_tests()


def skew_child(workdir: str, rank: int) -> None:
    """One rank of [serve]'s two-process gloo group on the one card:
    ``st.skew`` of a config-3 k-means step, each rank holding its row
    block; results to ``workdir``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spartan_tpu_torch as st
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.parallel import mesh as mesh_mod

    dev = _child_device()
    st.set_default_device(dev)
    if not mesh_mod.initialize_distributed(
            "file://" + os.path.join(workdir, "store"),
            num_processes=GROUP_RANKS, process_id=rank, backend="gloo",
            device=dev, timeout_s=GROUP_TIMEOUT_S):
        _fail("[serve] skew child: no process group")
    pts = st.from_numpy(np.load(os.path.join(workdir, "km_points.npy"),
                                mmap_mode="r"))
    c0 = st.from_numpy(np.load(os.path.join(workdir, "km_c0.npy")))
    rep = st.skew(km.kmeans_step(pts, c0, KM_K), tier="replay")
    d = rep.to_dict()
    with open(os.path.join(workdir, f"skew{rank}.json"), "w") as f:
        json.dump({"rank": rank, "totals": d["device_totals"],
                   "ratio": d["imbalance_ratio"],
                   "nodes": [{k: n[k] for k in ("node", "ratio",
                                                "straggler", "devices")}
                             for n in d["nodes"]],
                   "data": d["data"]}, f)
    mesh_mod.shutdown()


def _serve_skew(st, km, card: str, dev, kmr: dict, workdir: str) -> None:
    """``st.skew`` of a config-3 step on (8, 1) and on two gloo ranks."""
    c0 = st.from_numpy(kmr["c0"])
    with st.use_mesh(st.build_mesh((8, 1))):
        pts8 = st.as_expr(st.DistArray(kmr["points"].value.tensor,
                                       st.Tiling(("x", None)),
                                       st.get_mesh()))
        t0 = time.perf_counter()
        rep = st.skew(km.kmeans_step(pts8, c0, KM_K), tier="replay")
        skew_s = time.perf_counter() - t0
    d = rep.to_dict()
    data = [r for r in d["data"] if r["shape"] == [KM_N, KM_D]]
    _say(f"[serve] st.skew of a config-3 step on (8, 1) (per-block "
         f"replay, {skew_s:.2f} s): per-position ms " + ", ".join(
             f"{k.split('/')[-1]} {v * 1e3:.3f}"
             for k, v in sorted(d["device_totals"].items()))
         + f"; imbalance ratio {d['imbalance_ratio']}; points data skew: "
         f"{data[0]['shards'] if data else '?'} blocks, size ratio "
         f"{data[0]['size_ratio'] if data else '?'}, nnz ratio "
         f"{data[0]['nnz_ratio'] if data else '?'} on {card}")
    if len(d["device_totals"]) != 8 or d["imbalance_ratio"] is None or \
            not data:
        _fail(f"[serve] skew on (8, 1): {d['device_totals']}, "
              f"{d['imbalance_ratio']}, {d['data']}")
    pts_np, c0_np, _ = _data(KM_N, KM_D, KM_K, "clustered", 0)
    np.save(os.path.join(workdir, "km_points.npy"), pts_np)
    np.save(os.path.join(workdir, "km_c0.npy"), c0_np)
    del pts_np
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--skew-child", workdir, str(r)])
             for r in range(GROUP_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=GROUP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _fail(f"[serve] a skew child did not finish in {GROUP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        _fail(f"[serve] skew children exited {[p.returncode for p in procs]}")
    res = []
    for r in range(GROUP_RANKS):
        with open(os.path.join(workdir, f"skew{r}.json")) as f:
            res.append(json.load(f))
    want = sorted(f"{_child_device()}/rank{r}" for r in range(GROUP_RANKS))
    for rr in res:
        _say(f"[serve] st.skew on gloo rank {rr['rank']} of {GROUP_RANKS}: "
             f"per-rank ms " + ", ".join(
                 f"{k.split('/')[-1]} {v * 1e3:.3f}"
                 for k, v in sorted(rr["totals"].items()))
             + f"; imbalance ratio {rr['ratio']}; the rank's points block: "
             f"{[(r['shape'], r['shards'], r['nnz_ratio']) for r in rr['data']]}")
        if sorted(rr["totals"]) != want or rr["ratio"] is None:
            _fail(f"[serve] skew rank {rr['rank']}: {rr['totals']}")
    if res[0]["totals"] != res[1]["totals"]:
        _fail("[serve] the ranks folded different seconds")
    _say(f"[serve] skew children {time.perf_counter() - t0:.1f} s on {card}")


def phase_serve(st, kk, km, card: str, dev, kmr: dict, workdir: str) -> dict:
    """[serve]: the serving front end on the card (module docstring)."""
    t0 = time.perf_counter()
    out = _serve_kmeans(st, kk, km, card, dev, kmr)
    _serve_dot(st, card, dev)
    _serve_admission(st, km, card, dev, kmr)
    _serve_drain(st, card, dev)
    _serve_skew(st, km, card, dev, kmr, workdir)
    _say(f"[serve] phase {time.perf_counter() - t0:.1f} s on {card}")
    return out


def phase_spmd(st, kk, ks, km, card: str, dev, kmr: dict) -> dict:
    t0 = time.perf_counter()
    phase_spmd_threads(st, card, dev, kmr["points"], kmr["c0"])
    phase_spmd_attention(st, card, dev)
    phase_spmd_pipeline(st, card, dev)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_spmd_")
    try:
        group = phase_spmd_group(st, kk, ks, card, dev, kmr, workdir)
        phase_spmd_nccl(st, kk, km, card, dev, kmr, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    _say(f"[spmd] phase {time.perf_counter() - t0:.1f} s on {card}")
    return group


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--ckpt-child":
        ckpt_child(sys.argv[2])
        return
    if len(sys.argv) == 4 and sys.argv[1] == "--spmd-child":
        spmd_child(sys.argv[2], int(sys.argv[3]))
        return
    if len(sys.argv) == 4 and sys.argv[1] == "--local-child":
        local_child(sys.argv[2], int(sys.argv[3]))
        return
    if len(sys.argv) == 4 and sys.argv[1] == "--elastic-child":
        elastic_child(sys.argv[2], int(sys.argv[3]))
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--obs-child":
        obs_child(sys.argv[2])
        return
    if len(sys.argv) == 4 and sys.argv[1] == "--guards-child":
        guards_child(sys.argv[2], int(sys.argv[3]))
        return
    if len(sys.argv) == 4 and sys.argv[1] == "--persist-child":
        persist_child(sys.argv[2], int(sys.argv[3]))
        return
    if len(sys.argv) == 4 and sys.argv[1] == "--skew-child":
        skew_child(sys.argv[2], int(sys.argv[3]))
        return
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this script drives "
              "the port on the card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spartan_tpu_torch as st
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.examples import naive_bayes as nb
    from spartan_tpu_torch.examples import pagerank as pr
    from spartan_tpu_torch.kernels import build as build_mod
    from spartan_tpu_torch.kernels import kmeans as kk
    from spartan_tpu_torch.kernels import exchange as kx
    from spartan_tpu_torch.kernels import histogram as kh
    from spartan_tpu_torch.kernels import segment as ks
    from spartan_tpu_torch.kernels import stencil as kst
    from spartan_tpu_torch.kernels import topk as kt
    from spartan_tpu_torch.ops import segment as seg

    t_start = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda")
    st.set_default_device(dev)
    _COUNTED[:] = [ks, kx, kt, kh, kst]
    phase_build(build_mod, (kk._load, ks._load, kx._load, kt._load,
                            kh._load, kst._load))
    _histogram_layout(kh, dev)
    max_err = phase_kernel_vs_plain(kk, dev)
    phase_pack_kernel(kx, dev)
    topk_err = phase_topk_kernel(kt, dev)
    hist_err = phase_bincount_kernel(kh, dev)
    stencil_err = phase_stencil_kernel(kst, dev)
    t0 = time.perf_counter()
    links = pagerank_links(st.SparseDistArray)
    links.transition()._ensure_plan()
    _say(f"[pagerank] set-up (from_coo, transition, plan) "
         f"{time.perf_counter() - t0:.2f} s")
    seg_err = phase_segment_kernels(ks, seg, links.transition(), dev)
    phase_dot(st, card)
    kmr = phase_kmeans(st, kk, km, card, dev)
    prr = phase_pagerank(kk, ks, pr, links, card, dev)
    nbr = phase_naive_bayes(st, kk, ks, nb, card, dev)
    abr = phase_segment_ab(ks, card, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    keys = torch.rand(SORT_N, generator=gen, device=dev)
    with st.use_mesh(st.build_mesh(SORT_MESH)):
        sortr = phase_sort(st, kk, kx, keys, card, dev)
        topkr = phase_topk(st, kk, kt, keys, card, dev)
        histr = phase_histogram(st, kk, kh, keys, card, dev)
    del keys
    with st.use_mesh(st.build_mesh(VGG_MESH)):
        vggr = phase_vgg(st, kk, kst, card, dev)
    phase_structure(st, card, dev)
    exr = phase_examples(st, kk, ks, nb, card, dev)
    phase_masked(st, card, dev)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        phase_checkpoint(st, card, dev, kmr["padded"], workdir)
        cklr = phase_ckpt_loop(st, kk, km, card, dev, kmr["points"],
                               kmr["c0"], workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    strr = phase_streaming(st, kk, card, dev, kmr["points"], kmr["c0"])
    phase_planner(st, kk, km, card, dev, kmr["points"], kmr["c0"])
    phase_obs(st, kk, km, card, kmr, vggr)
    grp = phase_spmd(st, kk, ks, km, card, dev, kmr)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_local_")
    try:
        loc = phase_local(st, kk, km, pr, links, card, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_resilience_")
    try:
        resr = phase_resilience(st, kk, km, card, dev, workdir)
        elr = phase_elastic_group(st, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_guards_")
    try:
        guard = phase_guards(st, kk, km, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        serve = phase_serve(st, kk, km, card, dev, kmr, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    _say(json.dumps({"kernels": [{
        "name": "kmeans_assign_accumulate", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/kmeans.cu",
        "replaces": "spartan_tpu/kernels/kmeans.py:45",
        "launches": kmr["launches"], "max_abs_err": max_err,
        "ms": kmr["ms"], "plain_ms": kmr["plain_ms"],
        "bound_ms": kmr["bound_ms"], "bound_by": kmr["bound_by"],
        "library_ms": kmr["library_ms"],
        "estimator_launches": exr["kmeans_launches"],
        "ckpt_loop_launches": cklr["launches"],
        "refine_launches": strr["launches"],
        "group_launches_per_rank": grp["kmeans"],
        "local_launches_per_rank": loc["kmeans"],
        "resilience_launches": resr["launches"],
        "elastic_survivor_launches": elr["survivor_launches"],
        "integrity_launches": guard["integrity_launches"],
        "serve_launches": serve["launches"]}, {
        "name": "windowed_segsum", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/segment.cu",
        "replaces": "spartan_tpu/kernels/segment.py:148",
        "launches": prr["launches"], "max_abs_err": seg_err["windowed_err"],
        "ms": prr["ms"], "plain_ms": prr["plain_ms"],
        "bound_ms": prr["bound_ms"], "bound_by": prr["bound_by"],
        "library_ms": prr["library_ms"],
        "local_launches_per_rank": loc["windowed_segsum"]}, {
        "name": "segment_sum_block", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/segment.cu",
        "replaces": "spartan_tpu/kernels/segment.py:33",
        "launches": nbr["launches"], "max_abs_err": seg_err["block_err"],
        "ms": abr["ms"], "plain_ms": abr["plain_ms"],
        "bound_ms": abr["bound_ms"], "bound_by": abr["bound_by"],
        "library_ms": abr["library_ms"], "naive_bayes_ms": nbr["ms"],
        "naive_bayes_bound_ms": nbr["bound_ms"],
        "naive_bayes_library_ms": nbr["library_ms"],
        "estimator_launches": exr["nb_launches"],
        "group_launches_per_rank": grp["segment"]}, {
        "name": "partition_pack", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/exchange.cu",
        "replaces": "spartan_tpu/kernels/exchange.py:31",
        "launches": sortr["launches"], "max_abs_err": 0.0,
        "ms": sortr["ms"], "plain_ms": sortr["plain_ms"],
        "bound_ms": sortr["bound_ms"], "bound_by": sortr["bound_by"],
        "library_ms": sortr["library_ms"],
        "local_launches_per_rank": loc["partition_pack"]}, {
        "name": "shard_topk", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/topk.cu",
        "replaces": "spartan_tpu/kernels/topk.py:30",
        "launches": topkr["launches"], "max_abs_err": topk_err,
        "ms": topkr["ms"], "plain_ms": topkr["plain_ms"],
        "bound_ms": topkr["bound_ms"], "bound_by": topkr["bound_by"],
        "library_ms": topkr["library_ms"],
        "local_launches_per_rank": loc["shard_topk"]}, {
        "name": "bincount_block", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/histogram.cu",
        "replaces": "spartan_tpu/kernels/histogram.py:24",
        "launches": histr["launches"], "max_abs_err": hist_err,
        "ms": histr["ms"], "plain_ms": histr["plain_ms"],
        "bound_ms": histr["bound_ms"], "bound_by": histr["bound_by"],
        "library_ms": histr["library_ms"], "unique_ms": histr["unique_ms"],
        "unique_bound_ms": histr["unique_bound_ms"],
        "unique_library_ms": histr["unique_library_ms"],
        "group_launches_per_rank": grp["bincount"]}, {
        "name": "conv_block", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/stencil.cu",
        "replaces": "spartan_tpu/kernels/stencil.py:32",
        "launches": vggr["launches"], "max_abs_err": stencil_err,
        "ms": vggr["ms"], "plain_ms": vggr["plain_ms"],
        "bound_ms": vggr["bound_ms"], "bound_by": vggr["bound_by"],
        "bound_fp32_ms": vggr["bound_fp32_ms"],
        "library_ms": vggr["library_ms"],
        "group_launches_per_rank": grp["conv_block"]}]}))
    _say(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f}"
         " s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
