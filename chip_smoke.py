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
   rerun against its first run bit for bit; ``[gemv]``: the fixed-order
   vector product (``kernels/gemv.py``) as ``x @ A`` and ``A @ x`` of
   16,384^2 and 32,768^2 matrices and of a tall (2^22, 32) matrix in
   both orientations (the contraction 2^22 long), each bit-equal to its
   plain version, each output window at odd offsets and widths bit-equal
   to the product of the matching window view, within the float32
   summation bound of float64, with kernel, ``torch.matmul``, plain and
   bound ms; each case's device split from torch.profiler (pass 1 ms,
   fold ms, and what a product takes beyond its pass 1), traced in a
   child process so that no trace runs in this one before
   ``[sort]``'s, and printed beside those;
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
    of the one-process run; config 5's links and transition stored as
    each rank's block of the entries (nse / 2 x 12 bytes a rank, one
    ``partition_pack`` launch a rank for the transpose), a group
    ``from_coo_device`` of the 16M-entry stream bit-equal to the
    one-process dedup, naive Bayes's fit at 262,144 x 2,048 on each
    rank's rows (one ``segment_sum_block`` launch and one all-reduce of
    163,920 bytes a rank) beside one walk with its rule off, a per-row
    masked sort of 8 x 2^23 and a group save and load of the links;
    the user functions GSPMD keeps split, each beside its rule-off arm:
    the trace, a flip and a whole-shape map constant of 8192^2,
    centering config 4's X, ALS's half-step and 5 iterations of ``als``
    at MovieLens-1M's shape (within 1e-4 of float64 on the card, its
    bytes received exactly the transposed ratings' one relayout and the
    gloms) and the masked median of 8 x 2^23 along each axis, each
    with the bytes it received;
    ``retile`` of a 4096^2 array between every pair of {row, col,
    block, replicated}, bit-equal, with the bytes each rank received;
    ``calibrate_flop_weight`` over the group. No path gathers an array
    whole (``group_materialize_calls`` stays 0);
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
    request in the served window (the operator's batching rule). Then
    the same for kernel rows 4-7, 16 x 4 requests each on a logical
    (8, 1) mesh through one engine with batches of at most 16: top-k
    (both outputs, k = 128) and a 64-bin ranged histogram on 2^26 keys
    a request (windows of one seeded key buffer), the sort of 2^22 keys
    a request, and VGG-16 block 1 on 4 images of 224^2 x 3 a request
    (H tiled): the predicted peak a batch printed first (walks
    serialized where two would not fit), every result bit-equal to its
    serial ``evaluate()``, the plan in ``vmap`` with no demotion or solo
    fallback, batches of powers of two, the window's launches equal to
    the requests times a solo walk's (the operators' batching rules),
    request 0 against a torch, numpy or float64 reference, requests/s
    served and serial and the ``serve_batch`` dispatch ms. Then 64
    requests of ``st.ravel`` of a 2048^2 (2^22-key) array on (8, 1),
    batches of 16: its mode, demotions and solo fallbacks, each result
    bit-equal to its serial ``evaluate()`` and request 0 to
    ``reshape(-1)``. The
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
24. ``[incremental]``, the delta-aware engine (``FLAGS.incremental``,
    ``result_cache_bytes`` raised to hold a 4 GiB leaf): first the card's
    answer to ``incremental.order_granule`` (restricted cuBLAS
    vector-matrix and 4096^2 matrix products against the full products'
    bits) and the fixed-order kernel's windows at granule 1.
    Edge-insert PageRank through ``streaming.IncrementalPageRank`` on
    dense transitions at n = 16,384 and 32,768: 8 batches rewriting 1%
    of the columns through ``update()`` with a step after each, the
    flag on then off on the same stream, the seam write synchronised
    and timed outside the step windows; median step ms of each arm,
    their ratio, the on arm's ``incremental_*`` counter deltas and
    modes (every warm step served: its product restricted to the
    rewritten columns through ``fixed_order_dot``, 9 launches in the on
    arm), final ranks bit-equal to the off arm. The delta curve at
    0.1%, 1% and 10% dirty for n = 16,384. A 1,048,576 x 128 window
    normalized with fixed statistics after each 1% push (served
    incrementally, bit-equal). ``OnlineKMeans.refine
    (iters=5)`` twice under the flag: 5 row-1 launches each, bit-equal
    to the flag-off run, the loop node a counted fallback. The flag-off
    cost: config-3 ``kmeans_step`` iterations/s with ``expr.base``'s
    ``incremental_mod`` against a null shim (the JAX package's gate:
    1%);
25. ``[monitor]``, the continuous monitor: config-3 steps with
    ``FLAGS.monitor`` on at a 0.05 s interval against off, alternated,
    best of 3 (overhead, ticks, mean tick us); a planted 4x calibration
    drift fed until the drift anomaly fires, the autotune daemon's
    refit and swap or revert (its warm-up launching row 1, the step
    bit-equal); the ``sdc`` anomaly of ``[guards]``' quarantine and the
    epoch fences of the rebuilds; ``st.status()``; ``st.fleet_status()``
    over two gloo ranks (``--monitor-child``);
26. ``[benchguard]``: the run's steady figures (dot GFLOPS, config-3
    k-means, PageRank and logreg iterations/s, SSVD s, the naive-Bayes
    fit's ms and each kernel row's ms) against ``spartan_tpu_torch/utils/thresholds.json``; a
    breach names the figure, its value and its bound and fails the run;
    on a card other than the file's, ``ungraded: <card>``;
27. the ``kernels`` line (eight entries: the seven ports of Pallas
    kernels and ``fixed_order_dot``, with its launches on the
    ``[incremental]`` PageRank on arm and per rank of
    ``[incremental_group]``; times, launches, bounds; rows 1, 3, 4 and 7
    with their launches per rank on the group path, rows 1, 2, 5 and 6
    with their launches per rank under local-shard storage, row 1 with
    the faulted run's, the survivor's, the integrity run's and the
    served window's launches) and the result line.

``python3 chip_smoke.py --ckpt-child DIR`` is the child process of
``[ckpt_loop]``, and ``python3 chip_smoke.py --spmd-child DIR RANK``,
``--local-child DIR RANK``, ``--elastic-child DIR RANK``,
``--guards-child DIR RANK``, ``--skew-child DIR RANK`` and
``--monitor-child DIR RANK`` one rank of ``[spmd]``'s, ``[local]``'s,
``[elastic_group]``'s, ``[guards]``'s, ``[serve]``'s and ``[monitor]``'s
groups, ``--obs-child DIR``
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
# [local]'s local rules on the same group: the structure ops at 8192^2
# f32, outer of two 16,384-vectors, the batched sorts of 8 rows of 2^23
# keys along their tiled axis, a 64-bin histogram of the 8192^2 array,
# pooling of VGG-16 block 1's activations and the block's forward; each
# rank's measured peak within LOCAL_MEM_TOL of peak_bytes_card
LOCAL_BSORT = (8, 2 ** 23)
LOCAL_MEM_TOL = 0.05
# [local]'s user functions: logistic regression at bench.py's guard size
# (config 4) and its iterations, the seed of its X, the fuzzy k-means
# fuzziness; the rule-off arms walk one iteration of the loop
PART_SEED, PART_FZ_M = 90, 2.0
# [local]'s user functions GSPMD keeps split: ALS at MovieLens-1M's shape
# (6,040 users x 3,706 items, 1,000,209 ratings), synthetic by
# _movielens's recipe, k = EX_ML_K, its iterations and regularisation
LOCAL_ML_USERS, LOCAL_ML_ITEMS, LOCAL_ML_RATINGS = 6040, 3706, 1_000_209
LOCAL_ALS_ITERS, LOCAL_ALS_REG = 5, 0.1
# [local]'s fills: the draws' seed, the sample of the points' rows and
# the rows of the 8192^2 array a 4096-row source is written into
FILL_SEED, FILL_SAMPLE, FILL_ROWS = 70, 65_536, (2048, 6144)
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
# [serve]'s kernel cases (rows 4-7 through their batching rules): the
# engine's largest batch, keys a sort request (16 of them make one 2^26
# sort), images a VGG request, the stride between the top-k and
# histogram requests' windows of one key buffer, and the share of the
# card two batches' predicted peaks may take before walks serialize
SERVE_KERNEL_BATCH, SERVE_SORT_N, SERVE_VGG_N = 16, 2 ** 22, 4
SERVE_WINDOW_STRIDE, SERVE_MEM_SHARE = 4096, 0.8
# [gemv]: the fixed-order vector product at the incremental PageRank
# step's widths (vector-matrix and matrix-vector of one n^2 matrix) and
# at a tall (2^22, 32) matrix in both orientations (the contraction runs
# to 2^22); the output windows (start, width) each is checked at, and
# the timed reps
GEMV_NS, GEMV_TALL, GEMV_REPS = (16_384, 32_768), (2 ** 22, 32), 20
GEMV_WINDOWS = ((777, 164), (3001, 329), (1, 1), (-331, 331))
GEMV_TALL_WINDOWS = ((1, 7), (5, 27), (31, 1))
# [gemv]'s device split: calls traced a case
GEMV_SPLIT_CALLS = 5
# [serve]'s ravel case: the side of each request's square array (2^22 keys)
SERVE_RAVEL_SIDE = 2048


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


def phase_dot(st, card: str) -> dict:
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
    return {"gflops": gflops}


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
            "ops": ops, "nbytes": nbytes, "loop_ips": loop_ips, "ips": ips,
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
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "ips": ips}


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
            "bound_ms": bound_ms, "fit_ms": best * 1e3}


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


# -- [gemv]: the fixed-order vector product ----------------------------------


def _gemv_case(kg, label: str, vec, mat, orient: str, windows,
               card: str) -> dict:
    """One product through ``fixed_order_dot``: one launch, bit-equal to
    its plain version, each output window bit-equal to the product of
    the matching window of ``mat`` (a view), within the recursive-sum
    bound of float64; then kernel, ``torch.matmul`` and plain ms beside
    the bound."""
    if orient == "vecmat":  # vec (K,) @ mat (K, M)
        (k, m), pair = mat.shape, (vec, mat)

        def window(lo, hi):
            return kg.fixed_order_dot(vec, mat[:, lo:hi])
    else:  # mat (M, K) @ vec (K,)
        (m, k), pair = mat.shape, (mat, vec)

        def window(lo, hi):
            return kg.fixed_order_dot(mat[lo:hi], vec)
    before = kg.LAUNCHES["fixed_order_dot"]
    got = kg.fixed_order_dot(*pair)
    torch.cuda.synchronize()
    launches = kg.LAUNCHES["fixed_order_dot"] - before
    want = kg.fixed_order_dot_plain(*pair)
    err = float((got - want).abs().max())
    if launches != 1 or not torch.equal(got, want):
        _fail(f"[gemv] {label}: {launches} launches, max |kernel - plain| "
              f"{err:.3g} (want 1 launch, bit-equal)")
    held = []
    for lo, w in windows:
        lo = lo % m
        hi = min(m, lo + w)
        held.append(torch.equal(got[lo:hi], window(lo, hi)))
    if not all(held):
        _fail(f"[gemv] {label}: windows {windows} held {held}")
    # |got - exact| <= gamma_n (|x| @ |A|), n = KS + S + 1 roundings on
    # each element's path (a slice's products and sums, the slices' fold)
    n_round = kg.KS + -(-k // kg.KS) + 1
    ref = torch.matmul(*(t.double() for t in pair))
    mag = torch.matmul(*(t.double().abs() for t in pair))
    slack = float(((got.double() - ref).abs()
                   - n_round * _U / (1 - n_round * _U) * mag).max())
    del ref, mag
    if slack > 0:
        _fail(f"[gemv] {label}: beyond the float32 summation bound by "
              f"{slack:.3g}")
    ms = _event_ms(lambda: kg.fixed_order_dot(*pair), GEMV_REPS)
    lib_ms = _event_ms(lambda: torch.matmul(*pair), GEMV_REPS)
    plain_ms = _event_ms(lambda: kg.fixed_order_dot_plain(*pair), 1,
                         warmup=0)
    flops_peak, bw_peak = _peaks(card)
    bytes_ms = 4.0 * (k * m + k + m) / bw_peak * 1e3
    ops_ms = 2.0 * k * m / flops_peak * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    _say(f"[gemv] {label}: K = {k}, M = {m}, {launches} launch a product, "
         f"bit-equal to the plain version, {len(held)} windows "
         f"{[(lo % m, min(m, lo % m + w)) for lo, w in windows]} "
         f"bit-equal; kernel {ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, "
         f"plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms by "
         f"{bound_by} ({100 * bound_ms / ms:.0f}% of it) on {card}")
    return {"ms": ms, "library_ms": lib_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "launches": launches, "label": label, "orient": orient,
            "shape": tuple(mat.shape)}


def _gemv_split(kg, pair, ms: float) -> str:
    """Where one product's device time goes: a torch.profiler trace of
    ``GEMV_SPLIT_CALLS`` calls after a warm-up, the pass-1 and fold
    kernels' device ms (means over the calls), and what the product
    takes beyond its pass 1 (``ms``, the CUDA-event time of a call, less
    pass 1's)."""
    from torch.profiler import ProfilerActivity, profile

    kg.fixed_order_dot(*pair)
    torch.cuda.synchronize()
    for _attempt in range(2):  # a trace may lose its device records
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(GEMV_SPLIT_CALLS):
                kg.fixed_order_dot(*pair)
            torch.cuda.synchronize()
        rows = {"pass1": [], "fold_slices": []}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for key, got in rows.items():
                if key in e.key and e.self_device_time_total > 0:
                    got.append((e.self_device_time_total, e.count))
        if rows["pass1"]:
            break
    if not rows["pass1"]:
        return "not measured (the profiler recorded no pass-1 kernel)"
    # means over the kernels recorded (a late trace may drop a few)
    pass1, fold = (sum(t for t, _ in rows[k]) / 1e3
                   / max(1, sum(n for _, n in rows[k]))
                   for k in ("pass1", "fold_slices"))
    seen = sum(n for _, n in rows["pass1"])
    out = f"pass 1 {pass1:.4f} ms, "
    out += f"fold {fold:.4f} ms" if rows["fold_slices"] else \
        "no fold (one slice)"
    return out + (f", {ms - pass1:.4f} ms beyond pass 1 (torch.profiler, "
                  f"mean of the {seen} of {GEMV_SPLIT_CALLS} calls "
                  f"recorded)")


def phase_gemv(kg, card: str, dev) -> dict:
    """[gemv]: ``kernels/gemv.fixed_order_dot`` against its plain version
    at the PageRank step's widths and a tall matrix, in both
    orientations; returns the 16,384^2 vector-matrix case (the PageRank
    step's product) with the largest error of all cases, and every
    case's figures under ``cases`` (for ``phase_gemv_split``)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(26)
    out, cases = None, []
    for n in GEMV_NS:
        a = torch.rand((n, n), generator=gen, device=dev).mul_(2).sub_(1)
        x = torch.rand((n,), generator=gen, device=dev).mul_(2).sub_(1)
        vm = _gemv_case(kg, f"{n}^2 x @ A", x, a, "vecmat", GEMV_WINDOWS,
                        card)
        mv = _gemv_case(kg, f"{n}^2 A @ x", x, a, "matvec", GEMV_WINDOWS,
                        card)
        # a transposed view takes the other entry point over its base
        if not torch.equal(kg.fixed_order_dot(x, a.t()),
                           kg.fixed_order_dot(a, x)):
            _fail(f"[gemv] {n}^2: x @ A.T differs from A @ x")
        cases += [vm, mv]
        out = out or vm
        del a
    rows, cols = GEMV_TALL
    a = torch.rand((rows, cols), generator=gen, device=dev).mul_(2).sub_(1)
    x = torch.rand((rows,), generator=gen, device=dev).mul_(2).sub_(1)
    cases.append(_gemv_case(kg, f"tall ({rows}, {cols}) x @ A", x, a,
                            "vecmat", GEMV_TALL_WINDOWS, card))
    at = a.t().contiguous()
    del a
    cases.append(_gemv_case(kg, f"tall ({cols}, {rows}) A @ x", x, at,
                            "matvec", GEMV_TALL_WINDOWS, card))
    del at, x
    torch.cuda.empty_cache()
    _say(f"[gemv] phase {time.perf_counter() - t0:.1f} s on {card}")
    return dict(out, max_abs_err=max(c["max_abs_err"] for c in cases),
                cases=cases)


def phase_gemv_split(card: str, cases: list) -> None:
    """[gemv]'s device split of each case of ``phase_gemv`` (``cases``,
    its returned list), printed beside the case's kernel,
    ``torch.matmul`` and bound ms by :func:`gemv_split_child`. The trace
    runs in a process of its own: a torch.profiler trace in this one
    would be its first, and the phases timed by the host clock before
    ``[sort]`` (PageRank's launch-bound steps among them) ran without
    one when their limits in ``utils/thresholds.json`` were taken."""
    keep = ("label", "orient", "shape", "ms", "library_ms", "bound_ms")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_gemv_")
    try:
        job = os.path.join(workdir, "cases.json")
        with open(job, "w") as f:
            json.dump({"card": card,
                       "cases": [{k: c[k] for k in keep} for c in cases]}, f)
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--gemv-split-child",
             job], capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            _fail(f"[gemv] the split child exited {res.returncode}: "
                  f"{(res.stdout + res.stderr)[-2000:]}")
        for line in res.stdout.splitlines():
            _say(line)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def gemv_split_child(job: str) -> None:
    """The child of :func:`phase_gemv_split`: each case of ``job`` (a
    JSON file) on fresh operands of its shape and layout, its device
    split printed beside its kernel, ``torch.matmul`` and bound ms."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spartan_tpu_torch.kernels import gemv as kg

    with open(job) as f:
        spec = json.load(f)
    card, dev = spec["card"], torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(27)
    for case in spec["cases"]:
        mat = torch.rand(case["shape"], generator=gen, device=dev)
        vec = torch.rand((mat.shape[0 if case["orient"] == "vecmat" else 1],),
                         generator=gen, device=dev)
        pair = (vec, mat) if case["orient"] == "vecmat" else (mat, vec)
        split = _gemv_split(kg, pair, case["ms"])
        _say(f"[gemv] {case['label']}: device split {split}; beside kernel "
             f"{case['ms']:.4f} ms, torch.matmul {case['library_ms']:.4f} "
             f"ms, bound {case['bound_ms']:.4f} ms on {card}")
        del mat, vec, pair


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


def _movielens(nu: int = EX_ML_USERS, ni: int = EX_ML_ITEMS,
               n_ratings: int = EX_ML_RATINGS):
    """A MovieLens shape (100K's by default), synthetic: ``n_ratings``
    distinct (user, item) pairs, integer ratings 1-5 from a rank-5
    model plus noise."""
    rng = np.random.RandomState(49)
    flat = rng.choice(nu * ni, n_ratings, replace=False)
    rows, cols = flat // ni, flat % ni
    score = (rng.randn(nu, 5) @ rng.randn(5, ni)) / np.sqrt(5.0)
    vals = np.clip(np.rint(3.0 + score[rows, cols]
                           + 0.5 * rng.randn(rows.size)), 1, 5)
    dense = np.zeros((nu, ni), np.float32)
    dense[rows, cols] = vals
    return rows, cols, vals.astype(np.float32), dense


def _als_f64(r, k: int, iters: int, reg: float, seed: int, dev=None):
    """als' steps in float64 (batched normal equations), on ``dev`` (the
    host by default); numpy factors back."""
    dev = torch.device("cpu") if dev is None else dev
    v = torch.from_numpy((np.random.RandomState(seed).rand(
        r.shape[1], k).astype(np.float32) * 0.1).astype(np.float64)).to(dev)
    r = torch.as_tensor(r).to(device=dev, dtype=torch.float64)
    eye = torch.eye(k, dtype=torch.float64, device=dev)

    def side(rr, other):
        w = (rr != 0).to(torch.float64)
        a = torch.einsum("mn,nk,nl->mkl", w, other, other) + reg * eye
        b = ((w * rr) @ other)[:, :, None]
        return torch.linalg.solve(a, b)[:, :, 0]

    for _ in range(iters):
        u = side(r, v)
        v = side(r.T, u)
    return u.cpu().numpy(), v.cpu().numpy()


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
    pair of layouts, the local rules of the structure ops, outer, the
    scan, the batched sorts, the histogram, pooling and the VGG-16
    block-1 forward (``_local_rules``) and the FLOP-weight calibration;
    results to ``workdir``."""
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

    # PageRank at the [pagerank] plan over the sharded SpMV: the links
    # and their transition stored as each rank's block of the entries
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(dev)
    links = path("links", lambda: pagerank_links(st.SparseDistArray))
    torch.cuda.synchronize()
    res["links_alloc"] = torch.cuda.memory_allocated(dev) - m0
    kx.LAUNCHES["partition_pack"] = 0
    path("transition", links.transition)._ensure_plan()
    res["transition_launches"] = kx.LAUNCHES["partition_pack"]
    ks.LAUNCHES["windowed_segsum"] = 0
    ranks = path("pagerank", lambda: pr.pagerank(links, num_iter=PR_ITERS))
    res["pagerank_launches"] = ks.LAUNCHES["windowed_segsum"]
    np.save(os.path.join(workdir, f"ranks{rank}.npy"), ranks)
    res["pagerank_ms"] = _wall_ms(lambda: pr.pagerank(links,
                                                      num_iter=PR_ITERS),
                                  reps=2)
    res["sparse"] = _local_sparse(st, path, dev, mesh, links, workdir)
    del links
    torch.cuda.empty_cache()

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

    res["rules"] = _local_rules(st, path, dev, mesh, workdir)

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


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same shape and the same bits (4-byte dtypes)."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(
        torch.int32), b.contiguous().view(torch.int32))


def _local_sparse(st, path, dev, mesh, links, workdir: str) -> dict:
    """[local]'s sparse arrays, segment sums and masked sorts on this
    rank: config 5's ``links`` and its transition as stored (bytes a
    rank); a group ``from_coo_device`` of the 16M-entry stream with
    random values against the one-process dedup; the naive Bayes fit at
    262,144 x 2,048 under ``native_kernels=on`` (its segment sums proven
    over the rows) beside one walk with the rule switched off, both
    against the one-process fit; a per-row masked sort of 8 x 2^23
    against the one-process sort; a group save and load of ``links``.
    Each path's gathers and received bytes go to ``path``."""
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.array.masked import MaskedDistArray, masked_sort
    from spartan_tpu_torch.examples import naive_bayes as nb
    from spartan_tpu_torch.expr.map2 import Map2Expr
    from spartan_tpu_torch.kernels import exchange as kx
    from spartan_tpu_torch.kernels import segment as ks
    from spartan_tpu_torch.obs.metrics import partition_decisions
    from spartan_tpu_torch.utils import checkpoint as ckpt

    out = {}
    grid = (mesh.shape["x"], mesh.shape["y"])

    def stored(sp) -> int:
        return sum(t.numel() * t.element_size() for t in sp.block[:3])

    def same(g, one) -> bool:
        """``g``'s block is the one-process array's slice, bit for bit."""
        b, w = g.block, one.block
        sl = slice(b.lo, b.lo + b.data.shape[0])
        return (g.nnz == one.nnz and g.nse == one.nse
                and all(_bits_equal(x, y[sl]) for x, y in zip(b[:3], w[:3])))

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = path(name, fn)
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t) * 1e3
        return got

    T = links.transition()
    out["links_nse"], out["links_nnz"] = links.nse, links.nnz
    out["links_bytes"], out["T_bytes"] = stored(links), stored(T)
    out["T_nse"] = T.nse

    # the config-5 stream (16M entries, its duplicate links) with random
    # values, so each duplicate's sum shows its order
    rng = np.random.RandomState(4)
    rows = torch.from_numpy(np.repeat(np.arange(PR_N, dtype=np.int32),
                                      PR_DEG)).to(dev)
    cols = torch.from_numpy(rng.randint(0, PR_N, PR_N * PR_DEG)
                            .astype(np.int32)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    vals = torch.rand(PR_N * PR_DEG, generator=gen, device=dev)
    kx.LAUNCHES["partition_pack"] = 0
    g = timed("coo_device", lambda: st.SparseDistArray.from_coo_device(
        rows, cols, vals, (PR_N, PR_N)))
    out["coo_device_launches"] = kx.LAUNCHES["partition_pack"]
    with st.use_mesh(st.build_mesh(grid, dev)):
        one = st.SparseDistArray.from_coo_device(rows, cols, vals,
                                                 (PR_N, PR_N))
    out["coo_device_equal"] = same(g, one)
    out["coo_device_nnz"], out["coo_device_bytes"] = g.nnz, stored(g)
    del g, one, rows, cols, vals
    torch.cuda.empty_cache()

    # naive Bayes's fit on each rank's rows, then with the rule off
    x, yt, _ = _nb_data(dev)
    prev = st.FLAGS.native_kernels
    st.FLAGS.native_kernels = "on"
    try:
        with st.use_mesh(st.build_mesh(grid, dev)):
            one = nb.fit(from_tensor(x), from_tensor(yt), NB_CLASSES)
        X = from_tensor(x, tiling=st.Tiling(("x", None)))
        Y = from_tensor(yt, tiling=st.Tiling(("x",)))
        del x, yt
        torch.cuda.empty_cache()
        nb.fit(X, Y, NB_CLASSES)  # its plan, built
        ks.LAUNCHES["segment_sum_block"] = 0
        before = partition_decisions()
        c0 = st.REGISTRY.counter_values()
        got = timed("nb_fit", lambda: nb.fit(X, Y, NB_CLASSES))
        c1 = st.REGISTRY.counter_values()
        for key, name in (('collective_calls{op="all_reduce"}',
                           "nb_reduces"),
                          ('group_received_bytes{op="all_reduce"}',
                           "nb_reduce_recv")):
            out[name] = c1.get(key, 0) - c0.get(key, 0)
        out["nb_launches"] = ks.LAUNCHES["segment_sum_block"]
        out["nb_decisions"] = {"/".join(k): v - before.get(k, 0)
                               for k, v in partition_decisions().items()
                               if v != before.get(k, 0)}
        out["nb_equal"] = all(np.array_equal(a, b)
                              for a, b in zip(got, one))
        saved = Map2Expr._lower_local
        Map2Expr._lower_local = None
        try:
            nb.fit(X, Y, NB_CLASSES)  # its plan, built
            got = timed("nb_fit_off", lambda: nb.fit(X, Y, NB_CLASSES))
        finally:
            Map2Expr._lower_local = saved
        out["nb_off_equal"] = all(np.array_equal(a, b)
                                  for a, b in zip(got, one))
    finally:
        st.FLAGS.native_kernels = prev
    del X, Y, got, one
    torch.cuda.empty_cache()

    # a masked sort of each row of 8 x 2^23: the rows whole on each rank
    gen.manual_seed(43)
    shape = (MASK_ROWS, MASK_COLS)
    md = torch.randn(shape, generator=gen, device=dev)
    mm = torch.rand(shape, generator=gen, device=dev) < MASK_WHERE
    rows_t = st.Tiling(("x", None))
    srt = masked_sort(MaskedDistArray(from_tensor(md, tiling=rows_t),
                                      from_tensor(mm, tiling=rows_t)), 1)
    gd = timed("msort", lambda: srt.data.evaluate())
    gm = path("msort_mask", lambda: srt.mask.evaluate())
    with st.use_mesh(st.build_mesh(grid, dev)):
        one = masked_sort(MaskedDistArray(from_tensor(md),
                                          from_tensor(mm)), 1)
        od, om = one.data.evaluate().local, one.mask.evaluate().local
    ext = gd.tiling.block_extent(gd.shape, mesh)
    out["msort_equal"] = (_bits_equal(gd.local, od[ext.to_slice()])
                          and torch.equal(gm.local, om[ext.to_slice()]))
    out["msort_local"] = list(gd.local.shape)
    del md, mm, srt, gd, gm, one, od, om
    torch.cuda.empty_cache()

    # a group save and load of the links
    d = os.path.join(workdir, "links_ckpt")
    timed("sparse_save", lambda: ckpt.save_sparse(d, links))
    kx.LAUNCHES["partition_pack"] = 0
    back = timed("sparse_load", lambda: ckpt.load_sparse(d))
    out["load_launches"] = kx.LAUNCHES["partition_pack"]
    out["ckpt_equal"] = (back.nnz == links.nnz and back.nse == links.nse
                         and all(_bits_equal(x, y) for x, y in zip(
                             back.block[:3], links.block[:3])))
    del back
    return out


def _local_sparse_report(res, card: str) -> None:
    """[local]'s sparse cases beside their gates: each rank's entry
    bytes, nothing gathered, the launches on the stored blocks, NB's one
    all-reduce, every result bit-equal to the one-process run."""
    nb_bytes = NB_CLASSES * (NB_FEATURES + 1) * 4
    for r, rr in enumerate(res):
        sp = rr["sparse"]
        want = 12 * sp["links_nse"] // GROUP_RANKS
        _say(f"[local] rank {r}: config-5 links ({sp['links_nnz']} entries, "
             f"nse {sp['links_nse']}) stored {sp['links_bytes']} bytes "
             f"(nse / {GROUP_RANKS} x 12 = {want}; cudaMalloc'd "
             f"{rr['links_alloc']}), gathered whole {rr['links_mat']}; "
             f"its transition T stored {sp['T_bytes']} bytes, built with "
             f"{rr['transition_launches']} partition_pack launch(es), "
             f"gathered whole {rr['transition_mat']}, received "
             f"{rr['transition_recv']} bytes on {card}")
        for key, got, lim in (("links", sp["links_bytes"], want),
                              ("T", sp["T_bytes"], 12 * sp["T_nse"]
                               // GROUP_RANKS)):
            if got != lim:
                _fail(f"[local] rank {r}: {key} stores {got} bytes of "
                      f"entries, want {lim}")
        if abs(rr["links_alloc"] - want) > 0.01 * want:
            _fail(f"[local] rank {r}: from_coo allocated "
                  f"{rr['links_alloc']} bytes on the card, want its block "
                  f"of {want} (limit 1%)")
        _say(f"[local] rank {r}: from_coo_device of the {PR_N * PR_DEG}-"
             f"entry stream (random values, its duplicate links summed) "
             f"over the group: {sp['coo_device_ms']:.1f} ms, "
             f"{sp['coo_device_launches']} partition_pack launch(es), "
             f"nnz {sp['coo_device_nnz']}, stored "
             f"{sp['coo_device_bytes']} bytes, received "
             f"{rr['coo_device_recv']} bytes, bit-equal to the one-process "
             f"dedup {sp['coo_device_equal']} (host clock; two processes "
             f"time-slice one card) on {card}")
        _say(f"[local] rank {r}: naive Bayes fit {NB_ROWS} x {NB_FEATURES},"
             f" {NB_CLASSES} classes, native_kernels=on, on this rank's "
             f"rows: {sp['nb_fit_ms']:.1f} ms, {sp['nb_launches']} "
             f"segment_sum_block launch(es), gathered whole "
             f"{rr['nb_fit_mat']}, {sp['nb_reduces']} all-reduce receiving "
             f"{sp['nb_reduce_recv']} bytes (the (k, d + 1) partial: "
             f"{nb_bytes}), {rr['nb_fit_recv']} bytes received in all "
             f"(glom gathers the table the planner split), decisions "
             f"{sp['nb_decisions']}, tables bit-equal to the one-process "
             f"fit {sp['nb_equal']}; the rule switched off (one walk): "
             f"gathered whole {rr['nb_fit_off_mat']}, received "
             f"{rr['nb_fit_off_recv']} bytes, {sp['nb_fit_off_ms']:.1f} ms,"
             f" bit-equal {sp['nb_off_equal']} (host clock) on {card}")
        _say(f"[local] rank {r}: masked sort of each row of {MASK_ROWS} x "
             f"{MASK_COLS} f32 (block {sp['msort_local']}): "
             f"{sp['msort_ms']:.1f} ms, gathered whole "
             f"{rr['msort_mat'] + rr['msort_mask_mat']}, bit-equal to the "
             f"one-process sort {sp['msort_equal']}; save_sparse of links "
             f"{sp['sparse_save_ms']:.1f} ms, load_sparse "
             f"{sp['sparse_load_ms']:.1f} ms ({sp['load_launches']} "
             f"partition_pack launch(es)), gathered whole "
             f"{rr['sparse_save_mat'] + rr['sparse_load_mat']}, bit-equal "
             f"{sp['ckpt_equal']} on {card}")
        for name in ("links", "transition", "coo_device", "nb_fit", "msort",
                     "msort_mask", "sparse_save", "sparse_load"):
            if rr[f"{name}_mat"] != 0:
                _fail(f"[local] rank {r}: the {name} path gathered "
                      f"{rr[f'{name}_mat']} arrays whole ({rr['sites']})")
        for key in ("coo_device_equal", "nb_equal", "nb_off_equal",
                    "msort_equal", "ckpt_equal"):
            if not sp[key]:
                _fail(f"[local] rank {r}: {key} is False")
        for key, n in (("transition_launches", 1),):
            if rr[key] != n:
                _fail(f"[local] rank {r}: {key} {rr[key]}, want {n}")
        for key, n in (("coo_device_launches", 1), ("nb_launches", 1),
                       ("load_launches", 1)):
            if sp[key] != n:
                _fail(f"[local] rank {r}: {key} {sp[key]}, want {n}")
        if sp["nb_reduces"] != 1 or sp["nb_reduce_recv"] != nb_bytes:
            _fail(f"[local] rank {r}: the NB fit made {sp['nb_reduces']} "
                  f"all-reduces receiving {sp['nb_reduce_recv']} bytes, "
                  f"want one of {nb_bytes}")
        if rr["nb_fit_recv"] > 2 * nb_bytes:
            _fail(f"[local] rank {r}: the NB fit received "
                  f"{rr['nb_fit_recv']} bytes in all (limit twice its "
                  f"table, {2 * nb_bytes})")
        if [k for k in sp["nb_decisions"] if "/gather/" in k]:
            _fail(f"[local] rank {r}: the NB fit was not proven: "
                  f"{sp['nb_decisions']}")
        if rr["nb_fit_off_mat"] < 1:
            _fail(f"[local] rank {r}: the NB fit with its rule off gathered "
                  f"nothing: the arm did not run the old path")


def _sort_scratch(dev, r: int, n: int) -> float:
    """Bytes a stable torch.sort of int64 keys (with its int64 indices)
    holds per element beyond its input and outputs, at a size the
    batched sort's merge sorts, (R, p * m) (``ops/sort.SORT_SCRATCH``)."""
    keys = torch.randint(0, 2 ** 40, (r, n), device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = torch.sort(keys, dim=-1, stable=True)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - base - 16 * keys.numel()
    del out, keys
    return extra / (r * n)


def _local_rules(st, path, dev, mesh, workdir: str) -> dict:
    """The local rules at full width on this rank: each case's one-process
    result on a logical mesh of the group's shape first (from the same
    whole inputs), and for a case on a kernel's path the same run with
    ``native_kernels=off`` (the kernels' plain versions); then the
    group's walk measured against the plan's peak_bytes_card
    (``memory.validate_plan``), then the evaluation: its gathers, its
    kernel launches, and the rank's block against the same block of the
    one-process results (bit for bit, or the relative error). The sort
    and the histogram run at a second size as well, so that the card
    model's constants are held where they were not measured."""
    import torch.nn.functional as F  # noqa: F401 - _vgg_float64
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.expr import base
    from spartan_tpu_torch.kernels import exchange as kx
    from spartan_tpu_torch.kernels import histogram as kh
    from spartan_tpu_torch.kernels import stencil as kst
    from spartan_tpu_torch.resilience import memory

    half = (LOCAL_BSORT[0], LOCAL_BSORT[1] // 2)
    out = {"sort_scratch": _sort_scratch(dev, *LOCAL_BSORT),
           "sort_scratch_half": _sort_scratch(dev, *half)}
    gen = torch.Generator(device=dev)
    # the one-process run: the logical mesh of the group's shape, whose
    # programs add in the group's order (the blocked scan)
    one = st.build_mesh((mesh.shape["x"], mesh.shape["y"]), dev)
    rows, cols = st.Tiling(("x", None)), st.Tiling((None, "x"))
    hx = st.Tiling((None, "x", None, None))
    n = STRUCT_N

    def counted():
        return (kx.LAUNCHES["partition_pack"], kh.LAUNCHES["bincount_block"],
                kst.LAUNCHES["conv_block"])

    def one_run(make, leaves):
        with st.use_mesh(one):
            return make(*[st.as_expr(from_tensor(w)) for w, _ in
                          leaves]).evaluate().local

    def case(name, make, leaves, tol=None, ref=None, compare=None,
             plain=None, keep=False):
        """``make(*exprs)`` over ``leaves`` (whole tensor, tiling); with
        ``compare(block, extent)`` the error is its answer. ``plain``
        ("equal", or "close": [stencil]'s rtol 1e-4 plus an atol of 1e-6
        of the largest output) holds the block against the plain
        versions' run as well. With ``keep`` it returns the group's
        result and the one-process result."""
        if ref is None and compare is None:
            ref = one_run(make, leaves)
        plain_ref = None
        if plain is not None:
            prev = st.FLAGS.native_kernels
            st.FLAGS.native_kernels = "off"
            try:
                plain_ref = one_run(make, leaves)
            finally:
                st.FLAGS.native_kernels = prev
        xs = [st.as_expr(from_tensor(w, tiling=t)) for w, t in leaves]
        in_bytes = sum(w.numel() * w.element_size() for w, _ in leaves)
        del leaves[:]
        expr = make(*xs)
        plan = _plan_of(st, expr)
        val = memory.validate_plan(plan)
        k0 = counted()
        got = path("r_" + name, lambda: make(*xs).evaluate())
        torch.cuda.synchronize()
        k1 = counted()
        ext = got.tiling.block_extent(got.shape, mesh)
        if compare is not None:
            err = compare(got.local, ext)
            want = None
        else:
            want = ref[ext.to_slice()] if ref.shape == tuple(got.shape) \
                else ref
        if compare is not None:
            pass
        elif tol is None:
            err = 0.0 if torch.equal(got.local, want) else float("inf")
        else:
            d = (got.local.double() - want.double()).abs().max()
            err = float(d / want.double().abs().max().clamp_min(1e-30))
        plain_err = None
        if plain_ref is not None:
            pw = plain_ref[ext.to_slice()]
            if plain == "equal":
                plain_err = 0.0 if torch.equal(got.local, pw) \
                    else float("inf")
            else:  # the count of elements outside the rule
                atol = 1e-6 * float(plain_ref.abs().max())
                plain_err = float(((got.local - pw).abs()
                                   > 1e-4 * pw.abs() + atol).sum())
            del pw
        rec = {"err": err, "tol": tol, "in_bytes": in_bytes,
               "plain": plain, "plain_err": plain_err,
               "out_bytes": int(np.prod(got.shape))
               * got.local.element_size(),
               "measured": val["measured_peak_bytes"],
               "predicted": val["predicted_bytes"],
               "launches": [b - a for a, b in zip(k0, k1)],
               "ms": _wall_ms(lambda: make(*xs).evaluate(), reps=2)}
        out[name] = rec
        if keep:
            return got, ref
        del got, ref, want, xs, expr, plan, plain_ref
        torch.cuda.empty_cache()

    def rand(*shape, seed):
        gen.manual_seed(seed)
        return torch.rand(shape, generator=gen, device=dev)

    case("transpose", lambda x: x.T, [(rand(n, n, seed=41), rows)])
    case("reshape", lambda x: st.reshape(x, (n // 2, 2 * n)),
         [(rand(n, n, seed=42), rows)])
    case("ravel", lambda x: st.ravel(x), [(rand(n, n, seed=43), cols)])
    case("concatenate_untiled", lambda x, y: st.concatenate([x, y], 1),
         [(rand(n, n, seed=44), rows), (rand(n, n, seed=45), rows)])

    def concat_rows(x, y):
        e = st.concatenate([x, y], 0)
        e._forced_tiling = rows  # the tiled axis stays tiled
        return e

    case("concatenate_tiled", concat_rows,
         [(rand(n, n, seed=46), rows), (rand(n, n, seed=47), rows)])
    case("strided_slice", lambda x: x[::2, ::-3],
         [(rand(n, n, seed=48), rows)])
    case("outer", lambda a, b: st.outer(a, b),
         [(rand(OUTER_N, seed=49), st.Tiling(("x",))),
          (rand(OUTER_N, seed=50), st.Tiling(("x",)))])
    case("cumsum", lambda x: st.cumsum(x, 0), [(rand(n, n, seed=51), rows)],
         tol=1e-6)
    case("sort", lambda x: st.sort(x), [(rand(*LOCAL_BSORT, seed=52), cols)],
         plain="equal")
    case("argsort", lambda x: st.argsort(x),
         [(rand(*LOCAL_BSORT, seed=53), cols)], plain="equal")
    case("histogram", lambda x: st.histogram(x, HIST_BINS)[0],
         [(rand(n, n, seed=54), rows)], plain="equal")
    # the card model at a second size
    case("sort_half", lambda x: st.sort(x), [(rand(*half, seed=55), cols)],
         plain="equal")
    case("histogram_half", lambda x: st.histogram(x, HIST_BINS)[0],
         [(rand(n, n // 2, seed=56), rows)], plain="equal")
    xv, params = _vgg_params(dev)
    with torch.no_grad():
        act = torch.relu(torch.randn((VGG_N, VGG_HW, VGG_HW, VGG_WIDTHS[-1]),
                                     generator=gen, device=dev))
    case("maxpool", lambda x: st.maxpool(x, 2), [(act, hx)])
    with torch.no_grad():
        act = torch.relu(torch.randn((VGG_N, VGG_HW, VGG_HW, VGG_WIDTHS[-1]),
                                     generator=gen, device=dev))
    case("avgpool", lambda x: st.avgpool(x, 3, 1, "SAME"), [(act, hx)],
         tol=1e-6)
    del act
    ref = _vgg_float64(xv[:2], params)

    def against_f64(blk, ext):
        """The rank's rows of the first two images against the float64
        forward's (the [spmd] check: the largest absolute difference)."""
        rows_ = ref[:, ext.ul[1]:ext.lr[1]]
        return float((blk[:2].double() - rows_).abs().max())

    case("vgg", lambda x, *p: vgg_block1(st, x, list(zip(p[::2], p[1::2]))),
         [(xv, hx)] + [(a, None) for wb in params for a in wb], tol=1e-5,
         compare=against_f64, plain="close")
    del xv, params, ref
    out["fills"] = _local_fills(st, path, dev, mesh, one, case, rand)
    out["part"] = _local_partition(st, path, dev, case, rand, workdir)
    return out


def _local_fills_report(res, card: str) -> None:
    """[local]'s fills beside the whole-array path each rule replaced,
    and their checks: the uniform draw's bits on the host, 20 row-1
    launches a rank on the group-drawn points with the one-process
    run's centers, the window's DistArray pushes gathering nothing."""
    for r, rr in enumerate(res):
        f = rr["rules"]["fills"]
        rules = rr["rules"]
        for name, (peak, ms) in f["whole_path"].items():
            if name == "sw":
                now = (f"peak {f['sw']['peak']} bytes (card model "
                       f"{f['sw']['pred']:.0f}; worst push off its model "
                       f"by {f['sw']['worst']:.4f}), {f['sw']['ms']:.2f} "
                       f"ms a push, received {f['sw']['recv']} bytes")
            else:
                now = (f"peak {rules[name]['measured']} bytes, "
                       f"{rules[name]['ms']:.2f} ms, received "
                       f"{rr[f'r_{name}_recv']} bytes")
            _say(f"[local] rank {r}: {name}: local rule {now}; the "
                 f"whole-array path (the rule switched off, in this run, "
                 f"its gathers counted) peak {peak} bytes, {ms:.2f} ms "
                 f"(host clock; two processes time-slice one card) on "
                 f"{card}")
        _say(f"[local] rank {r}: st.rand of its {LOCAL_KM_N // GROUP_RANKS}"
             f"x{KM_D} block {rules['rand']['ms']:.2f} ms (counter-based, "
             f"Philox4x32-10); torch.rand of the same block "
             f"{f['torch_rand_ms']:.2f} ms; host draw of its first and "
             f"last 4096 rows bit-equal: {f['rand_host_equal']}; config-3 "
             f"k-means on the drawn points: {f['km_launches']} launches, "
             f"centers bit-equal to the one-process sharded run: "
             f"{f['km_equal']} (max |diff| {f['km_diff']:.3g}); window "
             f"{SW_WINDOW}x{SW_DIM}: {f['sw']['pushes']} DistArray pushes "
             f"of {SW_PUSH} rows, {f['sw']['gathers']} gathered whole, "
             f"received {f['sw']['recv']} bytes, bit-equal to the "
             f"one-process window: {f['sw']['equal']} on {card}")
        if not f["rand_host_equal"]:
            _fail(f"[local] rank {r}: the uniform draw's bits differ "
                  f"between the card and the host")
        if f["km_launches"] != KM_ITERS or rr["r_fill_km_mat"] != 0:
            _fail(f"[local] rank {r}: k-means on the drawn points launched "
                  f"{f['km_launches']} times (want {KM_ITERS}) and "
                  f"gathered {rr['r_fill_km_mat']} arrays whole")
        if not f["km_equal"]:
            _fail(f"[local] rank {r}: k-means centers on the drawn points "
                  f"differ from the one-process run by {f['km_diff']}")
        if f["sw"]["worst"] > LOCAL_MEM_TOL:
            _fail(f"[local] rank {r}: a window push's peak is off its card "
                  f"model by {f['sw']['worst']:.4f} (limit {LOCAL_MEM_TOL})")
        if f["sw"]["gathers"] != 0 or not f["sw"]["equal"]:
            _fail(f"[local] rank {r}: the window's DistArray pushes "
                  f"gathered {f['sw']['gathers']} arrays whole, bit-equal "
                  f"{f['sw']['equal']}")


def _whole_path(dev, cls, fn) -> tuple:
    """(peak bytes over the resident ones, best ms) of ``fn()`` with
    ``cls``'s local rule switched off: each rank makes or reads the
    whole array and keeps its block, as the port did before the rule."""
    saved = cls._lower_local
    cls._lower_local = None
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        return peak, _wall_ms(fn, reps=1)
    finally:
        cls._lower_local = saved
        torch.cuda.empty_cache()


def _local_fills(st, path, dev, mesh, one, case, rand) -> dict:
    """[local]'s creation, random fills, fancy indexing and region
    writes on this rank (``case`` records each one as the other rules),
    beside the whole-array path they replace; then config-3 k-means on
    the group-drawn points and the sliding window fed DistArray batches.
    Returns the figures that are no ``case``."""
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.array.extent import TileExtent
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.examples import streaming
    from spartan_tpu_torch.expr.assign import WriteExpr
    from spartan_tpu_torch.expr.filter import GatherExpr
    from spartan_tpu_torch.expr.ndarray import CreateExpr, RandomExpr
    from spartan_tpu_torch.kernels import kmeans as kk
    from spartan_tpu_torch.obs.metrics import collective_totals as tot
    from spartan_tpu_torch.utils import philox

    n, rows = STRUCT_N, st.Tiling(("x", None))
    res = {"whole_path": {}}

    def draw():
        return st.rand(LOCAL_KM_N, KM_D, seed=FILL_SEED, tiling=rows)

    pts, pts_ref = case("rand", draw, [], keep=True)
    res["whole_path"]["rand"] = _whole_path(
        dev, RandomExpr, lambda: draw().evaluate())
    # the uniform bits do not depend on the device: the rank's first and
    # last 4096 rows drawn on the host
    ext = pts.tiling.block_extent(pts.shape, mesh)
    same = []
    for a, b in ((ext.ul[0], ext.ul[0] + 4096), (ext.lr[0] - 4096,
                                                 ext.lr[0])):
        host = philox.draw("uniform", FILL_SEED, pts.shape,
                           TileExtent((a, 0), (b, KM_D), pts.shape),
                           torch.float32, "cpu")
        same.append(torch.equal(host, pts.local[a - ext.ul[0]:
                                                b - ext.ul[0]].cpu()))
    res["rand_host_equal"] = all(same)
    # torch.rand of the rank's block, for scale
    res["torch_rand_ms"] = _wall_ms(
        lambda: torch.rand(tuple(ext.shape), device=dev), reps=2)
    # config-3 k-means on the drawn points: one launch a rank an
    # iteration; the one-process run is the logical mesh's sharded pass
    # (a launch per row block, the blocks' sums added), so the centers
    # are the same bits
    c0 = pts_ref[:KM_K].clone()
    c = c0
    for _ in range(KM_ITERS):
        sums, cnt = kk.assign_accumulate_sharded(pts_ref, c, KM_K, mesh=one)
        c = sums / torch.clamp_min(cnt, 1.0)[:, None]
    one_centers = c.cpu().numpy()
    pe = st.as_expr(pts)
    k0 = kk.LAUNCHES
    got = path("r_fill_km", lambda: st.loop(
        KM_ITERS, lambda cc: km.kmeans_step(pe, cc, KM_K),
        st.from_numpy(c0.cpu().numpy())).glom())
    res["km_launches"] = kk.LAUNCHES - k0
    res["km_equal"] = bool(np.array_equal(got, one_centers))
    res["km_diff"] = float(np.abs(got - one_centers).max())
    del pe, got
    case("randn", lambda: st.randn(LOCAL_KM_N, KM_D, seed=FILL_SEED + 1,
                                   tiling=rows), [])
    case("zeros", lambda: st.zeros((n, n), tiling=rows), [])
    res["whole_path"]["zeros"] = _whole_path(
        dev, CreateExpr, lambda: st.zeros((n, n), tiling=rows).evaluate())
    case("arange", lambda: st.arange(n * n, tiling=st.Tiling(("x",))), [])
    case("eye", lambda: st.eye(n), [])
    # a sorted sample of the points' rows (the leaf: the one-process
    # draw, of which each rank keeps its block: the group's bits)
    idx = np.sort(np.random.RandomState(FILL_SEED).choice(
        LOCAL_KM_N, FILL_SAMPLE, replace=False))
    case("gather", lambda x: x[idx], [(pts_ref, rows)])
    xg = st.as_expr(from_tensor(pts_ref, tiling=rows))
    res["whole_path"]["gather"] = _whole_path(
        dev, GatherExpr, lambda: xg[idx].evaluate())
    del xg, pts, pts_ref
    torch.cuda.empty_cache()
    region = (slice(FILL_ROWS[0], FILL_ROWS[1]), slice(0, n))
    src_rows = FILL_ROWS[1] - FILL_ROWS[0]
    dst_t = rand(n, n, seed=FILL_SEED + 2)
    src_t = rand(src_rows, n, seed=FILL_SEED + 3)
    de = st.as_expr(from_tensor(dst_t, tiling=rows))
    ve = st.as_expr(from_tensor(src_t, tiling=rows))
    case("assign", lambda d, v: st.assign(d, region, v),
         [(dst_t, rows), (src_t, rows)])
    res["whole_path"]["assign"] = _whole_path(
        dev, WriteExpr, lambda: st.assign(de, region, ve).evaluate())
    del dst_t, src_t, de, ve
    torch.cuda.empty_cache()

    # the sliding window fed DistArray batches drawn on the group: each
    # rank receives only the rows its block of the window takes
    seeds = [FILL_SEED + 10 + i for i in range(SW_PUSHES)]
    with st.use_mesh(one):
        sw1 = streaming.SlidingWindowStats(SW_WINDOW, SW_DIM)
        for sd in seeds:
            sw1.push(st.randn(SW_PUSH, SW_DIM, seed=sd).evaluate())
        ref_buf = sw1.buf.local
        del sw1
    sw = streaming.SlidingWindowStats(SW_WINDOW, SW_DIM)
    batches = [st.randn(SW_PUSH, SW_DIM, seed=sd).evaluate() for sd in seeds]
    m0, r0 = (tot()["group_materialize_calls"], tot()["group_received_bytes"])
    times, peaks, preds = [], [], []
    for b in batches:
        # what the push's update should hold beside the window and the
        # batch (``DistArray.update_card_bytes``)
        preds.append(sw.buf.update_card_bytes(
            (slice(sw._head, sw._head + SW_PUSH), slice(0, SW_DIM)), b))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        sw.push(b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        peaks.append(torch.cuda.max_memory_allocated(dev) - base)
    res["sw"] = {
        "pushes": len(batches),
        "gathers": tot()["group_materialize_calls"] - m0,
        "recv": tot()["group_received_bytes"] - r0,
        "ms": float(np.median(times)), "peak": int(max(peaks)),
        "pred": float(max(preds)),
        "worst": float(max(abs(m / p - 1.0) for m, p in zip(peaks, preds))),
        "equal": bool(torch.equal(sw.buf.local, ref_buf[
            sw.buf.block_extent().to_slice()]))}
    # the path before this rule: each batch gathered whole on every rank
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    for b in batches[:4]:
        sw.push(b.materialize("update"))
    torch.cuda.synchronize()
    res["whole_path"]["sw"] = (
        torch.cuda.max_memory_allocated(dev) - base,
        (time.perf_counter() - t) * 1e3 / 4)
    del sw, batches, ref_buf
    torch.cuda.empty_cache()
    return res


def _local_partition(st, path, dev, case, rand, workdir: str) -> dict:
    """[local]'s user functions on this rank (``expr/partition.py``):
    config 4's logistic regression (10,000,000 x 32 f32, 10 iterations
    through ``st.loop``), linear and SVM gradients and the logistic
    predict on the same X, a fuzzy k-means step and ``kmeans_step``'s
    map2 form (``native_kernels=off``) on config 3's points, and a user
    elementwise map over 8192^2, the functions GSPMD keeps split (the
    trace, a flip and a whole-shape constant of 8192^2, centering the
    same X; ALS and the masked medians: ``_local_partition_gspmd``);
    each a ``case`` (0 gathered, its peak against ``peak_bytes_card``,
    its block against the one-process run), beside the path with its
    rule switched off (the counted gather) and the decisions it
    counted. Returns the figures that are no ``case``."""
    from spartan_tpu_torch.expr import builtins as bi
    from spartan_tpu_torch.expr.map import MapExpr
    from spartan_tpu_torch.expr.map2 import Map2Expr
    from spartan_tpu_torch.examples import fuzzy_kmeans, regression, svm
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.obs.metrics import partition_decisions

    from spartan_tpu_torch.array.distarray import from_tensor

    res = {"whole_path": {}, "decisions": {}}
    rows, rep1 = st.Tiling(("x", None)), st.Tiling((None,))
    n, d, iters = EX_LR_N, EX_LR_D, EX_LR_ITERS
    gen = torch.Generator(device=dev)
    gen.manual_seed(PART_SEED)
    x = torch.rand((n, d), generator=gen, device=dev)
    w_true = torch.randn((d,), generator=gen, device=dev)
    y01 = ((x - 0.5) @ w_true > 0).float()

    def logreg(k):
        def make(xe, ye):
            return st.loop(k, lambda w: w - 0.1 * regression.logistic_grad(
                xe, ye, w), bi.zeros((d,), np.float32, tiling=rep1))
        return make

    def decided(name, fn):
        """``fn()`` with the partition decisions it counted."""
        before = partition_decisions()
        got = fn()
        res["decisions"][name] = {
            "/".join(k): v - before.get(k, 0)
            for k, v in partition_decisions().items()
            if v != before.get(k, 0)}
        return got

    def off(name, cls, make, leaves):
        """The rule switched off (``cls``'s local rule): the peak over the
        resident bytes and the ms of one walk, the arrays gathered whole
        and the bytes received."""
        xs = [st.as_expr(from_tensor(w, tiling=t)) for w, t in leaves]
        saved = cls._lower_local
        cls._lower_local = None
        try:
            make(*xs).evaluate()  # its plan, built
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t = time.perf_counter()
            path("off_" + name, lambda: make(*xs).evaluate())
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            peak = torch.cuda.max_memory_allocated(dev) - base
        finally:
            cls._lower_local = saved
        res["whole_path"][name] = (peak, ms)
        del xs
        torch.cuda.empty_cache()

    got, _ = decided("logreg", lambda: case(
        "logreg", logreg(iters), [(x, rows), (y01, st.Tiling(("x",)))],
        tol=1e-5, keep=True))
    res["logreg_w"] = np.asarray(got.glom()).tolist()
    del got
    off("logreg", Map2Expr, logreg(1), [(x, rows), (y01, st.Tiling(("x",)))])
    if st.get_mesh().rank == 0:
        ref = _logreg_f64(x.cpu().numpy().astype(np.float64),
                          y01.cpu().numpy().astype(np.float64), iters, 0.1)
        res["logreg_f64_err"] = _rel(np.asarray(res["logreg_w"]), ref)
    w0 = (0.01 * torch.randn((d,), generator=gen, device=dev))
    y_lin = x @ w_true
    ypm = 2.0 * y01 - 1.0
    for name, make, y in (
            ("linear_grad", lambda xe, ye, we: regression.linear_grad(
                xe, ye, we), y_lin),
            ("svm_grad", lambda xe, ye, we: svm.svm_grad(xe, ye, we, 1e-3),
             ypm)):
        leaves = [(x, rows), (y, st.Tiling(("x",))), (w0, rep1)]
        decided(name, lambda: case(name, make, list(leaves), tol=1e-5))
        off(name, Map2Expr, make, leaves)
    predict = (lambda xe, we: regression.predict_logistic(xe, we))
    decided("predict_logistic", lambda: case(
        "predict_logistic", predict, [(x, rows), (w0, rep1)]))
    off("predict_logistic", Map2Expr, predict, [(x, rows), (w0, rep1)])
    # centering config 4's X: its mean over the rows is the blocks' sums
    # all-reduced, then divided
    center = (lambda xe: st.map2([xe], lambda t: t - t.mean(0)))
    decided("mean_center", lambda: case("mean_center", center, [(x, rows)],
                                        tol=1e-6))
    off("mean_center", Map2Expr, center, [(x, rows)])
    del x, y01, y_lin, ypm, w_true
    torch.cuda.empty_cache()
    # config 3's points: a fuzzy step and the map2 form of k-means
    pts_np = np.load(os.path.join(workdir, "km_points.npy"), mmap_mode="r")
    c0_np = np.load(os.path.join(workdir, "km_c0.npy"))
    pts = torch.from_numpy(np.array(pts_np)).to(dev)
    c0 = torch.from_numpy(c0_np).to(dev)
    crep = st.Tiling((None, None))
    fz = (lambda p, c: fuzzy_kmeans.fuzzy_kmeans_step(p, c, KM_K, PART_FZ_M))
    # the step in float64 on the card: the memberships divide by d2 =
    # |p|^2 - 2 p.c + |c|^2, which cancels on clustered points, so a
    # float32 step moves with the bits of p @ c^T; the group and the
    # one-process run are each held against this
    acc = fuzzy_kmeans._fuzzy_kern(pts.double(), c0.double(), PART_FZ_M)
    f64 = acc[:, :-1] / torch.clamp_min(acc[:, -1:], 1e-12)
    del acc
    grid = st.get_mesh().shape
    with st.use_mesh(st.build_mesh((grid["x"], grid["y"]), dev)):
        one = fz(st.as_expr(from_tensor(pts)),
                 st.as_expr(from_tensor(c0))).evaluate().local.double()
    res["fuzzy_one_f64"] = float((one - f64).abs().max() / f64.abs().max())
    got, _ = decided("fuzzy_kmeans_step", lambda: case(
        "fuzzy_kmeans_step", fz, [(pts, rows), (c0, crep)], tol=1e-4,
        compare=lambda blk, ext: float(
            (blk.double() - f64[ext.to_slice()]).abs().max()
            / f64.abs().max()), keep=True))
    ext = got.tiling.block_extent(got.shape, st.get_mesh())
    res["fuzzy_one_group"] = float(
        (got.local.double() - one[ext.to_slice()]).abs().max()
        / one.abs().max())
    del got, one, f64
    off("fuzzy_kmeans_step", Map2Expr, fz, [(pts, rows), (c0, crep)])
    kmf = (lambda p, c: km.kmeans_step(p, c, KM_K))
    prev = st.FLAGS.native_kernels
    st.FLAGS.native_kernels = "off"  # the map2 form, not the fused pass
    try:
        decided("kmeans_step_map2", lambda: case(
            "kmeans_step_map2", kmf, [(pts, rows), (c0, crep)], tol=1e-5))
        off("kmeans_step_map2", Map2Expr, kmf, [(pts, rows), (c0, crep)])
    finally:
        st.FLAGS.native_kernels = prev
    del pts, c0
    torch.cuda.empty_cache()
    # a user elementwise map over 8192^2
    m = STRUCT_N
    a, b = rand(m, m, seed=PART_SEED + 1), rand(m, m, seed=PART_SEED + 2)
    umap = (lambda xe, ye: st.map(
        lambda u, v: torch.where(u > v, u - v, 0.5 * v), xe, ye))
    decided("map_where", lambda: case("map_where", umap,
                                      [(a, rows), (b, rows)]))
    off("map_where", MapExpr, umap, [(a, rows), (b, rows)])
    del b
    # the trace (the diagonal's elements in each rank's rows, one
    # all-reduce), a flip (the mirrored rows moved), a whole-shape
    # constant in a map (each block divided by the whole row count)
    for name, cls, make, tol in (
            ("trace", Map2Expr, lambda xe: st.trace(xe), 1e-6),
            ("flip", Map2Expr, lambda xe: st.map2([xe],
                                                  lambda t: t.flip(0)), None),
            ("map_shape", MapExpr,
             lambda xe: st.map(lambda t: t / t.shape[0], xe), None)):
        decided(name, lambda: case(name, make, [(a, rows)], tol=tol))
        off(name, cls, make, [(a, rows)])
    del a
    torch.cuda.empty_cache()
    res.update(_local_partition_gspmd(st, path, dev, case, decided, off))
    return res


def _local_partition_gspmd(st, path, dev, case, decided, off) -> dict:
    """[local]'s ALS and masked medians on this rank (the functions GSPMD
    keeps split that the first proof gathered): ALS's half-step at
    MovieLens-1M's shape as a ``case`` beside its rule-off arm, then
    ``als`` itself (LOCAL_ALS_ITERS iterations) against float64 and
    the one-process run, with the bytes it received; the masked median
    of [masked]'s sensor matrix along each axis, bit for bit against
    the one-process run."""
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.array.masked import MaskedDistArray
    from spartan_tpu_torch.examples import als
    from spartan_tpu_torch.expr.map import MapExpr
    from spartan_tpu_torch.expr.map2 import Map2Expr
    from spartan_tpu_torch.obs.metrics import partition_decisions

    out = {}
    mesh = st.get_mesh()
    grid = (mesh.shape["x"], mesh.shape["y"])
    rows, crep = st.Tiling(("x", None)), st.Tiling((None, None))
    k, iters, reg = EX_ML_K, LOCAL_ALS_ITERS, LOCAL_ALS_REG
    dense_np = _movielens(LOCAL_ML_USERS, LOCAL_ML_ITEMS,
                          LOCAL_ML_RATINGS)[3]
    dense = torch.from_numpy(dense_np).to(dev)
    v0 = torch.from_numpy((np.random.RandomState(0).rand(
        LOCAL_ML_ITEMS, k).astype(np.float32) * 0.1)).to(dev)
    half = (lambda re, ve: st.map2([re, ve], als._solve_side,
                                   fn_kw={"reg": reg}, out_tiling=rows))
    # a GEMM of a row block need not sum as the whole's rows do on the
    # card (cuBLAS picks its kernel by the row count): within 1e-5
    decided("als_half", lambda: case("als_half", half,
                                     [(dense, rows), (v0, crep)], tol=1e-5))
    off("als_half", Map2Expr, half, [(dense, rows), (v0, crep)])
    del v0

    def run_als():
        r = from_tensor(dense, tiling=rows)
        t0 = time.perf_counter()
        got = als.als(r, k=k, num_iter=iters, reg=reg)
        torch.cuda.synchronize()
        return got, (time.perf_counter() - t0) * 1e3

    before = partition_decisions()
    (u, v), ms = path("als", run_als)
    out["als_decisions"] = {"/".join(key): val - before.get(key, 0)
                            for key, val in partition_decisions().items()
                            if val != before.get(key, 0)}
    with st.use_mesh(st.build_mesh(grid, dev)):
        u1, v1 = als.als(from_tensor(dense), k=k, num_iter=iters, reg=reg)
    out["als"] = {"ms": ms, "u_one": _rel(u, u1), "v_one": _rel(v, v1),
                  "u": np.asarray(u).tolist()[:4]}
    if mesh.rank == 0:
        u64, v64 = _als_f64(dense, k, iters, reg, 0, dev)
        out["als"].update(u_f64=_rel(u, u64), v_f64=_rel(v, v64))
        del u64, v64
    del dense, u1, v1
    torch.cuda.empty_cache()

    # the masked median of [masked]'s sensor matrix along each axis: the
    # rows split over the ranks; along the split axis the operands move
    # so that it is whole (an all-to-all of half of each block)
    gen = torch.Generator(device=dev)
    gen.manual_seed(MASK_SEED)
    shape = (MASK_ROWS, MASK_COLS)
    md = torch.rand(shape, generator=gen, device=dev)
    md[torch.rand(shape, generator=gen, device=dev) < MASK_NAN] = np.nan
    mm = torch.rand(shape, generator=gen, device=dev) < MASK_WHERE
    for ax in (1, 0):
        name = f"median_ax{ax}"

        def med(de, me, ax=ax):
            return st.median(MaskedDistArray(de, me), axis=ax)

        with st.use_mesh(st.build_mesh(grid, dev)):
            one = med(st.as_expr(from_tensor(md)),
                      st.as_expr(from_tensor(mm))).evaluate().local

        def bits(blk, ext, one=one):
            return 0.0 if _bits_equal(blk, one[ext.to_slice()]) \
                else float("inf")

        decided(name, lambda: case(name, med, [(md, rows), (mm, rows)],
                                   compare=bits))
        off(name, MapExpr, med, [(md, rows), (mm, rows)])
        del one
    del md, mm
    torch.cuda.empty_cache()
    return out


def _local_partition_report(res, card: str) -> None:
    """[local]'s user functions: each proven path beside its rule-off arm
    and the decisions counted; config 4's weights against float64."""
    per_iter = {"logreg": EX_LR_ITERS}
    for r, rr in enumerate(res):
        f = rr["rules"]["part"]
        rules = rr["rules"]
        for name, (peak, ms) in f["whole_path"].items():
            rec = rules[name]
            k = per_iter.get(name, 1)
            recv = rr[f"r_{name}_recv"]
            _say(f"[local] rank {r}: {name}: proven ({f['decisions'][name]}"
                 f" over its walks): gathered whole "
                 f"{rr[f'r_{name}_mat']}, received {recv} bytes "
                 f"({recv / k:.0f} an iteration), measured peak "
                 f"{rec['measured']} bytes against peak_bytes_card "
                 f"{rec['predicted']} (ratio "
                 f"{rec['predicted'] / rec['measured']:.4f}), "
                 f"{rec['ms'] / k:.3f} ms an iteration, err {rec['err']:.3g}"
                 f" (limit {rec['tol'] or 0.0:g}); the rule switched off "
                 f"(one iteration, in this run): gathered whole "
                 f"{rr[f'off_{name}_mat']}, received "
                 f"{rr[f'off_{name}_recv']} bytes, peak {peak} bytes, "
                 f"{ms:.2f} ms (host clock; two processes time-slice one "
                 f"card) on {card}")
            if rr[f"off_{name}_mat"] < 1:
                _fail(f"[local] rank {r}: {name} with its rule off gathered "
                      f"nothing: the arm did not run the old path")
            bad = [key for key in f["decisions"][name]
                   if "/gather/" in key]
            if bad:
                _fail(f"[local] rank {r}: {name} was not proven: {bad}")
        recv = rr["r_logreg_recv"] / EX_LR_ITERS
        if recv > 1024:
            _fail(f"[local] rank {r}: config-4 logreg received {recv:.0f} "
                  f"bytes an iteration (limit 1024)")
    for r, rr in enumerate(res):
        f = rr["rules"]["part"]
        grp = rr["rules"]["fuzzy_kmeans_step"]["err"]
        _say(f"[local] rank {r}: fuzzy_kmeans_step against the same step "
             f"in float64 on the card: the group {grp:.3g} (rtol 1e-4), "
             f"the one-process run {f['fuzzy_one_f64']:.3g}; "
             f"the group against the one-process run "
             f"{f['fuzzy_one_group']:.3g} (d2 = |p|^2 - 2 p.c + |c|^2 "
             f"cancels on clustered points) on {card}")
    _local_gspmd_report(res, card)
    err = res[0]["rules"]["part"]["logreg_f64_err"]
    _say(f"[local] config-4 logreg on the group ({EX_LR_N}x{EX_LR_D}, "
         f"{EX_LR_ITERS} iterations through st.loop): weights vs the same "
         f"steps in float64 numpy: normwise rel err {err:.3g} (rtol 1e-4) "
         f"on {card}")
    if not err <= 1e-4:
        _fail(f"[local] config-4 logreg on the group differs from float64 "
              f"by {err}")
    if len({str(rr["rules"]["part"]["logreg_w"]) for rr in res}) != 1:
        _fail("[local] the ranks' logreg weights differ")


def _als_recv_bytes(rank: int) -> int:
    """The bytes a rank of the group receives in ``als``: the transposed
    ratings laid out by their own rows once (its block's other half),
    then each iteration's glom of u and of v (the other ranks' rows)."""
    def own(n: int) -> int:
        return np.array_split(np.arange(n), GROUP_RANKS)[rank].size

    m, n, k = LOCAL_ML_USERS, LOCAL_ML_ITEMS, EX_ML_K
    retile = own(n) * (m - own(m)) * 4
    return retile + LOCAL_ALS_ITERS * ((m - own(m)) + (n - own(n))) * k * 4


def _local_gspmd_report(res, card: str) -> None:
    """[local]'s functions GSPMD keeps split: the bytes each case
    received against what the rule moves (nothing but a few bytes of
    all-reduce, a flip's mirrored block, half of the median's operands
    along the split axis), ALS against float64 and the one-process
    run."""
    blk = STRUCT_N // GROUP_RANKS * STRUCT_N * 4
    half = (MASK_ROWS // GROUP_RANKS) * (MASK_COLS // GROUP_RANKS) * 5
    want = {"trace": (0, 1024), "mean_center": (0, 1024),
            "map_shape": (0, 0), "als_half": (0, 0), "median_ax1": (0, 0),
            "flip": (blk, blk + 1024), "median_ax0": (half, half + 1024)}
    for r, rr in enumerate(res):
        for name, (lo, hi) in want.items():
            got = rr[f"r_{name}_recv"]
            _say(f"[local] rank {r}: {name}: received {got} bytes (want "
                 f"{lo}..{hi}) on {card}")
            if not lo <= got <= hi:
                _fail(f"[local] rank {r}: {name} received {got} bytes, "
                      f"want {lo}..{hi}")
        a = rr["rules"]["part"]["als"]
        recv, want_als = rr["als_recv"], _als_recv_bytes(r)
        f64 = (f"u {a['u_f64']:.3g}, v {a['v_f64']:.3g}" if "u_f64" in a
               else "computed on rank 0")
        _say(f"[local] rank {r}: als {LOCAL_ML_USERS} x {LOCAL_ML_ITEMS}, "
             f"{LOCAL_ML_RATINGS} ratings, k = {EX_ML_K}, {LOCAL_ALS_ITERS} "
             f"iterations on the group: {a['ms']:.1f} ms, gathered whole "
             f"{rr['als_mat']}, "
             f"received {recv} bytes (the transposed ratings' one relayout "
             f"and the gloms: {want_als}), decisions "
             f"{rr['rules']['part']['als_decisions']}; normwise rel err "
             f"against float64 on the card: {f64} (rtol 1e-4); against the "
             f"one-process run: u {a['u_one']:.3g}, v {a['v_one']:.3g} "
             f"(rtol 1e-4: a row block's GEMM sums in the order cuBLAS "
             f"picks for its row count) on {card}")
        if rr["als_mat"] != 0 or recv != want_als:
            _fail(f"[local] rank {r}: als gathered {rr['als_mat']} arrays "
                  f"whole and received {recv} bytes (want 0 and "
                  f"{want_als})")
        if any("/gather/" in key for key in
               rr["rules"]["part"]["als_decisions"]):
            _fail(f"[local] rank {r}: als was not proven: "
                  f"{rr['rules']['part']['als_decisions']}")
        if not (a["u_one"] <= 1e-4 and a["v_one"] <= 1e-4):
            _fail(f"[local] rank {r}: als differs from the one-process run "
                  f"by u {a['u_one']}, v {a['v_one']}")
        if "u_f64" in a and not (a["u_f64"] <= 1e-4 and a["v_f64"] <= 1e-4):
            _fail(f"[local] rank {r}: als differs from float64 by u "
                  f"{a['u_f64']}, v {a['v_f64']}")
    if len({str(rr["rules"]["part"]["als"]["u"]) for rr in res}) != 1:
        _fail("[local] the ranks' ALS factors differ")


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
    from spartan_tpu_torch.ops.sort import SORT_SCRATCH

    for rr in res:
        for name, rec in rr["rules"].items():
            if name.startswith("sort_scratch") or name in ("fills", "part"):
                continue
            lim = ("bit-equal" if rec["tol"] is None else
                   f"limit {rec['tol']:g}")
            if rec["plain"] is not None:
                lim += (f"; against the plain versions' run "
                        f"({rec['plain']}): {rec['plain_err']:.3g}")
            _say(f"[local] rank {rr['rank']}: {name}: operands "
                 f"{rec['in_bytes']} bytes, result {rec['out_bytes']} bytes "
                 f"whole; this rank's measured peak {rec['measured']} bytes, "
                 f"peak_bytes_card {rec['predicted']} (ratio "
                 f"{rec['predicted'] / rec['measured']:.4f}); 0 gathered "
                 f"whole; err {rec['err']:.3g} ({lim}); launches "
                 f"(partition_pack, bincount_block, conv_block) "
                 f"{rec['launches']}; {rec['ms']:.2f} ms a walk (host "
                 f"clock; two processes time-slice one card) on {card}")
        _say(f"[local] rank {rr['rank']}: torch.sort of int64 keys held "
             f"{rr['rules']['sort_scratch']:.4f} bytes an element of "
             f"scratch at {LOCAL_BSORT[0]}x{LOCAL_BSORT[1]} and "
             f"{rr['rules']['sort_scratch_half']:.4f} at half the row "
             f"(ops/sort.SORT_SCRATCH = {SORT_SCRATCH}) on {card}")
    # the local rules: no gather, each result within its limit, the
    # kernels' launches on the stored blocks, the card model's peak
    want_launches = {"sort": [1, 0, 0], "argsort": [2, 0, 0],
                     "histogram": [0, 1, 0], "vgg": [0, 0, 2],
                     "sort_half": [1, 0, 0], "histogram_half": [0, 1, 0]}
    for r, rr in enumerate(res):
        scratch = rr["rules"]["sort_scratch"]
        if abs(scratch / SORT_SCRATCH - 1.0) > LOCAL_MEM_TOL:
            _fail(f"[local] rank {r}: torch.sort held {scratch} bytes an "
                  f"element of scratch, ops/sort.SORT_SCRATCH says "
                  f"{SORT_SCRATCH} (limit 1 +- {LOCAL_MEM_TOL})")
        for name, rec in rr["rules"].items():
            if name.startswith("sort_scratch") or name in ("fills", "part"):
                continue
            if rec["plain"] is not None and rec["plain_err"] != 0.0:
                _fail(f"[local] rank {r}: {name} differs from the plain "
                      f"versions' run ({rec['plain']}): {rec['plain_err']}")
            if rr[f"r_{name}_mat"] != 0:
                _fail(f"[local] rank {r}: the {name} path gathered "
                      f"{rr[f'r_{name}_mat']} arrays whole ({rr['sites']})")
            if not rec["err"] <= (rec["tol"] or 0.0):
                _fail(f"[local] rank {r}: {name} differs from the "
                      f"one-process run by {rec['err']} (limit "
                      f"{rec['tol'] or 0.0})")
            if rec["launches"] != want_launches.get(name, [0, 0, 0]):
                _fail(f"[local] rank {r}: {name} launched (partition_pack, "
                      f"bincount_block, conv_block) {rec['launches']}, want "
                      f"{want_launches.get(name, [0, 0, 0])}")
            ratio = rec["predicted"] / rec["measured"]
            if abs(ratio - 1.0) > LOCAL_MEM_TOL:
                _fail(f"[local] rank {r}: {name} peak_bytes_card "
                      f"{rec['predicted']} against a measured peak of "
                      f"{rec['measured']} (ratio {ratio:.4f}, limit 1 +- "
                      f"{LOCAL_MEM_TOL})")
    _local_fills_report(res, card)
    _local_partition_report(res, card)
    _local_sparse_report(res, card)
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
    rules = r0["rules"]
    _say(f"[local] phase {time.perf_counter() - t0:.1f} s on {card}")
    return {"kmeans": r0["km_launches"], "partition_pack": r0["sort_launches"],
            "shard_topk": r0["topk_launches"],
            "windowed_segsum": r0["pagerank_launches"],
            "segment_sum_block": r0["sparse"]["nb_launches"],
            "sparse_partition_pack": r0["transition_launches"]
            + r0["sparse"]["coo_device_launches"]
            + r0["sparse"]["load_launches"],
            "batched_partition_pack": rules["sort"]["launches"][0]
            + rules["argsort"]["launches"][0],
            "bincount_block": rules["histogram"]["launches"][1],
            "conv_block": rules["vgg"]["launches"][2]}


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


def _profile_launches(profile_mod, kk):
    """Wrap the sampled profiler so its walks' k-means launches are
    counted apart: (the counts [samples, launches], the undo)."""
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

    def undo():
        profile_mod._profile_impl = impl

    return sampled, undo


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
        sampled, undo = _profile_launches(profile_mod, kk)
        _reset_counts(kk)
        try:
            got, plan = run(True)
        finally:
            undo()
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
    fetching each, under the caller's mesh (a thread starts on the
    default one); returns the fetched values in the same nesting."""
    import threading

    out = [[None] * len(b) for b in builds]
    futs = [[None] * len(b) for b in builds]
    errors = []
    barrier = threading.Barrier(len(builds))
    mesh = st.get_mesh()

    def client(c):
        try:
            barrier.wait()
            with st.use_mesh(mesh):
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


def _serve_kernel_case(st, kk, label: str, reqs: list, build, kernels,
                       check, card: str) -> int:
    """``SERVE_CLIENTS`` threads x ``SERVE_PER_CLIENT`` requests of one
    plan that launches kernel rows 4-7 (``build(req)`` is request
    ``req``'s expression, ``kernels`` the (module, name) counters of its
    kernels, ``check(req, value)`` holds request 0's value to a
    reference) through one ``ServeEngine`` with at most
    ``SERVE_KERNEL_BATCH`` requests a batch. Prints the predicted peak
    a batch (the solo walk's measured peak and stacked inputs, times the
    batch) before the window; fails unless every served result is
    bit-equal to its serial ``evaluate()``, the plan stays in ``vmap``
    with no demotion or solo fallback, every batch is a power of two and
    the window's launches equal the requests times a solo walk's.
    Returns the window's launches."""
    from spartan_tpu_torch.expr import base
    from spartan_tpu_torch.obs import flight
    from spartan_tpu_torch.obs import trace as trace_mod
    from spartan_tpu_torch.serve import coalesce

    n = len(reqs)

    def launches() -> int:
        return sum(mod.LAUNCHES[name] for mod, name in kernels)

    def values(v) -> list:
        return list(v) if isinstance(v, (tuple, list)) else [v]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    _reset_counts(kk)
    first = values(build(reqs[0]).glom())  # builds the plan
    torch.cuda.synchronize()
    solo_peak = torch.cuda.max_memory_allocated() - live
    per_req = launches()
    check(reqs[0], first)
    inputs = sum(t.numel() * t.element_size() for t in reqs[0]
                 if isinstance(t, torch.Tensor))
    batch = SERVE_KERNEL_BATCH
    predicted = batch * (solo_peak + inputs)
    torch.cuda.empty_cache()  # the card's free bytes, not the cache's
    free, total = torch.cuda.mem_get_info()
    # two workers may walk two batches at once: walks go one at a time
    # where two predicted batch peaks would not fit the card's share
    serialize = 2 * predicted > SERVE_MEM_SHARE * free
    _say(f"[serve] {label}: predicted peak a batch of {batch}: "
         f"{predicted} bytes ({batch} x (solo walk's measured peak "
         f"{solo_peak} + stacked inputs {inputs})); {per_req} kernel "
         f"launch(es) a solo walk; {free} bytes free of {total}; walks "
         f"{'serialized' if serialize else 'concurrent'} across the two "
         f"workers")
    if per_req < 1:
        _fail(f"[serve] {label}: a solo walk launched no kernel")
    _reset_counts(kk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = [values(build(r).glom()) for r in reqs]
    serial_s = time.perf_counter() - t0
    if launches() != n * per_req:
        _fail(f"[serve] {label}: {launches()} launches in {n} serial "
              f"walks, not {n} x {per_req}")
    dem0 = _counter(st, "serve_mode_demotions")
    fb0 = _counter(st, "serve_solo_fallbacks")
    flight.clear()
    builds = [[(lambda r=reqs[c * SERVE_PER_CLIENT + i]: build(r))
               for i in range(SERVE_PER_CLIENT)]
              for c in range(SERVE_CLIENTS)]
    prev = st.FLAGS.dispatch_serialize
    if serialize:
        st.FLAGS.dispatch_serialize = "on"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    t_us = (trace_mod.now() - trace_mod._EPOCH) * 1e6
    try:
        with st.ServeEngine(max_batch=batch) as eng:
            _reset_counts(kk)
            t0 = time.perf_counter()
            got, futs = _serve_clients(st, eng, builds, label)
            served_s = time.perf_counter() - t0
            served = launches()
    finally:
        st.FLAGS.dispatch_serialize = prev
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - live
    plan = base.lookup_plan(base.plan_signature(build(reqs[0]))[0])
    mode = coalesce.mode_for(plan)
    sv = plan.report.get("serve") or {}
    got = [values(v) for row in got for v in row]
    equal = sum(len(a) == len(b) and all(
        np.array_equal(u, v) for u, v in zip(a, b))
        for a, b in zip(serial, got))
    batches = _serve_flight(st, futs, label, card)
    sizes = sorted(set(batches))
    dispatch = [sp.seconds * 1e3 for sp in st.trace_events()
                if sp.name == "serve_batch" and sp.ts >= t_us]
    dem = _counter(st, "serve_mode_demotions") - dem0
    fb = _counter(st, "serve_solo_fallbacks") - fb0
    _say(f"[serve] {label}: {n} requests from {SERVE_CLIENTS} clients: "
         f"{equal}/{n} bit-equal to serial evaluate() (limit: all); mode "
         f"{mode} (report {sv.get('mode')}); batch sizes {sizes} (limit: "
         f"powers of two); {served} kernel launches in the served window "
         f"(limit: {n} x {per_req} = {n * per_req}); demotions {dem}, solo "
         f"fallbacks {fb} (limit 0); measured peak {peak} bytes above the "
         f"{live} live (predicted a batch {predicted})")
    _say(f"[serve] {label} served {n / served_s:.1f} requests/s, serial "
         f"evaluate() {n / serial_s:.1f} requests/s (host clock, fetch "
         f"included); {len(dispatch)} serve_batch dispatches, ms "
         + (f"min {min(dispatch):.3f} median {_pct(dispatch, 50):.3f} max "
            f"{max(dispatch):.3f}" if dispatch else "none recorded")
         + f" on {card}")
    if equal != n:
        _fail(f"[serve] {label}: served results differ from the serial "
              "ones")
    if mode != "vmap" or sv.get("mode") != "vmap":
        _fail(f"[serve] {label}: the plan left vmap mode: {mode}, {sv}")
    if dem or fb:
        _fail(f"[serve] {label}: {dem} demotion(s), {fb} solo fallback(s)")
    if any(b & (b - 1) for b in batches):
        _fail(f"[serve] {label}: a batch is not a power of two: {sizes}")
    if served != n * per_req:
        _fail(f"[serve] {label}: {served} launches for {n} served requests"
              f" of {per_req} each")
    if not any(b > 1 for b in batches):
        _fail(f"[serve] {label}: no request was coalesced")
    return served


def _serve_kernels(st, kk, kx, kh, kt, kst, card: str, dev) -> dict:
    """The kernel cases of [serve] on a logical (8, 1) mesh: top-k (both
    outputs) and a 64-bin histogram with a range on 2^26 keys a request,
    the sort of SERVE_SORT_N keys a request, and VGG-16 block 1's
    forward on SERVE_VGG_N images a request, H tiled."""
    from spartan_tpu_torch.array.distarray import from_tensor

    n = SERVE_CLIENTS * SERVE_PER_CLIENT
    gen = torch.Generator(device=dev)
    gen.manual_seed(28)
    out = {}
    with st.use_mesh(st.build_mesh(SORT_MESH)):
        # request i reads keys [i * stride, i * stride + SORT_N) of one
        # buffer: distinct inputs without 64 whole copies on the card
        buf = torch.rand(SORT_N + (n - 1) * SERVE_WINDOW_STRIDE,
                         generator=gen, device=dev)
        windows = [(buf[i * SERVE_WINDOW_STRIDE:
                        i * SERVE_WINDOW_STRIDE + SORT_N],)
                   for i in range(n)]

        def topk_check(req, v):
            want = torch.topk(req[0], TOPK_K).values.cpu().numpy()
            if not np.array_equal(v[0], want):
                _fail("[serve] top-k: request 0's values differ from "
                      "torch.topk's")

        out["shard_topk"] = _serve_kernel_case(
            st, kk, f"top-k k={TOPK_K} of {SORT_N} keys", windows,
            lambda r: st.tuple_of(*st.topk(from_tensor(r[0]), TOPK_K)),
            [(kt, "shard_topk")], topk_check, card)

        def hist_check(req, v):
            xn = req[0].cpu().numpy()
            edges = _np_edges(0.0, 1.0, HIST_BINS)
            b = np.searchsorted(edges, xn, side="right") - 1
            b[xn == edges[-1]] = HIST_BINS - 1
            want = np.bincount(b[(xn >= edges[0]) & (xn <= edges[-1])],
                               minlength=HIST_BINS)
            if not np.array_equal(v[0], want):
                _fail("[serve] histogram: request 0's counts differ from "
                      "numpy's on the same f32 edges")

        out["bincount_block"] = _serve_kernel_case(
            st, kk, f"histogram({HIST_BINS} bins, range=(0, 1)) of "
            f"{SORT_N} keys", windows,
            lambda r: st.histogram(from_tensor(r[0]), HIST_BINS,
                                   range=(0.0, 1.0))[0],
            [(kh, "bincount_block")], hist_check, card)
        del windows, buf
        keys = [(torch.rand(SERVE_SORT_N, generator=gen, device=dev),)
                for _ in range(n)]

        def sort_check(req, v):
            want = torch.sort(req[0]).values.cpu().numpy()
            if not np.array_equal(v[0], want):
                _fail("[serve] sort: request 0 differs from torch.sort")

        out["partition_pack"] = _serve_kernel_case(
            st, kk, f"sort of {SERVE_SORT_N} keys", keys,
            lambda r: st.sort(from_tensor(r[0])),
            [(kx, "partition_pack")], sort_check, card)
        del keys
    with st.use_mesh(st.build_mesh(VGG_MESH)):
        _, params = _vgg_params(dev)
        P = [(from_tensor(w), from_tensor(b)) for w, b in params]
        imgs = [(torch.randn((SERVE_VGG_N, VGG_HW, VGG_HW, VGG_WIDTHS[0]),
                             generator=gen, device=dev),)
                for _ in range(n)]

        def vgg_check(req, v):
            ref = _vgg_float64(req[0], params).cpu().numpy()
            rel = float(np.abs(v[0] - ref).max() / np.abs(ref).max())
            if rel > 1e-5:
                _fail(f"[serve] VGG: request 0 is {rel:.3g} off its "
                      "float64 forward (limit 1e-5)")

        out["conv_block"] = _serve_kernel_case(
            st, kk, f"VGG-16 block 1 on {SERVE_VGG_N} x {VGG_HW}^2 x "
            f"{VGG_WIDTHS[0]} images, H tiled", imgs,
            lambda r: vgg_block1(st, from_tensor(
                r[0], tiling=st.Tiling((None, "x", None, None))), P),
            [(kst, "conv_block")], vgg_check, card)
    return out


def _serve_ravel(st, card: str, dev) -> None:
    """[serve]'s ravel case: 64 requests of ``st.ravel`` of a
    SERVE_RAVEL_SIDE^2 array from 16 clients through one engine with
    batches of at most 16, on a logical (8, 1) mesh. Fails unless the
    plan stays in ``vmap`` with no demotion or solo fallback, every
    served result is bit-equal to its serial ``evaluate()`` and request
    0 is its array's ``reshape(-1)``."""
    from spartan_tpu_torch.array.distarray import from_tensor
    from spartan_tpu_torch.expr import base
    from spartan_tpu_torch.obs import flight
    from spartan_tpu_torch.serve import coalesce

    label = f"ravel of {SERVE_RAVEL_SIDE}^2 f32"
    n = SERVE_CLIENTS * SERVE_PER_CLIENT
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    with st.use_mesh(st.build_mesh(SORT_MESH)):
        xs = [torch.rand((SERVE_RAVEL_SIDE, SERVE_RAVEL_SIDE), generator=gen,
                         device=dev) for _ in range(n)]

        def build(x):
            return st.ravel(from_tensor(x))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serial = [build(x).glom() for x in xs]
        serial_s = time.perf_counter() - t0
        if not np.array_equal(serial[0], xs[0].reshape(-1).cpu().numpy()):
            _fail(f"[serve] {label}: request 0 differs from reshape(-1)")
        dem0 = _counter(st, "serve_mode_demotions")
        fb0 = _counter(st, "serve_solo_fallbacks")
        flight.clear()
        builds = [[(lambda x=xs[c * SERVE_PER_CLIENT + i]: build(x))
                   for i in range(SERVE_PER_CLIENT)]
                  for c in range(SERVE_CLIENTS)]
        with st.ServeEngine(max_batch=SERVE_KERNEL_BATCH) as eng:
            t0 = time.perf_counter()
            got, futs = _serve_clients(st, eng, builds, label)
            served_s = time.perf_counter() - t0
        plan = base.lookup_plan(base.plan_signature(build(xs[0]))[0])
        mode = coalesce.mode_for(plan)
        sv = plan.report.get("serve") or {}
        got = [v for row in got for v in row]
        equal = sum(np.array_equal(a, b) for a, b in zip(serial, got))
        batches = _serve_flight(st, futs, label, card)
        dem = _counter(st, "serve_mode_demotions") - dem0
        fb = _counter(st, "serve_solo_fallbacks") - fb0
        del xs
    _say(f"[serve] {label}: {n} requests from {SERVE_CLIENTS} clients: "
         f"{equal}/{n} bit-equal to serial evaluate() (limit: all); mode "
         f"{mode} (report {sv.get('mode')}); batch sizes "
         f"{sorted(set(batches))}; demotions {dem}, solo fallbacks {fb} "
         f"(limit 0); served {n / served_s:.1f} requests/s, serial "
         f"{n / serial_s:.1f} (host clock, fetch included) on {card}")
    if equal != n:
        _fail(f"[serve] {label}: served results differ from the serial "
              "ones")
    if mode != "vmap" or sv.get("mode") != "vmap":
        _fail(f"[serve] {label}: the plan left vmap mode: {mode}, {sv}")
    if dem or fb:
        _fail(f"[serve] {label}: {dem} demotion(s), {fb} solo fallback(s)")
    if not any(b > 1 for b in batches):
        _fail(f"[serve] {label}: no request was coalesced")


def phase_serve(st, kk, km, card: str, dev, kmr: dict, workdir: str) -> dict:
    """[serve]: the serving front end on the card (module docstring)."""
    from spartan_tpu_torch.kernels import exchange as kx
    from spartan_tpu_torch.kernels import histogram as kh
    from spartan_tpu_torch.kernels import stencil as kst
    from spartan_tpu_torch.kernels import topk as kt

    t0 = time.perf_counter()
    out = _serve_kmeans(st, kk, km, card, dev, kmr)
    out["kernels"] = _serve_kernels(st, kk, kx, kh, kt, kst, card, dev)
    _serve_ravel(st, card, dev)
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


# -- phases 24-26: the incremental engine, the monitor, the guard ---------

# [incremental]: edge-insert PageRank on dense transitions, 1% of the
# columns rewritten a batch, 8 batches with a step after each, flag on
# then off on the same stream; the delta curve's dirty fractions at the
# first size; the sliding window the elementwise stream normalizes
INC_NS, INC_BATCHES, INC_FRAC = (16_384, 32_768), 8, 0.01
INC_CURVE, INC_CURVE_STEPS = (0.001, 0.01, 0.1), 3
INC_SW_ROWS, INC_SW_DIM, INC_SW_PUSH = 1_048_576, 128, 10_486
INC_CACHE_BYTES = 16 << 30  # room for the cached result and leaf pins
INC_OFF_ITERS, INC_OFF_REPS = 200, 3
# [monitor]: the sampler's cadence, the per-evaluate k-means run each arm
# times, and the planted calibration drift
MON_INTERVAL_S, MON_ITERS, MON_REPS, MON_DRIFT = 0.05, 200, 3, 4.0


def _inc_counters(st) -> dict:
    c = st.metrics()["counters"]
    return {k: int(c.get(k, 0)) for k in (
        "incremental_hits", "incremental_fallbacks",
        "incremental_recomputed_tiles")}


def _delta(after: dict, before: dict) -> dict:
    return {k.replace("incremental_", ""): after[k] - before[k]
            for k in after}


def _inc_report(st, expr) -> dict:
    from spartan_tpu_torch.expr import base

    plan = base.lookup_plan(base.plan_signature(expr)[0])
    return dict((plan.report or {}).get("incremental") or {}) \
        if plan is not None else {}


def _inc_pagerank_arm(st, streaming, a, starts, width: int, on: bool):
    """One arm of the edge-insert stream: per batch the seam write (its
    own ms, synchronised outside the step window), then one step."""
    from spartan_tpu_torch.utils.config import FLAGS

    FLAGS.incremental = on
    n = a.shape[0]
    gen = torch.Generator(device=a.device)
    gen.manual_seed(80)
    pr = streaming.IncrementalPageRank(a.clone(),
                                       rebase_every=len(starts) + 1)
    pr.step()  # the cold step: a plan miss, and the cache's seed
    torch.cuda.synchronize()
    c0 = _inc_counters(st)
    seam, steps, reasons = [], [], []
    for j in starts:
        vals = torch.rand((n, width), generator=gen, device=a.device) / n
        torch.cuda.synchronize()
        t = time.perf_counter()
        pr.insert_edges(slice(j, j + width), vals)
        torch.cuda.synchronize()
        seam.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        pr.step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t) * 1e3)
        rep = _inc_report(st, pr._step_expr())
        reasons.append(rep.get("fallback") or rep.get("mode"))
    cnt = _delta(_inc_counters(st), c0)
    FLAGS.incremental = False
    # the ranks (this rank's block of them on a group mesh)
    return pr.ranks.local, seam, steps, cnt, reasons


def _inc_order_check(kg, n: int, dev) -> str:
    """The card's answer to ``incremental.order_granule``: do restricted
    cuBLAS vector-matrix and matrix products give the full product's
    bits? And the fixed-order kernel's windows at granule 1 (which the
    engine's vector products rely on); raises if one of those misses."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(81)
    r = torch.rand(n, generator=gen, device=dev)
    a = torch.rand((n, n), generator=gen, device=dev)
    full = r @ a
    mine = kg.fixed_order_dot(r, a)
    out = []
    for g in (1, 64, 1024):
        held = tries = 0
        for c0, w in ((777, 164), (3001, 328), (n - 300, 300)):
            lo, hi = (c0 // g) * g, min(n, -(-(c0 + w) // g) * g)
            tries += 1
            held += int(torch.equal(full[lo:hi], r @ a[:, lo:hi]))
        out.append(f"cuBLAS window granule {g}: {held}/{tries}")
    held = [torch.equal(mine[lo:lo + w],
                        kg.fixed_order_dot(r, a[:, lo:lo + w]))
            for lo, w in ((777, 164), (3001, 328), (n - 300, 300), (5, 1))]
    if not all(held):
        _fail(f"[incremental] fixed_order_dot windows held {held}")
    out.append(f"fixed_order_dot window granule 1: {sum(held)}/{len(held)}")
    m = 4096  # matrix products: row and column windows of a @ b
    x, y = a[:m, :m].contiguous(), a[m:2 * m, :m].contiguous()
    del a
    f = x @ y
    for g in (1, 256):
        held = tries = 0
        for lo, w in ((30, 2), (128, 128), (10, 41)):
            lo, hi = (lo // g) * g, min(m, -(-(lo + w) // g) * g)
            held += int(torch.equal(f[lo:hi], x[lo:hi] @ y))
            held += int(torch.equal(f[:, lo:hi], x @ y[:, lo:hi]))
            tries += 2
        out.append(f"{m}^2 matmul rows/cols granule {g}: {held}/{tries}")
    return ", ".join(out)


def _step_ips(st, km, points, c0, iters: int) -> float:
    """Config-3 iterations per second, one evaluate an iteration (the
    plan-cache hit path each time), host clock to a synchronise."""
    c = c0
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        c = km.kmeans_step(points, c, KM_K).evaluate()
    torch.cuda.synchronize()
    return iters / (time.perf_counter() - t)


class _NullIncremental:
    """A stand-in for expr/base's ``incremental_mod`` binding with the
    flag constant off: the arm that prices the flag read itself."""

    class _Flag:
        _value = False

    _INC_FLAG = _Flag()
    NOT_HANDLED = object()

    @staticmethod
    def evict_stale() -> int:
        return 0


def _inc_off_path(st, km, card: str, kmr: dict) -> dict:
    """The flag-off cost: config-3 steps with the real binding against
    the null shim, alternated, best of INC_OFF_REPS each."""
    from spartan_tpu_torch.expr import base

    real = base.incremental_mod
    pts, c0 = kmr["points"], st.from_numpy(kmr["c0"])
    _step_ips(st, km, pts, c0, 20)  # warm the plan
    real_ips, shim_ips = [], []
    try:
        for _ in range(INC_OFF_REPS):
            base.incremental_mod = real
            real_ips.append(_step_ips(st, km, pts, c0, INC_OFF_ITERS))
            base.incremental_mod = _NullIncremental
            shim_ips.append(_step_ips(st, km, pts, c0, INC_OFF_ITERS))
    finally:
        base.incremental_mod = real
    cost = max(real_ips) and (max(shim_ips) / max(real_ips) - 1.0)
    _say(f"[incremental] flag-off cost: config-3 kmeans_step "
         f"{max(real_ips):.2f} iters/s with the real binding, "
         f"{max(shim_ips):.2f} with the null shim (best of "
         f"{INC_OFF_REPS}, {INC_OFF_ITERS} evaluates each): "
         f"{100 * cost:.2f}% (the JAX package's gate: <= 1%) on {card}")
    return {"off_path_cost": cost}


def _inc_refine(st, kk, card: str, dev, kmr: dict,
                tag: str = "[incremental]", runs: int = 2) -> dict:
    """``OnlineKMeans.refine(iters=5)`` under the flag: 5 row-1 launches a
    refine, bit-equal to the flag-off run; the loop node's dirt is
    whole-node, its fallback counted. On a group mesh each rank holds
    its block of the points and counts its own launches; there the
    second refine is a plan miss (the first moved the centers to the
    step's output tiling), so a third is the warm one."""
    from spartan_tpu_torch.examples import streaming
    from spartan_tpu_torch.utils.config import FLAGS

    out = {}
    for on in (True, False):
        FLAGS.incremental = on
        okm = streaming.OnlineKMeans(torch.from_numpy(kmr["c0"]).to(dev))
        launches = []
        c0 = _inc_counters(st)
        for _ in range(runs):  # a miss, then a warm hit on new centers
            _reset_counts(kk)
            okm.refine(kmr["points"], iters=OKM_REFINE)
            torch.cuda.synchronize()
            launches.append(kk.LAUNCHES)
        out[on] = (okm.centers.local.clone(), launches,
                   _delta(_inc_counters(st), c0))
    FLAGS.incremental = False
    (c_on, l_on, d_on), (c_off, l_off, _) = out[True], out[False]
    _say(f"{tag} OnlineKMeans.refine(iters={OKM_REFINE}) {runs} times, "
         f"flag on: row-1 launches {l_on} (flag off {l_off}), counters "
         f"{d_on}, centers bit-equal to the flag-off run: "
         f"{torch.equal(c_on, c_off)} on {card}")
    if l_on != [OKM_REFINE] * runs or l_off != [OKM_REFINE] * runs:
        _fail(f"{tag} refine launched {l_on} / {l_off}, want "
              f"{OKM_REFINE} a refine")
    if not torch.equal(c_on, c_off):
        _fail(f"{tag} refine under the flag is not bit-equal")
    if d_on["fallbacks"] < 1 or d_on["hits"] != 0:
        _fail(f"{tag} the loop node was not a counted fallback: {d_on}")
    return {"launches": l_on, "counters": d_on}


def _inc_window(st, card: str, dev, pushes: int = INC_BATCHES,
                tag: str = "[incremental]") -> dict:
    """The elementwise stream: a 1,048,576 x 128 window normalized with
    fixed statistics after each 1% push; the restricted map serves it.
    On a group mesh each rank holds its block of the window and compares
    its own block of the results."""
    from spartan_tpu_torch.examples import streaming
    from spartan_tpu_torch.utils.config import FLAGS

    gen = torch.Generator(device=dev)
    gen.manual_seed(82)
    first = torch.randn((INC_SW_ROWS, INC_SW_DIM), generator=gen,
                        device=dev)
    rows = [torch.randn((INC_SW_PUSH, INC_SW_DIM), generator=gen,
                        device=dev) for _ in range(pushes)]
    res = {}
    for on in (True, False):
        FLAGS.incremental = on
        sw = streaming.SlidingWindowStats(INC_SW_ROWS, INC_SW_DIM,
                                          device=dev)
        sw.push(first)
        mean, std = sw.stats()
        sw.normalized(mean, std)  # seed
        c0 = _inc_counters(st)
        ms, seam = [], []
        for r in rows:
            torch.cuda.synchronize()
            t = time.perf_counter()
            sw.push(r)
            torch.cuda.synchronize()
            seam.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            out = sw.normalized(mean, std)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        res[on] = (out.local.clone(), float(np.median(ms)),
                   _delta(_inc_counters(st), c0), float(np.median(seam)))
        del sw, out
    del first, rows
    FLAGS.incremental = False
    (o_on, m_on, d_on, s_on), (o_off, m_off, _, s_off) = (res[True],
                                                          res[False])
    _say(f"{tag} window {INC_SW_ROWS}x{INC_SW_DIM} f32, "
         f"{pushes} pushes of {INC_SW_PUSH} rows, normalized() with "
         f"fixed statistics: median {m_on:.3f} ms on, {m_off:.3f} ms off "
         f"(x{m_off / m_on:.2f}); the push (the seam write) median "
         f"{s_on:.3f} ms on, {s_off:.3f} ms off; counters {d_on}; "
         f"bit-equal {torch.equal(o_on, o_off)} on {card}")
    if not torch.equal(o_on, o_off):
        _fail(f"{tag} the window stream is not bit-equal")
    if d_on["hits"] != pushes or d_on["fallbacks"] != 0:
        _fail(f"{tag} the window stream was not served "
              f"incrementally: {d_on}")
    return {"on_ms": m_on, "off_ms": m_off, "seam_ms": s_on,
            "counters": d_on}


def phase_incremental(st, kk, kg, km, card: str, dev, kmr: dict) -> dict:
    """[incremental]: the delta-aware engine on the card (module
    docstring)."""
    from spartan_tpu_torch.examples import streaming
    from spartan_tpu_torch.expr import incremental as inc
    from spartan_tpu_torch.utils.config import FLAGS

    t0 = time.perf_counter()
    prev_budget = FLAGS.result_cache_bytes
    FLAGS.result_cache_bytes = INC_CACHE_BYTES
    out = {}
    try:
        _say(f"[incremental] order_granule({dev.type}) = "
             f"{inc.order_granule(dev)}; restricted r @ A[:, window] "
             f"against the full product's bits at n = {INC_NS[0]}: "
             f"{_inc_order_check(kg, INC_NS[0], dev)} on {card}")
        for n in INC_NS:
            gen = torch.Generator(device=dev)
            gen.manual_seed(83)
            a = torch.rand((n, n), generator=gen, device=dev)
            a /= a.sum(1, keepdim=True)
            width = -(-n * int(INC_FRAC * 1000) // 1000)
            starts = [(j * 7919 * width) % (n - width)
                      for j in range(1, INC_BATCHES + 1)]
            kg.LAUNCHES["fixed_order_dot"] = 0
            on = _inc_pagerank_arm(st, streaming, a, starts, width, True)
            launches = kg.LAUNCHES["fixed_order_dot"]
            off = _inc_pagerank_arm(st, streaming, a, starts, width, False)
            del a
            torch.cuda.empty_cache()
            s_on, s_off = float(np.median(on[2])), float(np.median(off[2]))
            equal = torch.equal(on[0], off[0])
            _say(f"[incremental] PageRank dense {n}^2 f32, {INC_BATCHES} "
                 f"batches of {width} columns: seam write median "
                 f"{np.median(on[1] + off[1]):.3f} ms; step median "
                 f"{s_on:.3f} ms on, {s_off:.3f} ms off (x"
                 f"{s_off / s_on:.2f}); counters on {on[3]}, off "
                 f"{off[3]}; the on arm's modes {sorted(set(on[4]))}; "
                 f"fixed_order_dot launches in the on arm {launches} (the "
                 f"cold step and each warm one); final ranks bit-equal "
                 f"{equal} on {card}")
            if not equal:
                _fail(f"[incremental] PageRank at {n} is not bit-equal")
            if on[3]["hits"] != INC_BATCHES or on[3]["fallbacks"] != 0 \
                    or off[3]["hits"] + off[3]["fallbacks"] != 0:
                _fail(f"[incremental] PageRank's warm steps were not all "
                      f"served: on {on[3]} {on[4]}, off {off[3]}")
            if launches != INC_BATCHES + 1:
                _fail(f"[incremental] the on arm launched fixed_order_dot "
                      f"{launches} times, want {INC_BATCHES + 1}")
            out.setdefault("gemv_launches", launches)
            out[n] = {"on_ms": s_on, "off_ms": s_off, "counters": on[3],
                      "modes": sorted(set(on[4]))}
        n = INC_NS[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(84)
        a = torch.rand((n, n), generator=gen, device=dev)
        a /= a.sum(1, keepdim=True)
        curve = []
        for frac in INC_CURVE:
            width = max(1, int(round(n * frac)))
            starts = [(j * 4099 * width) % (n - width)
                      for j in range(1, INC_CURVE_STEPS + 1)]
            on = _inc_pagerank_arm(st, streaming, a, starts, width, True)
            off = _inc_pagerank_arm(st, streaming, a, starts, width, False)
            if not torch.equal(on[0], off[0]):
                _fail(f"[incremental] curve at {frac} is not bit-equal")
            curve.append(f"{100 * frac:g}% ({width} columns) "
                         f"{np.median(on[2]):.3f} ms on / "
                         f"{np.median(off[2]):.3f} off, {on[3]}")
        del a
        torch.cuda.empty_cache()
        _say(f"[incremental] delta curve at {n}: " + "; ".join(curve)
             + f" on {card}")
        _inc_window(st, card, dev)
        _inc_refine(st, kk, card, dev, kmr)
        out.update(_inc_off_path(st, km, card, kmr))
    finally:
        FLAGS.incremental = False
        FLAGS.result_cache_bytes = prev_budget
        inc.clear()
    _say(f"[incremental] phase {time.perf_counter() - t0:.1f} s on {card}")
    return out


# -- [integrity_group] and [incremental_group] ----------------------------
#
# Two gloo ranks sharing the card on a (2, 1) group mesh. [integrity_group]
# runs config 3 under the SDC sentinel: the flag-off loop, iterations/s
# and each rank's peak with the check off and on, a clean checked run of
# IG_ITERS iterations in a checkpointed st.loop, then the planted fault:
# rank IG_VICTIM corrupts the sampled walks IG_SDC names, both ranks
# vote alike and raise the same quarantining IntegrityError at the third
# violation, and a one-process survivor world resumes the per-rank
# snapshots, bit-equal to a clean one-process resume of a copy of them.
# st.loop walks one plan a segment, so the loop is checkpointed every
# iteration to give the cadence IG_ITERS walks. [incremental_group] runs
# the engine's streams on the group: the 1,048,576 x 128 window with
# IGI_PUSHES pushes, PageRank on a dense IGI_PR_N^2 transition (every
# warm step served: each rank's restricted product through the
# fixed-order kernel, the two ranks' partial sums added once) and the
# refine.
IG_SAMPLE, IG_STRIKES, IG_VICTIM, IG_ITERS = 5, 3, 1, 15
IG_SDC = "sdc@4#1,sdc@9#1,sdc@14#1"
IG_IPS_REPS, IG_TIMEOUT_S, IG_JOIN_S = 3, 120, 300
IGI_PUSHES, IGI_PR_N, IGI_PR_BATCHES = 20, 16_384, 4


def group_guard_child(workdir: str, rank: int) -> None:
    """One rank of an [integrity_group] or [incremental_group] world on
    the card (gloo, local storage), by ``job.json``'s ``kind``: the
    checked k-means runs (``integrity``), a resume of their snapshots
    (``resume``), or the engine's streams (``incremental``); results to
    ``workdir``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import importlib

    import spartan_tpu_torch as st
    from spartan_tpu_torch.examples import kmeans as km
    from spartan_tpu_torch.expr import base
    from spartan_tpu_torch.kernels import kmeans as kk
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.resilience import integrity

    with open(os.path.join(workdir, "job.json")) as f:
        job = json.load(f)
    dev = _child_device()
    st.set_default_device(dev)
    if not mesh_mod.initialize_distributed(
            "file://" + os.path.join(workdir, "store"),
            num_processes=job["world"], process_id=rank, backend="gloo",
            device=dev, timeout_s=IG_TIMEOUT_S):
        _fail("[integrity_group] child: no process group")
    card = job["card"]
    pts_np = np.load(job["points"], mmap_mode="r")
    c0_np = np.load(job["c0"])
    res = {"rank": rank}
    if job["kind"] == "incremental":
        kmr = {"points": st.as_expr(st.from_numpy(pts_np).evaluate()),
               "c0": c0_np}
        res.update(_ig_incremental(st, kk, card, dev, kmr))
    else:
        # the step keeps its centers replicated (its own out_tiling), so
        # the healthy rank's copy outvotes a corrupt one; the tiling
        # pass would split them, and two ranks' split blocks tie (the
        # JAX package's vote: both holders implicated)
        st.FLAGS.opt_auto_tiling = False
        pe = st.from_numpy(pts_np).evaluate()
        # the centers in the step's output tiling: every walk of the
        # loop's segments is one plan, whose walks the cadence counts
        t_out = km.kmeans_step(pe, st.from_numpy(c0_np), KM_K).evaluate(
        ).tiling
        c0 = st.from_numpy(c0_np, tiling=t_out).evaluate()

        def body(c):
            return km.kmeans_step(pe, c, KM_K)

        if job["kind"] == "resume":
            _reset_counts(kk)
            c = st.loop(IG_ITERS, body, c0, checkpoint_every=1,
                        resume=job["ck"])
            res["centers"] = c.glom().tolist()
            res["launches"] = kk.LAUNCHES
            res["resumed_from"] = c._resilience["resumed_from"]
        else:
            profile_mod = importlib.import_module(
                "spartan_tpu_torch.obs.profile")
            res.update(_ig_checked(st, km, kk, integrity, base,
                                   profile_mod, pe, c0, body, job, dev))
    with open(os.path.join(workdir, f"result{rank}.json"), "w") as f:
        json.dump(res, f)
    st.shutdown()


def _ig_checked(st, km, kk, integrity, base, profile_mod, pe, c0, body,
                job, dev) -> dict:
    """The 2-rank world of [integrity_group] (module section comment)."""
    res = {}
    st.FLAGS.retry_backoff_s = 0.0
    st.FLAGS.profile_sample_every = IG_SAMPLE
    st.FLAGS.sdc_quarantine_strikes = IG_STRIKES
    st.FLAGS.integrity_check = False
    off = st.loop(IG_ITERS, body, c0).glom()
    # iterations/s and the rank's peak with the check off and on, one
    # evaluate an iteration (every IG_SAMPLE-th walk checked), best of
    # IG_IPS_REPS each, alternated; the sampled profiler, which rides
    # the same cadence, is held off in both arms (its replay's peak
    # would hide the check's)
    ips = {False: [], True: []}
    peak = {False: 0, True: 0}
    sample = profile_mod.maybe_sample
    profile_mod.maybe_sample = lambda *a, **kw: None
    try:
        base_bytes = torch.cuda.memory_allocated(dev)
        for _ in range(IG_IPS_REPS):
            for check in (False, True):
                st.FLAGS.integrity_check = check
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                t = time.perf_counter()
                _km_steps(st, km, pe, c0, 0, IG_ITERS)
                torch.cuda.synchronize()
                ips[check].append(IG_ITERS / (time.perf_counter() - t))
                peak[check] = max(peak[check], torch.cuda.max_memory_allocated(
                    dev) - base_bytes)
    finally:
        profile_mod.maybe_sample = sample
    res["ips_off"], res["ips_on"] = max(ips[False]), max(ips[True])
    res["peak_off"], res["peak_on"] = peak[False], peak[True]

    verdicts, implicated = [], []
    stamp, note = integrity._stamp, integrity.note_violation

    def spy_stamp(d, p, v):
        verdicts.append({k: v[k] for k in v if k not in ("t", "plan")})
        return stamp(d, p, v)

    def spy_note(imp):
        implicated.append(list(imp))
        return note(imp)

    integrity._stamp, integrity.note_violation = spy_stamp, spy_note
    sampled, undo = _profile_launches(profile_mod, kk)
    try:
        # the clean checked run, snapshotted every iteration
        st.FLAGS.integrity_check = True
        integrity.reset()
        base.clear_plan_cache()
        _reset_counts(kk)
        clean = st.loop(IG_ITERS, body, c0, checkpoint_every=1,
                        checkpoint_path=job["ck_clean"]).glom()
        torch.cuda.synchronize()
        res["clean_equal"] = bool(np.array_equal(_bits(clean), _bits(off)))
        res["clean_launches"] = kk.LAUNCHES
        res["clean_samples"] = list(sampled)
        res["clean_verdicts"] = list(verdicts)
        res["clean_checks"] = integrity.status()["checks"]
        # the planted fault
        integrity.reset()
        base.clear_plan_cache()
        verdicts.clear()
        sampled[:] = [0, 0]
        _reset_counts(kk)
        err = None
        with st.chaos(IG_SDC, seed=3) as plan:
            try:
                st.loop(IG_ITERS, body, c0, checkpoint_every=1,
                        checkpoint_path=job["ck_fault"]).glom()
            except integrity.IntegrityError as e:
                err = {"quarantined": e.quarantined,
                       "suspects": list(e.suspects),
                       "kind": getattr(e, "fault_kind", None)}
        torch.cuda.synchronize()
        res["fault_error"] = err
        res["fault_implicated"] = implicated
        res["fault_verdicts"] = list(verdicts)
        res["fault_fired"] = [f["occurrence"] for f in plan.fired]
        res["fault_launches"] = kk.LAUNCHES
        res["fault_samples"] = list(sampled)
        res["history"] = [{k: h[k] for k in ("device", "strikes", "remedy")}
                          for h in integrity.quarantine_history()]
        res["quarantines"] = _counter(st, "integrity_quarantines")
    finally:
        integrity._stamp, integrity.note_violation = stamp, note
        undo()
        st.FLAGS.integrity_check = False
    res["off_centers"] = off.tolist()
    return res


def _ig_world(workdir: str, job: dict) -> list:
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "job.json"), "w") as f:
        json.dump(job, f)
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              "--group-guard-child", workdir, str(r)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for r in range(job["world"])]


def _ig_join(procs: list, workdir: str, label: str) -> list:
    """Each rank's result of a world, after it exited 0."""
    try:
        logs = [p.communicate(timeout=IG_JOIN_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        _fail(f"{label}: a child did not finish in {IG_JOIN_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    out = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            _fail(f"{label}: rank {r} exited {p.returncode}:\n{log[-4000:]}")
        for ln in log.splitlines():
            if ln.startswith("[incremental_group]"):
                _say(f"{ln} (rank {r})")
        with open(os.path.join(workdir, f"result{r}.json")) as f:
            out.append(json.load(f))
    return out


def phase_integrity_group(st, card: str, workdir: str) -> dict:
    """[integrity_group] (section comment above)."""
    t0 = time.perf_counter()
    pts_np, c0_np, _ = _data(LOCAL_KM_N, KM_D, KM_K, "clustered", 0)
    base = {"points": os.path.join(workdir, "points.npy"),
            "c0": os.path.join(workdir, "c0.npy"), "card": card}
    np.save(base["points"], pts_np)
    np.save(base["c0"], c0_np)
    del pts_np
    ck_fault = os.path.join(workdir, "ck_fault")
    job = dict(base, kind="integrity", world=2,
               ck_clean=os.path.join(workdir, "ck_clean"), ck_fault=ck_fault)
    r = _ig_join(_ig_world(os.path.join(workdir, "w2"), job),
                 os.path.join(workdir, "w2"), "[integrity_group]")
    tag = "[integrity_group]"
    for key in ("clean_verdicts", "fault_verdicts", "fault_implicated",
                "fault_error", "history", "clean_checks", "fault_fired"):
        if r[0][key] != r[1][key]:
            _fail(f"{tag} the ranks differ on {key}: {r[0][key]} / "
                  f"{r[1][key]}")
    x = r[0]
    if (not x["clean_equal"] or not r[1]["clean_equal"]
            or x["clean_checks"] != IG_ITERS // IG_SAMPLE
            or any(v["verdict"] != "ok" for v in x["clean_verdicts"])):
        _fail(f"{tag} clean run: checks {x['clean_checks']}, verdicts "
              f"{x['clean_verdicts']}, bit-equal {x['clean_equal']}")
    for rr in r:
        walks = IG_ITERS
        want = walks + rr["clean_checks"] + rr["clean_samples"][1]
        if rr["clean_launches"] != want:
            _fail(f"{tag} rank {rr['rank']}: {rr['clean_launches']} "
                  f"k-means launches, want {walks} walks + "
                  f"{rr['clean_checks']} re-walks + the profiler "
                  f"samples' {rr['clean_samples'][1]}")
    err = x["fault_error"]
    # replicated centers: the JAX package's vote names the victim alone
    if (err is None or err["quarantined"] != IG_VICTIM
            or err["kind"] != "sdc_quarantine"
            or x["fault_implicated"] != [[IG_VICTIM]] * IG_STRIKES
            or [h["device"] for h in x["history"]] != [IG_VICTIM]
            or x["quarantines"] != 1):
        _fail(f"{tag} planted fault: error {err}, implicated "
              f"{x['fault_implicated']}, history {x['history']}")
    moved, moved1 = ([(v.get("moved_sent"), v.get("moved_recv"))
                      for v in rr["clean_verdicts"]] for rr in r)
    with open(os.path.join(ck_fault, "LATEST.json")) as f:
        step = json.load(f)["step"]
    _say(f"{tag} config-3 k-means {LOCAL_KM_N}x{KM_D}, k = {KM_K}, on a "
         f"(2, 1) group of 2 gloo ranks sharing the card, every "
         f"{IG_SAMPLE}th walk checked: clean run of {IG_ITERS} iterations "
         f"in st.loop(checkpoint_every=1): {x['clean_checks']} checks, "
         f"verdicts {[v['verdict'] for v in x['clean_verdicts']]} on both "
         f"ranks, centers bit-equal to the flag-off run; row-1 launches a "
         f"rank {[rr['clean_launches'] for rr in r]} = {IG_ITERS} walks + "
         f"{x['clean_checks']} re-walks + the profiler samples' "
         f"{[rr['clean_samples'][1] for rr in r]}")
    _say(f"{tag} each check moves the split leaf's block to the rank "
         f"holding its rotated coordinates: rank 0 sent/received "
         f"{moved} bytes, rank 1 {moved1}; peak above the resident "
         f"points a rank, the sampled profiler held off in both arms: "
         f"{x['peak_off']} B with the check off, {x['peak_on']} B on "
         f"(rank 1: {r[1]['peak_off']} / "
         f"{r[1]['peak_on']}); iterations/s (one evaluate an iteration, "
         f"best of {IG_IPS_REPS}) off {x['ips_off']:.2f}, on "
         f"{x['ips_on']:.2f} ({(1 - x['ips_on'] / x['ips_off']) * 100:.1f}% "
         f"lower) on {card}")
    _say(f"{tag} planted {IG_SDC} (rank {IG_VICTIM} corrupts): fired at "
         f"walks {x['fault_fired']}, {len(x['fault_implicated'])} "
         f"violations implicating {x['fault_implicated']} on both ranks; "
         f"both raised IntegrityError(quarantined={err['quarantined']}, "
         f"class {err['kind']}) at the third; LATEST snapshot step {step}")
    # the survivor world: one process resumes the per-rank snapshots;
    # a clean one-process world resumes a copy of them
    ref = os.path.join(workdir, "ck_ref")
    _copy_snapshot(ck_fault, ref, step)
    surv = _ig_world(os.path.join(workdir, "surv"),
                     dict(base, kind="resume", world=1, ck=ck_fault))
    clean = _ig_world(os.path.join(workdir, "clean"),
                      dict(base, kind="resume", world=1, ck=ref))
    sv = _ig_join(surv, os.path.join(workdir, "surv"), tag)[0]
    cl = _ig_join(clean, os.path.join(workdir, "clean"), tag)[0]
    if (sv["resumed_from"] != step or sv["launches"] != IG_ITERS - step
            or not np.array_equal(_bits(sv["centers"]),
                                  _bits(cl["centers"]))):
        _fail(f"{tag} survivor: resumed from {sv['resumed_from']} (want "
              f"{step}), {sv['launches']} launches, bit-equal to the clean "
              "resume: "
              f"{np.array_equal(_bits(sv['centers']), _bits(cl['centers']))}")
    rel = _rel(np.asarray(sv["centers"]), np.asarray(x["off_centers"]))
    _say(f"{tag} one-process survivor world resumed from step "
         f"{sv['resumed_from']} with {sv['launches']} k-means launches, "
         f"centers bit-equal to a clean one-process resume of a copy of "
         f"the snapshots; {rel:.2e} relative to the 2-rank flag-off "
         f"centers (one rank sums its points in another order)")
    _say(f"{tag} phase {time.perf_counter() - t0:.1f} s on {card}")
    return {"launches": [rr["clean_launches"] for rr in r],
            "ips_off": x["ips_off"], "ips_on": x["ips_on"]}


def _ig_incremental(st, kk, card: str, dev, kmr: dict) -> dict:
    """One rank's streams of [incremental_group]."""
    from spartan_tpu_torch.examples import streaming
    from spartan_tpu_torch.expr import incremental as inc
    from spartan_tpu_torch.kernels import gemv as kg
    from spartan_tpu_torch.utils.config import FLAGS

    tag = "[incremental_group]"
    FLAGS.result_cache_bytes = INC_CACHE_BYTES
    out = {"window": _inc_window(st, card, dev, IGI_PUSHES, tag)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(83)
    n = IGI_PR_N
    a = torch.rand((n, n), generator=gen, device=dev)
    a /= a.sum(1, keepdim=True)
    width = -(-n * int(INC_FRAC * 1000) // 1000)
    starts = [(j * 7919 * width) % (n - width)
              for j in range(1, IGI_PR_BATCHES + 1)]
    kg.LAUNCHES["fixed_order_dot"] = 0
    on = _inc_pagerank_arm(st, streaming, a, starts, width, True)
    out["gemv_launches"] = kg.LAUNCHES["fixed_order_dot"]
    off = _inc_pagerank_arm(st, streaming, a, starts, width, False)
    del a
    equal = torch.equal(on[0], off[0])
    _say(f"{tag} PageRank dense {n}^2 f32, {IGI_PR_BATCHES} batches of "
         f"{width} columns: step median {np.median(on[2]):.3f} ms on, "
         f"{np.median(off[2]):.3f} ms off; seam write median "
         f"{np.median(on[1]):.3f} ms; counters on {on[3]}; modes "
         f"{on[4]}; fixed_order_dot launches in the on arm "
         f"{out['gemv_launches']}; ranks bit-equal {equal} on {card}")
    if not equal:
        _fail(f"{tag} PageRank is not bit-equal")
    if (on[3]["hits"] != IGI_PR_BATCHES or on[3]["fallbacks"] != 0
            or any(r != "incremental" for r in on[4])):
        _fail(f"{tag} PageRank's warm steps were not all served: "
              f"{on[3]}, {on[4]}")
    if out["gemv_launches"] != IGI_PR_BATCHES + 1:
        _fail(f"{tag} the on arm launched fixed_order_dot "
              f"{out['gemv_launches']} times, want {IGI_PR_BATCHES + 1}")
    out["pagerank"] = {"on_ms": float(np.median(on[2])),
                       "off_ms": float(np.median(off[2])),
                       "seam_ms": float(np.median(on[1])),
                       "counters": on[3], "reasons": on[4]}
    out["refine"] = _inc_refine(st, kk, card, dev, kmr, tag, runs=3)
    FLAGS.incremental = False
    inc.clear()
    return out


def phase_incremental_group(st, card: str, workdir: str) -> dict:
    """[incremental_group] (section comment above)."""
    t0 = time.perf_counter()
    pts_np, c0_np, _ = _data(LOCAL_KM_N, KM_D, KM_K, "clustered", 0)
    base = {"points": os.path.join(workdir, "points.npy"),
            "c0": os.path.join(workdir, "c0.npy"), "card": card}
    if not os.path.exists(base["points"]):
        np.save(base["points"], pts_np)
        np.save(base["c0"], c0_np)
    del pts_np
    d = os.path.join(workdir, "inc")
    r = _ig_join(_ig_world(d, dict(base, kind="incremental", world=2)), d,
                 "[incremental_group]")
    for key in ("window", "pagerank", "refine"):
        if r[0][key]["counters"] != r[1][key]["counters"]:
            _fail(f"[incremental_group] the ranks' {key} counters differ: "
                  f"{r[0][key]['counters']} / {r[1][key]['counters']}")
    if r[0]["pagerank"]["reasons"] != r[1]["pagerank"]["reasons"]:
        _fail("[incremental_group] the ranks' PageRank reasons differ")
    w0 = r[0]["window"]["counters"]
    _say(f"[incremental_group] both ranks alike: window {w0}, PageRank "
         f"{r[0]['pagerank']['counters']}, refine "
         f"{r[0]['refine']['counters']} with row-1 launches a rank "
         f"{[rr['refine']['launches'] for rr in r]}; phase "
         f"{time.perf_counter() - t0:.1f} s on {card}")
    return {"refine_launches": [rr["refine"]["launches"][0] for rr in r],
            "gemv_launches": [rr["gemv_launches"] for rr in r],
            "window_on_ms": r[0]["window"]["on_ms"],
            "window_off_ms": r[0]["window"]["off_ms"]}


def monitor_child(workdir: str, rank: int) -> None:
    """One rank of [monitor]'s two-process gloo group on the one card:
    each rank burns its own SLO class, then ``st.fleet_status()`` over a
    shared fleet directory after a barrier."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import spartan_tpu_torch as st
    from spartan_tpu_torch.obs import slo
    from spartan_tpu_torch.parallel import mesh as mesh_mod
    from spartan_tpu_torch.utils.config import FLAGS

    dev = _child_device()
    st.set_default_device(dev)
    if not mesh_mod.initialize_distributed(
            "file://" + os.path.join(workdir, "store"),
            num_processes=GROUP_RANKS, process_id=rank, backend="gloo",
            device=dev, timeout_s=GROUP_TIMEOUT_S):
        _fail("[monitor] child: no process group")
    import torch.distributed as dist

    FLAGS.monitor_fleet_dir = os.path.join(workdir, "fleet")
    FLAGS.serve_slo_classes = "gold=0.001@0.9"
    FLAGS.serve_slo_tenants = "hot=gold"
    for _ in range(4 + 4 * rank):  # rank 1 burns more
        slo.observe("hot", 1.0)
    for _ in range(6 - 2 * rank):
        slo.observe("hot", 0.0)
    st.fleet_status()  # publish
    dist.barrier()
    fs = st.fleet_status()
    dist.barrier()
    with open(os.path.join(workdir, f"fleet{rank}.json"), "w") as f:
        json.dump({"rank": rank, "process_count": fs["process_count"],
                   "ranks_reporting": fs["ranks_reporting"],
                   "slo_worst": fs["slo_worst"],
                   "anomalies_total": fs["anomalies_total"]}, f)
    mesh_mod.shutdown()


def _mon_overhead(st, km, card: str, kmr: dict) -> dict:
    from spartan_tpu_torch.obs import monitor
    from spartan_tpu_torch.utils.config import FLAGS

    pts, c0 = kmr["points"], st.from_numpy(kmr["c0"])
    _step_ips(st, km, pts, c0, 20)
    prev = (FLAGS.monitor, FLAGS.monitor_interval_s)
    on_ips, off_ips, ticks = [], [], []
    try:
        for _ in range(MON_REPS):
            FLAGS.monitor = False
            off_ips.append(_step_ips(st, km, pts, c0, MON_ITERS))
            FLAGS.monitor, FLAGS.monitor_interval_s = True, MON_INTERVAL_S
            s0 = monitor.MONITOR.health()["samples"]
            monitor.start()
            on_ips.append(_step_ips(st, km, pts, c0, MON_ITERS))
            monitor.stop()
            h = monitor.MONITOR.health()
            ticks.append((h["samples"] - s0, h["tick_us_mean"]))
    finally:
        monitor.stop()
        FLAGS.monitor, FLAGS.monitor_interval_s = prev
    cost = 1.0 - max(on_ips) / max(off_ips)
    seen = [(a["kind"], a["key"], a["value"])
            for a in monitor.recent_anomalies(64)]
    _say(f"[monitor] anomalies so far (the earlier phases' records): "
         f"{seen} on {card}")
    _say(f"[monitor] config-3 kmeans_step {max(off_ips):.2f} iters/s with "
         f"the monitor off, {max(on_ips):.2f} on at interval "
         f"{MON_INTERVAL_S} s (best of {MON_REPS}, {MON_ITERS} evaluates "
         f"each, alternated): overhead {100 * cost:.2f}%; ticks a run and "
         f"sample_tick_us (mean) {ticks} on {card}")
    if not all(n >= 1 for n, _ in ticks):
        _fail(f"[monitor] the sampler did not tick: {ticks}")
    return {"monitor_overhead": cost, "sample_tick_us": ticks[-1][1]}


def _mon_drift(st, kk, km, card: str, kmr: dict) -> None:
    """A planted 4x calibration drift: the detector fires, the daemon
    refits and swaps or reverts; a swap's warm-up evaluates the k-means
    step on the card (row 1 launches) and the step stays bit-equal."""
    from spartan_tpu_torch.obs import ledger, monitor
    from spartan_tpu_torch.utils.config import FLAGS

    saved = {k: getattr(FLAGS, k) for k in (
        "monitor_autotune", "monitor_drift_patience", "monitor_cooldown_s",
        "monitor_swap_margin", "cost_ledger", "cost_calibration",
        "calibration_drift_tol")}
    try:
        FLAGS.cost_ledger = True
        FLAGS.monitor_autotune = True
        FLAGS.monitor_drift_patience = 2
        FLAGS.monitor_cooldown_s = 0.0
        # margin 0: the daemon keeps any candidate that models no loss,
        # so the phase drives the swap path and its warm-up
        FLAGS.monitor_swap_margin = 0.0
        FLAGS.calibration_drift_tol = 0.693
        from spartan_tpu_torch.expr import base

        # the earlier phases' records (the served window's service times
        # among them) would dilute the planted drift: start the ledger
        # afresh, and make the k-means step's plan a miss again
        ledger.reset()
        base.clear_plan_cache()
        # the overhead runs' ticks may already have a streak on the
        # served window's service times: the planted drift starts one
        monitor.MONITOR.drift.reset()
        with st.use_mesh(st.build_mesh((4, 2))):
            c0 = st.from_numpy(kmr["c0"])
            pts = st.as_expr(st.DistArray(kmr["points"].value.tensor,
                                          st.Tiling(("x", None)),
                                          st.get_mesh()))
            before = km.kmeans_step(pts, c0, KM_K).evaluate().tensor.clone()
            if not monitor.MONITOR.autotune.templates():
                _fail("[monitor] the miss registered no hot-plan template")
            # the installed profile prices every class 4x off, and the
            # measured service times run 4x under the prediction
            cls = ("map", "contraction", "reshard", "psum", "reduce")
            ledger.set_profile(ledger.CalibrationProfile(
                {c: MON_DRIFT for c in cls}))
            FLAGS.cost_calibration = True
            rng = np.random.RandomState(85)
            for i in range(12):
                comp = {c: float(rng.uniform(10.0, 100.0)) for c in cls}
                ledger.ingest(f"drift-{i}", comp, 1e-6 * sum(
                    (4.0 if c == "psum" else 1.0) * v
                    for c, v in comp.items()))
            fired, t = [], 0.0
            _reset_counts(kk)
            while not fired and t < 20:
                ledger.note_service("drifting-plan", MON_DRIFT * 1e-3,
                                    1e-3)
                fired = [a for a in monitor.sample(t)
                         if a.kind == "calibration_drift"]
                t += 1.0
            torch.cuda.synchronize()
            warm_launches = kk.LAUNCHES
            events = [e for e in monitor.MONITOR.autotune.events
                      if e["event"] in ("refit", "swap", "revert", "skip")]
            after = km.kmeans_step(pts, c0, KM_K).evaluate().tensor
            equal = torch.equal(before, after)
        _say(f"[monitor] planted {MON_DRIFT:g}x drift: anomaly "
             f"{fired[0] if fired else None} after {int(t)} samples; "
             f"daemon {[(e['event'], e.get('modeled_win'), e.get('warmed'), e.get('reason')) for e in events]}"
             f"; row-1 launches in the warm-up {warm_launches}; the step "
             f"bit-equal after the decision: {equal} on {card}")
        if not fired:
            _fail("[monitor] the drift anomaly did not fire")
        last = events[-1]["event"] if events else None
        if last not in ("swap", "revert"):
            _fail(f"[monitor] the daemon decided nothing: {events}")
        if last == "swap" and (warm_launches < 1
                               or not events[-1].get("warmed")):
            _fail("[monitor] the swap's warm-up launched no k-means step")
        if not equal:
            _fail("[monitor] the k-means step moved under the new profile")
    finally:
        ledger.set_profile(None)
        for k, v in saved.items():
            setattr(FLAGS, k, v)
        monitor.MONITOR.autotune.reset()


def _mon_surfaces(st, card: str, workdir: str) -> None:
    """The ``sdc`` anomaly of [guards]' quarantine, the fence of
    [resilience]'s rebuild, ``st.status()``, and ``st.fleet_status()``
    over two gloo ranks."""
    from spartan_tpu_torch.obs import monitor

    anoms = monitor.recent_anomalies(64)
    sdc = [a for a in anoms if a["kind"] == "sdc"]
    fences = st.REGISTRY.counter("monitor_epoch_fences").value
    s = st.status()
    _say(f"[monitor] sdc anomalies from [guards]' quarantine: "
         f"{[(a['key'], a['value'], a['threshold']) for a in sdc]}; epoch "
         f"fences since [resilience]'s rebuild {fences}; st.status(): "
         f"platform {s['platform']}, mesh {s['mesh']}, daemon "
         f"{s['daemon']['state']}, {len(s['anomalies'])} anomalies, "
         f"integrity {(s['integrity'] or {}).get('quarantined')}, monitor "
         f"{s['monitor']} on {card}")
    if not sdc:
        _fail("[monitor] no sdc anomaly from [guards]' quarantine")
    if fences < 1:
        _fail("[monitor] [resilience]'s rebuild fenced no monitor")
    # [guards] resets the sentinel after its run, so the integrity line
    # is None here; its quarantine lives on as the sdc anomaly above
    want = {"platform", "mesh", "serve", "slo", "anomalies", "daemon",
            "calibration", "skew", "integrity", "monitor"}
    if not s["anomalies"] or not want <= set(s) or \
            s["monitor"]["samples"] < 1:
        _fail(f"[monitor] st.status() is not filled: {sorted(s)}")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--monitor-child", workdir, str(r)])
             for r in range(GROUP_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=GROUP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _fail(f"[monitor] a child did not finish in {GROUP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        _fail(f"[monitor] children exited {[p.returncode for p in procs]}")
    res = []
    for r in range(GROUP_RANKS):
        with open(os.path.join(workdir, f"fleet{r}.json")) as f:
            res.append(json.load(f))
    _say(f"[monitor] st.fleet_status() on {GROUP_RANKS} gloo ranks: "
         + "; ".join(f"rank {d['rank']}: process_count "
                     f"{d['process_count']}, ranks reporting "
                     f"{d['ranks_reporting']}, worst burn {d['slo_worst']}"
                     for d in res)
         + f" ({time.perf_counter() - t0:.1f} s) on {card}")
    for d in res:
        w = d["slo_worst"].get("gold") or {}
        if (d["process_count"] != GROUP_RANKS
                or d["ranks_reporting"] != GROUP_RANKS or w.get("rank") != 1):
            _fail(f"[monitor] fleet view of rank {d['rank']}: {d}")


def phase_monitor(st, kk, km, card: str, kmr: dict, workdir: str) -> dict:
    """[monitor]: the continuous monitor on the card (module docstring)."""
    t0 = time.perf_counter()
    out = _mon_overhead(st, km, card, kmr)
    _mon_drift(st, kk, km, card, kmr)
    _mon_surfaces(st, card, workdir)
    _say(f"[monitor] phase {time.perf_counter() - t0:.1f} s on {card}")
    return out


def phase_benchguard(card: str, figures: dict) -> None:
    """[benchguard]: the run's steady figures against
    ``spartan_tpu_torch/utils/thresholds.json``'s ``cuda`` entry, graded
    only on the card (``nvidia-smi``'s name and power limit, ``card``)
    that file names."""
    from spartan_tpu_torch.utils import benchguard

    want = benchguard.load_thresholds("cuda").get("card") or {}
    if want.get("nvidia_smi") != card:
        _say(f"[benchguard] ungraded: {card} (the thresholds file names "
             f"{want.get('nvidia_smi')})")
        return
    g = benchguard.check(figures, "cuda")
    for name, r in sorted(g["results"].items()):
        bound = (f">= {r['min']}" if "min" in r else
                 f"<= {r['max']}" if "max" in r else "unchecked")
        _say(f"[benchguard] {name} {r['value']!r} {bound}: "
             f"{'ok' if r['pass'] else 'BREACH' if r['pass'] is False else '-'}")
    _say(f"[benchguard] {g['checked']} figures graded on {card}: "
         f"{'pass' if g['pass'] else 'FAIL'}")
    if not g["pass"]:
        bad = [f"{k} {r['value']!r} (bound {r.get('min', r.get('max'))})"
               for k, r in g["results"].items() if r["pass"] is False]
        _fail(f"[benchguard] regression: {', '.join(bad)}")


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
    if len(sys.argv) == 4 and sys.argv[1] == "--monitor-child":
        monitor_child(sys.argv[2], int(sys.argv[3]))
        return
    if len(sys.argv) == 4 and sys.argv[1] == "--group-guard-child":
        group_guard_child(sys.argv[2], int(sys.argv[3]))
        return
    if len(sys.argv) == 3 and sys.argv[1] == "--gemv-split-child":
        gemv_split_child(sys.argv[2])
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
    from spartan_tpu_torch.kernels import gemv as kg
    from spartan_tpu_torch.kernels import histogram as kh
    from spartan_tpu_torch.kernels import segment as ks
    from spartan_tpu_torch.kernels import stencil as kst
    from spartan_tpu_torch.kernels import topk as kt
    from spartan_tpu_torch.ops import segment as seg

    t_start = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda")
    st.set_default_device(dev)
    _COUNTED[:] = [ks, kx, kt, kh, kst, kg]
    phase_build(build_mod, (kk._load, ks._load, kx._load, kt._load,
                            kh._load, kst._load, kg._load))
    _histogram_layout(kh, dev)
    max_err = phase_kernel_vs_plain(kk, dev)
    phase_pack_kernel(kx, dev)
    topk_err = phase_topk_kernel(kt, dev)
    hist_err = phase_bincount_kernel(kh, dev)
    stencil_err = phase_stencil_kernel(kst, dev)
    gemv = phase_gemv(kg, card, dev)
    phase_gemv_split(card, gemv["cases"])
    t0 = time.perf_counter()
    links = pagerank_links(st.SparseDistArray)
    links.transition()._ensure_plan()
    _say(f"[pagerank] set-up (from_coo, transition, plan) "
         f"{time.perf_counter() - t0:.2f} s")
    seg_err = phase_segment_kernels(ks, seg, links.transition(), dev)
    dotr = phase_dot(st, card)
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
    incr = phase_incremental(st, kk, kg, km, card, dev, kmr)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_group_guard_")
    try:
        igr = phase_integrity_group(st, card, workdir)
        incg = phase_incremental_group(st, card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_monitor_")
    try:
        phase_monitor(st, kk, km, card, kmr, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    figures = {
        "dot_gflops": dotr["gflops"], "kmeans_iters_per_sec": kmr["ips"],
        "pagerank_iters_per_sec": prr["ips"],
        "logreg_iters_per_sec": exr["logreg_iters_per_sec"],
        "ssvd_seconds": exr["ssvd_s"], "naive_bayes_fit_ms": nbr["fit_ms"],
        "kernel_ms:kmeans_assign_accumulate": kmr["ms"],
        "kernel_ms:windowed_segsum": prr["ms"],
        "kernel_ms:segment_sum_block": abr["ms"],
        "kernel_ms:partition_pack": sortr["ms"],
        "kernel_ms:shard_topk": topkr["ms"],
        "kernel_ms:bincount_block": histr["ms"],
        "kernel_ms:conv_block": vggr["ms"]}
    phase_benchguard(card, figures)
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
        "serve_launches": serve["launches"],
        "group_integrity_kmeans_launches_per_rank": igr["launches"],
        "group_incremental_refine_launches_per_rank":
            incg["refine_launches"]}, {
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
        "group_launches_per_rank": grp["segment"],
        "local_launches_per_rank": loc["segment_sum_block"]}, {
        "name": "partition_pack", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/exchange.cu",
        "replaces": "spartan_tpu/kernels/exchange.py:31",
        "launches": sortr["launches"], "max_abs_err": 0.0,
        "ms": sortr["ms"], "plain_ms": sortr["plain_ms"],
        "bound_ms": sortr["bound_ms"], "bound_by": sortr["bound_by"],
        "library_ms": sortr["library_ms"],
        "local_launches_per_rank": loc["partition_pack"],
        "local_batched_sort_launches_per_rank":
            loc["batched_partition_pack"],
        "local_sparse_sort_launches_per_rank":
            loc["sparse_partition_pack"],
        "serve_launches": serve["kernels"]["partition_pack"]}, {
        "name": "shard_topk", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/topk.cu",
        "replaces": "spartan_tpu/kernels/topk.py:30",
        "launches": topkr["launches"], "max_abs_err": topk_err,
        "ms": topkr["ms"], "plain_ms": topkr["plain_ms"],
        "bound_ms": topkr["bound_ms"], "bound_by": topkr["bound_by"],
        "library_ms": topkr["library_ms"],
        "local_launches_per_rank": loc["shard_topk"],
        "serve_launches": serve["kernels"]["shard_topk"]}, {
        "name": "bincount_block", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/histogram.cu",
        "replaces": "spartan_tpu/kernels/histogram.py:24",
        "launches": histr["launches"], "max_abs_err": hist_err,
        "ms": histr["ms"], "plain_ms": histr["plain_ms"],
        "bound_ms": histr["bound_ms"], "bound_by": histr["bound_by"],
        "library_ms": histr["library_ms"], "unique_ms": histr["unique_ms"],
        "unique_bound_ms": histr["unique_bound_ms"],
        "unique_library_ms": histr["unique_library_ms"],
        "group_launches_per_rank": grp["bincount"],
        "local_histogram_launches_per_rank": loc["bincount_block"],
        "serve_launches": serve["kernels"]["bincount_block"]}, {
        "name": "conv_block", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/stencil.cu",
        "replaces": "spartan_tpu/kernels/stencil.py:32",
        "launches": vggr["launches"], "max_abs_err": stencil_err,
        "ms": vggr["ms"], "plain_ms": vggr["plain_ms"],
        "bound_ms": vggr["bound_ms"], "bound_by": vggr["bound_by"],
        "bound_fp32_ms": vggr["bound_fp32_ms"],
        "library_ms": vggr["library_ms"],
        "group_launches_per_rank": grp["conv_block"],
        "local_vgg_launches_per_rank": loc["conv_block"],
        "serve_launches": serve["kernels"]["conv_block"]}, {
        "name": "fixed_order_dot", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/gemv.cu",
        "replaces": "spartan_tpu/expr/dot.py:93 (no Pallas kernel: "
                    "XLA's dot of a vector product)",
        "launches": incr["gemv_launches"], "max_abs_err":
            gemv["max_abs_err"], "ms": gemv["ms"],
        "plain_ms": gemv["plain_ms"], "bound_ms": gemv["bound_ms"],
        "bound_by": gemv["bound_by"], "library_ms": gemv["library_ms"],
        "group_incremental_launches_per_rank": incg["gemv_launches"]}]}))
    _say(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f}"
         " s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
