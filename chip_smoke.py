"""Drive the PyTorch/CUDA port (``spartan_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the result line:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every CUDA source of ``spartan_tpu_torch/csrc`` with
   nvcc for sm_90a, one nvcc per source, all at once, and prints each
   kernel's registers and spills;
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
   bit-equal to the plain-driven fit, prediction accuracy;
8. the segment-sum A/B at 1M x 128, k = 64 (kernel, ``index_add_``,
   one-hot product);
9. the ``kernels`` line (times, launches, bounds) and the result line.

Imports torch, numpy and the port only.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# FP32 outside the tensor cores and HBM bandwidth.
_PEAKS = {
    "H100 PCIe": (51e12, 2.0e12),
    "H100": (67e12, 3.35e12),  # SXM
}

KM_N, KM_D, KM_K, KM_ITERS = 1_000_000, 128, 64, 20
DOT_N, DOT_K = 4096, 64
PR_N, PR_DEG, PR_ITERS = 1_000_000, 16, 10
NB_ROWS, NB_FEATURES, NB_CLASSES = 262_144, 2048, 20
SEG_E, SEG_D, SEG_K = 1_000_000, 128, 64


def _say(*args) -> None:
    print(*args, flush=True)


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _peaks(name: str):
    for key, peaks in _PEAKS.items():
        if key in name:
            return peaks
    _fail(f"no published peaks for {name!r}")


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
    ok = (moved <= allowed and err <= tol
          and int(n_k.sum().item()) == v)
    _say(f"[kernel] n={n} d={d} k={k} valid={v} {kind}: moved rows "
         f"{moved} (allowed {allowed}), max |sum err| {err:.3g} "
         f"(tol {tol:.3g}) -> {'ok' if ok else 'MISMATCH'}")
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

    kk.LAUNCHES = 0
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
    ms = _event_ms(lambda: kk.assign_accumulate(p, c0, KM_K, KM_N), 20)
    plain_ms = _event_ms(
        lambda: kk.assign_accumulate_plain(p, c0, KM_K, KM_N), 20)
    lib_ms = _event_ms(lambda: _library(p, c0, KM_K, KM_N), 20)
    flops_peak, bw_peak = _peaks(card)
    ops = 2.0 * KM_N * KM_K * KM_D + KM_N * KM_D
    nbytes = 4.0 * (KM_N * KM_D + KM_K * KM_D + KM_K * KM_D + KM_K)
    t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
    bound_ms = max(t_ops, t_bytes)
    _say(f"[kmeans] {ips:.2f} iters/s ({KM_ITERS}-iteration loop, best of 3); "
         f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
         f"{lib_ms:.4f} (composite cdist+argmin+index_add_) bound_ms "
         f"{bound_ms:.4f} ({'operations' if t_ops >= t_bytes else 'bytes'}"
         f"; ops {t_ops:.4f} ms, bytes {t_bytes:.4f} ms) on {card}")
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


# -- phase 3, segment kernels ---------------------------------------------

_U = 2.0 ** -24  # f32 unit roundoff


def _reset_counts(kk, ks) -> None:
    """Every kernel's launch count to 0 (just before a main path)."""
    kk.LAUNCHES = 0
    for name in ks.LAUNCHES:
        ks.LAUNCHES[name] = 0


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
    _reset_counts(kk, ks)
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
        _reset_counts(kk, ks)
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
        _say(f"[naive_bayes] fit {best * 1e3:.2f} ms (best of 3); "
             f"segment kernel at {NB_ROWS} x {NB_FEATURES}, k = "
             f"{NB_CLASSES}: {ms:.4f} ms on {card}")
    finally:
        st.FLAGS.native_kernels, st.FLAGS.segment_impl = prev
    return {"launches": launches}


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


def main() -> None:
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
    from spartan_tpu_torch.kernels import segment as ks
    from spartan_tpu_torch.ops import segment as seg

    t_start = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda")
    st.set_default_device(dev)
    phase_build(build_mod, (kk._load, ks._load))
    max_err = phase_kernel_vs_plain(kk, dev)
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
    _say(json.dumps({"kernels": [{
        "name": "kmeans_assign_accumulate", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/kmeans.cu",
        "replaces": "spartan_tpu/kernels/kmeans.py:45",
        "launches": kmr["launches"], "max_abs_err": max_err,
        "ms": kmr["ms"], "plain_ms": kmr["plain_ms"],
        "bound_ms": kmr["bound_ms"], "bound_by": kmr["bound_by"],
        "library_ms": kmr["library_ms"]}, {
        "name": "windowed_segsum", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/segment.cu",
        "replaces": "spartan_tpu/kernels/segment.py:148",
        "launches": prr["launches"], "max_abs_err": seg_err["windowed_err"],
        "ms": prr["ms"], "plain_ms": prr["plain_ms"],
        "bound_ms": prr["bound_ms"], "bound_by": prr["bound_by"],
        "library_ms": prr["library_ms"]}, {
        "name": "segment_sum_block", "route": "cuda",
        "source": "spartan_tpu_torch/csrc/segment.cu",
        "replaces": "spartan_tpu/kernels/segment.py:33",
        "launches": nbr["launches"], "max_abs_err": seg_err["block_err"],
        "ms": abr["ms"], "plain_ms": abr["plain_ms"],
        "bound_ms": abr["bound_ms"], "bound_by": abr["bound_by"],
        "library_ms": abr["library_ms"]}]}))
    _say(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f}"
         " s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
