"""Counters, phase timers and profiling entry points.

Port of ``spartan_tpu/utils/profiling.py``: a thin facade over
``spartan_tpu_torch/obs``. Counters and per-phase timers live in the
typed metrics registry (``obs.metrics.REGISTRY``; snapshot via
``st.metrics()``), and :func:`phase` both feeds the per-phase
histograms and emits a span into the trace ring (``st.trace_export``).
``count`` / ``counters`` / ``record_phase`` / ``phase_seconds`` /
``reset_counters`` / ``plan_cache_stats`` read the same shapes as in
the JAX package.

Every timer here reads the host clock and nothing else: a phase around
a kernel launch times the launch, never the kernel, and no phase
synchronises the device. Device time comes from :func:`profile_trace`
(a ``torch.profiler`` capture) or CUDA events around the work.

``cost_analysis`` reads XLA's compiled program in the JAX package; the
port has no compiled program and counts it (``st.explain``'s
``cost_analysis``). ``hlo_text`` raises: its counterpart is the plan
audit, ``st.audit_plan``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from ..obs.metrics import METRICS_FLAG as _METRICS_FLAG
from ..obs.metrics import REGISTRY
from ..obs.trace import SpanCtx as _SpanCtx
from ..obs.trace import annotate as _obs_annotate
from ..obs.trace import device_profile as _obs_device_profile
from ..obs.trace import span as _obs_span
from .config import FLAGS
from .log import log_info

# re-exported so call sites can say ``prof.span(...)`` /
# ``prof.device_profile(...)`` without importing obs directly
span = _obs_span
device_profile = _obs_device_profile

# -- plan-cache counters and per-phase timers ----------------------------
#
# The evaluate() path (expr/base.py) is instrumented with named counters
# (plan_hits / plan_misses / donated_dispatches / evaluations) and
# per-phase wall-time histograms:
#
#   sign      structural signing (raw-DAG plan signature + optimized-DAG
#             signature)
#   optimize  the optimizer pass stack (plus per-pass ``pass:<name>``
#             and the smart-tiling ``tiling`` sub-phase)
#   build     Python-side assembly around dispatch: leaf gathering,
#             DistArray result wrapping
#   dispatch  the walk of the plan's DAG, which launches its kernels
#
# The JAX package's ``compile`` phase (trace + XLA compile) has no
# counterpart: torch runs eagerly, so a plan's first walk is a dispatch
# like every other. Counters are process-global; tests and benchmarks
# bracket a region with reset_counters() and read counters() after.

_PHASE_PREFIX = "phase:"


def count(name: str, n: int = 1) -> None:
    if _METRICS_FLAG._value:
        REGISTRY.counter(name).inc(n)


# phase-name -> Histogram handle; registry reset() zeroes instruments
# in place (it never replaces them), so cached handles stay valid
_phase_hists: Dict[str, Any] = {}


def record_phase(name: str, seconds: float) -> None:
    if _METRICS_FLAG._value:
        h = _phase_hists.get(name)
        if h is None:
            h = REGISTRY.histogram(_PHASE_PREFIX + name)
            _phase_hists[name] = h
        h.observe(seconds)


class _PhaseCtx(_SpanCtx):
    """The span context of :func:`phase`: a SpanCtx (one allocation,
    two clock reads) whose measured ``.seconds`` also feeds the
    per-phase histogram on exit."""

    __slots__ = ()

    def __init__(self, name: str):
        super().__init__(name, None)

    def __exit__(self, et, ev, tb) -> bool:
        r = super().__exit__(et, ev, tb)
        record_phase(self.name, self.seconds)
        return r


def phase(name: str) -> _PhaseCtx:
    """Time a named phase: a span in the trace ring (marked
    ``error=True`` with the exception type if the block raises) plus an
    observation in the per-phase histogram. Yields the span;
    ``.seconds`` holds the elapsed time after exit."""
    return _PhaseCtx(name)


class Stopwatch:
    """Result of :func:`stopwatch`: ``.elapsed`` seconds after exit."""

    __slots__ = ("elapsed",)

    def __init__(self) -> None:
        self.elapsed = 0.0


@contextlib.contextmanager
def stopwatch() -> Iterator[Stopwatch]:
    """Bare timing context for measurement harnesses: no span, no
    histogram — just ``.elapsed`` (host clock)."""
    sw = Stopwatch()
    t0 = time.perf_counter()
    try:
        yield sw
    finally:
        sw.elapsed = time.perf_counter() - t0


def counters() -> Dict[str, int]:
    """Snapshot of the named counters (plan_hits, plan_misses, ...);
    absent counters read as 0 via .get()."""
    return REGISTRY.counter_values()


def phase_seconds() -> Dict[str, float]:
    """Accumulated per-phase wall time in seconds (the histograms'
    exact sums; p50/p95/max via ``st.metrics()``)."""
    snap = REGISTRY.snapshot()["histograms"]
    return {name[len(_PHASE_PREFIX):]: h["sum"]
            for name, h in snap.items()
            if name.startswith(_PHASE_PREFIX)}


def reset_counters() -> None:
    """Zero every instrument in the registry (registrations survive,
    so snapshots keep stable keys across a reset)."""
    REGISTRY.reset()


def plan_cache_stats() -> Dict[str, Any]:
    """Hit/miss view of the evaluate() plan cache, with the hit rate
    (None before any lookup). ``compiles`` stays 0: the port compiles
    no program per plan."""
    c = counters()
    hits = c.get("plan_hits", 0)
    misses = c.get("plan_misses", 0)
    total = hits + misses
    return {
        "plan_hits": hits,
        "plan_misses": misses,
        "compiles": c.get("compiles", 0),
        "donated_dispatches": c.get("donated_dispatches", 0),
        "hit_rate": (hits / total) if total else None,
    }


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str] = None) -> Iterator[Any]:
    """Capture a device profile (``torch.profiler``, CUDA activity on
    the card) and write its Chrome trace under ``trace_dir`` (default
    ``FLAGS.profile_dir``). Yields the profiler."""
    trace_dir = trace_dir or FLAGS.profile_dir
    with _obs_device_profile(trace_dir) as p:
        yield p
    log_info("profiler trace written to %s", trace_dir)


def cost_analysis(expr) -> Dict[str, Any]:
    """FLOPs / bytes-accessed of an expr's plan: the counted
    ``cost_analysis`` of ``st.explain`` (``obs/explain.count_cost``; per
    device, as the JAX package's XLA read-out, with the whole plan's
    totals under ``program``)."""
    from ..obs.explain import explain

    return explain(expr, cost=True).cost_analysis


def hlo_text(expr) -> str:
    """The JAX package returns the compiled HLO; the port has none."""
    raise NotImplementedError(
        "hlo_text returns XLA's compiled HLO in the JAX package; the port "
        "runs no XLA program. Its counterpart is st.audit_plan(expr): the "
        "collectives a group walk of the plan issues, each attributed to "
        "its node")


def benchmark(fn: Callable[[], Any], iters: int = 5,
              warmup: int = 1) -> Dict[str, float]:
    """Timing harness (host clock). ``fn`` must finish its device work
    before returning (a ``.glom()`` or ``torch.cuda.synchronize()``),
    since nothing here waits for the card."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        with stopwatch() as sw:
            fn()
        times.append(sw.elapsed)
    arr = np.asarray(times)
    return {"best": float(arr.min()), "mean": float(arr.mean()),
            "std": float(arr.std()), "iters": iters}


def device_memory_stats() -> Dict[str, Any]:
    """Per-key {max, sum} memory stats across the visible CUDA devices
    (empty on the CPU)."""
    from ..obs.metrics import device_memory_aggregate

    return device_memory_aggregate()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range visible in profiler traces (delegates to
    ``obs.trace.annotate``)."""
    with _obs_annotate(name):
        yield
