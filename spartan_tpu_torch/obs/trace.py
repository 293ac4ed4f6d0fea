"""Span tracer: nested wall-time spans for the plan lifecycle.

Port of ``spartan_tpu/obs/trace.py``. Every ``evaluate()`` emits a span
tree (evaluate -> sign -> optimize -> per-pass -> tiling -> build ->
dispatch; see ``utils/profiling.phase``) carrying the plan-cache key,
hit/miss status and the user build site. Spans are ring-buffered in
memory (``FLAGS.trace_ring``) and exportable as Chrome trace-event JSON
in the JAX package's schema via ``st.trace_export(path)`` — load the
file at https://ui.perfetto.dev or chrome://tracing. ``FLAGS.trace``
toggles recording; the recording cost is one clock pair and a
lock-guarded deque append per span. Spans read the host clock only:
nothing here synchronises the device, so a span around a launch times
the launch, not the kernel.

Device-side attribution is separate: ``device_profile`` is a
``torch.profiler`` capture, and ``annotate`` / ``named_scope`` are
``torch.profiler.record_function`` ranges inside it.

This module imports only torch and the config layer — never the expr
or array layers — so every subsystem can emit spans without import
cycles.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Iterator, List, Optional

import torch

from ..utils.config import FLAGS

# the hot span path reads ._value directly (one attribute load) instead
# of FLAGS.__getattr__'s dict walk; FLAGS.trace = x lands on the same Flag
_TRACE_FLAG = FLAGS.flag("trace")
_RING_FLAG = FLAGS.flag("trace_ring")


def now() -> float:
    """The tracer clock (seconds, monotonic). All span timestamps and
    the phase timers share it."""
    return time.perf_counter()


_EPOCH = now()  # process trace epoch: span .ts is microseconds since this


def epoch() -> float:
    """The process trace epoch on the tracer clock: other timestamps
    can be reported on the same axis as span ``ts`` values."""
    return _EPOCH


@contextlib.contextmanager
def device_profile(trace_dir: str) -> Iterator[Any]:
    """The one device-profile entry point: a ``torch.profiler.profile``
    capture (CUDA activity too when a card is present) whose Chrome
    trace is written into ``trace_dir`` on exit. Yields the profiler,
    so callers can read ``key_averages()``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace_{os.getpid()}_{now():.6f}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named host range visible inside a :func:`device_profile` capture
    (``torch.profiler.record_function``; it also emits an NVTX range
    under ``torch.autograd.profiler.emit_nvtx``)."""
    with torch.profiler.record_function(name):
        yield


def profiler_active() -> bool:
    """True while a torch profiler is recording: ``Expr.lower`` wraps
    nodes in :func:`named_scope` only then (``FLAGS.trace_annotations``),
    so an unprofiled evaluate pays one call, not a range per node."""
    return torch.autograd.profiler._is_profiler_enabled


@contextlib.contextmanager
def named_scope(name: str) -> Iterator[None]:
    """A fixed label around a block of device work (the ``st.loop``
    body, an expr node), visible in device profiles: the counterpart of
    the JAX package's ``jax.named_scope``."""
    with torch.profiler.record_function(name):
        yield


class Span:
    """One completed (or in-flight) span. ``ts``/``dur`` are in
    microseconds since the process trace epoch, matching the Chrome
    trace-event ``ts``/``dur`` fields."""

    __slots__ = ("name", "ts", "dur", "tid", "depth", "args", "error",
                 "seconds")

    def __init__(self, name: str, ts: float, tid: int, depth: int):
        self.name = name
        self.ts = ts
        self.dur = 0.0
        self.tid = tid
        self.depth = depth
        self.args: Optional[Dict[str, Any]] = None
        self.error = False
        self.seconds = 0.0

    def set(self, **kw: Any) -> None:
        """Attach key/value annotations (exported under Chrome ``args``)."""
        if self.args is None:
            self.args = {}
        self.args.update(kw)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, ts={self.ts:.1f}us, "
                f"dur={self.dur:.1f}us, tid={self.tid}, "
                f"depth={self.depth}, error={self.error})")


class _NullSpan:
    """Sink yielded when tracing is off: same surface, records nothing."""

    __slots__ = ("seconds",)

    def __init__(self) -> None:
        self.seconds = 0.0

    def set(self, **kw: Any) -> None:
        pass


_NULL = _NullSpan()

_lock = threading.Lock()
_ring: Deque[Span] = deque(maxlen=max(1, FLAGS.trace_ring))
_tls = threading.local()
_tids: Dict[int, int] = {}  # threading ident -> small stable tid
# tid -> stack of OPEN spans (entered, not yet exited): the in-flight
# span tree of a hung call (the ring only ever sees COMPLETED spans,
# the wrong set during a hang).
_open: Dict[int, List[Span]] = {}


def _tid() -> int:
    ident = threading.get_ident()
    tid = _tids.get(ident)
    if tid is None:
        with _lock:
            tid = _tids.setdefault(ident, len(_tids))
    return tid


def _depth(delta: int) -> int:
    d = getattr(_tls, "depth", 0)
    _tls.depth = d + delta
    return d


def _append(sp: Span) -> None:
    global _ring
    with _lock:
        size = max(1, _RING_FLAG._value)
        if _ring.maxlen != size:
            _ring = deque(_ring, maxlen=size)
        _ring.append(sp)


class SpanCtx:
    """Hand-rolled context manager behind :func:`span` — the hot
    evaluate path enters ~5 of these per dispatch, so no generator
    frames and exactly two clock reads per span. ``.seconds`` on the
    ctx (and on the recorded span) carries the elapsed wall time after
    exit, including when tracing is off."""

    __slots__ = ("name", "init_args", "sp", "t0", "seconds")

    def __init__(self, name: str, args: Optional[Dict[str, Any]]):
        self.name = name
        self.init_args = args
        self.sp: Optional[Span] = None
        self.t0 = 0.0
        self.seconds = 0.0

    def __enter__(self) -> Any:
        self.t0 = now()
        if not _TRACE_FLAG._value:
            return _NULL
        sp = Span(self.name, (self.t0 - _EPOCH) * 1e6, _tid(),
                  _depth(+1))
        if self.init_args:
            sp.args = dict(self.init_args)
        self.sp = sp
        with _lock:
            _open.setdefault(sp.tid, []).append(sp)
        return sp

    def __exit__(self, et, ev, tb) -> bool:
        t1 = now()
        self.seconds = t1 - self.t0
        sp = self.sp
        if sp is None:
            _NULL.seconds = self.seconds
            return False
        if et is not None:
            # a raising block still records its span, marked as failed
            sp.error = True
            sp.set(exc=et.__name__)
        sp.dur = (t1 - _EPOCH) * 1e6 - sp.ts
        sp.seconds = self.seconds
        _depth(-1)
        with _lock:
            stack = _open.get(sp.tid)
            if stack and sp in stack:
                stack.remove(sp)  # usually the top; raise-paths may skip
        _append(sp)
        return False


def span(name: str, **args: Any) -> SpanCtx:
    """Record a nested span around the enclosed block.

    The yielded object supports ``.set(key=value)`` for annotations
    added mid-flight (e.g. plan-cache hit/miss once known). A raising
    block still records the span, marked ``error=True`` with the
    exception type under ``args["exc"]`` — failed evaluates stay
    visible in traces. ``.seconds`` carries the elapsed wall time
    after exit (also set when tracing is off, for callers that only
    want the measurement)."""
    return SpanCtx(name, args or None)


def events() -> List[Span]:
    """Snapshot of the ring buffer, oldest first (completion order)."""
    with _lock:
        return list(_ring)


def inflight() -> List[Dict[str, Any]]:
    """Snapshot of the OPEN spans, per thread, outermost first — the
    span tree a hung dispatch is stuck inside. Each entry carries the
    elapsed wall time so far (``elapsed_s``); the numerics watchdog
    serializes this into the crash dump."""
    t = now()
    out: List[Dict[str, Any]] = []
    with _lock:
        for tid, stack in sorted(_open.items()):
            for sp in stack:
                out.append({
                    "name": sp.name, "tid": tid, "depth": sp.depth,
                    "ts_us": sp.ts,
                    "elapsed_s": round(t - _EPOCH - sp.ts / 1e6, 6),
                    "args": dict(sp.args) if sp.args else {},
                })
    return out


def instant(name: str, error: bool = False, **args: Any) -> None:
    """Record a zero-duration marker span (health words, watchpoint
    checks). No-op when tracing is off."""
    if not _TRACE_FLAG._value:
        return
    sp = Span(name, (now() - _EPOCH) * 1e6, _tid(), 0)
    sp.error = error
    if args:
        sp.args = dict(args)
    _append(sp)


def clear() -> None:
    with _lock:
        _ring.clear()
    _loop_prev.clear()


def export(path: Optional[str] = None, clear_after: bool = False) -> Dict:
    """Export the span ring as a Chrome trace-event JSON document
    (Perfetto / chrome://tracing loadable).

    Every span becomes one complete ('ph': 'X') event with ``ts`` /
    ``dur`` in microseconds; nesting is implicit from containment on
    the same ``tid``. Returns the document; also writes it to ``path``
    when given."""
    pid = os.getpid()
    evts = []
    for sp in sorted(events(), key=lambda s: (s.tid, s.ts, -s.dur)):
        args: Dict[str, Any] = {"depth": sp.depth}
        if sp.error:
            args["error"] = True
        if sp.args:
            args.update(sp.args)
        evts.append({
            "name": sp.name,
            "ph": "X",
            "ts": sp.ts,
            "dur": sp.dur,
            "pid": pid,
            "tid": sp.tid,
            "args": args,
        })
    doc = {"traceEvents": evts, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
        from ..utils.log import log_info  # lazy: log-free at import

        log_info(
            "trace: %d span(s) written to %s (load at "
            "https://ui.perfetto.dev)", len(evts), path)
    if clear_after:
        clear()
    return doc


# -- st.loop per-iteration visibility ------------------------------------
#
# A LoopExpr runs all its iterations inside one evaluate, so host spans
# see one blob. With FLAGS.trace_loop_steps the loop marks the host
# clock after each iteration's launches; consecutive marks become
# "loop_step" spans carrying the step index. They time the host's
# launch of each step, not the device's execution (no mark ever waits
# for the device). The flag is part of the loop's structural signature.

_loop_prev: Dict[str, float] = {}


def loop_steps_begin(label: str) -> None:
    """Anchor step 0 of ``label`` at the dispatch start."""
    with _lock:
        _loop_prev[label] = now()


def record_loop_step(label: str, step: Any) -> None:
    """Close a span covering [previous mark, now] for iteration
    ``step`` of the loop ``label``."""
    if not _TRACE_FLAG._value:
        return
    t1 = now()
    with _lock:
        t0 = _loop_prev.get(label, t1)
        _loop_prev[label] = t1
    sp = Span("loop_step", (t0 - _EPOCH) * 1e6, _tid(), 0)
    sp.dur = (t1 - t0) * 1e6
    sp.seconds = t1 - t0
    sp.set(loop=label, step=int(step))
    _append(sp)
