"""Per-request flight recorder for the serve path (port of
``spartan_tpu/obs/flight.py``).

A request id (``rid``) is minted when ``evaluate_async``/``submit``
builds the request and propagates through its whole lifecycle — queue
admission, coalescing (which batch it joined and why), dispatch,
resolution, and the caller's fetch. Every hop appends one structured
:class:`Event` to a bounded ring, so ``st.flightrec()`` can replay any
recent request's timeline after the fact — the per-request analogue of
the span tracer's per-phase view, and the forensics record
``dump_crash`` folds in.

Event grammar (``kind`` + fields; all optional fields flat):

* ``submit``    — ``tenant``, ``plan`` (plan-key digest)
* ``enqueue``   — ``depth`` (queue depth after admission)
* ``reject``    — ``reason`` ('backpressure' | 'slo_admission' |
  'memory' | 'comm_budget')
* ``shed``      — ``reason`` ('deadline' | 'predicted')
* ``drain``     — ``reason`` ('reconfiguring' | 'stop')
* ``coalesce``  — ``span`` (dispatch span id shared by the batch),
  ``batch`` (clients in it), ``via`` ('head' | 'queued' | 'window':
  WHY this request is in this batch — it led it, it was already queued
  with the same signature, or it arrived during the linger window)
* ``dispatch``  — solo dispatch begin; ``span``, ``via``, ``batch=1``
* ``fallback``  — coalesced dispatch failed; re-dispatching solo
  (``reason`` the exception's type, ``mode`` the plan's batching mode
  after the failure)
* ``resolve``   — ``status`` ('ok' | 'error'), ``span``, ``batch``,
  and the latency decomposition ``queue_wait_s`` / ``coalesce_wait_s``
  / ``dispatch_s``
* ``fetch``     — ``seconds`` the caller's ``glom`` waited for the
  kernels the walk launched and the copy to the host
* ``profiled``  — this request's dispatch was sampled by the
  device-time attribution profiler (``FLAGS.profile_sample_every``,
  obs/profile.py): ``plan``, ``tier`` ('capture' | 'replay'),
  ``device_s`` (attributed device seconds), ``attributed_fraction``
* ``skew``, ``integrity``, ``persist``, ``sdc_retry`` — the skew
  observatory's sample, the SDC sentinel's verdict, the warm-start
  store's build source and the sentinel's retry, for the request's
  dispatch

The decomposition also feeds per-tenant histograms
(``serve_queue_wait_s{tenant=...}`` etc. in ``st.metrics()``), so
latency SLO dashboards get p50/p95 per tenant per phase without
replaying events.

Hot-path contract: every record is ONE flag read +
one ring append (GIL-atomic, no new lock) — no blocking work is added
to submit or resolution; the histograms ride the metrics registry's
existing lock. ``FLAGS.flightrec`` turns recording off entirely.

Imports only config + trace + metrics — same layer as the tracer.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from ..utils.config import FLAGS
from . import metrics as metrics_mod
from . import trace as trace_mod
from .metrics import METRICS_FLAG as _METRICS_FLAG
from .metrics import REGISTRY, labeled

_FLIGHT_FLAG = FLAGS.define_bool(
    "flightrec", True,
    "Record per-request flight events (submit -> queue -> coalesce -> "
    "dispatch -> resolve -> fetch) into the bounded ring behind "
    "st.flightrec(). One flag read + one ring append per hop.")
_RING_FLAG = FLAGS.define_int(
    "flightrec_ring", 4096,
    "Maximum flight events retained; older events drop when the ring "
    "wraps (st.flightrec reconstructs requests from the surviving "
    "window).")

_PHASES = ("queue_wait", "coalesce_wait", "dispatch", "fetch")

_rids = itertools.count(1)
_spans = itertools.count(1)
_resize_lock = threading.Lock()
_ring: Deque["Event"] = deque(maxlen=max(16, FLAGS.flightrec_ring))


class Event:
    """One flight hop: tracer-clock time, request id, kind, fields."""

    __slots__ = ("t", "rid", "kind", "args")

    def __init__(self, t: float, rid: int, kind: str,
                 args: Optional[Dict[str, Any]]):
        self.t = t
        self.rid = rid
        self.kind = kind
        self.args = args

    def __repr__(self) -> str:
        return f"Event(rid={self.rid}, kind={self.kind!r}, {self.args})"


def mint_rid() -> int:
    """A fresh request id (monotonic, process-wide)."""
    return next(_rids)


def mint_span() -> int:
    """A fresh dispatch span id — shared by every request resolved by
    one (possibly coalesced) dispatch."""
    return next(_spans)


def _append(ev: Event) -> None:
    global _ring
    size = max(16, _RING_FLAG._value)
    if _ring.maxlen != size:
        with _resize_lock:
            if _ring.maxlen != size:
                _ring = deque(_ring, maxlen=size)
    _ring.append(ev)  # deque.append is GIL-atomic: no hot-path lock


def note(rid: int, kind: str, **args: Any) -> None:
    """Append one event (no-op when FLAGS.flightrec is off)."""
    if not _FLIGHT_FLAG._value:
        return
    _append(Event(trace_mod.now(), rid, kind, args or None))


def _phase_hist(tenant: Optional[str], phase: str,
                seconds: float) -> None:
    if _METRICS_FLAG._value:
        REGISTRY.histogram(
            labeled("serve_" + phase + "_s",
                    tenant=tenant if tenant else "default"),
            "per-tenant serve latency decomposition, seconds "
            "(flight recorder)").observe(seconds)


def record_resolution(rid: int, tenant: Optional[str], span: int,
                      batch: int, status: str, t_submit: float,
                      t_taken: float, t_dispatch: float,
                      t_resolved: float) -> None:
    """The resolution hop: one 'resolve' event carrying the latency
    decomposition, plus the per-tenant phase histograms."""
    if not _FLIGHT_FLAG._value:
        return
    qw = max(0.0, t_taken - t_submit)
    cw = max(0.0, t_dispatch - t_taken)
    dw = max(0.0, t_resolved - t_dispatch)
    _append(Event(t_resolved, rid, "resolve", {
        "tenant": tenant, "span": span, "batch": batch,
        "status": status, "queue_wait_s": round(qw, 6),
        "coalesce_wait_s": round(cw, 6), "dispatch_s": round(dw, 6)}))
    _phase_hist(tenant, "queue_wait", qw)
    _phase_hist(tenant, "coalesce_wait", cw)
    _phase_hist(tenant, "dispatch", dw)


def note_fetch(rid: int, tenant: Optional[str], seconds: float) -> None:
    """The caller-side fetch hop (``EvalFuture.glom`` blocked this long
    on device execution + transfer)."""
    if not _FLIGHT_FLAG._value or rid <= 0:
        return
    _append(Event(trace_mod.now(), rid, "fetch",
                  {"tenant": tenant, "seconds": round(seconds, 6)}))
    _phase_hist(tenant, "fetch", seconds)


def events() -> List[Event]:
    """Ring snapshot, oldest first."""
    return list(_ring)


def snapshot(limit: Optional[int] = None) -> Dict[str, Any]:
    """The public ``st.flightrec()``: the event window (newest ``limit``
    when given), per-request reconstructed timelines, and per-tenant
    latency-decomposition histogram summaries."""
    evs = events()
    if limit is not None and limit >= 0:
        evs = evs[-limit:]
    epoch = trace_mod.epoch()
    out_events: List[Dict[str, Any]] = []
    requests: Dict[int, Dict[str, Any]] = {}
    for ev in evs:
        rec: Dict[str, Any] = {
            "t_us": round((ev.t - epoch) * 1e6, 1),
            "rid": ev.rid, "kind": ev.kind}
        if ev.args:
            rec.update(ev.args)
        out_events.append(rec)
        req = requests.setdefault(ev.rid, {"rid": ev.rid, "events": []})
        req["events"].append(ev.kind)
        args = ev.args or {}
        if ev.kind == "submit":
            req["tenant"] = args.get("tenant")
            req["plan"] = args.get("plan")
            req["t_submit_us"] = rec["t_us"]
        elif ev.kind in ("coalesce", "dispatch"):
            req["dispatch_span"] = args.get("span")
            req["batch"] = args.get("batch")
            req["via"] = args.get("via")
        elif ev.kind == "resolve":
            req["status"] = args.get("status")
            req["dispatch_span"] = args.get("span", req.get(
                "dispatch_span"))
            req["batch"] = args.get("batch", req.get("batch"))
            for k in ("queue_wait_s", "coalesce_wait_s", "dispatch_s"):
                req[k] = args.get(k)
        elif ev.kind == "fetch":
            req["fetch_s"] = args.get("seconds")
        elif ev.kind == "profiled":
            req["profiled"] = {
                "tier": args.get("tier"),
                "device_s": args.get("device_s"),
                "attributed_fraction": args.get("attributed_fraction"),
            }
        elif ev.kind in ("reject", "shed", "drain", "fallback"):
            req["status"] = ev.kind
            if args.get("reason"):
                req["reason"] = args["reason"]

    tenants: Dict[str, Dict[str, Any]] = {}
    hists = REGISTRY.snapshot()["histograms"]
    for key, summary in hists.items():
        base, _block = metrics_mod.split_labels(key)
        if not (base.startswith("serve_") and base.endswith("_s")):
            continue
        phase = base[len("serve_"):-len("_s")]
        if phase not in _PHASES:
            continue
        _n, lab = metrics_mod.parse_labels(key)
        tenants.setdefault(lab.get("tenant", "default"),
                           {})[phase] = summary
    # delta-aware evaluation counters (expr/incremental.py): the engine
    # notes per-dispatch events above ("incremental" kind) and its
    # running totals here, read from one flightrec call
    ctr = REGISTRY.counter_values()
    incremental = {k: v for k, v in ctr.items()
                   if k.startswith("incremental_")}
    gauges = REGISTRY.snapshot()["gauges"]
    cache_g = gauges.get("incremental_cache_bytes")
    if cache_g is not None:
        incremental["incremental_cache_bytes"] = cache_g["value"]
    return {"events": out_events, "requests": requests,
            "tenants": tenants, "incremental": incremental}


def clear() -> None:
    """Drop every recorded event (test isolation / benchmark brackets);
    rid/span counters keep running (ids stay process-unique)."""
    _ring.clear()
