"""Closed-loop telemetry: the continuous monitor and the autotune daemon
(port of ``spartan_tpu/obs/monitor.py``).

1. **Sampler + time-series store** — :class:`Monitor` samples, on a
   cadence (``FLAGS.monitor_interval_s``; tests call
   :meth:`Monitor.sample` with an injected time ``t``), the metrics
   registry (one atomic ``Registry.snapshot``), the ledger's per-model
   ``calibration_error_ratio`` aggregates, the SLO tracker's per-class
   burn rates (``obs/slo``) and the serve queue depth, into a bounded
   :class:`TimeSeriesStore` (``FLAGS.monitor_window`` points a series).

2. **Typed detectors** — sustained-breach detectors over those series:
   calibration drift per cost model (|log ratio| past
   ``FLAGS.calibration_drift_tol``), per-class SLO burn (past
   ``FLAGS.monitor_burn_threshold``), fallback-rate spikes (per-interval
   deltas of the ``persist_*`` / ``incremental_*`` /
   ``redistribute_fallback`` / ``serve_solo_fallbacks`` counters past
   ``FLAGS.monitor_fallback_rate``), backpressure (queue depth with
   admission rejections) and sustained shard imbalance (the skew
   observatory's last per-plan ratio past ``FLAGS.skew_warn_ratio``). A
   breach sustained for ``FLAGS.monitor_drift_patience`` consecutive
   samples emits ONE structured :class:`Anomaly` into the trace ring, the
   flight record, the ``monitor_anomalies_total{kind=...}`` counter and
   the bounded anomaly log that ``dump_crash`` and ``st.status()`` read.

3. **The autotune daemon** (``FLAGS.monitor_autotune``, default off) —
   on a sustained ``calibration_drift`` anomaly it refits per-op-class
   factors from the live ledger (``ledger.fit_profile``), re-plans the
   registered hot digests under the candidate profile (optimizer only:
   ``resilience.degrade.replan_for_profile``; the profile's fingerprint
   is in the plan key, so the challenger never aliases the incumbent),
   computes the modeled win (the incumbent's recorded cost components
   repriced under the candidate factors against the challenger plan's
   DP cost) and HOT-SWAPS — keeps the candidate installed and warms the
   challenger with one evaluation (``degrade.warm_evaluate``) — only
   when the win clears ``FLAGS.monitor_swap_margin``; otherwise it
   reverts and remembers the rejected fingerprint. Every attempt starts
   a ``FLAGS.monitor_cooldown_s`` cooldown.

Mesh-epoch fencing: a ``rebuild_mesh`` (elastic recovery) bumps the mesh
epoch; the next :meth:`Monitor.sample` notices, clears every detector
and daemon streak and the hot-plan templates, and stays quiet for that
tick; ``resilience/elastic`` also calls :func:`notify_mesh_recovery`
mid-recovery so a long rebuild cannot race a refit.

``st.status()`` is the one-page health view (the mesh status keys stay
top-level; ``slo`` / ``anomalies`` / ``daemon`` / ``calibration`` /
``serve`` / ``skew`` / ``integrity`` / ``monitor`` sections ride
alongside), and ``st.fleet_status()`` merges per-rank snapshots written
with the persist store's atomic-replace discipline under
``FLAGS.monitor_fleet_dir``.

Module-level imports stay inside obs/ + utils (``expr``, ``serve``,
``parallel`` and ``resilience`` load inside functions) so ``expr/base``
can call :func:`note_plan_built` without a cycle.
"""

from __future__ import annotations

import json
import math
import os
import threading
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..utils.config import FLAGS
from . import flight as flight_mod
from . import ledger as ledger_mod
from . import skew as skew_mod
from . import slo as slo_mod
from . import trace as trace_mod
from .metrics import METRICS_FLAG as _METRICS_FLAG
from .metrics import REGISTRY, labeled

_MONITOR_FLAG = FLAGS.define_bool(
    "monitor", False,
    "Run the continuous-monitoring sampler thread (obs/monitor.py): "
    "every monitor_interval_s it snapshots the metrics registry, "
    "ledger ratios and SLO burn rates into the bounded time-series "
    "store and runs the anomaly detectors. Off = zero background "
    "work; st.status() still renders from live state.")
FLAGS.define_float(
    "monitor_interval_s", 1.0,
    "Sampling cadence of the monitor thread, seconds.")
FLAGS.define_int(
    "monitor_window", 512,
    "Points retained per monitor time series (bounded ring).")
_AUTOTUNE_FLAG = FLAGS.define_bool(
    "monitor_autotune", False,
    "Closed-loop re-calibration daemon: on sustained calibration "
    "drift, refit per-op-class factors from the live ledger, re-plan "
    "the hot digests under the candidate profile (optimizer-only) and "
    "hot-swap only when the modeled win clears monitor_swap_margin. "
    "Also enables the hot-plan template registry on the plan-build "
    "miss path (one flag read per miss).")
FLAGS.define_int(
    "monitor_drift_patience", 3,
    "Consecutive breached samples before a detector emits an Anomaly "
    "(and the autotune daemon may act). Hysteresis against "
    "oscillating series.")
FLAGS.define_float(
    "monitor_swap_margin", 0.05,
    "Minimum modeled relative win (incumbent repriced minus "
    "challenger, over incumbent) before the autotune daemon keeps a "
    "refitted profile installed. Below it the candidate is reverted "
    "and its fingerprint remembered — no flapping.")
FLAGS.define_float(
    "monitor_cooldown_s", 30.0,
    "Cooldown after any autotune attempt (swap OR revert) before the "
    "daemon will act on drift again.")
FLAGS.define_float(
    "monitor_burn_threshold", 1.0,
    "SLO burn rate (violation rate over error budget) above which the "
    "burn detector counts a breach; 1.0 = consuming the whole budget.")
FLAGS.define_float(
    "monitor_fallback_rate", 5.0,
    "Fallback-counter increments per sample interval above which the "
    "fallback-spike detector counts a breach.")
FLAGS.define_str(
    "monitor_fleet_dir", "",
    "Directory for st.fleet_status() rank snapshots (each process "
    "writes rank_<i>.json with the persist-store atomic-replace "
    "discipline; rank 0 merges). Empty = fleet aggregation off.")

# fallback counters the spike detector watches (per-interval deltas)
_FALLBACK_COUNTERS = (
    "serve_solo_fallbacks",
    "persist_call_fallbacks",
    "persist_load_errors",
    "persist_prewarm_errors",
    "incremental_fallbacks",
    "redistribute_fallback",
)

_MAX_SERIES = 256


class Series:
    """One bounded time series: (t, value) pairs, newest last."""

    __slots__ = ("name", "points")

    def __init__(self, name: str, maxlen: int):
        self.name = name
        self.points: Deque[Tuple[float, float]] = deque(maxlen=maxlen)

    def record(self, t: float, v: float) -> None:
        self.points.append((t, float(v)))

    def latest(self) -> Optional[float]:
        return self.points[-1][1] if self.points else None

    def values(self) -> List[float]:
        return [v for _, v in self.points]


class TimeSeriesStore:
    """Bounded store of bounded series (at most :data:`_MAX_SERIES`
    series of ``FLAGS.monitor_window`` points each — the monitor can
    never grow without bound, matching the trace-ring discipline)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._series: "OrderedDict[str, Series]" = OrderedDict()

    def record(self, name: str, t: float, v: Optional[float]) -> None:
        if v is None:
            return
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = Series(
                    name, max(8, int(FLAGS.monitor_window)))
                while len(self._series) > _MAX_SERIES:
                    self._series.popitem(last=False)
            s.record(t, v)

    def series(self, name: str) -> Optional[Series]:
        with self._lock:
            return self._series.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._series)

    def to_dict(self, limit: int = 32) -> Dict[str, List]:
        """Newest ``limit`` points per series (status / crash dumps)."""
        with self._lock:
            return {name: [(round(t, 6), v)
                           for t, v in list(s.points)[-limit:]]
                    for name, s in self._series.items()}

    def clear(self) -> None:
        with self._lock:
            self._series.clear()


class Anomaly:
    """One structured detector finding."""

    __slots__ = ("kind", "key", "t", "value", "threshold", "detail")

    def __init__(self, kind: str, key: str, t: float, value: float,
                 threshold: float, detail: str = ""):
        self.kind = kind
        self.key = key
        self.t = t
        self.value = value
        self.threshold = threshold
        self.detail = detail

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "key": self.key,
                "t": round(self.t, 6), "value": round(self.value, 6),
                "threshold": round(self.threshold, 6),
                "detail": self.detail}

    def __repr__(self) -> str:
        return (f"Anomaly({self.kind}:{self.key} value={self.value:.4g}"
                f" threshold={self.threshold:.4g})")


class _SustainedDetector:
    """Breach streak tracking shared by every detector: a condition
    must hold for ``FLAGS.monitor_drift_patience`` CONSECUTIVE samples
    before one Anomaly is emitted (then the streak keeps counting so a
    still-breached series does not re-emit every tick)."""

    def __init__(self, kind: str):
        self.kind = kind
        self._streaks: Dict[str, int] = {}

    def feed(self, t: float,
             observations: Dict[str, Tuple[float, float, bool, str]]
             ) -> List[Anomaly]:
        out: List[Anomaly] = []
        patience = max(1, int(FLAGS.monitor_drift_patience))
        for key, (value, threshold, breached, detail) \
                in observations.items():
            if breached:
                s = self._streaks.get(key, 0) + 1
                self._streaks[key] = s
                if s == patience:
                    out.append(Anomaly(self.kind, key, t, value,
                                       threshold, detail))
            else:
                self._streaks[key] = 0
        return out

    def streak(self, key: str) -> int:
        return self._streaks.get(key, 0)

    def reset(self) -> None:
        self._streaks.clear()


def _drift_observations(models: Dict[str, Any]
                        ) -> Dict[str, Tuple[float, float, bool, str]]:
    """Calibration-drift detector input: per cost model, breach when
    |log(calibration_error_ratio)| exceeds the ledger's drift
    tolerance."""
    tol = float(FLAGS.calibration_drift_tol)
    obs: Dict[str, Tuple[float, float, bool, str]] = {}
    for model, rec in models.items():
        r = rec.get("calibration_error_ratio")
        if not r or r <= 0:
            continue
        dev = abs(math.log(r))
        obs[model] = (r, tol, dev > tol,
                      f"|log ratio| {dev:.3f} vs tol {tol:.3f}")
    return obs


def _burn_observations(burns: Dict[str, Dict[str, Any]]
                       ) -> Dict[str, Tuple[float, float, bool, str]]:
    thr = float(FLAGS.monitor_burn_threshold)
    obs: Dict[str, Tuple[float, float, bool, str]] = {}
    for name, rec in burns.items():
        b = rec.get("burn_rate")
        if b is None:
            continue
        obs[name] = (b, thr, b > thr,
                     f"violation rate {rec.get('violation_rate')} over "
                     f"budget {1.0 - rec.get('objective', 0.0):.4g}")
    return obs


def _skew_observations(current: Dict[str, Dict[str, Any]]
                       ) -> Dict[str, Tuple[float, float, bool, str]]:
    """Sustained-imbalance detector input: per plan digest, breach
    when the last measured shard-imbalance ratio (obs/skew) exceeds
    ``FLAGS.skew_warn_ratio``."""
    thr = float(getattr(FLAGS, "skew_warn_ratio", 1.5) or 1.5)
    obs: Dict[str, Tuple[float, float, bool, str]] = {}
    for digest, rec in current.items():
        r = rec.get("imbalance_ratio")
        if r is None:
            continue
        obs[digest] = (
            float(r), thr, r > thr,
            f"straggler node {rec.get('node')}, hottest shard "
            f"{rec.get('hottest_shard')}, wait "
            f"{rec.get('straggler_wait_s')}s")
    return obs


class _FallbackDetector(_SustainedDetector):
    """Per-interval counter deltas vs ``FLAGS.monitor_fallback_rate``."""

    def __init__(self) -> None:
        super().__init__("fallback_spike")
        self._last: Dict[str, int] = {}

    def observe(self, t: float, counters: Dict[str, int]
                ) -> List[Anomaly]:
        thr = float(FLAGS.monitor_fallback_rate)
        obs: Dict[str, Tuple[float, float, bool, str]] = {}
        for name in _FALLBACK_COUNTERS:
            cur = int(counters.get(name, 0))
            prev = self._last.get(name)
            self._last[name] = cur
            if prev is None:
                continue
            delta = max(0, cur - prev)
            obs[name] = (float(delta), thr, delta > thr,
                         f"{delta} increments this interval")
        return self.feed(t, obs)

    def reset(self) -> None:
        super().reset()
        self._last.clear()


class _BackpressureDetector(_SustainedDetector):
    """Queue-depth trend with admission rejections: a sample counts as
    breached when rejections grew this interval AND the queue is still
    non-empty — sustained, that is a saturated admission door, not a
    burst."""

    def __init__(self) -> None:
        super().__init__("backpressure")
        self._last_rejected: Optional[int] = None

    def observe(self, t: float, depth: int,
                rejected: int) -> List[Anomaly]:
        prev = self._last_rejected
        self._last_rejected = rejected
        if prev is None:
            return []
        delta = max(0, rejected - prev)
        obs = {"serve_queue": (
            float(depth), 0.0, delta > 0 and depth > 0,
            f"{delta} rejections this interval at depth {depth}")}
        return self.feed(t, obs)

    def reset(self) -> None:
        super().reset()
        self._last_rejected = None


# -- the autotune daemon --------------------------------------------------


class _Autotune:
    """Refit -> replan -> hysteresis-gated hot-swap state machine.

    States: ``idle`` (watching), ``cooldown`` (a recent attempt —
    swap or revert — holds further action for monitor_cooldown_s).
    The hot-plan templates are result-free structural clones captured
    on the plan-build miss path (:func:`note_plan_built`); each
    attempt re-clones them so the stored template is never mutated."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # digest -> result-free template DAG (clone shares leaves;
        # bounded: only the most recent _MAX_TEMPLATES misses)
        self._templates: "OrderedDict[str, Any]" = OrderedDict()
        self.last_attempt_t: Optional[float] = None
        self.last_rejected_fp: Optional[str] = None
        self.events: Deque[Dict[str, Any]] = deque(maxlen=32)
        self.state = "idle"

    _MAX_TEMPLATES = 16

    def register(self, digest: str, template: Any) -> None:
        with self._lock:
            self._templates[digest] = template
            self._templates.move_to_end(digest)
            while len(self._templates) > self._MAX_TEMPLATES:
                self._templates.popitem(last=False)

    def templates(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._templates)

    def clear_templates(self) -> None:
        with self._lock:
            self._templates.clear()

    def _event(self, t: float, kind: str, **extra: Any) -> None:
        rec = {"t": round(t, 6), "event": kind}
        rec.update(extra)
        self.events.append(rec)
        trace_mod.instant("autotune_" + kind, **extra)
        flight_mod.note(flight_mod.mint_rid(), "autotune",
                        event=kind, **extra)
        if _METRICS_FLAG._value:
            REGISTRY.counter(
                labeled("monitor_autotune_total", event=kind),
                "autotune daemon lifecycle events (refit / swap / "
                "revert / skip) by kind").inc()

    def in_cooldown(self, t: float) -> bool:
        last = self.last_attempt_t
        return (last is not None
                and t - last < float(FLAGS.monitor_cooldown_s))

    def tick(self, t: float, drift_anomalies: List[Anomaly]) -> None:
        """One daemon step, called by ``Monitor.sample`` under
        ``FLAGS.monitor_autotune``. Acts only on a fresh sustained
        drift anomaly, outside the cooldown."""
        if not drift_anomalies:
            if not self.in_cooldown(t):
                self.state = "idle"
            return
        if self.in_cooldown(t):
            self.state = "cooldown"
            return
        self.attempt(t)

    def attempt(self, t: float) -> Optional[str]:
        """Refit from the live ledger and trial the candidate. Returns
        'swap', 'revert', or None (nothing fittable / known-bad /
        already active). Cooldown starts on every outcome."""
        self.last_attempt_t = t
        self.state = "cooldown"
        candidate = ledger_mod.fit_profile()
        if candidate is None:
            self._event(t, "skip", reason="nothing_fittable")
            return None
        fp = candidate.fingerprint()
        active = ledger_mod.active_profile()
        if (active is not None and FLAGS.cost_calibration
                and fp == active.fingerprint()):
            self._event(t, "skip", reason="already_active",
                        fingerprint=fp)
            return None
        if fp == self.last_rejected_fp:
            self._event(t, "skip", reason="recently_rejected",
                        fingerprint=fp)
            return None
        self._event(t, "refit", fingerprint=fp,
                    classes=sorted(candidate.factors))

        # trial-install the candidate: the fingerprint flag write
        # re-keys every plan signed from here (plan-key separation —
        # the incumbent executable is untouched in the caches)
        prev_profile = active
        prev_enabled = bool(FLAGS.cost_calibration)
        ledger_mod.set_profile(candidate)
        FLAGS.cost_calibration = True

        from ..parallel import mesh as mesh_mod  # lazy: layer order
        from ..resilience import degrade as degrade_mod

        mesh = mesh_mod.get_mesh()
        wins: List[float] = []
        replanned = 0
        for digest, template in self.templates().items():
            comps = ledger_mod.components_of(digest)
            if not comps:
                continue
            plan = degrade_mod.replan_for_profile(template, mesh)
            if plan is None or plan.report is None:
                continue
            chal = plan.report.get("dp_cost")
            inc = sum(v * candidate.factors.get(c, 1.0)
                      for c, v in comps.items())
            if chal and inc > 0:
                replanned += 1
                wins.append((inc - float(chal)) / inc)
        win = max(wins) if wins else 0.0

        if replanned and win >= float(FLAGS.monitor_swap_margin):
            # HOT-SWAP: keep the candidate installed; warm the
            # challenger executables off the hot path so the first
            # re-keyed request is a pure cache hit
            warmed = 0
            for _, template in self.templates().items():
                if degrade_mod.warm_evaluate(template, mesh):
                    warmed += 1
            self._event(t, "swap", fingerprint=fp,
                        modeled_win=round(win, 4), replanned=replanned,
                        warmed=warmed)
            return "swap"

        # REVERT: modeled win below the hysteresis margin (or nothing
        # replannable) — restore the incumbent and remember the
        # rejected fingerprint so oscillating drift cannot flap
        ledger_mod.set_profile(prev_profile)
        FLAGS.cost_calibration = prev_enabled
        self.last_rejected_fp = fp
        self._event(t, "revert", fingerprint=fp,
                    modeled_win=round(win, 4), replanned=replanned)
        return "revert"

    def reset(self) -> None:
        with self._lock:
            self._templates.clear()
        self.last_attempt_t = None
        self.last_rejected_fp = None
        self.events.clear()
        self.state = "idle"

    def status(self) -> Dict[str, Any]:
        return {
            "enabled": bool(FLAGS.monitor_autotune),
            "state": self.state,
            "hot_plans": len(self._templates),
            "last_rejected_fingerprint": self.last_rejected_fp,
            "events": list(self.events),
        }


# -- the monitor ----------------------------------------------------------


class Monitor:
    """The sampler + detector harness (one per process,
    :data:`MONITOR`). Thread-hosted under ``FLAGS.monitor``; tests and
    ``st.status()`` drive :meth:`sample` directly."""

    def __init__(self) -> None:
        self.store = TimeSeriesStore()
        self.drift = _SustainedDetector("calibration_drift")
        self.burn = _SustainedDetector("slo_burn")
        self.imbalance = _SustainedDetector("imbalance")
        self.fallback = _FallbackDetector()
        self.backpressure = _BackpressureDetector()
        self.autotune = _Autotune()
        self.anomalies: Deque[Anomaly] = deque(maxlen=64)
        self._epoch_seen: Optional[int] = None
        self._samples = 0
        self._last_sample_t: Optional[float] = None
        self._tick_total_s = 0.0  # host seconds of every tick
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # set after every completed tick (a waiter needs no sleep loop)
        self.ticked = threading.Event()

    # -- sampling -------------------------------------------------------

    def _emit(self, a: Anomaly) -> None:
        self.anomalies.append(a)
        trace_mod.instant("anomaly", error=True, kind=a.kind,
                          key=a.key, value=a.value,
                          threshold=a.threshold, detail=a.detail)
        flight_mod.note(flight_mod.mint_rid(), "anomaly",
                        anomaly_kind=a.kind, key=a.key, value=a.value)
        if _METRICS_FLAG._value:
            REGISTRY.counter(
                labeled("monitor_anomalies_total", kind=a.kind),
                "structured anomalies emitted by the continuous "
                "monitor's detectors, by kind").inc()

    def sample(self, t: Optional[float] = None) -> List[Anomaly]:
        """One monitoring tick at time ``t`` (seconds on the trace clock;
        now when None): sample every source, update the series store,
        run the detectors, drive the autotune daemon. Returns the
        anomalies emitted THIS tick."""
        from ..parallel import mesh as mesh_mod  # lazy: layer order

        t0 = trace_mod.now()
        if t is None:
            t = t0
        ep = mesh_mod.mesh_epoch()
        if self._epoch_seen is None:
            self._epoch_seen = ep
        elif ep != self._epoch_seen:
            # epoch fence: the mesh was rebuilt under us — every
            # detector streak and hot-plan template referenced the
            # dead epoch; go quiet for this tick
            self._fence(ep)
            return []

        reg = REGISTRY.snapshot(reset=False)
        counters = reg["counters"]
        led = ledger_mod.snapshot()
        burns = slo_mod.burn_rates()

        from ..serve import engine as serve_engine  # lazy: layer order

        eng = serve_engine.peek_default()
        depth = eng.queue.depth() if eng is not None else 0
        rejected = int(counters.get("serve_rejected", 0))

        store = self.store
        for model, rec in led["models"].items():
            store.record("calibration_error_ratio:" + model, t,
                         rec.get("calibration_error_ratio"))
        for name, rec in burns.items():
            store.record("slo_burn_rate:" + name, t,
                         rec.get("burn_rate"))
        for name in _FALLBACK_COUNTERS:
            store.record("counter:" + name, t,
                         float(counters.get(name, 0)))
        store.record("serve_queue_depth", t, float(depth))
        store.record("counter:serve_rejected", t, float(rejected))
        for phase in ("queue_wait", "dispatch"):
            # flight-recorder latency decomposition (p95 per tenant)
            prefix = "serve_" + phase + "_s"
            for hname, summ in reg["histograms"].items():
                if hname.startswith(prefix):
                    store.record("p95:" + hname, t, summ.get("p95"))

        skew_cur = skew_mod.current()
        for digest, rec in skew_cur.items():
            store.record("skew_imbalance_ratio:" + digest, t,
                         rec.get("imbalance_ratio"))

        anomalies: List[Anomaly] = []
        drift_anoms = self.drift.feed(t, _drift_observations(
            led["models"]))
        anomalies += drift_anoms
        anomalies += self.burn.feed(t, _burn_observations(burns))
        anomalies += self.imbalance.feed(t, _skew_observations(skew_cur))
        anomalies += self.fallback.observe(t, counters)
        anomalies += self.backpressure.observe(t, depth, rejected)
        for a in anomalies:
            self._emit(a)

        if _AUTOTUNE_FLAG._value:
            self.autotune.tick(t, drift_anoms)

        self._samples += 1
        self._last_sample_t = t
        self._tick_total_s += trace_mod.now() - t0
        self.ticked.set()
        return anomalies

    def _fence(self, epoch: int) -> None:
        self._epoch_seen = epoch
        self.drift.reset()
        self.burn.reset()
        self.imbalance.reset()
        self.fallback.reset()
        self.backpressure.reset()
        self.autotune.clear_templates()
        trace_mod.instant("monitor_epoch_fence", epoch=epoch)
        if _METRICS_FLAG._value:
            REGISTRY.counter(
                "monitor_epoch_fences",
                "monitor detector resets forced by a mesh-epoch "
                "change (elastic recovery)").inc()

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "Monitor":
        """Start the sampler thread (idempotent; no-op unless
        ``FLAGS.monitor``)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            if not _MONITOR_FLAG._value:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="spartan-torch-monitor",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            th, self._thread = self._thread, None
        self._stop.set()
        if th is not None and th.is_alive():
            th.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(
                max(0.01, float(FLAGS.monitor_interval_s))):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 - the sampler is advisory
                # (never takes down the process); the failure itself
                # is visible as a missing tick in the series
                if _METRICS_FLAG._value:
                    REGISTRY.counter(
                        "monitor_sample_errors",
                        "monitor sampler ticks that raised (advisory; "
                        "swallowed)").inc()

    def reset(self) -> None:
        """Test isolation: drop series, streaks, anomalies, daemon
        state (the thread, if any, keeps running)."""
        self.store.clear()
        self.drift.reset()
        self.burn.reset()
        self.imbalance.reset()
        self.fallback.reset()
        self.backpressure.reset()
        self.autotune.reset()
        self.anomalies.clear()
        self._epoch_seen = None
        self._samples = 0
        self._last_sample_t = None
        self._tick_total_s = 0.0
        self.ticked.clear()

    # -- surfaces -------------------------------------------------------

    def health(self) -> Dict[str, Any]:
        return {
            "enabled": bool(FLAGS.monitor),
            "running": (self._thread is not None
                        and self._thread.is_alive()),
            "samples": self._samples,
            "last_sample_t": self._last_sample_t,
            "tick_us_mean": (round(self._tick_total_s * 1e6
                                   / self._samples, 3)
                             if self._samples else None),
            "series": len(self.store.names()),
        }


MONITOR = Monitor()


def note_plan_built(plan: Any, expr: Any) -> None:
    """``expr/base._build_plan``'s miss-path hook (one flag read when
    the daemon is off): capture a result-free structural clone of the
    raw DAG keyed by its ledger digest, so the autotune daemon can
    re-plan this digest under a candidate profile off the hot path.
    The clone shares leaves (no data copy) and is bounded to the most
    recent 16 misses."""
    if not _AUTOTUNE_FLAG._value:
        return
    report = getattr(plan, "report", None)
    if not report:
        return
    digest = report.get("plan_key")
    if digest is None:
        return
    try:
        from ..resilience import degrade as degrade_mod  # lazy

        MONITOR.autotune.register(
            digest, degrade_mod.clone_for_replan(expr))
    except Exception:  # noqa: BLE001 - registration is advisory
        pass


def notify_mesh_recovery() -> None:
    """``resilience/elastic``'s mid-recovery hook: fence the monitor
    NOW (don't wait for the next sample to notice the epoch bump) —
    a refit racing the rebuild would replan onto a dead mesh."""
    from ..parallel import mesh as mesh_mod  # lazy: layer order

    MONITOR._fence(mesh_mod.mesh_epoch())


def sample(t: Optional[float] = None) -> List[Anomaly]:
    """Drive one monitoring tick on the process monitor (at time ``t``
    on the trace clock; now when None)."""
    return MONITOR.sample(t)


def start() -> Monitor:
    return MONITOR.start()


def stop() -> None:
    MONITOR.stop()


def recent_anomalies(limit: int = 16) -> List[Dict[str, Any]]:
    return [a.to_dict() for a in list(MONITOR.anomalies)[-limit:]]


def note_anomaly(kind: str, key: str, value: float, threshold: float,
                 detail: str = "") -> None:
    """Emit a structured anomaly from OUTSIDE the monitor's detectors
    (same ring, trace instant, flight note, and per-kind counter as a
    detector finding). The integrity sentinel uses this to raise its
    ``sdc`` anomaly when a suspect device crosses the quarantine
    threshold; the monitor need not be started for the anomaly to be
    recorded."""
    MONITOR._emit(Anomaly(kind, key, trace_mod.now(), float(value),
                          float(threshold), detail))


def crash_section() -> Dict[str, Any]:
    """The monitor's contribution to ``dump_crash`` (advisory)."""
    return {
        "health": MONITOR.health(),
        "anomalies": recent_anomalies(32),
        "daemon": MONITOR.autotune.status(),
        "series_tail": MONITOR.store.to_dict(limit=8),
    }


# -- st.status() / st.fleet_status() --------------------------------------


def status() -> Dict[str, Any]:
    """The one-page health view behind ``st.status()``. Mesh-status
    keys stay TOP-LEVEL (platform / num_devices / mesh / process_* /
    memory_stats — the long-standing contract); the monitoring
    sections ride alongside."""
    from ..parallel import mesh as mesh_mod  # lazy: layer order
    from ..serve import engine as serve_engine

    s = dict(mesh_mod.status())
    eng = serve_engine.peek_default()
    s["serve"] = eng.stats() if eng is not None else None
    s["slo"] = slo_mod.burn_rates()
    s["anomalies"] = recent_anomalies()
    s["daemon"] = MONITOR.autotune.status()
    led = ledger_mod.snapshot()
    s["calibration"] = {
        "enabled": led["calibration"]["enabled"],
        "fingerprint": led["calibration"]["fingerprint"],
        "models": {
            m: rec.get("calibration_error_ratio")
            for m, rec in led["models"].items()
            if rec.get("calibration_error_ratio") is not None},
    }
    # one-line skew summary (obs/skew): the worst currently-measured
    # shard-imbalance ratio and the node dragging it, or None when no
    # skew measurement has been taken
    s["skew"] = skew_mod.worst_current()
    # integrity line (resilience/integrity.py, lazy: layer order):
    # checks run, violations, in-window strikes per device, quarantine
    # history — None until the SDC sentinel has run at least once
    from ..resilience import integrity as integrity_mod

    s["integrity"] = integrity_mod.status()
    s["monitor"] = MONITOR.health()
    return s


def _rank_path(dir_path: str, rank: int) -> str:
    return os.path.join(dir_path, f"rank_{rank}.json")


def publish_rank_status(dir_path: Optional[str] = None
                        ) -> Optional[str]:
    """Write THIS rank's status snapshot into the fleet dir with the
    persist-store file discipline (tmp + atomic ``os.replace`` — a
    concurrent reader never sees a torn file). Returns the path, or
    None with fleet aggregation off."""
    d = dir_path or FLAGS.monitor_fleet_dir
    if not d:
        return None
    os.makedirs(d, exist_ok=True)
    from ..parallel import mesh as mesh_mod  # lazy: layer order

    ms = mesh_mod.status()
    rank = int(ms.get("process_index", 0))
    doc = {
        "rank": rank,
        "wall_t": trace_mod.epoch(),
        "status": status(),
    }
    path = _rank_path(d, rank)
    tmp = path + f".tmp-{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, sort_keys=True, default=str)
    os.replace(tmp, path)
    return path


def fleet_status(dir_path: Optional[str] = None) -> Dict[str, Any]:
    """The rank-aggregated view behind ``st.fleet_status()``: publish
    this rank's snapshot, read every ``rank_*.json`` in the fleet dir
    and merge (worst SLO burn per class across ranks, total anomaly
    count, per-rank sections). Single-process (or with no fleet dir)
    it degrades to ``{"ranks": {0: ...}}`` over the live status."""
    d = dir_path or FLAGS.monitor_fleet_dir
    if not d:
        return {"fleet_dir": None,
                "ranks": {0: {"rank": 0, "status": status()}}}
    publish_rank_status(d)
    ranks: Dict[int, Dict[str, Any]] = {}
    try:
        names = sorted(os.listdir(d))
    except OSError:
        names = []
    for name in names:
        if not (name.startswith("rank_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(d, name)) as fh:
                doc = json.load(fh)
            ranks[int(doc["rank"])] = doc
        except (OSError, ValueError, KeyError):
            continue  # torn/corrupt file: skip, never fail the merge

    slo_worst: Dict[str, Dict[str, Any]] = {}
    skew_worst: Optional[Dict[str, Any]] = None
    anomaly_count = 0
    integ: Dict[str, Any] = {"checks": 0, "violations": 0,
                             "quarantined": []}
    integ_seen = False
    for doc in ranks.values():
        st_doc = doc.get("status") or {}
        anomaly_count += len(st_doc.get("anomalies") or ())
        # fleet integrity roll-up: totals across ranks plus every
        # rank's quarantine history (a quarantined chip is a
        # fleet-level casualty: the mesh every rank shares shrank)
        it = st_doc.get("integrity")
        if it:
            integ_seen = True
            integ["checks"] += int(it.get("checks") or 0)
            integ["violations"] += int(it.get("violations") or 0)
            for rec in it.get("quarantined") or ():
                q = dict(rec)
                q["rank"] = doc.get("rank")
                integ["quarantined"].append(q)
        for cls, rec in (st_doc.get("slo") or {}).items():
            b = rec.get("burn_rate")
            cur = slo_worst.get(cls)
            if b is not None and (
                    cur is None or cur.get("burn_rate") is None
                    or b > cur["burn_rate"]):
                slo_worst[cls] = {"burn_rate": b,
                                  "rank": doc.get("rank")}
        # worst shard-imbalance across ranks (the straggler is a
        # fleet-level property: one rank's hot shard taxes every rank
        # at the next collective)
        sk = st_doc.get("skew")
        if sk and sk.get("ratio") is not None and (
                skew_worst is None or sk["ratio"] > skew_worst["ratio"]):
            skew_worst = dict(sk)
            skew_worst["rank"] = doc.get("rank")
    from ..parallel import mesh as mesh_mod  # lazy: layer order

    return {
        "fleet_dir": d,
        "process_count": mesh_mod.status().get("process_count"),
        "ranks_reporting": len(ranks),
        "slo_worst": slo_worst,
        "skew_worst": skew_worst,
        "integrity": integ if integ_seen else None,
        "anomalies_total": anomaly_count,
        "ranks": ranks,
    }
