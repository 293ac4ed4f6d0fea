"""Device-time cost ledger + profile-guided cost-model calibration
(port of ``spartan_tpu/obs/ledger.py``).

The tiling DP's plan cost (``expr/tiling_cost``) is a prediction; this
module records it next to what the card did and closes the loop:

1. **The ledger** — one entry per plan-key digest recording the
   predictions (tiling-DP cost + its per-op-class decomposition) NEXT TO
   the measurements (the ``dispatch`` phase's host seconds from
   ``expr/base._run``, the counted ``cost_analysis`` FLOPs from
   ``st.explain``, per-node device seconds from ``st.profile`` and the
   sampler). ``st.ledger()`` snapshots it as JSON with per-plan
   measured-vs-predicted ratios and per-model aggregates, updates the
   Prometheus ``calibration_error_ratio{model=...}`` gauges. A
   measurement more than ``FLAGS.calibration_drift_tol`` away from its
   prediction (in ``|log(pred/actual)|``) bumps
   ``calibration_drift_total{model=...}``.

   The port's ``dispatch`` phase times the host's launches of a plan's
   kernels, never the kernels (nothing synchronises): on the card that
   is a launch time, and the device columns are where device time
   lands. The peak-memory columns (``peak_hbm``, ``snapshot(
   validate=True)``) hold the memory governor's modeled card peak
   (``resilience/memory.py``) and, once validated on the card, the
   measured one. ``note_skew`` records nothing
   until ``obs/skew`` is ported (ROADMAP A6), and ``note_service`` has
   no caller until ``serve/`` is (A5).

2. **Profile-guided calibration** — :func:`fit_profile` least-squares
   per-op-class correction factors (map / reduce / transpose / slice /
   other / contraction / reshard / psum, and the collectives — the term
   classes of the tiling DP) from the ledger's component decompositions
   and the measurements. The resulting :class:`CalibrationProfile`
   persists via ``st.save_profile(path)`` / ``st.load_profile(path)``
   and, under ``FLAGS.cost_calibration``, multiplies into the DP's
   edge/node costs (``expr/tiling_cost._cal_factors``). The active
   profile's fingerprint rides ``FLAGS.cost_calibration_fingerprint``
   into ``expr/base._opt_flags_key``, so calibrated and uncalibrated
   plans never alias in the plan cache.

Units note: the DP cost is bytes-equivalent, not seconds, so its ledger
ratio is scale-normalized — the seconds-per-unit scale is the median of
measured/predicted over the entries, and the per-plan ratio is read
against that scale. Calibration factors are likewise RELATIVE
(cost-weighted mean 1 over the fit set).

Imports only the config + metrics layers (expr loads lazily inside
functions) — recordable from any subsystem without cycles.
"""

from __future__ import annotations

import json
import math
import threading
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..utils.config import FLAGS
from .metrics import METRICS_FLAG as _METRICS_FLAG
from .metrics import REGISTRY, labeled

# define() returns the Flag; the dispatch hot path reads ._value
# directly (expr/base._dispatch pays one attribute load when off).
_LEDGER_FLAG = FLAGS.define_bool(
    "cost_ledger", True,
    "Record predicted-vs-measured cost per plan (tiling-DP cost vs the "
    "dispatch phase's seconds, counted cost_analysis FLOPs, profiled "
    "device seconds) into the ledger behind st.ledger(). Off-path cost "
    "when disabled is one flag read per dispatch.")
FLAGS.define_int(
    "cost_ledger_max", 256,
    "Maximum plan entries retained in the cost ledger; beyond it the "
    "oldest entry is dropped (FIFO).")
FLAGS.define_float(
    "calibration_drift_tol", 0.693,
    "Drift tolerance on |log(predicted/actual)| per cost model; a "
    "measurement outside it bumps calibration_drift_total{model=...}. "
    "Default log(2): predictions off by more than 2x either way "
    "count as drift.")
_CAL_FLAG = FLAGS.define_bool(
    "cost_calibration", False,
    "Multiply the active calibration profile's per-op-class factors "
    "into the tiling DP's edge/node costs (st.load_profile installs "
    "a profile). The profile fingerprint is part of the plan cache "
    "key: calibrated and uncalibrated plans never alias.")
FLAGS.define_str(
    "cost_calibration_fingerprint", "",
    "Fingerprint of the active calibration profile — set "
    "AUTOMATICALLY by st.load_profile / ledger.set_profile (the flag "
    "write invalidates the memoized plan-key flags component, so a "
    "new profile re-keys every plan). Do not set by hand.")

_MODELS = ("tiling_dp", "peak_hbm", "service_time")

# calibration-profile file schema (st.save_profile/st.load_profile):
# v2 added the device-time provenance fields (meta.source,
# meta.device_rows); v1 files still load with host-wall defaults
PROFILE_VERSION = 2

# the op-class vocabulary shared with expr/tiling_cost: node-class
# factors scale the compute term of that node class; "contraction"
# scales the FLOP term, "reshard" the operand-move bytes, "psum" the
# output all-reduce bytes. Under FLAGS.redistribution_planner the
# edge classes decompose per collective — "all_gather"/"all_to_all"
# from each reshard edge's chosen schedule (parallel/redistribute),
# "reduce_scatter"+"all_gather" from the psum term's two halves — so
# fit_profile calibrates each collective's factor independently from
# measured dispatches and the planner's schedule prices improve with
# use (profile fingerprint keying handles plan separation).
CLASSES = ("map", "reduce", "transpose", "slice", "other",
           "contraction", "reshard", "psum",
           "all_gather", "all_to_all", "reduce_scatter")


class _Entry:
    """One plan-key digest's predictions and measurements."""

    __slots__ = ("digest", "root", "dp_cost", "components",
                 "pred_peak_bytes", "plan_ref", "flops",
                 "xla_bytes_accessed", "pred_mem_bytes_validated",
                 "xla_peak_bytes", "dispatch_count", "dispatch_total_s",
                 "dispatch_min_s", "compile_s", "service_count",
                 "service_total_s", "pred_service_total_s",
                 "device_samples", "device_wall_total_s",
                 "device_attr_total_s", "device_components",
                 "device_tier", "skew_samples", "skew_ratio_last",
                 "skew_ratio_max", "skew_wait_total_s")

    def __init__(self, digest: str):
        self.digest = digest
        self.root: Optional[str] = None
        self.dp_cost: Optional[float] = None
        self.components: Optional[Dict[str, float]] = None
        self.pred_peak_bytes: Optional[int] = None
        self.plan_ref: Optional[Any] = None
        self.flops: Optional[float] = None
        self.xla_bytes_accessed: Optional[float] = None
        self.pred_mem_bytes_validated: Optional[int] = None
        self.xla_peak_bytes: Optional[int] = None
        self.dispatch_count = 0
        self.dispatch_total_s = 0.0
        self.dispatch_min_s: Optional[float] = None
        self.compile_s: Optional[float] = None
        self.service_count = 0
        self.service_total_s = 0.0
        self.pred_service_total_s = 0.0
        # DEVICE columns (obs/profile.py sampled attribution): per-op-
        # class device seconds measured by st.profile / the sampler —
        # fit_profile calibrates from these when present, host wall
        # otherwise
        self.device_samples = 0
        self.device_wall_total_s = 0.0
        self.device_attr_total_s = 0.0
        self.device_components: Optional[Dict[str, float]] = None
        self.device_tier: Optional[str] = None
        # SKEW columns (obs/skew.py): shard-imbalance context for the
        # measurements above — a high ratio means the device rows were
        # taken while one shard dragged the mesh, so fit_profile can
        # see (and report) imbalance-inflated calibration input
        self.skew_samples = 0
        self.skew_ratio_last: Optional[float] = None
        self.skew_ratio_max: Optional[float] = None
        self.skew_wait_total_s = 0.0


_lock = threading.Lock()
_entries: "OrderedDict[str, _Entry]" = OrderedDict()
# running log-scale EMA of measured-seconds / dp-cost (the tiling-DP
# drift reference; n counts samples so drift only fires warmed up)
_dp_state: Dict[str, float] = {"n": 0, "log_scale": 0.0}


def _get_or_create(digest: str) -> _Entry:
    """Entry lookup under ``_lock`` (caller holds it)."""
    e = _entries.get(digest)
    if e is None:
        e = _entries[digest] = _Entry(digest)
        maxn = max(8, int(FLAGS.cost_ledger_max))
        while len(_entries) > maxn:
            _entries.popitem(last=False)
    return e


def _drift(model: str, ratio: float) -> None:
    """Count a prediction landing outside the drift tolerance."""
    if ratio <= 0:
        return
    if abs(math.log(ratio)) > FLAGS.calibration_drift_tol:
        if _METRICS_FLAG._value:
            REGISTRY.counter(
                labeled("calibration_drift_total", model=model),
                "measurements whose |log(pred/actual)| exceeded "
                "FLAGS.calibration_drift_tol, per cost model").inc()


# -- recording hooks ------------------------------------------------------


def note_plan(plan: Any) -> None:
    """``expr/base._build_plan``'s hook: record the plan's predictions
    (DP cost + components, modeled peak HBM) and keep a weakref for
    on-demand validation. Miss-path only."""
    if not _LEDGER_FLAG._value:
        return
    report = getattr(plan, "report", None)
    if not report:
        return
    digest = report.get("plan_key")
    if digest is None:
        return
    mem = report.get("memory") or {}
    with _lock:
        e = _get_or_create(digest)
        e.root = report.get("root")
        e.dp_cost = report.get("dp_cost")
        e.components = report.get("cost_components")
        e.pred_peak_bytes = mem.get("peak_bytes_card")
        try:
            e.plan_ref = weakref.ref(plan)
        except TypeError:
            e.plan_ref = None


def note_dispatch(digest: Optional[str], kind: str,
                  seconds: float) -> None:
    """``expr/base._run``'s hook: one measured walk of the plan, the
    ``dispatch`` phase's host seconds. ``kind`` is the phase name
    ('dispatch'; the JAX package's 'compile' — its first trace+compile
    call, kept apart from the DP ratio — has no counterpart in an eager
    port, but the column stays)."""
    if not _LEDGER_FLAG._value or digest is None or seconds <= 0:
        return
    dp = None
    with _lock:
        e = _get_or_create(digest)
        if kind == "compile":
            e.compile_s = seconds
            return
        e.dispatch_count += 1
        e.dispatch_total_s += seconds
        if e.dispatch_min_s is None or seconds < e.dispatch_min_s:
            e.dispatch_min_s = seconds
        dp = e.dp_cost
        if dp and dp > 0:
            ls = math.log(seconds / dp)
            if _dp_state["n"] == 0:
                _dp_state["log_scale"] = ls
            else:
                _dp_state["log_scale"] += 0.1 * (ls
                                                 - _dp_state["log_scale"])
            _dp_state["n"] += 1
            warmed = _dp_state["n"] >= 8
            dev = abs(ls - _dp_state["log_scale"])
    if dp and dp > 0 and warmed:
        _drift("tiling_dp", math.exp(dev))


def note_service(digest: Optional[str], predicted_s: float,
                 measured_s: float) -> None:
    """Serve-worker hook: the queue's EMA prediction at pop time vs
    the request's measured service wall time."""
    if not _LEDGER_FLAG._value or digest is None or measured_s <= 0:
        return
    with _lock:
        e = _get_or_create(digest)
        e.service_count += 1
        e.service_total_s += measured_s
        e.pred_service_total_s += max(0.0, predicted_s)
    if predicted_s and predicted_s > 0:
        _drift("service_time", predicted_s / measured_s)


def note_memory_actual(digest: Optional[str], predicted: Any,
                       actual: Any) -> None:
    """The memory governor's hook (``resilience/memory.validate_plan``):
    a predicted peak next to the one measured on the card."""
    if digest is None or not actual:
        return
    with _lock:
        e = _get_or_create(digest)
        e.pred_mem_bytes_validated = int(predicted) if predicted else None
        e.xla_peak_bytes = int(actual)
    if predicted and actual:
        _drift("peak_hbm", float(predicted) / float(actual))


def note_cost_analysis(digest: Optional[str],
                       analysis: Optional[Dict[str, Any]]) -> None:
    """``st.explain``'s hook: the plan's counted ``cost_analysis``
    FLOPs/bytes (per device, as the JAX package's XLA read-out),
    recorded next to the model's cost."""
    if digest is None or not analysis:
        return
    with _lock:
        e = _get_or_create(digest)
        try:
            e.flops = float(analysis.get("flops", 0.0)) or e.flops
            e.xla_bytes_accessed = (
                float(analysis.get("bytes accessed", 0.0))
                or e.xla_bytes_accessed)
        except (TypeError, ValueError):
            pass


def note_device_profile(digest: Optional[str], tier: str,
                        wall_s: float, attributed_s: float,
                        class_seconds: Dict[str, float]) -> None:
    """``obs/profile``'s hook: one device-time attribution sample —
    whole-plan wall, attributed device seconds, and the per-op-class
    decomposition. Accumulated into the entry's DEVICE columns, which
    :func:`fit_profile` prefers over host dispatch wall: the factors
    then correct each class from where the device actually spent time
    instead of one blended total."""
    if not _LEDGER_FLAG._value or digest is None:
        return
    with _lock:
        e = _get_or_create(digest)
        e.device_samples += 1
        e.device_wall_total_s += max(0.0, wall_s)
        e.device_attr_total_s += max(0.0, attributed_s)
        e.device_tier = tier
        comp = e.device_components or {}
        for k, v in (class_seconds or {}).items():
            if v > 0:
                comp[k] = comp.get(k, 0.0) + float(v)
        e.device_components = comp or None


def note_skew(digest: Optional[str], imbalance_ratio: Optional[float],
              straggler_wait_s: Optional[float]) -> None:
    """``obs/skew``'s hook in the JAX package (one shard-skew measurement
    per plan). Records nothing until ``obs/skew`` is ported (ROADMAP
    A6): the skew columns stay empty."""
    return None


def ingest(digest: str, components: Dict[str, float],
           measured_s: float, dp_cost: Optional[float] = None) -> None:
    """Offline entry point: feed an externally measured schedule (a
    profile run, a replayed trace, a synthetic workload) into the
    ledger so :func:`fit_profile` can calibrate from it. ``dp_cost``
    defaults to the uncalibrated model's prediction — the sum of the
    components."""
    with _lock:
        e = _get_or_create(digest)
        e.components = {k: float(v) for k, v in components.items()}
        e.dp_cost = float(dp_cost if dp_cost is not None
                          else sum(e.components.values()))
        e.dispatch_count += 1
        e.dispatch_total_s += measured_s
        if e.dispatch_min_s is None or measured_s < e.dispatch_min_s:
            e.dispatch_min_s = measured_s


def predict_service_s(digest: Optional[str]) -> Optional[float]:
    """Calibrated service-time estimate for one plan digest: the
    entry's DP cost priced through the warmed seconds-per-cost-unit
    EMA (``_dp_state``). None until the scale has warmed (8 dispatch
    samples) or when the digest has no priced entry — callers
    (``serve/engine``'s model-priced shedding, ``obs/monitor``) fall
    back to the queue EMA. O(1) under the ledger lock."""
    if not _LEDGER_FLAG._value or digest is None:
        return None
    with _lock:
        if _dp_state["n"] < 8:
            return None
        e = _entries.get(digest)
        if e is None or not e.dp_cost or e.dp_cost <= 0:
            return None
        return float(e.dp_cost) * math.exp(_dp_state["log_scale"])


def components_of(digest: Optional[str]) -> Optional[Dict[str, float]]:
    """The recorded per-op-class cost decomposition for one digest
    (a copy), or None. The autotune daemon (``obs/monitor``) reprices
    an incumbent plan under a candidate profile from these."""
    if digest is None:
        return None
    with _lock:
        e = _entries.get(digest)
        if e is None or not e.components:
            return None
        return dict(e.components)


# -- the snapshot (st.ledger) --------------------------------------------


def _validate_missing() -> int:
    """Run ``resilience.memory.validate_plan`` for every live plan that
    has no memory actuals yet (one measured walk each, on the card;
    nothing on the CPU)."""
    with _lock:
        todo = [(e.plan_ref() if e.plan_ref is not None else None)
                for e in _entries.values() if e.xla_peak_bytes is None]
    done = 0
    for plan in todo:
        if plan is None:
            continue
        try:
            from ..resilience import memory as memory_mod  # lazy: obs
            # sits below resilience in the layer order
            if memory_mod.validate_plan(plan) is not None:
                done += 1
        except Exception:  # noqa: BLE001 - validation is advisory
            continue
    return done


def snapshot(validate: bool = False) -> Dict[str, Any]:
    """The public ``st.ledger()``: per-plan predictions, measurements
    and measured-vs-predicted ratios, per-model aggregates (geometric
    mean ratio, worst |log| deviation, drift counts), and the active
    calibration state. Updates the Prometheus
    ``calibration_error_ratio{model=...}`` gauges. ``validate=True``
    first measures the card peak of plans missing one."""
    if validate:
        _validate_missing()
    with _lock:
        entries = list(_entries.values())
    # per-platform seconds-per-cost-unit: the median measured/predicted
    # over entries with both sides (median: robust to one mismodeled
    # plan polluting the scale every other ratio is read against)
    pairs = [e.dispatch_min_s / e.dp_cost for e in entries
             if e.dp_cost and e.dp_cost > 0 and e.dispatch_min_s]
    scale = float(sorted(pairs)[len(pairs) // 2]) if pairs else None

    plans: Dict[str, Any] = {}
    logs: Dict[str, List[float]] = {m: [] for m in _MODELS}
    for e in entries:
        ratios: Dict[str, Optional[float]] = {}
        if scale and e.dp_cost and e.dp_cost > 0 and e.dispatch_min_s:
            r = (e.dp_cost * scale) / e.dispatch_min_s
            ratios["tiling_dp"] = round(r, 4)
            logs["tiling_dp"].append(math.log(r))
        if e.xla_peak_bytes and e.pred_mem_bytes_validated:
            r = e.pred_mem_bytes_validated / e.xla_peak_bytes
            ratios["peak_hbm"] = round(r, 4)
            logs["peak_hbm"].append(math.log(r))
        if e.service_count and e.service_total_s > 0 \
                and e.pred_service_total_s > 0:
            r = e.pred_service_total_s / e.service_total_s
            ratios["service_time"] = round(r, 4)
            logs["service_time"].append(math.log(r))
        plans[e.digest] = {
            "root": e.root,
            "predicted": {
                "dp_cost": e.dp_cost,
                "cost_components": e.components,
                "peak_bytes": e.pred_peak_bytes,
                "service_s": (
                    round(e.pred_service_total_s / e.service_count, 6)
                    if e.service_count else None),
            },
            "measured": {
                "dispatch_count": e.dispatch_count,
                "dispatch_min_s": e.dispatch_min_s,
                "dispatch_mean_s": (
                    round(e.dispatch_total_s / e.dispatch_count, 6)
                    if e.dispatch_count else None),
                "compile_s": e.compile_s,
                "flops": e.flops,
                "xla_bytes_accessed": e.xla_bytes_accessed,
                "xla_peak_bytes": e.xla_peak_bytes,
                "service_mean_s": (
                    round(e.service_total_s / e.service_count, 6)
                    if e.service_count else None),
                "device": ({
                    "samples": e.device_samples,
                    "tier": e.device_tier,
                    "wall_mean_s": round(
                        e.device_wall_total_s / e.device_samples, 9),
                    "attributed_mean_s": round(
                        e.device_attr_total_s / e.device_samples, 9),
                    "class_seconds_mean": {
                        k: round(v / e.device_samples, 9)
                        for k, v in (e.device_components or {}).items()},
                } if e.device_samples else None),
                "skew": ({
                    "samples": e.skew_samples,
                    "imbalance_ratio_last": round(e.skew_ratio_last, 4),
                    "imbalance_ratio_max": round(e.skew_ratio_max, 4),
                    "straggler_wait_mean_s": round(
                        e.skew_wait_total_s / e.skew_samples, 9),
                } if e.skew_samples else None),
            },
            "ratios": ratios,
        }

    models: Dict[str, Any] = {}
    for m in _MODELS:
        ls = logs[m]
        rec: Dict[str, Any] = {
            "samples": len(ls),
            "drift_events": REGISTRY.counter(
                labeled("calibration_drift_total", model=m)).value,
        }
        if ls:
            gm = math.exp(sum(ls) / len(ls))
            rec["calibration_error_ratio"] = round(gm, 4)
            rec["worst_abs_log"] = round(max(abs(v) for v in ls), 4)
            if _METRICS_FLAG._value:
                REGISTRY.gauge(
                    labeled("calibration_error_ratio", model=m),
                    "geometric-mean predicted/measured ratio per cost "
                    "model (1.0 = calibrated; scale-normalized for "
                    "tiling_dp)").set(float(gm))
        models[m] = rec
    if scale is not None:
        models["tiling_dp"]["seconds_per_cost_unit"] = scale

    prof = _active_profile
    return {
        "plans": plans,
        "models": models,
        "drift_tol": FLAGS.calibration_drift_tol,
        "calibration": {
            "enabled": bool(FLAGS.cost_calibration),
            "fingerprint": FLAGS.cost_calibration_fingerprint or None,
            "profile": prof.to_dict() if prof is not None else None,
        },
    }


def reset() -> None:
    """Drop every ledger entry and the DP scale state (test isolation;
    the active calibration profile is NOT touched — use
    ``set_profile(None)``)."""
    with _lock:
        _entries.clear()
        _dp_state["n"] = 0
        _dp_state["log_scale"] = 0.0


# -- profile-guided calibration ------------------------------------------


class CalibrationProfile:
    """Per-op-class multiplicative corrections for the tiling DP.

    ``factors`` maps class names (:data:`CLASSES`) to relative
    multipliers (cost-weighted mean ~1 over the fit set — the profile
    reshapes the model's trade-offs, not its absolute scale). File
    format (``st.save_profile`` / ``st.load_profile``)::

        {"version": 2,
         "factors": {"reshard": 4.1, "psum": 0.8, ...},
         "meta": {"fitted_from_plans": 12, "platform": "cpu",
                  "source": "device_time" | "host_wall",
                  "device_rows": 8, ...}}

    Version history: v1 profiles predate the device-time columns
    (``meta.source`` / ``meta.device_rows``); :meth:`from_dict` still
    accepts them, defaulting ``source`` to ``"host_wall"`` — the only
    measurement v1 fits could have used. Writers emit
    :data:`PROFILE_VERSION`.
    """

    def __init__(self, factors: Dict[str, float],
                 meta: Optional[Dict[str, Any]] = None):
        self.factors = {str(k): float(v) for k, v in factors.items()
                        if float(v) > 0}
        self.meta = dict(meta or {})
        self.meta.setdefault("source", "host_wall")

    def fingerprint(self) -> str:
        """Stable short digest of the factor set — keyed into
        ``_opt_flags_key`` via FLAGS.cost_calibration_fingerprint."""
        import hashlib

        blob = json.dumps(sorted((k, round(v, 6))
                                 for k, v in self.factors.items()))
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    def to_dict(self) -> Dict[str, Any]:
        return {"version": PROFILE_VERSION,
                "factors": dict(self.factors),
                "meta": dict(self.meta),
                "fingerprint": self.fingerprint()}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CalibrationProfile":
        version = int(d.get("version", 1))
        if not 1 <= version <= PROFILE_VERSION:
            raise ValueError(
                f"unsupported calibration profile version "
                f"{d.get('version')!r} (this build reads 1.."
                f"{PROFILE_VERSION})")
        meta = dict(d.get("meta") or {})
        if version < 2:
            # pre-device-column profiles could only have been fitted
            # from host wall; default the v2 fields so downstream
            # readers see one schema
            meta.setdefault("source", "host_wall")
            meta.setdefault("device_rows", 0)
        return cls(d.get("factors") or {}, meta)

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v:.3g}"
                         for k, v in sorted(self.factors.items()))
        return f"CalibrationProfile({body})"


_active_profile: Optional[CalibrationProfile] = None


def set_profile(profile: Optional[CalibrationProfile]) -> None:
    """Install (or clear) the active calibration profile. Writing the
    fingerprint flag bumps the config mutation counter, which
    invalidates ``expr/base``'s memoized flags key — every plan signed
    after this call carries the new fingerprint."""
    global _active_profile
    _active_profile = profile
    FLAGS.cost_calibration_fingerprint = (
        profile.fingerprint() if profile is not None else "")


def active_profile() -> Optional[CalibrationProfile]:
    return _active_profile


def factors() -> Optional[Dict[str, float]]:
    """The active per-op-class factors when calibration is on, else
    None (the tiling DP's one read per table build)."""
    if not _CAL_FLAG._value:
        return None
    p = _active_profile
    return p.factors if p is not None else None


def fit_profile(min_dispatches: int = 1) -> Optional[CalibrationProfile]:
    """Least-squares per-op-class factors from the ledger.

    Entries carrying DEVICE columns (sampled attribution,
    ``obs/profile``) contribute one row PER CLASS — the predicted
    component against the class's measured device seconds, so each
    factor is determined by where the device actually spent time.
    Entries with only host measurements contribute the classic total
    row ``sum_c comp[c] * f_c ~= dispatch_min_s``. The solution is
    clipped positive and normalized so the total modeled cost over the
    fit set is unchanged (factors are relative). Returns None when the
    ledger holds nothing fittable."""
    import numpy as np

    rows: List[Tuple[Dict[str, float], float]] = []
    device_rows = 0
    imbalanced_rows = 0
    warn = float(getattr(FLAGS, "skew_warn_ratio", 1.5) or 1.5)
    with _lock:
        for e in _entries.values():
            if not e.components:
                continue
            # skew context: rows fitted from an entry whose last
            # measured shard-imbalance ratio exceeded the warn
            # threshold were inflated by a dragging shard — counted
            # into the profile meta so operators can judge the fit
            hot = (e.skew_ratio_last is not None
                   and e.skew_ratio_last > warn)
            if e.device_samples and e.device_components:
                n = e.device_samples
                for c, secs in e.device_components.items():
                    pc = e.components.get(c, 0.0)
                    if pc > 0 and secs > 0:
                        rows.append(({c: pc}, secs / n))
                        device_rows += 1
                        imbalanced_rows += int(hot)
                continue
            if e.dispatch_min_s and e.dispatch_count >= min_dispatches:
                rows.append((dict(e.components), e.dispatch_min_s))
                imbalanced_rows += int(hot)
    if not rows:
        return None
    classes = sorted({c for comp, _ in rows for c in comp
                      if comp.get(c, 0.0) > 0})
    if not classes:
        return None
    a = np.array([[comp.get(c, 0.0) for c in classes]
                  for comp, _ in rows], dtype=np.float64)
    b = np.array([m for _, m in rows], dtype=np.float64)
    # condition: scale each class column to unit mean so lstsq is not
    # dominated by the class with the largest raw byte counts
    col = a.mean(axis=0)
    col[col <= 0] = 1.0
    sol, *_ = np.linalg.lstsq(a / col, b, rcond=None)
    sol = np.clip(sol / col, 1e-12, None)
    denom = float((a * sol).sum())
    base = float(a.sum())
    if denom <= 0 or base <= 0:
        return None
    f = np.clip(sol * (base / denom), 0.01, 100.0)
    factors_ = {c: float(f[i]) for i, c in enumerate(classes)}
    return CalibrationProfile(factors_, meta={
        "fitted_from_plans": len(rows), "classes": classes,
        "source": ("device_time" if device_rows else "host_wall"),
        "device_rows": device_rows,
        "imbalanced_rows": imbalanced_rows})


def save_profile(path: str,
                 profile: Optional[CalibrationProfile] = None) -> str:
    """Persist a calibration profile as JSON: the given one, else the
    active one, else a fresh fit from the ledger. Returns the path."""
    profile = profile or _active_profile or fit_profile()
    if profile is None:
        raise ValueError(
            "no calibration profile to save: none is active and the "
            "ledger holds no fittable entries (run some plans with "
            "FLAGS.cost_ledger on, or pass a profile explicitly)")
    with open(path, "w") as fh:
        json.dump(profile.to_dict(), fh, indent=2, sort_keys=True)
    return path


def load_profile(path: str) -> CalibrationProfile:
    """Load a profile from ``path`` and install it as the active one
    (enable application with ``FLAGS.cost_calibration = True``)."""
    with open(path) as fh:
        profile = CalibrationProfile.from_dict(json.load(fh))
    set_profile(profile)
    return profile
