"""Observability (port of ``spartan_tpu/obs``).

* :mod:`trace` — nested host-side spans for the plan lifecycle
  (evaluate -> sign -> optimize -> per-pass -> tiling -> build ->
  dispatch), ring-buffered and exportable as Chrome trace-event JSON
  (``st.trace_export(path)``; load in Perfetto).
* :mod:`metrics` — typed counters / gauges / histograms: per-phase
  p50/p95/max, plan-cache hit ratio, device memory high-water.
  ``st.metrics()`` snapshots as JSON; ``st.metrics(fmt="prometheus")``
  renders Prometheus text format.
* :mod:`explain` — ``st.explain(expr)``: passes, tilings, kernel nodes,
  reshard edges and the counted ``cost_analysis`` of a plan.
* :mod:`ledger` — ``st.ledger()``: the tiling DP's predictions next to
  measured walks and device profiles; ``fit_profile`` / ``save_profile``
  / ``load_profile`` calibrate the DP from them.
* :mod:`numerics` — ``st.audit`` (per-node device health words),
  ``st.watch`` watchpoints, ``st.loop(health=...)`` series, the dispatch
  watchdog and ``dump_crash``.
* :mod:`profile` — ``st.profile(expr)``: per-node device seconds (a
  ``torch.profiler`` capture on the card, replay elsewhere);
  ``st.profile_export`` merges them with the host spans.

* :mod:`flight` — ``st.flightrec()``: the serve path's per-request
  flight recorder (submit -> queue -> coalesce -> dispatch -> resolve ->
  fetch) with per-tenant latency decompositions.
* :mod:`slo` — per-tenant latency SLO classes for the serve path
  (``FLAGS.serve_slo_classes``): windowed violation tracking and the
  ``slo_burn_rate{slo_class=...}`` gauges.
* :mod:`skew` — ``st.skew(expr)``: per-position time skew with a
  collective wait decomposition, per-block data skew, and an advisory
  re-tiling, sampled on the profiler's cadence.

The JAX package's ``monitor`` is not ported yet.

Import discipline: ``obs`` sits below the expr and array layers (only
``utils/config`` above it), so every subsystem can emit spans and
metrics without import cycles.
"""

from . import flight
from . import ledger as _ledger_mod
from . import metrics as _metrics_mod
from . import numerics
from . import profile
from . import skew
from . import slo
from . import trace as _trace_mod
from .explain import ExplainReport, explain
from .ledger import (CalibrationProfile, fit_profile, load_profile,
                     save_profile)
from .metrics import REGISTRY, Counter, Gauge, Histogram, Registry
from .numerics import (AuditReport, Watchpoint, audit, dump_crash,
                       loop_health, unwatch, watch, watchpoints)
from .profile import DeviceProfile
from .skew import SkewReport
from .trace import Span, span

# the module stays importable as obs.ledger; the snapshot is
# ledger_snapshot (spartan_tpu_torch/__init__ wraps it as st.ledger())
ledger = _ledger_mod
metrics = _metrics_mod.snapshot
ledger_snapshot = _ledger_mod.snapshot
flightrec = flight.snapshot
profile_export = profile.export_merged
trace_export = _trace_mod.export
trace_events = _trace_mod.events
trace_clear = _trace_mod.clear

__all__ = ["span", "Span", "trace_export", "trace_events", "trace_clear",
           "metrics", "REGISTRY", "Registry", "Counter", "Gauge",
           "Histogram", "explain", "ExplainReport", "numerics",
           "audit", "AuditReport", "watch", "unwatch", "watchpoints",
           "Watchpoint", "loop_health", "dump_crash",
           "ledger", "ledger_snapshot", "CalibrationProfile",
           "fit_profile", "save_profile", "load_profile", "profile",
           "profile_export", "DeviceProfile", "flight", "flightrec",
           "skew", "SkewReport", "slo"]
