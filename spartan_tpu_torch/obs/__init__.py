"""Observability: spans and metrics (port of ``spartan_tpu/obs``).

* :mod:`trace` — nested host-side spans for the plan lifecycle
  (evaluate -> sign -> optimize -> per-pass -> tiling -> build ->
  dispatch), ring-buffered and exportable as Chrome trace-event JSON
  (``st.trace_export(path)``; load in Perfetto).
* :mod:`metrics` — typed counters / gauges / histograms: per-phase
  p50/p95/max, plan-cache hit ratio, device memory high-water.
  ``st.metrics()`` snapshots as JSON; ``st.metrics(fmt="prometheus")``
  renders Prometheus text format.

The JAX package's ``explain``, ``numerics``, ``ledger``, ``profile``,
``flight``, ``skew``, ``slo`` and ``monitor`` modules are not ported
yet (ROADMAP A4-A6).

Import discipline: ``obs`` sits below the expr and array layers (only
``utils/config`` above it), so every subsystem can emit spans and
metrics without import cycles.
"""

from . import metrics as _metrics_mod
from . import trace as _trace_mod
from .metrics import REGISTRY, Counter, Gauge, Histogram, Registry
from .trace import Span, span

metrics = _metrics_mod.snapshot
trace_export = _trace_mod.export
trace_events = _trace_mod.events
trace_clear = _trace_mod.clear

__all__ = ["span", "Span", "trace_export", "trace_events", "trace_clear",
           "metrics", "REGISTRY", "Registry", "Counter", "Gauge",
           "Histogram"]
