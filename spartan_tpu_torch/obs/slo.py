"""Per-tenant latency SLO classes for the serving path (port of
``spartan_tpu/obs/slo.py``).

The serve engine (``serve/engine``) admits per-tenant request streams
but, before this module, had no notion of a latency *objective*: every
tenant competed for the same queue and the only deadline semantics
were per-request ``deadline=`` arguments. This module adds the
operator-facing contract:

1. **SLO classes** — ``FLAGS.serve_slo_classes`` declares named
   latency classes, each with a target latency, an objective (the
   fraction of requests that must land under the target) and an
   optional queue share::

       FLAGS.serve_slo_classes = (
           "gold=0.05@0.999:1.0,silver=0.2@0.99:0.5,default=1.0@0.9")

   ``name=target_seconds@objective[:queue_share]``. ``queue_share``
   (0..1, default 1.0) caps how much of the admission queue the class
   may occupy — ``serve/engine.submit`` rejects a request with
   ``Backpressure`` when its class's share is exhausted, so a bulk
   tenant cannot starve the latency-sensitive one (DrJAX-style
   serving: admission is part of the latency contract, not an
   afterthought).

2. **Tenant mapping** — ``FLAGS.serve_slo_tenants`` maps tenant ids to
   class names (``"teamA=gold,teamB=silver"``). Unmapped tenants (and
   the anonymous ``None`` tenant) fall to the class named ``default``
   when one is declared, else they are untracked (zero hot-path cost:
   one memoized-parse check).

3. **Burn rate** — :func:`observe` records each resolved request's
   end-to-end latency into a bounded per-class window and publishes
   ``slo_requests_total{slo_class=}`` / ``slo_violations_total
   {slo_class=}`` counters and the ``slo_burn_rate{slo_class=}``
   gauge: the windowed violation rate divided by the class's error
   budget ``(1 - objective)``. Burn 1.0 = exactly consuming budget.
   The JAX package's monitor alerts on sustained burn; the port's
   monitor is not written yet, and :func:`burn_rates` is its input.

Parsing is memoized on ``config.mutation_count()`` (the
``_opt_flags_key`` pattern) so the per-request cost when no classes
are configured is one counter comparison. Imports only config +
metrics — usable from serve/ and obs/ without cycles.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional, Tuple

from ..utils import config as config_mod
from ..utils.config import FLAGS
from .metrics import METRICS_FLAG as _METRICS_FLAG
from .metrics import REGISTRY, labeled

FLAGS.define_str(
    "serve_slo_classes", "",
    "Comma-separated latency SLO classes for the serve path: "
    "'name=target_seconds@objective[:queue_share]', e.g. "
    "'gold=0.05@0.999:1.0,default=1.0@0.9'. Empty = SLO tracking off "
    "(zero serve-path cost beyond one memoized check).")
FLAGS.define_str(
    "serve_slo_tenants", "",
    "Tenant-to-SLO-class mapping, 'tenant=class' comma-separated. "
    "Unmapped tenants use the class named 'default' when declared.")
FLAGS.define_int(
    "serve_slo_window", 256,
    "Requests per SLO class kept in the sliding violation window the "
    "burn rate is computed over.")


class SLOClass:
    """One parsed latency class: name, target seconds, objective
    (fraction of requests that must meet the target), queue share."""

    __slots__ = ("name", "target_s", "objective", "share")

    def __init__(self, name: str, target_s: float, objective: float,
                 share: float = 1.0):
        self.name = name
        self.target_s = float(target_s)
        self.objective = min(max(float(objective), 0.0), 0.999999)
        self.share = min(max(float(share), 0.0), 1.0)

    def budget(self) -> float:
        """The error budget: the tolerated violation fraction."""
        return 1.0 - self.objective

    def to_dict(self) -> Dict[str, Any]:
        return {"target_s": self.target_s, "objective": self.objective,
                "queue_share": self.share}

    def __repr__(self) -> str:
        return (f"SLOClass({self.name}={self.target_s}@"
                f"{self.objective}:{self.share})")


def _parse_classes(spec: str) -> Dict[str, SLOClass]:
    out: Dict[str, SLOClass] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item or "=" not in item:
            continue
        name, _, rest = item.partition("=")
        share = 1.0
        if ":" in rest:
            rest, _, share_s = rest.rpartition(":")
            try:
                share = float(share_s)
            except ValueError:
                share = 1.0
        target_s, _, obj_s = rest.partition("@")
        try:
            out[name.strip()] = SLOClass(
                name.strip(), float(target_s),
                float(obj_s) if obj_s else 0.99, share)
        except ValueError:
            continue
    return out


def _parse_tenants(spec: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item or "=" not in item:
            continue
        tenant, _, cls = item.partition("=")
        out[tenant.strip()] = cls.strip()
    return out


# memoized parse: (mutation_count, classes, tenant_map) — any flag
# write invalidates, matching expr/base._opt_flags_key
_parsed: Optional[Tuple[int, Dict[str, SLOClass], Dict[str, str]]] = None


def classes() -> Dict[str, SLOClass]:
    """The parsed class table (memoized on the config mutation
    counter). Empty dict = SLO tracking off."""
    global _parsed
    ver = config_mod.mutation_count()
    p = _parsed
    if p is None or p[0] != ver:
        p = (ver, _parse_classes(FLAGS.serve_slo_classes),
             _parse_tenants(FLAGS.serve_slo_tenants))
        _parsed = p
    return p[1]


def class_for(tenant: Optional[str]) -> Optional[SLOClass]:
    """Resolve a tenant id to its SLO class (None = untracked)."""
    table = classes()
    if not table:
        return None
    tenants = _parsed[2] if _parsed is not None else {}
    name = tenants.get(tenant) if tenant is not None else None
    if name is None:
        name = "default"
    return table.get(name)


class _Window:
    """Bounded per-class violation window (requests, violations)."""

    __slots__ = ("samples", "violations")

    def __init__(self, maxlen: int):
        self.samples: deque = deque(maxlen=maxlen)
        self.violations = 0

    def add(self, violated: bool) -> None:
        if len(self.samples) == self.samples.maxlen:
            self.violations -= self.samples[0]
        self.samples.append(1 if violated else 0)
        self.violations += 1 if violated else 0

    def rate(self) -> Optional[float]:
        n = len(self.samples)
        return (self.violations / n) if n else None


_lock = threading.Lock()
_windows: Dict[str, _Window] = {}


def observe(tenant: Optional[str], latency_s: float) -> None:
    """Record one resolved request's end-to-end latency against its
    tenant's SLO class: updates the violation window, the
    ``slo_requests_total`` / ``slo_violations_total`` counters and the
    ``slo_burn_rate`` gauge. No-op when the tenant is untracked."""
    cls = class_for(tenant)
    if cls is None:
        return
    violated = latency_s > cls.target_s
    with _lock:
        w = _windows.get(cls.name)
        if w is None or w.samples.maxlen != max(
                8, int(FLAGS.serve_slo_window)):
            w = _windows[cls.name] = _Window(
                max(8, int(FLAGS.serve_slo_window)))
        w.add(violated)
        rate = w.rate()
    if _METRICS_FLAG._value:
        REGISTRY.counter(
            labeled("slo_requests_total", slo_class=cls.name),
            "resolved serve requests observed per SLO class").inc()
        if violated:
            REGISTRY.counter(
                labeled("slo_violations_total", slo_class=cls.name),
                "requests that missed their SLO class's latency "
                "target").inc()
        if rate is not None:
            REGISTRY.gauge(
                labeled("slo_burn_rate", slo_class=cls.name),
                "windowed SLO violation rate over the class error "
                "budget (1.0 = exactly consuming budget)").set(
                    rate / max(cls.budget(), 1e-6))


def burn_rates() -> Dict[str, Dict[str, Any]]:
    """Per-class burn state for the monitor and ``st.status()``:
    ``{class: {burn_rate, violation_rate, window, target_s,
    objective}}``."""
    table = classes()
    out: Dict[str, Dict[str, Any]] = {}
    with _lock:
        wins = dict(_windows)
    for name, cls in table.items():
        w = wins.get(name)
        rate = w.rate() if w is not None else None
        out[name] = {
            "target_s": cls.target_s,
            "objective": cls.objective,
            "queue_share": cls.share,
            "window": len(w.samples) if w is not None else 0,
            "violation_rate": (round(rate, 6)
                               if rate is not None else None),
            "burn_rate": (round(rate / max(cls.budget(), 1e-6), 4)
                          if rate is not None else None),
        }
    return out


def reset() -> None:
    """Drop all violation windows (test isolation; the flag-declared
    class table is re-parsed lazily)."""
    global _parsed
    with _lock:
        _windows.clear()
    _parsed = None
