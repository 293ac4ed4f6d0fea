"""Typed metrics registry: counters / gauges / histograms.

Port of ``spartan_tpu/obs/metrics.py``. Three instrument types, all
behind one lock:

* :class:`Counter` — monotonically increasing int
  (``plan_hits``, ``plan_misses``, ``evaluations``, ...);
* :class:`Gauge` — point-in-time value with a tracked high-water mark
  (``device_peak_bytes_in_use``);
* :class:`Histogram` — streaming count/sum/max plus a bounded sample
  window for p50/p95 (per-phase wall times: ``phase:sign``,
  ``phase:dispatch``, ``phase:pass:<name>``, ...).

``snapshot()`` exports the whole registry as JSON-ready dicts;
``prometheus()`` renders Prometheus text exposition format, in the JAX
package's names. ``FLAGS.metrics`` gates recording at the
``utils/profiling`` layer (direct instrument handles always record).

Imports only the config layer — usable from any subsystem without
cycles.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Dict, List, Tuple

from ..utils.config import FLAGS

# hot shims (utils/profiling.count / record_phase) read ._value
# directly to skip FLAGS.__getattr__
METRICS_FLAG = FLAGS.flag("metrics")


def escape_label_value(v: Any) -> str:
    """Prometheus exposition-format label-value escaping (backslash,
    double quote, newline): a hostile tenant label cannot break a
    scrape line or smuggle a fake series."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """``# HELP`` text escaping per the exposition format (backslash
    and newline only)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def labeled(name: str, **labels: Any) -> str:
    """Canonical instrument name carrying Prometheus-style labels:
    ``labeled("serve_requests", tenant="acme")`` ->
    ``serve_requests{tenant="acme"}``. Labels are sorted so the same
    label set always maps to the same instrument, values are escaped
    per the exposition format at definition time (the canonical key IS
    the rendered form), and ``prometheus()`` renders the label block
    natively (one TYPE line per base name)."""
    if not labels:
        return name
    body = ",".join(
        f'{k}="{escape_label_value(v)}"'
        for k, v in sorted(labels.items()))
    return f"{name}{{{body}}}"


def split_labels(key: str) -> tuple:
    """Inverse view of :func:`labeled`: (base name, label block or '')."""
    i = key.find("{")
    if i < 0:
        return key, ""
    return key[:i], key[i:]


def parse_labels(key: str) -> tuple:
    """Escape-aware inverse of :func:`labeled`: ``(base name, {label:
    unescaped value})``. Also parses rendered exposition series
    names."""
    base, block = split_labels(key)
    out: Dict[str, str] = {}
    i = 1  # past '{'
    n = len(block)
    while 0 < i < n and block[i] != "}":
        j = block.find("=", i)
        if j < 0 or j + 1 >= n or block[j + 1] != '"':
            break
        label = block[i:j]
        i = j + 2  # past ="
        val: List[str] = []
        while i < n and block[i] != '"':
            ch = block[i]
            if ch == "\\" and i + 1 < n:
                nxt = block[i + 1]
                val.append({"\\": "\\", '"': '"', "n": "\n"}.get(
                    nxt, "\\" + nxt))
                i += 2
            else:
                val.append(ch)
                i += 1
        out[label] = "".join(val)
        i += 1  # past closing quote
        if i < n and block[i] == ",":
            i += 1
    return base, out


class Counter:
    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def _reset(self) -> None:
        self._value = 0


class Gauge:
    __slots__ = ("name", "help", "_value", "_max", "_lock")

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._value: float = 0.0
        self._max: float = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v
            if v > self._max:
                self._max = v

    @property
    def value(self) -> float:
        return self._value

    @property
    def high_water(self) -> float:
        return self._max

    def _reset(self) -> None:
        self._value = 0.0
        self._max = 0.0


def _percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile over a non-empty sorted sample list."""
    i = min(len(samples) - 1, max(0, int(round(q * (len(samples) - 1)))))
    return samples[i]


class Histogram:
    """Streaming count/sum/max (exact) + a bounded recent-sample window
    for p50/p95 (approximate once the window wraps)."""

    __slots__ = ("name", "help", "count", "total", "vmax", "_samples",
                 "_lock")

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self.count = 0
        self.total = 0.0
        self.vmax = 0.0
        self._samples: Deque[float] = deque(
            maxlen=max(16, FLAGS.metrics_hist_window))
        self._lock = lock

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v > self.vmax:
                self.vmax = v
            self._samples.append(v)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            samples = sorted(self._samples)
            out = {"count": self.count, "sum": self.total,
                   "max": self.vmax}
        if samples:
            out["p50"] = _percentile(samples, 0.50)
            out["p95"] = _percentile(samples, 0.95)
        else:
            out["p50"] = out["p95"] = 0.0
        return out

    def _reset(self) -> None:
        self.count = 0
        self.total = 0.0
        self.vmax = 0.0
        self._samples.clear()


class Registry:
    """Get-or-create instrument registry; one per process (``REGISTRY``).

    ``reset()`` zeroes every instrument but keeps the registrations, so
    a snapshot taken right after a reset has the same keys (zeroed) —
    benchmark brackets diff snapshots without key juggling."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(
                    name, Counter(name, help, self._lock))
        return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(
                    name, Gauge(name, help, self._lock))
        return g

    def histogram(self, name: str, help: str = "") -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(
                    name, Histogram(name, help, self._lock))
        return h

    def counter_values(self) -> Dict[str, int]:
        with self._lock:
            return {k: c._value for k, c in self._counters.items()}

    def snapshot(self, reset: bool = False) -> Dict[str, Any]:
        """JSON-ready view of every instrument, taken under ONE lock
        hold so counters, gauges and histogram summaries all come from
        the same instant: a reader concurrent with recording threads
        never pairs a counter from T0 with a histogram from T1. The
        histogram summaries are computed
        inline (the shared lock is not reentrant; ``Histogram.summary``
        would deadlock here). ``reset=True`` zeroes every instrument
        inside the same critical section: the read-and-reset is atomic,
        so no concurrent increment can land between the read and the
        zero and be lost — the ``st.metrics(reset=True)`` delta-scrape
        contract."""
        with self._lock:
            counters = {k: c._value for k, c in self._counters.items()}
            gauges = {k: {"value": g._value, "max": g._max}
                      for k, g in self._gauges.items()}
            hists: Dict[str, Dict[str, float]] = {}
            for k, h in self._hists.items():
                samples = sorted(h._samples)
                summ = {"count": h.count, "sum": h.total,
                        "max": h.vmax}
                if samples:
                    summ["p50"] = _percentile(samples, 0.50)
                    summ["p95"] = _percentile(samples, 0.95)
                else:
                    summ["p50"] = summ["p95"] = 0.0
                hists[k] = summ
            if reset:
                for table in (self._counters, self._gauges,
                              self._hists):
                    for inst in table.values():
                        inst._reset()
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
        }

    def prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4). Instruments named
        through :func:`labeled` render their label block natively, with
        one ``# HELP`` (when the instrument carries help text, escaped
        per the format) + ``# TYPE`` pair per base metric (labeled
        counters become ``spartan_<name>{label="..."} N`` series; label
        values were escaped at :func:`labeled` time)."""
        lines: List[str] = []
        typed: set = set()
        with self._lock:
            helps: Dict[str, str] = {}
            for table in (self._counters, self._gauges, self._hists):
                for key, inst in table.items():
                    base, _ = split_labels(key)
                    if inst.help and base not in helps:
                        helps[base] = inst.help

        def _name(raw: str) -> str:
            safe = "".join(ch if (ch.isalnum() or ch == "_") else "_"
                           for ch in raw)
            return "spartan_" + safe

        def _series(raw: str, kind: str) -> str:
            base, labels = split_labels(raw)
            n = _name(base)
            if (n, kind) not in typed:
                typed.add((n, kind))
                if base in helps:
                    lines.append(
                        f"# HELP {n} {_escape_help(helps[base])}")
                lines.append(f"# TYPE {n} {kind}")
            return n + labels

        snap = self.snapshot()
        for k in sorted(snap["counters"]):
            lines.append(f"{_series(k, 'counter')} {snap['counters'][k]}")
        for k in sorted(snap["gauges"]):
            g = snap["gauges"][k]
            lines.append(f"{_series(k, 'gauge')} {g['value']}")
            base, labels = split_labels(k)
            n = _name(base) + "_max"
            if (n, "gauge") not in typed:
                typed.add((n, "gauge"))
                lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n}{labels} {g['max']}")
        for k in sorted(snap["histograms"]):
            h = snap["histograms"][k]
            base, labels = split_labels(k)
            n = _name(base)
            if (n, "summary") not in typed:
                typed.add((n, "summary"))
                if base in helps:
                    lines.append(
                        f"# HELP {n} {_escape_help(helps[base])}")
                lines.append(f"# TYPE {n} summary")
            q1 = labels[:-1] + ',quantile="0.5"}' if labels else \
                '{quantile="0.5"}'
            q2 = labels[:-1] + ',quantile="0.95"}' if labels else \
                '{quantile="0.95"}'
            lines.append(f"{n}{q1} {h['p50']}")
            lines.append(f"{n}{q2} {h['p95']}")
            lines.append(f"{n}_sum{labels} {h['sum']}")
            lines.append(f"{n}_count{labels} {h['count']}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            insts = (list(self._counters.values())
                     + list(self._gauges.values())
                     + list(self._hists.values()))
            for inst in insts:
                inst._reset()


REGISTRY = Registry()


def device_memory_aggregate() -> Dict[str, Dict[str, float]]:
    """Memory stats aggregated across every visible CUDA device: per
    key the ``max`` (the card that runs out first) and the ``sum``
    (total footprint), read from ``torch.cuda.memory_stats``. The keys
    include the JAX package's names ``bytes_in_use``,
    ``peak_bytes_in_use`` and ``bytes_limit`` beside torch's own
    (``allocated_bytes.all.current``, ...). Empty on the CPU, where
    torch keeps no allocator statistics."""
    agg: Dict[str, Dict[str, float]] = {}
    import torch

    if not torch.cuda.is_available():
        return agg
    for i in range(torch.cuda.device_count()):
        stats = dict(torch.cuda.memory_stats(i))
        stats["bytes_in_use"] = stats.get("allocated_bytes.all.current", 0)
        stats["peak_bytes_in_use"] = stats.get("allocated_bytes.all.peak",
                                               0)
        stats["bytes_limit"] = torch.cuda.get_device_properties(
            i).total_memory
        for key, v in stats.items():
            try:
                v = float(v)
            except (TypeError, ValueError):
                continue
            cur = agg.get(key)
            if cur is None:
                agg[key] = {"max": v, "sum": v}
            else:
                cur["max"] = max(cur["max"], v)
                cur["sum"] += v
    return agg


def _update_device_gauges() -> None:
    """Record device memory gauges (high-water tracked by the Gauge)
    on the card; nothing on the CPU. ``device_<key>`` is the MAX across
    the visible devices and ``device_<key>_total`` the sum."""
    aggregate = device_memory_aggregate()
    for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
        agg = aggregate.get(key)
        if agg is None:
            continue
        REGISTRY.gauge(
            "device_" + key,
            "device memory stat " + key + " (max across local "
            "devices)").set(agg["max"])
        REGISTRY.gauge(
            "device_" + key + "_total",
            "device memory stat " + key + " (sum across local "
            "devices)").set(agg["sum"])


# -- collectives (parallel/collectives.py) --------------------------------


class _Tap(threading.local):
    """The plan audit's dry walk (``analysis/plan_audit.py``) installs a
    recorder here: while one is set, the collective, received and
    materialize records of this thread go to it and not to REGISTRY."""

    rec: Any = None


TAP = _Tap()


def record_collective(op: str, nbytes: int, group: int = 0) -> None:
    """One collective call of ``op`` at one position, moving the
    position's ``nbytes`` over a line of ``group`` positions:
    ``collective_calls{op=...}`` and ``collective_bytes{op=...}``.
    Recorded whatever ``FLAGS.metrics`` says, as a direct instrument
    handle is."""
    rec = TAP.rec
    if rec is not None:
        rec.collective(op, int(nbytes), int(group))
        return
    REGISTRY.counter(labeled("collective_calls", op=op),
                     "collective calls by op").inc()
    REGISTRY.counter(labeled("collective_bytes", op=op),
                     "bytes into collectives by op").inc(int(nbytes))


def record_staged(op: str, nbytes: int) -> None:
    """A CUDA tensor of ``nbytes`` that a gloo group's ``op`` took
    through a host buffer: ``collective_host_staged_calls{op=...}`` and
    ``collective_host_staged_bytes{op=...}``."""
    REGISTRY.counter(labeled("collective_host_staged_calls", op=op),
                     "collective calls staged through host memory").inc()
    REGISTRY.counter(labeled("collective_host_staged_bytes", op=op),
                     "bytes staged through host memory").inc(int(nbytes))


def record_received(op: str, nbytes: int) -> None:
    """Bytes a rank received from the other ranks of a group in one
    ``op`` that moved local blocks: ``group_received_bytes{op=...}``."""
    if TAP.rec is not None:
        return
    REGISTRY.counter(labeled("group_received_bytes", op=op),
                     "bytes received from other ranks by op").inc(int(nbytes))


def record_materialize(site: str, nbytes: int) -> None:
    """One whole array gathered on a group mesh for ``site`` (an expr
    node with no local rule, or a caller of ``DistArray.tensor``), of
    ``nbytes``: ``group_materialize_calls{site=...}`` and
    ``group_materialize_bytes{site=...}``."""
    rec = TAP.rec
    if rec is not None:
        rec.materialize(site, int(nbytes))
        return
    REGISTRY.counter(labeled("group_materialize_calls", site=site),
                     "whole arrays gathered on a group mesh").inc()
    REGISTRY.counter(labeled("group_materialize_bytes", site=site),
                     "bytes of whole arrays gathered").inc(int(nbytes))


def record_partition(node: str, result: str, reason: str) -> None:
    """One decision on whether a user function runs on a rank's blocks
    (``expr/partition.py``): ``group_partition_decisions{node, result,
    reason}``, ``result`` ``local`` or ``gather``. The plan audit's dry
    walk records none."""
    if TAP.rec is not None:
        return
    REGISTRY.counter(labeled("group_partition_decisions", node=node,
                             result=result, reason=reason),
                     "user-function partition decisions on a group "
                     "mesh").inc()


def partition_decisions() -> Dict[Tuple[str, str, str], int]:
    """``group_partition_decisions`` by (node, result, reason)."""
    out: Dict[Tuple[str, str, str], int] = {}
    for key, v in REGISTRY.counter_values().items():
        base, labels = parse_labels(key)
        if base == "group_partition_decisions" and v:
            k = (labels.get("node", ""), labels.get("result", ""),
                 labels.get("reason", ""))
            out[k] = out.get(k, 0) + v
    return out


def materialize_sites() -> Dict[str, int]:
    """``group_materialize_calls`` by site."""
    out: Dict[str, int] = {}
    for key, v in REGISTRY.counter_values().items():
        base, labels = parse_labels(key)
        if base == "group_materialize_calls" and v:
            site = labels.get("site", "")
            out[site] = out.get(site, 0) + v
    return out


def collective_totals() -> Dict[str, int]:
    """The collective, host-staging, received and materialize counters,
    each summed over its labels."""
    out = {"collective_calls": 0, "collective_bytes": 0,
           "collective_host_staged_calls": 0,
           "collective_host_staged_bytes": 0,
           "group_received_bytes": 0,
           "group_materialize_calls": 0, "group_materialize_bytes": 0}
    for key, v in REGISTRY.counter_values().items():
        base, _ = split_labels(key)
        if base in out:
            out[base] += v
    return out


def snapshot(fmt: str = "json", reset: bool = False) -> Any:
    """The public ``st.metrics()``: registry snapshot plus derived
    plan-cache and device-memory views.

    ``fmt="json"`` (default) returns a dict; ``fmt="prometheus"``
    returns Prometheus text exposition format. ``reset=True`` zeroes
    every instrument atomically with the read (delta scrapes: two
    concurrent reset-scrapers never double-count or lose an
    increment); for the prometheus format the reset happens after the
    render (the exposition path reads the registry twice)."""
    _update_device_gauges()
    if fmt == "prometheus":
        text = REGISTRY.prometheus()
        if reset:
            REGISTRY.reset()
        return text
    if fmt != "json":
        raise ValueError(f"unknown metrics format {fmt!r} "
                         "(expected 'json' or 'prometheus')")
    snap = REGISTRY.snapshot(reset=reset)
    c = snap["counters"]
    hits = c.get("plan_hits", 0)
    misses = c.get("plan_misses", 0)
    total = hits + misses
    snap["plan_cache"] = {
        "plan_hits": hits,
        "plan_misses": misses,
        "compiles": c.get("compiles", 0),
        "donated_dispatches": c.get("donated_dispatches", 0),
        "hit_rate": (hits / total) if total else None,
    }
    return snap
