"""Numerics sentinel: device-side data-health observability (port of
``spartan_tpu/obs/numerics.py``).

Under ``FLAGS.audit_numerics`` every expr node's value gains a cheap
device-side health word — NaN count, Inf count, absmax, zero count, size
— computed with torch ops on the value's device right after the node's
``_lower`` (``Expr.lower``; ``Expr.lower_local`` on a group mesh). The
words stay on the device: after the walk they are stacked once and read
back in ONE copy (no synchronize per node). On a group mesh each rank
words its own block (a replicated block counts at its first copy only),
and the ranks' words fold with one all-reduce per operation: the counts
summed, the absmax maxed. Each word is tagged with the node's
structural-signature digest, its op and the user line that built it. On
top of that one mechanism:

* :func:`audit` — ``st.audit(expr)`` evaluates once and reports the
  **first bad node in topological order** (leaves first, children before
  parents), with op, build site and — for leaves — per-tile stats, so a
  NaN born in one tile is named at its origin instead of surfacing as a
  garbage reduction many expressions later.
* :class:`Watchpoint` — ``st.watch(distarray)`` installs a persistent
  watchpoint whose health series feeds the metrics registry
  (``numerics_nan_nodes`` counter, ``numerics_absmax`` gauge) and the
  tracer (zero-duration ``health`` spans). Watchpoints are re-checked
  after every ``evaluate()``.
* loop health — ``st.loop(..., health=True)`` keeps a per-iteration
  carry-norm / update-norm series on the device and reads it once when
  the loop ends (``loop_health``), with divergence counting;
  ``early_exit=True`` reads one stop flag per iteration from the device
  (the port's loop is a host loop: there is no device ``while_loop``)
  and stops when the carry goes non-finite or the update norm falls
  below ``stall_tol``.
* :func:`watchdog` / :func:`dump_crash` — ``evaluate()`` arms a timer
  when ``FLAGS.dispatch_timeout_s`` > 0 around the host ``dispatch``
  phase; a phase that exceeds it dumps the in-flight span tree, the plan
  report, the last health word, loop-health tails, the cost ledger and
  a metrics snapshot to a crash file. A CUDA walk returns when its
  launches are queued, before the card is done: the watchdog times the
  launches, and device time past the walk shows at the fetch that waits
  for it.
* :func:`guard_finite` — declarative guards: under an audit a violated
  guard makes ``st.audit`` raise ``ValueError`` with the numpy-compatible
  message; with audit off it costs a None check.

The audit flag does not enter the plan key: an audited walk runs the
same cached plan and only adds the words, so a plan-cache hit under
audit still yields them. The JAX package keys it because its probes are
compiled into the program.

Import discipline: sits in ``obs`` (below the expr/array layers);
expr-layer types are reached lazily inside functions only.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.config import FLAGS
from . import trace as trace_mod
from .explain import key_hash
from .metrics import METRICS_FLAG as _METRICS_FLAG
from .metrics import REGISTRY

_AUDIT_FLAG = FLAGS.define_bool(
    "audit_numerics", False,
    "Compute a device-side health word (NaN/Inf counts, absmax, zero "
    "fraction) for every expr node's value during each walk, so st.audit "
    "can attribute the first bad value to the node (and user line) that "
    "produced it. The words are read back once per walk. Not part of the "
    "plan key: an audited walk runs the same cached plan.")
_TIMEOUT_FLAG = FLAGS.define_float(
    "dispatch_timeout_s", 0.0,
    "Dispatch watchdog: when > 0, an evaluate() dispatch phase (the host "
    "walk that launches a plan's kernels) that exceeds this many seconds "
    "dumps the in-flight span tree, plan report, last health word and "
    "metrics snapshot to FLAGS.crash_dump_path. 0 disarms (default).")
_CRASH_FLAG = FLAGS.define_str(
    "crash_dump_path", "",
    "Where the dispatch watchdog (and dump_crash) writes its JSON "
    "crash report; empty = spartan_tpu_torch_crash_<pid>.json in the "
    "system temp dir.")

_lock = threading.Lock()
_tls = threading.local()
_watch_ids = itertools.count()

# open probe sessions (any thread): Expr.lower reads this int first, so
# an unaudited walk pays one global read per node
_PROBING = 0

# host-side state; the watchdog's timer thread reads these, so everything
# mutates under _lock
_last_health: Optional[Dict[str, Any]] = None
_collectors: List["_AuditCollector"] = []
_loop_series: Dict[str, List[Dict[str, Any]]] = {}
_WATCHPOINTS: List["Watchpoint"] = []


def _user_site() -> Optional[Tuple[str, int, str]]:
    """First stack frame outside the package (watchpoint provenance)."""
    import sys

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(pkg):
            return (fn, f.f_lineno, f.f_code.co_name)
        f = f.f_back
    return None


def _site_str(site: Optional[Tuple[str, int, str]]) -> Optional[str]:
    return f"{site[0]}:{site[1]} (in {site[2]})" if site else None


# -- the health word -----------------------------------------------------


def _health_word(x: Any, weight: float = 1.0) -> Optional[torch.Tensor]:
    """Device 5-vector [nan_count, inf_count, absmax, zero_count, size]
    (float64: counts exact to 2**53) of one tensor, on its device. None
    for values health is not defined on (tuples, empty tensors, python
    scalars). ``weight`` scales the counts (0 for a group rank's
    replicated copy that another rank counts)."""
    if not isinstance(x, torch.Tensor) or x.numel() == 0:
        return None
    f64 = torch.float64
    if x.dtype == torch.bool:
        zero_t = torch.zeros((), dtype=f64, device=x.device)
        nan = inf = zero_t
        absmax = x.any().to(f64)
        zero = (~x).sum().to(f64)
    elif x.is_floating_point() or x.is_complex():
        nan = torch.isnan(x).sum().to(f64)
        inf = torch.isinf(x).sum().to(f64)
        absmax = x.abs().amax().to(f64)
        zero = (x == 0).sum().to(f64)
    else:  # integers: NaN/Inf are impossible by construction
        zero_t = torch.zeros((), dtype=f64, device=x.device)
        nan = inf = zero_t
        absmax = x.to(f64).abs().amax()
        zero = (x == 0).sum().to(f64)
    size = torch.full((), float(x.numel()), dtype=f64, device=x.device)
    w = torch.stack([nan, inf, absmax, zero, size])
    if weight != 1.0:
        w = w * torch.tensor([weight, weight, 1.0, weight, weight],
                             dtype=f64, device=x.device)
    return w


def _word_to_fields(word: Any) -> Dict[str, Any]:
    w = np.asarray(word, dtype=np.float64).ravel()
    size = int(w[4])
    # the JAX package's zero fraction is a float32 mean: the same
    # correctly rounded float32 quotient of the exact counts
    zero_frac = (float(np.float32(w[3]) / np.float32(size)) if size
                 else 0.0)
    return {
        "nan_count": int(w[0]), "inf_count": int(w[1]),
        "any_nan": bool(w[0] > 0), "any_inf": bool(w[1] > 0),
        "absmax": float(np.float32(w[2])), "zero_frac": zero_frac,
        "size": size,
    }


# -- probe sessions (walk time) ------------------------------------------


class _ProbeCtx:
    """Open while an audited plan is walked: hands out topological
    indices (leaves are probed first, then each node as its lowering
    returns, children before parents) and per-node structural-signature
    digests, and holds the device words until :meth:`finish`."""

    def __init__(self, mesh: Any = None) -> None:
        from ..expr.base import _SigCtx  # lazy: obs sits below expr

        self._topo = itertools.count()
        self._sig = _SigCtx()
        self.mesh = mesh
        self.metas: List[Tuple] = []
        self.words: List[torch.Tensor] = []

    def attach(self, node: Any, val: Any, kind: str) -> None:
        weight = 1.0
        shape = None
        if hasattr(val, "local") and hasattr(val, "tiling"):
            # a group mesh's local value: the rank's block
            weight = 1.0 if val.is_first_copy else 0.0
            shape = tuple(int(s) for s in val.shape)
            dtype = str(val.dtype)
            val = val.local
        word = _health_word(val, weight)
        if word is None:
            return
        if shape is None:
            shape = tuple(int(s) for s in val.shape)
            from ..utils import dtypes

            dtype = str(dtypes.to_numpy(val.dtype))
        topo = next(self._topo)
        try:
            digest = key_hash(self._sig.of(node))
        except Exception:
            digest = None
        op = type(node).__name__
        fn = getattr(getattr(node, "op", None), "fn", None)
        fname = getattr(fn, "__name__", None)
        if fname and fname != "<lambda>":
            op = f"{op}({fname})"
        self.metas.append((topo, f"{type(node).__name__}#{node._id}", op,
                           _site_str(node._site), digest, kind, shape,
                           dtype))
        self.words.append(word)

    def finish(self) -> None:
        """Stack the words of each device (a scalar leaf's lives on the
        host), read each stack back in one copy, fold them over a group
        mesh and record them."""
        if not self.words:
            return
        host = torch.empty((len(self.words), 5), dtype=torch.float64)
        by_dev: Dict[Any, List[int]] = {}
        for i, word in enumerate(self.words):
            by_dev.setdefault(word.device, []).append(i)
        for idx in by_dev.values():
            host[idx] = torch.stack([self.words[i] for i in idx]).cpu()
        mesh = self.mesh
        if mesh is not None and mesh.is_group:
            host = _fold_words(host, mesh).cpu()
        host = host.numpy()
        for meta, word in zip(self.metas, host):
            _record_health(meta, word)


def _fold_words(w: torch.Tensor, mesh: Any) -> torch.Tensor:
    """Rows of words folded over a group's ranks: one all-reduce summing
    the counts, one maxing the absmax (beside a NaN flag: a max
    all-reduce does not carry NaN reliably)."""
    from ..parallel import collectives as coll

    w = w.to(mesh.device)
    axes = tuple(mesh.axis_names)
    counts = coll.reduce_over(w[:, [0, 1, 3, 4]].contiguous(), axes, "add",
                              mesh)
    am = w[:, 2]
    isnan = torch.isnan(am)
    amax = coll.reduce_over(torch.stack([torch.where(isnan, 0.0, am),
                                         isnan.to(am.dtype)], dim=1),
                            axes, "max", mesh)
    amax = torch.where(amax[:, 1] > 0, float("nan"), amax[:, 0])
    return torch.stack([counts[:, 0], counts[:, 1], amax, counts[:, 2],
                        counts[:, 3]], dim=1)


class _ProbeSession:
    """Context manager installing a :class:`_ProbeCtx` for the current
    (walking) thread; on a clean exit the words are read back."""

    __slots__ = ("prev", "ctx")

    def __init__(self, mesh: Any = None):
        self.ctx = _ProbeCtx(mesh)

    def __enter__(self) -> "_ProbeSession":
        global _PROBING
        self.prev = getattr(_tls, "probe", None)
        _tls.probe = self.ctx
        with _lock:
            _PROBING += 1
        return self

    def __exit__(self, et, ev, tb) -> None:
        global _PROBING
        _tls.probe = self.prev
        with _lock:
            _PROBING -= 1
        if et is None:
            self.ctx.finish()


def probe_session(mesh: Any = None) -> _ProbeSession:
    return _ProbeSession(mesh)


def probing() -> bool:
    """True while an audited plan is walked on this thread."""
    return getattr(_tls, "probe", None) is not None


def probe(node: Any, val: Any, kind: str = "node") -> None:
    """Attach a health word to one node's value. No-op unless a probe
    session is open on this thread (``FLAGS.audit_numerics``)."""
    ctx = getattr(_tls, "probe", None)
    if ctx is not None:
        ctx.attach(node, val, kind)


def guard_finite(tag: str, value: Any, message: str) -> None:
    """Declarative finiteness guard (builtins route data-dependent
    validity checks through here). Under an audit a violated guard is
    recorded and makes ``st.audit`` raise ``ValueError(message %
    values)``; with audit off it costs a None check."""
    if getattr(_tls, "probe", None) is None:
        return
    v = torch.as_tensor(value).to(torch.float64).reshape(-1).cpu().numpy()
    _record_guard(tag, message, v)


# -- host-side recording -------------------------------------------------


def _feed_metrics(rec: Dict[str, Any]) -> None:
    if not _METRICS_FLAG._value:
        return
    REGISTRY.counter("numerics_health_records",
                     "health words received from device probes").inc()
    if rec["any_nan"]:
        REGISTRY.counter("numerics_nan_nodes",
                         "health words reporting at least one NaN").inc()
    if rec["any_inf"]:
        REGISTRY.counter("numerics_inf_nodes",
                         "health words reporting at least one Inf").inc()
    if np.isfinite(rec["absmax"]):
        REGISTRY.gauge("numerics_absmax",
                       "absmax high-water across probed values"
                       ).set(rec["absmax"])


def _record_health(meta: Tuple, word: Any) -> None:
    global _last_health

    rec = _word_to_fields(word)
    rec.update(topo=meta[0], node=meta[1], op=meta[2], site=meta[3],
               digest=meta[4], kind=meta[5], shape=list(meta[6]),
               dtype=meta[7])
    bad = rec["any_nan"] or rec["any_inf"]
    with _lock:
        _last_health = rec
        for coll in _collectors:
            coll.records.append(rec)
    _feed_metrics(rec)
    trace_mod.instant("health", error=bad, node=rec["node"], op=rec["op"],
                      site=rec["site"], kind=rec["kind"],
                      nan=rec["nan_count"], inf=rec["inf_count"],
                      absmax=rec["absmax"], zero_frac=rec["zero_frac"])


def _record_guard(tag: str, message: str, values: Any) -> None:
    vals = [float(v) for v in np.asarray(values, np.float64).ravel()]
    if all(np.isfinite(v) for v in vals):
        return
    rec = {"tag": tag, "message": message % tuple(vals), "values": vals}
    with _lock:
        for coll in _collectors:
            coll.guards.append(rec)
    if _METRICS_FLAG._value:
        REGISTRY.counter("numerics_guard_violations",
                         "finiteness guards violated (guard_finite)").inc()
    trace_mod.instant("guard", error=True, tag=tag, message=rec["message"])


def record_loop_health(label: str, step: Any, norm: Any,
                       update_norm: Any) -> None:
    """One iteration's health record of the loop ``label``
    (expr/loop.py files the series when the loop ends)."""
    n, un = float(norm), float(update_norm)
    finite = bool(np.isfinite(n) and np.isfinite(un))
    rec = {"step": int(step), "norm": n, "update_norm": un,
           "finite": finite}
    with _lock:
        _loop_series.setdefault(label, []).append(rec)
    if _METRICS_FLAG._value:
        REGISTRY.counter("numerics_loop_steps",
                         "loop iterations with health emission").inc()
        if not finite:
            REGISTRY.counter("numerics_loop_divergence",
                             "loop iterations whose carry/update went "
                             "non-finite").inc()
    trace_mod.instant("loop_health", error=not finite, loop=label,
                      step=rec["step"], norm=n, update_norm=un)


def loop_health_begin(label: str) -> None:
    """Reset ``label``'s iteration-health series (a fresh forcing)."""
    with _lock:
        _loop_series[label] = []


class loop_label_scope:
    """Files the health series of the outermost health loop walked inside
    the scope under ``label`` (the user's loop), whichever cached plan's
    loop node runs it: a plan-cache hit walks the loop node of the plan's
    first build."""

    __slots__ = ("label", "_prev")

    def __init__(self, label: str):
        self.label = label

    def __enter__(self) -> "loop_label_scope":
        self._prev = getattr(_tls, "loop_label", None)
        _tls.loop_label = self.label
        return self

    def __exit__(self, *exc: Any) -> None:
        _tls.loop_label = self._prev


def claim_loop_label(default: str) -> str:
    """The label a health loop files its series under: the open
    :class:`loop_label_scope`'s (claimed once, by the outermost loop),
    else ``default``."""
    label = getattr(_tls, "loop_label", None)
    if label is None:
        return default
    _tls.loop_label = None
    return label


def loop_health(label: Optional[str] = None) -> Any:
    """Iteration-health series for one loop label, or all of them."""
    with _lock:
        if label is not None:
            return list(_loop_series.get(label, []))
        return {k: list(v) for k, v in _loop_series.items()}


def last_health() -> Optional[Dict[str, Any]]:
    """The most recent health word received from any probe."""
    with _lock:
        return dict(_last_health) if _last_health else None


# -- st.audit ------------------------------------------------------------


class _AuditCollector:
    __slots__ = ("records", "guards")

    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []
        self.guards: List[Dict[str, Any]] = []


class AuditReport:
    """Result of :func:`audit`: the evaluated result plus every health
    word received, sorted topologically — ``first_bad`` is the earliest
    node (leaves, then children before parents) whose value contained a
    NaN or Inf."""

    def __init__(self, records: List[Dict[str, Any]], result: Any,
                 root: str,
                 tile_stats: Optional[List[Dict[str, Any]]] = None):
        self.records = sorted(records, key=lambda r: r["topo"])
        self.result = result
        self.root = root
        self.tile_stats = tile_stats
        bad = [r for r in self.records if r["any_nan"] or r["any_inf"]]
        self.first_bad: Optional[Dict[str, Any]] = bad[0] if bad else None
        self.bad_count = len({r["node"] for r in bad})

    @property
    def ok(self) -> bool:
        return self.first_bad is None

    def nodes(self) -> List[str]:
        """Distinct probed node labels in topological order."""
        seen: List[str] = []
        for r in self.records:
            if r["node"] not in seen:
                seen.append(r["node"])
        return seen

    def raise_if_bad(self) -> None:
        if self.first_bad is not None:
            fb = self.first_bad
            raise FloatingPointError(
                f"numerics audit: first bad node {fb['node']} "
                f"({fb['op']}) built at {fb['site']}: "
                f"{fb['nan_count']} NaN / {fb['inf_count']} Inf "
                f"of {fb['size']} element(s)")

    def to_dict(self) -> Dict[str, Any]:
        return {"root": self.root, "ok": self.ok,
                "bad_nodes": self.bad_count,
                "first_bad": self.first_bad, "records": self.records,
                "tile_stats": self.tile_stats}

    def __str__(self) -> str:
        lines = [f"numerics audit of {self.root}: "
                 + ("CLEAN" if self.ok else f"{self.bad_count} bad node(s)")]
        if self.first_bad is not None:
            fb = self.first_bad
            lines.append(f"  first bad (topo #{fb['topo']}): {fb['node']} "
                         f"[{fb['op']}] {fb['shape']} {fb['dtype']}")
            if fb["site"]:
                lines.append(f"    built at {fb['site']}")
            lines.append(
                f"    nan={fb['nan_count']} inf={fb['inf_count']} "
                f"absmax={fb['absmax']} zero_frac="
                f"{round(fb['zero_frac'], 4)} sig={fb['digest']}")
            if self.tile_stats:
                lines.append("    per-tile:")
                for t in self.tile_stats:
                    lines.append(
                        f"      {t['index']}: nan={t['nan_count']} "
                        f"inf={t['inf_count']} absmax={t['absmax']} "
                        f"[{t['device']}]")
        lines.append(f"  probed {len(self.nodes())} node(s), "
                     f"{len(self.records)} health word(s)")
        return "\n".join(lines)

    __repr__ = __str__


def _leaf_tile_stats(root: Any, label: str
                     ) -> Optional[List[Dict[str, Any]]]:
    """Per-tile stats for a bad LEAF: its DistArray is still held, so
    each logical shard is characterized independently — naming the
    poisoned tile, not just the array."""
    from ..expr.base import _leaf_array
    from ..expr.optimize import dag_nodes

    for n in dag_nodes(root):
        if f"{type(n).__name__}#{n._id}" != label:
            continue
        arr = _leaf_array(n)
        if arr is not None and not arr.is_donated:
            return tile_stats(arr)
    return None


def audit(expr: Any, donate: Sequence[Any] = ()) -> AuditReport:
    """Evaluate ``expr`` once with health words and report data health
    per node — ``.first_bad`` is the first bad node in topological order,
    with its op, structural digest and user build site (and per-tile
    stats when the origin is a leaf).

    The audited walk runs the plan the cache holds for this structure
    (the audit flag is not part of the plan key). A violated
    :func:`guard_finite` raises ``ValueError`` with its message."""
    from ..expr import base

    root = expr if isinstance(expr, base.Expr) else base.as_expr(expr)
    root.invalidate()  # audit re-executes
    coll = _AuditCollector()
    prev = _AUDIT_FLAG._value
    with _lock:
        _collectors.append(coll)
    _AUDIT_FLAG.value = True
    try:
        with trace_mod.span("audit",
                            root=f"{type(root).__name__}#{root._id}"):
            result = base.evaluate(root, donate=donate)
    finally:
        _AUDIT_FLAG.value = prev
        with _lock:
            _collectors.remove(coll)
    if coll.guards:
        raise ValueError(coll.guards[0]["message"])
    label = f"{type(root).__name__}#{root._id}"
    report = AuditReport(coll.records, result, label)
    if report.first_bad is not None and report.first_bad["kind"] == "leaf":
        report.tile_stats = _leaf_tile_stats(root, report.first_bad["node"])
    return report


# -- watchpoints ---------------------------------------------------------


def _as_array(x: Any) -> Any:
    """Coerce a DistArray-or-evaluated-Expr to its DistArray."""
    from ..array.distarray import DistArray

    if isinstance(x, DistArray):
        return x
    value = getattr(x, "value", None)  # ValExpr
    if isinstance(value, DistArray):
        return value
    result = getattr(x, "_result", None)  # any evaluated Expr
    if isinstance(result, DistArray):
        return result
    if hasattr(x, "evaluate"):
        return x.evaluate()
    raise TypeError(f"expected a DistArray or an (evaluated) Expr, got "
                    f"{type(x).__name__}")


def array_health(arr: Any) -> Dict[str, Any]:
    """One-shot health word of a DistArray (a few reductions on its
    device and one read back). On a group mesh every rank takes part."""
    arr = _as_array(arr)
    if arr.size == 0:
        return {"nan_count": 0, "inf_count": 0, "any_nan": False,
                "any_inf": False, "absmax": 0.0, "zero_frac": 0.0,
                "size": 0}
    if arr.mesh.is_group:
        w = _health_word(arr.local, 1.0 if arr.is_first_copy else 0.0)
        if w is None:  # an empty block
            w = torch.tensor([0.0, 0.0, float("-inf"), 0.0, 0.0],
                             dtype=torch.float64, device=arr.mesh.device)
        w = _fold_words(w[None], arr.mesh)[0]
    else:
        w = _health_word(arr.local)
    return _word_to_fields(w.cpu().numpy())


def _index_str(ext: Any, tiles: Sequence[int]) -> str:
    """A tile's index as the JAX package prints a shard's: a tuple of
    slices, ``slice(None, None, None)`` along an axis not split."""
    return str(tuple(slice(lo, hi, None) if t > 1 else slice(None)
                     for lo, hi, t in zip(ext.ul, ext.lr, tiles)))


def tile_stats(arr: Any) -> List[Dict[str, Any]]:
    """Per-tile (per logical shard, row-major over the mesh positions —
    the JAX package's device order) health stats. Each real block's
    counts and absmax are reduced on its device (``_health_word``) and
    read back together, one small copy for the array; a complex block is
    reduced on the host (numpy's magnitude). On a group mesh the rank
    reports the block it holds."""
    from ..parallel import redistribute as redist_mod

    arr = _as_array(arr)
    mesh = arr.mesh
    if mesh.is_group:
        blocks = [(f"{mesh.device}/rank{mesh.rank}", arr.block_extent(),
                   arr.local)]
    else:
        whole = arr.local
        blocks = []
        for i, c in enumerate(redist_mod._coords(mesh)):
            ext = arr.tiling.block_extent(arr.shape, mesh, coords=c)
            sl = tuple(slice(lo, hi) for lo, hi in zip(ext.ul, ext.lr))
            blocks.append((f"{mesh.device}/shard{i}", ext, whole[sl]))
    tiles = arr.tiling.tiles_per_dim(mesh)
    words = [None if t.is_complex() else _health_word(t.detach())
             for _dev, _ext, t in blocks]
    dev_words = [w for w in words if w is not None]
    host = (iter(torch.stack(dev_words).cpu().numpy()) if dev_words
            else iter(()))
    out: List[Dict[str, Any]] = []
    for (dev, ext, t), w in zip(blocks, words):
        rec: Dict[str, Any] = {"device": dev,
                               "index": _index_str(ext, tiles)}
        if t.numel() == 0:
            rec.update(nan_count=0, inf_count=0, absmax=0.0, zero_frac=0.0,
                       size=0, nbytes=0, nnz=0)
            out.append(rec)
            continue
        if w is not None:
            nan, inf, absmax, zeros, _size = next(host)
        else:
            d = t.detach().cpu().numpy()
            nan, inf = np.isnan(d).sum(), np.isinf(d).sum()
            absmax, zeros = np.max(np.abs(d)), np.count_nonzero(d == 0)
        size = int(t.numel())
        # numpy's mean of the zero mask: the exact count over the size
        zero_frac = float(zeros) / size
        rec.update(nan_count=int(nan), inf_count=int(inf),
                   absmax=float(absmax), zero_frac=zero_frac, size=size,
                   nbytes=int(t.numel() * t.element_size()),
                   nnz=int(round(size * (1.0 - zero_frac))))
        out.append(rec)
    return out


class Watchpoint:
    """Persistent data-health watchpoint over a DistArray.

    Every :meth:`check` (manual, via :meth:`update` rebinding in an
    iterative driver, or automatic after each ``evaluate()``) appends
    one health record to ``series``, feeds the metrics registry and emits
    a ``health`` trace span; ``fired`` latches True the first time the
    array goes non-finite."""

    __slots__ = ("label", "site", "series", "fired", "_arr")

    def __init__(self, arr: Any, label: Optional[str] = None):
        self.label = label or f"watch#{next(_watch_ids)}"
        self.site = _site_str(_user_site())
        self.series: List[Dict[str, Any]] = []
        self.fired = False
        self._arr = _as_array(arr)

    @property
    def array(self) -> Any:
        return self._arr

    def check(self) -> Optional[Dict[str, Any]]:
        global _last_health

        arr = self._arr
        if arr is None or arr.is_donated:
            return None
        rec = array_health(arr)
        rec.update(topo=-1, node=self.label, op="watch", site=self.site,
                   digest=None, kind="watch", shape=list(arr.shape),
                   dtype=str(arr.dtype))
        bad = rec["any_nan"] or rec["any_inf"]
        with _lock:
            _last_health = rec
        self.series.append(rec)
        _feed_metrics(rec)
        if bad and not self.fired:
            self.fired = True
            if _METRICS_FLAG._value:
                REGISTRY.counter("numerics_watchpoints_fired",
                                 "watchpoints that observed a non-finite "
                                 "value").inc()
        trace_mod.instant("health", error=bad, node=self.label, op="watch",
                          site=self.site, kind="watch",
                          nan=rec["nan_count"], inf=rec["inf_count"],
                          absmax=rec["absmax"], zero_frac=rec["zero_frac"])
        return rec

    def update(self, arr: Any) -> Optional[Dict[str, Any]]:
        """Rebind to a new array (iterative-driver re-feed) + check."""
        self._arr = _as_array(arr)
        return self.check()

    def tile_stats(self) -> List[Dict[str, Any]]:
        return tile_stats(self._arr)

    def close(self) -> None:
        unwatch(self)

    def __repr__(self) -> str:
        return (f"Watchpoint({self.label!r}, checks={len(self.series)}, "
                f"fired={self.fired})")


def watch(arr: Any, label: Optional[str] = None) -> Watchpoint:
    """Install a persistent watchpoint on a DistArray (``st.watch``):
    checked now, after every later ``evaluate()``, and on demand via
    ``.check()`` / ``.update(new_arr)``."""
    wp = Watchpoint(arr, label)
    with _lock:
        _WATCHPOINTS.append(wp)
    wp.check()
    return wp


def unwatch(wp: Watchpoint) -> None:
    with _lock:
        if wp in _WATCHPOINTS:
            _WATCHPOINTS.remove(wp)


def watchpoints() -> List[Watchpoint]:
    with _lock:
        return list(_WATCHPOINTS)


def poll_watchpoints() -> None:
    """Re-check every installed watchpoint (the evaluate() epilogue calls
    this when any exist)."""
    for wp in watchpoints():
        try:
            wp.check()
        except Exception:
            pass  # a dead/donated watched array must not fail evaluate


# -- dispatch watchdog + crash dumps -------------------------------------


class _NullWatchdog:
    __slots__ = ()

    def __enter__(self) -> "_NullWatchdog":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


_NULL_WD = _NullWatchdog()


class _Watchdog:
    """Arms a daemon timer around one dispatch phase; if the phase is
    still running when the timer fires, dumps a crash report with the
    in-flight span tree. Cancelled (cheaply) on normal completion."""

    __slots__ = ("label", "report", "timeout", "timer", "fired")

    def __init__(self, label: str, report: Optional[Dict[str, Any]],
                 timeout: float):
        self.label = label
        self.report = report
        self.timeout = timeout
        self.timer: Optional[threading.Timer] = None
        self.fired = False

    def __enter__(self) -> "_Watchdog":
        self.timer = threading.Timer(self.timeout, self._fire)
        self.timer.daemon = True
        self.timer.start()
        return self

    def _fire(self) -> None:
        self.fired = True
        try:
            path = dump_crash(
                reason=(f"dispatch watchdog: phase {self.label!r} "
                        f"exceeded FLAGS.dispatch_timeout_s="
                        f"{self.timeout}s"),
                plan_report=self.report)
            from ..utils.log import log_warn

            log_warn("numerics watchdog fired (%s phase > %.3fs); "
                     "crash dump at %s", self.label, self.timeout, path)
        except Exception:
            pass  # the watchdog must never take the process down

    def __exit__(self, *exc: Any) -> None:
        if self.timer is not None:
            self.timer.cancel()


class deadline_scope:
    """Thread-local watchdog tightening for one request: inside the
    scope, :func:`watchdog` arms at ``min(FLAGS.dispatch_timeout_s,
    seconds)``. ``seconds=None`` is a no-op scope."""

    __slots__ = ("seconds", "_prev")

    def __init__(self, seconds: Optional[float]):
        self.seconds = seconds
        self._prev: Optional[float] = None

    def __enter__(self) -> "deadline_scope":
        if self.seconds is not None:
            self._prev = getattr(_tls, "deadline_s", None)
            _tls.deadline_s = max(1e-3, float(self.seconds))
        return self

    def __exit__(self, *exc: Any) -> None:
        if self.seconds is not None:
            _tls.deadline_s = self._prev


def watchdog(label: str, report: Optional[Dict[str, Any]] = None) -> Any:
    """Watchdog context for one dispatch phase; a shared no-op when
    ``FLAGS.dispatch_timeout_s`` <= 0 and no :class:`deadline_scope` is
    active (one float read + one thread-local getattr)."""
    t = _TIMEOUT_FLAG._value
    d = getattr(_tls, "deadline_s", None)
    if d is not None:
        t = min(t, d) if t and t > 0 else d
    if not t or t <= 0:
        return _NULL_WD
    return _Watchdog(label, report, float(t))


def _default_crash_path() -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"spartan_tpu_torch_crash_{os.getpid()}.json")


def dump_crash(path: Optional[str] = None, reason: str = "",
               plan_report: Optional[Dict[str, Any]] = None,
               chrome_trace: bool = False,
               extra: Optional[Dict[str, Any]] = None) -> str:
    """Write a JSON crash report: in-flight span tree, recent completed
    spans, last health word, loop-health tails, watchpoint states, the
    cost ledger, a metrics snapshot, and (optionally) the full Chrome
    trace document. Returns the path written. The flight recorder's
    last 128 events ride along (``flightrec``: which requests were in
    flight); the JAX package's ``monitor`` section is None until the
    monitor is ported."""
    from .metrics import snapshot as metrics_snapshot

    path = path or _CRASH_FLAG._value or _default_crash_path()
    recent = []
    for sp in trace_mod.events()[-128:]:
        e = {"name": sp.name, "ts_us": round(sp.ts, 1),
             "dur_us": round(sp.dur, 1), "tid": sp.tid, "depth": sp.depth}
        if sp.error:
            e["error"] = True
        if sp.args:
            e["args"] = dict(sp.args)
        recent.append(e)
    plan = dict(plan_report) if plan_report is not None else None
    with _lock:
        loops = {k: v[-32:] for k, v in _loop_series.items()}
        wps = [{"label": w.label, "fired": w.fired, "checks": len(w.series),
                "last": (w.series[-1] if w.series else None)}
               for w in _WATCHPOINTS]
    from . import ledger as ledger_mod

    from . import flight as flight_mod

    try:
        flightrec: Optional[Dict[str, Any]] = flight_mod.snapshot(
            limit=128)
    except Exception:  # noqa: BLE001 - forensics are best-effort
        flightrec = None
    try:
        ledger: Optional[Dict[str, Any]] = ledger_mod.snapshot()
    except Exception:  # noqa: BLE001 - forensics are best-effort
        ledger = None
    doc: Dict[str, Any] = {
        "reason": reason,
        "pid": os.getpid(),
        "flightrec": flightrec,
        "ledger": ledger,
        "monitor": None,
        # the non-default FLAGS in force when the process died
        "flags_nondefault": {f.name: f.value for f in FLAGS._flags.values()
                             if f.value != f.default},
        "inflight_spans": trace_mod.inflight(),
        "recent_spans": recent,
        "last_health": last_health(),
        "loop_health": loops,
        "watchpoints": wps,
        "plan": plan,
        "metrics": metrics_snapshot(),
    }
    if chrome_trace:
        doc["chrome_trace"] = trace_mod.export()
    if extra:
        doc.update(extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, default=str)
    return path
