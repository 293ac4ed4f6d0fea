"""Shard-level skew observatory: straggler and load-imbalance
attribution (port of ``spartan_tpu/obs/skew.py``).

Every SPMD step runs at the speed of its slowest shard: each collective
is a barrier, so one hot tile taxes the whole mesh. This module closes
the per-POSITION gap under the per-node views of the rest of ``obs``:

* **Time skew** — ``obs/profile`` gives each profiled node
  ``device_seconds`` per position: on a logical mesh of more than one
  position, the per-block replay (the hottest nodes and the root
  re-run on each position's block of the leaves; every position shares
  the one card, so this is the work each block carries, timed alone); on
  a one-position mesh one entry for the card; on a group mesh each
  rank's seconds, folded across the ranks with one gather.
  :func:`time_skew` folds those into per-node imbalance ratios
  (max/mean over positions) and a collective **wait decomposition**: a
  position's time at the barrier is ``max(shard) - shard``, attributed
  to the node's collective edges through the plan auditor's
  collective->node table.
* **Data skew** — :func:`per_shard_stats` (the port's block walk,
  ``obs/numerics.tile_stats``, which ``DistArray.tile_health`` runs)
  feeds per-block occupancy/byte/nnz stats; :func:`data_skew`
  summarizes max/mean ratios per array. Sampled on the
  ``FLAGS.profile_sample_every`` cadence, off the result path.
* **Surfaces** — ``st.skew(expr)`` returns a :class:`SkewReport`; the
  summary lands on the plan report so ``st.explain`` renders a "shard
  skew" section; ``skew_imbalance_ratio{plan=...}`` /
  ``skew_straggler_wait_s{plan=...}`` labeled gauges; ledger skew
  columns (``obs/ledger.note_skew``); :func:`current` and
  :func:`worst_current`, the inputs of the JAX package's monitor
  detector and status line (the port's monitor is not written yet); and
  an **advisory** re-tiling suggestion — when a node's imbalance ratio
  exceeds ``FLAGS.skew_warn_ratio`` the report prices an alternative
  tiling for the heaviest leaf through the redistribution planner.
  Report-only: nothing here mutates a plan.

Import discipline: sits in ``obs`` next to ``profile`` (which reaches
back only lazily inside ``maybe_sample``); expr/array/parallel/analysis
types load lazily inside functions.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.config import FLAGS
from . import ledger as ledger_mod
from . import profile as profile_mod
from . import trace as trace_mod
from .metrics import METRICS_FLAG as _METRICS_FLAG
from .metrics import REGISTRY, labeled

_WARN_FLAG = FLAGS.define_float(
    "skew_warn_ratio", 1.5,
    "Shard-imbalance ratio (hottest shard's device seconds over the "
    "mesh mean, per node) above which the skew observatory warns: "
    "st.skew prints the advisory re-tiling suggestion "
    "(obs/skew.py). Report-only — no plan is ever mutated.")

# leaves sampled per data-skew pass: each copies its blocks to the host,
# so the walk is bounded (the report notes what was dropped)
_DATA_LEAF_CAP = 8
_LAST_MAX = 32

_lock = threading.Lock()
_tls = threading.local()
# plan digest -> latest skew summary (bounded; current() and
# worst_current() read from here)
_last_by_plan: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()


# -- the per-block walk -------------------------------------------------


def per_shard_stats(arr: Any) -> List[Dict[str, Any]]:
    """Per-block stats of one array (``obs/numerics.tile_stats``: each
    logical position's block, row-major over the mesh, or the rank's own
    block on a group mesh), with the data-skew columns ``nbytes`` and
    ``nnz``."""
    from .numerics import tile_stats

    return tile_stats(arr)


def data_skew(arr: Any, label: Optional[str] = None) -> Dict[str, Any]:
    """One array's tile-load summary: per-shard size/byte/nnz spread
    as max/mean ratios, naming the heaviest block's position. Ratio
    1.0 = perfectly balanced; a row-tiled array with one oversized or
    one dense-among-zeros block shows up here."""
    stats = per_shard_stats(arr)

    def ratio(key: str) -> Tuple[Optional[float], Optional[str]]:
        vals = [(s[key], s["device"]) for s in stats]
        if not vals:
            return None, None
        mean = sum(v for v, _ in vals) / len(vals)
        mx, dev = max(vals, key=lambda p: p[0])
        if mean <= 0:
            return (1.0 if mx <= 0 else float("inf")), dev
        return mx / mean, dev

    size_r, _ = ratio("size")
    bytes_r, bdev = ratio("nbytes")
    nnz_r, ndev = ratio("nnz")
    hottest = ndev if (nnz_r or 0) >= (bytes_r or 0) else bdev
    value = getattr(arr, "value", None)
    tiling = getattr(value if value is not None else arr, "tiling", None)
    return {
        "leaf": label,
        "shape": list(getattr(arr, "shape", ())),
        "tiling": str(tiling) if tiling is not None else None,
        "shards": len(stats),
        "size_ratio": round(size_r, 4) if size_r is not None else None,
        "bytes_ratio": round(bytes_r, 4) if bytes_r is not None else None,
        "nnz_ratio": round(nnz_r, 4) if nnz_r is not None else None,
        "hottest": hottest,
        "bytes_total": sum(s["nbytes"] for s in stats),
    }


# -- time skew ------------------------------------------------------------


def _node_skew(device_seconds: Dict[str, float]
               ) -> Optional[Dict[str, float]]:
    """One node's imbalance numbers from its per-device seconds:
    ``ratio`` = max/mean, ``wait_s`` = sum over shards of
    (max - shard) — the total time the mesh spent parked at this
    node's barrier while its slowest shard finished."""
    vals = [v for v in device_seconds.values() if v >= 0]
    if len(vals) < 2:
        return None
    mx = max(vals)
    mean = sum(vals) / len(vals)
    if mean <= 0:
        return None
    return {"ratio": mx / mean, "wait_s": sum(mx - v for v in vals),
            "max_s": mx, "mean_s": mean}


def time_skew(prof: Any, audit: Any = None,
              scope_digests: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
    """Fold a :class:`~spartan_tpu_torch.obs.profile.DeviceProfile`
    whose nodes carry ``device_seconds`` into the per-node imbalance
    view: position totals, the hottest shard, per-node max/mean ratios
    with the barrier-wait decomposition, and — when a plan audit is
    given — the top straggler EDGES (the audit's collective->node rows
    joined to the waits through the plan's scope-digest table)."""
    totals: Dict[str, float] = {}
    nodes: List[Dict[str, Any]] = []
    for n in prof.nodes:
        dev = n.get("device_seconds")
        if not dev:
            continue
        for d, s in dev.items():
            totals[d] = totals.get(d, 0.0) + float(s)
        sk = _node_skew(dev)
        if sk is None:
            continue
        nodes.append({
            "node": n["node"], "digest": n.get("digest"),
            "op_class": n.get("op_class"),
            "ratio": round(sk["ratio"], 4),
            "wait_s": round(sk["wait_s"], 9),
            "max_s": round(sk["max_s"], 9),
            "mean_s": round(sk["mean_s"], 9),
            "devices": len(dev),
            "straggler": max(dev, key=dev.get),
        })
    nodes.sort(key=lambda r: -r["wait_s"])
    hottest = None
    if totals:
        d = max(totals, key=totals.get)
        hottest = {"device": d, "seconds": round(totals[d], 9)}

    edges: List[Dict[str, Any]] = []
    if audit is not None and nodes and scope_digests:
        # audit rows name nodes by the PLAN dag's labels; the profile's
        # attribution dag re-optimizes (fresh node ids), so the join
        # runs label -> digest -> profile node
        label_to_digest = {rec.get("node"): dg
                           for dg, rec in scope_digests.items()}
        by_digest = {r["digest"]: r for r in nodes if r.get("digest")}
        for row in audit.per_node():
            dg = label_to_digest.get(row["node"])
            hit = by_digest.get(dg) if dg else None
            if hit is None:
                continue
            edges.append({
                "node": row["node"],
                "kinds": dict(row["kinds"]),
                "bytes_moved": row["bytes_moved"],
                "ratio": hit["ratio"],
                "wait_s": hit["wait_s"],
                "straggler": hit["straggler"],
            })
        edges.sort(key=lambda r: -r["wait_s"])

    return {
        "device_totals": {d: round(s, 9) for d, s in totals.items()},
        "hottest_shard": hottest,
        "imbalance_ratio": (round(max(r["ratio"] for r in nodes), 4)
                            if nodes else None),
        "straggler_wait_s": (round(sum(r["wait_s"] for r in nodes), 9)
                             if nodes else None),
        "nodes": nodes,
        "straggler_edges": edges,
    }


# -- the advisory re-tiling suggestion (report-only) ----------------------


def _advisory(arr: Any, mesh: Any, ratio: float) -> Optional[Dict[str, Any]]:
    """Price an alternative tiling for the heaviest leaf through the
    redistribution planner: the candidate layouts' modeled move cost,
    cheapest first. ADVISORY ONLY — printed in the report so an
    operator (or a later closed-loop change) can act; no plan
    mutation."""
    try:
        from ..array import tiling as tiling_mod
        from ..parallel import redistribute

        value = getattr(arr, "value", None)
        da = value if value is not None else arr
        src = getattr(da, "tiling", None)
        shape = tuple(int(s) for s in da.shape)
        if src is None or not shape:
            return None
        nbytes = int(np.prod(shape)) * int(np.dtype(da.dtype).itemsize)

        def flat_row(ndim: int) -> Any:
            return tiling_mod.Tiling(
                ((tiling_mod.AXIS_ROW, tiling_mod.AXIS_COL),)
                + (None,) * (ndim - 1))

        best = None
        for maker in (tiling_mod.block, flat_row, tiling_mod.row,
                      tiling_mod.col):
            dst = tiling_mod.sanitize(maker(len(shape)), shape, mesh)
            if dst.axes == src.axes or not dst.sharded_axes():
                continue
            cost = redistribute.edge_cost(src, dst, float(nbytes), mesh)
            if best is None or cost < best["modeled_cost"]:
                scheds = redistribute.schedules(src, dst, mesh)
                via = (min(scheds, key=lambda s: s.cost(nbytes))
                       .describe() if scheds else "generic relayout")
                best = {"src": str(src), "dst": str(dst),
                        "bytes": nbytes,
                        "modeled_cost": round(float(cost), 3),
                        "schedule": via}
        if best is not None:
            best["trigger_ratio"] = round(float(ratio), 4)
        return best
    except Exception:  # noqa: BLE001 - the advisory is best-effort
        return None


# -- the report object ----------------------------------------------------


class SkewReport:
    """Structured shard-skew report with a pretty ``str()``.

    ``.data`` is the raw dict; the headline fields are attributes:
    ``plan``, ``tier``, ``imbalance_ratio`` (worst node's max/mean
    device seconds), ``straggler_wait_s`` (total barrier wait),
    ``hottest_shard``, ``nodes``, ``straggler_edges``, ``data``
    (per-leaf tile-load spread) and ``advisory`` (the priced
    re-tiling suggestion, present only past FLAGS.skew_warn_ratio)."""

    def __init__(self, data: Dict[str, Any]):
        self.data = data

    def __getattr__(self, name: str) -> Any:
        try:
            return self.__dict__["data"][name]
        except KeyError:
            raise AttributeError(name)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.data)

    def to_report(self) -> Dict[str, Any]:
        """The compact form stored on ``plan.report['skew']`` (what
        ``st.explain`` renders): top nodes/edges only."""
        d = dict(self.data)
        d["nodes"] = list(d.get("nodes") or [])[:8]
        d["straggler_edges"] = list(d.get("straggler_edges") or [])[:5]
        return d

    def __str__(self) -> str:
        d = self.data
        warn = d.get("warn_ratio")
        lines = [f"shard skew [{d.get('tier')}] plan {d.get('plan')}: "
                 f"imbalance max/mean "
                 f"{d.get('imbalance_ratio') or 'n/a'}"
                 + (f" (warn at {warn}x)" if warn else "")]
        hs = d.get("hottest_shard")
        if hs:
            lines.append(f"  hottest shard {hs['device']} "
                         f"({hs['seconds'] * 1e3:.3f}ms attributed)")
        for r in (d.get("nodes") or [])[:5]:
            lines.append(
                f"  {r['node']:<24} ratio {r['ratio']:<7} wait "
                f"{r['wait_s'] * 1e3:8.3f}ms across {r['devices']} "
                f"shard(s)  straggler {r['straggler']}")
        edges = d.get("straggler_edges") or []
        if edges:
            lines.append("  straggler edges (barrier wait at "
                         "collectives):")
            for e in edges[:5]:
                kinds = ", ".join(f"{k}x{n}" if n > 1 else k
                                  for k, n in sorted(e["kinds"].items()))
                lines.append(
                    f"    {e['node']:<22} {kinds:<20} wait "
                    f"{e['wait_s'] * 1e3:8.3f}ms  straggler "
                    f"{e['straggler']}")
        for rec in d.get("data") or []:
            lines.append(
                f"  data: {rec.get('leaf') or '?':<16} "
                f"{str(rec.get('tiling')):<14} "
                f"nnz ratio {rec.get('nnz_ratio')} bytes ratio "
                f"{rec.get('bytes_ratio')} hottest {rec.get('hottest')}")
        if d.get("data_leaves_skipped"):
            lines.append(f"  ({d['data_leaves_skipped']} leaf(s) past "
                         "the data-skew cap not walked)")
        adv = d.get("advisory")
        if adv:
            lines.append(
                f"  ADVISORY (ratio {adv['trigger_ratio']} > warn "
                f"{warn}): re-tile {adv['src']} -> {adv['dst']} "
                f"~cost {adv['modeled_cost']} via {adv['schedule']} "
                "(report-only; no plan changed)")
        return "\n".join(lines)

    __repr__ = __str__


# -- recording (metrics / ledger / monitor state) -------------------------


def _record(digest: Optional[str], summary: Dict[str, Any]) -> None:
    """Fold one skew measurement into the surfaces that outlive it:
    the bounded per-plan state (monitor detector + status line), the
    labeled gauges, and the ledger's skew columns."""
    if digest is None:
        return
    with _lock:
        _last_by_plan[digest] = summary
        _last_by_plan.move_to_end(digest)
        while len(_last_by_plan) > _LAST_MAX:
            _last_by_plan.popitem(last=False)
    ratio = summary.get("imbalance_ratio")
    wait = summary.get("straggler_wait_s")
    ledger_mod.note_skew(digest, ratio, wait)
    if _METRICS_FLAG._value and ratio is not None:
        REGISTRY.gauge(
            labeled("skew_imbalance_ratio", plan=digest),
            "worst per-node shard-imbalance ratio (hottest shard's "
            "device seconds over the mesh mean) of the last skew "
            "measurement, per plan").set(float(ratio))
        REGISTRY.gauge(
            labeled("skew_straggler_wait_s", plan=digest),
            "total barrier wait (sum over shards of max-shard minus "
            "shard) of the last skew measurement, per plan").set(
                float(wait or 0.0))


def current() -> Dict[str, Dict[str, Any]]:
    """Latest skew summary per plan digest (the monitor's detector
    input; bounded to the most recent _LAST_MAX plans)."""
    with _lock:
        return {k: dict(v) for k, v in _last_by_plan.items()}


def worst_current() -> Optional[Dict[str, Any]]:
    """The one-line operator view: the plan with the worst imbalance
    ratio right now — {plan, ratio, wait_s, node} — or None when
    nothing has been measured."""
    worst = None
    with _lock:
        for digest, rec in _last_by_plan.items():
            r = rec.get("imbalance_ratio")
            if r is None:
                continue
            if worst is None or r > worst["ratio"]:
                worst = {"plan": digest, "ratio": r,
                         "wait_s": rec.get("straggler_wait_s"),
                         "node": rec.get("node")}
    return worst


def _summary_of(report_dict: Dict[str, Any]) -> Dict[str, Any]:
    nodes = report_dict.get("nodes") or []
    return {
        "t": trace_mod.now(),
        "imbalance_ratio": report_dict.get("imbalance_ratio"),
        "straggler_wait_s": report_dict.get("straggler_wait_s"),
        "node": nodes[0]["node"] if nodes else None,
        "hottest_shard": (report_dict.get("hottest_shard") or {}
                          ).get("device"),
        "data_worst_ratio": max(
            (rec.get("nnz_ratio") or 0.0
             for rec in report_dict.get("data") or ()), default=None),
    }


# -- sampled continuous skew (rides the profile sampler) ------------------


def _leaf_arrays(leaves: Any) -> List[Tuple[str, Any]]:
    """The DistArrays behind a plan's raw leaves: ValExprs carry
    ``.value``, other forced leaves (e.g. an evaluated RandomExpr)
    hold theirs in ``._result``."""
    from ..array.distarray import DistArray

    out = []
    for i, leaf in enumerate(leaves or ()):
        value = getattr(leaf, "value", None)
        if value is None:
            value = getattr(leaf, "_result", leaf)
        if isinstance(value, DistArray):
            out.append((f"{type(leaf).__name__}#{getattr(leaf, '_id', i)}",
                        value))
    return out


def note_sampled(prof: Any, plan: Any, leaves: Any) -> None:
    """``obs/profile.maybe_sample``'s hook, after a sampled dispatch
    was profiled: fold the per-device timeline + a bounded data-skew
    walk over the dispatch's DistArray leaves into the skew state,
    off the result path. Stamps ``_tls.last_sample`` for the serve
    worker's flight-record ``skew`` event."""
    report = plan.report if plan is not None else None
    digest = report.get("plan_key") if report else None
    if digest is None:
        return
    tsk = time_skew(prof)
    arrs = _leaf_arrays(leaves)
    data = [data_skew(a, label) for label, a in arrs[:_DATA_LEAF_CAP]]
    d = dict(tsk)
    d.update(plan=digest, tier=prof.tier,
             warn_ratio=float(_WARN_FLAG._value), data=data,
             data_leaves_skipped=max(0, len(arrs) - _DATA_LEAF_CAP))
    if report is not None:
        d["advisory"] = None
        report["skew"] = SkewReport(d).to_report()
    summary = _summary_of(d)
    _record(digest, summary)
    _tls.last_sample = {
        "plan": digest,
        "imbalance_ratio": summary.get("imbalance_ratio"),
        "straggler_wait_s": summary.get("straggler_wait_s"),
        "hottest_shard": summary.get("hottest_shard"),
        "data_worst_ratio": summary.get("data_worst_ratio"),
    }


def take_last_sample() -> Optional[Dict[str, Any]]:
    """Pop this thread's last sampled-skew stamp (the serve worker
    folds it into the request's flight record as a 'skew' event)."""
    s = getattr(_tls, "last_sample", None)
    if s is not None:
        _tls.last_sample = None
    return s


# -- the public API (st.skew) ---------------------------------------------


def skew(expr: Any, tier: Optional[str] = None,
         reps: Optional[int] = None) -> SkewReport:
    """Per-position skew report for ``expr`` (see module docstring):
    runs one profiled walk (``obs/profile``, with per-position seconds),
    audits the plan's collectives for the straggler-edge join, walks the
    leaves' blocks for data skew, and prices the advisory re-tiling when
    the imbalance ratio exceeds ``FLAGS.skew_warn_ratio``."""
    from ..analysis import plan_audit
    from ..expr import base
    from ..parallel import mesh as mesh_mod

    root = expr if isinstance(expr, base.Expr) else base.as_expr(expr)
    if type(root).__name__ == "DictExpr":
        root = root._tuple
    if root._result is not None and not isinstance(root, base.ValExpr):
        root.invalidate()
    mesh = mesh_mod.get_mesh()
    with trace_mod.span("skew", root=f"{type(root).__name__}"
                                     f"#{root._id}"):
        # audit first: it builds AND caches the plan under both
        # signature keys (pre/post tiling stamp), so the profile call
        # below hits the same plan object the report lands on
        try:
            audit = plan_audit.audit_plan(root, mesh=mesh)
        except Exception:  # noqa: BLE001 - the edge join is advisory
            audit = None
        prof = profile_mod.profile(root, tier=tier, reps=reps)
        plan_key, rctx = base.plan_signature(root, mesh)
        plan = base.lookup_plan(plan_key)
        report = plan.report if plan is not None else None
        digest = (report.get("plan_key") if report else None) \
            or prof.plan_digest
        tsk = time_skew(prof, audit,
                        (report or {}).get("scope_digests"))
        arrs = _leaf_arrays(rctx.leaves)
        data = [data_skew(a, label)
                for label, a in arrs[:_DATA_LEAF_CAP]]
        d = dict(tsk)
        warn = float(_WARN_FLAG._value)
        d.update(plan=digest, tier=prof.tier, warn_ratio=warn,
                 data=data,
                 data_leaves_skipped=max(0, len(arrs) - _DATA_LEAF_CAP))
        d["advisory"] = None
        ratio = d.get("imbalance_ratio")
        if ratio is not None and warn > 0 and ratio > warn and arrs:
            heavy = max(
                zip(arrs, data),
                key=lambda p: (p[1].get("nnz_ratio") or 0.0,
                               p[1].get("bytes_total") or 0))[0][1]
            d["advisory"] = _advisory(heavy, mesh, ratio)
        rep = SkewReport(d)
        if report is not None:
            report["skew"] = rep.to_report()
        _record(digest, _summary_of(d))
    return rep


def reset() -> None:
    """Drop the per-plan skew state (test isolation)."""
    with _lock:
        _last_by_plan.clear()
    _tls.last_sample = None
