"""Device-time attribution profiler: per-expr-node device seconds (port of
``spartan_tpu/obs/profile.py``).

``st.profile(expr)`` runs one profiled walk of the expression's plan and
returns a per-expr-node DEVICE-time report keyed by each node's
structural-signature digest (the ``_sig`` digest the numerics sentinel
tags health words with, and the join key of the profiler ranges — see
:func:`scope_name`). Two attribution tiers behind one API:

* **capture** — the port's counterpart of the JAX package's ``xplane``
  tier. The plan's walk runs ``_CAPTURE_WALKS`` times under one
  ``torch.profiler`` capture with CUDA activity, and the first walk
  whose every launch of device work has its device record is
  attributed; each node's lowering runs inside
  ``record_function(scope_name(node))`` (``Expr.lower``, only while a
  profiler records). The capture's Chrome trace is parsed: every device
  event (a kernel — the hand-written ones of ``_build/`` like any torch
  op's — a memcpy or a memset) is joined through its CUPTI correlation
  id to the runtime launch that issued it, and the launch to the
  innermost node range that encloses it on the launching thread. Real
  device timings of one walk, nothing re-run. Where XPlane names XLA
  ops by their ``named_scope``, CUPTI names kernels by the launch's
  correlation id: the range is found on the host side of the join.
* **replay** — the portable fallback (and the only tier on the CPU,
  where no device activity is recorded): after one full walk, each
  node's lowering is re-run on its children's held values and timed
  alone, with CUDA events on the card and the host clock on the CPU,
  best of ``reps``; the walk is timed the same way and is the wall. The
  nodes are not forced under it: what they sum past it is
  ``DeviceProfile.excess_s`` (timing noise, or work counted twice).

``tier="auto"`` (the default, ``FLAGS.profile_tier``) tries the capture
and falls back to replay when the runtime records no device activity,
loses the device records of every captured walk, or the capture
attributes less than half the walk; ``tier="capture"`` raises instead
(``"xplane"`` is accepted as its JAX-package name).

On a group mesh each rank profiles its own walk (its blocks, its
collectives); the cross-rank fold of ``device_seconds`` per device waits
for ``obs/skew`` (ROADMAP A6).

**Sampled continuous profiling.** ``FLAGS.profile_sample_every=N``
profiles every Nth warm dispatch of a plan after the real walk, off the
result path: the served result comes from the unprofiled walk
(bit-equal to an unsampled run). Sampled timelines fold per-node device
seconds into the cost ledger's per-op-class DEVICE columns
(``fit_profile`` then calibrates from device time) and land on the plan
report, so ``st.explain`` shows measured device time next to the
modeled cost. The OFF path (N=0, the default) costs one flag read per
dispatch.

``st.profile_export(path)`` merges the host span ring and the last
device timeline into one Perfetto-loadable Chrome trace, on the tracer's
clock: a capture's kernels keep their measured start times, shifted by
the offset between the capture's anchor range on the kineto clock and
the same range's span on the tracer clock; a replay's nodes are laid end
to end from the profile's start (an attribution layout, not a
schedule).

Import discipline: sits in ``obs`` (config/trace/metrics/ledger/explain
above it only); expr-layer types are reached lazily inside functions.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils.config import FLAGS
from . import ledger as ledger_mod
from . import trace as trace_mod
from .explain import key_hash
from .metrics import METRICS_FLAG as _METRICS_FLAG
from .metrics import REGISTRY

# expr/base._run reads ._value directly (one attribute load per walk)
_SAMPLE_FLAG = FLAGS.define_int(
    "profile_sample_every", 0,
    "Sampled continuous profiling: profile every Nth warm dispatch of "
    "each plan (per-plan counters) with the device-time attribution "
    "profiler, folding per-node device seconds into the cost ledger's "
    "device columns and the plan report (st.explain). 0 = off (the "
    "default; one flag read per dispatch). Sampled results are "
    "bit-equal to unsampled: the profile re-walks off the result path.")
_TIER_FLAG = FLAGS.define_str(
    "profile_tier", "auto",
    "Attribution tier for st.profile and the sampler: 'auto' (try the "
    "torch.profiler capture, fall back to replay), 'capture' (capture "
    "only; raises when the runtime records no device activity; "
    "'xplane' is its JAX-package name), 'replay' (re-time each node's "
    "lowering on its held inputs).")
_MAX_NODES_FLAG = FLAGS.define_int(
    "profile_max_nodes", 128,
    "Replay-tier node budget: DAGs with more interior nodes than this "
    "re-time only the last (topological) budget's worth and report the "
    "rest in the unattributed residual (nodes_skipped on the report).")

_SCOPE_MARK = "__sg_"
_SCOPE_RX = re.compile(r"__sg_([0-9a-f]{4,16})")
# the range around each walk of a capture: a walk's launches are those
# inside its range, and its kineto start beside the tracer clock's puts
# the capture on the tracer's time base
_ANCHOR = "st_profile_walk"
_CAPTURE_WALKS = 3
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the runtime and driver calls that put work on the device (a kernel
# launch, a copy, a fill): each has a device record when none is lost;
# the others (cudaFuncSetAttribute, cudaGetLastError, ...) have none
_DEVICE_WORK_RX = re.compile(r"Launch(?!HostFunc)|Memcpy|Memset")

_lock = threading.Lock()
_tls = threading.local()
_sample_counts: Dict[str, int] = {}
# plan digest -> _Attribution (reused across samples of one plan)
_attr_cache: "OrderedDict[str, _Attribution]" = OrderedDict()
_ATTR_CACHE_MAX = 16
# torch.profiler takes one capture at a time; a concurrent sampler
# skips the capture tier instead of racing it
_capture_lock = threading.Lock()
_last_profile: Optional["DeviceProfile"] = None


# -- digest-carrying profiler ranges --------------------------------------


class _NamingCtx:
    """Per-walk digest source: one shared, memoizing signature context;
    a node's digest is the hash of its memoized signature within the
    root traversal (the root's range is entered first, so one
    ``of(root)`` memoizes every descendant)."""

    __slots__ = ("_sig", "_digests")

    def __init__(self, sig_ctx: Any = None):
        if sig_ctx is None:
            from ..expr.base import _SigCtx  # lazy: obs sits below expr

            sig_ctx = _SigCtx()
        self._sig = sig_ctx
        self._digests: Dict[int, str] = {}

    def digest(self, node: Any) -> Optional[str]:
        d = self._digests.get(node._id)
        if d is None:
            try:
                memo = self._sig._memo
                if node._id not in memo:
                    self._sig.of(node)
                d = key_hash(memo[node._id]) or ""
            except Exception:  # noqa: BLE001 - naming is advisory
                d = ""
            self._digests[node._id] = d
        return d or None


class naming_session:
    """Context manager installing a fresh :class:`_NamingCtx` for the
    walking thread (no-op when ``FLAGS.trace_annotations`` is off —
    there are no ranges to name)."""

    __slots__ = ("_prev", "_on")

    def __enter__(self) -> "naming_session":
        self._on = bool(FLAGS.trace_annotations)
        if self._on:
            self._prev = getattr(_tls, "naming", None)
            _tls.naming = _NamingCtx()
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._on:
            _tls.naming = self._prev


class _use_naming:
    """Install an EXISTING naming ctx (a profiled walk names its ranges
    with the attribution's digests)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: _NamingCtx):
        self._ctx = ctx

    def __enter__(self) -> "_use_naming":
        self._prev = getattr(_tls, "naming", None)
        _tls.naming = self._ctx
        return self

    def __exit__(self, *exc: Any) -> None:
        _tls.naming = self._prev


def scope_name(node: Any) -> str:
    """The profiler range label of one expr node — ``TypeName#<id>``
    (the JAX package's ``named_scope`` says ``TypeName_<id>``) plus,
    inside a naming session, the structural ``__sg_<digest>`` join key
    the capture tier matches on. Called by ``Expr.lower`` only while a
    profiler records."""
    base = f"{type(node).__name__}#{node._id}"
    ctx = getattr(_tls, "naming", None)
    if ctx is None:
        return base
    d = ctx.digest(node)
    return f"{base}{_SCOPE_MARK}{d}" if d else base


# -- the report object ----------------------------------------------------


class DeviceProfile:
    """One device-time attribution: per-node seconds keyed by ``_sig``
    digest, plus the whole-walk wall and the unattributed residual.

    ``nodes`` is a list of dicts sorted hottest-first, each carrying
    ``node`` (label), ``digest``, ``op_class``, ``site``, ``shape``,
    ``seconds`` (measured device time), ``share`` (of attributed),
    ``modeled_cost`` (the tiling DP's estimate for the same node) and,
    from the capture tier, ``kernels`` ({device event name: seconds})."""

    def __init__(self, tier: str, plan_digest: Optional[str],
                 wall_s: float, nodes: List[Dict[str, Any]],
                 note: Optional[str] = None, nodes_skipped: int = 0,
                 events: Optional[List[Dict[str, Any]]] = None):
        self.tier = tier
        self.plan_digest = plan_digest
        self.wall_s = float(max(0.0, wall_s))
        self.nodes = sorted(nodes, key=lambda n: -n["seconds"])
        self.note = note
        self.nodes_skipped = int(nodes_skipped)
        # capture tier: the device events on the tracer clock (us)
        self.events = events or []
        self.t0_us = (trace_mod.now() - trace_mod.epoch()) * 1e6

    @property
    def attributed_s(self) -> float:
        return float(sum(n["seconds"] for n in self.nodes))

    @property
    def unattributed_s(self) -> float:
        return max(0.0, self.wall_s - self.attributed_s)

    @property
    def excess_s(self) -> float:
        """How far the attributed seconds pass the wall: 0 for a capture
        (its nodes' kernels lie inside the walk); for a replay, whose
        nodes and walk are timed apart, the timing noise, or work counted
        twice."""
        return max(0.0, self.attributed_s - self.wall_s)

    @property
    def attributed_fraction(self) -> float:
        if self.wall_s <= 0:
            return 0.0
        return min(1.0, self.attributed_s / self.wall_s)

    def top(self, k: int = 5) -> List[Dict[str, Any]]:
        """The k hottest attributed nodes (device seconds, descending)."""
        return self.nodes[:max(0, k)]

    def node(self, label_prefix: str) -> List[Dict[str, Any]]:
        """The attributed nodes whose label starts with ``label_prefix``
        (a class name), in walk order."""
        return sorted((n for n in self.nodes
                       if n["node"].startswith(label_prefix)),
                      key=lambda n: n.get("topo", 0))

    def class_seconds(self) -> Dict[str, float]:
        """Attributed device seconds summed per cost-model op class —
        the vector the ledger's device columns accumulate."""
        out: Dict[str, float] = {}
        for n in self.nodes:
            c = n.get("op_class") or "other"
            out[c] = out.get(c, 0.0) + n["seconds"]
        return {k: round(v, 9) for k, v in out.items()}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "tier": self.tier,
            "plan": self.plan_digest,
            "wall_s": round(self.wall_s, 9),
            "attributed_s": round(self.attributed_s, 9),
            "unattributed_s": round(self.unattributed_s, 9),
            "excess_s": round(self.excess_s, 9),
            "attributed_fraction": round(self.attributed_fraction, 4),
            "class_seconds": self.class_seconds(),
            "nodes": [dict(n) for n in self.nodes],
            "nodes_skipped": self.nodes_skipped,
            "note": self.note,
        }

    # stored on the plan report under "device_profile"
    to_report = to_dict

    def trace_events(self) -> List[Dict[str, Any]]:
        """Chrome trace events for the merged export: one device track
        (tid 1000000). A capture's device events keep their measured
        times on the tracer clock; a replay's nodes are laid end to end
        in walk order from the profile's start, then the residual."""
        pid = os.getpid()
        tid = 1_000_000
        evts: List[Dict[str, Any]] = [{
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": f"device timeline (st.profile, "
                             f"{self.tier} tier)"},
        }]
        if self.events:
            for e in self.events:
                evts.append({"name": e["name"], "ph": "X",
                             "ts": round(e["ts"], 3),
                             "dur": round(e["dur"], 3), "pid": pid,
                             "tid": tid, "args": {"node": e.get("node")}})
            return evts
        cursor = self.t0_us
        for n in sorted(self.nodes, key=lambda d: d.get("topo", 0)):
            dur = n["seconds"] * 1e6
            evts.append({
                "name": f"{n['node']} [{n['digest']}]", "ph": "X",
                "ts": round(cursor, 3), "dur": round(dur, 3),
                "pid": pid, "tid": tid,
                "args": {"op_class": n.get("op_class"),
                         "modeled_cost": n.get("modeled_cost"),
                         "share": n.get("share")},
            })
            cursor += dur
        if self.unattributed_s > 0:
            evts.append({"name": "(unattributed)", "ph": "X",
                         "ts": round(cursor, 3),
                         "dur": round(self.unattributed_s * 1e6, 3),
                         "pid": pid, "tid": tid, "args": {}})
        return evts

    def __str__(self) -> str:
        lines = [
            f"device profile [{self.tier}] plan {self.plan_digest}: "
            f"wall {self.wall_s * 1e3:.3f}ms, attributed "
            f"{self.attributed_fraction * 100:.1f}% "
            f"({len(self.nodes)} node(s), unattributed "
            f"{self.unattributed_s * 1e3:.3f}ms)"]
        if self.note:
            lines.append(f"  note: {self.note}")
        if self.excess_s > 0:
            lines.append(f"  the nodes' times pass the wall by "
                         f"{self.excess_s * 1e3:.3f}ms")
        show = self.nodes if len(self.nodes) <= 8 else self.top(5)
        for n in show:
            modeled = (f" modeled~{n['modeled_cost']}"
                       if n.get("modeled_cost") is not None else "")
            lines.append(
                f"  {n['node']:<24} {n['seconds'] * 1e3:9.3f}ms "
                f"{n['share'] * 100:5.1f}%  [{n.get('op_class')}]"
                f"{modeled}  sig={n['digest']}")
        if len(self.nodes) > len(show):
            lines.append(f"  ... ({len(self.nodes) - len(show)} more; "
                         ".nodes has all)")
        if self.nodes_skipped:
            lines.append(f"  ({self.nodes_skipped} node(s) past "
                         "FLAGS.profile_max_nodes not replayed)")
        return "\n".join(lines)

    __repr__ = __str__


# -- attribution machinery ------------------------------------------------


class _Attribution:
    """The per-plan machinery: the plan's optimized DAG, its leaf ids,
    per-node digests and metadata. Built once per plan digest (bounded
    LRU) and reused across samples; each walk seeds it from the CURRENT
    request's leaves in the given order."""

    __slots__ = ("dag", "leaf_ids", "naming", "nodes", "meta")

    def __init__(self, plan: Any):
        from ..expr import base, tiling_cost
        from ..expr.optimize import dag_nodes

        self.dag = plan.dag
        self.leaf_ids = plan.leaf_ids
        ctx = base._SigCtx()
        ctx.of(self.dag)
        self.naming = _NamingCtx(ctx)
        self.nodes: List[Any] = []
        self.meta: Dict[int, Dict[str, Any]] = {}
        for topo, n in enumerate(dag_nodes(self.dag)):
            if isinstance(n, (base.ValExpr, base.ScalarExpr)) \
                    or n._id in self.leaf_ids:
                continue
            cost = getattr(n, "_plan_cost", None)
            site = n._site
            self.nodes.append(n)
            self.meta[n._id] = {
                "node": f"{type(n).__name__}#{n._id}",
                "digest": self.naming.digest(n),
                "op_class": tiling_cost.op_class(n),
                "site": f"{site[0]}:{site[1]}" if site else None,
                "shape": list(n.shape),
                "topo": topo,
                "modeled_cost": (round(float(cost), 3)
                                 if cost is not None else None),
            }

    def env(self, leaves: List[Any], order: Tuple[int, ...],
            mesh: Any) -> Dict[int, Any]:
        """A fresh walk env seeded with the request's leaves."""
        from ..expr import base

        if mesh.is_group:
            return base.GroupEnv(mesh, (
                (lid, base._leaf_local(leaves[i], mesh))
                for lid, i in zip(self.leaf_ids, order)))
        return {lid: base._leaf_arg(leaves[i])
                for lid, i in zip(self.leaf_ids, order)}

    def run(self, env: Dict[int, Any]) -> Dict[int, Any]:
        """One walk of the plan over a seeded env (values discarded by
        the caller); returns the filled env."""
        with _use_naming(self.naming):
            if type(env) is not dict:  # a GroupEnv
                self.dag.lower_local(env)
            else:
                self.dag.lower(env)
        return env

    def walk(self, leaves: List[Any], order: Tuple[int, ...],
             mesh: Any) -> Dict[int, Any]:
        """One walk of the plan seeded with the request's leaves."""
        return self.run(self.env(leaves, order, mesh))


def _attribution_for(digest: Optional[str], plan: Any) -> _Attribution:
    if digest is not None:
        with _lock:
            hit = _attr_cache.get(digest)
            if hit is not None and hit.dag is plan.dag:
                _attr_cache.move_to_end(digest)
                return hit
    attr = _Attribution(plan)
    if digest is not None:
        with _lock:
            _attr_cache[digest] = attr
            _attr_cache.move_to_end(digest)
            while len(_attr_cache) > _ATTR_CACHE_MAX:
                _attr_cache.popitem(last=False)
    return attr


def _on_card(mesh: Any) -> bool:
    return mesh.device.type == "cuda"


def _time_call(fn: Any, setup: Any, reps: int, cuda: bool) -> float:
    """Best-of-``reps`` seconds of one warm call of ``fn(setup())``, the
    setup (a fresh walk env) outside the timed region: CUDA events around
    the call on the card (device time between the two events), the host
    clock on the CPU."""
    fn(setup())  # warm
    best = float("inf")
    for _ in range(max(1, reps)):
        arg = setup()
        if cuda:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn(arg)
            e.record()
            e.synchronize()
            best = min(best, s.elapsed_time(e) / 1e3)
        else:
            t0 = trace_mod.now()
            fn(arg)
            best = min(best, trace_mod.now() - t0)
    return best


def _replay_times(attr: _Attribution, leaves: List[Any], order: Any,
                  mesh: Any, reps: int
                  ) -> Tuple[Dict[int, float], float, int]:
    """Replay: per-node seconds of each node's lowering re-run on its
    children's held values, the whole walk's seconds, and how many nodes
    were skipped (the budget, or a node whose inputs exist only inside an
    enclosing loop's body — its time stays with the loop node). Each is
    timed apart, best of ``reps``: the nodes' times are not forced under
    the walk's, so a replay that counts work twice shows as a sum past
    the wall (``DeviceProfile.excess_s``)."""
    from ..expr import base

    cuda = _on_card(mesh)
    held = attr.walk(leaves, order, mesh)
    wall = _time_call(attr.run, lambda: attr.env(leaves, order, mesh),
                      reps, cuda)
    budget = max(8, _MAX_NODES_FLAG._value)
    nodes = attr.nodes
    skipped = max(0, len(nodes) - budget)
    if skipped:
        nodes = nodes[skipped:]  # keep the roots' end of the walk
    seeds = attr.env(leaves, order, mesh)
    group = mesh.is_group
    out: Dict[int, float] = {}
    for n in nodes:
        if n._id not in held:
            skipped += 1
            continue
        kids = {c._id: held[c._id] for c in n.children() if c._id in held}

        def setup(kids=kids) -> Dict[int, Any]:
            env = (base.GroupEnv(mesh, seeds) if group else dict(seeds))
            env.update(kids)
            return env

        def one(env: Dict[int, Any], n=n) -> None:
            with _use_naming(attr.naming):
                if group:
                    n.lower_local(env)
                else:
                    n.lower(env)

        try:
            out[n._id] = _time_call(one, setup, reps, cuda)
        except Exception:  # noqa: BLE001 - a node that cannot run
            skipped += 1   # alone keeps its time in the residual
    return out, wall, skipped


def _parse_capture(doc: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Fold a capture's Chrome trace per node range: each device event
    joins its runtime launch by CUPTI correlation id, and the launch the
    innermost ``__sg_`` range that encloses it on the launching thread.

    A capture holds its walk one or more times, each under an anchor range
    (``_ANCHOR``; a trace without one is one walk). The first walk whose
    every launch of device work (a kernel, a copy, a fill) has its device
    event is the one attributed (the card can lose the device records of
    a capture's first kernels, see :func:`_capture_times`); ``complete``
    says whether one was. Returns
    per-digest seconds, per-digest per-event-name seconds, the device wall
    (first event start to last event end), the walk's index and anchor
    start, and its device events; None when no walk holds a device
    event."""
    events = doc.get("traceEvents") or []
    ranges: Dict[Any, List[Tuple[float, float, str]]] = {}
    launches: Dict[Any, Tuple[Any, float]] = {}
    work = set()  # the launches that put work on the device
    devs: List[Dict[str, Any]] = []
    anchors: List[Tuple[Any, float, float]] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", ""))
        name = str(ev.get("name", ""))
        args = ev.get("args") or {}
        key = (ev.get("pid"), ev.get("tid"))
        ts = float(ev.get("ts", 0.0))
        if cat == "user_annotation":
            if name == _ANCHOR:
                anchors.append((key, ts, ts + float(ev.get("dur", 0.0))))
            m = _SCOPE_RX.search(name)
            if m is not None:
                ranges.setdefault(key, []).append(
                    (ts, ts + float(ev.get("dur", 0.0)), m.group(1)))
        elif cat in _LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (key, ts)
            if _DEVICE_WORK_RX.search(name):
                work.add(args["correlation"])
        elif cat in _DEVICE_CATS:
            devs.append({"name": name, "ts": ts,
                         "dur": float(ev.get("dur", 0.0)),
                         "corr": args.get("correlation")})
    anchors.sort(key=lambda a: a[1])
    walks = []
    for akey, alo, ahi in anchors or [(None, float("-inf"), float("inf"))]:
        inside = {c for c, (k, t) in launches.items()
                  if (akey is None or k == akey) and alo <= t <= ahi}
        wdevs = [d for d in devs if d["corr"] in inside
                 or (akey is None and d["corr"] not in launches)]
        seen = {d["corr"] for d in wdevs}
        walks.append((inside & work <= seen, alo, wdevs))
    pick = next((i for i, w in enumerate(walks) if w[0] and w[2]), None)
    if pick is None:
        pick = max(range(len(walks)), key=lambda i: len(walks[i][2]))
    complete, alo, devs = walks[pick]
    if not devs:
        return None
    by_digest: Dict[str, float] = {}
    by_kernel: Dict[str, Dict[str, float]] = {}
    for d in devs:
        digest = None
        lk = launches.get(d["corr"])
        if lk is not None:
            key, t = lk
            best = None
            for lo, hi, dg in ranges.get(key, ()):
                if lo <= t <= hi and (best is None or lo >= best[0]):
                    best = (lo, dg)
            digest = best[1] if best else None
        d["digest"] = digest
        if digest is None:
            continue
        secs = d["dur"] / 1e6
        by_digest[digest] = by_digest.get(digest, 0.0) + secs
        slot = by_kernel.setdefault(digest, {})
        slot[d["name"]] = slot.get(d["name"], 0.0) + secs
    start = min(d["ts"] for d in devs)
    end = max(d["ts"] + d["dur"] for d in devs)
    return {"by_digest": by_digest, "by_kernel": by_kernel,
            "wall_s": (end - start) / 1e6, "complete": complete,
            "walk": pick, "anchor": alo if anchors else None,
            "events": devs}


def _capture_times(attr: _Attribution, leaves: List[Any], order: Any,
                   mesh: Any
                   ) -> Optional[Tuple[Dict[int, float],
                                       Dict[int, Dict[str, float]], float,
                                       List[Dict[str, Any]]]]:
    """Whole walks under a ``torch.profiler`` capture with CUDA activity,
    attributed per node (:func:`_parse_capture`): (node seconds, node
    kernel seconds, device wall, device events).

    On an H100 the profiler has dropped the device records of a capture's
    first kernels, more of them in an older process. So a device op read
    back opens the capture, and the capture holds ``_CAPTURE_WALKS``
    walks: the first whose every launch of device work has its device
    record is attributed. None when no walk is whole, when the capture is
    busy, or when the walks run nothing on the card (the CPU);
    ``_tls.capture_note`` then says which."""
    if not _on_card(mesh):
        _tls.capture_note = f"the mesh's device is {mesh.device}"
        return None
    if not _capture_lock.acquire(blocking=False):
        _tls.capture_note = "another capture holds the profiler"
        return None
    tmp = tempfile.mkdtemp(prefix="spartan_tpu_torch_capture_")
    try:
        attr.walk(leaves, order, mesh)  # warm OUTSIDE the capture
        torch.cuda.synchronize(mesh.device)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prev = FLAGS.trace_annotations
        FLAGS.trace_annotations = True  # the node ranges are the join
        try:
            starts: List[float] = []
            with torch.profiler.profile(activities=acts) as p:
                torch.ones(1 << 20, device=mesh.device).add_(1.0) \
                    .sum().item()
                for _ in range(_CAPTURE_WALKS):
                    starts.append((trace_mod.now() - trace_mod.epoch())
                                  * 1e6)
                    with torch.profiler.record_function(_ANCHOR):
                        attr.walk(leaves, order, mesh)
                    torch.cuda.synchronize(mesh.device)
            path = os.path.join(tmp, "capture.json")
            p.export_chrome_trace(path)
            with open(path) as fh:
                parsed = _parse_capture(json.load(fh))
        finally:
            FLAGS.trace_annotations = prev
        if parsed is None:
            _tls.capture_note = "the capture recorded no device event"
            return None
        if not parsed["complete"]:
            _tls.capture_note = (
                f"the profiler lost device records of all {_CAPTURE_WALKS} "
                "captured walks")
            return None
        by_id = {attr.meta[n._id]["digest"]: n._id for n in attr.nodes}
        out = {by_id[d]: s for d, s in parsed["by_digest"].items()
               if d in by_id}
        kern = {by_id[d]: k for d, k in parsed["by_kernel"].items()
                if d in by_id}
        # the tracer-clock start of the attributed walk minus its
        # kineto start: the device events' offset onto the tracer's time
        # base
        off = starts[parsed["walk"]] - parsed["anchor"]
        names = {attr.meta[n]["digest"]: attr.meta[n]["node"] for n in out}
        evs = [{"name": d["name"], "ts": d["ts"] + off, "dur": d["dur"],
                "node": names.get(d.get("digest"))}
               for d in parsed["events"]]
        return out, kern, parsed["wall_s"], evs
    finally:
        _capture_lock.release()
        shutil.rmtree(tmp, ignore_errors=True)


def _profile_impl(attr: _Attribution, leaves: List[Any], order: Any,
                  mesh: Any, tier: str, reps: int,
                  digest: Optional[str]) -> DeviceProfile:
    node_secs: Optional[Dict[int, float]] = None
    kernels: Dict[int, Dict[str, float]] = {}
    events: List[Dict[str, Any]] = []
    skipped = 0
    wall_s = 0.0
    if tier in ("auto", "capture"):
        cap = _capture_times(attr, leaves, order, mesh)
        if cap is not None:
            node_secs, kernels, wall_s, events = cap
            if tier == "auto" and (wall_s <= 0 or
                                   sum(node_secs.values()) < 0.5 * wall_s):
                node_secs = None  # a partial capture: replay instead
                kernels, events = {}, []
    chosen = "capture"
    if node_secs is None:
        if tier == "capture":
            raise RuntimeError(
                "profile tier 'capture' requested but the runtime recorded "
                "no device activity joinable to expr nodes (a torch."
                "profiler capture with CUDA activity needs the card: "
                f"{getattr(_tls, 'capture_note', None)}); use "
                "tier='replay' or 'auto'")
        node_secs, wall_s, skipped = _replay_times(attr, leaves, order,
                                                   mesh, reps)
        chosen = "replay"
    nodes: List[Dict[str, Any]] = []
    total = sum(node_secs.values()) or 1.0
    for nid, secs in node_secs.items():
        if secs <= 0:
            continue
        rec = dict(attr.meta[nid])
        rec["seconds"] = round(secs, 9)
        rec["share"] = round(secs / total, 4)
        if kernels.get(nid):
            rec["kernels"] = {k: round(v, 9)
                              for k, v in kernels[nid].items()}
        nodes.append(rec)
    return DeviceProfile(chosen, digest, wall_s, nodes,
                         nodes_skipped=skipped, events=events)


def _record(prof: DeviceProfile, plan: Any) -> None:
    """Fold one timeline into the surfaces that outlive it: the plan
    report (st.explain), the cost ledger's device columns, the metrics
    registry, and the merged-export anchor."""
    global _last_profile

    if plan is not None and plan.report is not None:
        plan.report["device_profile"] = prof.to_report()
        # the plan's predictions sit next to the device columns even when
        # the entry was dropped (ledger reset / FIFO)
        ledger_mod.note_plan(plan)
    ledger_mod.note_device_profile(prof.plan_digest, prof.tier, prof.wall_s,
                                   prof.attributed_s, prof.class_seconds())
    if _METRICS_FLAG._value:
        REGISTRY.counter("profile_samples",
                         "device-time attribution profiles taken "
                         "(st.profile + sampled dispatches)").inc()
        REGISTRY.gauge("profile_attributed_fraction",
                       "fraction of the last profiled walk's wall "
                       "attributed to named expr nodes"
                       ).set(prof.attributed_fraction)
    with _lock:
        _last_profile = prof


def _norm_tier(tier: Optional[str]) -> str:
    tier = (tier or _TIER_FLAG._value or "auto").lower()
    if tier == "xplane":
        tier = "capture"
    if tier not in ("auto", "capture", "replay"):
        raise ValueError(f"unknown profile tier {tier!r} "
                         "(auto|capture|replay)")
    return tier


# -- the public API -------------------------------------------------------


def profile(expr: Any, tier: Optional[str] = None,
            reps: Optional[int] = None) -> DeviceProfile:
    """Run one profiled walk of ``expr``'s plan and return the
    per-expr-node device-time report (see module docstring).

    Plans like ``st.explain`` (a never-evaluated expr is pre-planned, so
    the next ``evaluate()`` hits); an already-evaluated root is
    re-planned from its lineage. ``tier``: 'auto' (default,
    ``FLAGS.profile_tier``) / 'capture' / 'replay'; ``reps``: timing
    repetitions per node for the replay tier (best-of, default 3)."""
    from ..expr import base
    from ..parallel import mesh as mesh_mod

    root = expr if isinstance(expr, base.Expr) else base.as_expr(expr)
    if type(root).__name__ == "DictExpr":
        root = root._tuple
    if root._result is not None and not isinstance(root, base.ValExpr):
        # profile the computation, not the cached result
        root.invalidate()
    mesh = mesh_mod.get_mesh()
    tier = _norm_tier(tier)
    reps = int(reps) if reps is not None else 3

    with trace_mod.span("profile", root=f"{type(root).__name__}#{root._id}"):
        plan_key, rctx = base.plan_signature(root, mesh)
        plan = base.lookup_plan(plan_key)
        leaves = rctx.leaves
        if plan is None:
            plan, _dag, opt_leaves = base._build_plan(root, mesh, rctx,
                                                      plan_key)
            if plan is not None and plan.stored is not None:
                plan = plan.stored  # raw order: the request's leaves
            elif plan is not None:
                leaves = opt_leaves  # uncacheable: its own leaves
        digest = key_hash(plan_key)
        if plan is None:
            return DeviceProfile("none", digest, 0.0, [],
                                 note="optimized DAG already carries a "
                                      "result; nothing to run")
        if plan.report is not None:
            digest = plan.report.get("plan_key") or digest
        attr = _attribution_for(digest, plan)
        with mesh_mod.use_mesh(mesh):
            prof = _profile_impl(attr, leaves, plan.arg_order, mesh, tier,
                                 reps, digest)
    _record(prof, plan)
    return prof


def export_merged(path: Optional[str] = None,
                  profile: Optional[DeviceProfile] = None) -> Dict[str, Any]:
    """``st.profile_export(path)``: one Perfetto-loadable Chrome trace
    merging the host span ring (``obs.trace``) with a device timeline
    (the given profile, else the most recent one), on the tracer's
    clock. Returns the document; also writes it to ``path`` when
    given."""
    doc = trace_mod.export()
    prof = profile if profile is not None else _last_profile
    if prof is not None:
        doc["traceEvents"] = list(doc["traceEvents"]) + prof.trace_events()
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
        from ..utils.log import log_info  # lazy: log-free at import

        log_info("profile: %d event(s) written to %s (host spans + device "
                 "timeline; load at https://ui.perfetto.dev)",
                 len(doc["traceEvents"]), path)
    return doc


def last_profile() -> Optional[DeviceProfile]:
    with _lock:
        return _last_profile


# -- sampled continuous profiling (the dispatch-time wrapper) -------------


def maybe_sample(expr: Any, plan: Any, phase_name: str, seconds: float,
                 leaves: List[Any], order: Any, donated: bool,
                 mesh: Any) -> None:
    """``expr/base._run``'s hook, called only when
    ``FLAGS.profile_sample_every`` > 0. Profiles every Nth warm dispatch
    of each plan after the real walk, off the result path. A walk that
    released donated leaves is never sampled (their tensors are gone)."""
    n = _SAMPLE_FLAG._value
    if n <= 0 or phase_name != "dispatch" or donated:
        return
    report = plan.report
    digest = report.get("plan_key") if report else None
    if digest is None:
        return
    with _lock:
        c = _sample_counts.get(digest, 0) + 1
        _sample_counts[digest] = c
    if c % max(1, n) != 0:
        return
    try:
        with trace_mod.span("profile_sample", plan=digest):
            attr = _attribution_for(digest, plan)
            tier = _norm_tier(None)
            prof = _profile_impl(attr, leaves, order, mesh, tier, 1, digest)
        _record(prof, plan)
        _tls.last_sample = {
            "plan": digest, "tier": prof.tier,
            "device_s": round(prof.attributed_s, 6),
            "attributed_fraction": round(prof.attributed_fraction, 4),
        }
    except Exception:  # noqa: BLE001 - sampling must never fail a
        # served evaluation; the error count is the alarm
        if _METRICS_FLAG._value:
            REGISTRY.counter("profile_sample_errors",
                             "sampled profiling attempts that raised (the "
                             "evaluation was unaffected)").inc()


def take_last_sample() -> Optional[Dict[str, Any]]:
    """Pop this thread's last sampled-profile stamp."""
    s = getattr(_tls, "last_sample", None)
    if s is not None:
        _tls.last_sample = None
    return s


def reset() -> None:
    """Drop sampler counters, cached attributions and the last profile
    (test isolation)."""
    global _last_profile
    with _lock:
        _sample_counts.clear()
        _attr_cache.clear()
        _last_profile = None
