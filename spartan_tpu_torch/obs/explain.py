"""Plan introspection: make every ``evaluate()`` explainable after the
fact (port of ``spartan_tpu/obs/explain.py``).

``st.explain(expr)`` answers "what will (or did) this evaluate do":
which optimizer passes ran and how they changed the DAG, which tiling
the cost model chose per node (with its cost estimate), which nodes run
a hand-written kernel (``kernels``), where reshards were planned, the
leaf -> walk argument order, the donation slots of the last run, and the
plan's FLOPs and bytes (``cost_analysis``).

The structured report is built ONCE, on the plan-cache miss path
(``expr/base._build_plan`` calls :func:`build_plan_report` and stores
the dict on the ``_Plan``), so explaining a cached plan is a signature
traversal + dict copy — no optimizer re-run. Explaining a never-
evaluated expr builds (and caches) its plan without running it, so the
following ``evaluate()`` hits.

``cost_analysis`` has no compiled program to read here (the JAX package
reads XLA's ``Compiled.cost_analysis()``): it is COUNTED. Each node
class returns its FLOPs and bytes from its shapes (``Expr.cost``) by the
rules XLA applies — a dot is ``2·m·n·k`` FLOPs and reads its operands
and writes its output once, an elementwise op is one FLOP per element
(a transcendental one counts under ``transcendentals``), a reduction of
``n`` elements to one is ``n − 1`` — and a kernel node returns its
kernel wrapper's own count (``kernels/kmeans.cost``,
``kernels/stencil.cost``), the count ``chip_smoke.py`` divides by the
card's rates for the kernel's bound. As in the JAX package on a
partitioned mesh, ``flops`` and ``bytes accessed`` are PER DEVICE (one
mesh position's share under the committed tilings, with a k-split
product's partial-sum all-reduce); ``program`` holds the whole plan's
totals — the work the one card of a logical mesh does — and ``nodes``
each node's.

Top-level imports stay off the expr layer (expr/base imports this
module); expr and tiling helpers load lazily inside the builders.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def key_hash(key: Any) -> Optional[str]:
    """Short printable digest of a plan key (process-stable, matching
    what evaluate spans carry)."""
    if key is None:
        return None
    return format(hash(key) & 0xFFFFFFFFFFFF, "012x")


def _label(node: Any) -> str:
    return f"{type(node).__name__}#{node._id}"


def _site_str(site: Optional[Tuple[str, int, str]]) -> Optional[str]:
    return f"{site[0]}:{site[1]} (in {site[2]})" if site else None


def _leaf_entries(leaves: Sequence[Any]) -> List[Dict[str, Any]]:
    from ..expr.base import ScalarExpr, ValExpr

    out = []
    for pos, leaf in enumerate(leaves):
        if isinstance(leaf, ScalarExpr):
            out.append({"pos": pos, "kind": "scalar",
                        "weak_kind": leaf.weak_kind})
        else:
            kind = "val" if isinstance(leaf, ValExpr) else "cached"
            out.append({"pos": pos, "kind": kind, "shape": leaf.shape,
                        "dtype": str(leaf.dtype),
                        "tiling": leaf.out_tiling().axes})
    return out


def _tiling_entries(dag: Any) -> List[Dict[str, Any]]:
    from ..expr.base import ScalarExpr, ValExpr
    from ..expr.optimize import dag_nodes

    out = []
    for n in dag_nodes(dag):
        if isinstance(n, (ValExpr, ScalarExpr)):
            continue
        try:
            tiling = n.out_tiling().axes
        except Exception:
            tiling = None
        entry: Dict[str, Any] = {
            "node": _label(n), "shape": n.shape, "dtype": str(n.dtype),
            "tiling": tiling, "forced": n._forced_tiling is not None,
        }
        cost = getattr(n, "_plan_cost", None)
        if cost is not None:
            entry["cost_estimate"] = round(float(cost), 3)
        plan = getattr(n, "_dot_plan", None)
        if plan is not None:
            entry["contraction"] = {"grid": plan[0].axes,
                                    "strategy": plan[1]}
        site = _site_str(n._site)
        if site is not None:
            entry["site"] = site
        out.append(entry)
    return out


def _reshard_edges(dag: Any) -> List[Dict[str, Any]]:
    """Edges where the plan demands an operand layout different from the
    child's own output layout — the points a reshard must materialize.
    With ``FLAGS.redistribution_planner`` on, each edge also names its
    chosen collective schedule, the modeled cost, and whether the
    explicit schedule or the implicit path was taken."""
    from ..expr import tiling_cost
    from ..expr.optimize import dag_nodes
    from ..parallel import mesh as mesh_mod
    from ..parallel import redistribute as redist_mod
    from . import ledger as ledger_mod

    mesh = mesh_mod.get_mesh()
    planner = redist_mod.planner_on()
    factors = ledger_mod.factors() if planner else None
    edges = []
    for n in dag_nodes(dag):
        kids = n.children()
        if not kids:
            continue
        try:
            t = n.out_tiling()
        except Exception:
            continue
        cview = tiling_cost._contraction_view(n)
        reqs: List[Optional[Any]] = [None] * len(kids)
        if cview is not None and getattr(n, "_dot_plan", None) is not None:
            grid, strategy = n._dot_plan
            try:
                reqs = list(cview[1](grid, strategy))
            except Exception:
                reqs = [None] * len(kids)
        else:
            for i, c in enumerate(kids):
                try:
                    reqs[i] = tiling_cost._operand_requirement(n, t, c, i)
                except Exception:
                    reqs[i] = None
        for i, (c, req) in enumerate(zip(kids, reqs)):
            if req is None:
                continue
            try:
                src = c.out_tiling().axes
            except Exception:
                continue
            if src == req.axes:
                continue
            nbytes = float(c.size) * c.dtype.itemsize
            try:
                moved = tiling_cost.reshard_cost(c.out_tiling(), req,
                                                 nbytes, mesh)
            except Exception:
                moved = None
            if moved == 0.0:
                continue  # e.g. replicated source: nothing moves
            entry = {
                "edge": f"{_label(c)} -> {_label(n)}", "operand": i,
                "src": src, "dst": req.axes,
                "bytes_per_chip": (round(moved, 1)
                                   if moved is not None else None),
            }
            if planner:
                # the SAME decision the lowering seam makes for this
                # edge (redistribute.constrain)
                try:
                    d = redist_mod.decide(c.out_tiling(), req, c.shape,
                                          c.dtype, mesh, factors)
                except Exception:
                    d = None
                if d is not None:
                    entry["schedule"] = d.schedule.describe()
                    entry["modeled_cost"] = round(d.cost, 1)
                    entry["path"] = "explicit" if d.explicit else "implicit"
                    entry["reason"] = d.reason
            edges.append(entry)
    return edges


# -- the counted cost analysis -------------------------------------------


def _fmt_bytes(n: Any) -> str:
    if n is None:
        return "?"
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return (f"{n:.0f}{unit}" if unit == "B"
                    else f"{n:.1f}{unit}")
        n /= 1024.0
    return f"{n:.1f}GiB"


def _parallelism(tiling: Any, mesh: Any) -> int:
    p = 1
    for n in tiling.tiles_per_dim(mesh):
        p *= int(n)
    return max(1, p)


def _per_device(n: Any, c: Dict[str, float], mesh: Any
                ) -> Tuple[float, float, float]:
    """One mesh position's share (FLOPs, transcendentals, bytes) of node
    ``n``'s counts ``c`` under the committed tilings: the work splits as
    the node's output tiling splits, each array child is read in its
    block of the work (whole when it broadcasts), a scalar whole. A 2-D
    product under a plan computes its (m/r, k/s) x (k/s, n/c) block and,
    with the contraction split, adds the partial sums with an all-reduce
    that XLA counts as one FLOP per output element read and written. A
    ``ContractExpr`` under its plan splits the same way: its output grid
    by the plan's tiling, its primary contraction label by the strategy
    axis. A node with its own per-device program (the blocked scan)
    counts it (``cost_per_device``)."""
    from ..expr.base import ScalarExpr
    from ..expr.contract import ContractExpr

    own = getattr(n, "cost_per_device", None)
    if own is not None:
        return own(mesh)
    plan = getattr(n, "_dot_plan", None)
    if plan is not None and isinstance(n, ContractExpr):
        return _contract_per_device(n, plan, mesh)
    if plan is not None and getattr(n, "a", None) is not None \
            and n.a.ndim == 2 and n.b.ndim == 2:
        grid, k_ax = plan
        size = (lambda ax: 1 if ax is None else
                _parallelism(_one_axis(ax), mesh))
        r, col, s = size(grid.axes[0]), size(grid.axes[1]), size(k_ax)
        m, kk = n.a.shape
        nn = n.b.shape[1]
        it = n.dtype.itemsize
        out_blk = (m / r) * (nn / col)
        flops = 2.0 * (m / r) * (nn / col) * (kk / s)
        nbytes = (n.a.dtype.itemsize * (m / r) * (kk / s)
                  + n.b.dtype.itemsize * (kk / s) * (nn / col)
                  + it * out_blk)
        if s > 1:
            flops += out_blk
            nbytes += 2.0 * it * out_blk
        return flops, 0.0, nbytes
    try:
        p = _parallelism(n.out_tiling(), mesh)
    except Exception:
        p = 1
    kids = {k._id: k for k in n.children()}.values()
    # the work's shape: the largest operand's (a reduction's), else the
    # output's
    work = max((k.shape for k in kids), key=lambda s: int(np.prod(s)),
               default=n.shape)
    if int(np.prod(work)) < n.size:
        work = n.shape
    nbytes = 0.0
    for k in kids:
        kb = float(k.size) * k.dtype.itemsize
        split = not isinstance(k, ScalarExpr) and k.shape in (work, n.shape)
        nbytes += kb / p if split else kb  # broadcast / scalar: whole
    own = c["bytes accessed"] - sum(float(k.size) * k.dtype.itemsize
                                    for k in kids)
    nbytes += max(0.0, own) / p
    return (c["flops"] / p, float(c.get("transcendentals", 0.0)) / p,
            nbytes)


def _contract_per_device(n: Any, plan: Any, mesh: Any
                         ) -> Tuple[float, float, float]:
    """One position's share of a planned ``ContractExpr``: the block
    product of its output block over its share of the contraction (the
    primary label split by the strategy axis), plus the all-reduce's one
    FLOP per output element read and written when the strategy splits
    it; each operand read in its block, the output written in its."""
    out_t, strategy = plan
    size = (lambda ax: 1 if ax is None else
            _parallelism(_one_axis(ax), mesh))

    def block(shape: Tuple[int, ...], axes: Tuple[Any, ...]) -> float:
        b = 1.0
        for d, ax in zip(shape, axes):
            b *= d / size(ax)
        return b

    labels = n.contraction_labels
    s = size(strategy) if (strategy and labels) else 1
    contr = 1.0
    for lab in labels:
        contr *= n.label_size(lab)
    contr /= s
    out_blk = block(n.shape, out_t.axes)
    ta, tb = n.plan_operand_tilings(out_t, strategy)
    it = n.dtype.itemsize
    flops = 2.0 * out_blk * contr
    nbytes = (n.a.dtype.itemsize * block(n.a.shape, ta.axes)
              + n.b.dtype.itemsize * block(n.b.shape, tb.axes)
              + it * out_blk)
    if s > 1:
        flops += out_blk
        nbytes += 2.0 * it * out_blk
    return flops, 0.0, nbytes


def _one_axis(ax: Any) -> Any:
    from ..array.tiling import Tiling

    return Tiling((ax,))


def count_cost(dag: Any, mesh: Any = None) -> Dict[str, Any]:
    """The plan's counted cost analysis (see the module docstring):
    ``flops`` / ``transcendentals`` / ``bytes accessed`` per device,
    ``program`` with the whole plan's totals, ``nodes`` per node (with
    ``kernel`` for a node that runs a hand-written kernel)."""
    from ..expr.base import ScalarExpr, ValExpr
    from ..expr.optimize import dag_nodes
    from ..parallel import mesh as mesh_mod

    mesh = mesh or mesh_mod.get_mesh()
    nodes: List[Dict[str, Any]] = []
    tot = {"flops": 0.0, "transcendentals": 0.0, "bytes accessed": 0.0}
    dev = {"flops": 0.0, "transcendentals": 0.0, "bytes accessed": 0.0}
    for n in dag_nodes(dag):
        if isinstance(n, (ValExpr, ScalarExpr)):
            continue
        c = n.cost()
        if not any(c.get(k) for k in tot):
            continue
        for k in tot:
            tot[k] += float(c.get(k, 0.0))
        df, dt, db = _per_device(n, c, mesh)
        dev["flops"] += df
        dev["transcendentals"] += dt
        dev["bytes accessed"] += db
        entry = {"node": _label(n), "flops": c["flops"],
                 "transcendentals": c.get("transcendentals", 0.0),
                 "bytes accessed": c["bytes accessed"]}
        if c.get("kernel"):
            entry["kernel"] = dict(c["kernel"])
        nodes.append(entry)
    out: Dict[str, Any] = dict(dev)
    out["program"] = tot
    out["devices"] = mesh_mod.device_count(mesh)
    out["nodes"] = nodes
    return out


def build_plan_report(expr: Any, dag: Any, leaves: Sequence[Any],
                      plan_key: Any, passes: List[Dict[str, Any]],
                      out_tilings: Sequence[Any],
                      arg_order: Optional[Tuple[int, ...]]
                      ) -> Dict[str, Any]:
    """The structured per-plan report, built on the miss path and stored
    on the ``_Plan`` (shared by the cached and the first-run plan, so a
    cache-hit ``st.explain`` is instant)."""
    from ..parallel import mesh as mesh_mod

    # the tiling DP's prediction for this plan: the roots' cumulative
    # chosen-tiling cost (bytes-equivalent) and its per-op-class
    # decomposition — what the cost ledger compares against measured
    # dispatch time and what fit_profile calibrates from
    dp_cost: Optional[float] = None
    components: Optional[Dict[str, float]] = None
    try:
        from ..expr import tiling_cost
        from ..expr.base import TupleExpr

        roots = dag.elements if isinstance(dag, TupleExpr) else (dag,)
        vals = [getattr(r, "_plan_cost", None) for r in roots]
        vals = [float(v) for v in vals if v is not None]
        dp_cost = sum(vals) if vals else None
        components = tiling_cost.class_components(dag) or None
    except Exception:  # noqa: BLE001 - the prediction is advisory
        pass

    # kernel decisions: the SAME select() the lowering calls per
    # kernel-eligible node — backend (cuda / plain / expr) and the
    # fallback reason
    kernel_nodes = None
    try:
        from ..kernels import registry as kernels_mod

        kernel_nodes = kernels_mod.plan_entries(dag) or None
    except Exception:  # noqa: BLE001 - the report is advisory
        pass

    # planned cross-mesh migrations: leaves that were rehomed or
    # restored through the redistribution planner carry a _migration
    # record (schedule, route, modeled bytes, reason)
    migrations = None
    try:
        migs = []
        for leaf in leaves:
            arr = getattr(leaf, "value", None)
            if arr is None:
                arr = getattr(leaf, "_result", None)
            m = getattr(arr, "_migration", None)
            if m:
                migs.append(dict(m))
        migrations = migs or None
    except Exception:  # noqa: BLE001 - the report is advisory
        pass

    report: Dict[str, Any] = {
        "root": _label(expr),
        "site": _site_str(expr._site),
        "plan_key": key_hash(plan_key),
        "dp_cost": dp_cost,
        "cost_components": components,
        "kernels": kernel_nodes,
        # the mesh generation this plan was built for
        "mesh_epoch": mesh_mod.mesh_epoch(),
        "passes": passes,
        "optimized_nodes": (passes[-1]["nodes_after"] if passes else None),
        "leaves": _leaf_entries(leaves),
        "arg_order": list(arg_order) if arg_order is not None else None,
        "out_tilings": [t.axes for t in out_tilings],
        "tilings": _tiling_entries(dag),
        "reshard_edges": _reshard_edges(dag),
        "migrations": migrations,
        "donation": {"last_donated_args": None, "donated_dispatches": 0},
        "cost_analysis": None,
    }
    # filled in by _build_plan's epilogue (scope_digest_table): the
    # digest is computed from the FINAL node state
    report["scope_digests"] = {}
    return report


def scope_digest_table(dag: Any) -> Dict[str, Dict[str, Any]]:
    """digest -> node table: the same ``__sg_`` digests a naming session
    (obs/profile.py) stamps into this plan's profiler ranges, mapped back
    to node label + user build site. Called at the END of
    ``_build_plan`` (miss path, one extra signing traversal)."""
    try:
        from ..expr.optimize import dag_nodes
        from .profile import _NamingCtx

        nctx = _NamingCtx()
        # memoize ROOT-FIRST, exactly like the walk-time session
        nctx.digest(dag)
        digests: Dict[str, Dict[str, Any]] = {}
        for n in dag_nodes(dag):
            dg = nctx.digest(n)
            if dg:
                digests[dg] = {"node": _label(n), "site": _site_str(n._site)}
        return digests
    except Exception:  # noqa: BLE001 - attribution is advisory
        return {}


class ExplainReport:
    """Structured plan report with a pretty ``str()`` rendering.

    ``.data`` is the raw dict; the common fields are attributes:
    ``cache`` ('hit' / 'miss' / 'evaluated'), ``plan_key``, ``passes``,
    ``tilings``, ``kernels``, ``reshard_edges``, ``leaves``,
    ``arg_order``, ``donation``, ``cost_analysis``, ``flops``, and —
    once ``st.profile`` or the ``FLAGS.profile_sample_every`` sampler
    has measured this plan — ``device_profile`` (per-node measured
    device seconds next to the modeled costs, hottest first)."""

    def __init__(self, data: Dict[str, Any]):
        self.data = data

    def __getattr__(self, name: str) -> Any:
        try:
            return self.__dict__["data"][name]
        except KeyError:
            raise AttributeError(name)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.data)

    @property
    def flops(self) -> Optional[float]:
        ca = self.data.get("cost_analysis")
        return ca.get("flops") if ca else None

    def __str__(self) -> str:
        d = self.data
        lines = [f"plan for {d.get('root')} "
                 f"[cache {d.get('cache', '?')}, key {d.get('plan_key')}]"]
        if d.get("site"):
            lines.append(f"  built at {d['site']}")
        if d.get("mesh_epoch"):  # epoch 0 (no rebuild yet) is implied
            lines.append(f"  mesh epoch {d['mesh_epoch']} "
                         "(rebuilt after device loss)")
        if d.get("passes"):
            lines.append("  passes:")
            for p in d["passes"]:
                delta = p["nodes_after"] - p["nodes_before"]
                lines.append(
                    f"    {p['name']:<18} {p['nodes_before']:>4} -> "
                    f"{p['nodes_after']:<4} nodes ({delta:+d}) "
                    f"{p.get('seconds', 0.0) * 1e3:8.2f} ms")
        if d.get("dp_cost") is not None:
            lines.append(f"  dp_cost {d['dp_cost']:.6g} "
                         f"{d.get('cost_components') or {}}")
        if d.get("tilings"):
            lines.append("  tilings:")
            for t in d["tilings"]:
                extra = ""
                if t.get("forced"):
                    extra += " FORCED"
                if t.get("cost_estimate") is not None:
                    extra += f" cost~{t['cost_estimate']}"
                if t.get("contraction"):
                    cstrat = t["contraction"]
                    extra += (f" contraction(grid={cstrat['grid']}, "
                              f"axis={cstrat['strategy']})")
                lines.append(f"    {t['node']:<22} {str(t['shape']):<16} "
                             f"{str(t['tiling']):<14}{extra}")
        if d.get("kernels"):
            lines.append("  kernel nodes:")
            for kn in d["kernels"]:
                line = (f"    {kn['node']:<22} {kn['op']:<14} "
                        f"backend={kn['backend']}")
                if kn.get("reason"):
                    line += f" ({kn['reason']})"
                lines.append(line)
        if d.get("reshard_edges"):
            lines.append("  reshard edges:")
            for e in d["reshard_edges"]:
                line = (f"    {e['edge']}: {e['src']} -> {e['dst']} "
                        f"(~{e['bytes_per_chip']} B/chip)")
                if e.get("schedule"):
                    line += (f" via {e['schedule']} [{e['path']}, "
                             f"cost~{e['modeled_cost']}]")
                lines.append(line)
        if d.get("migrations"):
            lines.append("  migrations (cross-mesh re-tiling):")
            for m in d["migrations"]:
                line = (f"    {str(m.get('shape', '?')):<14} "
                        f"{str(m.get('src_tiling', '?'))} -> "
                        f"{str(m.get('dst_tiling', '?'))} "
                        f"[{m.get('route')}, ~{m.get('bytes', 0)} B]")
                if m.get("schedule"):
                    line += f" via {m['schedule']}"
                if m.get("reason"):
                    line += f" ({m['reason']})"
                lines.append(line)
        aud = d.get("audit")
        if aud:
            # the static communication audit (analysis/plan_audit.py):
            # the per-node collective table and its findings
            from ..analysis.plan_audit import PlanAudit

            for ln in str(PlanAudit.from_dict(aud)).splitlines():
                lines.append("  " + ln)
        dp = d.get("device_profile")
        if dp:
            lines.append(
                f"  device profile [{dp.get('tier')}]: wall "
                f"{dp.get('wall_s', 0.0) * 1e3:.3f}ms, attributed "
                f"{dp.get('attributed_fraction', 0.0) * 100:.1f}% "
                f"(unattributed {dp.get('unattributed_s', 0.0) * 1e3:.3f}ms)")
            nodes = dp.get("nodes") or []
            shown = nodes if len(nodes) <= 8 else nodes[:5]
            for n in shown:
                modeled = (f" modeled~{n['modeled_cost']}"
                           if n.get("modeled_cost") is not None else "")
                lines.append(f"    {n['node']:<24} "
                             f"{n['seconds'] * 1e3:9.3f}ms "
                             f"{n.get('share', 0.0) * 100:5.1f}%{modeled}")
            if len(nodes) > len(shown):
                lines.append(f"    ... ({len(nodes) - len(shown)} more "
                             "attributed node(s))")
        sk = d.get("skew")
        if sk:
            # shard-level skew (obs/skew.py: st.skew or the sampler): the
            # per-position view under the per-node seconds above
            line = (f"  shard skew [{sk.get('tier')}]: imbalance "
                    f"max/mean {sk.get('imbalance_ratio') or 'n/a'}")
            hs = sk.get("hottest_shard")
            if hs:
                line += (f", hottest shard {hs['device']} "
                         f"({hs['seconds'] * 1e3:.3f}ms)")
            lines.append(line)
            for r in (sk.get("nodes") or [])[:3]:
                lines.append(
                    f"    {r['node']:<24} ratio {r['ratio']:<7} wait "
                    f"{r['wait_s'] * 1e3:8.3f}ms  straggler "
                    f"{r['straggler']}")
            for e in (sk.get("straggler_edges") or [])[:3]:
                kinds = ", ".join(f"{k}x{n}" if n > 1 else k
                                  for k, n in sorted(e["kinds"].items()))
                lines.append(
                    f"    edge {e['node']:<19} {kinds:<18} wait "
                    f"{e['wait_s'] * 1e3:8.3f}ms")
            adv = sk.get("advisory")
            if adv:
                lines.append(
                    f"    ADVISORY: re-tile {adv['src']} -> "
                    f"{adv['dst']} ~cost {adv['modeled_cost']} "
                    f"via {adv['schedule']} (report-only)")
        if d.get("leaves") is not None:
            lines.append(f"  leaves: {len(d['leaves'])} "
                         f"(arg order {d.get('arg_order')})")
        don = d.get("donation") or {}
        if don.get("last_donated_args"):
            lines.append(
                f"  donation: args {don['last_donated_args']} donated "
                f"({don['donated_dispatches']} donated dispatch(es))")
        mem = d.get("memory")
        if mem:
            line = (f"  memory: predicted peak "
                    f"{_fmt_bytes(mem.get('peak_bytes_card'))} on the card, "
                    f"{_fmt_bytes(mem.get('peak_bytes_per_chip'))}/chip "
                    "by the JAX package's model")
            if mem.get("budget_bytes"):
                line += f" (budget {_fmt_bytes(mem['budget_bytes'])})"
            if mem.get("governed_rung"):
                line += f", GOVERNED -> rung {mem['governed_rung']}"
                if mem.get("governed_peak_bytes"):
                    line += (f" predicted "
                             f"{_fmt_bytes(mem['governed_peak_bytes'])}")
            lines.append(line)
            for top in (mem.get("card_top") or [])[:5]:
                lines.append(f"    {top['node']:<28} "
                             f"{_fmt_bytes(top['bytes'])}")
            val = mem.get("validation")
            if val:
                lines.append(
                    f"    validated: measured peak "
                    f"{_fmt_bytes(val.get('measured_peak_bytes'))}, "
                    f"predicted/measured {val.get('error_ratio')}")
        res = d.get("resilience")
        if res:
            line = f"  resilience: retries={res.get('retries', 0)}"
            if res.get("rung"):
                line += f", degraded rung={res['rung']}"
                # a predictive pick (the memory governor, before any
                # walk) apart from a reactive one (after a real OOM)
                line += f" ({res.get('origin', 'reactive')}"
                if res.get("rung_predicted_bytes") is not None:
                    line += (", predicted "
                             f"{_fmt_bytes(res['rung_predicted_bytes'])}")
                line += ")"
            if res.get("restores"):
                line += f", loop restores={res['restores']}"
            if res.get("resumed_from") is not None:
                line += f", resumed from iteration {res['resumed_from']}"
            lines.append(line)
        sv = d.get("serve")
        if sv:
            lines.append(
                f"  serve: coalesced {sv.get('batches', 0)} batch(es), "
                f"last batch={sv.get('last_batch')} client(s) "
                f"[{sv.get('mode')}], {sv.get('requests', 0)} "
                f"request(s) total")
        ca = d.get("cost_analysis")
        if ca:
            lines.append(
                f"  cost_analysis: flops={ca.get('flops')} "
                f"bytes={ca.get('bytes accessed')} per device of "
                f"{ca.get('devices')}; program flops="
                f"{ca['program']['flops']} bytes="
                f"{ca['program']['bytes accessed']}")
        elif ca is None and "cost_analysis" in d:
            lines.append("  cost_analysis: (skipped; "
                         "st.explain(expr, cost=True) to count)")
        return "\n".join(lines)

    __repr__ = __str__


def explain(expr: Any, cost: bool = True) -> ExplainReport:
    """Explain the evaluation plan for ``expr`` (see module docstring).

    ``cost=True`` (default) also fills ``cost_analysis`` (counted once
    per plan, memoized on its report). Never runs the plan: explaining
    an unevaluated expr pre-plans it (the next ``evaluate()`` is a
    plan-cache hit)."""
    from ..expr import base
    from ..parallel import mesh as mesh_mod

    root = expr if isinstance(expr, base.Expr) else base.as_expr(expr)
    if root._result is not None:
        return ExplainReport({
            "root": _label(root), "site": _site_str(root._site),
            "cache": "evaluated", "plan_key": None, "passes": [],
            "tilings": [], "reshard_edges": [], "leaves": None,
            "arg_order": None, "donation": {}, "cost_analysis": None,
            # the resilience record survives on the expr even after its
            # plan report is unreachable through the cache
            "resilience": getattr(root, "_resilience", None),
            "note": "expr already carries a result; nothing to plan",
        })

    mesh = mesh_mod.get_mesh()
    plan_key, rctx = base.plan_signature(root, mesh)
    plan = base.lookup_plan(plan_key)
    status = "hit" if plan is not None else "miss"
    if plan is None:
        plan, dag, _ = base._build_plan(root, mesh, rctx, plan_key)
        if plan is None:  # optimizer collapsed to an already-held result
            return ExplainReport({
                "root": _label(root), "site": _site_str(root._site),
                "cache": "evaluated", "plan_key": key_hash(plan_key),
                "passes": [], "tilings": [], "reshard_edges": [],
                "leaves": None, "arg_order": None, "donation": {},
                "cost_analysis": None,
                "note": "optimized DAG already carries a result",
            })
    if cost and plan.report.get("cost_analysis") is None:
        with mesh_mod.use_mesh(mesh):
            plan.report["cost_analysis"] = count_cost(plan.dag, mesh)
        # the counted FLOPs land in the cost ledger next to the tiling
        # DP's prediction for the same plan digest
        from . import ledger as ledger_mod

        ledger_mod.note_cost_analysis(plan.report.get("plan_key"),
                                      plan.report["cost_analysis"])
    data = dict(plan.report)
    data["cache"] = status
    return ExplainReport(data)
