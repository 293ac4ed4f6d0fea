"""Static communication audit of a plan (port of
``spartan_tpu/analysis/plan_audit.py``; ``st.audit_plan``).

The JAX package AOT-compiles a plan over its committed shardings and
reads the collectives out of the post-GSPMD HLO. The port runs no XLA
program. Its audit is a dry walk of the plan's optimized DAG over a
group mesh of the plan's mesh shape: every node's group lowering
(``Expr.lower_local``: its local rule, or its whole lowering where it
has none) runs on ``meta`` tensors, which carry shapes and no data, and
the collectives layer records each call it would make instead of making
it. Nothing is computed, moved or launched. Every branch of a local
rule is decided from shapes, tilings and the plan (``expr/base.py``),
so the list is the one a real group walk issues, call for call and
byte for byte, and it is the same whether the plan was built on a
logical mesh or on a group. The sources it sees:

* the k-split all-reduce of a ``DotExpr`` or ``ContractExpr``, and
  the all-reduce of a user ``map2``'s partial sum where its function is
  proven row-partitionable (``expr/partition.py``; an unproven one is a
  whole-array gather below);
* each ``all_gather``/``all_to_all`` step of the schedule
  ``parallel/redistribute.relayout`` runs for a reshard (a forced
  tiling, an operand's required layout, the plan's output tilings);
* the sample sort's ``all_to_all`` exchanges and sample gathers (of
  rows along a tiled axis too);
* the stencil's and the pools' halo ``ring_permute`` calls;
* the piece exchange's uneven ``all_to_all``
  (``parallel/redistribute.move_pieces``) of a reshape, a
  concatenation, a slice, a diagonal or an uneven relayout, and the
  all-gathers of the blocked scan's totals and of a user reduce's
  partials;
* every whole-array gather of a node without a local rule (counted on a
  real walk as ``group_materialize_calls{site}``).

Each record carries the JAX package's kind name (``all-reduce``,
``all-gather``, ``all-to-all``, ``collective-permute``), the position's
``operand_bytes`` (what ``collective_bytes{op}`` counts) and
``result_bytes``, the ``group_size``, ``bytes_moved`` from the ring
model (``analysis/hlo.py``), the node (and its ``scope_digests`` entry)
and the node's build site.

Findings follow the JAX package: ``full_gather`` for each whole-array
gather (node, site, bytes), ``replicated_intermediate`` for an
all-gather whose result exceeds ``FLAGS.replication_warn_bytes``.
``missed_donation`` follows the port's semantics, not XLA's aliasing:
the port frees a donated leaf after the walk (``expr/base.py::_run``),
so a donation is missed when the donated array is not a leaf of the
built plan (nothing frees it), or when another live tensor shares its
storage (freeing it releases nothing).

The verdict is memoized on ``plan.report["audit"]`` (JSON-safe; the
persist store carries it), renders in ``st.explain`` as the per-node
collective table, and ``FLAGS.verify_evaluate`` runs
:func:`audit_on_miss` on the plan-cache miss path only (advisory).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..obs.metrics import METRICS_FLAG, REGISTRY, TAP
from ..utils import dtypes
from ..utils.config import FLAGS
from ..utils.log import log_warn
from . import hlo

_REPLICATION_WARN_FLAG = FLAGS.define_int(
    "replication_warn_bytes", 64 << 20,
    "Plan-audit threshold: an all-gather whose (per-position, fully "
    "materialized) result exceeds this many bytes is flagged as a "
    "replicated_intermediate finding: each position holds a whole copy "
    "of something the tiling meant to shard. 0 disables the check.")


class AuditFinding:
    """One plan-audit finding (advisory: the auditor never fails the
    evaluation that triggered it)."""

    __slots__ = ("severity", "kind", "message", "node", "source",
                 "bytes")

    def __init__(self, severity: str, kind: str, message: str,
                 node: Optional[str] = None,
                 source: Optional[str] = None,
                 nbytes: Optional[float] = None):
        self.severity = severity
        self.kind = kind
        self.message = message
        self.node = node
        self.source = source
        self.bytes = nbytes

    def __str__(self) -> str:
        on = f" on {self.node}" if self.node else ""
        at = f" [{self.source}]" if self.source else ""
        return f"{self.kind}: {self.message}{on}{at}"

    __repr__ = __str__

    def to_dict(self) -> Dict[str, Any]:
        return {"severity": self.severity, "kind": self.kind,
                "message": self.message, "node": self.node,
                "source": self.source, "bytes": self.bytes}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AuditFinding":
        return cls(d.get("severity", "warning"), d.get("kind", "?"),
                   d.get("message", ""), d.get("node"),
                   d.get("source"), d.get("bytes"))


class PlanAudit:
    """Structured audit of one plan.

    ``collectives`` — per-call dicts (kind, op, operand_bytes,
    result_bytes, group_size, bytes_moved, node, source); ``multiset``
    — ``{kind: count}``; ``comm_bytes`` — modeled per-position wire
    total; ``findings`` — :class:`AuditFinding` list; ``donation`` —
    the requested argument positions and those the walk frees
    (``aliased``, the JAX package's key)."""

    def __init__(self, collectives: List[Dict[str, Any]],
                 findings: List[AuditFinding],
                 donation: Optional[Dict[str, Any]] = None):
        self.collectives = collectives
        self.findings = findings
        self.donation = donation or {"requested": [], "aliased": []}

    @property
    def comm_bytes(self) -> float:
        return float(sum(c.get("bytes_moved", 0.0)
                         for c in self.collectives))

    @property
    def multiset(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for c in self.collectives:
            out[c["kind"]] = out.get(c["kind"], 0) + 1
        return out

    def operand_bytes(self) -> Dict[str, int]:
        """``{kind: operand bytes}`` summed over the plan: what the
        walk adds to ``collective_bytes{op}``."""
        out: Dict[str, int] = {}
        for c in self.collectives:
            out[c["kind"]] = out.get(c["kind"], 0) + int(c["operand_bytes"])
        return out

    def per_node(self) -> List[Dict[str, Any]]:
        """The st.explain collective table: one row per node
        (``<unattributed>`` for none), heaviest first."""
        rows: Dict[str, Dict[str, Any]] = {}
        for c in self.collectives:
            node = c.get("node") or "<unattributed>"
            row = rows.setdefault(node, {"node": node, "kinds": {},
                                         "bytes_moved": 0.0})
            row["kinds"][c["kind"]] = row["kinds"].get(c["kind"], 0) + 1
            row["bytes_moved"] += float(c.get("bytes_moved", 0.0))
        return sorted(rows.values(), key=lambda r: -r["bytes_moved"])

    def to_dict(self) -> Dict[str, Any]:
        return {"collectives": list(self.collectives),
                "multiset": self.multiset,
                "comm_bytes": self.comm_bytes,
                "findings": [f.to_dict() for f in self.findings],
                "donation": dict(self.donation)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PlanAudit":
        return cls(list(d.get("collectives") or ()),
                   [AuditFinding.from_dict(f)
                    for f in d.get("findings") or ()],
                   dict(d.get("donation") or {}))

    def __str__(self) -> str:
        from ..obs.explain import _fmt_bytes

        lines = [f"plan audit: {len(self.collectives)} collective(s), "
                 f"~{_fmt_bytes(self.comm_bytes)}/position modeled, "
                 f"{len(self.findings)} finding(s)"]
        if self.collectives:
            lines.append(f"  {'node':<34} {'collective':<20} "
                         f"{'g':>3} {'bytes/pos':>12}")
            for row in self.per_node():
                kinds = ", ".join(f"{k}x{n}" if n > 1 else k
                                  for k, n in sorted(row["kinds"].items()))
                g = max((c["group_size"] for c in self.collectives
                         if (c.get("node") or "<unattributed>")
                         == row["node"]), default=1)
                lines.append(f"  {row['node']:<34} {kinds:<20} "
                             f"{g:>3} "
                             f"{_fmt_bytes(row['bytes_moved']):>12}")
        for f in self.findings:
            lines.append(f"  finding: {f}")
        return "\n".join(lines)

    __repr__ = __str__


# -- the dry group --------------------------------------------------------


class _DryDist:
    """``torch.distributed`` for the dry runner: every call leaves its
    output buffers as they were allocated (``meta`` tensors: shapes
    only)."""

    ReduceOp = None  # filled at first use (torch.distributed import)

    @staticmethod
    def get_backend(group) -> str:
        return "dry"

    @staticmethod
    def _noop(*args, **kwargs) -> None:
        return None

    all_reduce = all_gather = all_to_all_single = broadcast = \
        reduce_scatter = _noop


def _dry_runner_cls():
    from ..parallel.collectives import GroupRunner

    class DryRunner(GroupRunner):
        """A group runner whose calls move nothing (the audit's)."""

        def __init__(self, mesh, track: bool = False):
            import torch.distributed as dist

            _DryDist.ReduceOp = dist.ReduceOp
            self.mesh = mesh
            self.dist = _DryDist
            self.backend = "dry"
            self._anchor = None

    return DryRunner


class _DryGroup:
    """The process group of the audit's dry mesh: none, and a runner
    class whose collectives move nothing."""

    __slots__ = ("runner_cls",)

    def __init__(self):
        self.runner_cls = _dry_runner_cls()


def dry_mesh(mesh: Any) -> Any:
    """A group mesh of ``mesh``'s shape on the ``meta`` device, at
    ``mesh``'s coordinates on a group (position (0, 0) of a logical
    mesh), whose collectives move nothing."""
    from ..parallel import mesh as mesh_mod

    nx, ny = mesh.shape[mesh_mod.AXIS_ROW], mesh.shape[mesh_mod.AXIS_COL]
    dm = mesh_mod.Mesh((nx, ny), torch.device("meta"), ids=mesh.ids)
    dm.group = _DryGroup()
    dm.coords = dict(mesh.coords)
    dm.rank = mesh.rank
    i, j = dm.coords[mesh_mod.AXIS_ROW], dm.coords[mesh_mod.AXIS_COL]
    lines = {mesh_mod.AXIS_ROW: [a * ny + j for a in range(nx)],
             mesh_mod.AXIS_COL: [i * ny + b for b in range(ny)]}
    for axis, members in lines.items():
        dm._axis_groups[axis] = (dm.group if len(members) > 1 else None,
                                 members)
    dm.runner = dm.group.runner_cls(dm)
    return dm


class _Recorder:
    """The tap the dry walk installs in ``obs.metrics``: each collective
    and whole-array gather of the walk, with the node being lowered."""

    def __init__(self, env: Any, root: Any):
        self.env = env
        self.root = root
        self.calls: List[Tuple[str, int, int, Any]] = []
        self.gathers: List[Tuple[str, int, Any]] = []

    def _node(self) -> Any:
        nodes = self.env.nodes
        return nodes[-1] if nodes else self.root

    def collective(self, op: str, nbytes: int, group: int) -> None:
        self.calls.append((op, nbytes, group, self._node()))

    def materialize(self, site: str, nbytes: int) -> None:
        self.gathers.append((site, nbytes, self._node()))


def _plan_leaves(plan: Any) -> Dict[int, Any]:
    from ..expr.optimize import dag_nodes

    ids = set(plan.leaf_ids)
    return {n._id: n for n in dag_nodes(plan.dag) if n._id in ids}


def _dry_leaf(leaf: Any, dm: Any) -> Any:
    from ..array.distarray import DistArray
    from ..expr import base

    if isinstance(leaf, base.ScalarExpr):
        return base.local_scalar(torch.tensor(leaf.pyvalue,
                                              dtype=leaf.tdtype), dm)
    arr = base._leaf_array(leaf)
    if arr is None:
        raise TypeError(f"unknown leaf {leaf!r}")
    blk = torch.empty(arr.tiling.block_extent(arr.shape, dm).shape,
                      dtype=dtypes.to_torch(arr.dtype), device="meta")
    return DistArray.from_local(blk, arr.tiling, arr.shape, dm)


def dry_walk(plan: Any, mesh: Any) -> _Recorder:
    """Walk ``plan`` over the dry group mesh of ``mesh``'s shape (its
    output relayouts included, as ``expr/base.py::_run`` does) and
    return the recorder of its collectives."""
    from ..expr import base
    from ..kernels import build as kbuild
    from ..parallel import mesh as mesh_mod
    from ..parallel import redistribute as redist_mod

    dm = dry_mesh(mesh)
    leaves = _plan_leaves(plan)
    env = base.GroupEnv(dm, ((lid, _dry_leaf(leaves[lid], dm))
                             for lid in plan.leaf_ids))
    env.nodes = []
    rec = _Recorder(env, plan.dag)
    prev, shapes = TAP.rec, kbuild.SHAPES_ONLY.on
    TAP.rec, kbuild.SHAPES_ONLY.on = rec, True
    try:
        with torch.no_grad(), mesh_mod.use_mesh(dm):
            out = plan.dag.lower_local(env)
            outs = out if plan.is_tuple else (out,)
            for o, t in zip(outs, plan.out_tilings):
                redist_mod.relayout(o, t)
    finally:
        TAP.rec, kbuild.SHAPES_ONLY.on = prev, shapes
    return rec


# -- the audit ------------------------------------------------------------


def _label(n: Any) -> str:
    from ..obs.explain import _label as label

    return label(n)


def _site(n: Any) -> Optional[str]:
    from ..obs.explain import _site_str

    return _site_str(getattr(n, "_site", None))


def _collectives(rec: _Recorder, report: Dict[str, Any]
                 ) -> List[Dict[str, Any]]:
    digest_of = {v.get("node"): k for k, v in
                 (report.get("scope_digests") or {}).items()
                 if isinstance(v, dict)}
    out = []
    for op, nbytes, group, node in rec.calls:
        kind = hlo.KIND.get(op, op)
        label = _label(node)
        cop = hlo.CollectiveOp(kind, hlo.result_bytes(kind, nbytes, group),
                               float(nbytes), group, digest_of.get(label),
                               op, _site(node))
        d = cop.to_dict()
        d["node"] = label
        out.append(d)
    return out


def _storage_shared(arr: Any) -> bool:
    """True when another live tensor shares the storage of ``arr``'s
    tensor (freeing ``arr`` would release nothing)."""
    t = arr._local
    if t is None or t.device.type == "meta":
        return False
    use = getattr(torch._C, "_storage_Use_Count", None)
    if use is None:
        return False
    # the tensor itself and the temporary storage handle read here
    return int(use(t.untyped_storage()._cdata)) > 2


def _donation(plan: Any, donated: Sequence[Any]
              ) -> Tuple[Dict[str, Any], List[AuditFinding]]:
    from ..expr import base

    pos_of = {}
    leaves = _plan_leaves(plan)
    for j, lid in enumerate(plan.leaf_ids):
        arr = base._leaf_array(leaves[lid])
        if arr is not None:
            pos_of.setdefault(id(arr), j)
    requested: List[int] = []
    freed: List[int] = []
    findings: List[AuditFinding] = []
    for d in donated:
        j = pos_of.get(id(d))
        if j is None:
            findings.append(AuditFinding(
                "warning", "missed_donation",
                f"a donated array of shape {d.shape} is not a leaf of "
                "the built plan: the walk never reads it, so nothing "
                "frees it"))
            continue
        requested.append(j)
        if _storage_shared(d):
            findings.append(AuditFinding(
                "warning", "missed_donation",
                f"argument {j} was donated but another live tensor "
                "shares its storage: freeing it after the walk "
                "releases nothing", _label(leaves[plan.leaf_ids[j]])))
        else:
            freed.append(j)
    return {"requested": requested, "aliased": freed}, findings


def _count_metrics(audit: PlanAudit) -> None:
    if not METRICS_FLAG._value:
        return
    REGISTRY.counter(
        "audit_runs", "plan audits executed (dry group walk; miss path "
        "or st.audit_plan only)").inc()
    REGISTRY.counter(
        "audit_collectives",
        "collective calls seen by plan audits").inc(
        len(audit.collectives))
    if audit.findings:
        REGISTRY.counter(
            "audit_findings",
            "plan-audit findings (full_gather / "
            "replicated_intermediate / missed_donation)").inc(
            len(audit.findings))
    REGISTRY.gauge(
        "audit_last_comm_bytes",
        "modeled per-position wire bytes of the last audited "
        "plan").set(audit.comm_bytes)


def audit_built_plan(plan: Any, mesh: Any = None,
                     donated: Sequence[Any] = (),
                     force: bool = False) -> PlanAudit:
    """Audit an already-built ``_Plan``. The no-donation verdict is
    memoized on ``plan.report["audit"]`` (and rides the persist store),
    so a repeat audit is a dict read. ``donated``: the DistArrays the
    caller would donate (checked fresh each time)."""
    from ..parallel import mesh as mesh_mod

    report = plan.report if plan is not None else None
    if report is None:
        return PlanAudit([], [])
    cached = report.get("audit")
    if cached is not None and not donated and not force:
        if METRICS_FLAG._value:
            REGISTRY.counter(
                "audit_cached",
                "plan audits served from the memoized (or "
                "persist-restored) verdict without a walk").inc()
        return PlanAudit.from_dict(cached)
    if mesh is None:
        mesh = mesh_mod.get_mesh()
    rec = dry_walk(plan, mesh)
    collectives = _collectives(rec, report)

    findings: List[AuditFinding] = []
    for site, nbytes, node in rec.gathers:
        findings.append(AuditFinding(
            "warning", "full_gather",
            f"the group walk gathers the whole array (~{int(nbytes)} "
            f"bytes) onto every position for {site}, which has no local "
            "rule: the tiling buys nothing here",
            _label(node), _site(node), float(nbytes)))
    warn_bytes = _REPLICATION_WARN_FLAG._value
    if warn_bytes:
        for c in collectives:
            full = c["result_bytes"]
            if c["kind"] == "all-gather" and full > warn_bytes:
                findings.append(AuditFinding(
                    "warning", "replicated_intermediate",
                    f"all-gather result of ~{int(full)} bytes exceeds "
                    f"FLAGS.replication_warn_bytes ({warn_bytes}); every "
                    "position holds a full replica of this intermediate",
                    c.get("node"), c.get("source"), full))
    donation, missed = _donation(plan, donated)
    audit = PlanAudit(collectives, findings + missed, donation)
    _count_metrics(audit)
    if not donated:
        report["audit"] = audit.to_dict()
    return audit


def audit_on_miss(plan: Any, mesh: Any) -> None:
    """The ``FLAGS.verify_evaluate`` miss-path hook (``expr/base.py::
    evaluate``). Advisory: findings are logged and counted, never
    raised; a persist-restored verdict (``report["audit"]``) is read,
    not re-walked."""
    try:
        audit = audit_built_plan(plan, mesh)
    except Exception as e:  # noqa: BLE001 - the audit must never make
        # evaluate() less available than it is with the flag off
        log_warn("plan audit failed (%s: %s); continuing without a "
                 "verdict", type(e).__name__, str(e)[:200])
        return
    for f in audit.findings:
        log_warn("plan audit: %s", f)


def audit_plan(expr: Any, donate: Sequence[Any] = (),
               mesh: Any = None) -> PlanAudit:
    """Audit the plan an expression would evaluate with
    (``st.audit_plan``): sign the raw DAG, reuse the cached plan on a
    hit, build (and cache) it on a miss, without running it. ``donate``
    takes the DistArrays ``evaluate(donate=...)`` would."""
    from ..expr import base
    from ..parallel import mesh as mesh_mod

    if mesh is None:
        mesh = mesh_mod.get_mesh()
    root = base.as_expr(expr)
    plan_key, rctx = base.plan_signature(root, mesh)
    plan = base.lookup_plan(plan_key)
    if plan is None:
        plan, _dag, _leaves = base._build_plan(root, mesh, rctx, plan_key)
        stored = base.lookup_plan(plan_key)
        if stored is not None:
            plan = stored
            # the tiling DP stamps its choices on the raw nodes, so the
            # next signature of this expr may differ: store the audited
            # plan under it too, so a following explain or evaluate
            # finds the verdict
            k2, _ = base.plan_signature(root, mesh)
            if k2 != plan_key and base.lookup_plan(k2) is None:
                base.store_plan(k2, stored)
    if plan is None:
        # the optimizer collapsed the DAG onto a held result
        return PlanAudit([], [])
    return audit_built_plan(plan, mesh, base._norm_donate(donate))
