"""Smart-tiling pass: choose tilings via the cost model (port of
``spartan_tpu/expr/tiling_pass.py``).

Builds the candidate table and runs the DP of ``tiling_cost.py``,
writing ``_forced_tiling`` / ``_dot_plan`` on the DAG's nodes. It runs
only on plan-cache misses: ``evaluate`` keys the complete plan, these
choices included, on the raw DAG's signature, so iterative applications
run the cost model once per structure, not once per step. Under
``FLAGS.verify_passes`` the tilings it wrote are linted
(``analysis/lints.forced_tiling_findings``) and each warning-level
finding is raised as a ``LintWarning`` warning.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from .base import Expr
from .optimize import Pass, dag_nodes, register_pass

# the persist store's seam (persist/__init__.py), set by
# expr/base._build_plan around one optimize(): ``restore`` holds an
# entry whose decisions this pass stamps instead of running its DP,
# ``capture`` asks it to record the structure and its decisions
# (``last``), ``outcome`` says what happened to the entry
_TLS = threading.local()


def structure(root: Expr) -> List[Any]:
    """The structural signature of the DAG the DP plans: each node's
    type, shape, dtype, pinned tiling and children (by post-order
    position), in post-order. JSON-clean."""
    from ..persist.store import axes_to_json

    nodes = dag_nodes(root)
    pos = {n._id: i for i, n in enumerate(nodes)}
    return [[type(n).__name__, list(n.shape), str(n.dtype),
             (axes_to_json(n._forced_tiling.axes)
              if n._forced_tiling is not None else None),
             [pos[c._id] for c in n.children()]] for n in nodes]


def decisions(root: Expr) -> List[Any]:
    """The DP's decisions per node, in post-order: the committed tiling,
    the GEMM plan (output grid and strategy axis) and the cost estimate
    (JSON-clean)."""
    from ..persist.store import axes_to_json

    out = []
    for n in dag_nodes(root):
        plan = getattr(n, "_dot_plan", None)
        out.append([
            (axes_to_json(n._forced_tiling.axes)
             if n._forced_tiling is not None else None),
            ([axes_to_json(plan[0].axes), plan[1]]
             if plan is not None else None),
            getattr(n, "_plan_cost", None)])
    return out


def _stamp(root: Expr, recs: List[Any]) -> None:
    """Write stored decisions onto the DAG's nodes (post-order)."""
    from ..array.tiling import Tiling

    def axes(a):
        return Tiling(tuple(tuple(x) if isinstance(x, list) else x
                            for x in a))

    for n, (forced, plan, cost) in zip(dag_nodes(root), recs):
        if forced is not None:
            n._forced_tiling = axes(forced)
        if plan is not None:
            n._dot_plan = (axes(plan[0]), plan[1])
        if cost is not None:
            n._plan_cost = cost


def begin(entry: Any, capture: bool) -> None:
    _TLS.restore = entry
    _TLS.capture = capture
    _TLS.outcome = None
    _TLS.last = None


def end() -> Dict[str, Any]:
    """The pass's record of this optimize(): ``outcome`` ("restored",
    "meta_mismatch" or None) and ``last`` (structure and decisions when
    captured)."""
    out = {"outcome": getattr(_TLS, "outcome", None),
           "last": getattr(_TLS, "last", None)}
    _TLS.restore = None
    _TLS.capture = False
    _TLS.outcome = None
    _TLS.last = None
    return out


class SmartTilingPass(Pass):
    name = "auto_tiling"
    flag = "opt_auto_tiling"

    def run(self, root: Expr) -> Expr:
        from ..utils import profiling as prof
        from ..utils.config import FLAGS
        from . import tiling_cost

        entry = getattr(_TLS, "restore", None)
        capture = getattr(_TLS, "capture", False)
        shape: Optional[List[Any]] = None
        if entry is not None or capture:
            shape = structure(root)
        if entry is not None:
            if entry.meta.get("structure") == shape:
                # a persisted plan of this structure: its decisions, no DP
                with prof.phase("tiling"):
                    _stamp(root, entry.meta["decisions"])
                _TLS.outcome = "restored"
                if capture:
                    _TLS.last = {"structure": shape,
                                 "decisions": entry.meta["decisions"]}
                return root
            _TLS.outcome = "meta_mismatch"
        # a "tiling" sub-span (nested under "pass:auto_tiling" in the
        # trace ring): the candidate table and DP are the dominant
        # per-miss planning cost
        with prof.phase("tiling"):
            root = tiling_cost.assign_tilings(root)
        if capture:
            _TLS.last = {"structure": shape, "decisions": decisions(root)}
        if FLAGS.verify_passes:
            # forced tilings the mesh/shape cannot honor are reshards or
            # uneven shards the plan did not price: warn at plan time
            import warnings

            from ..analysis.lints import LintWarning, forced_tiling_findings

            for f in forced_tiling_findings(root):
                if f.severity == "warning":
                    warnings.warn(str(f), LintWarning, stacklevel=2)
        return root


register_pass(SmartTilingPass())
