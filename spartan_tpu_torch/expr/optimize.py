"""Optimizer passes over the expr DAG (port of
``spartan_tpu/expr/optimize.py``): cached-expr collapsing, map fusion,
reduce-map fusion and the smart-tiling pass (``tiling_pass.py``,
registered on first use), each behind its FLAGS toggle. Smart tiling
commits the JAX package's tilings and contraction plans: on a logical
mesh those are metadata over one tensor, so the pass changes no value;
on a group mesh they are the layouts the ranks' blocks move to.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..array.distarray import DistArray
from ..utils import profiling as prof
from ..utils.config import FLAGS
from .base import Expr, ValExpr
from .local import LocalExpr, LocalInput
from .map import MapExpr
from .reduce import ReduceExpr


def rewrite(root: Expr, visit: Callable[[Expr, Tuple[Expr, ...]], Expr]
            ) -> Expr:
    """Bottom-up DAG rewrite preserving sharing (memoized by node id)."""
    memo: Dict[int, Expr] = {}

    def go(n: Expr) -> Expr:
        if n._id in memo:
            return memo[n._id]
        new_kids = tuple(go(k) for k in n.children())
        out = visit(n, new_kids)
        memo[n._id] = out
        return out

    return go(root)


def default_visit(n: Expr, new_kids: Tuple[Expr, ...]) -> Expr:
    # identity comparison: Expr overloads __eq__ to build lazy MapExprs
    old_kids = n.children()
    if len(new_kids) == len(old_kids) and all(
            a is b for a, b in zip(new_kids, old_kids)):
        return n
    return n.replace_children(new_kids)


class Pass:
    name = "base"
    flag = ""
    # the pass checker's invariant (analysis/passes.py, under
    # FLAGS.verify_passes): a pass that prunes sub-DAGs, and with them
    # their leaves, opts out of strict leaf preservation
    preserves_leaves = True

    def enabled(self) -> bool:
        return not self.flag or getattr(FLAGS, self.flag)

    def run(self, root: Expr) -> Expr:
        raise NotImplementedError


class CollapseCachedPass(Pass):
    """Replace already-evaluated sub-DAGs with Val leaves: iterative
    applications re-use prior results without re-walking their history."""

    name = "collapse_cached"
    flag = "opt_collapse_cached"
    # collapsing a cached node prunes its whole sub-DAG: the leaves
    # below it disappear into the substituted Val leaf
    preserves_leaves = False

    def run(self, root: Expr) -> Expr:
        def visit(n: Expr, kids: Tuple[Expr, ...]) -> Expr:
            if (isinstance(n._result, DistArray)
                    and not isinstance(n, ValExpr)):
                return ValExpr(n._result)
            return default_visit(n, kids)

        return rewrite(root, visit)


def _splice(inputs: Tuple[Expr, ...]
            ) -> Tuple[List[Expr], Dict[int, LocalExpr]]:
    """Inline unevaluated MapExpr producers: the new input list and the
    mapping from each old input slot to its local tree."""
    new_inputs: List[Expr] = []
    pos: Dict[int, int] = {}

    def input_slot(e: Expr) -> int:
        if e._id not in pos:
            pos[e._id] = len(new_inputs)
            new_inputs.append(e)
        return pos[e._id]

    mapping: Dict[int, LocalExpr] = {}
    for i, c in enumerate(inputs):
        if isinstance(c, MapExpr) and c._result is None:
            sub: Dict[int, LocalExpr] = {
                j: LocalInput(input_slot(sc)) for j, sc in enumerate(c.inputs)}
            mapping[i] = c.op.remap(sub)
        else:
            mapping[i] = LocalInput(input_slot(c))
    return new_inputs, mapping


def _has_map_producer(inputs: Tuple[Expr, ...]) -> bool:
    return any(isinstance(c, MapExpr) and c._result is None for c in inputs)


class MapFusionPass(Pass):
    """Fold MapExpr children into their MapExpr parents: ``(a+b)*c``
    becomes one LocalExpr tree."""

    name = "map_fusion"
    flag = "opt_map_fusion"

    def run(self, root: Expr) -> Expr:
        def visit(n: Expr, kids: Tuple[Expr, ...]) -> Expr:
            n = default_visit(n, kids)
            if not isinstance(n, MapExpr) or not _has_map_producer(n.inputs):
                return n
            new_inputs, mapping = _splice(n.inputs)
            return MapExpr(new_inputs, n.op.remap(mapping))

        return rewrite(root, visit)


class ReduceFusionPass(Pass):
    """Fold MapExpr producers into the reduction's pre-reduce tree:
    ``(a*b).sum()`` becomes one fused ReduceExpr node."""

    name = "reduce_fusion"
    flag = "opt_reduce_fusion"

    def run(self, root: Expr) -> Expr:
        def visit(n: Expr, kids: Tuple[Expr, ...]) -> Expr:
            n = default_visit(n, kids)
            if (not isinstance(n, ReduceExpr)
                    or not _has_map_producer(n.inputs)):
                return n
            new_inputs, mapping = _splice(n.inputs)
            return n.with_fused(new_inputs, n.pre.remap(mapping))

        return rewrite(root, visit)


_PASSES: List[Pass] = []


def register_pass(p: Pass) -> None:
    _PASSES.append(p)


register_pass(CollapseCachedPass())
register_pass(MapFusionPass())
register_pass(ReduceFusionPass())

_tiling_pass_loaded = False


def _ensure_tiling_pass() -> None:
    """Import ``tiling_pass`` (it registers itself) once; a flag read
    after that, since the plan key reads the pass list per evaluate."""
    global _tiling_pass_loaded
    if _tiling_pass_loaded:
        return
    from . import tiling_pass  # noqa: F401  (self-registers on import)
    _tiling_pass_loaded = True


def optimize(root: Expr, report: Optional[List[Dict]] = None) -> Expr:
    """Run the enabled pass stack. Only plan-cache misses reach this.
    Each pass runs in a ``pass:<name>`` phase (span and histogram).

    ``report``: optional list; one dict per enabled pass is appended
    (``name`` / ``nodes_before`` / ``nodes_after`` / ``seconds``), the
    JAX package's per-pass record.

    With ``FLAGS.verify_passes`` every pass is bracketed by the
    invariant checker (``analysis/passes.py``) in a ``verify`` phase:
    shape/dtype/leaf preservation and DAG well-formedness, a failure
    naming the offending pass."""
    _ensure_tiling_pass()
    verify = FLAGS.verify_passes
    snap = None
    if verify:
        from ..analysis import passes as checkmod

        with prof.phase("verify"):
            snap = checkmod.snapshot(root)
    for p in _PASSES:
        if p.enabled():
            before = len(dag_nodes(root)) if report is not None else 0
            with prof.phase("pass:" + p.name) as psp:
                new_root = p.run(root)
            if report is not None:
                report.append({"name": p.name, "nodes_before": before,
                               "nodes_after": len(dag_nodes(new_root)),
                               "seconds": psp.seconds})
            if verify:
                with prof.phase("verify"):
                    snap = checkmod.check_pass(p, snap, new_root)
            root = new_root
    return root


def dag_nodes(root: Expr) -> List[Expr]:
    """All nodes, post-order, deduped (for optimizer tests)."""
    out: List[Expr] = []
    seen = set()

    def go(n: Expr) -> None:
        if n._id in seen:
            return
        seen.add(n._id)
        for k in n.children():
            go(k)
        out.append(n)

    go(root)
    return out
