"""DAG well-formedness verifier: one traversal, nothing run (port of
``spartan_tpu/analysis/verify.py``).

Every ``Expr`` subclass encodes its shape/dtype derivation in its
constructor (``eval_shape_of`` on ``meta`` tensors, or explicit
arithmetic), and its ``replace_children`` is a pure re-construction over
new children. The verifier uses that: rebuilding a node over its OWN
children re-derives shape and dtype from scratch, so any divergence
between the declared ``_shape``/``_dtype`` and what the children imply —
a corrupted rewrite, a broken fusion, a stale axis — surfaces as a
mismatch, and an illegal node (bad broadcast, out-of-range axis, wrong
``replace_children`` arity) surfaces as a constructor error. Violations
carry the user build site recorded at construction (``Expr._site``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..expr.base import Expr, ExprError


class VerificationError(ExprError):
    """Static verification failed; the message lists every violation
    with node provenance."""


class Violation:
    """One well-formedness violation, attributed to a node."""

    __slots__ = ("kind", "message", "node_repr", "site")

    def __init__(self, kind: str, message: str,
                 node: Optional[Expr] = None):
        self.kind = kind
        self.message = message
        self.node_repr = repr(node) if node is not None else ""
        self.site = getattr(node, "_site", None)

    def __str__(self) -> str:
        loc = (f" [built at {self.site[0]}:{self.site[1]} "
               f"(in {self.site[2]})]" if self.site else "")
        on = f" on {self.node_repr}" if self.node_repr else ""
        return f"{self.kind}: {self.message}{on}{loc}"

    __repr__ = __str__


class _ProbeCtx:
    """Minimal signing context: exercises ONE node's ``_sig`` without
    recursing into children (``of`` returns an opaque placeholder)."""

    def leaf_pos(self, leaf: Expr) -> int:
        return 0

    def of(self, node: Expr) -> Tuple:
        return ("probe", node._id)


def walk(root: Expr) -> Tuple[List[Expr], Optional[Expr]]:
    """Post-order node list plus the first back-edge target if the
    'DAG' is cyclic (cycle-safe: never loops forever)."""
    VISITING, DONE = 1, 2
    order: List[Expr] = []
    cycle: Optional[Expr] = None
    state: Dict[int, int] = {}
    stack: List[Tuple[Expr, Optional[Iterator]]] = [(root, None)]
    while stack:
        node, it = stack.pop()
        if it is None:
            if state.get(node._id) is not None:
                continue
            state[node._id] = VISITING
            try:
                kids: Tuple = tuple(node.children())
            except Exception:
                kids = ()  # reported per-node by verify_node
            it = iter(kids)
        descended = False
        for k in it:
            if not isinstance(k, Expr):
                continue  # reported per-node by verify_node
            st = state.get(k._id)
            if st == VISITING:
                if cycle is None:
                    cycle = k
                continue
            if st == DONE:
                continue
            stack.append((node, it))
            stack.append((k, None))
            descended = True
            break
        if not descended:
            state[node._id] = DONE
            order.append(node)
    return order, cycle


def _derived_slice_shape(node: Expr) -> Tuple[int, ...]:
    """SliceExpr threads its declared shape through replace_children, so
    re-derive it independently with the index rule ``expr/slice.py``
    applies when it builds the node."""
    from ..expr.slice import _normalize_index

    return tuple(_normalize_index(tuple(node.index), node.input.shape)[1])


def verify_node(node: Expr) -> List[Violation]:
    """Well-formedness checks for ONE node (children assumed checked)."""
    from ..expr.reduce import GeneralReduceExpr, ReduceExpr
    from ..expr.reshape import TransposeExpr
    from ..expr.slice import SliceExpr

    vios: List[Violation] = []

    # declared metadata sanity
    if not all(isinstance(s, int) and s >= 0 for s in node._shape):
        vios.append(Violation(
            "bad_shape", f"declared shape {node._shape!r} is not a tuple "
            "of non-negative ints", node))
    if not isinstance(node._dtype, np.dtype):
        vios.append(Violation(
            "bad_dtype", f"declared dtype {node._dtype!r} is not a "
            "numpy dtype", node))

    # children must be Exprs
    try:
        kids = tuple(node.children())
    except Exception as e:
        vios.append(Violation(
            "children_error",
            f"children() raised {type(e).__name__}: {e}", node))
        return vios
    for i, k in enumerate(kids):
        if not isinstance(k, Expr):
            vios.append(Violation(
                "bad_child",
                f"child {i} is {type(k).__name__}, not an Expr", node))
            return vios

    # every node must sign (the plan cache keys on it)
    try:
        sig = node._sig(_ProbeCtx())
        if not isinstance(sig, tuple):
            vios.append(Violation(
                "bad_sig", f"_sig returned {type(sig).__name__}, "
                "expected a tuple", node))
    except NotImplementedError:
        vios.append(Violation(
            "missing_sig",
            f"{type(node).__name__} does not implement _sig", node))
    except Exception as e:
        vios.append(Violation(
            "sig_error", f"_sig raised {type(e).__name__}: {e}", node))

    # forced tiling (smart-tiling output) must match the node's rank
    ft = node._forced_tiling
    if ft is not None and ft.ndim != node.ndim:
        vios.append(Violation(
            "forced_tiling_rank",
            f"_forced_tiling rank {ft.ndim} != node rank {node.ndim}",
            node))

    # axis-bounds checks that reconstruction alone cannot catch
    # (constructors normalize axes modulo ndim, masking corruption)
    if isinstance(node, (ReduceExpr, GeneralReduceExpr)):
        nd = (len(node._pre_shape) if isinstance(node, ReduceExpr)
              else node.input.ndim)
        if node.axis is not None and not all(
                0 <= a < max(nd, 1) for a in node.axis):
            vios.append(Violation(
                "bad_axis", f"reduction axis {node.axis} out of bounds "
                f"for rank-{nd} operand", node))
    if isinstance(node, TransposeExpr):
        if tuple(sorted(node.perm)) != tuple(range(node.input.ndim)):
            vios.append(Violation(
                "bad_axis", f"transpose perm {node.perm} is not a "
                f"permutation of rank {node.input.ndim}", node))

    # re-derive shape/dtype by rebuilding the node over its own
    # children; the constructor is the derivation rule, so divergence
    # means the declared metadata no longer matches the children
    try:
        clone = node.replace_children(kids)
    except NotImplementedError:
        vios.append(Violation(
            "missing_replace_children",
            f"{type(node).__name__} does not implement "
            "replace_children", node))
        return vios
    except Exception as e:
        vios.append(Violation(
            "rebuild_failed",
            "reconstructing this node over its own children raised "
            f"{type(e).__name__}: {e} (illegal broadcast / axis / "
            "operand combination)", node))
        return vios
    if clone is not node:
        if tuple(clone.shape) != tuple(node.shape):
            vios.append(Violation(
                "shape_mismatch",
                f"declared shape {node.shape} != shape {clone.shape} "
                "derived from children", node))
        if np.dtype(clone.dtype) != np.dtype(node.dtype):
            vios.append(Violation(
                "dtype_mismatch",
                f"declared dtype {node.dtype} != dtype {clone.dtype} "
                "derived from children", node))
        try:
            if len(tuple(clone.children())) != len(kids):
                vios.append(Violation(
                    "arity_mismatch",
                    "replace_children changed the child count "
                    f"({len(kids)} -> {len(tuple(clone.children()))})",
                    node))
        except Exception:
            pass  # clone children_error would re-report the same root cause
    if isinstance(node, SliceExpr):
        # declared shape is threaded through replace_children; derive
        # it independently from the index
        try:
            derived = _derived_slice_shape(node)
        except Exception as e:
            vios.append(Violation(
                "bad_axis", f"slice index {node.index!r} is illegal for "
                f"input shape {node.input.shape}: {e}", node))
        else:
            if derived != tuple(node.shape):
                vios.append(Violation(
                    "shape_mismatch",
                    f"declared shape {node.shape} != shape {derived} "
                    "derived from the slice index", node))
    return vios


def verify_dag(root: Expr) -> List[Violation]:
    """Verify a whole DAG; returns ALL violations (empty = well-formed).

    Acyclicity is checked first — a cyclic graph is reported as one
    ``cycle`` violation and not traversed further (per-node checks
    could recurse forever through the back edge)."""
    order, cycle = walk(root)
    if cycle is not None:
        return [Violation(
            "cycle", "expression graph contains a cycle (a node is "
            "reachable from itself); evaluation would never terminate",
            cycle)]
    vios: List[Violation] = []
    for node in order:
        vios.extend(verify_node(node))
    return vios
