"""Optimizer-pass invariant checking (port of
``spartan_tpu/analysis/passes.py``; ``FLAGS.verify_passes``, env
``SPARTAN_TPU_TORCH_VERIFY_PASSES``).

``optimize()`` (expr/optimize.py) calls in here when the flag is on:
the DAG is snapshotted before the pass stack and re-checked after every
registered ``Pass``. A pass must

* preserve the root's shape and dtype (rewrites change the walk, never
  the value computed),
* keep the graph acyclic and well-formed (the full
  :func:`~spartan_tpu_torch.analysis.verify.verify_dag` battery),
* introduce no leaf without a pre-pass counterpart — a new leaf must be
  a ``ValExpr`` wrapping data that already existed in the DAG (a leaf's
  array, or a node's cached ``_result`` — the collapse rewrite), never
  invented data,
* drop no leaf, unless the pass declares ``preserves_leaves = False``
  (``CollapseCachedPass`` prunes entire sub-DAGs below a cached node).

Failures raise :class:`PassInvariantError` naming the offending pass and
node. The checks run only on plan-cache misses, where the optimizer
itself runs, so a steady-state evaluate pays nothing.
"""

from __future__ import annotations

from typing import Any, List, Set

import numpy as np

from ..expr.base import Expr, ExprError, ScalarExpr, ValExpr
from .verify import verify_dag, walk


class PassInvariantError(ExprError):
    """An optimizer pass violated a structural invariant; the message
    names the pass and the offending node."""


class _Snapshot:
    __slots__ = ("shape", "dtype", "leaves", "leaf_ids", "leaf_data_ids",
                 "data_ids", "scalar_values")

    def __init__(self, shape, dtype, leaves: List[Expr],
                 leaf_ids: Set[int], leaf_data_ids: Set[int],
                 data_ids: Set[int], scalar_values: List[Any]):
        self.shape = shape
        self.dtype = dtype
        self.leaves = leaves
        self.leaf_ids = leaf_ids
        self.leaf_data_ids = leaf_data_ids
        self.data_ids = data_ids
        self.scalar_values = scalar_values


def _leaf_data_id(leaf: Expr) -> Any:
    from ..array.distarray import DistArray

    if isinstance(leaf, ValExpr):
        return id(leaf.value)
    if isinstance(leaf._result, DistArray):
        return id(leaf._result)
    return None


def snapshot(root: Expr, context: str = "input DAG") -> _Snapshot:
    """Capture the invariant-relevant state of a DAG: root shape/dtype,
    the leaf set (by object identity AND by backing-array identity), and
    every DistArray reachable as a cached result (legal collapse
    substitutes)."""
    from ..array.distarray import DistArray

    nodes, cycle = walk(root)
    if cycle is not None:
        raise PassInvariantError(f"{context} contains a cycle at {cycle!r}")
    leaves = [n for n in nodes if not n.children()]
    leaf_ids = {id(n) for n in leaves}
    leaf_data_ids = set()
    for n in leaves:
        d = _leaf_data_id(n)
        if d is not None:
            leaf_data_ids.add(d)
    data_ids = set(leaf_data_ids)
    for n in nodes:
        if isinstance(n._result, DistArray):
            data_ids.add(id(n._result))
    scalar_values = [n.pyvalue for n in leaves if isinstance(n, ScalarExpr)]
    return _Snapshot(tuple(root.shape), root.dtype, leaves, leaf_ids,
                     leaf_data_ids, data_ids, scalar_values)


def check_pass(p: Any, pre: _Snapshot, post_root: Expr) -> _Snapshot:
    """Assert the pass invariants over ``post_root`` against the pre-pass
    snapshot; returns the post snapshot (the next pass's ``pre``).
    Raises :class:`PassInvariantError` naming ``p``."""
    name = getattr(p, "name", type(p).__name__)

    post = snapshot(post_root, context=f"DAG after pass '{name}'")

    if post.shape != pre.shape:
        raise PassInvariantError(
            f"pass '{name}' changed the root shape: {pre.shape} -> "
            f"{post.shape} (rewrites must preserve the computed value)")
    if np.dtype(post.dtype) != np.dtype(pre.dtype):
        raise PassInvariantError(
            f"pass '{name}' changed the root dtype: {pre.dtype} -> "
            f"{post.dtype}")

    # no invented data: every post leaf must trace back to the pre DAG
    for leaf in post.leaves:
        if id(leaf) in pre.leaf_ids:
            continue
        d = _leaf_data_id(leaf)
        if d is not None and d in pre.data_ids:
            continue  # ValExpr over a pre-existing array / cached result
        if isinstance(leaf, ScalarExpr) and any(
                type(v) is type(leaf.pyvalue) and v == leaf.pyvalue
                for v in pre.scalar_values):
            continue  # re-wrapped scalar constant: same value, ok
        raise PassInvariantError(
            f"pass '{name}' introduced leaf {leaf!r} with no pre-pass "
            "counterpart (neither a prior leaf, a cached result, nor "
            "an existing scalar constant)")

    # no dropped inputs (unless the pass legitimately prunes, like the
    # cached-collapse rewrite)
    if getattr(p, "preserves_leaves", True):
        post_ids = {id(n) for n in post.leaves}
        for leaf in pre.leaves:
            if id(leaf) in post_ids:
                continue
            d = _leaf_data_id(leaf)
            if d is not None and d in post.leaf_data_ids:
                continue
            raise PassInvariantError(
                f"pass '{name}' dropped leaf {leaf!r}: an input the "
                "computation read before the rewrite is no longer "
                "reachable (semantics changed)")

    vios = verify_dag(post_root)
    if vios:
        raise PassInvariantError(
            f"pass '{name}' broke DAG well-formedness:\n  "
            + "\n  ".join(str(v) for v in vios))
    return post
