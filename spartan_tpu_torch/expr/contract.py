"""General two-operand tensor contraction (port of
``spartan_tpu/expr/contract.py``).

The whole two-operand contraction family -- einsum, tensordot, batched
matmul, inner -- lowers through one ``ContractExpr`` node, and an
N-operand einsum through a chain of them along ``np.einsum_path``'s
greedy order. The smart-tiling pass sets a node's ``_dot_plan`` (output
grid and contraction placement); its operand edges go through
``parallel/redistribute.constrain`` and the plan joins the signature.
On a logical mesh the node is one ``torch.einsum`` whatever the plan
(float32 products in full float32: TF32 is off,
``spartan_tpu_torch/__init__.py``). On a group mesh the plan is carried
out: the operands move to the plan's layouts, each rank contracts its
blocks, and a split contraction ends in an all-reduce over its mesh
axis. A node without a plan takes its output's tiling with the
contraction gathered.

Axis vocabulary (einsum labels):
  * batch labels -- in both operands and the output,
  * contraction labels -- in both operands, not in the output,
  * free labels -- in one operand and the output,
  * summed labels -- in one operand only.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from ..parallel import mesh as mesh_mod
from ..parallel import redistribute as redist_mod
from ..utils import dtypes
from .base import Expr

_CANON = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


class ContractExpr(Expr):
    """``einsum(a_labels, b_labels -> out_labels)`` over two operands.
    Labels are canonical single characters; ``precision`` is carried for
    the signature (float32 runs at full precision on every path)."""

    def __init__(self, a: Expr, b: Expr,
                 a_labels: Sequence[str], b_labels: Sequence[str],
                 out_labels: Sequence[str],
                 precision: Optional[str] = None):
        self.a = a
        self.b = b
        self.a_labels = tuple(a_labels)
        self.b_labels = tuple(b_labels)
        self.out_labels = tuple(out_labels)
        self.precision = precision
        self._dot_plan = None
        if len(self.a_labels) != a.ndim or len(self.b_labels) != b.ndim:
            raise ValueError("labels must cover every operand axis")
        if len(set(self.a_labels)) != len(self.a_labels) or \
                len(set(self.b_labels)) != len(self.b_labels):
            raise ValueError("repeated labels within one operand "
                             "(diagonals) are not contractions")
        dims: Dict[str, int] = {}
        for labels, op in ((self.a_labels, a), (self.b_labels, b)):
            for lab, d in zip(labels, op.shape):
                if dims.setdefault(lab, int(d)) != int(d):
                    raise ValueError(
                        f"size mismatch for label {lab!r}: "
                        f"{dims[lab]} vs {d}")
        for lab in self.out_labels:
            if lab not in dims:
                raise ValueError(f"output label {lab!r} not in operands")
        self._dims = dims
        shape = tuple(dims[lab] for lab in self.out_labels)
        super().__init__(shape, dtypes.result_type(a.dtype, b.dtype))

    @property
    def contraction_labels(self) -> Tuple[str, ...]:
        """Labels in both operands but not the output, largest dim
        first."""
        both = [lab for lab in self.a_labels
                if lab in self.b_labels and lab not in self.out_labels]
        return tuple(sorted(both, key=lambda s: (-self._dims[s], s)))

    def label_size(self, lab: str) -> int:
        return self._dims[lab]

    def flops(self) -> float:
        """2 x (product of every distinct label's size)."""
        f = 2.0
        for d in self._dims.values():
            f *= d
        return f

    def cost(self) -> Dict[str, float]:
        """:meth:`flops`; the operands read once, the output written
        once."""
        from .base import io_bytes

        return {"flops": self.flops(), "transcendentals": 0.0,
                "bytes accessed": io_bytes(self.children(), self)}

    def plan_operand_tilings(self, out_t: Tiling,
                             strategy: Optional[str]
                             ) -> Tuple[Tiling, Tiling]:
        """Operand layouts implied by an output grid + contraction
        placement: each operand axis takes the output's mesh axis for
        its label (batch/free), the strategy axis on the primary
        contraction label, and None elsewhere."""
        mesh_of = {lab: ax
                   for lab, ax in zip(self.out_labels, out_t.axes)}
        contraction = self.contraction_labels
        primary = contraction[0] if (contraction and strategy) else None

        def operand(labels: Tuple[str, ...]) -> Tiling:
            return Tiling([strategy if lab == primary else mesh_of.get(lab)
                           for lab in labels])

        return operand(self.a_labels), operand(self.b_labels)

    def children(self) -> Tuple[Expr, ...]:
        return (self.a, self.b)

    def replace_children(self, new_children) -> "ContractExpr":
        return ContractExpr(new_children[0], new_children[1],
                            self.a_labels, self.b_labels,
                            self.out_labels, self.precision)

    def _subscripts(self) -> str:
        return ("".join(self.a_labels) + "," + "".join(self.b_labels)
                + "->" + "".join(self.out_labels))

    def _lower(self, env: Dict[int, Any]) -> Any:
        av = self.a.lower(env)
        bv = self.b.lower(env)
        if self._dot_plan is not None:
            mesh = mesh_mod.get_mesh()
            ta, tb = self.plan_operand_tilings(*self._dot_plan)
            av = redist_mod.constrain(av, ta, mesh,
                                      src=self.a.out_tiling())
            bv = redist_mod.constrain(bv, tb, mesh,
                                      src=self.b.out_tiling())
        return dtypes.contract(
            functools.partial(torch.einsum, self._subscripts()), self.dtype,
            av, bv)

    def _lower_local(self, env) -> Any:
        from ..array.distarray import DistArray
        from ..parallel import collectives as coll

        if self._dot_plan is not None:
            out_t, strategy = self._dot_plan
        else:
            out_t = tiling_mod.sanitize(self.out_tiling(), self.shape,
                                        env.mesh)
            strategy = None
        used = [a for a in out_t.axes if a is not None]
        if len(set(used)) != len(used) or any(
                isinstance(a, tuple) for a in used) or strategy in used:
            return NotImplemented
        ta, tb = self.plan_operand_tilings(out_t, strategy)
        ab = redist_mod.relayout(self.a.lower_local(env), ta).local
        bb = redist_mod.relayout(self.b.lower_local(env), tb).local
        out = dtypes.contract(
            functools.partial(torch.einsum, self._subscripts()), self.dtype,
            ab, bb)
        if strategy is not None and self.contraction_labels:
            out = coll.reduce_over(out, (strategy,), "add", env.mesh)
        return DistArray.from_local(out, out_t, self.shape, env.mesh)

    def _sig(self, ctx) -> Tuple:
        plan = (None if self._dot_plan is None
                else (self._dot_plan[0].axes, self._dot_plan[1]))
        return ("contract", self._subscripts(), self.precision, plan,
                ctx.of(self.a), ctx.of(self.b))

    def _default_tiling(self) -> Tiling:
        if self.ndim >= 2:
            return tiling_mod.block(self.ndim)
        if self.ndim == 1:
            return tiling_mod.row(1)
        return Tiling(())


def contract(a: Expr, b: Expr, a_labels: Sequence[str],
             b_labels: Sequence[str], out_labels: Sequence[str],
             precision: Optional[str] = None) -> Optional[ContractExpr]:
    """Build a contraction node, or None when the spec falls outside
    the contraction family (repeated labels / size mismatches needing
    broadcast) — callers fall back to a whole-array einsum then."""
    try:
        return ContractExpr(a, b, a_labels, b_labels, out_labels,
                            precision)
    except ValueError:
        return None


def canonicalize(per_operand: Sequence[Sequence[str]],
                 out: Sequence[str]
                 ) -> Tuple[Tuple[Tuple[str, ...], ...],
                            Tuple[str, ...]]:
    """Rename arbitrary axis labels to canonical letters in first-use
    order — distinct user spellings of the same contraction share one
    plan-cache entry."""
    mapping: Dict[str, str] = {}

    def rename(lab: str) -> str:
        if lab not in mapping:
            if len(mapping) >= len(_CANON):
                raise ValueError("too many distinct contraction labels")
            mapping[lab] = _CANON[len(mapping)]
        return mapping[lab]

    ops = tuple(tuple(rename(lab) for lab in labels)
                for labels in per_operand)
    return ops, tuple(rename(lab) for lab in out)


def contract_chain(operands, per_op_labels, out_labels,
                   precision=None):
    """Decompose an N-operand einsum into a chain of pairwise
    ContractExprs along np.einsum_path's greedy contraction order (each
    a node a tiling plan can later be attached to). Returns None when the
    chain falls outside the pairwise family (single-operand
    path steps, diagonals, broadcasting), letting the caller fall back
    to the whole-array einsum. Operands must already be Exprs."""
    ops = list(operands)
    labels = [tuple(ls) for ls in per_op_labels]
    out = tuple(out_labels)
    if len(ops) < 2:
        return None
    spec = ",".join("".join(ls) for ls in labels) + "->" + "".join(out)
    try:
        # zero-copy dummies: einsum_path only reads shapes
        dummies = [np.broadcast_to(np.float32(0), o.shape) for o in ops]
        path = np.einsum_path(spec, *dummies, optimize="greedy")[0]
    except Exception:
        return None
    for step in path[1:]:  # path[0] is the 'einsum_path' marker
        if len(step) != 2:
            return None  # single-operand reduction step: whole-array path
        j, i = sorted(step, reverse=True)
        a, la = ops.pop(j), labels.pop(j)
        b, lb = ops.pop(i), labels.pop(i)
        if not ops:  # final pair: the caller's output, in order
            inter = out
        else:
            keep = set(out)
            for ls in labels:
                keep.update(ls)
            seen = []
            for lab in lb + la:
                if lab in keep and lab not in seen:
                    seen.append(lab)
            inter = tuple(seen)
        e = contract(b, a, lb, la, inter, precision=precision)
        if e is None:
            return None
        ops.append(e)
        labels.append(inter)
    return ops[0]


def parse_einsum_2op(subscripts: str, a_ndim: int, b_ndim: int
                     ) -> Optional[Tuple[Tuple[str, ...],
                                         Tuple[str, ...],
                                         Tuple[str, ...]]]:
    """Parse a two-operand einsum spec into canonical per-axis label
    tuples, expanding ellipses against the known ranks. Returns None
    for specs outside the contraction family (the caller's whole-array einsum
    fallback handles those): repeated labels in an operand, or
    ellipsis batch ranks that differ between operands or broadcast."""
    parsed = parse_einsum(subscripts, (a_ndim, b_ndim))
    if parsed is None:
        return None
    (ca, cb), co = parsed
    return ca, cb, co


def parse_einsum(subscripts: str, ndims
                 ) -> Optional[Tuple[Tuple[Tuple[str, ...], ...],
                                     Tuple[str, ...]]]:
    """Parse an N-operand einsum spec into canonical per-axis label
    tuples, expanding ellipses against the known ranks. Returns None
    for specs outside the contraction family (the caller's whole-array einsum
    fallback handles those): repeated labels within an operand, or
    ellipsis batch ranks that differ between operands (broadcast)."""
    spec = subscripts.replace(" ", "")
    if "->" in spec:
        ins, out = spec.split("->", 1)
    else:
        ins, out = spec, None
    parts = ins.split(",")
    if len(parts) != len(ndims):
        return None

    def expand(part: str, ndim: int) -> Optional[Tuple[str, ...]]:
        if "..." in part:
            head, _, tail = part.partition("...")
            n_ell = ndim - len(head) - len(tail)
            if n_ell < 0:
                return None
            ell = tuple(f"...{i}" for i in range(n_ell))
            return tuple(head) + ell + tuple(tail)
        return tuple(part) if len(part) == ndim else None

    expanded = []
    for part, nd in zip(parts, ndims):
        ls = expand(part, nd)
        if ls is None:
            return None
        expanded.append(ls)
    ell_counts = {len([x for x in ls if x.startswith("...")])
                  for ls in expanded}
    ell_counts.discard(0)
    if len(ell_counts) > 1:
        return None  # broadcasting ellipsis ranks: whole-array fallback
    n_ell = ell_counts.pop() if ell_counts else 0
    ell = tuple(f"...{i}" for i in range(n_ell))
    if out is None:
        # implicit output: ellipsis dims then once-occurring labels in
        # alphabetical order (NumPy's rule)
        counts: Dict[str, int] = {}
        for part in parts:
            for lab in part.replace(".", ""):
                counts[lab] = counts.get(lab, 0) + 1
        lo = ell + tuple(sorted(
            lab for lab, c in counts.items() if c == 1))
    else:
        if "..." in out:
            head, _, tail = out.partition("...")
            lo = tuple(head) + ell + tuple(tail)
        else:
            if ell:
                return None  # einsum would error; let torch.einsum raise it
            lo = tuple(out)
    try:
        return canonicalize(expanded, lo)
    except ValueError:
        return None  # >52 distinct labels: the whole-array fallback handles it
