"""Lazy expression DAG over DistArrays, evaluated eagerly with torch.

Port of ``spartan_tpu/expr/base.py``. The JAX package lowers the whole
optimized DAG into one traced function and jit-compiles it; here
``evaluate()`` walks the optimized DAG and runs each node's torch code
on the leaf tensors. The plan cache keeps the JAX package's shape: the
RAW DAG's structural signature keys a plan (the optimized DAG plus its
leaf order), so a structurally identical evaluate — the iterative
applications' steady state — skips the optimizer and re-signing and walks
the cached DAG with the new leaf tensors. There is no compile cache to
mirror: torch runs eagerly.

On a group mesh (``parallel/mesh.py``) each rank holds only its blocks
(``array/distarray.py``), and a plan walk runs on them: the env holds
each node's local value, a ``DistArray`` of the rank's block under the
tiling the node produced (:class:`GroupEnv`, :meth:`Expr.lower_local`).
A node with a local rule (``_lower_local``) computes its block from its
children's blocks, with the collectives its rule needs. Any other node
reads its children whole (each gathered and counted at the node's
class name, ``group_materialize_calls{site=...}``), runs its ``_lower``
on every rank, and keeps its result's block: what GSPMD does with an op
it cannot partition. Every branch of a local rule is decided from
shapes, tilings and the plan, never from a rank's data or the size of
its block, so every rank takes the same collectives.

Each evaluate is one ``evaluate`` span with the JAX package's phases
inside it (``sign``, ``optimize`` with its per-pass phases, ``build``,
``dispatch``; ``utils/profiling.py``), and its counters
(``evaluations``, ``plan_hits``, ``plan_misses``,
``donated_dispatches``) live in ``obs.metrics.REGISTRY``. Spans read the
host clock only: ``dispatch`` times the launches of a plan's kernels,
never waits for them.

A failed run of a plan goes to the resilience policy engine
(``resilience/engine.py``): retry, the OOM ladder, elastic recovery or
fail fast, by the classifier's verdict. The chaos seams
(``resilience/faults.py``) fire before each run, at ``compile`` on a
plan's first run and ``dispatch`` on later ones. Plan keys lead with the
mesh epoch (``parallel/mesh.py``), and a leaf of an earlier epoch raises
``StaleMeshError`` before anything runs.
"""

from __future__ import annotations

import functools
import itertools
import os
import sys
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..array import distarray as da
from ..array import tiling as tiling_mod
from ..array.distarray import DistArray
from ..array.tiling import Tiling
from ..kernels import registry as kernels_mod
from ..obs import ledger as ledger_mod
from ..obs import monitor as monitor_mod
from ..obs import numerics as numerics_mod
from ..obs import profile as profile_mod
from ..obs import trace as trace_mod
from ..obs.explain import build_plan_report, scope_digest_table
from ..parallel import mesh as mesh_mod
from ..parallel import redistribute as redistribute_mod
from .. import persist as persist_mod
from ..resilience import degrade as degrade_mod
from ..resilience import faults as faults_mod
from ..resilience import integrity as integrity_mod
from ..resilience import memory as memory_mod
from ..utils import config as config_mod
from ..utils import dtypes
from ..utils import profiling as prof
from ..utils.config import FLAGS

_ANNOTATE_FLAG = FLAGS.flag("trace_annotations")

_ids = itertools.count()
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _user_site() -> Optional[Tuple[str, int, str]]:
    """First stack frame outside this package — the user line that built
    an expr (named in evaluation errors)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG):
            return (fn, f.f_lineno, f.f_code.co_name)
        f = f.f_back
    return None


class ExprError(RuntimeError):
    """Evaluation error annotated with the user line that built the
    failing expression."""


def nbytes_of(e: "Expr") -> float:
    """Bytes of one node's value (size x itemsize)."""
    return float(e.size) * np.dtype(e.dtype).itemsize


def io_bytes(inputs: Sequence["Expr"], out: Optional["Expr"]) -> float:
    """Bytes a node reads and writes: each distinct input once (a scalar
    leaf at its itemsize, as XLA counts a scalar parameter), its output
    once."""
    seen = {c._id: c for c in inputs}
    return (sum(nbytes_of(c) for c in seen.values())
            + (nbytes_of(out) if out is not None else 0.0))


def fn_key(fn: Any) -> Any:
    """Structural identity for a kernel function: code object + captured
    closure values + defaults. Two closures created by the same def with
    the same captures compare equal, so iterative applications that rebuild
    their kernels every step still hit the plan cache."""
    if isinstance(fn, functools.partial):
        return ("partial", fn_key(fn.func), fn.args,
                tuple(sorted(fn.keywords.items())))
    code = getattr(fn, "__code__", None)
    if code is None:
        return fn  # builtins / callables: identity is the best we have
    cells: Tuple = ()
    closure = getattr(fn, "__closure__", None)
    if closure:
        vals = []
        for c in closure:
            try:
                v = c.cell_contents
            except ValueError:
                v = "<empty>"
            try:
                hash(v)
            except TypeError:
                v = id(v)
            vals.append(v)
        cells = tuple(vals)
    return (code, cells, getattr(fn, "__defaults__", None) or ())


class Expr:
    """A node in the lazy DAG. Subclasses define children + lowering."""

    def __init__(self, shape: Tuple[int, ...], dtype: Any):
        self._id = next(_ids)
        self._shape = tuple(int(s) for s in shape)
        self._dtype = np.dtype(dtype)
        self._result: Any = None
        # a tiling pinned on this node (the JAX package's auto-tiling
        # pass sets it; tests and callers pin an axis with it): it
        # changes out_tiling() and the plan key, never the data
        self._forced_tiling: Optional[Tiling] = None
        self._site = _user_site()

    # -- structure ------------------------------------------------------

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def size(self) -> int:
        return int(np.prod(self._shape)) if self._shape else 1

    def children(self) -> Tuple["Expr", ...]:
        raise NotImplementedError

    def replace_children(self, new_children: Tuple["Expr", ...]) -> "Expr":
        """Clone this node over rewritten children (optimizer passes)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support replace_children")

    def _lower(self, env: Dict[int, Any]) -> Any:
        """Compute this node's tensor (children via ``c.lower(env)``)."""
        raise NotImplementedError

    # the local rule on a group mesh: ``_lower_local(env)`` returns this
    # node's local value from its children's (``c.lower_local(env)``), or
    # NotImplemented where the inputs' metadata rules it out
    _lower_local: Optional[Callable[..., Any]] = None

    def lower_local(self, env: "GroupEnv") -> Any:
        """This node's local value on a group mesh: a ``DistArray`` of
        the rank's block (a tuple of them for a multi-output node)."""
        if self._id not in env:
            nodes = env.nodes
            if nodes is not None:
                # the plan audit's dry walk: collectives are attributed
                # to the innermost node being lowered
                nodes.append(self)
                try:
                    return self._lower_local_node(env)
                finally:
                    nodes.pop()
            return self._lower_local_node(env)
        return env[self._id]

    def _lower_local_node(self, env: "GroupEnv") -> Any:
        """Lower this node on a group mesh and memoize its value."""
        try:
            if _ANNOTATE_FLAG._value and trace_mod.profiler_active():
                # each rank's profile attributes its kernels to the
                # node, as Expr.lower's range does
                with trace_mod.named_scope(profile_mod.scope_name(self)):
                    val = self._lower_local_value(env)
            else:
                val = self._lower_local_value(env)
        except Exception as e:
            if self._site and not getattr(e, "_expr_annotated", False):
                e._expr_annotated = True
                e.add_note(f"while evaluating {type(self).__name__} "
                           f"built at {self._site[0]}:{self._site[1]} "
                           f"(in {self._site[2]})")
            raise
        if self._forced_tiling is not None and isinstance(val,
                                                          DistArray):
            val = redistribute_mod.relayout(val, self._forced_tiling)
        if numerics_mod._PROBING:
            # numerics sentinel: the rank's block's health word
            numerics_mod.probe(self, val)
        env[self._id] = val
        if env.release:
            env.consumed(env.release.get(self._id))
        return val

    def _lower_local_value(self, env: "GroupEnv") -> Any:
        """The node's local rule, or its whole lowering kept as the
        rank's block where it has none."""
        val = (self._lower_local(env) if self._lower_local is not None
               else NotImplemented)
        if val is NotImplemented:
            prev, env.site = env.site, type(self).__name__
            try:
                val = _wrap_whole(self._lower(env), self, env.mesh)
            finally:
                env.site = prev
        return val

    def lower(self, env: Dict[int, Any]) -> Any:
        if type(env) is GroupEnv:
            # a lowering without a local rule reads this child whole
            return _whole(self.lower_local(env), env.site)
        if self._id not in env:
            try:
                if _ANNOTATE_FLAG._value and trace_mod.profiler_active():
                    # device profiles attribute this node's kernels to
                    # it; a range per node costs microseconds, so only
                    # while a profiler records. Inside a naming session
                    # (st.profile) the range also carries the node's
                    # _sig digest, the capture tier's join key
                    with trace_mod.named_scope(profile_mod.scope_name(self)):
                        val = self._lower(env)
                else:
                    val = self._lower(env)
            except Exception as e:
                if self._site and not getattr(e, "_expr_annotated", False):
                    e._expr_annotated = True  # annotate innermost only
                    e.add_note(f"while evaluating {type(self).__name__} "
                               f"built at {self._site[0]}:{self._site[1]} "
                               f"(in {self._site[2]})")
                raise
            if numerics_mod._PROBING:
                # numerics sentinel (st.audit / FLAGS.audit_numerics): a
                # health word of this node's value, kept on the device
                numerics_mod.probe(self, val)
            if (self._forced_tiling is not None
                    and not profile_mod.shard_local_lowering()):
                # smart tiling chose this node's layout: the
                # redistribution seam returns ``val`` itself unless the
                # planner is on and predicts an explicit schedule from
                # the node's natural layout (then it moves the logical
                # shards and the values stay bit-equal)
                val = redistribute_mod.constrain(
                    val, self._forced_tiling, mesh_mod.get_mesh(),
                    src=self._default_tiling())
            env[self._id] = val
            rel = getattr(env, "release", None)
            if rel:
                env.consumed(rel.get(self._id))
            return val
        return env[self._id]

    def _sig(self, ctx: "_SigCtx") -> Tuple:
        """Structural signature of this node (children via ctx.of)."""
        raise NotImplementedError

    def out_tiling(self) -> Tiling:
        """Tiling of the evaluated result (``_forced_tiling`` when set)."""
        if self._forced_tiling is not None:
            return self._forced_tiling
        return self._default_tiling()

    def _default_tiling(self) -> Tiling:
        raise NotImplementedError

    # a node whose lowering gives one layout (``_default_tiling``)
    # whatever it is asked: the tiling DP offers it no other
    fixed_tiling = False

    def operand_requirement(self, t: Tiling,
                            child_idx: int) -> Optional[Tiling]:
        """The tiling this node wants of child ``child_idx`` when it
        produces ``t``, which the tiling DP prices as a move of that
        child (``expr/tiling_cost``); None = no preference."""
        return None

    def cost(self) -> Dict[str, float]:
        """This node's own FLOPs and bytes accessed, counted from shapes
        by the rules XLA's cost analysis applies (``st.explain``'s
        ``cost_analysis``, obs/explain.py). By default a node moves data
        and computes nothing: no FLOP, each child read once and the
        output written once."""
        return {"flops": 0.0, "transcendentals": 0.0,
                "bytes accessed": io_bytes(self.children(), self)}

    # -- evaluation -----------------------------------------------------

    def evaluate(self, donate: Sequence[Any] = ()) -> DistArray:
        return evaluate(self, donate=donate)

    def evaluate_async(self, donate: Sequence[Any] = (),
                       tenant: Optional[str] = None,
                       deadline_s: Optional[float] = None):
        """Submit this expr to the concurrent serving engine
        (``spartan_tpu_torch/serve``): returns an ``EvalFuture`` at once;
        identical-signature requests from concurrent callers coalesce
        into one batched walk."""
        from ..serve import evaluate_async as _ea

        return _ea(self, donate=donate, tenant=tenant,
                   deadline_s=deadline_s)

    def force(self, donate: Sequence[Any] = ()) -> DistArray:
        return evaluate(self, donate=donate)

    def glom(self) -> np.ndarray:
        return self.evaluate().glom()

    def optimized(self) -> "Expr":
        """The optimizer's rewrite of this DAG (nothing is evaluated)."""
        from .optimize import optimize

        return optimize(self)

    def invalidate(self) -> None:
        """Drop this node's cached result; the next evaluate recomputes
        it from the DAG (its lineage)."""
        self._result = None

    def recompute(self) -> DistArray:
        """Lineage-based recovery: re-evaluate this expr from its
        (deterministic) DAG, ignoring the cached result."""
        self.invalidate()
        return evaluate(self)

    def __array__(self, dtype=None, copy=None):
        out = self.glom()
        return out.astype(dtype) if dtype is not None else out

    # -- operator overloading (build MapExprs) --------------------------

    def _binop(self, other: Any, name: str, reverse: bool = False) -> "Expr":
        from .map import build_binop

        return build_binop(name, self, other, reverse)

    def __add__(self, o):
        return self._binop(o, "add")

    def __radd__(self, o):
        return self._binop(o, "add", True)

    def __sub__(self, o):
        return self._binop(o, "subtract")

    def __rsub__(self, o):
        return self._binop(o, "subtract", True)

    def __mul__(self, o):
        return self._binop(o, "multiply")

    def __rmul__(self, o):
        return self._binop(o, "multiply", True)

    def __truediv__(self, o):
        return self._binop(o, "divide")

    def __rtruediv__(self, o):
        return self._binop(o, "divide", True)

    def __floordiv__(self, o):
        return self._binop(o, "floor_divide")

    def __rfloordiv__(self, o):
        return self._binop(o, "floor_divide", True)

    def __mod__(self, o):
        return self._binop(o, "mod")

    def __rmod__(self, o):
        return self._binop(o, "mod", True)

    def __pow__(self, o):
        return self._binop(o, "power")

    def __rpow__(self, o):
        return self._binop(o, "power", True)

    def __neg__(self):
        from .map import build_unop

        return build_unop("negative", self)

    def __abs__(self):
        from .map import build_unop

        return build_unop("absolute", self)

    def __eq__(self, o):  # type: ignore[override]
        return self._binop(o, "equal")

    def __ne__(self, o):  # type: ignore[override]
        return self._binop(o, "not_equal")

    def __lt__(self, o):
        return self._binop(o, "less")

    def __le__(self, o):
        return self._binop(o, "less_equal")

    def __gt__(self, o):
        return self._binop(o, "greater")

    def __ge__(self, o):
        return self._binop(o, "greater_equal")

    def __and__(self, o):
        return self._binop(o, "bitwise_and")

    def __or__(self, o):
        return self._binop(o, "bitwise_or")

    def __xor__(self, o):
        return self._binop(o, "bitwise_xor")

    def __invert__(self):
        from .map import build_unop

        # numpy semantics: logical not for bools, bitwise not for ints
        name = "logical_not" if self.dtype == np.bool_ else "invert"
        return build_unop(name, self)

    def __hash__(self) -> int:  # __eq__ is overloaded; hash by identity
        return id(self)

    def __bool__(self) -> bool:
        # Never truth-test an Expr: __eq__/__lt__/... build lazy
        # element-wise graphs, so `if expr:` or `expr in seq` would
        # silently build (or force) a graph.
        built = (f"; the expr was built at {self._site[0]}:"
                 f"{self._site[1]} (in {self._site[2]})"
                 if self._site else "")
        raise ExprError(
            f"an Expr has no truth value{built}. Force explicitly "
            "instead: bool(expr.glom()) for a size-1 result, "
            ".any()/.all() for element-wise tests, or `is` for object "
            "identity.")

    def __getitem__(self, idx) -> "Expr":
        from .slice import make_slice

        return make_slice(self, idx)

    # -- numpy-flavoured conveniences ------------------------------------

    def astype(self, dtype) -> "Expr":
        from .builtins import astype

        return astype(self, dtype)

    def sum(self, axis=None, keepdims=False) -> "Expr":
        from .reduce import sum as _sum

        return _sum(self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False) -> "Expr":
        from .reduce import mean

        return mean(self, axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False) -> "Expr":
        from .reduce import max as _max

        return _max(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False) -> "Expr":
        from .reduce import min as _min

        return _min(self, axis=axis, keepdims=keepdims)

    def all(self, axis=None, keepdims=False) -> "Expr":
        from .reduce import all as _all

        return _all(self, axis=axis, keepdims=keepdims)

    def any(self, axis=None, keepdims=False) -> "Expr":
        from .reduce import any as _any

        return _any(self, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None) -> "Expr":
        from .reduce import argmax

        return argmax(self, axis=axis)

    def argmin(self, axis=None) -> "Expr":
        from .reduce import argmin

        return argmin(self, axis=axis)

    def dot(self, other) -> "Expr":
        from .dot import dot

        return dot(self, other)

    def __matmul__(self, other) -> "Expr":
        from .dot import dot

        return dot(self, other)

    def transpose(self, *axes) -> "Expr":
        from .reshape import transpose

        return transpose(self, *axes)

    @property
    def T(self) -> "Expr":
        return self.transpose()

    def reshape(self, *shape) -> "Expr":
        from .reshape import reshape

        return reshape(self, *shape)

    def ravel(self) -> "Expr":
        from .reshape import ravel

        return ravel(self)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(id={self._id}, shape={self._shape}, "
                f"dtype={self._dtype})")


# -- leaf nodes ---------------------------------------------------------


class ValExpr(Expr):
    """Leaf wrapping an evaluated DistArray (the reference's ``Val``)."""

    def __init__(self, value: DistArray):
        super().__init__(value.shape, value.dtype)
        self.value = value
        self._result = value

    def children(self) -> Tuple[Expr, ...]:
        return ()

    def replace_children(self, new_children: Tuple[Expr, ...]) -> Expr:
        return self

    def _lower(self, env: Dict[int, Any]) -> Any:
        raise RuntimeError("leaf must be seeded into env before lowering")

    def _sig(self, ctx: "_SigCtx") -> Tuple:
        return ("val", ctx.leaf_pos(self), self._shape, str(self._dtype),
                self.value.tiling.axes)

    def _default_tiling(self) -> Tiling:
        return self.value.tiling


class ScalarExpr(Expr):
    """Leaf wrapping a Python scalar. Its value is NOT in the signature,
    so same-structure DAGs with different constants share one plan; it
    is passed at run time as a 0-d CPU tensor (see
    ``utils.dtypes.scalar_dtype``), which torch combines with tensors
    on any device."""

    def __init__(self, value: Any):
        self.tdtype = dtypes.scalar_dtype(value)
        super().__init__((), dtypes.to_numpy(self.tdtype))
        self.pyvalue = value
        self.weak_kind = ("b" if isinstance(value, bool) else
                          "i" if isinstance(value, int) else "f")

    def children(self) -> Tuple[Expr, ...]:
        return ()

    def replace_children(self, new_children: Tuple[Expr, ...]) -> Expr:
        return self

    def _lower(self, env: Dict[int, Any]) -> Any:
        raise RuntimeError("leaf must be seeded into env before lowering")

    def _sig(self, ctx: "_SigCtx") -> Tuple:
        return ("scalar", ctx.leaf_pos(self), self.weak_kind)

    def _default_tiling(self) -> Tiling:
        return tiling_mod.replicated(0)


def as_expr(value: Any) -> Expr:
    """The reference's ``AsArray``: coerce anything to an Expr."""
    if isinstance(value, Expr):
        return value
    if isinstance(value, DistArray):
        return ValExpr(value)
    if isinstance(value, (bool, int, float, np.bool_, np.integer,
                          np.floating)):
        if isinstance(value, (np.bool_, np.integer, np.floating)):
            value = value.item()
        return ScalarExpr(value)
    if isinstance(value, (np.ndarray, list, tuple)):
        return ValExpr(da.from_numpy(np.asarray(value)))
    if isinstance(value, torch.Tensor):
        return ValExpr(da.from_tensor(value))
    from ..array.masked import MaskedDistArray

    if isinstance(value, MaskedDistArray):
        raise TypeError(
            "this operation does not support MaskedDistArray operands "
            "(the mask would be silently dropped). Use the mask-aware "
            "ops — elementwise arithmetic / map, dot, sort, argsort, "
            "median, concatenate, and the masked reductions — or pass "
            ".filled(fill) / .data explicitly.")
    raise TypeError(f"cannot lift {type(value).__name__} into an Expr")


class TupleExpr(Expr):
    """Multiple roots evaluated in ONE plan; ``glom()``/``evaluate()``
    return tuples."""

    def __init__(self, elements: Sequence[Expr]):
        self.elements: Tuple[Expr, ...] = tuple(as_expr(e) for e in elements)
        if not self.elements:
            raise ValueError("TupleExpr needs at least one element")
        super().__init__((), self.elements[0].dtype)

    def children(self) -> Tuple[Expr, ...]:
        return self.elements

    def replace_children(self, new_children: Tuple[Expr, ...]) -> "TupleExpr":
        return TupleExpr(new_children)

    def _lower(self, env: Dict[int, Any]) -> Any:
        return tuple(e.lower(env) for e in self.elements)

    def _lower_local(self, env) -> Any:
        return tuple(e.lower_local(env) for e in self.elements)

    def cost(self) -> Dict[str, float]:
        return {"flops": 0.0, "transcendentals": 0.0, "bytes accessed": 0.0}

    def _sig(self, ctx: "_SigCtx") -> Tuple:
        return ("tuple",) + tuple(ctx.of(e) for e in self.elements)

    def out_tilings(self) -> Tuple[Tiling, ...]:
        return tuple(tiling_mod.sanitize(e.out_tiling(), e.shape)
                     for e in self.elements)

    def _default_tiling(self) -> Tiling:
        return tiling_mod.replicated(0)

    def __len__(self) -> int:
        return len(self.elements)

    def glom(self):  # type: ignore[override]
        return tuple(r.glom() for r in evaluate(self))


def lazify(value: Any) -> Expr:
    return as_expr(value)


def tuple_of(*elements: Any) -> TupleExpr:
    return TupleExpr(elements)


class ListExpr(TupleExpr):
    """List-shaped multi-root evaluation (the reference's ``ListExpr``)."""

    def glom(self):  # type: ignore[override]
        return [r.glom() for r in evaluate(self)]


class DictExpr(Expr):
    """Dict of exprs evaluated in ONE plan (the reference's ``DictExpr``):
    the values, in sorted key order, are one ``TupleExpr``;
    ``glom()``/``evaluate()`` return dicts."""

    def __init__(self, items: Dict[str, Any]):
        self._keys = tuple(sorted(items))
        self._tuple = TupleExpr([items[k] for k in self._keys])
        super().__init__((), self._tuple.elements[0].dtype)

    def children(self) -> Tuple[Expr, ...]:
        return (self._tuple,)

    def replace_children(self, new_children: Tuple[Expr, ...]) -> "DictExpr":
        e = DictExpr.__new__(DictExpr)
        Expr.__init__(e, (), new_children[0].elements[0].dtype)
        e._keys = self._keys
        e._tuple = new_children[0]
        return e

    def _lower(self, env: Dict[int, Any]) -> Any:
        raise RuntimeError("DictExpr is evaluated via its tuple")

    def _sig(self, ctx: "_SigCtx") -> Tuple:
        return ("dict", self._keys, ctx.of(self._tuple))

    def evaluate(self, donate: Sequence[Any] = ()):  # type: ignore[override]
        return dict(zip(self._keys, evaluate(self._tuple, donate=donate)))

    def force(self, donate: Sequence[Any] = ()):  # type: ignore[override]
        return self.evaluate(donate=donate)

    def glom(self):  # type: ignore[override]
        return {k: v.glom() for k, v in self.evaluate().items()}

    def __getitem__(self, key: str) -> Expr:  # type: ignore[override]
        return self._tuple.elements[self._keys.index(key)]


def dict_of(**items: Any) -> DictExpr:
    return DictExpr(items)


# -- evaluation machinery ----------------------------------------------


class _SigCtx:
    """Assigns stable positions to leaves and dedups shared subtrees."""

    def __init__(self) -> None:
        self.leaves: List[Expr] = []
        self._leaf_pos: Dict[int, int] = {}
        self._memo: Dict[int, Tuple] = {}
        self._visit: Dict[int, int] = {}

    def leaf_pos(self, leaf: Expr) -> int:
        pos = self._leaf_pos.get(leaf._id)
        if pos is None:
            pos = len(self.leaves)
            self._leaf_pos[leaf._id] = pos
            self.leaves.append(leaf)
        return pos

    def of(self, node: Expr) -> Tuple:
        if node._id in self._memo:
            # shared subtree: refer to it by visit index, not structure,
            # so diamond DAGs don't blow up exponentially
            return ("ref", self._visit[node._id])
        sig = node._sig(self)
        if node._forced_tiling is not None:
            sig = sig + ("forced", node._forced_tiling.axes)
        self._visit[node._id] = len(self._memo)
        self._memo[node._id] = sig
        return sig


class _PlanSigCtx(_SigCtx):
    """Signs the RAW (pre-optimizer) DAG for the plan cache.

    Nodes carrying a cached ``_result`` sign as Val leaves — exactly the
    rewrite ``CollapseCachedPass`` performs — because the optimizer's
    output depends on which sub-DAGs are already evaluated."""

    def of(self, node: Expr) -> Tuple:
        if node._id in self._memo:
            return ("ref", self._visit[node._id])
        if (node._result is not None and not isinstance(node, ValExpr)
                and isinstance(node._result, DistArray)):
            sig = ("val", self.leaf_pos(node), node._shape,
                   str(node._dtype), node._result.tiling.axes)
            self._visit[node._id] = len(self._memo)
            self._memo[node._id] = sig
            return sig
        return super().of(node)


class _Plan:
    """The steady-state recipe for one raw-DAG signature: the optimized
    DAG, the ids of its leaves (the env slots a run seeds), the output
    tilings, and ``arg_order`` mapping each optimized leaf to the
    position of the raw leaf that feeds it. ``key`` is the plan key,
    ``report`` the plan's record (its key digest, root and build site,
    and the resilience record of its failures), ``warm`` whether a run
    of it has succeeded (the chaos seam's ``compile`` vs ``dispatch``)."""

    __slots__ = ("dag", "leaf_ids", "out_tilings", "is_tuple", "arg_order",
                 "key", "report", "warm", "stored", "release",
                 "governed_rung", "persist_digest", "__weakref__")

    def __init__(self, dag: Expr, leaf_ids: Tuple[int, ...],
                 out_tilings: Tuple[Tiling, ...], is_tuple: bool,
                 arg_order: Tuple[int, ...], key: Optional[Tuple] = None,
                 report: Optional[Dict[str, Any]] = None):
        self.dag = dag
        self.leaf_ids = leaf_ids
        self.out_tilings = out_tilings
        self.is_tuple = is_tuple
        self.arg_order = arg_order
        self.key = key
        self.report = report
        self.warm = False
        self.stored: Optional["_Plan"] = None
        # (consumers, release) of _release_map: the walk frees each
        # value at its last consumer (_FreeingEnv)
        self.release: Optional[Tuple[Dict[int, int],
                                     Dict[int, Tuple[int, ...]]]] = None
        # the memory governor's rung for an over-budget plan
        self.governed_rung: Optional[str] = None
        # the persist store's address of this plan
        self.persist_digest: Optional[str] = None


# The plan cache is an LRU shared by every thread that evaluates (and the
# serve engine's workers); _cache_lock guards it and the variant cache
# (they evict together), for dict operations only, never a DAG walk.
# Other modules go through lookup_plan / store_plan / cached_executable.
_PLAN_CACHE_MAX_FLAG = FLAGS.define_int(
    "plan_cache_max", 512,
    "Maximum plans retained in the evaluate() plan cache; beyond it "
    "the least-recently-used plan is evicted together with every "
    "variant keyed under it (the serve coalescer's batched walks). "
    "0 = unbounded (and the hot path skips the LRU reordering). "
    "Eviction counts land on the plan_evictions metric.")
_plan_cache: "OrderedDict[Tuple, _Plan]" = OrderedDict()
_cache_lock = threading.Lock()
_PLAN_COUNTERS = ("plan_hits", "plan_misses", "evaluations")


class _Exec:
    """A variant of a plan (the serve coalescer's batched walk): the
    function and whether a call of it has succeeded (the chaos seam's
    ``compile`` vs ``dispatch``)."""

    __slots__ = ("fn", "warm")

    def __init__(self, fn: Callable):
        self.fn = fn
        self.warm = False


# variant key (a plan key plus the variant's own fields) -> _Exec
_compile_cache: Dict[Tuple, _Exec] = {}

# -- walk serialization --------------------------------------------------
#
# A walk on the CPU runs its torch ops on the calling thread, and on a
# group mesh it issues collectives: two threads walking at once on a
# group mesh would pair the wrong collective calls across ranks. The
# serve engine's workers and concurrent evaluate() callers therefore
# serialize the walk (not the planning) where it needs it. Walks on the
# card only launch work onto the device's stream, so 'auto' leaves a
# logical mesh on the card unguarded.

_DISPATCH_SERIALIZE_FLAG = FLAGS.define_str(
    "dispatch_serialize", "auto",
    "Serialize plan walks across threads: 'auto' (serialize on the cpu "
    "and on a group mesh, whose collectives would pair the wrong calls "
    "across ranks under concurrent walks; leave a logical mesh on the "
    "card unserialized), 'on', or 'off'. Planning, leaf gathering and "
    "result wrapping always run concurrently — only the walk is "
    "guarded.")

# reentrant: a lowering may evaluate another expression on the walking
# thread (a user function of st.map that calls evaluate())
_launch_lock = threading.RLock()


class _NullGuard:
    __slots__ = ()

    def __enter__(self) -> "_NullGuard":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


_NULL_GUARD = _NullGuard()


def launch_guard(mesh=None):
    """The serialization context for one plan walk, shared by ``_run``
    and the serve coalescer: the process's walk lock where
    ``FLAGS.dispatch_serialize`` asks for it (see the flag), else a
    no-op. One flag read on the hot path."""
    v = _DISPATCH_SERIALIZE_FLAG._value
    if v == "off":
        return _NULL_GUARD
    if v != "on":
        mesh = mesh or mesh_mod.get_mesh()
        if mesh.device.type != "cpu" and not mesh.is_group:
            return _NULL_GUARD
    return _launch_lock


def plan_stats() -> Dict[str, int]:
    """Plan-cache counters: ``plan_hits``, ``plan_misses``,
    ``evaluations`` (the JAX package's counters of the same names, read
    from ``obs.metrics.REGISTRY``)."""
    c = prof.counters()
    return {k: c.get(k, 0) for k in _PLAN_COUNTERS}


def reset_plan_stats() -> None:
    for k in _PLAN_COUNTERS:
        prof.REGISTRY.counter(k)._reset()


def plan_cache_size() -> int:
    return len(_plan_cache)


def compile_cache_size() -> int:
    return len(_compile_cache)


def clear_plan_cache() -> None:
    with _cache_lock:
        _plan_cache.clear()


def clear_compile_cache() -> None:
    """Drop every plan and every variant (the variants are keyed under
    their plans, so the two clear together)."""
    with _cache_lock:
        _compile_cache.clear()
        _plan_cache.clear()


def _drop_variants(plan_key: Tuple) -> None:
    """Remove every variant keyed under ``plan_key`` (caller holds
    ``_cache_lock``)."""
    n = len(plan_key)
    for k in [k for k in _compile_cache if k[:n] == plan_key]:
        del _compile_cache[k]


def lookup_plan(plan_key: Tuple) -> Optional[_Plan]:
    """Plan-cache read (the only read path: serve/, obs/ and analysis/
    go through here). A hit refreshes LRU recency when the cache is
    bounded; unbounded (``plan_cache_max=0``) skips the reorder."""
    with _cache_lock:
        plan = _plan_cache.get(plan_key)
        if plan is not None and _PLAN_CACHE_MAX_FLAG._value > 0:
            _plan_cache.move_to_end(plan_key)
        return plan


def store_plan(plan_key: Tuple, plan: _Plan) -> _Plan:
    """Insert with LRU eviction (``FLAGS.plan_cache_max``): an evicted
    plan takes every variant keyed under it (``plan.key + ...``, the
    serve coalescer's batched walks) out of the variant cache with it,
    so an unbounded stream of plans cannot pin their dead variants.
    The first writer wins a race (the existing plan is returned)."""
    evicted = 0
    with _cache_lock:
        cur = _plan_cache.get(plan_key)
        if cur is not None:
            return cur
        _plan_cache[plan_key] = plan
        maxn = _PLAN_CACHE_MAX_FLAG._value
        while maxn and maxn > 0 and len(_plan_cache) > maxn:
            old_key, _old = _plan_cache.popitem(last=False)
            _drop_variants(old_key)
            evicted += 1
    if evicted:
        prof.count("plan_evictions", evicted)
    return plan


def cached_executable(key: Tuple, make: Callable[[], Callable]) -> _Exec:
    """Get-or-create a plan variant under ``key`` (a plan key plus the
    variant's fields): ``make()`` builds the function on a miss, outside
    the lock, and the first writer wins. The serve coalescer keys its
    batched walks here, so they share the plan's eviction, and each
    miss counts on ``compiles``."""
    with _cache_lock:
        ex = _compile_cache.get(key)
    if ex is None:
        mine = _Exec(make())
        with _cache_lock:
            ex = _compile_cache.setdefault(key, mine)
        if ex is mine:
            prof.count("compiles")
    return ex


# _opt_flags_key memo: (flag-mutation count, registered passes) -> key.
# Every input of the key is a flag, so it stays valid until a flag write.
_opt_key_memo: Tuple[Tuple, Tuple] = ((), ())


def _opt_flags_key() -> Tuple:
    """Everything the optimizer and lowering read that the raw signature
    cannot see: a plan is reusable only under the same configuration —
    the enabled passes, the tiling cost weights, the redistribution
    planner, loop-carry sharding and the kernel policy (JAX
    ``base.py:1109-1117``)."""
    global _opt_key_memo
    # the module, not the package's ``optimize`` function of that name
    optimize_mod = sys.modules[__package__ + ".optimize"]
    # the smart-tiling pass registers itself on first use: it must be
    # in the registry before the key is read
    optimize_mod._ensure_tiling_pass()
    passes = optimize_mod._PASSES
    ver = (config_mod.mutation_count(), len(passes))
    memo_ver, key = _opt_key_memo
    if memo_ver != ver:
        # cost calibration re-weights the tiling DP's terms (the active
        # profile of obs/ledger -> tiling_cost._cal_factors): a
        # calibrated plan never aliases an uncalibrated one, and each
        # profile keys apart by its fingerprint (set_profile writes the
        # fingerprint flag, which moves the memo's version). The audit
        # flag (obs/numerics) is NOT here: an audited walk runs the same
        # plan and only adds health words beside it
        cal = ((FLAGS.cost_calibration_fingerprint or "on")
               if FLAGS.cost_calibration else None)
        key = (tuple(p.name for p in passes if p.enabled()),
               FLAGS.tiling_compute_weight, FLAGS.tiling_flop_weight,
               FLAGS.tiling_operand_move_weight,
               FLAGS.tiling_memory_weight, cal,
               bool(FLAGS.redistribution_planner),
               bool(FLAGS.shard_loop_carries),
               kernels_mod.policy_key())
        _opt_key_memo = (ver, key)
    # the OOM ladder's rung (thread-local, outside the memo): a degraded
    # plan never aliases the normal one (JAX ``base.py:1119``)
    return key + (getattr(degrade_mod._TLS, "rung", None),)


def _mesh_key(mesh) -> Tuple:
    # led by the mesh epoch, so a dead mesh's plans miss after a
    # rebuild_mesh and evict_stale_plans finds them; a group mesh lowers
    # on local blocks, a logical one on whole tensors
    return ((mesh_mod._EPOCH,) + tuple(sorted(mesh.shape.items())),
            str(mesh.device), mesh.is_group)


def evict_stale_plans() -> int:
    """Drop every plan keyed under a mesh epoch older than the current
    one (elastic recovery calls it after ``rebuild_mesh``). Returns the
    number of plans evicted."""
    epoch = mesh_mod._EPOCH
    with _cache_lock:
        stale = [k for k in _plan_cache if k[2][0][0] != epoch]
        for k in stale:
            del _plan_cache[k]
            _drop_variants(k)
    if stale:
        prof.count("plan_evictions", len(stale))
    # the incremental engine's result cache holds tensors keyed by plan:
    # entries born under a dead epoch go with the plans
    incremental_mod.evict_stale()
    return len(stale)


def plan_signature(expr: Expr, mesh=None) -> Tuple[Tuple, _PlanSigCtx]:
    """One raw-DAG traversal -> (plan-cache key, signing context)."""
    mesh = mesh or mesh_mod.get_mesh()
    rctx = _PlanSigCtx()
    raw_sig = rctx.of(expr)
    return (raw_sig, _opt_flags_key(), _mesh_key(mesh)), rctx


def _leaf_arg(leaf: Expr) -> Any:
    if isinstance(leaf, ValExpr):
        return leaf.value.tensor
    if isinstance(leaf, ScalarExpr):
        return torch.tensor(leaf.pyvalue, dtype=leaf.tdtype)
    if isinstance(leaf._result, DistArray):
        return leaf._result.tensor  # cached node signed as a Val leaf
    raise TypeError(f"unknown leaf {leaf!r}")


# The walk frees each value at its last consumer (False: every value
# lives until the walk ends, as before the memory governor; a switch for
# measuring the difference)
FREE_AT_LAST_USE = True


def _release_map(dag: Expr, leaf_ids: Sequence[int]
                 ) -> Tuple[Dict[int, int], Dict[int, Tuple[int, ...]]]:
    """(consumers, release) of a plan: each interior node's count of
    distinct parents, and for each node the children it may be the last
    consumer of. Leaves and roots are never freed by the walk."""
    from .optimize import dag_nodes

    keep = set(leaf_ids) | {dag._id}
    if isinstance(dag, TupleExpr):
        keep.update(e._id for e in dag.elements)
    consumers: Dict[int, int] = {}
    release: Dict[int, Tuple[int, ...]] = {}
    for n in dag_nodes(dag):
        kids = tuple({c._id: None for c in n.children()
                      if c._id not in keep})
        for k in kids:
            consumers[k] = consumers.get(k, 0) + 1
        if kids:
            release[n._id] = kids
    return consumers, release


class _Freeing:
    """The walk's freeing of values at their last consumer: ``release``
    maps a node to the children it may be the last reader of, and
    ``remaining`` counts each child's consumers still to run."""

    __slots__ = ()

    def consumed(self, kids: Optional[Tuple[int, ...]]) -> None:
        if not kids:
            return
        rem = self.remaining
        for k in kids:
            r = rem.get(k, 0) - 1
            rem[k] = r
            if r <= 0:
                self.pop(k, None)


class _FreeingEnv(_Freeing, dict):
    """The env of a plan walk on a logical mesh that frees values at
    their last consumer (``plan.release``). A loop body walks each
    iteration in a :meth:`fork`, which frees the same way."""

    __slots__ = ("release", "consumers", "remaining")

    def __init__(self, items, release, consumers):
        dict.__init__(self, items)
        self.release = release
        self.consumers = consumers
        self.remaining = dict(consumers)

    def fork(self) -> "_FreeingEnv":
        """A copy with every consumer still to run (a loop iteration)."""
        return _FreeingEnv(self, self.release, self.consumers)


class GroupEnv(_Freeing, dict):
    """The env of a plan walk on a group mesh: node id -> the node's
    local value. ``site`` names the node whose lowering (no local rule)
    is reading its children whole; ``mesh`` is the group mesh;
    ``nodes`` the audit's stack of nodes being lowered; ``release`` and
    ``remaining`` free values at their last consumer, as
    :class:`_FreeingEnv` does."""

    __slots__ = ("site", "mesh", "nodes", "release", "consumers",
                 "remaining")

    def __init__(self, mesh, items=()):
        dict.__init__(self, items)
        self.site = "evaluate"
        self.mesh = mesh
        # the stack of nodes being lowered, kept only by the plan
        # audit's dry walk (None on a real walk)
        self.nodes: Optional[List[Expr]] = None
        self.release: Optional[Dict[int, Tuple[int, ...]]] = None
        self.consumers: Dict[int, int] = {}
        self.remaining: Dict[int, int] = {}

    def copy(self) -> "GroupEnv":
        """A copy (a loop iteration's env) with every consumer still to
        run."""
        out = GroupEnv(self.mesh, self)
        out.site = self.site
        out.nodes = self.nodes
        out.release = self.release
        out.consumers = self.consumers
        out.remaining = dict(self.consumers)
        return out


def _whole(val: Any, site: str) -> Any:
    """A local value gathered whole (counted at ``site``)."""
    if isinstance(val, DistArray):
        return val.materialize(site)
    if isinstance(val, tuple):
        return tuple(_whole(v, site) for v in val)
    return val


def _wrap_whole(val: Any, node: Optional[Expr], mesh) -> Any:
    """A whole value every rank computed, as local values: a tensor of
    the node's shape keeps its block under the node's (sanitized)
    tiling, anything else its whole, replicated."""
    if isinstance(val, torch.Tensor):
        if node is not None and tuple(val.shape) == node.shape:
            t = tiling_mod.sanitize(node.out_tiling(), node.shape, mesh)
        else:
            t = tiling_mod.replicated(val.ndim)
        return DistArray(val, t, mesh)
    if isinstance(val, tuple):
        return tuple(_wrap_whole(v, None, mesh) for v in val)
    return val


def local_scalar(value: torch.Tensor, mesh) -> DistArray:
    """A 0-d tensor as a replicated local value."""
    return DistArray.from_local(value, tiling_mod.replicated(0), (), mesh)


def _leaf_local(leaf: Expr, mesh) -> Any:
    """A leaf's local value on the group mesh ``mesh``."""
    if isinstance(leaf, ScalarExpr):
        return local_scalar(torch.tensor(leaf.pyvalue, dtype=leaf.tdtype),
                            mesh)
    arr = _leaf_array(leaf)
    if arr is None:
        raise TypeError(f"unknown leaf {leaf!r}")
    if not arr.mesh.is_group:
        # an array made on a logical mesh: the rank keeps its block
        return DistArray(arr.tensor, arr.tiling, mesh)
    arr.local  # a donated leaf raises here
    return arr


def _leaf_array(leaf: Expr) -> Optional[DistArray]:
    """The DistArray behind a leaf (None for scalars)."""
    if isinstance(leaf, ValExpr):
        return leaf.value
    if isinstance(leaf, ScalarExpr):
        return None
    return leaf._result if isinstance(leaf._result, DistArray) else None


def _arg_order(raw_leaves: List[Expr],
               opt_leaves: List[Expr]) -> Optional[Tuple[int, ...]]:
    """Map each optimized-DAG leaf back to the raw-DAG leaf feeding it.
    Passes keep leaf objects (or substitute ``ValExpr(n._result)`` for
    a node the raw signature already signed as a leaf), so identity on
    the Expr or its DistArray recovers the raw position. None (plan not
    cacheable) if a pass introduced a leaf with no raw counterpart."""
    pos: Dict[int, int] = {}
    for i, leaf in enumerate(raw_leaves):
        pos.setdefault(id(leaf), i)
        arr = _leaf_array(leaf)
        if arr is not None:
            pos.setdefault(id(arr), i)
    order = []
    for leaf in opt_leaves:
        j = pos.get(id(leaf))
        if j is None and isinstance(leaf, ValExpr):
            j = pos.get(id(leaf.value))
        if j is None:
            return None
        order.append(j)
    return tuple(order)


def _norm_donate(donate: Sequence[Any]) -> List[DistArray]:
    out: List[DistArray] = []
    for d in donate:
        if isinstance(d, DistArray):
            out.append(d)
        elif isinstance(d, ValExpr):
            out.append(d.value)
        elif isinstance(d, Expr) and isinstance(d._result, DistArray):
            out.append(d._result)
        else:
            raise TypeError(
                f"donate expects DistArrays (or evaluated exprs), got "
                f"{type(d).__name__}")
        if out[-1]._donate_site is None:
            out[-1]._donate_site = _user_site()
    return out


def _check_epochs(leaves: List[Expr], order: Tuple[int, ...]) -> None:
    """Raise ``StaleMeshError``, naming every stale leaf, when a leaf
    array was made in an earlier mesh epoch (before a ``rebuild_mesh``)."""
    epoch = mesh_mod._EPOCH
    stale: List[DistArray] = []
    for i in order:
        arr = _leaf_array(leaves[i])
        if arr is not None and arr._epoch != epoch and \
                not any(arr is s for s in stale):
            stale.append(arr)
    if stale:
        raise mesh_mod.StaleMeshError(
            f"{len(stale)} input DistArray(s) belong to mesh epoch "
            f"{stale[0]._epoch} but the mesh was rebuilt (current epoch "
            f"{epoch}, e.g. after device loss). Re-create them, or call "
            ".rehome() / resilience.elastic.rehome() to migrate them.",
            arrays=stale)


def plan_leaves(plan: _Plan) -> List[Expr]:
    """The leaves of a plan's optimized DAG, in ``plan.leaf_ids``
    order (the leaves its first run was seeded with)."""
    from .optimize import dag_nodes

    by_id = {n._id: n for n in dag_nodes(plan.dag)}
    return [by_id[lid] for lid in plan.leaf_ids]


def walk_env(plan: _Plan, leaves: Sequence[Expr], mesh,
             seeds: Optional[Sequence[Any]] = None) -> Dict[int, Any]:
    """The env a walk of ``plan`` starts from: each of ``leaves`` (in
    ``plan.leaf_ids`` order) seeded as its tensor, or its local value
    on a group mesh (``seeds`` when given: the integrity check's leaves
    moved onto a rotated mesh); the walk frees each value at its last
    consumer (``FREE_AT_LAST_USE``)."""
    free = plan.release if FREE_AT_LAST_USE else None
    if mesh.is_group:
        if seeds is None:
            seeds = [_leaf_local(leaf, mesh) for leaf in leaves]
        env: Dict[int, Any] = GroupEnv(mesh, zip(plan.leaf_ids, seeds))
        if free is not None:
            env.consumers = free[0]
            env.remaining = dict(free[0])
            env.release = free[1]
        return env
    seeds = ((lid, _leaf_arg(leaf))
             for lid, leaf in zip(plan.leaf_ids, leaves))
    if free is None:
        return dict(seeds)
    return _FreeingEnv(seeds, free[1], free[0])


def _dispatch(expr: Expr, plan: _Plan, leaves: List[Expr],
              order: Tuple[int, ...], donated: List[DistArray],
              mesh) -> Any:
    """One run of a plan: the epoch check, the chaos seam (``compile``
    on the plan's first run, ``dispatch`` after), the walk."""
    _check_epochs(leaves, order)
    if faults_mod._ACTIVE is not None:
        faults_mod.fire("dispatch" if plan.warm else "compile")
    result = _run(expr, plan, leaves, order, mesh, donated)
    plan.warm = True
    return result


def _handle_failure(exc: Exception, expr: Expr, plan: _Plan,
                    leaves: List[Expr], order: Tuple[int, ...],
                    donated: List[DistArray], mesh) -> Any:
    """Route a failed run into the resilience policy engine (imported
    here: failures are the cold path)."""
    from ..resilience import engine

    return engine.handle_failure(exc, expr, plan, leaves, order, donated,
                                 mesh)


def _run(expr: Expr, plan: _Plan, leaves: List[Expr],
         order: Tuple[int, ...], mesh,
         donated: Sequence[DistArray] = ()) -> Any:
    """Walk the plan's DAG with the leaf tensors, wrap the outputs, and
    release the donated leaves (those marked by ``donate()`` or named in
    ``donated``) once the walk is done.

    Around the walk: the dispatch watchdog (``FLAGS.dispatch_timeout_s``),
    and under ``FLAGS.audit_numerics`` a probe session (the leaves'
    health words, then each node's). After it: the ``dispatch`` phase's
    seconds into the cost ledger, the sampled profiler
    (``FLAGS.profile_sample_every``), and the watchpoints."""
    group = mesh.is_group
    warm = plan.warm
    with prof.phase("build"):
        env = walk_env(plan, [leaves[i] for i in order], mesh)
        released = []
        dpos = []
        for j, i in enumerate(order):
            arr = _leaf_array(leaves[i])
            if arr is not None and (arr._donate_next or any(
                    arr is d for d in donated)):
                dpos.append(j)
                if not any(arr is r for r in released):
                    released.append(arr)
    pctx = prof.phase("dispatch")
    with pctx, numerics_mod.watchdog("dispatch", plan.report), \
            launch_guard(mesh):
        if numerics_mod._AUDIT_FLAG._value:
            # leaves first (a poisoned input names the LEAF, not its
            # first consumer), then every node as its lowering returns
            with numerics_mod.probe_session(mesh):
                for lid, i in zip(plan.leaf_ids, order):
                    numerics_mod.probe(leaves[i], env[lid], kind="leaf")
                out = plan.dag.lower_local(env) if group \
                    else plan.dag.lower(env)
        else:
            out = plan.dag.lower_local(env) if group else plan.dag.lower(env)
    del env
    if faults_mod._ACTIVE is not None:
        # the chaos sdc seam: a flip armed by this walk's fire() lands
        # on its result; detecting it is the integrity sentinel's job
        out = faults_mod.corrupt_output(out, plan.out_tilings, mesh)
    if integrity_mod._CHECK_FLAG._value:
        # the SDC sentinel: every Nth walk of a plan is checked against
        # a re-walk on a rotated mesh; a corrupt result raises here,
        # before it is wrapped, cached or returned
        integrity_mod.maybe_check(plan, out, [leaves[i] for i in order],
                                  bool(released), mesh)
    with prof.phase("build"):
        for arr in released:
            arr._release_donated()
        if released:
            prof.count("donated_dispatches")
        if plan.report is not None:
            don = plan.report.get("donation")
            if don is not None:
                don["last_donated_args"] = dpos
                if released:
                    don["donated_dispatches"] = (
                        don.get("donated_dispatches", 0) + 1)
        result = _wrap_result(expr, plan, out, mesh)
    if ledger_mod._LEDGER_FLAG._value and plan.report is not None:
        # cost ledger: this walk's host seconds (the launches; nothing
        # waits for the card) next to the plan's predicted DP cost; a
        # plan's first walk (its one-time costs: the JAX package's
        # compile) is kept apart, so calibration fits warm walks only
        ledger_mod.note_dispatch(plan.report.get("plan_key"),
                                 "dispatch" if warm else "compile",
                                 pctx.seconds)
    if profile_mod._SAMPLE_FLAG._value > 0:
        # sampled continuous profiling: every Nth warm walk of a plan is
        # profiled after it, off the result path (the result above is
        # the unprofiled walk's)
        profile_mod.maybe_sample(expr, plan,
                                 "dispatch" if warm else "first",
                                 pctx.seconds, leaves, order,
                                 bool(released), mesh)
    if numerics_mod._WATCHPOINTS:
        # persistent watchpoints (st.watch): re-checked after every walk
        numerics_mod.poll_watchpoints()
    return result


def _wrap_result(expr: Expr, plan: _Plan, out: Any, mesh) -> Any:
    """A walk's outputs as DistArrays under the plan's output tilings,
    seeded into ``expr``'s result cache. Shared by ``_run`` and the
    serve coalescer (one call per request of a batch)."""
    outs = out if plan.is_tuple else (out,)
    wrapped = []
    for o, t in zip(outs, plan.out_tilings):
        if mesh.is_group:
            o = redistribute_mod.relayout(o, t)
            if o.local.device != mesh.device:  # a scalar-only expr
                o = DistArray.from_local(o.local.to(mesh.device), t,
                                         o.shape, mesh)
            wrapped.append(o)
            continue
        if o.device != mesh.device:  # a scalar-only expression
            o = o.to(mesh.device)
        wrapped.append(DistArray(o, t, mesh))
    result: Any = tuple(wrapped) if plan.is_tuple else wrapped[0]
    expr._result = result
    if not plan.is_tuple:
        _maybe_record_write(expr, result)
    return result


_write_expr_cls = None  # lazily bound assign.WriteExpr (import cycle)


def _maybe_record_write(expr: Expr, result: Any) -> None:
    """The assign-expr mutation seam: evaluating ``st.assign(arr, idx,
    v)`` (a WriteExpr over a concrete array) is a functional update of
    that array — stamp the result into the source's Lineage exactly as
    ``DistArray.update()`` does, so the incremental engine sees the
    written region as the only delta."""
    global _write_expr_cls
    if _write_expr_cls is None:
        if type(expr).__name__ != "WriteExpr":
            return
        from .assign import WriteExpr

        _write_expr_cls = WriteExpr
    if not isinstance(expr, _write_expr_cls):
        return
    dst = expr.dst
    if (isinstance(dst, ValExpr) and isinstance(dst.value, DistArray)
            and isinstance(result, DistArray)
            and result.shape == dst.value.shape):
        dst.value._record_mutation(result, expr.region)


def leaf_args(leaves: Sequence[Expr], order: Tuple[int, ...]) -> List[Any]:
    """One request's walk seeds on a logical mesh: the tensor of each
    leaf in ``order`` (a scalar leaf as a 0-d CPU tensor). The serve
    coalescer gathers these per request; the epoch check comes first,
    as in ``_dispatch``."""
    _check_epochs(list(leaves), order)
    return [_leaf_arg(leaves[i]) for i in order]


def evaluate(expr: Expr, donate: Sequence[Any] = ()) -> Any:
    """Evaluate one root.

    Plan-cache hit: one raw-DAG traversal, then a walk of the cached
    optimized DAG — no optimizer rewrites, no re-signing. Miss:
    optimize, sign the optimized DAG, run it, and memoize the plan
    under the raw signature (``_build_plan``, which ``st.explain`` and
    ``st.profile`` share).

    ``donate``: DistArrays (or their evaluated exprs) the caller releases
    to this evaluation. Those that feed it as leaves are invalidated when
    it is done (their tensors are freed once nothing else holds them),
    and any later use raises. ``DistArray.donate()`` marks an array the
    same way without an argument."""
    if expr._result is not None:
        return expr._result
    prof.count("evaluations")
    mesh = mesh_mod.get_mesh()
    donated = _norm_donate(donate)
    with prof.span("evaluate") as esp:
        if trace_mod._TRACE_FLAG._value:  # skip the label f-strings off
            site = expr._site
            esp.set(root=f"{type(expr).__name__}#{expr._id}",
                    site=(f"{site[0]}:{site[1]}" if site else None))
        rctx: Optional[_PlanSigCtx] = None
        plan_key: Optional[Tuple] = None
        if FLAGS.plan_cache:
            with prof.phase("sign"):
                plan_key, rctx = plan_signature(expr, mesh)
            plan = lookup_plan(plan_key)
            if plan is not None:
                prof.count("plan_hits")
                esp.set(cache="hit")
                if plan.governed_rung is not None:
                    # a plan the memory governor judged over budget
                    # runs its rung again
                    gov = memory_mod.redirect_governed(expr, plan,
                                                       donated, mesh)
                    if gov is not memory_mod.NOT_HANDLED:
                        return gov
                if incremental_mod._INC_FLAG._value:
                    # delta-aware path (expr/incremental.py): serve from
                    # the result cache + a dirty sub-plan when lineage
                    # proves most tiles clean; NOT_HANDLED falls through
                    # to the ordinary full dispatch
                    inc = incremental_mod.intercept(
                        expr, plan, rctx.leaves, plan.arg_order, donated,
                        mesh)
                    if inc is not incremental_mod.NOT_HANDLED:
                        expr._result = inc
                        return inc
                try:
                    result = _dispatch(expr, plan, rctx.leaves,
                                       plan.arg_order, donated, mesh)
                except Exception as e:
                    result = _handle_failure(e, expr, plan, rctx.leaves,
                                             plan.arg_order, donated, mesh)
                if incremental_mod._INC_FLAG._value:
                    incremental_mod.note_result(
                        plan, rctx.leaves, plan.arg_order, result, donated,
                        mesh)
                return result
            prof.count("plan_misses")
            esp.set(cache="miss")

        if FLAGS.verify_evaluate:
            # static sanity on the MISS path only (hits stay walk-bound):
            # well-formedness + donation/tiling lints, raising with the
            # user's build site before anything runs
            from ..analysis import check as _check

            with prof.phase("verify"):
                _check(expr, donate=donated)

        plan, dag, leaves = _build_plan(expr, mesh, rctx, plan_key,
                                        store=False)
        if plan is None:
            # the optimizer collapsed the root onto an already-held result
            expr._result = dag._result
            return dag._result
        if FLAGS.verify_evaluate:
            # the static communication audit (analysis/plan_audit.py),
            # miss path only like the DAG check above: findings are
            # logged and counted, never raised; a persist-restored
            # verdict is a dict read
            from ..analysis import plan_audit as plan_audit_mod

            with prof.phase("audit_plan"):
                plan_audit_mod.audit_on_miss(plan, mesh)
        # a new plan's decisions (and its audit) go to the store
        _persist(plan, mesh)
        if plan.report is not None:
            # the predictive memory governor: past the budget, the
            # cheapest sufficient ladder rung runs now, before this
            # plan's first walk
            gov = memory_mod.maybe_degrade(expr, plan, plan_key, donated,
                                           mesh)
            if gov is not memory_mod.NOT_HANDLED:
                return gov
        try:
            result = _dispatch(expr, plan, leaves, plan.arg_order, donated,
                               mesh)
        except Exception as e:
            result = _handle_failure(e, expr, plan, leaves, plan.arg_order,
                                     donated, mesh)
        if plan.stored is not None and plan.warm:
            plan.stored.warm = True
        if incremental_mod._INC_FLAG._value:
            incremental_mod.note_result(plan, leaves, plan.arg_order,
                                        result, donated, mesh)
        return result


def _persist(plan: _Plan, mesh) -> None:
    """Write a new plan to the warm-start store (atomic,
    lease-arbitrated, no-raise; nothing when the store is off)."""
    if plan.persist_digest is not None:
        persist_mod.maybe_store(plan, mesh)
        plan.persist_digest = None
        if plan.stored is not None:
            plan.stored.persist_digest = None


def _build_plan(expr: Expr, mesh, rctx: Optional[_PlanSigCtx],
                plan_key: Optional[Tuple], store: bool = True
                ) -> Tuple[Optional[_Plan], Expr, Optional[List[Expr]]]:
    """The plan-cache MISS pipeline, shared by ``evaluate()``,
    ``st.explain`` and ``st.profile``: optimize -> sign the optimized DAG
    -> output tilings -> the plan report -> memoize the plan under the
    raw signature.

    Returns ``(plan, dag, leaves)`` where ``plan.arg_order`` is the
    identity over the OPTIMIZED leaves (the first run's order) and
    ``plan.stored`` the cached plan (raw order), or None when the plan is
    not cacheable; ``(None, dag, None)`` when the optimized DAG already
    carries a result and there is nothing to run."""
    from . import tiling_pass
    from .optimize import optimize

    # the warm-start store (persist/): before the optimizer, look this
    # raw signature up on disk. A hit's plan decisions replace the
    # tiling DP; a rejected entry degrades to a normal build with the
    # reason on the report. One flag read when the store is off
    p_entry = p_digest = p_reason = None
    if rctx is not None and plan_key is not None:
        p_entry, p_digest, p_reason = persist_mod.lookup(plan_key, mesh)
    passes_report: List[Dict[str, Any]] = []
    tiling_pass.begin(p_entry, p_digest is not None)
    try:
        with prof.phase("optimize"):
            dag = optimize(expr, report=passes_report)
    finally:
        p_pass = tiling_pass.end()
    if dag._result is not None:
        return None, dag, None
    if getattr(degrade_mod._TLS, "rung", None) in ("finer_tiling",
                                                   "fusion_off"):
        # the OOM ladder: the finest divisible tilings on a clone
        degrade_mod.force_finer(dag, mesh)
    with prof.phase("sign"):
        ctx = _SigCtx()
        ctx.of(dag)
    leaves = ctx.leaves
    is_tuple = isinstance(dag, TupleExpr)
    if is_tuple:
        out_tilings = dag.out_tilings()
    else:
        out_tilings = (tiling_mod.sanitize(dag.out_tiling(), dag.shape,
                                           mesh),)
    leaf_ids = tuple(leaf._id for leaf in leaves)
    raw_order: Optional[Tuple[int, ...]] = None
    if rctx is not None:
        raw_order = _arg_order(rctx.leaves, leaves)
    report = build_plan_report(expr, dag, leaves, plan_key, passes_report,
                               out_tilings, raw_order)
    restored = (p_entry is not None and p_pass["outcome"] == "restored"
                and p_entry.matches(out_tilings, is_tuple, raw_order,
                                    len(raw_order or ())))
    if restored and p_entry.memory is not None:
        # the stored memory verdict (its budget is this process's)
        report["memory"] = dict(p_entry.memory,
                                budget_bytes=memory_mod.hbm_budget_bytes())
    else:
        with prof.phase("memory_model"):
            # the memory governor's input: the modeled peaks of this
            # plan (resilience/memory.py), on the miss path only
            report["memory"] = memory_mod.estimate_report(
                dag, out_tilings, mesh)
    if p_digest is not None or p_reason is not None:
        rec: Dict[str, Any] = {"source": "plan", "digest": p_digest}
        if p_reason:
            rec["reason"] = p_reason
        if restored:
            persist_mod.note_hit()
            rec = {"source": "disk", "digest": p_digest}
            if p_entry.audit is not None:
                # a warm restart reads the stored audit, never re-walks
                report["audit"] = p_entry.audit
        elif p_entry is not None:
            persist_mod.reject_entry(p_entry, "meta_mismatch")
            rec["reason"] = "meta_mismatch"
        if p_pass["last"] is not None:
            rec.update(p_pass["last"])
        report["persist"] = rec
        persist_mod.note_build(rec["source"], p_digest, rec.get("reason"))
    release = _release_map(dag, leaf_ids)
    stored: Optional[_Plan] = None
    if rctx is not None:
        if raw_order is not None:
            # the winner of a store race is what later lookups see
            fresh = _Plan(dag, leaf_ids, out_tilings, is_tuple, raw_order,
                          plan_key, report)
            fresh.release = release
            stored = store_plan(plan_key, fresh)
            report = stored.report
            if p_digest is not None and not restored:
                # written to the store once built (_persist)
                stored.persist_digest = p_digest
        else:
            prof.count("plan_uncacheable")
    plan = _Plan(dag, leaf_ids, out_tilings, is_tuple,
                 tuple(range(len(leaves))), plan_key, report)
    plan.release = release
    plan.stored = stored
    if stored is not None:
        plan.persist_digest = stored.persist_digest
    # cost ledger: this plan's predictions (DP cost + per-class
    # components), so measured walks land next to them. Miss path only
    ledger_mod.note_plan(stored if stored is not None else plan)
    # autotune hot-plan templates (obs/monitor.py): under the
    # re-calibration daemon, a result-free clone of this miss's raw DAG
    # keyed by its ledger digest, so drift-triggered replans run off
    # the hot path. One flag read when the daemon is off; miss path only
    if monitor_mod._AUTOTUNE_FLAG._value:
        monitor_mod.note_plan_built(stored if stored is not None else plan,
                                    expr)
    # the digest -> node table, computed LAST, from the final node state
    report["scope_digests"] = scope_digest_table(dag)
    if store:
        _persist(plan, mesh)
    return plan, dag, leaves


_eval_shape_cache: Dict[Tuple, Any] = {}


class ShapeDtype:
    """Result of :func:`eval_shape_of`: a shape and a numpy dtype."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape: Tuple[int, ...], dtype: np.dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype


def eval_shape_of(fn: Callable, *inputs: Expr, cache_key: Any = None,
                  **kw) -> ShapeDtype:
    """Exact result shape/dtype by running ``fn`` on ``meta`` tensors
    (shapes and dtypes only: no data, no FLOPs). Scalars enter as 0-d
    tensors, as they do at run time.

    With ``cache_key`` (a hashable identity for ``fn``), results are
    memoized on input shapes/dtypes — iterative applications rebuild
    identical DAG structures every step."""
    key = None
    if cache_key is not None:
        key = (cache_key,
               tuple((i.shape, str(i.dtype),
                      i.weak_kind if isinstance(i, ScalarExpr) else None)
                     for i in inputs))
        hit = _eval_shape_cache.get(key)
        if hit is not None:
            return hit
    specs = []
    for i in inputs:
        tdt = i.tdtype if isinstance(i, ScalarExpr) else \
            dtypes.to_torch(i.dtype)
        specs.append(torch.empty(i.shape, dtype=tdt, device="meta"))
    out = fn(*specs, **kw)
    res = ShapeDtype(out.shape, dtypes.to_numpy(out.dtype))
    if key is not None and len(_eval_shape_cache) < 4096:
        _eval_shape_cache[key] = res
    return res


# Bottom-bound seam: the incremental engine (expr/incremental.py) needs
# every Expr type above, and its own expr imports are lazy, so binding it
# here closes the cycle. The evaluate() paths read
# incremental_mod._INC_FLAG._value — one attribute-chain read when
# FLAGS.incremental is off — and a benchmark may swap this binding for a
# null shim to price that read.
from . import incremental as incremental_mod  # noqa: E402
