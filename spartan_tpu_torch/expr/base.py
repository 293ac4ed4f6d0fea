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
from ..obs import trace as trace_mod
from ..parallel import mesh as mesh_mod
from ..parallel import redistribute as redistribute_mod
from ..resilience import degrade as degrade_mod
from ..resilience import faults as faults_mod
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
            try:
                val = (self._lower_local(env) if self._lower_local is not None
                       else NotImplemented)
                if val is NotImplemented:
                    prev, env.site = env.site, type(self).__name__
                    try:
                        val = _wrap_whole(self._lower(env), self, env.mesh)
                    finally:
                        env.site = prev
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
            env[self._id] = val
        return env[self._id]

    def lower(self, env: Dict[int, Any]) -> Any:
        if type(env) is GroupEnv:
            # a lowering without a local rule reads this child whole
            return _whole(self.lower_local(env), env.site)
        if self._id not in env:
            try:
                if _ANNOTATE_FLAG._value and trace_mod.profiler_active():
                    # device profiles attribute this node's kernels to
                    # it; a range per node costs microseconds, so only
                    # while a profiler records
                    with trace_mod.named_scope(
                            f"{type(self).__name__}#{self._id}"):
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
            if self._forced_tiling is not None:
                # smart tiling chose this node's layout: the
                # redistribution seam returns ``val`` itself unless the
                # planner is on and predicts an explicit schedule from
                # the node's natural layout (then it moves the logical
                # shards and the values stay bit-equal)
                val = redistribute_mod.constrain(
                    val, self._forced_tiling, mesh_mod.get_mesh(),
                    src=self._default_tiling())
            env[self._id] = val
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

    # -- evaluation -----------------------------------------------------

    def evaluate(self, donate: Sequence[Any] = ()) -> DistArray:
        return evaluate(self, donate=donate)

    def force(self, donate: Sequence[Any] = ()) -> DistArray:
        return evaluate(self, donate=donate)

    def glom(self) -> np.ndarray:
        return self.evaluate().glom()

    def invalidate(self) -> None:
        """Drop this node's cached result; the next evaluate recomputes
        it from the DAG (its lineage)."""
        self._result = None

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
                 "key", "report", "warm")

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


# The plan cache is an LRU shared by every thread that evaluates;
# _cache_lock guards the dict operations only, never a DAG walk.
_PLAN_CACHE_MAX = 512
_plan_cache: "OrderedDict[Tuple, _Plan]" = OrderedDict()
_cache_lock = threading.Lock()
_PLAN_COUNTERS = ("plan_hits", "plan_misses", "evaluations")


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


def clear_plan_cache() -> None:
    with _cache_lock:
        _plan_cache.clear()


def lookup_plan(plan_key: Tuple) -> Optional[_Plan]:
    with _cache_lock:
        plan = _plan_cache.get(plan_key)
        if plan is not None:
            _plan_cache.move_to_end(plan_key)
        return plan


def store_plan(plan_key: Tuple, plan: _Plan) -> _Plan:
    """Insert with LRU eviction; the first writer wins a race."""
    with _cache_lock:
        cur = _plan_cache.get(plan_key)
        if cur is not None:
            return cur
        _plan_cache[plan_key] = plan
        while len(_plan_cache) > _PLAN_CACHE_MAX:
            _plan_cache.popitem(last=False)
    return plan


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
        key = (tuple(p.name for p in passes if p.enabled()),
               FLAGS.tiling_compute_weight, FLAGS.tiling_flop_weight,
               FLAGS.tiling_operand_move_weight,
               FLAGS.tiling_memory_weight,
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
    if stale:
        prof.count("plan_evictions", len(stale))
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


class GroupEnv(dict):
    """The env of a plan walk on a group mesh: node id -> the node's
    local value. ``site`` names the node whose lowering (no local rule)
    is reading its children whole; ``mesh`` is the group mesh."""

    __slots__ = ("site", "mesh")

    def __init__(self, mesh, items=()):
        super().__init__(items)
        self.site = "evaluate"
        self.mesh = mesh

    def copy(self) -> "GroupEnv":
        out = GroupEnv(self.mesh, self)
        out.site = self.site
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


def _report(expr: Expr, plan_key: Optional[Tuple]) -> Dict[str, Any]:
    from ..resilience.engine import key_hash

    site = expr._site
    return {"plan_key": key_hash(plan_key),
            "root": f"{type(expr).__name__}#{expr._id}",
            "site": f"{site[0]}:{site[1]}" if site else None}


def _run(expr: Expr, plan: _Plan, leaves: List[Expr],
         order: Tuple[int, ...], mesh,
         donated: Sequence[DistArray] = ()) -> Any:
    """Walk the plan's DAG with the leaf tensors, wrap the outputs, and
    release the donated leaves (those marked by ``donate()`` or named in
    ``donated``) once the walk is done."""
    group = mesh.is_group
    with prof.phase("build"):
        if group:
            env: Dict[int, Any] = GroupEnv(mesh, (
                (lid, _leaf_local(leaves[i], mesh))
                for lid, i in zip(plan.leaf_ids, order)))
        else:
            env = {lid: _leaf_arg(leaves[i])
                   for lid, i in zip(plan.leaf_ids, order)}
        released = []
        for i in order:
            arr = _leaf_array(leaves[i])
            if arr is not None and (arr._donate_next or any(
                    arr is d for d in donated)) and \
                    not any(arr is r for r in released):
                released.append(arr)
    with prof.phase("dispatch"):
        out = plan.dag.lower_local(env) if group else plan.dag.lower(env)
    del env
    with prof.phase("build"):
        for arr in released:
            arr._release_donated()
        if released:
            prof.count("donated_dispatches")
        outs = out if plan.is_tuple else (out,)
        wrapped = []
        for o, t in zip(outs, plan.out_tilings):
            if group:
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
    return result


def evaluate(expr: Expr, donate: Sequence[Any] = ()) -> Any:
    """Evaluate one root.

    Plan-cache hit: one raw-DAG traversal, then a walk of the cached
    optimized DAG — no optimizer rewrites, no re-signing. Miss:
    optimize, sign the optimized DAG, run it, and memoize the plan
    under the raw signature.

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
                try:
                    return _dispatch(expr, plan, rctx.leaves,
                                     plan.arg_order, donated, mesh)
                except Exception as e:
                    return _handle_failure(e, expr, plan, rctx.leaves,
                                           plan.arg_order, donated, mesh)
            prof.count("plan_misses")
            esp.set(cache="miss")

        from .optimize import optimize

        with prof.phase("optimize"):
            dag = optimize(expr)
        if dag._result is not None:
            # the optimizer collapsed the root onto an already-held result
            expr._result = dag._result
            return dag._result
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
        report = _report(expr, plan_key)
        stored: Optional[_Plan] = None
        if rctx is not None:
            raw_order = _arg_order(rctx.leaves, leaves)
            if raw_order is not None:
                stored = store_plan(plan_key, _Plan(
                    dag, leaf_ids, out_tilings, is_tuple, raw_order,
                    plan_key, report))
                report = stored.report
        plan = _Plan(dag, leaf_ids, out_tilings, is_tuple,
                     tuple(range(len(leaves))), plan_key, report)
        try:
            result = _dispatch(expr, plan, leaves, plan.arg_order, donated,
                               mesh)
        except Exception as e:
            result = _handle_failure(e, expr, plan, leaves, plan.arg_order,
                                     donated, mesh)
        if stored is not None and plan.warm:
            stored.warm = True
        return result


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
