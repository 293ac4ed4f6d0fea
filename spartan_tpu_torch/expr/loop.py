"""Iteration: ``loop(n, body_fn, *init)`` (port of
``spartan_tpu/expr/loop.py``).

The body DAG is built once over symbolic carries; evaluating the loop
runs it ``n`` times — the JAX package's ``lax.fori_loop`` becomes a
Python loop over the body DAG, with the carries rebound each step. The
whole loop is still one ``evaluate()`` (one plan, one plan-cache entry),
and the iteration count is a scalar leaf, so changing it does not
re-plan. Nothing in the loop waits for the device.

``donate_init`` releases the init arrays to the loop's evaluation, and
``checkpoint_every`` / ``checkpoint_path`` / ``resume`` run the loop in
snapshotted segments (``resilience/loop_ckpt.py``). ``health``,
``early_exit`` and ``stall_tol`` need the numerics loop series, which is
not ported (ROADMAP A4): they raise ``NotImplementedError``.

Forcing a loop is one ``loop`` span; with ``FLAGS.trace_loop_steps``
each iteration adds a ``loop_step`` span (host marks between the
iterations' launches). ``FLAGS.shard_loop_carries`` gives large
replicated carries the default divisible tiling for the whole loop, as
in the JAX package: the inits and every iteration's outputs pass
through ``parallel/redistribute.constrain`` to that tiling.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from ..obs import trace as obs_trace
from ..parallel import redistribute as redist_mod
from ..utils import dtypes
from ..utils import profiling as prof
from ..utils.config import FLAGS
from .base import Expr, TupleExpr, ValExpr, as_expr, evaluate


def _carry_shard_tiling(ini: "Expr", shape: Tuple[int, ...],
                        dtype: Any) -> Optional[Tiling]:
    """The sharded layout a loop carry gets under
    ``FLAGS.shard_loop_carries``, or None to keep the init's own
    tiling: only replicated, large-enough carries with a divisible
    axis are sharded (the default_tiling rule — largest divisible axis
    onto the mesh row axis)."""
    if not FLAGS.shard_loop_carries or not shape:
        return None
    if any(a is not None for a in ini.out_tiling().axes):
        return None  # already tiled: the user/DP chose a layout
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if nbytes < FLAGS.shard_carry_min_bytes:
        return None
    t = tiling_mod.default_tiling(shape)
    if all(a is None for a in t.axes):
        return None  # nothing divides: replication is all there is
    return t


class CarryExpr(Expr):
    """Symbolic leaf bound to the loop-carried value inside the body DAG.
    Never evaluated on its own: ``LoopExpr`` seeds it each step."""

    def __init__(self, shape: Tuple[int, ...], dtype: Any, slot: int,
                 tiling: Tiling, sharded: bool = False):
        super().__init__(shape, dtype)
        self.slot = slot
        self._tiling = tiling
        # True when FLAGS.shard_loop_carries overrode a replicated init:
        # the loop constrains this carry to _tiling on entry and after
        # every iteration
        self.sharded = sharded

    def children(self) -> Tuple[Expr, ...]:
        return ()

    def replace_children(self, new_children: Tuple[Expr, ...]) -> "CarryExpr":
        return self

    def _lower(self, env: Dict[int, Any]) -> Any:
        raise RuntimeError(
            "loop carry used outside its loop body (exprs built from a "
            "loop body's carry cannot escape the body function)")

    def _sig(self, ctx) -> Tuple:
        # de Bruijn level relative to the enclosing loop binders (frames
        # pushed by LoopExpr._sig): nested loops with same-shaped carries
        # must NOT collide in the plan cache
        frames = getattr(ctx, "_loop_binders", ())
        for level, frame in enumerate(reversed(frames)):
            if self._id in frame:
                return ("carry", level, self.slot, self._shape,
                        str(self._dtype))
        # escaped carry: unique per instance so no plan can alias it
        return ("carry-escaped", self._id)

    def _default_tiling(self) -> Tiling:
        return self._tiling


class LoopIndexExpr(CarryExpr):
    """Symbolic leaf bound to the iteration index (int32)."""

    def __init__(self) -> None:
        super().__init__((), np.int32, -1, tiling_mod.replicated(0))


class LoopExpr(Expr):
    """Iterates a body DAG ``n`` times. Internal node — consumed through
    ``LoopItemExpr`` projections."""

    def __init__(self, n_expr: Expr, init: Tuple[Expr, ...],
                 carries: Tuple[CarryExpr, ...],
                 body_roots: Tuple[Expr, ...],
                 index_expr: Optional[LoopIndexExpr]):
        if len(init) != len(body_roots):
            raise ValueError(
                f"loop body returned {len(body_roots)} values for "
                f"{len(init)} carried inputs")
        for i, (ini, b) in enumerate(zip(init, body_roots)):
            if b.shape != ini.shape:
                raise ValueError(
                    f"loop carry {i} must keep its shape: init "
                    f"{ini.shape}, body returned {b.shape}")
        self.n_expr = n_expr
        self.init = init
        self.carries = carries
        self.body_roots = body_roots
        self.index_expr = index_expr
        self._items: Tuple["LoopItemExpr", ...] = ()
        super().__init__((), body_roots[0].dtype)

    def children(self) -> Tuple[Expr, ...]:
        return (self.n_expr,) + self.init + self.body_roots

    def replace_children(self, new_children: Tuple[Expr, ...]) -> "LoopExpr":
        k = len(self.init)
        return LoopExpr(new_children[0], tuple(new_children[1:1 + k]),
                        self.carries, tuple(new_children[1 + k:]),
                        self.index_expr)

    def _constrain(self, vals: Tuple[Any, ...],
                   srcs: Tuple[Tiling, ...]) -> Tuple[Any, ...]:
        """Sharded carries to their loop tiling (a no-op on the value
        unless the redistribution planner runs a schedule)."""
        return tuple(
            redist_mod.constrain(v, ce._tiling, src=t) if ce.sharded else v
            for v, ce, t in zip(vals, self.carries, srcs))

    def _lower(self, env: Dict[int, Any]) -> Any:
        n = int(self.n_expr.lower(env))
        # cast inits to the body's (stable) carry dtypes
        carry = tuple(
            i.lower(env).to(dtypes.to_torch(b.dtype))
            for i, b in zip(self.init, self.body_roots))
        sharded = any(c.sharded for c in self.carries)
        if sharded:
            carry = self._constrain(carry, tuple(i.out_tiling()
                                                 for i in self.init))
        trace_steps = FLAGS.trace_loop_steps
        label = f"loop#{self._id}"
        if trace_steps:
            obs_trace.loop_steps_begin(label)  # anchor step 0's span
        for i in range(n):
            benv = dict(env)
            if self.index_expr is not None:
                benv[self.index_expr._id] = torch.tensor(i,
                                                         dtype=torch.int32)
            for ce, cv in zip(self.carries, carry):
                benv[ce._id] = cv
            with obs_trace.named_scope("st_loop_body") \
                    if obs_trace.profiler_active() \
                    else contextlib.nullcontext():
                carry = tuple(b.lower(benv) for b in self.body_roots)
            if sharded:
                carry = self._constrain(carry, tuple(
                    b.out_tiling() for b in self.body_roots))
            if trace_steps:
                obs_trace.record_loop_step(label, i)
        return carry

    def _sig(self, ctx) -> Tuple:
        # the carry-sharding layout is structural: the chosen layouts
        # are part of the signature (None when carry sharding is off)
        shard = tuple(c._tiling.axes if c.sharded else None
                      for c in self.carries) \
            if any(c.sharded for c in self.carries) else None
        head = (("loop", bool(FLAGS.trace_loop_steps), shard,
                 ctx.of(self.n_expr))
                + tuple(ctx.of(i) for i in self.init))
        # bind the carries for the body traversal (see CarryExpr._sig)
        frames = getattr(ctx, "_loop_binders", None)
        if frames is None:
            frames = []
            ctx._loop_binders = frames
        frame = {c._id: c.slot for c in self.carries}
        if self.index_expr is not None:
            frame[self.index_expr._id] = -1
        frames.append(frame)
        try:
            body = tuple(ctx.of(b) for b in self.body_roots)
        finally:
            frames.pop()
        return head + body

    def _default_tiling(self) -> Tiling:
        return tiling_mod.replicated(0)


class LoopItemExpr(Expr):
    """Projection of one carried value out of a ``LoopExpr``. Forcing any
    item of a multi-carry loop evaluates ALL sibling items in one plan
    (one loop execution) and seeds every sibling's result."""

    def __init__(self, loop: LoopExpr, idx: int):
        self.loop = loop
        self.idx = idx
        b = loop.body_roots[idx]
        super().__init__(b.shape, b.dtype)

    def evaluate(self, donate=()):
        if self._result is not None:
            return self._result
        # donate_init: the init arrays feed only this loop and are
        # released with its evaluation
        donate = tuple(donate) + getattr(self.loop, "_donate_init", ())
        n = self.loop.n_expr
        label = f"loop#{self.loop._id}"
        with prof.span("loop", loop=label, n=getattr(n, "pyvalue", None),
                       carries=len(self.loop.init)):
            siblings = self.loop._items
            if len(siblings) > 1:
                results = evaluate(TupleExpr(siblings), donate=donate)
                for item, res in zip(siblings, results):
                    item._result = res
                return self._result
            return evaluate(self, donate=donate)

    force = evaluate

    def children(self) -> Tuple[Expr, ...]:
        return (self.loop,)

    def replace_children(self, new_children: Tuple[Expr, ...]
                         ) -> "LoopItemExpr":
        return LoopItemExpr(new_children[0], self.idx)

    def _lower(self, env: Dict[int, Any]) -> Any:
        return self.loop.lower(env)[self.idx]

    def _sig(self, ctx) -> Tuple:
        return ("loopitem", self.idx, ctx.of(self.loop))

    def _default_tiling(self) -> Tiling:
        carry = self.loop.carries[self.idx]
        if carry.sharded:
            # the loop keeps this carry in its sharded layout
            return carry._tiling
        return self.loop.body_roots[self.idx].out_tiling()


def loop(n_iters: Any, body_fn: Callable, *init: Any,
         with_index: bool = False, donate_init: bool = False,
         health: bool = False, early_exit: bool = False,
         stall_tol: float = 0.0, checkpoint_every: int = 0,
         checkpoint_path: Optional[str] = None,
         resume: Optional[str] = None):
    """Iterate ``body_fn`` ``n_iters`` times.

    ``body_fn`` receives one lazy expr per carried value (prepended with
    the iteration-index expr when ``with_index``) and returns the same
    number of exprs with unchanged shapes. Returns one lazy expr per
    carried value (a single expr for a single carry). Example::

        w = st.loop(100, lambda w: w - 0.1 * grad(x, y, w), w0)

    ``donate_init``: release the init DistArrays to the loop's
    evaluation; using them afterwards raises.

    ``checkpoint_every`` / ``checkpoint_path`` / ``resume``: run the loop
    in segments of ``checkpoint_every`` iterations, snapshot the carries
    to ``checkpoint_path`` after each, restore the last snapshot when a
    segment fails with a transient or I/O error, and with
    ``resume=path`` continue a killed run from its last snapshot. The
    segments change no arithmetic: the final carries are the same bits as
    the uninterrupted loop's. Checkpointed loops run when called and
    return the final carries as ``ValExpr`` leaves.

    ``health``, ``early_exit`` and ``stall_tol`` raise
    ``NotImplementedError``: they need the numerics loop series
    (ROADMAP A4).
    """
    if health or early_exit or stall_tol:
        raise NotImplementedError(
            "st.loop(health=, early_exit=, stall_tol=) needs the numerics "
            "loop series (obs/numerics.py), which the port does not have "
            "yet (ROADMAP A4)")
    if checkpoint_every or resume is not None:
        from ..resilience.loop_ckpt import checkpointed_loop

        return checkpointed_loop(
            n_iters, body_fn, init, with_index=with_index,
            donate_init=donate_init, every=int(checkpoint_every or 0),
            path=checkpoint_path, resume=resume)
    init_exprs = tuple(as_expr(i) for i in init)
    if not init_exprs:
        raise ValueError("loop needs at least one carried value")
    index_expr = LoopIndexExpr() if with_index else None

    def build(carry_specs: Tuple[Tuple[Tuple[int, ...], Any], ...]):
        carries = []
        for slot, ((shape, dtype), ini) in enumerate(
                zip(carry_specs, init_exprs)):
            shard_t = _carry_shard_tiling(ini, shape, dtype)
            carries.append(CarryExpr(
                shape, dtype, slot,
                shard_t if shard_t is not None else ini.out_tiling(),
                sharded=shard_t is not None))
        carries = tuple(carries)
        args = ((index_expr,) if with_index else ()) + carries
        out = body_fn(*args)
        if not isinstance(out, (tuple, list)):
            out = (out,)
        return carries, tuple(as_expr(o) for o in out)

    specs = tuple((i.shape, i.dtype) for i in init_exprs)
    carries, body_roots = build(specs)
    out_specs = tuple((b.shape, b.dtype) for b in body_roots)
    if len(out_specs) == len(specs) and out_specs != specs:
        # dtype promotion in the body (e.g. int init, float update):
        # rebuild with the promoted carry dtypes and require a fixpoint
        carries, body_roots = build(out_specs)
        specs2 = tuple((b.shape, b.dtype) for b in body_roots)
        if specs2 != out_specs:
            raise TypeError(
                f"loop body dtypes do not stabilize: {specs} -> "
                f"{out_specs} -> {specs2}")

    le = LoopExpr(as_expr(n_iters), init_exprs, carries, body_roots,
                  index_expr)
    items = tuple(LoopItemExpr(le, i) for i in range(len(init_exprs)))
    le._items = items  # sibling set for one-plan multi-carry forcing
    if donate_init:
        le._donate_init = tuple(
            i.value for i in init_exprs if isinstance(i, ValExpr))
    return items[0] if len(items) == 1 else items
