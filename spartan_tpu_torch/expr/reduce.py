"""Reduction expressions (port of ``spartan_tpu/expr/reduce.py``).

``ReduceExpr`` reduces over axes, optionally through a fused pre-reduce
elementwise tree (what the reduce-map fusion pass builds). Dtypes follow
the JAX package: sums and products of unsigned integers are uint32, of
signed integers and bool int32; means of integers are float32, all/any
give bool, and argmin/argmax give int32 with the first index winning
ties (bool compared as int32). ``GeneralReduceExpr`` is the
reference's user reduction: a torch ``local_reduce_fn(block, axis=...)``
applied to the whole tensor.

On a group mesh a ``ReduceExpr`` whose pre-reduce tree is elementwise
reduces the rank's block and combines the partials over the mesh axes
that tile a reduced dim, and only those (a replicated axis would count
a block twice): sums and products through an all-reduce (integers in
int64, so int32 wraps as in one pass), max/min/all/any through max/min,
``mean`` as a sum over the global count, and argmax/argmin as (value,
global index) pairs gathered and merged with the lowest index winning
ties and NaN winning as in one pass. An empty block (a dim shorter than
its tiles) contributes the op's identity.

A ``GeneralReduceExpr`` with an ``accumulate_fn`` applies its
``local_reduce_fn`` to the rank's block, gathers the partials over the
mesh axes that tile a reduced dim and folds them with
``accumulate_fn`` in position order, so every rank gets the same bits.
Without one the combiner is unknown and it reads its operand whole.
"""

from __future__ import annotations

import builtins
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from ..utils import dtypes
from .base import Expr, as_expr, eval_shape_of, fn_key
from .local import LocalExpr, LocalInput

Axis = Union[None, int, Tuple[int, ...]]

REDUCE_OPS = ("sum", "prod", "max", "min", "mean", "all", "any",
              "argmax", "argmin")
_NO_KEEPDIMS = ("argmax", "argmin")


def _norm_axis(axis: Axis, ndim: int) -> Optional[Tuple[int, ...]]:
    if axis is None:
        return None
    if isinstance(axis, (int, np.integer)):
        axis = (int(axis),)
    return tuple(sorted(a % ndim for a in axis))


def reduce_tensor(op: str, x: torch.Tensor, axis: Optional[Tuple[int, ...]],
                  keepdims: bool) -> torch.Tensor:
    """One named reduction of ``x`` over ``axis`` (None = all axes)."""
    if op in _NO_KEEPDIMS:
        fn = torch.argmax if op == "argmax" else torch.argmin
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        if axis is None:
            out = dtypes.call(fn, x.reshape(-1))
        else:
            if len(axis) != 1:
                raise ValueError(f"{op} takes one axis, got {axis}")
            out = dtypes.call(fn, x, dim=axis[0])
        return out.to(torch.int32)
    dims = tuple(range(x.ndim)) if axis is None else axis
    integral = not (x.dtype.is_floating_point or x.dtype.is_complex)
    if op in ("sum", "prod") and integral:
        # int32 or uint32 results, summed in a type torch has kernels for
        # (int64 wraps to the same low 32 bits)
        acc = torch.uint32 if dtypes.is_unsigned(x.dtype) else torch.int32
        wide = torch.int64 if acc == torch.uint32 else torch.int32
        x = x.to(wide)
        if op == "sum":
            return torch.sum(x, dim=dims, keepdim=keepdims,
                             dtype=wide).to(acc)
        for d in sorted(dims, reverse=True):
            x = torch.prod(x, dim=d, keepdim=keepdims)
        return x.to(acc)
    if op == "sum":
        return torch.sum(x, dim=dims, keepdim=keepdims)
    if op == "prod":
        for d in sorted(dims, reverse=True):
            x = torch.prod(x, dim=d, keepdim=keepdims)
        return x
    if op in ("all", "any"):
        fn = torch.all if op == "all" else torch.any
        return fn(x.to(torch.bool), dim=dims, keepdim=keepdims)
    if op == "mean":
        if integral:
            x = x.to(torch.float32)
        return torch.mean(x, dim=dims, keepdim=keepdims)
    if op == "max":
        return dtypes.call(torch.amax, x, dim=dims, keepdim=keepdims)
    if op == "min":
        return dtypes.call(torch.amin, x, dim=dims, keepdim=keepdims)
    raise ValueError(f"unknown reduction {op!r}")


class ReduceExpr(Expr):
    """Built-in reduction over axes, with an optional fused pre-reduce
    elementwise tree.

    The plain form reduces a single child. The fused form — produced by
    the reduce-map fusion pass — holds the producer MapExpr's inputs
    directly plus its LocalExpr tree as ``pre``, so ``(a * b).sum()`` is
    ONE DAG node."""

    def __init__(self, input: Optional[Expr], op: str, axis: Axis = None,
                 keepdims: bool = False, dtype: Any = None,
                 _inputs: Optional[Tuple[Expr, ...]] = None,
                 _pre: Optional[LocalExpr] = None):
        if op not in REDUCE_OPS:
            raise ValueError(f"unknown reduction {op!r}")
        if _inputs is not None:
            self.inputs: Tuple[Expr, ...] = tuple(_inputs)
            self.pre: LocalExpr = _pre if _pre is not None else LocalInput(0)
        else:
            self.inputs = (input,)
            self.pre = LocalInput(0)
        self.op = op
        pre_out = eval_shape_of(lambda *xs: self.pre.emit(xs),
                                *self.inputs,
                                cache_key=("reduce_pre", self.pre.key()))
        self._pre_shape = pre_out.shape
        self._pre_dtype = pre_out.dtype
        self.axis = _norm_axis(axis, len(pre_out.shape))
        self.keepdims = bool(keepdims)
        self.req_dtype = np.dtype(dtype) if dtype is not None else None
        out = eval_shape_of(lambda *xs: self._emit(xs), *self.inputs,
                            cache_key=("reduce", self.pre.key(), op,
                                       self.axis, self.keepdims,
                                       str(self.req_dtype)))
        super().__init__(out.shape, out.dtype)

    def _emit(self, vals: Sequence[Any]) -> Any:
        x = self.pre.emit(tuple(vals))
        out = reduce_tensor(self.op, x, self.axis, self.keepdims)
        if self.req_dtype is not None:
            out = out.to(dtypes.to_torch(self.req_dtype))
        return out

    def children(self) -> Tuple[Expr, ...]:
        return self.inputs

    def replace_children(self, new_children: Tuple[Expr, ...]) -> "ReduceExpr":
        return ReduceExpr(None, self.op, self.axis, self.keepdims,
                          self.req_dtype, _inputs=new_children,
                          _pre=self.pre)

    def with_fused(self, inputs: Sequence[Expr],
                   pre: LocalExpr) -> "ReduceExpr":
        """Rebuild with map producers spliced into the pre-reduce tree
        (the reduce-map fusion rewrite)."""
        return ReduceExpr(None, self.op, self.axis, self.keepdims,
                          self.req_dtype, _inputs=tuple(inputs), _pre=pre)

    def _lower(self, env: Dict[int, Any]) -> Any:
        return self._emit([c.lower(env) for c in self.inputs])

    def cost(self) -> Dict[str, float]:
        """The fused pre-reduce tree's ops per element of its output,
        then one FLOP per element folded away (``n - 1`` for a whole
        reduction of ``n``; nine for an argmax or argmin, XLA's
        compare-and-select of a value and an index; a mean adds its
        divide per output element);
        each input read once, the output written once."""
        from .base import io_bytes
        from .local import op_counts

        pre = int(np.prod(self._pre_shape)) if self._pre_shape else 1
        f, t = op_counts(self.pre)
        red = float(pre - self.size)
        if self.op in ("argmax", "argmin"):
            # XLA's variadic (value, index) reduce: 9 ops a compare
            red *= 9.0
        if self.op == "mean":
            red += self.size
        return {"flops": float(f) * pre + red,
                "transcendentals": float(t) * pre,
                "bytes accessed": io_bytes(self.inputs, self)}

    def _lower_local(self, env) -> Any:
        from .map import emit_blocks

        shape = self._pre_shape
        got = emit_blocks(self.pre, self.inputs, shape, self._pre_tiling(),
                          env, "ReduceExpr")
        if got is NotImplemented:
            return got
        from ..array.distarray import DistArray
        from ..parallel import collectives as coll

        mesh = env.mesh
        x, tp = got
        ext = tp.block_extent(shape, mesh)
        dims = tuple(range(len(shape))) if self.axis is None else self.axis
        over = [sub for d in dims for sub in tiling_mod.mesh_axes_of(
            tp.axes[d])]
        empty = builtins.any(ext.shape[d] == 0 for d in dims)
        op = self.op
        if op in _NO_KEEPDIMS:
            out = _arg_local(op, x, self.axis, ext, shape, over, mesh, empty)
        elif op == "mean":
            xs = x.to(torch.float32) if not (x.dtype.is_floating_point
                                             or x.dtype.is_complex) else x
            part = coll.reduce_over(torch.sum(xs, dim=dims, keepdim=True),
                                    over, "add", mesh)
            count = int(np.prod([shape[d] for d in dims], dtype=np.int64))
            out = part / count
        else:
            if empty and op in ("max", "min"):
                keep = [1 if d in dims else n for d, n in
                        enumerate(ext.shape)]
                part = torch.full(keep, _identity(op, x.dtype),
                                  dtype=x.dtype, device=x.device)
            else:
                part = reduce_tensor(op, x, dims, True)
            comb = {"sum": "add", "prod": "prod", "max": "max", "min": "min",
                    "all": "min", "any": "max"}[op]
            out = coll.reduce_over(part, over, comb, mesh)
        if not (self.keepdims and op not in _NO_KEEPDIMS):
            out = out.reshape([n for d, n in enumerate(out.shape)
                               if d not in dims])
        if self.req_dtype is not None:
            out = out.to(dtypes.to_torch(self.req_dtype))
        return DistArray.from_local(out, self._out_of(tp), self.shape, mesh)

    def _sig(self, ctx) -> Tuple:
        return (("reduce", self.op, self.axis, self.keepdims,
                 str(self.req_dtype), self.pre.key())
                + tuple(ctx.of(c) for c in self.inputs))

    def _pre_tiling(self) -> Tiling:
        """Tiling of the (virtual) pre-reduce value: the largest
        same-shaped input donates, mirroring MapExpr._default_tiling."""
        best: Optional[Tiling] = None
        for c in self.inputs:
            if c.shape == self._pre_shape:
                t = c.out_tiling()
                if t.sharded_axes():
                    return t
                best = best or t
        if best is not None:
            return best
        return tiling_mod.default_tiling(self._pre_shape)

    def _default_tiling(self) -> Tiling:
        return self._out_of(self._pre_tiling())

    def _out_of(self, t: Tiling) -> Tiling:
        """The output's tiling when the pre-reduce value is tiled
        ``t``."""
        if self.axis is None:
            return tiling_mod.replicated(self.ndim)
        if self.keepdims and self.op not in _NO_KEEPDIMS:
            for a in self.axis:
                t = (t.whole(a) if isinstance(t, tiling_mod.BoxTiling)
                     else t.with_axis(a, None))
            return t
        for a in reversed(self.axis):
            t = t.drop_axis(a)
        return t


def _identity(op: str, dtype: torch.dtype):
    """The value an empty block contributes to a max (min)."""
    lo = op in ("max", "argmax")
    if dtype == torch.bool:
        return not lo
    if dtype.is_floating_point:
        return float("-inf") if lo else float("inf")
    info = torch.iinfo(dtype)
    return info.min if lo else info.max


def _better(op: str, v: torch.Tensor, i: torch.Tensor, bv: torch.Tensor,
            bi: torch.Tensor) -> torch.Tensor:
    """Where (v, i) beats the best (bv, bi) so far: a larger (smaller)
    value, a NaN over a number, and the lower index among equals."""
    strict = v > bv if op == "argmax" else v < bv
    tie = (v == bv) & (i < bi)
    if v.dtype.is_floating_point:
        vn, bn = torch.isnan(v), torch.isnan(bv)
        return (strict & ~bn) | (tie & ~bn) | (vn & ~bn) | (vn & bn
                                                            & (i < bi))
    return strict | tie


def _arg_local(op: str, x: torch.Tensor, axis, ext, shape, over, mesh,
               empty: bool) -> torch.Tensor:
    """argmax/argmin of the rank's block as (value, global index) pairs,
    merged over the axes ``over``; returns the int32 global index with
    the reduced dim(s) kept as size 1 (the flattened index, 0-d, for
    ``axis=None``)."""
    from ..parallel import collectives as coll

    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    fn = torch.argmax if op == "argmax" else torch.argmin
    big = torch.iinfo(torch.int64).max
    if axis is None:
        if empty:
            v = torch.full((), _identity(op, x.dtype), dtype=x.dtype,
                           device=x.device)
            gi = torch.full((), big, dtype=torch.int64, device=x.device)
        else:
            flat = x.reshape(-1)
            li = dtypes.call(fn, flat)
            v = flat[li]
            # the block's flat index to the global flat index
            gi = torch.zeros((), dtype=torch.int64, device=x.device)
            rest = li.to(torch.int64)
            stride = 1
            for d in reversed(range(x.ndim)):
                c = rest % ext.shape[d] + ext.ul[d]
                rest = rest // ext.shape[d]
                gi = gi + c * stride
                stride *= int(shape[d])
    else:
        a = axis[0]
        if empty:
            keep = [1 if d == a else n for d, n in enumerate(ext.shape)]
            v = torch.full(keep, _identity(op, x.dtype), dtype=x.dtype,
                           device=x.device)
            gi = torch.full(keep, big, dtype=torch.int64, device=x.device)
        else:
            li = dtypes.call(fn, x, dim=a, keepdim=True)
            v = x.gather(a, li)
            gi = li.to(torch.int64) + ext.ul[a]
    for sub in over:
        vs, ids = coll.stack_over(v, sub, mesh), coll.stack_over(gi, sub,
                                                                 mesh)
        v, gi = vs[0], ids[0]
        for k in range(1, vs.shape[0]):
            take = _better(op, vs[k], ids[k], v, gi)
            v = torch.where(take, vs[k], v)
            gi = torch.where(take, ids[k], gi)
    return gi.to(torch.int32)


def _make(op: str):
    def builder(input: Any, axis: Axis = None, keepdims: bool = False,
                dtype: Any = None) -> ReduceExpr:
        return ReduceExpr(as_expr(input), op, axis, keepdims, dtype)

    builder.__name__ = op
    return builder


class GeneralReduceExpr(Expr):
    """User reduction: the reference's ``ReduceExpr(input, axis,
    dtype_fn, local_reduce_fn, accumulate_fn)``. ``local_reduce_fn(block,
    axis=...)`` is torch code, associative with ``accumulate_fn`` as its
    combiner; on one device it is applied to the whole tensor, which for
    an associative reducer equals per-tile reduces merged."""

    def __init__(self, input: Expr, axis: Axis,
                 local_reduce_fn: Callable,
                 accumulate_fn: Optional[Callable] = None,
                 dtype: Any = None):
        self.input = input
        self.axis = _norm_axis(axis, input.ndim)
        self.local_reduce_fn = local_reduce_fn
        self.accumulate_fn = accumulate_fn
        out = eval_shape_of(lambda x: local_reduce_fn(x, axis=self._ax()),
                            input)
        super().__init__(out.shape, out.dtype if dtype is None else dtype)

    def _ax(self):
        return self.axis if self.axis is None or len(self.axis) > 1 \
            else self.axis[0]

    def children(self) -> Tuple[Expr, ...]:
        return (self.input,)

    def replace_children(self, new_children: Tuple[Expr, ...]
                         ) -> "GeneralReduceExpr":
        return GeneralReduceExpr(new_children[0], self.axis,
                                 self.local_reduce_fn, self.accumulate_fn,
                                 self.dtype)

    def _lower(self, env: Dict[int, Any]) -> Any:
        out = self.local_reduce_fn(self.input.lower(env), axis=self._ax())
        want = dtypes.to_torch(self.dtype)
        return out if out.dtype == want else out.to(want)

    def _lower_local(self, env) -> Any:
        """The user's reduction of the rank's block, its partials folded
        over the reduced mesh axes by ``accumulate_fn`` in position
        order. Without a combiner, or where a reduced dim leaves some
        position an empty block, the counted whole read."""
        if self.accumulate_fn is None:
            return NotImplemented
        from ..array.distarray import DistArray
        from ..parallel import collectives as coll

        mesh = env.mesh
        x = self.input.lower_local(env)
        t = x.tiling
        dims = tuple(range(self.input.ndim)) if self.axis is None \
            else self.axis
        over = [sub for d in dims for sub in tiling_mod.mesh_axes_of(
            t.axes[d]) if mesh.shape[sub] > 1]
        for d in dims:
            if tiling_mod.tile_count(t.axes[d], mesh) > self.input.shape[d]:
                return NotImplemented
        part = self.local_reduce_fn(x.local, axis=self._ax())
        want = dtypes.to_torch(self.dtype)
        fold = _TORCH_FOLD.get(self.accumulate_fn, self.accumulate_fn)
        for sub in over:
            parts = coll.stack_over(part, sub, mesh)
            part = parts[0]
            for k in range(1, parts.shape[0]):
                part = fold(part, parts[k])
        if part.dtype != want:
            part = part.to(want)
        out_t = tiling_mod.replicated(self.ndim)
        if self.axis is not None:
            out_t = t
            for a in reversed(self.axis):
                out_t = out_t.drop_axis(a)
        return DistArray.from_local(part, out_t, self.shape, mesh)

    def _sig(self, ctx) -> Tuple:
        return ("greduce", fn_key(self.local_reduce_fn),
                fn_key(self.accumulate_fn) if self.accumulate_fn else None,
                self.axis, str(self.dtype), ctx.of(self.input))

    def cost(self) -> Dict[str, float]:
        """One FLOP per element folded away, as XLA counts a reduce of
        one binary op (the user's function is not seen here); the input
        read once, the output written once."""
        from .base import io_bytes

        return {"flops": float(self.input.size - self.size),
                "transcendentals": 0.0,
                "bytes accessed": io_bytes(self.children(), self)}

    def _default_tiling(self) -> Tiling:
        t = self.input.out_tiling()
        if self.axis is None:
            return tiling_mod.replicated(self.ndim)
        for a in reversed(self.axis):
            t = t.drop_axis(a)
        return t


# numpy combiners a user passes as ``accumulate_fn``, as torch ops (a
# numpy ufunc would take a CUDA tensor to the host)
_TORCH_FOLD = {np.add: torch.add, np.multiply: torch.mul,
               np.maximum: torch.maximum, np.minimum: torch.minimum,
               np.logical_and: torch.logical_and,
               np.logical_or: torch.logical_or}


def reduce(input: Any, axis: Axis = None, *,
           local_reduce_fn: Callable,
           accumulate_fn: Optional[Callable] = None,
           dtype: Any = None) -> GeneralReduceExpr:
    return GeneralReduceExpr(as_expr(input), axis, local_reduce_fn,
                             accumulate_fn, dtype)


sum = _make("sum")
prod = _make("prod")
mean = _make("mean")


def max(input: Any, axis: Axis = None, keepdims: bool = False) -> ReduceExpr:
    return ReduceExpr(as_expr(input), "max", axis, keepdims)


def min(input: Any, axis: Axis = None, keepdims: bool = False) -> ReduceExpr:
    return ReduceExpr(as_expr(input), "min", axis, keepdims)


def all(input: Any, axis: Axis = None, keepdims: bool = False) -> ReduceExpr:
    return ReduceExpr(as_expr(input), "all", axis, keepdims)


def any(input: Any, axis: Axis = None, keepdims: bool = False) -> ReduceExpr:
    return ReduceExpr(as_expr(input), "any", axis, keepdims)


def argmax(input: Any, axis: Axis = None) -> ReduceExpr:
    return ReduceExpr(as_expr(input), "argmax", axis)


def argmin(input: Any, axis: Axis = None) -> ReduceExpr:
    return ReduceExpr(as_expr(input), "argmin", axis)
