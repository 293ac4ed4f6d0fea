"""Shape ops: transpose / reshape / ravel / concatenate (port of
``spartan_tpu/expr/reshape.py``).

Each is a node whose output tiling differs from its input's; on one
device the data movement is one torch copy (the JAX package leaves it to
GSPMD's collectives). Results are materialized, never views of an input.
``concatenate`` keeps the masks of masked operands (``array/masked.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from .base import Expr, as_expr, eval_shape_of


class TransposeExpr(Expr):
    def __init__(self, input: Expr, perm: Tuple[int, ...]):
        self.input = input
        self.perm = perm
        shape = tuple(input.shape[p] for p in perm)
        super().__init__(shape, input.dtype)

    def children(self) -> Tuple[Expr, ...]:
        return (self.input,)

    def replace_children(self, new_children) -> "TransposeExpr":
        return TransposeExpr(new_children[0], self.perm)

    def _lower(self, env: Dict[int, Any]) -> Any:
        return self.input.lower(env).permute(self.perm).contiguous()

    def _sig(self, ctx) -> Tuple:
        return ("transpose", self.perm, ctx.of(self.input))

    def _default_tiling(self) -> Tiling:
        return self.input.out_tiling().transpose(self.perm)


def transpose(x: Any, *axes) -> TransposeExpr:
    x = as_expr(x)
    if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
        axes = tuple(axes[0])
    if not axes:
        axes = tuple(reversed(range(x.ndim)))
    if sorted(axes) != list(range(x.ndim)):
        raise ValueError(f"invalid permutation {axes} for rank {x.ndim}")
    return TransposeExpr(x, tuple(int(a) for a in axes))


class ReshapeExpr(Expr):
    def __init__(self, input: Expr, new_shape: Tuple[int, ...]):
        self.input = input
        super().__init__(new_shape, input.dtype)

    def children(self) -> Tuple[Expr, ...]:
        return (self.input,)

    def replace_children(self, new_children) -> "ReshapeExpr":
        return ReshapeExpr(new_children[0], self._shape)

    def _lower(self, env: Dict[int, Any]) -> Any:
        v = self.input.lower(env)
        out = v.reshape(self._shape)
        # reshape returns a view where it can: keep results independent
        return out.clone() if out.data_ptr() == v.data_ptr() else out

    def _sig(self, ctx) -> Tuple:
        return ("reshape", self._shape, ctx.of(self.input))

    def _default_tiling(self) -> Tiling:
        # a reshape generally invalidates the input tiling: re-place
        return tiling_mod.default_tiling(self.shape)


def reshape(x: Any, *shape) -> ReshapeExpr:
    x = as_expr(x)
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    shape = tuple(int(s) for s in shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        if shape.count(-1) != 1 or x.size % known:
            raise ValueError(f"cannot reshape {x.shape} into {shape}")
        shape = tuple(x.size // known if s == -1 else s for s in shape)
    if int(np.prod(shape)) != x.size:
        raise ValueError(f"cannot reshape {x.shape} into {shape}")
    return ReshapeExpr(x, shape)


def ravel(x: Any) -> ReshapeExpr:
    x = as_expr(x)
    return ReshapeExpr(x, (x.size,))


class ConcatExpr(Expr):
    def __init__(self, inputs: Sequence[Expr], axis: int):
        self.inputs = tuple(inputs)
        self.axis = axis
        first = self.inputs[0]
        for c in self.inputs[1:]:
            if (c.ndim != first.ndim
                    or c.shape[:axis] + c.shape[axis + 1:]
                    != first.shape[:axis] + first.shape[axis + 1:]):
                raise ValueError("concatenate shapes incompatible")
        out = eval_shape_of(lambda *xs: torch.cat(xs, dim=axis),
                            *self.inputs)
        super().__init__(out.shape, out.dtype)

    def children(self) -> Tuple[Expr, ...]:
        return self.inputs

    def replace_children(self, new_children) -> "ConcatExpr":
        return ConcatExpr(new_children, self.axis)

    def _lower(self, env: Dict[int, Any]) -> Any:
        return torch.cat([c.lower(env) for c in self.inputs], dim=self.axis)

    def _sig(self, ctx) -> Tuple:
        return (("concat", self.axis)
                + tuple(ctx.of(c) for c in self.inputs))

    def _default_tiling(self) -> Tiling:
        # keep the first input's tiling on the other axes
        return self.inputs[0].out_tiling().with_axis(self.axis, None)


def concatenate(arrays: Sequence[Any], axis: int = 0):
    """Join arrays along an axis; masked operands keep their masks
    (``numpy.ma.concatenate``)."""
    from ..array.masked import MaskedDistArray, masked_concatenate

    arrays = list(arrays)
    if any(isinstance(a, MaskedDistArray) for a in arrays):
        return masked_concatenate(arrays, axis)
    inputs = [as_expr(a) for a in arrays]
    if not inputs:
        raise ValueError("need at least one array")
    axis = axis % inputs[0].ndim
    return ConcatExpr(inputs, axis)
