"""Shape ops: transpose / reshape / ravel / concatenate (port of
``spartan_tpu/expr/reshape.py``).

Each is a node whose output tiling differs from its input's; on one
device the data movement is one torch copy (the JAX package leaves it to
GSPMD's collectives). Results are materialized, never views of an input.
``concatenate`` keeps the masks of masked operands (``array/masked.py``).

On a group mesh each has a local rule. A transpose permutes the rank's
block under the permuted tiling: no collective. A reshape (ravel
included) and a concatenation move only the pieces that change owner
(``parallel/redistribute.move_pieces``): every position's block is a
region of the output, found from the shapes and tilings, and the runs
each rank's output block lacks arrive in one ``all_to_all`` of uneven
pieces. Where every block maps onto the rank's own output block (axes
split or merged inside the block, the ravel of a row-tiled array whose
rows divide the mesh, a concatenation along an untiled axis) nothing
moves.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..array.extent import TileExtent
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

    def _lower_local(self, env) -> Any:
        """The rank's block permuted, under the permuted tiling."""
        from ..array.distarray import DistArray

        x = self.input.lower_local(env)
        blk = x.local.permute(self.perm).contiguous()
        return DistArray.from_local(blk, x.tiling.transpose(self.perm),
                                    self.shape, env.mesh)

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
        # reshape returns a view where the strides allow one: keep results
        # independent by cloning a view, and let reshape copy otherwise.
        # Asking ``view`` decides this from the strides alone, which a
        # batched tensor under ``torch.func.vmap`` has (not a data pointer)
        try:
            return v.view(self._shape).clone()
        except RuntimeError:
            return v.reshape(self._shape)

    def _extent_of(self, t: Tiling, mesh):
        """Each position's block of the input (tiled ``t``) as a region
        of the output: a reshape keeps the row-major order, so a block's
        runs in the input are its runs in the output."""
        from ..array.extent import flat_runs
        from ..parallel import redistribute as redist_mod

        shape, out_shape = self.input.shape, self.shape

        def ext_of(c):
            e = t.block_extent(shape, mesh, c)
            if e.size == 0:
                return None
            return redist_mod.RunSet(flat_runs(e, shape), out_shape)

        return ext_of

    def _pieces(self, x, mesh):
        """The input's blocks as pieces of the output."""
        from ..parallel import redistribute as redist_mod

        return redist_mod.Piece(x.local, self._extent_of(x.tiling, mesh),
                                redist_mod.free_axes(x.tiling, mesh))

    def card_staging(self, mesh) -> float:
        """The piece exchange's buffers (``resilience/memory.py``)."""
        if not mesh.is_group:
            return 0.0
        from ..parallel import redistribute as redist_mod

        t_in = tiling_mod.sanitize(self.input.out_tiling(), self.input.shape,
                                   mesh)
        return redist_mod.exchange_staging(
            [self._extent_of(t_in, mesh)],
            [redist_mod.free_axes(t_in, mesh)],
            tiling_mod.sanitize(self.out_tiling(), self.shape, mesh),
            self.shape, mesh, self.dtype.itemsize)

    def _lower_local(self, env) -> Any:
        """Each rank's output block from the pieces the input's blocks
        hold of it (no collective where each block is the rank's own
        output block)."""
        from ..array.distarray import DistArray
        from ..parallel import redistribute as redist_mod

        mesh = env.mesh
        x = self.input.lower_local(env)
        t = tiling_mod.sanitize(self.out_tiling(), self.shape, mesh)
        blk = redist_mod.move_pieces([self._pieces(x, mesh)], t,
                                     self.shape, x.local.dtype, mesh)
        return DistArray.from_local(blk, t, self.shape, mesh)

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

    def _lower_local(self, env) -> Any:
        """Each input's blocks placed at its offset along the axis as
        pieces of the output: along an untiled axis every rank holds its
        output block already; along a tiled one the pieces move."""
        from ..array.distarray import DistArray
        from ..parallel import redistribute as redist_mod
        from ..utils import dtypes

        mesh = env.mesh
        t = tiling_mod.sanitize(self.out_tiling(), self.shape, mesh)
        want = dtypes.to_torch(self.dtype)
        pieces = []
        for c, off in zip(self.inputs, self._offsets()):
            x = c.lower_local(env)
            blk = x.local if x.local.dtype == want else x.local.to(want)
            pieces.append(redist_mod.Piece(
                blk, _shifted_extent(x.tiling, c.shape, self.axis, off,
                                     self.shape, mesh),
                redist_mod.free_axes(x.tiling, mesh)))
        blk = redist_mod.move_pieces(pieces, t, self.shape, want, mesh)
        return DistArray.from_local(blk, t, self.shape, mesh)

    def _offsets(self):
        off = 0
        for c in self.inputs:
            yield off
            off += c.shape[self.axis]

    def card_staging(self, mesh) -> float:
        """The piece exchange's buffers and the inputs cast to the
        output's dtype (``resilience/memory.py``)."""
        if not mesh.is_group:
            return 0.0
        from ..parallel import redistribute as redist_mod

        exts, frees, cast = [], [], 0.0
        for c, off in zip(self.inputs, self._offsets()):
            t_in = tiling_mod.sanitize(c.out_tiling(), c.shape, mesh)
            exts.append(_shifted_extent(t_in, c.shape, self.axis, off,
                                        self.shape, mesh))
            frees.append(redist_mod.free_axes(t_in, mesh))
            if c.dtype != self.dtype:
                cast += float(t_in.block_extent(c.shape, mesh).size) \
                    * self.dtype.itemsize
        return cast + redist_mod.exchange_staging(
            exts, frees,
            tiling_mod.sanitize(self.out_tiling(), self.shape, mesh),
            self.shape, mesh, self.dtype.itemsize)

    def _sig(self, ctx) -> Tuple:
        return (("concat", self.axis)
                + tuple(ctx.of(c) for c in self.inputs))

    def _default_tiling(self) -> Tiling:
        # keep the first input's tiling on the other axes
        return self.inputs[0].out_tiling().with_axis(self.axis, None)


def _shifted_extent(t: Tiling, shape, axis: int, off: int, out_shape,
                    mesh):
    """Each position's block of an input tiled ``t`` as a region of the
    concatenation ``out_shape``, at offset ``off`` along ``axis``."""

    def ext_of(c):
        e = t.block_extent(shape, mesh, c)
        if e.size == 0:
            return None
        ul, lr = list(e.ul), list(e.lr)
        ul[axis] += off
        lr[axis] += off
        return TileExtent(ul, lr, out_shape)

    return ext_of


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
