"""Lazy slicing (port of ``spartan_tpu/expr/slice.py``).

Basic indexing (ints, slices with any step, ``None``, ``...``) is a
``SliceExpr``; integer-array and boolean indexing delegate to
``filter``. torch slices take no negative step, so an axis read with a
negative step is flipped and then sliced with the positive step.

On a group mesh each rank intersects its block with the slice, takes
the selected elements of its block (flipping an axis read with a
negative step), and the pieces move to the output's tiling
(``parallel/redistribute.move_pieces``): nothing moves where each
rank's selection is its own output block.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from ..utils import dtypes
from .base import Expr, as_expr

Index = Union[int, slice, type(Ellipsis), None]


def _normalize_index(idx: Any, shape: Tuple[int, ...]
                     ) -> Tuple[Tuple[Index, ...], Tuple[int, ...],
                                Tuple[int, ...]]:
    """Normalize to a full per-axis index tuple; return (index, out_shape,
    squeezed_axes)."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    n_explicit = sum(1 for i in idx if i is not Ellipsis and i is not None)
    out: List[Index] = []
    for i in idx:
        if i is Ellipsis:
            out.extend([slice(None)] * (len(shape) - n_explicit))
        else:
            out.append(i)
    while len([i for i in out if i is not None]) < len(shape):
        out.append(slice(None))
    if len([i for i in out if i is not None]) > len(shape):
        raise IndexError(f"too many indices for shape {shape}")

    norm: List[Index] = []
    out_shape: List[int] = []
    squeezed: List[int] = []
    axis = 0
    for i in out:
        if i is None:  # np.newaxis
            out_shape.append(1)
            norm.append(None)
            continue
        dim = shape[axis]
        if isinstance(i, (int, np.integer)):
            ii = int(i)
            if ii < 0:
                ii += dim
            if not 0 <= ii < dim:
                raise IndexError(
                    f"index {i} out of bounds for axis {axis} (size {dim})")
            norm.append(ii)
            squeezed.append(axis)
        elif isinstance(i, slice):
            start, stop, step = i.indices(dim)
            n = len(range(start, stop, step))
            # a negative stop from .indices() means "past the beginning";
            # storing it verbatim would re-wrap to dim-1 — use None
            stored_stop: Optional[int] = stop
            if step < 0 and stop < 0:
                stored_stop = None
            norm.append(slice(start, stored_stop, step))
            out_shape.append(n)
        else:
            raise TypeError(f"unsupported index component {i!r}")
        axis += 1
    return tuple(norm), tuple(out_shape), tuple(squeezed)


class SliceExpr(Expr):
    """Basic (rectangular, possibly strided) indexing with int-squeeze and
    np.newaxis support."""

    def __init__(self, input: Expr, index: Tuple[Index, ...],
                 out_shape: Tuple[int, ...], squeezed: Tuple[int, ...]):
        self.input = input
        self.index = index
        self.squeezed = squeezed
        super().__init__(out_shape, input.dtype)

    def children(self) -> Tuple[Expr, ...]:
        return (self.input,)

    def replace_children(self, new_children: Tuple[Expr, ...]) -> "SliceExpr":
        return SliceExpr(new_children[0], self.index, self._shape,
                         self.squeezed)

    def _lower(self, env: Dict[int, Any]) -> Any:
        x = self.input.lower(env)
        flips: List[int] = []
        idx: List[Any] = []
        src_axis = 0
        for i in self.index:
            if i is None:
                idx.append(None)
                continue
            if isinstance(i, slice) and i.step < 0:
                # reversed read: on the flipped axis, source position p
                # sits at dim-1-p, and the stride becomes positive
                dim = x.shape[src_axis]
                n = len(range(*i.indices(dim)))
                lo = dim - 1 - i.start
                flips.append(src_axis)
                idx.append(slice(lo, lo + (n - 1) * -i.step + 1 if n else lo,
                                 -i.step))
            else:
                idx.append(i)
            src_axis += 1
        if flips:
            x = x.flip(flips)
        return x[tuple(idx)]

    def _selection(self, ext) -> Optional[Tuple[Tuple, Tuple, Tuple]]:
        """What the block ``ext`` of the input holds of the output:
        (the output region's ul, lr, and per source axis the block-local
        (start, count, step) to read, or an int for a squeezed axis), or
        None where it holds nothing."""
        ul: List[int] = []
        lr: List[int] = []
        reads: List[Any] = []
        src_axis = 0
        for i in self.index:
            if i is None:
                ul.append(0)
                lr.append(1)
                continue
            b0, b1 = ext.ul[src_axis], ext.lr[src_axis]
            dim = self.input.shape[src_axis]
            if isinstance(i, int):
                if not b0 <= i < b1:
                    return None
                reads.append(i - b0)
            else:
                start, _, step = i.indices(dim) if i.stop is not None \
                    else (i.start, None, i.step)
                n = len(range(*i.indices(dim)))
                if step > 0:
                    k_lo = max(0, -(-(b0 - start) // step))
                    k_hi = min(n, -(-(b1 - start) // step))
                else:
                    k_lo = max(0, -(-(start - (b1 - 1)) // -step))
                    k_hi = min(n, (start - b0) // -step + 1)
                if k_hi <= k_lo:
                    return None
                ul.append(k_lo)
                lr.append(k_hi)
                reads.append((start + k_lo * step - b0, k_hi - k_lo, step))
            src_axis += 1
        return tuple(ul), tuple(lr), tuple(reads)

    def _lower_local(self, env) -> Any:
        """The selected elements of each rank's block, as pieces of the
        output moved to its tiling."""
        from ..array.distarray import DistArray
        from ..array.extent import TileExtent
        from ..parallel import redistribute as redist_mod

        mesh = env.mesh
        x = self.input.lower_local(env)
        t_in, shape = x.tiling, self.shape
        me = self._selection(t_in.block_extent(self.input.shape, mesh))
        blk = None if me is None else _piece(x.local, me)
        t = tiling_mod.sanitize(self.out_tiling(), shape, mesh)
        out = redist_mod.move_pieces(
            [redist_mod.Piece(blk, self._extent_of(t_in, mesh),
                              redist_mod.free_axes(t_in, mesh))],
            t, shape, x.local.dtype, mesh)
        return DistArray.from_local(out, t, shape, mesh)

    def _extent_of(self, t_in: Tiling, mesh):
        """Each position's selection as a region of the output."""
        from ..array.extent import TileExtent

        def ext_of(c):
            sel = self._selection(t_in.block_extent(self.input.shape, mesh,
                                                    c))
            return None if sel is None else TileExtent(sel[0], sel[1],
                                                       self.shape)

        return ext_of

    def card_staging(self, mesh) -> float:
        """The rank's selection copied out of its block (where it is no
        contiguous view of it) and the piece exchange's buffers
        (``resilience/memory.py``)."""
        if not mesh.is_group:
            return 0.0
        from ..parallel import redistribute as redist_mod

        t_in = tiling_mod.sanitize(self.input.out_tiling(),
                                   self.input.shape, mesh)
        ext = t_in.block_extent(self.input.shape, mesh)
        me = self._selection(ext)
        copy = 0.0
        if me is not None:
            idx, flips = _reads(me)
            view = torch.empty(ext.shape, dtype=dtypes.to_torch(self.dtype),
                               device="meta")[idx]
            if flips or not view.is_contiguous():
                copy = float(view.numel()) * self.dtype.itemsize
        return copy + redist_mod.exchange_staging(
            [self._extent_of(t_in, mesh)], [redist_mod.free_axes(t_in, mesh)],
            tiling_mod.sanitize(self.out_tiling(), self.shape, mesh),
            self.shape, mesh, self.dtype.itemsize)

    def _sig(self, ctx) -> Tuple:
        key = tuple((i.start, i.stop, i.step) if isinstance(i, slice)
                    else i for i in self.index)
        return ("slice", key, ctx.of(self.input))

    def _default_tiling(self) -> Tiling:
        """Keep the input's tiling on axes taken whole; drop it on
        cut/strided/squeezed axes."""
        in_t = self.input.out_tiling()
        in_shape = self.input.shape
        axes: List[Optional[str]] = []
        src_axis = 0
        for i in self.index:
            if i is None:
                axes.append(None)
                continue
            if isinstance(i, int):
                src_axis += 1
                continue
            full = (i.start == 0 and i.step == 1
                    and i.stop == in_shape[src_axis])
            axes.append(in_t.axes[src_axis] if full else None)
            src_axis += 1
        return Tiling(axes)


def _reads(sel) -> Tuple[Tuple[Any, ...], List[int]]:
    """The block index of a selection's reads, ascending on every axis,
    and the output axes to flip after it."""
    flips = []
    idx: List[Any] = []
    for axis, r in enumerate(sel[2]):
        if isinstance(r, int):
            idx.append(r)
            continue
        lo, n, step = r
        if step > 0:
            idx.append(slice(lo, lo + (n - 1) * step + 1, step))
        else:
            # read ascending, then flip: the output runs the other way
            first = lo + (n - 1) * step
            idx.append(slice(first, lo + 1, -step))
            flips.append(axis)
    # the squeezed axes before a flipped one are gone
    gone = [a for a, r in enumerate(sel[2]) if isinstance(r, int)]
    return tuple(idx), [f - sum(1 for g in gone if g < f) for f in flips]


def _piece(v, sel) -> Any:
    """The selected elements of the block ``v`` in the output's order
    and shape (``SliceExpr._selection``'s reads)."""
    idx, flips = _reads(sel)
    v = v[idx]
    if flips:
        v = v.flip(flips)
    # newaxis entries: the output's size-1 axes
    return v.reshape(tuple(h - l for l, h in zip(sel[0], sel[1])))


def make_slice(input: Expr, idx: Any) -> Expr:
    """Entry point for ``Expr.__getitem__``: basic indexing here; boolean /
    integer-array indexing delegates to filter."""
    input = as_expr(input)
    if isinstance(idx, Expr) or isinstance(idx, np.ndarray):
        from .filter import filter as _filter

        return _filter(input, idx)
    index, out_shape, squeezed = _normalize_index(idx, input.shape)
    return SliceExpr(input, index, out_shape, squeezed)
