"""Functional assignment and region writes (port of
``spartan_tpu/expr/assign.py``).

``WriteExpr`` is a new array equal to ``dst`` with ``region`` <-
reducer(dst[region], src): ``x.at[region].op(value)`` in the JAX package,
a copy of ``dst`` with the region combined in place here. Deterministic:
one write per element. On a group mesh each rank writes the part of the
region its block holds, from the part of ``src`` that reaches it
through the piece exchange (``WriteExpr._lower_local``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..array import extent as extent_mod
from ..array import tiling as tiling_mod
from ..array.distarray import _canonical_reducer
from ..array.extent import TileExtent
from ..array.tiling import Tiling
from .base import Expr, as_expr

_COMBINE = {
    "add": torch.add,
    "mul": torch.mul,
    "max": torch.maximum,
    "min": torch.minimum,
}


class WriteExpr(Expr):
    """A new array equal to ``dst`` with ``region`` <- reducer(dst, src)."""

    def __init__(self, dst: Expr, region: TileExtent, src: Expr,
                 reducer: Any = None):
        if region.shape != src.shape:
            # numpy-style broadcast of the source into the region
            np.broadcast_shapes(region.shape, src.shape)
        self.dst = dst
        self.region = region
        self.src = src
        self.op = _canonical_reducer(reducer)
        super().__init__(dst.shape, dst.dtype)

    def children(self) -> Tuple[Expr, ...]:
        return (self.dst, self.src)

    def replace_children(self, new_children) -> "WriteExpr":
        return WriteExpr(new_children[0], self.region, new_children[1],
                         self.op)

    def _lower(self, env: Dict[int, Any]) -> Any:
        x = self.dst.lower(env)
        v = self.src.lower(env).to(device=x.device, dtype=x.dtype)
        v = torch.broadcast_to(v, self.region.shape)
        out = x.clone()
        sl = self.region.to_slice()
        out[sl] = v if self.op == "set" else _COMBINE[self.op](out[sl], v)
        return out

    def _lower_local(self, env) -> Any:
        """Each rank combines the region's part in its block with the
        matching part of ``src``, which reaches it through the piece
        exchange (nothing moves where it already holds it); a rank whose
        block misses the region copies nothing and receives nothing."""
        from ..array.distarray import DistArray, region_source
        from ..parallel import redistribute as redist_mod

        mesh = env.mesh
        t = tiling_mod.sanitize(self.out_tiling(), self.shape, mesh)
        x = self.dst.lower_local(env)
        if not redist_mod.same_blocks(x.tiling, t, self.shape, mesh):
            x = redist_mod.relayout(x, t)
        v = region_source(self.src.lower_local(env), self.region, t,
                          self.shape)
        out = x.local.clone()
        if v is not None:
            mine = t.block_extent(self.shape, mesh)
            part = self.region.intersection(mine)
            sl = part.offset_from(mine).to_slice()
            v = torch.broadcast_to(v.to(dtype=out.dtype), part.shape)
            out[sl] = v if self.op == "set" else _COMBINE[self.op](out[sl],
                                                                 v)
        return DistArray.from_local(out, t, self.shape, mesh)

    def card_staging(self, mesh) -> float:
        """What the local rule holds beside the destination's block and
        the output: the destination moved to the output's layout, the
        source's part once it moved (and the exchange's buffers while
        it moves), its cast and a combine's result
        (``resilience/memory.py``)."""
        if not mesh.is_group:
            return 0.0
        from ..array import distarray as da_mod
        from ..parallel import redistribute as redist_mod

        t = tiling_mod.sanitize(self.out_tiling(), self.shape, mesh)
        item = self.dtype.itemsize
        mine = t.block_extent(self.shape, mesh)
        out = 0.0
        if not redist_mod.same_blocks(tiling_mod.sanitize(
                self.dst.out_tiling(), self.dst.shape, mesh), t, self.shape,
                mesh):
            out += float(mine.size) * item
        part = self.region.intersection(mine) if self.region.size else None
        st = tiling_mod.sanitize(self.src.out_tiling(), self.src.shape, mesh)
        piece, moving = da_mod.source_staging(
            st, self.src.shape, self.src.dtype.itemsize, self.region, t,
            self.shape, mesh)
        after = 0.0
        if part is not None:
            if self.src.dtype != self.dtype:
                after += float(part.size) * item
            if self.op != "set":
                after += float(part.size) * item
        return out + piece + max(moving, after)

    def _sig(self, ctx) -> Tuple:
        return ("write", self.region.ul, self.region.lr, self.op,
                ctx.of(self.dst), ctx.of(self.src))

    def _default_tiling(self) -> Tiling:
        return self.dst.out_tiling()


def assign(dst: Any, idx: Any, value: Any, reducer: Any = None) -> WriteExpr:
    """Functional ``dst[idx] = value`` -> new lazy array."""
    dst = as_expr(dst)
    region = (idx if isinstance(idx, TileExtent)
              else extent_mod.from_slice(idx, dst.shape))
    return WriteExpr(dst, region, as_expr(value), reducer)


def write_array(shape, region: Any, data: Any, dtype: Any = None,
                reducer: Any = None, tile_hint=None) -> WriteExpr:
    """The reference's ``write_array``: a fresh array of ``shape`` with
    ``data`` written at ``region`` (zeros elsewhere)."""
    from .builtins import zeros

    data = as_expr(data)
    dtype = np.dtype(dtype) if dtype is not None else data.dtype
    base = zeros(shape, dtype, tile_hint=tile_hint)
    region = (region if isinstance(region, TileExtent)
              else extent_mod.from_slice(region, base.shape))
    return WriteExpr(base, region, data, reducer)
