"""Functional assignment and region writes (port of
``spartan_tpu/expr/assign.py``).

``WriteExpr`` is a new array equal to ``dst`` with ``region`` <-
reducer(dst[region], src): ``x.at[region].op(value)`` in the JAX package,
a copy of ``dst`` with the region combined in place here. Deterministic:
one write per element.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..array import extent as extent_mod
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
