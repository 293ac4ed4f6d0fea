"""map2: a kernel over whole arrays of different shapes, and its
per-tile form (port of ``spartan_tpu/expr/map2.py``).

``map2``'s ``fn`` receives the whole input tensors and returns one
tensor. ``shard_map2``'s ``fn`` runs under ``parallel/shard_map.py`` at
every mesh position on each input's block, and its blocks tile the
result.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from ..parallel import mesh as mesh_mod
from .base import Expr, as_expr, eval_shape_of, fn_key


class Map2Expr(Expr):
    """Kernel over whole input tensors."""

    def __init__(self, inputs: Sequence[Expr], fn: Callable,
                 fn_kw: Tuple[Tuple[str, Any], ...] = (),
                 out_tiling: Optional[Tiling] = None):
        self.inputs = tuple(inputs)
        self.fn = fn
        self.fn_kw = fn_kw
        out = eval_shape_of(lambda *xs: fn(*xs, **dict(fn_kw)),
                            *self.inputs,
                            cache_key=("map2", fn_key(fn), fn_kw))
        super().__init__(out.shape, out.dtype)
        self._map2_tiling = out_tiling

    def children(self) -> Tuple[Expr, ...]:
        return self.inputs

    def replace_children(self, new_children) -> "Map2Expr":
        return Map2Expr(new_children, self.fn, self.fn_kw,
                        self._map2_tiling)

    def _lower(self, env: Dict[int, Any]) -> Any:
        vals = [c.lower(env) for c in self.inputs]
        return self.fn(*vals, **dict(self.fn_kw))

    def _sig(self, ctx) -> Tuple:
        return (("map2", fn_key(self.fn), self.fn_kw)
                + tuple(ctx.of(c) for c in self.inputs))

    def _default_tiling(self) -> Tiling:
        if self._map2_tiling is not None:
            return self._map2_tiling
        return tiling_mod.default_tiling(self.shape)


def map2(arrays: Sequence[Any], fn: Callable,
         fn_kw: Optional[dict] = None,
         out_tiling: Optional[Tiling] = None) -> Map2Expr:
    inputs = tuple(as_expr(a) for a in arrays)
    kw = tuple(sorted((fn_kw or {}).items()))
    return Map2Expr(inputs, fn, kw, out_tiling)


class ShardMap2Expr(Expr):
    """Per-block kernel under ``shard_map`` — the reference's true
    per-tile kernel convention. ``in_tilings[i]`` names how input i is
    blocked; ``out_tiling`` how the kernel's outputs tile the result.
    Each operand goes through ``redistribute.constrain`` to its tiling
    before the kernel runs, as in the JAX package."""

    def __init__(self, inputs: Sequence[Expr], fn: Callable,
                 in_tilings: Sequence[Tiling], out_tiling: Tiling,
                 out_shape: Sequence[int], out_dtype: Any):
        self.inputs = tuple(inputs)
        self.fn = fn
        self.in_tilings = tuple(in_tilings)
        self._out_tiling = out_tiling
        super().__init__(tuple(int(s) for s in out_shape), out_dtype)

    def children(self) -> Tuple[Expr, ...]:
        return self.inputs

    def replace_children(self, new_children) -> "ShardMap2Expr":
        return ShardMap2Expr(new_children, self.fn, self.in_tilings,
                             self._out_tiling, self._shape, self._dtype)

    def _lower(self, env: Dict[int, Any]) -> Any:
        from ..parallel import redistribute as redist_mod
        from ..parallel.shard_map import shard_map

        mesh = mesh_mod.get_mesh()
        vals = [redist_mod.constrain(c.lower(env), t, mesh,
                                     src=c.out_tiling())
                for c, t in zip(self.inputs, self.in_tilings)]
        return shard_map(self.fn, mesh, self.in_tilings,
                         self._out_tiling)(*vals)

    def _sig(self, ctx) -> Tuple:
        return (("smap2", fn_key(self.fn),
                 tuple(t.axes for t in self.in_tilings),
                 self._out_tiling.axes)
                + tuple(ctx.of(c) for c in self.inputs))

    def _default_tiling(self) -> Tiling:
        return self._out_tiling


def shard_map2(arrays: Sequence[Any], fn: Callable,
               in_tilings: Sequence[Tiling], out_tiling: Tiling,
               out_shape: Sequence[int], out_dtype: Any = np.float32
               ) -> ShardMap2Expr:
    inputs = tuple(as_expr(a) for a in arrays)
    if len(inputs) != len(in_tilings):
        raise ValueError("need one tiling per input")
    return ShardMap2Expr(inputs, fn, in_tilings, out_tiling, out_shape,
                         out_dtype)
