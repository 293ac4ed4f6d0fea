"""map2: a kernel over whole arrays of different shapes, and its
per-tile form (port of ``spartan_tpu/expr/map2.py``).

``map2``'s ``fn`` receives the whole input tensors and returns one
tensor. ``shard_map2``'s ``fn`` runs under ``parallel/shard_map.py`` at
every mesh position on each input's block, and its blocks tile the
result.

On a group mesh ``map2`` runs on the ranks' row blocks where the aten
program its ``fn`` traces to proves that right (``expr/partition.py``,
as GSPMD partitions the ops it traces): the operands that span the
rows move to a tiling split on the row mesh axis only, the program is
replayed on the blocks with an all-reduce wherever a partial sum meets
an op that needs it whole (a mean over the rows among them), a flip
along the rows brings each rank its mirrored rows in one piece
exchange, and a partial result is all-reduced once. Where the rows are
not proven and the column mesh axis has positions, the same proof runs
over the columns of the largest input, split on that axis.
Any other ``fn`` reads its split inputs whole (counted). ``shard_map2``
runs on the blocks the ranks store (``shard_map_local``): each operand
moves to its tiling and each rank keeps its output block.
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

    def _row_plan(self, tilings: Sequence[Tiling], mesh,
                  count: bool = False):
        """(the proof's plan, each input's split dim or None, the split
        dim's whole count, the mesh axis it is split on) where ``fn`` is
        proven partitionable over inputs held under ``tilings`` on the
        group mesh ``mesh``; None where no input is split (``fn`` runs
        whole, moving nothing), or a string: why it is not proven. The
        rows are the leading dim of the largest input, split on the row
        mesh axis, and every input of that many rows is split along
        them; where that is not proven and the column mesh axis has
        positions, the largest input's second dim is tried on it (GSPMD
        keeps a column split where a function reads whole columns).
        With ``count``, the decision is counted in
        ``group_partition_decisions``."""
        from ..obs.metrics import record_partition

        if not any(n > 1 for t in tilings for n in t.tiles_per_dim(mesh)):
            return None
        big = max((c for c in self.inputs if c.ndim),
                  key=lambda c: c.size, default=None)
        first = None
        for dim, axis, what in ((0, mesh_mod.AXIS_ROW, "rows"),
                                (1, mesh_mod.AXIS_COL, "columns")):
            n = big.shape[dim] if big is not None and big.ndim > dim \
                else 0
            if n < mesh.shape[axis] or mesh.shape[axis] == 1:
                got = "fewer rows than row positions"
            else:
                got = self._split_plan(tilings, mesh, dim, n)
            if not isinstance(got, str):
                if count:
                    record_partition("Map2Expr", "local", what)
                return got[0], got[1], n, axis
            first = first or got
        if count:
            record_partition("Map2Expr", "gather", first)
        return first

    def _split_plan(self, tilings, mesh, dim: int, n: int):
        """(plan, split dims) of the proof with every input of ``n``
        along ``dim`` split there, or the reason it is not proven."""
        from ..kernels import registry as kernels_mod
        from ..utils.config import FLAGS
        from . import partition
        from .map import _specs

        row_dims = tuple(dim if c.ndim > dim and c.shape[dim] == n
                         else None for c in self.inputs)
        specs = _specs(self.inputs)
        axes = tuple((a, int(mesh.shape[a])) for a in mesh.axis_names)
        # the kernel policy picks the ops a function traces to (a
        # segment sum's kernel or its scatter)
        key = ("map2", fn_key(self.fn), self.fn_kw, specs, dim,
               tuple(t.axes for t in tilings), axes,
               kernels_mod.policy_key(), FLAGS.segment_impl)
        fn, kw = self.fn, dict(self.fn_kw)
        plan = partition.cached(key, lambda: partition.rows(
            lambda *xs: fn(*xs, **kw), specs, row_dims, n))
        return plan if isinstance(plan, str) else (plan, row_dims)

    def _lower_local(self, env) -> Any:
        """On a group mesh, a proven ``fn``'s program on the rank's
        blocks (:meth:`_row_plan`): one all-reduce over the split's mesh
        axis a partial sum, the output relaid to the node's tiling.
        Otherwise NotImplemented: ``fn`` runs whole on inputs gathered
        whole."""
        from ..array.distarray import DistArray
        from ..parallel import collectives as coll
        from ..parallel import redistribute as redist_mod
        from . import partition

        mesh = env.mesh
        vals = [c.lower_local(env) for c in self.inputs]
        got = self._row_plan([v.tiling for v in vals], mesh, count=True)
        if got is None or isinstance(got, str):
            return NotImplemented
        plan, row_dims, n_rows, axis = got
        blocks = [redist_mod.relayout(v, _split_tiling(v.ndim, d, axis)).local
                  for v, d in zip(vals, row_dims)]
        ext = Tiling((axis,)).block_extent((n_rows,), mesh)

        def reduce(t):
            return coll.reduce_over(t, (axis,), "add", mesh)

        def move(t, d):
            shape = list(t.shape)
            shape[d] = n_rows
            piece, tl = _mirror_piece(t, d, shape, mesh, axis)
            return redist_mod.move_pieces([piece], tl, shape, t.dtype, mesh)

        out = plan.run(blocks, ext.shape[0], reduce, start=ext.ul[0],
                       move=move)
        st = plan.out_state
        if st == partition.P:
            out = reduce(out)
        t = _split_tiling(out.ndim, st[1] if st[0] == "R" else None, axis)
        want = tiling_mod.sanitize(self.out_tiling(), self.shape, mesh)
        if redist_mod.same_blocks(t, want, self.shape, mesh):
            # the node's tiling gives every rank this block (a mesh axis
            # of one position splits nothing): no copy
            return DistArray.from_local(out, want, self.shape, mesh)
        return redist_mod.relayout(DistArray.from_local(out, t, self.shape,
                                                        mesh), want)

    def card_staging(self, mesh) -> float:
        """What the lowering holds beside its output on a group mesh
        (``resilience/memory.py``): for a proven ``fn``, the operands'
        blocks (where they move) and the replay's intermediates at the
        block's rows, a partial beside its all-reduce, a flip's reversed
        block beside its exchange; else each split operand gathered
        whole."""
        if not mesh.is_group:
            return 0.0
        from ..parallel import redistribute as redist_mod
        from . import partition

        tilings = [tiling_mod.sanitize(c.out_tiling(), c.shape, mesh)
                   for c in self.inputs]
        got = self._row_plan(tilings, mesh)
        if got is None:
            return 0.0
        if isinstance(got, str):
            return float(sum(c.size * c.dtype.itemsize
                             for c, t in zip(self.inputs, tilings)
                             if t.sharded_axes()))
        plan, row_dims, n_rows, axis = got
        staging = 0.0
        for c, t, d in zip(self.inputs, tilings, row_dims):
            want = _split_tiling(c.ndim, d, axis)
            if t != want:
                staging += float(want.block_extent(c.shape, mesh).size) \
                    * c.dtype.itemsize
        rows = Tiling((axis,)).block_extent((n_rows,), mesh).shape[0]

        def move_bytes(node):
            # a flip's piece exchange: its send and received buffers
            v = node.meta["val"]
            d = plan.states[node][1]
            piece, tl = _mirror_piece(None, d, list(v.shape), mesh, axis)
            return redist_mod.exchange_staging(
                [piece.extent_of], [piece.free], tl, tuple(v.shape), mesh,
                v.element_size())

        replay = plan.card_bytes(rows, move_bytes)
        if plan.out_state != partition.P:
            # the program's output is the node's value (its own size)
            st = plan.out_state
            t = _split_tiling(self.ndim, st[1] if st[0] == "R" else None,
                              axis)
            replay -= float(t.block_extent(self.shape, mesh).size) \
                * self.dtype.itemsize
        return staging + max(replay, 0.0)

    def _sig(self, ctx) -> Tuple:
        return (("map2", fn_key(self.fn), self.fn_kw)
                + tuple(ctx.of(c) for c in self.inputs))

    def _default_tiling(self) -> Tiling:
        if self._map2_tiling is not None:
            return self._map2_tiling
        return tiling_mod.default_tiling(self.shape)


def _mirror_piece(block, d: int, shape, mesh, axis: str):
    """A rank's block of an array of ``shape`` split along dim ``d`` on
    the mesh axis ``axis``, reversed along ``d``, as a piece of the
    flipped array (it covers the mirror of the rows it was cut from),
    and the tiling the flipped array's blocks take."""
    from ..array import extent as extent_mod
    from ..parallel import redistribute as redist_mod

    tl = _split_tiling(len(shape), d, axis)
    n = shape[d]

    def extent_of(c):
        e = tl.block_extent(shape, mesh, c)
        ul, lr = list(e.ul), list(e.lr)
        ul[d], lr[d] = n - e.lr[d], n - e.ul[d]
        return extent_mod.create(ul, lr, shape)

    return redist_mod.Piece(block, extent_of,
                            redist_mod.free_axes(tl, mesh)), tl


def _split_tiling(ndim: int, d: Optional[int], axis: str) -> Tiling:
    """Split along dim ``d`` on the mesh axis ``axis`` only (None:
    whole)."""
    return Tiling([axis if i == d else None for i in range(ndim)])


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

    def _lower_local(self, env) -> Any:
        from ..array.distarray import DistArray
        from ..parallel import redistribute as redist_mod
        from ..parallel.shard_map import shard_map_local

        mesh = env.mesh
        tilings = [t if t is not None else tiling_mod.replicated(c.ndim)
                   for c, t in zip(self.inputs, self.in_tilings)]
        if not all(t.divisible(c.shape, mesh)
                   for c, t in zip(self.inputs, tilings)) or \
                not self._out_tiling.divisible(self.shape, mesh):
            return NotImplemented  # the whole path raises as shard_map does
        blocks = [redist_mod.relayout(c.lower_local(env), t).local
                  for c, t in zip(self.inputs, tilings)]
        blk = shard_map_local(self.fn, mesh, tilings,
                              self._out_tiling)(*blocks)
        return DistArray.from_local(blk, self._out_tiling, self.shape, mesh)

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
