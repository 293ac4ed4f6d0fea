"""Elementwise map expressions (port of ``spartan_tpu/expr/map.py``).

A ``MapExpr`` applies a fused ``LocalExpr`` tree to broadcast-aligned
inputs; the optimizer's map fusion folds chains of maps into one tree.
A user ``map`` over masked operands (``MaskedDistArray``) runs ``fn`` on
the data and returns the union of the masks beside it.

On a group mesh a tree of ufuncs runs on the ranks' blocks: each
operand comes to the output's tiling (a scalar as it is, a broadcast
dim whole, any other layout through ``redistribute.relayout``) and the
tree runs on the aligned blocks. The package's own functions in a tree
say how they act on a block (``LocalCall``): a cast or histogram's
bucketing acts on each element; a sort or scan along an axis needs that
axis whole in the block (the operands move to a tiling without it);
``tril``/``triu`` read the block's offset. A user function runs on the
blocks where the aten program it traces to proves it elementwise
(``expr/partition.py``: pointwise ops only): the program traced at the
whole shapes is replayed on the blocks, as GSPMD partitions the ops it
traces, so a size read from an operand's shape keeps its whole value;
any other user function reads its operands whole, counted.
A call that reduces an axis away (``LocalCall(drops=)``, the masked
median along an axis) runs where each block holds that axis whole: the
operands move to the output's tiling with the axis added whole, which
keeps them where the axis is not split and is GSPMD's all-to-all where
it is. ``map_with_location`` runs ``fn`` on the rank's block with its
global offset.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..array import extent as extent_mod
from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from ..parallel import mesh as mesh_mod
from .base import Expr, as_expr, eval_shape_of, fn_key
from .local import LocalCall, LocalExpr, LocalInput, LocalUfunc


def elementwise(op: LocalExpr) -> bool:
    """True for a tree of ufuncs, inputs, constants and casts (no user
    function): it runs on any block of its broadcast-aligned inputs."""
    if isinstance(op, LocalUfunc):
        return all(elementwise(a) for a in op.args)
    if isinstance(op, LocalCall):
        return op.elementwise and all(elementwise(a) for a in op.args)
    return True


def blockwise(op: LocalExpr) -> bool:
    """True for a tree every call of which acts on blocks: elementwise,
    along an axis or at a block's offset."""
    if isinstance(op, LocalUfunc):
        return all(blockwise(a) for a in op.args)
    if isinstance(op, LocalCall):
        return ((op.elementwise or op.along is not None
                 or op.located is not None)
                and all(blockwise(a) for a in op.args))
    return True


def along_axes(op: LocalExpr, ndim: int) -> set:
    """The axes the tree's calls work along (each must be whole in a
    block)."""
    out = set()
    if isinstance(op, LocalCall) and op.along is not None:
        out.add(op.along % ndim)
    for a in getattr(op, "args", ()):
        out |= along_axes(a, ndim)
    return out


def emit_blocks(op: LocalExpr, inputs: Sequence[Expr],
                shape: Tuple[int, ...], t: Tiling, env,
                node: str = "MapExpr"):
    """The tree ``op`` over ``inputs`` run on this rank's block of an
    output of ``shape`` tiled ``t``: (the block, its tiling), or
    NotImplemented where a call cannot act on blocks. Calls along an
    axis or at an offset need every operand of the output's shape (so
    each call sees the block's shape) and the axes they work along
    whole in the block. A tree with a user function runs on the blocks
    where its traced program proves it elementwise
    (:func:`proven_elementwise`; the decision counted at ``node``)."""
    if not broadcasts_to(inputs, shape):
        return NotImplemented
    ew = elementwise(op)
    plan = None
    if not blockwise(op):
        if not proven_elementwise(op, inputs, shape, node):
            return NotImplemented
        plan = _decision(op, inputs, shape)
        ew = True
    vals = [c.lower_local(env) for c in inputs]
    box = box_tiling(vals, shape)
    if box is not None:
        # a restricted walk's operand cut from a leaf: the output stays
        # where the ranks hold that box (expr/incremental.py); a user
        # function is proven at the tiling's blocks, not the box's
        if not elementwise(op):
            return NotImplemented
        t = box
    if not ew:
        if any(c.ndim and c.shape != shape for c in inputs):
            return NotImplemented
        for a in along_axes(op, len(shape)):
            t = t.with_axis(a, None)
        t = tiling_mod.sanitize(t, shape, env.mesh)
        op = op.at(t.block_extent(shape, env.mesh).ul)
    want = t.block_extent(shape, env.mesh).shape
    blocks = aligned_blocks(vals, shape, t)
    blk = op.emit(blocks) if plan is None else plan.run(blocks, want)
    if tuple(blk.shape) != tuple(want):  # every operand a scalar
        blk = torch.broadcast_to(blk, want).clone()
    return blk, t


def dropped_axis(op: LocalExpr, inputs: Sequence[Expr]) -> Optional[int]:
    """The axis a tree reduces away where its root is a call that says so
    (``LocalCall(drops=)``) over elementwise trees (fused producers) of
    inputs of one shape (or scalars); else None."""
    if not isinstance(op, LocalCall) or op.drops is None or \
            not all(elementwise(a) for a in op.args):
        return None
    shapes = {tuple(c.shape) for c in inputs if c.ndim}
    if len(shapes) != 1:
        return None
    return op.drops % len(shapes.pop())


def drop_tiling(t: Tiling, axis: int) -> Tiling:
    """The output tiling of a call that reduces ``axis`` of an operand
    tiled ``t`` away: a mesh axis on ``axis`` moves to the first other
    unsplit dim (the operand then moves once, GSPMD's all-to-all), then
    the axis goes."""
    m = t.axes[axis]
    if m is not None:
        for i, a in enumerate(t.axes):
            if i != axis and a is None:
                t = t.with_axis(i, m)
                break
    return t.drop_axis(axis)


def _want(v_shape: Tuple[int, ...], shape: Tuple[int, ...],
          tiling: Tiling) -> Tiling:
    """The tiling of a value of ``v_shape`` aligned with ``tiling`` of an
    output of ``shape``: the output's axis on each of its dims, a
    broadcast dim (size 1) whole."""
    off = len(shape) - len(v_shape)
    return Tiling([None if d == 1 and shape[i + off] != 1
                   else tiling.axes[i + off]
                   for i, d in enumerate(v_shape)])


def proven_elementwise(op: LocalExpr, inputs: Sequence[Expr],
                       shape: Tuple[int, ...], node: str = "MapExpr") -> bool:
    """True where the tree's program traced at the whole shapes acts on
    each element alone (``expr/partition.py``), decided from metadata
    alone, so every rank agrees, whatever its block. Cached by the tree,
    the shapes and dtypes; each decision is counted in
    ``group_partition_decisions``."""
    from ..obs.metrics import record_partition

    got = _decision(op, inputs, shape)
    reason = got if isinstance(got, str) else None
    record_partition(node, "gather" if reason else "local",
                     reason or "elementwise")
    return reason is None


def _specs(inputs: Sequence[Expr], shapes=None) -> Tuple:
    """(shape, torch dtype) of each input (at ``shapes`` where given)."""
    from ..utils import dtypes
    from .base import ScalarExpr

    shapes = shapes or [c.shape for c in inputs]
    return tuple((tuple(s), c.tdtype if isinstance(c, ScalarExpr)
                  else dtypes.to_torch(c.dtype))
                 for c, s in zip(inputs, shapes))


def _decision(op: LocalExpr, inputs: Sequence[Expr],
              shape: Tuple[int, ...]):
    """:func:`partition.elementwise` for the tree (its plan, or the
    reason it is not proven), cached."""
    from . import partition

    specs = _specs(inputs)
    key = ("map", op.key(), specs, tuple(shape))
    return partition.cached(key, lambda: partition.elementwise(
        lambda *xs: op.emit(list(xs)), specs, tuple(shape)))


def aligned_blocks(vals: Sequence[Any], shape: Tuple[int, ...],
                   tiling: Tiling) -> list:
    """Each local value's block aligned with the block ``tiling`` gives
    this rank of an array of ``shape`` (the values broadcast to it): a
    0-d value as it is; otherwise the value comes to the tiling of its
    own dims (a broadcast dim of size 1 whole), moving where its layout
    differs."""
    from ..parallel import redistribute as redist_mod

    out = []
    for v in vals:
        if v.ndim == 0:
            out.append(v.local)
            continue
        off = len(shape) - v.ndim
        if isinstance(tiling, tiling_mod.BoxTiling):
            # the box's dims of the value; a broadcast dim whole
            want = tiling
            for i in range(off):
                want = want.drop_axis(0)
            for i, d in enumerate(v.shape):
                if d == 1 and shape[i + off] != 1:
                    want = want.whole(i)
        else:
            want = _want(tuple(v.shape), shape, tiling)
        out.append(redist_mod.relayout(v, want).local)
    return out


def box_tiling(vals: Sequence[Any], shape: Tuple[int, ...]):
    """The :class:`~..array.tiling.BoxTiling` of the first local value
    of ``shape`` that carries one, else None."""
    for v in vals:
        t = getattr(v, "tiling", None)
        if isinstance(t, tiling_mod.BoxTiling) and tuple(v.shape) == \
                tuple(shape):
            return t
    return None


def broadcasts_to(vals: Sequence[Any], shape: Tuple[int, ...]) -> bool:
    """True when every value broadcasts to ``shape`` (numpy rules)."""
    for v in vals:
        if v.ndim > len(shape):
            return False
        off = len(shape) - v.ndim
        if any(d not in (1, shape[i + off]) for i, d in enumerate(v.shape)):
            return False
    return True


class MapExpr(Expr):
    """Fused elementwise expression over broadcast-aligned inputs."""

    def __init__(self, inputs: Sequence[Expr], op: LocalExpr):
        self.inputs: Tuple[Expr, ...] = tuple(inputs)
        self.op = op
        out = eval_shape_of(lambda *xs: op.emit(xs), *self.inputs,
                            cache_key=("map", op.key()))
        super().__init__(out.shape, out.dtype)

    def children(self) -> Tuple[Expr, ...]:
        return self.inputs

    def replace_children(self, new_children: Tuple[Expr, ...]) -> "MapExpr":
        return MapExpr(new_children, self.op)

    def _lower(self, env: Dict[int, Any]) -> Any:
        return self.op.emit([c.lower(env) for c in self.inputs])

    def _lower_local(self, env) -> Any:
        from ..array.distarray import DistArray

        ax = dropped_axis(self.op, self.inputs)
        if ax is not None:
            return self._drop_local(env, ax)
        got = emit_blocks(self.op, self.inputs, self.shape,
                          self.out_tiling(), env)
        if got is NotImplemented:
            return got
        blk, t = got
        return DistArray.from_local(blk, t, self.shape, env.mesh)

    def _drop_local(self, env, ax: int) -> Any:
        """A call that reduces ``ax`` away, on this rank's blocks: the
        operands under the output's tiling with ``ax`` added whole, the
        call on them, the output block kept."""
        from ..array.distarray import DistArray
        from ..obs.metrics import record_partition
        from ..parallel import redistribute as redist_mod

        mesh = env.mesh
        t = tiling_mod.sanitize(self.out_tiling(), self.shape, mesh)
        t_in = t.add_axis(ax, None)
        blocks = []
        for c in self.inputs:
            v = c.lower_local(env)
            blocks.append(v.local if not c.ndim else
                          redist_mod.relayout(v, t_in).local)
        record_partition("MapExpr", "local", "drops_axis")
        return DistArray.from_local(self.op.emit(blocks), t, self.shape,
                                    mesh)

    def drop_staging(self, mesh) -> Optional[float]:
        """On a group mesh, for a call that reduces an axis away
        (:meth:`_drop_local`): the blocks its operands move into and the
        most its program, traced at those blocks' shapes, holds beside
        them, less its output block (``resilience/memory.py``); else
        None."""
        ax = dropped_axis(self.op, self.inputs)
        if ax is None or not mesh.is_group:
            return None
        from . import partition

        t = tiling_mod.sanitize(self.out_tiling(), self.shape, mesh)
        t_in = t.add_axis(ax, None)
        staging, shapes = 0.0, []
        for c in self.inputs:
            blk = t_in.block_extent(c.shape, mesh) if c.ndim else None
            shapes.append(blk.shape if c.ndim else ())
            if c.ndim and tiling_mod.sanitize(c.out_tiling(), c.shape,
                                              mesh) != t_in:
                staging += float(blk.size) * c.dtype.itemsize
        specs = _specs(self.inputs, shapes)
        key = ("drop", self.op.key(), specs)
        peak = partition.cached(key, lambda: partition.program_peak(
            lambda *xs: self.op.emit(list(xs)), specs))
        out = float(t.block_extent(self.shape, mesh).size) \
            * self.dtype.itemsize
        return staging + max(peak - out, 0.0)

    def card_units(self, mesh) -> Optional[float]:
        """On a group mesh, for a tree with a user function proven
        elementwise: the most its traced program holds at once, in units
        of its output (``resilience/memory.py``); else None."""
        if not mesh.is_group or blockwise(self.op):
            return None
        got = _decision(self.op, self.inputs, self.shape)
        return None if isinstance(got, str) else got.units

    def _sig(self, ctx) -> Tuple:
        return (("map", self.op.key())
                + tuple(ctx.of(c) for c in self.inputs))

    def cost(self) -> Dict[str, float]:
        """One FLOP per fused op per output element (a transcendental op
        under ``transcendentals``); each input read once, the output
        written once."""
        from .base import io_bytes
        from .local import call_flops, op_counts

        f, t = op_counts(self.op)
        return {"flops": float(f) * self.size
                + call_flops(self.op, self.shape),
                "transcendentals": float(t) * self.size,
                "bytes accessed": io_bytes(self.inputs, self)}

    def _default_tiling(self) -> Tiling:
        ax = dropped_axis(self.op, self.inputs)
        if ax is not None:
            # the operands' tiling without the axis the call reduces
            big = next(c for c in self.inputs if c.ndim)
            return drop_tiling(big.out_tiling(), ax)
        # the largest same-shaped input donates its tiling (the reference
        # evaluated on the owner of the largest input's tiles)
        best: Optional[Tiling] = None
        for c in self.inputs:
            if c.shape == self.shape:
                t = c.out_tiling()
                if t.sharded_axes():
                    return t
                best = best or t
        if best is not None:
            return best
        return tiling_mod.default_tiling(self.shape)


def build_binop(name: str, a: Any, b: Any, reverse: bool = False) -> MapExpr:
    a = as_expr(a)
    b = as_expr(b)
    if reverse:
        a, b = b, a
    return MapExpr((a, b), LocalUfunc(name, (LocalInput(0), LocalInput(1))))


def build_unop(name: str, a: Any) -> MapExpr:
    return MapExpr((as_expr(a),), LocalUfunc(name, (LocalInput(0),)))


def map(fn: Callable, *args: Any, fn_kw: Optional[dict] = None):
    """User map: ``fn`` is a function of torch tensors applied to the
    broadcast-aligned inputs.

    Masked operands propagate: ``fn`` runs on the data and the result's
    mask is the OR of the operands' masks (``numpy.ma``'s ufunc rule),
    broadcast to the output shape."""
    from ..array import masked as masked_mod

    if any(isinstance(a, masked_mod.MaskedDistArray) for a in args):
        out = map(fn, *(masked_mod._data_of(a) for a in args),
                  fn_kw=fn_kw)
        masks = [a.mask for a in args
                 if isinstance(a, masked_mod.MaskedDistArray)]
        mask = masks[0]
        for m in masks[1:]:
            mask = mask | m
        if mask.shape != out.shape:
            mask = map(lambda o, m: torch.broadcast_to(m.to(torch.bool),
                                                       o.shape), out, mask)
        return masked_mod.MaskedDistArray(out, mask)
    inputs = tuple(as_expr(a) for a in args)
    kw = tuple(sorted((fn_kw or {}).items()))
    op = LocalCall(fn, tuple(LocalInput(i) for i in range(len(inputs))), kw)
    return MapExpr(inputs, op)


class MapWithLocationExpr(Expr):
    """Map whose kernel also receives the block's global offset (the
    reference's ``map_with_location``: index-dependent ops).

    ``fn(block, ul)`` runs once per logical block of the input's tiling,
    with ``ul`` that block's global upper-left corner (Python ints), and
    the blocks' results are stitched together: the JAX package runs
    ``fn`` per shard under ``shard_map``. Where the tiling does not
    divide the shape, ``fn`` runs once on the whole array at
    ``(0, ...)``, as there.
    """

    def __init__(self, input: Expr, fn: Callable,
                 fn_kw: Tuple[Tuple[str, Any], ...] = ()):
        self.input = input
        self.fn = fn
        self.fn_kw = fn_kw
        # fn must preserve the block shape; dtype may change
        out = eval_shape_of(
            lambda x: fn(x, tuple(0 for _ in input.shape), **dict(fn_kw)),
            input)
        if out.shape != input.shape:
            raise ValueError(
                "map_with_location kernels must preserve shape; got "
                f"{out.shape} from {input.shape}")
        super().__init__(out.shape, out.dtype)

    def children(self) -> Tuple[Expr, ...]:
        return (self.input,)

    def replace_children(self, new_children: Tuple[Expr, ...]
                         ) -> "MapWithLocationExpr":
        return MapWithLocationExpr(new_children[0], self.fn, self.fn_kw)

    def _lower(self, env: Dict[int, Any]) -> Any:
        x = self.input.lower(env)
        kw = dict(self.fn_kw)
        mesh = mesh_mod.get_mesh()
        tiles = self.input.out_tiling().tiles_per_dim(mesh)
        if any(n > 1 and d % n for d, n in zip(self.shape, tiles)):
            # uneven tiling: a single logical block at (0, ...)
            return self.fn(x, tuple(0 for _ in self.shape), **kw)
        out = None
        for ext in extent_mod.tile_grid(self.shape, tiles):
            sl = ext.to_slice()
            blk = self.fn(x[sl], ext.ul, **kw)
            if out is None:
                # made from the block, so a batched block under
                # ``torch.func.vmap`` gives a batched result
                out = blk.new_empty(self.shape)
            out[sl] = blk
        return out

    def _lower_local(self, env) -> Any:
        t = self.input.out_tiling()
        if not t.divisible(self.shape, env.mesh):
            return NotImplemented  # one block at (0, ...): whole
        from ..array.distarray import DistArray
        from ..parallel import redistribute as redist_mod

        x = redist_mod.relayout(self.input.lower_local(env), t)
        ext = t.block_extent(self.shape, env.mesh)
        blk = self.fn(x.local, ext.ul, **dict(self.fn_kw))
        return DistArray.from_local(blk, t, self.shape, env.mesh)

    def _sig(self, ctx) -> Tuple:
        return ("maploc", fn_key(self.fn), self.fn_kw,
                self.input.out_tiling().axes, ctx.of(self.input))

    def _default_tiling(self) -> Tiling:
        return self.input.out_tiling()


def map_with_location(array: Any, fn: Callable,
                      fn_kw: Optional[dict] = None) -> MapWithLocationExpr:
    return MapWithLocationExpr(as_expr(array), fn,
                               tuple(sorted((fn_kw or {}).items())))
