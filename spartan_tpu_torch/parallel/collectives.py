"""Explicit collectives over the mesh (port of
``spartan_tpu/parallel/collectives.py``).

The names and semantics are the JAX package's. Inside a ``shard_map``
body (``parallel/shard_map.py``): :func:`all_reduce` (``add``, ``max``,
``min``, ``mean``), :func:`all_gather` (``tiled=``, ``gather_axis=``),
:func:`reduce_scatter`, :func:`all_to_all`, :func:`ring_permute`,
:func:`axis_index` and :func:`axis_size`. At host level:
:func:`reshard` and :func:`ulysses_swap`.

Each runner carries them its own way:

* **the thread runner** (:class:`ThreadLink`, a logical mesh): in the
  process, on the positions' device tensors. ``add`` folds left in
  position order, so a sum is bit-stable from run to run; the result is
  computed once per line of positions and shared.
* **the group runner** (:class:`GroupRunner`, a group mesh): through
  ``torch.distributed`` on the axis sub-group, with the pieces in
  coordinate order along the line. On a rotated mesh
  (``mesh.rotated_mesh``) a line's coordinates are not its sub-group's
  rank order: gathers and all-to-alls reorder the pieces, and a sum
  over a line of more than two ranks first moves each value to the
  group rank of its coordinate, so the backend adds in the unrotated
  mesh's order (a sum of two is the same bits either way). On a
  ``gloo`` group a
  CUDA tensor goes through a host buffer and back: gloo has no CUDA
  form of these calls in the card's torch build (a CUDA ``all_reduce``
  aborts the process there, ``writev: Bad address``). That transport is
  named and counted (``collective_host_staged_calls``/``_bytes`` in
  ``REGISTRY``); on an ``nccl`` group nothing is staged, and a CPU
  tensor raises. Gradients
  flow through ``all_reduce`` (``add``, ``mean``), ``all_gather``,
  ``reduce_scatter``, ``all_to_all`` and ``ring_permute`` by their
  transposes.

Every call counts ``collective_calls``/``collective_bytes`` by op (the
bytes of the calling position's input).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from ..array.tiling import Tiling
from ..obs.metrics import (record_collective, record_received,
                           record_staged)
from . import mesh as mesh_mod
from . import shard_map as smap

_OPS = ("add", "max", "min", "mean")


def _count(op: str, x: torch.Tensor, axis: str) -> None:
    record_collective(op, x.numel() * x.element_size(),
                      smap.current().size(axis))


def _check_op(op: str) -> None:
    if op not in _OPS:
        raise ValueError(f"unknown all_reduce op {op!r}")


def _check_split(x: torch.Tensor, dim: int, n: int, what: str) -> None:
    if x.shape[dim] % n:
        raise ValueError(f"{what}: dim {dim} of extent {x.shape[dim]} does "
                         f"not split over {n} positions")


def _fold(vals: List[torch.Tensor], op: str) -> torch.Tensor:
    acc = vals[0]
    for v in vals[1:]:
        if op in ("add", "mean"):
            acc = acc + v
        elif op == "max":
            acc = torch.maximum(acc, v)
        else:
            acc = torch.minimum(acc, v)
    if op == "mean" and len(vals) > 1:
        acc = acc / len(vals)
    return acc


# -- the thread runner ---------------------------------------------------


class ThreadLink:
    """One position's collectives on the thread runner."""

    def __init__(self, runner: "smap.ThreadRunner", coords):
        self.runner = runner
        self.coords = coords
        self.mesh = runner.mesh

    def _ex(self, axis: str, x: Any,
            combine: Optional[Callable[[List[Any]], Any]] = None) -> Any:
        return self.runner.exchange(axis, self.coords, x, combine)

    def all_reduce(self, x, axis, op):
        if self.mesh.shape[axis] == 1:
            return x
        return self._ex(axis, x, lambda vals: _fold(vals, op))

    def all_gather(self, x, axis, dim, tiled=True):
        if tiled:
            return self._ex(axis, x, lambda vals: torch.cat(vals, dim))
        return self._ex(axis, x, lambda vals: torch.stack(vals, dim))

    def reduce_scatter(self, x, axis, dim):
        n = self.mesh.shape[axis]
        _check_split(x, dim, n, "reduce_scatter")
        total = self._ex(axis, x, lambda vals: _fold(vals, "add"))
        return total.chunk(n, dim)[self.coords[axis]]

    def all_to_all(self, x, axis, split_axis, concat_axis):
        n = self.mesh.shape[axis]
        _check_split(x, split_axis, n, "all_to_all")
        me = self.coords[axis]
        vals = self._ex(axis, x)
        return torch.cat([v.chunk(n, split_axis)[me] for v in vals],
                         concat_axis)

    def ring_permute(self, x, axis, shift):
        n = self.mesh.shape[axis]
        vals = self._ex(axis, x)
        return vals[(self.coords[axis] - shift) % n]


# -- the group runner ----------------------------------------------------


class _Transposed(torch.autograd.Function):
    """A group collective with its transpose as the backward. ``anchor``
    (a scalar that requires grad) makes every rank record the call, so
    the transposes run on every rank whatever each rank's operand."""

    @staticmethod
    def forward(ctx, x, anchor, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g.contiguous()), None, None, None


class GroupRunner:
    """The rank's collectives on a group mesh, through
    ``torch.distributed`` on the axis sub-groups."""

    def __init__(self, mesh: mesh_mod.Mesh, track: bool = False):
        import torch.distributed as dist

        self.mesh = mesh
        self.dist = dist
        self.backend = dist.get_backend(mesh.group)
        # recorded for autograd on every rank alike (the shard_map's
        # inputs ask for gradients): see _Transposed
        self._anchor = (torch.zeros((), requires_grad=True) if track
                        else None)

    def _differentiable(self, x: torch.Tensor, fwd: Callable,
                        bwd: Callable) -> torch.Tensor:
        if self._anchor is not None and torch.is_grad_enabled():
            return _Transposed.apply(x, self._anchor, fwd, bwd)
        return fwd(x)

    def _line(self, axis: str):
        pg, members = self.mesh.axis_group(axis)
        return pg, len(members), self.mesh.coords[axis]

    def _swap(self, t: torch.Tensor, pg, n: int, send_to: int,
              recv_from: int) -> torch.Tensor:
        """``t`` sent to group rank ``send_to`` of ``pg``, and the
        same-shaped tensor group rank ``recv_from`` sent here."""
        flat = t.reshape(-1)
        m = flat.numel()
        out = torch.empty_like(flat)
        self.dist.all_to_all_single(
            out, flat, [m if r == recv_from else 0 for r in range(n)],
            [m if r == send_to else 0 for r in range(n)], group=pg)
        return out.view(t.shape)

    def _in_rank_order(self, t: torch.Tensor, axis: str, order,
                       back: bool = False) -> torch.Tensor:
        """On a line whose coordinates are not its group's rank order:
        coordinate c's ``t`` moved to group rank c (so the backend
        combines in the unrotated order), or with ``back`` group rank
        c's ``t`` moved to coordinate c."""
        pg, n, me = self._line(axis)
        mine = order[me]
        if back:
            return self._swap(t, pg, n, order[mine], me)
        return self._swap(t, pg, n, me, order[mine])

    def _transport(self, op: str, x: torch.Tensor,
                   call: Callable[[torch.Tensor], torch.Tensor]
                   ) -> torch.Tensor:
        """``call`` on ``x``; through a host buffer (counted) for a CUDA
        tensor on a gloo group."""
        x = x.contiguous()
        if self.backend == "nccl":
            if x.device.type != "cuda":
                raise ValueError(f"{op} on an nccl group takes CUDA "
                                 f"tensors, not {x.device}")
            return call(x)
        if x.device.type == "cuda":
            record_staged(op, x.numel() * x.element_size())
            return call(x.cpu()).to(x.device)
        return call(x)

    def all_reduce(self, x, axis, op):
        pg, n, _ = self._line(axis)
        if pg is None:
            return x
        dist = self.dist
        red = {"add": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]

        def run(t):
            out = self.reduce_line(t, axis, red)
            return out / n if op == "mean" else out

        if op in ("max", "min"):
            if torch.is_grad_enabled() and x.requires_grad:
                raise NotImplementedError(
                    f"no gradient through all_reduce({op!r}) on a group")
            return smap.mark_same(run(x), x, axis)
        return smap.mark_same(self._differentiable(x, run, run), x, axis)

    def all_gather(self, x, axis, dim, tiled=True):
        pg, n, _ = self._line(axis)
        if pg is None:
            return x if tiled else x.unsqueeze(dim)
        dist = self.dist
        order = self.mesh.line_order(axis)

        def call(t):
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=pg)
            if order is not None:  # group rank order -> coordinates
                parts = [parts[g] for g in order]
            return torch.cat(parts, dim) if tiled else torch.stack(parts,
                                                                   dim)

        def run(t):
            return self._transport("all_gather", t, call)

        def back(g):
            if tiled:
                return self._reduce_scatter(g, axis, dim)
            return self._reduce_scatter(g, axis, dim).squeeze(dim)

        return smap.mark_same(self._differentiable(x, run, back), x, axis)

    def broadcast_first(self, x, axis):
        """Position 0's ``x`` along ``axis``, on every member (output
        assembly's; its gradient is ``shard_map``'s)."""
        pg, _, _ = self._line(axis)
        if pg is None:
            return x
        src = self.mesh.axis_group(axis)[1][0]

        def call(t):
            buf = t.clone()
            self.dist.broadcast(buf, src=src, group=pg)
            return buf

        return self._transport("broadcast", x, call)

    def _reduce_scatter(self, x, axis, dim):
        pg, n, _ = self._line(axis)
        if pg is None:
            return x
        _check_split(x, dim, n, "reduce_scatter")
        dist = self.dist
        order = self.mesh.line_order(axis)

        def call(t):
            if order is not None and n > 2:
                t = self._in_rank_order(t, axis, order)
            chunks = [c.contiguous() for c in t.chunk(n, dim)]
            if order is not None and n <= 2:
                # group rank g takes coordinate order.index(g)'s chunk
                chunks = [chunks[order.index(g)] for g in range(n)]
            out = torch.empty_like(chunks[0])
            dist.reduce_scatter(out, chunks, group=pg)
            if order is not None and n > 2:
                out = self._in_rank_order(out, axis, order, back=True)
            return out

        return self._transport("reduce_scatter", x, call)

    def reduce_scatter(self, x, axis, dim):
        return self._differentiable(
            x, lambda t: self._reduce_scatter(t, axis, dim),
            lambda g: self.all_gather(g, axis, dim))

    def _all_to_all(self, x, axis, split_axis, concat_axis):
        pg, n, _ = self._line(axis)
        if pg is None:
            return x
        _check_split(x, split_axis, n, "all_to_all")
        dist = self.dist
        order = self.mesh.line_order(axis)

        def call(t):
            # the chunks stacked on a new leading dim: all_to_all_single
            # (gloo has no list form of all_to_all in every build)
            chunks = t.chunk(n, split_axis)
            if order is not None:  # chunk c goes to coordinate c
                chunks = [chunks[order.index(g)] for g in range(n)]
            send = torch.stack(chunks).contiguous()
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=pg)
            parts = recv.unbind(0)
            if order is not None:
                parts = [parts[g] for g in order]
            return torch.cat(parts, concat_axis)

        return self._transport("all_to_all", x, call)

    def all_to_all(self, x, axis, split_axis, concat_axis):
        return self._differentiable(
            x, lambda t: self._all_to_all(t, axis, split_axis, concat_axis),
            lambda g: self._all_to_all(g, axis, concat_axis, split_axis))

    def _permute(self, x, axis, shift):
        pg, n, me = self._line(axis)
        if pg is None:
            return x
        dst, src = (me + shift) % n, (me - shift) % n
        order = self.mesh.line_order(axis)
        if order is not None:
            dst, src = order[dst], order[src]
        return self._transport("ring_permute", x, lambda t: self._swap(
            t, pg, n, dst, src))

    def ring_permute(self, x, axis, shift):
        return self._differentiable(x, lambda t: self._permute(t, axis, shift),
                               lambda g: self._permute(g, axis, -shift))

    def reduce_line(self, t: torch.Tensor, axis: str, red) -> torch.Tensor:
        """``t`` combined by the backend's ``red`` over this rank's line
        of ``axis`` (in the unrotated order, as :meth:`all_reduce`)."""
        pg, n, _ = self._line(axis)
        order = self.mesh.line_order(axis)

        def call(buf):
            if order is not None and n > 2:
                buf = self._in_rank_order(buf, axis, order)
            else:
                buf = buf.clone()
            self.dist.all_reduce(buf, op=red, group=pg)
            return buf

        return self._transport("all_reduce", t, call)

    def all_to_all_v(self, x, in_splits, out_splits):
        """``all_to_all_single`` of the flat ``x`` over the whole group
        with uneven splits: ``in_splits[r]`` elements go to rank r,
        ``out_splits[r]`` come from it, in rank order."""
        dist = self.dist
        pg = self.mesh.group

        def call(t):
            out = torch.empty(sum(out_splits), dtype=t.dtype,
                              device=t.device)
            dist.all_to_all_single(out, t, list(out_splits),
                                   list(in_splits), group=pg)
            return out

        return self._transport("all_to_all", x, call)


# -- local blocks on a group mesh (outside shard_map) ---------------------
#
# Storage on a group mesh keeps each array's block on its rank
# (array/distarray.py). These moves of whole blocks between the ranks
# run outside any shard_map body, through the mesh's GroupRunner; each
# records collective_calls/_bytes and the bytes the rank needs from the
# other positions (group_received_bytes: the peers' blocks of a gather
# or all-reduce, the peers' chunks of an all-to-all).

# collectives carry these dtypes as a same-width integer view (the
# backends have no sum or transport for some of them)
_WIRE = {torch.bool: torch.uint8, torch.uint16: torch.int16,
         torch.uint32: torch.int32, torch.uint64: torch.int64,
         torch.bfloat16: torch.int16}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _to_wire(t: torch.Tensor):
    """(``t`` as the backends move it, the dtype to view the result back
    as, or None when it travels as it is)."""
    wire = _WIRE.get(t.dtype)
    if wire is None:
        return t.contiguous(), None
    return t.contiguous().view(wire), t.dtype


def _from_wire(t: torch.Tensor, dtype) -> torch.Tensor:
    return t if dtype is None else t.view(dtype)


def new_runner(mesh: mesh_mod.Mesh, track: bool = False) -> GroupRunner:
    """A runner of ``mesh``'s collectives: the group's own, or the one
    its group object names (the plan audit's dry group, whose calls
    move nothing)."""
    cls = getattr(mesh.group, "runner_cls", None) or GroupRunner
    return cls(mesh, track)


def group_runner(mesh: mesh_mod.Mesh) -> GroupRunner:
    """The group mesh's runner for collectives outside shard_map."""
    if mesh.runner is None:
        mesh.runner = new_runner(mesh)
    return mesh.runner


def _live_axes(axes, mesh: mesh_mod.Mesh) -> List[str]:
    return [a for a in axes if mesh.shape[a] > 1]


def gather_dim(block: torch.Tensor, dim: int, entry, size: int,
               mesh: mesh_mod.Mesh) -> torch.Tensor:
    """The whole of dim ``dim`` (of extent ``size``) from the blocks of
    the positions along the mesh axes of the tiling entry ``entry``:
    each block is padded to the largest tile (``all_gather`` takes equal
    sizes), gathered over the inner axis of a tuple first (row-major
    tile order), and the padding is cut after."""
    from ..array import extent as extent_mod
    from ..array import tiling as tiling_mod

    n = tiling_mod.tile_count(entry, mesh)
    if n == 1:
        return block
    splits = extent_mod.compute_splits(size, n)
    lens = [hi - lo for lo, hi in splits] + [0] * (n - len(splits))
    mx = max(lens)
    if mx == 0:
        return block
    if block.shape[dim] < mx:
        pad = list(block.shape)
        pad[dim] = mx - block.shape[dim]
        block = torch.cat([block, block.new_zeros(pad)], dim)
    out, dtype = _to_wire(block)
    runner = group_runner(mesh)
    for sub in reversed(_live_axes(tiling_mod.mesh_axes_of(entry), mesh)):
        before = _nbytes(out)
        out = runner.all_gather(out, sub, dim)
        record_collective("all_gather", before, mesh.shape[sub])
        record_received("all_gather", _nbytes(out) - before)
    out = _from_wire(out, dtype)
    if all(ln == mx for ln in lens):
        return out
    return torch.cat([out.narrow(dim, i * mx, ln)
                      for i, ln in enumerate(lens) if ln], dim)


def gather_whole(block: torch.Tensor, tiling: Tiling, shape,
                 mesh: mesh_mod.Mesh) -> torch.Tensor:
    """The whole array from the ranks' blocks under ``tiling`` (a box's
    blocks, which follow another array's grid, through the piece
    exchange)."""
    from ..array.tiling import BoxTiling, replicated
    from . import redistribute as redist_mod

    if isinstance(tiling, BoxTiling):
        return redist_mod.move_pieces([redist_mod.Piece(
            block, lambda c: tiling.block_extent(shape, mesh, c),
            redist_mod.free_axes(tiling, mesh))], replicated(len(shape)),
            shape, block.dtype, mesh)
    for dim, a in enumerate(tiling.axes):
        block = gather_dim(block, dim, a, int(shape[dim]), mesh)
    return block


def stack_over(t: torch.Tensor, axis: str,
               mesh: mesh_mod.Mesh) -> torch.Tensor:
    """Every position's ``t`` along ``axis``, stacked on a new leading
    dim in position order."""
    if mesh.shape[axis] == 1:
        return t[None]
    w, dtype = _to_wire(t)
    out = group_runner(mesh).all_gather(w, axis, 0, tiled=False)
    record_collective("all_gather", _nbytes(w), mesh.shape[axis])
    record_received("all_gather", _nbytes(out) - _nbytes(w))
    return _from_wire(out, dtype)


def reduce_over(t: torch.Tensor, axes, op: str,
                mesh: mesh_mod.Mesh) -> torch.Tensor:
    """``t`` combined by ``op`` (``add``, ``prod``, ``max``, ``min``)
    over the positions along each mesh axis of ``axes``. Integers sum
    and multiply as int64 and come back to their dtype (so int32 wraps
    as it would in one pass); bools combine as uint8."""
    live = _live_axes(axes, mesh)
    if not live:
        return t
    runner = group_runner(mesh)
    dist = runner.dist
    dtype = t.dtype
    if dtype == torch.bool:
        t = t.to(torch.uint8)
    elif not (dtype.is_floating_point or dtype.is_complex) \
            and op in ("add", "prod"):
        t = t.to(torch.int64)
    red = {"add": dist.ReduceOp.SUM, "prod": dist.ReduceOp.PRODUCT,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
    for axis in live:
        n = mesh.shape[axis]
        record_collective("all_reduce", _nbytes(t), n)
        record_received("all_reduce", _nbytes(t) * (n - 1))
        t = runner.reduce_line(t, axis, red)
    return t.to(dtype) if t.dtype != dtype else t


def combine_owned(t: torch.Tensor, axes, mesh: mesh_mod.Mesh
                  ) -> torch.Tensor:
    """Exact combine of values that one position along ``axes`` holds
    and every other position leaves zero: the bits are summed as
    integers, so every value (-0.0 and NaN payloads included) arrives
    as its owner wrote it."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    bits = t.contiguous().view(ints[t.element_size()])
    return reduce_over(bits, axes, "add", mesh).view(t.dtype)


def exchange(t: torch.Tensor, axis: str, split_dim: int, concat_dim: int,
             mesh: mesh_mod.Mesh) -> torch.Tensor:
    """``all_to_all`` of a local block over ``axis``: chunk ``j`` of
    ``split_dim`` goes to position ``j``; the chunks received are
    concatenated along ``concat_dim`` in position order."""
    n = mesh.shape[axis]
    if n == 1:
        return t
    w, dtype = _to_wire(t)
    record_collective("all_to_all", _nbytes(w), n)
    record_received("all_to_all", _nbytes(w) * (n - 1) // n)
    return _from_wire(group_runner(mesh)._all_to_all(w, axis, split_dim,
                                                     concat_dim), dtype)


def exchange_v(send: torch.Tensor, in_splits, out_splits,
               mesh: mesh_mod.Mesh) -> torch.Tensor:
    """One ``all_to_all`` of uneven pieces over the whole group: the
    flat ``send`` holds ``in_splits[r]`` elements for each rank r in
    rank order, and the result the ``out_splits[r]`` elements each rank
    r sent here. Counted as an ``all_to_all`` of ``send``'s bytes."""
    w, dtype = _to_wire(send.reshape(-1))
    n = len(in_splits)
    record_collective("all_to_all", _nbytes(w), n)
    record_received("all_to_all", (sum(out_splits) - out_splits[mesh.rank])
                    * w.element_size())
    return _from_wire(group_runner(mesh).all_to_all_v(w, in_splits,
                                                      out_splits), dtype)


# -- in-kernel collectives (call inside shard_map) ------------------------


def all_reduce(x: torch.Tensor, axis: str = mesh_mod.AXIS_ROW,
               op: str = "add") -> torch.Tensor:
    """The lowering of the reference's reducer-merge."""
    _check_op(op)
    pos = smap.current()
    _count("all_reduce", x, axis)
    return pos.runner.all_reduce(x, axis, op)


def all_gather(x: torch.Tensor, axis: str = mesh_mod.AXIS_ROW, *,
               gather_axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """The lowering of the reference's remote tile fetch: the blocks of
    the positions along ``axis`` concatenated (``tiled``) or stacked
    along ``gather_axis``."""
    pos = smap.current()
    _count("all_gather", x, axis)
    return pos.runner.all_gather(x, axis, gather_axis % max(x.ndim, 1)
                                 if tiled else gather_axis, tiled)


def reduce_scatter(x: torch.Tensor, axis: str = mesh_mod.AXIS_ROW, *,
                   scatter_axis: int = 0) -> torch.Tensor:
    """The sum over ``axis``, of which each position keeps its own
    block along ``scatter_axis`` (``psum_scatter``, tiled)."""
    pos = smap.current()
    _count("reduce_scatter", x, axis)
    return pos.runner.reduce_scatter(x, axis, scatter_axis % x.ndim)


def all_to_all(x: torch.Tensor, axis: str = mesh_mod.AXIS_ROW, *,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """The lowering of the reference's shuffle: block ``j`` of
    ``split_axis`` goes to position ``j``; the blocks received are
    concatenated along ``concat_axis`` in position order."""
    pos = smap.current()
    _count("all_to_all", x, axis)
    return pos.runner.all_to_all(x, axis, split_axis % x.ndim,
                                 concat_axis % x.ndim)


def ring_permute(x: torch.Tensor, axis: str = mesh_mod.AXIS_ROW,
                 shift: int = 1) -> torch.Tensor:
    """Rotate blocks around the ring (the substrate of ring attention
    and pipeline stages): ``shift=+1`` sends to the next position."""
    pos = smap.current()
    _count("ring_permute", x, axis)
    return pos.runner.ring_permute(x, axis, shift)


def axis_index(axis: str = mesh_mod.AXIS_ROW) -> int:
    return smap.current().index(axis)


def axis_size(axis: str = mesh_mod.AXIS_ROW) -> int:
    if smap.inside():
        return smap.current().size(axis)
    return mesh_mod.get_mesh().shape[axis]


# -- host-level resharding ----------------------------------------------


def reshard(arr: Any, tiling: Tiling):
    """``arr`` (a DistArray or a whole tensor) under ``tiling``, as a
    DistArray. On a logical mesh only the tiling changes; on a group
    mesh each rank ends with its block under ``tiling`` (a DistArray
    moves between the ranks, ``DistArray.retile``; a whole tensor is
    cut to the rank's block)."""
    from ..array.distarray import DistArray, from_tensor

    if isinstance(arr, DistArray):
        return arr.retile(tiling)
    return from_tensor(arr, tiling=tiling)


def ulysses_swap(arr: torch.Tensor, seq_axis: int, head_axis: int,
                 mesh_axis: str = mesh_mod.AXIS_ROW) -> torch.Tensor:
    """Ulysses-style axis swap: move the mesh split from ``seq_axis`` to
    ``head_axis`` with one all-to-all."""
    from ..array.distarray import DistArray

    if isinstance(arr, DistArray):
        arr = arr.materialize("ulysses_swap")
    ndim = arr.ndim
    in_axes: List[Optional[str]] = [None] * ndim
    in_axes[seq_axis] = mesh_axis
    out_axes: List[Optional[str]] = [None] * ndim
    out_axes[head_axis] = mesh_axis

    def kern(x):
        return all_to_all(x, mesh_axis, split_axis=head_axis,
                          concat_axis=seq_axis)

    return smap.shard_map(kern, None, (Tiling(in_axes),),
                          Tiling(out_axes))(arr)
