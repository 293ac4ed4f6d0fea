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
  ``torch.distributed`` on the axis sub-group. On a ``gloo`` group a
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
from ..obs.metrics import record_collective, record_staged
from . import mesh as mesh_mod
from . import shard_map as smap

_OPS = ("add", "max", "min", "mean")


def _count(op: str, x: torch.Tensor) -> None:
    record_collective(op, x.numel() * x.element_size())


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
            def call(buf):
                buf = buf.clone()
                dist.all_reduce(buf, op=red, group=pg)
                return buf

            out = self._transport("all_reduce", t, call)
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

        def call(t):
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t, group=pg)
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

        def call(t):
            chunks = [c.contiguous() for c in t.chunk(n, dim)]
            out = torch.empty_like(chunks[0])
            dist.reduce_scatter(out, chunks, group=pg)
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

        def call(t):
            # the chunks stacked on a new leading dim: all_to_all_single
            # (gloo has no list form of all_to_all in every build)
            send = torch.stack(t.chunk(n, split_axis)).contiguous()
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=pg)
            return torch.cat(recv.unbind(0), concat_axis)

        return self._transport("all_to_all", x, call)

    def all_to_all(self, x, axis, split_axis, concat_axis):
        return self._differentiable(
            x, lambda t: self._all_to_all(t, axis, split_axis, concat_axis),
            lambda g: self._all_to_all(g, axis, concat_axis, split_axis))

    def _permute(self, x, axis, shift):
        pg, n, me = self._line(axis)
        if pg is None:
            return x
        dist = self.dist
        dst, src = (me + shift) % n, (me - shift) % n

        def call(t):
            flat = t.reshape(-1)
            m = flat.numel()
            out = torch.empty_like(flat)
            dist.all_to_all_single(
                out, flat, [m if r == src else 0 for r in range(n)],
                [m if r == dst else 0 for r in range(n)], group=pg)
            return out.view(t.shape)

        return self._transport("ring_permute", x, call)

    def ring_permute(self, x, axis, shift):
        return self._differentiable(x, lambda t: self._permute(t, axis, shift),
                               lambda g: self._permute(g, axis, -shift))


# -- in-kernel collectives (call inside shard_map) ------------------------


def all_reduce(x: torch.Tensor, axis: str = mesh_mod.AXIS_ROW,
               op: str = "add") -> torch.Tensor:
    """The lowering of the reference's reducer-merge."""
    _check_op(op)
    pos = smap.current()
    _count("all_reduce", x)
    return pos.runner.all_reduce(x, axis, op)


def all_gather(x: torch.Tensor, axis: str = mesh_mod.AXIS_ROW, *,
               gather_axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """The lowering of the reference's remote tile fetch: the blocks of
    the positions along ``axis`` concatenated (``tiled``) or stacked
    along ``gather_axis``."""
    pos = smap.current()
    _count("all_gather", x)
    return pos.runner.all_gather(x, axis, gather_axis % max(x.ndim, 1)
                                 if tiled else gather_axis, tiled)


def reduce_scatter(x: torch.Tensor, axis: str = mesh_mod.AXIS_ROW, *,
                   scatter_axis: int = 0) -> torch.Tensor:
    """The sum over ``axis``, of which each position keeps its own
    block along ``scatter_axis`` (``psum_scatter``, tiled)."""
    pos = smap.current()
    _count("reduce_scatter", x)
    return pos.runner.reduce_scatter(x, axis, scatter_axis % x.ndim)


def all_to_all(x: torch.Tensor, axis: str = mesh_mod.AXIS_ROW, *,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """The lowering of the reference's shuffle: block ``j`` of
    ``split_axis`` goes to position ``j``; the blocks received are
    concatenated along ``concat_axis`` in position order."""
    pos = smap.current()
    _count("all_to_all", x)
    return pos.runner.all_to_all(x, axis, split_axis % x.ndim,
                                 concat_axis % x.ndim)


def ring_permute(x: torch.Tensor, axis: str = mesh_mod.AXIS_ROW,
                 shift: int = 1) -> torch.Tensor:
    """Rotate blocks around the ring (the substrate of ring attention
    and pipeline stages): ``shift=+1`` sends to the next position."""
    pos = smap.current()
    _count("ring_permute", x)
    return pos.runner.ring_permute(x, axis, shift)


def axis_index(axis: str = mesh_mod.AXIS_ROW) -> int:
    return smap.current().index(axis)


def axis_size(axis: str = mesh_mod.AXIS_ROW) -> int:
    if smap.inside():
        return smap.current().size(axis)
    return mesh_mod.get_mesh().shape[axis]


# -- host-level resharding ----------------------------------------------


def reshard(arr: Any, tiling: Tiling):
    """``arr`` (a DistArray or a tensor) under ``tiling``, as a
    DistArray. Every rank and every logical position reads the same
    whole tensor, so only the tiling changes."""
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
        arr = arr.tensor
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
