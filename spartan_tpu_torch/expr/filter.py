"""Integer-array (and boolean-mask) indexing: the gather half of
``spartan_tpu/expr/filter.py``.

The indices are host data with a static shape. A boolean mask is
turned into its nonzero indices on the host first (its output size is
data-dependent), exactly as in the JAX package.

On a group mesh the indices tell every rank, from shapes and tilings
alone, which output rows it owns and which rank holds each input row
they read: each rank sends the requested rows it holds, in one uneven
all-to-all (``GatherExpr._lower_local``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from .base import Expr, as_expr


class _Pair(NamedTuple):
    """The rows one position sends another: ``out_rows`` in the
    receiver's block (its output rows flattened), ``in_rows`` in the
    sender's block (its leading axes flattened), and the trailing box
    both hold, as slices of each one's trailing block."""

    out_rows: np.ndarray
    in_rows: np.ndarray
    in_trail: Tuple[slice, ...]
    out_trail: Tuple[slice, ...]
    trail_shape: Tuple[int, ...]

    @property
    def numel(self) -> int:
        return int(self.out_rows.size * int(np.prod(self.trail_shape,
                                                     dtype=np.int64)))


class _Route(NamedTuple):
    """This rank's share of a gather's exchange, by rank: what it sends
    each rank, what it receives from each, its own rows, and whether
    any row changes owner anywhere in the group."""

    send: Tuple[Optional[_Pair], ...]
    recv: Tuple[Optional[_Pair], ...]
    own: Optional[_Pair]
    moves: bool


class GatherExpr(Expr):
    """x[indices] (or x[i_idx, j_idx, ...]) with static index arrays."""

    def __init__(self, input: Expr, indices: Tuple[np.ndarray, ...]):
        self.input = input
        self.indices = indices
        out = np.broadcast_shapes(*[ix.shape for ix in indices])
        shape = out + input.shape[len(indices):]
        super().__init__(shape, input.dtype)
        self._routes: Dict[Tuple, _Route] = {}

    def children(self) -> Tuple[Expr, ...]:
        return (self.input,)

    def replace_children(self, new_children) -> "GatherExpr":
        return GatherExpr(new_children[0], self.indices)

    def _lower(self, env: Dict[int, Any]) -> Any:
        x = self.input.lower(env)
        return x[tuple(torch.from_numpy(ix.astype(np.int64)).to(x.device)
                       for ix in self.indices)]

    def _flat_rows(self) -> np.ndarray:
        """The input row (its leading axes flattened) of each output row,
        in the output's row-major order."""
        lead = self.input.shape[:len(self.indices)]
        ix = [np.where(i < 0, i + d, i).astype(np.int64)
              for i, d in zip(np.broadcast_arrays(*self.indices), lead)]
        return np.ravel_multi_index(ix, lead).reshape(-1)

    def _route(self, t_in: Tiling, t_out: Tiling, mesh) -> _Route:
        """Who sends whom which rows (memoized per layout and rank: a
        plan's walks repeat it). From the indices, shapes and tilings
        only, so every rank derives the same exchange."""
        from ..parallel import redistribute as redist_mod

        key = (t_in, t_out, tuple(sorted(mesh.shape.items())), mesh.pos,
               mesh.rank_of_pos)
        hit = self._routes.get(key)
        if hit is not None:
            return hit
        k, nb = len(self.indices), len(self.shape) - (self.input.ndim
                                                      - len(self.indices))
        in_shape, out_shape = self.input.shape, self.shape
        lead = in_shape[:k]
        rows = self._flat_rows().reshape(out_shape[:nb])
        coords = redist_mod._coords(mesh)
        free = redist_mod.free_axes(t_in, mesh)
        ins = [t_in.block_extent(in_shape, mesh, c) for c in coords]
        outs = [t_out.block_extent(out_shape, mesh, c) for c in coords]

        def pair(q: int, p: int) -> Optional[_Pair]:
            if any(coords[q][a] != coords[p][a] for a in free):
                return None  # another line of the free axes sends it
            bi, bo = ins[q], outs[p]
            lo = [max(a, b) for a, b in zip(bi.ul[k:], bo.ul[nb:])]
            hi = [min(a, b) for a, b in zip(bi.lr[k:], bo.lr[nb:])]
            if any(a >= b for a, b in zip(lo, hi)):
                return None
            want = rows[tuple(slice(a, b) for a, b in
                              zip(bo.ul[:nb], bo.lr[:nb]))].reshape(-1)
            multi = np.unravel_index(want, lead)
            hit = np.ones(want.shape, bool)
            for d in range(k):
                hit &= (multi[d] >= bi.ul[d]) & (multi[d] < bi.lr[d])
            j = np.flatnonzero(hit)
            if j.size == 0:
                return None
            src = np.ravel_multi_index(
                [multi[d][j] - bi.ul[d] for d in range(k)], bi.shape[:k])
            return _Pair(j, src.astype(np.int64),
                         tuple(slice(a - u, b - u) for a, b, u in
                               zip(lo, hi, bi.ul[k:])),
                         tuple(slice(a - u, b - u) for a, b, u in
                               zip(lo, hi, bo.ul[nb:])),
                         tuple(b - a for a, b in zip(lo, hi)))

        n = len(coords)
        me = mesh.pos
        moves = any(pair(q, p) is not None for q in range(n)
                    for p in range(n) if q != p)
        rop = mesh.rank_of_pos
        by_rank = (list(range(n)) if rop is None
                   else [rop.index(r) for r in range(n)])
        route = _Route(
            tuple(None if p == me else pair(me, p) for p in by_rank),
            tuple(None if q == me else pair(q, me) for q in by_rank),
            pair(me, me), moves)
        self._routes[key] = route
        return route

    def _lower_local(self, env) -> Any:
        """The rank's output rows, each read from the rank that holds its
        input row: its own rows copied in place, the rest in one uneven
        all-to-all (none when no row changes owner anywhere). Copies
        only, in the indices' order, duplicates included."""
        from ..array.distarray import DistArray
        from ..parallel import collectives as coll

        mesh = env.mesh
        x = self.input.lower_local(env)
        t_out = tiling_mod.sanitize(self.out_tiling(), self.shape, mesh)
        route = self._route(x.tiling, t_out, mesh)
        k = len(self.indices)
        xb = x.local
        x2 = xb.reshape((-1,) + tuple(xb.shape[k:]))
        nb = self.ndim - (self.input.ndim - k)
        ob = t_out.block_extent(self.shape, mesh).shape
        out = torch.empty(ob, dtype=xb.dtype, device=xb.device)
        o2 = out.view((-1,) + tuple(ob[nb:]))
        dev = xb.device

        def take(pr: _Pair) -> torch.Tensor:
            v = torch.index_select(x2, 0, torch.from_numpy(pr.in_rows)
                                   .to(dev))
            return v[(slice(None),) + pr.in_trail]

        def put(pr: _Pair, v: torch.Tensor) -> None:
            j = torch.from_numpy(pr.out_rows).to(dev)
            o2[(j,) + pr.out_trail] = v.reshape((-1,) + pr.trail_shape)

        if route.own is not None:
            put(route.own, take(route.own))
        if not route.moves:
            return DistArray.from_local(out, t_out, self.shape, mesh)
        ins = [0 if pr is None else pr.numel for pr in route.send]
        outs = [0 if pr is None else pr.numel for pr in route.recv]
        send = torch.empty(sum(ins), dtype=xb.dtype, device=dev)
        pos = 0
        for pr, m in zip(route.send, ins):
            if m:
                send.narrow(0, pos, m).copy_(take(pr).reshape(-1))
                pos += m
        recv = coll.exchange_v(send, ins, outs, mesh)
        del send
        pos = 0
        for pr, m in zip(route.recv, outs):
            if m:
                put(pr, recv.narrow(0, pos, m))
                pos += m
        return DistArray.from_local(out, t_out, self.shape, mesh)

    def card_staging(self, mesh) -> float:
        """The rank's own rows read out before they are placed, then the
        send and receive buffers together, each beside the index
        vectors of its largest piece (``resilience/memory.py``)."""
        if not mesh.is_group:
            return 0.0
        t_in = tiling_mod.sanitize(self.input.out_tiling(),
                                   self.input.shape, mesh)
        t_out = tiling_mod.sanitize(self.out_tiling(), self.shape, mesh)
        r = self._route(t_in, t_out, mesh)
        item = self.dtype.itemsize
        pieces = [pr for pr in r.send + r.recv + (r.own,) if pr is not None]
        idx = 8.0 * max((pr.out_rows.size for pr in pieces), default=0)
        own = 0.0 if r.own is None else float(r.own.numel) * item
        if not r.moves:
            return own + idx
        moved = float(sum(pr.numel for pr in r.send + r.recv
                          if pr is not None)) * item
        return max(own, moved) + idx

    def _sig(self, ctx) -> Tuple:
        key = tuple((ix.shape, ix.tobytes()) for ix in self.indices)
        return ("gather", key, ctx.of(self.input))

    def _default_tiling(self) -> Tiling:
        return tiling_mod.default_tiling(self.shape)


def filter(x: Any, mask_or_indices: Any) -> Expr:
    x = as_expr(x)
    idx = mask_or_indices
    if isinstance(idx, Expr):
        idx = idx.glom()
    idx = np.asarray(idx)
    if idx.dtype == np.bool_:
        return GatherExpr(x, tuple(np.asarray(i) for i in np.nonzero(idx)))
    if not np.issubdtype(idx.dtype, np.integer):
        raise TypeError(f"unsupported index dtype {idx.dtype}")
    dim = x.shape[0]
    idx = np.where(idx < 0, idx + dim, idx)
    if (idx < 0).any() or (idx >= dim).any():
        raise IndexError("fancy index out of bounds")
    return GatherExpr(x, (idx,))
