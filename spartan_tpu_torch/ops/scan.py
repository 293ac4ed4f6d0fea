"""Blocked prefix scan over the logical row shards (port of
``spartan_tpu/ops/scan.py``).

The JAX package runs a scan along a sharded axis 0 as one shard_map
program: a local inclusive scan per shard, an all_gather of the shards'
totals, an exclusive scan of the totals, and the combine of each shard's
local scan with its offset. On one card the p logical shards are the
leading blocks of one tensor and the all_gather is a view, but the
blocked decomposition stays: float sums round as they do in the JAX
package's blocked program (up to the summation order inside a block).

On a group mesh (:func:`blocked_scan_local`) the same program runs once
per rank on the block it stores: the local scan, a real all-gather of
the p block totals along the row axis, their inclusive scan, and the
combine with this rank's exclusive offset, so the additions are the
blocked program's, in its order.

Supports add / mul / max / min, axis 0 of arrays of any rank. Result
dtypes follow ``jnp.cumsum``/``cumprod`` with 64-bit types off: bool
scans in int32, every other type keeps its dtype (an int8 sum wraps in
int8, a uint16 sum in uint16).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..parallel import mesh as mesh_mod
from ..utils import dtypes


def _acc_dtype(x: torch.Tensor):
    """The dtype ``jnp.cumsum``/``jnp.cumprod`` return for ``x``."""
    return torch.int32 if x.dtype == torch.bool else x.dtype


def _cumulative(fn, v: torch.Tensor, axis: int) -> torch.Tensor:
    """``fn`` (cumsum or cumprod) accumulating in the result's dtype."""
    return dtypes.call(lambda t: fn(t, dim=axis, dtype=t.dtype),
                       v.to(_acc_dtype(v)))


def _cumsum(v: torch.Tensor, axis: int) -> torch.Tensor:
    return _cumulative(torch.cumsum, v, axis)


def _cumprod(v: torch.Tensor, axis: int) -> torch.Tensor:
    return _cumulative(torch.cumprod, v, axis)


def _cummax(v: torch.Tensor, axis: int) -> torch.Tensor:
    return dtypes.call(lambda t: torch.cummax(t, dim=axis).values, v)


def _cummin(v: torch.Tensor, axis: int) -> torch.Tensor:
    return dtypes.call(lambda t: torch.cummin(t, dim=axis).values, v)


_LOCAL = {"add": _cumsum, "mul": _cumprod, "max": _cummax, "min": _cummin}
_COMBINE = {op: functools.partial(dtypes.call, fn) for op, fn in
            (("add", torch.add), ("mul", torch.mul), ("max", torch.maximum),
             ("min", torch.minimum))}
_IDENTITY = {"add": 0.0, "mul": 1.0, "max": -np.inf, "min": np.inf}


def xla_scan_flops(n: int) -> float:
    """The FLOPs XLA's cost analysis counts for an inclusive scan of
    length ``n`` along one column: a reduce-window of size n (n - 1 per
    element) up to 16; past 16, XLA's rewrite pads to 16-element blocks
    (240 each), adds each block's offset (one per padded element) and
    scans the b block totals (a window of b over b + 1 outputs, or the
    same rewrite again past 16 blocks)."""
    if n <= 16:
        return float(n * (n - 1))
    b = -(-n // 16)
    tail = float((b + 1) * (b - 1)) if b <= 16 else xla_scan_flops(b)
    return 240.0 * b + 16.0 * b + tail


class LocalScan:
    """The cumulative op along one axis as a map function (a scan the
    blocked scan does not take); ``axis=None`` scans the flattened
    array, as ``jnp.cumsum`` does. Equal for equal (op, axis), so a
    rebuilt scan keys the same plan."""

    __slots__ = ("op", "axis")

    def __init__(self, op: str, axis):
        self.op = op
        self.axis = axis

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        if self.axis is None:
            return _LOCAL[self.op](v.reshape(-1), 0)
        return _LOCAL[self.op](v, self.axis)

    def __eq__(self, other) -> bool:
        return (type(other) is LocalScan and other.op == self.op
                and other.axis == self.axis)

    def __hash__(self) -> int:
        return hash(("scan", self.op, self.axis))

    def stable_key(self):
        return ("LocalScan", self.op, self.axis)

    def flops(self, shape) -> float:
        """XLA's count of the scan over an output of ``shape``."""
        size = int(np.prod(shape)) if shape else 1
        n = size if self.axis is None else int(shape[self.axis])
        return xla_scan_flops(n) * (size // max(1, n))


def blocked_scan_flops(rows: int, cols: int, p: int, ndev: int) -> float:
    """One device's FLOPs of the JAX package's blocked scan as XLA
    counts them: the local scan of its (rows, cols) block, the scan of
    the p shards' totals, the combine with its offset (and past 16 rows
    the rewrite's offset add a second time, fused into the combine),
    and the scalar arithmetic of the shard index (5 ops, 6 where the
    row axis is not the whole mesh)."""
    dup = 16 * -(-rows // 16) if rows > 16 else 0
    idx = 5.0 if ndev == p else 6.0
    return (xla_scan_flops(rows) + xla_scan_flops(p) + rows + dup) * cols \
        + idx


def _identity_for(op: str, dtype):
    dt = dtypes.to_numpy(dtype)
    if op in ("max", "min") and np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        return int(info.min if op == "max" else info.max)
    return _IDENTITY[op]


def scan_axes(in_axes, ndim: int) -> tiling_mod.Tiling:
    """The tiling the blocked scan runs under: the scan axis on the mesh
    row axis, trailing axes keeping their mesh assignment (a trailing
    axis that uses the row axis drops to replicated)."""
    row = tiling_mod.AXIS_ROW
    trailing = list(tuple(in_axes or ())[1:]) + [None] * ndim
    axes = [row]
    for a in trailing[:ndim - 1]:
        conflict = a == row or (isinstance(a, tuple) and row in a)
        axes.append(None if conflict else a)
    return tiling_mod.Tiling(axes)


def _kernel(xs: torch.Tensor, p: int, op: str) -> torch.Tensor:
    """The blocked scan of ``xs`` (p, rows, ...): local scans, exclusive
    offsets of the shards' totals, combine."""
    local = _LOCAL[op](xs, 1)
    tot = local[:, -1]                                   # (p, ...) totals
    incl = _LOCAL[op](tot, 0)
    ident = torch.full_like(incl[:1], _identity_for(op, xs.dtype))
    excl = torch.cat([ident, incl[:-1]], dim=0)
    return _COMBINE[op](local, excl[:, None])


def blocked_scan(x: torch.Tensor, op: str = "add", mesh=None,
                 in_axes=None) -> torch.Tensor:
    """Inclusive prefix scan along axis 0 over the mesh row axis's p
    logical shards; the local cumulative op when axis 0 does not split
    into p whole shards (the JAX package's contract)."""
    if op not in _LOCAL:
        raise ValueError(f"unknown scan op {op!r}")
    mesh = mesh or mesh_mod.get_mesh()
    p = int(mesh.shape[tiling_mod.AXIS_ROW])
    n = int(x.shape[0])
    if p <= 1 or n == 0 or n % p != 0:
        return _LOCAL[op](x, 0)
    t = tiling_mod.sanitize(scan_axes(in_axes, x.ndim), x.shape, mesh)
    if t.axes[0] is None:  # sanitize dropped the scan axis
        return _LOCAL[op](x, 0)
    out = _kernel(x.reshape((p, n // p) + tuple(x.shape[1:])), p, op)
    return out.reshape(x.shape)


def blocked_scan_local(arr, op: str, tiling):
    """The blocked scan of a group mesh ``DistArray`` along axis 0, on
    the blocks the ranks store (moved to ``tiling``, the scan axis on
    the row axis or whole): each rank scans its block, the p blocks'
    totals are gathered along the row axis and scanned, and each rank
    combines its block with its exclusive offset. Returns the rank's
    block of the result under ``tiling``."""
    from ..array.distarray import DistArray
    from ..parallel import collectives as coll
    from ..parallel import redistribute as redist_mod

    mesh = arr.mesh
    x = redist_mod.relayout(arr, tiling)
    local = _LOCAL[op](x.local, 0)
    name = tiling.axes[0]
    if name is None or int(mesh.shape[name]) <= 1:
        return DistArray.from_local(local, tiling, arr.shape, mesh)
    tot = local[-1]                                       # (...) total
    incl = _LOCAL[op](coll.stack_over(tot, name, mesh), 0)
    me = mesh.coords[name]
    # the first block combines with the identity, as _kernel's does
    off = (torch.full_like(incl[0], _identity_for(op, local.dtype))
           if me == 0 else incl[me - 1])
    out = _COMBINE[op](local, off)
    return DistArray.from_local(out, tiling, arr.shape, mesh)
