"""Blocked prefix scan over the logical row shards (port of
``spartan_tpu/ops/scan.py``).

The JAX package runs a scan along a sharded axis 0 as one shard_map
program: a local inclusive scan per shard, an all_gather of the shards'
totals, an exclusive scan of the totals, and the combine of each shard's
local scan with its offset. On one card the p logical shards are the
leading blocks of one tensor and the all_gather is a view, but the
blocked decomposition stays: float sums round as they do in the JAX
package's blocked program (up to the summation order inside a block).

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
