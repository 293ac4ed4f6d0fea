"""shuffle: arbitrary tile redistribution with a user kernel (port of
``spartan_tpu/expr/shuffle.py``).

``kernel(extent, block, **kw)`` runs once per source tile (the tiles the
source's Tiling induces over the logical mesh) on that tile's block as a
numpy array, and yields ``(target_extent, data)`` updates, which are
combined into the target with ``combiner`` (set/add/mul/max/min).
Updates are applied in source-tile order, then in emission order, on
both modes:

* ``mode='sharded'`` (default) never gathers the whole source: a thread
  pool fetches each tile, runs the kernel and cuts every emission into
  the target's tiles (an interval index over the target's tile grid);
  the main thread takes the results in source-tile order, through a
  bounded submission window, and folds each piece into its target tile's
  host block, allocated at its first piece. The touched blocks are then
  copied into the target tensor on the device. ``workers=1`` runs the
  kernels inline.
* ``mode='host'`` gathers the whole source once and scatters into one
  host buffer.

The kernel body runs on the host under the GIL, and each tile's fetch is
a device-to-host copy.
"""

from __future__ import annotations

import bisect
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..array import distarray as da
from ..array import tiling as tiling_mod
from ..array.extent import TileExtent
from ..array.tiling import Tiling
from ..utils import dtypes
from .base import Expr, ValExpr, as_expr, evaluate

_COMBINERS = {
    "set": lambda tgt, sl, v: tgt.__setitem__(sl, v),
    "add": lambda tgt, sl, v: tgt.__setitem__(sl, tgt[sl] + v),
    "mul": lambda tgt, sl, v: tgt.__setitem__(sl, tgt[sl] * v),
    "max": lambda tgt, sl, v: tgt.__setitem__(sl, np.maximum(tgt[sl], v)),
    "min": lambda tgt, sl, v: tgt.__setitem__(sl, np.minimum(tgt[sl], v)),
}


def shuffle(source: Any,
            kernel: Callable[[TileExtent, np.ndarray],
                             Iterable[Tuple[TileExtent, np.ndarray]]],
            target_shape: Optional[Sequence[int]] = None,
            target: Optional[Any] = None,
            dtype: Any = None,
            combiner: Any = "add",
            tile_hint: Optional[Sequence[int]] = None,
            tiling: Optional[Tiling] = None,
            kw: Optional[dict] = None,
            mode: str = "sharded",
            workers: Optional[int] = None) -> Expr:
    """Run ``kernel(extent, block, **kw)`` over every source tile and
    combine its ``(target_extent, data)`` emissions into the target.
    Returns a ValExpr over the new DistArray (evaluated eagerly: the
    kernel is arbitrary Python). On the sharded path kernels may run
    concurrently (``workers`` threads, default ``min(32, 4 x cores)``),
    so a kernel must be thread-safe for any state it shares;
    ``workers=1`` calls them one at a time. Combining is always ordered
    and on one thread."""
    source = as_expr(source)
    src = evaluate(source)
    try:
        name = da._canonical_reducer(combiner)
    except ValueError:
        raise ValueError(f"unsupported combiner {combiner!r}") from None
    kw = kw or {}

    if target is not None:
        tgt = evaluate(as_expr(target))
        out_shape = tgt.shape
        out_dtype = tgt.dtype
        out_tiling = tgt.tiling
    else:
        if target_shape is None:
            raise ValueError("shuffle needs target_shape or target")
        tgt = None
        out_shape = tuple(int(s) for s in target_shape)
        out_dtype = (dtypes.canonical(np.dtype(dtype)) if dtype is not None
                     else src.dtype)
        if tiling is not None:
            out_tiling = tiling
        elif tile_hint is not None:
            out_tiling = tiling_mod.from_tile_hint(out_shape, tile_hint,
                                                   src.mesh)
        else:
            out_tiling = tiling_mod.default_tiling(out_shape, src.mesh)
        out_tiling = tiling_mod.sanitize(out_tiling, out_shape, src.mesh)

    if mode == "sharded":
        result = _shuffle_sharded(src, kernel, kw, out_shape, out_dtype,
                                  out_tiling, name, tgt, workers=workers)
    elif mode == "host":
        result = _shuffle_host(src, kernel, kw, out_shape, out_dtype,
                               out_tiling, name, tgt)
    else:
        raise ValueError(f"unknown shuffle mode {mode!r}")
    return ValExpr(result)


def _normalize(t_ext, data, out_shape, out_dtype):
    if not isinstance(t_ext, TileExtent):
        t_ext = TileExtent(t_ext[0], t_ext[1], out_shape)
    data = np.asarray(data, dtype=out_dtype)
    if data.shape != t_ext.shape:
        data = np.broadcast_to(data, t_ext.shape)
    return t_ext, data


class _RegionIndex:
    """Interval index over the target's tile grid: routing an emission
    is a bisect per axis (O(log g)) plus the product of the hit
    intervals; a linear scan if the regions are not a grid."""

    def __init__(self, regions):
        self.regions = list(regions)
        ndim = len(self.regions[0].ul) if self.regions else 0
        per_dim = [sorted({(r.ul[d], r.lr[d]) for r in self.regions})
                   for d in range(ndim)]
        grid = 1
        for iv in per_dim:
            grid *= len(iv)
        if grid == len(self.regions):
            self._starts = [[iv[0] for iv in dim_ivs] for dim_ivs in per_dim]
            self._ivs = per_dim
            self._by_coord = {
                tuple(bisect.bisect_right(self._starts[d], r.ul[d]) - 1
                      for d in range(ndim)): r
                for r in self.regions}
        else:
            self._by_coord = None

    def hits(self, ext):
        if self._by_coord is None:
            return [r for r in self.regions
                    if ext.intersection(r) is not None]
        hit_ranges = []
        for d, (starts, ivs) in enumerate(zip(self._starts, self._ivs)):
            lo = max(bisect.bisect_right(starts, ext.ul[d]) - 1, 0)
            hi = bisect.bisect_left(starts, ext.lr[d])
            idxs = [i for i in range(lo, hi) if ivs[i][1] > ext.ul[d]]
            if not idxs:
                return []
            hit_ranges.append(idxs)
        out = []

        def rec(d, coord):
            if d == len(hit_ranges):
                r = self._by_coord.get(tuple(coord))
                if r is not None:
                    out.append(r)
                return
            for i in hit_ranges[d]:
                coord.append(i)
                rec(d + 1, coord)
                coord.pop()

        rec(0, [])
        return out


# Optional observability hook for tests: called as hook(event, nbytes)
# with event in {'alloc', 'release'} around each target block's host
# lifetime on the sharded path.
_block_lifecycle_hook: Optional[Callable[[str, int], None]] = None


def _shuffle_sharded(src, kernel, kw, out_shape, out_dtype, out_tiling,
                     combiner_name, tgt, workers=None) -> da.DistArray:
    """Scatter-combine with the kernels fanned out over a thread pool:
    pool tasks fetch a tile, run the kernel and route its emissions into
    per-region piece copies; the main thread folds the pieces in
    source-tile order into host blocks of the touched target tiles."""
    apply_update = _COMBINERS[combiner_name]
    mesh = src.mesh
    regions = sorted(set(out_tiling.extents(out_shape, mesh)),
                     key=lambda r: r.ul)
    index = _RegionIndex(regions)
    hook = _block_lifecycle_hook

    def run_tile(s_ext):
        """Fetch + kernel + route for one source tile (pool worker)."""
        block = src.fetch(s_ext)
        routed = []  # (region, isect, piece copy) in emission order
        for t_ext, data in kernel(s_ext, block, **kw):
            t_ext, data = _normalize(t_ext, data, out_shape, out_dtype)
            for r_ext in index.hits(t_ext):
                isect = t_ext.intersection(r_ext)
                if isect is None:
                    continue
                # a copy: never pin the kernel's whole output by a view
                piece = np.ascontiguousarray(data[t_ext.offset_slice(isect)])
                routed.append((r_ext, isect, piece))
        return routed

    blocks: dict = {}  # touched regions only, allocated at the first piece

    def fold(routed):
        for r_ext, isect, piece in routed:
            base = blocks.get(r_ext)
            if base is None:
                base = (tgt.fetch(r_ext).astype(out_dtype, copy=True)
                        if tgt is not None else np.zeros(r_ext.shape,
                                                         out_dtype))
                if hook:
                    hook("alloc", base.nbytes)
                blocks[r_ext] = base
            apply_update(base, isect.offset_from(r_ext).to_slice(), piece)

    src_extents = list(src.extents())
    if workers is None:
        cores = os.cpu_count() or 1
        workers = min(32, 4 * cores) if cores > 1 else 1
    n_workers = max(1, min(workers, len(src_extents)))
    if n_workers == 1:
        for e in src_extents:
            fold(run_tile(e))
    else:
        # a small fixed slack over the pool size keeps the workers fed
        # without buffering pieces in proportion to the core count
        window = n_workers + 4
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            pending = deque()
            todo = iter(src_extents)

            def submit_next():
                for e in todo:
                    pending.append(pool.submit(run_tile, e))
                    return

            for _ in range(window):
                submit_next()
            while pending:
                routed = pending.popleft().result()  # source-tile order
                submit_next()
                fold(routed)

    tdt = dtypes.to_torch(out_dtype)
    if tgt is not None:
        out = tgt.tensor.to(dtype=tdt, copy=True)
    else:
        out = torch.zeros(out_shape, dtype=tdt, device=mesh.device)
    for r_ext in [r for r in regions if r in blocks]:
        base = blocks.pop(r_ext)
        out[r_ext.to_slice()] = torch.from_numpy(base).to(mesh.device)
        if hook:
            hook("release", base.nbytes)
    return da.DistArray(out, out_tiling, mesh)


def _shuffle_host(src, kernel, kw, out_shape, out_dtype, out_tiling,
                  combiner_name, tgt) -> da.DistArray:
    """Gather the source once and scatter into one host buffer."""
    apply_update = _COMBINERS[combiner_name]
    tgt_np = (tgt.glom().astype(out_dtype, copy=True) if tgt is not None
              else np.zeros(out_shape, out_dtype))
    src_np = src.glom()
    for s_ext in src.extents():
        for t_ext, data in kernel(s_ext, src_np[s_ext.to_slice()], **kw):
            t_ext, data = _normalize(t_ext, data, out_shape, out_dtype)
            apply_update(tgt_np, t_ext.to_slice(), data)
    return da.from_numpy(tgt_np, tiling=out_tiling, mesh=src.mesh)
