"""Segment sums and the windowed sorted-segment plan (port of
``spartan_tpu/ops/segment.py``).

``segment_sum(vals, ids, k, impl)`` sums rows of ``vals`` into ``k``
buckets by ``ids``; ids outside ``[0, k)`` are dropped. Its paths, under
the JAX package's names (``FLAGS.segment_impl`` or ``impl=``):

* ``xla`` — the library scatter: ``index_add_`` of the in-range entries
  (XLA's scatter in the JAX package);
* ``onehot`` — ``onehot(ids)^T @ vals`` in IEEE f32;
* ``pallas`` — the hand-written block kernel
  (``kernels/segment.py::segment_sum_block``), when the registry's
  constraints hold, else ``onehot``; on a group mesh its ``shard_map``
  form ``segment_sum_sharded``, one kernel per rank;
* ``auto`` — the registry decides: under ``FLAGS.native_kernels=auto``
  segment sums keep the library scatter (the JAX package's measured-off
  rule, ``kernels/registry.py``); ``native_kernels=on`` selects the
  kernel wherever its constraints hold.

:class:`SegmentPlan` lays a sorted id stream out on the host for the
windowed kernel (``kernels/segment.py::windowed_segsum``), as the JAX
package's plan does; its layout arrays equal the JAX plan's.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..kernels import registry as kernels_mod
from ..kernels import segment as ksegment
from ..parallel import mesh as mesh_mod
from ..parallel.mesh import DeviceLike
from ..utils import dtypes
from ..utils.config import FLAGS

FLAGS.define_str("segment_impl", "auto",
                 "segment-sum path: auto|xla|onehot|pallas")


def _segment_sum_xla(vals: torch.Tensor, ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """``index_add_`` of every entry into zeros of one spare bucket more,
    the out-of-range ids pointed at the spare one, which is cut off: the
    kept buckets add their entries in the same order as an add of the
    kept entries alone, and no step depends on the data (it traces to
    an ``index_add`` into zeros, which the row proof of
    ``expr/partition.py`` splits over the rows)."""
    keep = (ids >= 0) & (ids < num_segments)
    slot = torch.where(keep, ids, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, slot, vals)[:num_segments]


def _select(vals: torch.Tensor, num_segments: int,
            force: bool = False) -> kernels_mod.Selection:
    return kernels_mod.select(
        "segment_sum", vals.shape, dtypes.to_numpy(vals.dtype),
        tiling_mod.row(max(vals.ndim, 1)), force=force,
        num_segments=num_segments)


def segment_sum(vals: torch.Tensor, ids: torch.Tensor, num_segments: int,
                impl: Optional[str] = None, sorted_ids: bool = False,
                local: bool = False) -> torch.Tensor:
    """Sum ``vals`` rows into ``num_segments`` buckets by ``ids``; ids
    outside ``[0, num_segments)`` are dropped. ``sorted_ids`` is the JAX
    package's hint to XLA's scatter; ``index_add_`` has no use for it.

    On a group mesh the kernel path of whole tensors is the group form
    (``segment_sum_sharded``: each rank's rows, then an all-reduce);
    ``local=True`` says the tensors are already this rank's entries,
    whose partial sum the caller merges. ``meta`` tensors (a trace)
    take the path a device takes, with the kernel as its operator, so
    the traced program is the one that runs on a rank's rows."""
    del sorted_ids
    k = int(num_segments)
    impl = impl or FLAGS.segment_impl
    forced = impl == "pallas"
    if impl == "auto":
        impl = "pallas" if _select(vals, k).native else "xla"
    if impl == "pallas":
        if _select(vals, k, force=forced).native:
            group = None if local or vals.device.type == "meta" \
                else mesh_mod.ambient_group()
            if group is not None:
                return ksegment.segment_sum_sharded(vals, ids, k, group)
            return ksegment.segment_sum_block(vals, ids, k)
        impl = "onehot"  # a constraint failed (the selection's reason)
    if impl == "onehot":
        return ksegment.segment_sum_block_plain(vals, ids, k)
    if impl != "xla":
        raise ValueError(f"unknown segment_impl {impl!r}: "
                         "auto|xla|onehot|pallas")
    return _segment_sum_xla(vals, ids, k)


def segment_count(ids: torch.Tensor, num_segments: int,
                  dtype: Any = np.float32, impl: Optional[str] = None
                  ) -> torch.Tensor:
    ones = torch.ones(ids.shape, dtype=dtypes.to_torch(dtype),
                      device=ids.device)
    return segment_sum(ones, ids, num_segments, impl)


class SegmentPlan:
    """Host-built layout of a sorted id stream for the windowed kernel.

    Entries are grouped by aligned ``W``-slot output windows and padded
    to whole ``EB``-entry subblocks: a window's region holds its entries
    sorted by local id (``id - w * W``), then sentinel ids (``W``). The
    layout (``ids2d``, ``wb``, ``perm``, ``padded_size``, ``nsteps``,
    ``rows_pad``, ``outblk``) is the JAX plan's, so plan-ordered streams
    cross between the packages. The port keeps one more array the JAX
    plan computes and drops: ``starts``, the subblock offset of each
    window's region, which the CUDA kernel walks by.

    Built once per static id structure (a sparse matrix's rows); value
    streams must come in plan order (:meth:`reorder` lays host arrays
    out). The tensors live on ``device`` (the default device if None).
    """

    W = 1024          # output window
    EB = 1024         # entries per subblock
    SUB = 8           # subblocks per step of the TPU grid

    def __init__(self, ids: np.ndarray, num_segments: int,
                 device: Optional[DeviceLike] = None):
        ids = np.asarray(ids)
        if ids.ndim != 1:
            raise ValueError("SegmentPlan ids must be 1-D")
        if np.any(np.diff(ids) < 0):
            raise ValueError("SegmentPlan requires sorted ids")
        n = int(num_segments)
        W, EB, SUB = self.W, self.EB, self.SUB
        self.num_segments = n
        self.n_pad = -(-max(n, 1) // W) * W
        n_windows = self.n_pad // W
        # out-of-range ids drop on both ends: sorted, so negatives are a
        # prefix and ids >= n a suffix
        neg = int(np.searchsorted(ids, 0))
        e = int(np.searchsorted(ids, n))
        ids_v = ids[neg:e].astype(np.int64)
        e -= neg
        wb_all = ids_v // W
        counts = np.bincount(wb_all, minlength=n_windows)
        padded = -(-counts // EB) * EB
        total = int(padded.sum())
        rows_out = self.n_pad // 128
        self.outblk = min(1024, rows_out)
        self.rows_pad = -(-rows_out // self.outblk) * self.outblk
        step = SUB * EB
        total_steps = max(-(-total // step), 1)
        grand = total_steps * step
        starts = np.zeros(n_windows + 1, np.int64)
        starts[1:] = np.cumsum(padded)
        src_starts = np.zeros(n_windows, np.int64)
        src_starts[1:] = np.cumsum(counts)[:-1]
        pos = starts[wb_all] + (np.arange(e) - src_starts[wb_all])
        ids_local = np.full(grand, W, np.int32)
        ids_local[pos] = (ids_v - wb_all * W).astype(np.int32)
        self.perm = pos                     # valid entry -> padded slot
        self._lo = neg                      # first valid source index
        self.padded_size = grand
        self.nsteps = total_steps
        wb = np.zeros(grand // EB, np.int32)
        wb[:total // EB] = np.repeat(
            np.arange(n_windows, dtype=np.int32), padded // EB)
        dev = mesh_mod.resolve_device(device)
        self._ids2d = torch.from_numpy(ids_local.reshape(-1, 128)).to(dev)
        self._wb = torch.from_numpy(wb).to(dev)
        self._starts = torch.from_numpy(
            (starts // EB).astype(np.int32)).to(dev)

    def reorder(self, arr: np.ndarray, fill=0) -> np.ndarray:
        """Host-side: lay a per-entry companion array out in plan order."""
        arr = np.asarray(arr)
        out = np.full((self.padded_size,) + arr.shape[1:], fill, arr.dtype)
        out[self.perm] = arr[self._lo:self._lo + self.perm.size]
        return out

    def segment_sum(self, vals: torch.Tensor) -> torch.Tensor:
        """Sum a plan-ordered f32 value stream into segments."""
        out2d = ksegment.windowed_segsum(
            vals, self._ids2d, self._wb, rows_pad=self.rows_pad,
            nsteps=self.nsteps, outblk=self.outblk, sub=self.SUB,
            starts=self._starts)
        return out2d.reshape(-1)[:self.num_segments]
