"""Sparse arrays: padded, row-sorted COO with a static entry count (port
of ``spartan_tpu/array/sparse.py``).

A ``SparseDistArray`` holds three tensors on the mesh's device — data
(f32), rows and cols (int32) — with entries in lexicographic (row, col)
order, duplicates summed at construction, and padding entries carrying
distinct out-of-range coordinates (``row >= nrows``) so that every merge
drops them. The entry count is padded to the logical mesh's size, as the
JAX package pads it to its device count, so ``nse`` and the padding
pattern equal the JAX package's at the same mesh shape.

SpMV paths (``spmv(x, impl=...)``):

* ``windowed`` — the default for a vector operand: a :class:`SegmentPlan`
  over the row ids, the plan-ordered ``data * x[cols]`` stream, and the
  hand-written windowed kernel (its plain version for CPU tensors);
* ``bcoo`` — ``torch.sparse_coo_tensor(...) @ x``, the library matvec
  (the counterpart of the JAX package's BCOO path), the default for
  matrix operands;
* ``xla`` | ``onehot`` | ``pallas`` — the segment-merge ablations
  through ``ops/segment.segment_sum``.

On a group mesh the windowed path is the JAX package's entry-sharded
SpMV: the entries split over the mesh's row axis (the JAX package's
``_entry_tiling``), each rank lays out a plan over its own entries and
runs the windowed kernel on them (one launch a rank), and an all-reduce
over the row axis merges the partial outputs. The COO tensors
themselves stay whole on every rank: sparse arrays beyond the SpMV have
no local rule yet. ``impl='sharded'`` names that path explicitly.
``from_coo_device`` canonicalises coordinate tensors on their device
(the checkpoint loader's path).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..ops.segment import SegmentPlan, segment_sum
from ..parallel import mesh as mesh_mod
from ..parallel.mesh import DeviceLike, Mesh
from ..utils import dtypes
from . import tiling as tiling_mod
from .distarray import DistArray


def _contrib_segsum(data: torch.Tensor, rows: torch.Tensor,
                    cols: torch.Tensor, x: torch.Tensor, n: int,
                    impl: str) -> torch.Tensor:
    """SpMV body: gather operand rows, scale by entry values, merge into
    output rows (out-of-range padding rows drop)."""
    gathered = torch.index_select(x, 0, cols)
    contrib = data * gathered if gathered.ndim == 1 \
        else data[:, None] * gathered
    return segment_sum(contrib, rows, n, impl=impl, sorted_ids=True)


def _dedup(rows: torch.Tensor, cols: torch.Tensor, data: torch.Tensor,
           n: int, m: int):
    """COO canonicalisation on the tensors' device (the JAX package's
    ``_dedup_kernel``): a lexicographic (row, col) sort by the int64 key
    ``row * m + col``, the values of each run of one coordinate summed by
    a pairwise tree in a fixed order, and every slot past the unique
    count rewritten to the canonical out-of-range padding. Entries with
    ``row >= n`` sort last and are not counted. Returns
    (rows, cols, data, nnz).

    The tree takes ceil(log2(longest run)) elementwise passes over the
    entries: at pass ``s`` an entry whose offset in its run is a multiple
    of ``2s`` adds the partial sum ``s`` places on, when that lies in the
    same run. No pass scatters, so the sums are the same bits on every
    run and on every device."""
    nse = int(data.shape[0])
    dev = data.device
    key = rows.to(torch.int64) * max(m, 1) + cols.to(torch.int64)
    key, order = torch.sort(key, stable=True)
    r2, c2, d2 = rows[order], cols[order], data[order]
    is_new = torch.ones(nse, dtype=torch.bool, device=dev)
    is_new[1:] = key[1:] != key[:-1]
    uid = torch.cumsum(is_new.to(torch.int64), 0) - 1
    pos = torch.arange(nse, device=dev)
    starts = pos[is_new]
    ends = torch.cat([starts[1:], starts.new_full((1,), nse)])
    offset = pos - starts[uid]
    left = ends[uid] - pos  # entries from this one to its run's end
    run_max = int((ends - starts).max()) if nse else 0
    dsum = d2
    s = 1
    while s < run_max:
        ahead = torch.zeros_like(dsum)
        ahead[:-s] = dsum[s:]
        take = (offset % (2 * s) == 0) & (left > s)
        dsum = torch.where(take, dsum + ahead, dsum)
        s *= 2
    rr = torch.zeros(nse, dtype=r2.dtype, device=dev)
    cc = torch.zeros(nse, dtype=c2.dtype, device=dev)
    dd = torch.zeros(nse, dtype=d2.dtype, device=dev)
    nruns = int(starts.shape[0])
    rr[:nruns] = r2[is_new]
    cc[:nruns] = c2[is_new]
    dd[:nruns] = dsum[is_new]
    nnz = int((is_new & (r2 < n)).sum())
    j = pos - nnz
    valid = pos < nnz
    rr = torch.where(valid, rr, (n + j // max(m, 1)).to(r2.dtype))
    cc = torch.where(valid, cc, (j % max(m, 1)).to(c2.dtype))
    dd = torch.where(valid, dd, torch.zeros((), dtype=d2.dtype,
                                             device=dev))
    return rr, cc, dd, nnz


class SparseDistArray:
    """A (nrows, ncols) sparse matrix as padded, row-sorted COO tensors.
    Immutable; every op returns a new array or a dense result."""

    # the JAX package's plan keeps its output in VMEM, which bounds the
    # windowed path to 2M rows; the port keeps that constraint
    _PLAN_MAX_ROWS = 2 * 1024 * 1024

    def __init__(self, data: torch.Tensor, rows: torch.Tensor,
                 cols: torch.Tensor, shape: Tuple[int, int], nnz: int,
                 mesh: Optional[Mesh] = None):
        self.data = data
        self.rows = rows
        self.cols = cols
        self.shape = tuple(int(s) for s in shape)
        self.nnz = int(nnz)  # true (unpadded) count
        self.mesh = mesh or mesh_mod.get_mesh()
        # the windowed path's layout, built on first use: the plan and
        # the plan-ordered data / cols tensors
        self._plan: Optional[SegmentPlan] = None
        self._pdata: Optional[torch.Tensor] = None
        self._pcols: Optional[torch.Tensor] = None
        # cached column-stochastic transition (see transition())
        self._transition: Optional["SparseDistArray"] = None

    # -- construction ---------------------------------------------------

    @staticmethod
    def _place(data: np.ndarray, rows: np.ndarray, cols: np.ndarray,
               shape, nnz: int, mesh: Mesh) -> "SparseDistArray":
        def put(a, dtype):
            # an owned, writable copy: never the caller's (maybe read-only)
            # buffer
            return torch.from_numpy(np.array(a, dtype, order="C")).to(
                mesh.device)

        return SparseDistArray(put(data, np.float32), put(rows, np.int32),
                               put(cols, np.int32), shape, nnz, mesh)

    @staticmethod
    def from_coo(rows: Any, cols: Any, data: Any, shape: Tuple[int, int],
                 pad_to: Optional[int] = None, mesh: Optional[Mesh] = None,
                 device: Optional[DeviceLike] = None) -> "SparseDistArray":
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        data = np.asarray(data, np.float32)
        m = int(shape[1])
        # lexicographic (row, col) sort and duplicate summation (COO
        # semantics, like scipy), as in the JAX package
        flat = rows * m + cols
        uniq, inv = np.unique(flat, return_inverse=True)
        data = np.bincount(inv.reshape(-1), weights=data.astype(np.float64),
                           minlength=uniq.size).astype(np.float32)
        rows = (uniq // m).astype(np.int32)
        cols = (uniq % m).astype(np.int32)
        nnz = data.size
        mesh = mesh or mesh_mod.mesh_on(device)
        nx, ny = mesh_mod.mesh_axis_sizes(mesh)
        total = max(pad_to or nnz, nnz)
        total += -total % (nx * ny)
        pad = total - nnz
        if pad:
            # distinct out-of-range (row >= nrows) coordinates per padding
            # entry, still sorted: every merge drops them
            j = np.arange(pad, dtype=np.int64)
            rows = np.concatenate(
                [rows, (shape[0] + j // max(m, 1)).astype(np.int32)])
            cols = np.concatenate([cols, (j % max(m, 1)).astype(np.int32)])
            data = np.pad(data, (0, pad))
        return SparseDistArray._place(data, rows, cols, shape, nnz, mesh)

    @staticmethod
    def from_coo_device(rows: Any, cols: Any, data: Any,
                        shape: Tuple[int, int], mesh: Optional[Mesh] = None,
                        device: Optional[DeviceLike] = None
                        ) -> "SparseDistArray":
        """Construct from coordinate tensors without a host round trip
        (the device twin of :meth:`from_coo`): the sort, the duplicate
        sums and the canonical padding run on the mesh's device
        (:func:`_dedup`); only counts come to the host (the entries,
        the runs, the longest run). The inputs are padded with out-of-range rows first, so the entry
        count divides the mesh, as in the JAX package."""
        mesh = mesh or mesh_mod.mesh_on(device)
        n, m = int(shape[0]), int(shape[1])

        def put(a, dtype):
            if not isinstance(a, torch.Tensor):
                a = torch.from_numpy(np.array(a, order="C"))
            return a.to(device=mesh.device, dtype=dtype)

        rows = put(rows, torch.int32)
        cols = put(cols, torch.int32)
        data = put(data, torch.float32)
        nx, ny = mesh_mod.mesh_axis_sizes(mesh)
        pad = -int(data.shape[0]) % (nx * ny)
        if pad:
            j = torch.arange(pad, dtype=torch.int32, device=mesh.device)
            rows = torch.cat([rows, n + j // max(m, 1)])
            cols = torch.cat([cols, j % max(m, 1)])
            data = torch.cat([data, data.new_zeros((pad,))])
        rr, cc, dd, nnz = _dedup(rows, cols, data, n, m)
        return SparseDistArray(dd, rr, cc, (n, m), nnz, mesh)

    @staticmethod
    def from_reference(data: Any, rows: Any, cols: Any,
                       shape: Tuple[int, int], nnz: int,
                       mesh: Optional[Mesh] = None,
                       device: Optional[DeviceLike] = None
                       ) -> "SparseDistArray":
        """Carry a JAX-package sparse array's state across: its glommed
        ``data``/``rows``/``cols`` as numpy, padding included, its shape
        and its true entry count."""
        mesh = mesh or mesh_mod.mesh_on(device)
        data, rows, cols = (np.asarray(a) for a in (data, rows, cols))
        if not data.shape == rows.shape == cols.shape or data.ndim != 1:
            raise ValueError(f"data {data.shape}, rows {rows.shape} and "
                             f"cols {cols.shape} must be one 1-D length")
        return SparseDistArray._place(data, rows, cols, shape, nnz, mesh)

    @staticmethod
    def from_scipy(mat, mesh: Optional[Mesh] = None,
                   device: Optional[DeviceLike] = None) -> "SparseDistArray":
        coo = mat.tocoo()
        return SparseDistArray.from_coo(coo.row, coo.col, coo.data,
                                        coo.shape, mesh=mesh, device=device)

    @staticmethod
    def from_dense(arr: Any, mesh: Optional[Mesh] = None,
                   device: Optional[DeviceLike] = None) -> "SparseDistArray":
        arr = np.asarray(arr)
        rows, cols = np.nonzero(arr)
        return SparseDistArray.from_coo(rows, cols, arr[rows, cols],
                                        arr.shape, mesh=mesh, device=device)

    # -- properties -----------------------------------------------------

    @property
    def dtype(self) -> np.dtype:
        return dtypes.to_numpy(self.data.dtype)

    @property
    def nse(self) -> int:
        """Stored (padded) entry count."""
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def __repr__(self) -> str:
        return (f"SparseDistArray(shape={self.shape}, nnz={self.nnz}, "
                f"nse={self.nse}, device={self.device})")

    # -- conversions ----------------------------------------------------

    def todense(self) -> DistArray:
        n, m = self.shape
        # padding rows are >= n, so their flat ids fall out of range and
        # the merge drops them
        flat = self.rows.to(torch.int64) * m + self.cols.to(torch.int64)
        out = segment_sum(self.data, flat, n * m, sorted_ids=True)
        return DistArray(out.reshape(n, m),
                         tiling_mod.default_tiling((n, m), self.mesh),
                         self.mesh)

    def glom(self) -> np.ndarray:
        return self.todense().glom()

    # -- ops ------------------------------------------------------------

    def _ensure_plan(self) -> SegmentPlan:
        """Build (once) the windowed path's layout: a SegmentPlan over
        the sorted row ids and the plan-ordered data / cols tensors (one
        copy to the host and back, at set-up)."""
        if self._plan is not None:
            return self._plan
        lo, hi = self._entry_range()
        rows = self.rows[lo:hi].cpu().numpy()
        data = self.data[lo:hi].cpu().numpy()
        cols = self.cols[lo:hi].cpu().numpy()
        dev = self.device
        plan = SegmentPlan(rows, self.shape[0], device=dev)
        self._pdata = torch.from_numpy(plan.reorder(data)).to(dev)
        self._pcols = torch.from_numpy(
            plan.reorder(cols, fill=0).astype(np.int32)).to(dev)
        self._plan = plan
        return plan

    def _entry_range(self) -> Tuple[int, int]:
        """The entries this rank's windowed plan covers: its block of the
        entries split over the row axis on a group mesh, else all."""
        if not self.mesh.is_group:
            return 0, self.nse
        ext = tiling_mod.row(1).block_extent((self.nse,), self.mesh)
        return ext.ul[0], ext.lr[0]

    def _can_window(self) -> bool:
        """The windowed path runs on the one device the port uses, up to
        the JAX plan's row bound."""
        return self.shape[0] <= self._PLAN_MAX_ROWS

    def _default_windowed(self) -> bool:
        return self._can_window()

    def default_impl(self, x_ndim: int = 1) -> str:
        """The spmv path the default dispatch takes for an operand of
        rank ``x_ndim``."""
        if x_ndim == 1 and self._default_windowed():
            return "windowed"
        return "bcoo"

    def spmv_traced(self, x: torch.Tensor) -> torch.Tensor:
        """Windowed matvec on a vector already on the device (the body of
        the fused PageRank loop)."""
        plan = self._ensure_plan()
        y = plan.segment_sum(self._pdata
                             * torch.index_select(x, 0, self._pcols))
        if self.mesh.is_group:
            from ..parallel import collectives as coll

            y = coll.reduce_over(y, (tiling_mod.AXIS_ROW,), "add",
                                 self.mesh)
        return y

    def _operand(self, x: Any) -> torch.Tensor:
        if isinstance(x, DistArray):
            x = x.materialize("spmv")
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        return x.to(self.device)

    def spmv(self, x: Any, impl: Optional[str] = None) -> torch.Tensor:
        """y = A @ x for dense x (ncols,) or (ncols, d).

        Default: the windowed path for a vector, the library matvec
        (``bcoo``) for a matrix. ``impl`` forces a path ('windowed' |
        'bcoo' | 'xla' | 'onehot' | 'pallas')."""
        x = self._operand(x)
        if impl is None:
            impl = self.default_impl(x.ndim)
        if impl == "sharded":
            if not self.mesh.is_group:
                raise ValueError("impl='sharded' (entry shards merged by "
                                 "an all-reduce) runs on a multi-GPU group "
                                 "mesh; use impl='windowed' or 'bcoo'")
            impl = "windowed"
        if impl == "windowed":
            if x.ndim != 1:
                raise ValueError(
                    "impl='windowed' supports vector x only; use the "
                    "'bcoo' or 'xla' path for (n, d) operands")
            if not self._can_window():
                raise ValueError(
                    "impl='windowed' requested but the windowed kernel "
                    f"takes at most {self._PLAN_MAX_ROWS} rows; use "
                    "impl='bcoo' or leave impl=None")
            return self.spmv_traced(x)
        if impl == "bcoo":
            keep = self.rows < self.shape[0]
            idx = torch.stack([self.rows[keep], self.cols[keep]]).to(
                torch.int64)
            mat = torch.sparse_coo_tensor(idx, self.data[keep], self.shape,
                                          is_coalesced=True,
                                          check_invariants=False)
            if x.ndim == 1:
                return torch.mv(mat, x)
            return torch.sparse.mm(mat, x)
        return _contrib_segsum(self.data, self.rows, self.cols, x,
                               self.shape[0], impl)

    def rsums(self) -> torch.Tensor:
        """Row sums (out-degree weights for PageRank)."""
        return segment_sum(self.data, self.rows, self.shape[0],
                           sorted_ids=True)

    def transition(self) -> "SparseDistArray":
        """Column-stochastic transition matrix ``T = (A / outdegree)^T``
        (the PageRank operator), built once and cached on this array;
        :meth:`clear_cache` releases it."""
        if self._transition is None:
            out_deg = self.rsums().cpu().numpy()
            inv = np.where(out_deg > 0,
                           1.0 / np.maximum(out_deg, 1e-30), 0.0)
            self._transition = self.scale_rows(
                inv.astype(np.float32)).transpose()
        return self._transition

    def clear_cache(self) -> None:
        """Drop cached derived state: the transition matrix and the
        windowed layout."""
        self._transition = None
        self._plan = None
        self._pdata = None
        self._pcols = None

    def transpose(self) -> "SparseDistArray":
        """Transposed copy, on the device. Entries re-sort by (new row,
        new col) = (col, row); padding entries get the transposed shape's
        distinct out-of-range pattern (``m + j // n``, ``j % n``), whose
        rows are all >= m, so one int64 key ``new_row * n + new_col``
        orders them last, as the JAX package's leading pad flag does."""
        n, m = self.shape
        nn = max(n, 1)
        j = torch.arange(self.nse, dtype=torch.int64, device=self.device)
        valid = self.rows < n
        new_r = torch.where(valid, self.cols.to(torch.int64), m + j // nn)
        new_c = torch.where(valid, self.rows.to(torch.int64), j % nn)
        order = torch.argsort(new_r * nn + new_c, stable=True)
        return SparseDistArray(
            self.data[order], new_r[order].to(torch.int32),
            new_c[order].to(torch.int32), (m, n), self.nnz, self.mesh)

    @property
    def T(self) -> "SparseDistArray":
        return self.transpose()

    def scale_rows(self, scale: Any) -> "SparseDistArray":
        """Multiply row i's entries by scale[i] (PageRank normalization).

        Padding entries read one zero slot past the last row (the JAX
        package's gather clamps their out-of-range rows to it)."""
        scale = torch.as_tensor(np.asarray(scale)) \
            if not isinstance(scale, torch.Tensor) else scale
        scale = scale.to(device=self.device, dtype=self.data.dtype)
        n = self.shape[0]
        ext = torch.cat([scale, scale.new_zeros(1)])
        data = self.data * ext[self.rows.to(torch.int64).clamp(0, n)]
        return SparseDistArray(data, self.rows, self.cols, self.shape,
                               self.nnz, self.mesh)
