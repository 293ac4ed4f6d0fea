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

On a group mesh (the port's mesh over the ranks of a process group) the
entries are split as the JAX package splits them (``_entry_tiling``:
blocks of the padded entry stream over the mesh's row axis, copies over
its column axis), and each rank stores only its block
(:attr:`SparseDistArray.block`; ``nse`` stays the whole count, and
``data``/``rows``/``cols`` gather the whole stream, counted at
``sparse_entries``). Every op runs on the blocks:

* ``from_coo``/``from_reference`` upload only the rank's slice of the
  host COO (every rank is given the same host arrays, as a
  multi-process ``device_put`` is);
* ``from_coo_device`` and ``transpose`` sort the entries over the ranks
  of each row-axis line by an int64 key (a sample sort: splitters from
  each rank's samples, then one uneven all-to-all of the runs that
  change owner, packed by the ``partition_pack`` kernel where the
  registry selects it), so every run of one coordinate ends whole on
  one rank; the duplicate sums there are the one-process pairwise
  tree's bits, and the unique entries are rebalanced to even blocks
  with the canonical padding on the last ones;
* ``scale_rows`` is local (``scale`` is whole on every rank), and
  ``rsums`` and every SpMV path are a local segment sum of the rank's
  entries followed by one all-reduce over the row axis (the JAX
  package's ``psum``); the SpMV's operand is whole on every rank, as
  the JAX package replicates it (a split ``DistArray`` operand is
  gathered, counted at ``spmv``);
* ``todense`` sends each entry to the rank whose dense block holds it.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.segment import SegmentPlan, segment_sum
from ..parallel import mesh as mesh_mod
from ..parallel.mesh import DeviceLike, Mesh
from ..utils import dtypes
from . import tiling as tiling_mod
from .distarray import DistArray

_AXIS = tiling_mod.AXIS_ROW
_SAMPLES = 64  # splitter samples a rank (capped at its block)


def _contrib_segsum(data: torch.Tensor, rows: torch.Tensor,
                    cols: torch.Tensor, x: torch.Tensor, n: int,
                    impl: str) -> torch.Tensor:
    """SpMV body over the entries given: gather operand rows, scale by
    entry values, merge into output rows (out-of-range padding rows
    drop)."""
    gathered = torch.index_select(x, 0, cols)
    contrib = data * gathered if gathered.ndim == 1 \
        else data[:, None] * gathered
    return segment_sum(contrib, rows, n, impl=impl, sorted_ids=True,
                       local=True)


def _run_sums(key: torch.Tensor, data: torch.Tensor):
    """(is_new, sums) over a sorted key stream: ``is_new`` marks each
    run's first entry, and a run's first slot of ``sums`` holds the sum
    of its values by a pairwise tree in a fixed order: ceil(log2(longest
    run)) elementwise passes, at pass ``s`` an entry whose offset in its
    run is a multiple of ``2s`` adds the partial sum ``s`` places on,
    when that lies in the same run. No pass scatters, so the sums are
    the same bits on every run and on every device."""
    nse = int(key.shape[0])
    dev = key.device
    is_new = torch.ones(nse, dtype=torch.bool, device=dev)
    is_new[1:] = key[1:] != key[:-1]
    uid = torch.cumsum(is_new.to(torch.int64), 0) - 1
    pos = torch.arange(nse, device=dev)
    starts = pos[is_new]
    ends = torch.cat([starts[1:], starts.new_full((1,), nse)])
    offset = pos - starts[uid]
    left = ends[uid] - pos  # entries from this one to its run's end
    run_max = int((ends - starts).max()) if nse else 0
    dsum = data
    s = 1
    while s < run_max:
        ahead = torch.zeros_like(dsum)
        ahead[:-s] = dsum[s:]
        take = (offset % (2 * s) == 0) & (left > s)
        dsum = torch.where(take, dsum + ahead, dsum)
        s *= 2
    return is_new, dsum


def _pad_entries(j0: int, count: int, n: int, m: int, dev):
    """``count`` canonical padding entries from padding index ``j0`` on:
    the ``j``-th slot past the unique entries holds (``n + j // m``,
    ``j % m``, 0). Returns (rows, cols, data)."""
    j = torch.arange(count, dtype=torch.int64, device=dev) + j0
    mm = max(m, 1)
    return ((n + j // mm).to(torch.int32), (j % mm).to(torch.int32),
            torch.zeros(count, dtype=torch.float32, device=dev))


def _dedup(rows: torch.Tensor, cols: torch.Tensor, data: torch.Tensor,
           n: int, m: int):
    """COO canonicalisation on the tensors' device (the JAX package's
    ``_dedup_kernel``): a lexicographic (row, col) sort by the int64 key
    ``row * m + col``, the values of each run of one coordinate summed by
    :func:`_run_sums`' pairwise tree, and every slot past the unique
    count rewritten to the canonical out-of-range padding. Entries with
    ``row >= n`` sort last and are not counted. Returns
    (rows, cols, data, nnz)."""
    nse = int(data.shape[0])
    dev = data.device
    key = rows.to(torch.int64) * max(m, 1) + cols.to(torch.int64)
    key, order = torch.sort(key, stable=True)
    r2, c2, d2 = rows[order], cols[order], data[order]
    is_new, dsum = _run_sums(key, d2)
    nnz = int((is_new & (r2 < n)).sum())
    pr, pc, pd = _pad_entries(0, nse - nnz, n, m, dev)
    return (torch.cat([r2[is_new][:nnz], pr.to(r2.dtype)]),
            torch.cat([c2[is_new][:nnz], pc.to(c2.dtype)]),
            torch.cat([dsum[is_new][:nnz], pd.to(d2.dtype)]), nnz)


# -- the group mesh: entries sorted and moved over a row-axis line -------


def _line(mesh: Mesh) -> List[int]:
    """The group ranks of this rank's row-axis line, by row coordinate
    (every rank of a line holds another block of the entries; the ranks
    of a column-axis line hold copies of one block)."""
    ny = mesh.shape[tiling_mod.AXIS_COL]
    j = mesh.coords[tiling_mod.AXIS_COL]
    return [mesh.ids[a * ny + j] for a in range(mesh.shape[_AXIS])]


def _swap(parts: Sequence[torch.Tensor], mesh: Mesh,
          recv: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """``parts[a]`` (flat) to the rank at row coordinate ``a`` of this
    rank's line; returns what each rank of the line sent here, by row
    coordinate. The own part stays in place; the rest move in one
    uneven all-to-all over the group (``collectives.exchange_v``; ranks
    of other lines exchange nothing with this one). ``recv`` gives the
    sizes to receive where the caller knows them; otherwise the line's
    sizes are gathered first."""
    from ..parallel import collectives as coll

    me = mesh.coords[_AXIS]
    line = _line(mesh)
    sizes = [int(t.numel()) for t in parts]
    if recv is None:
        allc = coll.stack_over(torch.tensor(sizes, dtype=torch.int64,
                                            device=parts[0].device),
                               _AXIS, mesh).tolist()
        recv = [int(allc[a][me]) for a in range(len(line))]
    world = mesh.shape[_AXIS] * mesh.shape[tiling_mod.AXIS_COL]
    at = {r: a for a, r in enumerate(line)}
    in_splits, out_splits, send = [0] * world, [0] * world, []
    for r in range(world):
        a = at.get(r)
        if a is None or a == me:
            continue
        in_splits[r], out_splits[r] = sizes[a], int(recv[a])
        send.append(parts[a].reshape(-1))
    dtype, dev = parts[0].dtype, parts[0].device
    got = coll.exchange_v(torch.cat(send) if send else
                          torch.empty(0, dtype=dtype, device=dev),
                          in_splits, out_splits, mesh)
    out: List[Optional[torch.Tensor]] = [None] * len(line)
    pos = 0
    for r in range(world):
        a = at.get(r)
        if a is None or a == me:
            continue
        out[a] = got.narrow(0, pos, out_splits[r])
        pos += out_splits[r]
    out[me] = parts[me].reshape(-1)
    return out


def _entry_sort(rows: torch.Tensor, cols: torch.Tensor, data: torch.Tensor,
                width: int, total: int, mesh: Mesh):
    """Sort the entries of this rank's line by the int64 key ``row *
    width + col``, stable in the global entry order: each rank sorts its
    block, ``p - 1`` splitters come from ``_SAMPLES`` evenly spaced keys
    of every rank, and each rank's run for rank ``j`` (contiguous in its
    sorted block) moves there; a run of equal keys has one destination.
    The runs go as one (3, p, m) int32 send buffer of rows, cols and the
    data's bits, packed by the ``partition_pack`` kernel where the
    registry selects it (one launch a rank), and only each destination's
    valid prefix moves. The received runs, in source order, are merged
    by a stable sort. Returns this rank's bucket: (key, rows, cols,
    data), sorted."""
    from ..kernels import exchange as kexchange
    from ..kernels import registry as kernels_mod
    from ..parallel import collectives as coll

    p = mesh.shape[_AXIS]
    me = mesh.coords[_AXIS]
    dev = data.device
    ln = int(data.shape[0])
    key = rows.to(torch.int64) * width + cols.to(torch.int64)
    key, order = torch.sort(key, stable=True)
    words = torch.stack([rows[order].to(torch.int32),
                         cols[order].to(torch.int32),
                         data[order].contiguous().view(torch.int32)])
    del order
    s = min(_SAMPLES, ln)
    samp = (torch.arange(s, device=dev) * ln) // s
    alls = torch.sort(coll.stack_over(key[samp], _AXIS, mesh)
                      .reshape(-1)).values
    splitters = alls[torch.arange(1, p, device=dev) * s]
    dst = torch.searchsorted(splitters, key, right=True)
    counts = torch.bincount(dst, minlength=p)
    starts = torch.cumsum(counts, 0) - counts
    del dst, key
    sel = kernels_mod.select("sort_exchange", (total,), np.int32,
                             tiling_mod.row(1), mesh, p=p, m=ln)
    cnt = counts.tolist()
    if sel.native:
        packed = kexchange.partition_pack(
            words, starts.to(torch.int32)[None].expand(3, p).contiguous(),
            counts.to(torch.int32)[None].expand(3, p).contiguous())
        parts = [packed[:, j, :cnt[j]].contiguous() for j in range(p)]
        del packed
    else:
        st = starts.tolist()
        parts = [words[:, st[j]:st[j] + cnt[j]].contiguous()
                 for j in range(p)]
    del words
    got = _swap(parts, mesh)
    del parts
    merged = torch.cat([g.reshape(3, -1) for g in got], 1)
    r, c = merged[0], merged[1]
    key = r.to(torch.int64) * width + c.to(torch.int64)
    key, order = torch.sort(key, stable=True)
    return (key, r[order], c[order],
            merged[2][order].contiguous().view(torch.float32))


def _rebalance(rows: torch.Tensor, cols: torch.Tensor, data: torch.Tensor,
               total: int, mesh: Mesh):
    """This rank's even block of ``total`` global slots (``row(1)`` over
    the line), filled from the entries every rank of the line holds in
    order (rank 0's first): each rank's entries take the slots after
    the earlier ranks' (the offsets from one gather of the counts), and
    each run moves to the rank whose block holds its slots. Returns
    (rows, cols, data) of the block's filled prefix, its slot offset
    ``lo``, and the number of entries over the line."""
    from ..array import extent as extent_mod
    from ..parallel import collectives as coll

    p = mesh.shape[_AXIS]
    me = mesh.coords[_AXIS]
    u = int(data.shape[0])
    allu = coll.stack_over(torch.tensor([u], dtype=torch.int64,
                                        device=data.device),
                           _AXIS, mesh).reshape(-1).tolist()
    offs = np.cumsum([0] + allu)
    count = int(offs[-1])
    bounds = extent_mod.compute_splits(total, p)
    bounds = list(bounds) + [(total, total)] * (p - len(bounds))
    lo, hi = bounds[me]

    def cut(a: int, lo_b: int, hi_b: int) -> Tuple[int, int]:
        s0, s1 = max(int(offs[a]), lo_b), min(int(offs[a + 1]), hi_b)
        return (s0, max(s0, s1))

    words = torch.stack([rows.to(torch.int32), cols.to(torch.int32),
                         data.contiguous().view(torch.int32)])
    parts = []
    for b, (lo_b, hi_b) in enumerate(bounds):
        s0, s1 = cut(me, lo_b, hi_b)
        a0 = s0 - int(offs[me])
        parts.append(words[:, a0:a0 + s1 - s0].contiguous())
    recv = [3 * (cut(a, lo, hi)[1] - cut(a, lo, hi)[0]) for a in range(p)]
    got = torch.cat([g.reshape(3, -1) for g in _swap(parts, mesh, recv)], 1)
    return (got[0], got[1], got[2].contiguous().view(torch.float32), lo,
            count)


class EntryBlock(NamedTuple):
    """The entries a rank stores: its block of the padded entry stream,
    at global slot ``lo`` (the whole stream, ``lo`` 0, off a group
    mesh)."""

    data: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    lo: int


class SparseDistArray:
    """A (nrows, ncols) sparse matrix as padded, row-sorted COO tensors.
    Immutable; every op returns a new array or a dense result.

    On a group mesh ``data``/``rows``/``cols`` given to the constructor
    are this rank's block of the entries (``row(1)`` over ``nse``
    slots); ``nse`` defaults to the block's length times the row axis's
    size."""

    # the JAX package's plan keeps its output in VMEM, which bounds the
    # windowed path to 2M rows; the port keeps that constraint
    _PLAN_MAX_ROWS = 2 * 1024 * 1024

    def __init__(self, data: torch.Tensor, rows: torch.Tensor,
                 cols: torch.Tensor, shape: Tuple[int, int], nnz: int,
                 mesh: Optional[Mesh] = None, nse: Optional[int] = None):
        self._data = data
        self._rows = rows
        self._cols = cols
        self.shape = tuple(int(s) for s in shape)
        self.nnz = int(nnz)  # true (unpadded) count
        self.mesh = mesh or mesh_mod.get_mesh()
        if nse is None:
            nse = int(data.shape[0]) * (self.mesh.shape[_AXIS]
                                        if self.mesh.is_group else 1)
        self._nse = int(nse)
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
        """Upload host entries: the whole stream, or on a group mesh only
        this rank's block of it."""
        total = int(np.asarray(data).shape[0])
        ext = tiling_mod.row(1).block_extent((total,), mesh) \
            if mesh.is_group else None

        def put(a, dtype):
            a = np.asarray(a)
            if ext is not None:
                a = a[ext.ul[0]:ext.lr[0]]
            # an owned, writable copy: never the caller's (maybe read-only)
            # buffer
            return torch.from_numpy(np.array(a, dtype, order="C")).to(
                mesh.device)

        return SparseDistArray(put(data, np.float32), put(rows, np.int32),
                               put(cols, np.int32), shape, nnz, mesh,
                               nse=total)

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
        the runs, the longest run). The inputs are padded with
        out-of-range rows first, so the entry count divides the mesh, as
        in the JAX package. On a group mesh every rank is given the same
        tensors and keeps its block of the padded stream, and the dedup
        runs over the ranks (:meth:`_from_entry_blocks`)."""
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
        if mesh.is_group:
            total = int(data.shape[0])
            e = tiling_mod.row(1).block_extent((total,), mesh)
            sl = slice(e.ul[0], e.lr[0])
            return SparseDistArray._from_entry_blocks(
                rows[sl], cols[sl], data[sl], total, (n, m), mesh)
        rr, cc, dd, nnz = _dedup(rows, cols, data, n, m)
        return SparseDistArray(dd, rr, cc, (n, m), nnz, mesh)

    @staticmethod
    def _from_entry_blocks(rows: torch.Tensor, cols: torch.Tensor,
                           data: torch.Tensor, total: int,
                           shape: Tuple[int, int], mesh: Mesh
                           ) -> "SparseDistArray":
        """The group dedup: each rank's block (``row(1)`` of a stream of
        ``total`` entries, ``total`` a multiple of the mesh's size) is
        sorted over its row-axis line by ``row * m + col``
        (:func:`_entry_sort`), so each run of one coordinate lies whole
        on one rank in the global entry order; the ranks sum their runs
        (:func:`_run_sums`, the one-process bits), keep the unique
        in-range entries, and rebalance them to even blocks
        (:func:`_rebalance`: ``nnz`` and each rank's offset from one
        gather of the counts); the slots past ``nnz`` get the canonical
        padding."""
        n, m = int(shape[0]), int(shape[1])
        dev = data.device
        if total == 0:
            return SparseDistArray(data, rows, cols, (n, m), 0, mesh, nse=0)
        key, r2, c2, d2 = _entry_sort(rows, cols, data, max(m, 1), total,
                                      mesh)
        is_new, dsum = _run_sums(key, d2)
        del key, d2
        u = int((is_new & (r2 < n)).sum())
        rr, cc, dd, lo, nnz = _rebalance(r2[is_new][:u], c2[is_new][:u],
                                         dsum[is_new][:u], total, mesh)
        del r2, c2, dsum, is_new
        blk = tiling_mod.row(1).block_extent((total,), mesh).shape[0]
        got = int(dd.shape[0])
        pr, pc, pd = _pad_entries(lo + got - nnz, blk - got, n, m, dev)
        return SparseDistArray(torch.cat([dd, pd]), torch.cat([rr, pr]),
                               torch.cat([cc, pc]), (n, m), nnz, mesh,
                               nse=total)

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
    def block(self) -> EntryBlock:
        """The entries this rank stores (the whole stream off a group
        mesh)."""
        lo = tiling_mod.row(1).block_extent((self._nse,), self.mesh).ul[0] \
            if self.mesh.is_group else 0
        return EntryBlock(self._data, self._rows, self._cols, lo)

    def entry_array(self, name: str) -> DistArray:
        """One entry component (``data``, ``rows`` or ``cols``) as a
        ``DistArray`` of ``nse`` under ``row(1)``, from the stored
        blocks (nothing moves)."""
        t = {"data": self._data, "rows": self._rows, "cols": self._cols}[
            name]
        if self.mesh.is_group:
            return DistArray.from_local(t, tiling_mod.row(1), (self._nse,),
                                        self.mesh)
        return DistArray(t, tiling_mod.row(1), self.mesh)

    def whole_entries(self, site: str
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(data, rows, cols) of the whole entry stream on every rank. On
        a group mesh one gather, counted as ``group_materialize_calls``
        at ``site``."""
        if not self.mesh.is_group:
            return self._data, self._rows, self._cols
        words = torch.stack([self._data.contiguous().view(torch.int32),
                             self._rows.to(torch.int32),
                             self._cols.to(torch.int32)], 1)
        whole = DistArray.from_local(words, tiling_mod.row(2),
                                     (self._nse, 3), self.mesh
                                     ).materialize(site)
        return (whole[:, 0].contiguous().view(torch.float32),
                whole[:, 1].contiguous(), whole[:, 2].contiguous())

    @property
    def data(self) -> torch.Tensor:
        """The whole stream's values (gathered on a group mesh, counted
        at ``sparse_entries``; :attr:`block` is the rank's own)."""
        return self.whole_entries("sparse_entries")[0]

    @property
    def rows(self) -> torch.Tensor:
        """The whole stream's row ids (see :attr:`data`)."""
        return self.whole_entries("sparse_entries")[1]

    @property
    def cols(self) -> torch.Tensor:
        """The whole stream's column ids (see :attr:`data`)."""
        return self.whole_entries("sparse_entries")[2]

    @property
    def dtype(self) -> np.dtype:
        return dtypes.to_numpy(self._data.dtype)

    @property
    def nse(self) -> int:
        """Stored (padded) entry count, over every rank."""
        return self._nse

    @property
    def device(self) -> torch.device:
        return self._data.device

    def __repr__(self) -> str:
        return (f"SparseDistArray(shape={self.shape}, nnz={self.nnz}, "
                f"nse={self.nse}, device={self.device})")

    # -- conversions ----------------------------------------------------

    def todense(self) -> DistArray:
        n, m = self.shape
        t = tiling_mod.default_tiling((n, m), self.mesh)
        if self.mesh.is_group:
            return self._todense_group(t)
        # padding rows are >= n, so their flat ids fall out of range and
        # the merge drops them
        flat = self._rows.to(torch.int64) * m + self._cols.to(torch.int64)
        out = segment_sum(self._data, flat, n * m, sorted_ids=True)
        return DistArray(out.reshape(n, m), t, self.mesh)

    def _todense_group(self, t: tiling_mod.Tiling) -> DistArray:
        """Each entry goes to the rank whose block of the dense array
        holds it: a rank sends to the ranks of its row-axis line only
        (the other lines hold copies of its block), so every block
        receives each entry once. The entries are unique, so the block
        is a merge of (flat id, value) pairs with no order to keep."""
        n, m = self.shape
        mesh = self.mesh
        rows = self._rows.to(torch.int64)
        cols = self._cols.to(torch.int64)
        j = mesh.coords[tiling_mod.AXIS_COL]
        ids, vals = [], []
        for a in range(mesh.shape[_AXIS]):
            e = t.block_extent((n, m), mesh, {_AXIS: a,
                                              tiling_mod.AXIS_COL: j})
            (r0, c0), (r1, c1) = e.ul, e.lr
            mine = (rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1)
            ids.append((rows[mine] - r0) * (c1 - c0) + (cols[mine] - c0))
            vals.append(self._data[mine])
        got = _swap(ids, mesh)
        got_ids = torch.cat(got)
        got_vals = torch.cat(_swap(vals, mesh, [g.numel() for g in got]))
        e = t.block_extent((n, m), mesh)
        out = segment_sum(got_vals, got_ids, e.size, sorted_ids=False,
                          local=True)
        return DistArray.from_local(out.reshape(e.shape), t, (n, m), mesh)

    def glom(self) -> np.ndarray:
        return self.todense().glom()

    # -- ops ------------------------------------------------------------

    def merge_partials(self, y: torch.Tensor) -> torch.Tensor:
        """A partial result over this rank's entries merged over the row
        axis (the JAX package's ``psum``); as it is off a group mesh."""
        if not self.mesh.is_group:
            return y
        from ..parallel import collectives as coll

        return coll.reduce_over(y, (_AXIS,), "add", self.mesh)

    def _ensure_plan(self) -> SegmentPlan:
        """Build (once) the windowed path's layout over the stored
        entries: a SegmentPlan over their sorted row ids and the
        plan-ordered data / cols tensors (one copy of the rank's block to
        the host and back, at set-up)."""
        if self._plan is not None:
            return self._plan
        rows = self._rows.cpu().numpy()
        data = self._data.cpu().numpy()
        cols = self._cols.cpu().numpy()
        dev = self.device
        plan = SegmentPlan(rows, self.shape[0], device=dev)
        self._pdata = torch.from_numpy(plan.reorder(data)).to(dev)
        self._pcols = torch.from_numpy(
            plan.reorder(cols, fill=0).astype(np.int32)).to(dev)
        self._plan = plan
        return plan

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
        the fused PageRank loop): the kernel over the stored entries,
        merged over the row axis on a group mesh."""
        plan = self._ensure_plan()
        return self.merge_partials(plan.segment_sum(
            self._pdata * torch.index_select(x, 0, self._pcols)))

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
        'bcoo' | 'xla' | 'onehot' | 'pallas'). Every path runs on the
        stored entries; on a group mesh an all-reduce over the row axis
        merges the ranks' partial outputs."""
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
            keep = self._rows < self.shape[0]
            idx = torch.stack([self._rows[keep], self._cols[keep]]).to(
                torch.int64)
            mat = torch.sparse_coo_tensor(idx, self._data[keep], self.shape,
                                          is_coalesced=True,
                                          check_invariants=False)
            y = torch.mv(mat, x) if x.ndim == 1 else torch.sparse.mm(mat, x)
            return self.merge_partials(y)
        return self.merge_partials(_contrib_segsum(self._data, self._rows,
                                            self._cols, x, self.shape[0],
                                            impl))

    def rsums(self) -> torch.Tensor:
        """Row sums (out-degree weights for PageRank): a segment sum of
        the stored entries, merged over the row axis on a group mesh."""
        return self.merge_partials(segment_sum(self._data, self._rows,
                                        self.shape[0], sorted_ids=True,
                                        local=True))

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
        distinct out-of-range pattern (``m + j // n``, ``j % n``, ``j``
        the entry's slot), whose rows are all >= m, so one int64 key
        ``new_row * n + new_col`` orders them last, as the JAX package's
        leading pad flag does. On a group mesh the sort runs over the
        ranks (:func:`_entry_sort`); the keys are unique, so the result
        is a permutation of the entries and bit-exact."""
        n, m = self.shape
        nn = max(n, 1)
        blk = self.block
        ln = int(self._data.shape[0])
        j = torch.arange(ln, dtype=torch.int64, device=self.device) + blk.lo
        valid = self._rows < n
        new_r = torch.where(valid, self._cols.to(torch.int64), m + j // nn)
        new_c = torch.where(valid, self._rows.to(torch.int64), j % nn)
        if self.mesh.is_group:
            if self._nse == 0:
                return SparseDistArray(self._data, self._cols, self._rows,
                                       (m, n), self.nnz, self.mesh, nse=0)
            _, r2, c2, d2 = _entry_sort(new_r.to(torch.int32),
                                        new_c.to(torch.int32), self._data,
                                        nn, self._nse, self.mesh)
            rr, cc, dd, _, _ = _rebalance(r2, c2, d2, self._nse, self.mesh)
            return SparseDistArray(dd, rr, cc, (m, n), self.nnz, self.mesh,
                                   nse=self._nse)
        order = torch.argsort(new_r * nn + new_c, stable=True)
        return SparseDistArray(
            self._data[order], new_r[order].to(torch.int32),
            new_c[order].to(torch.int32), (m, n), self.nnz, self.mesh)

    @property
    def T(self) -> "SparseDistArray":
        return self.transpose()

    def scale_rows(self, scale: Any) -> "SparseDistArray":
        """Multiply row i's entries by scale[i] (PageRank normalization);
        ``scale`` is whole on every rank, as in the JAX package.

        Padding entries read one zero slot past the last row (the JAX
        package's gather clamps their out-of-range rows to it)."""
        scale = torch.as_tensor(np.asarray(scale)) \
            if not isinstance(scale, torch.Tensor) else scale
        scale = scale.to(device=self.device, dtype=self._data.dtype)
        n = self.shape[0]
        ext = torch.cat([scale, scale.new_zeros(1)])
        data = self._data * ext[self._rows.to(torch.int64).clamp(0, n)]
        return SparseDistArray(data, self._rows, self._cols, self.shape,
                               self.nnz, self.mesh, nse=self._nse)
