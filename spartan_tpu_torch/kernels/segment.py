"""Segment sums: the hand-written CUDA kernels and their plain versions
(port of ``spartan_tpu/kernels/segment.py``).

* :func:`segment_sum_block` — ``out[s] = sum of vals[i] with ids[i] ==
  s`` for ``s`` in ``[0, num_segments)``; ids outside that range are
  dropped. The kernel behind ``segment_sum(impl="pallas")``.
* :func:`windowed_segsum` — SegmentPlan's sorted-segment sum over a
  plan-ordered value stream (``ops/segment.py``), the kernel of every
  PageRank iteration.

On CUDA tensors each wrapper launches its kernel in
``spartan_tpu_torch/csrc/segment.cu`` (built with ``nvcc`` for
``sm_90a`` at first use, bound through ``ctypes``); on CPU tensors it
runs the plain version beside it; any other device raises. There is no
fallback: a CUDA tensor the kernel cannot take raises. The block kernel
is the torch custom operator ``spartan_tpu_torch::segment_sum_block``:
on ``meta`` tensors its shape rule answers (a trace records it as one
node), and under ``torch.func.vmap`` its batching rule launches it once
a client.

:func:`segment_sum_sharded` is the JAX package's ``shard_map`` form
(per-shard block sums merged by ``reduce_scatter`` and ``all_gather``
where the shard count divides the segments, else by ``all_reduce``);
``ops/segment.py`` takes it on a group mesh, where each rank runs the
block kernel on the rows it stores. On a logical mesh the block kernel
runs once over all entries.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from ..array import tiling as tiling_mod
from ..parallel import mesh as mesh_mod
from . import build as build_mod

# Kernel launches so far, per kernel: each wrapper adds one where it
# launches its CUDA kernel and nowhere else (plain versions do not count).
LAUNCHES: Dict[str, int] = {"windowed_segsum": 0, "segment_sum_block": 0}

# SegmentPlan's geometry: 1024-slot output windows, 1024-entry subblocks,
# local id 1024 marks a padding entry
_WINDOW = 1024
_SUBBLOCK = 1024
_SENTINEL = 1024

# geometry of the block kernel (csrc/segment.cu)
_MAX_THREADS = 256
# CTAs the block kernel aims for, per SM
_CTAS_PER_SM = 4
# fewest rows a CTA takes
_MIN_CHUNK_ROWS = 256


def cuda_limits(num_segments: int) -> str:
    """Why the block kernel cannot take ``num_segments``, or "" when it
    can: one column of partial sums per segment must fit a block's
    shared memory."""
    need = 4 * int(num_segments)
    if need > build_mod.SMEM_PER_BLOCK:
        return (f"{num_segments} segments need {need}B of partial sums "
                f"per column > {build_mod.SMEM_PER_BLOCK}B of shared "
                "memory per block")
    return ""


# -- the plain versions -------------------------------------------------


def segment_sum_block_plain(vals: torch.Tensor, ids: torch.Tensor,
                            num_segments: int) -> torch.Tensor:
    """The one-hot product ``onehot(ids)^T @ vals`` (the TPU kernel's
    formulation; IEEE f32 — the package turns TF32 off). Ids outside
    ``[0, num_segments)`` match no column and drop out. Also the port's
    ``segment_impl="onehot"`` path."""
    seg = torch.arange(num_segments, device=ids.device)
    onehot = (ids[:, None] == seg[None, :]).to(vals.dtype)
    return onehot.T @ vals


def windowed_segsum_plain(vals: torch.Tensor, ids2d: torch.Tensor,
                          wb: torch.Tensor, rows_pad: int) -> torch.Tensor:
    """Every entry adds into flat slot ``wb[i // 1024] * 1024 + id``;
    sentinel ids (1024) drop. Returns ``(rows_pad, 128)``."""
    ids = ids2d.reshape(-1).to(torch.int64)
    keep = ids < _SENTINEL
    slot = (torch.repeat_interleave(wb.to(torch.int64), _SUBBLOCK) * _WINDOW
            + ids)
    out = torch.zeros(rows_pad * 128, dtype=torch.float32, device=vals.device)
    out.index_add_(0, slot[keep], vals.reshape(-1).to(torch.float32)[keep])
    return out.reshape(rows_pad, 128)


# -- the CUDA kernels ---------------------------------------------------


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spartan_windowed_segsum.argtypes = [vp, vp, vp, vp, i32, i32, vp]
    lib.spartan_windowed_segsum.restype = i32
    lib.spartan_segment_sum_block.argtypes = [
        vp, vp, i32, vp, vp, i64, i32, i32, i32, i32, i32, i64, vp]
    lib.spartan_segment_sum_block.restype = i32


def _load() -> ctypes.CDLL:
    """``csrc/segment.cu``, built with nvcc for sm_90a at first use."""
    return build_mod.load("segment", _bind)


def _block_geometry(e: int, d: int, k: int, sms: int):
    """(d_tile, threads, n_chunks, chunk_rows) of one block-kernel launch:
    the widest column tile (up to 256, a power of two) whose (k, d_tile)
    partial fits shared memory, and row chunks enough for about
    ``_CTAS_PER_SM`` CTAs per SM, each of at least ``_MIN_CHUNK_ROWS``
    rows."""
    d_tile = _MAX_THREADS
    while d_tile > 1 and (d_tile >= 2 * d
                          or 4 * k * d_tile > build_mod.SMEM_PER_BLOCK):
        d_tile //= 2
    threads = -(-d_tile // 32) * 32
    tiles = -(-d // d_tile)
    want = max(1, -(-_CTAS_PER_SM * sms // tiles))
    n_chunks = max(1, min(want, -(-e // _MIN_CHUNK_ROWS)))
    chunk_rows = max(1, -(-e // n_chunks))
    n_chunks = max(1, -(-e // chunk_rows))
    return d_tile, threads, n_chunks, chunk_rows


def _launch_block(vals: torch.Tensor, ids: torch.Tensor,
                  k: int) -> torch.Tensor:
    why = cuda_limits(k)
    if why:
        raise ValueError(f"segment_sum_block kernel cannot take k={k}: {why}")
    e, d = vals.shape
    lib = _load()
    dev = vals.device
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        d_tile, threads, n_chunks, chunk_rows = _block_geometry(e, d, k, sms)
        part = torch.empty((n_chunks, k, d), dtype=torch.float32, device=dev)
        out = torch.empty((k, d), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spartan_segment_sum_block(
            vals.data_ptr(), ids.data_ptr(), ids.element_size(),
            part.data_ptr(), out.data_ptr(), e, d, k, d_tile, threads,
            n_chunks, chunk_rows, stream)
    build_mod.check(err, "segment_sum_block kernel launch")
    build_mod.count_launch(LAUNCHES, "segment_sum_block")
    return out


def _launch_windowed(vals: torch.Tensor, ids: torch.Tensor,
                     starts: torch.Tensor, rows_pad: int) -> torch.Tensor:
    n_out = rows_pad * 128 // _WINDOW
    n_windows = starts.numel() - 1
    if rows_pad * 128 % _WINDOW or not 0 <= n_windows <= n_out:
        raise ValueError(f"windowed_segsum kernel: rows_pad {rows_pad} and "
                         f"{n_windows} windows do not form whole "
                         f"{_WINDOW}-slot output windows")
    if vals.numel() >= 2 ** 31:
        raise ValueError(f"windowed_segsum kernel indexes a window's region "
                         f"with int32; {vals.numel()} entries are too many")
    lib = _load()
    dev = vals.device
    with torch.cuda.device(dev):
        out = torch.empty((rows_pad, 128), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spartan_windowed_segsum(
            vals.data_ptr(), ids.data_ptr(), starts.data_ptr(),
            out.data_ptr(), n_windows, n_out, stream)
    build_mod.check(err, "windowed_segsum kernel launch")
    build_mod.count_launch(LAUNCHES, "windowed_segsum")
    return out


# -- the block kernel as an operator, with its batching rule -------------
#
# The block kernel is a torch custom operator, as the k-means pass is
# (kernels/kmeans.py): ``make_fx`` records it as one node (the row proof
# of expr/partition.py gives it a rule, and its replay calls it on the
# rank's rows), and ``torch.func.vmap`` reaches it through its batching
# rule (``build.per_client``: one launch a client).


@torch.library.custom_op("spartan_tpu_torch::segment_sum_block",
                         mutates_args=())
def _block_op(vals: torch.Tensor, ids: torch.Tensor,
              num_segments: int) -> torch.Tensor:
    """The CUDA kernel on the card, the plain version on the CPU."""
    if not build_mod.on_card(vals, "segment_sum_block"):
        return segment_sum_block_plain(vals, ids, num_segments)
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int64)
    squeeze = vals.ndim == 1
    v2 = vals.reshape(-1, 1) if squeeze else vals
    out = _launch_block(v2.contiguous(), ids.contiguous(), num_segments)
    return out.reshape(num_segments) if squeeze else out


@_block_op.register_fake
def _block_fake(vals, ids, num_segments):
    return vals.new_empty((num_segments,) + tuple(vals.shape[1:]))


_block_op.register_vmap(build_mod.per_client(_block_op))


# -- the wrappers -------------------------------------------------------


def segment_sum_block(vals: torch.Tensor, ids: torch.Tensor,
                      num_segments: int, block_e: int = 512) -> torch.Tensor:
    """Sum the rows of ``vals`` ``(e,)`` or ``(e, d)`` f32 into
    ``num_segments`` buckets by integer ``ids`` ``(e,)``; ids outside
    ``[0, num_segments)`` are dropped. ``block_e`` is the JAX kernel's
    entry block, accepted for its signature: the CUDA kernel sizes its
    own row chunks. On ``meta`` tensors (a trace) the operator's shape
    rule answers."""
    del block_e
    if vals.dtype != torch.float32:
        raise TypeError(f"segment_sum_block takes float32 vals, not "
                        f"{vals.dtype}")
    if vals.ndim not in (1, 2) or ids.shape != vals.shape[:1]:
        raise ValueError(f"vals {tuple(vals.shape)} and ids "
                         f"{tuple(ids.shape)} do not form an entry stream")
    if ids.dtype.is_floating_point or ids.dtype.is_complex \
            or ids.dtype == torch.bool:
        raise TypeError(f"segment ids must be integers, not {ids.dtype}")
    if ids.device != vals.device:
        raise ValueError("vals and ids must be on one device")
    if vals.device.type != "meta":
        build_mod.on_card(vals, "segment_sum_block")  # raises elsewhere
    return _block_op(vals, ids, int(num_segments))


def windowed_segsum(vals: torch.Tensor, ids2d: torch.Tensor,
                    wb: torch.Tensor, *, rows_pad: int, nsteps: int,
                    outblk: int, sub: int,
                    starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SegmentPlan's sorted-segment sum: the plan-ordered f32 stream
    ``vals`` (P,) with local ids ``ids2d`` (P/128, 128) in [0, 1024]
    (1024: padding, dropped) and the window of each 1024-entry subblock
    ``wb`` (P/1024,) → ``(rows_pad, 128)`` f32, flat slot ``wb * 1024 +
    id``. ``nsteps``, ``outblk`` and ``sub`` are the TPU grid's, checked
    against the stream's length. The CUDA kernel walks windows, not
    subblocks: it needs the plan's per-window subblock offsets
    ``starts`` (n_windows + 1,) int32."""
    del outblk
    p = ids2d.numel()
    if vals.numel() != p or p != nsteps * sub * _SUBBLOCK \
            or wb.numel() * _SUBBLOCK != p:
        raise ValueError(f"windowed_segsum: {vals.numel()} values, "
                         f"{ids2d.numel()} ids and {wb.numel()} subblock "
                         f"windows do not form {nsteps} steps of {sub} "
                         f"subblocks")
    if not build_mod.on_card(vals, "windowed_segsum"):
        return windowed_segsum_plain(vals, ids2d, wb, rows_pad)
    if starts is None:
        raise ValueError("the windowed_segsum kernel needs the plan's "
                         "per-window subblock offsets (starts=)")
    for name, t, dt in (("ids2d", ids2d, torch.int32),
                        ("starts", starts, torch.int32)):
        if t.dtype != dt or t.device != vals.device:
            raise ValueError(f"{name} must be {dt} on {vals.device}")
    return _launch_windowed(vals.reshape(-1).to(torch.float32).contiguous(),
                            ids2d.contiguous(), starts.contiguous(),
                            int(rows_pad))


def segment_sum_sharded(vals: torch.Tensor, ids: torch.Tensor,
                        num_segments: int,
                        mesh: Optional[mesh_mod.Mesh] = None,
                        block_e: int = 512) -> torch.Tensor:
    """The partitionable segment sum (the JAX package's
    ``segment_sum_sharded``): the entry stream row-split over the mesh's
    row axis (padded with dropped entries to whole shards),
    :func:`segment_sum_block` per shard, and the partials merged by
    ``reduce_scatter`` then ``all_gather`` when the shard count divides
    ``num_segments``, else by ``all_reduce``. Every position ends with
    the whole (replicated) result. On a group mesh each rank runs on the
    row blocks it stores (local-shard storage): of group mesh
    ``DistArray``s as they are stored, of whole tensors each rank's rows."""
    from ..parallel.shard_map import shard_map, shard_map_local

    if getattr(vals, "mesh", None) is None:  # whole tensors
        mesh = mesh or mesh_mod.get_mesh()
        if mesh.is_group:
            from ..array.distarray import from_tensor

            vals = from_tensor(vals, tiling_mod.row(vals.ndim), mesh)
            ids = from_tensor(ids, tiling_mod.row(1), mesh)
    elif not vals.mesh.is_group:
        vals, ids = vals.local, ids.local  # logical mesh DistArrays
    if getattr(vals, "mesh", None) is not None:
        # group mesh DistArrays: the blocks the ranks store, moved to
        # rows where they lie otherwise
        from ..parallel import redistribute as redist_mod

        mesh = vals.mesh
        k = int(num_segments)
        v = redist_mod.relayout(vals, tiling_mod.row(vals.ndim)).local
        i = redist_mod.relayout(ids, tiling_mod.row(1)).local
        squeeze = v.ndim == 1
        out = shard_map_local(
            _segment_body(k, block_e, mesh), mesh,
            (tiling_mod.row(2), tiling_mod.row(1)),
            tiling_mod.replicated(2))(v[:, None] if squeeze else v, i)
        return out[:, 0] if squeeze else out
    mesh = mesh or mesh_mod.get_mesh()
    p = int(mesh.shape[tiling_mod.AXIS_ROW])
    k = int(num_segments)
    if p <= 1:
        return segment_sum_block(vals, ids, k, block_e)
    squeeze = vals.ndim == 1
    if squeeze:
        vals = vals[:, None]
    e_pad = -vals.shape[0] % p
    if e_pad:
        vals = torch.cat([vals, vals.new_zeros((e_pad, vals.shape[1]))])
        ids = torch.cat([ids, ids.new_full((e_pad,), k)])
    out = shard_map(_segment_body(k, block_e, mesh), mesh,
                    (tiling_mod.row(2), tiling_mod.row(1)),
                    tiling_mod.replicated(2))(vals, ids)
    return out[:, 0] if squeeze else out


def _segment_body(k: int, block_e: int, mesh: mesh_mod.Mesh):
    """One position's part of the sharded segment sum: its block through
    :func:`segment_sum_block`, merged by ``reduce_scatter`` then
    ``all_gather`` when the row axis divides ``k``, else ``all_reduce``
    (every position's (k, d) part has one shape, whatever its block)."""
    from ..parallel import collectives as coll

    axis = tiling_mod.AXIS_ROW
    scatter = k % int(mesh.shape[axis]) == 0

    def body(v, i):
        part = segment_sum_block(v, i, k, block_e)
        if scatter:
            # each position reduces its own k/p rows, then the gather
            # makes the result whole: one all-reduce's bytes
            return coll.all_gather(coll.reduce_scatter(part, axis), axis)
        return coll.all_reduce(part, axis)

    return body
