"""Histogram / bincount: the hand-written CUDA kernel and its plain
version (port of ``spartan_tpu/kernels/histogram.py``).

:func:`bincount_block` counts integer ids into ``length`` buckets with
``jnp.bincount``'s rule: negative ids count in bucket 0, ids >= length
are dropped. :func:`bincount_sharded` is the BincountExpr path over the
logical mesh: the id stream padded to whole row shards (padding ids are
``length``, dropped), each shard counted, the shards' counts summed.

On CUDA tensors the wrappers launch ``spartan_tpu_torch/csrc/
histogram.cu`` (built with ``nvcc`` for ``sm_90a`` at first use, bound
through ``ctypes``), which counts all shards' ids in one launch into
int32 sub-histograms in shared memory. :func:`_plan` decides each
launch: the sub-histograms a CTA, the split of the ids into a scalar
head, 16-byte vectors and a scalar tail, and the grid. On
CPU tensors they run :func:`bincount_block_plain`, the TPU
kernel's formulation (a f32 one-hot per 512-id block, reduced over the
block); any other device raises. Counting in int32 instead of the TPU's
f32 gives the same result wherever the TPU's count is exact: below 2**24
per bucket per shard. Both wrappers return int32, as ``bincount_sharded``
does in the JAX package.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..array import tiling as tiling_mod
from ..parallel import mesh as mesh_mod
from . import build as build_mod

# Kernel launches so far: the wrappers add one where they launch the
# CUDA kernel and nowhere else (the plain version does not count).
LAUNCHES: Dict[str, int] = {"bincount_block": 0}

_BLOCK_E = 512
# one-hot elements the plain version materialises per step
_ONEHOT_BUDGET = 1 << 24

# geometry of the CUDA kernel (csrc/histogram.cu): threads a CTA, 16-byte
# vectors a thread loads per chunk, warps a CTA
_THREADS = 256
_VECS = 8
_WARPS = _THREADS // 32
# a CTA's sub-histograms stay within this many bytes (one copy when a
# single row is larger)
_SHARED_BUDGET = 16 * 1024


class Plan(NamedTuple):
    """One launch of ``csrc/histogram.cu``: its int32 sub-histograms a
    CTA, the split of the ids into a scalar head, a body of 16-byte
    vectors and a scalar tail, and the grid."""
    copies: int
    head: int
    nvec: int
    tail: int
    ctas: int


def _copies(length: int) -> int:
    """Sub-histograms a CTA: one per warp where ``length`` int32 rows of
    them fit ``_SHARED_BUDGET``, halved until they do, at least one."""
    copies = _WARPS
    while copies > 1 and 4 * length * copies > _SHARED_BUDGET:
        copies //= 2
    return copies


def _plan(length: int, e: int, misalign: int, slots: int) -> Plan:
    """The launch for ``e`` ids whose first lies ``misalign`` 4-byte words
    past a 16-byte boundary, on a card that holds ``slots`` CTAs of this
    length at once: one CTA per chunk of ``_THREADS * _VECS`` vectors, at
    most ``slots`` (CTAs then walk the chunks grid-stride), at least
    one."""
    head = min(e, -misalign % 4)
    nvec = (e - head) // 4
    chunks = -(-nvec // (_THREADS * _VECS))
    return Plan(_copies(length), head, nvec, e - head - 4 * nvec,
                max(1, min(slots, chunks)))


def cuda_limits(length: int, e: int) -> str:
    """Why the kernel cannot count ``e`` ids into ``length`` buckets, or
    "" when it can: one int32 histogram per CTA must fit a block's
    shared memory, and int32 counts must not overflow."""
    if 4 * int(length) > build_mod.SMEM_PER_BLOCK:
        return (f"{length} buckets need {4 * int(length)}B of shared "
                f"memory > {build_mod.SMEM_PER_BLOCK}B per block")
    if e >= 2 ** 31:
        return f"{e} ids could overflow int32 counts"
    return ""


def bincount_block_plain(ids: torch.Tensor, length: int,
                         block_e: int = _BLOCK_E) -> torch.Tensor:
    """The TPU kernel's formulation: ids padded to whole ``block_e``
    blocks with ``length`` (dropped), clipped at 0, each block's
    ``(block_e, k_total)`` one-hot summed into a f32 counts row. Returns
    int32 ``(length,)``."""
    dev = ids.device
    ids = ids.reshape(-1).to(torch.int32)
    e_pad = -ids.numel() % block_e
    if e_pad:
        ids = torch.cat([ids, torch.full((e_pad,), length, dtype=torch.int32,
                                         device=dev)])
    ids = ids.clamp_min(0).reshape(-1, block_e)
    k_total = -(-length // 128) * 128
    seg = torch.arange(k_total, dtype=torch.int32, device=dev)
    counts = torch.zeros((k_total,), dtype=torch.float32, device=dev)
    step = max(1, _ONEHOT_BUDGET // (block_e * k_total))
    for lo in range(0, ids.shape[0], step):
        onehot = (ids[lo:lo + step, :, None] == seg).to(torch.float32)
        counts += onehot.sum(dim=(0, 1))
    return counts[:length].to(torch.int32)


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spartan_bincount_ctas_per_sm.argtypes = [i32, i32,
                                                 ctypes.POINTER(i32)]
    lib.spartan_bincount_ctas_per_sm.restype = i32
    lib.spartan_bincount.argtypes = [vp, i32, i64, i32, i32, vp, i32, i32,
                                     vp]
    lib.spartan_bincount.restype = i32


def _load() -> ctypes.CDLL:
    """``csrc/histogram.cu``, built with nvcc for sm_90a at first use."""
    return build_mod.load("histogram", _bind)


_slots: Dict[Tuple[int, int], int] = {}


def _card_slots(lib: ctypes.CDLL, dev: torch.device, length: int) -> int:
    """CTAs of ``length``'s sub-histograms that the card holds at once
    (the occupancy query times the SMs), cached per device and length."""
    key = (dev.index or 0, length)
    slots = _slots.get(key)
    if slots is None:
        per_sm = ctypes.c_int(0)
        build_mod.check(lib.spartan_bincount_ctas_per_sm(
            length, _copies(length), ctypes.byref(per_sm)),
            "bincount_block occupancy query")
        if per_sm.value < 1:
            raise RuntimeError(f"bincount_block kernel cannot hold one CTA "
                               f"of {length} buckets on an SM")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        slots = _slots[key] = per_sm.value * sms
    return slots


def _launch(ids: torch.Tensor, length: int) -> torch.Tensor:
    why = cuda_limits(length, ids.numel())
    if why:
        raise ValueError(f"bincount_block kernel cannot take this input: "
                         f"{why}")
    lib = _load()
    dev = ids.device
    with torch.cuda.device(dev):
        plan = _plan(length, ids.numel(), (ids.data_ptr() // 4) % 4,
                     _card_slots(lib, dev, length))
        out = torch.zeros((length,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spartan_bincount(
            ids.data_ptr(), plan.head, plan.nvec, plan.tail, length,
            out.data_ptr(), plan.copies, plan.ctas, stream)
    build_mod.check(err, "bincount_block kernel launch")
    build_mod.count_launch(LAUNCHES, "bincount_block")
    return out


def _checked(ids: torch.Tensor, length: int) -> int:
    if ids.dtype.is_floating_point or ids.dtype.is_complex \
            or ids.dtype == torch.bool:
        raise TypeError(f"bincount ids must be integers, not {ids.dtype}")
    length = int(length)
    if length < 1:
        raise ValueError(f"bincount needs length >= 1, got {length}")
    return length


def bincount_block(ids: torch.Tensor, length: int,
                   block_e: int = _BLOCK_E) -> torch.Tensor:
    """One shard's int32 counts of ``ids`` in [0, length). ``block_e`` is
    the TPU kernel's id block, kept for the plain version."""
    length = _checked(ids, length)
    if not build_mod.on_card(ids, "bincount_block"):
        return bincount_block_plain(ids, length, block_e)
    # jnp parity: ids are counted as int32 (wider ids wrap, as astype)
    return _launch(ids.reshape(-1).to(torch.int32).contiguous(), length)


def _padded(ids: torch.Tensor, length: int, p: int) -> torch.Tensor:
    """The id stream padded with ``length`` (dropped) to ``p`` whole
    shards, as int32."""
    e_pad = -ids.numel() % p
    ids = ids.to(torch.int32)
    if e_pad:
        ids = torch.cat([ids, torch.full((e_pad,), length, dtype=torch.int32,
                                         device=ids.device)])
    return ids


def bincount_group(ids: torch.Tensor, length: int,
                   mesh: Optional[mesh_mod.Mesh] = None) -> torch.Tensor:
    """The JAX package's ``shard_map`` form of ``bincount_sharded``: the
    padded id stream row-split over the mesh's row axis,
    :func:`bincount_block` per position, the count rows summed as f32
    by an ``all_reduce``, then int32 (exact below 2**24 a bucket). On a
    group mesh each rank keeps only its row block of the stream and
    counts it (:func:`bincount_local`)."""
    from ..parallel import collectives as coll
    from ..parallel.shard_map import shard_map

    length = _checked(ids, length)
    mesh = mesh or mesh_mod.get_mesh()
    if mesh.is_group:
        from ..array.distarray import from_tensor

        # each rank keeps its row block of the whole stream
        return bincount_local(from_tensor(ids.reshape(-1),
                                          tiling_mod.row(1), mesh), length)
    axis = tiling_mod.AXIS_ROW
    p = max(int(mesh.shape[axis]), 1)
    ids = _padded(ids.reshape(-1), length, p)

    def body(i):
        part = bincount_block(i, length).to(torch.float32)
        return coll.all_reduce(part, axis)

    out = shard_map(body, mesh, (tiling_mod.row(1),),
                    tiling_mod.replicated(1))(ids)
    return out.to(torch.int32)


def bincount_local(ids, length: int) -> torch.Tensor:
    """Per-rank bincount of a 1-D group mesh ``DistArray`` of ids as the
    ranks store them (moved to rows first): :func:`bincount_block` a
    rank on its block, the count rows summed as f32 by an all-reduce
    over the row axis, then int32. Returns the whole (length,) counts
    on every rank."""
    from ..parallel import collectives as coll
    from ..parallel import redistribute as redist_mod

    ids = redist_mod.relayout(ids, tiling_mod.row(1))
    length = _checked(ids.local, length)
    part = bincount_block(ids.local.to(torch.int32), length).to(
        torch.float32)
    return coll.reduce_over(part, (tiling_mod.AXIS_ROW,), "add",
                            ids.mesh).to(torch.int32)


def bincount_sharded(ids: torch.Tensor, length: int,
                     mesh: Optional[mesh_mod.Mesh] = None) -> torch.Tensor:
    """Distributed bincount over the mesh row axis: the 1-D id stream
    padded to p whole shards with ``length``, counted per shard, the
    shards' counts summed. Returns int32 ``(length,)``. On a logical
    mesh on the card all shards are counted in one launch; on a group
    mesh each rank counts the block it stores (:func:`bincount_local`;
    of a whole tensor, its row block)."""
    if getattr(ids, "mesh", None) is not None:  # a DistArray
        if ids.mesh.is_group:
            return bincount_local(ids, length)
        ids = ids.local
    length = _checked(ids, length)
    mesh = mesh or mesh_mod.get_mesh()
    if mesh.is_group:
        return bincount_group(ids, length, mesh)
    p = max(int(mesh.shape.get(tiling_mod.AXIS_ROW, 1)), 1)
    ids = ids.reshape(-1)
    if build_mod.on_card(ids, "bincount_block"):
        return _launch(ids.to(torch.int32).contiguous(), length)
    shards = _padded(ids, length, p).reshape(p, -1)
    # the shards' rows merge as the psum does: f32 rows added, then int32
    total = torch.zeros((length,), dtype=torch.float32, device=ids.device)
    for i in range(p):
        total += bincount_block_plain(shards[i], length).to(torch.float32)
    return total.to(torch.int32)
