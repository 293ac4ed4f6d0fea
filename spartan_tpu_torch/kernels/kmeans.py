"""Fused k-means pass: the hand-written CUDA kernel and its plain
version (port of ``spartan_tpu/kernels/kmeans.py``).

``assign_accumulate(points, centers, k, valid_rows)`` returns the
``(k, d)`` f32 sums and ``(k,)`` f32 counts of one pass: each row below
``valid_rows`` goes to the center with the least ``|c|^2 - 2 p.c``
(first index on ties). On CUDA tensors it launches the kernel in
``spartan_tpu_torch/csrc/kmeans.cu`` (built with ``nvcc`` for
``sm_90a`` at first use, bound through ``ctypes``); on CPU tensors it
runs :func:`assign_accumulate_plain`. There is no fallback: a CUDA
tensor the kernel cannot take raises.

The JAX package runs one kernel per row shard and merges with a
``psum``. On a logical mesh the port runs one pass over all rows with
the ``valid_rows`` mask, which gives the same sums up to summation
order. :func:`assign_accumulate_sharded` is the JAX package's
``shard_map`` form: each position runs the pass on its row block, with
its share of the ``valid_rows`` limit, and an ``all_reduce`` merges the
sums and counts. On a group mesh (``parallel/mesh.py``) :func:`step`
takes it, and each rank runs the pass on the row block it stores
(local-shard storage, ``array/distarray.py``): a ``DistArray``'s with
no whole tensor and no slicing, a whole tensor's cut to the rank's rows
(:func:`assign_accumulate_local`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..parallel import mesh as mesh_mod
from . import build as build_mod
from . import registry

_BLOCK = 1024

# geometry of the CUDA kernel (csrc/kmeans.cu): rows per tile, centers
# per block of the register tile
_TILE = 128
_CBLOCK = 64
_MAX_D = 1024
_SMEM_LIMIT = build_mod.SMEM_PER_BLOCK

# Kernel launches so far: the wrapper adds one per launch of the CUDA
# kernel and nowhere else (the plain version does not count), under
# build.COUNT_LOCK, so concurrent serve workers lose no increment.
LAUNCHES = 0

_occupancy: Dict[Tuple[int, int, int], int] = {}


def _rule_bytes(d: int, k: int) -> int:
    """The shared memory the selection rule allows for (d, k): centers,
    partial sums, norms, counts and a 256-row assignment, the first
    kernel's footprint. The rule keeps it so that its answers stay the
    same; the kernel's own footprint without staging is never larger."""
    return 4 * (2 * k * d + 2 * k + 256)


def _smem_bytes(d: int, k: int) -> int:
    """The kernel's shared memory where it reads the points from global
    memory: centers and partial sums (k, d), norms padded to the center
    block, counts and one assignment per tile row. (The kernel stages
    point tiles on top of this only where they fit.)"""
    kp = -(-k // _CBLOCK) * _CBLOCK
    return 4 * (2 * k * d + kp + k + _TILE)


def cuda_limits(d: int, k: int) -> str:
    """Why the CUDA kernel cannot take (d, k), or "" when it can."""
    if d > _MAX_D:
        return f"d {d} > {_MAX_D}"
    need = _rule_bytes(d, k)
    if need > _SMEM_LIMIT:
        return (f"centers + partial sums {need}B > {_SMEM_LIMIT}B of "
                "shared memory per block")
    return ""


def supports(n: int, d: int, k: int, mesh=None) -> bool:
    """Can the fused kernel module take this problem here?"""
    sel = registry.select("kmeans", (n, d), np.float32,
                          tiling_mod.row(2), mesh, k=k, block=_BLOCK)
    return sel.native


# -- the plain version -------------------------------------------------


def assign_accumulate_plain(points: torch.Tensor, centers: torch.Tensor,
                            k: int, valid_rows: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain torch: what the CPU tests run and what
    the kernel is held against on the card."""
    n, d = points.shape
    valid = n if valid_rows is None else min(int(valid_rows), n)
    p = points[:valid]
    cn = (centers * centers).sum(1)
    score = cn[None, :] - 2.0 * (p @ centers.T)
    assign = score.argmin(1)
    sums = torch.zeros((k, d), dtype=points.dtype,
                       device=points.device).index_add_(0, assign, p)
    cnt = torch.zeros((k,), dtype=points.dtype,
                      device=points.device).index_add_(
        0, assign, torch.ones((valid,), dtype=points.dtype,
                              device=points.device))
    return sums, cnt


# -- the CUDA kernel ---------------------------------------------------


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spartan_kmeans_blocks_per_sm.argtypes = [i32, i32,
                                                 ctypes.POINTER(i32)]
    lib.spartan_kmeans_blocks_per_sm.restype = i32
    lib.spartan_kmeans_assign_accumulate.argtypes = [
        vp, vp, vp, vp, vp, vp, i64, i32, i32, i64, i32, vp]
    lib.spartan_kmeans_assign_accumulate.restype = i32


def _load() -> ctypes.CDLL:
    """``csrc/kmeans.cu``, built with nvcc for sm_90a at first use."""
    return build_mod.load("kmeans", _bind)


def _check(err: int, what: str) -> None:
    build_mod.check(err, f"k-means kernel {what}")


def _grid_size(rows: int, per_sm: int, sms: int) -> int:
    """Persistent CTAs for ``rows`` rows: one per tile, at most
    ``per_sm`` on each of ``sms`` SMs, at least one (it writes the zero
    partials when no row is valid)."""
    return max(1, min(-(-rows // _TILE), per_sm * sms))


def _grid(lib: ctypes.CDLL, dev: torch.device, m: int, d: int,
          k: int) -> int:
    key = (dev.index or 0, d, k)
    bps = _occupancy.get(key)
    if bps is None:
        out = ctypes.c_int(0)
        _check(lib.spartan_kmeans_blocks_per_sm(d, k, ctypes.byref(out)),
               "occupancy query")
        if out.value < 1:
            raise RuntimeError(f"k-means kernel cannot run one block of "
                               f"d={d}, k={k}")
        bps = _occupancy[key] = out.value
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _grid_size(m, bps, sms)


def _launch(points: torch.Tensor, centers: torch.Tensor, k: int,
            valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    m, d = points.shape
    why = cuda_limits(d, k)
    if d % 128 or why:
        raise ValueError(f"k-means kernel cannot take d={d}, k={k}: "
                         f"{why or 'd not a multiple of 128'}")
    for name, t in (("points", points), ("centers", centers)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = _load()
    dev = points.device
    with torch.cuda.device(dev):
        grid = _grid(lib, dev, valid, d, k)
        part_sums = torch.empty((grid, k, d), dtype=torch.float32, device=dev)
        part_cnt = torch.empty((grid, k), dtype=torch.float32, device=dev)
        sums = torch.empty((k, d), dtype=torch.float32, device=dev)
        cnt = torch.empty((k,), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spartan_kmeans_assign_accumulate(
            points.data_ptr(), centers.data_ptr(), part_sums.data_ptr(),
            part_cnt.data_ptr(), sums.data_ptr(), cnt.data_ptr(), m, d, k,
            valid, grid, stream)
    _check(err, "launch")
    with build_mod.COUNT_LOCK:
        LAUNCHES += 1
    return sums, cnt


# -- the operator and its batching rule ---------------------------------
#
# The pass is a torch custom operator, so that ``torch.func.vmap`` (the
# serve coalescer's batched walk, serve/coalesce.py) reaches the kernel
# through a batching rule instead of tracing into the ctypes call, which
# cannot take a batched tensor: the counterpart of ``pallas_call``'s
# batching rule in the JAX package. The rule launches the kernel once
# per client on that client's slice (the same kernel, inputs and grid as
# a solo call), so a batched walk is bit-equal to the solo walks and
# counts one launch per client. One launch for the whole batch, with a
# client axis in the grid, is later work (ROADMAP).


@torch.library.custom_op("spartan_tpu_torch::kmeans_assign_accumulate",
                         mutates_args=())
def _pass_op(points: torch.Tensor, centers: torch.Tensor, k: int,
             valid: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass: the CUDA kernel on the card, the plain version on the
    CPU."""
    if build_mod.on_card(points, "k-means"):
        return _launch(points.contiguous(), centers.contiguous(), k, valid)
    return assign_accumulate_plain(points, centers, k, valid)


@_pass_op.register_fake
def _pass_fake(points, centers, k, valid):
    d = points.shape[1]
    return (points.new_empty((k, d)), points.new_empty((k,)))


def _client(t: torch.Tensor, dim: Optional[int], i: int) -> torch.Tensor:
    """Client ``i``'s operand: the whole tensor where it is shared."""
    return t if dim is None else t.select(dim, i)


def _pass_vmap(info, in_dims, points, centers, k, valid):
    """The batching rule: one pass a client, outputs stacked on a new
    leading axis. A client's slice of a contiguous stack along its batch
    axis is contiguous, and 16-byte aligned since the kernel takes d in
    multiples of 128."""
    pd, cd = in_dims[0], in_dims[1]
    outs = [_pass_op(_client(points, pd, i), _client(centers, cd, i), k,
                     valid) for i in range(info.batch_size)]
    return ((torch.stack([o[0] for o in outs]),
             torch.stack([o[1] for o in outs])), (0, 0))


_pass_op.register_vmap(_pass_vmap)


# -- the wrapper -------------------------------------------------------


def assign_accumulate(points: torch.Tensor, centers: torch.Tensor, k: int,
                      valid_rows: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused pass: (k, d) cluster sums and (k,) counts."""
    if points.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError("k-means pass takes float32 points and centers")
    if points.ndim != 2 or centers.shape != (k, points.shape[1]):
        raise ValueError(f"points {tuple(points.shape)} and centers "
                         f"{tuple(centers.shape)} do not match k={k}")
    if centers.device != points.device:
        raise ValueError("points and centers must be on one device")
    n = points.shape[0]
    valid = n if valid_rows is None else max(0, min(int(valid_rows), n))
    build_mod.on_card(points, "k-means")  # raises for another device
    return _pass_op(points, centers, k, valid)


def assign_accumulate_local(points, centers: torch.Tensor, k: int,
                            valid_rows: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass over a group mesh ``DistArray`` of points as it is
    stored: each rank runs :func:`assign_accumulate` on its row block
    (its share of the first ``valid_rows`` rows), and an all-reduce over
    the row axis merges the (k, d) sums and (k,) counts. Points under
    another layout first move to rows (``redistribute.relayout``)."""
    from ..parallel import collectives as coll
    from ..parallel import redistribute as redist_mod

    rows = tiling_mod.row(2)
    points = redist_mod.relayout(points, rows)
    n = points.shape[0]
    valid = n if valid_rows is None else max(0, min(int(valid_rows), n))
    ext = rows.block_extent(points.shape, points.mesh)
    blk = points.local
    limit = min(max(valid - ext.ul[0], 0), blk.shape[0])
    sums, cnt = assign_accumulate(blk, centers, k, limit)
    axes = (tiling_mod.AXIS_ROW,)
    return (coll.reduce_over(sums, axes, "add", points.mesh),
            coll.reduce_over(cnt, axes, "add", points.mesh))


def assign_accumulate_sharded(points, centers: torch.Tensor,
                              k: int, valid_rows: Optional[int] = None,
                              mesh: Optional[mesh_mod.Mesh] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``shard_map`` form of one pass: each position
    of the mesh's row axis runs :func:`assign_accumulate` on its row
    block, counting only its share of the first ``valid_rows`` rows,
    and an ``all_reduce`` sums the (k, d) sums and (k,) counts. A row
    count the row axis does not divide takes one pass over all rows, as
    in the JAX package, and so does a mesh of one row position. On a
    group mesh the pass runs on the row blocks the ranks store
    (:func:`assign_accumulate_local`): of a group mesh ``DistArray`` as
    it is stored, of a whole tensor each rank's row block."""
    from ..parallel import collectives as coll
    from ..parallel.shard_map import shard_map

    if getattr(points, "mesh", None) is not None and points.mesh.is_group:
        return assign_accumulate_local(points, centers, k, valid_rows)
    mesh = mesh or mesh_mod.get_mesh()
    if mesh.is_group:
        from ..array.distarray import from_tensor

        return assign_accumulate_local(
            from_tensor(points, tiling_mod.row(2), mesh), centers, k,
            valid_rows)
    n = points.shape[0]
    valid = n if valid_rows is None else max(0, min(int(valid_rows), n))
    axis = tiling_mod.AXIS_ROW
    p = int(mesh.shape[axis])
    if n % p or p <= 1:
        return assign_accumulate(points, centers, k, valid)
    ms = n // p

    def body(pts, c):
        limit = min(max(valid - coll.axis_index(axis) * ms, 0), ms)
        sums, cnt = assign_accumulate(pts, c, k, limit)
        return coll.all_reduce(sums, axis), coll.all_reduce(cnt, axis)

    return shard_map(body, mesh, (tiling_mod.row(2), None),
                     (tiling_mod.replicated(2), tiling_mod.replicated(1)))(
        points, centers)


def step(points: torch.Tensor, centers: torch.Tensor, k: int,
         valid_rows: Optional[int] = None) -> torch.Tensor:
    """One k-means update: new centers from one fused pass (per rank on
    a group mesh). An empty cluster becomes the zero vector (sums /
    max(count, 1)), as in the JAX package."""
    group = mesh_mod.ambient_group()
    if group is not None:
        sums, cnt = assign_accumulate_sharded(points, centers, k,
                                              valid_rows, group)
    else:
        sums, cnt = assign_accumulate(points, centers, k, valid_rows)
    return sums / torch.clamp_min(cnt, 1.0)[:, None]


def run(points: torch.Tensor, centers: torch.Tensor, k: int, iters: int,
        valid_rows: Optional[int] = None) -> torch.Tensor:
    """All iterations, launched back to back with no host sync."""
    c = centers
    for _ in range(int(iters)):
        c = step(points, c, k, valid_rows)
    return c


def cost(n: int, d: int, k: int) -> Tuple[float, float]:
    """(operations, bytes) of one pass over ``n`` valid rows of ``d``
    dims against ``k`` centers: 2·n·k·d FLOPs of distance products plus
    n·d adds into the sums; the points read once, the centers read and
    the sums written (k, d), the counts written (k,), in float32. The
    count ``chip_smoke.py`` divides by the card's rates for the kernel's
    bound, and the k-means node's ``cost_analysis`` (``st.explain``)."""
    return (2.0 * n * k * d + float(n) * d,
            4.0 * (n * d + 2.0 * k * d + k))
