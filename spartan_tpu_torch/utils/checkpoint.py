"""Checkpoints: per-tile save and load of DistArrays (port of
``spartan_tpu/utils/checkpoint.py``).

A checkpoint is a directory: one raw blob per logical tile of the
array's tiling over its logical mesh (a replicated axis is written
once), written concurrently through the blob I/O pool
(``spartan_tpu_torch/native``), and ``manifest.json`` with the shape,
dtype, tiling, mesh and, per shard, its extent (``ul``, ``lr``), file
and CRC32. The format is the JAX package's: a checkpoint written by
either package loads in the other, bit for bit.

``save`` stages every tile in one host buffer: from the card, a cached
page-locked buffer of at most 1 GiB, filled by asynchronous copies that
one synchronisation covers; a larger array stages through pageable
memory freed after the call. It writes into a temporary directory and
swaps it into place, so a failed or killed save leaves the previous
checkpoint whole. ``load`` verifies each shard's CRC32 (a corrupt blob
raises ``ValueError`` naming its file) and lands the whole array on the
current mesh's device.

On a **group mesh** (``parallel/mesh.py``) nothing is gathered: each
rank writes the blobs of its block when it holds the block's first copy
(``DistArray.is_first_copy``, so a replicated block is written once),
straight into ``path``; rank 0 writes the manifest after a barrier, and
a second barrier keeps every rank from returning before the manifest
exists. The manifest and the blobs keep the JAX package's format: the
manifest lists every shard, and only rank 0's own blobs carry a CRC, as
in the JAX package's multi-process writer. ``load`` on a group mesh reads
only the blobs that meet the rank's block.

A checkpoint written on another grid (an elastic shrink, or a world of
another size) loads as a planned migration: ``load`` prices the move
from the saved tiling on the saved grid to the tiling on the current
grid (``parallel/redistribute.plan_transition``) and records the route
(``restore``), schedule, modelled bytes and reason on the array's
``_migration``.

The ``checkpoint`` chaos seam (``resilience/faults.py``) fires once per
``save`` and per ``load``.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..array import distarray as da
from ..array import tiling as tiling_mod
from ..array.distarray import DistArray
from ..array.extent import TileExtent
from ..parallel import mesh as mesh_mod
from ..utils import dtypes

_MANIFEST = "manifest.json"


def _fire_checkpoint_fault() -> None:
    """The ``checkpoint`` chaos seam: an installed plan's ``io`` tokens
    raise OSError here. One module-attribute read when none is."""
    from ..resilience import faults as faults_mod

    if faults_mod._ACTIVE is not None:
        faults_mod.fire("checkpoint")


def _barrier(mesh) -> None:
    import torch.distributed as dist

    dist.barrier(group=mesh.group)

# At most this many bytes of page-locked staging outlive a call: one
# cached buffer grows to the largest save or load up to this size. A
# larger array stages through pageable memory allocated for the call
# (blocking copies, one per tile).
_PINNED_KEEP = 1 << 30
_pinned_lock = threading.Lock()
_pinned: Optional[np.ndarray] = None  # page-locked by cudaHostRegister


def _pinned_view(nbytes: int) -> np.ndarray:
    """The first ``nbytes`` of the cached page-locked buffer, grown
    (the old one unlocked and freed) when too small. Hold
    ``_pinned_lock``."""
    global _pinned
    if _pinned is None or _pinned.nbytes < nbytes:
        cudart = torch.cuda.cudart()
        if _pinned is not None:
            torch.cuda.check_error(
                cudart.cudaHostUnregister(_pinned.ctypes.data))
            _pinned = None
        buf = np.empty(nbytes, dtype=np.uint8)
        torch.cuda.check_error(
            cudart.cudaHostRegister(buf.ctypes.data, buf.nbytes, 0))
        _pinned = buf
    return _pinned[:nbytes]


@contextlib.contextmanager
def _staging(nbytes: int, device: torch.device) -> Iterator[np.ndarray]:
    """A uint8 host buffer of ``nbytes`` for one save or load. For the
    card it is the cached page-locked buffer (tile copies run
    asynchronously and one synchronisation covers them) unless the
    array is larger than ``_PINNED_KEEP``."""
    nbytes = max(nbytes, 1)
    if device.type != "cuda" or nbytes > _PINNED_KEEP:
        try:
            yield np.empty(nbytes, dtype=np.uint8)
        finally:
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()
        return
    with _pinned_lock:
        try:
            yield _pinned_view(nbytes)
        finally:
            # no copy may still use the buffer once it is reused or freed
            torch.cuda.current_stream(device).synchronize()


def _torch_dtype(name: str) -> torch.dtype:
    if name == "bfloat16":
        return torch.bfloat16
    return dtypes.to_torch(np.dtype(name))


def _swap_into_place(tmp: str, path: str) -> None:
    """Promote the fully written ``tmp`` dir to ``path``: a reader (or a
    crash) sees the old complete checkpoint or the new one, never a
    partial write."""
    if os.path.isdir(path):
        old = path + f".old-{os.getpid()}"
        shutil.rmtree(old, ignore_errors=True)
        os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    else:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        os.replace(tmp, path)


def _axes_to_json(axes):
    return [list(a) if isinstance(a, tuple) else a for a in axes]


def _axes_from_json(axes):
    return tuple(tuple(a) if isinstance(a, list) else a for a in axes)


def _shard_name(ext: TileExtent) -> str:
    return ("shard_" + "_".join(f"{a}-{b}" for a, b in zip(ext.ul, ext.lr))
            + ".bin")


def _crcs(bufs: List[np.ndarray], nthreads: int) -> List[int]:
    # zlib.crc32 releases the interpreter lock on large buffers
    if len(bufs) <= 1:
        return [zlib.crc32(b) for b in bufs]
    with ThreadPoolExecutor(max(1, min(nthreads, len(bufs)))) as pool:
        return list(pool.map(zlib.crc32, bufs))


def _layout(exts: List[TileExtent],
            itemsize: int) -> Tuple[List[int], List[int], int]:
    """Each tile's byte offset and size in one staging buffer, and the
    buffer's size."""
    sizes = [int(np.prod(e.shape, dtype=np.int64)) * itemsize for e in exts]
    offs = [int(o) for o in np.cumsum([0] + sizes[:-1])] if sizes else []
    return offs, sizes, sum(sizes)


def save(path: str, array: Any, nthreads: int = 8) -> None:
    """Write one DistArray (an Expr is evaluated first, a numpy array
    placed first): shard blobs and manifest under ``path``/."""
    if not isinstance(array, DistArray):
        if hasattr(array, "evaluate"):
            array = array.evaluate()
        else:
            array = da.from_numpy(np.asarray(array))
    _fire_checkpoint_fault()
    if array.mesh.is_group:
        _save_group(path, array, nthreads)
        return
    t = array.local
    dest = os.path.abspath(path) + f".tmp-{os.getpid()}"
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest)
    try:
        exts = array.extents()
        offs, sizes, total = _layout(exts, t.element_size())
        on_card = t.device.type == "cuda"
        with _staging(total, t.device) as host:
            stage = torch.from_numpy(host)
            for e, off, nb in zip(exts, offs, sizes):
                view = stage[off:off + nb].view(t.dtype).view(e.shape)
                view.copy_(t[e.to_slice()], non_blocking=on_card)
            if on_card:
                torch.cuda.current_stream(t.device).synchronize()
            bufs = [host[off:off + nb] for off, nb in zip(offs, sizes)]
            crcs = _crcs(bufs, nthreads)
            files = [_shard_name(e) for e in exts]
            native.write_blobs([os.path.join(dest, f) for f in files],
                               bufs, nthreads)
        with open(os.path.join(dest, _MANIFEST), "w") as f:
            json.dump(_manifest(array, files, crcs), f)
        _swap_into_place(dest, path)
    except BaseException:
        shutil.rmtree(dest, ignore_errors=True)
        raise


def _manifest(array: DistArray, files: List[str],
              crcs: List[Optional[int]]) -> Dict[str, Any]:
    exts = array.extents()
    shards = []
    for e, f, c in zip(exts, files, crcs):
        rec = {"ul": list(e.ul), "lr": list(e.lr), "file": f}
        if c is not None:
            rec["crc32"] = c
        shards.append(rec)
    return {"shape": list(array.shape), "dtype": str(array.dtype),
            "tiling": _axes_to_json(array.tiling.axes),
            "mesh": {k: int(v) for k, v in array.mesh.shape.items()},
            "shards": shards}


def _save_group(path: str, array: DistArray, nthreads: int) -> None:
    """The group mesh's writer: each rank writes its block's blob when it
    holds the block's first copy, in place under ``path``; rank 0 writes
    the manifest (CRCs of its own blobs only) after a barrier, and a
    second barrier holds every rank until the manifest is written."""
    mesh = array.mesh
    os.makedirs(path, exist_ok=True)
    mine = array.block_extent()
    crc = None
    if array.is_first_copy:
        blk = array.local
        offs, sizes, total = _layout([mine], blk.element_size())
        with _staging(total, blk.device) as host:
            torch.from_numpy(host)[:total].view(blk.dtype).view(
                mine.shape).copy_(blk)
            buf = host[:total]
            if mesh.rank == 0:
                crc = zlib.crc32(buf)
            native.write_blobs([os.path.join(path, _shard_name(mine))],
                               [buf], nthreads)
    # the manifest commits the checkpoint: not before every rank's blobs
    _barrier(mesh)
    if mesh.rank == 0:
        exts = array.extents()
        files = [_shard_name(e) for e in exts]
        crcs = [crc if (crc is not None and tuple(e.ul) == tuple(mine.ul)
                        and tuple(e.lr) == tuple(mine.lr)) else None
                for e in exts]
        tmp = os.path.join(path, f".{_MANIFEST}.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(_manifest(array, files, crcs), f)
        os.replace(tmp, os.path.join(path, _MANIFEST))
    # no rank returns before the manifest exists
    _barrier(mesh)


def _read_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, _MANIFEST)) as f:
        return json.load(f)


def _read(path: str, device: torch.device, nthreads: int = 8,
          manifest: Optional[Dict[str, Any]] = None,
          region: Optional[TileExtent] = None
          ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """A checkpoint's data on ``device``, CRCs verified: the whole array,
    or with ``region`` only that region, read from the blobs that meet
    it."""
    if manifest is None:
        manifest = _read_manifest(path)
    shape = tuple(int(s) for s in manifest["shape"])
    tdt = _torch_dtype(manifest["dtype"])
    itemsize = torch.empty((), dtype=tdt).element_size()
    if region is None:
        region = TileExtent((0,) * len(shape), shape, shape)
    recs, exts = [], []
    for r in manifest["shards"]:
        e = TileExtent(r["ul"], r["lr"], shape)
        if region.size == 0 or e.intersection(region) is not None:
            recs.append(r)
            exts.append(e)
    offs, sizes, total = _layout(exts, itemsize)
    on_card = device.type == "cuda"
    out = torch.empty(region.shape, dtype=tdt, device=device)
    with _staging(total, device) as host:
        stage = torch.from_numpy(host)
        bufs = [host[off:off + nb] for off, nb in zip(offs, sizes)]
        native.read_blobs([os.path.join(path, r["file"]) for r in recs],
                          bufs, nthreads)
        got = _crcs(bufs, nthreads)
        for rec, crc in zip(recs, got):
            want = rec.get("crc32")
            if want is not None and crc != want:
                raise ValueError(
                    f"checkpoint shard {rec['file']!r} under {path!r} "
                    f"failed CRC32 verification (manifest {want}, "
                    f"read {crc}): the blob is corrupt or truncated")
        for e, off, nb in zip(exts, offs, sizes):
            part = e.intersection(region)
            if part is None:
                continue
            src = stage[off:off + nb].view(tdt).view(e.shape)
            out[part.offset_from(region).to_slice()].copy_(
                src[part.offset_from(e).to_slice()], non_blocking=on_card)
    return out, manifest


def _load_host(path: str, nthreads: int = 8) -> Tuple[np.ndarray,
                                                      Dict[str, Any]]:
    """Read a checkpoint into a host array (no device transfer)."""
    t, manifest = _read(path, torch.device("cpu"), nthreads)
    return dtypes.to_host(t), manifest


def load(path: str, tiling: Optional[tiling_mod.Tiling] = None,
         nthreads: int = 8) -> DistArray:
    """Read a checkpoint onto the current mesh's device, under its saved
    tiling (sanitized for the current mesh) or ``tiling``. Every shard
    that carries a CRC32 is verified as read. On a group mesh each rank
    reads only the blobs that meet its block. A checkpoint of another
    grid records its planned migration on the array's ``_migration``."""
    _fire_checkpoint_fault()
    mesh = mesh_mod.get_mesh()
    manifest = _read_manifest(path)
    shape = tuple(int(s) for s in manifest["shape"])
    saved_axes = _axes_from_json(manifest["tiling"])
    if tiling is None:
        tiling = tiling_mod.sanitize(tiling_mod.Tiling(saved_axes), shape,
                                     mesh)
    if mesh.is_group:
        blk, _ = _read(path, mesh.device, nthreads, manifest,
                       tiling.block_extent(shape, mesh))
        arr = DistArray.from_local(blk, tiling, shape, mesh)
    else:
        t, _ = _read(path, mesh.device, nthreads, manifest)
        arr = DistArray(t, tiling, mesh)
    saved_mesh = {k: int(v) for k, v in (manifest.get("mesh") or {}).items()}
    cur_mesh = {k: int(v) for k, v in mesh.shape.items()}
    if saved_mesh and saved_mesh != cur_mesh:
        from ..parallel import redistribute as redist_mod

        dec = redist_mod.plan_transition(
            tiling_mod.Tiling(saved_axes), arr.tiling, saved_mesh,
            cur_mesh, shape, arr.dtype)
        arr._migration = {
            "route": "restore", "bytes": int(dec.bytes),
            "schedule": (dec.schedule.describe()
                         if dec.schedule is not None else None),
            "planned_route": dec.route, "reason": dec.reason,
            "shape": shape, "src_tiling": saved_axes,
            "dst_tiling": arr.tiling.axes, "src_mesh": saved_mesh,
            "dst_mesh": cur_mesh,
        }
    return arr


def save_tree(path: str, arrays: Dict[str, Any], nthreads: int = 8) -> None:
    """Save a named collection (an application's state dict). On a group
    mesh every rank writes its blobs (``save`` barriers per array) and
    rank 0 alone writes ``tree.json``."""
    os.makedirs(path, exist_ok=True)
    for name, arr in arrays.items():
        save(os.path.join(path, name), arr, nthreads)
    if mesh_mod.get_mesh().rank == 0:
        with open(os.path.join(path, "tree.json"), "w") as f:
            json.dump({"names": sorted(arrays)}, f)


def load_tree(path: str, nthreads: int = 8) -> Dict[str, DistArray]:
    with open(os.path.join(path, "tree.json")) as f:
        names = json.load(f)["names"]
    return {n: load(os.path.join(path, n), nthreads=nthreads)
            for n in names}


def save_sparse(path: str, sp, nthreads: int = 8) -> None:
    """Checkpoint a SparseDistArray: its three entry arrays, tiled over
    the mesh's row axis, and its shape and true entry count."""
    os.makedirs(path, exist_ok=True)
    t = tiling_mod.row(1)
    for name, arr in (("data", sp.data), ("rows", sp.rows),
                      ("cols", sp.cols)):
        save(os.path.join(path, name), DistArray(arr, t, sp.mesh), nthreads)
    with open(os.path.join(path, "sparse.json"), "w") as f:
        json.dump({"shape": list(sp.shape), "nnz": int(sp.nnz)}, f)


def load_sparse(path: str, nthreads: int = 8):
    """Load a sparse checkpoint onto the current mesh's device and
    re-canonicalise it there (``from_coo_device``): the entry count is
    padded to the current mesh's size with out-of-range rows, which the
    dedup rewrites to the canonical padding."""
    from ..array.sparse import SparseDistArray

    with open(os.path.join(path, "sparse.json")) as f:
        meta = json.load(f)
    shape = tuple(meta["shape"])
    mesh = mesh_mod.get_mesh()
    nx, ny = mesh_mod.mesh_axis_sizes(mesh)

    def component(name, fill):
        t, _ = _read(os.path.join(path, name), mesh.device, nthreads)
        pad = -t.shape[0] % (nx * ny)
        if pad:
            t = torch.cat([t, torch.full((pad,), fill, dtype=t.dtype,
                                         device=t.device)])
        return t

    return SparseDistArray.from_coo_device(
        component("rows", shape[0]), component("cols", 0),
        component("data", 0), shape, mesh=mesh)
