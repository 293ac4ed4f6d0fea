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
current mesh's device. The multi-process branch and the cross-mesh
migration records wait for elasticity (ROADMAP A3b-iii; the planner
they price with, ``parallel/redistribute.
plan_transition``, is ported).
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
    # a group mesh gathers the whole array (counted); the multi-process
    # writer that keeps local blocks is ROADMAP A3b-iii
    t = array.materialize("checkpoint")
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
        manifest = {
            "shape": list(array.shape),
            "dtype": str(array.dtype),
            "tiling": _axes_to_json(array.tiling.axes),
            "mesh": {k: int(v) for k, v in array.mesh.shape.items()},
            "shards": [{"ul": list(e.ul), "lr": list(e.lr), "file": f,
                        "crc32": c} for e, f, c in zip(exts, files, crcs)],
        }
        with open(os.path.join(dest, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        _swap_into_place(dest, path)
    except BaseException:
        shutil.rmtree(dest, ignore_errors=True)
        raise


def _read(path: str, device: torch.device,
          nthreads: int = 8) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """A checkpoint's data as one tensor on ``device``, CRCs verified."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    shape = tuple(int(s) for s in manifest["shape"])
    tdt = _torch_dtype(manifest["dtype"])
    itemsize = torch.empty((), dtype=tdt).element_size()
    exts = [TileExtent(r["ul"], r["lr"], shape) for r in manifest["shards"]]
    offs, sizes, total = _layout(exts, itemsize)
    on_card = device.type == "cuda"
    out = torch.empty(shape, dtype=tdt, device=device)
    with _staging(total, device) as host:
        stage = torch.from_numpy(host)
        bufs = [host[off:off + nb] for off, nb in zip(offs, sizes)]
        native.read_blobs([os.path.join(path, r["file"])
                           for r in manifest["shards"]], bufs, nthreads)
        got = _crcs(bufs, nthreads)
        for rec, crc in zip(manifest["shards"], got):
            want = rec.get("crc32")
            if want is not None and crc != want:
                raise ValueError(
                    f"checkpoint shard {rec['file']!r} under {path!r} "
                    f"failed CRC32 verification (manifest {want}, "
                    f"read {crc}): the blob is corrupt or truncated")
        for e, off, nb in zip(exts, offs, sizes):
            src = stage[off:off + nb].view(tdt).view(e.shape)
            out[e.to_slice()].copy_(src, non_blocking=on_card)
    return out, manifest


def _load_host(path: str, nthreads: int = 8) -> Tuple[np.ndarray,
                                                      Dict[str, Any]]:
    """Read a checkpoint into a host array (no device transfer)."""
    t, manifest = _read(path, torch.device("cpu"), nthreads)
    return dtypes.to_host(t), manifest


def load(path: str, tiling: Optional[tiling_mod.Tiling] = None,
         nthreads: int = 8) -> DistArray:
    """Read a checkpoint onto the current mesh's device, under its saved
    tiling (sanitized for the current mesh) or ``tiling``. Every shard's
    CRC32 is verified as read."""
    mesh = mesh_mod.get_mesh()
    t, manifest = _read(path, mesh.device, nthreads)
    if tiling is None:
        tiling = tiling_mod.sanitize(
            tiling_mod.Tiling(_axes_from_json(manifest["tiling"])),
            t.shape, mesh)
    return DistArray(t, tiling, mesh)


def save_tree(path: str, arrays: Dict[str, Any], nthreads: int = 8) -> None:
    """Save a named collection (an application's state dict)."""
    os.makedirs(path, exist_ok=True)
    for name, arr in arrays.items():
        save(os.path.join(path, name), arr, nthreads)
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
