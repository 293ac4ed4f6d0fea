"""Sample-sort send-buffer pack: the hand-written CUDA kernel and its
plain version (port of ``spartan_tpu/kernels/exchange.py``).

The sample sort's padded transport (``ops/sort.py``) builds, for every
logical shard i, a ``(p, m)`` send buffer: row j is the contiguous run
``xs[i, starts[i, j] : starts[i, j] + counts[i, j]]`` of the shard's
sorted stream, zero past ``counts[i, j]``. Runs are contiguous, so the
scatter the expr path lowers through is a batch of dynamic slices.

:func:`partition_pack` packs all shards' buffers in one launch of
``spartan_tpu_torch/csrc/exchange.cu`` on CUDA tensors (built with
``nvcc`` for ``sm_90a`` at first use, bound through ``ctypes``) and runs
:func:`partition_pack_plain` on CPU tensors; any other device raises.
Both move raw 32-bit words, so every 4-byte dtype is packed bit for bit,
NaN payloads and -0.0 included. Validity needs no kernel: slot t of row
j is valid when ``t < counts[j]`` (an iota compare, built by the
caller).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from ..utils import dtypes
from . import build as build_mod

# Kernel launches so far: the wrapper adds one where it launches the
# CUDA kernel and nowhere else (the plain version does not count).
LAUNCHES: Dict[str, int] = {"partition_pack": 0}

# the 32-bit integer view each 4-byte dtype is moved as
_WORD = {torch.float32: torch.int32, torch.int32: torch.int32}


def cuda_limits(dtype, m: int) -> str:
    """Why the kernel cannot take ``dtype`` rows of ``m`` slots, or ""
    when it can (``dtype`` torch or numpy): it moves 32-bit words and
    indexes a row with int32 ``starts``."""
    if dtypes.to_numpy(dtype) not in (np.float32, np.int32):
        return f"dtype {dtype} is not a 4-byte type the kernel moves"
    if m >= 2 ** 31:
        return f"rows of {m} slots exceed int32 run offsets"
    return ""


def partition_pack_plain(xs: torch.Tensor, starts: torch.Tensor,
                         counts: torch.Tensor) -> torch.Tensor:
    """A gather over an index map on the int32 view of ``xs`` (B, m):
    ``out[b, j, t] = xs[b, starts[b, j] + t]`` for ``t < counts[b, j]``,
    else 0. Returns ``(B, p, m)`` of ``xs``'s dtype, bit-exact."""
    b, m = xs.shape
    p = starts.shape[1]
    words = xs.view(_WORD[xs.dtype])
    t = torch.arange(m, dtype=torch.int64, device=xs.device)
    src = (starts.to(torch.int64)[:, :, None] + t).clamp_(0, max(m - 1, 0))
    vals = words.gather(1, src.reshape(b, p * m)).reshape(b, p, m)
    keep = t < counts.to(torch.int64)[:, :, None]
    return torch.where(keep, vals, torch.zeros((), dtype=words.dtype,
                                               device=xs.device)
                       ).view(xs.dtype)


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spartan_partition_pack.argtypes = [vp, vp, vp, vp, i64, i32, i64, vp]
    lib.spartan_partition_pack.restype = i32


def _load() -> ctypes.CDLL:
    """``csrc/exchange.cu``, built with nvcc for sm_90a at first use."""
    return build_mod.load("exchange", _bind)


def _launch(xs: torch.Tensor, starts: torch.Tensor,
            counts: torch.Tensor) -> torch.Tensor:
    b, m = xs.shape
    p = starts.shape[1]
    lib = _load()
    dev = xs.device
    with torch.cuda.device(dev):
        out = torch.empty((b, p, m), dtype=xs.dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spartan_partition_pack(
            xs.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            out.data_ptr(), b, p, m, stream)
    build_mod.check(err, "partition_pack kernel launch")
    build_mod.count_launch(LAUNCHES, "partition_pack")
    return out


def partition_pack(xs: torch.Tensor, starts: torch.Tensor,
                   counts: torch.Tensor) -> torch.Tensor:
    """``(B, p, m)`` send buffers of B logical shards' sorted streams
    ``xs`` (B, m), 4-byte dtype; ``starts``/``counts`` (B, p) int32 name
    each destination's contiguous run. Slots past a run's count are 0."""
    if xs.ndim != 2 or starts.ndim != 2 or starts.shape != counts.shape \
            or starts.shape[0] != xs.shape[0]:
        raise ValueError(f"xs {tuple(xs.shape)}, starts "
                         f"{tuple(starts.shape)} and counts "
                         f"{tuple(counts.shape)} do not form (B, m) streams "
                         f"with (B, p) runs")
    if starts.device != xs.device or counts.device != xs.device:
        raise ValueError("xs, starts and counts must be on one device")
    why = cuda_limits(xs.dtype, xs.shape[1])
    if why:
        raise TypeError(f"partition_pack cannot take this input: {why}")
    if not build_mod.on_card(xs, "partition_pack"):
        return partition_pack_plain(xs, starts, counts)
    for name, t in (("starts", starts), ("counts", counts)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 on the card, not "
                             f"{t.dtype}")
    return _launch(xs.contiguous(), starts.contiguous(), counts.contiguous())
