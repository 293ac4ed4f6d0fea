"""Per-shard top-k selection: the hand-written CUDA kernel and its plain
version (port of ``spartan_tpu/kernels/topk.py``).

:func:`shard_topk` takes the ranking keys of B logical shards, ``(B, m)``
f32 or int32, and returns each shard's k best keys and their local int32
indices, best first, for k <= 128. The order is ``lax.top_k``'s and is
total: a larger key wins, and among equal keys the lower index wins; f32
keys compare in IEEE total order on their bits (+NaN above +inf, +0.0
above -0.0, -NaN below -inf), int32 keys as integers. Slots a shard
cannot fill carry ``(sentinel, 2**30)``, and returned indices are clamped
to ``m - 1``, as in the TPU kernel.

On CUDA tensors the wrapper launches ``spartan_tpu_torch/csrc/topk.cu``
(built with ``nvcc`` for ``sm_90a`` at first use, bound through
``ctypes``); on CPU tensors it runs :func:`shard_topk_plain`; any other
device raises, and so does a CUDA tensor the kernel cannot take.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils import dtypes
from . import build as build_mod

# Kernel launches so far: the wrapper adds one where it launches the
# CUDA kernel and nowhere else (the plain version does not count).
LAUNCHES: Dict[str, int] = {"shard_topk": 0}

MAX_K = 128
IDX_INF = 2 ** 30  # index of an empty slot, before the clamp to m - 1
# keys one CTA of the kernel's first pass reads per step (256 threads x
# four 16-byte vectors), and its CTAs per SM (the kernel's launch bounds)
_STEP = 4096
_CTAS_PER_SM = 4
# candidate words one CTA of the second pass takes
_PASS2_WORDS = 1024
# the first pass seeds its threshold from _RUNS runs of _RUN_LEN keys
_RUNS = 8
_RUN_LEN = 128


def order_key(key: torch.Tensor) -> torch.Tensor:
    """An integer tensor whose natural order is ``lax.top_k``'s order of
    ``key``: floats by IEEE total order on their bits (no two bit
    patterns tie), integers and bools by value."""
    if key.dtype.is_floating_point:
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        bits = key.view(ints[key.element_size()])
        mask = (1 << (8 * key.element_size() - 1)) - 1
        return bits ^ ((bits >> (8 * key.element_size() - 1)) & mask)
    if key.dtype == torch.bool:
        return key.to(torch.int32)
    return key


def top_k(key: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k best keys and their int64
    indices, best first, ties to the lowest index (a stable descending
    sort of :func:`order_key`). Needs ``k`` <= the last axis."""
    idx = torch.sort(order_key(key), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return key.gather(-1, idx), idx


def cuda_limits(dtype, m: int, k: int) -> str:
    """Why the kernel cannot take ``dtype`` rows of ``m`` keys and this
    ``k``, or "" when it can (``dtype`` torch or numpy)."""
    if dtypes.to_numpy(dtype) not in (np.float32, np.int32):
        return f"dtype {dtype} is not float32 or int32"
    if not 1 <= k <= MAX_K:
        return f"k {k} outside [1, {MAX_K}]"
    if m >= 2 ** 31:
        return f"rows of {m} keys exceed int32 indices"
    return ""


def shard_topk_plain(key: torch.Tensor, k: int,
                     sentinel) -> Tuple[torch.Tensor, torch.Tensor]:
    """A stable descending sort of each row of ``key`` (B, m), cut to
    k: ``((B, k) keys, (B, k) int32 indices)``."""
    b, m = key.shape
    take = min(k, m)
    keys, idx = top_k(key, take)
    if take < k:
        pad = k - take
        keys = torch.cat([keys, torch.full((b, pad), sentinel,
                                           dtype=key.dtype,
                                           device=key.device)], 1)
        idx = torch.cat([idx, torch.full((b, pad), IDX_INF,
                                         dtype=idx.dtype,
                                         device=key.device)], 1)
    return keys, idx.clamp_(max=max(m - 1, 0)).to(torch.int32)


def _chunking(rows: int, m: int, sms: int) -> Tuple[int, int]:
    """``(chunk, chunks)`` of the kernel's first pass: each of ``rows``
    rows of ``m`` keys is cut into ``chunks`` chunks of ``chunk`` keys
    (the last one shorter), one CTA each, so that all rows together make
    about ``_CTAS_PER_SM`` CTAs per SM of ``sms``, one wave. A chunk is a
    whole number of steps; pass 2 then weighs ``chunks * k`` words per
    row, ``_PASS2_WORDS`` a CTA."""
    want = max(1, (_CTAS_PER_SM * sms) // rows)
    per_cta = -(-m // want)
    chunk = -(-per_cta // _STEP) * _STEP
    return chunk, -(-m // chunk)


def _sample_runs(n: int) -> List[int]:
    """Chunk-relative starts of the runs of ``_RUN_LEN`` keys from which
    the first pass seeds a chunk of ``n`` keys, spread from its first
    key to its last (none when the chunk holds at most ``_RUNS *
    _RUN_LEN`` keys: the seed then takes them all)."""
    if n <= _RUNS * _RUN_LEN:
        return []
    return [r * (n - _RUN_LEN) // (_RUNS - 1) for r in range(_RUNS)]


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spartan_shard_topk.argtypes = [vp, vp, vp, vp, vp, i64, i64, i32,
                                       i32, i64, i64, ctypes.c_uint, vp]
    lib.spartan_shard_topk.restype = i32


def _load() -> ctypes.CDLL:
    """``csrc/topk.cu``, built with nvcc for sm_90a at first use."""
    return build_mod.load("topk", _bind)


def _sentinel_bits(sentinel, dtype) -> int:
    """The 32 bits of ``sentinel`` as a ``dtype`` key."""
    word = torch.tensor([sentinel], dtype=dtype).view(torch.int32)
    return int(word.item()) & 0xFFFFFFFF


def _launch(key: torch.Tensor, k: int, sentinel):
    b, m = key.shape
    lib = _load()
    dev = key.device
    chunk, chunks = _chunking(
        b, m, torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(dev):
        cand1 = torch.empty((b, chunks, k), dtype=torch.int64, device=dev)
        cand2 = torch.empty((b, -(-chunks * k // _PASS2_WORDS), k),
                            dtype=torch.int64, device=dev)
        out_keys = torch.empty((b, k), dtype=key.dtype, device=dev)
        out_idx = torch.empty((b, k), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spartan_shard_topk(
            key.data_ptr(), cand1.data_ptr(), cand2.data_ptr(),
            out_keys.data_ptr(), out_idx.data_ptr(), b, m, k,
            int(key.dtype == torch.float32), chunk, chunks,
            _sentinel_bits(sentinel, key.dtype), stream)
    build_mod.check(err, "shard_topk kernel launch")
    build_mod.count_launch(LAUNCHES, "shard_topk")
    return out_keys, out_idx


def shard_topk(key: torch.Tensor, k: int,
               sentinel) -> Tuple[torch.Tensor, torch.Tensor]:
    """``((B, k) keys, (B, k) int32 local indices)`` of each row of the
    ranking keys ``key`` (B, m), best first. ``sentinel`` fills the slots
    of a row shorter than k."""
    if key.ndim != 2 or key.shape[0] == 0 or key.shape[1] == 0:
        raise ValueError(f"shard_topk takes (B, m) keys with B, m >= 1, "
                         f"not {tuple(key.shape)}")
    k = int(k)
    if not build_mod.on_card(key, "shard_topk"):
        return shard_topk_plain(key, k, sentinel)
    why = cuda_limits(key.dtype, key.shape[1], k)
    if why:
        raise ValueError(f"shard_topk kernel cannot take this input: {why}")
    if key.shape[0] > 65535:
        raise ValueError(f"shard_topk kernel takes at most 65535 rows, not "
                         f"{key.shape[0]}")
    return _launch(key.contiguous(), k, sentinel)
