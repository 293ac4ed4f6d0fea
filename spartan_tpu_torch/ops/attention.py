"""Long-context attention: blockwise, ring (sequence-parallel), Ulysses
(port of ``spartan_tpu/ops/attention.py``).

The sequence axis is split over a mesh axis and attention runs either

* :func:`blockwise_attention` — online softmax over KV blocks on one
  position (memory-efficient; the substrate),
* :func:`ring_attention` — KV blocks rotate around the ring
  (``ring_permute``) while each position accumulates its queries'
  online softmax,
* :func:`ulysses_attention` — one ``all_to_all`` moves the split from
  the sequence axis to the head axis, full attention runs per head
  group, and the inverse ``all_to_all`` restores the sequence split.

Arrays are ``(L, H, D)``. Every variant accumulates in float32 (float64
for float64 inputs) and matches :func:`dense_attention`. The products are
``torch.einsum`` (cuBLAS with TF32 off on the card): the JAX package has
no Pallas kernel here, XLA computes them. ``scaled_dot_product_attention``
is not used: its fused kernels do not promise IEEE float32.
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import numpy as np
import torch

from ..array.tiling import Tiling
from ..parallel import collectives as coll
from ..parallel import mesh as mesh_mod
from ..parallel.shard_map import shard_map

_NEG_INF = -1e30
# elements of one head group's score matrix in dense_attention: heads are
# taken in groups of at most this many scores (1 GiB of float32), which
# bounds the memory of a long sequence without changing any value
_SCORE_ELEMS = 1 << 28


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.promote_types(dt, torch.float32)


def _tensor(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.asarray(x)).to(mesh_mod.get_mesh().device)


def dense_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Oracle: plain softmax attention. q, k, v: (L, H, D)."""
    q, k, v = _tensor(q), _tensor(k), _tensor(v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    lq, h = q.shape[0], q.shape[1]
    lk = k.shape[0]
    group = max(1, min(h, _SCORE_ELEMS // max(lq * lk, 1)))
    mask = None
    if causal:
        mask = torch.ones((lq, lk), dtype=torch.bool,
                          device=q.device).tril()
    outs = []
    for h0 in range(0, h, group):
        sl = slice(h0, min(h, h0 + group))
        scores = torch.einsum("qhd,khd->hqk", q[:, sl], k[:, sl]) * scale
        if mask is not None:
            scores = scores.masked_fill(~mask[None], _NEG_INF)
        w = torch.softmax(scores.to(_acc_dtype(q.dtype)), dim=-1)
        del scores
        outs.append(torch.einsum("hqk,khd->qhd", w.to(q.dtype), v[:, sl]))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


def _online_block(q, k, v, acc, m, denom, q_off: int, k_off: int,
                  causal: bool, valid=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One KV block of online softmax. q: (Lq,H,D); k,v: (Lk,H,D);
    acc: (Lq,H,D); m, denom: (H, Lq), in the accumulation dtype.
    ``valid`` (Lk,) masks padding keys when not causal."""
    adt = acc.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("qhd,khd->hqk", q, k).to(adt) * scale
    if causal:
        q_pos = q_off + torch.arange(q.shape[0], device=q.device)
        k_pos = k_off + torch.arange(k.shape[0], device=q.device)
        keep = q_pos[:, None] >= k_pos[None, :]
        scores = scores.masked_fill(~keep[None], _NEG_INF)
    elif valid is not None:
        scores = scores.masked_fill(~valid[None, None, :], _NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    del scores
    denom = denom * corr + p.sum(dim=-1)
    pv = torch.einsum("hqk,khd->qhd", p.to(v.dtype), v).to(adt)
    acc = acc * corr.T[..., None] + pv
    return acc, m_new, denom


def _state(q: torch.Tensor):
    adt = _acc_dtype(q.dtype)
    lq, h = q.shape[0], q.shape[1]
    acc = torch.zeros(q.shape, dtype=adt, device=q.device)
    m = torch.full((h, lq), _NEG_INF, dtype=adt, device=q.device)
    den = torch.zeros((h, lq), dtype=adt, device=q.device)
    return acc, m, den


def blockwise_attention(q, k, v, block_size: int = 512,
                        causal: bool = False) -> torch.Tensor:
    """(L, H, D) attention over KV blocks; O(L * block) memory."""
    q, k, v = _tensor(q), _tensor(k), _tensor(v)
    lk = k.shape[0]
    bs = min(block_size, lk)
    pad = -lk % bs
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    acc, m, den = _state(q)
    for koff in range(0, k.shape[0], bs):
        kk, vv = k[koff:koff + bs], v[koff:koff + bs]
        # padding keys (zeros) sit past lk: not causal, they are masked;
        # causal, they lie past every query
        valid = (koff + torch.arange(bs, device=q.device)) < lk
        acc, m, den = _online_block(q, kk, vv, acc, m, den, 0, koff,
                                    causal, None if causal else valid)
    return (acc / den.T[..., None]).to(q.dtype)


def ring_attention(q, k, v, causal: bool = False,
                   mesh_axis: str = mesh_mod.AXIS_ROW) -> torch.Tensor:
    """Sequence-parallel attention: (L, H, D) arrays split on L over
    ``mesh_axis``; KV blocks rotate around the ring (``ring_permute``)
    while each position accumulates its local queries' online softmax."""
    q, k, v = _tensor(q), _tensor(k), _tensor(v)
    mesh = mesh_mod.get_mesh()
    n = mesh.shape[mesh_axis]
    seq = q.shape[0]
    if seq % max(n, 1):
        raise ValueError(f"sequence length {seq} must divide over "
                         f"{n} devices")
    seq_t = Tiling((mesh_axis, None, None))
    shard_l = seq // n

    def kernel(ql, kl, vl):
        my = coll.axis_index(mesh_axis)
        q_off = my * shard_l
        acc, m, den = _state(ql)
        kk, vv = kl, vl
        for s in range(n):
            # the block in hand came from position (my - s) mod n
            k_off = ((my - s) % n) * shard_l
            acc, m, den = _online_block(ql, kk, vv, acc, m, den, q_off,
                                        k_off, causal)
            kk = coll.ring_permute(kk, mesh_axis, 1)
            vv = coll.ring_permute(vv, mesh_axis, 1)
        return (acc / den.T[..., None]).to(ql.dtype)

    return shard_map(kernel, mesh, (seq_t, seq_t, seq_t), seq_t)(q, k, v)


def ulysses_attention(q, k, v, causal: bool = False,
                      mesh_axis: str = mesh_mod.AXIS_ROW) -> torch.Tensor:
    """Sequence parallelism by an axis swap: inputs split on L; one
    ``all_to_all`` re-splits them on H, full-sequence attention runs per
    head group, and the inverse ``all_to_all`` restores the L split."""
    q, k, v = _tensor(q), _tensor(k), _tensor(v)
    mesh = mesh_mod.get_mesh()
    n = mesh.shape[mesh_axis]
    if q.shape[1] % max(n, 1):
        raise ValueError(f"head count {q.shape[1]} must divide over "
                         f"{n} devices")
    seq_t = Tiling((mesh_axis, None, None))

    def kernel(ql, kl, vl):
        # (L/n, H, D) -> (L, H/n, D)
        qh = coll.all_to_all(ql, mesh_axis, split_axis=1, concat_axis=0)
        kh = coll.all_to_all(kl, mesh_axis, split_axis=1, concat_axis=0)
        vh = coll.all_to_all(vl, mesh_axis, split_axis=1, concat_axis=0)
        out = dense_attention(qh, kh, vh, causal)
        return coll.all_to_all(out, mesh_axis, split_axis=0, concat_axis=1)

    return shard_map(kernel, mesh, (seq_t, seq_t, seq_t), seq_t)(q, k, v)
