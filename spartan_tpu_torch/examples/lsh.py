"""Locality-sensitive hashing (port of ``spartan_tpu/examples/lsh.py``).

Random-hyperplane (SimHash) signatures for cosine similarity: the
O(n·d·b) projection is one ``st.dot`` against the projection matrix and
an elementwise sign on the device; banding and candidate-pair
extraction work on the host on the (n, bands) packed signatures, as in
the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np

from ..expr import builtins as bi
from ..expr.base import as_expr
from ..expr.dot import dot


def signatures(points, n_bits: int = 64, seed: int = 0) -> np.ndarray:
    """(n, n_bits) sign bits of X @ R for random Gaussian R."""
    points = as_expr(points)
    d = points.shape[1]
    rng = np.random.RandomState(seed)
    r = rng.randn(d, n_bits).astype(np.float32)
    proj = dot(points, as_expr(r))
    bits = bi.astype(proj > 0.0, np.int32)
    return np.asarray(bits.glom()).astype(np.uint8)


def band_signatures(bits: np.ndarray, bands: int) -> np.ndarray:
    """Pack each band's bit-slice into one uint64 per (row, band)."""
    n, nb = bits.shape
    if nb % bands:
        raise ValueError(f"{nb} bits not divisible into {bands} bands")
    rows_per = nb // bands
    if rows_per > 64:
        raise ValueError("band width > 64 bits")
    weights = (1 << np.arange(rows_per, dtype=np.uint64))
    return (bits.reshape(n, bands, rows_per).astype(np.uint64)
            * weights[None, None, :]).sum(axis=2)


def candidate_pairs(points, n_bits: int = 64, bands: int = 8,
                    seed: int = 0) -> Set[Tuple[int, int]]:
    """Pairs sharing at least one band hash (the LSH candidates for
    high cosine similarity)."""
    packed = band_signatures(signatures(points, n_bits, seed), bands)
    out: Set[Tuple[int, int]] = set()
    for b in range(bands):
        buckets: Dict[int, List[int]] = {}
        for i, h in enumerate(packed[:, b]):
            buckets.setdefault(int(h), []).append(i)
        for members in buckets.values():
            for x in range(len(members)):
                for y in range(x + 1, len(members)):
                    out.add((members[x], members[y]))
    return out


def hamming_similarity(points, i: int, j: int, n_bits: int = 256,
                       seed: int = 0) -> float:
    """Estimated cosine similarity of rows i, j from signature
    agreement: cos(pi * (1 - agree_frac)). Fetches and projects only
    the two rows."""
    points = as_expr(points)
    d = points.shape[1]
    rng = np.random.RandomState(seed)
    r = rng.randn(d, n_bits).astype(np.float32)
    two = np.stack([np.asarray(points[i].glom()),
                    np.asarray(points[j].glom())])
    bits = (two @ r) > 0.0
    agree = float((bits[0] == bits[1]).mean())
    return float(np.cos(np.pi * (1.0 - agree)))
