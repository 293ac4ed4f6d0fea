"""Stochastic (randomized) SVD (port of ``spartan_tpu/examples/ssvd.py``;
config 5 of BASELINE.json, after Halko-Martinsson-Tropp).

The sketch, the power iterations, the projection and the small final
SVD are one lazy DAG: the big products are ``st.dot`` (cuBLAS, TF32
off), each (m, k) panel's QR is ``torch.linalg.qr`` inside a ``map2``,
and the (k, n) SVD is ``torch.linalg.svd`` inside a ``map2``, all on the
array's device; only the packed small factors come to the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..array import distarray as da
from ..array import tiling as tiling_mod
from ..expr.base import as_expr
from ..expr.dot import dot
from ..expr.map2 import map2


def _qr_q(x):
    return torch.linalg.qr(x)[0]


def _small_svd(bv):
    u_b, s, vt = torch.linalg.svd(bv, full_matrices=False)
    return torch.cat([u_b, s[None, :], vt.T], dim=0)


def ssvd(a, rank: int, n_oversample: int = 10, n_power_iter: int = 2,
         seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Approximate truncated SVD: returns (U, s, Vt) with U (m, rank)."""
    a = as_expr(a)
    m, n = a.shape
    k = min(rank + n_oversample, min(m, n))

    rng = np.random.RandomState(seed)
    omega = da.from_numpy(rng.randn(n, k).astype(np.float32),
                          tiling=tiling_mod.replicated(2))

    # sketch + power iterations, QR-stabilized each hop
    y = dot(a, omega)
    q = map2([y], _qr_q, out_tiling=tiling_mod.row(2))
    for _ in range(n_power_iter):
        z = dot(a.T, q)
        qz = map2([z], _qr_q, out_tiling=tiling_mod.row(2))
        y = dot(a, qz)
        q = map2([y], _qr_q, out_tiling=tiling_mod.row(2))

    # project to the small space and decompose there
    b = dot(q.T, a)  # (k, n)
    packed = map2([b], _small_svd,
                  out_tiling=tiling_mod.replicated(2)).glom()
    u_b = packed[:k]
    s = packed[k]
    vt = packed[k + 1:].T

    u = dot(q, da.from_numpy(u_b)).glom()
    return u[:, :rank], s[:rank], vt[:rank]
