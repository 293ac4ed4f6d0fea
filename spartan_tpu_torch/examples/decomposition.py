"""Matrix decompositions: Cholesky, QR, tall-skinny QR and Netflix SGD
(port of ``spartan_tpu/examples/decomposition.py``).

The factorizations are ``torch.linalg`` calls (cuSOLVER on the card,
TF32 off) inside ``map2`` over the operand. ``tsqr`` is the
owner-computes tree: a QR of each logical row shard (batched over the
mesh's row shards), a QR of the stacked R factors, and each shard's Q
corrected by its block of the second Q — the program the JAX package
runs under ``shard_map``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..array import distarray as da
from ..array import tiling as tiling_mod
from ..expr.base import Expr, as_expr
from ..expr.map2 import map2
from ..parallel import mesh as mesh_mod


def _cholesky_kern(x):
    return torch.linalg.cholesky(x)


def cholesky(a) -> Expr:
    """Lower-triangular factor of an SPD matrix."""
    a = as_expr(a)
    return map2([a], _cholesky_kern, out_tiling=tiling_mod.replicated(2))


def _qr_kern(x):
    q, r = torch.linalg.qr(x)
    return torch.cat([q, r], dim=0)  # pack (m+n, n)


def qr(a) -> Tuple[np.ndarray, np.ndarray]:
    """Thin QR of a matrix."""
    a = as_expr(a)
    packed = map2([a], _qr_kern, out_tiling=tiling_mod.replicated(2)).glom()
    m = a.shape[0]
    return packed[:m], packed[m:]


def _tsqr_kern(x, p):
    m, n = x.shape
    q1, r1 = torch.linalg.qr(x.reshape(p, m // p, n))  # (p, m/p, n), (p, n, n)
    q2, r = torch.linalg.qr(r1.reshape(p * n, n))
    q = q1 @ q2.reshape(p, n, n)  # each shard's Q times its block of q2
    return torch.cat([q.reshape(m, n), r], dim=0)


def tsqr(a) -> Tuple[np.ndarray, np.ndarray]:
    """Tall-skinny QR: local QR per logical row shard, the stacked R
    factors QR'd again, local Q corrected."""
    a = as_expr(a)
    n_x = max(int(mesh_mod.get_mesh().shape.get(tiling_mod.AXIS_ROW, 1)), 1)
    m, n = a.shape
    if m % n_x or m // n_x < n:
        # fall back to the plain path when shards would be wide
        return qr(a)
    packed = map2([a], _tsqr_kern, fn_kw={"p": n_x},
                  out_tiling=tiling_mod.replicated(2)).glom()
    return packed[:m], packed[m:]


def _netflix_step(rv, uv, vv, lr, reg):
    pred = uv @ vv.T
    mask = (rv != 0).to(rv.dtype)
    err = (pred - rv) * mask
    gu = err @ vv / torch.clamp_min(mask.sum(), 1.0) + reg * uv
    gv = err.T @ uv / torch.clamp_min(mask.sum(), 1.0) + reg * vv
    return torch.cat([uv - lr * gu, vv - lr * gv], dim=0)


def netflix_sgd(ratings, k: int = 16, num_iter: int = 10,
                lr: float = 0.01, reg: float = 0.05, seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Netflix-style matrix factorization: full-gradient descent on the
    observed entries (zeros are missing), one ``map2`` step per
    iteration."""
    ratings = as_expr(ratings)
    m, n = ratings.shape
    rng = np.random.RandomState(seed)
    u = rng.rand(m, k).astype(np.float32) * 0.1
    v = rng.rand(n, k).astype(np.float32) * 0.1
    for _ in range(num_iter):
        eu = da.from_numpy(u, tiling=tiling_mod.replicated(2))
        ev = da.from_numpy(v, tiling=tiling_mod.replicated(2))
        packed = map2([ratings, eu, ev], _netflix_step,
                      fn_kw={"lr": lr, "reg": reg},
                      out_tiling=tiling_mod.replicated(2)).glom()
        u, v = packed[:m], packed[m:]
    return u, v
