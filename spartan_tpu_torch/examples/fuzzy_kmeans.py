"""Fuzzy k-means (port of ``spartan_tpu/examples/fuzzy_kmeans.py``).

Soft assignments with fuzziness m; one iteration is one ``map2``
(memberships and the weighted center sums) and a division, evaluated
per iteration as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..expr import builtins as bi
from ..expr.base import Expr, ValExpr, as_expr
from ..expr.map2 import map2


def _fuzzy_kern(p, c, m):
    d2 = ((p * p).sum(1, keepdim=True) - 2.0 * (p @ c.T)
          + (c * c).sum(1)[None, :])
    d2 = torch.clamp_min(d2, 1e-12)
    inv = d2 ** (-1.0 / (m - 1.0))
    u = inv / inv.sum(1, keepdim=True)  # memberships (n, k)
    um = u ** m
    sums = um.T @ p  # (k, d) weighted sums
    wsum = um.sum(0)  # (k,)
    return torch.cat([sums, wsum[:, None]], dim=1)


def fuzzy_kmeans_step(points: Expr, centers: Expr, k: int,
                      m: float = 2.0) -> Expr:
    acc = map2([points, centers], _fuzzy_kern, fn_kw={"m": m},
               out_tiling=tiling_mod.replicated(2))
    sums = acc[:, :-1]
    w = acc[:, -1:]
    return sums / bi.maximum(w, 1e-12)


def fuzzy_kmeans(points, k: int, num_iter: int = 10, m: float = 2.0,
                 seed: int = 0) -> np.ndarray:
    points = as_expr(points)
    n, d = points.shape
    rng = np.random.RandomState(seed)
    centers: Expr = as_expr(
        points[np.sort(rng.choice(n, k, replace=False))].glom())
    for _ in range(num_iter):
        centers = ValExpr(
            fuzzy_kmeans_step(points, centers, k, m).evaluate())
    return centers.glom()
