"""Multinomial naive Bayes (port of ``spartan_tpu/examples/naive_bayes.py``).

Fitting is one segment sum of feature counts by class plus one of class
sizes, in one ``map2`` with a replicated result, then log-prior and
log-likelihood tables on the host. Under ``FLAGS.native_kernels=on`` (or
``FLAGS.segment_impl=pallas``) the 2-D feature counts go through the
hand-written segment kernel; the 1-D class sizes are lifted to rows of
128 and fall back to the one-hot product, as in the JAX package.
Prediction is one table product per batch (``torch.matmul``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..array.distarray import from_numpy
from ..expr.base import Expr, as_expr
from ..expr.map2 import map2
from ..ops.segment import segment_count, segment_sum


def _fit_kern(n_classes: int):
    def kern(xv, yv):
        counts = segment_sum(xv, yv, n_classes)
        class_n = segment_count(yv, n_classes, dtype=xv.dtype)
        return torch.cat([counts, class_n[:, None]], dim=1)

    return kern


def fit(x, y, n_classes: int, alpha: float = 1.0
        ) -> Tuple[np.ndarray, np.ndarray]:
    """x: (n, d) nonnegative counts; y: (n,) int labels.
    Returns (log_prior (c,), log_likelihood (c, d))."""
    x, y = as_expr(x), as_expr(y)
    packed = map2([x, y], _fit_kern(n_classes),
                  out_tiling=tiling_mod.replicated(2)).glom()
    counts = packed[:, :-1]
    class_n = packed[:, -1]
    smoothed = counts + alpha
    log_lik = np.log(smoothed / smoothed.sum(axis=1, keepdims=True))
    log_prior = np.log(np.maximum(class_n, 1e-12) / class_n.sum())
    return log_prior.astype(np.float32), log_lik.astype(np.float32)


def _predict_kern(xv, pv, lv):
    # int32 class ids, the dtype of the JAX package's argmax
    return torch.argmax(xv @ lv.T + pv[None, :], dim=1).to(torch.int32)


def predict(x, log_prior: np.ndarray, log_lik: np.ndarray) -> Expr:
    x = as_expr(x)
    ep = from_numpy(log_prior, tiling=tiling_mod.replicated(1))
    el = from_numpy(log_lik, tiling=tiling_mod.replicated(2))
    return map2([x, ep, el], _predict_kern,
                out_tiling=tiling_mod.Tiling((x.out_tiling().axes[0],)))
