"""Topic modelling by EM (port of ``spartan_tpu/examples/lda.py``).

Multinomial-mixture / pLSI-style EM with Dirichlet pseudocount
smoothing. The (D, W, K) responsibility tensor is never materialized:
each topic's (D, W) responsibility slice is a lazy expr chain whose two
reductions evaluate in one plan (``tuple_of``), as in the JAX package;
the (D, k) and (k, W) factors are renormalized on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..expr import builtins as bi
from ..expr.base import ValExpr, as_expr, tuple_of
from ..expr.dot import dot


def lda(counts, k: int, num_iter: int = 30, alpha: float = 0.1,
        beta: float = 0.01, seed: int = 0
        ) -> Tuple[np.ndarray, np.ndarray]:
    """Fit a k-topic model to a (D, W) document-term count matrix.

    Returns (theta, phi): theta (D, k) per-document topic mixtures and
    phi (k, W) topic-word distributions, both row-normalized.
    """
    counts = as_expr(counts)
    d, w = counts.shape
    rng = np.random.RandomState(seed)
    theta = rng.rand(d, k).astype(np.float32) + 0.5
    theta /= theta.sum(axis=1, keepdims=True)
    phi = rng.rand(k, w).astype(np.float32) + 0.5
    phi /= phi.sum(axis=1, keepdims=True)

    for _ in range(num_iter):
        theta_e = as_expr(theta)
        phi_e = as_expr(phi)
        # denom[d, w] = sum_k theta[d, k] phi[k, w]
        denom = ValExpr(dot(theta_e, phi_e).evaluate())
        new_theta = np.empty_like(theta)
        new_phi = np.empty_like(phi)
        for t in range(k):
            # responsibility slice r_t = C * (theta_t phi_t) / denom;
            # both reductions evaluate as one plan
            outer_t = bi.outer_product(theta_e[:, t], phi_e[t, :])
            r_t = counts * outer_t / bi.maximum(denom, 1e-30)
            phi_row, theta_col = tuple_of(
                r_t.sum(axis=0), r_t.sum(axis=1)).evaluate()
            new_phi[t, :] = np.asarray(phi_row.glom())
            new_theta[:, t] = np.asarray(theta_col.glom())
        theta = new_theta + alpha
        theta /= theta.sum(axis=1, keepdims=True)
        phi = new_phi + beta
        phi /= phi.sum(axis=1, keepdims=True)
    return theta, phi


def log_likelihood(counts, theta: np.ndarray, phi: np.ndarray) -> float:
    """Observed-data log likelihood sum_dw C[d,w] log(theta phi)[d,w]."""
    counts = as_expr(counts)
    mix = dot(as_expr(theta), as_expr(phi))
    ll = (counts * bi.log(bi.maximum(mix, 1e-30))).sum()
    return float(ll.glom())
