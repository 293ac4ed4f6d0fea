"""Lanczos bidiagonalization SVD (port of
``spartan_tpu/examples/lanczos.py``).

The two products of a step (``A @ v`` and ``A.T @ u``) are ``st.dot``
on the array's device, the only O(mn) work; the O(k^2) recurrence
(reorthogonalization, the small SVD of B) stays on the host in numpy,
as in the JAX package. The products run in IEEE float32 (the package
turns TF32 off): the recurrence amplifies product rounding into loss
of orthogonality.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..expr.base import as_expr
from ..expr.dot import dot


def lanczos_bidiag(a, k: int, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """k-step Golub-Kahan bidiagonalization of A (m, n).

    Returns (U, B, V): U (m, k+1) and V (n, k) with orthonormal
    columns (full reorthogonalization) and B (k+1, k) lower-bidiagonal
    with A @ V ~= U @ B.
    """
    a = as_expr(a)
    m, n = a.shape
    k = min(k, min(m, n))
    rng = np.random.RandomState(seed)
    u = rng.randn(m).astype(np.float32)
    u /= np.linalg.norm(u)
    us = [u]
    vs = []
    alphas = []
    betas = []
    for j in range(k):
        # v_j = A^T u_j - beta_{j-1} v_{j-1}, reorthogonalized
        v = np.array(dot(a.T, as_expr(us[-1]), precision="highest").glom())
        for prev in vs:  # full reorth (k is small)
            v -= prev * float(prev @ v)
        alpha = float(np.linalg.norm(v))
        if alpha < 1e-12:
            break
        v /= alpha
        vs.append(v)
        alphas.append(alpha)
        # u_{j+1} = A v_j - alpha_j u_j, reorthogonalized
        u = np.array(dot(a, as_expr(v), precision="highest").glom())
        for prev in us:
            u -= prev * float(prev @ u)
        beta = float(np.linalg.norm(u))
        if beta < 1e-12:
            betas.append(0.0)
            break
        u /= beta
        us.append(u)
        betas.append(beta)
    if not vs:
        raise ValueError(
            "Lanczos breakdown at step 0: A^T u is (numerically) zero "
            "— the matrix has no Krylov direction (all-zero input?)")
    k_eff = len(alphas)
    B = np.zeros((len(us), k_eff), np.float32)
    for j in range(k_eff):
        B[j, j] = alphas[j]
        if j + 1 < len(us):
            B[j + 1, j] = betas[j]
    return (np.stack(us, axis=1).astype(np.float32), B,
            np.stack(vs, axis=1).astype(np.float32))


def lanczos_svd(a, rank: int, extra: int = 6, seed: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Top-``rank`` singular triplets via ``rank + extra`` Lanczos
    steps and the small SVD of the bidiagonal B."""
    a = as_expr(a)
    U, B, V = lanczos_bidiag(a, rank + extra, seed=seed)
    ub, s, vbt = np.linalg.svd(B, full_matrices=False)
    r = min(rank, s.size)
    return ((U @ ub[:, :r]).astype(np.float32), s[:r].astype(np.float32),
            (V @ vbt.T[:, :r]).astype(np.float32))
