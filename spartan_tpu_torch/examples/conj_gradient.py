"""Conjugate gradient solver (port of
``spartan_tpu/examples/conj_gradient.py``).

Each step is a handful of lazy exprs (one product, axpys, two inner
products), evaluated per step; the two inner products come to the host
as Python floats, as in the JAX package, and every step after the
first hits the plan cache.
"""

from __future__ import annotations

import numpy as np

from ..expr import builtins as bi
from ..expr.base import ValExpr, as_expr
from ..expr.dot import dot


def conj_gradient(a, b, num_iter: int = 20, tol: float = 1e-6
                  ) -> np.ndarray:
    """Solve A x = b for SPD A."""
    a = as_expr(a)
    b = as_expr(b)
    n = b.shape[0]
    x = bi.zeros((n,), np.float32)
    r = ValExpr((b - dot(a, x)).evaluate())
    p = r
    rs_old = float((r * r).sum().glom())
    for _ in range(num_iter):
        ap = dot(a, p)
        denom = float((p * ap).sum().glom())
        if abs(denom) < 1e-30:
            break
        alpha = rs_old / denom
        x = ValExpr((x + alpha * p).evaluate())
        r = ValExpr((r - alpha * ap).evaluate())
        rs_new = float((r * r).sum().glom())
        if np.sqrt(rs_new) < tol:
            break
        p = ValExpr((r + (rs_new / rs_old) * p).evaluate())
        rs_old = rs_new
    return x.glom()
