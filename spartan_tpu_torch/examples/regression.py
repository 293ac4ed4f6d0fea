"""Linear / ridge / logistic regression (port of
``spartan_tpu/examples/regression.py``; config 4 of BASELINE.json).

One SGD step is one ``map2`` over the whole X, y: ``X @ w``, the error,
``X.T @ err`` (two cuBLAS products, TF32 off), and the update. With
``fused`` (the default) all steps run as one ``st.loop`` evaluation, with
no host sync between steps, as the JAX package runs one ``fori_loop``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..expr import builtins as bi
from ..expr.base import Expr, ValExpr, as_expr
from ..expr.loop import loop
from ..expr.map2 import map2

_REPL1 = tiling_mod.replicated(1)


def _linear_kern(xv, yv, wv):
    err = xv @ wv - yv
    return xv.T @ err / xv.shape[0]


def _logistic_kern(xv, yv, wv):
    p = torch.sigmoid(xv @ wv)
    return xv.T @ (p - yv) / xv.shape[0]


def linear_grad(x: Expr, y: Expr, w: Expr) -> Expr:
    """d/dw of 0.5*||Xw - y||^2 / n  (lazy)."""
    return map2([x, y, w], _linear_kern, out_tiling=_REPL1)


def logistic_grad(x: Expr, y: Expr, w: Expr) -> Expr:
    """Gradient of mean logistic loss, y in {0,1}."""
    return map2([x, y, w], _logistic_kern, out_tiling=_REPL1)


def _fit(step, n_features: int, num_iter: int, fused: bool) -> np.ndarray:
    w: Expr = bi.zeros((n_features,), np.float32, tiling=_REPL1)
    if fused:
        return loop(num_iter, step, w).glom()
    for _ in range(num_iter):
        w = ValExpr(step(w).evaluate())
    return w.glom()


def linear_regression(x, y, num_iter: int = 10, lr: float = 1e-2,
                      ridge: float = 0.0, fused: bool = True) -> np.ndarray:
    x, y = as_expr(x), as_expr(y)

    def step(w: Expr) -> Expr:
        g = linear_grad(x, y, w)
        if ridge:
            g = g + ridge * w
        return w - lr * g

    return _fit(step, x.shape[1], num_iter, fused)


def ridge_regression(x, y, num_iter: int = 10, lr: float = 1e-2,
                     alpha: float = 1.0) -> np.ndarray:
    return linear_regression(x, y, num_iter, lr, ridge=alpha)


def logistic_regression(x, y, num_iter: int = 10, lr: float = 1e-1,
                        fused: bool = True) -> np.ndarray:
    x, y = as_expr(x), as_expr(y)
    return _fit(lambda w: w - lr * logistic_grad(x, y, w), x.shape[1],
                num_iter, fused)


def _predict_kern(xv, wv):
    return torch.sigmoid(xv @ wv)


def predict_logistic(x, w) -> Expr:
    x, w = as_expr(x), as_expr(w)
    return map2([x, w], _predict_kern,
                out_tiling=tiling_mod.Tiling((x.out_tiling().axes[0],)))
