"""Linear SVM by primal sub-gradient descent (port of
``spartan_tpu/examples/svm.py``).

One step is one ``map2`` (the hinge-loss sub-gradient over the whole X,
y) and the update, evaluated each step as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..expr import builtins as bi
from ..expr.base import Expr, ValExpr, as_expr
from ..expr.map2 import map2

_REPL1 = tiling_mod.replicated(1)


def _svm_kern(xv, yv, wv, reg):
    margin = yv * (xv @ wv)
    active = (margin < 1.0).to(xv.dtype)
    g = -(xv.T @ (active * yv)) / xv.shape[0]
    return g + reg * wv


def svm_grad(x: Expr, y: Expr, w: Expr, reg: float) -> Expr:
    """y in {-1, +1}; sub-gradient of mean hinge loss + L2."""
    return map2([x, y, w], _svm_kern, fn_kw={"reg": reg}, out_tiling=_REPL1)


def svm(x, y, num_iter: int = 100, lr: float = 0.1, reg: float = 1e-3
        ) -> np.ndarray:
    x, y = as_expr(x), as_expr(y)
    w: Expr = bi.zeros((x.shape[1],), np.float32, tiling=_REPL1)
    for _ in range(num_iter):
        g = svm_grad(x, y, w, reg)
        w = ValExpr((w - lr * g).evaluate())
    return w.glom()


def _predict_kern(xv, wv):
    return torch.sign(xv @ wv)


def predict(x, w) -> Expr:
    x, w = as_expr(x), as_expr(w)
    return map2([x, w], _predict_kern,
                out_tiling=tiling_mod.Tiling((x.out_tiling().axes[0],)))
