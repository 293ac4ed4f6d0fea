"""Linear estimators (port of
``spartan_tpu/examples/sklearn/linear_model.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...expr.base import as_expr
from ..regression import (linear_regression, logistic_regression,
                          predict_logistic, ridge_regression)
from ..svm import predict as svm_predict
from ..svm import svm


class LinearRegression:
    def __init__(self, max_iter: int = 100, lr: float = 1e-2):
        self.max_iter = max_iter
        self.lr = lr
        self.coef_: Optional[np.ndarray] = None

    def fit(self, x, y) -> "LinearRegression":
        self.coef_ = linear_regression(as_expr(x), as_expr(y),
                                       num_iter=self.max_iter, lr=self.lr)
        return self

    def predict(self, x) -> np.ndarray:
        return as_expr(x).dot(as_expr(self.coef_)).glom()


class Ridge(LinearRegression):
    def __init__(self, alpha: float = 1.0, max_iter: int = 100,
                 lr: float = 1e-2):
        super().__init__(max_iter, lr)
        self.alpha = alpha

    def fit(self, x, y) -> "Ridge":
        self.coef_ = ridge_regression(as_expr(x), as_expr(y),
                                      num_iter=self.max_iter, lr=self.lr,
                                      alpha=self.alpha)
        return self


class LogisticRegression:
    def __init__(self, max_iter: int = 100, lr: float = 0.1):
        self.max_iter = max_iter
        self.lr = lr
        self.coef_: Optional[np.ndarray] = None

    def fit(self, x, y) -> "LogisticRegression":
        self.coef_ = logistic_regression(as_expr(x), as_expr(y),
                                         num_iter=self.max_iter,
                                         lr=self.lr)
        return self

    def predict_proba(self, x) -> np.ndarray:
        return predict_logistic(as_expr(x), as_expr(self.coef_)).glom()

    def predict(self, x) -> np.ndarray:
        return (self.predict_proba(x) > 0.5).astype(np.int32)


class SGDSVC:
    """Linear SVM via primal sub-gradient descent."""

    def __init__(self, max_iter: int = 100, lr: float = 0.1,
                 reg: float = 1e-3):
        self.max_iter = max_iter
        self.lr = lr
        self.reg = reg
        self.coef_: Optional[np.ndarray] = None

    def fit(self, x, y) -> "SGDSVC":
        self.coef_ = svm(as_expr(x), as_expr(y), num_iter=self.max_iter,
                         lr=self.lr, reg=self.reg)
        return self

    def predict(self, x) -> np.ndarray:
        return svm_predict(as_expr(x), as_expr(self.coef_)).glom()
