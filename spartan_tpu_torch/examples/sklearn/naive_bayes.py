"""MultinomialNB estimator (port of
``spartan_tpu/examples/sklearn/naive_bayes.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...expr.base import as_expr
from ..naive_bayes import fit as nb_fit
from ..naive_bayes import predict as nb_predict


class MultinomialNB:
    def __init__(self, alpha: float = 1.0):
        self.alpha = alpha
        self.class_log_prior_: Optional[np.ndarray] = None
        self.feature_log_prob_: Optional[np.ndarray] = None

    def fit(self, x, y, n_classes: Optional[int] = None) -> "MultinomialNB":
        y_arr = np.asarray(as_expr(y).glom(), np.int32)
        if n_classes is None:
            n_classes = int(y_arr.max()) + 1
        self.class_log_prior_, self.feature_log_prob_ = nb_fit(
            as_expr(x), as_expr(y_arr), n_classes, self.alpha)
        return self

    def predict(self, x) -> np.ndarray:
        return nb_predict(as_expr(x), self.class_log_prior_,
                          self.feature_log_prob_).glom()
