"""KMeans estimator (port of ``spartan_tpu/examples/sklearn/cluster.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...expr.base import as_expr
from ..kmeans import assign_points, kmeans


class KMeans:
    def __init__(self, n_clusters: int = 8, max_iter: int = 10,
                 random_state: int = 0):
        self.n_clusters = n_clusters
        self.max_iter = max_iter
        self.random_state = random_state
        self.cluster_centers_: Optional[np.ndarray] = None
        self.labels_: Optional[np.ndarray] = None

    def fit(self, x) -> "KMeans":
        centers, labels = kmeans(as_expr(x), self.n_clusters,
                                 num_iter=self.max_iter,
                                 seed=self.random_state)
        self.cluster_centers_ = centers
        self.labels_ = labels
        return self

    def predict(self, x) -> np.ndarray:
        if self.cluster_centers_ is None:
            raise RuntimeError("call fit first")
        return assign_points(as_expr(x),
                             as_expr(self.cluster_centers_)).glom()

    def fit_predict(self, x) -> np.ndarray:
        return self.fit(x).labels_
