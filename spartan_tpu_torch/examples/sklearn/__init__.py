"""sklearn-style estimator wrappers (port of
``spartan_tpu/examples/sklearn/``).

Thin fit/predict classes over the examples; inputs may be NumPy
arrays, DistArrays or exprs.
"""

from .cluster import KMeans
from .linear_model import LinearRegression, LogisticRegression, Ridge, SGDSVC
from .naive_bayes import MultinomialNB

__all__ = ["KMeans", "LinearRegression", "LogisticRegression", "Ridge",
           "SGDSVC", "MultinomialNB"]
