"""Model zoo: the framework's estimator-level surface (port of
``spartan_tpu/models``).

The framework's "models" are its application algorithms
(``examples/`` and ``examples/sklearn/``); this namespace collects them
as the stable, importable model API, with the JAX package's names and
``__all__``:

    from spartan_tpu_torch.models import KMeans, LogisticRegression
    from spartan_tpu_torch.models import pagerank, ssvd, als

Estimators follow the sklearn fit/predict convention; functional
algorithms (pagerank, ssvd, lanczos SVD, als, cg, matrix factorization,
decompositions, lda, lsh) are re-exported directly.
"""

from ..examples.als import als  # noqa: F401
from ..examples.conj_gradient import conj_gradient as conjugate_gradient  # noqa: F401,E501
from ..examples.decomposition import (cholesky,  # noqa: F401
                                      netflix_sgd, qr, tsqr)
from ..examples.fuzzy_kmeans import fuzzy_kmeans  # noqa: F401
from ..examples.kmeans import assign_points, kmeans  # noqa: F401
from ..examples.lanczos import lanczos_svd  # noqa: F401
from ..examples.lda import lda  # noqa: F401
from ..examples.lsh import candidate_pairs as lsh_candidate_pairs  # noqa: F401,E501
from ..examples.matrix_fact import sgd_matrix_factorization  # noqa: F401
from ..examples.naive_bayes import fit as fit_naive_bayes  # noqa: F401
from ..examples.pagerank import pagerank  # noqa: F401
from ..examples.regression import (linear_regression,  # noqa: F401
                                   logistic_regression, ridge_regression)
from ..examples.sklearn.cluster import KMeans  # noqa: F401
from ..examples.sklearn.linear_model import (LinearRegression,  # noqa: F401
                                             LogisticRegression, Ridge,
                                             SGDSVC)
from ..examples.sklearn.naive_bayes import MultinomialNB  # noqa: F401
from ..examples.ssvd import ssvd  # noqa: F401
from ..examples.svm import svm as svm_fit  # noqa: F401

__all__ = [
    "als", "conjugate_gradient", "cholesky", "qr", "tsqr", "netflix_sgd",
    "fuzzy_kmeans", "kmeans", "assign_points", "lanczos_svd", "lda",
    "lsh_candidate_pairs",
    "sgd_matrix_factorization", "fit_naive_bayes", "pagerank",
    "linear_regression", "logistic_regression", "ridge_regression",
    "ssvd", "svm_fit",
    "KMeans", "LinearRegression", "LogisticRegression", "Ridge",
    "SGDSVC", "MultinomialNB",
]
