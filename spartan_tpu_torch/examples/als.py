"""Alternating least squares matrix factorization (port of
``spartan_tpu/examples/als.py``).

R (users x items) ~= U @ V^T. Each half-step solves every row's k x k
normal equations in one batched program inside a ``map2``: the JAX
package's ``vmap`` over rows becomes an (m, k, k) stack of normal
matrices and one batched ``torch.linalg.solve``. The stack is built
through an (m, n, k) masked copy of the other factor, so a half-step
holds m·n·k·4 bytes beside its inputs (101.6 MB at MovieLens-100K's
943 x 1,682 with k = 16). On a group mesh each rank solves its own
rows' systems (``expr/partition.py``): the transposed ratings are laid
out by their own rows once, so no half-step moves the ratings.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..array import distarray as da
from ..array import tiling as tiling_mod
from ..expr.base import as_expr
from ..expr.map2 import map2


def _solve_side(r, other, reg):
    """For each row i of r: solve (O^T W_i O + reg I) f_i = O^T W_i r_i
    where W_i masks observed entries (r != 0)."""
    w = (r != 0).to(r.dtype)  # (m, n)
    wo = w[:, :, None] * other[None, :, :]  # (m, n, k)
    a = wo.transpose(1, 2) @ other  # (m, k, k)
    a = a + reg * torch.eye(other.shape[1], dtype=r.dtype, device=r.device)
    b = (w * r) @ other  # (m, k)
    return torch.linalg.solve(a, b)


def als(ratings, k: int = 8, num_iter: int = 10, reg: float = 0.1,
        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Factor a (possibly zero-masked) ratings matrix; zeros = missing."""
    ratings = as_expr(ratings)
    m, n = ratings.shape
    rng = np.random.RandomState(seed)
    v = rng.rand(n, k).astype(np.float32) * 0.1

    r_rows = ratings  # (m, n)
    # the transpose (n, m), once, split along its own rows: the item
    # half-steps read their row blocks where they are held
    r_cols = ratings.T.evaluate().retile(tiling_mod.row(2))

    u = None
    for _ in range(num_iter):
        ev = da.from_numpy(v, tiling=tiling_mod.replicated(2))
        u = map2([r_rows, ev], _solve_side, fn_kw={"reg": reg},
                 out_tiling=tiling_mod.row(2)).glom()
        eu = da.from_numpy(u, tiling=tiling_mod.replicated(2))
        v = map2([r_cols, eu], _solve_side, fn_kw={"reg": reg},
                 out_tiling=tiling_mod.row(2)).glom()
    return u, v
