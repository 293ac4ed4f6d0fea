"""Sparse PageRank (port of ``spartan_tpu/examples/pagerank.py``; config 5
of BASELINE.json).

``rank = d * T @ rank + (1 - d) / n`` plus the dangling-mass correction,
where ``T`` is the column-stochastic transition of the link matrix. With
no convergence test (``tol == 0``) and the windowed path available, the
whole power iteration is ``num_iter`` windowed SpMVs (a gather, the
hand-written windowed kernel, the teleport) launched back to back on the
device with no host sync, as the JAX package runs it in one
``fori_loop``. Otherwise each iteration is one ``spmv`` plus the
teleport.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..array.sparse import SparseDistArray


def _teleport_body(y: torch.Tensor, damping: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Teleport and dangling-mass correction, in f32 like the JAX
    package's (``damping`` is a 0-d f32 tensor)."""
    new = damping * y + (1.0 - damping) / n
    dangling = 1.0 - new.sum()
    return new + dangling / n


def pagerank(links: SparseDistArray, damping: float = 0.85,
             num_iter: int = 20, tol: float = 0.0,
             transition: Optional[SparseDistArray] = None) -> np.ndarray:
    """links[i, j] != 0 means page i links to page j. Returns the ranks
    on the host.

    ``transition`` takes a precomputed column-stochastic matrix; by
    default ``links.transition()`` builds it once and caches it on
    ``links`` (see SparseDistArray.clear_cache)."""
    n = links.shape[0]
    T = transition if transition is not None else links.transition()
    dev = T.device
    rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    damp = torch.tensor(damping, dtype=torch.float32, device=dev)
    if tol == 0 and T._default_windowed():
        for _ in range(int(num_iter)):
            rank = _teleport_body(T.spmv_traced(rank), damp, n)
        return rank.cpu().numpy()
    for _ in range(int(num_iter)):
        new = _teleport_body(T.spmv(rank), damp, n)
        if tol > 0:
            # the convergence test costs one host fetch per iteration
            delta = float((new - rank).abs().sum())
            rank = new
            if delta < tol:
                break
        else:
            rank = new
    return rank.cpu().numpy()
