"""Streaming state (port of ``spartan_tpu/examples/streaming.py``).

Each class keeps its state in DistArray handles and applies new data
through ``DistArray.update`` (a functional region write), so the
per-step DAGs keep their structure and hit the plan cache. Their results
equal a full recompute: the JAX package's incremental engine, which
would recompute only what a batch dirtied, is not ported yet (ROADMAP).
The ``*_async`` entry points (``step_async``, ``stats_async``) submit
through ``serve/`` (``evaluate_async``: admission control, coalescing,
flight recording).

* :class:`IncrementalPageRank`: dense-transition PageRank over column
  (in-link) batches, with a damped correction against a fixed base
  vector and a periodic rebase through ``st.loop``;
* :class:`OnlineKMeans`: mini-batch k-means (``partial_fit``, a plain
  torch map2) and full Lloyd refinement through ``st.loop`` over
  ``examples/kmeans.kmeans_step``, which launches the fused k-means
  kernel once per iteration where the registry selects it;
* :class:`SlidingWindowStats`: per-feature mean/std over a ring-buffer
  window.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..array import distarray as da_mod
from ..array import tiling as tiling_mod
from ..array.distarray import DistArray
from ..expr import base as expr_base
from ..expr.base import Expr, lazify


def _dist(x: Any) -> DistArray:
    if isinstance(x, DistArray):
        return x
    if isinstance(x, Expr):
        return x.evaluate()
    if isinstance(x, torch.Tensor):
        return da_mod.from_tensor(x)
    return da_mod.from_numpy(np.asarray(x))


class IncrementalPageRank:
    """Dense-transition PageRank over edge-insert batches.

    ``A`` (n, n) holds in ``A[i, j]`` the probability of moving from
    page i to page j, so ``r @ A`` is one power step.
    ``insert_edges(cols, values)`` replaces pages' in-link columns
    through ``DistArray.update``; ``step()``
    evaluates one damped correction ``r' = d * (r0 @ A) + (1 - d) / n``
    against the fixed base ``r0``; every ``rebase_every`` batches (or on
    ``rebase()``) the estimate is folded into a new base by full power
    iterations.
    """

    def __init__(self, transition: Any, damping: float = 0.85,
                 rebase_every: int = 8):
        self.A = _dist(transition)
        n = self.A.shape[0]
        if self.A.shape != (n, n):
            raise ValueError(f"transition must be square, got "
                             f"{self.A.shape}")
        self.n = n
        self.damping = float(damping)
        self.rebase_every = int(rebase_every)
        self._base = da_mod.from_tensor(torch.full(
            (n,), 1.0 / n, dtype=self.A.tensor.dtype,
            device=self.A.device), mesh=self.A.mesh)
        self.ranks: DistArray = self._base
        self._batches_since_rebase = 0

    def _step_expr(self):
        from ..expr.dot import DotExpr

        prod = DotExpr(lazify(self._base), lazify(self.A))
        return prod * self.damping + (1.0 - self.damping) / self.n

    def step_async(self, tenant: Optional[str] = None):
        """The serve/ route: submit the correction step to the
        concurrent engine (admission, flight recording); returns its
        ``EvalFuture``."""
        return self._step_expr().evaluate_async(tenant=tenant)

    def insert_edges(self, cols: slice, values: Any) -> None:
        """Replace the in-link columns ``A[:, cols]``: one region
        write."""
        self.A = self.A.update((slice(0, self.n), cols), values)
        self._batches_since_rebase += 1

    def step(self) -> DistArray:
        """One damped correction against the fixed base vector; rebases
        first when the window is up."""
        if self._batches_since_rebase >= self.rebase_every:
            self.rebase()
        self.ranks = expr_base.evaluate(self._step_expr())
        return self.ranks

    def rebase(self, iters: int = 4) -> DistArray:
        """Fold the current estimate into a new base with ``iters`` full
        power iterations, one ``st.loop`` evaluation."""
        from ..expr.loop import loop as st_loop

        A = lazify(self.A)
        d, n = self.damping, self.n
        out = st_loop(iters, lambda r: r.dot(A) * d + (1.0 - d) / n,
                      lazify(self.ranks))
        self._base = expr_base.evaluate(out)
        self.ranks = self._base
        self._batches_since_rebase = 0
        return self._base


def _minibatch_kernel(k: int):
    """points (b, d), centers (k, d), counts (k,) -> (k, d + 1): the moved
    centers beside the new per-center counts (Sculley's per-center
    learning rate 1 / count)."""

    def kern(points, centers, counts):
        d2 = ((points * points).sum(1, keepdim=True)
              - 2.0 * (points @ centers.T)
              + (centers * centers).sum(1)[None, :])
        assign = torch.argmin(d2, dim=1)
        sums = torch.zeros_like(centers).index_add_(0, assign, points)
        cnt = torch.zeros_like(counts).index_add_(
            0, assign, torch.ones((points.shape[0],), dtype=points.dtype,
                                  device=points.device))
        new_counts = counts + cnt
        lr = (cnt / new_counts)[:, None]
        mean = sums / torch.clamp_min(cnt, 1.0)[:, None]
        moved = torch.where(cnt[:, None] > 0,
                            centers * (1.0 - lr) + mean * lr, centers)
        return torch.cat([moved, new_counts[:, None]], dim=1)

    return kern


class OnlineKMeans:
    """Mini-batch k-means over streaming batches.

    ``partial_fit(batch)`` assigns the batch to the current centers and
    moves each center toward its batch mean with the learning rate
    1/count, one plan-cached evaluation per batch. ``refine`` runs full
    Lloyd iterations over a point set through ``st.loop``.
    """

    def __init__(self, centers: Any):
        self.centers = _dist(centers)
        self.k, self.d = self.centers.shape
        self._counts = da_mod.from_tensor(torch.ones(
            (self.k,), dtype=self.centers.tensor.dtype,
            device=self.centers.device), mesh=self.centers.mesh)

    def partial_fit(self, batch: Any) -> DistArray:
        from ..expr.map2 import map2

        pts = _dist(batch)
        packed = expr_base.evaluate(map2(
            [lazify(pts), lazify(self.centers), lazify(self._counts)],
            _minibatch_kernel(self.k),
            out_tiling=tiling_mod.replicated(2))).tensor
        self.centers = da_mod.from_tensor(packed[:, :-1].contiguous(),
                                          mesh=self.centers.mesh)
        self._counts = da_mod.from_tensor(packed[:, -1].contiguous(),
                                          mesh=self.centers.mesh)
        return self.centers

    def refine(self, points: Any, iters: int = 5) -> DistArray:
        """Full Lloyd iterations over ``points`` as one ``st.loop``."""
        from ..expr.loop import loop as st_loop
        from .kmeans import kmeans_step

        pts = lazify(_dist(points))
        out = st_loop(iters, lambda c: kmeans_step(pts, c, self.k),
                      lazify(self.centers))
        self.centers = expr_base.evaluate(out)
        return self.centers


class SlidingWindowStats:
    """Per-feature mean/std over a ring-buffer window (w, d).

    ``push(rows)`` overwrites the oldest slots through
    ``DistArray.update``; ``stats()`` reduces the window.
    """

    def __init__(self, window: int, dim: int, dtype: Any = np.float32,
                 device=None):
        self.window = int(window)
        self.dim = int(dim)
        self.buf = da_mod.zeros((self.window, self.dim), dtype,
                                device=device)
        self._head = 0
        self._filled = 0

    def push(self, rows: Any) -> None:
        if isinstance(rows, torch.Tensor):
            rows = rows.to(self.buf.device)
        else:
            rows = np.asarray(rows, self.buf.dtype)
        if rows.ndim == 1:
            rows = rows[None, :]
        r = 0
        while r < len(rows):
            take = min(len(rows) - r, self.window - self._head)
            self.buf = self.buf.update(
                (slice(self._head, self._head + take), slice(0, self.dim)),
                rows[r:r + take])
            self._head = (self._head + take) % self.window
            r += take
        self._filled = min(self.window, self._filled + len(rows))

    def stats(self) -> Tuple[DistArray, DistArray]:
        """(mean, std) per feature over the window."""
        x = lazify(self.buf)
        mean = expr_base.evaluate(x.mean(axis=0))
        var = expr_base.evaluate(((x - lazify(mean)) ** 2).mean(axis=0))
        std = expr_base.evaluate(lazify(var) ** 0.5)
        return mean, std

    def stats_async(self, tenant: Optional[str] = None):
        """serve/ route for read-heavy monitors: the mean through the
        concurrent engine (identical concurrent readers coalesce)."""
        return lazify(self.buf).mean(axis=0).evaluate_async(tenant=tenant)

    def normalized(self, mean: DistArray, std: DistArray) -> DistArray:
        """(window - mean) / std, elementwise over the window."""
        x = lazify(self.buf)
        return expr_base.evaluate(
            (x - lazify(mean)) / (lazify(std) + 1e-12))
