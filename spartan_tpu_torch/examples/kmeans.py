"""k-means clustering (port of ``spartan_tpu/examples/kmeans.py``).

One iteration, ``kmeans_step``, takes one of two forms:

* the fused pass (``ops/kmeans.py``, a :class:`KMeansStepExpr` node):
  whenever the kernel registry's constraints hold, one launch of the
  hand-written CUDA kernel (its plain torch version for CPU tensors)
  plus the division;
* the expr path: a ``map2`` (distances, argmin, segment sums and
  counts) feeding a map (the division).

``kmeans`` runs all iterations as one ``st.loop`` over it, with no host
sync between iterations, and so does a user's own ``st.loop`` —
checkpointed or not. The JAX package's ``kmeans`` calls its kernel's
``run`` directly and its ``kmeans_step`` is always the map2 form.

The two round differently: the expr path includes ``|p|^2`` in the
distances, the kernel drops it. Each is tested against its own JAX
counterpart.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..array.distarray import DistArray
from ..array.tiling import Tiling
from ..expr import builtins as bi
from ..expr.base import Expr, ValExpr, as_expr
from ..expr.loop import loop
from ..expr.map2 import map2, shard_map2
from ..ops import kmeans as kmeans_kernel
from ..parallel import mesh as mesh_mod


def _assign_and_accumulate(k: int):
    """Kernel: points (n, d), centers (k, d) -> (k, d+1) [sums | counts].

    ``jax.ops.segment_sum`` becomes ``index_add_``; both run on ``meta``
    tensors, so shape inference needs no data."""

    def kern(points, centers):
        d2 = ((points * points).sum(1, keepdim=True)
              - 2.0 * (points @ centers.T)
              + (centers * centers).sum(1)[None, :])
        assign = torch.argmin(d2, dim=1)
        sums = torch.zeros((k, points.shape[1]), dtype=points.dtype,
                           device=points.device).index_add_(0, assign, points)
        counts = torch.zeros((k,), dtype=points.dtype,
                             device=points.device).index_add_(
            0, assign, torch.ones((points.shape[0],), dtype=points.dtype,
                                  device=points.device))
        return torch.cat([sums, counts[:, None]], dim=1)

    return kern


class KMeansStepExpr(Expr):
    """One k-means update through the fused pass: the CUDA kernel for
    CUDA tensors, its plain version for CPU tensors (``ops/kmeans.py``).
    An empty cluster becomes the zero vector, as in the map2 form."""

    def __init__(self, points: Expr, centers: Expr, k: int):
        self.points = points
        self.centers = centers
        self.k = int(k)
        super().__init__(centers.shape, np.float32)

    def children(self) -> Tuple[Expr, ...]:
        return (self.points, self.centers)

    def replace_children(self, new_children) -> "KMeansStepExpr":
        return KMeansStepExpr(new_children[0], new_children[1], self.k)

    def _lower(self, env: Dict[int, Any]) -> Any:
        return kmeans_kernel.step(self.points.lower(env),
                                  self.centers.lower(env), self.k)

    def _lower_local(self, env) -> Any:
        """On a group mesh: the pass on each rank's stored row block and
        an all-reduce of the sums and counts (one launch a rank)."""
        from ..kernels import kmeans as kk

        c = self.centers.lower_local(env).retile(tiling_mod.replicated(2))
        sums, cnt = kk.assign_accumulate_local(
            self.points.lower_local(env), c.local, self.k)
        new = sums / torch.clamp_min(cnt, 1.0)[:, None]
        return DistArray.from_local(new, tiling_mod.replicated(2),
                                    self.shape, env.mesh)

    def _sig(self, ctx) -> Tuple:
        return ("kmeans_step", self.k, ctx.of(self.points),
                ctx.of(self.centers))

    def cost(self) -> Dict[str, float]:
        """The fused pass's own count (``kernels/kmeans.cost``, under
        ``kernel``) plus the division: k·d FLOPs reading the (k, d) sums
        and (k,) counts and writing the (k, d) centers."""
        n, d = self.points.shape
        k = self.k
        kf, kb = kmeans_kernel.cost(n, d, k)
        return {"flops": kf + float(k * d), "transcendentals": 0.0,
                "bytes accessed": kb + 4.0 * (2 * k * d + k),
                "kernel": {"name": "kmeans_assign_accumulate",
                           "flops": kf, "bytes accessed": kb}}

    def _default_tiling(self) -> Tiling:
        return tiling_mod.replicated(2)


def kmeans_step(points: Expr, centers: Expr, k: int) -> Expr:
    """One iteration: returns the new (k, d) centers as a lazy expr (the
    fused pass where the registry selects it, else the map2 form)."""
    points, centers = as_expr(points), as_expr(centers)
    n, d = points.shape
    if (points.dtype == np.float32 and centers.dtype == np.float32
            and _kernel_supports(n, d, k)):
        return KMeansStepExpr(points, centers, k)
    acc = map2([points, centers], _assign_and_accumulate(k),
               out_tiling=tiling_mod.replicated(2))
    sums = acc[:, :-1]
    counts = acc[:, -1:]
    return sums / bi.maximum(counts, 1.0)


def _assign_kern(p, c):
    d2 = ((p * p).sum(1, keepdim=True) - 2.0 * (p @ c.T)
          + (c * c).sum(1)[None, :])
    return torch.argmin(d2, dim=1).to(torch.int32)


def assign_points(points: Expr, centers: Expr) -> Expr:
    """Cluster id (int32) per point. On a group mesh whose row axis
    divides the points, the per-row kernel runs on each rank's row
    block (``shard_map2``) instead of on the whole points."""
    group = mesh_mod.ambient_group()
    n = points.shape[0]
    if group is not None and n % group.shape[tiling_mod.AXIS_ROW] == 0:
        return shard_map2([points, centers], _assign_kern,
                          (tiling_mod.row(2), tiling_mod.replicated(2)),
                          tiling_mod.row(1), (n,), np.int32)
    return map2([points, centers], _assign_kern,
                out_tiling=tiling_mod.Tiling((points.out_tiling().axes[0],)))


def _kernel_pad(n: int) -> int:
    """Pad rows so every logical row shard holds whole 1024-point
    blocks, as the JAX package's k-means does."""
    p = max(int(mesh_mod.get_mesh().shape.get(tiling_mod.AXIS_ROW, 1)), 1)
    q = p * kmeans_kernel._BLOCK
    return -(-n // q) * q


def _kernel_supports(n: int, d: int, k: int) -> bool:
    return kmeans_kernel.supports(_kernel_pad(n), d, k)


def kmeans(points, k: int, num_iter: int = 10,
           centers: Union[None, np.ndarray, DistArray, Expr] = None,
           seed: int = 0,
           fused: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """The whole k-means loop; returns the final (k, d) centers and the int32
    assignment of every point, both on the host.

    ``fused`` (default) runs all iterations as one ``st.loop`` over
    :func:`kmeans_step`. ``fused=False`` evaluates one step per Python
    iteration; each step after the first hits the plan cache."""
    points = as_expr(points)
    n, d = points.shape
    if centers is None:
        rng = np.random.RandomState(seed)
        idx = rng.choice(n, size=k, replace=False)
        first = points[np.sort(idx)].glom()
        centers_e: Expr = as_expr(first)
    elif isinstance(centers, (DistArray, Expr)):
        centers_e = as_expr(centers)  # e.g. from_reference() state
    else:
        centers_e = as_expr(np.asarray(centers, np.float32))
    if fused:
        centers_e = ValExpr(loop(
            num_iter, lambda c: kmeans_step(points, c, k),
            centers_e).evaluate())
    else:
        for _ in range(num_iter):
            centers_e = kmeans_step(points, centers_e, k)
            # force so the next iteration starts from a Val leaf (the
            # collapse-cached pass keeps the DAG constant-size)
            centers_e = ValExpr(centers_e.evaluate())
    final = centers_e.glom()
    assign = assign_points(points, centers_e).glom()
    return final, assign
