"""Fused k-means pass entry points (port of ``spartan_tpu/ops/kmeans.py``):
the applications import ``supports`` / ``assign_accumulate`` / ``step`` /
``run`` from here; the kernel lives in ``kernels/kmeans.py``."""

from __future__ import annotations

from ..kernels.kmeans import (_BLOCK, assign_accumulate,
                              assign_accumulate_plain, cost, run, step,
                              supports)

__all__ = ["supports", "assign_accumulate", "assign_accumulate_plain",
           "step", "run", "cost", "_BLOCK"]
