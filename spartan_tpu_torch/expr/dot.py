"""Matrix product (port of ``DotExpr`` in ``spartan_tpu/expr/dot.py``).

The JAX package leaves the dense product to XLA; here it is
``torch.matmul`` (cuBLAS on the card). The package turns TF32 off at
import (see ``spartan_tpu_torch/__init__.py``), so a float32 product is
IEEE float32 whatever ``precision`` says — the JAX package's
``precision="highest"``. ``precision`` stays in the signature for API
parity. The explicit per-tile form (``DotShardMapExpr``) waits for the
multi-GPU slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from ..utils import dtypes
from .base import Expr, as_expr


class DotExpr(Expr):
    """a @ b for 1-D/2-D operands (NumPy dot semantics)."""

    def __init__(self, a: Expr, b: Expr, precision: Optional[str] = None):
        if a.ndim > 2 or b.ndim > 2:
            raise ValueError("dot supports 1-D and 2-D operands")
        if a.shape[-1] != (b.shape[0] if b.ndim else 1):
            raise ValueError(f"dot shape mismatch {a.shape} x {b.shape}")
        self.a = a
        self.b = b
        self.precision = precision
        if a.ndim == 1 and b.ndim == 1:
            shape: Tuple[int, ...] = ()
        elif a.ndim == 1:
            shape = (b.shape[1],)
        elif b.ndim == 1:
            shape = (a.shape[0],)
        else:
            shape = (a.shape[0], b.shape[1])
        super().__init__(shape, np.result_type(a.dtype, b.dtype))

    def children(self) -> Tuple[Expr, ...]:
        return (self.a, self.b)

    def replace_children(self, new_children) -> "DotExpr":
        return DotExpr(new_children[0], new_children[1], self.precision)

    def _lower(self, env: Dict[int, Any]) -> Any:
        # torch.matmul takes one dtype; promote as numpy/JAX do
        return dtypes.contract(torch.matmul, self.dtype, self.a.lower(env),
                               self.b.lower(env))

    def _sig(self, ctx) -> Tuple:
        return ("dot", self.precision, ctx.of(self.a), ctx.of(self.b))

    def _default_tiling(self) -> Tiling:
        if self.ndim == 2:
            return tiling_mod.block(2)
        if self.ndim == 1:
            return tiling_mod.row(1)
        return tiling_mod.replicated(0)


def dot(a: Any, b: Any, precision: Optional[str] = None):
    """``a @ b``; masked operands take the mask-aware GEMM
    (``numpy.ma.dot``, ``array/masked.py``)."""
    from ..array.masked import MaskedDistArray, masked_dot

    if isinstance(a, MaskedDistArray) or isinstance(b, MaskedDistArray):
        return masked_dot(a, b, precision=precision)
    return DotExpr(as_expr(a), as_expr(b), precision)
