"""Matrix product (port of ``DotExpr`` in ``spartan_tpu/expr/dot.py``).

The JAX package leaves the dense product to XLA; here it is
``torch.matmul`` (cuBLAS on the card). The package turns TF32 off at
import (see ``spartan_tpu_torch/__init__.py``), so a float32 product is
IEEE float32 whatever ``precision`` says — the JAX package's
``precision="highest"``. ``precision`` stays in the signature for API
parity.

The smart-tiling pass records a GEMM's plan in ``_dot_plan``: the
output grid and the contraction's placement (None: gathered; a mesh
axis: split there and merged by a psum). The operand edges go through
``parallel/redistribute.constrain`` and the plan joins the signature,
as in the JAX package. Each product is still one ``torch.matmul`` over
whole operands, so the plan changes no bits; the k-split with an
all-reduce waits for local-shard storage (ROADMAP A3b-ii).

``DotShardMapExpr`` (``dot_shardmap``) is the explicit blocked GEMM
under ``parallel/shard_map.py``: A split (x, y), B split (y, None), a
partial ``torch.matmul`` at every position and an ``all_reduce`` over
y; the result is row-tiled.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from ..parallel import mesh as mesh_mod
from ..parallel import redistribute as redist_mod
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
        # smart-tiling plan (tiling_cost): (output Tiling, strategy)
        self._dot_plan = None
        if a.ndim == 1 and b.ndim == 1:
            shape: Tuple[int, ...] = ()
        elif a.ndim == 1:
            shape = (b.shape[1],)
        elif b.ndim == 1:
            shape = (a.shape[0],)
        else:
            shape = (a.shape[0], b.shape[1])
        # JAX's promotion with 64-bit types off: float32 . int32 is
        # float32 (numpy would say float64); both operands are cast to
        # it before torch.matmul
        super().__init__(shape, dtypes.result_type(a.dtype, b.dtype))

    def children(self) -> Tuple[Expr, ...]:
        return (self.a, self.b)

    def replace_children(self, new_children) -> "DotExpr":
        return DotExpr(new_children[0], new_children[1], self.precision)

    @property
    def _dot_strategy(self):
        """Contraction placement from the plan (None = gathered)."""
        return self._dot_plan[1] if self._dot_plan is not None else None

    def _lower(self, env: Dict[int, Any]) -> Any:
        av = self.a.lower(env)
        bv = self.b.lower(env)
        if (self.a.ndim == 2 and self.b.ndim == 2
                and self._dot_plan is not None):
            # the plan's operand layouts: A (m_r, k), B (k, m_c), from
            # the children's committed tilings the DP priced
            plan_t, k = self._dot_plan
            m_r, m_c = plan_t.axes[:2]
            mesh = mesh_mod.get_mesh()
            av = redist_mod.constrain(av, Tiling((m_r, k)), mesh,
                                      src=self.a.out_tiling())
            bv = redist_mod.constrain(bv, Tiling((k, m_c)), mesh,
                                      src=self.b.out_tiling())
        # torch.matmul takes one dtype: both operands are cast to the
        # result type first
        return dtypes.contract(torch.matmul, self.dtype, av, bv)

    def _sig(self, ctx) -> Tuple:
        # the plan changes the lowering, so it keys the plan cache
        plan = (None if self._dot_plan is None
                else (self._dot_plan[0].axes, self._dot_plan[1]))
        return ("dot", self.precision, plan, ctx.of(self.a),
                ctx.of(self.b))

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


class DotShardMapExpr(Expr):
    """Explicit blocked GEMM under ``shard_map``: A split (x, y) on
    (rows, contraction), B split (y,) on rows; each position computes
    its partial product and ``all_reduce`` over y merges them — the
    literal all-reduce lowering of the reference's reducer-merge. The
    dtype is the JAX package's promotion with 64-bit types off (both
    operands are cast to it), as ``DotExpr``'s is."""

    def __init__(self, a: Expr, b: Expr):
        if a.ndim != 2 or b.ndim != 2:
            raise ValueError("dot_shardmap requires 2-D operands")
        if a.shape[1] != b.shape[0]:
            raise ValueError(f"shape mismatch {a.shape} x {b.shape}")
        self.a = a
        self.b = b
        super().__init__((a.shape[0], b.shape[1]),
                         dtypes.result_type(a.dtype, b.dtype))

    def children(self) -> Tuple[Expr, ...]:
        return (self.a, self.b)

    def replace_children(self, new_children) -> "DotShardMapExpr":
        return DotShardMapExpr(new_children[0], new_children[1])

    def _lower(self, env: Dict[int, Any]) -> Any:
        from ..parallel import collectives as coll
        from ..parallel.shard_map import shard_map

        mesh = mesh_mod.get_mesh()
        a_t = Tiling((mesh_mod.AXIS_ROW, mesh_mod.AXIS_COL))
        b_t = Tiling((mesh_mod.AXIS_COL, None))
        av = redist_mod.constrain(self.a.lower(env), a_t, mesh,
                                  src=self.a.out_tiling())
        bv = redist_mod.constrain(self.b.lower(env), b_t, mesh,
                                  src=self.b.out_tiling())
        dt = self.dtype

        def kernel(ab, bb):
            return coll.all_reduce(dtypes.contract(torch.matmul, dt, ab, bb),
                                   mesh_mod.AXIS_COL)

        return shard_map(kernel, mesh, (a_t, b_t),
                         tiling_mod.row(2))(av, bv)

    def _sig(self, ctx) -> Tuple:
        return ("dot_smap", ctx.of(self.a), ctx.of(self.b))

    def _default_tiling(self) -> Tiling:
        return tiling_mod.row(2)


def dot_shardmap(a: Any, b: Any) -> DotShardMapExpr:
    return DotShardMapExpr(as_expr(a), as_expr(b))
