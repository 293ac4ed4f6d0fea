"""Matrix product (port of ``DotExpr`` in ``spartan_tpu/expr/dot.py``).

The JAX package leaves the dense product to XLA; here it is
``torch.matmul`` (cuBLAS on the card). The package turns TF32 off at
import (see ``spartan_tpu_torch/__init__.py``), so a float32 product is
IEEE float32 whatever ``precision`` says — the JAX package's
``precision="highest"``. ``precision`` stays in the signature for API
parity. A float32 product of one 1-D and one 2-D operand on the card
(``kernels/gemv.py::routes``) runs through the hand-written fixed-order
kernel instead, whose per-element order depends only on the contraction
length, so a product restricted to a window of its output
(``expr/incremental.py``) keeps the whole product's bits there; the
route does not depend on ``FLAGS.incremental``.

The smart-tiling pass records a GEMM's plan in ``_dot_plan``: the
output grid and the contraction's placement (None: gathered; a mesh
axis: split there and merged by a psum). The operand edges go through
``parallel/redistribute.constrain`` and the plan joins the signature,
as in the JAX package. On a logical mesh the product is one
``torch.matmul`` over whole operands, so the plan changes no bits. On a
group mesh the plan is carried out: each operand moves to the plan's
layout (A ``(m_r, k)``, B ``(k, m_c)``), each rank multiplies its
blocks, and a k-split ends in an all-reduce over the contraction's mesh
axis, which changes the order of the sum. A node without a plan takes
the operands' own placements (:func:`local_plan`).

``DotShardMapExpr`` (``dot_shardmap``) is the explicit blocked GEMM
under ``parallel/shard_map.py``: A split (x, y), B split (y, None), a
partial ``torch.matmul`` at every position and an ``all_reduce`` over
y; the result is row-tiled. On a group mesh its body runs on the blocks
the ranks store (``shard_map_local``): each operand moves to its
tiling, each rank multiplies its blocks and all-reduces over y.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from ..kernels import gemv
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
        return _contract(self.dtype, av, bv)

    def _lower_local(self, env) -> Any:
        """The plan on the ranks' blocks: 1-D operands take part as a
        row (A) or a column (B) of a 2-D product."""
        from ..array.distarray import DistArray
        from ..parallel import collectives as coll

        av, bv = self.a.lower_local(env), self.b.lower_local(env)
        a2 = av.tiling.axes if av.ndim == 2 else (None,) + av.tiling.axes
        b2 = bv.tiling.axes if bv.ndim == 2 else bv.tiling.axes + (None,)
        if self.a.ndim == 2 and self.b.ndim == 2 \
                and self._dot_plan is not None:
            (m_r, m_c), k = self._dot_plan[0].axes[:2], self._dot_plan[1]
        else:
            m_r, k, m_c = local_plan(a2, b2)
        if self.a.ndim == 1:
            m_r = None
        if self.b.ndim == 1:
            m_c = None
        if k is not None and k in (m_r, m_c) or \
                (m_r is not None and m_r == m_c):
            return NotImplemented
        ab = redist_mod.relayout(av, Tiling(((m_r,) if av.ndim == 2 else ())
                                            + (k,))).local
        bb = redist_mod.relayout(bv, Tiling((k,) + ((m_c,) if bv.ndim == 2
                                                    else ()))).local
        out = _contract(self.dtype, ab, bb)
        if k is not None:
            out = coll.reduce_over(out, (k,), "add", env.mesh)
        axes = ((m_r,) if self.a.ndim == 2 else ()) + \
            ((m_c,) if self.b.ndim == 2 else ())
        return DistArray.from_local(out, Tiling(axes), self.shape, env.mesh)

    def cost(self) -> Dict[str, float]:
        """2·m·n·k FLOPs (a 1-D operand is one row or column); the
        operands read once, the output written once."""
        from .base import io_bytes

        m = self.a.shape[0] if self.a.ndim == 2 else 1
        n = self.b.shape[1] if self.b.ndim == 2 else 1
        k = self.a.shape[-1]
        return {"flops": 2.0 * m * n * k, "transcendentals": 0.0,
                "bytes accessed": io_bytes((self.a, self.b), self)}

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


def _contract(dtype, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the result ``dtype``: through the fixed-order kernel
    where ``gemv.routes`` holds, else ``torch.matmul`` (which takes one
    dtype: both operands are cast to the result type first)."""
    if gemv.routes(a, b, dtype):
        return gemv.fixed_order_dot(a.to(torch.float32),
                                    b.to(torch.float32))
    return dtypes.contract(torch.matmul, dtype, a, b)


def local_plan(a_axes, b_axes) -> Tuple[Any, Any, Any]:
    """(m_r, k, m_c) for a product without a committed plan: the rows
    keep A's placement, the columns B's, and the contraction is split
    where either operand already splits it (A's placement first), so
    operands already in place do not move."""
    m_r, m_c = a_axes[0], b_axes[1]
    if m_c == m_r:
        m_c = None
    k = a_axes[1] if a_axes[1] is not None else b_axes[0]
    if k is not None and k in (m_r, m_c):
        k = None
    return m_r, k, m_c


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

    def _lower_local(self, env) -> Any:
        """The body on the stored blocks, as ``ShardMap2Expr`` runs its
        kernel: the partial product, then ``all_reduce`` over y."""
        from ..array.distarray import DistArray
        from ..parallel import collectives as coll
        from ..parallel.shard_map import shard_map_local

        mesh = env.mesh
        a_t = Tiling((mesh_mod.AXIS_ROW, mesh_mod.AXIS_COL))
        b_t = Tiling((mesh_mod.AXIS_COL, None))
        out_t = tiling_mod.row(2)
        if not (a_t.divisible(self.a.shape, mesh)
                and b_t.divisible(self.b.shape, mesh)
                and out_t.divisible(self.shape, mesh)):
            return NotImplemented  # the whole path raises as shard_map does
        ab = redist_mod.relayout(self.a.lower_local(env), a_t).local
        bb = redist_mod.relayout(self.b.lower_local(env), b_t).local
        dt = self.dtype

        def kernel(x, y):
            return coll.all_reduce(dtypes.contract(torch.matmul, dt, x, y),
                                   mesh_mod.AXIS_COL)

        blk = shard_map_local(kernel, mesh, (a_t, b_t), out_t)(ab, bb)
        return DistArray.from_local(blk, out_t, self.shape, mesh)

    def _sig(self, ctx) -> Tuple:
        return ("dot_smap", ctx.of(self.a), ctx.of(self.b))

    def _default_tiling(self) -> Tiling:
        return tiling_mod.row(2)


def dot_shardmap(a: Any, b: Any) -> DotShardMapExpr:
    return DotShardMapExpr(as_expr(a), as_expr(b))
