"""Block outer product (port of ``spartan_tpu/expr/outer.py``): C[i, j]
= a[i] * b[j], or ``fn(a[:, None], b[None, :])`` with a user function of
torch tensors; the result is tiled over both mesh axes.

On a group mesh each rank forms its (row block x column block) of the
result from the pieces of the two vectors it needs: each vector comes to
the tiling of its output axis (an all-gather of at most m + n elements,
never of m * n), and ``fn`` runs on the two pieces as it runs on the
whole vectors, an outer broadcast."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from .base import Expr, as_expr, eval_shape_of, fn_key


class OuterExpr(Expr):
    def __init__(self, a: Expr, b: Expr,
                 fn: Optional[Callable] = None):
        if a.ndim != 1 or b.ndim != 1:
            raise ValueError("outer requires 1-D operands")
        self.a = a
        self.b = b
        self.fn = fn
        out = eval_shape_of(self._apply, a, b)
        super().__init__(out.shape, out.dtype)

    def _apply(self, av: Any, bv: Any) -> Any:
        if self.fn is not None:
            return self.fn(av[:, None], bv[None, :])
        return torch.outer(av, bv)

    def children(self) -> Tuple[Expr, ...]:
        return (self.a, self.b)

    def replace_children(self, new_children) -> "OuterExpr":
        return OuterExpr(new_children[0], new_children[1], self.fn)

    def _lower(self, env: Dict[int, Any]) -> Any:
        return self._apply(self.a.lower(env), self.b.lower(env))

    def _lower_local(self, env) -> Any:
        """The rank's output block from its rows' piece of ``a`` and its
        columns' piece of ``b``."""
        from ..array.distarray import DistArray
        from ..parallel import redistribute as redist_mod

        mesh = env.mesh
        t = tiling_mod.sanitize(self.out_tiling(), self.shape, mesh)
        av = redist_mod.relayout(self.a.lower_local(env),
                                 Tiling((t.axes[0],))).local
        bv = redist_mod.relayout(self.b.lower_local(env),
                                 Tiling((t.axes[1],))).local
        return DistArray.from_local(self._apply(av, bv), t, self.shape,
                                    mesh)

    def _sig(self, ctx) -> Tuple:
        return ("outer", None if self.fn is None else fn_key(self.fn),
                ctx.of(self.a), ctx.of(self.b))

    def cost(self) -> Dict[str, float]:
        """One multiply per output element (a user ``fn``'s operations
        are not counted, as for a user map); each operand read once,
        the output written once."""
        from .base import io_bytes

        return {"flops": float(self.size) if self.fn is None else 0.0,
                "transcendentals": 0.0,
                "bytes accessed": io_bytes(self.children(), self)}

    def _default_tiling(self) -> Tiling:
        return tiling_mod.block(2)


def outer(a: Any, b: Any, fn: Optional[Callable] = None) -> OuterExpr:
    return OuterExpr(as_expr(a), as_expr(b), fn)
