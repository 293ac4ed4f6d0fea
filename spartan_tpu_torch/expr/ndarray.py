"""Lazy array-creation expressions (port of
``spartan_tpu/expr/ndarray.py``).

A creation node makes its tensor when the plan runs, on the mesh's
device. Random fills draw from a ``torch.Generator`` seeded per node,
so re-evaluating the same expr gives the same values (not the JAX
package's bits: tests feed both packages numpy data).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from ..parallel import mesh as mesh_mod
from ..utils import dtypes
from .base import Expr


class CreateExpr(Expr):
    """Lazy fill: zeros/ones/full/arange/linspace/eye."""

    def __init__(self, shape: Sequence[int], dtype: Any, kind: str,
                 params: Tuple = (),
                 tiling: Optional[Tiling] = None,
                 tile_hint: Optional[Sequence[int]] = None):
        shape = tuple(int(s) for s in shape)
        super().__init__(shape, dtype)
        self.kind = kind
        self.params = params
        if tiling is None and tile_hint is not None:
            tiling = tiling_mod.from_tile_hint(shape, tile_hint)
        self._tiling = tiling

    def children(self) -> Tuple[Expr, ...]:
        return ()

    def replace_children(self, new_children: Tuple[Expr, ...]) -> Expr:
        return self

    def _lower(self, env: Dict[int, Any]) -> Any:
        dev = mesh_mod.get_mesh().device
        dt = dtypes.to_torch(self.dtype)
        k = self.kind
        if k == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=dev)
        if k == "ones":
            return torch.ones(self.shape, dtype=dt, device=dev)
        if k == "full":
            return torch.full(self.shape, self.params[0], dtype=dt,
                              device=dev)
        if k == "arange":
            return torch.from_numpy(
                np.arange(*self.params).astype(self.dtype)).to(dev)
        if k == "linspace":
            # the JAX package's explicit iota lowering: start + step * i
            # in f32, the last sample pinned to stop
            start, stop, num, endpoint = self.params
            if num == 1:
                return torch.full((1,), start, dtype=dt, device=dev)
            step = (stop - start) / ((num - 1) if endpoint else num)
            out = (torch.tensor(start, dtype=torch.float32)
                   + torch.tensor(step, dtype=torch.float32)
                   * torch.arange(num, dtype=torch.float32)).to(dev)
            if endpoint:
                out[-1] = stop
            return out.to(dt)
        if k == "eye":
            n, m, k_off = self.params
            return torch.from_numpy(
                np.eye(n, m, k_off, dtype=self.dtype)).to(dev)
        raise ValueError(f"unknown creation kind {self.kind!r}")

    def _sig(self, ctx) -> Tuple:
        return ("create", self.kind, self._shape, str(self._dtype),
                self.params)

    def _default_tiling(self) -> Tiling:
        if self._tiling is not None:
            return self._tiling
        return tiling_mod.default_tiling(self.shape)


class RandomExpr(Expr):
    """Lazy random fill from a per-node seed (a counter when none is
    given), so re-evaluating the same expr is deterministic."""

    _counter = [0]

    def __init__(self, shape: Sequence[int], kind: str,
                 seed: Optional[int] = None,
                 dtype: Any = np.float32,
                 tiling: Optional[Tiling] = None,
                 tile_hint: Optional[Sequence[int]] = None):
        shape = tuple(int(s) for s in shape)
        super().__init__(shape, dtype)
        self.kind = kind
        if seed is None:
            RandomExpr._counter[0] += 1
            seed = RandomExpr._counter[0]
        self.seed = int(seed)
        # [low, high) of a randint fill
        self.params_range: Tuple[int, int] = (0, 0)
        if tiling is None and tile_hint is not None:
            tiling = tiling_mod.from_tile_hint(shape, tile_hint)
        self._tiling = tiling

    def children(self) -> Tuple[Expr, ...]:
        return ()

    def replace_children(self, new_children: Tuple[Expr, ...]) -> Expr:
        return self

    def _lower(self, env: Dict[int, Any]) -> Any:
        dev = mesh_mod.get_mesh().device
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        dt = dtypes.to_torch(self.dtype)
        if self.kind == "uniform":
            return torch.rand(self.shape, generator=gen, dtype=dt,
                              device=dev)
        if self.kind == "normal":
            return torch.randn(self.shape, generator=gen, dtype=dt,
                               device=dev)
        if self.kind == "randint":
            lo, hi = self.params_range
            return torch.randint(lo, hi, self.shape, generator=gen,
                                 dtype=dt, device=dev)
        raise ValueError(f"unknown random kind {self.kind!r}")

    def _sig(self, ctx) -> Tuple:
        return ("random", self.kind, self.seed, self._shape,
                str(self._dtype), self.params_range)

    def _default_tiling(self) -> Tiling:
        if self._tiling is not None:
            return self._tiling
        return tiling_mod.default_tiling(self.shape)


def ndarray(shape: Sequence[int], dtype: Any = np.float32,
            tile_hint: Optional[Sequence[int]] = None,
            reducer: Any = None,
            tiling: Optional[Tiling] = None) -> CreateExpr:
    """The reference's ``ndarray``: a new zero-filled distributed array.

    ``reducer`` is accepted for API parity and is advisory, as in the
    JAX package: a write names its reducer itself."""
    return CreateExpr(shape, dtype, "zeros", (), tiling, tile_hint)
