"""Lazy array-creation expressions (port of
``spartan_tpu/expr/ndarray.py``).

A creation node makes its tensor when the plan runs, on the mesh's
device. Both compute any block from its extent alone, so on a group
mesh a rank makes only its block (``_lower_local``) and that block
equals the same slice of the whole array. Random fills are
counter-based (``utils/philox.py``): the value at a flat index is a
function of the node's seed and the index, so re-evaluating the same
expr gives the same values on any mesh (not the JAX package's bits:
tests feed both packages numpy data).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..array.extent import TileExtent
from ..array.tiling import Tiling
from ..parallel import mesh as mesh_mod
from ..utils import dtypes, philox
from .base import Expr


def _lower_block(node: Expr, env: Any) -> Any:
    """A creation node's local value on a group mesh: only the rank's
    block under the node's sanitized tiling, made from its extent."""
    from ..array.distarray import DistArray

    mesh = env.mesh
    t = tiling_mod.sanitize(node.out_tiling(), node.shape, mesh)
    blk = node.block(t.block_extent(node.shape, mesh), mesh.device)
    return DistArray.from_local(blk, t, node.shape, mesh)


def _block_numel(node: Expr, mesh) -> int:
    """Elements of the block ``node`` makes on ``mesh`` (the whole on a
    logical mesh)."""
    if not mesh.is_group:
        return int(np.prod(node.shape, dtype=np.int64))
    t = tiling_mod.sanitize(node.out_tiling(), node.shape, mesh)
    return t.block_extent(node.shape, mesh).size


def _arange_args(params: Tuple) -> Tuple[Any, Any, Any]:
    """(start, stop, step) of ``arange(*params)`` with numpy's defaults
    (start 0, step 1)."""
    if len(params) == 1:
        return 0, params[0], 1
    if len(params) == 2:
        return params[0], params[1], 1
    return tuple(params)


def arange_meta(params: Tuple, dtype: Any = None) -> Tuple[int, np.dtype]:
    """The length and dtype of ``np.arange(*params, dtype=dtype)``,
    worked out from the arguments without making the array: numpy's
    ``ceil((stop - start) / step)``, and the arguments' common type with
    the defaults taking part as numpy's int (the canonical dtype is the
    caller's)."""
    start, stop, step = _arange_args(params)
    if step == 0:
        raise ValueError("arange: step must not be 0")
    n = max(0, math.ceil(float((stop - start) / step)))
    dt = (np.dtype(dtype) if dtype is not None else
          np.result_type(*(np.asarray(p) for p in (start, stop, step))))
    return n, dt


def _scalar(x: Any, dt: torch.dtype) -> torch.Tensor:
    """``x`` cast to ``dt`` as numpy casts a scalar (a 0-d host tensor)."""
    return torch.from_numpy(np.asarray(x)).to(dt)


def _arange_block(params: Tuple, lo: int, hi: int, dt: torch.dtype,
                  device: Any) -> torch.Tensor:
    """Elements ``lo .. hi`` of the JAX package's ``jnp.arange(*params,
    dtype=dt)``, in ``dt`` as it fills (integers in int64, then cast).
    With a step that is numpy's fill: the first value ``start``, the
    second ``start + step``, then ``start + i * (second - start)``;
    without one, ``start + i``."""
    start, _, step = _arange_args(params)
    ints = not dt.is_floating_point
    cdt = torch.int64 if ints else dt
    v = torch.arange(lo, hi, dtype=torch.int64, device=device)
    if len(params) < 3:
        v = v.to(cdt)
        if start != 0:
            v.add_(_scalar(start, dt).to(cdt))
        return v.to(dt)
    if cdt in (torch.float16, torch.bfloat16):
        cdt = torch.float32  # numpy fills a half array in float32
    first = _scalar(start, dt).to(cdt)
    nxt = _scalar(start + step, dt).to(cdt)
    v = v.to(cdt).mul_(nxt - first).add_(first)
    for i, val in ((0, first), (1, nxt)):
        if lo <= i < hi:
            v[i - lo] = val
    return v.to(dt)


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
        return self.block(philox.whole(self.shape),
                          mesh_mod.get_mesh().device)

    def _lower_local(self, env) -> Any:
        return _lower_block(self, env)

    def block(self, ext: TileExtent, dev: Any) -> torch.Tensor:
        """The block ``ext`` of this fill, on ``dev``."""
        dt = dtypes.to_torch(self.dtype)
        shape = tuple(int(h - l) for l, h in zip(ext.ul, ext.lr))
        k = self.kind
        if k in ("zeros", "ones", "full"):
            v = (self.params[0] if k == "full" else
                 0 if k == "zeros" else 1)
            return torch.full(shape, v, dtype=dt, device=dev)
        if k == "arange":
            lo, hi = int(ext.ul[0]), int(ext.lr[0])
            return _arange_block(self.params, lo, hi, dt, dev)
        if k == "linspace":
            # the JAX package's explicit iota lowering: start + step * i
            # in f32, the last sample pinned to stop
            start, stop, num, endpoint = self.params
            lo, hi = int(ext.ul[0]), int(ext.lr[0])
            if num == 1:
                return torch.full(shape, start, dtype=dt, device=dev)
            step = (stop - start) / ((num - 1) if endpoint else num)
            out = torch.arange(lo, hi, dtype=torch.int64,
                               device=dev).to(torch.float32)
            out.mul_(torch.tensor(np.float32(step))).add_(
                torch.tensor(np.float32(start)))
            if endpoint and lo <= num - 1 < hi:
                out[num - 1 - lo] = stop
            return out.to(dt)
        if k == "eye":
            # the diagonal col - row = k_off, in the block's coordinates
            n, m, k_off = self.params
            out = torch.zeros(shape, dtype=dt, device=dev)
            torch.diagonal(out, int(k_off) - int(ext.ul[1])
                           + int(ext.ul[0])).fill_(1)
            return out
        raise ValueError(f"unknown creation kind {self.kind!r}")

    def card_staging(self, mesh) -> float:
        """The int64 index vector an iota fill holds beside its
        block (``resilience/memory.py``)."""
        if self.kind not in ("arange", "linspace"):
            return 0.0
        return 8.0 * _block_numel(self, mesh)

    def _sig(self, ctx) -> Tuple:
        return ("create", self.kind, self._shape, str(self._dtype),
                self.params)

    def _default_tiling(self) -> Tiling:
        if self._tiling is not None:
            return self._tiling
        return tiling_mod.default_tiling(self.shape)


class RandomExpr(Expr):
    """Lazy counter-based random fill from a per-node seed (a counter
    when none is given), so re-evaluating the same expr is
    deterministic."""

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
        return self.block(philox.whole(self.shape),
                          mesh_mod.get_mesh().device)

    def _lower_local(self, env) -> Any:
        return _lower_block(self, env)

    def block(self, ext: TileExtent, dev: Any) -> torch.Tensor:
        """The block ``ext`` of this draw, on ``dev``: the same slice of
        the whole draw on every mesh and device."""
        return philox.draw(self.kind, self.seed, self.shape, ext,
                           dtypes.to_torch(self.dtype), dev,
                           self.params_range)

    def card_staging(self, mesh) -> float:
        """The draw's word buffers (``utils/philox.py``)."""
        return float(philox.staging_bytes(_block_numel(self, mesh)))

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
