"""File I/O for arrays: ``from_file`` / ``save`` / ``load`` (port of
``spartan_tpu/expr/fio.py``).

``.npy`` files load through numpy; checkpoint directories (per-tile
blobs and a manifest, ``utils/checkpoint.py``, the JAX package's format)
round-trip DistArrays with their tilings.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np

from ..array import distarray as da
from ..array.tiling import Tiling
from ..utils import checkpoint
from .base import Expr, ValExpr


def from_file(path: str, tiling: Optional[Tiling] = None,
              tile_hint=None) -> Expr:
    """An array from a ``.npy`` file or a checkpoint directory."""
    if os.path.isdir(path):
        return ValExpr(checkpoint.load(path, tiling=tiling))
    data = np.load(path)
    return ValExpr(da.from_numpy(data, tiling=tiling, tile_hint=tile_hint))


def save(path: str, expr: Any) -> None:
    """Save an expr or DistArray as a checkpoint directory."""
    checkpoint.save(path, expr)


def load(path: str, tiling: Optional[Tiling] = None) -> Expr:
    return from_file(path, tiling=tiling)
