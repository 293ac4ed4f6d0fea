"""DistArray: one tensor on one device plus the Tiling that describes
its tiles.

Port of ``spartan_tpu/array/distarray.py``. There a DistArray is a
GSPMD-sharded ``jax.Array``; here the data is one ``torch.Tensor`` on
the mesh's device, and the tiling is metadata: ``extents()`` gives the
tile map over the logical mesh, the same as the JAX package's at the
same mesh shape. Creation functions take an explicit ``device`` (default
device when None) and random fills take a seed for a
``torch.Generator``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..parallel import mesh as mesh_mod
from ..parallel.mesh import DeviceLike, Mesh
from ..utils import dtypes
from . import tiling as tiling_mod
from . import extent as extent_mod
from .extent import TileExtent
from .tiling import Tiling

# region-write reducers: the reference's names and numpy functions map to
# the canonical names assign/write_array and shuffle apply
REDUCERS = {None: "set", "set": "set", "add": "add", "mul": "multiply",
            "max": "max", "min": "min"}


def _canonical_reducer(reducer: Any) -> str:
    """Accept the reference's numpy-function reducers as well as names."""
    if reducer is None:
        return "set"
    if isinstance(reducer, str):
        if reducer not in REDUCERS:
            raise ValueError(f"unknown reducer {reducer!r}")
        return reducer
    for name, fn in (("add", np.add), ("mul", np.multiply),
                     ("max", np.maximum), ("min", np.minimum)):
        if reducer is fn:
            return name
    raise ValueError(f"unsupported reducer {reducer!r}; use one of "
                     f"{sorted(k for k in REDUCERS if k)}")


class DistArray:
    """A tensor on the mesh's device and its :class:`Tiling`."""

    __slots__ = ("tensor", "tiling", "mesh")

    def __init__(self, tensor: torch.Tensor, tiling: Tiling,
                 mesh: Optional[Mesh] = None):
        if tiling.ndim != tensor.ndim:
            raise ValueError(
                f"tiling rank {tiling.ndim} != array rank {tensor.ndim}")
        self.tensor = tensor
        self.tiling = tiling
        self.mesh = mesh or mesh_mod.get_mesh()

    # -- basic properties ----------------------------------------------

    @property
    def shape(self) -> tuple:
        return tuple(self.tensor.shape)

    @property
    def dtype(self) -> np.dtype:
        return dtypes.to_numpy(self.tensor.dtype)

    @property
    def ndim(self) -> int:
        return self.tensor.ndim

    @property
    def size(self) -> int:
        return int(self.tensor.numel())

    @property
    def device(self) -> torch.device:
        return self.tensor.device

    def __repr__(self) -> str:
        return (f"DistArray(shape={self.shape}, dtype={self.dtype}, "
                f"tiling={self.tiling}, device={self.device})")

    # -- tile map view --------------------------------------------------

    def extents(self) -> List[TileExtent]:
        return self.tiling.extents(self.shape, self.mesh)

    # -- data access ----------------------------------------------------

    def glom(self) -> np.ndarray:
        """Fetch the whole array to the host."""
        return dtypes.to_host(self.tensor)

    def fetch(self, region: Any) -> np.ndarray:
        """Fetch a rectangular region (a TileExtent or a slice/int index)
        to the host."""
        if not isinstance(region, TileExtent):
            region = extent_mod.from_slice(region, self.shape)
        return dtypes.to_host(self.tensor[region.to_slice()])


# -- creation -----------------------------------------------------------


def _resolve(shape: Sequence[int], tiling: Optional[Tiling],
             tile_hint: Optional[Sequence[int]], mesh: Optional[Mesh],
             device: Optional[DeviceLike]) -> tuple:
    if mesh is None:
        mesh = mesh_mod.mesh_on(device)
    if tiling is None:
        tiling = (tiling_mod.from_tile_hint(shape, tile_hint, mesh)
                  if tile_hint is not None else
                  tiling_mod.default_tiling(shape, mesh))
    return tiling, mesh


def from_tensor(t: torch.Tensor, tiling: Optional[Tiling] = None,
                mesh: Optional[Mesh] = None) -> DistArray:
    """Wrap a tensor (moved to the mesh's device when elsewhere)."""
    tiling, mesh = _resolve(t.shape, tiling, None, mesh, None)
    if t.device != mesh.device:
        t = t.to(mesh.device)
    return DistArray(t, tiling, mesh)


def from_numpy(arr: Any, tiling: Optional[Tiling] = None,
               tile_hint: Optional[Sequence[int]] = None,
               mesh: Optional[Mesh] = None,
               device: Optional[DeviceLike] = None) -> DistArray:
    arr = np.asarray(arr)
    tiling, mesh = _resolve(arr.shape, tiling, tile_hint, mesh, device)
    # an owned, writable, C-ordered copy: the tensor never aliases the
    # caller's buffer (which may be read-only, e.g. a glommed array)
    arr = np.array(arr, dtype=dtypes.canonical(arr.dtype), order="C")
    t = dtypes.from_host(arr).to(mesh.device)
    return DistArray(t, tiling, mesh)


def from_reference(values: np.ndarray,
                   tiling_axes: Sequence[Optional[str]],
                   mesh: Optional[Mesh] = None,
                   device: Optional[DeviceLike] = None) -> DistArray:
    """Carry a JAX-package array's state across: ``values`` is its
    glommed numpy data and ``tiling_axes`` its ``Tiling.axes``; the
    result holds the same values under the same tiling, so its tile
    extents equal the reference array's at the same mesh shape."""
    t = Tiling(tuple(tiling_axes))
    values = np.asarray(values)
    if t.ndim != values.ndim:
        raise ValueError(f"tiling axes {t.axes} do not match the "
                         f"reference array's rank {values.ndim}")
    return from_numpy(values, tiling=t, mesh=mesh, device=device)


def _filled(shape: Sequence[int], dtype: Any, make,
            tiling: Optional[Tiling], tile_hint: Optional[Sequence[int]],
            mesh: Optional[Mesh], device: Optional[DeviceLike]
            ) -> DistArray:
    shape = tuple(int(s) for s in shape)
    tiling, mesh = _resolve(shape, tiling, tile_hint, mesh, device)
    return DistArray(make(shape, dtypes.to_torch(dtype), mesh.device),
                     tiling, mesh)


def zeros(shape: Sequence[int], dtype: Any = np.float32,
          tiling: Optional[Tiling] = None,
          tile_hint: Optional[Sequence[int]] = None,
          mesh: Optional[Mesh] = None,
          device: Optional[DeviceLike] = None) -> DistArray:
    return _filled(shape, dtype,
                   lambda s, dt, dev: torch.zeros(s, dtype=dt, device=dev),
                   tiling, tile_hint, mesh, device)


def ones(shape: Sequence[int], dtype: Any = np.float32,
         tiling: Optional[Tiling] = None,
         tile_hint: Optional[Sequence[int]] = None,
         mesh: Optional[Mesh] = None,
         device: Optional[DeviceLike] = None) -> DistArray:
    return _filled(shape, dtype,
                   lambda s, dt, dev: torch.ones(s, dtype=dt, device=dev),
                   tiling, tile_hint, mesh, device)


def full(shape: Sequence[int], fill_value: Any, dtype: Any = None,
         tiling: Optional[Tiling] = None,
         tile_hint: Optional[Sequence[int]] = None,
         mesh: Optional[Mesh] = None,
         device: Optional[DeviceLike] = None) -> DistArray:
    if dtype is None:
        dtype = dtypes.canonical(np.result_type(type(fill_value)))
    return _filled(shape, dtype,
                   lambda s, dt, dev: torch.full(s, fill_value, dtype=dt,
                                                 device=dev),
                   tiling, tile_hint, mesh, device)


def arange(*args, dtype: Any = None, tiling: Optional[Tiling] = None,
           tile_hint: Optional[Sequence[int]] = None,
           mesh: Optional[Mesh] = None,
           device: Optional[DeviceLike] = None) -> DistArray:
    probe = np.arange(*args, dtype=dtype)
    return from_numpy(probe, tiling=tiling, tile_hint=tile_hint, mesh=mesh,
                      device=device)


def _random(shape: Sequence[int], seed: int, sampler,
            tiling: Optional[Tiling], tile_hint: Optional[Sequence[int]],
            mesh: Optional[Mesh], device: Optional[DeviceLike]
            ) -> DistArray:
    def make(s, dt, dev):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        return sampler(s, generator=gen, dtype=dt, device=dev)

    return _filled(shape, np.float32, make, tiling, tile_hint, mesh, device)


def rand(*shape: int, seed: int = 0, tiling: Optional[Tiling] = None,
         tile_hint: Optional[Sequence[int]] = None,
         mesh: Optional[Mesh] = None,
         device: Optional[DeviceLike] = None) -> DistArray:
    """Uniform [0, 1) f32 from a ``torch.Generator`` seeded with
    ``seed`` (not the JAX package's bits: tests feed both packages
    numpy data instead)."""
    return _random(shape, seed, torch.rand, tiling, tile_hint, mesh, device)


def randn(*shape: int, seed: int = 0, tiling: Optional[Tiling] = None,
          tile_hint: Optional[Sequence[int]] = None,
          mesh: Optional[Mesh] = None,
          device: Optional[DeviceLike] = None) -> DistArray:
    return _random(shape, seed, torch.randn, tiling, tile_hint, mesh,
                   device)
