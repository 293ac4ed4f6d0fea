"""DistArray: one tensor on one device plus the Tiling that describes
its tiles.

Port of ``spartan_tpu/array/distarray.py``. There a DistArray is a
GSPMD-sharded ``jax.Array``; here the data is one ``torch.Tensor`` on
the mesh's device, and the tiling is metadata: ``extents()`` gives the
tile map over the logical mesh, the same as the JAX package's at the
same mesh shape. Creation functions take an explicit ``device`` (default
device when None) and random fills take a seed for a
``torch.Generator``.

``update`` is a functional region write: it returns a new array and
leaves this one as it was. Donation (``donate()``,
``evaluate(donate=...)``) releases the handle's tensor after the
evaluation that consumes it: the memory is freed once nothing else holds
the tensor, and any later use of the handle raises. The port never
writes a donated tensor in place, so a cached plan, a loop closure or
another handle that still holds it reads what it held. The incremental
engine's lineage (``_record_mutation``) waits for that engine.
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


# update()'s combine step per canonical reducer (torch's bool add and
# mul are logical or and and, as jnp's are)
_COMBINE = {"add": torch.add, "multiply": torch.mul, "max": torch.maximum,
            "min": torch.minimum}


class DistArray:
    """A tensor on the mesh's device and its :class:`Tiling`."""

    __slots__ = ("_tensor", "tiling", "mesh", "_donate_next",
                 "_donate_site")

    def __init__(self, tensor: torch.Tensor, tiling: Tiling,
                 mesh: Optional[Mesh] = None):
        if tiling.ndim != tensor.ndim:
            raise ValueError(
                f"tiling rank {tiling.ndim} != array rank {tensor.ndim}")
        self._tensor = tensor
        self._donate_next = False
        self._donate_site = None
        self.tiling = tiling
        self.mesh = mesh or mesh_mod.get_mesh()

    # -- donation -------------------------------------------------------

    @property
    def tensor(self) -> torch.Tensor:
        t = self._tensor
        if t is None:
            site = (f" (donated at {self._donate_site[0]}:"
                    f"{self._donate_site[1]}, in {self._donate_site[2]})"
                    if self._donate_site else "")
            raise RuntimeError(
                "DistArray used after donation: its tensor was released "
                "to an evaluate(donate=...) / .donate() evaluation"
                f"{site}; rebuild the array (or keep a copy) instead of "
                "reusing the donated handle")
        return t

    def donate(self) -> "DistArray":
        """Release this array's tensor to the next evaluation that
        consumes it as a leaf; the handle is invalid afterwards. Returns
        ``self`` for chaining: ``evaluate(step(c.donate()))``."""
        from ..expr.base import _user_site

        self._donate_next = True
        if self._donate_site is None:
            # the user line that asked, named by the use-after-donate error
            self._donate_site = _user_site()
        return self

    @property
    def is_donated(self) -> bool:
        return self._tensor is None

    def _release_donated(self) -> None:
        """Called by ``evaluate`` after the evaluation that consumed a
        donated leaf."""
        self._tensor = None
        self._donate_next = False

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
        if self._tensor is None:
            return f"DistArray(<donated>, tiling={self.tiling})"
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

    def update(self, region: Any, data: Any,
               reducer: Any = None) -> "DistArray":
        """Functional region write: a new DistArray whose ``region`` (a
        TileExtent or a slice/int index) holds ``reducer(existing, data)``
        (default: overwrite); this array is unchanged. ``data`` is cast
        to this array's dtype and broadcast to the region's shape; the
        reducers combine in that dtype (integers wrap)."""
        if not isinstance(region, TileExtent):
            region = extent_mod.from_slice(region, self.shape)
        op = REDUCERS[_canonical_reducer(reducer)]
        x = self.tensor
        d = _as_tensor(data, x.dtype, x.device)
        sl = region.to_slice()
        d = torch.broadcast_to(d, region.shape)
        out = x.clone()
        out[sl] = d if op == "set" else dtypes.call(_COMBINE[op], out[sl], d)
        return DistArray(out, self.tiling, self.mesh)


def _as_tensor(data: Any, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """``data`` (a DistArray, tensor, array or scalar) as a tensor of
    ``dtype`` on ``device``, cast as ``jnp.asarray(data, dtype)`` casts."""
    if isinstance(data, DistArray):
        data = data.tensor
    if not isinstance(data, torch.Tensor):
        data = dtypes.from_host(np.array(data, order="C"))
    return data.to(device=device, dtype=dtype)


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
