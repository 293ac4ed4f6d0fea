"""DistArray: an array's data on the mesh plus the Tiling that
describes its tiles.

Port of ``spartan_tpu/array/distarray.py``. There a DistArray is a
GSPMD-sharded ``jax.Array`` and each device holds its shard. Here the
storage follows the mesh (``parallel/mesh.py``):

* on a **logical mesh** the data is one ``torch.Tensor`` on the mesh's
  device and the tiling is metadata: ``extents()`` gives the tile map,
  the same as the JAX package's at the same mesh shape;
* on a **group mesh** each rank holds only its block, the
  ``Tiling.block_extent`` of the rank's coordinates (a replicated mesh
  axis holds the same block on every rank along it), and the global
  ``shape`` and ``dtype`` are metadata. :attr:`DistArray.local` is the
  block; :attr:`DistArray.tensor` gathers the whole array on every rank
  and counts it (``group_materialize_calls``/``_bytes`` by site in
  ``obs.metrics``), so nothing gathers silently. ``from_numpy`` and its
  kin copy only the rank's block to the device (every rank passes the
  whole host array, as every JAX process does for ``device_put``),
  ``retile`` is a real move between the ranks
  (``parallel/redistribute.relayout``), ``glom`` gathers to every rank,
  ``fetch`` moves only the region, ``update`` writes where the region
  meets the block and ``map_shards`` runs on the block.

On the logical mesh ``local`` is the whole tensor. The constructor
takes the WHOLE tensor on either mesh (a group rank keeps its block of
it); :meth:`DistArray.from_local` wraps a block a rank already holds.
Creation functions take an explicit ``device`` (default device when
None) and random fills take a seed for a ``torch.Generator``.

``update`` is a functional region write: it returns a new array and
leaves this one as it was. Donation (``donate()``,
``evaluate(donate=...)``) releases the handle's data after the
evaluation that consumes it: the memory is freed once nothing else holds
the tensor, and any later use of the handle's data raises (its shape
and dtype stay readable). The port never writes a donated tensor in
place, so a cached plan, a loop closure or another handle that still
holds it reads what it held. The incremental engine's lineage
(``_record_mutation``) waits for that engine.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

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


def _owned_block(whole: torch.Tensor, ext: TileExtent,
                 device: torch.device) -> torch.Tensor:
    """``whole``'s block at ``ext`` on ``device``, in storage of its own
    (a view would keep the whole tensor alive); the whole tensor itself
    when the block is all of it."""
    if tuple(ext.shape) == tuple(whole.shape):
        return whole.to(device)
    blk = whole[ext.to_slice()]
    out = torch.empty(blk.shape, dtype=blk.dtype, device=device)
    return out.copy_(blk)


class DistArray:
    """An array's data on the mesh and its :class:`Tiling`: the whole
    tensor on a logical mesh, the rank's block on a group mesh."""

    __slots__ = ("_local", "tiling", "mesh", "_shape", "_dtype",
                 "_donate_next", "_donate_site", "_epoch", "_migration")

    def __init__(self, tensor: torch.Tensor, tiling: Tiling,
                 mesh: Optional[Mesh] = None):
        """Wrap the WHOLE ``tensor``; a group rank keeps its block."""
        if tiling.ndim != tensor.ndim:
            raise ValueError(
                f"tiling rank {tiling.ndim} != array rank {tensor.ndim}")
        mesh = mesh or mesh_mod.get_mesh()
        shape = tuple(int(s) for s in tensor.shape)
        if mesh.is_group:
            tensor = _owned_block(tensor, tiling.block_extent(shape, mesh),
                                  tensor.device)
        self._set(tensor, tiling, mesh, shape)

    def _set(self, local: torch.Tensor, tiling: Tiling, mesh: Mesh,
             shape: tuple) -> None:
        self._local = local
        self._dtype = local.dtype
        self._donate_next = False
        self._donate_site = None
        self.tiling = tiling
        self.mesh = mesh
        self._shape = shape
        # the mesh epoch this array was made in (parallel/mesh.py): one
        # of an earlier epoch raises StaleMeshError until rehome()
        self._epoch = mesh_mod._EPOCH
        self._migration = None  # the last planned cross-mesh move

    @classmethod
    def from_local(cls, block: torch.Tensor, tiling: Tiling, shape,
                   mesh: Mesh) -> "DistArray":
        """An array of global ``shape`` of which this rank holds ``block``
        (its ``tiling.block_extent``; on a logical mesh, the whole)."""
        shape = tuple(int(s) for s in shape)
        want = (tiling.block_extent(shape, mesh).shape if mesh.is_group
                else shape)
        if tuple(block.shape) != tuple(want) or tiling.ndim != len(shape):
            raise ValueError(f"block {tuple(block.shape)} is not the block "
                             f"{tuple(want)} of {shape} under {tiling} on "
                             f"{mesh}")
        arr = cls.__new__(cls)
        arr._set(block, tiling, mesh, shape)
        return arr

    # -- donation -------------------------------------------------------

    def _data(self) -> torch.Tensor:
        t = self._local
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

    @property
    def local(self) -> torch.Tensor:
        """This rank's block (the whole tensor on a logical mesh)."""
        return self._data()

    @property
    def tensor(self) -> torch.Tensor:
        """The whole array. On a group mesh every rank gathers it, and
        the gather is counted (site ``tensor``)."""
        return self.materialize("tensor")

    def materialize(self, site: str) -> torch.Tensor:
        """The whole array on every rank; on a group mesh a gather over
        the mesh axes that tile it, counted as
        ``group_materialize_calls{site=site}`` (a replicated array
        gathers nothing and is not counted)."""
        t = self._data()
        if not self.mesh.is_group:
            return t
        from ..parallel import collectives as coll

        whole = coll.gather_whole(t, self.tiling, self._shape, self.mesh)
        if self.is_split:
            from ..obs.metrics import record_materialize

            record_materialize(site, whole.numel() * whole.element_size())
        return whole

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
        return self._local is None

    def _release_donated(self) -> None:
        """Called by ``evaluate`` after the evaluation that consumed a
        donated leaf."""
        self._local = None
        self._donate_next = False

    # -- basic properties (metadata: nothing is gathered) ----------------

    @property
    def shape(self) -> tuple:
        return self._shape

    @property
    def dtype(self) -> np.dtype:
        return dtypes.to_numpy(self._dtype)

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def size(self) -> int:
        return int(np.prod(self._shape, dtype=np.int64))

    @property
    def device(self) -> torch.device:
        return self._data().device

    def __repr__(self) -> str:
        if self._local is None:
            return f"DistArray(<donated>, tiling={self.tiling})"
        return (f"DistArray(shape={self.shape}, dtype={self.dtype}, "
                f"tiling={self.tiling}, device={self.device})")

    # -- tile map view --------------------------------------------------

    def extents(self) -> List[TileExtent]:
        return self.tiling.extents(self.shape, self.mesh)

    @property
    def is_split(self) -> bool:
        """True when a mesh axis of more than one position tiles it (on a
        group mesh the ranks then hold different blocks)."""
        return any(tiling_mod.tile_count(a, self.mesh) > 1
                   for a in self.tiling.axes)

    def block_extent(self) -> TileExtent:
        """The extent of :attr:`local` (the whole on a logical mesh)."""
        if not self.mesh.is_group:
            return TileExtent((0,) * self.ndim, self.shape, self.shape)
        return self.tiling.block_extent(self.shape, self.mesh)

    # -- data access ----------------------------------------------------

    def glom(self) -> np.ndarray:
        """Fetch the whole array to the host (a ``fetch`` phase: the copy
        waits for the device work that produced the tensor). On a group
        mesh every rank gathers the blocks (not a materialization: the
        caller asked for the whole)."""
        from ..parallel import collectives as coll
        from ..utils import profiling as prof

        with prof.phase("fetch") as sp:
            sp.set(shape=self.shape, dtype=str(self.dtype))
            t = self._data()
            if self.mesh.is_group:
                t = coll.gather_whole(t, self.tiling, self._shape, self.mesh)
            return dtypes.to_host(t)

    def fetch(self, region: Any) -> np.ndarray:
        """Fetch a rectangular region (a TileExtent or a slice/int index)
        to the host. On a group mesh each rank puts the part of the
        region its block holds, and the one owner of each element (the
        first position along the axes that replicate the array) sends
        it: only the region's bytes move."""
        if not isinstance(region, TileExtent):
            region = extent_mod.from_slice(region, self.shape)
        t = self._data()
        if not self.mesh.is_group or not self.is_split:
            return dtypes.to_host(t[region.to_slice()])
        from ..parallel import collectives as coll

        out = torch.zeros(region.shape, dtype=t.dtype, device=t.device)
        mine = self.block_extent()
        part = region.intersection(mine) if region.size else None
        if part is not None and self.is_first_copy:
            out[part.offset_from(region).to_slice()] = \
                t[part.offset_from(mine).to_slice()]
        return dtypes.to_host(coll.combine_owned(
            out, self.mesh.axis_names, self.mesh))

    @property
    def is_first_copy(self) -> bool:
        """True at the first position along every mesh axis that does
        not tile this array (the one that sends a replicated block)."""
        used = {sub for a in self.tiling.axes
                for sub in tiling_mod.mesh_axes_of(a)}
        return not any(self.mesh.coords[a] for a in self.mesh.axis_names
                       if a not in used)

    def update(self, region: Any, data: Any,
               reducer: Any = None) -> "DistArray":
        """Functional region write: a new DistArray whose ``region`` (a
        TileExtent or a slice/int index) holds ``reducer(existing, data)``
        (default: overwrite); this array is unchanged. ``data`` is cast
        to this array's dtype and broadcast to the region's shape; the
        reducers combine in that dtype (integers wrap). On a group mesh
        each rank writes where the region meets its block."""
        if not isinstance(region, TileExtent):
            region = extent_mod.from_slice(region, self.shape)
        op = REDUCERS[_canonical_reducer(reducer)]
        x = self._data()
        d = _as_tensor(data, x.dtype, x.device)
        d = torch.broadcast_to(d, region.shape)
        mine = self.block_extent()
        out = x.clone()
        part = region.intersection(mine) if region.size else None
        if part is not None:
            sl = part.offset_from(mine).to_slice()
            dp = d[part.offset_from(region).to_slice()]
            out[sl] = dp if op == "set" else dtypes.call(_COMBINE[op],
                                                         out[sl], dp)
        return DistArray.from_local(out, self.tiling, self.shape, self.mesh)

    # -- retiling -------------------------------------------------------

    def retile(self, new_tiling: Tiling) -> "DistArray":
        """This array under ``new_tiling``. On a logical mesh a tiling is
        metadata, so the new handle shares the tensor: nothing moves, and
        donating either handle leaves the other valid (donation drops a
        handle, never the data another handle holds). On a group mesh it
        is the JAX package's ``device_put`` to the new sharding: a real
        move between the ranks (``parallel/redistribute.relayout``: the
        planner's schedule over the group, else an all-gather and a
        slice)."""
        if new_tiling == self.tiling:
            return self
        if new_tiling.ndim != self.ndim:
            raise ValueError(f"tiling rank {new_tiling.ndim} != array "
                             f"rank {self.ndim}")
        if self.mesh.is_group:
            from ..parallel import redistribute as redist_mod

            return redist_mod.relayout(self, new_tiling)
        return DistArray(self._data(), new_tiling, self.mesh)

    def replicate(self) -> "DistArray":
        return self.retile(tiling_mod.replicated(self.ndim))

    def rehome(self) -> "DistArray":
        """Move this array, in place, onto the current mesh epoch after a
        ``rebuild_mesh`` (in place so that every holder of the handle,
        such as a loop body's closure, sees the move).

        The move is planned (``parallel/redistribute.plan_rehome``): the
        destination tiling is the source's sanitized for the survivor
        grid, and the route, schedule, modelled wire bytes and reason
        land on ``self._migration``. On a logical mesh the tensor stays
        on its device and only the tiling changes, so no bytes move; the
        record's ``bytes`` is the planner's model of what a mesh of
        separate devices would move. A donated handle is skipped with a
        labelled reason. A group mesh is never rebuilt in its
        processes, so an array of one is never stale."""
        if self._local is None:
            self._migration = {"route": "skipped", "bytes": 0,
                               "reason": "buffer invalidated by donation"}
            return self
        if self._epoch == mesh_mod._EPOCH:
            return self
        from ..parallel import redistribute as redist_mod

        mesh = mesh_mod.get_mesh()
        t, dec = redist_mod.plan_rehome(self, mesh)
        self._migration = {
            "route": dec.route, "bytes": int(dec.bytes),
            "schedule": (dec.schedule.describe()
                         if dec.schedule is not None else None),
            "reason": dec.reason, "shape": self.shape,
            "src_tiling": self.tiling.axes, "dst_tiling": t.axes,
            "from_epoch": self._epoch, "to_epoch": mesh_mod._EPOCH,
        }
        if self._local.device != mesh.device:
            self._local = self._local.to(mesh.device)
        self.tiling = t
        self.mesh = mesh
        self._epoch = mesh_mod._EPOCH
        return self

    # -- per-shard execution (the foreach_tile analogue) ----------------

    def map_shards(self, fn: Callable[[torch.Tensor], torch.Tensor]
                   ) -> "DistArray":
        """Apply a shape-preserving torch function to every logical
        shard's block independently (owner-computes, no communication)
        and reassemble the blocks, as the JAX package's ``shard_map``
        does. Replicated mesh axes hold the same block on every shard,
        so each distinct block runs once; on a group mesh the rank runs
        its own block. Needs the tiling to divide the shape, as
        ``shard_map`` does."""
        if not self.tiling.divisible(self.shape, self.mesh):
            raise ValueError(
                f"map_shards needs a tiling that divides the shape: "
                f"{self.tiling} over {self.shape} on {self.mesh}")
        x = self._data()
        base = self.block_extent()
        out = None
        for ext in [base] if self.mesh.is_group else self.extents():
            sl = ext.offset_from(base).to_slice()
            blk = fn(x[sl])
            if tuple(blk.shape) != tuple(ext.shape):
                raise ValueError(
                    f"map_shards fn must preserve the block shape: "
                    f"{tuple(ext.shape)} -> {tuple(blk.shape)}")
            if out is None:
                out = torch.empty(x.shape, dtype=blk.dtype,
                                  device=x.device)
            out[sl] = blk
        return DistArray.from_local(out, self.tiling, self.shape, self.mesh)


def _as_tensor(data: Any, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """``data`` (a DistArray, tensor, array or scalar) as a tensor of
    ``dtype`` on ``device``, cast as ``jnp.asarray(data, dtype)`` casts."""
    if isinstance(data, DistArray):
        data = data.materialize("update")
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
    """Wrap a whole tensor (moved to the mesh's device when elsewhere;
    on a group mesh only the rank's block is kept and moved)."""
    tiling, mesh = _resolve(t.shape, tiling, None, mesh, None)
    if mesh.is_group:
        shape = tuple(int(s) for s in t.shape)
        return DistArray.from_local(
            _owned_block(t, tiling.block_extent(shape, mesh), mesh.device),
            tiling, shape, mesh)
    if t.device != mesh.device:
        t = t.to(mesh.device)
    return DistArray(t, tiling, mesh)


def from_numpy(arr: Any, tiling: Optional[Tiling] = None,
               tile_hint: Optional[Sequence[int]] = None,
               mesh: Optional[Mesh] = None,
               device: Optional[DeviceLike] = None) -> DistArray:
    """The host array on the mesh's device; on a group mesh every rank
    passes the whole array and copies only its block."""
    arr = np.asarray(arr)
    tiling, mesh = _resolve(arr.shape, tiling, tile_hint, mesh, device)
    shape = tuple(int(s) for s in arr.shape)
    if mesh.is_group:
        part = arr[tiling.block_extent(shape, mesh).to_slice()]
    else:
        part = arr
    # an owned, writable, C-ordered copy: the tensor never aliases the
    # caller's buffer (which may be read-only, e.g. a glommed array)
    part = np.array(part, dtype=dtypes.canonical(arr.dtype), order="C")
    t = dtypes.from_host(part).to(mesh.device)
    return DistArray.from_local(t, tiling, shape, mesh)


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
    """A fill made whole (a group rank keeps its block): a seeded
    generator's draws then equal a logical mesh's on the same device."""
    shape = tuple(int(s) for s in shape)
    tiling, mesh = _resolve(shape, tiling, tile_hint, mesh, device)
    return DistArray(make(shape, dtypes.to_torch(dtype), mesh.device),
                     tiling, mesh)


def _filled_local(shape: Sequence[int], dtype: Any, make,
                  tiling: Optional[Tiling],
                  tile_hint: Optional[Sequence[int]], mesh: Optional[Mesh],
                  device: Optional[DeviceLike]) -> DistArray:
    """A constant fill: on a group mesh only the rank's block is made."""
    shape = tuple(int(s) for s in shape)
    tiling, mesh = _resolve(shape, tiling, tile_hint, mesh, device)
    blk = tiling.block_extent(shape, mesh).shape if mesh.is_group else shape
    return DistArray.from_local(make(blk, dtypes.to_torch(dtype),
                                     mesh.device), tiling, shape, mesh)


def zeros(shape: Sequence[int], dtype: Any = np.float32,
          tiling: Optional[Tiling] = None,
          tile_hint: Optional[Sequence[int]] = None,
          mesh: Optional[Mesh] = None,
          device: Optional[DeviceLike] = None) -> DistArray:
    return _filled_local(shape, dtype,
                         lambda s, dt, dev: torch.zeros(s, dtype=dt,
                                                        device=dev),
                         tiling, tile_hint, mesh, device)


def ones(shape: Sequence[int], dtype: Any = np.float32,
         tiling: Optional[Tiling] = None,
         tile_hint: Optional[Sequence[int]] = None,
         mesh: Optional[Mesh] = None,
         device: Optional[DeviceLike] = None) -> DistArray:
    return _filled_local(shape, dtype,
                         lambda s, dt, dev: torch.ones(s, dtype=dt,
                                                       device=dev),
                         tiling, tile_hint, mesh, device)


def full(shape: Sequence[int], fill_value: Any, dtype: Any = None,
         tiling: Optional[Tiling] = None,
         tile_hint: Optional[Sequence[int]] = None,
         mesh: Optional[Mesh] = None,
         device: Optional[DeviceLike] = None) -> DistArray:
    if dtype is None:
        dtype = dtypes.canonical(np.result_type(type(fill_value)))
    return _filled_local(shape, dtype,
                         lambda s, dt, dev: torch.full(s, fill_value,
                                                       dtype=dt, device=dev),
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
