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
holds it reads what it held.

``update`` is also the mutation seam of the incremental engine
(``expr/incremental.py``): the new array shares this array's
:class:`Lineage` with the written region logged, and for an overwrite
the post-write values of the region are stashed, so a warm evaluate can
recompute only what the write touched.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

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


_MUTLOG_MAX = 256  # mutation-log cap: overflow collapses to whole-array


def _stash_enabled() -> bool:
    from ..utils.config import FLAGS

    return bool(getattr(FLAGS, "incremental", False))


class Lineage:
    """Shared mutation history of a family of :class:`DistArray` handles.

    ``update()`` is functional — it returns a NEW DistArray — but the
    returned array shares its parent's ``Lineage`` so the incremental
    engine can tell what moved between the leaf a result-cache entry
    recorded and the leaf a later evaluate sees: same lineage and a
    higher version means "this array, with exactly the extents logged in
    between dirty"; anything else is a new identity and the engine
    recomputes in full. The log is bounded: past ``_MUTLOG_MAX`` entries
    it collapses to one whole-array marker (``None`` extent), the
    conservative over-approximation."""

    __slots__ = ("log", "latest", "stash", "stash_bytes")

    # post-write region values kept per logged entry: the engine serves
    # a restricted leaf from them instead of slicing the parent
    _STASH_MAX_BYTES = 64 << 20

    def __init__(self) -> None:
        # log: [(version, TileExtent | None)]; None means whole array
        self.log: List[Tuple[int, Optional[TileExtent]]] = []
        self.latest = 0
        self.stash: dict = {}  # version -> torch.Tensor (region values)
        self.stash_bytes = 0

    def note(self, ext: Optional[TileExtent],
             value: Optional[torch.Tensor] = None) -> int:
        self.latest += 1
        if len(self.log) >= _MUTLOG_MAX:
            self.log = [(self.latest, None)]
            self.stash.clear()
            self.stash_bytes = 0
        else:
            self.log.append((self.latest, ext))
            if value is not None and ext is not None:
                nb = value.numel() * value.element_size()
                if nb <= self._STASH_MAX_BYTES:
                    self.stash[self.latest] = value
                    self.stash_bytes += nb
                    while self.stash_bytes > self._STASH_MAX_BYTES:
                        old = self.stash.pop(next(iter(self.stash)))
                        self.stash_bytes -= (old.numel()
                                             * old.element_size())
        return self.latest

    def stashed_between(self, v0: int, v1: int
                        ) -> Optional[Tuple[TileExtent, torch.Tensor]]:
        """The post-write values of the delta: available iff EXACTLY one
        write landed in ``v0 < version <= v1`` and its values were
        stashed whole (stashes of sequential writes do not compose: the
        later region may overlap the earlier; a group mesh stashes
        nothing)."""
        found = None
        for v, ext in self.log:
            if v0 < v <= v1:
                if found is not None:
                    return None
                found = (v, ext)
        if found is None:
            return None
        v, ext = found
        val = self.stash.get(v)
        if ext is None or val is None or tuple(val.shape) != ext.shape:
            return None
        return ext, val

    def dirty_between(self, v0: int, v1: int,
                      shape: tuple) -> Optional[TileExtent]:
        """Bounding box of the extents logged with ``v0 < version <=
        v1``; ``None`` means the whole array (a full marker, a dropped
        entry)."""
        box: Optional[TileExtent] = None
        seen = 0
        for v, ext in self.log:
            if v0 < v <= v1:
                seen += 1
                if ext is None:
                    return None
                if box is None:
                    box = ext
                else:
                    box = TileExtent(
                        tuple(min(a, b) for a, b in zip(box.ul, ext.ul)),
                        tuple(max(a, b) for a, b in zip(box.lr, ext.lr)),
                        shape)
        if seen == 0 and v1 > v0:
            return None  # versions fell off the bounded log
        return box


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
                 "_donate_next", "_donate_site", "_epoch", "_migration",
                 "_lineage", "_version")

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
        self._lineage: Optional[Lineage] = None  # update/assign seam
        self._version = 0

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

    def tile_shape(self) -> tuple:
        """Shape of the largest tile."""
        exts = self.extents()
        return max((e.shape for e in exts),
                   key=lambda s: np.prod(s or (1,)))

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

    # -- data health (obs/numerics.py, the numerics sentinel) -----------

    def health(self) -> dict:
        """One-shot device-side health word: NaN/Inf counts, absmax, zero
        fraction (a few reductions on the device and one read back)."""
        from ..obs import numerics

        return numerics.array_health(self)

    def tile_health(self) -> list:
        """Per-tile (per logical shard) health stats — names the
        poisoned tile, not just the array."""
        from ..obs import numerics

        return numerics.tile_stats(self)

    def watch(self, label: Optional[str] = None):
        """Install a persistent numerics watchpoint on this array
        (``st.watch(arr)``): checked now, after every ``evaluate()``, and
        via ``.check()`` / ``.update(new_arr)``."""
        from ..obs import numerics

        return numerics.watch(self, label)

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
        each rank writes where the region meets its block; a DistArray
        ``data`` sends each rank only the part its block takes
        (:func:`region_source`).

        The new array shares this array's :class:`Lineage` with
        ``region`` logged as its delta; an overwrite with
        ``FLAGS.incremental`` on also stashes the post-write values of
        the region, which the incremental engine serves a restricted
        leaf from (not on a group mesh, where the engine slices the
        rank's own block)."""
        if not isinstance(region, TileExtent):
            region = extent_mod.from_slice(region, self.shape)
        op = REDUCERS[_canonical_reducer(reducer)]
        x = self._data()
        mine = self.block_extent()
        part = region.intersection(mine) if region.size else None
        if isinstance(data, DistArray) and data.mesh.is_group:
            # each rank receives only the part of the value its block
            # takes (the write's piece exchange)
            d = region_source(data, region, self.tiling, self.shape)
            d = None if part is None else torch.broadcast_to(
                d.to(device=x.device, dtype=x.dtype), part.shape)
        else:
            d = _as_tensor(data, x.dtype, x.device)
            d = torch.broadcast_to(d, region.shape)
            if part is not None:
                d = d[part.offset_from(region).to_slice()]
        out = x.clone()
        stash = None
        if part is not None:
            sl = part.offset_from(mine).to_slice()
            out[sl] = d if op == "set" else dtypes.call(_COMBINE[op],
                                                        out[sl], d)
            if op == "set" and not self.mesh.is_group and _stash_enabled():
                stash = out[sl].clone()
        res = DistArray.from_local(out, self.tiling, self.shape, self.mesh)
        self._record_mutation(res, region, stash)
        return res

    def update_card_bytes(self, region: Any, data: "DistArray",
                          reducer: Any = None) -> float:
        """The bytes ``self.update(region, data, reducer)`` holds on this
        rank at its peak beside the arrays it is given, for a DistArray
        ``data`` on a group mesh: the value's part with its exchange's
        buffers while it moves, then the part beside its cast, the new
        block and a combine's result (``WriteExpr.card_staging``'s
        model, in the order ``update`` runs)."""
        if not isinstance(region, TileExtent):
            region = extent_mod.from_slice(region, self.shape)
        item, s_item = self.dtype.itemsize, data.dtype.itemsize
        piece, moving = source_staging(data.tiling, data.shape, s_item,
                                       region, self.tiling, self.shape,
                                       self.mesh)
        mine = self.block_extent()
        part = region.intersection(mine) if region.size else None
        after = float(mine.size) * item
        if part is not None:
            if data.dtype != self.dtype:
                after += piece / s_item * item
            if _canonical_reducer(reducer) != "set":
                after += float(part.size) * item
        return piece + max(moving, after)

    def _record_mutation(self, child: "DistArray",
                         region: Optional[TileExtent],
                         value: Optional[torch.Tensor] = None) -> None:
        """Thread this array's lineage through a functionally updated
        child: ``region`` (the whole array when ``None``) becomes the
        delta between ``self``'s version and ``child``'s, with the
        post-write region ``value`` stashed when given.

        A Lineage log is linear, but ``update()`` may branch: two
        children cut from one parent diverge, and if both shared one log
        the engine would read a sibling's writes as part of the other
        child's delta. So a child cut from a handle that is not the
        lineage tip gets a FRESH Lineage: the engine's same-lineage check
        fails, it recomputes once in full, and the new lineage serves the
        branch's own deltas from then on."""
        lin = self._lineage
        if lin is None:
            lin = Lineage()
            lin.latest = self._version
            self._lineage = lin
        elif self._version != lin.latest:
            lin = Lineage()  # branch point: ``self`` is an interior handle
            lin.latest = self._version
        child._lineage = lin
        child._version = lin.note(region, value)

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


def region_source(src: "DistArray", region: TileExtent, dst: Tiling,
                  shape: Sequence[int]) -> Optional[torch.Tensor]:
    """The part of ``src`` (broadcast numpy-style into ``region`` of an
    array of ``shape`` under ``dst``) that this rank's ``dst`` block
    takes, on this rank, from one piece exchange
    (``redistribute.move_pieces``: a rank copies the runs it holds
    itself, and no collective runs where no part changes owner). Along
    a broadcast dim the part keeps size 1 (the caller broadcasts after
    the move). None where the block misses the region."""
    from ..parallel import redistribute as redist_mod

    mesh = src.mesh
    t, sshape, want = source_layout(src.tiling, src.shape, region, dst,
                                    shape)
    blk = src.local.reshape(t.block_extent(sshape, mesh).shape)
    got = redist_mod.move_pieces(
        [redist_mod.Piece(blk, lambda c: t.block_extent(sshape, mesh, c),
                          redist_mod.free_axes(t, mesh))],
        want, sshape, blk.dtype, mesh)
    part = (region.intersection(dst.block_extent(shape, mesh))
            if region.size else None)
    return None if part is None else got


def source_staging(src_tiling: Tiling, src_shape: Sequence[int],
                   itemsize: int, region: TileExtent, dst: Tiling,
                   shape: Sequence[int], mesh: Mesh) -> tuple:
    """(the bytes of the part :func:`region_source` returns on this
    rank, the bytes its exchange holds beside it while it moves), from
    shapes and tilings (``resilience/memory.py``'s card model)."""
    from ..parallel import redistribute as redist_mod

    t, sshape, want = source_layout(src_tiling, src_shape, region, dst,
                                    shape)
    piece = float(want.block_extent(sshape, mesh).size) * itemsize
    moving = redist_mod.exchange_staging(
        [lambda c: t.block_extent(sshape, mesh, c)],
        [redist_mod.free_axes(t, mesh)], want, sshape, mesh, itemsize)
    return piece, moving


def source_layout(t: Tiling, sshape: Sequence[int], region: TileExtent,
                  dst: Tiling, shape: Sequence[int]) -> tuple:
    """(tiling, shape, where the write needs it) of a write's source
    under ``t``, with the leading size-1 dims numpy's broadcast adds to
    reach the region's rank."""
    k = len(region.shape) - len(sshape)
    sshape = tuple(int(d) for d in sshape)
    if k:
        pad = (1,) * k
        t = (tiling_mod.BoxTiling((None,) * k + t.axes, pad + t.parent,
                                  (0,) * k + t.offset)
             if isinstance(t, tiling_mod.BoxTiling)
             else Tiling((None,) * k + t.axes))
        sshape = pad + sshape
    want = tiling_mod.RegionTiling(
        dst, shape, region, [s == 1 and r != 1
                             for s, r in zip(sshape, region.shape)])
    return t, sshape, want


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
    """The lazy ``arange``'s fill, made eagerly: a group rank makes only
    its block."""
    from ..expr.ndarray import _arange_block, arange_meta

    n, dt = arange_meta(args, dtype)
    shape = (n,)
    tiling, mesh = _resolve(shape, tiling, tile_hint, mesh, device)
    ext = (tiling.block_extent(shape, mesh) if mesh.is_group
           else TileExtent((0,), shape, shape))
    return DistArray.from_local(
        _arange_block(args, int(ext.ul[0]), int(ext.lr[0]),
                      dtypes.to_torch(dtypes.canonical(dt)), mesh.device),
        tiling, shape, mesh)


def _random(shape: Sequence[int], seed: int, kind: str,
            tiling: Optional[Tiling], tile_hint: Optional[Sequence[int]],
            mesh: Optional[Mesh], device: Optional[DeviceLike]
            ) -> DistArray:
    """A counter-based f32 draw (``utils/philox.py``): a group rank
    makes only its block, the same slice of the whole draw."""
    from ..utils import philox

    shape = tuple(int(s) for s in shape)
    tiling, mesh = _resolve(shape, tiling, tile_hint, mesh, device)
    ext = (tiling.block_extent(shape, mesh) if mesh.is_group
           else philox.whole(shape))
    return DistArray.from_local(
        philox.draw(kind, seed, shape, ext, torch.float32, mesh.device),
        tiling, shape, mesh)


def rand(*shape: int, seed: int = 0, tiling: Optional[Tiling] = None,
         tile_hint: Optional[Sequence[int]] = None,
         mesh: Optional[Mesh] = None,
         device: Optional[DeviceLike] = None) -> DistArray:
    """Uniform [0, 1) f32, counter-based under ``seed`` (the lazy
    ``st.rand``'s values; not the JAX package's bits: tests feed both
    packages numpy data instead)."""
    return _random(shape, seed, "uniform", tiling, tile_hint, mesh, device)


def randn(*shape: int, seed: int = 0, tiling: Optional[Tiling] = None,
          tile_hint: Optional[Sequence[int]] = None,
          mesh: Optional[Mesh] = None,
          device: Optional[DeviceLike] = None) -> DistArray:
    """Standard normal f32, counter-based under ``seed``."""
    return _random(shape, seed, "normal", tiling, tile_hint, mesh, device)
