"""Tiling vocabulary: which logical mesh axes split which array axes.

Port of ``spartan_tpu/array/tiling.py``. There a ``Tiling`` also names
a GSPMD ``PartitionSpec``; here ``axes[i]`` is the mesh axis splitting
array axis ``i`` (or None), ``extents()`` gives the tile grid it
induces on a shape, and ``block_extent()`` the one block a mesh
position holds. On a logical mesh an array's data is one tensor on one
device whatever its tiling; on a group mesh each rank stores its
``block_extent()`` (``array/distarray.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..parallel import mesh as mesh_mod
from ..parallel.mesh import AXIS_COL, AXIS_ROW, Mesh
from . import extent as extent_mod
from .extent import TileExtent


class Tiling:
    """Assignment of mesh axes to array axes. Hashable; used in plan
    cache keys."""

    __slots__ = ("axes",)

    def __init__(self, axes: Sequence[Optional[str]]):
        self.axes: Tuple[Optional[str], ...] = tuple(axes)

    def __hash__(self) -> int:
        return hash(self.axes)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Tiling) and self.axes == other.axes

    def __repr__(self) -> str:
        return f"Tiling({self.axes})"

    @property
    def ndim(self) -> int:
        return len(self.axes)

    def sharded_axes(self) -> List[int]:
        return [i for i, a in enumerate(self.axes) if a is not None]

    def drop_axis(self, axis: int) -> "Tiling":
        axis = axis % self.ndim
        return Tiling(self.axes[:axis] + self.axes[axis + 1:])

    def add_axis(self, axis: int,
                 mesh_axis: Optional[str] = None) -> "Tiling":
        axis = axis % (self.ndim + 1)
        return Tiling(self.axes[:axis] + (mesh_axis,) + self.axes[axis:])

    def transpose(self, perm: Sequence[int]) -> "Tiling":
        return Tiling(tuple(self.axes[p] for p in perm))

    def mesh_axis_of(self, array_axis: int) -> Optional[str]:
        return self.axes[array_axis]

    def with_axis(self, axis: int, mesh_axis: Optional[str]) -> "Tiling":
        axes = list(self.axes)
        axes[axis] = mesh_axis
        return Tiling(axes)

    # -- tile-grid view -------------------------------------------------

    def tiles_per_dim(self, mesh: Optional[Mesh] = None) -> Tuple[int, ...]:
        mesh = mesh or mesh_mod.get_mesh()

        def axis_size(a) -> int:
            if a is None:
                return 1
            if isinstance(a, tuple):  # multi-axis split, e.g. ('x', 'y')
                n = 1
                for sub in a:
                    n *= mesh.shape[sub]
                return n
            return mesh.shape[a]

        return tuple(axis_size(a) for a in self.axes)

    def extents(self, shape: Sequence[int],
                mesh: Optional[Mesh] = None) -> List[TileExtent]:
        """The tile extents this tiling induces on ``shape``, row-major
        over the mesh axes (the JAX package's shard order)."""
        return extent_mod.tile_grid(shape, self.tiles_per_dim(mesh))

    def block_extent(self, shape: Sequence[int], mesh: Optional[Mesh] = None,
                     coords: Optional[dict] = None) -> TileExtent:
        """The block of ``shape`` this tiling gives the mesh position
        ``coords`` (by default the group mesh's own rank): along each dim,
        the tile that the position's index over the dim's mesh axes
        (row-major over a tuple of axes) picks from
        ``extent.compute_splits``. A replicated mesh axis gives every
        position along it the same block; a position past a dim's last
        tile (a dim shorter than its tile count) holds an empty block at
        the dim's end."""
        mesh = mesh or mesh_mod.get_mesh()
        coords = mesh.coords if coords is None else coords
        ul, lr = [], []
        for d, a in zip(shape, self.axes):
            d = int(d)
            splits = extent_mod.compute_splits(d, tile_count(a, mesh))
            i = tile_index(a, coords, mesh)
            lo, hi = splits[i] if i < len(splits) else (d, d)
            ul.append(lo)
            lr.append(hi)
        return TileExtent(ul, lr, shape)

    def divisible(self, shape: Sequence[int],
                  mesh: Optional[Mesh] = None) -> bool:
        """True if every tiled axis divides evenly (what a per-shard
        schedule and ``map_shards`` need)."""
        for d, n in zip(shape, self.tiles_per_dim(mesh)):
            if n > 1 and d % n != 0:
                return False
        return True


class BoxTiling(Tiling):
    """Where the ranks of a group mesh hold a box cut from a tiled
    array: the box at ``offset`` in an array of shape ``parent`` tiled
    ``axes``, each position holding the part of the box that its block
    of the parent covers (possibly empty). The incremental engine's
    restricted walk (``expr/incremental.py``) carries the values cut
    from its leaves under it, so the restricted nodes and the splice
    work inside each rank's block; a move to any other tiling goes
    through the piece exchange (``parallel/redistribute.relayout``)."""

    __slots__ = ("parent", "offset")

    def __init__(self, axes: Sequence[Optional[str]],
                 parent: Sequence[int], offset: Sequence[int]):
        super().__init__(axes)
        self.parent: Tuple[int, ...] = tuple(int(d) for d in parent)
        self.offset: Tuple[int, ...] = tuple(int(o) for o in offset)

    def __hash__(self) -> int:
        return hash((self.axes, self.parent, self.offset))

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, BoxTiling) and self.axes == other.axes
                and self.parent == other.parent
                and self.offset == other.offset)

    def __repr__(self) -> str:
        return (f"BoxTiling({self.axes}, parent={self.parent}, "
                f"offset={self.offset})")

    def drop_axis(self, axis: int) -> "BoxTiling":
        axis = axis % self.ndim
        return BoxTiling(self.axes[:axis] + self.axes[axis + 1:],
                         self.parent[:axis] + self.parent[axis + 1:],
                         self.offset[:axis] + self.offset[axis + 1:])

    def whole(self, axis: int) -> "BoxTiling":
        """The tiling with dim ``axis`` held whole by every position (a
        dim of size 1 after a reduction kept it)."""
        return BoxTiling(self.axes[:axis] + (None,) + self.axes[axis + 1:],
                         self.parent[:axis] + (1,) + self.parent[axis + 1:],
                         self.offset[:axis] + (0,) + self.offset[axis + 1:])

    def block_extent(self, shape: Sequence[int], mesh: Optional[Mesh] = None,
                     coords: Optional[dict] = None) -> TileExtent:
        blk = Tiling(self.axes).block_extent(self.parent, mesh, coords)
        ul, lr = [], []
        for lo, hi, off, d in zip(blk.ul, blk.lr, self.offset, shape):
            a = min(max(lo - off, 0), int(d))
            ul.append(a)
            lr.append(max(a, min(max(hi - off, 0), int(d))))
        return TileExtent(ul, lr, shape)

    def extents(self, shape: Sequence[int],
                mesh: Optional[Mesh] = None) -> List[TileExtent]:
        mesh = mesh or mesh_mod.get_mesh()
        return [self.block_extent(shape, mesh, {AXIS_ROW: i, AXIS_COL: j})
                for i in range(mesh.shape[AXIS_ROW])
                for j in range(mesh.shape[AXIS_COL])]

    def divisible(self, shape: Sequence[int],
                  mesh: Optional[Mesh] = None) -> bool:
        return False  # its blocks follow the parent's grid, not shape's


class RegionTiling(Tiling):
    """Where the positions of a group mesh need the source of a write
    into ``region`` of an array of ``parent`` under ``dst``: each
    position the part of the region its ``dst`` block covers, in the
    source's coordinates; along a dim the source broadcasts (``bcast``:
    its size 1) the whole dim where that part is not empty. A position
    whose block misses the region needs nothing. The write's piece
    exchange moves a source to it (``array/distarray.region_source``)."""

    __slots__ = ("dst", "parent", "region", "bcast")

    def __init__(self, dst: Tiling, parent: Sequence[int],
                 region: TileExtent, bcast: Sequence[bool]):
        super().__init__(dst.axes)
        self.dst = dst
        self.parent: Tuple[int, ...] = tuple(int(d) for d in parent)
        self.region = region
        self.bcast: Tuple[bool, ...] = tuple(bool(b) for b in bcast)

    def __hash__(self) -> int:
        return hash((self.dst, self.parent, self.region, self.bcast))

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, RegionTiling) and self.dst == other.dst
                and self.parent == other.parent
                and self.region == other.region
                and self.bcast == other.bcast)

    def __repr__(self) -> str:
        return (f"RegionTiling({self.dst}, parent={self.parent}, "
                f"region={self.region}, bcast={self.bcast})")

    def block_extent(self, shape: Sequence[int], mesh: Optional[Mesh] = None,
                     coords: Optional[dict] = None) -> TileExtent:
        blk = self.dst.block_extent(self.parent, mesh, coords)
        part = self.region.intersection(blk) if self.region.size else None
        if part is None:
            return TileExtent((0,) * len(shape), (0,) * len(shape), shape)
        ul = [0 if b else a - r for a, r, b in
              zip(part.ul, self.region.ul, self.bcast)]
        lr = [1 if b else a - r for a, r, b in
              zip(part.lr, self.region.ul, self.bcast)]
        return TileExtent(ul, lr, shape)

    def extents(self, shape: Sequence[int],
                mesh: Optional[Mesh] = None) -> List[TileExtent]:
        mesh = mesh or mesh_mod.get_mesh()
        return [self.block_extent(shape, mesh, {AXIS_ROW: i, AXIS_COL: j})
                for i in range(mesh.shape[AXIS_ROW])
                for j in range(mesh.shape[AXIS_COL])]

    def divisible(self, shape: Sequence[int],
                  mesh: Optional[Mesh] = None) -> bool:
        return False  # its blocks follow the destination's grid


def box_of(t: Tiling, shape: Sequence[int], ul: Sequence[int]) -> BoxTiling:
    """The :class:`BoxTiling` of the box at ``ul`` cut from an array of
    ``shape`` under ``t`` (itself possibly a box: the cuts compose)."""
    if isinstance(t, BoxTiling):
        return BoxTiling(t.axes, t.parent,
                         tuple(a + b for a, b in zip(t.offset, ul)))
    return BoxTiling(t.axes, shape, ul)


def mesh_axes_of(a) -> Tuple[str, ...]:
    """The mesh axes of one tiling entry (None, an axis, or a tuple of
    axes)."""
    if a is None:
        return ()
    return tuple(a) if isinstance(a, tuple) else (a,)


def tile_count(a, mesh: Mesh) -> int:
    """Tiles along a dim split by the tiling entry ``a``."""
    n = 1
    for sub in mesh_axes_of(a):
        n *= mesh.shape[sub]
    return n


def tile_index(a, coords: dict, mesh: Mesh) -> int:
    """Row-major index of a position's tile along a dim split by ``a``."""
    idx = 0
    for sub in mesh_axes_of(a):
        idx = idx * mesh.shape[sub] + coords[sub]
    return idx


# -- canonical tilings --------------------------------------------------


def replicated(ndim: int) -> Tiling:
    return Tiling((None,) * ndim)


def row(ndim: int) -> Tiling:
    """Tile the leading axis over the mesh's row axis."""
    if ndim == 0:
        return Tiling(())
    return Tiling((AXIS_ROW,) + (None,) * (ndim - 1))


def col(ndim: int) -> Tiling:
    """Tile the second axis (requires ndim >= 2)."""
    if ndim < 2:
        return replicated(ndim)
    return Tiling((None, AXIS_COL) + (None,) * (ndim - 2))


def block(ndim: int) -> Tiling:
    """2-D block tiling of the leading two axes."""
    if ndim < 2:
        return row(ndim)
    return Tiling((AXIS_ROW, AXIS_COL) + (None,) * (ndim - 2))


def row_t(ndim: int) -> Tiling:
    """Transposed row tiling: the leading axis on the *col* mesh axis
    (a smart-tiling candidate that lets a transpose line up)."""
    if ndim == 0:
        return Tiling(())
    return Tiling((AXIS_COL,) + (None,) * (ndim - 1))


def col_t(ndim: int) -> Tiling:
    """Transposed col tiling: the second axis on the *row* mesh axis."""
    if ndim < 2:
        return replicated(ndim)
    return Tiling((None, AXIS_ROW) + (None,) * (ndim - 2))


def block_t(ndim: int) -> Tiling:
    """Transposed block tiling: ``(y, x)``."""
    if ndim < 2:
        return row_t(ndim)
    return Tiling((AXIS_COL, AXIS_ROW) + (None,) * (ndim - 2))


def flat_row(ndim: int) -> Tiling:
    """The leading axis split over both mesh axes, row-major: the
    finest 1-D split."""
    if ndim == 0:
        return Tiling(())
    return Tiling(((AXIS_ROW, AXIS_COL),) + (None,) * (ndim - 1))


def from_tile_hint(shape: Sequence[int], tile_hint: Sequence[int],
                   mesh: Optional[Mesh] = None) -> Tiling:
    """Map the reference's ``tile_hint`` (desired per-tile shape) onto the
    nearest expressible mesh tiling: axes whose hint is smaller than the
    dim get tiled, in order, onto the mesh axes larger than 1."""
    mesh = mesh or mesh_mod.get_mesh()
    shape = tuple(int(s) for s in shape)
    want_split = [i for i, (d, t) in enumerate(zip(shape, tile_hint))
                  if int(t) < d]
    axes: List[Optional[str]] = [None] * len(shape)
    avail = [a for a in (AXIS_ROW, AXIS_COL) if mesh.shape.get(a, 1) > 1]
    for i, array_axis in enumerate(want_split[:len(avail)]):
        axes[array_axis] = avail[i]
    return Tiling(axes)


def default_tiling(shape: Sequence[int],
                   mesh: Optional[Mesh] = None) -> Tiling:
    """Default placement: tile the largest divisible axis on the mesh row
    axis (and the next largest on col if it helps)."""
    mesh = mesh or mesh_mod.get_mesh()
    ndim = len(shape)
    if ndim == 0:
        return Tiling(())
    nx, ny = mesh_mod.mesh_axis_sizes(mesh)
    axes: List[Optional[str]] = [None] * ndim
    order = sorted(range(ndim), key=lambda i: -int(shape[i]))
    placed_row = placed_col = False
    for i in order:
        d = int(shape[i])
        if not placed_row and nx > 1 and d % nx == 0 and d >= nx:
            axes[i] = AXIS_ROW
            placed_row = True
        elif not placed_col and ny > 1 and d % ny == 0 and d >= ny:
            axes[i] = AXIS_COL
            placed_col = True
    return Tiling(axes)


def sanitize(t: Tiling, shape: Sequence[int],
             mesh: Optional[Mesh] = None) -> Tiling:
    """Drop mesh axes from dims they don't divide evenly."""
    if isinstance(t, (BoxTiling, RegionTiling)):
        return t  # its blocks follow its parent's grid
    mesh = mesh or mesh_mod.get_mesh()
    axes = list(t.axes)
    for i, (d, n) in enumerate(zip(shape, t.tiles_per_dim(mesh))):
        if n > 1 and (int(d) % n != 0 or int(d) < n):
            axes[i] = None
    return Tiling(axes)
