"""Tiling vocabulary: which logical mesh axes split which array axes.

Port of ``spartan_tpu/array/tiling.py``. There a ``Tiling`` also names
a GSPMD ``PartitionSpec``; here it is pure metadata: ``axes[i]`` is the
mesh axis splitting array axis ``i`` (or None), and ``extents()`` gives
the tile grid it induces on a shape over the logical mesh. An array's
data is one tensor on one device whatever its tiling.
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

    def divisible(self, shape: Sequence[int],
                  mesh: Optional[Mesh] = None) -> bool:
        """True if every tiled axis divides evenly (what a per-shard
        schedule and ``map_shards`` need)."""
        for d, n in zip(shape, self.tiles_per_dim(mesh)):
            if n > 1 and d % n != 0:
                return False
        return True


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
    mesh = mesh or mesh_mod.get_mesh()
    axes = list(t.axes)
    for i, (d, n) in enumerate(zip(shape, t.tiles_per_dim(mesh))):
        if n > 1 and (int(d) % n != 0 or int(d) < n):
            axes[i] = None
    return Tiling(axes)
