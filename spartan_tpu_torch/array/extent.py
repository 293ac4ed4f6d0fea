"""Rectangular tile extents — the port's own copy of the part of
``spartan_tpu/array/extent.py`` this package uses (the Python path; the
JAX package's native ctypes twin is not carried).

``TileExtent(ul, lr, array_shape)`` is a half-open region; ``tile_grid``
gives the regular grid of extents a tiling induces on a shape;
``from_slice``, ``intersection`` and the local-offset methods are the
region algebra of ``assign``/``write_array`` and ``shuffle``;
``drop_axis``/``add_axis`` carry a region through a reduction (the
incremental engine's dirt propagation); ``find_overlapping``,
``all_nonoverlapping``, ``is_complete``, ``tiles_like_hint`` and
``index_for`` are the tile-map algebra of the reference;
``flat_runs`` and ``intersect_runs`` give the row-major runs of a
region and their overlaps (the piece exchange of
``parallel/redistribute.py``). Metadata only: the data of an array is
one torch tensor whatever its tiles. Extents are immutable and
hashable.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Coord = Tuple[int, ...]


class TileExtent:
    """A half-open rectangular region ``[ul, lr)`` of an array of
    ``array_shape``."""

    __slots__ = ("ul", "lr", "array_shape", "_hash")

    def __init__(self, ul: Sequence[int], lr: Sequence[int],
                 array_shape: Optional[Sequence[int]] = None):
        self.ul: Coord = tuple(int(x) for x in ul)
        self.lr: Coord = tuple(int(x) for x in lr)
        self.array_shape: Optional[Coord] = (
            tuple(int(x) for x in array_shape)
            if array_shape is not None else None)
        if len(self.ul) != len(self.lr):
            raise ValueError(f"rank mismatch: {self.ul} vs {self.lr}")
        for u, l in zip(self.ul, self.lr):
            if u > l:
                raise ValueError(f"inverted extent: {self.ul}..{self.lr}")
        if self.array_shape is not None:
            if len(self.array_shape) != len(self.ul):
                raise ValueError("array_shape rank mismatch")
            for l, s in zip(self.lr, self.array_shape):
                if l > s:
                    raise ValueError(
                        f"extent {self.ul}..{self.lr} exceeds array "
                        f"shape {self.array_shape}")
        self._hash = hash((self.ul, self.lr, self.array_shape))

    @property
    def shape(self) -> Coord:
        return tuple(l - u for u, l in zip(self.ul, self.lr))

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def ndim(self) -> int:
        return len(self.ul)

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, TileExtent) and self.ul == other.ul
                and self.lr == other.lr
                and self.array_shape == other.array_shape)

    def __repr__(self) -> str:
        return f"Extent({self.ul}..{self.lr} of {self.array_shape})"

    def to_slice(self) -> Tuple[slice, ...]:
        return tuple(slice(u, l) for u, l in zip(self.ul, self.lr))

    def to_global(self, local_idx: Sequence[int]) -> Coord:
        return tuple(u + i for u, i in zip(self.ul, local_idx))

    def to_local(self, global_idx: Sequence[int]) -> Coord:
        return tuple(i - u for u, i in zip(self.ul, global_idx))

    def ravelled_pos(self) -> int:
        """Linear offset of ``ul`` within the full array (C order)."""
        if self.array_shape is None:
            raise ValueError("ravelled_pos requires array_shape")
        pos = 0
        for u, s in zip(self.ul, self.array_shape):
            pos = pos * s + u
        return pos

    def drop_axis(self, axis: int) -> "TileExtent":
        """Remove one axis (the extent of a reduction's output region)."""
        axis = axis % self.ndim
        ul = self.ul[:axis] + self.ul[axis + 1:]
        lr = self.lr[:axis] + self.lr[axis + 1:]
        shape = (None if self.array_shape is None else
                 self.array_shape[:axis] + self.array_shape[axis + 1:])
        return TileExtent(ul, lr, shape)

    def add_axis(self, axis: int, dim: int = 1) -> "TileExtent":
        axis = axis % (self.ndim + 1)
        ul = self.ul[:axis] + (0,) + self.ul[axis:]
        lr = self.lr[:axis] + (dim,) + self.lr[axis:]
        shape = (None if self.array_shape is None else
                 self.array_shape[:axis] + (dim,) + self.array_shape[axis:])
        return TileExtent(ul, lr, shape)

    def intersection(self, other: "TileExtent") -> Optional["TileExtent"]:
        """The overlap of two extents, or None when they do not overlap;
        the result keeps whichever array_shape is known."""
        ul = tuple(max(a, b) for a, b in zip(self.ul, other.ul))
        lr = tuple(min(a, b) for a, b in zip(self.lr, other.lr))
        if any(u >= l for u, l in zip(ul, lr)):
            return None
        shape = self.array_shape if self.array_shape is not None \
            else other.array_shape
        return TileExtent(ul, lr, shape)

    def contains(self, other: "TileExtent") -> bool:
        return (all(a <= b for a, b in zip(self.ul, other.ul))
                and all(a >= b for a, b in zip(self.lr, other.lr)))

    def offset_from(self, outer: "TileExtent") -> "TileExtent":
        """``self`` in the local coordinates of ``outer``, which must
        contain it."""
        if not outer.contains(self):
            raise ValueError(f"{self} not inside {outer}")
        ul = tuple(a - b for a, b in zip(self.ul, outer.ul))
        lr = tuple(a - b for a, b in zip(self.lr, outer.ul))
        return TileExtent(ul, lr, outer.shape)

    def offset_slice(self, inner: "TileExtent") -> Tuple[slice, ...]:
        """The slice selecting ``inner`` out of a buffer shaped like
        ``self``."""
        return inner.offset_from(self).to_slice()


def create(ul: Sequence[int], lr: Sequence[int],
           array_shape: Optional[Sequence[int]] = None) -> TileExtent:
    return TileExtent(ul, lr, array_shape)


def from_shape(shape: Sequence[int]) -> TileExtent:
    return TileExtent((0,) * len(shape), shape, shape)


def from_slice(idx, shape: Sequence[int]) -> TileExtent:
    """The extent a (tuple of) slice/int selects from ``shape``. Integer
    indices keep their axis with extent 1; negative indices and open
    slices are normalized; steps other than 1 are rejected."""
    shape = tuple(int(s) for s in shape)
    if not isinstance(idx, tuple):
        idx = (idx,)
    if len(idx) > len(shape):
        raise IndexError(f"too many indices {idx} for shape {shape}")
    idx = idx + (slice(None),) * (len(shape) - len(idx))
    ul: List[int] = []
    lr: List[int] = []
    for i, (ix, dim) in enumerate(zip(idx, shape)):
        if isinstance(ix, slice):
            start, stop, step = ix.indices(dim)
            if step != 1:
                raise ValueError("strided slices unsupported in extent algebra")
            ul.append(start)
            lr.append(max(start, stop))
        elif isinstance(ix, (int, np.integer)):
            ii = int(ix)
            if ii < 0:
                ii += dim
            if not 0 <= ii < dim:
                raise IndexError(f"index {ix} out of bounds for axis {i} "
                                 f"with size {dim}")
            ul.append(ii)
            lr.append(ii + 1)
        else:
            raise TypeError(f"unsupported index {ix!r}")
    return TileExtent(ul, lr, shape)


def intersection(a: TileExtent, b: TileExtent) -> Optional[TileExtent]:
    return a.intersection(b)


def find_overlapping(extents: Sequence[TileExtent],
                     region: TileExtent) -> List[TileExtent]:
    """All extents intersecting ``region`` (the tile lookup of region
    fetch/update)."""
    return [e for e in extents if e.intersection(region) is not None]


def all_nonoverlapping(extents: Sequence[TileExtent]) -> bool:
    for i, a in enumerate(extents):
        for b in extents[i + 1:]:
            if a.intersection(b) is not None:
                return False
    return True


def is_complete(shape: Sequence[int], extents: Sequence[TileExtent]) -> bool:
    """Do the (non-overlapping) extents exactly cover an array of
    ``shape``?"""
    total = int(np.prod([int(s) for s in shape])) if len(shape) else 1
    return (sum(e.size for e in extents) == total
            and all_nonoverlapping(extents))


def compute_splits(dim: int, n: int) -> List[Tuple[int, int]]:
    """Split ``dim`` into ``n`` contiguous chunks, remainder spread over the
    leading chunks (an even split when dim % n == 0)."""
    n = max(1, min(n, dim)) if dim > 0 else 1
    base, extra = divmod(dim, n)
    splits = []
    lo = 0
    for i in range(n):
        hi = lo + base + (1 if i < extra else 0)
        splits.append((lo, hi))
        lo = hi
    return splits


def tile_grid(shape: Sequence[int],
              tiles_per_dim: Sequence[int]) -> List[TileExtent]:
    """Regular grid of extents: ``tiles_per_dim[i]`` chunks along axis i,
    in row-major tile order."""
    shape = tuple(int(s) for s in shape)
    per_axis = [compute_splits(d, n) for d, n in zip(shape, tiles_per_dim)]
    out = []
    for combo in itertools.product(*per_axis):
        ul = tuple(c[0] for c in combo)
        lr = tuple(c[1] for c in combo)
        out.append(TileExtent(ul, lr, shape))
    return out


def tiles_like_hint(shape: Sequence[int], tile_hint: Sequence[int]
                    ) -> List[TileExtent]:
    """Grid from a tile-size hint (the reference's ``tile_hint``: the
    desired per-tile shape)."""
    shape = tuple(int(s) for s in shape)
    tiles_per_dim = [max(1, -(-d // max(1, int(t))))
                     for d, t in zip(shape, tile_hint)]
    return tile_grid(shape, tiles_per_dim)


def index_for(extents: Sequence[TileExtent]) -> Dict[TileExtent, int]:
    return {e: i for i, e in enumerate(extents)}


def flat_runs(ext: TileExtent, shape: Sequence[int]
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, lengths), int64: the contiguous runs of the region
    ``ext`` of an array of ``shape`` in its row-major (C) order, in
    increasing order. The axes after the last one the region cuts merge
    into each run, so a block of whole rows is one run."""
    shape = tuple(int(s) for s in shape)
    if ext.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if not shape:
        return np.zeros(1, np.int64), np.ones(1, np.int64)
    k = len(shape) - 1
    while k > 0 and ext.ul[k] == 0 and ext.lr[k] == shape[k]:
        k -= 1
    strides = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    length = (ext.lr[k] - ext.ul[k]) * strides[k]
    starts = np.array([sum(u * s for u, s in zip(ext.ul, strides))],
                      np.int64)
    for i in range(k):
        step = np.arange(ext.lr[i] - ext.ul[i], dtype=np.int64) * strides[i]
        starts = (starts[:, None] + step[None, :]).reshape(-1)
    return starts, np.full(starts.shape[0], length, np.int64)


def intersect_runs(a: Tuple[np.ndarray, np.ndarray],
                   b: Tuple[np.ndarray, np.ndarray]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
    """The overlaps of two increasing lists of disjoint runs, in
    increasing order: (starts, lengths, the index of the run of ``a``
    and of ``b`` each overlap lies in)."""
    a_s, a_l = a
    b_s, b_l = b
    a_e, b_e = a_s + a_l, b_s + b_l
    lo = np.searchsorted(b_e, a_s, side="right")
    hi = np.searchsorted(b_s, a_e, side="left")
    cnt = np.maximum(hi - lo, 0)
    ai = np.repeat(np.arange(a_s.shape[0], dtype=np.int64), cnt)
    first = np.cumsum(cnt) - cnt
    bj = lo[ai] + np.arange(ai.shape[0], dtype=np.int64) - first[ai]
    st = np.maximum(a_s[ai], b_s[bj])
    en = np.minimum(a_e[ai], b_e[bj])
    keep = en > st
    return st[keep], (en - st)[keep], ai[keep], bj[keep]
