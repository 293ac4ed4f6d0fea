"""Delta-aware incremental evaluation (port of
``spartan_tpu/expr/incremental.py``).

The plan cache (expr/base.py) made "same DAG" skip planning; this layer
makes "same DAG + mostly-same data" skip most of the compute. The
mutation seam is ``DistArray.update()`` / the ``assign`` expr route
(array/distarray.py): a functional update returns a new handle that
SHARES its parent's :class:`~..array.distarray.Lineage` with the written
extent logged, so the raw-DAG plan key — leaf signatures are positional
shape/dtype/tiling, not data identity — still hits, and this module can
tell exactly which tiles moved since the result it cached.

On a warm ``evaluate()`` whose plan is cached (and only there:
``intercept`` is called from the plan-cache hit path, behind one flag
read when ``FLAGS.incremental`` is off):

1. Per-leaf dirty extents come from comparing each leaf against the
   snapshot the result-cache entry recorded (same handle = clean; same
   lineage at a later version = the logged extents; anything else =
   whole-leaf dirty).
2. Dirty boxes propagate bottom-up through the RAW DAG: map = identity
   under broadcast, axis-reduce = the box with reduced axes collapsed,
   dot = dirty rows/cols of the non-contracted dims; reduce_all, loop,
   shuffle and anything unknown = whole-node (over-recompute of a
   deterministic program is bit-equal).
3. If the root's dirty box is a small enough sub-region
   (``FLAGS.incremental_max_dirty_frac``), the engine builds a
   RESTRICTED sub-DAG computing just that region, evaluates it through
   the ordinary ``evaluate()`` and splices it into a clone of the
   cached result. When every dirty leaf's delta is one stashed write,
   the restriction uses the exact root box and the stash is the leaf;
   otherwise a leaf is a slice of its parent whose starts are walk
   arguments (``ScalarExpr``) and whose sizes are rounded up to powers
   of two, so deltas of similar size share one plan. On a logical mesh
   the slice is a view of one tensor: the JAX package's reason to
   prefer the stash (GSPMD lowers a traced-start slice of a sharded
   axis to a gather) does not apply here, but the plan keys and the
   ``incremental_*`` counters are the JAX package's on the same stream.
4. Anything the rules cannot prove clean falls back to the ordinary
   full dispatch with the reason in the metrics and ``st.explain``.

Bit-equality with a full recompute rests on the restricted program
running the same per-element reductions. Elementwise maps do so by
construction. A sum, mean or product restricted to a window of its
kept axes does where its reduction keeps each kept element's order for
the narrower window: on the card a float32 one lowers through the
hand-written fixed-order kernel (``kernels/reduce.py``), whose order
depends only on the reduced length; integer and bool sums and products
are exact in any order; torch's CPU sums hold it for an inner axis in
any window and for an outer one at windows of 32 columns in the layouts
measured; :func:`reduce_granule` says which, per node, or that none does
(``reduction-order``). A product does where its kernel reduces each
output element of the narrower shape in the same order as for the full
one. On the card a float32 product of one 1-D and one 2-D
operand lowers through the hand-written fixed-order kernel
(``kernels/gemv.py``), whose order depends only on the contraction's
length, so its restricted window is any window; integer and bool
products are exact in any order. Other products go to BLAS, which does
not promise the order: it picks kernels, thread splits and split-K by
shape. :func:`product_granule` says, per product node, the width its
restricted output window is widened to (start rounded down, end rounded
up to a multiple of it, or to the end of the axis) so that the orders
match, or that no width does (:func:`order_granule` for BLAS); then the
dot's dirt is whole-node under the counted reason ``contraction-order``.

Cached results live in a bounded LRU under ``FLAGS.result_cache_bytes``
(reported to the memory governor via :func:`cache_bytes` and the
``incremental_cache_bytes`` gauge). Entries are mesh-epoch fenced:
``evict_stale()`` (from ``evict_stale_plans()`` after elastic recovery)
reaps entries born under a dead mesh, and an entry whose result or
leaves were donated is dropped on first touch. A published entry is
never written in place: a splice clones the cached result.

On a group mesh every rank caches its block of the result (whether to
cache is decided on the global result size, so every rank caches
alike), and the same decisions run on every rank from data every rank
has alike: the lineage's global regions, the propagated box, the
``dirty-frac`` threshold on the global fraction, the product granule
(agreed once per group and kind of product, :func:`product_granule`)
and the cache hit. The restricted sub-DAG and the splice run as one
group walk: a leaf's slice is the rank's share of the box, the part of
it that the rank's block holds (possibly empty;
``array/tiling.BoxTiling``), elementwise maps and reductions along
unsplit axes compute only that share, a reduction along a split axis or
a product issues its collective over the box's slab on every rank (an
empty share takes part), and the splice writes each rank's share into a
clone of its cached block. No
collective moves the box when the walk keeps it where the ranks hold
it. The mutation seam stashes nothing there: the slice of the rank's
own block serves the restricted leaf.

Expr-layer imports happen inside functions: expr/base.py binds this
module at import time (``incremental_mod``, swappable by a null shim)
and map/reduce/dot import base themselves.
"""

from __future__ import annotations

import threading
import types
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..array.extent import TileExtent
from ..kernels import gemv
from ..kernels import reduce as kreduce
from ..obs.metrics import REGISTRY
from ..parallel import mesh as mesh_mod
from ..utils import dtypes
from ..utils import profiling as prof
from ..utils.config import FLAGS

_INC_FLAG = FLAGS.define_bool(
    "incremental", False,
    "Delta-aware evaluation: on a plan-cache hit, recompute only the "
    "tiles dirtied by DistArray.update()/assign since the cached "
    "result, splicing them into the cached output (bit-equal to a "
    "full recompute; falls back to one whenever cleanliness can't be "
    "proven, with the reason in incremental_* metrics + st.explain). "
    "Off by default: the hit path then pays exactly one flag read.")
_CACHE_FLAG = FLAGS.define_int(
    "result_cache_bytes", 256 << 20,
    "Budget for the incremental engine's per-plan result cache "
    "(bounded LRU of device tensors). Each entry is charged for its "
    "cached result PLUS the leaf snapshots it pins; residency (incl. "
    "the mutation-seam stash kept alive by cached snapshots) is "
    "visible to the memory governor via the incremental_cache_bytes "
    "gauge / expr.incremental.cache_bytes(). A single entry larger "
    "than the budget is never cached.")
_FRAC_FLAG = FLAGS.define_float(
    "incremental_max_dirty_frac", 0.25,
    "Dirty-fraction ceiling for the incremental path: when the root's "
    "propagated dirty box exceeds this fraction of the output, a full "
    "recompute is cheaper than restrict+splice and the engine falls "
    "back (reason 'dirty-frac').")

NOT_HANDLED = object()  # sentinel: caller proceeds with the full path

_MISS = object()


class _Full:
    """Whole-node dirty (the conservative propagation sentinel)."""

    __repr__ = __str__ = lambda self: "FULL"


FULL = _Full()


class Unsupported(Exception):
    """A DAG construct the restriction builder has no rule for — the
    caller degrades to a full recompute with this as the reason."""


# -- the contraction order of a restricted product ---------------------


def order_granule(device: torch.device) -> Optional[int]:
    """The width a restricted BLAS product's output window is widened to
    on ``device`` so that each output element is reduced in the same
    order as in the full product, or None when no width does. On the
    card a float32 vector product does not ask: it lowers through the
    fixed-order kernel, any window of which holds the order
    (:func:`product_granule`).

    * ``cpu``: the BLAS GEMV kernels vectorize over the output in
      blocks of 16 float32 lanes and treat the remainder in a tail, and
      the GEMM kernels block the output in panels; a window whose ends
      sit on multiples of 256 (or at the end of the axis) runs every
      element through the same code as the full product on one thread
      (measured on vector products up to 16,384 wide and matrix products
      up to 4096^2; multiples of 64 miss on 1024^2 matrix products).
      With several threads the library splits the contraction by shape,
      and no window holds the order.
    * ``cuda``: cuBLAS chooses its kernel (and split-K) by the output's
      width. On an NVIDIA H100 80GB HBM3 (torch 2.11, CUDA 12.8) no
      window width from 1 to 1024 gave the full product's bits for
      vector-matrix, matrix-vector or matrix products of 4096 to 32,768
      wide (``chip_smoke.py``'s ``[incremental]`` phase repeats the
      check on every run), so a matrix-matrix product's dirt, and a
      float16, bfloat16 or float64 product's, is whole-node there.
    """
    if device.type == "cpu":
        return 256 if torch.get_num_threads() == 1 else None
    return None


def cpu_reduce_granule(device: torch.device) -> Optional[int]:
    """The width the kept axes of a restricted torch sum are widened to
    on ``device`` (window ends on multiples of it from the start of each
    block the reduction runs on, or at the block's end) where a reduced
    axis lies outside a cut kept axis, or None when no width keeps the
    full reduction's order. A float32 sum, mean or product on the card
    does not ask: it lowers through the fixed-order kernel, any window of
    which holds the order (:func:`reduce_granule`).

    * ``cpu``: torch sums an outer axis over the inner columns in
      vectorized groups, and columns outside a whole group take another
      summation order; windows on multiples of 32 columns gave the full
      sum's bits for every shape measured (31 to 20,000 rows, 16 to
      1000 columns, 1 and 4 threads), windows on multiples of 16 did
      not.
    * ``cuda``: the reduction's launch configuration follows the shape,
      so a restricted float16, bfloat16 or float64 sum's dirt is
      whole-node there under the counted reason ``reduction-order``.

    The CPU width holds only where it was measured: one kept axis after
    the reduced ones, and that axis the last (:func:`_window_holds`).
    With several kept axes after them torch vectorizes over their
    flattened run, and the full sum's tail (the last ``W mod 32`` of the
    ``W`` flattened columns) takes another order than a restricted sum
    of the same columns: (300, 3, 200) at windows 160 and 192,
    (300, 5, 100) at 64, (300, 4, 200) and (300, 2, 208) at 192 and
    (50, 3, 1000) at 960 and 992 missed the full sum's bits, (300, 3,
    192), whose flattened width has no tail, did not. Those sums fall
    back under ``reduction-order`` on the CPU; on the card a float32 one
    takes the kernel.

    ``max``/``min``/``argmax``/``argmin`` (exact in any order) are not
    held to it, nor, on the CPU, an inner axis (each kept element
    reduced over contiguous values): restricted windows of ``x.sum(1)``
    gave the full sum's bits at (64, 2^20), (1024, 16,384), (16,384,
    4096) and (8, 2^22) with 8 threads. On the card torch's inner sums
    of 16,384^2 missed the full sum's bits in row windows of 1 and 7
    rows (``chip_smoke.py``'s ``[incremental]`` probe, C47), so there
    every cut kept axis is held (:func:`_ordered_cut`): a float32 sum
    takes the kernel, the other float dtypes keep ``reduction-order``."""
    return 32 if device.type == "cpu" else None


def _window_holds(n: Any) -> bool:
    """True where :func:`cpu_reduce_granule`'s width was measured to
    keep a restricted sum of the reduction ``n`` in the full sum's order:
    the kept axes after its first reduced axis are one, the last."""
    ps = n._pre_shape
    first = min(n.axis)
    return [d for d in range(len(ps))
            if d > first and d not in n.axis] == [len(ps) - 1]


_ORDERED = ("sum", "mean", "prod")


def _ordered_cut(n: Any, out_box: TileExtent,
                 device: torch.device) -> List[int]:
    """The pre-reduce axes of the reduction ``n`` that its restricted
    output ``out_box`` cuts where their restricted sums may take another
    order than the whole reduction's (:func:`reduce_granule`), where
    ``n``'s op sums: on the CPU the cut axes with a reduced axis before
    them (torch's CPU sums of an inner axis keep the order in any window
    of rows, :func:`cpu_reduce_granule`), on the card every cut axis
    (torch's inner sums there may split a row over blocks by the
    output's size, C47)."""
    if n.op not in _ORDERED or n.axis is None:
        return []
    ps = n._pre_shape
    kept = [d for d in range(len(ps)) if d not in n.axis]
    keep_dims = n.keepdims and n.op not in ("argmax", "argmin")
    out = []
    for i, d in enumerate(kept):
        j = d if keep_dims else i
        if (out_box.ul[j], out_box.lr[j]) != (0, ps[d]) and (
                device.type != "cpu" or any(a < d for a in n.axis)):
            out.append(d)
    return out


def _exact_reduce(n: Any) -> bool:
    """True for an integer or bool ``sum``/``prod``: exact in any
    order."""
    dt = dtypes.to_numpy(n._pre_dtype)
    return n.op in ("sum", "prod") and (dt == np.bool_
                                        or np.issubdtype(dt, np.integer))


def reduce_granule(n: Any, mesh: Any) -> Optional[int]:
    """The width the reduction ``n``'s restricted kept axes are widened
    to on ``mesh`` where :func:`_ordered_cut` names a cut axis, so that
    each element is reduced in the whole reduction's order, or None
    where no width does (its dirt is then whole-node under
    ``reduction-order``):

    * 1 for integer and bool sums and products, exact in any order;
    * 1 (any window, no widening) where ``n`` lowers through the
      fixed-order kernel (``kernels/reduce.py::routes``: a float32
      ``sum``, ``mean`` or ``prod`` on the card), whose per-element order
      depends only on the reduced length;
    * :func:`cpu_reduce_granule` of the mesh's device where
      :func:`_window_holds`, else None (so a float16, bfloat16 or
      float64 sum on the card keeps ``reduction-order``, its cut an
      outer or an inner one).

    On a group mesh a kernel reduction keeps ``reduction-order`` where a
    mesh axis that splits a reduced axis has three or more ranks: the
    ranks' partial sums meet in an all-reduce along it whose ring may
    add them in an order that follows the message's length; two partial
    sums meet in one add, which is commutative, so a line of two keeps
    the order. Every rank gives the same answer: it follows the node's
    shapes, dtype and tiling and the mesh's device type."""
    if _exact_reduce(n):
        return 1
    if not kreduce.routes(mesh.device, n._pre_dtype, n.op, n.axis,
                          len(n._pre_shape)):
        return cpu_reduce_granule(mesh.device) if _window_holds(n) else None
    if not mesh.is_group:
        return 1
    from ..array import tiling as tiling_mod

    t = n._pre_tiling()
    if any(mesh.shape[sub] >= 3 for d in n.axis
           for sub in tiling_mod.mesh_axes_of(t.axes[d])):
        return None
    return 1


def _reduce_window(n: Any, d: int, lo: int, hi: int, granule: int,
                   mesh: Any) -> Tuple[int, int]:
    """``[lo, hi)`` of pre-reduce axis ``d`` widened to the points
    ``cpu_reduce_granule`` allows: multiples of ``granule`` from the start
    of each block the reduction runs on (one block on a logical mesh,
    the ranks' blocks of the pre-reduce tiling on a group mesh), and
    the blocks' ends."""
    from ..array import extent as extent_mod
    from ..array import tiling as tiling_mod

    size = n._pre_shape[d]
    tiles = (tiling_mod.tile_count(n._pre_tiling().axes[d], mesh)
             if mesh.is_group else 1)
    points = set()
    for a, b in extent_mod.compute_splits(size, tiles):
        points.update(range(a, b, granule))
        points.add(b)
    points.add(0)
    return (max(p for p in points if p <= lo),
            min(p for p in points if p >= hi))


def _product_kind(n: Any) -> str:
    """``exact`` for an integer or bool product (exact in any order),
    ``vector`` for a shape and dtype the fixed-order kernel computes
    (``gemv.takes``), else ``blas``. Every rank of a group says the same
    of a node."""
    dt = dtypes.to_numpy(n.dtype)
    if dt == np.bool_ or np.issubdtype(dt, np.integer):
        return "exact"
    return "vector" if gemv.takes(n.a, n.b, n.dtype) else "blas"


# (id(process group), kind of product) -> the granule its ranks agreed on
_agreed: Dict[Tuple[int, str], Optional[int]] = {}


def product_granule(n: Any, mesh: Any) -> Optional[int]:
    """The width the product ``n``'s restricted output window is
    widened to on ``mesh`` so that each element is reduced in the whole
    product's order, or None where no width does (its dirt is then
    whole-node under ``contraction-order``):

    * 1 (any window, no widening) where ``n`` lowers through the
      fixed-order kernel (``kernels/gemv.py::routes``: a float32 product
      of one 1-D and one 2-D operand on the card), whose per-element
      order depends only on the contraction's length;
    * 1 for integer and bool products, exact in any order;
    * :func:`order_granule` of the mesh's device otherwise.

    On a group mesh the ranks agree on the answer once per group and
    kind of product (:func:`_product_kind`): None where any rank says
    None, else the widest, so every rank restricts the same products (it
    decides which collectives the restricted walk issues). There a float
    product keeps ``contraction-order`` where an axis of the mesh has
    three or more ranks: a k-split product ends in an all-reduce along
    that axis (``collectives.reduce_over``), and the backend's ring may
    add three or more partial sums in an order that follows the
    message's length, so a window's sums need not meet in the whole
    product's order. Two ranks' partial sums meet in one add, which is
    commutative, so a line of two keeps the order."""
    kind = _product_kind(n)
    if kind == "exact":
        return 1
    if mesh.is_group and max(mesh.shape.values()) >= 3:
        return None
    a, b = (types.SimpleNamespace(ndim=c.ndim, device=mesh.device)
            for c in (n.a, n.b))
    g = (1 if kind == "vector" and gemv.routes(a, b, n.dtype)
         else order_granule(mesh.device))
    if not mesh.is_group:
        return g
    key = (id(mesh.group), kind)
    with _lock:
        if key in _agreed:
            return _agreed[key]
    from ..parallel import collectives as coll

    none, widest = (int(v) for v in coll.reduce_over(
        torch.tensor([int(g is None), g or 0], device=mesh.device),
        mesh.axis_names, "max", mesh))
    got = None if none else widest
    with _lock:
        _agreed[key] = got
    return got


def _widen(lo: int, hi: int, dim: int, granule: int) -> Tuple[int, int]:
    return (lo // granule) * granule, min(dim, -(-hi // granule) * granule)


# -- the bounded result cache -------------------------------------------


class _Entry:
    """One cached result. IMMUTABLE after construction: a warm splice
    publishes a fresh entry with a compare-and-swap on the entry object
    (see ``intercept``), so concurrent intercepts for the same plan key
    never observe — or double-account — a half-updated entry.

    ``nbytes`` is the device residency attributable to the entry: the
    cached result PLUS the leaf snapshots ``slots`` keeps alive. Lineage
    stash bytes are shared across entries and accounted separately in
    :func:`cache_bytes`."""

    __slots__ = ("result", "slots", "epoch", "nbytes")

    def __init__(self, result: Any, slots: Tuple, epoch: int,
                 nbytes: int):
        self.result = result
        self.slots = slots
        self.epoch = epoch
        self.nbytes = nbytes


_lock = threading.RLock()
_cache: "OrderedDict[Tuple, _Entry]" = OrderedDict()
_total_bytes = 0
_tls = threading.local()  # re-entry guard for the inner evaluates


def cache_bytes() -> int:
    """Current result-cache residency — the number the memory governor
    sees: cached results, the leaf snapshots the entries pin, and the
    mutation-seam stash of every Lineage a cached snapshot keeps alive
    (deduplicated: lineages are shared across handles and entries)."""
    with _lock:
        total = _total_bytes
        seen: set = set()
        for e in _cache.values():
            for s in e.slots:
                if s[0] != "a":
                    continue
                lin = s[1]._lineage
                if lin is not None and id(lin) not in seen:
                    seen.add(id(lin))
                    total += lin.stash_bytes
    return total


def cache_entries() -> int:
    return len(_cache)


def clear() -> int:
    """Drop every cached result. Returns the entries dropped."""
    global _total_bytes
    with _lock:
        n = len(_cache)
        _cache.clear()
        _agreed.clear()
        _total_bytes = 0
    _gauge()
    return n


def evict_stale() -> int:
    """Reap entries born under a dead mesh epoch — called from
    ``evict_stale_plans()`` (elastic recovery) next to the plan purge,
    so a rebuilt mesh is never served tensors of its predecessor."""
    global _total_bytes
    epoch = mesh_mod._EPOCH
    with _lock:
        dead = [k for k, e in _cache.items() if e.epoch != epoch]
        for k in dead:
            _total_bytes -= _cache.pop(k).nbytes
    if dead:
        prof.count("incremental_evictions", len(dead))
        _gauge()
    return len(dead)


def _drop(key: Tuple) -> None:
    global _total_bytes
    with _lock:
        e = _cache.pop(key, None)
        if e is not None:
            _total_bytes -= e.nbytes
    _gauge()


def _gauge() -> None:
    REGISTRY.gauge(
        "incremental_cache_bytes",
        "incremental result-cache residency, bytes").set(cache_bytes())


def _slots_nbytes(slots: Tuple) -> int:
    """Device bytes pinned by an entry's leaf snapshots (deduplicated:
    one DistArray may fill several arg slots)."""
    seen: set = set()
    total = 0
    for s in slots:
        if s[0] != "a" or id(s[1]) in seen:
            continue
        seen.add(id(s[1]))
        total += int(s[1].size) * s[1].dtype.itemsize
    return total


def _snapshot_slots(ordered: List[Any]) -> Optional[Tuple]:
    """Per-arg-slot leaf snapshot: ('s', value) for scalars, ('a',
    array, version) for DistArray leaves; None when a leaf is outside
    the model (nothing to compare against next time)."""
    from .base import ScalarExpr, _leaf_array

    slots = []
    for leaf in ordered:
        if isinstance(leaf, ScalarExpr):
            slots.append(("s", leaf.pyvalue))
            continue
        arr = _leaf_array(leaf)
        if arr is None or arr.is_donated:
            return None
        slots.append(("a", arr, arr._version))
    return tuple(slots)


def note_result(plan: Any, leaves: List[Any], order: Tuple[int, ...],
                result: Any, donated: List[Any], mesh: Any) -> None:
    """Seed/refresh the result cache after an ordinary (full) dispatch.
    Called from both evaluate paths behind the FLAGS.incremental read;
    skips anything outside the model (tuple roots, donated buffers,
    oversized results) — those evaluations stay full. On a group mesh
    each rank caches its block; the entry is charged the GLOBAL sizes,
    which every rank has alike, so every rank makes the same choice."""
    global _total_bytes
    if getattr(_tls, "active", False) or donated:
        return
    from ..array.distarray import DistArray

    if not isinstance(result, DistArray):
        return  # tuple roots (multi-output plans) are not modeled
    try:
        ordered = [leaves[i] for i in order]
    except (IndexError, TypeError):
        return
    slots = _snapshot_slots(ordered)
    if slots is None:
        return
    nbytes = (int(result.size) * result.dtype.itemsize
              + _slots_nbytes(slots))
    budget = _CACHE_FLAG._value
    if nbytes > budget:
        return
    with _lock:
        old = _cache.pop(plan.key, None)
        if old is not None:
            _total_bytes -= old.nbytes
        _cache[plan.key] = _Entry(result, slots, mesh_mod._EPOCH, nbytes)
        _total_bytes += nbytes
        evicted = 0
        while _total_bytes > budget and len(_cache) > 1:
            _, e = _cache.popitem(last=False)
            _total_bytes -= e.nbytes
            evicted += 1
    if evicted:
        prof.count("incremental_evictions", evicted)
    _gauge()


# -- per-leaf dirt -------------------------------------------------------


def _leaf_dirt(leaf: Any, slot: Tuple) -> Tuple[Any, Any]:
    """(dirt, stash) for one arg slot: dirt is None (clean) | TileExtent
    | FULL; stash is the lineage's (extent, post-write values) pair when
    the whole delta is a single stashed write."""
    from .base import ScalarExpr, _leaf_array

    if isinstance(leaf, ScalarExpr):
        if slot[0] == "s" and slot[1] == leaf.pyvalue:
            return None, None
        return FULL, None  # a changed scalar feeds everything downstream
    arr = _leaf_array(leaf)
    if arr is None or slot[0] != "a":
        return FULL, None
    rec_arr, rec_ver = slot[1], slot[2]
    if arr is rec_arr and arr._version == rec_ver:
        return None, None
    lin = arr._lineage
    if (lin is None or rec_arr._lineage is not lin
            or arr._version <= rec_ver):
        return FULL, None  # new identity / rewound handle: no delta
    # same lineage at a higher version IS the ancestor chain: a
    # branching update gets a fresh Lineage (_record_mutation), so each
    # log stays linear and dirty_between() is exactly the delta
    box = lin.dirty_between(rec_ver, arr._version, arr.shape)
    if box is None:
        return FULL, None
    return (TileExtent(box.ul, box.lr, arr.shape),
            lin.stashed_between(rec_ver, arr._version))


# -- dirty propagation ---------------------------------------------------


def _bbox(a: TileExtent, b: TileExtent, shape: Tuple[int, ...]
          ) -> TileExtent:
    return TileExtent(tuple(min(x, y) for x, y in zip(a.ul, b.ul)),
                      tuple(max(x, y) for x, y in zip(a.lr, b.lr)),
                      shape)


def _covers(box: TileExtent, shape: Tuple[int, ...]) -> bool:
    return (all(u == 0 for u in box.ul)
            and tuple(box.lr) == tuple(shape))


def _union_children(node: Any, children: Tuple, shape: Tuple[int, ...],
                    dirt: Dict, memo: Dict, details: List,
                    reasons: Optional[List[str]]) -> Any:
    """The broadcast-map rule: a same-shaped dirty child passes its box
    through; a dirty broadcast child (shape differs) dirties the whole
    node."""
    out: Any = None
    for c in children:
        d = _propagate(c, dirt, memo, details, reasons)
        if d is None:
            continue
        if d is FULL or tuple(c.shape) != tuple(shape):
            return FULL
        box = TileExtent(d.ul, d.lr, shape)
        out = box if out is None else _bbox(out, box, shape)
    return out


def _propagate(n: Any, dirt: Dict[int, Any], memo: Dict[int, Any],
               details: List[Tuple[Any, Any]],
               reasons: Optional[List[str]] = None) -> Any:
    """Dirty region of ``n`` in its own coordinates: None | box | FULL.
    A rule that makes a node whole-node for a named cause (the
    contraction order) appends the cause to ``reasons``."""
    hit = memo.get(n._id, _MISS)
    if hit is not _MISS:
        return hit
    from .base import ScalarExpr, ValExpr
    from .dot import DotExpr
    from .map import MapExpr
    from .reduce import _NO_KEEPDIMS, ReduceExpr

    r: Any
    if n._id in dirt:
        r = dirt[n._id]
    elif (isinstance(n, (ValExpr, ScalarExpr))
          or n._result is not None):
        r = None  # an un-arged leaf / cached sub-DAG: data unchanged
    elif isinstance(n, MapExpr):
        r = _union_children(n, n.inputs, n.shape, dirt, memo, details,
                            reasons)
    elif isinstance(n, ReduceExpr):
        pre = _union_children(n, n.inputs, n._pre_shape, dirt, memo,
                              details, reasons)
        if pre is None:
            r = None
        elif pre is FULL or n.axis is None:
            r = FULL  # reduce_all: every output element sees the dirt
        elif n.keepdims and n.op not in _NO_KEEPDIMS:
            ul = list(pre.ul)
            lr = list(pre.lr)
            for a in n.axis:
                ul[a], lr[a] = 0, 1
            r = TileExtent(ul, lr, n.shape)
        else:
            box = pre
            for a in sorted(n.axis, reverse=True):
                box = box.drop_axis(a)
            r = TileExtent(box.ul, box.lr, n.shape)
        mesh = mesh_mod.get_mesh()
        if (r is not None and r is not FULL
                and _ordered_cut(n, r, mesh.device)
                and reduce_granule(n, mesh) is None):
            # the restricted sum would not add in the full one's order
            # here: whole-node, under a named reason
            if reasons is not None:
                reasons.append("reduction-order")
            r = FULL
    elif isinstance(n, DotExpr):
        r = _dot_dirt(n, dirt, memo, details, reasons)
    else:
        # unknown access pattern (slice, shuffle, loop, transpose,
        # general reduce, shard_map nodes, ...): whole-node dirty —
        # always correct, and the root-level fallback keeps it honest
        r = None
        for c in n.children():
            if _propagate(c, dirt, memo, details, reasons) is not None:
                r = FULL
                break
    memo[n._id] = r
    if r is not None:
        details.append((n, r))
    return r


def _dot_dirt(n: Any, dirt: Dict, memo: Dict, details: List,
              reasons: Optional[List[str]]) -> Any:
    a, b = n.children()
    da = _propagate(a, dirt, memo, details, reasons)
    db = _propagate(b, dirt, memo, details, reasons)
    if da is None and db is None:
        return None
    if da is not None and db is not None:
        return FULL
    an, bn = a.ndim, b.ndim
    if da is not None:
        if da is FULL or an != 2:
            return FULL  # dirt on the contracted dim feeds every output
        out = (TileExtent((da.ul[0], 0), (da.lr[0], n.shape[1]), n.shape)
               if bn == 2 else  # (n,k)@(k,m): dirty rows -> output rows
               TileExtent((da.ul[0],), (da.lr[0],), n.shape))
    else:
        if db is FULL or bn != 2:
            return FULL
        out = (TileExtent((0, db.ul[1]), (n.shape[0], db.lr[1]), n.shape)
               if an == 2 else  # dirty cols -> those output cols
               TileExtent((db.ul[1],), (db.lr[1],), n.shape))
    if product_granule(n, mesh_mod.get_mesh()) is None:
        # the restricted product would not reduce in the full one's
        # order here: whole-node, under a named reason
        if reasons is not None:
            reasons.append("contraction-order")
        return FULL
    return out


# -- restriction (the dirty sub-plan) ------------------------------------


class DynSliceExpr:
    """A slice of ``input`` with starts given as walk arguments
    (``ScalarExpr``s, value-free signatures) and static sizes — the
    restriction leaf. Sizes are quantized to powers of two at the root,
    so successive deltas of similar size share one plan. On a logical
    mesh the slice is a view of the input's tensor."""


class DynUpdateExpr:
    """Splices the recomputed dirty region into a CLONE of the cached
    previous result, under the destination's tiling; the cached tensor
    is never written."""


def _build_expr_types():
    """Define the real expr subclasses lazily (base import cycle)."""
    global DynSliceExpr, DynUpdateExpr
    from ..array import tiling as tiling_mod
    from ..array.tiling import Tiling
    from .base import Expr

    def _starts(starts, env) -> List[int]:
        return [int(s.lower(env)) for s in starts]

    def _in_block(mine: TileExtent, starts: List[int],
                  blk: TileExtent) -> Tuple[slice, ...]:
        """The box-relative part ``mine`` of a box at ``starts`` as a
        slice of the block ``blk`` (empty where ``mine`` is)."""
        return tuple(slice(max(0, u + s - b), max(0, u + s - b) + (l - u))
                     for u, l, s, b in zip(mine.ul, mine.lr, starts,
                                           blk.ul))

    class _DynSliceExpr(Expr):
        __doc__ = DynSliceExpr.__doc__

        def __init__(self, input: Expr, starts: Tuple[Expr, ...],
                     sizes: Tuple[int, ...]):
            self.input = input
            self.starts = tuple(starts)
            self.sizes = tuple(int(s) for s in sizes)
            super().__init__(self.sizes, input.dtype)

        def children(self) -> Tuple[Expr, ...]:
            return (self.input,) + self.starts

        def replace_children(self, new_children: Tuple[Expr, ...]):
            return _DynSliceExpr(new_children[0],
                                 tuple(new_children[1:]), self.sizes)

        def _lower(self, env: Dict[int, Any]) -> Any:
            x = self.input.lower(env)
            return x[tuple(slice(s, s + z) for s, z in
                           zip(_starts(self.starts, env), self.sizes))]

        def _lower_local(self, env) -> Any:
            """The rank's share of the box: the part of it that the
            rank's block of the input holds, a view of that block (no
            collective), under the box's ``BoxTiling``."""
            from ..array.distarray import DistArray

            x = self.input.lower_local(env)
            starts = _starts(self.starts, env)
            t = tiling_mod.box_of(x.tiling, x.shape, starts)
            mine = t.block_extent(self.sizes, env.mesh)
            return DistArray.from_local(
                x.local[_in_block(mine, starts, x.block_extent())], t,
                self.sizes, env.mesh)

        def _sig(self, ctx) -> Tuple:
            return (("dynslice", self.sizes)
                    + tuple(ctx.of(c) for c in self.children()))

        def _default_tiling(self) -> Tiling:
            # keep the input's tiling on axes taken whole; cut axes
            # lose alignment with the tile grid (SliceExpr's rule)
            t = self.input.out_tiling()
            for d, sz in enumerate(self.sizes):
                if sz != self.input.shape[d]:
                    t = t.with_axis(d, None)
            return t

    class _DynUpdateExpr(Expr):
        __doc__ = DynUpdateExpr.__doc__

        def __init__(self, dst: Expr, src: Expr,
                     starts: Tuple[Expr, ...]):
            self.dst = dst
            self.src = src
            self.starts = tuple(starts)
            super().__init__(dst.shape, dst.dtype)

        def children(self) -> Tuple[Expr, ...]:
            return (self.dst, self.src) + self.starts

        def replace_children(self, new_children: Tuple[Expr, ...]):
            return _DynUpdateExpr(new_children[0], new_children[1],
                                  tuple(new_children[2:]))

        def _lower(self, env: Dict[int, Any]) -> Any:
            dst = self.dst.lower(env)
            src = self.src.lower(env)
            out = dst.clone()  # a published entry is never written
            sl = tuple(slice(s, s + z) for s, z in
                       zip(_starts(self.starts, env), self.src.shape))
            out[sl] = src.to(dtype=out.dtype)
            return out

        def _lower_local(self, env) -> Any:
            """The rank's block of the cached result (a clone) with the
            rank's share of the box written: the recomputed values come
            to where the ranks hold the box, which moves nothing when
            the restricted walk kept them there."""
            from ..array.distarray import DistArray
            from ..parallel import redistribute as redist_mod

            dst = self.dst.lower_local(env)
            src = self.src.lower_local(env)
            starts = _starts(self.starts, env)
            t = tiling_mod.box_of(dst.tiling, dst.shape, starts)
            part = redist_mod.relayout(src, t).local
            out = dst.local.clone()  # a published entry is never written
            sl = _in_block(t.block_extent(src.shape, env.mesh), starts,
                           dst.block_extent())
            out[sl] = part.to(dtype=out.dtype)
            return DistArray.from_local(out, dst.tiling, dst.shape,
                                        env.mesh)

        def _sig(self, ctx) -> Tuple:
            return ("dynupdate",) + tuple(
                ctx.of(c) for c in self.children())

        def _default_tiling(self) -> Tiling:
            return self.dst.out_tiling()  # the cached result's tiling

    DynSliceExpr = _DynSliceExpr
    DynUpdateExpr = _DynUpdateExpr


_types_built = False


def _types() -> None:
    global _types_built
    if not _types_built:
        _build_expr_types()
        _types_built = True


def _quantize(box: TileExtent, shape: Tuple[int, ...]) -> TileExtent:
    """Round the root's dirty box up to power-of-two sizes (clamped to
    the dim), sliding the start so the box stays covered and in bounds:
    distinct deltas collapse onto ~log2(dim) plan shapes per axis."""
    ul, lr = [], []
    for u, l, d in zip(box.ul, box.lr, shape):
        size = max(1, l - u)
        q = 1
        while q < size:
            q <<= 1
        q = min(q, d)
        start = min(u, d - q)
        ul.append(start)
        lr.append(start + q)
    return TileExtent(ul, lr, shape)


def _restrict(n: Any, box: TileExtent, memo: Dict,
              stashes: Optional[Dict[int, Tuple]] = None) -> Any:
    """An expr computing ``n[box]`` — same reductions, restricted output
    region. Raises :class:`Unsupported` for nodes without a restriction
    rule. ``stashes`` maps leaf ids to (extent, values) pairs from the
    mutation seam: a leaf whose needed box equals its stashed extent is
    served as a materialized value instead of a slice of its parent."""
    key = (n._id, box.ul, box.lr)
    hit = memo.get(key)
    if hit is not None:
        return hit
    from .base import ScalarExpr, ValExpr
    from .dot import DotExpr
    from .map import MapExpr
    from .reduce import ReduceExpr

    if _covers(box, n.shape):
        out = n
    elif (isinstance(n, (ValExpr, ScalarExpr))
          or n._result is not None):
        sv = stashes.get(n._id) if stashes else None
        if (sv is not None and tuple(sv[0].ul) == tuple(box.ul)
                and tuple(sv[0].lr) == tuple(box.lr)):
            from ..array import distarray as da_mod

            out = ValExpr(da_mod.from_tensor(sv[1]))
        else:
            out = _dyn_slice(n, box)
    elif isinstance(n, MapExpr):
        out = MapExpr(
            tuple(_restrict_bcast(c, box, n.shape, memo, stashes)
                  for c in n.inputs), n.op)
    elif isinstance(n, ReduceExpr):
        if n.axis is None:
            raise Unsupported("restrict:reduce_all")
        ps = n._pre_shape
        if n.keepdims and n.op not in ("argmax", "argmin"):
            ul = list(box.ul)
            lr = list(box.lr)
            for a in n.axis:
                ul[a], lr[a] = 0, ps[a]
        else:
            ul, lr = [], []
            kept = [d for d in range(len(ps)) if d not in n.axis]
            pos = {d: i for i, d in enumerate(kept)}
            for d in range(len(ps)):
                if d in pos:
                    ul.append(box.ul[pos[d]])
                    lr.append(box.lr[pos[d]])
                else:
                    ul.append(0)
                    lr.append(ps[d])
        mesh = mesh_mod.get_mesh()
        cut = _ordered_cut(n, box, mesh.device)
        wide_ul, wide_lr = list(ul), list(lr)
        if cut:
            granule = reduce_granule(n, mesh)
            if granule is None:
                raise Unsupported("reduction-order")
            for d in cut if granule > 1 else ():
                wide_ul[d], wide_lr[d] = _reduce_window(
                    n, d, ul[d], lr[d], granule, mesh)
        pre_box = TileExtent(wide_ul, wide_lr, ps)
        out = ReduceExpr(
            None, n.op, n.axis, n.keepdims, n.req_dtype,
            _inputs=tuple(_restrict_bcast(c, pre_box, ps, memo, stashes)
                          for c in n.inputs),
            _pre=n.pre)
        if (wide_ul, wide_lr) != (ul, lr):
            # the widened sums, then the box cut back out of them
            keep_dims = n.keepdims and n.op not in ("argmax", "argmin")
            dims = [d for d in range(len(ps))
                    if keep_dims or d not in n.axis]
            _types()
            out = DynSliceExpr(out, tuple(
                ScalarExpr(ul[d] - wide_ul[d]) for d in dims), box.shape)
    elif isinstance(n, DotExpr):
        out = _restrict_dot(n, box, memo, stashes)
    else:
        raise Unsupported(f"restrict:{type(n).__name__}")
    memo[key] = out
    return out


def _restrict_dot(n: Any, box: TileExtent, memo: Dict,
                  stashes: Optional[Dict[int, Tuple]]) -> Any:
    """``n[box]`` for a product: the output window is widened to the
    product's granule (``product_granule``: 1 leaves it as it is) along
    each cut non-contracted axis, the product runs over the widened
    operands, and a slice takes ``box`` back out of it."""
    from .base import ScalarExpr
    from .dot import DotExpr

    a, b = n.children()
    granule = product_granule(n, mesh_mod.get_mesh())
    if granule is None:
        raise Unsupported("contraction-order")
    wide = TileExtent(
        *zip(*(_widen(u, l, d, granule)
               for u, l, d in zip(box.ul, box.lr, n.shape))), n.shape)
    if a.ndim == 2 and b.ndim == 2:
        abox = TileExtent((wide.ul[0], 0), (wide.lr[0], a.shape[1]),
                          a.shape)
        bbox = TileExtent((0, wide.ul[1]), (b.shape[0], wide.lr[1]),
                          b.shape)
    elif a.ndim == 2 and b.ndim == 1:
        abox = TileExtent((wide.ul[0], 0), (wide.lr[0], a.shape[1]),
                          a.shape)
        bbox = TileExtent((0,), (b.shape[0],), b.shape)
    elif a.ndim == 1 and b.ndim == 2:
        abox = TileExtent((0,), (a.shape[0],), a.shape)
        bbox = TileExtent((0, wide.ul[0]), (b.shape[0], wide.lr[0]),
                          b.shape)
    else:
        raise Unsupported("restrict:dot-rank")
    prod = DotExpr(_restrict(a, abox, memo, stashes),
                   _restrict(b, bbox, memo, stashes), n.precision)
    if wide == box:
        return prod
    _types()
    return DynSliceExpr(prod, tuple(ScalarExpr(int(u) - int(w))
                                    for u, w in zip(box.ul, wide.ul)),
                        box.shape)


def _restrict_bcast(c: Any, box: TileExtent,
                    target_shape: Tuple[int, ...], memo: Dict,
                    stashes: Optional[Dict[int, Tuple]] = None) -> Any:
    """Restrict a broadcast-aligned child: slice axes that match the
    target, keep broadcast (size-1 / missing) axes whole."""
    cs = tuple(c.shape)
    off = len(target_shape) - len(cs)
    if off < 0:
        raise Unsupported("restrict:broadcast-rank")
    ul, lr = [], []
    for i, d in enumerate(cs):
        td = i + off
        if d == target_shape[td]:
            ul.append(box.ul[td])
            lr.append(box.lr[td])
        elif d == 1:
            ul.append(0)
            lr.append(1)
        else:
            raise Unsupported("restrict:broadcast-shape")
    return _restrict(c, TileExtent(ul, lr, cs), memo, stashes)


def _dyn_slice(n: Any, box: TileExtent) -> Any:
    from .base import ScalarExpr

    _types()
    starts = tuple(ScalarExpr(int(u)) for u in box.ul)
    return DynSliceExpr(n, starts, box.shape)


# -- tile accounting / reporting ----------------------------------------


def _tile_counts(n: Any, r: Any, mesh: Any) -> Tuple[int, int]:
    """(total tiles, dirty tiles) of node ``n`` under its committed
    tiling — the per-node dirty/clean view st.explain shows."""
    try:
        tiles = n.out_tiling().tiles_per_dim(mesh)
    except Exception:  # noqa: BLE001 - accounting is advisory
        tiles = tuple(1 for _ in n.shape)
    total = 1
    for t in tiles:
        total *= max(1, t)
    if r is FULL:
        return total, total
    dirty = 1
    for u, l, d, t in zip(r.ul, r.lr, n.shape, tiles):
        t = max(1, t)
        ts = -(-d // t)  # ceil tile size
        lo = u // ts
        hi = -(-l // ts)
        dirty *= max(1, hi - lo)
    return total, min(total, dirty)


def _report(plan: Any, **fields: Any) -> None:
    if plan is not None and plan.report is not None:
        inc = {"cache_bytes": cache_bytes(), "entries": len(_cache)}
        inc.update(fields)
        plan.report["incremental"] = inc


def degrade_to_full(plan: Any, reason: str) -> Any:
    prof.count("incremental_fallbacks")
    _report(plan, mode="full", fallback=reason)
    from ..obs import flight as flight_mod

    flight_mod.note(0, "incremental", mode="full", reason=reason)
    return NOT_HANDLED


# -- the intercept (plan-cache hit path) ---------------------------------


def intercept(expr: Any, plan: Any, leaves: List[Any],
              order: Tuple[int, ...], donated: List[Any],
              mesh: Any) -> Any:
    """Try to serve a warm evaluate from the result cache + a dirty
    sub-plan. Returns the result, or NOT_HANDLED to let the ordinary
    full dispatch run (which then refreshes the cache via
    ``note_result``)."""
    global _total_bytes
    if getattr(_tls, "active", False):
        return NOT_HANDLED  # inner restricted/splice evaluate
    if donated:
        return degrade_to_full(plan, "donation")
    with _lock:
        entry = _cache.get(plan.key)
        if entry is not None:
            _cache.move_to_end(plan.key)
    if entry is None:
        return NOT_HANDLED  # cold: seeded by note_result after dispatch
    if entry.epoch != mesh_mod._EPOCH:
        _drop(plan.key)
        return NOT_HANDLED
    if entry.result.is_donated:
        _drop(plan.key)
        return degrade_to_full(plan, "result-donated")
    try:
        ordered = [leaves[i] for i in order]
    except (IndexError, TypeError):
        return degrade_to_full(plan, "leaf-mismatch")
    if len(ordered) != len(entry.slots):
        _drop(plan.key)
        return degrade_to_full(plan, "leaf-mismatch")
    from .base import _leaf_array

    for leaf in ordered:
        arr = _leaf_array(leaf)
        if arr is not None and arr._donate_next:
            # a .donate()-marked leaf: the caller is owed a release
            # that only the real dispatch performs
            return degrade_to_full(plan, "donation")

    with prof.phase("incremental"):
        try:
            dirt: Dict[int, Any] = {}
            stashes: Dict[int, Tuple] = {}
            for leaf, slot in zip(ordered, entry.slots):
                d, sv = _leaf_dirt(leaf, slot)
                if d is not None:
                    dirt[leaf._id] = d
                    if sv is not None:
                        stashes[leaf._id] = sv
            if not dirt:
                # every leaf identical to the cached evaluation: the
                # cached result IS the answer — zero walks
                prof.count("incremental_hits")
                _report(plan, mode="cache-hit", fallback=None)
                return entry.result

            details: List[Tuple[Any, Any]] = []
            reasons: List[str] = []
            root_dirt = _propagate(expr, dirt, {}, details, reasons)
            if root_dirt is None:
                prof.count("incremental_hits")
                _report(plan, mode="cache-hit", fallback=None)
                return entry.result
            if root_dirt is FULL:
                return degrade_to_full(
                    plan, reasons[0] if reasons else "dirty-full")
            frac = root_dirt.size / max(1, expr.size)
            if frac > _FRAC_FLAG._value:
                return degrade_to_full(plan, f"dirty-frac:{frac:.3f}")
            use_box = _quantize(root_dirt, expr.shape)
        except Exception as e:  # noqa: BLE001 - honest fallback: dirt
            # computation errors degrade exactly like dispatch errors
            return degrade_to_full(plan, f"error:{type(e).__name__}")
        try:
            _tls.active = True
            sub_expr = None
            # exact-box pass: when every dirty leaf's delta is a single
            # stashed write, restrict to the UN-quantized root box so
            # each leaf's needed box lines up with its stashed extent
            if stashes and all(
                    d is not FULL and lid in stashes
                    and tuple(stashes[lid][0].ul) == tuple(d.ul)
                    and tuple(stashes[lid][0].lr) == tuple(d.lr)
                    for lid, d in dirt.items()):
                try:
                    sub_expr = _restrict(expr, root_dirt, {}, stashes)
                    use_box = root_dirt
                except Unsupported:
                    sub_expr = None
            if sub_expr is None:
                use_box = _quantize(root_dirt, expr.shape)
                sub_expr = _restrict(expr, use_box, {})
            from .base import ScalarExpr, ValExpr, evaluate

            _types()
            starts = tuple(ScalarExpr(int(u)) for u in use_box.ul)
            if mesh.is_group:
                # one walk: the restricted values reach the splice where
                # the ranks hold them, never gathered
                combined = evaluate(DynUpdateExpr(ValExpr(entry.result),
                                                  sub_expr, starts))
            else:
                sub = evaluate(sub_expr)
                combined = evaluate(
                    DynUpdateExpr(ValExpr(entry.result), ValExpr(sub),
                                  starts))
        except Unsupported as e:
            return degrade_to_full(plan, str(e))
        except Exception as e:  # noqa: BLE001 - the honest-fallback
            # contract: ANY failure mid-incremental-dispatch (chaos
            # faults included) degrades to the ordinary full path
            _fatal_reraise(e)
            return degrade_to_full(plan, f"error:{type(e).__name__}")
        finally:
            _tls.active = False

        slots = _snapshot_slots(ordered)
        if slots is not None:
            nbytes = (int(combined.size) * combined.dtype.itemsize
                      + _slots_nbytes(slots))
            budget = _CACHE_FLAG._value
            fresh = _Entry(combined, slots, entry.epoch, nbytes)
            evicted = 0
            with _lock:
                # CAS on the entry object: publish only if the slot
                # still holds the entry this splice was derived from
                if nbytes <= budget and _cache.get(plan.key) is entry:
                    _cache[plan.key] = fresh
                    _cache.move_to_end(plan.key)
                    _total_bytes += fresh.nbytes - entry.nbytes
                    while _total_bytes > budget and len(_cache) > 1:
                        _, e = _cache.popitem(last=False)
                        _total_bytes -= e.nbytes
                        evicted += 1
            if evicted:
                prof.count("incremental_evictions", evicted)
        root_total, root_dirty = _tile_counts(expr, use_box, mesh)
        prof.count("incremental_hits")
        prof.count("incremental_recomputed_tiles", root_dirty)
        _report(plan, mode="incremental", fallback=None,
                dirty_frac=round(frac, 6),
                dirty_box=[list(use_box.ul), list(use_box.lr)],
                nodes=[{"node": f"{type(n).__name__}#{n._id}",
                        "tiles": _tile_counts(n, r, mesh)[0],
                        "dirty_tiles": _tile_counts(n, r, mesh)[1]}
                       for n, r in details[-8:]])
        from ..obs import flight as flight_mod

        flight_mod.note(0, "incremental", mode="incremental",
                        dirty_frac=round(frac, 6),
                        recomputed_tiles=root_dirty)
        _gauge()
        return combined


def _fatal_reraise(exc: BaseException) -> None:
    """A sticky CUDA error poisons the context for every later launch:
    it must reach the resilience engine, not a full re-dispatch."""
    from ..resilience import classify

    if classify.classify(exc) == classify.FATAL_MESH:
        raise exc
