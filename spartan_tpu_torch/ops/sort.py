"""Distributed sample sort and top-k over the logical row shards (port
of ``spartan_tpu/ops/sort.py``).

The JAX package sorts an array sharded along its sort axis with one
static-shape shard_map program per shard:

1. a local two-key sort ``(is_padding, value)``: a ragged tail (n not a
   multiple of p) is padded, and a validity channel keeps the padding
   behind every real element through the whole pipeline;
2. ``s`` evenly spaced samples of each shard's valid prefix, gathered and
   sorted into p - 1 splitters;
3. the bucket exchange: each shard packs its sorted stream into a fixed
   ``(p, m)`` send buffer (run j to row j) with a parallel validity
   buffer, one all_to_all for each;
4. a local two-key merge of the ``p * m`` received slots;
5. the rebalance to even shards of m: the buckets' valid sizes are
   gathered, each shard cuts its bucket at the output shards' bounds,
   and a second all_to_all delivers the chunks.

On a logical mesh the p shards are the rows of one tensor on one card,
the all_to_all is a transpose of the (sender, receiver) axes and the
all_gather a view; every step keeps the JAX program's static shapes (no
host sync). On a group mesh (local-shard storage, ``array/distarray.py``)
:func:`sample_sort_local` runs the same program once per rank on the
row block the rank stores, with a real ``all_gather`` of the samples
and bucket sizes and a real ``all_to_all`` of the send buffers over the
collective axis, and rebalances to the blocks of the sort axis (an N-d
array's batch axes stay in each rank's block, every batch position a
row of the program);
:func:`distributed_topk_local` takes each rank's candidates from its
block and gathers the p * k of them. Batched sorts (an N-d array along
its last axis) stack the rows of every batch position. The send buffer is packed by the
``partition_pack`` kernel when ``kernels.select("sort_exchange")`` picks
it, else by the scatter the JAX package's expr path lowers through. The
JAX package's ragged transport (``lax.ragged_all_to_all``, its own
chip's payload-only exchange) has no port.

Order: ``lax.sort``'s. Values compare through :func:`sort_key`, an
integer key with -0.0 == +0.0 and every NaN equal and last, and every
sort is stable, so equal keys keep their source order: the result (and
the argsort's indices) are the stable sort's, whatever the splitters.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..parallel import mesh as mesh_mod
from ..utils import dtypes

_SAMPLES = 64  # per-shard splitter samples (capped at shard size)


# -- order keys ---------------------------------------------------------


def sort_key(v: torch.Tensor) -> torch.Tensor:
    """An integer tensor ordered as ``lax.sort`` orders ``v``: floats
    with -0.0 equal to +0.0 and every NaN equal and above +inf (the
    comparator's canonicalisation), then by IEEE total order on the bits;
    integers and bools by value."""
    if v.dtype.is_floating_point:
        v = torch.where(v == 0, torch.zeros((), dtype=v.dtype,
                                            device=v.device), v)
        v = torch.where(torch.isnan(v), torch.full((), float("nan"),
                                                   dtype=v.dtype,
                                                   device=v.device), v)
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        bits = dtypes.bitcast(v, ints[v.element_size()])
        width = 8 * v.element_size()
        return bits ^ ((bits >> (width - 1)) & ((1 << (width - 1)) - 1))
    if v.dtype == torch.bool:
        return v.to(torch.int32)
    return v


def _lexsort(first: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Stable order along the last axis by (``first``, ``key``): ``first``
    a 0/1 flag, ``key`` from :func:`sort_key`."""
    if key.element_size() <= 4:
        comp = (first.to(torch.int64) << 32) | (key.to(torch.int64)
                                                + 2 ** 31)
        return torch.sort(comp, dim=-1, stable=True).indices
    order = torch.sort(key, dim=-1, stable=True).indices
    flags = first.to(torch.int8).expand(key.shape).gather(-1, order)
    return order.gather(-1, torch.sort(flags, dim=-1, stable=True).indices)


def stable_argsort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.argsort`` along ``dim`` (stable, ``lax.sort`` order), int64."""
    return torch.sort(sort_key(x), dim=dim, stable=True).indices


# -- the per-shard program, batched over rows and logical shards ---------


def _exchange(t: torch.Tensor) -> torch.Tensor:
    """all_to_all (split 0, concat 0, tiled) over the logical shards:
    ``t[r, sender, receiver, ...]`` becomes ``[r, receiver, sender,
    ...]``."""
    return t.transpose(1, 2)


def _pack_scatter(xs_sorted: torch.Tensor, dst: torch.Tensor,
                  starts: torch.Tensor, p: int) -> torch.Tensor:
    """The expr path's send buffer: element t of a shard scattered to
    (dst[t], t - starts[dst[t]]); padding (dst == p) to a dropped slot.
    Returns (R, S, p, m) for the S shards of ``xs_sorted`` (R, S, m)."""
    r, shards, m = xs_sorted.shape
    dc = dst.clamp(max=p - 1)
    pos = torch.arange(m, device=dst.device) - starts.gather(-1, dc)
    flat = torch.where(dst < p, dc * m + pos, p * m)
    # zeros made from the source (batched with it under vmap), filled in
    # place: one buffer, as many bytes as a solo walk's
    out = xs_sorted.new_zeros((r, shards, p * m + 1)).scatter_(
        -1, flat, xs_sorted)
    return out[..., :p * m].reshape(r, shards, p, m)


def _kernel(xs: torch.Tensor, p: int, s: int, n: int,
            with_indices: bool = False, pack: bool = False):
    """The sample sort of ``xs`` (R, p, m): R independent rows, each
    padded to p shards of m slots, of which global slots >= n are
    padding. Returns the sorted rows (R, p, m) (and the int32 source
    index of each slot) with the padding in the global tail."""
    from ..kernels import exchange as kexchange

    r, _, m = xs.shape
    dev = xs.device
    t = torch.arange(m, dtype=torch.int64, device=dev)
    gidx = torch.arange(p * m, dtype=torch.int64, device=dev).reshape(p, m)
    inv = (gidx >= n).expand(r, p, m)
    # 1. local two-key sort: padding behind every value, stable
    order = _lexsort(inv, sort_key(xs))
    xs_sorted = xs.gather(-1, order)
    src_idx = (gidx[:, :1] + order).to(torch.int32) if with_indices else None
    mv = m - (gidx >= n).sum(-1)                          # (p,) valid
    inv_s = t >= mv[:, None]                              # (p, m)

    # 2. splitters: s evenly spaced samples of each valid prefix
    samp_idx = ((torch.arange(s, device=dev) * mv[:, None]) // s
                ).clamp(0, m - 1)
    samples = xs_sorted.gather(-1, samp_idx.expand(r, p, s)).reshape(r,
                                                                     p * s)
    alls = samples.gather(-1, stable_argsort(samples))
    splitters = alls[:, torch.arange(1, p, device=dev) * s]  # (R, p - 1)

    # 3. bucket exchange: runs are contiguous in the sorted stream
    skey = sort_key(splitters)[:, None, :].expand(r, p, p - 1).contiguous()
    dst = torch.searchsorted(skey, sort_key(xs_sorted), right=True)
    dst = torch.where(inv_s, p, dst)                      # padding: nowhere
    bounds = torch.searchsorted(
        dst, torch.arange(p + 1, device=dev).expand(r, p, p + 1).contiguous())
    starts = bounds[..., :p]
    counts = bounds[..., 1:] - bounds[..., :p]            # (R, p, p)
    if pack:
        send = kexchange.partition_pack(
            xs_sorted.reshape(r * p, m), starts.reshape(r * p, p).to(
                torch.int32), counts.reshape(r * p, p).to(torch.int32)
        ).reshape(r, p, p, m)
    else:
        send = _pack_scatter(xs_sorted, dst, starts, p)
    vals = _exchange(send).reshape(r, p, p * m)
    rvalid = _exchange(t < counts[..., None]).reshape(r, p, p * m)
    k = rvalid.sum(-1)                                    # (R, p)
    if with_indices:
        isend = (kexchange.partition_pack(
            src_idx.reshape(r * p, m), starts.reshape(r * p, p).to(
                torch.int32), counts.reshape(r * p, p).to(torch.int32)
        ).reshape(r, p, p, m) if pack
            else _pack_scatter(src_idx, dst, starts, p))
        ridx = _exchange(isend).reshape(r, p, p * m)

    # 4. local merge: (invalid, value), stable
    order2 = _lexsort(~rvalid, sort_key(vals))
    bucket = vals.gather(-1, order2)
    bidx = ridx.gather(-1, order2) if with_indices else None

    # 5. rebalance to even output shards
    off = torch.cumsum(k, -1) - k                         # (R, p)
    out_starts = torch.arange(p, device=dev) * m
    lo = torch.maximum(off[..., None], out_starts)        # (R, d, j)
    hi = torch.minimum((off + k)[..., None], out_starts + m)
    cnt = (hi - lo).clamp(min=0)
    st = (lo - out_starts).clamp(0, m)
    gather_idx = (lo[..., None] - off[..., None, None] + t
                  ).clamp(0, p * m - 1).reshape(r, p, p * m)
    rcnt, rst = _exchange(cnt), _exchange(st)             # (R, j, d)
    positions = torch.where(t < rcnt[..., None], rst[..., None] + t, m
                            ).reshape(r, p, p * m)

    def deliver(src: torch.Tensor) -> torch.Tensor:
        chunks = _exchange(src.gather(-1, gather_idx).reshape(r, p, p, m))
        out = chunks.new_zeros((r, p, m + 1)).scatter_(
            -1, positions, chunks.reshape(r, p, p * m))
        return out[..., :m]

    out_vals = deliver(bucket)
    if not with_indices:
        return out_vals
    return out_vals, deliver(bidx)


def _padded(x: torch.Tensor, n: int, p: int) -> Tuple[torch.Tensor, int]:
    """Pad the last axis to the next multiple of ``p``; the padded values
    are irrelevant (the validity channel orders and places them)."""
    m = -(-n // p)
    if m * p != n:
        pad = torch.zeros(tuple(x.shape[:-1]) + (m * p - n,), dtype=x.dtype,
                          device=x.device)
        x = torch.cat([x, pad], dim=-1)
    return x, m


def _uses(mesh_axis, name) -> bool:
    """Does a Tiling axis entry involve mesh axis ``name``?"""
    if mesh_axis == name:
        return True
    return isinstance(mesh_axis, tuple) and name in mesh_axis


def collective_axis(in_tiling, mesh=None) -> str:
    """The mesh axis the sample sort runs over: the sort (last) axis's
    placement when that is a mesh axis of size > 1, else the row axis."""
    mesh = mesh or mesh_mod.get_mesh()
    name = tiling_mod.AXIS_ROW
    if in_tiling is not None and isinstance(in_tiling.axes[-1], str) \
            and int(mesh.shape.get(in_tiling.axes[-1], 1)) > 1:
        name = in_tiling.axes[-1]
    return name


def batch_axes(in_tiling, name: str, ndim: int):
    """Leading (batch) axis placements with any use of the collective
    axis ``name`` cleared."""
    if in_tiling is None:
        return (None,) * (ndim - 1)
    return tuple(None if _uses(a, name) else a
                 for a in in_tiling.axes[:-1])


def _run(x: torch.Tensor, mesh, with_indices: bool,
         in_tiling=None) -> torch.Tensor:
    """Every sample-sort entry point: pad the last axis, pick the
    collective axis, run the program over all rows, unpad."""
    from ..kernels import registry as kernels_mod

    mesh = mesh or mesh_mod.get_mesh()
    n = int(x.shape[-1])
    name = collective_axis(in_tiling, mesh)
    p = int(mesh.shape.get(name, 1))
    if p <= 1 or n == 0:
        order = stable_argsort(x)
        return order.to(torch.int32) if with_indices else x.gather(-1, order)
    xp, m = _padded(x, n, p)
    t = tiling_mod.Tiling(batch_axes(in_tiling, name, x.ndim) + (name,))
    sel = kernels_mod.select("sort_exchange", (n,), dtypes.to_numpy(x.dtype),
                             t, mesh, p=p, m=m)
    rows = int(np.prod(x.shape[:-1], dtype=np.int64))
    out = _kernel(xp.reshape(rows, p, m), p, min(_SAMPLES, m), n,
                  with_indices=with_indices, pack=sel.native)
    out = (out[1] if with_indices else out).reshape(xp.shape)
    return out[..., :n] if m * p != n else out


def sample_sort(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sort a 1-D array of any length over the mesh row axis."""
    return _run(x, mesh, with_indices=False)


def sample_argsort(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """int32 indices that sort a 1-D array of any length (the source
    index rides the pipeline as a payload)."""
    return _run(x, mesh, with_indices=True)


def sample_sort_axis(x: torch.Tensor, mesh=None, with_indices: bool = False,
                     in_tiling=None) -> torch.Tensor:
    """Sort an N-d array along its last axis, every leading position a
    row of the same program; ``in_tiling`` (the layout with the sort axis
    last) picks the collective axis. Indices are within-row positions."""
    return _run(x, mesh, with_indices=with_indices, in_tiling=in_tiling)


# -- top-k ----------------------------------------------------------------


def _extreme(dtype, lo: bool):
    """The dtype's most extreme value (lo=True: minimum): the sentinel
    that masks padded slots out of a top-k."""
    dt = dtypes.to_numpy(dtype)
    if dt == np.bool_:
        return not lo
    if np.issubdtype(dt, np.floating):
        return float(-np.inf if lo else np.inf)
    info = np.iinfo(dt)
    return int(info.min if lo else info.max)


def _flip_key(v: torch.Tensor) -> torch.Tensor:
    """Order-reversing key: floats negate (NaN's sign flips, as in JAX),
    integers flip their bits (exact over the whole range)."""
    if v.dtype.is_floating_point:
        return -v
    if v.dtype == torch.bool:
        return ~v
    return torch.bitwise_not(v)


def distributed_topk(x: torch.Tensor, k: int, largest: bool = True,
                     mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the k largest (smallest) elements of a
    1-D array, best first: each logical shard's top-k candidates, their
    gather (a view) and a final top-k of the p * k candidates. The order
    is ``lax.top_k``'s (ties to the lowest index); smallest-k runs
    largest-k on the order-flipped key. Requires ``k <= ceil(n / p)``."""
    from ..kernels import registry as kernels_mod
    from ..kernels import topk as ktopk

    mesh = mesh or mesh_mod.get_mesh()
    p = int(mesh.shape.get(tiling_mod.AXIS_ROW, 1))
    n = int(x.shape[0])
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"topk needs 1 <= k <= {n}, got {k}")
    if p <= 1:
        _, idx = ktopk.top_k(x if largest else _flip_key(x), k)
        return x[idx], idx.to(torch.int32)
    xp, m = _padded(x, n, p)
    if k > m:
        raise ValueError(
            f"distributed_topk requires k <= shard size {m}; got {k}")
    sentinel = _extreme(x.dtype, lo=largest)
    sel = kernels_mod.select("topk", (n,), dtypes.to_numpy(x.dtype),
                             tiling_mod.row(1), mesh, k=k)
    gidx = torch.arange(p * m, dtype=torch.int64,
                        device=x.device).reshape(p, m)
    # padding slots carry the sentinel; they sit at the global tail, so
    # with ties to the lowest index no padding slot displaces a real
    # element of the same key, and every returned index is < n
    vv = torch.where(gidx < n, xp.reshape(p, m),
                     torch.full((), sentinel, dtype=x.dtype,
                                device=x.device))
    key = vv if largest else _flip_key(vv)
    if sel.native:
        lk, li = ktopk.shard_topk(key, k, _extreme(key.dtype, lo=True))
        li = li.to(torch.int64)
    else:
        lk, li = ktopk.top_k(key, k)
    gv = vv.gather(1, li).reshape(-1)                     # (p * k,)
    gi = gidx.gather(1, li).reshape(-1)
    _, win = ktopk.top_k(lk.reshape(-1), k)
    return gv[win], gi[win].to(torch.int32)


# -- the group mesh: one program per rank on the stored row blocks -------


def _pack_runs(xs_sorted: torch.Tensor, dst: torch.Tensor,
               starts: torch.Tensor, counts: torch.Tensor, p: int,
               pack: bool) -> torch.Tensor:
    """One rank's (R, p, m) send buffers, one a row: run j of a row's
    sorted stream in its row j; the ``partition_pack`` kernel when
    selected (one launch for all rows), else the expr path's
    scatter."""
    from ..kernels import exchange as kexchange

    if pack:
        return kexchange.partition_pack(xs_sorted, starts.to(torch.int32),
                                        counts.to(torch.int32))
    return _pack_scatter(xs_sorted[:, None], dst[:, None],
                         starts[:, None], p)[:, 0]


def sort_tiling(in_axes, axis: int, mesh) -> tiling_mod.Tiling:
    """The tiling the sample sort of an array tiled ``in_axes`` along
    ``axis`` runs and returns under: the sort axis on the collective
    axis, the batch axes keeping their placements less that axis (a
    vector on the row axis)."""
    if len(in_axes) == 1:  # a vector sorts over the row axis
        return tiling_mod.row(1)
    axes = list(in_axes)
    axes.append(axes.pop(axis))
    moved = tiling_mod.Tiling(axes)
    name = collective_axis(moved, mesh)
    out = list(batch_axes(moved, name, len(axes)))
    out.insert(axis, name)
    return tiling_mod.Tiling(out)


# Bytes a stable ``torch.sort`` of int64 keys holds per element beyond
# its input and its two int64 outputs (the radix sort's scratch), as
# chip_smoke.py's [local] phase measures it on an H100 at 8 rows of 2^23
SORT_SCRATCH = 3.03


def local_staging(r: int, m: int, p: int, ln: int, with_indices: bool,
                  itemsize: int = 4) -> float:
    """The most bytes :func:`sample_sort_local` holds at once on a rank
    beyond its input block, for R rows of m slots (ln of them real) over
    p ranks: the largest of its stages' live sets, counted from the
    program (each intermediate dropped where the program drops it; a
    key is 4 bytes a 4-byte value, ``sort_key``'s own temporaries three
    keys; a two-key sort 24 bytes an element to build its int64 keys,
    then those keys, its values and indices and ``SORT_SCRATCH``)."""
    n1, n2 = float(r * m), float(r * p * m)
    f = float(itemsize)
    pad = f * n1 if ln < m else 0.0
    idx = 4.0 * n1 if with_indices else 0.0

    def lexsort(n: float, flag: float) -> float:
        # the key, the flag, the int64 key built (24 B/elt at its
        # peak), then the key, flag, int64 key, values, indices, scratch
        return 4.0 * n + flag + max(24.0 * n, (24.0 + SORT_SCRATCH) * n)

    a = pad + max(3.0 * 4.0 * n1, lexsort(n1, 0.0))
    b = f * n1 + idx + max(3.0 * 4.0 * n1, 4.0 * n1 + 8.0 * n1,
                           16.0 * n1)
    c = f * n1 + idx + 8.0 * n1 + 2.0 * f * n2
    if with_indices:
        c = max(c, f * n1 + idx + 8.0 * n1 + (f + 1.0) * n2 + 8.0 * n2)
    base = (f + 1.0) * n2 + (4.0 * n2 if with_indices else 0.0)
    d = base + max(n2 + 3.0 * 4.0 * n2, lexsort(n2, n2))
    e = max(base + 8.0 * n2 + f * n2, f * n2 + 8.0 * n2 + 2.0 * f * n2,
            f * n2 + n2 + 16.0 * n2 + f * n1)
    return max(a, b, c, d, e)


def sample_sort_local(arr, with_indices: bool = False, axis: int = -1):
    """The sample sort (or argsort: int32 positions along the axis) of a
    group mesh ``DistArray`` along ``axis``, on the blocks the ranks
    store: the array moves to :func:`sort_tiling` (the sort axis on the
    collective axis, the batch axes staying in the block), every batch
    position of the block is a row of one program: each rank sorts its
    rows, the samples are gathered into p - 1 splitters a row, each rank
    packs its runs into (R, p, m) send buffers (one ``partition_pack``
    launch a rank for all its rows where the registry selects it, two
    for an argsort) and one ``all_to_all`` delivers them, each rank
    merges its buckets, and a second ``all_to_all`` rebalances them to
    the blocks of the sort axis. Returns the result under that tiling.
    Static shapes throughout: no host sync."""
    from ..array import extent as extent_mod
    from ..array.distarray import DistArray
    from ..kernels import registry as kernels_mod
    from ..parallel import collectives as coll
    from ..parallel import redistribute as redist_mod

    mesh = arr.mesh
    ndim = arr.ndim
    axis = axis % ndim
    shape = tuple(arr.shape)
    t = sort_tiling(arr.tiling.axes, axis, mesh)
    name = t.axes[axis]
    p = int(mesh.shape[name])
    n = int(shape[axis])
    arr = redist_mod.relayout(arr, t)
    orig = arr.local.dtype
    v = torch.movedim(dtypes.widen(arr.local), axis, -1)
    bshape = tuple(v.shape[:-1])
    ext = t.block_extent(shape, mesh)
    lo, ln = ext.ul[axis], ext.shape[axis]
    r = int(np.prod(bshape, dtype=np.int64))
    x = v.reshape(r, ln)
    dev = x.device

    def result(out):
        out = out.reshape(bshape + (ln,))
        out = torch.movedim(out, -1, axis).contiguous()
        return DistArray.from_local(out if with_indices else out.to(orig),
                                    t, shape, mesh)

    if p <= 1 or n == 0:
        order = stable_argsort(x)
        return result(order.to(torch.int32) if with_indices
                      else x.gather(-1, order))
    m = -(-n // p)
    sel = kernels_mod.select("sort_exchange", (n,), dtypes.to_numpy(x.dtype),
                             t, mesh, p=p, m=m)
    tpos = torch.arange(m, dtype=torch.int64, device=dev)
    if ln < m:
        x = torch.cat([x, x.new_zeros(r, m - ln)], -1)
    inv = (tpos >= ln).expand(r, m)
    # 1. local two-key sort: padding behind every value, stable
    order = _lexsort(inv, sort_key(x))
    xs_sorted = x.gather(-1, order)
    src_idx = (lo + order).to(torch.int32) if with_indices else None
    # each intermediate is dropped once the program is past it (the
    # card model, local_staging, counts what stays live)
    del order, x, v
    # 2. splitters from s evenly spaced samples of each valid prefix
    s = min(_SAMPLES, m)
    samp = ((torch.arange(s, device=dev) * ln) // s).clamp(0, m - 1)
    alls = coll.stack_over(xs_sorted[:, samp], name, mesh).transpose(
        0, 1).reshape(r, p * s)
    alls = alls.gather(-1, stable_argsort(alls))
    splitters = alls[:, torch.arange(1, p, device=dev) * s]
    # 3. bucket exchange: runs are contiguous in the sorted stream
    dst = torch.searchsorted(sort_key(splitters).contiguous(),
                             sort_key(xs_sorted), right=True)
    dst = torch.where(inv, p, dst)
    bounds = torch.searchsorted(dst, torch.arange(p + 1, device=dev).expand(
        r, p + 1).contiguous())
    starts, counts = bounds[:, :p], bounds[:, 1:] - bounds[:, :p]
    vals = coll.exchange(_pack_runs(xs_sorted, dst, starts, counts, p,
                                    sel.native), name, 1, 1, mesh)
    rvalid = coll.exchange(tpos < counts[..., None], name, 1, 1,
                           mesh).reshape(r, p * m)
    if with_indices:
        ridx = coll.exchange(_pack_runs(src_idx, dst, starts, counts, p,
                                        sel.native), name, 1, 1, mesh)
    del dst, xs_sorted, src_idx
    # 4. local merge: (invalid, value), stable
    order2 = _lexsort(~rvalid, sort_key(vals.reshape(r, p * m)))
    bucket = (ridx if with_indices else vals).reshape(r, p * m).gather(
        -1, order2)
    del order2, vals
    if with_indices:
        del ridx
    # 5. rebalance to the blocks of the sort axis
    ks = coll.stack_over(rvalid.sum(-1), name, mesh).transpose(0, 1)
    del rvalid
    off = torch.cumsum(ks, -1) - ks                       # (R, p)
    me = mesh.coords[name]
    bnd = torch.tensor(extent_mod.compute_splits(n, p), dtype=torch.int64,
                       device=dev)
    if bnd.shape[0] < p:  # fewer elements than ranks: empty tail blocks
        bnd = torch.cat([bnd, bnd.new_full((p - bnd.shape[0], 2), n)])
    mine = off[:, me:me + 1]
    lo_j = torch.maximum(mine, bnd[:, 0])
    hi_j = torch.minimum(mine + ks[:, me:me + 1], bnd[:, 1])
    cnt = (hi_j - lo_j).clamp(min=0)
    st = (lo_j - bnd[:, 0]).clamp(0, m)
    gidx = ((lo_j - mine)[..., None] + tpos).clamp(0, p * m - 1)
    recv = coll.exchange(bucket.gather(-1, gidx.reshape(r, p * m)).reshape(
        r, p, m), name, 1, 1, mesh)
    del bucket, gidx
    rcnt = coll.exchange(cnt[..., None], name, 1, 1, mesh)
    rst = coll.exchange(st[..., None], name, 1, 1, mesh)
    positions = torch.where(tpos < rcnt, rst + tpos, ln)
    out = recv.new_zeros((r, ln + 1)).scatter_(
        -1, positions.reshape(r, p * m), recv.reshape(r, p * m))
    del positions, recv
    return result(out[:, :ln])


def distributed_topk_local(arr, k: int, largest: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the k largest (smallest) elements of a
    1-D group mesh ``DistArray``, best first, on the row blocks the
    ranks store: each rank's top-k candidates of its block (one
    ``shard_topk`` launch a rank where the registry selects it), an
    ``all_gather`` of the p * k candidates and their global indices,
    and a final top-k with ties to the lowest index (``lax.top_k``'s
    order, C3). Padding slots of a short block carry the sentinel and
    an index past ``n``, and their candidates go behind every real one,
    as the single-process program keeps its padding at the global tail.
    Requires ``k <= ceil(n / p)``. Every rank returns the same whole
    result."""
    from ..kernels import registry as kernels_mod
    from ..kernels import topk as ktopk
    from ..parallel import collectives as coll
    from ..parallel import redistribute as redist_mod

    mesh = arr.mesh
    name = tiling_mod.AXIS_ROW
    p = int(mesh.shape[name])
    n = int(arr.shape[0])
    k = int(k)
    if not 1 <= k <= n:
        raise ValueError(f"topk needs 1 <= k <= {n}, got {k}")
    t = tiling_mod.Tiling((name,))
    arr = redist_mod.relayout(arr, t)
    x = arr.local
    if p <= 1:
        _, idx = ktopk.top_k(x if largest else _flip_key(x), k)
        return x[idx], idx.to(torch.int32)
    m = -(-n // p)
    if k > m:
        raise ValueError(
            f"distributed_topk requires k <= shard size {m}; got {k}")
    ext = t.block_extent((n,), mesh)
    lo, ln = ext.ul[0], ext.shape[0]
    dev = x.device
    sentinel = _extreme(x.dtype, lo=largest)
    sel = kernels_mod.select("topk", (n,), dtypes.to_numpy(x.dtype),
                             tiling_mod.row(1), mesh, k=k)
    tpos = torch.arange(m, dtype=torch.int64, device=dev)
    if ln < m:
        x = torch.cat([x, x.new_zeros(m - ln)])
    real = tpos < ln
    vv = torch.where(real, x, torch.full((), sentinel, dtype=x.dtype,
                                         device=dev))
    gidx = torch.where(real, lo + tpos, n + tpos)
    key = vv if largest else _flip_key(vv)
    if sel.native:
        lk, li = ktopk.shard_topk(key[None], k, _extreme(key.dtype, lo=True))
        lk, li = lk[0], li[0].to(torch.int64)
    else:
        lk, li = ktopk.top_k(key, k)
    ck = coll.stack_over(lk, name, mesh).reshape(-1)
    cv = coll.stack_over(vv[li], name, mesh).reshape(-1)
    ci = coll.stack_over(gidx[li], name, mesh).reshape(-1)
    back = torch.sort((ci >= n).to(torch.int8), stable=True).indices
    ck, cv, ci = ck[back], cv[back], ci[back]
    _, win = ktopk.top_k(ck, k)
    return cv[win], ci[win].to(torch.int32)
