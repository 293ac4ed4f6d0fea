"""``shard_map``: run a per-block function over the positions of a mesh.

The port's counterpart of the ``shard_map`` that every SPMD body of the
JAX package runs under (``spartan_tpu/utils/compat.py`` names it):
``shard_map(fn, mesh, in_tilings, out_tilings)(*args)`` gives ``fn``
each input's block at one mesh position and assembles the blocks ``fn``
returns into whole outputs. Inside ``fn`` the collectives of
``parallel/collectives.py`` reach the other positions. Extents that a
tiling does not divide raise, as JAX's ``shard_map`` does.

Two runners carry it out:

* **the thread runner** (a logical mesh): one Python thread per
  position, all on the mesh's one device, one running at a time (a
  baton passes at each rendezvous, so the threads do not contend for
  the interpreter lock); the threads are kept between calls. The collectives rendezvous in the process on
  the device tensors themselves, so autograd sees one graph across the
  positions. A failure in one position aborts every rendezvous and is
  raised in the caller; every rendezvous waits at most
  :data:`RENDEZVOUS_TIMEOUT_S`. Each thread carries the caller's
  thread-local state: the pinned mesh, the span depth, grad and
  inference mode, the current CUDA device and stream.
* **the group runner** (a group mesh, ``parallel/mesh.py``): ``fn``
  runs once in each rank. Given whole tensors, it takes the rank's
  block of each and assembles each output with an ``all_gather`` over
  the axes that tile it, so every rank ends with the whole result.
  :func:`shard_map_local` is the form for local-shard storage
  (``array/distarray.py``): it takes the blocks the rank stores and
  returns the rank's output blocks, with nothing gathered. The
  collectives go through ``torch.distributed`` on the axis sub-groups.

A replicated output (an axis of the mesh that does not tile it) takes
position 0's block on both runners: the group runner broadcasts it from
position 0 of that axis, unless an ``all_reduce`` or ``all_gather`` over
the axis made it equal there already (:func:`same_over`). Gradients
follow the JAX package's transposes: the group runner's slice of a tiled
input gathers its gradient, a replicated input (a ``None`` tiling
included) sums its gradient over the positions that share it, and a
replicated output's gradient reaches position 0's block only, as on the
thread runner.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..array.tiling import (Tiling, mesh_axes_of, replicated,
                            tile_count, tile_index)
from . import mesh as mesh_mod
from .mesh import AXIS_COL, AXIS_ROW, Mesh

# the longest any position waits at one rendezvous of the thread runner
RENDEZVOUS_TIMEOUT_S = 600.0
# the longest the caller waits for a worker thread after the others ended
JOIN_TIMEOUT_S = 600.0

_ctx = threading.local()


class Position:
    """What a body sees of its own position: the mesh, its coordinates
    and the runner that carries its collectives."""

    __slots__ = ("mesh", "coords", "runner")

    def __init__(self, mesh: Mesh, coords: Dict[str, int], runner: Any):
        self.mesh = mesh
        self.coords = coords
        self.runner = runner

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def size(self, axis: str) -> int:
        return self.mesh.shape[axis]


def current() -> Position:
    """The position of the ``shard_map`` body running on this thread;
    raises outside one."""
    pos = getattr(_ctx, "pos", None)
    if pos is None:
        raise RuntimeError("a collective was called outside shard_map: "
                           "collectives run inside a shard_map body")
    return pos


def inside() -> bool:
    return getattr(_ctx, "pos", None) is not None


# -- blocks of a tiling ------------------------------------------------


def _as_tilings(tilings, n: int, what: str) -> List[Optional[Tiling]]:
    if isinstance(tilings, Tiling) or tilings is None:
        tilings = [tilings] * n if what == "in" else [tilings]
    tilings = list(tilings)
    if len(tilings) != n:
        raise ValueError(f"shard_map: {n} {what}puts but {len(tilings)} "
                         "tilings")
    return tilings


def _check_divides(t: Tiling, shape: Sequence[int], mesh: Mesh,
                   what: str) -> None:
    if t.ndim != len(shape):
        raise ValueError(f"shard_map: {what} tiling {t} has rank {t.ndim}, "
                         f"the value has shape {tuple(shape)}")
    for dim, a in enumerate(t.axes):
        n = tile_count(a, mesh)
        if shape[dim] % n:
            raise ValueError(
                f"shard_map: {what} dim {dim} of extent {shape[dim]} does "
                f"not divide over {n} positions of mesh axis {a!r} "
                f"(tiling {t}, mesh {dict(mesh.shape)})")


def _block_slices(t: Tiling, shape: Sequence[int], coords: Dict[str, int],
                  mesh: Mesh) -> Tuple[slice, ...]:
    out = []
    for dim, a in enumerate(t.axes):
        n = tile_count(a, mesh)
        ext = shape[dim] // n
        i = tile_index(a, coords, mesh)
        out.append(slice(i * ext, (i + 1) * ext))
    return tuple(out)


def _replicated_axes(t: Tiling, mesh: Mesh) -> List[str]:
    """The mesh axes of more than one position that do not tile ``t``."""
    used = {sub for a in t.axes for sub in mesh_axes_of(a)}
    return [axis for axis in (AXIS_ROW, AXIS_COL)
            if axis not in used and mesh.shape[axis] > 1]


def mark_same(out: torch.Tensor, x: torch.Tensor,
              axis: str) -> torch.Tensor:
    """Tag ``out``, a group collective's result over ``axis`` from
    ``x``, as equal at every position of ``axis`` and of the axes ``x``
    was equal over."""
    out._same_over = same_over(x) | {axis}
    return out


def same_over(t: Any) -> frozenset:
    """The axes over which a body's value is known equal at every
    position (:func:`mark_same`); output assembly broadcasts over the
    others."""
    return getattr(t, "_same_over", frozenset())


def _coords_of(mesh: Mesh, flat: int) -> Dict[str, int]:
    i, j = divmod(flat, mesh.shape[AXIS_COL])
    return {AXIS_ROW: i, AXIS_COL: j}


# -- the thread runner ---------------------------------------------------


class _Line:
    """The rendezvous of one line of positions along an axis."""

    __slots__ = ("slots", "arrived", "gen", "out")

    def __init__(self, n: int):
        self.slots: List[Any] = [None] * n
        self.arrived = 0
        self.gen = 0
        self.out: Any = None


class ThreadRunner:
    """The in-process rendezvous of a logical mesh's positions. One
    position runs at a time: a thread holds the runner's ``baton``
    while it runs its body and gives it up only while it waits at a
    rendezvous (or when it ends), so the threads never contend for the
    interpreter lock between two torch calls. ``exchange`` deposits a
    value and returns every member's, in position order."""

    def __init__(self, mesh: Mesh, timeout: float):
        self.mesh = mesh
        self.timeout = timeout
        self.baton = threading.Lock()
        self._cond = threading.Condition()
        self._aborted = False
        nx, ny = mesh.shape[AXIS_ROW], mesh.shape[AXIS_COL]
        self._lines: Dict[Tuple[str, int], _Line] = {}
        for j in range(ny):
            self._lines[(AXIS_ROW, j)] = _Line(nx)
        for i in range(nx):
            self._lines[(AXIS_COL, i)] = _Line(ny)

    def _line(self, axis: str, coords: Dict[str, int]) -> _Line:
        other = coords[AXIS_COL] if axis == AXIS_ROW else coords[AXIS_ROW]
        return self._lines[(axis, other)]

    def exchange(self, axis: str, coords: Dict[str, int], value: Any,
                 combine: Optional[Callable[[List[Any]], Any]] = None
                 ) -> Any:
        """Every member's ``value`` along ``axis``, in position order;
        with ``combine``, ``combine`` of that list, computed once (by
        the member that arrives last) and shared. Raises
        ``threading.BrokenBarrierError`` when the runner was aborted or
        a wait outlasts the timeout."""
        line = self._line(axis, coords)
        n = len(line.slots)
        with self._cond:
            if self._aborted:
                raise threading.BrokenBarrierError
            line.slots[coords[axis]] = value
            line.arrived += 1
            gen = line.gen
            vals = None
            if line.arrived == n:
                vals, line.slots, line.arrived = line.slots, [None] * n, 0
        if vals is not None:
            out = vals if combine is None else combine(vals)
            with self._cond:
                line.out, line.gen = out, gen + 1
                self._cond.notify_all()
            return out
        self.baton.release()
        try:
            with self._cond:
                done = self._cond.wait_for(
                    lambda: self._aborted or line.gen != gen, self.timeout)
                if self._aborted or not done:
                    self._aborted = True
                    self._cond.notify_all()
                    raise threading.BrokenBarrierError
                out = line.out
        finally:
            self.baton.acquire()
        return out

    def abort(self) -> None:
        with self._cond:
            self._aborted = True
            self._cond.notify_all()


def _thread_state(device: torch.device) -> Dict[str, Any]:
    from ..obs import trace

    state = {"mesh": mesh_mod.pinned_mesh(),
             "depth": getattr(trace._tls, "depth", 0),
             "grad": torch.is_grad_enabled(),
             "inference": torch.is_inference_mode_enabled(),
             "stream": None}
    if device.type == "cuda":
        state["stream"] = torch.cuda.current_stream(device)
        state["cuda"] = (device.index if device.index is not None
                         else torch.cuda.current_device())
    return state


class _Worker:
    """One idle-until-given-work thread of the thread runner."""

    def __init__(self, name: str):
        self._jobs: "queue.SimpleQueue[Callable[[], None]]" = \
            queue.SimpleQueue()
        threading.Thread(target=self._loop, daemon=True, name=name).start()

    def submit(self, job: Callable[[], None]) -> None:
        self._jobs.put(job)

    def _loop(self) -> None:
        while True:
            self._jobs.get()()


class _Workers:
    """The thread runner's threads, kept across ``shard_map`` calls so
    the per-thread state of torch and CUDA (library handles, the current
    device, allocator caches) is made once. A call takes a worker per
    position and gives them back when every position has ended; a
    worker that does not end is not given back."""

    def __init__(self):
        self._lock = threading.Lock()
        self._idle: List[_Worker] = []
        self._made = 0
        self._out = 0

    def take(self, n: int) -> List[_Worker]:
        with self._lock:
            got = self._idle[:n]
            del self._idle[:n]
            while len(got) < n:
                got.append(_Worker(f"shard_map-worker-{self._made}"))
                self._made += 1
            self._out += n
            return got

    def give(self, workers: List[_Worker]) -> None:
        with self._lock:
            self._idle.extend(workers)
            self._out -= len(workers)

    def busy(self) -> int:
        """Workers taken and not given back."""
        with self._lock:
            return self._out


_WORKERS = _Workers()


def _run_positions(fn: Callable, mesh: Mesh,
                   blocks_of: Callable) -> List[Any]:
    """Run ``fn`` at every position of a logical mesh, one worker thread
    each; returns the results in flat (row-major) position order."""
    from ..obs import trace
    from .collectives import ThreadLink

    n = mesh.shape[AXIS_ROW] * mesh.shape[AXIS_COL]
    runner = ThreadRunner(mesh, RENDEZVOUS_TIMEOUT_S)
    state = _thread_state(mesh.device)
    results: List[Any] = [None] * n
    errors: List[Optional[BaseException]] = [None] * n
    ended = threading.Semaphore(0)

    def work(flat: int) -> None:
        coords = _coords_of(mesh, flat)
        mesh_mod.set_mesh(state["mesh"])
        trace._tls.depth = state["depth"]
        _ctx.pos = Position(mesh, coords, ThreadLink(runner, coords))
        runner.baton.acquire()
        try:
            with torch.inference_mode(state["inference"]), \
                    torch.set_grad_enabled(state["grad"]):
                if state["stream"] is not None:
                    torch.cuda.set_device(state["cuda"])
                    with torch.cuda.stream(state["stream"]):
                        results[flat] = fn(*blocks_of(coords))
                else:
                    results[flat] = fn(*blocks_of(coords))
        except BaseException as e:  # re-raised in the caller
            errors[flat] = e
            runner.abort()
        finally:
            _ctx.pos = None
            mesh_mod.set_mesh(None)
            runner.baton.release()
            ended.release()

    workers = _WORKERS.take(n)
    for flat, worker in enumerate(workers):
        worker.submit(lambda flat=flat: work(flat))
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for _ in range(n):
        if not ended.acquire(timeout=max(0.0, deadline - time.monotonic())):
            runner.abort()
            raise TimeoutError(f"shard_map: a position of {mesh} did not "
                               f"finish within {JOIN_TIMEOUT_S} s")
    _WORKERS.give(workers)
    first = next((e for e in errors
                  if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)), None)
    if first is None:
        first = next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    return results


def _assemble(blocks: Dict[Tuple[int, ...], torch.Tensor],
              grid: Tuple[int, ...]) -> torch.Tensor:
    """The whole tensor from its tiles, keyed by tile index (autograd
    sees the cats)."""

    def build(prefix: Tuple[int, ...]) -> torch.Tensor:
        dim = len(prefix)
        if dim == len(grid):
            return blocks[prefix]
        parts = [build(prefix + (i,)) for i in range(grid[dim])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    return build(())


def _thread_outputs(results: List[Any], tilings: List[Tiling],
                    mesh: Mesh, single: bool) -> Any:
    outs = []
    for k, t in enumerate(tilings):
        blocks: Dict[Tuple[int, ...], torch.Tensor] = {}
        used = {sub for a in t.axes for sub in mesh_axes_of(a)}
        for flat, res in enumerate(results):
            coords = _coords_of(mesh, flat)
            if any(coords[a] for a in (AXIS_ROW, AXIS_COL) if a not in used):
                continue  # a replicated copy: position 0's block wins
            blk = res if single else res[k]
            key = tuple(tile_index(a, coords, mesh) for a in t.axes)
            blocks[key] = blk
        grid = tuple(tile_count(a, mesh) for a in t.axes)
        outs.append(_assemble(blocks, grid))
    return outs[0] if single else tuple(outs)


# -- the group runner ----------------------------------------------------


class _SliceIn(torch.autograd.Function):
    """The rank's block of a whole input; its gradient is gathered over
    the tiling axes and summed over the axes that replicate the input,
    so every rank holds the whole input's gradient."""

    @staticmethod
    def forward(ctx, whole, sl, tiling, pos):
        ctx.tiling, ctx.pos, ctx.shape = tiling, pos, whole.shape
        return whole[sl].clone()

    @staticmethod
    def backward(ctx, g):
        runner, t = ctx.pos.runner, ctx.tiling
        g = g.contiguous()
        used = set()
        for dim, a in enumerate(t.axes):
            for sub in reversed(mesh_axes_of(a)):
                g = runner.all_gather(g, sub, dim)
                used.add(sub)
        for axis in (AXIS_ROW, AXIS_COL):
            if axis not in used:
                g = runner.all_reduce(g, axis, "add")
        return g, None, None, None


class _AssembleOut(torch.autograd.Function):
    """The whole output from the ranks' blocks (:func:`_gather_whole`);
    its gradient is the rank's block of the whole gradient at position 0
    of the axes that replicate the output, and zero elsewhere, as on the
    thread runner."""

    @staticmethod
    def forward(ctx, block, tiling, pos, same):
        ctx.tiling, ctx.pos = tiling, pos
        return _gather_whole(block, tiling, pos, same)

    @staticmethod
    def backward(ctx, g):
        t, pos = ctx.tiling, ctx.pos
        blk = g[_block_slices(t, g.shape, pos.coords, pos.mesh)]
        if any(pos.coords[a] for a in _replicated_axes(t, pos.mesh)):
            return torch.zeros_like(blk), None, None, None
        return blk.clone(), None, None, None


def _gather_whole(block: torch.Tensor, t: Tiling, pos: Position,
                  same: frozenset) -> torch.Tensor:
    """Position 0's block along each axis that replicates the output
    (a broadcast, unless the block is equal there: ``same``), then an
    ``all_gather`` over the tiling axes."""
    out = block.contiguous()
    for axis in _replicated_axes(t, pos.mesh):
        if axis not in same:
            out = pos.runner.broadcast_first(out, axis)
    for dim, a in enumerate(t.axes):
        # the inner axis of a tuple split first: row-major tile order
        for sub in reversed(mesh_axes_of(a)):
            out = pos.runner.all_gather(out, sub, dim)
    return out


def _run_group(fn: Callable, mesh: Mesh, args: Sequence[Any],
               in_t: List[Optional[Tiling]], out_t: List[Tiling],
               single: bool, local: bool = False) -> Any:
    from .collectives import new_runner

    if inside():
        raise RuntimeError("shard_map does not nest")
    grad = torch.is_grad_enabled()
    track = grad and any(isinstance(x, torch.Tensor) and x.requires_grad
                         for x in args)
    pos = Position(mesh, dict(mesh.coords), new_runner(mesh, track))
    blocks = [] if not local else list(args)
    for x, t in zip([] if local else args, in_t):
        if not isinstance(x, torch.Tensor):
            blocks.append(x)
            continue
        if t is None:
            if not (grad and x.requires_grad):
                blocks.append(x)
                continue
            # a whole input that asks for gradients is a replicated one:
            # its gradient sums over the ranks, as on the thread runner
            t = replicated(x.ndim)
        sl = _block_slices(t, x.shape, pos.coords, mesh)
        if grad and x.requires_grad:
            blocks.append(_SliceIn.apply(x, sl, t, pos))
        else:
            blocks.append(x[sl])
    _ctx.pos = pos
    try:
        res = fn(*blocks)
    finally:
        _ctx.pos = None
    res_list = [res] if single else list(res)
    if len(res_list) != len(out_t):
        raise ValueError(f"shard_map: fn returned {len(res_list)} outputs "
                         f"for {len(out_t)} out tilings")
    outs = []
    for blk, t in zip(res_list, out_t):
        if local:
            # the rank's output block; a replicated axis holds position
            # 0's block unless the body made it equal there already
            for axis in _replicated_axes(t, mesh):
                if axis not in same_over(blk):
                    blk = pos.runner.broadcast_first(blk.contiguous(), axis)
            outs.append(blk)
        elif grad and blk.requires_grad:
            outs.append(_AssembleOut.apply(blk, t, pos, same_over(blk)))
        else:
            outs.append(_gather_whole(blk, t, pos, same_over(blk)))
    return outs[0] if single else tuple(outs)


# -- the entry point ------------------------------------------------------


def shard_map_local(fn: Callable, mesh: Mesh, in_tilings: Any,
                    out_tilings: Any) -> Callable:
    """``fn`` over the ranks of a group mesh, on the blocks each rank
    stores: the returned function takes each input's local block (under
    its tiling in ``in_tilings``; a non-tensor as it is) and returns the
    rank's output blocks under ``out_tilings``. The caller checks that
    the tilings divide the global shapes."""

    def mapped(*blocks):
        single = isinstance(out_tilings, Tiling)
        out_t = [out_tilings] if single else list(out_tilings)
        return _run_group(fn, mesh, blocks,
                          _as_tilings(in_tilings, len(blocks), "in"),
                          out_t, single, local=True)

    return mapped


def shard_map(fn: Callable, mesh: Optional[Mesh] = None,
              in_tilings: Any = None, out_tilings: Any = None) -> Callable:
    """``fn`` over the positions of ``mesh`` (the ambient mesh if None).

    ``in_tilings`` has one :class:`Tiling` per input (None: replicated,
    or an input that is not a tensor); ``out_tilings`` is one Tiling
    (``fn`` returns one tensor) or a sequence of them (``fn`` returns a
    tuple). Returns a function of the whole inputs that returns the
    whole outputs."""

    def mapped(*args):
        m = mesh or mesh_mod.get_mesh()
        in_t = _as_tilings(in_tilings, len(args), "in")
        single = isinstance(out_tilings, Tiling)
        out_t = [out_tilings] if single else list(out_tilings)
        for x, t in zip(args, in_t):
            if t is not None and isinstance(x, torch.Tensor):
                _check_divides(t, x.shape, m, "input")
        if m.group is not None:
            outs = _run_group(fn, m, args, in_t, out_t, single)
        else:
            if inside():
                raise RuntimeError("shard_map does not nest")

            def blocks_of(coords):
                return [x if t is None or not isinstance(x, torch.Tensor)
                        else x[_block_slices(t, x.shape, coords, m)]
                        for x, t in zip(args, in_t)]

            results = _run_positions(fn, m, blocks_of)
            outs = _thread_outputs(results, out_t, m, single)
        for o, t in zip([outs] if single else outs, out_t):
            if t.ndim != o.ndim:
                raise ValueError(f"shard_map: out tiling {t} has rank "
                                 f"{t.ndim}, the output has rank {o.ndim}")
        return outs

    return mapped
