"""Device meshes, the default device and process-group bring-up.

The JAX package shards every array over a mesh of devices with two
named axes. The port has two kinds of mesh:

* **the logical mesh** (``Mesh(shape, device)``): a logical ``(x, y)``
  grid plus the one ``torch.device`` every array of the mesh lives on.
  The grid decides tile extents (``Tiling`` metadata), so extents match
  the JAX package's at the same mesh shape, and ``shard_map`` runs one
  thread per position on the device;
* **the group mesh** (``Mesh(shape, device, group=...)``): one position
  per rank of a ``torch.distributed`` process group, at coordinates
  ``divmod(rank, y)`` (the JAX package's row-major device order), with
  one sub-group per row and per column for the axis collectives.
  Each rank holds only its block of every array (``DistArray.local``,
  the ``Tiling.block_extent`` of its coordinates; a replicated mesh
  axis holds the same block on every rank along it), plan walks run on
  the blocks, and what has no local rule gathers its inputs whole,
  counted in ``group_materialize_calls`` (``array/distarray.py``,
  ``expr/base.py``). ``shard_map`` runs the rank's own block and the
  collectives go through the group.

:func:`initialize_distributed` builds the group and installs its mesh
as the ambient one; :func:`shutdown` clears it.

Every logical position has an id, row-major over the grid (the JAX
package's device ids at the same mesh shape). The **mesh epoch** is a
process-wide generation counter that :func:`rebuild_mesh` bumps when a
lost position is excluded: the survivors form a new logical mesh
(:func:`factor_2d` of their count, on the same device), DistArrays and
plan keys record the epoch they were made under, and an array of an
older epoch raises :class:`StaleMeshError` instead of running. A group
mesh is not rebuilt in its process: there a lost rank ends the world,
and a smaller world started anew resumes from the last snapshot
(``resilience/loop_ckpt.py``).

Mesh axes:
  * ``"x"`` — the primary tiling axis (rows / batch).
  * ``"y"`` — the secondary tiling axis (cols).

Device default: ``cuda``. Asking for ``cuda`` on a machine without a
usable card raises; nothing falls back to the CPU silently. Callers ask
for the CPU explicitly, with ``set_default_device("cpu")`` or a
``device=`` argument.
"""

from __future__ import annotations

import datetime
import math
import os
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

import torch

AXIS_ROW = "x"
AXIS_COL = "y"

DeviceLike = Union[str, torch.device]

_state = threading.local()
_default_device: torch.device = torch.device("cuda")
_global_mesh: Optional["Mesh"] = None
# the mesh initialize_distributed built over its process group
_group_mesh: Optional["Mesh"] = None
# True when initialize_distributed created the default process group
# (shutdown destroys only a group it created)
_created_group = False
_lock = threading.Lock()
_dist_lock = threading.Lock()

# -- mesh epoch (elastic recovery) ---------------------------------------
#
# Bumped by every rebuild_mesh. DistArrays record it at birth and plan
# keys lead with it (expr/base._mesh_key), so nothing made for a dead
# mesh runs on the rebuilt one. Reads are unlocked (one module-attribute
# load on the hot path); writes hold _lock.
_EPOCH = 0
_excluded_ids: Tuple[int, ...] = ()
# the (position ids, device) the first rebuild shrank: later rebuilds
# exclude from it cumulatively, as the JAX package's from jax.devices()
_universe: Optional[Tuple[Tuple[int, ...], torch.device]] = None
# epoch -> {axis: size} of the mesh that generation ran on (both sides
# of every rebuild), for migration records of arrays whose mesh is gone
_shape_history: Dict[int, Dict[str, int]] = {}


def mesh_epoch() -> int:
    """The current mesh generation (bumped by :func:`rebuild_mesh`)."""
    return _EPOCH


def mesh_shape_at(epoch: int) -> Optional[dict]:
    """The {axis: size} grid of mesh generation ``epoch``, when known
    (:func:`rebuild_mesh` records both sides of every transition)."""
    return _shape_history.get(int(epoch))


class StaleMeshError(RuntimeError):
    """An array of an earlier mesh epoch was used after
    :func:`rebuild_mesh`. ``arrays`` holds the offending arrays, so
    ``resilience/elastic.rehome`` can move them onto the rebuilt mesh."""

    def __init__(self, msg: str, arrays=()):
        super().__init__(msg)
        self.arrays = list(arrays)


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
    """The ``torch.device`` to run on: ``device`` if given, else the
    default. Raises when CUDA is asked for and no card is usable."""
    dev = _default_device if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "spartan_tpu_torch runs on CUDA by default, but "
            "torch.cuda.is_available() is False. Ask for the CPU "
            "explicitly: spartan_tpu_torch.set_default_device('cpu') or "
            "device='cpu'.")
    return dev


def set_default_device(device: DeviceLike) -> None:
    """Set the device that new meshes (and so new arrays) use; resets
    the ambient default mesh so it is rebuilt on that device."""
    global _default_device, _global_mesh
    with _lock:
        _default_device = torch.device(device)
        _global_mesh = None
    _state.mesh = None
    _state.epoch = _EPOCH


def get_default_device() -> torch.device:
    return _default_device


class Mesh:
    """A logical ``(x, y)`` grid over one device, or, with ``group``,
    the grid of the ranks of a ``torch.distributed`` process group."""

    __slots__ = ("shape", "device", "group", "rank", "coords",
                 "_axis_groups", "runner", "ids")

    def __init__(self, shape: Tuple[int, int], device: torch.device,
                 group=None, ids: Optional[Tuple[int, ...]] = None):
        nx, ny = (int(s) for s in shape)
        if nx < 1 or ny < 1:
            raise ValueError(f"mesh shape {shape} must be positive")
        self.shape: Dict[str, int] = {AXIS_ROW: nx, AXIS_COL: ny}
        # the positions' ids, row-major (the JAX package's device ids):
        # 0..n-1, or the survivors' ids on a rebuilt mesh
        self.ids: Tuple[int, ...] = (tuple(range(nx * ny)) if ids is None
                                     else tuple(int(i) for i in ids))
        if len(self.ids) != nx * ny:
            raise ValueError(f"{len(self.ids)} position ids for a "
                             f"{nx}x{ny} mesh")
        self.device = device
        self.group = group
        self.rank = 0
        self.coords: Dict[str, int] = {AXIS_ROW: 0, AXIS_COL: 0}
        # axis -> (process group or None, ranks of my row/column)
        self._axis_groups: Dict[str, Tuple[object, List[int]]] = {}
        # the group's collectives outside shard_map (parallel/collectives
        # GroupRunner), made at first use
        self.runner = None
        if group is not None:
            self._join(group, nx, ny)

    def _join(self, group, nx: int, ny: int) -> None:
        import torch.distributed as dist

        world = dist.get_world_size(group)
        if nx * ny != world:
            raise ValueError(f"group mesh {nx}x{ny} needs {nx * ny} ranks; "
                             f"the group has {world}")
        ranks = dist.get_process_group_ranks(group)
        self.rank = dist.get_rank(group)
        i, j = divmod(self.rank, ny)
        self.coords = {AXIS_ROW: i, AXIS_COL: j}
        # every rank creates every sub-group, in one order (new_group is
        # collective); a sub-group of all ranks is the group itself, one
        # of one rank other than the group is not created (its
        # collectives are local)
        lines = {AXIS_ROW: [[ranks[a * ny + b] for a in range(nx)]
                            for b in range(ny)],
                 AXIS_COL: [[ranks[a * ny + b] for b in range(ny)]
                            for a in range(nx)]}
        mine = {AXIS_ROW: j, AXIS_COL: i}
        for axis in (AXIS_ROW, AXIS_COL):
            for k, members in enumerate(lines[axis]):
                if len(members) == world:
                    pg = group
                elif len(members) == 1:
                    pg = None
                else:
                    pg = dist.new_group(members)
                if k == mine[axis]:
                    self._axis_groups[axis] = (pg, members)

    @property
    def axis_names(self) -> Tuple[str, str]:
        return (AXIS_ROW, AXIS_COL)

    @property
    def is_group(self) -> bool:
        """True for a mesh over the ranks of a process group."""
        return self.group is not None

    def axis_group(self, axis: str):
        """(process group or None, member ranks) of this rank's line
        along ``axis`` of a group mesh."""
        return self._axis_groups[axis]

    def __repr__(self) -> str:
        extra = (f", rank={self.rank} of a group" if self.group is not None
                 else "")
        return (f"Mesh(x={self.shape[AXIS_ROW]}, y={self.shape[AXIS_COL]}, "
                f"device={self.device}{extra})")


def build_mesh(shape: Tuple[int, int] = (1, 1),
               device: Optional[DeviceLike] = None) -> Mesh:
    """Build a logical ``(x, y)`` mesh on ``device`` (default device if
    None)."""
    return Mesh(shape, resolve_device(device))


def set_mesh(mesh: Optional[Mesh]) -> None:
    _state.mesh = mesh
    _state.epoch = _EPOCH


def _pin() -> Optional[Mesh]:
    """This thread's pinned mesh when it was pinned in the current
    epoch; a pin from before a :func:`rebuild_mesh` is ignored."""
    mesh = getattr(_state, "mesh", None)
    if mesh is not None and getattr(_state, "epoch", 0) == _EPOCH:
        return mesh
    return None


def get_mesh() -> Mesh:
    """The ambient mesh: a thread-local pin (``use_mesh``/``set_mesh``)
    of the current epoch, else the group mesh
    :func:`initialize_distributed` built, else the default mesh: the
    survivors' mesh after a :func:`rebuild_mesh`, a 1x1 mesh on the
    default device before one."""
    mesh = _pin()
    if mesh is not None:
        return mesh
    if _group_mesh is not None:
        return _group_mesh
    global _global_mesh
    with _lock:
        if _global_mesh is None:
            _global_mesh = _build_surviving()
        return _global_mesh


class use_mesh:
    """Context manager pinning the ambient mesh for this thread. The pin
    is epoch-scoped: once :func:`rebuild_mesh` runs, :func:`get_mesh`
    stops returning the pinned (now dead) mesh."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._prev: Optional[Mesh] = None
        self._prev_epoch = 0

    def __enter__(self) -> Mesh:
        self._prev = getattr(_state, "mesh", None)
        self._prev_epoch = getattr(_state, "epoch", _EPOCH)
        _state.mesh = self.mesh
        _state.epoch = _EPOCH
        return self.mesh

    def __exit__(self, *exc) -> None:
        _state.mesh = self._prev
        _state.epoch = self._prev_epoch


def _build_surviving() -> Mesh:
    """The default mesh: over the positions no :func:`rebuild_mesh` has
    excluded, when one ran, else a 1x1 mesh on the default device.
    Hold ``_lock``."""
    if _universe is None:
        return build_mesh()
    ids, device = _universe
    survivors = tuple(i for i in ids if i not in _excluded_ids)
    if not survivors:
        raise RuntimeError("rebuild_mesh excluded every position")
    return Mesh(factor_2d(len(survivors)), device, ids=survivors)


def rebuild_mesh(exclude_devices=(), shape=None) -> Mesh:
    """Shrink the logical mesh after the loss of positions, and bump the
    mesh epoch.

    ``exclude_devices`` are position ids (or anything with an ``id``)
    removed from the survivor set, cumulatively with earlier rebuilds;
    the survivors form a :func:`factor_2d` grid (or ``shape``) on the
    current mesh's device. The bump fences everything made before it:
    plan keys lead with the epoch (stale plans miss), DistArrays record
    their birth epoch (a stale one raises :class:`StaleMeshError`), and
    pins of the old mesh stop counting. The caller
    (``resilience/elastic``) evicts the dead epoch's plans after.

    A group mesh is refused: its positions are processes, and one that
    is lost takes its collectives with it. The surviving ranks exit,
    and a smaller world restarts and resumes from its last snapshot
    (``st.loop(..., resume=path)``)."""
    global _EPOCH, _global_mesh, _excluded_ids, _universe
    cur = get_mesh()
    if cur.is_group:
        raise RuntimeError(
            "rebuild_mesh cannot shrink a group mesh in its processes: "
            "a lost rank ends the process group. The surviving world "
            "restarts with fewer ranks and resumes from its last "
            "snapshot (st.loop(..., resume=path)).")
    with _lock:
        if _universe is None:
            _universe = (cur.ids, cur.device)
        _shape_history.setdefault(_EPOCH, dict(cur.shape))
        excluded = set(_excluded_ids)
        for d in exclude_devices:
            excluded.add(int(d) if isinstance(d, int) else int(d.id))
        _excluded_ids = tuple(sorted(excluded))
        ids, device = _universe
        survivors = tuple(i for i in ids if i not in _excluded_ids)
        if not survivors:
            raise RuntimeError("rebuild_mesh excluded every position")
        _EPOCH += 1
        _global_mesh = Mesh(shape or factor_2d(len(survivors)), device,
                            ids=survivors)
        _shape_history[_EPOCH] = dict(_global_mesh.shape)
        _state.mesh = _global_mesh
        _state.epoch = _EPOCH
        mesh = _global_mesh
    from ..utils.log import log_warn

    log_warn("mesh epoch %d: rebuilt over %d surviving position(s)%s",
             _EPOCH, len(mesh.ids),
             f" (excluded ids {_excluded_ids})" if _excluded_ids else "")
    return mesh


def reset_epoch_for_tests() -> None:
    """Restore the epoch-0 world with no position excluded (test
    isolation only: epochs only grow otherwise)."""
    global _EPOCH, _global_mesh, _excluded_ids, _universe
    with _lock:
        _EPOCH = 0
        _global_mesh = None
        _excluded_ids = ()
        _universe = None
        _shape_history.clear()
        _state.mesh = None
        _state.epoch = 0


def mesh_on(device: Optional[DeviceLike] = None) -> Mesh:
    """The ambient mesh, or, when ``device`` names another device, a
    mesh of the pinned mesh's shape (1x1 when none is pinned) on it."""
    if device is None:
        return get_mesh()
    dev = resolve_device(device)
    pinned = _pin()
    if pinned is not None and pinned.device == dev:
        return pinned
    return Mesh(mesh_axis_sizes(pinned) if pinned is not None else (1, 1),
                dev)


def mesh_axis_sizes(mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    mesh = mesh or get_mesh()
    return (mesh.shape[AXIS_ROW], mesh.shape[AXIS_COL])


def device_count(mesh: Optional[Mesh] = None) -> int:
    """Logical shards of the mesh (``x * y``): the JAX package's device
    count at the same mesh shape, which the tiling cost model divides
    by."""
    nx, ny = mesh_axis_sizes(mesh)
    return nx * ny


def ambient_group() -> Optional[Mesh]:
    """The ambient mesh when it is a group mesh, else None; unlike
    :func:`get_mesh` it never builds the default mesh (so code that
    takes its group form only on a group mesh runs without a default
    device)."""
    mesh = _pin()
    if mesh is not None:
        return mesh if mesh.group is not None else None
    return _group_mesh


def pinned_mesh() -> Optional[Mesh]:
    """This thread's pinned mesh, or None (the ``shard_map`` runner
    carries it into its worker threads)."""
    return _pin()


def factor_2d(n: int) -> Tuple[int, int]:
    """The most-square (rows, cols) grid of ``n`` positions, favouring
    rows (the JAX package's default mesh shape)."""
    best = (n, 1)
    for c in range(1, int(math.isqrt(n)) + 1):
        if n % c == 0:
            best = (n // c, c)
    return best


# -- process-group bring-up ----------------------------------------------

# transient connect failures worth a retry (a coordinator that is still
# starting, or restarting)
_TRANSIENT = ("connection refused", "connection reset", "timed out",
              "timeout", "unavailable", "failed to connect",
              "no such file")


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v not in (None, ""):
            return int(v)
    return None


def _pick_backend(backend: Optional[str], device: torch.device,
                  world: int) -> str:
    """The process group's backend: ``backend`` if given, else ``nccl``
    when every rank on this host has a card of its own, else ``gloo``.
    The ranks on this host are ``LOCAL_WORLD_SIZE`` (a launcher sets
    it); without it, a world no larger than this host's cards has a card
    per rank, and a larger one (several hosts, or ranks sharing cards)
    cannot be told apart, so it raises and asks for ``backend=``."""
    import torch.distributed as dist
    from ..utils.log import log_info

    if backend is None:
        cards = torch.cuda.device_count() if device.type == "cuda" else 0
        local_world = _env_int("LOCAL_WORLD_SIZE")
        if device.type != "cuda":
            backend, why = "gloo", f"the mesh's device is {device}"
        elif local_world is None and world > cards:
            raise ValueError(
                f"cannot choose a backend: {world} ranks, {cards} cards on "
                "this host and no LOCAL_WORLD_SIZE to say how many ranks "
                "share them; pass backend='nccl' (a card per rank) or "
                "backend='gloo', or set LOCAL_WORLD_SIZE")
        elif cards < (local_world or world):
            backend, why = "gloo", (f"{local_world} local ranks share "
                                    f"{cards} cards")
        elif not dist.is_nccl_available():
            backend, why = "gloo", "this torch build has no NCCL"
        else:
            backend, why = "nccl", (f"{local_world or world} local ranks, "
                                    f"{cards} cards")
        log_info("process group backend %s: %s", backend, why)
    if backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError("backend 'nccl' was asked for, but this "
                               "torch build has no NCCL")
        if device.type != "cuda":
            raise RuntimeError(f"backend 'nccl' needs CUDA devices, not "
                               f"{device}")
    elif backend == "gloo":
        if not dist.is_gloo_available():
            raise RuntimeError("backend 'gloo' was asked for, but this "
                               "torch build has no gloo")
    else:
        raise ValueError(f"unknown backend {backend!r}: nccl or gloo")
    return backend


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           backend: Optional[str] = None,
                           device: Optional[DeviceLike] = None,
                           timeout_s: float = 300.0,
                           max_attempts: int = 3,
                           backoff_s: float = 0.5) -> bool:
    """Bring up a ``torch.distributed`` process group and install a
    group mesh over its ranks as the ambient mesh.

    Returns False, and does nothing, unless it is given an address
    (``coordinator_address`` as ``host:port`` or a ``file://`` URL) or
    finds ``COORDINATOR_ADDRESS`` (the same forms)
    or a launcher's ``MASTER_ADDR``, ``WORLD_SIZE`` and ``RANK`` in the
    environment. The world size and
    rank come from the arguments, else ``NUM_PROCESSES``/``PROCESS_ID``,
    else ``WORLD_SIZE``/``RANK``.

    The backend is ``nccl`` when every local rank has its own card,
    else ``gloo`` (see :func:`_pick_backend`); ``backend=`` wins, and
    asking for one that is missing raises. The mesh's device is ``device=``, else the CPU when the
    default device is the CPU, else ``cuda:LOCAL_RANK`` (modulo the
    cards, so ranks that share a card use it). The mesh shape is the
    most-square grid of the world size (:func:`factor_2d`); another
    layout is ``Mesh(shape, device, group=...)``.

    Re-entrant: a second call returns True without dialing again; a
    default group the caller created itself (with the address or
    environment above) is adopted, not dialed again. Transient connect
    failures retry up to ``max_attempts`` times with doubling
    ``backoff_s``; every ``init_process_group`` gets ``timeout_s``."""
    global _group_mesh, _created_group
    import torch.distributed as dist

    env_coord = os.environ.get("COORDINATOR_ADDRESS")
    launcher = all(os.environ.get(k) for k in ("MASTER_ADDR", "WORLD_SIZE",
                                               "RANK"))
    want = coordinator_address is not None or bool(env_coord) or launcher
    if not want:
        return False
    with _dist_lock:
        if _group_mesh is not None:
            return True
        if not dist.is_available():
            raise RuntimeError("this torch build has no torch.distributed")
        local_rank = _env_int("LOCAL_RANK") or 0
        if device is not None:
            dev = torch.device(device)
            if dev.type == "cuda" and dev.index is None:
                resolve_device(dev)
                dev = torch.device("cuda", torch.cuda.current_device())
        elif _default_device.type == "cpu":
            dev = torch.device("cpu")
        else:
            resolve_device("cuda")
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        if dev.type == "cuda":
            resolve_device(dev)
            torch.cuda.set_device(dev)
        if not dist.is_initialized():
            world = (num_processes if num_processes is not None
                     else _env_int("NUM_PROCESSES", "WORLD_SIZE"))
            rank = (process_id if process_id is not None
                    else _env_int("PROCESS_ID", "RANK"))
            if world is None or rank is None:
                raise ValueError("initialize_distributed needs the world "
                                 "size and rank: pass num_processes and "
                                 "process_id, or set WORLD_SIZE and RANK")
            addr = coordinator_address or env_coord
            if not addr:
                init_method = "env://"
            else:
                # host:port, or a URL such as file:///path/store
                init_method = addr if "://" in addr else f"tcp://{addr}"
            chosen = _pick_backend(backend, dev, int(world))
            delay = backoff_s
            for attempt in range(max(1, max_attempts)):
                try:
                    dist.init_process_group(
                        chosen, init_method=init_method,
                        world_size=int(world), rank=int(rank),
                        timeout=datetime.timedelta(seconds=timeout_s))
                    break
                except (RuntimeError, ValueError, OSError) as e:
                    text = str(e).lower()
                    if (attempt + 1 < max(1, max_attempts)
                            and any(m in text for m in _TRANSIENT)):
                        from ..utils.log import log_warn

                        log_warn("process group connect attempt %d/%d "
                                 "failed (%s); retrying in %.2fs",
                                 attempt + 1, max_attempts, str(e)[:120],
                                 delay)
                        time.sleep(delay)
                        delay *= 2
                        continue
                    raise
            _created_group = True
        elif backend is not None and dist.get_backend() != backend:
            raise RuntimeError(f"the process group is {dist.get_backend()!r}"
                               f", not the {backend!r} asked for")
        _group_mesh = Mesh(factor_2d(dist.get_world_size()), dev,
                           group=dist.group.WORLD)
        return True


def backend(mesh: Optional[Mesh] = None) -> Optional[str]:
    """The process group's backend of a group mesh; None for a logical
    mesh."""
    mesh = mesh or get_mesh()
    if mesh.group is None:
        return None
    import torch.distributed as dist

    return dist.get_backend(mesh.group)


def shutdown() -> None:
    """Clear the ambient mesh (this thread's pin and the group mesh) and
    destroy the process group if :func:`initialize_distributed` created
    it."""
    global _group_mesh, _created_group
    _state.mesh = None
    with _dist_lock:
        _group_mesh = None
        if _created_group:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            _created_group = False


def status() -> dict:
    """A snapshot of the cluster view: this process's index and the
    process count, the ambient mesh, and ``torch.cuda.memory_stats``
    aggregated over the local cards (per key the max and the sum)."""
    from ..obs.metrics import device_memory_aggregate

    mesh = get_mesh()
    index, count = 0, 1
    if mesh.group is not None:
        import torch.distributed as dist

        index, count = dist.get_rank(), dist.get_world_size()
    return {
        "platform": "gpu" if mesh.device.type == "cuda" else "cpu",
        "device": str(mesh.device),
        "num_devices": device_count(mesh),
        "num_local_devices": (torch.cuda.device_count()
                              if torch.cuda.is_available() else 0),
        "process_index": index,
        "process_count": count,
        "backend": backend(mesh),
        "mesh": {k: int(v) for k, v in mesh.shape.items()},
        "memory_stats": device_memory_aggregate(),
    }
