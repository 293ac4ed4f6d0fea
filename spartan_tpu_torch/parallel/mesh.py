"""Logical device mesh and the default device.

The JAX package shards every array over a mesh of devices with two
named axes. This slice of the port runs on ONE device: a mesh is a
*logical* ``(x, y)`` grid plus the one ``torch.device`` every array of
the mesh lives on. The grid still decides tile extents (``Tiling``
metadata), so extents match the JAX package's at the same mesh shape,
and the applications pad rows to whole kernel blocks per logical row shard
exactly as the JAX package's applications do.

Mesh axes:
  * ``"x"`` — the primary tiling axis (rows / batch).
  * ``"y"`` — the secondary tiling axis (cols).

Device default: ``cuda``. Asking for ``cuda`` on a machine without a
usable card raises; nothing falls back to the CPU silently. Callers ask
for the CPU explicitly, with ``set_default_device("cpu")`` or a
``device=`` argument.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple, Union

import torch

AXIS_ROW = "x"
AXIS_COL = "y"

DeviceLike = Union[str, torch.device]

_state = threading.local()
_default_device: torch.device = torch.device("cuda")
_global_mesh: Optional["Mesh"] = None
_lock = threading.Lock()


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


def get_default_device() -> torch.device:
    return _default_device


class Mesh:
    """A logical ``(x, y)`` grid over one device."""

    __slots__ = ("shape", "device")

    def __init__(self, shape: Tuple[int, int], device: torch.device):
        nx, ny = (int(s) for s in shape)
        if nx < 1 or ny < 1:
            raise ValueError(f"mesh shape {shape} must be positive")
        self.shape: Dict[str, int] = {AXIS_ROW: nx, AXIS_COL: ny}
        self.device = device

    @property
    def axis_names(self) -> Tuple[str, str]:
        return (AXIS_ROW, AXIS_COL)

    def __repr__(self) -> str:
        return (f"Mesh(x={self.shape[AXIS_ROW]}, y={self.shape[AXIS_COL]}, "
                f"device={self.device})")


def build_mesh(shape: Tuple[int, int] = (1, 1),
               device: Optional[DeviceLike] = None) -> Mesh:
    """Build a logical ``(x, y)`` mesh on ``device`` (default device if
    None)."""
    return Mesh(shape, resolve_device(device))


def set_mesh(mesh: Optional[Mesh]) -> None:
    _state.mesh = mesh


def get_mesh() -> Mesh:
    """The ambient mesh: a thread-local pin (``use_mesh``/``set_mesh``),
    else a 1x1 mesh on the default device."""
    mesh = getattr(_state, "mesh", None)
    if mesh is not None:
        return mesh
    global _global_mesh
    with _lock:
        if _global_mesh is None:
            _global_mesh = build_mesh()
        return _global_mesh


class use_mesh:
    """Context manager pinning the ambient mesh for this thread."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._prev: Optional[Mesh] = None

    def __enter__(self) -> Mesh:
        self._prev = getattr(_state, "mesh", None)
        _state.mesh = self.mesh
        return self.mesh

    def __exit__(self, *exc) -> None:
        _state.mesh = self._prev


def mesh_on(device: Optional[DeviceLike] = None) -> Mesh:
    """The ambient mesh, or, when ``device`` names another device, a
    mesh of the pinned mesh's shape (1x1 when none is pinned) on it."""
    if device is None:
        return get_mesh()
    dev = resolve_device(device)
    pinned = getattr(_state, "mesh", None)
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
