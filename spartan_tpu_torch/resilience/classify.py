"""Error classifier: an exception to a recovery decision (port of
``spartan_tpu/resilience/classify.py``, rewritten for the errors torch
and CUDA raise).

==================  ======================================  ================
class               what it covers                          policy
==================  ======================================  ================
``transient``       UNAVAILABLE / DEADLINE_EXCEEDED /       retry with
                    ABORTED / CANCELLED, preemption,        backoff
                    socket and connection drops             (``engine``)
``oom``             ``torch.cuda.OutOfMemoryError``,        the OOM ladder
                    ``MemoryError``, allocator messages     (``degrade``)
``io``              ``OSError`` (the checkpoint layer)      retry
``fatal_mesh``      a dead device or peer: DATA_LOSS,       elastic
                    halted devices, CUDA's *sticky* errors  recovery
                    (illegal memory access, device-side     (``elastic``)
                    assert, unspecified launch failure /
                    ``cudaErrorLaunchFailure``), a lost
                    ``torch.distributed`` peer
                    (``DistNetworkError``,
                    ``DistBackendError``, gloo's "Connection
                    closed/reset by peer" and collective
                    timeouts, NCCL's "remote process
                    exited")
``stale_mesh``      an array of a rebuilt mesh              fail fast; the
                    (``StaleMeshError``)                    loop rehomes
``sdc``             a failed integrity check                retry
``deterministic``   everything else: ValueError, TypeError, fail fast
                    shape and dtype errors, compile errors
==================  ======================================  ================

A sticky CUDA error leaves the process's CUDA context unusable: every
later call on the card fails, so no restore inside the process can
succeed. Those errors classify ``fatal_mesh``, and elastic recovery
rebuilds nothing for them (every logical position shares the one dead
context): ``st.loop(..., resume=path)`` in a new process recovers from
the last snapshot. A lost peer of a process group is ``fatal_mesh``
too: the group's collectives cannot complete again, so a retry would
only wait on the dead rank.

Classification is by exception type first (``OSError`` is ``io``,
``torch.cuda.OutOfMemoryError`` and ``MemoryError`` are ``oom``) and by
message second: torch reports CUDA and NCCL faults as ``RuntimeError``
(``torch.AcceleratorError`` in newer releases, a subclass), told apart
only by their text. The JAX package's marker tables are kept for the
message forms torch produces too.
"""

from __future__ import annotations

import torch

TRANSIENT = "transient"
OOM = "oom"
IO = "io"
DETERMINISTIC = "deterministic"
FATAL_MESH = "fatal_mesh"
STALE_MESH = "stale_mesh"
SDC = "sdc"


class FatalMeshError(RuntimeError):
    """A device is gone for good: no retry in this process can succeed.
    ``failed_devices`` (when known) names the casualties."""

    def __init__(self, msg: str, failed_devices=()):
        super().__init__(msg)
        self.failed_devices = tuple(failed_devices)


_OOM_MARKERS = (
    "resource_exhausted", "resource exhausted", "out of memory",
    "out-of-memory", "failed to allocate", "allocation failure",
)

# worth retrying: a re-dispatch can succeed once the condition clears
_TRANSIENT_MARKERS = (
    "unavailable", "deadline_exceeded", "deadline exceeded", "aborted",
    "cancelled", "device lost", "device loss", "preempt",
    "connection reset", "connection refused", "socket closed",
    "heartbeat", "network", "too many pings",
)

# a device or host gone for good; checked before the transient table
_FATAL_MESH_MARKERS = (
    "data_loss", "data loss", "device halted", "chip halted",
    "halted client", "client has been halted", "device failure",
    "device unhealthy", "hardware failure", "missing device",
)

# a torch.distributed peer that is gone: gloo reports the closed socket
# (or the peer's reset) and a collective that timed out waiting for it,
# NCCL the remote exit. Checked before the transient table, whose
# "connection reset" and "network" would otherwise retry into a dead
# group.
_PEER_LOSS_MARKERS = (
    "connection closed by peer", "connection reset by peer",
    "remote process exited", "broken pipe",
)
_COLLECTIVE_TIMEOUT_MARKERS = ("for recv operation to complete",
                               "for send operation to complete")

# CUDA's sticky errors: the context is unusable for the rest of the
# process (cudaErrorIllegalAddress, cudaErrorAssert,
# cudaErrorLaunchFailure, cudaErrorIllegalInstruction,
# cudaErrorMisalignedAddress)
_STICKY_CUDA_MARKERS = (
    "illegal memory access", "device-side assert triggered",
    "unspecified launch failure", "cudaerrorlaunchfailure",
    "cudaerrorillegaladdress", "illegal instruction", "misaligned address",
)

_INTERNAL_DEVICE_MARKERS = ("device", "chip", "gpu")

_SDC_MARKERS = ("integrity violation", "silent data corruption",
                "checksum mismatch")


def _dist_errors() -> tuple:
    import torch.distributed as dist

    return tuple(c for c in (getattr(dist, "DistNetworkError", None),
                             getattr(dist, "DistBackendError", None))
                 if c is not None)


# torch.distributed's own peer-loss exceptions (classified by type)
_DIST_ERRORS = _dist_errors()


def is_sticky_cuda(exc: BaseException) -> bool:
    """True for CUDA's sticky errors: the process's CUDA context is
    unusable, so no position of a logical mesh on that card survives."""
    return isinstance(exc, RuntimeError) and _match(
        str(exc).lower(), _STICKY_CUDA_MARKERS)


def _match(text: str, markers: tuple) -> bool:
    return any(m in text for m in markers)


def classify(exc: BaseException) -> str:
    """Map an exception to one of the seven recovery classes."""
    kind = getattr(exc, "fault_kind", None)
    if kind is not None:  # injected faults label themselves
        return {"transient": TRANSIENT, "oom": OOM, "io": IO,
                "device_loss": FATAL_MESH, "recover": TRANSIENT,
                "compile": DETERMINISTIC, "sdc": SDC,
                }.get(kind, DETERMINISTIC)
    if isinstance(exc, FatalMeshError):
        return FATAL_MESH
    from ..parallel.mesh import StaleMeshError

    if isinstance(exc, StaleMeshError):
        return STALE_MESH
    if isinstance(exc, _DIST_ERRORS):
        return FATAL_MESH
    if isinstance(exc, OSError):
        return IO
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return OOM
    if isinstance(exc, RuntimeError):
        text = str(exc).lower()
        if (_match(text, _STICKY_CUDA_MARKERS)
                or _match(text, _FATAL_MESH_MARKERS)
                or _match(text, _PEER_LOSS_MARKERS)
                or _match(text, _COLLECTIVE_TIMEOUT_MARKERS)):
            return FATAL_MESH
        if text.startswith("internal") and _match(
                text, _INTERNAL_DEVICE_MARKERS):
            return FATAL_MESH
        if _match(text, _SDC_MARKERS):
            return SDC
        if _match(text, _OOM_MARKERS):
            return OOM
        if _match(text, _TRANSIENT_MARKERS):
            return TRANSIENT
    return DETERMINISTIC
