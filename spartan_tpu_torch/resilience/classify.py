"""Error classifier: an exception to a recovery decision (port of
``spartan_tpu/resilience/classify.py``, rewritten for the errors torch
and CUDA raise).

==================  ======================================  ================
class               what it covers                          policy
==================  ======================================  ================
``transient``       UNAVAILABLE / DEADLINE_EXCEEDED /       retry; the
                    ABORTED / CANCELLED, preemption,        checkpointed
                    socket and connection drops, NCCL       loop restores
                    network errors                          its snapshot
``oom``             ``torch.cuda.OutOfMemoryError``,        restore (the
                    ``MemoryError``, allocator messages     degradation
                                                            ladder waits)
``io``              ``OSError`` (the checkpoint layer)      restore / retry
``fatal_mesh``      a dead device: DATA_LOSS, halted        re-raise at once
                    devices, and CUDA's *sticky* errors     (elastic
                    (illegal memory access, device-side     recovery waits);
                    assert, unspecified launch failure /    resume in a new
                    ``cudaErrorLaunchFailure``)             process
``stale_mesh``      an array of a rebuilt mesh (the port    re-raise
                    has no mesh rebuild yet: never raised)
``sdc``             a failed integrity check                restore
``deterministic``   everything else: ValueError, TypeError, re-raise
                    shape and dtype errors, compile errors
==================  ======================================  ================

A sticky CUDA error leaves the process's CUDA context unusable: every
later call on the card fails, so no restore inside the process can
succeed. Those errors classify ``fatal_mesh`` so that the checkpointed
loop re-raises at once; ``st.loop(..., resume=path)`` in a new process
recovers from the last snapshot.

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
    if isinstance(exc, OSError):
        return IO
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return OOM
    if isinstance(exc, RuntimeError):
        text = str(exc).lower()
        if _match(text, _STICKY_CUDA_MARKERS) or _match(
                text, _FATAL_MESH_MARKERS):
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
