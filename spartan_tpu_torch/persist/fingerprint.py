"""Process-stable entry addressing for the persistent plan store (port
of ``spartan_tpu/persist/fingerprint.py``).

The in-memory plan cache keys on Python object hashes, meaningless
across a process restart. The store addresses entries by
:func:`stable_digest`: a SHA-256 walk over the same plan-key tuple
``evaluate()`` computes, every component reduced to its structural
content — scalars, strings and bytes by type tag and value; tuples,
lists, dicts and sets by tagged (sorted where unordered) recursion;
code objects by their bytecode, constants, names and arity; functions
by ``module.qualname``. On the same plain objects the digest is
byte-identical to the JAX package's. The port adds one rule: an object
with a ``stable_key()`` method (``ops/scan.LocalScan``) digests as that
key. Anything else raises :class:`UnstableKeyError` and the plan is
not persisted.

A digest alone never authorizes a load: :func:`env_fingerprint`
captures what outside the plan key decides whether stored plan
decisions mean the same thing here — the Python, torch and CUDA
runtime versions, the device name and compute capability (``cpu`` off
the card) and the card count, the mesh shape and epoch, the optimizer
flags (``_opt_flags_key``) and the kernel policy — and the store
compares it verbatim on every load.
"""

from __future__ import annotations

import hashlib
import sys
import types
from typing import Any, Dict, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1


class UnstableKeyError(TypeError):
    """A plan-key component has no process-stable byte representation;
    the plan cannot be addressed on disk (and is not persisted)."""


def _feed(h, obj: Any) -> None:
    # type tags keep 1 and 1.0 and "1" and True apart
    if obj is None:
        h.update(b"\x00N")
    elif obj is True:
        h.update(b"\x00T")
    elif obj is False:
        h.update(b"\x00F")
    elif isinstance(obj, int):
        h.update(b"\x00i" + str(obj).encode())
    elif isinstance(obj, float):
        h.update(b"\x00f" + repr(obj).encode())
    elif isinstance(obj, str):
        b = obj.encode()
        h.update(b"\x00s" + str(len(b)).encode() + b":" + b)
    elif isinstance(obj, bytes):
        h.update(b"\x00b" + str(len(obj)).encode() + b":" + obj)
    elif isinstance(obj, (tuple, list)):
        h.update(b"\x00(" if isinstance(obj, tuple) else b"\x00[")
        for item in obj:
            _feed(h, item)
        h.update(b"\x00)")
    elif isinstance(obj, (frozenset, set)):
        h.update(b"\x00{")
        for d in sorted(stable_digest(item) for item in obj):
            h.update(d.encode())
        h.update(b"\x00}")
    elif isinstance(obj, dict):
        h.update(b"\x00d")
        for k in sorted(obj, key=lambda k: stable_digest(k)):
            _feed(h, k)
            _feed(h, obj[k])
        h.update(b"\x00e")
    elif isinstance(obj, np.dtype):
        h.update(b"\x00y" + str(obj).encode())
    elif isinstance(obj, (np.integer, np.floating, np.bool_)):
        h.update(b"\x00n" + str(obj.dtype).encode() + b":"
                 + repr(obj.item()).encode())
    elif isinstance(obj, types.CodeType):
        # structural identity, mirroring fn_key's intent: the same def
        # compiled in another process digests the same
        h.update(b"\x00c")
        _feed(h, (obj.co_name, obj.co_argcount, obj.co_kwonlyargcount,
                  obj.co_nlocals, obj.co_flags, obj.co_code,
                  obj.co_names, obj.co_varnames, obj.co_freevars,
                  obj.co_cellvars, obj.co_consts))
    elif isinstance(obj, (types.FunctionType, types.BuiltinFunctionType,
                          types.MethodType)):
        # module-qualified name: stable for module-level kernels and
        # for local defs at the same definition site
        mod = getattr(obj, "__module__", None)
        qual = getattr(obj, "__qualname__", getattr(obj, "__name__", None))
        if not mod or not qual:
            raise UnstableKeyError(
                f"unnameable callable in plan key: {obj!r}")
        h.update(b"\x00q" + f"{mod}.{qual}".encode())
    elif isinstance(obj, type):
        h.update(b"\x00t" + f"{obj.__module__}.{obj.__qualname__}".encode())
    elif callable(getattr(obj, "stable_key", None)):
        h.update(b"\x00k" + f"{type(obj).__module__}.{type(obj).__qualname__}"
                 .encode())
        _feed(h, obj.stable_key())
    else:
        raise UnstableKeyError(
            f"plan-key component {type(obj).__name__} has no stable "
            "byte representation; plan is not persistable")


def stable_digest(obj: Any) -> str:
    """Process-stable SHA-256 hex digest (40 characters) of a (nested)
    plan-key component. Raises :class:`UnstableKeyError` for components
    with no stable representation (the caller skips persistence)."""
    h = hashlib.sha256()
    _feed(h, obj)
    return h.hexdigest()[:40]


def _device(mesh: Any) -> Dict[str, Any]:
    dev = mesh.device
    if dev.type != "cuda":
        return {"device": "cpu", "capability": None, "cards": 0}
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return {"device": torch.cuda.get_device_name(idx),
            "capability": list(torch.cuda.get_device_capability(idx)),
            "cards": torch.cuda.device_count()}


def env_fingerprint(mesh: Any) -> Dict[str, Any]:
    """Everything outside the plan key that decides whether a stored
    plan means the same thing in this process (module docstring).
    Validated verbatim (dict equality after a JSON round trip) on every
    load. JSON-clean by construction."""
    from ..expr import base as expr_base
    from ..kernels import registry as kernels_mod
    from ..parallel import mesh as mesh_mod

    fp = {
        "format": FORMAT_VERSION,
        "python": list(sys.version_info[:3]),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "mesh_shape": [[str(k), int(v)]
                       for k, v in sorted(mesh.shape.items())],
        "mesh_epoch": int(mesh_mod._EPOCH),
        "group": bool(mesh.is_group),
        "opt_flags": stable_digest(expr_base._opt_flags_key()),
        "kernels_policy": stable_digest(kernels_mod.policy_key()),
    }
    fp.update(_device(mesh))
    return fp


def entry_digest(plan_key: Tuple, fingerprint: Dict[str, Any]) -> str:
    """The on-disk address of one plan: the raw-DAG plan key extended
    with the environment fingerprint. Raises UnstableKeyError when the
    plan key cannot be stably represented."""
    return stable_digest((plan_key, fingerprint))
