"""The blob I/O pool: checkpoint shards written and read concurrently in
C++ (the port's own copy of ``spartan_tpu/native``'s blob functions).

``blob_io.cpp`` is compiled with ``g++`` at first use into
``spartan_tpu_torch/_build/``, under a name that carries the source's
hash, and bound through ``ctypes``. There is no Python fallback: where
the pool cannot be built, ``write_blobs``/``read_blobs`` raise with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "blob_io.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libspartan_blob_io_{digest}.so")


def _build(out: str) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("the blob I/O pool needs g++ (or c++) on PATH "
                           "to build spartan_tpu_torch/native/blob_io.cpp")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(
        [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", _SRC,
         "-o", tmp], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build the blob I/O pool "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)


def lib() -> ctypes.CDLL:
    """The pool's library, built if needed and opened once per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            handle = ctypes.CDLL(path)
            i32, i64 = ctypes.c_int32, ctypes.c_int64
            pp = ctypes.POINTER(ctypes.c_char_p)
            vpp = ctypes.POINTER(ctypes.c_void_p)
            for fn in (handle.blob_write_parallel, handle.blob_read_parallel):
                fn.argtypes = [pp, vpp, ctypes.POINTER(i64), i64, i32,
                               ctypes.POINTER(i64)]
                fn.restype = i32
            _lib = handle
        return _lib


def route() -> str:
    """Where blobs go through: the built library's file name."""
    return os.path.basename(lib()._name)


_ERRORS = {-1: "cannot open", -2: "short transfer on"}


def _call(fn, paths: Sequence[str], ptrs: List[int], sizes: List[int],
          nthreads: int, what: str) -> None:
    n = len(paths)
    if n == 0:
        return
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    c_ptrs = (ctypes.c_void_p * n)(*ptrs)
    c_sizes = (ctypes.c_int64 * n)(*sizes)
    failed = ctypes.c_int64(-1)
    rc = fn(c_paths, c_ptrs, c_sizes, n, int(nthreads),
            ctypes.byref(failed))
    if rc != 0:
        raise OSError(f"blob {what} failed: {_ERRORS.get(rc, rc)} "
                      f"{paths[failed.value]!r}")


def _check_buffers(arrays: Sequence[np.ndarray], writable: bool) -> None:
    for a in arrays:
        if not a.flags["C_CONTIGUOUS"]:
            raise ValueError("blob buffers must be C-contiguous")
        if writable and not a.flags["WRITEABLE"]:
            raise ValueError("blob read targets must be writable")


def write_blobs(paths: Sequence[str], arrays: Sequence[np.ndarray],
                nthreads: int = 8) -> None:
    """Write each array's raw bytes to its path, concurrently."""
    if len(paths) != len(arrays):
        raise ValueError("one path per array")
    _check_buffers(arrays, writable=False)
    _call(lib().blob_write_parallel, paths,
          [a.ctypes.data for a in arrays], [a.nbytes for a in arrays],
          nthreads, "write")


def read_blobs(paths: Sequence[str], arrays: Sequence[np.ndarray],
               nthreads: int = 8) -> None:
    """Fill each preallocated, C-contiguous array from its path."""
    if len(paths) != len(arrays):
        raise ValueError("one path per array")
    _check_buffers(arrays, writable=True)
    _call(lib().blob_read_parallel, paths,
          [a.ctypes.data for a in arrays], [a.nbytes for a in arrays],
          nthreads, "read")
