"""Build the port's CUDA sources and bind them through ctypes.

Each kernel module keeps its CUDA C++ in ``spartan_tpu_torch/csrc/<name>.cu``
behind a plain C interface. :func:`build_all` compiles sources with
``nvcc`` for ``sm_90a`` into ``spartan_tpu_torch/_build/``, one ``nvcc``
process per source, all started together; a library's file name carries
its source's hash, so an edited source is rebuilt and an unchanged one is
not. :func:`load` opens a library once per process and lets the kernel
module declare its functions' argument types. ``BUILD_LOG[name]`` holds
nvcc's output (ptxas registers, shared memory and spills per kernel) of
the library's build, kept beside it as ``<library>.log``.

Nothing here runs at import: kernels are built at their first launch,
on the machine with the card (the CPU has no ``nvcc``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# the dynamic shared memory one block may use on Hopper (227 KB)
SMEM_PER_BLOCK = 232448

# nvcc's output per source name, for the builds this process ran
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

# held by every kernel module's launch counter (its ``LAUNCHES``): the
# serve engine's workers launch from several threads, and a bare
# read-modify-write would lose increments between them
COUNT_LOCK = threading.Lock()


def count_launch(counts: Dict[str, int], name: str) -> None:
    """Add one to ``counts[name]`` (a kernel module's ``LAUNCHES``)
    under :data:`COUNT_LOCK`."""
    with COUNT_LOCK:
        counts[name] += 1


def sources() -> List[str]:
    """Names of every CUDA source in ``csrc/`` (file names without
    ``.cu``)."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels are built "
                       "from spartan_tpu_torch/csrc at first use")


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` is built (named by the
    source's hash)."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libspartan_{name}_{digest}.so")


def build_all(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, all at once;
    wait for every compiler process, then raise if any failed. Returns
    name -> library path."""
    paths = {name: library_path(name) for name in names}
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    for name, out in paths.items():
        if os.path.exists(out):
            if os.path.exists(out + ".log"):
                with open(out + ".log") as f:
                    BUILD_LOG[name] = f.read()
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(f"{tmp}.log", "w+")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, os.path.join(CSRC, name + ".cu")]
        running.append((name, out, tmp, log,
                        subprocess.Popen(cmd, stdout=log,
                                         stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in running:
        rc = proc.wait()
        log.seek(0)
        BUILD_LOG[name] = log.read()
        log.close()
        if rc != 0:
            os.remove(log.name)
            failed.append(f"csrc/{name}.cu: nvcc exited {rc}:\n"
                          f"{BUILD_LOG[name]}")
        else:
            os.replace(log.name, out + ".log")
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed and opened once
    per process; ``bind`` sets its functions' argument and result types
    the first time."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name])
            bind(lib)
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed with CUDA error {err}")


class _ShapesOnly(threading.local):
    on = False


# set by the plan audit's dry walk (analysis/plan_audit.py) on its
# thread: there a wrapper given a ``meta`` tensor runs its plain version
# on shapes alone, and computes no value
SHAPES_ONLY = _ShapesOnly()


def on_card(t, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); raises for any other device, except a
    ``meta`` tensor inside the plan audit's dry walk."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu" or (t.device.type == "meta"
                                  and SHAPES_ONLY.on):
        return False
    raise ValueError(f"no {what} kernel for device {t.device}")
