"""Resilient execution (port of ``spartan_tpu/resilience``).

* :mod:`classify` — the error decision table: transient / oom / io /
  fatal_mesh / stale_mesh / sdc / deterministic, by exception type and
  by the wording torch, CUDA, gloo and NCCL use.
* :mod:`faults` — deterministic, seeded fault injection (``st.chaos`` /
  ``FLAGS.fault_inject``) at the real seams: a plan's first run and
  later runs, checkpoint IO, and inside elastic recovery.
* :mod:`engine` — the retry policy engine inside ``evaluate()``:
  transient -> backoff and jitter under a per-plan retry budget, oom ->
  the degradation ladder, fatal_mesh -> elastic recovery,
  deterministic -> fail fast with the plan attached.
* :mod:`degrade` — the OOM ladder: finer tiling -> fusion off ->
  chunked row blocks, each rung keyed into the plan cache.
* :mod:`elastic` — the last rung: rebuild the logical mesh over the
  surviving positions (bumping the mesh epoch), evict the dead epoch's
  plans, rehome stale arrays through the migration planner.
* :mod:`loop_ckpt` — ``st.loop(..., checkpoint_every=N,
  checkpoint_path=p, resume=p)``: snapshots, restore on failure, resume
  on a rebuilt mesh or in a smaller world.

``integrity`` (the silent-corruption sentinel, ``IntegrityError``) and
``memory`` (the predictive memory governor) are not ported (ROADMAP
A5). This package imports no expr module at import time.
"""

from . import classify, degrade, elastic, engine, faults, loop_ckpt
from .classify import (DETERMINISTIC, FATAL_MESH, IO, OOM, SDC,
                       STALE_MESH, TRANSIENT, FatalMeshError,
                       classify as classify_error)
from .faults import (ChaosPlan, InjectedCheckpointError,
                     InjectedCompileError, InjectedDeviceLossError,
                     InjectedOOMError, InjectedTransientError, chaos,
                     chaos_clear)

__all__ = [
    "chaos", "chaos_clear", "ChaosPlan", "classify_error",
    "TRANSIENT", "OOM", "IO", "DETERMINISTIC", "FATAL_MESH",
    "STALE_MESH", "SDC", "FatalMeshError",
    "InjectedTransientError", "InjectedOOMError",
    "InjectedCompileError", "InjectedCheckpointError",
    "InjectedDeviceLossError",
    "classify", "degrade", "elastic", "engine", "faults", "loop_ckpt",
]
