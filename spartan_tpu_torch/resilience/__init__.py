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

* :mod:`memory` — the predictive memory governor: a plan's modeled
  peak (the JAX package's per-chip figure and the port's card peak),
  admission against ``FLAGS.hbm_budget_bytes``, a ladder rung chosen
  before the first walk.
* :mod:`integrity` — the silent-corruption sentinel
  (``IntegrityError``): block checksums against a re-walk on a rotated
  mesh, strikes, quarantine.

This package imports no expr module at import time.
"""

from . import (classify, degrade, elastic, engine, faults, integrity,
               loop_ckpt, memory)
from .classify import (DETERMINISTIC, FATAL_MESH, IO, OOM, SDC,
                       STALE_MESH, TRANSIENT, FatalMeshError,
                       classify as classify_error)
from .faults import (ChaosPlan, InjectedCheckpointError,
                     InjectedCompileError, InjectedDeviceLossError,
                     InjectedOOMError, InjectedTransientError, chaos,
                     chaos_clear)
from .integrity import IntegrityError

__all__ = [
    "chaos", "chaos_clear", "ChaosPlan", "classify_error",
    "TRANSIENT", "OOM", "IO", "DETERMINISTIC", "FATAL_MESH",
    "STALE_MESH", "SDC", "FatalMeshError", "IntegrityError",
    "InjectedTransientError", "InjectedOOMError",
    "InjectedCompileError", "InjectedCheckpointError",
    "InjectedDeviceLossError",
    "classify", "degrade", "elastic", "engine", "faults", "integrity",
    "loop_ckpt", "memory",
]
