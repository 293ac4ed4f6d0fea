"""Elastic mesh recovery: the last rung of the resilience ladder (port of
``spartan_tpu/resilience/elastic.py``).

Retry assumes the failed run can succeed on the same mesh, the OOM
ladder that a smaller plan fits. The persistent loss of a position
breaks both:

1. **detect** — ``resilience.classify`` maps DATA_LOSS and halted-device
   statuses, a lost ``torch.distributed`` peer, CUDA's sticky errors
   and the injected ``device_loss`` fault to ``fatal_mesh``; the policy
   engine routes that class here.
2. **drain** — stop the default serve engine admitting and fail its
   queued requests with the retryable ``MeshReconfiguring`` (with
   ``FLAGS.elastic_retry_after_s``); admission reopens after the
   rebuild, and clients resubmit onto the rebuilt mesh.
3. **rebuild** — ``parallel.mesh.rebuild_mesh(exclude_devices=...)``
   shrinks the logical mesh to the surviving positions and bumps the
   mesh epoch.
4. **invalidate** — plan keys lead with the epoch, so the dead epoch's
   plans miss; ``expr.base.evict_stale_plans`` drops them here.
   DistArrays record their birth epoch, and a stale one raises
   ``StaleMeshError`` until :func:`rehome` moves it.
5. **resume** — ``st.loop`` restores its carries from the last
   snapshot on the rebuilt mesh and re-enters the loop.

What the port cannot rebuild in its process, it does not: recovery then
bumps no epoch and raises ``FatalMeshError`` saying how to resume.

* A **sticky CUDA error** leaves the process's CUDA context unusable,
  and every logical position shares it: ``st.loop(..., resume=path)``
  in a new process recovers.
* On a **group mesh** a lost rank ends the process group: the surviving
  ranks exit, and a smaller world started anew resumes from the
  snapshot (``utils/checkpoint.load`` records the migration).
* A failure that **names no position** (neither ``failed_devices`` nor
  ``device N`` in its message) gives nothing to exclude.

Recovery is idempotent per epoch, also under chaos: every phase probes
the ``recover`` fault seam, and a recovery killed between the epoch bump
and the eviction is finished by the next :func:`on_fatal_mesh` (or
:func:`rehome`). ``FLAGS.elastic_recovery=False`` turns the rung off.

On one card every logical position shares the device, so a rehome moves
no bytes: the array's tensor stays where it is and its tiling is
re-planned for the survivor grid. Its record carries the planner's
modelled wire bytes (``parallel/redistribute.plan_rehome``), which is
what a mesh of real devices would move.
"""

from __future__ import annotations

import re
import threading
from typing import Any, List, Optional, Sequence

from ..obs.metrics import METRICS_FLAG as _METRICS_FLAG
from ..obs.metrics import REGISTRY
from ..parallel import mesh as mesh_mod
from ..utils import profiling as prof
from ..utils.config import FLAGS
from ..utils.log import log_warn
from . import classify as cls

FLAGS.define_bool(
    "elastic_recovery", True,
    "Master switch for elastic mesh recovery: on a fatal_mesh failure, "
    "rebuild the logical mesh over the surviving positions (bumping "
    "the mesh epoch), evict the dead epoch's plans, and let "
    "checkpointed loops resume. Off = fatal mesh errors fail fast like "
    "deterministic ones.")
FLAGS.define_float(
    "elastic_retry_after_s", 0.1,
    "retry-after a drained serve request carries during a mesh "
    "rebuild (serve/engine.drain_reconfiguring).")

_lock = threading.Lock()

# the highest epoch whose recovery finished (eviction included), and
# whether a recovery is in flight: a fault between the epoch bump and
# the eviction leaves _completed_epoch behind, and the next entry runs
# the idempotent tail (_finish_recovery)
_completed_epoch = 0
_pending = False

# the last rehome pass's per-array migration records
_last_rehome: list = []

# "device 3", "device: 3", "device #3" in status messages
_DEV_RE = re.compile(r"device[:\s#]*(\d+)", re.IGNORECASE)


def _fire_recover() -> None:
    """The ``recover`` chaos seam."""
    from . import faults as faults_mod

    if faults_mod._ACTIVE is not None:
        faults_mod.fire("recover")


def _count(name: str, help_: str, n: int = 1) -> None:
    if _METRICS_FLAG._value:
        REGISTRY.counter(name, help_).inc(n)


def _named_positions(exc: BaseException) -> List[int]:
    """The positions a failure names: an explicit ``failed_devices`` (on
    it or its cause), else ``device N`` in its message."""
    ids = [int(d) for d in getattr(exc, "failed_devices", ()) or ()]
    if not ids:
        seen = getattr(exc, "__cause__", None)
        if seen is not None:
            ids = [int(d) for d in getattr(seen, "failed_devices", ())
                   or ()]
    if not ids:
        m = _DEV_RE.search(str(exc))
        if m:
            ids = [int(m.group(1))]
    return ids


def infer_failed_devices(exc: BaseException) -> List[int]:
    """Which positions died: the ones the failure names, else the
    highest id still in the mesh (the JAX package's rule)."""
    ids = _named_positions(exc)
    if not ids:
        ids = [max(mesh_mod.get_mesh().ids)]
    return ids


def _drain_serve(retry_after_s: float) -> int:
    """Stop the default serve engine admitting and fail its queued
    backlog with MeshReconfiguring (in-flight dispatches fail on their
    own and are mapped by the worker). No-op without a running engine.
    Returns requests drained."""
    from ..serve import engine as serve_engine

    eng = serve_engine.peek_default()
    if eng is None or not eng.running:
        return 0
    return eng.drain_reconfiguring(retry_after_s)


def _resume_serve() -> None:
    """Reopen the default serve engine's admission after the rebuild
    (idempotent)."""
    from ..serve import engine as serve_engine

    eng = serve_engine.peek_default()
    if eng is not None:
        eng.resume_admission()


def _notify_monitor() -> None:
    """Fence the continuous monitor NOW, at the epoch bump: its detector
    streaks and the autotune daemon's hot-plan templates reference the
    dead epoch, and waiting for the sampler to notice would let a refit
    racing this recovery replan onto the dead mesh."""
    from ..obs import monitor as monitor_mod

    monitor_mod.notify_mesh_recovery()


def _evict() -> int:
    """Drop the dead epochs' plans, in memory and in the warm-start
    store on disk (``persist.evict_stale``: a restart must not bring
    back plans of a mesh that no longer exists). Returns the plans
    evicted from memory."""
    from .. import persist
    from ..expr import base as expr_base

    n = expr_base.evict_stale_plans()
    persist.evict_stale()
    return n


def _not_rebuilt(exc: BaseException, why: str) -> cls.FatalMeshError:
    """The FatalMeshError for a loss recovery cannot rebuild in this
    process (the epoch stays)."""
    note = (f"resilience: elastic recovery rebuilt nothing: {why}; "
            "resume from the last snapshot in a new process "
            "(st.loop(..., resume=path))")
    if isinstance(exc, cls.FatalMeshError):
        exc.add_note(note)
        return exc
    err = cls.FatalMeshError(
        f"persistent device/host loss ({type(exc).__name__}: "
        f"{str(exc)[:200]})",
        failed_devices=getattr(exc, "failed_devices", ()))
    err.__cause__ = exc
    err.add_note(note)
    return err


def _finish_recovery(epoch: int) -> Any:
    """The idempotent tail of a recovery that died after its epoch bump
    (chaos at the ``recover`` seam): evict, mark the epoch complete.
    Caller holds ``_lock``."""
    global _completed_epoch, _pending
    with prof.span("elastic_recover", epoch=epoch, resumed=True) as sp:
        with prof.phase("evict"):
            _fire_recover()
            evicted = _evict()
        sp.set(evicted=evicted)
    _completed_epoch = epoch
    _pending = False
    _resume_serve()
    _count("elastic_recoveries_resumed",
           "recoveries finished by a later handle_failure after a "
           "mid-recovery fault")
    _count("elastic_plans_evicted",
           "dead-epoch plans evicted during elastic recovery", evicted)
    log_warn("elastic: finished interrupted recovery for mesh epoch %d — "
             "%d plan(s) evicted", epoch, evicted)
    return mesh_mod.get_mesh()


def on_fatal_mesh(exc: BaseException, mesh: Any = None) -> Optional[Any]:
    """Run by the policy engine on a ``fatal_mesh`` failure: drain,
    rebuild, evict; idempotent per epoch and under chaos at the
    ``recover`` seam.

    Returns the rebuilt mesh (or the current one when this epoch is
    already recovered); None when elastic recovery is off. Raises
    ``FatalMeshError`` with no epoch bump where nothing can be rebuilt
    in this process (a group mesh, a sticky CUDA error, a failure that
    names no position, no survivor). The caller still raises: the
    failed run's inputs belong to the dead mesh, and recovery makes
    the next run land on a live one."""
    global _completed_epoch, _pending
    if not FLAGS.elastic_recovery:
        return None
    cur = mesh if mesh is not None else mesh_mod.get_mesh()
    if cur.is_group:
        raise _not_rebuilt(
            exc, "a group mesh loses a rank with its process group, so "
            "the surviving ranks exit and a smaller world restarts")
    if cls.is_sticky_cuda(exc):
        raise _not_rebuilt(
            exc, "a sticky CUDA error leaves this process's CUDA context "
            "unusable, and every logical position shares it")
    seen_epoch = mesh_mod._EPOCH
    with _lock:
        if _completed_epoch > mesh_mod._EPOCH:
            _completed_epoch = 0  # epoch reset (test isolation)
            _pending = False
        if mesh_mod._EPOCH != seen_epoch:
            # another thread's recovery rebuilt past this failure's
            # epoch while this one waited for the lock
            if not _pending or _completed_epoch >= mesh_mod._EPOCH:
                return mesh_mod.get_mesh()
            # ... but died before finishing (chaos mid-recovery)
            return _finish_recovery(mesh_mod._EPOCH)
        named = _named_positions(exc)
        if not named:
            raise _not_rebuilt(exc, "the failure names no logical "
                                    "position to exclude")
        already = set(mesh_mod._excluded_ids)
        if all(d in already for d in named):
            # this loss was already excluded by an earlier recovery: a
            # second failure for it is a no-op
            if not _pending or _completed_epoch >= mesh_mod._EPOCH:
                return mesh_mod.get_mesh()
            return _finish_recovery(mesh_mod._EPOCH)
        if set(cur.ids) <= set(named) | already:
            raise _not_rebuilt(exc, f"no logical position survives the "
                                    f"loss of {sorted(named)}")
        _pending = True
        with prof.span("elastic_recover", epoch=seen_epoch,
                       lost=tuple(named)) as sp:
            with prof.phase("drain"):
                _fire_recover()
                drained = _drain_serve(FLAGS.elastic_retry_after_s)
            with prof.phase("rebuild"):
                # a fault here leaves the epoch unbumped (the next entry
                # reruns the whole recovery); one after rebuild_mesh
                # leaves _completed_epoch behind (_finish_recovery)
                _fire_recover()
                new_mesh = mesh_mod.rebuild_mesh(exclude_devices=named)
            _notify_monitor()
            with prof.phase("evict"):
                _fire_recover()
                evicted = _evict()
            sp.set(drained=drained, evicted=evicted,
                   survivors=len(new_mesh.ids),
                   from_shape=mesh_mod.mesh_shape_at(seen_epoch),
                   to_shape=dict(new_mesh.shape))
        _completed_epoch = mesh_mod._EPOCH
        _pending = False
        _count("elastic_recoveries",
               "fatal mesh failures recovered by drain/rebuild/evict")
        _count("elastic_plans_evicted",
               "dead-epoch plans evicted during elastic recovery", evicted)
        _resume_serve()
        log_warn("elastic: mesh epoch %d -> %d after the loss of position(s)"
                 " %s — %d survivor(s), %d plan(s) evicted; resume loops "
                 "from checkpoint", seen_epoch, mesh_mod._EPOCH, named,
                 len(new_mesh.ids), evicted)
        return new_mesh


def quarantine_device(device: int, reason: str = "sdc") -> Optional[Any]:
    """Planned eviction of a position that still answers but is no
    longer trusted: the drain, rebuild, evict of :func:`on_fatal_mesh`
    without an exception. Live arrays rehome on their next use.
    Idempotent; None when elastic recovery is off."""
    global _completed_epoch, _pending
    if not FLAGS.elastic_recovery:
        return None
    with _lock:
        if _completed_epoch > mesh_mod._EPOCH:
            _completed_epoch = 0
            _pending = False
        if int(device) in set(mesh_mod._excluded_ids):
            if not _pending or _completed_epoch >= mesh_mod._EPOCH:
                return mesh_mod.get_mesh()
            return _finish_recovery(mesh_mod._EPOCH)
        seen_epoch = mesh_mod._EPOCH
        _pending = True
        with prof.span("elastic_quarantine", epoch=seen_epoch,
                       device=int(device), reason=reason) as sp:
            with prof.phase("drain"):
                _fire_recover()
                drained = _drain_serve(FLAGS.elastic_retry_after_s)
            with prof.phase("rebuild"):
                _fire_recover()
                new_mesh = mesh_mod.rebuild_mesh(
                    exclude_devices=[int(device)])
            _notify_monitor()
            with prof.phase("evict"):
                _fire_recover()
                evicted = _evict()
            sp.set(drained=drained, evicted=evicted,
                   survivors=len(new_mesh.ids),
                   from_shape=mesh_mod.mesh_shape_at(seen_epoch),
                   to_shape=dict(new_mesh.shape))
        _completed_epoch = mesh_mod._EPOCH
        _pending = False
        _count("elastic_quarantines",
               "suspect devices evicted by planned quarantine")
        _count("elastic_plans_evicted",
               "dead-epoch plans evicted during elastic recovery", evicted)
        _resume_serve()
        log_warn("elastic: mesh epoch %d -> %d after quarantine of "
                 "position %d (%s) — %d survivor(s), %d plan(s) evicted",
                 seen_epoch, mesh_mod._EPOCH, int(device), reason,
                 len(new_mesh.ids), evicted)
        return new_mesh


def rehome(arrays: Sequence[Any]) -> int:
    """Move stale-epoch DistArrays onto the current mesh through the
    migration planner (``DistArray.rehome`` ->
    ``parallel/redistribute.plan_rehome``): each array's route,
    schedule, modelled bytes and reason land on its ``_migration``
    record, in the ``elastic_rehome`` span and in the ``elastic_*``
    counters. Donated handles are skipped with a labelled reason.
    Returns the number of arrays moved."""
    global _last_rehome
    if _pending and FLAGS.elastic_recovery:
        # a recovery died between its epoch bump and its eviction:
        # finish it here too
        with _lock:
            if _pending and _completed_epoch < mesh_mod._EPOCH:
                _finish_recovery(mesh_mod._EPOCH)
    n = skipped = 0
    total_bytes = 0
    records = []
    with prof.span("elastic_rehome", arrays=len(arrays)) as sp:
        with prof.phase("migrate"):
            _fire_recover()
            for arr in arrays:
                arr = getattr(arr, "value", arr)  # unwrap ValExpr
                if arr.is_donated:
                    arr.rehome()  # records the labelled skip
                    skipped += 1
                    records.append(arr._migration or {"route": "skipped"})
                    continue
                if arr._epoch != mesh_mod._EPOCH:
                    arr.rehome()
                    n += 1
                    mig = arr._migration
                    if mig:
                        total_bytes += int(mig.get("bytes", 0))
                        records.append(mig)
        sp.set(migrated=n, skipped=skipped, bytes=total_bytes,
               routes=tuple(sorted({r.get("route", "?")
                                    for r in records})) or None)
    _last_rehome = records
    if n:
        _count("elastic_rehomed",
               "stale-epoch DistArrays migrated onto the rebuilt mesh", n)
    if skipped:
        _count("elastic_rehome_skipped",
               "donated/invalidated handles skipped (with reason) "
               "during a rehome pass", skipped)
    if total_bytes:
        _count("elastic_migrated_bytes",
               "modeled wire bytes of planned cross-mesh migrations "
               "(rehome + checkpoint restore)", total_bytes)
    return n


def note_migrations(records: Sequence[Any]) -> None:
    """Fold migrations made elsewhere (checkpoint restores onto another
    grid, ``resilience/loop_ckpt``) into the ``elastic_*`` counters."""
    total = sum(int(r.get("bytes", 0)) for r in records if r)
    if records:
        _count("elastic_restore_migrations",
               "loop carries re-tiled through the migration planner on "
               "checkpoint restore", len([r for r in records if r]))
    if total:
        _count("elastic_migrated_bytes",
               "modeled wire bytes of planned cross-mesh migrations "
               "(rehome + checkpoint restore)", total)


def last_rehome_report() -> list:
    """The per-array migration records of the last rehome pass."""
    return list(_last_rehome)
