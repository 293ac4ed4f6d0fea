"""Checkpointed ``st.loop``: carry snapshots between segments, restore
and resume (port of ``spartan_tpu/resilience/loop_ckpt.py``).

``st.loop(..., checkpoint_every=N, checkpoint_path=p, resume=p)`` runs
the loop in segments of N iterations. Each segment is one ``st.loop``
evaluation (the plan cache makes every segment after the first a hit:
the iteration count and the ``with_index`` offset are scalar leaves).
After each segment the carries are snapshotted atomically through
``utils/checkpoint`` (temporary directory, ``os.replace``, a CRC32 per
shard), so a killed process never leaves a partial snapshot as the
latest. Segments change no arithmetic: the port's loop is a Python loop
over the same body, so a segmented, restored or resumed run gives the
uninterrupted run's bits.

Failures (``resilience/classify.py``):

* a transient, out-of-memory, I/O or integrity failure of a segment
  restores the last snapshot (or, before the first one, re-runs from the
  held carries) and re-runs, at most ``FLAGS.loop_restore_max`` times,
  after which the failure propagates;
* a deterministic error propagates at once;
* ``fatal_mesh`` after which elastic recovery rebuilt the logical mesh
  (the epoch advanced: ``resilience/elastic.py``) restores the last
  snapshot onto the rebuilt mesh and re-enters the loop there
  (``mesh_rebuilt`` in the record, ``resilience_loop_elastic_resumes``).
  A ``fatal_mesh`` that rebuilt nothing (a sticky CUDA error, a lost
  rank of a group mesh, elastic recovery off) propagates at once:
  ``resume=`` in a new process, or in a smaller world, recovers it;
* ``stale_mesh`` (a leaf the body captured, made before the rebuild)
  rehomes the arrays the error names (``elastic.rehome``) and re-runs
  the segment, at most 8 passes;
* an ``OSError`` while writing a snapshot at a segment boundary is
  counted (``resilience_checkpoint_failures``, ``checkpoint_failures``
  in the loop's record) and warned, and the run carries on: the next
  boundary retries the write and the previous snapshot stays the one
  ``LATEST.json`` names. Any other error of the write propagates, as
  does an I/O error while reading a snapshot, and on a group mesh any
  error of the write (the peers wait for the rank's blobs at the
  snapshot's barriers: the rank cannot carry on alone).

On a **group mesh** every rank writes only its blocks' blobs, straight
into the step directory (``utils/checkpoint.save``: no gather, rank 0
writes each manifest after a barrier), and rank 0 alone writes
``loop_meta.json`` and then ``LATEST.json``, the commit marker: a rank
killed between its blobs and the marker leaves ``LATEST.json`` at the
previous snapshot. A peer lost during a snapshot raises
``FatalMeshError``. A snapshot restored onto another grid (a rebuilt
mesh, a smaller world) records each carry's planned migration in the
loop's record (``migrations``) and the ``elastic_*`` counters.

``resume=path`` continues from the last snapshot under ``path`` (a fresh
start when there is none). ``health`` / ``early_exit`` / ``stall_tol``
go to every segment; a segment that exits early ends the loop at that
iteration's snapshot.

Observability, as in the JAX package: a ``ckpt_loop`` span around the
run, a ``loop_segment`` span per segment and a ``loop_checkpoint`` span
per snapshot, and the ``REGISTRY`` counters
``resilience_loop_checkpoints``, ``resilience_loop_resumes``,
``resilience_loop_restores``, ``resilience_loop_elastic_resumes`` and
``resilience_checkpoint_failures``.

Layout under ``checkpoint_path`` (the JAX package's)::

    step_00000005/           carry snapshots after iteration 5
        carry0/  carry1/...  per-carry shard blobs + CRC manifests
        loop_meta.json       {"step": 5, "carries": k}
    step_00000010/
    LATEST.json              {"step": 10, "dir": "step_00000010"}

Only the last two snapshots are kept.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

from ..obs.metrics import METRICS_FLAG as _METRICS_FLAG
from ..obs.metrics import REGISTRY
from ..utils import profiling as prof
from ..utils.config import FLAGS
from ..utils.log import log_info, log_warn
from . import classify as cls

_LATEST = "LATEST.json"
_KEEP_SNAPSHOTS = 2


def _count(name: str, help_: str) -> None:
    if _METRICS_FLAG._value:
        REGISTRY.counter(name, help_).inc()


def _step_dir(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step:08d}")


def _commit(path: str, final: str, step: int) -> None:
    """Write ``LATEST.json`` (atomically): the snapshot commit marker."""
    ltmp = os.path.join(path, f".{_LATEST}.{os.getpid()}")
    with open(ltmp, "w") as f:
        json.dump({"step": int(step), "dir": os.path.basename(final)}, f)
    os.replace(ltmp, os.path.join(path, _LATEST))


def save_snapshot(path: str, step: int, carries: List[Any]) -> str:
    """Snapshot the carries after iteration ``step``; the ``LATEST.json``
    marker is written (atomically) only after the snapshot is whole.

    One process: the snapshot is written into a temporary directory and
    swapped into place. A group mesh: every rank writes its blocks'
    blobs straight into the step directory (``checkpoint.save`` barriers
    per carry), and rank 0 alone writes ``loop_meta.json`` and the
    marker."""
    from ..parallel import mesh as mesh_mod
    from ..utils import checkpoint as ckpt

    os.makedirs(path, exist_ok=True)
    mesh = mesh_mod.get_mesh()
    final = _step_dir(path, step)
    tree = {f"carry{i}": c for i, c in enumerate(carries)}
    meta = {"step": int(step), "carries": len(carries)}
    with prof.span("loop_checkpoint", step=step):
        if mesh.is_group:
            ckpt.save_tree(final, tree)
            if mesh.rank == 0:
                with open(os.path.join(final, "loop_meta.json"), "w") as f:
                    json.dump(meta, f)
                _commit(path, final, step)
        else:
            tmp = os.path.join(path, f".tmp_step_{step}_{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            ckpt.save_tree(tmp, tree)
            with open(os.path.join(tmp, "loop_meta.json"), "w") as f:
                json.dump(meta, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            _commit(path, final, step)
    _count("resilience_loop_checkpoints",
           "carry snapshots written by checkpointed st.loop")
    if mesh.rank == 0:
        _prune(path, keep=_KEEP_SNAPSHOTS, newest=step)
    return final


def _prune(path: str, keep: int, newest: int) -> None:
    """Keep the ``keep`` latest snapshots up to step ``newest``, the one
    just committed. Snapshots past it are an earlier run's, which
    ``LATEST.json`` no longer names; they go too (the JAX package keeps
    the highest-numbered ones, so there a fresh run into an earlier
    run's directory deletes its own new snapshot)."""
    steps = sorted(int(d[len("step_"):]) for d in os.listdir(path)
                   if d.startswith("step_"))
    kept = [s for s in steps if s <= newest][-keep:]
    for s in steps:
        if s not in kept:
            shutil.rmtree(_step_dir(path, s), ignore_errors=True)


def load_latest(path: str) -> Optional[Tuple[int, List[Any]]]:
    """(step, carries) of the last committed snapshot, or None."""
    from ..utils import checkpoint as ckpt

    marker = os.path.join(path, _LATEST)
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        latest = json.load(f)
    snap = os.path.join(path, latest["dir"])
    with open(os.path.join(snap, "loop_meta.json")) as f:
        meta = json.load(f)
    tree = ckpt.load_tree(snap)
    return int(meta["step"]), [tree[f"carry{i}"]
                               for i in range(int(meta["carries"]))]


def _note_restore_migrations(carries: List[Any],
                             rec: Dict[str, Any]) -> None:
    """Fold the restored carries' planned migrations (the snapshot was
    written on another grid) into the loop's record and the
    ``elastic_*`` counters."""
    migs = [m for m in (getattr(c, "_migration", None) for c in carries)
            if m]
    if not migs:
        return
    from . import elastic

    rec.setdefault("migrations", []).extend(migs)
    elastic.note_migrations(migs)
    log_info("st.loop restore: %d carr%s re-tiled through the migration "
             "planner (%d modeled wire bytes)", len(migs),
             "y" if len(migs) == 1 else "ies",
             sum(int(m.get("bytes", 0)) for m in migs))


def _add_note(e: BaseException, note: str) -> None:
    e.add_note(f"checkpointed st.loop: {note}")


def checkpointed_loop(n_iters: Any, body_fn: Any, init: Tuple[Any, ...], *,
                      with_index: bool, donate_init: bool, every: int,
                      path: Optional[str], resume: Optional[str],
                      health: bool = False, early_exit: bool = False,
                      stall_tol: float = 0.0) -> Any:
    """The loop behind ``st.loop(..., checkpoint_every=...)``.

    Runs when called and returns the final carries as ``ValExpr``s, so
    the call site keeps the lazy-loop surface (``.glom()``,
    ``.evaluate()``). Each carry's ``_resilience`` holds the run's record
    (segments, restores, the step it resumed from). ``health`` /
    ``early_exit`` / ``stall_tol`` go to every segment, and a segment
    that exited early ends the whole loop at its snapshot."""
    from ..obs import numerics as obs_numerics
    from ..expr.base import ScalarExpr, ValExpr, as_expr
    from ..expr.loop import loop as _loop

    n_expr = as_expr(n_iters)
    if not isinstance(n_expr, ScalarExpr):
        raise TypeError(
            "st.loop(..., checkpoint_every=/resume=) needs a static "
            "(Python int) iteration count: segmentation happens on the "
            "host")
    n = int(n_expr.pyvalue)
    if path is None:
        path = resume
    every = int(every) if every and every > 0 else n
    if every < n and path is None:
        raise ValueError(
            "st.loop(checkpoint_every=...) needs checkpoint_path= "
            "(or resume=) to write snapshots to")

    from ..parallel import mesh as mesh_mod

    start = 0
    carries: Optional[List[Any]] = None
    restored: List[Any] = []
    if resume is not None:
        latest = load_latest(resume) if os.path.isdir(resume) else None
        if latest is not None:
            start, carries = latest
            restored = carries
            _count("resilience_loop_resumes",
                   "checkpointed loops resumed from a snapshot")
            log_info("st.loop resume: restored iteration %d from %s",
                     start, resume)
        else:
            log_info("st.loop resume: no snapshot under %r; starting "
                     "fresh", resume)
    if carries is None:
        carries = [as_expr(i).evaluate() for i in init]

    rec: Dict[str, Any] = {
        "loop": True, "n": n, "checkpoint_every": every,
        "resumed_from": start if start else None,
        "restores": 0, "segments": 0, "retries": 0, "rung": None,
    }
    _note_restore_migrations(restored, rec)
    step = start
    rehome_passes = 0
    # restore only from a snapshot of this run (or the one it resumed):
    # ``path`` may still hold an earlier run's snapshots
    own = (start > 0 and path is not None
           and os.path.abspath(path) == os.path.abspath(resume))
    track_health = bool(health or early_exit)  # early_exit implies it
    stopped_early = False
    with prof.span("ckpt_loop", n=n, every=every, start=start):
        while step < n and not stopped_early:
            seg = min(every, n - step)
            if with_index:
                def body(i, *cs, _off=step):
                    # the offset is a scalar leaf: the global index is
                    # right and the plan still hits
                    return body_fn(i + _off, *cs)
            else:
                body = body_fn
            epoch = mesh_mod.mesh_epoch()
            try:
                with prof.span("loop_segment", step=step, seg=seg):
                    items = _loop(seg, body,
                                  *[ValExpr(c) for c in carries],
                                  with_index=with_index,
                                  donate_init=donate_init, health=health,
                                  early_exit=early_exit,
                                  stall_tol=stall_tol)
                    tup = items if isinstance(items, tuple) else (items,)
                    results = [it.evaluate() for it in tup]
            except Exception as e:
                kind = cls.classify(e)
                if kind == cls.DETERMINISTIC:
                    raise
                if kind == cls.STALE_MESH:
                    # after a rebuild, leaves the body captured (the
                    # k-means points) still belong to the dead epoch:
                    # rehome them and re-run the segment. Each pass heals
                    # every array the error names.
                    from . import elastic

                    rehome_passes += 1
                    if rehome_passes > 8:
                        raise
                    try:
                        healed = elastic.rehome(getattr(e, "arrays", ()))
                    except Exception as re_exc:
                        # a transient fault inside the rehome pass (the
                        # `recover` chaos seam): the re-run raises
                        # StaleMeshError again and the next pass heals
                        if cls.classify(re_exc) == cls.DETERMINISTIC:
                            raise
                        log_warn("st.loop: rehome pass failed (%s); "
                                 "re-entering recovery", str(re_exc)[:120])
                        continue
                    if not healed:
                        raise
                    rec["rehomed"] = rec.get("rehomed", 0) + len(e.arrays)
                    log_warn("st.loop: rehomed %d stale leaf array(s); "
                             "re-running the segment at iteration %d",
                             len(e.arrays), step)
                    continue
                if kind == cls.FATAL_MESH:
                    if mesh_mod.mesh_epoch() == epoch:
                        # nothing was rebuilt in this process: resume=
                        # in a new process (or a smaller world) recovers
                        raise
                    # elastic recovery rebuilt the mesh: restore the
                    # last snapshot onto it and re-enter the loop
                    rec["mesh_rebuilt"] = True
                    _count("resilience_loop_elastic_resumes",
                           "checkpointed loops re-entered on a rebuilt "
                           "mesh after device loss")
                rec["restores"] += 1
                _count("resilience_loop_restores",
                       "failed loop segments restored from the last good "
                       "snapshot")
                if rec["restores"] > FLAGS.loop_restore_max:
                    _add_note(e, f"{FLAGS.loop_restore_max} restores "
                                 f"exhausted at iteration {step}")
                    raise
                latest = load_latest(path) if own else None
                if latest is not None:
                    step, carries = latest
                    # carries written on the pre-loss grid restore as
                    # planned migrations onto the rebuilt mesh
                    _note_restore_migrations(carries, rec)
                    log_warn("st.loop: segment failed (%s: %s); "
                             "restored iteration %d from checkpoint",
                             kind, str(e)[:120], step)
                    continue
                if any(c.is_donated for c in carries):
                    _add_note(e, "no snapshot to restore and the "
                                 "segment donated its carries: cannot "
                                 "re-run")
                    raise
                log_warn("st.loop: segment failed (%s: %s); no snapshot "
                         "yet, re-running from the held carries", kind,
                         str(e)[:120])
                continue
            # the retries and the rung the policy engine took inside the
            # segment's evaluation
            for it in tup:
                r = getattr(it, "_resilience", None)
                if r:
                    rec["retries"] += r.get("retries", 0)
                    if r.get("rung"):
                        rec["rung"] = r["rung"]
            carries = results
            rec["segments"] += 1
            executed = seg
            if track_health:
                # the segment's series (read back when its loop ended)
                # says how many iterations ran
                series = obs_numerics.loop_health(tup[0].loop.label)
                if early_exit and series and len(series) < seg:
                    executed = len(series)
                    stopped_early = True
            step += executed
            if path is not None and (every < n or resume is not None):
                try:
                    save_snapshot(path, step, carries)
                except Exception as e:
                    if (mesh_mod.get_mesh().is_group
                            and cls.classify(e) == cls.FATAL_MESH):
                        # a peer died during the snapshot's barriers
                        raise cls.FatalMeshError(
                            f"a rank of the group was lost while "
                            f"writing the iteration-{step} snapshot "
                            f"({type(e).__name__}: {str(e)[:200]}); the "
                            "last committed snapshot is the one "
                            "LATEST.json names: resume from it in a "
                            "smaller world") from e
                    if not isinstance(e, OSError) or \
                            mesh_mod.get_mesh().is_group:
                        # on a group mesh the peers wait for this rank's
                        # blobs at the snapshot's barriers: carrying on
                        # alone would split the group, so the failure
                        # propagates (LATEST.json names the previous
                        # snapshot; resume= recovers)
                        raise
                    # a failed snapshot must not kill a healthy run:
                    # the carries live on, the next boundary retries
                    # the write, and the previous snapshot (LATEST.json
                    # is written last) stays the restore point
                    rec["checkpoint_failures"] = (
                        rec.get("checkpoint_failures", 0) + 1)
                    _count("resilience_checkpoint_failures",
                           "loop snapshot writes that failed "
                           "(non-fatal; previous snapshot intact)")
                    log_warn("st.loop: snapshot at iteration %d failed "
                             "(%s); continuing, the previous snapshot "
                             "remains the restore point", step,
                             str(e)[:120])
                    continue
                own = True

    out = []
    for c in carries:
        v = ValExpr(c)
        v._resilience = rec
        out.append(v)
    return out[0] if len(out) == 1 else tuple(out)
