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
* ``fatal_mesh`` (a dead device, or CUDA's sticky errors, after which
  the process's CUDA context is unusable) and ``stale_mesh`` propagate
  at once: the elastic recovery of the JAX package waits for
  ``rebuild_mesh`` and the resilience engine (ROADMAP A3b-iii/A5).
  ``resume=`` in a new process is what recovers them;
* an I/O error while writing or reading a snapshot propagates (the
  previous snapshot stays whole).

``resume=path`` continues from the last snapshot under ``path`` (a fresh
start when there is none). ``health`` / ``early_exit`` are not ported
(ROADMAP A4).

Observability, as in the JAX package: a ``ckpt_loop`` span around the
run, a ``loop_segment`` span per segment and a ``loop_checkpoint`` span
per snapshot, and the ``REGISTRY`` counters
``resilience_loop_checkpoints``, ``resilience_loop_resumes`` and
``resilience_loop_restores``. The JAX package's
``resilience_loop_elastic_resumes`` and
``resilience_checkpoint_failures`` count branches the port does not
have (elastic recovery, ROADMAP A3b-iii/A5; a failed snapshot write
propagates here).

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


def save_snapshot(path: str, step: int, carries: List[Any]) -> str:
    """Atomically snapshot the carries after iteration ``step``; the
    ``LATEST.json`` marker is written (atomically) only after the
    snapshot directory is in place."""
    from ..utils import checkpoint as ckpt

    os.makedirs(path, exist_ok=True)
    final = _step_dir(path, step)
    with prof.span("loop_checkpoint", step=step):
        tmp = os.path.join(path, f".tmp_step_{step}_{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        ckpt.save_tree(tmp, {f"carry{i}": c
                             for i, c in enumerate(carries)})
        with open(os.path.join(tmp, "loop_meta.json"), "w") as f:
            json.dump({"step": int(step), "carries": len(carries)}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        ltmp = os.path.join(path, f".{_LATEST}.{os.getpid()}")
        with open(ltmp, "w") as f:
            json.dump({"step": int(step),
                       "dir": os.path.basename(final)}, f)
        os.replace(ltmp, os.path.join(path, _LATEST))
    _count("resilience_loop_checkpoints",
           "carry snapshots written by checkpointed st.loop")
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


def _add_note(e: BaseException, note: str) -> None:
    e.add_note(f"checkpointed st.loop: {note}")


def checkpointed_loop(n_iters: Any, body_fn: Any, init: Tuple[Any, ...], *,
                      with_index: bool, donate_init: bool, every: int,
                      path: Optional[str], resume: Optional[str]) -> Any:
    """The loop behind ``st.loop(..., checkpoint_every=...)``.

    Runs when called and returns the final carries as ``ValExpr``s, so
    the call site keeps the lazy-loop surface (``.glom()``,
    ``.evaluate()``). Each carry's ``_resilience`` holds the run's record
    (segments, restores, the step it resumed from)."""
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

    start = 0
    carries: Optional[List[Any]] = None
    if resume is not None:
        latest = load_latest(resume) if os.path.isdir(resume) else None
        if latest is not None:
            start, carries = latest
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
        "restores": 0, "segments": 0,
    }
    step = start
    # restore only from a snapshot of this run (or the one it resumed):
    # ``path`` may still hold an earlier run's snapshots
    own = (start > 0 and path is not None
           and os.path.abspath(path) == os.path.abspath(resume))
    with prof.span("ckpt_loop", n=n, every=every, start=start):
        while step < n:
            seg = min(every, n - step)
            if with_index:
                def body(i, *cs, _off=step):
                    # the offset is a scalar leaf: the global index is
                    # right and the plan still hits
                    return body_fn(i + _off, *cs)
            else:
                body = body_fn
            try:
                with prof.span("loop_segment", step=step, seg=seg):
                    items = _loop(seg, body,
                                  *[ValExpr(c) for c in carries],
                                  with_index=with_index,
                                  donate_init=donate_init)
                    tup = items if isinstance(items, tuple) else (items,)
                    results = [it.evaluate() for it in tup]
            except Exception as e:
                kind = cls.classify(e)
                if kind in (cls.DETERMINISTIC, cls.FATAL_MESH,
                            cls.STALE_MESH):
                    raise
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
            carries = results
            rec["segments"] += 1
            step += seg
            if path is not None and (every < n or resume is not None):
                save_snapshot(path, step, carries)
                own = True

    out = []
    for c in carries:
        v = ValExpr(c)
        v._resilience = rec
        out.append(v)
    return out[0] if len(out) == 1 else tuple(out)
