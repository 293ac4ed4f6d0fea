"""The OOM ladder: trade speed for memory instead of failing (port of
``spartan_tpu/resilience/degrade.py``).

On a failure classified ``oom`` the policy engine walks this ladder,
rung by rung, until one fits:

1. ``finer_tiling`` — re-plan a clone of the DAG with the finest
   divisible candidate tiling forced on every interior node.
2. ``fusion_off`` — the same, with the map and reduce fusion passes off
   (smaller fused bodies, shorter live ranges).
3. ``chunked`` — evaluate the root in row blocks (slices along axis 0),
   each fetched to the host and reassembled: the device holds one
   block's worth at a time. Array roots only.

Each rung evaluates under a degrade context whose rung name is part of
the plan key (``expr/base._opt_flags_key``), so a degraded plan never
collides with a normal one; the rung taken is recorded on the plan
report and in the ``resilience_degrade_<rung>`` counters. The re-plan
works on a clone of the DAG (fresh interior nodes, shared leaves,
evaluated sub-DAGs as Val leaves), so the user's expressions are never
mutated.

On a logical mesh a tiling is metadata over the one tensor, so the
first two rungs change the plan (and, through the kernels' selection,
the code path) rather than the bytes a device holds; the chunked rung
does bound them. On a group mesh ``finer_tiling`` shrinks what a rank
holds: each node keeps a finer block, and a product re-planned at the
finer output grid computes its block with the contraction whole, with
no k-split partial product and all-reduce copy.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

from ..obs.metrics import METRICS_FLAG as _METRICS_FLAG
from ..obs.metrics import REGISTRY
from ..utils import profiling as prof
from ..utils.config import FLAGS
from ..utils.log import log_warn

FLAGS.define_bool(
    "oom_degrade", True,
    "On an out-of-memory failure, walk the degradation ladder (replan "
    "at finer tiling -> fusion passes off -> chunked row-block "
    "evaluation) instead of raising. Each rung is keyed into the plan "
    "cache so degraded and normal plans never collide.")
FLAGS.define_int(
    "degrade_chunks", 0,
    "Row-block count for the 'chunked' ladder rung (0 = one block per "
    "mesh position, min 2).")

RUNGS = ("finer_tiling", "fusion_off", "chunked")

# Thread-local degrade context: expr/base reads ``_TLS.rung`` into every
# plan key; only the ladder sets it.
_TLS = threading.local()


def active_rung() -> Optional[str]:
    return getattr(_TLS, "rung", None)


class _RungCtx:
    """Set and restore the degrade rung (and, from ``fusion_off`` on,
    the fusion pass flags) around one degraded re-plan."""

    __slots__ = ("rung", "_prev", "_flags")

    def __init__(self, rung: str):
        self.rung = rung
        self._prev = None
        self._flags = None

    def __enter__(self) -> "_RungCtx":
        self._prev = getattr(_TLS, "rung", None)
        _TLS.rung = self.rung
        if self.rung in ("fusion_off", "chunked"):
            self._flags = (FLAGS.opt_map_fusion, FLAGS.opt_reduce_fusion)
            FLAGS.opt_map_fusion = False
            FLAGS.opt_reduce_fusion = False
        return self

    def __exit__(self, *exc: Any) -> None:
        _TLS.rung = self._prev
        if self._flags is not None:
            FLAGS.opt_map_fusion, FLAGS.opt_reduce_fusion = self._flags


class NotApplicable(Exception):
    """A rung that cannot apply to this root (chunking a scalar)."""


def clone_for_replan(root: Any) -> Any:
    """Copy the interior of a DAG (fresh ``_id``s, no forced tilings, no
    cached results), sharing its leaves and turning every interior node
    that already holds a result into a Val leaf, as the plan signature
    sees it. Forcing tilings on the clone never touches the user's
    expressions."""
    from ..array.distarray import DistArray
    from ..expr.base import ValExpr

    memo = {}

    def go(n):
        out = memo.get(n._id)
        if out is not None:
            return out
        if (n._result is not None and not isinstance(n, ValExpr)
                and isinstance(n._result, DistArray)):
            out = ValExpr(n._result)
        else:
            kids = n.children()
            out = n if not kids else n.replace_children(
                tuple(go(k) for k in kids))
        memo[n._id] = out
        return out

    return go(root)


# -- autotune replan/warm (obs/monitor's daemon) ------------------------


def replan_for_profile(template: Any, mesh) -> Optional[Any]:
    """Re-plan a result-free template DAG under the CURRENTLY installed
    calibration profile — optimizer only: sign a fresh clone, look the
    key up, build on a miss. Nothing runs. The profile's fingerprint is
    part of the plan key, so the challenger lands in the plan cache
    WITHOUT touching the incumbent. Returns the (possibly cached) plan,
    or None when the structure is uncacheable."""
    from ..expr import base

    clone = clone_for_replan(template)
    plan_key, rctx = base.plan_signature(clone, mesh)
    plan = base.lookup_plan(plan_key)
    if plan is None:
        plan, _dag, _leaves = base._build_plan(clone, mesh, rctx,
                                               plan_key)
    return plan


def warm_evaluate(template: Any, mesh) -> bool:
    """Evaluate a fresh clone of ``template`` once, off the hot path
    (the autotune daemon's challenger warm-up), so the first re-keyed
    request is a plan-cache hit. Advisory: an ordinary failure is
    swallowed and counted in ``monitor_warm_failures``, and the swap
    stands on the modeled win alone. A ``fatal_mesh`` error (a sticky
    CUDA error, a lost peer) is re-raised: the context it poisoned must
    reach the caller, never be hidden by an advisory warm-up."""
    from ..expr import base
    from ..parallel import mesh as mesh_mod
    from . import classify

    clone = clone_for_replan(template)
    try:
        with mesh_mod.use_mesh(mesh):
            base.evaluate(clone)
        return True
    except Exception as e:  # noqa: BLE001 - warm-up is advisory; the
        # resilience engine already classified/retried inside evaluate
        if classify.classify(e) == classify.FATAL_MESH:
            raise
        if _METRICS_FLAG._value:
            REGISTRY.counter(
                "monitor_warm_failures",
                "autotune challenger warm-up evaluations that failed "
                "(advisory; the hot-swap decision is model-based)").inc()
        return False


def force_finer(dag: Any, mesh) -> int:
    """Force the finest divisible candidate tiling on every interior
    node of ``dag`` (a clone). Returns how many nodes were re-forced.
    Runs in ``expr/base.evaluate`` between the optimizer and the
    signature."""
    from ..array import tiling as tiling_mod
    from ..expr import tiling_cost
    from ..expr.base import ScalarExpr, ValExpr
    from ..expr.optimize import dag_nodes

    forced = 0
    for n in dag_nodes(dag):
        if isinstance(n, (ValExpr, ScalarExpr)) or not n.children():
            continue
        if n.ndim == 0:
            continue
        cands = tiling_cost.candidates(n, mesh)
        if not cands:
            continue
        best = max(cands, key=lambda t: tiling_cost._parallelism(t, mesh))
        try:
            cur = tiling_mod.sanitize(n.out_tiling(), n.shape, mesh)
        except Exception:
            cur = tiling_mod.replicated(n.ndim)
        if (tiling_cost._parallelism(best, mesh)
                > tiling_cost._parallelism(cur, mesh)):
            n._forced_tiling = best
            if getattr(n, "_dot_plan", None) is not None:
                # the product computes its finer output block directly,
                # with its contraction whole (no partial product and no
                # all-reduce copy a rank would hold beside it)
                n._dot_plan = (best, None)
            forced += 1
    return forced


def _replan_evaluate(expr: Any, donated: List[Any], rung: str) -> Any:
    """Evaluate a clone of the DAG under the degrade context; the plan
    cache keys on the rung, so a repeated degradation of the same
    structure is a plan-cache hit."""
    from ..expr import base

    clone = clone_for_replan(expr)
    with _RungCtx(rung):
        return base.evaluate(clone, donate=donated)


def rung_predicted_bytes(expr: Any, rung: str, mesh) -> Optional[int]:
    """The memory governor's modelled card peak for ``rung``'s re-plan
    of ``expr`` (``resilience/memory.py``; the re-plan is a plan-cache
    hit after the rung ran), or None when no model is available."""
    from .memory import _rung_estimate

    try:
        return _rung_estimate(expr, rung, mesh)[1]
    except Exception:  # noqa: BLE001 - the prediction is a record only
        return None


def _chunk_bounds(n_rows: int, chunks: int) -> List[int]:
    chunks = max(2, min(chunks, n_rows))
    step = -(-n_rows // chunks)
    return list(range(0, n_rows, step)) + [n_rows]


def _chunked_evaluate(expr: Any, mesh) -> Any:
    """Evaluate ``expr`` in row blocks: slice the root along axis 0,
    force each block on its own, fetch it to the host and reassemble
    into a new DistArray."""
    import numpy as np

    from ..array import distarray as da
    from ..expr.base import TupleExpr
    from ..parallel import mesh as mesh_mod

    if isinstance(expr, TupleExpr) or expr.ndim == 0:
        raise NotApplicable(
            "chunked evaluation needs a single array-shaped root")
    n_rows = int(expr.shape[0])
    if n_rows < 2:
        raise NotApplicable("root has fewer than 2 rows to chunk")
    chunks = FLAGS.degrade_chunks or mesh_mod.device_count(mesh)
    bounds = _chunk_bounds(n_rows, chunks)
    out = np.empty(expr.shape, expr.dtype)
    with _RungCtx("chunked"):
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            out[lo:hi] = np.asarray(expr[lo:hi].evaluate().glom())
    return da.from_numpy(out, mesh=mesh)


def _count(rung: str) -> None:
    if _METRICS_FLAG._value:
        REGISTRY.counter(
            "resilience_degrades",
            "OOM degradations that produced a result").inc()
        REGISTRY.counter(
            f"resilience_degrade_{rung}",
            f"degradations resolved at the {rung} rung").inc()


def run_ladder(exc: BaseException, expr: Any, donated: List[Any],
               mesh, plan: Any) -> Any:
    """Walk the ladder for an OOM-classified failure. Returns the result
    (also set on ``expr._result`` and recorded on the plan report and
    ``expr._resilience``); raises the last OOM, annotated, when every
    rung fails too or none applies."""
    from . import classify as classify_mod
    from .engine import _attach_note, _dump, _resilience_record

    if not FLAGS.oom_degrade:
        raise exc
    rec = _resilience_record(expr, plan)
    rec["oom_events"] = rec.get("oom_events", 0) + 1
    if _METRICS_FLAG._value:
        REGISTRY.counter("resilience_oom_events",
                         "dispatch failures classified as OOM").inc()
    last = exc
    for rung in RUNGS:
        log_warn("resilience: OOM (%s) — degrading to rung %r",
                 str(last)[:120], rung)
        try:
            with prof.span("degrade", rung=rung,
                           error=type(last).__name__):
                if rung == "chunked":
                    result = _chunked_evaluate(expr, mesh)
                else:
                    result = _replan_evaluate(expr, donated, rung)
        except NotApplicable:
            continue
        except Exception as e:  # the ladder's advance decision
            if classify_mod.classify(e) != classify_mod.OOM:
                _attach_note(
                    e, f"while degrading to rung {rung!r} after: {last}")
                raise
            last = e
            continue
        rec["rung"] = rung
        rec["degraded"] = True
        rec["origin"] = "reactive"
        if rung != "chunked":
            predicted = rung_predicted_bytes(expr, rung, mesh)
            if predicted is not None:
                rec["rung_predicted_bytes"] = predicted
        _count(rung)
        expr._result = result
        expr._resilience = rec
        return result
    _attach_note(last, "OOM degradation ladder exhausted (rungs tried: "
                       f"{', '.join(RUNGS)})")
    _dump("resilience: OOM degradation ladder exhausted", plan, rec)
    raise last
