"""The retry policy engine: what ``evaluate()`` does when a run fails
(port of ``spartan_tpu/resilience/engine.py``).

``expr/base.evaluate`` wraps each run of a plan; an exception lands in
:func:`handle_failure`, which executes the classifier's decision table
(:mod:`resilience.classify`):

* **transient / io** — retry the same plan with exponential backoff and
  jitter, up to ``FLAGS.retry_max`` attempts per failure and
  ``FLAGS.retry_budget`` retries per plan (per tenant and plan inside a
  :class:`tenant_scope`). Each attempt records a ``retry`` span and the
  ``resilience_retries`` / ``resilience_recovered`` counters. A real
  (not injected) failure of a run that donated its inputs is not
  retried: the donated tensors may be gone.
* **oom** — the degradation ladder (:mod:`resilience.degrade`). Inside
  a degraded evaluation the OOM propagates, so the outer ladder
  advances (no nested ladders).
* **fatal_mesh** — elastic recovery (:mod:`resilience.elastic`), then
  :class:`~resilience.classify.FatalMeshError`: the failed run's inputs
  belong to the dead mesh, so the resume happens above (the
  checkpointed loop restores its snapshot on the rebuilt mesh).
* **stale_mesh** — fail fast with the remedy attached (the checkpointed
  loop intercepts it and rehomes).
* **deterministic** — fail fast, with the plan's key, root and build
  site attached as a note.

Exhausted retries and ladders write a crash dump (:func:`_dump`,
``obs/numerics.dump_crash``) before re-raising, with the flight
recorder's recent requests (``obs/flight.py``).
:func:`retry_evaluate` is the caller-level loop behind
the deprecated ``utils/recovery.evaluate_with_recovery``.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs.explain import key_hash
from ..obs.metrics import METRICS_FLAG as _METRICS_FLAG
from ..obs.metrics import REGISTRY, labeled
from ..utils import profiling as prof
from ..utils.config import FLAGS
from ..utils.log import log_warn
from . import classify as cls
from . import degrade

FLAGS.define_int(
    "retry_max", 3,
    "Max transient-fault retries per failure episode inside "
    "evaluate() (0 disables in-evaluate retry).")
FLAGS.define_float(
    "retry_backoff_s", 0.05,
    "Base backoff before the first in-evaluate retry; doubles per "
    "attempt (jittered +/-50%), capped at retry_backoff_max_s.")
FLAGS.define_float(
    "retry_backoff_max_s", 2.0,
    "Backoff ceiling for in-evaluate retries.")
FLAGS.define_int(
    "retry_budget", 32,
    "Lifetime retry budget per plan (keyed on the plan key): a plan "
    "that keeps failing transiently stops retrying once the budget is "
    "spent, so a misclassified deterministic fault cannot retry "
    "forever.")
FLAGS.define_bool(
    "resilience", True,
    "Master switch for the in-evaluate policy engine (classifier + "
    "retry + OOM degradation + elastic recovery). Off = failures "
    "propagate raw.")
FLAGS.define_int(
    "serve_tenant_retry_quota", 0,
    "Tenant-wide lifetime retry quota across all plans, on top of the "
    "per-plan retry_budget, for failures inside a tenant_scope. "
    "0 = disabled (per-plan budgets only).")

# deterministic jitter source (reproducible test timing)
_rng = random.Random(0xC0FFEE)

# (tenant, plan digest) -> retries consumed, plus tenant-wide totals;
# every mutation holds _budget_lock (never held while running a plan)
_budget_lock = threading.Lock()
_budget_used: Dict[str, int] = {}
_tenant_used: Dict[str, int] = {}

_TENANT_TLS = threading.local()

# the last crash record _dump wrote (reason and resilience record)
_last_dump: Optional[Dict[str, Any]] = None


class tenant_scope:
    """Tag this thread's failures with a tenant: retries inside the
    scope charge ``<tenant>/<plan digest>`` (and the tenant-wide
    ``FLAGS.serve_tenant_retry_quota``) instead of the shared per-plan
    account."""

    __slots__ = ("tenant", "_prev")

    def __init__(self, tenant: Optional[str]):
        self.tenant = tenant
        self._prev: Optional[str] = None

    def __enter__(self) -> "tenant_scope":
        self._prev = getattr(_TENANT_TLS, "tenant", None)
        _TENANT_TLS.tenant = self.tenant
        return self

    def __exit__(self, *exc: Any) -> None:
        _TENANT_TLS.tenant = self._prev


def current_tenant() -> Optional[str]:
    return getattr(_TENANT_TLS, "tenant", None)


def reset() -> None:
    """Forget per-plan and per-tenant retry budgets (test isolation)."""
    with _budget_lock:
        _budget_used.clear()
        _tenant_used.clear()


def _attach_note(exc: BaseException, note: str) -> None:
    """Add a PEP-678 note; a frozen exception keeps its original."""
    try:
        exc.add_note(note)
    except Exception:
        pass


def _resilience_record(expr: Any, plan: Any) -> Dict[str, Any]:
    """The per-plan resilience record: on the plan report (so a later
    hit of the plan shows it) and on the expr."""
    rec: Optional[Dict[str, Any]] = None
    if plan is not None and plan.report is not None:
        rec = plan.report.setdefault(
            "resilience", {"retries": 0, "faults": [], "rung": None})
    if rec is None:
        rec = getattr(expr, "_resilience", None) or {
            "retries": 0, "faults": [], "rung": None}
    expr._resilience = rec
    return rec


def _plan_digest(plan: Any) -> str:
    try:
        return key_hash(plan.key) or "?"
    except Exception:
        return "?"


def _sleep_backoff(attempt: int) -> float:
    base = FLAGS.retry_backoff_s
    if base <= 0:
        return 0.0
    delay = min(FLAGS.retry_backoff_max_s, base * (2 ** attempt))
    delay *= 0.5 + _rng.random()  # +/-50% jitter
    time.sleep(delay)
    return delay


def _dump(reason: str, plan: Any, rec: Dict[str, Any]) -> None:
    """Write the crash record of a terminal failure through
    ``obs/numerics.dump_crash`` (the reason, the plan report, the
    resilience record, spans, health, ledger and metrics) and keep its
    summary as ``_last_dump``; never raises."""
    global _last_dump
    from ..obs import numerics as numerics_mod

    try:
        report = plan.report if plan is not None and plan.report else None
        doc = {"reason": reason,
               "plan_report": ({k: v for k, v in report.items()
                                if k != "resilience"}
                               if report is not None else None),
               "resilience": dict(rec), "path": None}
        _last_dump = doc
        doc["path"] = numerics_mod.dump_crash(
            reason=reason, plan_report=doc["plan_report"],
            extra={"resilience": dict(rec)})
        log_warn("resilience: %s; crash dump at %s", reason, doc["path"])
    except Exception:
        pass  # forensics must never mask the real failure


def _donation_in_flight(leaves: List[Any], donated: List[Any]) -> bool:
    from ..expr.base import _leaf_array

    if donated:
        return True
    for leaf in leaves:
        arr = _leaf_array(leaf)
        if arr is not None and getattr(arr, "_donate_next", False):
            return True
    return False


def handle_failure(exc: BaseException, expr: Any, plan: Any,
                   leaves: List[Any], order: Tuple[int, ...],
                   donated: List[Any], mesh) -> Any:
    """Run by ``evaluate()`` when a run of ``plan`` raised ``exc``.
    Returns a result (a retry or a rung succeeded) or raises."""
    if not FLAGS.resilience:
        raise exc
    kind = cls.classify(exc)
    rec = _resilience_record(expr, plan)
    rec["faults"].append(
        {"class": kind, "error": f"{type(exc).__name__}: "
                                 f"{str(exc)[:200]}"})

    if kind == cls.FATAL_MESH:
        # a device or peer is gone: no retry of this plan can succeed.
        # Elastic recovery rebuilds the mesh where it can; the resume
        # happens above (the checkpointed loop restores its snapshot)
        from . import elastic

        if getattr(exc, "quarantined", None) is not None and mesh.is_group:
            # the integrity sentinel quarantined a rank of the group:
            # every rank raises this same error, and the world restarts
            # without that rank from its per-rank snapshots
            _attach_note(exc, "resilience: a group mesh cannot drop a "
                         "rank in its processes; not retried")
            _dump("integrity quarantine on a group mesh", plan, rec)
            raise exc

        if _METRICS_FLAG._value:
            REGISTRY.counter(
                "resilience_fatal_mesh_faults",
                "dispatch failures classified fatal_mesh "
                "(persistent device/host loss)").inc()
        new_mesh = elastic.on_fatal_mesh(exc, mesh)
        if new_mesh is None:  # FLAGS.elastic_recovery off: fail fast
            _attach_note(
                exc, "resilience: fatal mesh failure and elastic "
                "recovery is disabled (FLAGS.elastic_recovery)")
            _dump("fatal mesh failure (elastic off)", plan, rec)
            raise exc
        rec["mesh_rebuilt"] = True
        n = len(new_mesh.ids)
        if isinstance(exc, cls.FatalMeshError):
            _attach_note(
                exc, f"resilience: mesh rebuilt over {n} surviving "
                "position(s) (elastic recovery); resume loops from their "
                "checkpoints")
            raise exc
        raise cls.FatalMeshError(
            f"persistent device/host loss ({type(exc).__name__}: "
            f"{str(exc)[:200]}); mesh rebuilt over {n} surviving "
            "position(s) — resume loops from their checkpoints",
            failed_devices=getattr(exc, "failed_devices", ()),
        ) from exc

    if kind == cls.STALE_MESH:
        _attach_note(
            exc, "resilience: stale mesh epoch — not retried (rehome "
            "or re-create the inputs on the rebuilt mesh)")
        raise exc

    if kind == cls.OOM:
        if degrade.active_rung() is not None:
            # inside a degraded re-plan: the outer ladder advances
            raise exc
        return degrade.run_ladder(exc, expr, donated, mesh, plan)

    if kind in (cls.TRANSIENT, cls.IO, cls.SDC):
        if _METRICS_FLAG._value:
            if kind == cls.SDC:
                REGISTRY.counter(
                    "resilience_sdc_faults",
                    "dispatch results discarded by the integrity "
                    "sentinel (failed checksum cross-check)").inc()
            else:
                REGISTRY.counter(
                    "resilience_transient_faults",
                    "dispatch failures classified transient/io").inc()
        if (not getattr(exc, "injected", False)
                and _donation_in_flight(leaves, donated)):
            _attach_note(
                exc, "resilience: retry skipped — the failed run donated "
                "its inputs, which a partial run may already have "
                "released; re-create the donated arrays and re-evaluate")
            raise exc
        from ..expr import base

        tenant = current_tenant()
        digest = _plan_digest(plan)
        account = f"{tenant}/{digest}" if tenant else digest
        attempt = 0
        last = exc
        while attempt < FLAGS.retry_max:
            exhausted: Optional[str] = None
            with _budget_lock:
                used = _budget_used.get(account, 0)
                quota = FLAGS.serve_tenant_retry_quota
                if used >= FLAGS.retry_budget:
                    exhausted = (f"per-plan retry budget "
                                 f"({FLAGS.retry_budget}) exhausted "
                                 f"for {account}")
                elif (tenant and quota > 0
                        and _tenant_used.get(tenant, 0) >= quota):
                    exhausted = (f"tenant retry quota ({quota}) "
                                 f"exhausted for tenant {tenant!r}")
                else:
                    _budget_used[account] = used + 1
                    if tenant:
                        _tenant_used[tenant] = (
                            _tenant_used.get(tenant, 0) + 1)
            if exhausted is not None:
                _attach_note(last, "resilience: " + exhausted)
                _dump("retry budget exhausted", plan, rec)
                raise last
            delay = _sleep_backoff(attempt)
            rec["retries"] += 1
            if _METRICS_FLAG._value:
                REGISTRY.counter(
                    "resilience_retries",
                    "dispatch retries attempted by the policy "
                    "engine").inc()
                if tenant:
                    REGISTRY.counter(
                        labeled("resilience_retries", tenant=tenant),
                        "per-tenant dispatch retries (serve)").inc()
            with prof.span("retry", attempt=attempt, plan=digest,
                           error_class=kind,
                           backoff_ms=round(delay * 1e3, 1)) as rsp:
                try:
                    result = base._dispatch(expr, plan, leaves, order,
                                            donated, mesh)
                except Exception as e:  # classify and route the retry
                    rsp.set(failed=type(e).__name__)
                    k2 = cls.classify(e)
                    rec["faults"].append(
                        {"class": k2, "error": f"{type(e).__name__}: "
                                               f"{str(e)[:200]}"})
                    if k2 == cls.OOM:
                        if degrade.active_rung() is not None:
                            raise
                        return degrade.run_ladder(e, expr, donated,
                                                  mesh, plan)
                    if k2 not in (cls.TRANSIENT, cls.IO, cls.SDC):
                        _attach_note(
                            e, f"resilience: while retrying after a "
                            f"{kind} fault (attempt {attempt + 1})")
                        raise
                    last = e
                    attempt += 1
                    continue
            if _METRICS_FLAG._value:
                REGISTRY.counter(
                    "resilience_recovered",
                    "evaluations recovered by retry").inc()
            log_warn("resilience: recovered after %d retry(ies) "
                     "(plan %s)", attempt + 1, digest)
            return result
        _attach_note(
            last, f"resilience: {FLAGS.retry_max} retry(ies) "
            f"exhausted for plan {digest} (transient fault persisted)")
        _dump("transient retries exhausted", plan, rec)
        raise last

    # deterministic: fail fast, with the plan summary attached
    if _METRICS_FLAG._value:
        REGISTRY.counter(
            "resilience_deterministic_failures",
            "dispatch failures classified deterministic (not "
            "retried)").inc()
    note = "resilience: deterministic failure — not retried"
    if plan is not None and plan.report is not None:
        r = plan.report
        note += (f" (plan {r.get('plan_key')}, root {r.get('root')}"
                 + (f", built at {r['site']}" if r.get("site") else "")
                 + ")")
    _attach_note(exc, note)
    raise exc


def retry_evaluate(expr: Any, retries: int = 2, backoff_s: float = 0.0,
                   retryable: Optional[Tuple[type, ...]] = None,
                   on_failure: Optional[Callable] = None) -> Any:
    """Caller-level detection and lineage-recovery loop (the engine
    behind the deprecated ``evaluate_with_recovery``).

    With ``retryable=None`` the classifier decides: transient, io and
    oom failures re-evaluate from lineage, deterministic errors
    propagate at once. An explicit ``retryable`` tuple keeps the
    legacy isinstance rule."""
    for attempt in range(retries + 1):
        try:
            return expr.evaluate()
        except Exception as e:
            if retryable is not None:
                ok = isinstance(e, retryable)
            else:
                ok = cls.classify(e) != cls.DETERMINISTIC
            if not ok or attempt == retries:
                raise
            log_warn("retry_evaluate: attempt %d/%d failed (%s); "
                     "recomputing from lineage", attempt + 1,
                     retries + 1, e)
            if _METRICS_FLAG._value:
                REGISTRY.counter(
                    "resilience_driver_retries",
                    "caller-level lineage retries (retry_evaluate / "
                    "the deprecated evaluate_with_recovery)").inc()
            expr.invalidate()
            if on_failure is not None:
                on_failure(attempt, e)
            if backoff_s:
                time.sleep(backoff_s * (2 ** attempt))
