"""The concurrent serving engine: workers, batching window, dispatch
(port of ``spartan_tpu/serve/engine.py``).

One :class:`ServeEngine` owns a bounded :class:`AdmissionQueue` and a
small pool of worker threads. The request lifecycle:

1. **submit** (caller thread): normalize donation, capture the ambient
   mesh, sign the raw DAG once (``base.plan_signature`` — the same
   traversal ``evaluate()`` would do), then enqueue. Admission past
   the high-water mark raises ``Backpressure(retry_after_s=...)``
   instead of queueing unbounded latency; with a device-memory budget
   known (the predictive memory governor) a submission whose
   predicted peak cannot fit next to the in-flight memory
   reservations is rejected the same way.
2. **batch** (worker): pop the head request, pull every queued request
   with the same plan signature, linger one batching window
   (``FLAGS.serve_batch_window_s``) for stragglers, and re-pull.
3. **dispatch**: a batch of one (or a donating / uncacheable-plan /
   unknown-plan request) goes through plain ``evaluate()`` under the
   request's tenant scope + deadline scope; a batch of N goes through
   the coalescer (one batched walk, N responses). A failed
   coalesced dispatch falls back to solo dispatches, where the
   resilience policy engine applies classification, per-tenant retry
   budgets and backoff per request.
4. **resolve**: each request's future resolves with its DistArray
   (the kernels its walk launched may still run on the card — fetch
   waits for them); donated buffers were released by the walk's
   epilogue. Workers launch on the device's default stream, so a result
   handed to another thread needs no event.

Deadlines: a request whose deadline expires in the queue is shed with
``DeadlineExceeded`` (never dispatched); the remaining time of a live
request propagates into the dispatch watchdog
(``obs/numerics.deadline_scope``), so a dispatch that would blow the
deadline dumps in-flight forensics.

Tenancy: ``tenant=`` labels flow into per-tenant metrics
(``serve_requests{tenant="..."}`` in the Prometheus export) and into
the resilience engine's per-tenant retry accounts
(``engine.tenant_scope``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

from .. import persist as persist_mod
from ..expr import base
from ..obs import flight as flight_mod
from ..obs import ledger as ledger_mod
from ..obs import numerics as numerics_mod
from ..obs import profile as profile_mod
from ..obs import skew as skew_mod
from ..obs import trace as trace_mod
from ..obs.explain import key_hash
from ..obs import slo as slo_mod
from ..obs.metrics import METRICS_FLAG as _METRICS_FLAG
from ..obs.metrics import REGISTRY, labeled
from ..parallel import mesh as mesh_mod
from ..resilience import engine as resilience_engine
from ..resilience import integrity as integrity_mod
from ..resilience import memory as memory_mod
from ..utils import profiling as prof
from ..utils.config import FLAGS
from ..utils.log import log_warn
from ..resilience import classify as resilience_classify
from . import coalesce
from .future import (Backpressure, CommBudgetExceeded, DeadlineExceeded,
                     EvalFuture, MeshReconfiguring)
from .queue import AdmissionQueue


def _sdc_in_chain(e: Optional[BaseException]) -> bool:
    """True when this failure originated in an integrity violation:
    either it IS the sentinel's IntegrityError (class 'sdc'), or it is
    the StaleMeshError the policy engine's post-quarantine retry
    surfaced while handling one (implicit exception chaining keeps the
    IntegrityError on __context__)."""
    seen = 0
    while e is not None and seen < 8:
        if resilience_classify.classify(e) == resilience_classify.SDC:
            return True
        e = e.__cause__ or e.__context__
        seen += 1
    return False

FLAGS.define_int(
    "serve_workers", 2,
    "Worker threads in the default serve engine's dispatch pool.")
FLAGS.define_int(
    "serve_queue_max", 1024,
    "Admission-control high-water mark: submissions past this queue "
    "depth are rejected with Backpressure(retry_after_s=...) instead "
    "of queueing unbounded latency.")
FLAGS.define_float(
    "serve_batch_window_s", 0.002,
    "Coalescing linger: after popping a request, a worker waits up to "
    "this long for more identical-signature submissions before "
    "dispatching the batch. 0 = dispatch immediately (coalesce only "
    "what is already queued).")
FLAGS.define_int(
    "serve_max_batch", 32,
    "Maximum clients coalesced into one batched walk (the batch size "
    "is part of the variant key; a new size builds a new variant).")
FLAGS.define_bool(
    "serve_coalesce", True,
    "Coalesce identical-signature requests into leading-axis batched "
    "walks (one walk, N responses). Off = every "
    "request dispatches solo (still async, still admission-controlled).")
_MODEL_PRICING_FLAG = FLAGS.define_bool(
    "serve_model_pricing", True,
    "Price service-time predictions (deadline shedding, the ledger's "
    "service rows) with the calibrated cost model "
    "(ledger.predict_service_s: the plan's DP cost through the warmed "
    "seconds-per-cost-unit scale) instead of the raw queue EMA. Falls "
    "back to the EMA per request until the scale warms or when the "
    "plan has no priced entry.")
_COMM_BUDGET_FLAG = FLAGS.define_int(
    "comm_budget_bytes", 0,
    "Communication-aware admission: when > 0, a submission whose plan "
    "carries an audit verdict (analysis/plan_audit.py — the plan "
    "miss ran under FLAGS.verify_evaluate, or st.audit_plan was "
    "called) with modeled per-chip wire bytes above this budget is "
    "rejected with CommBudgetExceeded and the finding in its flight "
    "record. 0 = off (one flag read per submit).")


def _pow2_chunks(batch: List["_Request"]) -> List[List["_Request"]]:
    """Split a batch into largest-power-of-two-first chunks."""
    out: List[List["_Request"]] = []
    i = 0
    while i < len(batch):
        size = 1 << ((len(batch) - i).bit_length() - 1)
        out.append(batch[i:i + size])
        i += size
    return out


class _MemoryLedger:
    """In-flight memory reservations (the admission tier of the
    predictive memory governor, resilience/memory.py): each dispatch
    reserves its predicted per-chip peak when a worker picks it up and
    releases it at future resolution, so ``submit`` can reject
    combinations of requests whose modeled working sets cannot fit in
    device memory together — with a retryable ``Backpressure`` instead
    of a device OOM that trips the whole engine. One leaf lock; never held
    while dispatching."""

    __slots__ = ("_lock", "_reserved")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._reserved = 0

    def reserved(self) -> int:
        return self._reserved

    def reserve(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self._reserved += n
            now = self._reserved
        if _METRICS_FLAG._value:
            REGISTRY.gauge(
                "serve_mem_reserved_bytes",
                "predicted per-chip bytes reserved by in-flight serve "
                "dispatches (high-water tracked)").set(float(now))

    def release(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self._reserved = max(0, self._reserved - n)
            now = self._reserved
        if _METRICS_FLAG._value:
            REGISTRY.gauge(
                "serve_mem_reserved_bytes",
                "predicted per-chip bytes reserved by in-flight serve "
                "dispatches (high-water tracked)").set(float(now))


class _Request:
    """One queued evaluation. Signed at submit time (caller thread) so
    workers can group by plan signature without re-traversing. Minted
    with a flight-recorder request id (obs/flight.py) that every
    lifecycle event — queue, coalesce, dispatch, resolve, fetch —
    carries; ``t_taken``/``t_dispatch`` stamps feed the per-tenant
    latency decomposition."""

    __slots__ = ("expr", "donate", "tenant", "deadline", "future",
                 "plan_key", "leaves", "mesh", "coalescable",
                 "t_submit", "taken", "mem_bytes", "rid", "t_taken",
                 "t_dispatch", "via")

    def __init__(self, expr: Any, donate: List[Any],
                 tenant: Optional[str], deadline_s: Optional[float],
                 mesh) -> None:
        self.expr = expr
        self.donate = donate
        self.tenant = tenant
        self.t_submit = trace_mod.now()
        self.deadline = (self.t_submit + deadline_s
                         if deadline_s is not None else None)
        self.future = EvalFuture(tenant)
        self.future.t_submit = self.t_submit
        self.mesh = mesh
        self.taken = False  # queue bookkeeping (AdmissionQueue)
        self.mem_bytes = 0  # predicted peak (memory-aware admission)
        self.plan_key, sig_ctx = base.plan_signature(expr, mesh)
        self.leaves = sig_ctx.leaves
        # donating requests never coalesce: buffer aliasing is a
        # per-dispatch contract the batched program cannot honor
        self.coalescable = (not donate and not any(
            arr is not None and arr._donate_next
            for arr in (base._leaf_array(l) for l in self.leaves)))
        self.rid = flight_mod.mint_rid()
        self.t_taken = 0.0
        self.t_dispatch = 0.0
        self.via = "head"  # how a batch got this request (flight rec)
        self.future.rid = self.rid
        if flight_mod._FLIGHT_FLAG._value:
            flight_mod.note(self.rid, "submit", tenant=tenant,
                            plan=key_hash(self.plan_key))

    def remaining_s(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - trace_mod.now()


class ServeEngine:
    """A worker pool + admission queue + coalescer. Usable as a
    context manager; ``stop()`` drains (rejects) the backlog."""

    def __init__(self, workers: Optional[int] = None,
                 queue_max: Optional[int] = None,
                 batch_window_s: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 coalesce_requests: Optional[bool] = None):
        self.workers = int(workers if workers is not None
                           else FLAGS.serve_workers)
        self.batch_window_s = float(
            batch_window_s if batch_window_s is not None
            else FLAGS.serve_batch_window_s)
        self.max_batch = int(max_batch if max_batch is not None
                             else FLAGS.serve_max_batch)
        self.coalesce_requests = bool(
            coalesce_requests if coalesce_requests is not None
            else FLAGS.serve_coalesce)
        self.queue = AdmissionQueue(
            queue_max if queue_max is not None else FLAGS.serve_queue_max)
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        # in-flight memory reservations (predictive governor tier 3)
        self.ledger = _MemoryLedger()
        # elastic recovery gate: while the mesh rebuilds, submissions
        # fail fast with MeshReconfiguring(retry_after_s=this value)
        # instead of queueing onto a dead mesh. None = admitting.
        self._reconfiguring: Optional[float] = None

    # -- lifecycle ------------------------------------------------------

    @property
    def running(self) -> bool:
        return bool(self._threads) and not self._stop.is_set()

    def start(self) -> "ServeEngine":
        with self._lock:
            if self._threads:
                return self
            self._stop.clear()
            self.queue.reopen()
            for i in range(max(1, self.workers)):
                t = threading.Thread(
                    target=self._worker, name=f"spartan-serve-{i}",
                    daemon=True)
                t.start()
                self._threads.append(t)
        return self

    def stop(self, timeout: float = 5.0) -> None:
        with self._lock:
            threads, self._threads = self._threads, []
        self._stop.set()
        self.queue.close()  # wakes idle workers blocked on the CV
        for r in self.queue.drain():
            flight_mod.note(r.rid, "drain", reason="stop")
            r.future._reject(RuntimeError("serve engine stopped"))
        for t in threads:
            t.join(timeout)

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- warm start (persist/) ------------------------------------------

    def prewarm(self, manifest: Any = "all",
                timeout_s: Optional[float] = None) -> Dict[str, Any]:
        """Restore a configured plan set from the warm-start store at
        startup, OFF the request path: entries land in the store's
        in-memory prewarm table, so the first request for each plan
        pays neither the optimizer's tiling search nor disk IO.

        ``manifest``: a path to a JSON ``{"entries": [digest, ...]}``
        file (see ``persist.write_manifest``), the dict/list itself, or
        ``"all"``
        (every entry in the store). Per-entry timeout
        (``timeout_s`` / ``FLAGS.persist_prewarm_timeout_s``) + error
        isolation: a missing, corrupt or slow entry is counted
        (``persist_prewarm_*`` metrics) and skipped — prewarm can
        never crash or stall engine startup indefinitely. No-op with
        the store off. Returns ``{loaded, missing, errors, total}``."""
        stats = persist_mod.prewarm(manifest, timeout_s)
        if _METRICS_FLAG._value:
            REGISTRY.gauge(
                "persist_prewarmed_plans",
                "plans resident in the warm-start prewarm table"
            ).set(float(persist_mod.stats().get("preloaded", 0)))
        return stats

    # -- elastic recovery (resilience/elastic.py) -----------------------

    def drain_reconfiguring(self, retry_after_s: float) -> int:
        """Stop admitting and fail the queued backlog with a retryable
        :class:`MeshReconfiguring` — called by elastic recovery before
        the mesh rebuild so nothing else dispatches onto the dead
        mesh. Workers stay up (their in-flight failures are mapped to
        MeshReconfiguring by ``_solo``); ``resume_admission`` reopens
        the door after the rebuild. Returns requests drained.

        Re-entrant: a recovery interrupted by a mid-recovery fault
        (the chaos ``recover`` seam) re-drains on its next attempt —
        draining an already-draining engine just empties whatever
        queued since."""
        self._reconfiguring = float(retry_after_s)
        drained = self.queue.drain()
        for r in drained:
            flight_mod.note(r.rid, "drain", reason="reconfiguring")
            r.future._reject(MeshReconfiguring(
                retry_after_s, "request drained before dispatch"))
        if drained and _METRICS_FLAG._value:
            REGISTRY.counter(
                "serve_mesh_drained",
                "queued requests drained by elastic mesh "
                "recovery").inc(len(drained))
        return len(drained)

    def resume_admission(self) -> None:
        """Reopen admission after the mesh rebuild completed.
        Idempotent — the finish tail of an interrupted recovery calls
        it again; reopening an open door is a no-op."""
        if self._reconfiguring is None:
            return
        self._reconfiguring = None
        trace_mod.instant("serve_admission_reopened")
        if _METRICS_FLAG._value:
            REGISTRY.counter(
                "serve_admission_reopened",
                "admission reopenings after elastic recovery").inc()

    # -- submission -----------------------------------------------------

    def submit(self, expr: Any, donate: Sequence[Any] = (),
               tenant: Optional[str] = None,
               deadline_s: Optional[float] = None) -> EvalFuture:
        """Admit one evaluation; returns its future immediately.
        Raises :class:`Backpressure` past the queue's high-water mark."""
        expr = base.as_expr(expr)
        gate = self._reconfiguring
        if gate is not None:
            raise MeshReconfiguring(gate, "admission paused")
        if _METRICS_FLAG._value:
            REGISTRY.counter(
                "serve_requests", "requests submitted to the serve "
                "engine").inc()
            if tenant:
                REGISTRY.counter(
                    labeled("serve_requests", tenant=tenant),
                    "per-tenant submissions").inc()
        if expr._result is not None:  # already evaluated: no dispatch
            fut = EvalFuture(tenant)
            fut.t_submit = trace_mod.now()
            fut._resolve(expr._result)
            return fut
        donated = base._norm_donate(donate)
        req = _Request(expr, donated, tenant, deadline_s,
                       mesh_mod.get_mesh())
        # SLO-class admission (obs/slo.py): a class
        # with a queue share below 1.0 may only occupy that fraction
        # of the admission queue — a bulk class cannot queue the
        # latency class out. Same retryable Backpressure contract as
        # depth shedding. One memoized-parse check when no classes
        # are configured.
        cls = slo_mod.class_for(tenant)
        if cls is not None and cls.share < 1.0:
            cap = max(1, int(self.queue.maxsize * cls.share))
            if self.queue.depth() >= cap:
                if _METRICS_FLAG._value:
                    REGISTRY.counter(
                        labeled("serve_slo_rejected",
                                slo_class=cls.name),
                        "submissions shed because their SLO class's "
                        "queue share was exhausted").inc()
                flight_mod.note(req.rid, "reject",
                                reason="slo_admission",
                                slo_class=cls.name, share=cls.share)
                raise Backpressure(
                    self.queue.depth(),
                    self.queue.retry_after_s(self.workers))
        # memory-aware admission (resilience/memory.py): when a budget is
        # known, a submission whose predicted peak cannot fit next to
        # the in-flight reservations is rejected with the SAME
        # retryable Backpressure contract as queue-depth shedding —
        # the client backs off instead of the whole engine OOMing.
        budget = (memory_mod.hbm_budget_bytes()
                  if memory_mod._GOVERNOR_FLAG._value else None)
        if budget:
            req.mem_bytes = memory_mod.request_bytes(
                base.lookup_plan(req.plan_key), req.leaves, req.mesh)
            if req.mem_bytes + self.ledger.reserved() > budget:
                if _METRICS_FLAG._value:
                    REGISTRY.counter(
                        "serve_mem_rejected",
                        "submissions shed because their predicted "
                        "peak would overflow the device-memory "
                        "budget").inc()
                flight_mod.note(req.rid, "reject", reason="memory")
                raise Backpressure(
                    self.queue.depth(),
                    self.queue.retry_after_s(self.workers))
        # communication-aware admission (analysis/plan_audit.py): a plan
        # whose AUDITED wire total exceeds the budget is rejected
        # before it queues — non-retryable (the same expr meets the
        # same plan), with the worst finding in the flight record.
        # Unaudited plans pass: the budget gates verdicts, it does not
        # force an audit walk onto the submit path.
        comm_budget = _COMM_BUDGET_FLAG._value
        if comm_budget:
            plan = base.lookup_plan(req.plan_key)
            verdict = (plan.report.get("audit")
                       if plan is not None and plan.report is not None
                       else None)
            if verdict and verdict.get("comm_bytes", 0.0) > comm_budget:
                if _METRICS_FLAG._value:
                    REGISTRY.counter(
                        "serve_comm_rejected",
                        "submissions rejected because their plan's "
                        "audited communication exceeds "
                        "FLAGS.comm_budget_bytes").inc()
                worst = max(
                    verdict.get("collectives") or [{}],
                    key=lambda c: c.get("bytes_moved", 0.0))
                finding = (f"{worst.get('kind', '?')} on "
                           f"{worst.get('node') or '<unattributed>'} "
                           f"~{worst.get('bytes_moved', 0.0):.0f}B/chip")
                flight_mod.note(
                    req.rid, "reject", reason="comm_budget",
                    comm_bytes=verdict.get("comm_bytes"),
                    budget_bytes=comm_budget, finding=finding)
                raise CommBudgetExceeded(
                    float(verdict.get("comm_bytes", 0.0)), comm_budget,
                    finding)
        if not self.running:
            self.start()
        try:
            self.queue.put(req, workers=self.workers)
        except Backpressure:
            flight_mod.note(req.rid, "reject", reason="backpressure")
            raise
        flight_mod.note(req.rid, "enqueue", depth=self.queue.depth())
        return req.future

    def stats(self) -> Dict[str, Any]:
        c = REGISTRY.counter_values()
        total = c.get("serve_requests", 0)
        coal = c.get("serve_coalesced_requests", 0)
        return {
            "queue_depth": self.queue.depth(),
            "mem_reserved_bytes": self.ledger.reserved(),
            "mem_rejected": c.get("serve_mem_rejected", 0),
            "requests": total,
            "coalesced_requests": coal,
            "coalesced_batches": c.get("serve_coalesced_batches", 0),
            "rejected": c.get("serve_rejected", 0),
            "deadline_expired": c.get("serve_deadline_expired", 0),
            "solo_fallbacks": c.get("serve_solo_fallbacks", 0),
            "coalesce_hit_ratio": (coal / total) if total else 0.0,
        }

    # -- worker side ----------------------------------------------------

    def _worker(self) -> None:
        while not self._stop.is_set():
            # blocking pop: an idle worker parks on the queue's CV and
            # costs zero CPU until a put or close() wakes it
            req = self.queue.pop()
            if req is None:
                continue
            req.t_taken = trace_mod.now()
            # the service-time PREDICTION for this request: the
            # calibrated model's price for this plan when it has one
            # (FLAGS.serve_model_pricing), else the queue EMA as of
            # pop — exactly what a Backpressure retry-after would have
            # quoted; the cost ledger pairs it with the measured
            # service below either way, so the monitor's drift
            # detector judges whichever predictor actually ran
            predicted_s = self._predict_service_s(req)
            with prof.stopwatch() as sw:
                try:
                    self._service(req)
                except Exception as e:  # belt: _service resolves futures
                    req.future._reject(e)
            self.queue.note_service_time(sw.elapsed)
            if ledger_mod._LEDGER_FLAG._value:
                ledger_mod.note_service(key_hash(req.plan_key),
                                        predicted_s, sw.elapsed)
            if profile_mod._SAMPLE_FLAG._value > 0:
                # the sampled profiler ran on THIS worker thread during
                # the dispatch: stamp the request's flight record so
                # sampled requests are identifiable after the fact
                samp = profile_mod.take_last_sample()
                if samp is not None:
                    flight_mod.note(req.rid, "profiled", **samp)
                    # the skew observatory rode the same sample: its
                    # per-shard summary lands as its own event
                    sk = skew_mod.take_last_sample()
                    if sk is not None:
                        flight_mod.note(req.rid, "skew", **sk)
            if integrity_mod._CHECK_FLAG._value:
                # the SDC sentinel's verdicts for this request's
                # dispatch (including violations discarded and retried
                # by the policy engine mid-evaluate): flight-recorded
                # so a corrupt-then-retried request is auditable
                ic = integrity_mod.take_last_check()
                if ic is not None:
                    flight_mod.note(req.rid, "integrity", **ic)

    def _predict_service_s(self, r: "_Request") -> float:
        """This request's service-time prediction: the calibrated
        model's plan price when available, the queue EMA otherwise."""
        if _MODEL_PRICING_FLAG._value:
            p = ledger_mod.predict_service_s(key_hash(r.plan_key))
            if p is not None and p > 0:
                return p
        return self.queue.ema_service_s()

    def _shed_expired(self, batch: List[_Request]) -> List[_Request]:
        live: List[_Request] = []
        for r in batch:
            rem = r.remaining_s()
            if rem is not None and rem <= 0:
                if _METRICS_FLAG._value:
                    REGISTRY.counter(
                        "serve_deadline_expired",
                        "requests shed because their deadline expired "
                        "before dispatch").inc()
                flight_mod.note(r.rid, "shed", reason="deadline")
                r.future._reject(DeadlineExceeded(
                    f"deadline expired {-rem * 1e3:.1f}ms before "
                    f"dispatch (queued {trace_mod.now() - r.t_submit:.3f}s)"))
                continue
            if rem is not None and _MODEL_PRICING_FLAG._value:
                # predictive shed: the calibrated model says this
                # dispatch cannot finish inside the remaining budget —
                # shed NOW instead of burning a doomed dispatch slot
                # (the EMA-era behavior only shed already-expired
                # requests). Model-priced only: the EMA's blend over
                # unrelated plans is too blunt to pre-reject on.
                pred = ledger_mod.predict_service_s(
                    key_hash(r.plan_key))
                if pred is not None and pred > rem:
                    if _METRICS_FLAG._value:
                        REGISTRY.counter(
                            "serve_predicted_shed",
                            "requests shed because the calibrated "
                            "model priced their dispatch past the "
                            "remaining deadline").inc()
                    flight_mod.note(r.rid, "shed", reason="predicted",
                                    predicted_s=round(pred, 6),
                                    remaining_s=round(rem, 6))
                    r.future._reject(DeadlineExceeded(
                        f"predicted service {pred * 1e3:.1f}ms exceeds "
                        f"remaining deadline {rem * 1e3:.1f}ms"))
                    continue
            live.append(r)
        return live

    def _take(self, req: _Request, limit: int,
              via: str) -> List[_Request]:
        """Pull same-signature companions for ``req``'s batch, stamping
        each with its taken time and HOW it joined ('queued' = already
        waiting at pop time, 'window' = arrived during the linger) —
        the flight recorder's coalescing provenance."""
        more = self.queue.take_matching(req.plan_key, limit)
        if more:
            now = trace_mod.now()
            for r in more:
                r.t_taken = now
                r.via = via
        return more

    def _service(self, req: _Request) -> None:
        batch = [req]
        if self.coalesce_requests and req.coalescable:
            batch += self._take(req, self.max_batch - len(batch),
                                "queued")
            if len(batch) < self.max_batch and self.batch_window_s > 0:
                # linger once for stragglers inside the batching window
                self.queue.wait_for_more(self.batch_window_s)
                batch += self._take(req, self.max_batch - len(batch),
                                    "window")
        batch = self._shed_expired(batch)
        if not batch:
            return

        if len(batch) == 1 or not self.coalesce_requests:
            for r in batch:
                self._solo(r)
            return

        plan = base.lookup_plan(req.plan_key)
        if plan is None:
            # plan-cache miss: build it by evaluating the head request
            # solo (optimize once), then coalesce the rest
            self._solo(batch[0])
            batch = self._shed_expired(batch[1:])
            plan = base.lookup_plan(req.plan_key)
        if not batch:
            return
        if (plan is None or plan.arg_order is None
                or coalesce.mode_for(plan) == "off" or len(batch) == 1):
            # uncacheable plan / demoted plan / single survivor
            for r in batch:
                self._solo(r)
            return
        # quantize to power-of-two chunks (13 -> 8+4+1): the batch size
        # is part of the variant key, so free-running sizes would build
        # a variant per observed size — quantized, a plan gains
        # at most log2(serve_max_batch) batched variants ever
        for chunk in _pow2_chunks(batch):
            if len(chunk) == 1:
                self._solo(chunk[0])
                continue
            try:
                self._coalesced(plan, chunk)
            except Exception as e:
                mode = coalesce.classify_batch_failure(e, plan)
                if _METRICS_FLAG._value:
                    REGISTRY.counter(
                        "serve_solo_fallbacks",
                        "batches that fell back to solo dispatches "
                        "after a batched failure").inc()
                log_warn("serve: coalesced dispatch failed (%s: %s); "
                         "falling back to %d solo dispatch(es), "
                         "mode=%s", type(e).__name__, str(e)[:120],
                         len(chunk), mode)
                if flight_mod._FLIGHT_FLAG._value:
                    for r in chunk:
                        flight_mod.note(r.rid, "fallback",
                                        reason=type(e).__name__,
                                        mode=mode)
                for r in chunk:
                    self._solo(r)

    def _coalesced(self, plan: Any, batch: List[_Request]) -> None:
        deadlines = [r.remaining_s() for r in batch]
        tightest = min((d for d in deadlines if d is not None),
                       default=None)
        # one dispatch span id for the whole batch: every member's
        # flight record names WHICH dispatch resolved it and why it
        # was in this batch (its 'via' stamp from _take / head pop)
        span = flight_mod.mint_span()
        t0 = trace_mod.now()
        record = flight_mod._FLIGHT_FLAG._value
        for r in batch:
            r.t_dispatch = t0
            if record:
                flight_mod.note(r.rid, "coalesce", span=span,
                                batch=len(batch), via=r.via)
        # one reservation for the whole batch: each request brings its
        # own predicted peak (the leading client axis scales working
        # sets ~linearly; the batched walk is not re-modeled)
        reserved = sum(r.mem_bytes for r in batch)
        self.ledger.reserve(reserved)
        try:
            with mesh_mod.use_mesh(batch[0].mesh), \
                    numerics_mod.deadline_scope(tightest):
                results = coalesce.dispatch_batch(plan, batch,
                                                  batch[0].mesh)
        finally:
            self.ledger.release(reserved)
        for r, res in zip(batch, results):
            r.future.coalesced = len(batch)
            r.future._resolve(res)
            self._flight_resolve(r, span, len(batch), "ok")

    def _flight_resolve(self, r: _Request, span: int, batch: int,
                        status: str) -> None:
        """One resolution record: the request's latency decomposition
        (queue-wait / coalesce-wait / dispatch) lands in its flight
        record and the per-tenant histograms; the end-to-end latency
        feeds the tenant's SLO class (obs/slo.py) regardless of the
        flight-recorder flag."""
        if r.future.t_resolved is not None:
            slo_mod.observe(r.tenant,
                            r.future.t_resolved - r.t_submit)
        if not flight_mod._FLIGHT_FLAG._value:
            return
        flight_mod.record_resolution(
            rid=r.rid, tenant=r.tenant, span=span, batch=batch,
            status=status, t_submit=r.t_submit,
            t_taken=r.t_taken or r.t_submit,
            t_dispatch=r.t_dispatch or r.t_taken or r.t_submit,
            t_resolved=r.future.t_resolved)

    def _solo(self, r: _Request) -> None:
        span = flight_mod.mint_span()
        r.t_dispatch = trace_mod.now()
        if flight_mod._FLIGHT_FLAG._value:
            flight_mod.note(r.rid, "dispatch", span=span, batch=1,
                            via=r.via)
        self.ledger.reserve(r.mem_bytes)
        try:
            self._solo_inner(r)
        finally:
            self.ledger.release(r.mem_bytes)
        # warm-start provenance: if this dispatch built its plan, name
        # whether its decisions came from the persist store (disk) or
        # a fresh optimizer run — the flight-record half of the
        # st.explain persist line. None on plan-cache hits and with
        # the store off; popped unconditionally so a stale outcome
        # can never stamp a later request.
        src = persist_mod.take_build_source()
        if src is not None and flight_mod._FLIGHT_FLAG._value:
            flight_mod.note(r.rid, "persist",
                            **{k: v for k, v in src.items()
                               if v is not None})
        self._flight_resolve(
            r, span, 1, "ok" if r.future._exc is None else "error")

    def _solo_inner(self, r: _Request) -> None:
        with mesh_mod.use_mesh(r.mesh), \
                resilience_engine.tenant_scope(r.tenant), \
                numerics_mod.deadline_scope(r.remaining_s()):
            try:
                result = base.evaluate(r.expr, donate=r.donate)
            except Exception as e:
                # the resilience engine already ran (classified,
                # retried under the tenant's budget); hand the terminal
                # failure to the caller through its future. A fatal
                # mesh failure is the one remap: elastic recovery has
                # already rebuilt the mesh by the time the engine
                # re-raised, so the caller gets the retryable
                # MeshReconfiguring-with-retry-after contract instead
                # of the raw device-death status.
                if (resilience_classify.classify(e)
                        == resilience_classify.FATAL_MESH):
                    mr = MeshReconfiguring(
                        FLAGS.elastic_retry_after_s,
                        "dispatch hit device loss; mesh rebuilt")
                    mr.__cause__ = e
                    r.future._reject(mr)
                    return
                if _sdc_in_chain(e):
                    # the integrity sentinel discarded this request's
                    # result (and may have quarantined the suspect,
                    # surfacing stale_mesh on the engine's retry): the
                    # client NEVER sees the corrupt value — retry once
                    # on the CURRENT (post-quarantine) mesh, rehoming
                    # stale leaves through the planner-priced elastic
                    # path, flight-recorded either way.
                    self._sdc_retry(r, e)
                    return
                r.future._reject(e)
                return
        r.future.coalesced = 1
        r.future._resolve(result)

    def _sdc_retry(self, r: _Request, exc: Exception) -> None:
        from ..resilience import elastic as elastic_mod

        if flight_mod._FLIGHT_FLAG._value:
            flight_mod.note(
                r.rid, "sdc_retry",
                quarantined=getattr(exc, "quarantined", None))
        try:
            with mesh_mod.use_mesh(mesh_mod.get_mesh()), \
                    resilience_engine.tenant_scope(r.tenant), \
                    numerics_mod.deadline_scope(r.remaining_s()):
                for _ in range(3):  # rehome passes, like st.loop's
                    try:
                        result = base.evaluate(r.expr, donate=r.donate)
                        break
                    except mesh_mod.StaleMeshError as se:
                        elastic_mod.rehome(getattr(se, "arrays", ()))
                else:
                    result = base.evaluate(r.expr, donate=r.donate)
        except Exception as e2:
            r.future._reject(e2)
            return
        r.future.coalesced = 1
        r.future._resolve(result)


# -- the default engine (st.evaluate_async) ------------------------------

_default_lock = threading.Lock()
_default: Optional[ServeEngine] = None


def default_engine() -> ServeEngine:
    """The process's shared engine, started lazily on first use."""
    global _default
    with _default_lock:
        if _default is None:
            _default = ServeEngine()
        return _default.start()


def peek_default() -> Optional[ServeEngine]:
    """The default engine if one exists — WITHOUT starting it (elastic
    recovery drains the engine only if there is one to drain)."""
    with _default_lock:
        return _default


def shutdown_default() -> None:
    """Stop (and forget) the default engine; the next
    ``evaluate_async`` starts a fresh one."""
    global _default
    with _default_lock:
        eng, _default = _default, None
    if eng is not None:
        eng.stop()


def evaluate_async(expr: Any, donate: Sequence[Any] = (),
                   tenant: Optional[str] = None,
                   deadline_s: Optional[float] = None) -> EvalFuture:
    """Submit ``expr`` to the default serve engine: returns an
    :class:`EvalFuture` immediately. Identical-signature requests from
    concurrent callers coalesce into one batched walk; the resilience
    engine's retries and the dispatch watchdog apply per request."""
    return default_engine().submit(expr, donate=donate, tenant=tenant,
                                   deadline_s=deadline_s)
