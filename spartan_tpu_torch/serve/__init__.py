"""Concurrent serving front end: async evaluate, admission control,
request coalescing (port of ``spartan_tpu/serve``).

``evaluate()`` is a synchronous single-caller path. This package puts a
serving engine in front of the plan machinery — no new execution
semantics, just concurrency:

* **async evaluation** — ``st.evaluate_async(expr)`` /
  ``expr.evaluate_async()`` return an :class:`EvalFuture` at once; a
  worker walks the plan and the future resolves with the ``DistArray``,
  whose kernels may still run on the card. Fetch (``.glom()``) is where
  the caller waits for them.
* **admission control** — a bounded queue; past the high-water mark
  submissions are rejected with :class:`Backpressure` carrying a
  ``retry_after_s`` estimate. SLO classes (``obs/slo``) cap a class's
  share of the queue, the memory governor's budget and the plan audit's
  communication total gate admission, and deadlines shed expired
  requests and propagate into the dispatch watchdog.
* **signature-level coalescing** — requests whose raw-DAG signature
  matches (the plan-cache key) within the batching window share one
  cached plan and run as one batched walk along a new leading client
  axis (``torch.func.vmap`` over the walk, or the walk replayed per
  client): one walk, N responses (``serve/coalesce.py``). ``st.explain``
  names the coalesced batch.
* **tenancy** — per-tenant request counters in the Prometheus export,
  per-tenant latency decompositions in the flight recorder
  (``st.flightrec``) and per-tenant retry budgets in the resilience
  engine.
* **elastic drain** — during a mesh rebuild after device loss
  (``resilience/elastic``), admission pauses and queued requests fail
  with the retryable :class:`MeshReconfiguring` carrying a retry-after;
  clients resubmit onto the rebuilt mesh.

Locking discipline:

* ``expr/base._cache_lock`` guards the plan and variant caches; held for
  dict operations only, reached only through ``lookup_plan`` /
  ``store_plan`` / ``cached_executable``.
* ``expr/base.launch_guard`` serializes walks on the CPU and on a group
  mesh (``FLAGS.dispatch_serialize``). On a group mesh every rank must
  also walk the same requests in the same order, or their collectives
  pair across requests: serve there with one worker
  (``ServeEngine(workers=1)``) and the same submissions on every rank.
* the metrics registry, trace ring, chaos plan, retry budgets, the
  kernels' launch counters and the coalescer's mode table each take
  their own leaf lock; no module calls out of itself while holding one,
  so the lock graph is acyclic.
* per-request state (tenant, deadline) rides thread-locals
  (``resilience.engine.tenant_scope``, ``obs.numerics.deadline_scope``)
  set by the worker around each dispatch.
* futures are resolved exactly once by their owning worker; callers
  only wait on an Event.
"""

from .coalesce import reset_modes
from .engine import (ServeEngine, default_engine, evaluate_async,
                     peek_default, shutdown_default)
from .future import (Backpressure, CommBudgetExceeded, DeadlineExceeded,
                     EvalFuture, MeshReconfiguring, ServeError)
from .queue import AdmissionQueue

__all__ = [
    "ServeEngine", "AdmissionQueue", "EvalFuture", "ServeError",
    "Backpressure", "CommBudgetExceeded", "DeadlineExceeded",
    "MeshReconfiguring", "evaluate_async", "default_engine",
    "peek_default", "shutdown_default", "reset_modes",
]
