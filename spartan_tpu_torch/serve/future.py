"""Request futures and the serving error vocabulary (port of
``spartan_tpu/serve/future.py``).

An :class:`EvalFuture` is the handle ``evaluate_async`` returns: the
submitting thread gets it at once, and a serve worker resolves it after
the (possibly coalesced) walk. On the card a walk only launches its
kernels onto the device's stream, so the resolved ``DistArray`` may
still be in flight there: ``glom()`` (the copy to the host) is where the
caller waits for the device, as XLA's asynchronous dispatch makes the
JAX package's ``glom()`` the wait. The flight recorder's ``fetch``
seconds therefore hold the device time. Donated inputs are released at
the same resolution point (``evaluate()``'s epilogue).

Thread-safety: one ``threading.Event`` per future; ``_resolve`` /
``_reject`` are called once by the owning worker (a second resolution is
ignored, the first writer wins), and callbacks run on the resolving
thread.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional


class ServeError(RuntimeError):
    """Base class for serving-layer failures."""


class Backpressure(ServeError):
    """Admission control rejected the request: the submission queue is
    past its high-water mark. ``retry_after_s`` is the engine's
    estimate of when capacity frees up (queue depth x recent service
    time per worker) — the reject-with-retry-after contract clients
    are expected to honor instead of hammering the queue."""

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(
            f"serve queue full ({depth} request(s) queued); "
            f"retry after ~{retry_after_s:.3f}s")
        self.depth = depth
        self.retry_after_s = retry_after_s


class DeadlineExceeded(ServeError):
    """The request's deadline expired before its dispatch started (it
    was shed from the queue) or before its result resolved."""


class CommBudgetExceeded(ServeError):
    """Admission control rejected the request because its plan's
    audited communication total (analysis/plan_audit.py, cached on the
    plan report) exceeds ``FLAGS.comm_budget_bytes``. NOT retryable —
    resubmitting the same expression meets the same plan; restructure
    the computation (or raise the budget). The finding lands in the
    flight record (``st.flightrec``) with the modeled bytes."""

    def __init__(self, comm_bytes: float, budget_bytes: int,
                 detail: str = ""):
        super().__init__(
            f"plan's modeled communication ~{comm_bytes:.0f} bytes/chip "
            f"exceeds FLAGS.comm_budget_bytes={budget_bytes}"
            + (f" ({detail})" if detail else ""))
        self.comm_bytes = comm_bytes
        self.budget_bytes = budget_bytes


class MeshReconfiguring(ServeError):
    """The mesh is being rebuilt after persistent device/host loss
    (elastic recovery): this request was drained, or arrived during
    the drain, and was NOT dispatched. Retryable — resubmit after
    ``retry_after_s``; the rebuild is host-side work, so the engine is
    admitting again almost immediately, with plans re-built for the
    surviving devices. Inputs that lived on the dead mesh must be
    re-created (or ``.rehome()``d) before resubmitting — a stale
    resubmission fails with ``StaleMeshError`` naming them."""

    def __init__(self, retry_after_s: float, detail: str = ""):
        super().__init__(
            "mesh reconfiguring after device loss; retry after "
            f"~{retry_after_s:.3f}s" + (f" ({detail})" if detail else ""))
        self.retry_after_s = retry_after_s


class EvalFuture:
    """Resolution handle for one submitted evaluation.

    ``result(timeout)`` blocks until the worker resolves the future and
    returns the ``DistArray`` (or tuple, for ``TupleExpr`` roots) — or
    raises the failure the evaluation produced (after the resilience
    engine's retries ran their course). ``glom(timeout)`` also copies
    the result to the host, which is where the caller waits for the
    kernels the walk launched."""

    __slots__ = ("_event", "_result", "_exc", "_callbacks", "_lock",
                 "tenant", "coalesced", "t_submit", "t_resolved", "rid")

    def __init__(self, tenant: Optional[str] = None):
        self._event = threading.Event()
        self._result: Any = None
        self._exc: Optional[BaseException] = None
        self._callbacks: List[Callable[["EvalFuture"], None]] = []
        self._lock = threading.Lock()
        self.tenant = tenant
        # set by the worker: how many requests shared this dispatch
        # (1 = solo); observability for tests and clients
        self.coalesced = 0
        # engine-stamped tracer-clock timestamps (obs.trace.now):
        # t_resolved - t_submit is the request's serving latency
        self.t_submit: float = 0.0
        self.t_resolved: float = 0.0
        # flight-recorder request id (obs/flight.py), minted at submit
        # and shared with every event of this request's lifecycle;
        # 0 = not a recorded request (bare futures)
        self.rid: int = 0

    # -- caller side ----------------------------------------------------

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"EvalFuture.result timed out after {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"EvalFuture.exception timed out after {timeout}s")
        return self._exc

    def glom(self, timeout: Optional[float] = None) -> Any:
        """Resolve AND fetch: the one call that waits for the device
        (``result()`` returns a handle whose kernels may still run).
        The fetch's wall time is the last hop of this request's flight
        record (per-tenant ``serve_fetch_s`` histogram)."""
        out = self.result(timeout)
        from ..obs import flight as flight_mod
        from ..obs import trace as trace_mod

        t0 = trace_mod.now()
        if isinstance(out, tuple):
            fetched: Any = tuple(o.glom() for o in out)
        else:
            fetched = out.glom()
        flight_mod.note_fetch(self.rid, self.tenant,
                              trace_mod.now() - t0)
        return fetched

    def add_done_callback(self, fn: Callable[["EvalFuture"], None]
                          ) -> None:
        """Run ``fn(self)`` when the future resolves (immediately if it
        already has). Runs on the resolving worker thread; exceptions
        from callbacks are swallowed (a client callback must not kill
        a worker)."""
        run_now = False
        with self._lock:
            if self._event.is_set():
                run_now = True
            else:
                self._callbacks.append(fn)
        if run_now:
            try:
                fn(self)
            except Exception:
                pass

    # -- worker side ----------------------------------------------------

    def _fire_callbacks(self) -> None:
        with self._lock:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            try:
                fn(self)
            except Exception:
                pass  # client callbacks must not kill the worker

    def _stamp(self) -> None:
        from ..obs import trace as trace_mod

        self.t_resolved = trace_mod.now()

    def _resolve(self, result: Any) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._result = result
            self._stamp()
            self._event.set()
        self._fire_callbacks()

    def _reject(self, exc: BaseException) -> None:
        with self._lock:
            if self._event.is_set():
                return
            self._exc = exc
            self._stamp()
            self._event.set()
        self._fire_callbacks()
