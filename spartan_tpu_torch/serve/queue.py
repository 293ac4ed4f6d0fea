"""Bounded submission queue with admission control (port of
``spartan_tpu/serve/queue.py``).

The front door of the serve engine: callers ``put()`` requests (fast,
one lock), workers ``pop()`` them and pull same-signature companions
with ``take_matching`` for coalescing. Past the high-water mark
(``FLAGS.serve_queue_max``) admission REJECTS with
:class:`~spartan_tpu_torch.serve.future.Backpressure` carrying a
retry-after estimate — shedding at the door instead of letting latency
grow unboundedly inside (the queue never blocks a submitter).

Structure: one FIFO deque (arrival order) plus a per-plan-signature
bucket index for the coalescer — ``take_matching`` pops from its
bucket in O(taken) instead of scanning the whole backlog. A request
taken from a bucket stays in the FIFO with its ``taken`` flag set and
is skipped lazily; both views converge under one condition variable.

Idle workers BLOCK on the condition variable (no poll timeout): an
idle engine costs no steady-state CPU, and ``close()`` wakes every
waiter for shutdown.

Locking: the one condition variable guards the deque, the buckets and
the depth count; ``put``/``pop``/``take_matching`` never call out of
the module while holding it.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from ..obs.metrics import METRICS_FLAG as _METRICS_FLAG
from ..obs.metrics import REGISTRY
from .future import Backpressure


class AdmissionQueue:
    """FIFO of :class:`~spartan_tpu_torch.serve.engine._Request` objects with
    a hard depth bound and per-signature buckets for the coalescer."""

    def __init__(self, maxsize: int):
        self.maxsize = max(1, int(maxsize))
        self._cv = threading.Condition(threading.Lock())
        self._items: Deque[Any] = deque()
        self._by_key: Dict[Any, Deque[Any]] = {}
        self._depth = 0  # live (not-taken) requests
        self._closed = False
        # recent per-request service seconds (EMA, worker-updated) —
        # the basis of the Backpressure retry-after estimate
        self._ema_service_s = 0.001

    def depth(self) -> int:
        return self._depth

    def note_service_time(self, seconds: float) -> None:
        """EMA update from a worker after each completed request."""
        with self._cv:
            self._ema_service_s += 0.2 * (seconds - self._ema_service_s)

    def ema_service_s(self) -> float:
        """The queue's service-time PREDICTION: the current EMA of
        per-request service seconds. Read by the Backpressure
        retry-after estimate and — before each service — by the cost
        ledger, so the prediction the client's backoff was based on is
        recorded next to the measured service time (unlocked read: a
        stale EMA is still the value the estimate used)."""
        return self._ema_service_s

    def retry_after_s(self, workers: int) -> float:
        """Expected time until the current backlog drains one slot."""
        return max(0.001,
                   self._depth * self._ema_service_s / max(1, workers))

    def put(self, req: Any, workers: int = 1) -> None:
        """Admit or reject (never blocks the submitter)."""
        with self._cv:
            if self._closed:
                raise RuntimeError("serve engine stopped")
            if self._depth >= self.maxsize:
                if _METRICS_FLAG._value:
                    REGISTRY.counter(
                        "serve_rejected",
                        "requests shed by admission control "
                        "(Backpressure)").inc()
                raise Backpressure(self._depth,
                                   self.retry_after_s(workers))
            self._items.append(req)
            if req.coalescable:
                bucket = self._by_key.get(req.plan_key)
                if bucket is None:
                    bucket = self._by_key[req.plan_key] = deque()
                bucket.append(req)
            self._depth += 1
            if _METRICS_FLAG._value:
                REGISTRY.gauge(
                    "serve_queue_depth",
                    "submission queue depth (high-water tracked)"
                ).set(float(self._depth))
            self._cv.notify()

    def pop(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Blocking head pop (arrival order, bucket-taken requests
        skipped). ``timeout=None`` blocks until an item arrives or the
        queue is closed — an idle worker costs nothing; returns None
        on close or timeout."""
        with self._cv:
            while True:
                while self._items and self._items[0].taken:
                    self._items.popleft()  # lazily drop bucket-taken
                if self._items:
                    req = self._items.popleft()
                    req.taken = True
                    self._depth -= 1
                    self._unbucket(req)
                    return req
                if self._closed:
                    return None
                if not self._cv.wait(timeout):
                    return None

    def _unbucket(self, req: Any) -> None:
        """Drop a head-popped request's bucket entry (cheap when it is
        the bucket head, which FIFO order makes the common case)."""
        bucket = self._by_key.get(req.plan_key)
        if not bucket:
            return
        while bucket and bucket[0].taken and bucket[0] is not req:
            bucket.popleft()
        if bucket and bucket[0] is req:
            bucket.popleft()
        if not bucket:
            del self._by_key[req.plan_key]

    def take_matching(self, plan_key: Any, limit: int) -> List[Any]:
        """Remove up to ``limit`` queued coalescable requests with the
        given plan signature (O(taken), via the bucket index); the
        FIFO keeps their husks and skips them lazily."""
        if limit <= 0:
            return []
        out: List[Any] = []
        with self._cv:
            bucket = self._by_key.get(plan_key)
            while bucket and len(out) < limit:
                r = bucket.popleft()
                if not r.taken:
                    r.taken = True
                    self._depth -= 1
                    out.append(r)
            if bucket is not None and not bucket:
                self._by_key.pop(plan_key, None)
        return out

    def wait_for_more(self, window_s: float) -> None:
        """The coalescing linger: block up to ``window_s`` for another
        submission to arrive (woken by ``put``'s notify)."""
        with self._cv:
            self._cv.wait(window_s)

    def drain(self) -> List[Any]:
        """Remove everything live (engine shutdown: reject the
        backlog)."""
        with self._cv:
            out = [r for r in self._items if not r.taken]
            for r in out:
                r.taken = True
            self._items.clear()
            self._by_key.clear()
            self._depth = 0
            return out

    def close(self) -> None:
        """Reject future puts and wake every blocked worker."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def reopen(self) -> None:
        """Accept puts again (engine restart after stop())."""
        with self._cv:
            self._closed = False
