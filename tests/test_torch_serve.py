"""The port's serving front end (``spartan_tpu_torch/serve``), on the CPU.

Each case of ``tests/test_serve.py`` has its counterpart here, run on
the port under a logical (8, 1) mesh (the JAX file's ``mesh1d``). Where
the two packages can be compared, the same seeded numpy requests go
through both ``ServeEngine``s:

* served values: within rtol 1e-5 of the JAX package's (float32 sums of
  up to 256 terms, summed in another order), and each package's served
  values bit-equal to its own serial ``evaluate()``;
* ``_pow2_chunks`` sizes: equal;
* each request's sequence of flight-event kinds: equal;
* a coalesced k-means step (the fused kernel's plain version under the
  operator's batching rule) against the JAX package's ``kmeans_step``
  (its map2 form) on well-separated data (ROADMAP C22): same
  assignments, centers within rtol 1e-5 (sums of 256 points of up to
  ~20 in another order).

Port-only cases: the plan stays in ``vmap`` mode for the k-means step
and for ``(x + y).sum() * s`` (whose shared ``(x + y).sum()`` runs once
per batch); the demotion ladder reaches ``unroll`` on a plan whose walk
cannot be vmapped; the messages of unvmappable lowerings classify
deterministic; audited batches and the integrity sentinel; the elastic
drain of queued requests and their resubmission after the rebuild; the
kernels' launch counters under threads.

Every wait has its own timeout (``glom(timeout=60)``), and no test
sleeps longer than 1 s.
"""

import threading

import numpy as np
import pytest
import torch

import spartan_tpu as st_j
from spartan_tpu.examples import kmeans as km_j
from spartan_tpu.serve import coalesce as coalesce_j
from spartan_tpu.serve import engine as engine_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J

import spartan_tpu_torch as st_t
from spartan_tpu_torch.examples import kmeans as km_t
from spartan_tpu_torch.expr import base
from spartan_tpu_torch.kernels import build as build_mod
from spartan_tpu_torch.kernels import kmeans as kk
from spartan_tpu_torch.obs import flight
from spartan_tpu_torch.obs import numerics as numerics_t
from spartan_tpu_torch.obs.metrics import REGISTRY
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.resilience import classify as cls_t
from spartan_tpu_torch.resilience import engine as res_engine
from spartan_tpu_torch.resilience import integrity as integrity_t
from spartan_tpu_torch.serve import coalesce
from spartan_tpu_torch.serve.engine import _pow2_chunks
from spartan_tpu_torch.serve.queue import AdmissionQueue
from spartan_tpu_torch.utils.config import FLAGS

torch.set_num_threads(1)

WAIT_S = 60
RTOL = 1e-5

_SAVED = ("retry_backoff_s", "retry_max", "retry_budget",
          "serve_tenant_retry_quota", "plan_cache_max",
          "serve_coalesce_mode", "resilience", "audit_numerics",
          "integrity_check", "profile_sample_every", "flightrec")


@pytest.fixture(autouse=True)
def _setup(mesh1d):
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    saved = {n: getattr(FLAGS, n) for n in _SAVED}
    saved_j = {n: getattr(FLAGS_J, n) for n in ("serve_coalesce_mode",)}
    FLAGS.retry_backoff_s = 0.0
    res_engine.reset()
    coalesce.reset_modes()
    coalesce_j.reset_modes()
    st_t.chaos_clear()
    st_t.serve.shutdown_default()
    st_j.serve.shutdown_default()
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        yield
    st_t.serve.shutdown_default()
    st_j.serve.shutdown_default()
    st_t.chaos_clear()
    coalesce.reset_modes()
    coalesce_j.reset_modes()
    res_engine.reset()
    integrity_t.reset()
    mesh_t.reset_epoch_for_tests()
    for n, v in saved.items():
        setattr(FLAGS, n, v)
    for n, v in saved_j.items():
        setattr(FLAGS_J, n, v)
    mesh_t.set_default_device(prev)


def _np_pair(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, n).astype(np.float32),
            rng.rand(n, n).astype(np.float32))


def _shared(n=16, seed=0):
    x, y = _np_pair(n, seed)
    return (st_t.as_expr(st_t.as_expr(x).evaluate()),
            st_t.as_expr(st_t.as_expr(y).evaluate()))


def _shared_j(n=16, seed=0):
    x, y = _np_pair(n, seed)
    return (st_j.as_expr(st_j.as_expr(x).evaluate()),
            st_j.as_expr(st_j.as_expr(y).evaluate()))


def _park(engine):
    """Hold ``engine``'s workers off: submit() starts workers unless the
    engine looks running, so give it one finished thread; submissions
    then stay queued until ``engine.stop()`` or a real ``start()``."""
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    engine._threads.append(t)


def _unpark(engine):
    engine._threads.clear()
    engine.start()


def _plan_of(expr):
    return base.lookup_plan(base.plan_signature(expr)[0])


def _counter(name):
    return st_t.metrics()["counters"].get(name, 0)


# -- futures + async basics ---------------------------------------------


def test_evaluate_async_solo_matches_evaluate():
    xe, ye = _shared()
    want = np.asarray(((xe + ye) * 2.0).sum().glom())
    fut = ((xe + ye) * 2.0).sum().evaluate_async()
    got = np.asarray(fut.glom(timeout=WAIT_S))
    np.testing.assert_array_equal(want, got)
    assert fut.done() and fut.exception(0) is None
    assert fut.coalesced >= 1
    assert fut.t_resolved >= fut.t_submit > 0


def test_future_timeout_and_callbacks():
    fut = st_t.EvalFuture()
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.01)
    seen = []
    fut.add_done_callback(lambda f: seen.append(f))
    fut._resolve("x")
    assert seen == [fut]
    fut.add_done_callback(lambda f: seen.append("late"))
    assert seen == [fut, "late"]  # post-resolution callback runs now
    fut._resolve("y")  # double resolution ignored, first writer wins
    assert fut.result(0) == "x"


def test_already_evaluated_expr_resolves_immediately():
    xe, _ = _shared()
    e = (xe * 3.0).sum()
    e.evaluate()
    fut = e.evaluate_async()
    assert fut.done()


# -- coalescing ----------------------------------------------------------


def test_identical_signatures_coalesce_one_dispatch():
    xe, ye = _shared()

    def build(i):
        return (xe + ye).sum() * float(i)

    float(build(0).glom())  # plan in cache
    compiles_before = _counter("compiles")
    eng = st_t.ServeEngine(workers=1, batch_window_s=0.05, max_batch=8)
    _park(eng)
    futs = [eng.submit(build(i + 1)) for i in range(8)]
    _unpark(eng)
    with eng:
        vals = [float(f.glom(timeout=WAIT_S)) for f in futs]
    # one batched walk built for the whole batch
    assert _counter("compiles") == compiles_before + 1
    base_val = float(np.asarray((xe + ye).sum().glom()))
    np.testing.assert_allclose(vals, [base_val * (i + 1)
                                      for i in range(8)], rtol=RTOL)
    assert all(f.coalesced == 8 for f in futs)
    assert coalesce.mode_for(_plan_of(build(9))) == "vmap"


def test_coalesced_bit_equal_to_serial():
    xe, ye = _shared(seed=3)

    def build(i):
        return ((xe + ye) * float(i)).sum()

    serial = [np.asarray(build(i).evaluate().glom()) for i in range(6)]
    with st_t.ServeEngine(workers=1, batch_window_s=0.05,
                          max_batch=8) as eng:
        futs = [eng.submit(build(i)) for i in range(6)]
        served = [np.asarray(f.glom(timeout=WAIT_S)) for f in futs]
    for a, b in zip(serial, served):
        np.testing.assert_array_equal(a, b)


def test_distinct_signatures_do_not_coalesce():
    xe, ye = _shared()
    with st_t.ServeEngine(workers=1, batch_window_s=0.02,
                          max_batch=8) as eng:
        f1 = eng.submit((xe + ye).sum())
        f2 = eng.submit((xe * ye).sum())  # different op: different plan
        v1 = float(f1.glom(timeout=WAIT_S))
        v2 = float(f2.glom(timeout=WAIT_S))
    assert v1 != v2
    assert f1.coalesced == 1 and f2.coalesced == 1


def test_donating_requests_never_coalesce():
    xe, ye = _shared()
    scratch = (xe + ye).evaluate()

    with st_t.ServeEngine(workers=1, batch_window_s=0.05,
                          max_batch=8) as eng:
        futs = [eng.submit((xe + ye).sum() * float(i))
                for i in range(3)]
        fd = eng.submit((st_t.as_expr(scratch) * 2.0).sum(),
                        donate=[scratch])
        fd.result(timeout=WAIT_S)
        for f in futs:
            f.result(timeout=WAIT_S)
    assert fd.coalesced == 1  # solo: donation is a per-walk contract
    assert scratch.is_donated  # donation epilogue ran
    # the shared leaves were never freed or donated by the batch
    assert not xe.value.is_donated and not ye.value.is_donated
    np.testing.assert_array_equal(np.asarray(xe.glom()), _np_pair()[0])


def test_batch_sizes_quantize_to_powers_of_two():
    sizes = [len(c) for c in _pow2_chunks(list(range(13)))]
    assert sizes == [8, 4, 1]
    assert [len(c) for c in _pow2_chunks(list(range(8)))] == [8]
    # the same chunking as the JAX package's for every batch to 64
    for n in range(1, 65):
        assert ([len(c) for c in _pow2_chunks(list(range(n)))]
                == [len(c) for c in engine_j._pow2_chunks(list(range(n)))])


def test_unroll_mode_and_demotion_ladder():
    xe, ye = _shared()
    FLAGS.serve_coalesce_mode = "unroll"
    serial = [np.asarray(((xe + ye).sum() * float(i + 1)).evaluate().glom())
              for i in range(4)]
    with st_t.ServeEngine(workers=1, batch_window_s=0.05,
                          max_batch=4) as eng:
        futs = [eng.submit((xe + ye).sum() * float(i + 1))
                for i in range(4)]
        vals = [np.asarray(f.glom(timeout=WAIT_S)) for f in futs]
    for a, b in zip(serial, vals):
        np.testing.assert_array_equal(a, b)  # unroll is bit-equal to solo
    # demotion: unroll -> off (vmap was overridden to unroll)
    plan = _plan_of((xe + ye).sum() * 9.0)
    assert plan is not None
    assert coalesce.mode_for(plan) == "unroll"
    assert coalesce.demote(plan) == "off"
    assert coalesce.mode_for(plan) == "off"


def test_request_id_propagation_through_coalesce():
    """A coalesced batch of N submissions yields N flight records sharing
    ONE dispatch span id, bit-equal results, and a per-request latency
    decomposition that adds up."""
    xe, ye = _shared(seed=9)

    def build(i):
        return (xe + ye).sum() * float(i + 1)

    serial = [np.asarray(build(i).evaluate().glom()) for i in range(8)]
    flight.clear()
    eng = st_t.ServeEngine(workers=1, batch_window_s=0.05, max_batch=8)
    _park(eng)
    futs = [eng.submit(build(i), tenant="rid-t") for i in range(8)]
    _unpark(eng)
    with eng:
        served = [np.asarray(f.glom(timeout=WAIT_S)) for f in futs]
    for a, b in zip(serial, served):
        np.testing.assert_array_equal(a, b)  # bit-equal to serial

    rec = st_t.flightrec()
    rids = [f.rid for f in futs]
    assert len(set(rids)) == 8 and all(r > 0 for r in rids)
    reqs = [rec["requests"][r] for r in rids]
    spans = {q["dispatch_span"] for q in reqs}
    assert len(spans) == 1 and None not in spans
    assert all(q["batch"] == 8 for q in reqs)
    assert all(q["status"] == "ok" for q in reqs)
    vias = [q["via"] for q in reqs]
    assert vias.count("head") == 1
    assert set(vias) <= {"head", "queued", "window"}
    for q in reqs:
        ev = q["events"]
        assert ev.index("submit") < ev.index("enqueue") \
            < ev.index("coalesce") < ev.index("resolve") \
            < ev.index("fetch")
    for f, q in zip(futs, reqs):
        qw, cw, dw = (q["queue_wait_s"], q["coalesce_wait_s"],
                      q["dispatch_s"])
        assert qw >= 0 and cw >= 0 and dw >= 0
        total = f.t_resolved - f.t_submit
        # recorded phases are rounded to 1us each: allow 3 roundings
        assert abs((qw + cw + dw) - total) < 5e-6
        assert q["fetch_s"] >= 0
    tn = rec["tenants"]["rid-t"]
    for phase in ("queue_wait", "coalesce_wait", "dispatch", "fetch"):
        assert tn[phase]["count"] >= 8, (phase, tn)


def test_flightrec_records_solo_and_shed():
    xe, ye = _shared(seed=10)
    flight.clear()
    eng = st_t.ServeEngine(workers=1, batch_window_s=0.0, max_batch=4)
    # an expired-deadline request sheds before dispatch (the engine is
    # not started yet, so it cannot be served early)
    _park(eng)
    shed = eng.submit((xe * ye).sum(), deadline_s=0.0)
    _unpark(eng)
    with pytest.raises(st_t.DeadlineExceeded):
        shed.result(timeout=WAIT_S)
    solo = eng.submit((xe - ye).sum() * 3.0)
    solo.result(timeout=WAIT_S)
    eng.stop()
    rec = st_t.flightrec()
    assert rec["requests"][shed.rid]["status"] == "shed"
    assert rec["requests"][shed.rid]["reason"] == "deadline"
    sq = rec["requests"][solo.rid]
    assert sq["status"] == "ok" and sq["batch"] == 1
    assert "dispatch" in sq["events"]


def test_explain_names_coalesced_batch():
    xe, ye = _shared()

    def build(i):
        return (xe - ye).sum() * float(i + 1)

    float(build(98).glom())  # a cold plan's head request runs solo
    eng = st_t.ServeEngine(workers=1, batch_window_s=0.05, max_batch=4)
    _park(eng)
    futs = [eng.submit(build(i)) for i in range(4)]
    _unpark(eng)
    with eng:
        for f in futs:
            f.result(timeout=WAIT_S)
    text = str(st_t.explain(build(99)))
    assert "serve: coalesced" in text
    assert "batch=4" in text and "[vmap]" in text


# -- admission control + deadlines --------------------------------------


def test_backpressure_past_high_water():
    q = AdmissionQueue(2)

    class R:
        plan_key = ("k",)
        coalescable = True
        taken = False

    q.put(R())
    q.put(R())
    with pytest.raises(st_t.Backpressure) as ei:
        q.put(R())
    assert ei.value.retry_after_s > 0
    assert ei.value.depth == 2


def test_queue_bucket_index_matches_fifo():
    q = AdmissionQueue(64)

    class R:
        def __init__(self, key, coalescable=True):
            self.plan_key = key
            self.coalescable = coalescable
            self.taken = False

    a = [R("a") for _ in range(3)]
    b = [R("b") for _ in range(2)]
    solo = R("a", coalescable=False)
    for r in (a[0], b[0], a[1], solo, b[1], a[2]):
        q.put(r)
    head = q.pop(timeout=0)
    assert head is a[0]
    match = q.take_matching("a", 10)
    assert match == [a[1], a[2]]  # solo skipped: not coalescable
    assert q.pop(timeout=0) is b[0]
    assert q.take_matching("b", 10) == [b[1]]
    assert q.pop(timeout=0) is solo
    assert q.pop(timeout=0) is None
    assert q.depth() == 0


def test_deadline_sheds_before_dispatch():
    xe, ye = _shared()
    eng = st_t.ServeEngine(workers=1, batch_window_s=0.0, max_batch=4)
    _park(eng)
    fut = eng.submit((xe + ye).sum(), deadline_s=0.0)
    _unpark(eng)
    with pytest.raises(st_t.DeadlineExceeded):
        fut.result(timeout=WAIT_S)
    eng.stop()


def test_engine_stop_rejects_backlog_and_restarts():
    xe, ye = _shared()
    eng = st_t.ServeEngine(workers=1)
    fut = eng.submit((xe + ye).sum() * 7.0)
    fut.result(timeout=WAIT_S)
    eng.stop()
    with pytest.raises(RuntimeError):
        eng.queue.put(object())  # closed queue rejects
    eng.start()  # reopens
    fut2 = eng.submit((xe + ye).sum() * 8.0)
    assert fut2.result(timeout=WAIT_S) is not None
    eng.stop()


# -- plan-cache LRU bounding --------------------------------------------


def test_plan_cache_lru_eviction_and_variants():
    xe, ye = _shared()
    base.clear_plan_cache()
    base.clear_compile_cache()
    FLAGS.plan_cache_max = 4
    before = _counter("plan_evictions")
    # a plan with a batched variant: a coalesced batch of 2
    first = (xe + ye).sum()
    (first * 1.0).evaluate()
    eng = st_t.ServeEngine(workers=1, batch_window_s=0.05, max_batch=2)
    _park(eng)
    futs = [eng.submit((xe + ye).sum() * float(i)) for i in range(2)]
    _unpark(eng)
    with eng:
        for f in futs:
            f.result(timeout=WAIT_S)
    served_key = _plan_of((xe + ye).sum() * 5.0).key
    assert any(k[:len(served_key)] == served_key
               for k in base._compile_cache)
    built = [
        (xe + ye).sum(),
        (xe * ye).sum(),
        (xe - ye).sum(),
        (xe + ye).sum(axis=0),
        (xe * ye).sum(axis=0),
        (xe - ye).sum(axis=0),
    ]
    for e in built:
        e.evaluate()
    assert base.plan_cache_size() <= 4
    assert _counter("plan_evictions") - before >= 2
    # evicted plans drop their variants with them: every variant key
    # prefix-matches a LIVE plan, and the served plan's is gone
    live = {p.key for p in base._plan_cache.values()}
    for k in base._compile_cache:
        assert any(k[:len(pk)] == pk for pk in live)
    assert served_key not in live
    assert not any(k[:len(served_key)] == served_key
                   for k in base._compile_cache)


def test_plan_cache_unbounded_when_zero():
    xe, ye = _shared()
    base.clear_plan_cache()
    FLAGS.plan_cache_max = 0
    for i in range(3):
        ((xe + ye) * float(i)).sum().evaluate()
    assert base.plan_cache_size() >= 1  # no eviction path taken
    lookedup = base.lookup_plan(
        base.plan_signature(((xe + ye) * 9.0).sum())[0])
    assert lookedup is not None


# -- tenancy -------------------------------------------------------------


def test_per_tenant_metrics_in_prometheus():
    xe, ye = _shared()
    before = {t: REGISTRY.counter(
        f'serve_requests{{tenant="{t}"}}').value for t in ("acme",
                                                           "umbrella")}
    with st_t.ServeEngine(workers=1, batch_window_s=0.0) as eng:
        eng.submit((xe + ye).sum(), tenant="acme").result(timeout=WAIT_S)
        eng.submit((xe + ye).sum() * 2.0,
                   tenant="umbrella").result(timeout=WAIT_S)
    text = REGISTRY.prometheus()
    for t in ("acme", "umbrella"):
        assert (f'spartan_serve_requests{{tenant="{t}"}} '
                f'{before[t] + 1}') in text


# -- concurrency x resilience stress matrix ------------------------------


def _stress(clients, per_client, spec=None, distinct=False,
            tenants=False):
    """N client threads submitting through one engine (optionally under
    chaos); returns (serial results, served results, errors)."""
    xe, ye = _shared(seed=11)

    def build(c, i):
        k = float(c * per_client + i + 1)
        if distinct and c % 2:
            return ((xe * ye) + k).sum()
        return ((xe + ye) * k).sum()

    serial = {}
    for c in range(clients):
        for i in range(per_client):
            serial[(c, i)] = np.asarray(build(c, i).evaluate().glom())

    served = {}
    errors = []
    lock = threading.Lock()
    eng = st_t.ServeEngine(workers=2, batch_window_s=0.001,
                           max_batch=8, queue_max=4096)
    cm = st_t.chaos(spec, seed=7) if spec else None
    mesh = mesh_t.get_mesh()
    try:
        eng.start()

        def client(c):
            try:
                with mesh_t.use_mesh(mesh):
                    futs = [(i, eng.submit(
                        build(c, i),
                        tenant=f"t{c}" if tenants else None))
                        for i in range(per_client)]
                for i, f in futs:
                    v = np.asarray(f.glom(timeout=WAIT_S))
                    with lock:
                        served[(c, i)] = v
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=2 * WAIT_S)
        assert not any(t.is_alive() for t in threads), "deadlock"
    finally:
        if cm is not None:
            cm.uninstall()
        eng.stop()
    return serial, served, errors


def test_stress_identical_plans_bit_equal():
    serial, served, errors = _stress(clients=8, per_client=6)
    assert not errors
    assert len(served) == len(serial)
    for k, v in serial.items():
        np.testing.assert_array_equal(v, served[k])


def test_stress_distinct_plans_bit_equal():
    serial, served, errors = _stress(clients=8, per_client=6,
                                     distinct=True)
    assert not errors
    for k, v in serial.items():
        np.testing.assert_array_equal(v, served[k])


def test_stress_under_transient_chaos_bit_equal():
    # probabilistic transient faults: the coalesced path falls back to
    # solo, the solo path retries under the policy engine; results stay
    # bit-equal and nothing deadlocks
    before = _counter("resilience_retries")
    serial, served, errors = _stress(clients=8, per_client=6,
                                     spec="transient:0.08",
                                     tenants=True)
    assert not errors
    assert len(served) == len(serial)
    for k, v in serial.items():
        np.testing.assert_array_equal(v, served[k])
    assert _counter("resilience_retries") >= before


def test_per_tenant_retry_budgets_isolated():
    """One tenant's fault storm cannot drain another tenant's retry
    account: budgets are keyed (tenant, plan digest)."""
    xe, ye = _shared(seed=5)
    FLAGS.retry_max = 1
    FLAGS.retry_budget = 2

    def burn(tenant):
        hits = 0
        for i in range(4):
            e = ((xe + ye) * float(100 + i)).sum()
            with st_t.chaos("transient@0", seed=i):
                with res_engine.tenant_scope(tenant):
                    try:
                        e.evaluate()
                        hits += 1
                    except Exception:  # noqa: BLE001
                        pass
        return hits

    assert burn("tenant-a") == 2  # 2 retries allowed, then exhausted
    assert burn("tenant-b") == 2  # B's account on the SAME plan intact


def test_tenant_quota_caps_across_plans():
    xe, ye = _shared(seed=6)
    FLAGS.retry_max = 1
    FLAGS.retry_budget = 100
    FLAGS.serve_tenant_retry_quota = 3
    survived = 0
    with res_engine.tenant_scope("greedy"):
        for i in range(6):
            # distinct plans so the per-plan budget never binds
            e = ((xe + ye) * float(i)).sum(axis=0) + float(i)
            with st_t.chaos("transient@0", seed=i):
                try:
                    e.evaluate()
                    survived += 1
                except Exception:  # noqa: BLE001
                    pass
    assert survived == 3  # quota, not per-plan budget, was the cap


def test_engine_stats_shape():
    xe, ye = _shared()
    with st_t.ServeEngine(workers=1, batch_window_s=0.01) as eng:
        futs = [eng.submit((xe + ye).sum() * float(i))
                for i in range(4)]
        for f in futs:
            f.result(timeout=WAIT_S)
        stats = eng.stats()
    for key in ("queue_depth", "requests", "coalesced_requests",
                "coalesced_batches", "rejected", "deadline_expired",
                "solo_fallbacks", "coalesce_hit_ratio",
                "mem_reserved_bytes", "mem_rejected"):
        assert key in stats
    assert set(stats) == set(st_j.ServeEngine(workers=1).stats())


# -- parity with the JAX package -----------------------------------------


def _serve_all(st, builds, park):
    eng = st.ServeEngine(workers=1, batch_window_s=0.05, max_batch=8)
    park(eng)
    futs = [eng.submit(b) for b in builds]
    eng._threads.clear()
    eng.start()
    try:
        return [np.asarray(f.glom(timeout=WAIT_S)) for f in futs], futs
    finally:
        eng.stop()


@pytest.mark.parametrize("form", ["sum_times_s", "scaled_sum"])
def test_served_values_match_jax_package(form):
    """The same seeded requests through both engines: the port's served
    values bit-equal to its serial ones, the JAX package's within rtol
    1e-6 of its own (XLA's batched axis reduction sums in another order
    than its solo one: 7 of 16 sums of the ``scaled_sum`` form differ in
    the last bit), and the two packages within rtol 1e-5."""
    scales = [float(s) for s in np.random.RandomState(4).rand(8) * 10]

    def builds(xe, ye):
        if form == "sum_times_s":
            return [(xe + ye).sum() * s for s in scales]
        return [((xe + ye) * s).sum(axis=0) for s in scales]

    xe, ye = _shared(seed=12)
    xj, yj = _shared_j(seed=12)
    serial_t = [np.asarray(b.evaluate().glom()) for b in builds(xe, ye)]
    serial_j = [np.asarray(b.glom()) for b in builds(xj, yj)]
    got_t, futs_t = _serve_all(st_t, builds(xe, ye), _park)
    got_j, futs_j = _serve_all(st_j, builds(xj, yj), _park)
    for a, b in zip(serial_t, got_t):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(serial_j, got_j):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    for a, b in zip(got_t, got_j):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    assert [f.coalesced for f in futs_t] == [f.coalesced for f in futs_j]
    plan = _plan_of(builds(xe, ye)[0])
    assert coalesce.mode_for(plan) == "vmap"
    assert plan.report["serve"]["last_batch"] == 8


def _kinds(st_pkg, flight_mod, reqs):
    rec = st_pkg.flightrec()
    return [rec["requests"][f.rid]["events"] for f in reqs]


def test_flight_event_kinds_match_jax_package():
    """Each request's sequence of flight-event kinds, for a shed, a solo
    and a coalesced request, equals the JAX package's."""
    from spartan_tpu.obs import flight as flight_j

    def drive(st, xe, ye, flight_mod):
        flight_mod.clear()
        eng = st.ServeEngine(workers=1, batch_window_s=0.05, max_batch=4)
        _park(eng)
        shed = eng.submit((xe * ye).sum(), deadline_s=0.0)
        eng._threads.clear()
        eng.start()
        with pytest.raises(st.DeadlineExceeded):
            shed.result(timeout=WAIT_S)
        solo = eng.submit((xe - ye).sum() * 3.0)
        solo.glom(timeout=WAIT_S)
        eng.stop()
        float(((xe + ye).sum() * 0.5).glom())  # warm the batch's plan
        eng.queue.reopen()
        _park(eng)
        batch = [eng.submit((xe + ye).sum() * float(i + 1))
                 for i in range(4)]
        eng._threads.clear()
        eng.start()
        for f in batch:
            f.glom(timeout=WAIT_S)
        eng.stop()
        return _kinds(st, flight_mod, [shed, solo] + batch)

    xe, ye = _shared(seed=13)
    xj, yj = _shared_j(seed=13)
    kt = drive(st_t, xe, ye, flight)
    kj = drive(st_j, xj, yj, flight_j)
    assert kt == kj
    assert kt[0] == ["submit", "enqueue", "shed"]
    assert kt[1] == ["submit", "enqueue", "dispatch", "resolve", "fetch"]
    assert kt[2] == ["submit", "enqueue", "coalesce", "resolve", "fetch"]


def _clusters(n=2048, d=128, k=8, seed=0):
    """Well-separated clusters, one initial center per cluster (ROADMAP
    C22: the fused pass drops |p|^2 from the distances, the JAX map2
    form keeps it, so the two are compared where no row is near a
    tie)."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(k, d).astype(np.float32) * 20.0
    labels = np.arange(n) % k
    pts = (centers[labels]
           + rng.randn(n, d).astype(np.float32) * 0.05).astype(np.float32)
    return pts, centers


def test_coalesced_kmeans_step_vmap_matches_jax():
    """Served k-means steps: one batch in ``vmap`` mode, the fused
    pass's batching rule (one plain pass a client on the CPU), each
    result bit-equal to its serial evaluate and within rtol 1e-5 of the
    JAX package's ``kmeans_step``."""
    pts, centers = _clusters()
    rng = np.random.RandomState(1)
    cs = [(centers + rng.randn(*centers.shape).astype(np.float32) * 0.5)
          .astype(np.float32) for _ in range(8)]
    p_t = st_t.from_numpy(pts)
    c_t = [st_t.from_numpy(c) for c in cs]
    assert isinstance(km_t.kmeans_step(p_t, c_t[0], 8),
                      km_t.KMeansStepExpr)
    serial = [km_t.kmeans_step(p_t, c, 8).glom() for c in c_t]
    got, futs = _serve_all(st_t, [km_t.kmeans_step(p_t, c, 8)
                                  for c in c_t], _park)
    for a, b in zip(serial, got):
        np.testing.assert_array_equal(a, b)
    assert [f.coalesced for f in futs] == [8] * 8
    plan = _plan_of(km_t.kmeans_step(p_t, c_t[0], 8))
    assert coalesce.mode_for(plan) == "vmap"
    assert plan.report["serve"]["mode"] == "vmap"
    p_j = st_j.from_numpy(pts)
    for c, b in zip(cs, got):
        want = np.asarray(km_j.kmeans_step(p_j, st_j.from_numpy(c),
                                           8).glom())
        np.testing.assert_allclose(b, want, rtol=1e-5, atol=1e-5)


def test_coalesced_naive_bayes_fits_stay_in_vmap(monkeypatch):
    """Served naive Bayes fits under ``native_kernels=on``, where both
    segment sums are the block kernel's operator: one batch in ``vmap``
    mode with no demotion, the operator's batching rule one call a
    client, each result bit-equal to its serial evaluate."""
    from spartan_tpu_torch.array import tiling as tiling_t
    from spartan_tpu_torch.examples import naive_bayes
    from spartan_tpu_torch.kernels import segment as kseg

    rng = np.random.RandomState(5)
    y = st_t.from_numpy(rng.randint(0, 4, 512).astype(np.int32))
    xs = [st_t.from_numpy(np.floor(rng.rand(512, 16) * 5.0)
                          .astype(np.float32)) for _ in range(8)]

    def build(x):
        return st_t.map2([x, y], naive_bayes._fit_kern(4),
                         out_tiling=tiling_t.replicated(2))

    prev = FLAGS.native_kernels
    FLAGS.native_kernels = "on"
    try:
        serial = [np.asarray(build(x).glom()) for x in xs]
        calls = []
        plain = kseg.segment_sum_block_plain

        def counted(v, i, k):
            calls.append(tuple(v.shape))
            return plain(v, i, k)

        monkeypatch.setattr(kseg, "segment_sum_block_plain", counted)
        got, futs = _serve_all(st_t, [build(x) for x in xs], _park)
        plan = _plan_of(build(xs[0]))
    finally:
        FLAGS.native_kernels = prev
    for a, b in zip(serial, got):
        np.testing.assert_array_equal(a, b)
    assert [f.coalesced for f in futs] == [8] * 8
    assert coalesce.mode_for(plan) == "vmap"
    assert plan.report["serve"]["mode"] == "vmap"
    # each client's feature counts one call a client; the class sizes
    # read only the shared labels, so they run once, unbatched
    assert sorted(calls) == sorted([(512, 16)] * 8 + [(512,)])


def test_shared_subdag_runs_once_per_batch_under_vmap(monkeypatch):
    """``(x + y).sum() * s``: the shared ``(x + y).sum()`` runs once per
    batch (on unbatched tensors), the product once, batched."""
    xe, ye = _shared(seed=14)
    float(((xe + ye).sum() * 2.0).glom())
    plan = _plan_of((xe + ye).sum() * 3.0)
    from spartan_tpu_torch.expr.optimize import dag_nodes

    calls = []
    for n in dag_nodes(plan.dag):
        if type(n).__name__ == "ReduceExpr":
            orig = n._lower

            def counted(env, orig=orig):
                out = orig(env)
                calls.append(torch._C._functorch.is_batchedtensor(out))
                return out

            monkeypatch.setattr(n, "_lower", counted)
    assert len({id(n) for n in dag_nodes(plan.dag)
                if type(n).__name__ == "ReduceExpr"}) == 1
    got, futs = _serve_all(st_t, [(xe + ye).sum() * float(i + 1)
                                  for i in range(8)], _park)
    assert calls == [False]  # once, on unbatched tensors
    assert coalesce.mode_for(plan) == "vmap"
    want = float(np.asarray((xe + ye).sum().glom()))
    np.testing.assert_allclose([float(g) for g in got],
                               [want * (i + 1) for i in range(8)],
                               rtol=RTOL)


# -- the demotion ladder ---------------------------------------------------


def _copied_in_place(t):
    """A user function that writes its operand into a fresh buffer in
    place: under vmap the buffer is unbatched and the write raises."""
    out = torch.zeros(t.shape, dtype=t.dtype, device=t.device)
    out.add_(t)
    return out * 2.0


def test_ladder_reaches_unroll_on_an_unvmappable_plan():
    """A user map that writes in place into an unbatched buffer: its
    vmap walk raises, the failure classifies deterministic, the plan
    demotes to ``unroll`` and the batch is served solo (a ``fallback``
    flight event); the next batch coalesces in ``unroll``, bit-equal to
    serial."""
    rng = np.random.RandomState(15)
    vs = [st_t.from_numpy(rng.rand(4096).astype(np.float32))
          for _ in range(4)]

    def build(v):
        return st_t.map(_copied_in_place, st_t.as_expr(v))

    serial = [np.asarray(build(v).glom()) for v in vs]
    dem = _counter("serve_mode_demotions")
    flight.clear()
    got, futs = _serve_all(st_t, [build(v) for v in vs], _park)
    for a, b in zip(serial, got):
        np.testing.assert_array_equal(a, b)
    assert [f.coalesced for f in futs] == [1] * 4
    plan = _plan_of(build(vs[0]))
    assert coalesce.mode_for(plan) == "unroll"
    assert _counter("serve_mode_demotions") == dem + 1
    rec = st_t.flightrec()
    assert all(rec["requests"][f.rid]["status"] == "ok"
               and "fallback" in rec["requests"][f.rid]["events"]
               for f in futs)
    got2, futs2 = _serve_all(st_t, [build(v) for v in vs], _park)
    for a, b in zip(serial, got2):
        np.testing.assert_array_equal(a, b)
    assert [f.coalesced for f in futs2] == [4] * 4
    assert plan.report["serve"]["mode"] == "unroll"


def _vmap_error(fn, *args):
    try:
        torch.func.vmap(fn)(*args)
    except Exception as e:  # noqa: BLE001 - the message under test
        return e
    raise AssertionError("vmap did not raise")


def test_unvmappable_lowerings_classify_deterministic():
    """The messages torch raises for a walk that cannot be vmapped —
    a host read (``.item()``, ``.tolist()``), a shape that depends on
    data, an in-place write into an unbatched buffer — and the
    coalescer's group-mesh refusal all classify deterministic: the
    ladder demotes, it never retries."""
    x = torch.rand(3, 5)
    errs = [
        _vmap_error(lambda r: r.sum().item(), x),
        _vmap_error(lambda r: torch.tensor(r.tolist()), x),
        _vmap_error(lambda r: torch.nonzero(r > 0.5), x),
        _vmap_error(lambda r: torch.unique(r), x),
        _vmap_error(lambda r: torch.zeros(5).add_(r), x),
    ]
    for e in errs:
        assert cls_t.classify(e) == cls_t.DETERMINISTIC, repr(e)

    class _Group:
        is_group = True
        device = torch.device("cpu")

    plan = _plan_of_any()
    with pytest.raises(RuntimeError) as ei:
        coalesce.dispatch_batch(plan, [], _Group())
    assert cls_t.classify(ei.value) == cls_t.DETERMINISTIC
    assert "group mesh" in str(ei.value)


def _plan_of_any():
    xe, ye = _shared(seed=16)
    e = (xe + ye).sum()
    e.evaluate()
    return _plan_of((xe + ye).sum())


# -- audit and integrity inside a batch -----------------------------------


def test_audited_batch_probes_each_client():
    """Under ``FLAGS.audit_numerics`` a batch probes each client's leaves
    and nodes as a solo walk does (the JAX package's batched program
    calls its probe callbacks once per client), and stays bit-equal."""
    xe, ye = _shared(seed=17)

    def build(i):
        return (xe + ye).sum() * float(i + 1)

    serial = [np.asarray(build(i).evaluate().glom()) for i in range(4)]
    FLAGS.audit_numerics = True
    before = _counter("numerics_health_records")
    build(0).evaluate()
    per_walk = _counter("numerics_health_records") - before
    assert per_walk > 0
    before = _counter("numerics_health_records")
    got, futs = _serve_all(st_t, [build(i) for i in range(4)], _park)
    assert _counter("numerics_health_records") - before == 4 * per_walk
    assert [f.coalesced for f in futs] == [4] * 4
    for a, b in zip(serial, got):
        np.testing.assert_array_equal(a, b)


def test_integrity_sentinel_rides_solo_walks_only(monkeypatch):
    """Like the JAX package's batched program, a coalesced batch runs no
    integrity re-walk (nor a sampled profile): the sentinel checks solo
    walks, and served values stay bit-equal."""
    xe, ye = _shared(seed=18)

    def build(i):
        return (xe + ye).sum() * float(i + 1)

    serial = [np.asarray(build(i).evaluate().glom()) for i in range(4)]
    FLAGS.integrity_check = True
    FLAGS.profile_sample_every = 1
    checks = []
    orig = integrity_t.maybe_check
    monkeypatch.setattr(integrity_t, "maybe_check",
                        lambda *a, **k: checks.append(1) or orig(*a, **k))
    build(0).evaluate()
    assert checks  # a solo walk is checked
    n = len(checks)
    got, futs = _serve_all(st_t, [build(i) for i in range(4)], _park)
    assert [f.coalesced for f in futs] == [4] * 4
    assert len(checks) == n
    for a, b in zip(serial, got):
        np.testing.assert_array_equal(a, b)


# -- elastic drain ----------------------------------------------------------


def test_elastic_drain_fails_queued_requests_and_resubmits():
    """Queued requests of the default engine fail with
    ``MeshReconfiguring`` (with a retry-after) when ``device_loss`` chaos
    rebuilds the logical (4, 2) mesh; resubmitted after the rebuild on
    rehomed inputs, they come back bit-equal to a clean serial run on
    the rebuilt mesh."""
    from spartan_tpu_torch.resilience import elastic

    x, y = _np_pair(32, seed=19)
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        xa, ya = st_t.from_numpy(x).evaluate(), st_t.from_numpy(y).evaluate()
        from spartan_tpu_torch.serve import engine as engine_t

        eng = st_t.ServeEngine()
        _park(eng)
        engine_t._default = eng  # the engine elastic recovery drains
        queued = [eng.submit((st_t.as_expr(xa) + st_t.as_expr(ya)).sum()
                             * float(i + 1)) for i in range(3)]
        assert eng.running and eng.queue.depth() == 3
        with st_t.chaos("device_loss@0"):
            z = (st_t.as_expr(xa) * 2.0).sum()
            with pytest.raises(Exception):
                z.evaluate()
        assert mesh_t.mesh_epoch() == 1
        for f in queued:
            e = f.exception(timeout=WAIT_S)
            assert isinstance(e, st_t.MeshReconfiguring)
            assert e.retry_after_s > 0
        rec = st_t.flightrec()
        assert all(rec["requests"][f.rid]["reason"] == "reconfiguring"
                   for f in queued)
        eng._threads.clear()
        eng.start()
        assert eng._reconfiguring is None  # admission reopened
        elastic.rehome([xa, ya])
        rebuilt = mesh_t.get_mesh()
        clean = [np.asarray(((st_t.as_expr(xa) + st_t.as_expr(ya)).sum()
                             * float(i + 1)).evaluate().glom())
                 for i in range(3)]
        futs = [eng.submit((st_t.as_expr(xa) + st_t.as_expr(ya)).sum()
                           * float(i + 1)) for i in range(3)]
        for f, want in zip(futs, clean):
            np.testing.assert_array_equal(np.asarray(f.glom(timeout=WAIT_S)),
                                          want)
        assert rebuilt.shape == mesh_t.get_mesh().shape


# -- launch counters under threads -------------------------------------------


def test_launch_counters_exact_under_threads(monkeypatch):
    """8 threads x 100 calls through the k-means wrapper's counting
    path (the kernel launch replaced by its plain version) and through
    every other module's counter: the counts come out exact."""
    from spartan_tpu_torch.kernels import (exchange, histogram, segment,
                                           stencil, topk)

    monkeypatch.setattr(build_mod, "on_card", lambda t, what: True)

    def fake_launch(points, centers, k, valid):
        out = kk.assign_accumulate_plain(points, centers, k, valid)
        with build_mod.COUNT_LOCK:
            kk.LAUNCHES += 1
        return out

    monkeypatch.setattr(kk, "_launch", fake_launch)
    mods = [(exchange, "partition_pack"), (histogram, "bincount_block"),
            (segment, "segment_sum_block"), (stencil, "conv_block"),
            (topk, "shard_topk")]
    k0 = kk.LAUNCHES
    before = {n: m.LAUNCHES[n] for m, n in mods}
    p = torch.rand(64, 128)
    c = p[:4].clone()
    barrier = threading.Barrier(8)

    def worker():
        barrier.wait()
        for _ in range(100):
            kk.assign_accumulate(p, c, 4)
            for m, n in mods:
                build_mod.count_launch(m.LAUNCHES, n)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert kk.LAUNCHES - k0 == 800
    for m, n in mods:
        assert m.LAUNCHES[n] - before[n] == 800
        m.LAUNCHES[n] = before[n]
    kk.LAUNCHES = k0


def test_kmeans_vmap_rule_bit_equal_to_solo_passes():
    """The operator's batching rule: ``torch.func.vmap`` over the pass
    gives each client's solo result, shared points or not."""
    g = torch.Generator().manual_seed(20)
    p = torch.rand(3000, 128, generator=g)
    cs = torch.rand(5, 8, 128, generator=g)
    ps = torch.rand(5, 300, 128, generator=g)
    solo = [kk.assign_accumulate(p, cs[i], 8) for i in range(5)]
    sums, cnt = torch.func.vmap(
        lambda c: kk.assign_accumulate(p, c, 8, 2500))(cs)
    solo_v = [kk.assign_accumulate(p, cs[i], 8, 2500) for i in range(5)]
    for i in range(5):
        assert torch.equal(sums[i], solo_v[i][0])
        assert torch.equal(cnt[i], solo_v[i][1])
    both = torch.func.vmap(lambda q, c: kk.step(q, c, 8))(ps, cs)
    for i in range(5):
        assert torch.equal(both[i], kk.step(ps[i], cs[i], 8))
    assert solo[0][1].sum().item() == 3000


def test_crash_dump_carries_the_flight_record(tmp_path):
    xe, ye = _shared(seed=21)
    flight.clear()
    fut = ((xe + ye).sum() * 2.0).evaluate_async(tenant="dump-t")
    fut.glom(timeout=WAIT_S)
    import json

    path = numerics_t.dump_crash(str(tmp_path / "crash.json"),
                                 reason="test")
    with open(path) as f:
        doc = json.load(f)
    fr = doc["flightrec"]
    assert fr is not None
    req = fr["requests"][str(fut.rid)]
    assert req["tenant"] == "dump-t" and req["status"] == "ok"


def test_engine_prewarm_and_the_persist_flight_event(tmp_path):
    """``ServeEngine.prewarm`` loads a stored plan set off the request
    path; the first served request of a prewarmed plan builds it from
    the store (``persist`` flight event, source ``disk``) with no DP
    run, and its value equals the evaluate before the restart."""
    from spartan_tpu_torch import persist
    from spartan_tpu_torch.utils import profiling as prof_t

    saved = FLAGS.persist_cache_dir
    rng = np.random.RandomState(22)
    x = st_t.from_numpy(rng.rand(48, 48).astype(np.float32))
    y = st_t.from_numpy(rng.rand(48, 48).astype(np.float32))

    def build():
        return st_t.dot(st_t.dot(x, y) * 0.5 + 1.0, x).sum(axis=0)

    try:
        FLAGS.persist_cache_dir = str(tmp_path / "store")
        base.clear_plan_cache()
        persist.reset()
        want = np.asarray(build().glom())
        man = str(tmp_path / "manifest.json")
        assert persist.write_manifest(man) == 1
        base.clear_plan_cache()  # a restart: the disk stays
        persist.reset()
        with st_t.ServeEngine(workers=1, batch_window_s=0.0) as eng:
            got = eng.prewarm(man)
            assert got["loaded"] == 1 and got["errors"] == 0
            assert REGISTRY.gauge("persist_prewarmed_plans").value == 1
            dp0 = prof_t.counters().get("tiling_dp_runs", 0)
            flight.clear()
            fut = eng.submit(build())
            np.testing.assert_array_equal(
                np.asarray(fut.glom(timeout=WAIT_S)), want)
        assert prof_t.counters().get("tiling_dp_runs", 0) == dp0
        evs = [e for e in flight.events()
               if e.rid == fut.rid and e.kind == "persist"]
        assert len(evs) == 1 and evs[0].args["source"] == "disk"
    finally:
        FLAGS.persist_cache_dir = saved
        base.clear_plan_cache()
        persist.reset()
