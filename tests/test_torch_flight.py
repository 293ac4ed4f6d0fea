"""The port's flight recorder (``obs/flight.py``) and SLO classes
(``obs/slo.py``), on the CPU.

* the flight ring: rid/span minting, the event grammar, the resolution
  decomposition and per-tenant histograms, the bounded ring, ``clear``,
  and one flag read when ``FLAGS.flightrec`` is off; the same snapshot
  shape as the JAX package's for the same calls;
* the SLO cases of ``tests/test_monitor.py`` (from
  ``test_slo_class_parsing_matrix``): the class and tenant parsers, burn
  tracking and its Prometheus export, the bounded window, queue-share
  admission, and the model-priced predictive shed with and without
  ``FLAGS.serve_model_pricing``; ``slo.burn_rates`` equal to the JAX
  package's for the same latency sequence;
* the flight case of ``tests/test_profile.py``: requests served under
  ``FLAGS.profile_sample_every`` are stamped ``profiled`` (and ``skew``)
  in their flight records.

Every wait has its own timeout; no test sleeps.
"""

import threading

import numpy as np
import pytest
import torch

from spartan_tpu.obs import flight as flight_j
from spartan_tpu.obs import slo as slo_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J

import spartan_tpu_torch as st_t
from spartan_tpu_torch.obs import flight
from spartan_tpu_torch.obs import ledger
from spartan_tpu_torch.obs import profile as profile_t
from spartan_tpu_torch.obs import skew as skew_t
from spartan_tpu_torch.obs import slo
from spartan_tpu_torch.obs.explain import key_hash
from spartan_tpu_torch.obs.metrics import REGISTRY, labeled
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.serve import engine as engine_mod
from spartan_tpu_torch.serve.future import Backpressure, DeadlineExceeded
from spartan_tpu_torch.utils.config import FLAGS

torch.set_num_threads(1)

WAIT_S = 60

_SAVED = ("serve_slo_classes", "serve_slo_tenants", "serve_slo_window",
          "cost_ledger", "serve_model_pricing", "flightrec",
          "flightrec_ring", "profile_sample_every")
_SAVED_J = ("serve_slo_classes", "serve_slo_tenants", "serve_slo_window")


@pytest.fixture(autouse=True)
def _setup():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    saved = {n: getattr(FLAGS, n) for n in _SAVED}
    saved_j = {n: getattr(FLAGS_J, n) for n in _SAVED_J}
    FLAGS.cost_ledger = True
    ledger.set_profile(None)
    ledger.reset()
    slo.reset()
    slo_j.reset()
    profile_t.reset()
    skew_t.reset()
    st_t.serve.shutdown_default()
    yield
    st_t.serve.shutdown_default()
    ledger.set_profile(None)
    ledger.reset()
    slo.reset()
    slo_j.reset()
    profile_t.reset()
    skew_t.reset()
    for n, v in saved.items():
        setattr(FLAGS, n, v)
    for n, v in saved_j.items():
        setattr(FLAGS_J, n, v)
    mesh_t.set_default_device(prev)


def _fresh_expr(seed=21):
    rng = np.random.RandomState(seed)
    return (st_t.as_expr(rng.rand(16, 16).astype(np.float32))
            + st_t.as_expr(rng.rand(16, 16).astype(np.float32)))


def _park(engine):
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    engine._threads.append(t)


# -- the flight ring -------------------------------------------------------


def _drive(mod):
    """The same calls against either package's recorder."""
    mod.clear()
    r1, r2 = mod.mint_rid(), mod.mint_rid()
    sp = mod.mint_span()
    mod.note(r1, "submit", tenant="a", plan="p1")
    mod.note(r1, "enqueue", depth=1)
    mod.note(r1, "coalesce", span=sp, batch=2, via="head")
    mod.note(r2, "submit", tenant="b", plan="p1")
    mod.note(r2, "enqueue", depth=2)
    mod.note(r2, "coalesce", span=sp, batch=2, via="queued")
    mod.record_resolution(rid=r1, tenant="a", span=sp, batch=2,
                          status="ok", t_submit=1.0, t_taken=1.25,
                          t_dispatch=1.5, t_resolved=2.0)
    mod.record_resolution(rid=r2, tenant="b", span=sp, batch=2,
                          status="ok", t_submit=1.0, t_taken=1.5,
                          t_dispatch=1.5, t_resolved=2.0)
    mod.note_fetch(r1, "a", 0.125)
    r3 = mod.mint_rid()
    mod.note(r3, "submit", tenant="a", plan="p2")
    mod.note(r3, "reject", reason="memory")
    snap = mod.snapshot()
    reqs = {}
    for rid, name in ((r1, "r1"), (r2, "r2"), (r3, "r3")):
        q = dict(snap["requests"][rid])
        q.pop("rid")
        q.pop("t_submit_us", None)
        q["dispatch_span"] = q.get("dispatch_span") is not None
        reqs[name] = q
    kinds = [e["kind"] for e in snap["events"]]
    return reqs, kinds


def test_flight_snapshot_matches_jax_package():
    reqs_t, kinds_t = _drive(flight)
    reqs_j, kinds_j = _drive(flight_j)
    assert kinds_t == kinds_j
    assert reqs_t == reqs_j
    assert reqs_t["r1"]["queue_wait_s"] == 0.25
    assert reqs_t["r1"]["coalesce_wait_s"] == 0.25
    assert reqs_t["r1"]["dispatch_s"] == 0.5
    assert reqs_t["r1"]["fetch_s"] == 0.125
    assert reqs_t["r3"]["status"] == "reject"
    assert reqs_t["r3"]["reason"] == "memory"


def test_ids_are_monotonic_and_process_unique():
    a = [flight.mint_rid() for _ in range(5)]
    assert a == sorted(a) and len(set(a)) == 5
    flight.clear()  # clearing keeps the counters running
    assert flight.mint_rid() > a[-1]
    s = flight.mint_span()
    assert flight.mint_span() == s + 1


def test_ring_is_bounded_and_resizes():
    flight.clear()
    FLAGS.flightrec_ring = 16
    rid = flight.mint_rid()
    for i in range(40):
        flight.note(rid, "enqueue", depth=i)
    evs = flight.events()
    assert len(evs) == 16
    assert evs[-1].args["depth"] == 39  # the newest survive
    FLAGS.flightrec_ring = 32
    flight.note(rid, "enqueue", depth=40)
    assert len(flight.events()) == 17
    assert flight.snapshot(limit=4)["events"][-1]["depth"] == 40
    assert len(flight.snapshot(limit=4)["events"]) == 4


def test_recording_off_is_one_flag_read():
    flight.clear()
    FLAGS.flightrec = False
    rid = flight.mint_rid()
    flight.note(rid, "submit", tenant="x")
    flight.record_resolution(rid=rid, tenant="x", span=1, batch=1,
                             status="ok", t_submit=0.0, t_taken=0.0,
                             t_dispatch=0.0, t_resolved=1.0)
    flight.note_fetch(rid, "x", 1.0)
    assert flight.events() == []
    FLAGS.flightrec = True
    with st_t.ServeEngine(workers=1, batch_window_s=0.0) as eng:
        FLAGS.flightrec = False
        fut = eng.submit(_fresh_expr(5).sum())
        fut.glom(timeout=WAIT_S)
    assert flight.events() == []
    assert fut.rid > 0  # ids are minted whatever the flag


def test_tenant_histograms_decompose_each_phase():
    flight.clear()
    with st_t.ServeEngine(workers=1, batch_window_s=0.0) as eng:
        futs = [eng.submit(_fresh_expr(6 + i).sum(), tenant="hist-t")
                for i in range(3)]
        for f in futs:
            f.glom(timeout=WAIT_S)
    tn = st_t.flightrec()["tenants"]["hist-t"]
    for phase in ("queue_wait", "coalesce_wait", "dispatch", "fetch"):
        assert tn[phase]["count"] >= 3
    text = st_t.metrics(fmt="prometheus")
    for phase in ("queue_wait", "coalesce_wait", "dispatch", "fetch"):
        assert f'spartan_serve_{phase}_s_count{{tenant="hist-t"}}' in text


# -- SLO classes + burn windows (tests/test_monitor.py's SLO cases) ----------


def test_slo_class_parsing_matrix():
    FLAGS.serve_slo_classes = (
        "gold=0.05@0.999:0.25, bulk=2.0, nonsense")
    FLAGS.serve_slo_tenants = "t1=gold, svc=bulk"
    table = slo.classes()
    assert set(table) == {"gold", "bulk"}
    g = table["gold"]
    assert (g.target_s, g.objective, g.share) == (0.05, 0.999, 0.25)
    b = table["bulk"]
    assert (b.target_s, b.objective, b.share) == (2.0, 0.99, 1.0)
    assert abs(g.budget() - 0.001) < 1e-12

    assert slo.class_for("t1").name == "gold"
    assert slo.class_for("svc").name == "bulk"
    assert slo.class_for("stranger") is None
    assert slo.class_for(None) is None

    FLAGS.serve_slo_classes = "default=1.0@0.9"
    assert slo.class_for("stranger").name == "default"
    FLAGS.serve_slo_classes = "x=1.0@1.0"
    assert slo.classes()["x"].objective <= 0.999999
    FLAGS.serve_slo_classes = ""
    assert slo.classes() == {}
    assert slo.class_for("t1") is None


@pytest.mark.parametrize("spec", [
    "gold=0.05@0.999:0.25, bulk=2.0, nonsense",
    "default=1.0@0.9,hot=0.001@0.5:0.1",
    "a=1@2:3,b=x@0.9,c=0.5@:0.5,=1@0.9",
])
def test_slo_parsers_match_jax_package(spec):
    FLAGS.serve_slo_classes = spec
    FLAGS_J.serve_slo_classes = spec
    FLAGS.serve_slo_tenants = FLAGS_J.serve_slo_tenants = \
        "t1=gold, svc=bulk,bad, t2=default"
    t = {k: v.to_dict() for k, v in slo.classes().items()}
    j = {k: v.to_dict() for k, v in slo_j.classes().items()}
    assert t == j
    for tenant in ("t1", "svc", "t2", "stranger", None):
        ct, cj = slo.class_for(tenant), slo_j.class_for(tenant)
        assert (ct.name if ct else None) == (cj.name if cj else None)


def test_slo_burn_tracking_and_prometheus_export():
    FLAGS.serve_slo_classes = "gold=0.001@0.9"
    FLAGS.serve_slo_tenants = "hot=gold"
    FLAGS.serve_slo_window = 16
    req0 = REGISTRY.counter(
        labeled("slo_requests_total", slo_class="gold")).value
    vio0 = REGISTRY.counter(
        labeled("slo_violations_total", slo_class="gold")).value
    for _ in range(10):
        slo.observe("hot", 0.05)  # every one a violation
    slo.observe("untracked-tenant", 0.05)  # no-op

    rec = slo.burn_rates()["gold"]
    assert rec["window"] == 10
    assert rec["violation_rate"] == pytest.approx(1.0)
    assert rec["burn_rate"] == pytest.approx(10.0)
    assert rec["target_s"] == 0.001 and rec["queue_share"] == 1.0

    assert REGISTRY.counter(
        labeled("slo_requests_total", slo_class="gold")).value == req0 + 10
    assert REGISTRY.counter(
        labeled("slo_violations_total", slo_class="gold")).value \
        == vio0 + 10

    text = st_t.metrics(fmt="prometheus")
    assert "# HELP spartan_slo_burn_rate " in text
    assert "# TYPE spartan_slo_burn_rate gauge" in text
    assert 'spartan_slo_burn_rate{slo_class="gold"}' in text


def test_slo_window_is_bounded():
    FLAGS.serve_slo_classes = "gold=10.0@0.9"
    FLAGS.serve_slo_tenants = "hot=gold"
    FLAGS.serve_slo_window = 8
    for _ in range(8):
        slo.observe("hot", 100.0)  # violations fill the window
    for _ in range(8):
        slo.observe("hot", 0.0)  # then healthy samples evict them
    rec = slo.burn_rates()["gold"]
    assert rec["window"] == 8
    assert rec["violation_rate"] == pytest.approx(0.0)
    assert rec["burn_rate"] == pytest.approx(0.0)


def test_burn_rates_match_jax_package():
    """The same latency sequence through both packages' classes gives the
    same burn state, window by window."""
    spec = "gold=0.05@0.99:0.5,silver=0.2@0.9,default=1.0@0.5"
    tenants = "a=gold,b=silver"
    FLAGS.serve_slo_classes = FLAGS_J.serve_slo_classes = spec
    FLAGS.serve_slo_tenants = FLAGS_J.serve_slo_tenants = tenants
    FLAGS.serve_slo_window = FLAGS_J.serve_slo_window = 32
    rng = np.random.RandomState(7)
    lat = rng.exponential(0.1, size=200)
    who = rng.choice(["a", "b", "c", None], size=200)
    for i, (t, s) in enumerate(zip(who, lat)):
        slo.observe(t, float(s))
        slo_j.observe(t, float(s))
        if i % 50 == 49:
            assert slo.burn_rates() == slo_j.burn_rates()
    assert slo.burn_rates()["gold"]["window"] == 32


def test_slo_class_queue_share_admission():
    FLAGS.serve_slo_classes = "bulk=5.0@0.9:0.5"
    FLAGS.serve_slo_tenants = "b=bulk"
    engine = st_t.ServeEngine(workers=1, queue_max=4, batch_window_s=0.0)
    _park(engine)
    before = REGISTRY.counter(labeled(
        "serve_slo_rejected", slo_class="bulk")).value
    flight.clear()
    try:
        engine.submit(_fresh_expr(30), tenant="b")
        engine.submit(_fresh_expr(31), tenant="b")
        with pytest.raises(Backpressure):
            engine.submit(_fresh_expr(32), tenant="b")
        assert REGISTRY.counter(labeled(
            "serve_slo_rejected", slo_class="bulk")).value == before + 1
        rejected = [r for r in st_t.flightrec()["requests"].values()
                    if r.get("status") == "reject"]
        assert [r["reason"] for r in rejected] == ["slo_admission"]
        # an untracked tenant still has the full queue available
        engine.submit(_fresh_expr(33), tenant="other")
    finally:
        engine.stop()


def test_model_priced_predictive_shed():
    """A request whose calibrated price exceeds its remaining deadline
    is shed at pop time without taking a dispatch slot, and the
    rejection names the prediction."""
    assert FLAGS.serve_model_pricing is True
    ledger.ingest("ema-warm", {"map": 1.0}, 1.0)
    for _ in range(8):
        ledger.note_dispatch("ema-warm", "dispatch", 1.0)
    assert ledger.predict_service_s("ema-warm") == pytest.approx(
        1.0, rel=1e-6)

    engine = st_t.ServeEngine(workers=1, queue_max=4)
    try:
        doomed = engine_mod._Request(
            _fresh_expr(40), [], "t", 5.0, mesh_t.get_mesh())
        ledger.ingest(key_hash(doomed.plan_key),
                      {"map": 100.0}, 100.0)  # priced at ~100 s
        before = REGISTRY.counter("serve_predicted_shed").value
        live = engine._shed_expired([doomed])
        assert live == []
        assert REGISTRY.counter(
            "serve_predicted_shed").value == before + 1
        with pytest.raises(DeadlineExceeded, match="predicted"):
            doomed.future.result(timeout=1)

        ok = engine_mod._Request(
            _fresh_expr(41), [], "t", 5.0, mesh_t.get_mesh())
        ledger.ingest(key_hash(ok.plan_key), {"map": 0.001}, 0.001)
        assert engine._shed_expired([ok]) == [ok]
    finally:
        engine.stop()


def test_predictive_shed_requires_model_pricing():
    FLAGS.serve_model_pricing = False
    ledger.ingest("ema-warm", {"map": 1.0}, 1.0)
    for _ in range(8):
        ledger.note_dispatch("ema-warm", "dispatch", 1.0)
    engine = st_t.ServeEngine(workers=1, queue_max=4)
    try:
        req = engine_mod._Request(
            _fresh_expr(42), [], "t", 5.0, mesh_t.get_mesh())
        ledger.ingest(key_hash(req.plan_key), {"map": 100.0}, 100.0)
        # only already-expired deadlines shed without model pricing
        assert engine._shed_expired([req]) == [req]
    finally:
        engine.stop()


def test_served_latency_feeds_the_slo_class():
    FLAGS.serve_slo_classes = "gold=60.0@0.9"
    FLAGS.serve_slo_tenants = "g=gold"
    with st_t.ServeEngine(workers=1, batch_window_s=0.0) as eng:
        for i in range(3):
            eng.submit(_fresh_expr(50 + i).sum(),
                       tenant="g").result(timeout=WAIT_S)
    rec = slo.burn_rates()["gold"]
    assert rec["window"] == 3 and rec["violation_rate"] == 0.0


# -- the sampled profiler's stamp (tests/test_profile.py's flight case) -----


def _kstep(pts, c, k=8):
    from spartan_tpu_torch.examples.kmeans import kmeans_step
    from spartan_tpu_torch.expr.base import ValExpr

    return kmeans_step(pts, ValExpr(c), k)


def test_sampled_requests_stamped_in_flight_recorder():
    rng = np.random.RandomState(4)
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        pts = st_t.from_numpy(rng.rand(128, 16).astype(np.float32))
        c0 = st_t.as_expr(rng.rand(8, 16).astype(np.float32)).evaluate()
        ref = np.asarray(_kstep(pts, c0).evaluate().glom())
        _kstep(pts, c0).evaluate()  # warm: the served walks all hit

        flight.clear()
        FLAGS.profile_sample_every = 1
        eng = st_t.ServeEngine(workers=2, coalesce_requests=False)
        with eng:
            futs = [eng.submit(_kstep(pts, c0)) for _ in range(4)]
            outs = [np.asarray(f.glom(timeout=WAIT_S)) for f in futs]
        FLAGS.profile_sample_every = 0
    for out in outs:
        np.testing.assert_array_equal(ref, out)
    rec = st_t.flightrec()
    stamped = [rec["requests"][f.rid] for f in futs
               if "profiled" in rec["requests"][f.rid]]
    assert stamped
    p = stamped[0]["profiled"]
    assert p["tier"] in ("replay", "capture")
    assert p["device_s"] >= 0
    # the skew observatory rode the same sample
    assert all("skew" in q["events"] for q in stamped)
    assert skew_t.current()
