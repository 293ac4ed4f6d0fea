"""The port's continuous monitor (``obs/monitor.py``): the detector
matrix, the sampler and its time-series store, epoch fencing, the
autotune daemon's refit -> replan -> hysteresis-gated hot swap, and the
``st.status()`` / ``st.fleet_status()`` surfaces, on the CPU.

Each case of ``tests/test_monitor.py`` that no other port test covers
has its counterpart here (the six SLO and shedding cases are in
``tests/test_torch_flight.py``), and each runs the same inputs through
both packages: the JAX package on its 8x1 CPU mesh, the port on a
logical (8, 1) mesh. The anomalies (kind, key, value, threshold), the
detector streaks, the daemon's events and decisions, the status and
fleet sections must equal the JAX package's. The port's ticks take
their time from ``Monitor.sample``'s ``t`` argument; the JAX package's
read its trace clock, which no detector compares across packages. The
sampler-thread case waits on the monitor's ``ticked`` event with a
timeout; no test sleeps.
"""

import json
import types

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu_torch.parallel import mesh as mesh_t

torch.set_num_threads(1)

_SAVED = (
    "serve_slo_classes", "serve_slo_tenants", "serve_slo_window",
    "monitor", "monitor_interval_s", "monitor_window",
    "monitor_autotune", "monitor_drift_patience",
    "monitor_swap_margin", "monitor_cooldown_s",
    "monitor_burn_threshold", "monitor_fallback_rate",
    "monitor_fleet_dir", "cost_ledger", "cost_calibration",
    "cost_calibration_fingerprint", "calibration_drift_tol",
    "serve_model_pricing",
)


def _side(name):
    import importlib

    m = lambda sub: importlib.import_module(f"{name}.{sub}")  # noqa: E731
    return types.SimpleNamespace(
        jax=name == "spartan_tpu",
        st=st_j if name == "spartan_tpu" else st_t,
        monitor=m("obs.monitor"), ledger=m("obs.ledger"), slo=m("obs.slo"),
        skew=m("obs.skew"),
        trace=m("obs.trace"), explain=m("obs.explain"),
        metrics=m("obs.metrics"), mesh=m("parallel.mesh"),
        base=m("expr.base"), da=m("array.distarray"),
        tiling=m("array.tiling"), FLAGS=m("utils.config").FLAGS)


J = _side("spartan_tpu")
T = _side("spartan_tpu_torch")
SIDES = (J, T)


def _reset(P):
    P.monitor.MONITOR.stop()
    P.monitor.MONITOR.reset()
    P.ledger.set_profile(None)
    P.ledger.reset()
    P.slo.reset()
    P.skew.reset()  # an earlier test's imbalance record feeds a detector
    P.st.serve.shutdown_default()
    P.trace.clear()


@pytest.fixture(autouse=True)
def _setup():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    saved = {P.jax: {n: getattr(P.FLAGS, n) for n in _SAVED}
             for P in SIDES}
    for P in SIDES:
        P.FLAGS.cost_ledger = True
        _reset(P)
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=(8, 1))), \
            mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        yield
    for P in SIDES:
        _reset(P)
        for n, v in saved[P.jax].items():
            setattr(P.FLAGS, n, v)
    mesh_t.set_default_device(prev)


def _sample(P, t):
    """One tick: the port at the injected time ``t``, the JAX package at
    its trace clock (its ``sample`` takes no time)."""
    return P.monitor.sample() if P.jax else P.monitor.sample(t)


def _anoms(out):
    return [(a.kind, a.key, round(a.value, 6), round(a.threshold, 6))
            for a in out]


def _both(fn):
    """``fn(P)`` on each side; the two results must be equal."""
    got = [fn(P) for P in SIDES]
    assert got[1] == got[0]
    return got[1]


def _trace_names(P):
    return [s.name for s in P.trace.events()]


# -- the detector matrix --------------------------------------------------


def test_sustained_detector_patience_and_no_reemit():
    def run(P):
        P.FLAGS.monitor_drift_patience = 3
        d = P.monitor._SustainedDetector("test_kind")
        breach = {"k": (5.0, 1.0, True, "hot")}
        calm = {"k": (0.5, 1.0, False, "ok")}
        seq = [_anoms(d.feed(float(t), breach)) for t in range(5)]
        seq.append(_anoms(d.feed(5.0, calm)))
        seq.append(d.streak("k"))
        seq += [_anoms(d.feed(float(t), breach)) for t in range(6, 9)]
        return seq

    seq = _both(run)
    assert seq[2] == [("test_kind", "k", 5.0, 1.0)]
    assert seq[6] == 0 and len(seq[9]) == 1
    assert all(s == [] for i, s in enumerate(seq) if i not in (2, 6, 9))


def test_sustained_detector_oscillation_never_emits():
    def run(P):
        P.FLAGS.monitor_drift_patience = 2
        d = P.monitor._SustainedDetector("test_kind")
        return [_anoms(d.feed(float(i), {"k": (1.0, 1.0, i % 2 == 0,
                                               "flap")}))
                for i in range(10)]

    assert _both(run) == [[]] * 10


def test_fallback_detector_primes_then_spikes():
    def run(P):
        P.FLAGS.monitor_drift_patience = 1
        P.FLAGS.monitor_fallback_rate = 2.0
        d = P.monitor._FallbackDetector()
        return [_anoms(d.observe(float(t), {"serve_solo_fallbacks": v}))
                for t, v in enumerate((100, 105, 105, 106))]

    seq = _both(run)
    assert seq == [[], [("fallback_spike", "serve_solo_fallbacks", 5.0,
                         2.0)], [], []]


def test_backpressure_detector_needs_rejections_and_depth():
    def run(P):
        P.FLAGS.monitor_drift_patience = 1
        d = P.monitor._BackpressureDetector()
        return [_anoms(d.observe(0.0, 0, 0)),
                [a.kind for a in d.observe(1.0, 3, 2)],
                _anoms(d.observe(2.0, 0, 5))]

    assert _both(run) == [[], ["backpressure"], []]


def test_monitor_sample_emits_drift_anomaly():
    def run(P):
        P.FLAGS.calibration_drift_tol = 0.3
        P.FLAGS.monitor_drift_patience = 2
        for _ in range(6):
            P.ledger.note_service("drifting-plan", 0.5, 0.1)
        first = _anoms(_sample(P, 0.0))
        out = _sample(P, 1.0)
        a = out[0]
        series = P.monitor.MONITOR.store.series(
            "calibration_error_ratio:service_time")
        ctr = P.metrics.REGISTRY.counter(P.metrics.labeled(
            "monitor_anomalies_total", kind="calibration_drift")).value
        d = a.to_dict()
        return (first, _anoms(out),
                list(P.monitor.MONITOR.anomalies)[-1] is a,
                len(series.values()), ctr >= 1,
                "anomaly" in _trace_names(P),
                (d["kind"], d["value"] == round(a.value, 6)))

    r = _both(run)
    assert r[0] == [] and r[1][0][:2] == ("calibration_drift",
                                          "service_time")
    assert r[1][0][2] == pytest.approx(5.0, rel=0.01)
    assert r[2:] == (True, 2, True, True, ("calibration_drift", True))


def test_monitor_sample_emits_burn_anomaly():
    def run(P):
        P.FLAGS.serve_slo_classes = "gold=0.001@0.9"
        P.FLAGS.serve_slo_tenants = "hot=gold"
        P.FLAGS.monitor_burn_threshold = 1.0
        P.FLAGS.monitor_drift_patience = 1
        for _ in range(10):
            P.slo.observe("hot", 1.0)
        out = _anoms(_sample(P, 0.0))
        s = P.monitor.MONITOR.store.series("slo_burn_rate:gold")
        return out, round(s.latest(), 6)

    out, latest = _both(run)
    assert [a[:2] for a in out] == [("slo_burn", "gold")]
    assert latest == pytest.approx(10.0)


# -- epoch fencing --------------------------------------------------------


def test_epoch_fence_resets_streaks_and_templates():
    def run(P):
        P.FLAGS.calibration_drift_tol = 0.3
        P.FLAGS.monitor_drift_patience = 5
        for _ in range(4):
            P.ledger.note_service("drifting-plan", 0.5, 0.1)
        M = P.monitor.MONITOR
        _sample(P, 0.0)
        _sample(P, 1.0)
        streak = M.drift.streak("service_time")
        M.autotune.register("dead-digest", object())
        before = P.metrics.REGISTRY.counter("monitor_epoch_fences").value
        M._epoch_seen = P.mesh.mesh_epoch() - 1
        quiet = _sample(P, 2.0)
        return (streak, quiet, M._epoch_seen == P.mesh.mesh_epoch(),
                M.drift.streak("service_time"), M.autotune.templates(),
                P.metrics.REGISTRY.counter("monitor_epoch_fences").value
                - before, "monitor_epoch_fence" in _trace_names(P))

    assert _both(run) == (2, [], True, 0, {}, 1, True)


def test_notify_mesh_recovery_fences_immediately():
    def run(P):
        _sample(P, 0.0)
        P.monitor.MONITOR.autotune.register("dead-digest", object())
        P.monitor.notify_mesh_recovery()
        return (P.monitor.MONITOR.autotune.templates(),
                P.monitor.MONITOR._epoch_seen == P.mesh.mesh_epoch())

    assert _both(run) == ({}, True)


# -- the autotune daemon --------------------------------------------------


def _synthetic_rows(P, true_factors, rows=12, seed=7, scale=1e-6):
    rng = np.random.RandomState(seed)
    classes = sorted(true_factors)
    for i in range(rows):
        comp = {c: float(rng.uniform(10.0, 100.0)) for c in classes}
        measured = scale * sum(true_factors[c] * comp[c] for c in classes)
        P.ledger.ingest(f"syn-{i}", comp, measured)


def _events(P, kind=None):
    evs = list(P.monitor.MONITOR.autotune.events)
    return [e for e in evs if kind is None or e["event"] == kind]


def test_autotune_skip_reasons_and_hysteresis():
    def run(P):
        P.FLAGS.monitor_cooldown_s = 50.0
        auto = P.monitor.MONITOR.autotune
        out = [auto.attempt(0.0), _events(P, "skip")[-1]["reason"],
               auto.state, auto.in_cooldown(10.0)]
        _synthetic_rows(P, {"map": 1.0, "reshard": 4.0})
        out.append(auto.attempt(100.0))
        rev = _events(P, "revert")[-1]
        out += [rev["replanned"], P.ledger.active_profile(),
                P.FLAGS.cost_calibration,
                auto.last_rejected_fp == rev["fingerprint"],
                rev["fingerprint"]]
        out += [auto.attempt(200.0), _events(P, "skip")[-1]["reason"]]
        n = len(_events(P))
        auto.tick(210.0, [P.monitor.Anomaly("calibration_drift",
                                            "tiling_dp", 210.0, 5.0, 0.3,
                                            "test")])
        out += [auto.state, len(_events(P)) == n]
        auto.tick(1000.0, [])
        out.append(auto.state)
        return out

    r = _both(run)
    assert r[:4] == [None, "nothing_fittable", "cooldown", True]
    assert r[4:9] == ["revert", 0, None, False, True]
    assert r[10:] == [None, "recently_rejected", "cooldown", True, "idle"]


def _gemm(P, n, seed=11):
    rng = np.random.RandomState(seed)
    a = P.da.from_numpy(rng.rand(n, n).astype(np.float32),
                        tiling=P.tiling.row(2))
    b = P.da.from_numpy(rng.rand(n, n).astype(np.float32),
                        tiling=P.tiling.row(2))
    return lambda: P.st.dot(P.st.as_expr(a), P.st.as_expr(b))


def test_autotune_hot_swap_acceptance():
    def run(P):
        P.FLAGS.monitor_autotune = True
        P.FLAGS.monitor_swap_margin = 0.05
        build = _gemm(P, 96)
        key0 = P.base.plan_signature(build())[0]
        v0 = np.asarray(build().glom())
        registered = (P.explain.key_hash(key0)
                      in P.monitor.MONITOR.autotune.templates())
        _synthetic_rows(P, {"map": 1.0, "contraction": 1.0,
                            "reshard": 1.0, "psum": 10.0})
        decision = P.monitor.MONITOR.autotune.attempt(0.0)
        ev = _events(P, "swap")[-1]
        key1 = P.base.plan_signature(build())[0]
        v1 = np.asarray(build().glom())
        P.FLAGS.cost_calibration = False
        back = P.base.plan_signature(build())[0] == key0
        return ((registered, decision, round(ev["modeled_win"], 4),
                 ev["replanned"], ev["warmed"], bool(_events(P, "refit")),
                 P.FLAGS.monitor_autotune, key1 != key0,
                 "autotune_swap" in _trace_names(P), back), v0, v1)

    got = [run(P) for P in SIDES]
    assert got[1][0] == got[0][0]
    facts, v0, v1 = got[1]
    assert facts[:2] == (True, "swap") and facts[2] >= 0.05
    assert facts[3] >= 1 and facts[4] >= 1 and facts[5:] == (
        True, True, True, True, True)
    # the port's product keeps its bits under the new plan; both agree
    # with the JAX package's to a float32 sum's order
    assert np.array_equal(v0, v1)
    np.testing.assert_allclose(v1, got[0][2], rtol=1e-5)


def test_autotune_closed_loop_via_sample():
    def run(P):
        P.FLAGS.monitor_autotune = True
        P.FLAGS.monitor_drift_patience = 1
        P.FLAGS.monitor_cooldown_s = 0.0
        P.FLAGS.calibration_drift_tol = 0.3
        P.FLAGS.monitor_swap_margin = 0.05
        build = _gemm(P, 112, seed=12)
        v0 = np.asarray(build().glom())
        _synthetic_rows(P, {"map": 1.0, "contraction": 1.0,
                            "reshard": 1.0, "psum": 10.0}, seed=8)
        for _ in range(4):
            P.ledger.note_service("drifting-plan", 0.5, 0.1)
        out = _sample(P, 0.0)
        kinds = [e["event"] for e in _events(P)]
        status = P.st.status()
        v1 = np.asarray(build().glom())
        return ((any(a.kind == "calibration_drift" for a in out),
                 "refit" in kinds and "swap" in kinds,
                 status["daemon"]["state"],
                 bool([e for e in status["daemon"]["events"]
                       if e["event"] == "swap"]),
                 any(a["kind"] == "calibration_drift"
                     for a in status["anomalies"])), v0, v1)

    got = [run(P) for P in SIDES]
    assert got[1][0] == got[0][0] == (True, True, "cooldown", True, True)
    assert np.array_equal(got[1][1], got[1][2])


def test_autotune_no_swap_when_model_already_calibrated():
    def run(P):
        P.FLAGS.monitor_autotune = True
        P.FLAGS.monitor_swap_margin = 0.05
        build = _gemm(P, 80, seed=13)
        key0 = P.base.plan_signature(build())[0]
        build().glom()
        has = bool(P.monitor.MONITOR.autotune.templates())
        _synthetic_rows(P, {"map": 1.0, "contraction": 1.0,
                            "reshard": 1.0, "psum": 1.0}, seed=9)
        return (has, P.monitor.MONITOR.autotune.attempt(0.0),
                P.ledger.active_profile(), P.FLAGS.cost_calibration,
                P.base.plan_signature(build())[0] == key0)

    assert _both(run) == (True, "revert", None, False, True)


# -- surfaces -------------------------------------------------------------


def test_status_has_monitoring_sections_on_top_of_mesh_contract():
    def run(P):
        P.FLAGS.serve_slo_classes = "gold=0.5@0.99"
        P.st.serve.default_engine()
        s = P.st.status()
        return (sorted(k for k in s if k in (
                    "platform", "num_devices", "mesh", "process_index",
                    "memory_stats", "serve", "slo", "anomalies", "daemon",
                    "calibration", "skew", "integrity", "monitor")),
                "queue_depth" in s["serve"], "gold" in s["slo"],
                s["daemon"]["state"], s["calibration"]["enabled"],
                s["monitor"]["running"], isinstance(s["anomalies"], list))

    r = _both(run)
    assert len(r[0]) == 13 and r[1:] == (True, True, "idle", False, False,
                                         True)


def test_fleet_status_aggregates_ranks_and_skips_corrupt(tmp_path):
    def run(P):
        d = tmp_path / ("j" if P.jax else "t") / "fleet"
        P.FLAGS.monitor_fleet_dir = str(d)
        P.FLAGS.serve_slo_classes = "gold=0.001@0.9"
        P.FLAGS.serve_slo_tenants = "hot=gold"
        for _ in range(10):
            P.slo.observe("hot", 1.0)
        fs = P.st.fleet_status()
        out = [fs["fleet_dir"] == str(d), fs["ranks_reporting"],
               0 in fs["ranks"], fs["slo_worst"]["gold"]["rank"]]
        peer = {"rank": 1, "wall_t": 0.0,
                "status": {"slo": {"gold": {"burn_rate": 99.0}},
                           "anomalies": [{"kind": "slo_burn"}] * 3}}
        (d / "rank_1.json").write_text(json.dumps(peer))
        (d / "rank_2.json").write_text("{torn")
        fs = P.st.fleet_status()
        out += [fs["ranks_reporting"], fs["slo_worst"]["gold"],
                fs["anomalies_total"] >= 3]
        doc = json.loads((d / "rank_0.json").read_text())
        out.append(sorted(doc))
        P.FLAGS.monitor_fleet_dir = ""
        fs = P.st.fleet_status()
        out += [fs["fleet_dir"], 0 in fs["ranks"]]
        return out

    r = _both(run)
    assert r == [True, 1, True, 0, 2, {"burn_rate": 99.0, "rank": 1},
                 True, ["rank", "status", "wall_t"], None, True]


def test_monitor_thread_lifecycle_and_crash_section():
    def run(P):
        M = P.monitor.MONITOR
        P.FLAGS.monitor = True
        P.FLAGS.monitor_interval_s = 0.02
        P.monitor.start()
        try:
            if P.jax:  # the JAX package's monitor has no tick event
                deadline = 1000
                while M.health()["samples"] == 0 and deadline:
                    M._stop.wait(0.01)
                    deadline -= 1
            else:
                assert M.ticked.wait(30)
            h = M.health()
            running = (h["running"], h["samples"] >= 1)
        finally:
            P.monitor.stop()
        sec = P.monitor.crash_section()
        return (running, M.health()["running"], sorted(sec),
                sec["daemon"]["state"] in ("idle", "cooldown"))

    assert _both(run) == ((True, True), False,
                          ["anomalies", "daemon", "health", "series_tail"],
                          True)


def test_registry_snapshot_reset_is_atomic_and_keeps_keys():
    def run(P):
        R = P.metrics.REGISTRY
        R.counter("tmon_ctr", "test counter").inc(5)
        R.gauge("tmon_gauge", "test gauge").set(2.5)
        R.histogram("tmon_hist", "test histogram").observe(1.25)
        snap = R.snapshot(reset=True)
        snap2 = R.snapshot()
        m = P.st.metrics(reset=True)
        return (snap["counters"]["tmon_ctr"],
                snap["gauges"]["tmon_gauge"]["value"],
                snap["histograms"]["tmon_hist"]["count"],
                snap2["counters"]["tmon_ctr"],
                snap2["gauges"]["tmon_gauge"]["value"],
                snap2["histograms"]["tmon_hist"]["count"],
                "counters" in m)

    assert _both(run) == (5, 2.5, 1, 0, 0.0, 0, True)
