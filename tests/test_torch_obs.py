"""The port's spans and metrics against the JAX package, on the CPU.

One plan-cache miss and one hit through each package must give the
same hit/miss counts, the same span names for the phases both packages
have, the same Prometheus text for the same instruments and a Chrome
trace of the same schema. Phases the port lacks, and why:

* ``compile``: torch runs eagerly, so a plan's first walk is a
  ``dispatch`` like every later one (and ``plan_cache_stats()`` counts
  no compiles);
* ``verify``: the JAX package's pass checker (``analysis/passes.py``,
  on under its test suite) is not ported (ROADMAP A4);
* ``memory_model``: the memory governor's peak model
  (``resilience/memory.py``) is not ported (ROADMAP A5).
"""

import importlib
import json
import os

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.obs import trace as trace_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.utils import profiling as prof_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J
from spartan_tpu_torch.obs import trace as trace_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.utils import profiling as prof_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

# the modules (each obs package exports a function ``metrics``)
metrics_j = importlib.import_module("spartan_tpu.obs.metrics")
metrics_t = importlib.import_module("spartan_tpu_torch.obs.metrics")

torch.set_num_threads(1)

_PORT_LACKS = {"compile", "verify", "memory_model"}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)


def _expr(st, a, b):
    x, y = st.from_numpy(a), st.from_numpy(b)
    return (st.dot(x * 2.0 + 1.0, st.transpose(y)) - 0.5).sum(axis=0)


def _miss_and_hit(st, prof, trace, mesh_ctx):
    """Spans and counters of one miss and one hit of the same
    structure (fresh leaves each time)."""
    rng = np.random.RandomState(0)
    a, b = rng.rand(16, 8).astype(np.float32), rng.rand(16, 8).astype(
        np.float32)
    c = rng.rand(16, 8).astype(np.float32)
    with mesh_ctx:
        # another structure first: first-use registrations happen there
        st.from_numpy(c).sum().glom()
        prof.reset_counters()
        trace.clear()
        miss = _expr(st, a, b)
        miss.glom()
        names_miss = [s.name for s in trace.events()]
        trace.clear()
        hit = _expr(st, b, a)
        hit.glom()
        names_hit = [s.name for s in trace.events()]
        stats = prof.plan_cache_stats()
    return names_miss, names_hit, stats


def _jax_mesh():
    return mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=(4, 2)))


def _port_mesh():
    return mesh_t.use_mesh(mesh_t.build_mesh((4, 2)))


def test_one_miss_one_hit_same_stats_and_span_names():
    miss_j, hit_j, stats_j = _miss_and_hit(st_j, prof_j, trace_j,
                                           _jax_mesh())
    miss_t, hit_t, stats_t = _miss_and_hit(st_t, prof_t, trace_t,
                                           _port_mesh())
    assert stats_t.keys() == stats_j.keys()
    for k in ("plan_hits", "plan_misses", "hit_rate",
              "donated_dispatches"):
        assert stats_t[k] == stats_j[k], k
    assert (stats_t["plan_hits"], stats_t["plan_misses"]) == (1, 1)
    assert stats_j["compiles"] >= 1 and stats_t["compiles"] == 0
    # the JAX package's first run is a "compile"; the port's a dispatch
    want_miss = ["dispatch" if n == "compile" else n for n in miss_j
                 if n not in ("verify", "memory_model")]
    assert miss_t == want_miss
    assert hit_t == [n for n in hit_j if n not in _PORT_LACKS]
    for name in ("evaluate", "sign", "optimize", "pass:auto_tiling",
                 "tiling", "build", "dispatch", "fetch"):
        assert name in miss_t
    assert set(miss_j) - set(miss_t) <= _PORT_LACKS


def test_evaluate_span_carries_cache_status_and_site():
    with _port_mesh():
        trace_t.clear()
        e = st_t.from_numpy(np.ones((8, 4), np.float32)) + 1.0
        e.glom()
    ev = [s for s in trace_t.events() if s.name == "evaluate"][-1]
    assert ev.args["cache"] in ("hit", "miss")
    assert ev.args["root"].startswith("MapExpr#")
    assert __file__ in ev.args["site"]


def _fill(reg):
    reg.counter("plan_hits", "plan-cache hits").inc(3)
    reg.counter(metrics_j.labeled("serve_requests", tenant='a"b\\c')).inc()
    reg.counter(metrics_j.labeled("serve_requests", tenant="z")).inc(2)
    g = reg.gauge("device_bytes_in_use", "bytes in use")
    g.set(10.0)
    g.set(4.0)
    h = reg.histogram("phase:sign", "signing seconds")
    for v in (0.5, 0.25, 1.0, 0.125):
        h.observe(v)
    reg.histogram(metrics_j.labeled("latency", slo="gold")).observe(2.0)


def test_same_instruments_give_the_same_prometheus_text_and_snapshot():
    rj, rt = metrics_j.Registry(), metrics_t.Registry()
    _fill(rj)
    _fill(rt)
    assert rt.prometheus() == rj.prometheus()
    assert rt.snapshot() == rj.snapshot()
    assert rt.snapshot(reset=True) == rj.snapshot(reset=True)
    assert rt.snapshot() == rj.snapshot()  # zeroed, same keys
    for key in ('serve_requests{tenant="a\\"b\\\\c"}', "plan_hits",
                'latency{slo="gold"}'):
        base, labels = metrics_t.parse_labels(key)
        assert (base, labels) == metrics_j.parse_labels(key)
        assert metrics_t.labeled(base, **labels) == key


def test_metrics_snapshot_shape_matches_jax():
    with _port_mesh():
        (st_t.from_numpy(np.ones(8, np.float32)) * 2.0).glom()
    with _jax_mesh():
        (st_j.from_numpy(np.ones(8, np.float32)) * 2.0).glom()
    sj, stt = st_j.metrics(), st_t.metrics()
    assert stt.keys() == sj.keys()
    assert stt["plan_cache"].keys() == sj["plan_cache"].keys()
    text = st_t.metrics(fmt="prometheus")
    assert "# TYPE spartan_evaluations counter" in text
    with pytest.raises(ValueError, match="unknown metrics format"):
        st_t.metrics(fmt="xml")
    assert metrics_t.device_memory_aggregate() == {}  # no card here
    assert prof_t.device_memory_stats() == {}


def _schema(doc):
    evs = doc["traceEvents"]
    return (sorted(doc), doc["displayTimeUnit"],
            sorted({tuple(sorted(e)) for e in evs}),
            sorted({e["ph"] for e in evs}),
            sorted({type(e[k]).__name__ for e in evs
                    for k in ("ts", "dur", "pid", "tid")}),
            all("depth" in e["args"] for e in evs))


def test_chrome_trace_has_the_jax_schema(tmp_path):
    trace_j.clear()
    trace_t.clear()
    _miss_and_hit(st_j, prof_j, trace_j, _jax_mesh())
    _miss_and_hit(st_t, prof_t, trace_t, _port_mesh())
    pj, pt = tmp_path / "jax.json", tmp_path / "port.json"
    dj = trace_j.export(str(pj))
    dt = st_t.trace_export(str(pt))
    assert _schema(json.loads(pt.read_text())) == _schema(dt)
    assert _schema(dt) == _schema(dj)
    assert json.loads(pt.read_text())["traceEvents"]
    st_t.trace_export(clear_after=True)
    assert st_t.trace_events() == []


def test_span_errors_ring_wrap_instants_and_inflight():
    trace_t.clear()
    with pytest.raises(KeyError):
        with st_t.span("outer", tag=1):
            with st_t.span("inner") as sp:
                sp.set(k="v")
                assert [s["name"] for s in trace_t.inflight()] == [
                    "outer", "inner"]
                raise KeyError("boom")
    inner, outer = trace_t.events()[-2:]
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.error and inner.args == {"k": "v", "exc": "KeyError"}
    assert outer.args["tag"] == 1 and outer.depth == 0 and inner.depth == 1
    assert trace_t.inflight() == []
    trace_t.instant("mark", error=True, why="x")
    assert trace_t.events()[-1].name == "mark"
    prev = FLAGS_T.trace_ring
    FLAGS_T.trace_ring = 4
    try:
        for i in range(10):
            with st_t.span(f"s{i}"):
                pass
        assert [s.name for s in trace_t.events()] == ["s6", "s7", "s8",
                                                      "s9"]
    finally:
        FLAGS_T.trace_ring = prev
    FLAGS_T.trace = False
    try:
        trace_t.clear()
        with st_t.span("off") as sp:
            sp.set(a=1)
        assert trace_t.events() == []
    finally:
        FLAGS_T.trace = True


def test_metrics_flag_gates_the_profiling_layer():
    prof_t.reset_counters()
    FLAGS_T.metrics = False
    try:
        prof_t.count("plan_hits")
        prof_t.record_phase("sign", 1.0)
    finally:
        FLAGS_T.metrics = True
    assert prof_t.counters().get("plan_hits", 0) == 0
    assert prof_t.phase_seconds().get("sign", 0.0) == 0.0
    with prof_t.phase("sign") as sp:
        pass
    assert prof_t.phase_seconds()["sign"] == pytest.approx(sp.seconds)
    with prof_t.stopwatch() as sw:
        pass
    assert sw.elapsed >= 0.0
    res = prof_t.benchmark(lambda: None, iters=3)
    assert res["iters"] == 3 and res["best"] <= res["mean"] + 1e-12


def test_xla_readouts_raise_naming_the_roadmap_item():
    e = st_t.from_numpy(np.ones(4, np.float32)) + 1.0
    for fn in (prof_t.cost_analysis, prof_t.hlo_text):
        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            fn(e)


def test_profile_trace_and_annotations_capture_on_the_cpu(tmp_path):
    with prof_t.profile_trace(str(tmp_path)) as p:
        assert trace_t.profiler_active()
        with prof_t.annotate("user_range"):
            (st_t.from_numpy(np.ones((8, 4), np.float32)) * 3.0).glom()
    assert not trace_t.profiler_active()
    names = {evt.key for evt in p.key_averages()}
    assert "user_range" in names
    assert any(n.startswith("MapExpr#") for n in names)  # node ranges
    files = os.listdir(tmp_path)
    assert files and json.loads((tmp_path / files[0]).read_text())


def test_loop_span_and_per_step_spans():
    trace_t.clear()
    FLAGS_T.trace_loop_steps = True
    try:
        w = st_t.loop(5, lambda w: w + 1.0,
                      st_t.from_numpy(np.zeros(4, np.float32)))
        np.testing.assert_array_equal(w.glom(), np.full(4, 5.0))
    finally:
        FLAGS_T.trace_loop_steps = False
    evs = trace_t.events()
    steps = [s for s in evs if s.name == "loop_step"]
    assert [s.args["step"] for s in steps] == [0, 1, 2, 3, 4]
    loops = [s for s in evs if s.name == "loop"]
    assert len(loops) == 1 and loops[0].args["n"] == 5


def test_checkpointed_loop_counts_and_spans_match_jax(tmp_path):
    c0 = np.zeros(4, np.float32)

    def run(st, prof, trace, path):
        prof.reset_counters()
        trace.clear()
        st.loop(6, lambda w: w + 1.0, st.from_numpy(c0),
                checkpoint_every=2, checkpoint_path=str(path))
        out = st.loop(8, lambda w: w + 1.0, st.from_numpy(c0),
                      checkpoint_every=2, checkpoint_path=str(path),
                      resume=str(path))
        c = prof.counters()
        names = {s.name for s in trace.events()}
        return np.asarray(out.glom()), {
            k: c.get(k, 0) for k in ("resilience_loop_checkpoints",
                                     "resilience_loop_resumes",
                                     "resilience_loop_restores")}, names

    with _jax_mesh():
        vj, cj, nj = run(st_j, prof_j, trace_j, tmp_path / "jax")
    with _port_mesh():
        vt, ct, nt = run(st_t, prof_t, trace_t, tmp_path / "port")
    np.testing.assert_array_equal(vt, vj)
    assert ct == cj and ct["resilience_loop_checkpoints"] > 0
    for name in ("ckpt_loop", "loop_segment", "loop_checkpoint"):
        assert name in nt and name in nj


def test_flags_have_the_jax_defaults():
    for name in ("opt_auto_tiling", "tiling_compute_weight",
                 "tiling_flop_weight", "tiling_operand_move_weight",
                 "tiling_memory_weight", "trace", "trace_ring", "metrics",
                 "metrics_hist_window", "trace_annotations",
                 "trace_loop_steps", "redistribution_planner",
                 "shard_loop_carries", "shard_carry_min_bytes"):
        assert getattr(FLAGS_T, name) == getattr(FLAGS_J, name), name
