"""The port's device-time attribution profiler (``obs/profile.py``)
against the JAX package's, on the CPU.

On the CPU no device activity is recorded, so ``auto`` answers from the
replay tier in both packages: on the same DAG and logical mesh (4x2,
8x1, 2x4) the replay must attribute the same node types as the JAX
package's plan, and every node's seconds must be >= 0; on a stepped
clock, where each node's lowering costs a known time, the nodes must sum
to the measured walk exactly. The capture tier's join (device event -> CUPTI
correlation id -> launch -> innermost node range) is held on a recorded
trace document; on the card it runs in ``chip_smoke.py [obs]`` and
``tests/test_torch_cuda.py``. Sampled profiling must leave results
bit-equal and feed the ledger's device columns.
"""

import contextlib
import json

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu_torch.obs import ledger as ledger_t
from spartan_tpu_torch.obs import profile as profile_t
from spartan_tpu_torch.obs import trace as trace_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.utils import profiling as prof_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)

MESHES = [(4, 2), (8, 1), (2, 4)]
RNG = np.random.RandomState(0)
A = RNG.rand(64, 32).astype(np.float32)
B = RNG.rand(32, 16).astype(np.float32)


@pytest.fixture(autouse=True)
def _clean_state():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    profile_t.reset()
    ledger_t.reset()
    yield
    profile_t.reset()
    ledger_t.reset()
    FLAGS_T.profile_sample_every = 0
    FLAGS_T.profile_tier = "auto"
    mesh_t.set_default_device(prev)


@contextlib.contextmanager
def _meshes(shape):
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)), \
            mesh_t.use_mesh(mesh_t.build_mesh(shape)):
        yield


def dot_map_reduce(st):
    a, b = st.from_numpy(A), st.from_numpy(B)
    return (st.dot(a * 2.0, b) + 1.0).sum(axis=0)


def transpose_chain(st):
    a = st.from_numpy(A)
    return st.exp(st.transpose(a) - 0.5).max(axis=1)


def map_only(st):
    return st.from_numpy(A) * 3.0 - 1.0


DAGS = [dot_map_reduce, transpose_chain, map_only]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("dag", DAGS, ids=lambda f: f.__name__)
def test_replay_attributes_the_jax_node_types(dag, shape):
    with _meshes(shape):
        pj = st_j.profile(dag(st_j), tier="replay")
        pt = st_t.profile(dag(st_t))  # auto: no device activity here
    assert pt.tier == pj.tier == "replay"
    # the JAX package's replay attributes a node its sub-plan's time
    # minus its children's, clipped at zero, and drops a node whose
    # difference the timing noise zeroes; the port re-times each node's
    # own lowering, so it attributes every interior node of the plan:
    # the JAX plan's interior node types, which hold the JAX replay's
    types_t = sorted(n["node"].split("#")[0] for n in pt.nodes)
    types_j = sorted(n["node"].split("#")[0] for n in pj.nodes)
    plan_j = sorted(t["node"].split("#")[0]
                    for t in st_j.explain(dag(st_j)).tilings)
    assert types_t == plan_j
    assert set(types_j) <= set(plan_j)
    rep = st_t.explain(dag(st_t), cost=False)
    assert types_t == sorted(t["node"].split("#")[0] for t in rep.tilings)
    assert all(n["seconds"] >= 0 for n in pt.nodes)
    # the nodes and the walk are microsecond host timings taken apart
    # here: the sum against the wall is held on a stepped clock below
    assert pt.wall_s > 0 and pt.excess_s >= 0
    assert pt.attributed_s + pt.unattributed_s == pytest.approx(
        pt.wall_s + pt.excess_s, abs=1e-12)
    assert 0.0 < pt.attributed_fraction <= 1.0
    assert sum(n["share"] for n in pt.nodes) == pytest.approx(1.0, abs=1e-3)
    assert set(pt.class_seconds()) <= {"contraction", "map", "reduce",
                                       "transpose", "slice", "other"}
    assert all(n["digest"] for n in pt.nodes)


def test_capture_tier_raises_without_device_activity():
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        with pytest.raises(RuntimeError, match="no device activity"):
            st_t.profile(map_only(st_t), tier="capture")
        with pytest.raises(RuntimeError, match="no device activity"):
            st_t.profile(map_only(st_t), tier="xplane")  # the JAX name
        with pytest.raises(ValueError, match="unknown profile tier"):
            st_t.profile(map_only(st_t), tier="bogus")


def _trace_doc(first_walk_whole=False):
    """A capture's Chrome trace as torch.profiler writes it, two walks
    each under its anchor range. The first walk lost one launch's device
    record (as CUPTI can on the card) unless ``first_walk_whole``; the
    second holds two node ranges (one nested in the other) on the walking
    thread, launches with correlation ids, device events joined to them,
    runtime calls that put no work on the device (and have no device
    event), and one kernel whose launch lies outside every node range."""
    tid = {"pid": 7, "tid": 11}
    ev = [
        dict(ph="X", cat="user_annotation", name="st_profile_walk",
             ts=10.0, dur=60.0, **tid),
        dict(ph="X", cat="user_annotation",
             name="KMeansStepExpr#4__sg_bbbbbbbbbbbb", ts=12.0, dur=50.0,
             **tid),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=20.0,
             dur=5.0, args={"correlation": 8}, **tid),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=30.0,
             dur=5.0, args={"correlation": 9}, **tid),
        dict(ph="X", cat="kernel", name="small", ts=40.0,
             dur=4.0, pid=0, tid=7, args={"correlation": 8}),
        dict(ph="X", cat="user_annotation", name="st_profile_walk",
             ts=100.0, dur=900.0, **tid),
        dict(ph="X", cat="user_annotation",
             name="ReduceExpr#5__sg_aaaaaaaaaaaa", ts=110.0, dur=500.0,
             **tid),
        dict(ph="X", cat="user_annotation",
             name="KMeansStepExpr#4__sg_bbbbbbbbbbbb", ts=120.0, dur=100.0,
             **tid),
        dict(ph="X", cat="cuda_runtime", name="cudaFuncSetAttribute",
             ts=125.0, dur=1.0, args={"correlation": 10}, **tid),
        dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=130.0,
             dur=5.0, args={"correlation": 1}, **tid),
        dict(ph="X", cat="cuda_runtime", name="cudaGetLastError", ts=136.0,
             dur=1.0, args={"correlation": 11}, **tid),
        dict(ph="X", cat="cuda_runtime", name="cudaMemsetAsync", ts=300.0,
             dur=5.0, args={"correlation": 2}, **tid),
        dict(ph="X", cat="cuda_driver", name="cuLaunchKernel", ts=700.0,
             dur=5.0, args={"correlation": 3}, **tid),
        dict(ph="X", cat="kernel", name="kmeans_kernel", ts=200.0,
             dur=400.0, pid=0, tid=7, args={"correlation": 1}),
        dict(ph="X", cat="gpu_memset", name="Memset", ts=600.0, dur=10.0,
             pid=0, tid=7, args={"correlation": 2}),
        dict(ph="X", cat="kernel", name="stray", ts=800.0, dur=50.0,
             pid=0, tid=7, args={"correlation": 3}),
    ]
    if first_walk_whole:
        ev.append(dict(ph="X", cat="kernel", name="kmeans_kernel",
                       ts=45.0, dur=20.0, pid=0, tid=7,
                       args={"correlation": 9}))
    return {"traceEvents": ev}


def test_capture_join_attributes_to_the_innermost_range():
    # the first walk lost a device record: the second is attributed
    got = profile_t._parse_capture(_trace_doc())
    assert got["complete"] and got["walk"] == 1
    assert got["by_digest"] == {"bbbbbbbbbbbb": 400e-6,
                                "aaaaaaaaaaaa": 10e-6}
    assert got["by_kernel"]["bbbbbbbbbbbb"] == {"kmeans_kernel": 400e-6}
    assert got["wall_s"] == pytest.approx(650e-6)  # 200 .. 850 us
    assert got["anchor"] == 100.0
    assert [d["digest"] for d in got["events"]] == [
        "bbbbbbbbbbbb", "aaaaaaaaaaaa", None]
    # a whole first walk is the one attributed
    first = profile_t._parse_capture(_trace_doc(first_walk_whole=True))
    assert first["complete"] and first["walk"] == 0
    assert first["by_kernel"]["bbbbbbbbbbbb"] == {"small": 4e-6,
                                                  "kmeans_kernel": 20e-6}
    # no whole walk: the fullest one, marked incomplete
    doc = _trace_doc()
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if e.get("args", {}).get("correlation") != 2]
    doc["traceEvents"].append(dict(ph="X", cat="cuda_runtime",
                                   name="cudaMemsetAsync", ts=310.0,
                                   dur=5.0, pid=7, tid=11,
                                   args={"correlation": 2}))
    part = profile_t._parse_capture(doc)
    assert not part["complete"] and part["walk"] == 1
    assert profile_t._parse_capture({"traceEvents": []}) is None


# each lowering of a node of these classes advances the stepped clock by
# its cost (seconds)
_STEP_COST = {"MapExpr": 2e-3, "DotExpr": 5e-3, "ReduceExpr": 3e-3,
              "TransposeExpr": 1e-3}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("dag", DAGS, ids=lambda f: f.__name__)
def test_replay_nodes_sum_to_the_walk_on_a_stepped_clock(dag, shape,
                                                         monkeypatch):
    # the clock moves only when a node lowers: the walk is the plan's
    # nodes' costs, and each node's replay must be its own cost, none of
    # its children's, so the nodes sum to the measured walk exactly (a
    # replay that re-ran a child would pass the wall)
    from spartan_tpu_torch.expr import base as base_t

    clock = [0.0]
    monkeypatch.setattr(profile_t.trace_mod, "now", lambda: clock[0])
    lowered = []
    for cls in (c for c in _all_subclasses(base_t.Expr)
                if c.__name__ in _STEP_COST and "_lower" in vars(c)):
        def stepped(self, env, _real=vars(cls)["_lower"]):
            out = _real(self, env)
            clock[0] += _STEP_COST[type(self).__name__]
            lowered.append(type(self).__name__)
            return out

        monkeypatch.setattr(cls, "_lower", stepped)
    with mesh_t.use_mesh(mesh_t.build_mesh(shape)):
        prof = st_t.profile(dag(st_t), tier="replay")
    assert prof.nodes and lowered
    for n in prof.nodes:
        assert n["seconds"] == pytest.approx(
            _STEP_COST[n["node"].split("#")[0]], abs=1e-12), n
    assert prof.wall_s == pytest.approx(
        sum(_STEP_COST[n["node"].split("#")[0]] for n in prof.nodes),
        abs=1e-12)
    assert prof.attributed_s <= prof.wall_s + 1e-12
    assert prof.excess_s == pytest.approx(0.0, abs=1e-12)
    assert prof.attributed_fraction == pytest.approx(1.0)


def _all_subclasses(cls):
    out = []
    for c in cls.__subclasses__():
        out.append(c)
        out.extend(_all_subclasses(c))
    return out


def test_export_merges_host_spans_and_the_device_track(tmp_path):
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        trace_t.clear()
        prof = st_t.profile(dot_map_reduce(st_t))
        path = str(tmp_path / "merged.json")
        doc = st_t.profile_export(path)
    with open(path) as f:
        assert json.load(f) == doc
    names = {e["name"] for e in doc["traceEvents"]}
    assert "profile" in names  # the host span
    dev = [e for e in doc["traceEvents"] if e.get("tid") == 1_000_000
           and e["ph"] == "X"]
    assert len(dev) >= len(prof.nodes)
    # a capture's device events keep their times on the tracer clock
    cap = profile_t.DeviceProfile("capture", "d", 1e-3, [], events=[
        {"name": "k", "ts": 5.0, "dur": 2.0, "node": "X#1"}])
    evs = [e for e in cap.trace_events() if e["ph"] == "X"]
    assert evs == [{"name": "k", "ph": "X", "ts": 5.0, "dur": 2.0,
                    "pid": evs[0]["pid"], "tid": 1_000_000,
                    "args": {"node": "X#1"}}]


def test_profile_lands_on_the_report_and_the_ledger():
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        prof = st_t.profile(dot_map_reduce(st_t))
        rep = st_t.explain(dot_map_reduce(st_t))
    assert rep.device_profile["tier"] == "replay"
    assert rep.device_profile["plan"] == prof.plan_digest == rep.plan_key
    assert "device profile [replay]" in str(rep)
    ent = st_t.ledger()["plans"][rep.plan_key]
    assert ent["measured"]["device"]["samples"] == 1
    assert profile_t.last_profile() is prof


def test_sampled_profiling_is_bit_equal_and_feeds_the_ledger():
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        plain = [dot_map_reduce(st_t).glom() for _ in range(2)]
        FLAGS_T.profile_sample_every = 2
        prof_t.reset_counters()
        sampled = [dot_map_reduce(st_t).glom() for _ in range(4)]
        rep = st_t.explain(dot_map_reduce(st_t), cost=False)
    for s in sampled:
        np.testing.assert_array_equal(s, plain[0])
    assert prof_t.counters().get("profile_samples", 0) == 2
    assert prof_t.counters().get("profile_sample_errors", 0) == 0
    dev = st_t.ledger()["plans"][rep.plan_key]["measured"]["device"]
    assert dev["samples"] == 2 and dev["tier"] == "replay"
    fit = ledger_t.fit_profile()
    assert fit is not None and fit.meta["source"] == "device_time"
    assert profile_t.take_last_sample()["tier"] == "replay"
    assert profile_t.take_last_sample() is None


def test_an_evaluated_root_is_reprofiled_from_its_lineage():
    with mesh_t.use_mesh(mesh_t.build_mesh((2, 4))):
        e = dot_map_reduce(st_t)
        want = e.glom()
        prof = st_t.profile(e, reps=1)
        assert prof.nodes and e._result is None
        np.testing.assert_array_equal(e.glom(), want)
