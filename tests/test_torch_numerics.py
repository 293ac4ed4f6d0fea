"""The port's numerics sentinel (``obs/numerics.py``) against the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through ``st.audit`` in both
packages on the 4x2, 8x1 and 2x4 logical meshes: the health words must
agree exactly — NaN and Inf counts, absmax, zero fraction (the JAX
package's float32 mean is the correctly rounded float32 quotient of the
exact counts, which the port reproduces), size — record by record in
topological order, and name a first bad node of the same type. absmax is
compared only where no NaN is present (C12: the JAX package's max does
not carry NaN reliably). ``array_health`` and ``tile_stats`` agree on
every mesh; ``loop_health`` norms agree within 1e-6 relative, and
``early_exit`` stops at the JAX package's iteration for a loop that
diverges to inf and for one that stalls (thresholds far from any norm).
"""

import contextlib
import json
import os

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.obs import numerics as num_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu_torch.obs import numerics as num_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.utils import profiling as prof_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)

MESHES = [(4, 2), (8, 1), (2, 4)]
REL = 1e-6


@pytest.fixture(autouse=True)
def _clean_state():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)
    for N in (num_j, num_t):
        for wp in N.watchpoints():
            N.unwatch(wp)
        with N._lock:
            N._loop_series.clear()
    FLAGS_T.audit_numerics = False
    FLAGS_T.dispatch_timeout_s = 0.0


@contextlib.contextmanager
def _meshes(shape):
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)), \
            mesh_t.use_mesh(mesh_t.build_mesh(shape)):
        yield


def _data(seed=0, nan=False, zeros=True):
    a = np.random.RandomState(seed).rand(16, 8).astype(np.float32)
    if zeros:
        a[3, 2] = a[5, 5] = a[9, 1] = 0.0
    if nan:
        a[2, 3] = np.nan
    return a


# -- DAGs (each builds from one numpy array) --------------------------------


def ratio(st, a):
    x = st.from_numpy(a)
    return ((x * 2.0 - 1.0) / (x + 0.5)).sum(axis=1)


def div_by_zero(st, a):
    # 1/x is +inf where x == 0: the Inf is born in this map
    x = st.from_numpy(a)
    return (1.0 / x) * 0.5


def compare(st, a):
    x = st.from_numpy(a)
    return (x > 0.5).astype(np.int32) * 3


def dot_chain(st, a):
    x = st.from_numpy(a)
    return st.dot(st.transpose(x), x) - 1.0


DAGS = [ratio, div_by_zero, compare, dot_chain]


def _rec(r, nan_free):
    # a leaf's absmax is the same data's, exactly; a computed node's
    # values round differently in XLA and torch (a sum's order, a
    # product's FMA), so its absmax is held to REL below
    return (r["op"].split("(")[0], r["kind"], r["nan_count"],
            r["inf_count"], r["zero_frac"], r["size"],
            r["absmax"] if nan_free and r["kind"] == "leaf" else None,
            tuple(r["shape"]), r["dtype"])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("dag", DAGS, ids=lambda f: f.__name__)
def test_audit_words_match_jax(dag, nan, shape):
    a = _data(1, nan=nan)
    with _meshes(shape):
        rj = st_j.audit(dag(st_j, a))
        rt = st_t.audit(dag(st_t, a))
    nan_free = not any(r["any_nan"] for r in rj.records)
    assert [_rec(r, nan_free) for r in rt.records] == \
        [_rec(r, nan_free) for r in rj.records]
    if nan_free:
        for r_t, r_j in zip(rt.records, rj.records):
            if np.isfinite(r_j["absmax"]):
                assert abs(r_t["absmax"] - r_j["absmax"]) <= \
                    REL * r_j["absmax"]
            else:
                assert r_t["absmax"] == r_j["absmax"]
    assert rt.ok == rj.ok
    if rj.first_bad is not None:
        assert rt.first_bad["node"].split("#")[0] == \
            rj.first_bad["node"].split("#")[0]
        assert rt.first_bad["kind"] == rj.first_bad["kind"]
        assert rt.bad_count == rj.bad_count
    got_j = rj.result.glom() if hasattr(rj.result, "glom") else rj.result
    np.testing.assert_allclose(rt.result.glom(), np.asarray(got_j),
                               rtol=1e-5, equal_nan=True)


def test_planted_nan_names_the_leaf_and_its_tile():
    a = _data(2, nan=True)
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x = st_t.from_numpy(a)
        rep = st_t.audit(((x * 2.0) + 1.0).sum())
    fb = rep.first_bad
    assert fb["kind"] == "leaf" and fb["node"] == f"ValExpr#{x._id}"
    assert fb["nan_count"] == 1 and "test_torch_numerics" in fb["site"]
    bad = [t for t in rep.tile_stats if t["nan_count"]]
    assert len(bad) == 1 and bad[0]["index"] == \
        "(slice(0, 4, None), slice(0, 4, None))"
    with pytest.raises(FloatingPointError, match="first bad node ValExpr"):
        rep.raise_if_bad()
    assert "first bad" in str(rep)


def test_audit_on_a_plan_cache_hit_still_yields_words():
    a = _data(3)
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        ratio(st_t, a).glom()  # builds and caches the plan
        prof_t.reset_counters()
        rep = st_t.audit(ratio(st_t, a))
        assert prof_t.counters().get("plan_hits", 0) == 1
        assert prof_t.counters().get("plan_misses", 0) == 0
    assert len(rep.records) == 5 and rep.ok
    assert rep.records[-1]["op"] == "ReduceExpr"


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("nan", [False, True])
def test_array_health_and_tile_stats_match_jax(nan, shape):
    a = _data(4, nan=nan)
    with _meshes(shape):
        hj = num_j.array_health(st_j.from_numpy(a))
        ht = num_t.array_health(st_t.from_numpy(a))
        tj = num_j.tile_stats(st_j.from_numpy(a))
        tt = st_t.from_numpy(a).value.tile_health()
    if nan:
        hj.pop("absmax")
        ht.pop("absmax")
    assert ht == hj
    keys = ["index", "nan_count", "inf_count", "zero_frac", "size",
            "nbytes", "nnz"] + ([] if nan else ["absmax"])
    assert [{k: t[k] for k in keys} for t in tt] == \
        [{k: t[k] for k in keys} for t in tj]


# -- loop health -------------------------------------------------------------

W0 = np.linspace(0.5, 1.5, 8).astype(np.float32)


def _series(st, N, n, fn, **kw):
    """The loop's result and its one health series. The JAX package
    files a series under the label of the loop node its plan lowered —
    after a rewrite of the body (map fusion) not the user's loop — so its
    series is the one recorded during this run; the port files it under
    the user's loop's label."""
    with N._lock:
        N._loop_series.clear()
    item = st.loop(n, fn, st.from_numpy(W0), **kw)
    out = item.glom()
    if N is num_t:
        assert list(N.loop_health()) == [item.loop.label]
        return out, N.loop_health(item.loop.label)
    series = [s for s in N.loop_health().values() if s]
    assert len(series) == 1
    return out, series[0]


LOOPS = {
    # converges geometrically: the update norm halves each iteration
    "converge": (lambda w: w * 0.5, {"health": True}),
    # stalls: stops after the first update norm below 0.01 (update
    # norms 0.75, 0.375, ..., 0.0117, 0.0059: the eighth iteration)
    "stall": (lambda w: w * 0.5, {"early_exit": True, "stall_tol": 0.01}),
    # diverges to inf at the fifth iteration
    "diverge": (lambda w: w * 1e9, {"early_exit": True}),
    # a fixed point away from zero (a divide, not a multiply-add: XLA
    # contracts that into one FMA where torch rounds twice, and the
    # update norm's cancellation would magnify the last bit)
    "affine": (lambda w: w / 1.25 + 0.1, {"health": True}),
}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", sorted(LOOPS))
def test_loop_health_matches_jax(case, shape):
    fn, kw = LOOPS[case]
    with _meshes(shape):
        oj, sj = _series(st_j, num_j, 12, fn, **kw)
        ot, stt = _series(st_t, num_t, 12, fn, **kw)
    assert len(stt) == len(sj)
    assert [r["step"] for r in stt] == [r["step"] for r in sj]
    assert [r["finite"] for r in stt] == [r["finite"] for r in sj]
    for rt, rj in zip(stt, sj):
        for k in ("norm", "update_norm"):
            if np.isfinite(rj[k]):
                assert abs(rt[k] - rj[k]) <= REL * abs(rj[k])
            else:
                assert rt[k] == rj[k] or (np.isnan(rt[k])
                                          and np.isnan(rj[k]))
    np.testing.assert_array_equal(ot, np.asarray(oj))


def test_early_exit_returns_the_stopping_iterations_carries():
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        got, series = _series(st_t, num_t, 12, lambda w: w * 0.5,
                              early_exit=True, stall_tol=0.01)
        full = st_t.loop(len(series), lambda w: w * 0.5,
                         st_t.from_numpy(W0)).glom()
    assert len(series) == 8
    np.testing.assert_array_equal(got, full)


def test_health_reads_once_and_early_exit_once_per_iteration(monkeypatch):
    calls = []
    real = torch.Tensor.item

    def counted(self):
        calls.append(1)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "item", counted)
    with mesh_t.use_mesh(mesh_t.build_mesh((1, 1))):
        st_t.loop(9, lambda w: w * 0.5, st_t.from_numpy(W0),
                  health=True).glom()
        n_health = len(calls)
        del calls[:]
        st_t.loop(9, lambda w: w * 0.5, st_t.from_numpy(W0),
                  early_exit=True).glom()
    assert n_health == 0
    assert len(calls) == 9


def test_checkpointed_loop_ends_at_an_early_exit(tmp_path):
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        out = st_t.loop(12, lambda w: w * 0.5, st_t.from_numpy(W0),
                        checkpoint_every=3, checkpoint_path=str(tmp_path),
                        early_exit=True, stall_tol=0.01)
        ref = st_t.loop(8, lambda w: w * 0.5, st_t.from_numpy(W0)).glom()
    np.testing.assert_array_equal(out.glom(), ref)
    # segments of 3: the third stops on the stall after its second
    # iteration, the eighth
    assert out._resilience["segments"] == 3
    with open(os.path.join(str(tmp_path), "LATEST.json")) as f:
        assert json.load(f)["step"] == 8


# -- watchpoints, the watchdog and crash dumps ------------------------------


def test_watchpoint_fires_on_the_evaluate_that_poisons_it():
    a = _data(5)
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        arr = st_t.from_numpy(a).evaluate()
        wp = st_t.watch(arr, label="w")
        assert not wp.fired and wp.series[-1]["absmax"] == \
            pytest.approx(float(np.abs(a).max()))
        arr.tensor[0, 0] = float("nan")
        (st_t.from_numpy(a) + 1.0).glom()  # any evaluate polls it
        assert wp.fired and wp.series[-1]["nan_count"] == 1
        assert len(wp.series) == 2 and wp in num_t.watchpoints()
        wp.close()
        assert wp not in num_t.watchpoints()


def test_dump_crash_and_the_watchdog(tmp_path):
    path = str(tmp_path / "crash.json")
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        st_t.audit(ratio(st_t, _data(6)))
        st_t.loop(3, lambda w: w * 0.5, st_t.from_numpy(W0),
                  health=True).glom()
        num_t.dump_crash(path, reason="test", extra={"x": 1})
    with open(path) as f:
        doc = json.load(f)
    for key in ("inflight_spans", "recent_spans", "last_health",
                "loop_health", "watchpoints", "plan", "metrics", "ledger",
                "flags_nondefault"):
        assert key in doc
    assert doc["reason"] == "test" and doc["x"] == 1
    # the flight recorder's window and the continuous monitor's section
    # ride the dump (the JAX package's sections)
    assert set(doc["flightrec"]) == {"events", "requests", "tenants",
                                     "incremental"}
    assert set(doc["monitor"]) == {"health", "anomalies", "daemon",
                                   "series_tail"}
    assert doc["last_health"]["op"] == "ReduceExpr"
    assert num_t.watchdog("dispatch") is num_t._NULL_WD
    FLAGS_T.dispatch_timeout_s = 5.0
    wd = num_t.watchdog("dispatch", {"plan_key": "k"})
    assert isinstance(wd, num_t._Watchdog) and wd.timeout == 5.0
    with num_t.deadline_scope(0.5):
        assert num_t.watchdog("dispatch").timeout == 0.5
    FLAGS_T.crash_dump_path = path
    try:
        wd._fire()
    finally:
        FLAGS_T.crash_dump_path = ""
    with open(path) as f:
        assert "exceeded FLAGS.dispatch_timeout_s" in json.load(f)["reason"]


def test_guard_finite_raises_under_audit_only():
    num_t.guard_finite("g", float("nan"), "bad range %s")  # no session
    with mesh_t.use_mesh(mesh_t.build_mesh((1, 1))):
        x = st_t.from_numpy(_data(7))

        def guarded(v):
            num_t.guard_finite("g", v.max(), "range max %s is not finite")
            return v

        with pytest.raises(ValueError, match="range max nan"):
            st_t.audit(st_t.map(guarded, x / 0.0 * 0.0))


@pytest.mark.parametrize("inf", [False, True])
def test_histogram_range_guard_matches_jax(inf):
    # np.histogram raises on a non-finite autodetected range: both
    # packages raise the same message under st.audit, and give the same
    # counts on finite data (an Inf, not a NaN: C12, the JAX package's
    # sharded max drops NaN)
    a = np.random.RandomState(9).rand(256).astype(np.float32)
    if inf:
        a[17] = np.inf
    out = []
    with _meshes((8, 1)):
        for st in (st_j, st_t):
            try:
                rep = st.audit(st.histogram(st.from_numpy(a), 8)[0])
                out.append(("ok", np.asarray(rep.result.glom()).tolist()))
            except ValueError as e:
                out.append(("raised", str(e)))
    assert out[1] == out[0]
    assert out[0][0] == ("raised" if inf else "ok")


# -- a group mesh: each rank words its own block ---------------------------

_GROUP_CASES = r'''
import numpy as np
import spartan_tpu_torch as st
from spartan_tpu_torch.array.distarray import from_numpy
from spartan_tpu_torch.array.tiling import Tiling
from spartan_tpu_torch.obs import numerics as num


def run_cases(a):
    out = {}
    x = st.as_expr(from_numpy(a, tiling=Tiling(("x", None))))
    rep = st.audit(((x * 2.0 - 1.0) / (x + 0.5)).sum(axis=1))
    out["words"] = np.array([[r["nan_count"], r["inf_count"], r["absmax"],
                              r["zero_frac"], r["size"]]
                             for r in rep.records])
    out["first_bad"] = np.array(rep.first_bad["topo"]
                                if rep.first_bad else -1)
    for name, axes in (("row", ("x", None)), ("rep", (None, None))):
        h = num.array_health(from_numpy(a, tiling=Tiling(axes)))
        out["health_" + name] = np.array([h["nan_count"], h["absmax"],
                                          h["zero_frac"], h["size"]])
    w0 = from_numpy(np.nan_to_num(a[:, 0]) + 0.5, tiling=Tiling(("x",)))
    for name, kw in (("health", {"health": True}),
                     ("stall", {"early_exit": True, "stall_tol": 0.01})):
        item = st.loop(12, lambda w: w * 0.5, st.as_expr(w0), **kw)
        out["carry_" + name] = item.glom()
        out["norms_" + name] = np.array(
            [[r["norm"], r["update_norm"]]
             for r in num.loop_health(item.loop.label)])
    prof = st.profile(((x * 2.0) + 1.0).sum(axis=0), tier="replay")
    out["profile_nodes"] = np.array(sorted(n["node"].split("#")[0]
                                           for n in prof.nodes))
    return out
'''

_GROUP_CHILD = r"""
import os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import spartan_tpu_torch as st

st.set_default_device("cpu")
a = np.load(os.environ["INPUT"])
assert st.initialize_distributed() is True
mesh = st.get_mesh()
assert mesh.is_group
ns = {}
exec(os.environ["CASES"], ns)
out = ns["run_cases"](a)
st.shutdown()
np.savez(os.path.join(os.environ["OUT"], f"rank{mesh.rank}.npz"), **out)
print("CHILD_OK", mesh.rank, flush=True)
"""


def test_group_mesh_words_fold_over_the_ranks(tmp_path):
    """Two gloo CPU ranks, each holding its row block: the audit's words,
    array_health, the loop's series and the replay's node types equal
    the logical (2, 1) mesh's (the ranks' counts summed, absmax maxed,
    a replicated block counted once)."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    a = _data(8, nan=True)
    np.save(tmp_path / "a.npy", a)
    procs = []
    for rank in range(2):
        env = dict(os.environ, REPO=repo, INPUT=str(tmp_path / "a.npy"),
                   OUT=str(tmp_path), CASES=_GROUP_CASES,
                   COORDINATOR_ADDRESS=f"file://{tmp_path / 'store'}",
                   WORLD_SIZE="2", RANK=str(rank), OMP_NUM_THREADS="1")
        for key in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
            env.pop(key, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _GROUP_CHILD], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    ns = {}
    exec(_GROUP_CASES, ns)
    with mesh_t.use_mesh(mesh_t.build_mesh((2, 1))):
        want = ns["run_cases"](a)
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"CHILD_OK {rank}" in log, log[-3000:]
    for rank in range(2):
        got = dict(np.load(tmp_path / f"rank{rank}.npz"))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
