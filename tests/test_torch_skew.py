"""The port's shard-level skew observatory (``obs/skew.py``), on the CPU.

Each case of ``tests/test_skew.py`` has its counterpart here, on a
logical (8, 1) mesh with the deliberately skewed array (its first row
block dense, the rest zero). The JAX file's four monitor and
status-line cases check the JAX package's monitor; the port's monitor is
not written yet, so their counterparts check the skew state those
surfaces read (``current``, ``worst_current``, ``reset``) against the
JAX package's for the same records.

Against the JAX package, exactly:

* ``data_skew`` of the same numpy arrays on 4x2 and 8x1 under row,
  column, block and replicated tilings (shards, the size/bytes/nnz
  ratios, the byte total and the hottest block's position);
* ``time_skew`` of one synthetic profile, with and without an audit's
  straggler-edge join.

And the per-position seconds: one entry for the card on a 1x1 mesh, the
per-block replay's eight on (8, 1), and on a gloo group of two CPU
processes each rank's seconds folded with one gather (both ranks report
both ranks' seconds, equal on each).
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import spartan_tpu as st_j
from spartan_tpu.analysis import plan_audit as plan_audit_j
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.obs import ledger as ledger_j
from spartan_tpu.obs import skew as skew_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J

import spartan_tpu_torch as st_t
from spartan_tpu_torch.analysis import plan_audit as plan_audit_t
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.expr import base
from spartan_tpu_torch.obs import ledger
from spartan_tpu_torch.obs import numerics
from spartan_tpu_torch.obs import profile as profile_t
from spartan_tpu_torch.obs import skew as skew_mod
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.utils.config import FLAGS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 150


@pytest.fixture(autouse=True)
def _setup():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    saved = {n: getattr(FLAGS, n) for n in (
        "profile_sample_every", "profile_tier", "skew_warn_ratio",
        "cost_ledger")}
    saved_j = {n: getattr(FLAGS_J, n) for n in ("cost_ledger",)}
    FLAGS.cost_ledger = True
    FLAGS.profile_sample_every = 0
    for mod in (skew_mod, skew_j):
        mod.reset()
    profile_t.reset()
    ledger.set_profile(None)
    ledger.reset()
    st_t.serve.shutdown_default()
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        yield
    st_t.serve.shutdown_default()
    for mod in (skew_mod, skew_j):
        mod.reset()
    profile_t.reset()
    ledger.set_profile(None)
    ledger.reset()
    for n, v in saved.items():
        setattr(FLAGS, n, v)
    for n, v in saved_j.items():
        setattr(FLAGS_J, n, v)
    mesh_t.set_default_device(prev)


def _skewed_np(n=64, d=32):
    x = np.zeros((n, d), np.float32)
    x[: n // 8] = 1.5  # exactly the rows of block 0 on the 8x1 mesh
    return x


def _skewed_array(n=64, d=32):
    """Row-tiled array whose FIRST block is dense and the rest all zero:
    every per-block nnz walk must name position 0's block the hottest
    (nnz ratio == positions)."""
    return st_t.from_numpy(_skewed_np(n, d), tiling=tiling_t.row(2))


# -- per-block stats: the block walk ---------------------------------------


def test_per_shard_stats_superset_of_tile_stats():
    arr = _skewed_array().evaluate()
    via_skew = skew_mod.per_shard_stats(arr)
    assert via_skew == numerics.tile_stats(arr) == arr.tile_health()
    assert len(via_skew) == 8  # one record per position
    for rec in via_skew:
        for k in ("device", "index", "nan_count", "inf_count",
                  "absmax", "zero_frac", "size", "nbytes", "nnz"):
            assert k in rec
    nnzs = sorted(r["nnz"] for r in via_skew)
    assert nnzs[-1] == 64 * 32 // 8 and sum(nnzs[:-1]) == 0


def test_data_skew_names_dense_shard():
    arr = _skewed_array().evaluate()
    rec = skew_mod.data_skew(arr, label="x")
    assert rec["shards"] == 8
    assert rec["nnz_ratio"] == pytest.approx(8.0)
    assert rec["size_ratio"] == pytest.approx(1.0)  # even split
    dense = max(skew_mod.per_shard_stats(arr), key=lambda r: r["nnz"])
    assert rec["hottest"] == dense["device"] == "cpu/shard0"
    assert rec["tiling"] == str(arr.tiling)


_DATA_CASES = [((8, 1), "row"), ((8, 1), "col"), ((4, 2), "row"),
               ((4, 2), "col"), ((4, 2), "block"), ((4, 2), "rep")]


@pytest.mark.parametrize("shape,layout", _DATA_CASES)
def test_data_skew_matches_jax_package(devices, shape, layout):
    rng = np.random.RandomState(3)
    x = rng.rand(32, 24).astype(np.float32)
    x[x < 0.6] = 0.0
    x[:5] = 2.0  # a dense corner
    make = {"row": "row", "col": "col", "block": "block",
            "rep": "replicated"}[layout]
    mj = mesh_j.build_mesh(devices, shape=shape)
    with mesh_j.use_mesh(mj):
        aj = st_j.from_numpy(x, tiling=getattr(tiling_j, make)(2)).evaluate()
        rj = skew_j.data_skew(aj, "x")
        devs_j = [r["device"] for r in skew_j.per_shard_stats(aj)]
    with mesh_t.use_mesh(mesh_t.build_mesh(shape)):
        at = st_t.from_numpy(x, tiling=getattr(tiling_t, make)(2)).evaluate()
        rt = skew_mod.data_skew(at, "x")
        devs_t = [r["device"] for r in skew_mod.per_shard_stats(at)]
    for k in ("leaf", "shape", "shards", "size_ratio", "bytes_ratio",
              "nnz_ratio", "bytes_total"):
        assert rt[k] == rj[k], k
    assert devs_t.index(rt["hottest"]) == devs_j.index(rj["hottest"])


# -- the acceptance criterion: attribution on a skewed workload ------------


def test_skew_report_names_hottest_shard_and_straggler():
    x = _skewed_array()
    rep = st_t.skew(st_t.dot(x.T, x).sum() + x.sum())
    d = rep.to_dict()
    assert isinstance(rep, st_t.SkewReport)
    assert len(d["device_totals"]) == 8
    assert d["hottest_shard"] is not None
    assert d["hottest_shard"]["device"] in d["device_totals"]
    assert d["imbalance_ratio"] is not None and d["imbalance_ratio"] >= 1
    assert d["nodes"], "per-node skew rows must exist on the 8x1 mesh"
    for row in d["nodes"]:
        assert row["straggler"] in d["device_totals"]
        assert row["devices"] >= 2 and row["wait_s"] >= 0
    data_rows = [r for r in d["data"] if r.get("nnz_ratio")]
    assert any(r["nnz_ratio"] == pytest.approx(8.0) for r in data_rows)
    # the audit's collectives joined to the waits: the dot's k-split
    # all-reduce is a straggler edge
    assert any("all-reduce" in e["kinds"] for e in d["straggler_edges"])
    text = str(rep)
    assert "shard skew" in text and "straggler" in text
    worst = skew_mod.worst_current()
    assert worst is not None and worst["plan"] == d["plan"]
    assert worst["ratio"] == d["imbalance_ratio"]


def test_skew_report_lands_in_explain():
    x = _skewed_array()
    expr = (st_t.as_expr(x) * 2.0).sum()
    st_t.skew(expr)
    text = str(st_t.explain(expr))
    assert "shard skew" in text
    assert "imbalance" in text


def test_skew_advisory_prices_retile_when_past_warn():
    """Past FLAGS.skew_warn_ratio the report carries the priced
    re-tiling suggestion (report-only; plan untouched)."""
    FLAGS.skew_warn_ratio = 1e-9  # any measured ratio trips it
    x = _skewed_array()
    key_before, _ = base.plan_signature(st_t.dot(x.T, x).sum())
    rep = st_t.skew(st_t.dot(x.T, x).sum())
    adv = rep.to_dict().get("advisory")
    assert adv is not None
    assert adv["src"] != adv["dst"]
    assert adv["modeled_cost"] is not None
    assert "ADVISORY" in str(rep)
    key_after, _ = base.plan_signature(st_t.dot(x.T, x).sum())
    assert key_before == key_after  # report-only: no plan mutation


def test_ledger_grows_skew_columns():
    x = _skewed_array()
    rep = st_t.skew((st_t.as_expr(x) + 1.0).sum())
    ent = ledger.snapshot()["plans"].get(rep.plan)
    assert ent is not None and ent["measured"]["skew"] is not None
    sk = ent["measured"]["skew"]
    assert sk["samples"] >= 1
    assert sk["imbalance_ratio_last"] == rep.imbalance_ratio
    assert sk["imbalance_ratio_max"] >= sk["imbalance_ratio_last"]
    assert sk["straggler_wait_mean_s"] >= 0


# -- the skew state the JAX package's monitor and status line read --------


def _seed(mod, digest="testplan00", ratio=3.2):
    mod._record(digest, {
        "t": 0.0, "imbalance_ratio": ratio, "straggler_wait_s": 0.01,
        "node": "dot#5", "hottest_shard": "cpu/shard0",
        "data_worst_ratio": 8.0})


def test_recorded_imbalance_matches_jax_skew_state():
    """The monitor's sustained-imbalance detector reads ``current()``:
    the same records give the same per-plan state in both packages, and
    the ledger's skew columns fill from them."""
    FLAGS_J.cost_ledger = True
    for mod in (skew_mod, skew_j):
        _seed(mod, ratio=3.2)
        _seed(mod, ratio=2.5)
    assert skew_mod.current() == skew_j.current()
    ent = ledger.snapshot()["plans"]["testplan00"]["measured"]["skew"]
    ent_j = ledger_j.snapshot()["plans"]["testplan00"]["measured"]["skew"]
    assert ent == ent_j
    assert ent["samples"] == 2 and ent["imbalance_ratio_max"] == 3.2
    ledger_j.reset()


def test_imbalance_below_warn_carries_no_advisory():
    FLAGS.skew_warn_ratio = 1e9
    x = _skewed_array()
    rep = st_t.skew(st_t.dot(x.T, x).sum())
    assert rep.to_dict()["advisory"] is None
    assert "ADVISORY" not in str(rep)
    assert rep.imbalance_ratio is not None  # measured, below the warning


def test_reset_clears_the_skew_state():
    _seed(skew_mod)
    skew_mod._tls.last_sample = {"plan": "x"}
    assert skew_mod.current()
    skew_mod.reset()
    assert skew_mod.current() == {}
    assert skew_mod.worst_current() is None
    assert skew_mod.take_last_sample() is None


def test_worst_current_matches_jax_status_line():
    """``st.status()``'s skew line (the JAX package) is ``worst_current``:
    the worst plan, the same in both packages."""
    for mod in (skew_mod, skew_j):
        assert mod.worst_current() is None  # nothing measured yet
        _seed(mod, "planA", ratio=2.0)
        _seed(mod, "planB", ratio=4.0)
    assert skew_mod.worst_current() == {"plan": "planB", "ratio": 4.0,
                                        "wait_s": 0.01, "node": "dot#5"}
    assert skew_mod.worst_current() == skew_j.worst_current()


# -- time skew: the fold, against the JAX package --------------------------


class _Prof:
    def __init__(self, nodes):
        self.nodes = nodes


_SYNTH = [
    {"node": "DotExpr#2", "digest": "d2", "op_class": "contraction",
     "seconds": 0.004, "device_seconds": {
         f"dev{i}": 0.001 * (1 + (i == 3) * 3) for i in range(8)}},
    {"node": "ReduceExpr#3", "digest": "d3", "op_class": "reduce",
     "seconds": 0.002, "device_seconds": {
         f"dev{i}": 0.0002 + 0.00001 * i for i in range(8)}},
    {"node": "MapExpr#4", "digest": "d4", "op_class": "map",
     "seconds": 0.001, "device_seconds": {"dev0": 0.001}},
    {"node": "MapExpr#5", "digest": "d5", "op_class": "map",
     "seconds": 0.001},
]
_AUDIT = {"collectives": [
    {"kind": "all-reduce", "node": "DotExpr#20", "bytes_moved": 4096.0,
     "operand_bytes": 4096, "group_size": 8},
    {"kind": "all-gather", "node": "ReduceExpr#30", "bytes_moved": 512.0,
     "operand_bytes": 64, "group_size": 8},
    {"kind": "all-reduce", "node": "DotExpr#20", "bytes_moved": 1024.0,
     "operand_bytes": 1024, "group_size": 8}], "findings": []}
_SCOPES = {"d2": {"node": "DotExpr#20"}, "d3": {"node": "ReduceExpr#30"}}


def test_time_skew_matches_jax_package():
    prof = _Prof([dict(n) for n in _SYNTH])
    plain_t = skew_mod.time_skew(prof)
    plain_j = skew_j.time_skew(_Prof([dict(n) for n in _SYNTH]))
    assert plain_t == plain_j
    assert plain_t["hottest_shard"]["device"] == "dev3"
    assert [r["node"] for r in plain_t["nodes"]] == ["DotExpr#2",
                                                     "ReduceExpr#3"]
    at = plan_audit_t.PlanAudit.from_dict(_AUDIT)
    aj = plan_audit_j.PlanAudit.from_dict(_AUDIT)
    edges_t = skew_mod.time_skew(prof, at, _SCOPES)
    edges_j = skew_j.time_skew(_Prof([dict(n) for n in _SYNTH]), aj,
                               _SCOPES)
    assert edges_t == edges_j
    assert edges_t["straggler_edges"][0]["kinds"] == {"all-reduce": 2}


# -- per-position seconds ----------------------------------------------------


def test_one_position_mesh_has_one_entry_for_the_card():
    rng = np.random.RandomState(5)
    with mesh_t.use_mesh(mesh_t.build_mesh((1, 1))):
        x = st_t.from_numpy(rng.rand(64, 32).astype(np.float32))
        prof = st_t.profile((x * 2.0).sum(), tier="replay")
    for n in prof.nodes:
        assert list(n["device_seconds"]) == ["cpu"]
        assert n["device_seconds"]["cpu"] == n["seconds"]
    assert skew_mod.time_skew(prof)["nodes"] == []  # nothing to compare


def test_per_block_replay_names_every_position():
    x = _skewed_array()
    prof = st_t.profile(st_t.dot(x.T, x).sum(), tier="replay")
    timed = [n for n in prof.nodes if n.get("device_seconds")]
    assert timed
    for n in timed:
        assert sorted(n["device_seconds"]) == sorted(
            f"cpu/shard{i}" for i in range(8))


# -- sampling: bit-equality + the serve stamp ------------------------------


def test_sampled_skew_bit_equal_and_same_plan_key():
    x = _skewed_array()

    def expr():
        return st_t.dot(x.T, x).sum()

    key_off, _ = base.plan_signature(expr())
    ref = expr().evaluate().glom()
    expr().evaluate()  # a warm walk: the sampler skips the first
    assert skew_mod.current() == {}  # sampling off: no skew state

    FLAGS.profile_sample_every = 1
    key_on, _ = base.plan_signature(expr())
    got = expr().evaluate().glom()
    FLAGS.profile_sample_every = 0

    assert key_on == key_off
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))
    cur = skew_mod.current()
    assert len(cur) == 1  # the sampled walk recorded its plan
    rec = next(iter(cur.values()))
    assert rec.get("data_worst_ratio") == pytest.approx(8.0)
    stamp = skew_mod.take_last_sample()
    assert stamp is not None and stamp["plan"] in cur
    assert skew_mod.take_last_sample() is None  # pop-once


# -- concurrency: tear-free skew_* gauges -----------------------------------


def test_skew_gauges_tear_free_under_8_threads():
    n_threads, reps = 8, 40
    barrier = threading.Barrier(n_threads + 1)
    errors = []

    def writer(k):
        barrier.wait()
        for i in range(reps):
            try:
                skew_mod._record(f"plan{k:02d}", {
                    "t": float(i), "imbalance_ratio": 1.0 + k,
                    "straggler_wait_s": 0.001 * k, "node": f"dot#{k}",
                    "hottest_shard": f"dev{k}",
                    "data_worst_ratio": None})
            except Exception as e:  # noqa: BLE001 - collected
                errors.append(e)

    threads = [threading.Thread(target=writer, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    barrier.wait()
    seen = set()
    for _ in range(2000):
        snap = st_t.metrics(reset=True)
        for name, g in snap["gauges"].items():
            if not name.startswith('skew_imbalance_ratio{plan="plan0'):
                continue
            seen.add(name)
            v = g["value"] if isinstance(g, dict) else g
            assert v in {0.0} | {1.0 + k for k in range(n_threads)}
        if len(seen) == n_threads:
            break
        time.sleep(0.001)
    for t in threads:
        t.join(timeout=60)
    assert errors == []
    assert len(seen) == n_threads

    for k in range(n_threads):
        skew_mod._record(f"plan{k:02d}", {
            "t": 0.0, "imbalance_ratio": 1.0 + k,
            "straggler_wait_s": 0.25, "node": f"dot#{k}",
            "hottest_shard": f"dev{k}", "data_worst_ratio": None})
    text = st_t.metrics(fmt="prometheus")
    assert "# HELP spartan_skew_imbalance_ratio " in text
    assert "# TYPE spartan_skew_imbalance_ratio gauge" in text
    assert "# TYPE spartan_skew_straggler_wait_s gauge" in text
    assert 'spartan_skew_imbalance_ratio{plan="plan03"} 4' in text
    assert skew_mod.worst_current()["plan"] == "plan07"


# -- a gloo group of two CPU processes: the cross-rank fold ---------------

_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import spartan_tpu_torch as st

st.set_default_device("cpu")
assert st.initialize_distributed() is True
mesh = st.get_mesh()
assert mesh.is_group
x = np.zeros((64, 32), np.float32)
x[:32] = 1.5  # rank 0's block dense
a = st.from_numpy(x, tiling=st.Tiling(("x", None)))
rep = st.skew((st.as_expr(a) * 2.0 + 1.0).sum(axis=1))
d = rep.to_dict()
st.shutdown()
with open(os.path.join(os.environ["OUT"], f"rank{mesh.rank}.json"),
          "w") as f:
    json.dump({"totals": d["device_totals"],
               "nodes": [{"node": n["node"], "ratio": n["ratio"],
                          "devices": n["devices"]} for n in d["nodes"]],
               "data": d["data"]}, f)
print("CHILD_OK", mesh.rank, flush=True)
"""


def test_group_ranks_fold_device_seconds(tmp_path):
    procs = []
    for rank in range(2):
        env = dict(os.environ, REPO=REPO, OUT=str(tmp_path),
                   COORDINATOR_ADDRESS=f"file://{tmp_path / 'store'}",
                   WORLD_SIZE="2", RANK=str(rank), OMP_NUM_THREADS="1")
        for key in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
            env.pop(key, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"CHILD_OK {rank}" in log, log[-3000:]
    got = []
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            got.append(json.load(f))
    # every rank reports both ranks' seconds, the same on each
    assert sorted(got[0]["totals"]) == ["cpu/rank0", "cpu/rank1"]
    assert got[0]["totals"] == got[1]["totals"]
    assert got[0]["nodes"] and got[0]["nodes"] == got[1]["nodes"]
    assert all(n["devices"] == 2 for n in got[0]["nodes"])
    # each rank walks its own block for the data skew
    assert [r["shards"] for r in got[0]["data"]] == [1]
