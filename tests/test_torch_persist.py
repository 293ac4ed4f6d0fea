"""The warm-start plan store of the port (``spartan_tpu_torch/persist``),
on the CPU.

* ``stable_digest`` is byte-equal to the JAX package's on the same
  plain objects, and both refuse an object with no stable bytes;
* a plan set stored by one fresh process is read by another: the smart
  tiling DP runs 0 times there, the results are bit-equal, and the
  plans' decisions and reports are the stored ones;
* every rejection reason (``manifest``, ``crc``, ``version``,
  ``fingerprint``, ``meta``, ``meta_mismatch``, ``io`` chaos) degrades
  to a normal build, bit-equal, counted by reason;
* a stored audit verdict is read back instead of re-walked; steady-state
  hits never touch the store; dead-epoch entries go with elastic
  recovery's eviction; prewarm, manifests, stats and the GC bounds.
"""

import json
import os
import subprocess
import sys
import types
import zlib

import numpy as np
import pytest
import torch

import spartan_tpu_torch as st_t
from spartan_tpu.persist import fingerprint as fp_j
from spartan_tpu_torch import persist
from spartan_tpu_torch.expr import base as base_t
from spartan_tpu_torch.obs.metrics import REGISTRY, labeled
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.persist import fingerprint as fp_t
from spartan_tpu_torch.resilience import elastic as elastic_t
from spartan_tpu_torch.utils import profiling as prof_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _isolated():
    prev_dev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    saved = {n: getattr(FLAGS_T, n) for n in (
        "persist_cache_dir", "persist_max_bytes", "persist_ttl_s",
        "verify_evaluate")}
    st_t.chaos_clear()
    yield
    st_t.chaos_clear()
    for n, v in saved.items():
        setattr(FLAGS_T, n, v)
    persist.reset()
    base_t.clear_plan_cache()
    mesh_t.reset_epoch_for_tests()
    mesh_t.set_default_device(prev_dev)


class _Delta:
    def __init__(self):
        self.base = REGISTRY.counter_values()

    def __call__(self, name, **labels):
        key = labeled(name, **labels) if labels else name
        return REGISTRY.counter_values().get(key, 0) - self.base.get(key, 0)


def _restart():
    """A process restart for the evaluation stack: the in-memory plan
    cache and the store's memos go, the disk stays."""
    base_t.clear_plan_cache()
    persist.reset()


def _fresh(tmp_path, name="store"):
    d = str(tmp_path / name)
    FLAGS_T.persist_cache_dir = d
    _restart()
    return d


def _plan_set(seed=0, n=48):
    rng = np.random.RandomState(seed)
    x = st_t.from_numpy(rng.rand(n, n).astype(np.float32))
    y = st_t.from_numpy(rng.rand(n, n).astype(np.float32))
    return [((x + y) * 3.0 - x).sum(),
            st_t.dot(st_t.dot(x, y) * 0.5 + 1.0, x).sum(axis=0)]


def _entries(d):
    return sorted(p for p in os.listdir(d) if p.startswith("entry_")
                  and "." not in p)


def _dp_runs():
    return prof_t.counters().get("tiling_dp_runs", 0)


# -- stable_digest ------------------------------------------------------------


def _module_level(x):
    return x + 1


def test_stable_digest_is_byte_equal_to_jax():
    code = (lambda v: v * 2.0 + 1.0).__code__
    objs = [None, True, False, 0, -7, 1.5, float("inf"), "", "spartan",
            b"\x00\x01", (1, "a", (2.0, None)), [1, [2, [3]]],
            {"b": 1, "a": (2, 3)}, frozenset({1, 2, "x"}), {3, 4},
            np.dtype("float32"), np.int32(5), np.float64(2.5),
            np.bool_(True), code, _module_level, len, int,
            types.SimpleNamespace,
            ("val", 0, (64, 32), "float32", ("x", None)),
            (("map", ("add", ("in", 0), ("const", 2.0))),
             ("auto_tiling",), 1.0, None)]
    for obj in objs:
        assert fp_t.stable_digest(obj) == fp_j.stable_digest(obj), obj
    for mod in (fp_t, fp_j):
        for bad in (object(), np.add):
            with pytest.raises(mod.UnstableKeyError):
                mod.stable_digest(bad)


def test_store_off_by_default(tmp_path):
    assert FLAGS_T.persist_cache_dir == ""
    assert persist.active() is None
    assert persist.lookup(("k",), mesh_t.get_mesh()) == (None, None, None)
    assert persist.stats() == {"enabled": False}


# -- a round trip across fresh processes --------------------------------------

_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import spartan_tpu_torch as st
from spartan_tpu_torch.examples import kmeans as km
from spartan_tpu_torch.utils import profiling as prof

st.set_default_device("cpu")
st.FLAGS.persist_cache_dir = os.environ["STORE"]
rng = np.random.RandomState(2)
A = rng.rand(64, 64).astype(np.float32)
P = rng.rand(2048, 16).astype(np.float32)
out, reports = {}, {}
for shape in ((4, 2), (8, 1)):
    with st.use_mesh(st.build_mesh(shape)):
        a = st.from_numpy(A)
        chain = st.dot(st.dot(a, a) * 0.5 + 1.0, a).sum(axis=0)
        r = st.explain(chain)
        reports[f"chain{shape}"] = [
            r.data.get("persist", {}).get("source"),
            [{k: v for k, v in t.items() if k not in ("node", "site")}
             for t in r.tilings], r.dp_cost]
        out[f"chain{shape}"] = chain.glom()
        out[f"kmeans{shape}"] = km.kmeans(st.from_numpy(P), 4, 3,
                                          seed=1)[0]
np.savez(os.path.join(os.environ["OUT"], "out.npz"), **out)
c = prof.counters()
with open(os.path.join(os.environ["OUT"], "rec.json"), "w") as f:
    json.dump({"dp_runs": c.get("tiling_dp_runs", 0),
               "reports": reports,
               "counters": {k: v for k, v in
                            st.REGISTRY.counter_values().items()
                            if k.startswith("persist")}}, f, default=str)
print("CHILD_OK", flush=True)
"""


def _child(store, out):
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, REPO=REPO, STORE=str(store), OUT=str(out),
               OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                       capture_output=True, text=True,
                       timeout=CHILD_TIMEOUT_S)
    assert p.returncode == 0 and "CHILD_OK" in p.stdout, \
        (p.stdout + p.stderr)[-3000:]
    with open(os.path.join(out, "rec.json")) as f:
        rec = json.load(f)
    return dict(np.load(os.path.join(out, "out.npz"))), rec


def test_warm_restart_in_a_fresh_process_runs_no_dp(tmp_path):
    store = tmp_path / "store"
    cold, crec = _child(store, tmp_path / "cold")
    warm, wrec = _child(store, tmp_path / "warm")
    assert crec["dp_runs"] > 0
    assert wrec["dp_runs"] == 0
    assert wrec["counters"].get("persist_hits", 0) >= 4
    assert not [k for k in wrec["counters"] if "load_errors" in k]
    for k in cold:
        np.testing.assert_array_equal(warm[k], cold[k])
    for k, (src, tilings, dp) in wrec["reports"].items():
        assert src == "disk", k
        assert crec["reports"][k][0] == "plan"
        assert tilings == crec["reports"][k][1] and dp == \
            crec["reports"][k][2]


# -- rejections ---------------------------------------------------------------


def _mutate_plan(d, entry, fn):
    """Rewrite an entry's plan.json through ``fn`` and re-sign its CRC
    (so only the plan-level checks can reject it)."""
    path = os.path.join(d, entry, "plan.json")
    with open(path) as f:
        meta = json.load(f)
    data = fn(meta)
    raw = data if isinstance(data, bytes) else json.dumps(data).encode()
    with open(path, "wb") as f:
        f.write(raw)
    mp = os.path.join(d, entry, "manifest.json")
    with open(mp) as f:
        manifest = json.load(f)
    manifest["files"]["plan.json"]["crc32"] = zlib.crc32(raw)
    with open(mp, "w") as f:
        json.dump(manifest, f)


def _edit_manifest(d, entry, fn):
    mp = os.path.join(d, entry, "manifest.json")
    with open(mp) as f:
        manifest = json.load(f)
    fn(manifest)
    with open(mp, "w") as f:
        json.dump(manifest, f)


def _corrupt_byte(d, entry):
    path = os.path.join(d, entry, "plan.json")
    with open(path, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0x20]))


def _garbage_manifest(d, entry):
    with open(os.path.join(d, entry, "manifest.json"), "w") as f:
        f.write("{not json")


def _struct(meta):
    meta["structure"][-1][1] = [7, 7]
    return meta


REJECTIONS = {
    "crc": _corrupt_byte,
    "manifest": _garbage_manifest,
    "version": lambda d, e: _edit_manifest(
        d, e, lambda m: m.__setitem__("version", 99)),
    "fingerprint": lambda d, e: _edit_manifest(
        d, e, lambda m: m["fingerprint"].__setitem__("torch", "0.0")),
    "meta": lambda d, e: _mutate_plan(d, e, lambda m: b"[1, 2"),
    "meta_mismatch": lambda d, e: _mutate_plan(d, e, _struct),
}


@pytest.mark.parametrize("reason", list(REJECTIONS) + ["io"])
def test_every_rejection_degrades_to_a_normal_build(reason, tmp_path):
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        d = _fresh(tmp_path)
        cold = _plan_set()[1].glom()
        (entry,) = _entries(d)
        if reason != "io":
            REJECTIONS[reason](d, entry)
        _restart()
        delta = _Delta()
        runs = _dp_runs()
        if reason == "io":
            with st_t.chaos("io@0"):
                warm = _plan_set()[1].glom()
        else:
            warm = _plan_set()[1].glom()
        assert delta("persist_load_errors", reason=reason) == 1
        assert delta("persist_hits") == 0
        assert _dp_runs() == runs + 1  # the DP planned it again
    np.testing.assert_array_equal(warm, cold)


def test_a_hit_restores_decisions_and_skips_the_dp(tmp_path):
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        d = _fresh(tmp_path)
        cold = [e.glom() for e in _plan_set()]
        assert len(_entries(d)) == 2
        r_cold = st_t.explain(_plan_set(seed=3)[1])
        _restart()
        delta = _Delta()
        runs = _dp_runs()
        warm = [e.glom() for e in _plan_set()]
        assert _dp_runs() == runs
        assert delta("persist_hits") == 2
        r_warm = st_t.explain(_plan_set(seed=3)[1])
        # steady-state hits read nothing from the store
        loads = delta("persist_hits") + delta("persist_misses")
        [e.glom() for e in _plan_set(seed=4)]
        assert delta("persist_hits") + delta("persist_misses") == loads
    for a, b in zip(cold, warm):
        np.testing.assert_array_equal(a, b)
    assert [{k: v for k, v in t.items() if k not in ("node", "site")}
            for t in r_warm.tilings] == [
        {k: v for k, v in t.items() if k not in ("node", "site")}
        for t in r_cold.tilings]
    assert r_warm.dp_cost == r_cold.dp_cost
    assert r_warm.data["persist"]["source"] == "disk"


def test_stored_audit_is_read_back_not_rewalked(tmp_path):
    FLAGS_T.verify_evaluate = True
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        _fresh(tmp_path)
        delta = _Delta()
        _plan_set()[1].glom()
        assert delta("audit_runs") == 1
        _restart()
        delta = _Delta()
        _plan_set()[1].glom()
        assert delta("audit_runs") == 0 and delta("audit_cached") == 1


def test_dead_epoch_entries_go_with_the_eviction(tmp_path):
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        d = _fresh(tmp_path)
        _plan_set()[0].glom()
    assert len(_entries(d)) == 1
    st_t.rebuild_mesh(exclude_devices=[7])
    delta = _Delta()
    elastic_t._evict()
    assert _entries(d) == []
    assert delta("persist_evicted") == 1
    assert persist.last_evicted() == 1


def test_prewarm_manifest_stats_and_gc(tmp_path):
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        d = _fresh(tmp_path)
        [e.glom() for e in _plan_set()]
        assert persist.stats()["entries"] == 2
        man = str(tmp_path / "manifest.json")
        assert persist.write_manifest(man) == 2
        _restart()
        got = persist.prewarm(man)
        assert got == {"loaded": 2, "missing": 0, "errors": 0,
                       "skipped": 0, "total": 2}
        assert persist.stats()["preloaded"] == 2
        bad = persist.prewarm(["0" * 40])
        assert bad["missing"] == 1
        # the size bound keeps the newest entry only
        FLAGS_T.persist_max_bytes = 1
        _restart()
        _plan_set(n=40)[0].glom()
        assert len(_entries(d)) == 1
