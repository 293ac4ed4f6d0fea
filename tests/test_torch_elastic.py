"""Elastic recovery on the CPU: the migration planner, rehome, cross-mesh
checkpoint restore, the k-means acceptance on a rebuilt logical mesh,
chaos inside recovery, and the loss of a rank of a gloo group.

The same numpy inputs go through the JAX package (on the 8-device CPU
mesh) and the port (on a logical mesh of the same shape). Tolerances:
migration decisions (route, bytes, schedule, reason) and restore
records equal; every port-against-port resume bit-equal; k-means centers
against the JAX package rtol 1e-5 / atol 1e-6 (the JAX package's own
tolerance at ``tests/test_resilience.py:562``).

The group tests start gloo worlds of CPU processes (``python -c``, a
``file://`` store under ``tmp_path``, ``OMP_NUM_THREADS=1``). A world of
4 runs a checkpointed loop with two carries (config-3-shaped k-means
centers and the elementwise ``c * 1.01 + x``) with local storage; rank 3
is SIGKILLed once ``LATEST.json`` reads step 10, and the other ranks
must exit with ``FatalMeshError`` within the group's timeout. A world of
3 resumes from the snapshot, and another world of 3 resumes a copy of
it: bit-equal. The JAX package resumes a third copy on a 3-device mesh:
its k-means centers agree within 1e-5. Its elementwise carry is not
bit-equal to the port's: XLA's CPU backend contracts ``c * 1.01 + x``
into one fused multiply-add, so the test holds the port's carry bit-equal
to numpy's two-rounding recurrence and the JAX package's bit-equal to
numpy's fused one, from the same snapshot. The JAX package's own
multi-process tests (``tests/test_multihost.py``) skip these cases on
this CPU ("Multiprocess computations aren't implemented"); the port
runs them.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.examples.kmeans import kmeans_step as kmeans_step_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.parallel import redistribute as rd_j
from spartan_tpu.resilience import elastic as elastic_j
from spartan_tpu.resilience import engine as engine_j
from spartan_tpu.resilience import loop_ckpt as loop_ckpt_j
from spartan_tpu.utils import checkpoint as ckpt_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J

import spartan_tpu_torch as st_t
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.examples.kmeans import kmeans_step as kmeans_step_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.parallel import redistribute as rd_t
from spartan_tpu_torch.resilience import elastic as elastic_t
from spartan_tpu_torch.resilience import engine as engine_t
from spartan_tpu_torch.resilience import loop_ckpt as loop_ckpt_t
from spartan_tpu_torch.utils import checkpoint as ckpt_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 10.0
JOIN_TIMEOUT_S = 90


@pytest.fixture(autouse=True)
def _world(mesh2d):
    """Both packages on a 4x2 mesh; the epoch, the survivor set, chaos
    and the retry budgets are restored afterwards in both."""
    from spartan_tpu.serve import shutdown_default

    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    saved_j = {n: getattr(FLAGS_J, n) for n in (
        "retry_backoff_s", "redistribution_planner")}
    saved_t = {n: getattr(FLAGS_T, n) for n in (
        "retry_backoff_s", "redistribution_planner")}
    FLAGS_J.retry_backoff_s = 0.0
    FLAGS_T.retry_backoff_s = 0.0
    keep_j, keep_t = loop_ckpt_j._KEEP_SNAPSHOTS, loop_ckpt_t._KEEP_SNAPSHOTS
    for mod in (st_j, st_t):
        mod.chaos_clear()
    engine_j.reset()
    engine_t.reset()
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2), "cpu")):
        yield
    for mod in (st_j, st_t):
        mod.chaos_clear()
    engine_j.reset()
    engine_t.reset()
    shutdown_default()
    mesh_j.reset_epoch_for_tests()
    mesh_t.reset_epoch_for_tests()
    loop_ckpt_j._KEEP_SNAPSHOTS, loop_ckpt_t._KEEP_SNAPSHOTS = keep_j, keep_t
    for n, v in saved_j.items():
        setattr(FLAGS_J, n, v)
    for n, v in saved_t.items():
        setattr(FLAGS_T, n, v)
    mesh_t.set_default_device(prev)


def _counter_t(name):
    return st_t.metrics()["counters"].get(name, 0)


SRC = {"x": 4, "y": 2}
DST = {"x": 3, "y": 2}

# (src tiling, dst tiling, shape): tests/test_elastic_retile.py:60-134
PLAN_CASES = [
    ("row", "row", (24, 8)),
    ("row", "row", (8, 8)),
    ("flat_row", "row", (24, 8)),
    ("replicated", "replicated", (24, 8)),
    ("row", "row_t", (24, 8)),
    ("block", "col", (24, 8)),
    ("col", "block_t", (12, 6)),
]


def _tiling_t(name, ndim=2):
    """The port's tiling named as the JAX package's constructor (the
    port has no ``flat_row`` helper: it is ``Tiling((("x", "y"),) ...)``)."""
    if name == "flat_row":
        return tiling_t.Tiling((("x", "y"),) + (None,) * (ndim - 1))
    return getattr(tiling_t, name)(ndim)


def _describe(dec):
    return (dec.route, float(dec.bytes), float(dec.cost),
            dec.schedule.describe() if dec.schedule is not None else None,
            dec.reason)


@pytest.mark.parametrize("src,dst,shape", PLAN_CASES,
                         ids=[f"{a}-{b}-{s[0]}x{s[1]}"
                              for a, b, s in PLAN_CASES])
def test_plan_transition_matches_jax(src, dst, shape):
    dj = rd_j.plan_transition(getattr(tiling_j, src)(2),
                              getattr(tiling_j, dst)(2), SRC, DST, shape,
                              np.float32)
    dt = rd_t.plan_transition(_tiling_t(src), _tiling_t(dst), SRC, DST, shape,
                              np.float32)
    assert _describe(dt) == _describe(dj)


def test_plan_transition_named_cases():
    """The JAX package's expectations, on the port's planner."""
    d = rd_t.plan_transition(tiling_t.row(2), tiling_t.row(2), SRC, DST,
                             (24, 8), np.float32)
    assert d.route == "direct" and d.bytes == pytest.approx(24 * 8 * 4 / 3)
    assert [s.kind for s in d.schedule.steps] == ["transfer"]
    d = rd_t.plan_transition(tiling_t.row(2), tiling_t.row(2), SRC, DST,
                             (8, 8), np.float32)
    assert d.route == "gather" and "indivisible" in d.reason
    d = rd_t.plan_transition(_tiling_t("flat_row"), tiling_t.row(2), SRC,
                             DST, (24, 8), np.float32)
    assert d.route == "gather" and "flat_row" in d.reason
    d = rd_t.plan_transition(tiling_t.replicated(2), tiling_t.replicated(2),
                             SRC, DST, (24, 8), np.float32)
    assert d.route == "direct" and d.bytes == 0.0
    d = rd_t.plan_transition(tiling_t.row(2), tiling_t.row_t(2), SRC, DST,
                             (24, 8), np.float32)
    assert [s.kind for s in d.schedule.steps] == ["all_gather", "transfer",
                                                  "slice"]


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("from_epoch",
                                                      "to_epoch")}


def test_simulated_shrink_rehome_records_match_jax():
    """Arrays on (4, 2) rehomed after excluding positions 6 and 7: the
    same route, bytes, schedule, reason and tilings in both packages,
    values intact, the epoch advanced, the elastic counters fed."""
    vals = np.arange(24 * 8, dtype=np.float32).reshape(24, 8)
    names = ("row", "flat_row", "replicated")
    arrs_j = [st_j.from_numpy(vals.copy(), tiling=getattr(tiling_j, n)(2))
              for n in names]
    arrs_t = [st_t.from_numpy(vals.copy(), tiling=_tiling_t(n))
              for n in names]
    b0 = _counter_t("elastic_migrated_bytes")
    mesh_j.rebuild_mesh(exclude_devices=[6, 7])
    st_t.rebuild_mesh(exclude_devices=[6, 7])
    assert dict(mesh_t.get_mesh().shape) == {"x": 3, "y": 2}
    assert elastic_j.rehome(arrs_j) == elastic_t.rehome(arrs_t) == 3
    rep_j = [_strip(r) for r in elastic_j.last_rehome_report()]
    rep_t = [_strip(r) for r in elastic_t.last_rehome_report()]
    assert rep_t == rep_j
    for a in arrs_t:
        assert a.value._epoch == st_t.mesh_epoch() == 1
        np.testing.assert_array_equal(a.glom(), vals)
    assert _counter_t("elastic_migrated_bytes") > b0


def test_rehome_skips_donated_with_labelled_reason():
    a = np.ones((8, 8), np.float32)
    live = st_t.from_numpy(a.copy())
    donated = st_t.from_numpy(a.copy())
    donated.value._release_donated()
    s0 = _counter_t("elastic_rehome_skipped")
    st_t.rebuild_mesh(exclude_devices=[7])
    assert elastic_t.rehome([donated, live]) == 1
    assert _counter_t("elastic_rehome_skipped") == s0 + 1
    skip = [r for r in elastic_t.last_rehome_report()
            if r["route"] == "skipped"]
    assert skip and "donat" in skip[0]["reason"]
    np.testing.assert_array_equal(live.glom(), a)


def _restore_record(mig):
    return {k: mig[k] for k in ("route", "bytes", "schedule",
                                "planned_route", "reason", "src_tiling",
                                "dst_tiling", "src_mesh", "dst_mesh")}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_mesh_restore_record_matches_jax(writer, tmp_path):
    """A checkpoint saved on (4, 2) by one package loads in the other
    after a rebuild over 6 positions: the values, and a ``restore``
    migration record equal to the one the JAX package makes."""
    vals = np.arange(24 * 8, dtype=np.float32).reshape(24, 8)
    path = str(tmp_path / "a")
    if writer == "jax":
        ckpt_j.save(path, st_j.from_numpy(vals,
                                          tiling=tiling_j.row(2)).value)
    else:
        ckpt_t.save(path, st_t.from_numpy(vals,
                                          tiling=tiling_t.row(2)).value)
    mesh_j.rebuild_mesh(exclude_devices=[6, 7])
    st_t.rebuild_mesh(exclude_devices=[6, 7])
    got_j, got_t = ckpt_j.load(path), ckpt_t.load(path)
    np.testing.assert_array_equal(got_t.glom(), vals)
    np.testing.assert_array_equal(np.asarray(got_j.glom()), vals)
    assert got_t._migration["src_mesh"] == {"x": 4, "y": 2}
    assert got_t._migration["dst_mesh"] == {"x": 3, "y": 2}
    assert _restore_record(got_t._migration) == _restore_record(
        got_j._migration)


def _copy_snapshot(src, dst, step):
    """A copy of a loop's snapshot directory that stops at ``step``."""
    shutil.copytree(src, dst)
    for d in os.listdir(dst):
        if d.startswith("step_") and int(d[5:]) > step:
            shutil.rmtree(os.path.join(dst, d))
    with open(os.path.join(dst, "LATEST.json"), "w") as f:
        json.dump({"step": step, "dir": f"step_{step:08d}"}, f)


def _kmeans_elastic(st, step_fn, mesh_mod, pts_np, c0, k, tmp, tag):
    """``tests/test_resilience.py:811`` on one package: device_loss@2
    under a checkpointed k-means loop, then a clean resume of a copy of
    the iteration-10 snapshot on the rebuilt mesh."""
    p = os.path.join(tmp, f"ck_{tag}")
    points = st.from_numpy(pts_np)
    with st.chaos("device_loss@2") as plan:
        res = st.loop(20, lambda c: step_fn(points, c, k),
                      st.as_expr(c0.copy()), checkpoint_every=5,
                      checkpoint_path=p)
        out = np.asarray(res.glom())
    ref_dir = os.path.join(tmp, f"ref_{tag}")
    _copy_snapshot(p, ref_dir, 10)
    points2 = st.from_numpy(pts_np)
    ref = np.asarray(st.loop(20, lambda c: step_fn(points2, c, k),
                             st.as_expr(c0.copy()), checkpoint_every=5,
                             resume=ref_dir).glom())
    return out, ref, res._resilience, plan.fired


def test_acceptance_kmeans_elastic_recovery(tmp_path):
    """The k-means loop survives ``device_loss@2``: the mesh becomes
    (7, 1) at epoch 1 in both packages, the port's centers are bit-equal
    to its clean resume from the same snapshot and within 1e-5 of the
    JAX package's."""
    n, d, k = 256, 8, 4
    rng = np.random.RandomState(7)
    pts_np = rng.rand(n, d).astype(np.float32)
    c0 = pts_np[:k].copy()
    loop_ckpt_j._KEEP_SNAPSHOTS = loop_ckpt_t._KEEP_SNAPSHOTS = 16
    r0 = _counter_t("resilience_loop_elastic_resumes")
    out_t, ref_t, rec_t, fired_t = _kmeans_elastic(
        st_t, kmeans_step_t, mesh_t, pts_np, c0, k, str(tmp_path), "t")
    out_j, ref_j, rec_j, fired_j = _kmeans_elastic(
        st_j, kmeans_step_j, mesh_j, pts_np, c0, k, str(tmp_path), "j")
    assert fired_t == fired_j == [{"kind": "device_loss", "site": "dispatch",
                                   "occurrence": 2}]
    assert dict(mesh_t.get_mesh().shape) == {"x": 7, "y": 1}
    assert st_t.mesh_epoch() == st_j.mesh_epoch() == 1
    assert rec_t["mesh_rebuilt"] and rec_t["restores"] == 1
    assert rec_t["rehomed"] == rec_j["rehomed"] == 1
    assert _counter_t("resilience_loop_elastic_resumes") == r0 + 1
    np.testing.assert_array_equal(out_t, ref_t)
    np.testing.assert_array_equal(out_j, ref_j)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("probe", [0, 1, 2])
def test_chaos_during_recovery_reenters_cleanly(probe, tmp_path):
    """A transient fault at each recovery probe (drain, rebuild, evict)
    kills the recovery mid-flight; the loop re-enters, the recovery
    finishes, and the result is bit-equal to an uninterrupted run on the
    rebuilt mesh."""
    a = np.ones((8, 8), np.float32)
    x = st_t.from_numpy(a * 0.5)
    p = str(tmp_path / "ck")
    with st_t.chaos(f"device_loss@2x2,recover@{probe}"):
        res = st_t.loop(20, lambda c: c * 1.01 + x, st_t.from_numpy(a.copy()),
                        checkpoint_every=5, checkpoint_path=p)
        out = res.glom()
    assert mesh_t.mesh_epoch() >= 1
    assert elastic_t._completed_epoch == mesh_t.mesh_epoch()
    assert not elastic_t._pending
    x2 = st_t.from_numpy(a * 0.5)
    ref = st_t.loop(20, lambda c: c * 1.01 + x2,
                    st_t.from_numpy(a.copy())).glom()
    np.testing.assert_array_equal(out, ref)


def test_chaos_during_rehome_reenters(tmp_path):
    """``recover@3``: the first rehome pass fails; the loop re-enters and
    the next pass heals."""
    a = np.ones((8, 8), np.float32)
    x = st_t.from_numpy(a * 0.5)
    with st_t.chaos("device_loss@2,recover@3") as plan:
        out = st_t.loop(20, lambda c: c * 1.01 + x,
                        st_t.from_numpy(a.copy()), checkpoint_every=5,
                        checkpoint_path=str(tmp_path / "ck")).glom()
    assert [f["kind"] for f in plan.fired] == ["device_loss", "recover"]
    x2 = st_t.from_numpy(a * 0.5)
    ref = st_t.loop(20, lambda c: c * 1.01 + x2,
                    st_t.from_numpy(a.copy())).glom()
    np.testing.assert_array_equal(out, ref)


def test_device_loss_loop_with_planner_on(tmp_path):
    FLAGS_T.redistribution_planner = True
    a = np.ones((24, 8), np.float32)
    x = st_t.from_numpy(a * 0.5, tiling=tiling_t.row(2))
    with st_t.chaos("device_loss@2"):
        res = st_t.loop(20, lambda c: c * 1.01 + x,
                        st_t.from_numpy(a.copy()), checkpoint_every=5,
                        checkpoint_path=str(tmp_path / "ck"))
        out = res.glom()
    assert res._resilience["mesh_rebuilt"] and res._resilience["rehomed"]
    assert x.value._migration["reason"]
    x2 = st_t.from_numpy(a * 0.5)
    ref = st_t.loop(20, lambda c: c * 1.01 + x2,
                    st_t.from_numpy(a.copy())).glom()
    np.testing.assert_array_equal(out, ref)


# -- the loss of a rank of a gloo group --------------------------------------

# One rank of a world: a checkpointed loop with two carries, the k-means
# centers (points row-tiled, so each rank holds its rows) and the
# elementwise c * 1.01 + x (row-tiled too). MODE=run writes snapshots to
# CK, MODE=resume resumes from it. Prints RESULT <json> on success;
# FAILED <type> <class> and exit code 3 on a failure.
_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import spartan_tpu_torch as st
from spartan_tpu_torch.array.tiling import Tiling
from spartan_tpu_torch.examples import kmeans as km
from spartan_tpu_torch.obs.metrics import materialize_sites
from spartan_tpu_torch.resilience import classify

st.set_default_device("cpu")
st.initialize_distributed(timeout_s=float(os.environ["GROUP_TIMEOUT_S"]))
mesh = st.get_mesh()
inp = np.load(os.environ["INPUTS"])
row = Tiling(("x", None))
pts = st.from_numpy(inp["pts"], tiling=row)
x = st.from_numpy(inp["x"], tiling=row)
k = int(inp["k"])
for spec in filter(None, [os.environ.get("CHAOS_ALL"),
                          os.environ.get(f"CHAOS_{mesh.rank}")]):
    st.chaos(spec)
ck = os.environ["CK"]
kw = {"resume": ck} if os.environ["MODE"] == "resume" else \
    {"checkpoint_path": ck}
try:
    c, e = st.loop(20, lambda c, e: (km.kmeans_step(pts, c, k),
                                     e * 1.01 + x),
                   st.from_numpy(inp["c0"]),
                   st.from_numpy(inp["e0"], tiling=row),
                   checkpoint_every=5, **kw)
    out = {"c": c.glom(), "e": e.glom()}
except Exception as exc:
    print("FAILED", type(exc).__name__, classify.classify(exc), flush=True)
    os._exit(3)
rec = c._resilience
np.savez(os.path.join(os.environ["OUT"], f"rank{mesh.rank}.npz"), **out)
print("RESULT", json.dumps({
    "resumed_from": rec["resumed_from"],
    "migrations": [{k: v for k, v in m.items()
                    if k in ("route", "src_mesh", "dst_mesh")}
                   for m in rec.get("migrations", [])],
    "checkpoint_gathers": materialize_sites().get("checkpoint", 0),
    "mesh": dict(mesh.shape)}), flush=True)
st.shutdown()
"""


def _group_inputs(path):
    rng = np.random.RandomState(11)
    true = (rng.rand(4, 16) * 4.0).astype(np.float32)
    lab = rng.randint(0, 4, 3072)
    pts = (true[lab] + 0.05 * rng.randn(3072, 16)).astype(np.float32)
    inp = {"pts": pts, "c0": pts[:4].copy(), "k": np.array(4),
           "x": rng.rand(48, 8).astype(np.float32),
           "e0": rng.rand(48, 8).astype(np.float32)}
    np.savez(path, **inp)
    return inp


def _start(world, tmp, tag, ck, mode, extra=None):
    out = os.path.join(tmp, f"out_{tag}")
    os.makedirs(out, exist_ok=True)
    procs = []
    for rank in range(world):
        env = dict(os.environ, REPO=REPO, INPUTS=os.path.join(tmp, "in.npz"),
                   OUT=out, CK=ck, MODE=mode,
                   GROUP_TIMEOUT_S=str(GROUP_TIMEOUT_S),
                   COORDINATOR_ADDRESS=f"file://{tmp}/store_{tag}",
                   WORLD_SIZE=str(world), RANK=str(rank),
                   OMP_NUM_THREADS="1", **(extra or {}))
        for key in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
            env.pop(key, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs, out


def _join(procs):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def _result(log):
    line = [ln for ln in log.splitlines() if ln.startswith("RESULT ")]
    assert line, log[-3000:]
    return json.loads(line[-1][len("RESULT "):])


def _wait_step(ck, step, procs, deadline_s):
    marker = os.path.join(ck, "LATEST.json")
    t_end = time.monotonic() + deadline_s
    while time.monotonic() < t_end:
        if any(p.poll() is not None for p in procs):
            return False
        try:
            with open(marker) as f:
                if json.load(f).get("step", 0) >= step:
                    return True
        except (OSError, ValueError):
            pass
        time.sleep(0.02)
    return False


def _jax_resume(inp, ck, world):
    """The JAX package resumes the snapshot on a ``world``-device mesh."""
    m = mesh_j.build_mesh(jax.devices()[:world])
    with mesh_j.use_mesh(m):
        pts = st_j.from_numpy(inp["pts"], tiling=tiling_j.row(2))
        x = st_j.from_numpy(inp["x"], tiling=tiling_j.row(2))
        c, e = st_j.loop(20, lambda c, e: (kmeans_step_j(pts, c, 4),
                                           e * 1.01 + x),
                         st_j.from_numpy(inp["c0"]),
                         st_j.from_numpy(inp["e0"], tiling=tiling_j.row(2)),
                         checkpoint_every=5, resume=ck)
        return np.asarray(c.glom()), np.asarray(e.glom())


def _recurrence_n(e, x, n, fused):
    """``n`` iterations of ``e * 1.01 + x`` in numpy: two roundings, or
    one (float64 product and sum, then float32), as XLA's CPU backend
    contracts it."""
    for _ in range(n):
        if fused:
            e = (e.astype(np.float64) * np.float64(np.float32(1.01))
                 + x.astype(np.float64)).astype(np.float32)
        else:
            e = e * np.float32(1.01) + x
    return e


def test_group_rank_loss_survivor_world_resumes(tmp_path):
    """Rank 3 of a gloo world of 4 is SIGKILLed after the iteration-10
    snapshot; ranks 0-2 exit with FatalMeshError within the group's
    timeout instead of hanging. The snapshot holds blobs of several
    ranks and no gather at site ``checkpoint``. A world of 3 resumes it
    with a ``restore`` migration record from (2, 2) to (3, 1), bit-equal
    to another world of 3 resuming a copy."""
    tmp = str(tmp_path)
    inp = _group_inputs(os.path.join(tmp, "in.npz"))
    ck = os.path.join(tmp, "ck")
    # every dispatch sleeps 0.3 s, so the kill lands inside the loop
    victims, _ = _start(4, tmp, "victim", ck, "run",
                        {"CHAOS_ALL": "slow:1.0=0.3"})
    reached = _wait_step(ck, 10, victims, 60)
    if reached:
        victims[3].send_signal(signal.SIGKILL)
        t_kill = time.monotonic()
    logs = _join(victims)
    assert reached, [log[-2000:] for _, log in logs]
    waited = time.monotonic() - t_kill
    for rank, (rc, log) in enumerate(logs[:3]):
        assert rc == 3, log[-3000:]
        assert "FAILED FatalMeshError fatal_mesh" in log, log[-3000:]
    assert waited < GROUP_TIMEOUT_S + 15
    with open(os.path.join(ck, "LATEST.json")) as f:
        step = json.load(f)["step"]
    assert step >= 10
    snap = os.path.join(ck, f"step_{step:08d}")
    # the elementwise carry's blobs: one per block, each written by the
    # rank holding the block's first copy; only rank 0's carry a CRC
    with open(os.path.join(snap, "carry1", "manifest.json")) as f:
        shards = json.load(f)["shards"]
    assert len(shards) > 1
    for rec in shards:
        assert os.path.exists(os.path.join(snap, "carry1", rec["file"]))
    assert sum("crc32" in rec for rec in shards) == 1
    ref = os.path.join(tmp, "ref")
    _copy_snapshot(ck, ref, step)
    jax_ck = os.path.join(tmp, "jax_ck")
    _copy_snapshot(ck, jax_ck, step)
    e_snap = ckpt_t._load_host(os.path.join(snap, "carry1"))[0]
    survivors, out_s = _start(3, tmp, "survivor", ck, "resume")
    clean, out_c = _start(3, tmp, "clean", ref, "resume")
    c_j, e_j = _jax_resume(inp, jax_ck, 3)
    got_s, got_c = _join(survivors), _join(clean)
    for rc, log in got_s + got_c:
        assert rc == 0, log[-3000:]
        r = _result(log)
        assert r["resumed_from"] == step
        assert r["checkpoint_gathers"] == 0
        assert r["mesh"] == {"x": 3, "y": 1}
        assert {"route": "restore", "src_mesh": {"x": 2, "y": 2},
                "dst_mesh": {"x": 3, "y": 1}} in r["migrations"]
    for rank in range(3):
        s = np.load(os.path.join(out_s, f"rank{rank}.npz"))
        c = np.load(os.path.join(out_c, f"rank{rank}.npz"))
        np.testing.assert_array_equal(s["c"], c["c"])
        np.testing.assert_array_equal(s["e"], c["e"])
    s = np.load(os.path.join(out_s, "rank0.npz"))
    np.testing.assert_allclose(s["c"], c_j, rtol=1e-5, atol=1e-6)
    tail = 20 - step
    assert tail > 0
    np.testing.assert_array_equal(
        s["e"], _recurrence_n(e_snap, inp["x"], tail, fused=False))
    np.testing.assert_array_equal(
        e_j, _recurrence_n(e_snap, inp["x"], tail, fused=True))
    np.testing.assert_allclose(s["e"], e_j, rtol=1e-6)


def test_group_snapshot_commit_protocol(tmp_path):
    """A rank that fails at the ``checkpoint`` seam of the iteration-10
    snapshot (``io@2`` on rank 0: occurrences 0 and 1 are the two carries
    of iteration 5) dies before rank 0 writes the manifest. The other
    rank, already past its blobs and waiting at the barrier, exits with
    FatalMeshError, and ``LATEST.json`` still names iteration 5, which
    loads whole."""
    tmp = str(tmp_path)
    _group_inputs(os.path.join(tmp, "in.npz"))
    ck = os.path.join(tmp, "ck")
    procs, _ = _start(2, tmp, "commit", ck, "run", {"CHAOS_0": "io@2"})
    logs = _join(procs)
    assert logs[0][0] == 3 and "FAILED InjectedCheckpointError io" in \
        logs[0][1], logs[0][1][-3000:]
    assert logs[1][0] == 3 and "FAILED FatalMeshError fatal_mesh" in \
        logs[1][1], logs[1][1][-3000:]
    with open(os.path.join(ck, "LATEST.json")) as f:
        assert json.load(f)["step"] == 5
    # the iteration-10 snapshot never got its manifest
    snap10 = os.path.join(ck, "step_00000010")
    assert not os.path.exists(os.path.join(snap10, "carry0",
                                           "manifest.json"))
    step, carries = loop_ckpt_t.load_latest(ck)
    assert step == 5 and len(carries) == 2
