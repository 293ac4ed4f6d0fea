"""The SDC sentinel of the port (``resilience/integrity.py``), on the CPU.

* the CRC32 of each logical block equals the JAX package's
  ``shard_checksums`` record (same index key, same position id, same
  CRC) on 8x1 and on 4x2 for tilings that give every position a block;
* ``flip_bit`` gives the JAX package's flipped array;
* strikes, quarantine and exoneration follow the JAX package's sequence
  (``note_violation``, fed the same implications);
* end to end on one CPU "card": the rotated mesh is a permutation of
  the logical positions and its re-walk computes the same values, so a
  healthy check is quiet and bit-equal; an injected flip is caught, the
  corrupt result never returned and the clean retry's is; the cadence
  rides ``FLAGS.profile_sample_every``; a position corrupting every
  sampled walk is quarantined after the strike count, and the loop
  finishes bit-equal to a clean run through the same quarantine;
* on a group mesh (gloo groups of 2 and 4 CPU processes): each rank's
  block record, gathered, equals the JAX package's ``shard_checksums``;
  a clean checked run is bit-equal to the flag-off run, with every
  rank's verdicts the same; under ``sdc@N#d`` the implicated positions
  per violation and the quarantined one equal the JAX package's
  sentinel's on the JAX mesh of the group's shape, and every rank
  raises the same quarantining error (a restart, ``fatal_mesh``); ranks
  whose ballots name different walks raise alike.
"""

import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.resilience import integrity as integrity_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J

import spartan_tpu_torch as st_t
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.expr import base as base_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.resilience import elastic as elastic_t
from spartan_tpu_torch.resilience import engine as engine_t
from spartan_tpu_torch.resilience import integrity as integrity_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)

A = np.arange(64, dtype=np.float32).reshape(8, 8)


@pytest.fixture(autouse=True)
def _world():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    names = ("retry_backoff_s", "integrity_check", "sdc_quarantine_strikes",
             "profile_sample_every")
    saved = {n: (getattr(FLAGS_T, n), getattr(FLAGS_J, n)) for n in names}
    FLAGS_T.retry_backoff_s = 0.0
    for mod in (integrity_t, integrity_j):
        mod.reset()
    engine_t.reset()
    st_t.chaos_clear()
    yield
    st_t.chaos_clear()
    for mod in (integrity_t, integrity_j):
        mod.reset()
    engine_t.reset()
    base_t.clear_plan_cache()
    mesh_t.reset_epoch_for_tests()
    for n, (vt, vj) in saved.items():
        setattr(FLAGS_T, n, vt)
        setattr(FLAGS_J, n, vj)
    mesh_t.set_default_device(prev)


def _counter(name):
    return st_t.metrics()["counters"].get(name, 0)


def _arm(sample_every=1, strikes=3):
    FLAGS_T.integrity_check = True
    FLAGS_T.profile_sample_every = sample_every
    FLAGS_T.sdc_quarantine_strikes = strikes


CASES = [((8, 1), ("x", None)), ((4, 2), ("x", "y")), ((2, 4), ("y", "x"))]


@pytest.mark.parametrize("shape,axes", CASES)
def test_block_checksums_equal_jax(shape, axes):
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)):
        xj = st_j.from_numpy(A, tiling=tiling_j.Tiling(axes)).evaluate()
        want = integrity_j.shard_checksums(xj._jax)
    got = integrity_t.shard_checksums(torch.from_numpy(A.copy()),
                                      tiling_t.Tiling(axes),
                                      mesh_t.build_mesh(shape, "cpu"))
    assert got == want and len(got) == 8


@pytest.mark.parametrize("shape,axes", CASES)
@pytest.mark.parametrize("victim,seed,occ", [(5, 7, 0), (0, 3, 9),
                                             (7, 11, 2)])
def test_flip_bit_gives_jax_flipped_array(shape, axes, victim, seed, occ):
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)):
        xj = st_j.from_numpy(A, tiling=tiling_j.Tiling(axes)).evaluate()
        want = np.asarray(integrity_j.flip_bit(xj._jax, victim, seed, occ))
    got = integrity_t.flip_bit(torch.from_numpy(A.copy()), victim, seed,
                               occ, [tiling_t.Tiling(axes)],
                               mesh_t.build_mesh(shape, "cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((got.numpy() != A).sum()) == 1


def test_replicated_output_is_held_by_chunks():
    # one tensor holds every position's copy on one card: each position
    # answers for its row-major chunk, and the flip lands in the
    # victim's chunk only
    mesh = mesh_t.build_mesh((4, 2), "cpu")
    t = torch.from_numpy(A.copy())
    recs = integrity_t.shard_checksums(t, tiling_t.replicated(2), mesh)
    assert [k for k, _, _ in recs] == [("chunk", 8 * i, 8 * i + 8)
                                       for i in range(8)]
    bad = integrity_t.flip_bit(t, 6, 1, 0, [tiling_t.replicated(2)], mesh)
    diff = np.nonzero((bad.numpy() != A).reshape(-1))[0]
    assert len(diff) == 1 and 48 <= diff[0] < 56


STRIKE_SEQS = [
    [[2, 5]],
    [[6, 1], [6, 4], [6, 2]],
    [[i % 16] for i in range(64)] + [[100 + (i % 16)] for i in range(33)],
    [[3], [3, 4], [4], [4], [3]],
]


@pytest.mark.parametrize("seq", STRIKE_SEQS, ids=range(len(STRIKE_SEQS)))
def test_strikes_quarantine_exoneration_follow_jax(seq):
    for flags in (FLAGS_T, FLAGS_J):
        flags.sdc_quarantine_strikes = 3
    got = [integrity_t.note_violation(s) for s in seq]
    want = [integrity_j.note_violation(s) for s in seq]
    assert got == want
    st, sj = integrity_t.status(), integrity_j.status()
    for key in ("strikes", "exonerated", "window", "threshold"):
        assert st[key] == sj[key], key


# -- end to end ---------------------------------------------------------------


def test_rotated_mesh_permutes_positions_and_rewalks_the_same():
    mesh = mesh_t.build_mesh((4, 2), "cpu")
    rot = mesh_t.rotated_mesh(mesh, 3)
    assert rot.shape == mesh.shape and rot.device == mesh.device
    assert rot.ids == (3, 4, 5, 6, 7, 0, 1, 2)
    assert mesh_t.rotated_mesh(mesh_t.build_mesh((1, 1), "cpu")) is None
    with mesh_t.use_mesh(mesh):
        x = st_t.from_numpy(A, tiling=tiling_t.row(2))
        e = st_t.dot(x, x) * 0.5 + 1.0
        want = e.glom()
        plan = base_t.lookup_plan(base_t.plan_signature(
            st_t.dot(x, x) * 0.5 + 1.0, mesh)[0])
        again = integrity_t._rewalk(plan, base_t.plan_leaves(plan), rot)
    np.testing.assert_array_equal(again.numpy(), want)


def test_null_case_bit_equal_and_quiet():
    _arm(sample_every=1)
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x = st_t.from_numpy(A, tiling=tiling_t.block(2))
        out = (x * 3.0).glom()
    np.testing.assert_array_equal(out, A * 3.0)
    s = integrity_t.status()
    assert s["checks"] == 1 and s["violations"] == 0 and s["strikes"] == {}
    (verdict,) = integrity_t.current().values()
    assert verdict["verdict"] == "ok"


def test_injected_sdc_detected_retried_and_clean():
    _arm(sample_every=1)
    v0 = _counter("integrity_violations")
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x = st_t.from_numpy(A, tiling=tiling_t.block(2))
        with st_t.chaos("sdc@0#5", seed=7) as plan:
            out = (x * 3.0).glom()
    np.testing.assert_array_equal(out, A * 3.0)  # never the corrupt one
    assert [f["kind"] for f in plan.fired] == ["sdc"]
    s = integrity_t.status()
    assert s["violations"] == 1 and s["checks"] == 2
    assert "5" in s["strikes"] and s["quarantined"] == []
    assert _counter("integrity_violations") == v0 + 1
    summary = integrity_t.take_last_check()
    assert summary["violations"] == 1 and 5 in summary["suspects"]


def test_cadence_rides_profile_sample_every():
    _arm(sample_every=4)
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x = st_t.from_numpy(np.ones((8, 8), np.float32))
        for _ in range(8):
            (x + 1.0).glom()
    assert integrity_t.status()["checks"] == 2


def _steps(x, c, n):
    for _ in range(n):
        c = (st_t.as_expr(c) * 0.5 + x).evaluate()
    return c


def test_repeat_offender_quarantined_and_bit_equal_to_clean():
    """Position 6 corrupts every sampled walk (cadence 2): the third
    violation quarantines it, the caller rehomes its arrays onto the
    rebuilt mesh, and the run ends bit-equal to a clean run through the
    same quarantine."""
    _arm(sample_every=2, strikes=3)
    q0 = _counter("integrity_quarantines")
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        base_t.clear_plan_cache()
        x = st_t.from_numpy(A, tiling=tiling_t.block(2)).evaluate()
        c = st_t.from_numpy(A * 0.1, tiling=tiling_t.block(2)).evaluate()
        # walk occurrences 1, 3 and 5 are the plan's 2nd, 4th and 6th
        # runs (each violation's retry is a run): each one is sampled
        with st_t.chaos("sdc@1#6,sdc@3#6,sdc@5#6", seed=3):
            c = _steps(x, c, 3)
            with pytest.raises(mesh_t.StaleMeshError):
                _steps(x, c, 3)
        hist = integrity_t.quarantine_history()
        assert [h["device"] for h in hist] == [6]
        assert hist[0]["strikes"] >= 3
        assert 6 not in mesh_t.get_mesh().ids
        elastic_t.rehome([x, c])
        out = _steps(x, c, 3).glom()
    assert _counter("integrity_quarantines") == q0 + 1
    # the clean run: the same steps, the same quarantine before the
    # step the sentinel interrupted
    FLAGS_T.integrity_check = False
    mesh_t.reset_epoch_for_tests()
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        base_t.clear_plan_cache()
        x = st_t.from_numpy(A, tiling=tiling_t.block(2)).evaluate()
        c = st_t.from_numpy(A * 0.1, tiling=tiling_t.block(2)).evaluate()
        c = _steps(x, c, 3)
        elastic_t.quarantine_device(6)
        elastic_t.rehome([x, c])
        ref = _steps(x, c, 3).glom()
    np.testing.assert_array_equal(out, ref)


# -- a group mesh -------------------------------------------------------------
#
# Gloo groups of 2 and 4 CPU processes (meshes 2x1 and 2x2), launched as
# tests/test_torch_local_storage.py launches them. Each rank runs
# _GROUP_CHILD and writes its records, verdicts and results; the parent
# holds them against each other and against the JAX package's sentinel
# on the JAX mesh of the group's shape.

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 240
GROUP_LAYOUTS = {"row": ("x", None), "col": (None, "y"), "block": ("x", "y"),
                 "rep": (None, None), "flat": (("x", "y"), None)}
R = np.arange(96, dtype=np.float32).reshape(12, 8) * 0.25
SDC_SPEC = "sdc@1#{d},sdc@3#{d},sdc@5#{d}"

_GROUP_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import spartan_tpu_torch as st
import torch.distributed as dist
from spartan_tpu_torch.array.tiling import Tiling
from spartan_tpu_torch.expr import base
from spartan_tpu_torch.parallel import mesh as mesh_mod
from spartan_tpu_torch.resilience import integrity
from spartan_tpu_torch.utils.config import FLAGS

st.set_default_device("cpu")
assert st.initialize_distributed() is True
mesh = st.get_mesh()
layouts = json.loads(os.environ["LAYOUTS"])
R = np.arange(96, dtype=np.float32).reshape(12, 8) * 0.25
out = {"rank": mesh.rank, "coords": [mesh.coords["x"], mesh.coords["y"]]}

# each rank's block record, gathered
recs = {}
for name, axes in layouts.items():
    t = Tiling([tuple(a) if isinstance(a, list) else a for a in axes])
    arr = st.from_numpy(R, tiling=t).evaluate()
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, integrity.block_records(arr, t, mesh))
    recs[name] = sorted(r for g in got for r in g)
out["records"] = recs

# the rotated mesh: every rank holds another position's coordinates
n = len(mesh.ids)
out["rotations"] = {}
for k in range(1, n):
    rot = mesh_mod.rotated_mesh(mesh, k)
    assert rot is mesh_mod.rotated_mesh(mesh, k)  # made once
    out["rotations"][k] = [rot.coords["x"], rot.coords["y"]]

verdicts, implicated = [], []
stamp, note = integrity._stamp, integrity.note_violation
integrity._stamp = lambda d, p, v: (verdicts.append(
    {k: v[k] for k in v if k not in ("t", "plan")}), stamp(d, p, v))[1]
integrity.note_violation = lambda imp: (implicated.append(list(imp)),
                                        note(imp))[1]


def steps(x, c, k):
    for _ in range(k):
        c = (st.as_expr(c) * 0.5 + x).evaluate()
    return c


FLAGS.opt_auto_tiling = False  # each map keeps its leaves' layout


FLAGS.retry_backoff_s = 0.0
cases = {"block": Tiling(("x", "y")), "rep": Tiling((None, None))}
for name, t in cases.items():
    x = st.from_numpy(R, tiling=t).evaluate()
    c0 = st.from_numpy(R * 0.1, tiling=t).evaluate()
    FLAGS.integrity_check = False
    want = steps(x, c0, 6).glom()
    integrity.reset()
    base.clear_plan_cache()
    verdicts.clear()
    FLAGS.integrity_check = True
    FLAGS.profile_sample_every = 2
    FLAGS.sdc_quarantine_strikes = 3
    got = steps(x, c0, 6).glom()
    out[f"clean_{name}"] = {
        "equal": bool(np.array_equal(got, want)),
        "checks": integrity.status()["checks"],
        "verdicts": list(verdicts), "moved": [
            [v.get("moved_sent"), v.get("moved_recv")] for v in verdicts]}
    integrity.reset()
    base.clear_plan_cache()
    verdicts.clear()
    implicated.clear()
    err = None
    q0 = st.metrics()["counters"].get("integrity_quarantines", 0)
    with st.chaos(os.environ["SDC"], seed=3):
        try:
            c = steps(x, c0, 3)
            steps(x, c, 3)
        except integrity.IntegrityError as e:
            err = {"quarantined": e.quarantined, "suspects": list(e.suspects),
                   "kind": getattr(e, "fault_kind", None)}
    FLAGS.integrity_check = False
    out[f"sdc_{name}"] = {
        "implicated": list(implicated), "error": err,
        "verdicts": list(verdicts),
        "history": [{k: h[k] for k in ("device", "strikes", "remedy")}
                    for h in integrity.quarantine_history()],
        "quarantines": st.metrics()["counters"].get(
            "integrity_quarantines", 0) - q0}

# the ballots' guard: ranks that checked different walks raise, alike
try:
    integrity._ballots(mesh, (("plan", mesh.rank, 1), [[]], [[]]))
    out["guard"] = None
except RuntimeError as e:
    out["guard"] = "checked different walks" in str(e)
st.shutdown()
with open(os.path.join(os.environ["OUT"], f"rank{mesh.rank}.json"), "w") as f:
    json.dump(out, f)
print("CHILD_OK", mesh.rank, flush=True)
"""


def _group_shape(world):
    return (2, 1) if world == 2 else (2, 2)


@functools.lru_cache(maxsize=None)
def _group_run(world: int):
    """Every rank's JSON of _GROUP_CHILD on a gloo group of ``world``."""
    tmp = tempfile.mkdtemp(prefix="integrity_group_")
    procs = []
    for rank in range(world):
        env = dict(os.environ, REPO=REPO, OUT=tmp,
                   LAYOUTS=json.dumps(GROUP_LAYOUTS),
                   SDC=SDC_SPEC.format(d=world - 1),
                   COORDINATOR_ADDRESS=f"file://{tmp}/store",
                   WORLD_SIZE=str(world), RANK=str(rank),
                   OMP_NUM_THREADS="1")
        for key in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
            env.pop(key, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _GROUP_CHILD], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=JOIN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:  # a hung rank fails the test
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"CHILD_OK {rank}" in log, log[-3000:]
    outs = []
    for rank in range(world):
        with open(os.path.join(tmp, f"rank{rank}.json")) as f:
            outs.append(json.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    return outs


def _as_tuples(obj):
    if isinstance(obj, list):
        return tuple(_as_tuples(o) for o in obj)
    return obj


def _jax_sdc(world, t_axes):
    """The JAX package's sentinel on the same stream on the JAX mesh of
    the group's shape: the implicated positions per violation and the
    quarantined one."""
    from spartan_tpu.resilience import engine as engine_j

    integrity_j.reset()
    engine_j.reset()
    implicated = []
    note = integrity_j.note_violation

    def spy(imp):
        implicated.append(list(imp))
        return note(imp)

    FLAGS_J.integrity_check = True
    FLAGS_J.opt_auto_tiling = False
    FLAGS_J.profile_sample_every = 2
    FLAGS_J.sdc_quarantine_strikes = 3
    FLAGS_J.retry_backoff_s = 0.0
    integrity_j.note_violation = spy
    quarantined = None
    try:
        mj = mesh_j.build_mesh(jax.devices()[:world],
                               shape=_group_shape(world))
        with mesh_j.use_mesh(mj):
            t = tiling_j.Tiling(t_axes)
            x = st_j.from_numpy(R, tiling=t).evaluate()
            c = st_j.from_numpy(R * 0.1, tiling=t).evaluate()
            with st_j.chaos(SDC_SPEC.format(d=world - 1), seed=3):
                try:
                    for _ in range(6):
                        c = (st_j.as_expr(c) * 0.5 + x).evaluate()
                except integrity_j.IntegrityError as e:
                    quarantined = e.quarantined
                except mesh_j.StaleMeshError:
                    quarantined = integrity_j.quarantine_history()[-1][
                        "device"]
    finally:
        integrity_j.note_violation = note
        FLAGS_J.integrity_check = False
        FLAGS_J.opt_auto_tiling = True
        st_j.chaos_clear()
        mesh_j.reset_epoch_for_tests()
    return implicated, quarantined


@pytest.mark.parametrize("world", [2, 4])
def test_group_block_records_equal_jax_shard_checksums(world):
    outs = _group_run(world)
    shape = _group_shape(world)
    mj = mesh_j.build_mesh(jax.devices()[:world], shape=shape)
    with mesh_j.use_mesh(mj):
        for name, axes in GROUP_LAYOUTS.items():
            xj = st_j.from_numpy(R, tiling=tiling_j.Tiling(axes)).evaluate()
            want = integrity_j.shard_checksums(xj._jax)
            for r in outs:
                assert _as_tuples(r["records"][name]) == tuple(want), name
    # rank r holds position ids[(p + k) % n]'s coordinates... as the
    # JAX package's rotated device assignment: position p on device
    # (p + k) % n
    ny = shape[1]
    for r in outs:
        for k, (i, j) in r["rotations"].items():
            assert (r["rank"] - int(k)) % world == i * ny + j


@pytest.mark.parametrize("world", [2, 4])
def test_group_clean_checks_bit_equal_and_alike_on_every_rank(world):
    outs = _group_run(world)
    for name in ("block", "rep"):
        key = f"clean_{name}"
        for r in outs:
            assert r[key]["equal"], (name, r["rank"])
            # 6 steps, every 2nd walk of a plan sampled
            assert r[key]["checks"] == len(r[key]["verdicts"]) >= 2
            assert all(v["verdict"] == "ok" for v in r[key]["verdicts"])
            assert r[key]["verdicts"] == outs[0][key]["verdicts"]
        # a split leaf moves to the rank holding its rotated block; a
        # replicated one does not
        moved = [m for r in outs for m in r[key]["moved"]]
        if name == "rep":
            assert all(m == [0, 0] for m in moved)
        else:
            assert all(m[0] > 0 and m[1] > 0 for m in moved)


@pytest.mark.parametrize("world", [2, 4])
def test_group_sdc_suspects_strikes_quarantine_equal_jax(world):
    outs = _group_run(world)
    for name, axes in (("block", ("x", "y")), ("rep", (None, None))):
        key = f"sdc_{name}"
        want_imp, want_q = _jax_sdc(world, axes)
        for r in outs:
            got = r[key]
            assert got["implicated"] == want_imp, (name, r["rank"])
            assert len(got["implicated"]) == 3
            assert got["error"]["quarantined"] == want_q
            assert got["error"]["kind"] == "sdc_quarantine"
            assert [h["device"] for h in got["history"]] == [want_q]
            assert got["history"][0]["remedy"] == "restart"
            assert got["quarantines"] == 1
            # every rank's verdicts, in order, are the same
            assert got["verdicts"] == outs[0][key]["verdicts"]
            assert got["error"] == outs[0][key]["error"]
        if name == "rep":
            # replicated copies outvote the corrupt one: the victim alone
            assert all(imp == [world - 1] for imp in want_imp)


@pytest.mark.parametrize("world", [2, 4])
def test_group_ranks_checking_different_walks_raise_alike(world):
    outs = _group_run(world)
    assert all(r["guard"] is True for r in outs)
