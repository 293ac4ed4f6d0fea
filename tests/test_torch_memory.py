"""The memory governor of the port (``resilience/memory.py``), on the CPU.

* ``estimate_report``'s JAX figures (``peak_bytes_per_chip``,
  ``args_bytes``, ``out_bytes``, ``temp_bytes`` and the top
  contributors) equal the JAX package's on DAGs where the two packages'
  rules agree (maps, a dot, reductions, a loop, a dot chain, a
  transpose), on 1x1, 4x2, 8x1 and 2x4, exactly;
* the port's own rules for ``peak_bytes_card`` against hand-computed
  numbers: a fused map's intermediates, a pre-reduce tree, the k-split
  on a group mesh (partial product and all-reduce result at once, the
  operands' relayout blocks), ``st.loop``'s re-walk of its body;
* the walk frees every value at its last consumer and stays bit-equal;
* the governor picks a rung under a set budget before anything runs,
  with no OOM raised, bit-equal to the same rung forced (on a logical
  mesh the chunked rung, the only one that changes what one card holds;
  on a gloo group of two CPU processes ``finer_tiling``);
* ``degrade.rung_predicted_bytes`` returns the modeled peak, and the
  budget is None on the CPU unless set.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.expr import base as base_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu_torch.analysis import plan_audit
from spartan_tpu_torch.expr import base as base_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.resilience import degrade as degrade_t
from spartan_tpu_torch.resilience import engine as engine_t
from spartan_tpu_torch.resilience import memory as mem_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 150
MESHES = [(1, 1), (4, 2), (8, 1), (2, 4)]
R = np.random.RandomState(11)
X = R.rand(256, 64).astype(np.float32)
Y = R.rand(256, 64).astype(np.float32)
A = R.rand(64, 64).astype(np.float32)
B = R.rand(64, 64).astype(np.float32)
W = R.rand(64, 64).astype(np.float32)
F32 = 4


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    saved = {n: getattr(FLAGS_T, n) for n in (
        "hbm_budget_bytes", "memory_governor", "oom_degrade")}
    st_t.chaos_clear()
    engine_t.reset()
    yield
    for n, v in saved.items():
        setattr(FLAGS_T, n, v)
    mesh_t.set_default_device(prev)


def _plan(base, e, mesh):
    key, rctx = base.plan_signature(e, mesh)
    plan = base.lookup_plan(key)
    if plan is None:
        plan, _, _ = base._build_plan(e, mesh, rctx, key)
    return plan


def _dags(st):
    x, y, a, b, w = (st.from_numpy(v) for v in (X, Y, A, B, W))
    return {
        "map": (x + y) * 3.0 - x,
        "dot": st.dot(a, b),
        "reduce_axis": (x * x).sum(axis=0),
        "reduce_all": (x + y).sum(),
        "loop": st.loop(10, lambda c: c * 0.5 + a, w),
        "chain": st.dot(st.dot(a, b) * 0.5 + 1.0, a).sum(axis=0),
        "transpose": st.transpose(x) * 2.0,
    }


_KEYS = ("peak_bytes_per_chip", "args_bytes", "out_bytes", "temp_bytes")


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ["map", "dot", "reduce_axis",
                                  "reduce_all", "loop", "chain",
                                  "transpose"])
def test_estimate_report_matches_jax(name, shape):
    n = shape[0] * shape[1]
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices()[:n],
                                           shape=shape)), \
            mesh_t.use_mesh(mesh_t.build_mesh(shape)):
        mj = _plan(base_j, _dags(st_j)[name],
                   mesh_j.get_mesh()).report["memory"]
        mt = _plan(base_t, _dags(st_t)[name],
                   mesh_t.get_mesh()).report["memory"]
    assert {k: mt[k] for k in _KEYS} == {k: mj[k] for k in _KEYS}
    assert [t["bytes"] for t in mt["top"]] == [t["bytes"] for t in
                                               mj["top"]]


# -- the port's rules, by hand ----------------------------------------------


def test_card_rule_fused_map_intermediates():
    # (x + y) * 3 - x, evaluated op by op: the add's result is held
    # while the multiply runs, so two output-sized values live at once
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x, y = st_t.from_numpy(X), st_t.from_numpy(Y)
        m = mem_t.predict((x + y) * 3.0 - x)
    out = X.size * F32
    assert m["peak_bytes_card"] == 2 * out + 4 + out + out
    assert m["card_args_bytes"] == 2 * out + 4  # x, y, the f32 scalar


def test_card_rule_pre_reduce_tree():
    # (x * x).sum(axis=0): the fused tree's product lives at operand size
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x = st_t.from_numpy(X)
        m = mem_t.predict((x * x).sum(axis=0))
    assert m["peak_bytes_card"] == X.size * F32 + 64 * F32 + X.size * F32


def test_card_rule_loop_rewalks_its_body():
    # the body c * 0.5 + a holds its product beside its output, and the
    # new carry lives beside the old one: carries + body peak
    with mesh_t.use_mesh(mesh_t.build_mesh((1, 1))):
        a, w = st_t.from_numpy(A), st_t.from_numpy(W)
        m = mem_t.predict(st_t.loop(10, lambda c: c * 0.5 + a, w))
    blk = A.size * F32
    args = 2 * blk + 4 + 4  # a, w, the int32 count, the f32 scalar
    assert m["peak_bytes_card"] == args + blk + (blk + blk)


def test_card_rule_ksplit_on_a_group():
    # a (n x n) product on a (2, 1) group, rows of both operands stored
    # per rank: the DP's k-split reads A in column blocks (a relayout
    # into a new block), B in ('x', 'y') (a clone of its block), holds
    # the whole partial product and the all-reduce's result at once
    n = 1024
    with mesh_t.use_mesh(mesh_t.build_mesh((2, 1))) as mesh:
        a = st_t.from_numpy(R.rand(n, n).astype(np.float32))
        b = st_t.from_numpy(R.rand(n, n).astype(np.float32))
        plan = _plan(base_t, st_t.dot(a, b), mesh)
        grid, k = plan.dag._dot_plan
        assert (grid.axes, k) == ((None, "y"), "x")
        got = mem_t.card_estimate(plan.dag, plan.out_tilings,
                                  plan_audit.dry_mesh(mesh))
    whole = n * n * F32
    half = whole / 2
    args = 2 * half
    assert got["peak_bytes_card"] == args + half + half + whole + whole
    # the logical mesh: one matmul, its output only
    assert plan.report["memory"]["peak_bytes_card"] == 3 * whole


# -- the walk frees values ----------------------------------------------------


def _chain(st, a, b):
    return (st.dot(st.dot(a, b) * 0.5 + 1.0, a) - 2.0).sum(axis=0)


def test_walk_frees_at_last_consumer_bit_equal():
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))) as mesh:
        a, b = st_t.from_numpy(A), st_t.from_numpy(B)
        base_t.clear_plan_cache()
        freed = _chain(st_t, a, b).glom()
        plan = _plan(base_t, _chain(st_t, a, b), mesh)
        env = base_t.walk_env(plan, base_t.plan_leaves(plan), mesh)
        out = plan.dag.lower(env)
        # only the leaves and the root's value are left in the env
        assert set(env) == set(plan.leaf_ids) | {plan.dag._id}
        assert out is env[plan.dag._id]
        base_t.FREE_AT_LAST_USE = False
        try:
            env = base_t.walk_env(plan, base_t.plan_leaves(plan), mesh)
            plan.dag.lower(env)
            assert len(env) > len(plan.leaf_ids) + 1
            base_t.clear_plan_cache()
            kept = _chain(st_t, a, b).glom()
        finally:
            base_t.FREE_AT_LAST_USE = True
    np.testing.assert_array_equal(freed, kept)


# -- the governor -------------------------------------------------------------


def _counter(name):
    return st_t.metrics()["counters"].get(name, 0)


def test_budget_is_none_on_the_cpu_unless_set():
    FLAGS_T.hbm_budget_bytes = 0
    assert mem_t.hbm_budget_bytes() is None
    FLAGS_T.hbm_budget_bytes = 12345
    assert mem_t.hbm_budget_bytes() == 12345


def test_governor_picks_chunked_before_dispatch_on_a_logical_mesh():
    # on one card every position's block lives in one tensor, so only
    # the chunked rung changes what the card holds at once: with every
    # modeled rung over the budget, the governor takes it before the
    # plan runs, and nothing raises an OOM
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x, y = st_t.from_numpy(X), st_t.from_numpy(Y)
        e = (x + y) * 3.0 - x
        need = mem_t.predict(e)["peak_bytes_card"]
        # the governor judges a plan on its miss
        base_t.clear_plan_cache()
        FLAGS_T.hbm_budget_bytes = need - 1
        oom0 = _counter("resilience_oom_events")
        pd0 = _counter("resilience_predictive_degrades")
        got = e.glom()
        assert e._resilience["rung"] == "chunked"
        assert e._resilience["origin"] == "predictive"
        assert _counter("resilience_oom_events") == oom0
        assert _counter("resilience_predictive_degrades") == pd0 + 1
        # a hit of the same structure is redirected to its rung
        rd0 = _counter("memory_governor_redirects")
        x2, y2 = st_t.from_numpy(X), st_t.from_numpy(Y)
        e2 = (x2 + y2) * 3.0 - x2
        np.testing.assert_array_equal(e2.glom(), got)
        assert _counter("memory_governor_redirects") == rd0 + 1
        rep = str(st_t.explain(st_t.from_numpy(X) * 1.0))
        FLAGS_T.hbm_budget_bytes = 0
        forced = degrade_t._chunked_evaluate(
            (st_t.from_numpy(X) + st_t.from_numpy(Y)) * 3.0
            - st_t.from_numpy(X), mesh_t.get_mesh()).glom()
    np.testing.assert_array_equal(got, forced)
    assert "memory: predicted peak" in rep


def test_within_budget_runs_ungoverned():
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x = st_t.from_numpy(X)
        e = x * 2.0
        FLAGS_T.hbm_budget_bytes = mem_t.predict(e)["peak_bytes_card"]
        base_t.clear_plan_cache()
        np.testing.assert_array_equal(e.glom(), X * 2.0)
    assert getattr(e, "_resilience", None) is None


def test_rung_predicted_bytes_is_the_model():
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))) as mesh:
        x = st_t.from_numpy(X)
        e = x * 2.0 + 1.0
        with st_t.chaos("oom@0"):
            e.glom()
        assert e._resilience["rung"] == "finer_tiling"
        want = mem_t._rung_estimate(x * 2.0 + 1.0, "finer_tiling",
                                    mesh)[1]
        assert e._resilience["rung_predicted_bytes"] == want > 0
        assert degrade_t.rung_predicted_bytes(
            x * 2.0 + 1.0, "finer_tiling", mesh) == want


_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import spartan_tpu_torch as st
from spartan_tpu_torch.expr import base
from spartan_tpu_torch.resilience import degrade
from spartan_tpu_torch.resilience import memory as mem

st.set_default_device("cpu")
assert st.initialize_distributed() is True
mesh = st.get_mesh()
rng = np.random.RandomState(5)
A = rng.rand(256, 256).astype(np.float32)
B = rng.rand(256, 256).astype(np.float32)
build = lambda: st.dot(st.from_numpy(A), st.from_numpy(B))
normal = mem.predict(build())["peak_bytes_card"]
finer = mem._rung_estimate(build(), "finer_tiling", mesh)[1]
base.clear_plan_cache()  # the governor judges a plan on its miss
st.FLAGS.hbm_budget_bytes = (normal + finer) // 2
oom0 = st.metrics()["counters"].get("resilience_oom_events", 0)
e = build()
got = e.glom()
out = {"normal": normal, "finer": finer, "rung": e._resilience["rung"],
       "origin": e._resilience["origin"],
       "oom": st.metrics()["counters"].get("resilience_oom_events", 0)
       - oom0}
st.FLAGS.hbm_budget_bytes = 0
with degrade._RungCtx("finer_tiling"):
    forced = base.evaluate(degrade.clone_for_replan(build())).glom()
out["bit_equal"] = bool(np.array_equal(got, forced))
out["close"] = bool(np.allclose(got, A.astype(np.float64) @ B, rtol=1e-4))
st.shutdown()
with open(os.path.join(os.environ["OUT"], f"rank{mesh.rank}.json"),
          "w") as f:
    json.dump(out, f)
print("CHILD_OK", mesh.rank, flush=True)
"""


def test_governor_picks_finer_tiling_on_a_gloo_group(tmp_path):
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
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            got = json.load(f)
        # the k-split's partial product and all-reduce result against
        # the finer grid's gathered B and half-size output block
        assert got["finer"] < got["normal"]
        assert got["rung"] == "finer_tiling"
        assert got["origin"] == "predictive" and got["oom"] == 0
        assert got["bit_equal"] and got["close"]


def test_card_rule_halo_stencil_stages_its_blocks():
    # the kernel path of an H-tiled stencil pads each of the p H-shards
    # with its halo rows into one staging tensor beside its output
    from spartan_tpu_torch.kernels import stencil as kstencil

    img = R.rand(2, 32, 8, 4).astype(np.float32)
    flt = R.rand(3, 3, 4, 4).astype(np.float32)
    prev = FLAGS_T.native_kernels
    FLAGS_T.native_kernels = "on"
    try:
        with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
            x = st_t.from_numpy(img, tiling=st_t.Tiling((None, "x", None,
                                                         None)))
            m = mem_t.predict(st_t.stencil(x, flt))
    finally:
        FLAGS_T.native_kernels = prev
    blocks = int(np.prod(kstencil.halo_blocks_shape(img.shape, 3, 3, 8)))
    assert blocks == 8 * 2 * (4 + 2) * (8 + 2) * 4
    out = img.size // 4 * 4
    assert m["peak_bytes_card"] == (img.size + flt.size + out + blocks) * F32


def test_card_rule_fills_gathers_and_writes_on_a_group():
    # what each new local rule holds beside its input and output blocks
    # on a (2, 1) group, at each rank's position
    from spartan_tpu_torch.expr.filter import GatherExpr
    from spartan_tpu_torch.utils import philox

    sq = R.rand(16, 16).astype(np.float32)
    pts = R.rand(2048, 128).astype(np.float32)
    cols = st_t.Tiling((None, "x"))
    with mesh_t.use_mesh(mesh_t.build_mesh((2, 1))) as mesh:
        rnd = st_t.rand(64, 16, seed=1)
        big = st_t.randn(2 ** 21, 2, seed=2)
        ar = st_t.arange(1000)
        eye = st_t.eye(16, 12, 1)
        g = st_t.as_expr(st_t.from_numpy(pts))[np.array([2047, 3, 1500, 3,
                                                         900])]
        assert isinstance(g, GatherExpr)
        w = st_t.assign(st_t.from_numpy(sq), (slice(4, 12), slice(0, 16)),
                        st_t.from_numpy(sq[:8], tiling=cols))
        wb = st_t.assign(st_t.from_numpy(sq), (slice(6, 14), slice(0, 16)),
                         st_t.from_numpy(sq[0]), "add")
        wh = st_t.assign(st_t.from_numpy(sq), (slice(4, 12), slice(0, 16)),
                         st_t.from_numpy(sq[:8],
                                         tiling=st_t.Tiling(("x", None))))
        for pos in (0, 1):
            dm = plan_audit.dry_mesh(mesh)
            dm.coords = {"x": pos, "y": 0}
            # a draw's six word buffers over its block (one chunk at most)
            assert rnd.card_staging(dm) == 48 * 32 * 16
            assert big.card_staging(dm) == 48 * philox.CHUNK
            assert ar.card_staging(dm) == 8 * 500  # the int64 iota
            assert eye.card_staging(dm) == 0
            # the gather: own rows (3 and 2 rows of 64 columns), then the
            # send and receive buffers together (192 + 128 elements), and
            # the index vector of the largest piece (3 rows)
            assert g.card_staging(dm) == max((3, 2)[pos] * 64 * F32,
                                             (192 + 128) * F32) + 8 * 3
            # the source's part (4 x 16) once moved, and the exchange's
            # buffers while it moves (32 elements each way)
            assert w.card_staging(dm) == 64 * F32 + 64 * F32
            # a broadcast source: its (1 x 16) part, then the add's
            # result over the rank's part of the region (2 and 6 rows)
            assert wb.card_staging(dm) == 16 * F32 + max(
                16 * F32, (2, 6)[pos] * 16 * F32)
            # a source each rank holds where it writes: its (4 x 16)
            # part copied out of its block, and no exchange
            assert wh.card_staging(dm) == 64 * F32
    # a logical mesh holds the whole draw's chunk and no exchange
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))) as mesh:
        assert st_t.rand(64, 16).card_staging(mesh) == 48 * 64 * 16
        assert g.card_staging(mesh) == 0.0
        assert w.card_staging(mesh) == 0.0
