"""The plan audit (``st.audit_plan``) of the port, on the CPU.

The JAX package reads a plan's collectives out of post-GSPMD HLO; the
port lists them by a dry walk of the plan's group lowering on ``meta``
tensors (``spartan_tpu_torch/analysis/plan_audit.py``). Held here:

* the k-split dot's ``all-reduce`` against the JAX audit in kind, group
  size and modeled bytes, on 4x2, 8x1 and 2x4 (the relayouts around it
  are the port's own: GSPMD picks other moves);
* the H-sharded stencil issues only ``collective-permute``s on 8x1, as
  in the JAX package;
* on a gloo group of two CPU processes, every plan's audit equals what
  its walk counts in ``collective_calls{op}``/``collective_bytes{op}``,
  call for call and byte for byte, and its ``full_gather`` findings
  equal the walk's ``group_materialize_calls{site}``; the audit on the
  logical mesh of the group's shape gives the same list. The local rules
  of the structure ops, outer, the scan, a user reduce, pooling, batched
  sorts, the builtin maps, ``dot_shardmap`` and the proven user
  functions (a flip, a mean over the rows, the trace, ALS's half-step,
  a whole-shape constant, the masked median along either axis) find no
  ``full_gather``; a user function's ``map2`` scanning its rows is the
  planted gather. This is the oracle for the planted gathers: the JAX
  package's own traced-start case is red on this tree (ROADMAP C1);
* for each user function of the group-gather table, on 8x1 and 4x2,
  ``full_gather`` exactly where the JAX audit finds one, and the same
  count of all-reduces where GSPMD's is a sum over the split rows;
* the memoized verdict, the explain table, the miss-path hook and the
  port's ``missed_donation`` semantics (ROADMAP C35).
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
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu_torch.analysis import plan_audit
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.expr import base as base_t
from spartan_tpu_torch.obs.metrics import REGISTRY
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 150
MESHES = [(4, 2), (8, 1), (2, 4)]
RNG = np.random.RandomState(7)
A = RNG.rand(32, 32).astype(np.float32)
B = RNG.rand(32, 32).astype(np.float32)
IMG = RNG.rand(1, 32, 16, 4).astype(np.float32)
FLT = RNG.rand(3, 3, 4, 4).astype(np.float32)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)


def _counter(name):
    return REGISTRY.counter_values().get(name, 0)


def _both(shape):
    return (mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)),
            mesh_t.use_mesh(mesh_t.build_mesh(shape)))


def _ksplit_dot(st, tm):
    a = st.from_numpy(A, tiling=tm.row(2))
    b = st.from_numpy(B, tiling=tm.row(2))
    return st.dot(a, b)


@pytest.mark.parametrize("shape", MESHES)
def test_ksplit_all_reduce_matches_jax(shape):
    mj, mt = _both(shape)
    with mj, mt:
        aj = st_j.audit_plan(_ksplit_dot(st_j, tiling_j))
        at = st_t.audit_plan(_ksplit_dot(st_t, tiling_t))
    red_j = [(c["kind"], c["group_size"], c["bytes_moved"])
             for c in aj.collectives if c["kind"] == "all-reduce"]
    red_t = [(c["kind"], c["group_size"], c["bytes_moved"])
             for c in at.collectives if c["kind"] == "all-reduce"]
    assert red_t == red_j and len(red_t) == 1
    assert at.findings == [] and aj.findings == []
    # attributed to the dot node, with its scope digest and build site
    dot = [c for c in at.collectives if c["kind"] == "all-reduce"][0]
    assert dot["node"].startswith("DotExpr#") and dot["scope_digest"]
    assert __file__ in dot["source"]
    # the all-reduce's operand is the (32, 32) f32 partial product's
    # block; the ring model doubles its (g-1)/g share
    g = dot["group_size"]
    assert dot["bytes_moved"] == 2.0 * dot["operand_bytes"] * (g - 1) / g


def test_stencil_halo_permutes_only():
    mj, mt = _both((8, 1))
    with mj, mt:
        aj = st_j.audit_plan(st_j.stencil(st_j.from_numpy(
            IMG, tiling=tiling_j.Tiling((None, "x", None, None))), FLT))
        at = st_t.audit_plan(st_t.stencil(st_t.from_numpy(
            IMG, tiling=tiling_t.Tiling((None, "x", None, None))), FLT))
    assert at.multiset == aj.multiset == {"collective-permute": 2}
    # one halo slab each way: the same payload, one send per position
    assert sorted(c["bytes_moved"] for c in at.collectives) == sorted(
        c["bytes_moved"] for c in aj.collectives)
    assert all(c["node"].startswith("StencilExpr#")
               for c in at.collectives)
    assert not at.findings


def test_verdict_memoized_and_rendered():
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        a = st_t.from_numpy(A, tiling=tiling_t.row(2))
        e = st_t.dot(a, a) + 5.0
        runs0, cached0 = _counter("audit_runs"), _counter("audit_cached")
        first = st_t.audit_plan(e)
        second = st_t.audit_plan(e)
        assert _counter("audit_runs") - runs0 == 1
        assert _counter("audit_cached") - cached0 == 1
        assert second.multiset == first.multiset
        assert second.comm_bytes == first.comm_bytes > 0
        rep = str(st_t.explain(e))
    assert "plan audit:" in rep and "DotExpr" in rep and "all-reduce" in rep
    # the verdict is JSON-safe (it rides the persist store)
    json.dumps(first.to_dict())
    assert plan_audit.PlanAudit.from_dict(first.to_dict()).multiset == \
        first.multiset


def test_verify_evaluate_audits_the_miss_only():
    prev = FLAGS_T.verify_evaluate
    FLAGS_T.verify_evaluate = True
    try:
        with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
            base_t.clear_plan_cache()
            runs0 = _counter("audit_runs")
            x = RNG.rand(16, 8).astype(np.float32)
            got = (st_t.transpose(st_t.from_numpy(x)) * 2.0).glom()
            assert _counter("audit_runs") - runs0 == 1
            (st_t.transpose(st_t.from_numpy(x)) * 2.0).glom()  # a hit
            assert _counter("audit_runs") - runs0 == 1
    finally:
        FLAGS_T.verify_evaluate = prev
    np.testing.assert_array_equal(got, x.T * 2.0)


def _flip(v):
    return v.flip(0)


def _cumsum(v):
    return v.cumsum(0)


def test_planted_gather_is_a_full_gather_finding():
    # a user function's map2 that is not proven row-partitionable (a
    # scan along the rows; the JAX package all-gathers it too) gathers
    # its operand whole
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        x = st_t.from_numpy(RNG.rand(16, 8).astype(np.float32))
        au = st_t.audit_plan(st_t.map2([x], _cumsum) + 1.0)
    hits = [f for f in au.findings if f.kind == "full_gather"]
    assert len(hits) == 1
    f = hits[0]
    assert f.node.startswith("Map2Expr#") and "Map2Expr" in f.message
    assert f.bytes == 16 * 8 * 4 and __file__ in f.source
    assert au.multiset.get("all-gather", 0) >= 1


def test_a_proven_map2_is_one_all_reduce_and_no_gather():
    # logistic_grad's map2 is proven row-partitionable: the dry walk
    # runs its program on the row blocks (X relaid from its block tiling
    # by all-gathers over y) and all-reduces the partial gradient once
    from spartan_tpu_torch.examples import regression

    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x = st_t.from_numpy(RNG.rand(64, 8).astype(np.float32))
        y = st_t.from_numpy((RNG.rand(64) > 0.5).astype(np.float32))
        w = st_t.from_numpy(RNG.rand(8).astype(np.float32),
                            tiling=tiling_t.replicated(1))
        au = st_t.audit_plan(regression.logistic_grad(x, y, w))
    assert not [f for f in au.findings if f.kind == "full_gather"]
    assert au.multiset.get("all-reduce", 0) == 1
    red = [c for c in au.collectives if c["kind"] == "all-reduce"]
    assert red[0]["node"].startswith("Map2Expr#")
    assert red[0]["operand_bytes"] == 8 * 4 and red[0]["group_size"] == 4


def test_the_naive_bayes_fit_is_one_all_reduce_and_no_gather():
    # the fit's segment sums are proven over the rows (the scatter under
    # native_kernels=auto, the block kernel's operator under on): the
    # dry walk replays them on the row blocks and all-reduces the
    # (k, d + 1) partial counts once
    from spartan_tpu_torch.examples import naive_bayes

    prev = FLAGS_T.native_kernels
    try:
        for mode in ("auto", "on"):
            FLAGS_T.native_kernels = mode
            with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
                x = st_t.from_numpy(np.floor(RNG.rand(64, 8) * 5.0)
                                    .astype(np.float32))
                y = st_t.from_numpy((np.arange(64) % 3).astype(np.int32))
                au = st_t.audit_plan(st_t.map2(
                    [x, y], naive_bayes._fit_kern(3),
                    out_tiling=tiling_t.replicated(2)))
            assert not [f for f in au.findings if f.kind == "full_gather"]
            red = [c for c in au.collectives if c["kind"] == "all-reduce"]
            assert len(red) == 1 and red[0]["node"].startswith("Map2Expr#")
            assert red[0]["operand_bytes"] == 3 * 9 * 4
    finally:
        FLAGS_T.native_kernels = prev


def test_replicated_intermediate_over_the_threshold():
    prev = FLAGS_T.replication_warn_bytes
    FLAGS_T.replication_warn_bytes = 100
    try:
        with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
            base_t.clear_plan_cache()  # a memoized verdict of this shape
            x = st_t.from_numpy(RNG.rand(16, 8).astype(np.float32))
            au = st_t.audit_plan(st_t.map2([x], _flip) * 3.0)
    finally:
        FLAGS_T.replication_warn_bytes = prev
    rep = [f for f in au.findings if f.kind == "replicated_intermediate"]
    assert rep and all(f.bytes > 100 for f in rep)


def test_missed_donation_follows_the_ports_semantics():
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        y = st_t.from_numpy(RNG.rand(8, 8).astype(np.float32))
        ok = st_t.audit_plan(st_t.as_expr(y) * 2.0, donate=[y])
        assert ok.donation == {"requested": [0], "aliased": [0]}
        assert not [f for f in ok.findings if f.kind == "missed_donation"]
        # a donated array the plan never reads: nothing frees it
        z = st_t.from_numpy(RNG.rand(8, 8).astype(np.float32))
        miss = st_t.audit_plan(st_t.as_expr(y) + 1.0, donate=[z])
        assert [f for f in miss.findings if f.kind == "missed_donation"]
        # a leaf whose storage another live tensor shares: freeing it
        # releases nothing
        w = st_t.from_numpy(RNG.rand(8, 8).astype(np.float32)).evaluate()
        view = w.tensor[1:]  # noqa: F841 - held to share the storage
        shared = st_t.audit_plan((st_t.as_expr(w) * 4.0).sum(), donate=[w])
        assert shared.donation["requested"] == [0]
        assert shared.donation["aliased"] == []
        assert [f for f in shared.findings
                if f.kind == "missed_donation"]


# -- a gloo group of two CPU processes --------------------------------------

_CHILD = r"""
import json, os, sys
sys.path.insert(0, os.environ["REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
import spartan_tpu_torch as st
from spartan_tpu_torch.examples import kmeans as km
import importlib
metrics_mod = importlib.import_module("spartan_tpu_torch.obs.metrics")

st.set_default_device("cpu")
# the kernel forms (their plain versions on the CPU): k-means takes its
# fused node, which has a local rule, as on the card
st.FLAGS.native_kernels = "on"
assert st.initialize_distributed() is True
mesh = st.get_mesh()
assert mesh.is_group
ns = {}
exec(os.environ["CASES"], ns)
out = {}
for name, build in ns["cases"](st, km).items():
    audit = st.audit_plan(build())
    before = dict(st.REGISTRY.counter_values())
    build().evaluate()
    counted = {}
    for k, v in st.REGISTRY.counter_values().items():
        d = v - before.get(k, 0)
        if d:
            base, labels = metrics_mod.parse_labels(k)
            lab = labels.get("op", labels.get("site", ""))
            counted.setdefault(base, {})[lab] = d
    out[name] = {"audit": audit.to_dict(),
                 "findings": [f.to_dict() for f in audit.findings],
                 "counted": counted}
st.shutdown()
with open(os.path.join(os.environ["OUT"], f"rank{mesh.rank}.json"),
          "w") as f:
    json.dump(out, f)
print("CHILD_OK", mesh.rank, flush=True)
"""

_CASES = r"""
import numpy as np
import torch

def cases(st, km):
    from spartan_tpu_torch.array import masked
    from spartan_tpu_torch.examples import als
    from spartan_tpu_torch.examples import naive_bayes as nb

    rng = np.random.RandomState(3)
    a = rng.rand(16, 256).astype(np.float32)
    b = rng.rand(256, 16).astype(np.float32)
    keys = rng.rand(4096).astype(np.float32)
    pts = rng.rand(2048, 128).astype(np.float32)
    c0 = pts[:4].copy()
    x = rng.rand(16, 8).astype(np.float32)
    sq = rng.rand(16, 16).astype(np.float32)
    img = rng.rand(2, 16, 6, 4).astype(np.float32)
    batch = rng.rand(4, 512).astype(np.float32)
    rows, cols = st.Tiling(("x", None)), st.Tiling((None, "x"))
    hx = st.Tiling((None, "x", None, None))
    return {
        # a long contraction, split over the ranks (a k-split)
        "dot": lambda: st.dot(st.from_numpy(a, tiling=cols),
                              st.from_numpy(b, tiling=rows)),
        "sort": lambda: st.sort(st.from_numpy(keys)),
        "kmeans": lambda: km.kmeans_step(st.from_numpy(pts),
                                         st.from_numpy(c0), 4),
        "transpose": lambda: st.transpose(st.from_numpy(x)) * 2.0 + 1.0,
        # naive Bayes's fit: its segment sums proven over the rows, the
        # (k, d + 1) partial counts all-reduced once
        "nb_fit": lambda: st.map2(
            [st.from_numpy(np.floor(pts[:, :8] * 5.0)),
             st.from_numpy((np.arange(2048) % 4).astype(np.int32))],
            nb._fit_kern(4), out_tiling=st.Tiling((None, None))),
        # not proven: a user function scanning its rows reads its
        # operand whole
        "user_map2": lambda: st.map2([st.from_numpy(x)],
                                     lambda v: v.cumsum(0)) + 1.0,
        # proven user functions: a flip (the mirrored rows moved), a
        # mean over the rows and the trace (one all-reduce each), a
        # whole-shape constant, ALS's half-step, the masked median
        "user_flip": lambda: st.map2([st.from_numpy(x)],
                                     lambda v: v.flip(0)) + 1.0,
        "user_mean": lambda: st.map2([st.from_numpy(x)],
                                     lambda v: v - v.mean(0)),
        "user_trace": lambda: st.trace(st.from_numpy(sq), 2),
        "user_shape": lambda: st.map(lambda v: v / v.shape[0],
                                     st.from_numpy(x)),
        "user_als": lambda: st.map2(
            [st.from_numpy(np.floor(pts[:64, :12] * 3.0)),
             st.from_numpy(pts[:12, :3].copy(),
                           tiling=st.Tiling((None, None)))],
            als._solve_side, fn_kw={"reg": 0.1}),
        "median_ax1": lambda: st.median(masked.MaskedDistArray(
            st.from_numpy(batch, tiling=rows),
            st.from_numpy(batch > 0.9, tiling=rows)), axis=1),
        "median_ax0": lambda: st.median(masked.MaskedDistArray(
            st.from_numpy(batch, tiling=rows),
            st.from_numpy(batch > 0.9, tiling=rows)), axis=0),
        # one case per local rule of the structure ops and the rest
        "reshape": lambda: st.reshape(st.from_numpy(x), (8, 16)) * 2.0,
        "ravel": lambda: st.ravel(st.from_numpy(x)).sum(),
        "concat": lambda: st.concatenate([st.from_numpy(x),
                                          st.from_numpy(x)], 0),
        "concat1": lambda: st.concatenate([st.from_numpy(x),
                                           st.from_numpy(x)], 1),
        "slice": lambda: st.from_numpy(sq)[::2, ::-1] + 1.0,
        "outer": lambda: st.outer(st.from_numpy(keys[:64]),
                                  st.from_numpy(keys[64:96])),
        "cumsum": lambda: st.cumsum(st.from_numpy(x), 0),
        "ureduce": lambda: st.reduce(
            st.from_numpy(x), axis=0,
            local_reduce_fn=lambda v, axis: torch.amax(v, dim=axis),
            accumulate_fn=np.maximum),
        "maxpool": lambda: st.maxpool(st.from_numpy(img, tiling=hx), 3, 1,
                                      "SAME"),
        "bsort": lambda: st.sort(st.from_numpy(batch, tiling=cols)),
        "bargsort": lambda: st.argsort(st.from_numpy(batch, tiling=cols)),
        "tril": lambda: st.tril(st.from_numpy(sq), 1),
        "diagonal": lambda: st.diagonal(st.from_numpy(sq)) * 2.0,
        "histogram": lambda: st.histogram(st.from_numpy(sq), 16)[0],
        "dot_shardmap": lambda: st.dot_shardmap(st.from_numpy(sq),
                                                st.from_numpy(sq)),
        "rand": lambda: st.rand(64, 16, seed=3) * 2.0,
        "randint": lambda: st.randint(33, 8, low=0, high=5, seed=4),
        "arange": lambda: st.arange(1000) + 1,
        "eye": lambda: st.eye(16, 12, 1),
        "gather": lambda: st.from_numpy(pts)[np.array([2047, 3, 1500, 3,
                                                       900])],
        "gather_cols": lambda: st.from_numpy(sq, tiling=cols)[
            np.array([15, 0, 7])],
        "assign": lambda: st.assign(st.from_numpy(sq), (slice(4, 12),
                                                        slice(0, 16)),
                                    st.from_numpy(sq[:8], tiling=cols)),
        "assign_bcast": lambda: st.assign(st.from_numpy(sq),
                                          (slice(6, 14), slice(0, 16)),
                                          st.from_numpy(sq[0]), "add"),
    }
"""

_RULES = ("nb_fit", "transpose", "reshape", "ravel", "concat", "concat1", "slice",
          "outer", "cumsum", "ureduce", "maxpool", "bsort", "bargsort",
          "tril", "diagonal", "histogram", "dot_shardmap", "rand",
          "randint", "arange", "eye", "gather", "gather_cols", "assign",
          "assign_bcast", "user_flip", "user_mean", "user_trace",
          "user_shape", "user_als", "median_ax1", "median_ax0")

# cases whose ranks send different byte counts (the rows the indices
# take split unevenly over the ranks)
_UNEVEN = ("gather",)

_KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "all_to_all": "all-to-all", "ring_permute": "collective-permute",
         "reduce_scatter": "reduce-scatter"}


def test_audit_equals_the_counted_collectives_on_a_gloo_group(tmp_path):
    procs = []
    for rank in range(2):
        env = dict(os.environ, REPO=REPO, OUT=str(tmp_path), CASES=_CASES,
                   COORDINATOR_ADDRESS=f"file://{tmp_path / 'store'}",
                   WORLD_SIZE="2", RANK=str(rank), OMP_NUM_THREADS="1")
        for key in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
            env.pop(key, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    # meanwhile: the same plans' audits on the logical mesh of the
    # group's shape
    from spartan_tpu_torch.examples import kmeans as km_t

    ns = {}
    exec(_CASES, ns)
    prev = FLAGS_T.native_kernels
    FLAGS_T.native_kernels = "on"
    try:
        with mesh_t.use_mesh(mesh_t.build_mesh((2, 1))):
            logical = {name: st_t.audit_plan(build())
                       for name, build in ns["cases"](st_t, km_t).items()}
    finally:
        FLAGS_T.native_kernels = prev
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
        for name, rec in got.items():
            audit = plan_audit.PlanAudit.from_dict(rec["audit"])
            counted = rec["counted"]
            calls = {_KIND[k]: v for k, v in
                     counted.get("collective_calls", {}).items()}
            nbytes = {_KIND[k]: v for k, v in
                      counted.get("collective_bytes", {}).items()}
            assert audit.multiset == calls, (name, rank)
            assert audit.operand_bytes() == nbytes, (name, rank)
            sites = counted.get("group_materialize_calls", {})
            gathers = {}
            for f in audit.findings:
                if f.kind == "full_gather":
                    site = f.message.split(" for ")[1].split(",")[0]
                    gathers[site] = gathers.get(site, 0) + 1
            assert gathers == sites, (name, rank)
            # the logical mesh's audit (position (0, 0)) lists the same
            # calls (for an uneven case, the other rank's byte counts
            # are its own)
            lg = logical[name]
            if rank and name in _UNEVEN:
                assert [(c["kind"], c["group_size"])
                        for c in lg.collectives] == [
                    (c["kind"], c["group_size"])
                    for c in audit.collectives], name
                continue
            assert [(c["kind"], c["operand_bytes"], c["group_size"])
                    for c in lg.collectives] == [
                (c["kind"], c["operand_bytes"], c["group_size"])
                for c in audit.collectives], name
        assert got["dot"]["audit"]["multiset"].get("all-reduce", 0) >= 1
        assert got["sort"]["audit"]["multiset"].get("all-to-all", 0) >= 2
        assert not [f for f in got["kmeans"]["findings"]
                    if f["kind"] == "full_gather"]
        assert got["nb_fit"]["audit"]["multiset"] == {"all-reduce": 1}
        for name in ("user_mean", "user_trace"):
            assert got[name]["audit"]["multiset"] == {"all-reduce": 1}, name
        assert got["user_flip"]["audit"]["multiset"] == {"all-to-all": 1}
        for name in ("user_shape", "user_als", "median_ax1"):
            assert got[name]["audit"]["multiset"] == {}, name
        assert [f for f in got["user_map2"]["findings"]
                if f["kind"] == "full_gather"]
        # each local rule: no whole gather, and collectives where the
        # rule moves data between the ranks
        for name in _RULES:
            assert not [f for f in got[name]["findings"]
                        if f["kind"] == "full_gather"], (name, rank)
        for name in ("reshape", "concat", "slice", "outer", "cumsum",
                     "ureduce", "maxpool", "bsort", "histogram",
                     "dot_shardmap", "gather", "assign"):
            assert got[name]["audit"]["collectives"], (name, rank)
        # a fill makes its block and moves nothing; a gather of rows from
        # column blocks reads each rank's own columns
        for name in ("rand", "randint", "arange", "eye", "gather_cols"):
            assert not got[name]["audit"]["collectives"], (name, rank)
        assert got["maxpool"]["audit"]["multiset"] == {
            "collective-permute": 2}


# -- the group-gather table against the JAX audit ---------------------------

_TX = RNG.rand(1024, 16).astype(np.float32)
_TR = (np.floor(RNG.rand(1024, 64) * 5.0)
       * (RNG.rand(1024, 64) > 0.5)).astype(np.float32)
_TV = (0.1 * RNG.rand(64, 4)).astype(np.float32)
_TSQ = RNG.rand(256, 256).astype(np.float32)
_TM = RNG.rand(2048, 32).astype(np.float32)
_TMK = RNG.rand(2048, 32) > 0.9
_TA = RNG.rand(1024, 8).astype(np.float32)


def _table(st, tm, masked, als, pkg):
    """Each function of the group-gather table over row-split operands
    (``pkg`` "jax" or "torch" for the functions written per package)."""
    import jax.numpy as jnp

    rows = tm.Tiling(("x", None))
    x = st.from_numpy(_TX, tiling=rows)
    r = st.from_numpy(_TR, tiling=rows)
    v = st.from_numpy(_TV, tiling=tm.replicated(2))
    m = masked.MaskedDistArray(st.from_numpy(_TM, tiling=rows),
                               st.from_numpy(_TMK, tiling=rows))
    a = st.from_numpy(_TA, tiling=rows)
    if pkg == "jax":
        out = {"als": lambda: st.map2(
                   [r, v], lambda rv, vv: als._solve_side(rv, vv, 0.1),
                   out_tiling=tm.row(2)),
               "flip": lambda: st.map2([x], lambda t: jnp.flip(t, 0)),
               "cumsum": lambda: st.map2([x], lambda t: jnp.cumsum(t, 0))}
    else:
        out = {"als": lambda: st.map2([r, v], als._solve_side,
                                      fn_kw={"reg": 0.1},
                                      out_tiling=tm.row(2)),
               "flip": lambda: st.map2([x], lambda t: t.flip(0)),
               "cumsum": lambda: st.map2([x], lambda t: t.cumsum(0))}
    out.update({
        "trace": lambda: st.trace(st.from_numpy(_TSQ, tiling=rows)),
        "mean": lambda: st.map2([x], lambda t: t - t.mean(0)),
        "shape_constant": lambda: st.map(lambda t: t / t.shape[0], x),
        "median_ax1": lambda: st.median(m, axis=1),
        "median_ax0": lambda: st.median(m, axis=0),
        "einsum_chain": lambda: st.einsum("ij,jk,kl->il", x,
                                          st.from_numpy(_TSQ[:16, :16]),
                                          st.from_numpy(_TSQ[:16, :8])),
        "einsum_rows": lambda: st.einsum("ij,ik,il->jkl", a, a, a),
    })
    return out


_TABLE = ("als", "trace", "mean", "flip", "shape_constant", "median_ax1",
          "median_ax0", "einsum_chain", "einsum_rows", "cumsum")
# GSPMD's all-reduces of the masked median combine pieces of its result
# on their way to the result's layout, not partial sums of the function:
# the port keeps the result split until its glom
_NO_REDUCE_PARITY = ("median_ax1", "median_ax0")


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)], ids=["8x1", "4x2"])
@pytest.mark.parametrize("name", _TABLE)
def test_group_gather_table_matches_the_jax_audit(name, shape):
    from spartan_tpu.array import masked as masked_j
    from spartan_tpu.examples import als as als_j
    from spartan_tpu_torch.array import masked as masked_t
    from spartan_tpu_torch.examples import als as als_t

    mj, mt = _both(shape)
    with mj:
        aj = st_j.audit_plan(_table(st_j, tiling_j, masked_j, als_j,
                                    "jax")[name]())
    with mt:
        at = st_t.audit_plan(_table(st_t, tiling_t, masked_t, als_t,
                                    "torch")[name]())

    def gathers(au):
        return [f for f in au.findings if f.kind == "full_gather"]

    assert bool(gathers(at)) == bool(gathers(aj)), (at.multiset,
                                                    aj.multiset)
    if name not in _NO_REDUCE_PARITY:
        assert at.multiset.get("all-reduce", 0) == \
            aj.multiset.get("all-reduce", 0), (at.multiset, aj.multiset)
    # a scan along the rows is the one whole gather on 8x1; on 4x2 the
    # scan runs on each rank's columns (GSPMD all-gathers over x only)
    assert bool(gathers(at)) == (name == "cumsum" and shape == (8, 1))
