"""``st.explain`` of the port against the JAX package's, on the CPU.

On the same DAG and the same logical mesh (4x2, 8x1, 2x4) both packages
must report the same passes with the same node counts, the same tilings
per node, output tilings, argument order and reshard edges, and the
tiling DP's ``dp_cost`` and its components within 1e-9 relative.

``cost_analysis`` is XLA's read-out in the JAX package and a count in
the port. The JAX package's is PER DEVICE on a partitioned mesh (its dot
of 64x32 by 32x16 reports 8,448 FLOPs on the 4x2 mesh: each device's
16x16x16 block product plus the k-split's partial-sum add), and so is
the port's top-level ``flops`` / ``bytes accessed`` (``program`` holds
the whole plan's). Exact equality is held for the FLOPs and
transcendentals of dots, maps and map+reduce chains on every mesh, and
for the bytes of dots and maps; XLA:CPU leaves a map unfused before its
reduction and counts the intermediate's write and read, which the port's
fused walk does not do, so a reduction's bytes are not compared.
"""

import contextlib
import importlib

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.examples import kmeans as kmeans_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J
from spartan_tpu_torch.examples import kmeans as kmeans_t
from spartan_tpu_torch.expr import base as base_t
from spartan_tpu_torch.kernels import kmeans as kk_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.utils import profiling as prof_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)

MESHES = [(4, 2), (8, 1), (2, 4)]
REL = 1e-9
RNG = np.random.RandomState(0)
A = RNG.rand(64, 32).astype(np.float32)
B = RNG.rand(32, 16).astype(np.float32)
C = RNG.rand(64, 64).astype(np.float32)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)


@contextlib.contextmanager
def _meshes(shape):
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)), \
            mesh_t.use_mesh(mesh_t.build_mesh(shape)):
        yield


@contextlib.contextmanager
def _flags(**kw):
    prev = {k: (getattr(FLAGS_J, k), getattr(FLAGS_T, k)) for k in kw}
    for k, v in kw.items():
        setattr(FLAGS_J, k, v)
        setattr(FLAGS_T, k, v)
    try:
        yield
    finally:
        for k, (vj, vt) in prev.items():
            setattr(FLAGS_J, k, vj)
            setattr(FLAGS_T, k, vt)


# -- DAGs -------------------------------------------------------------------


def dot(st):
    return st.dot(st.from_numpy(A), st.from_numpy(B))


def dot_chain(st):
    c = st.from_numpy(C)
    return st.dot(st.dot(c, c) * 0.5 + 1.0, c).sum(axis=0)


def map_chain(st):
    return st.from_numpy(A) * 2.0 + 1.0


def map_reduce(st):
    return (st.from_numpy(A) * 2.0 + 1.0).sum()


def map_reduce_axis(st):
    return (st.from_numpy(A) - 0.5).mean(axis=1)


def exp_map(st):
    return st.exp(st.from_numpy(A))


def transpose_chain(st):
    a = st.from_numpy(A)
    return (st.transpose(a) * 3.0).sum(axis=1)


def kmeans_map2(st):
    km = kmeans_j if st is st_j else kmeans_t
    pts = st.from_numpy(RNG.rand(256, 16).astype(np.float32))
    return km.kmeans_step(pts, st.from_numpy(
        RNG.rand(4, 16).astype(np.float32)), 4)


DAGS = [dot, dot_chain, map_chain, map_reduce, map_reduce_axis, exp_map,
        transpose_chain, kmeans_map2]


def _typed(label):
    return label.split("#")[0]


def _close(a, b):
    if a is None or b is None:
        return a is b
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-30)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("dag", DAGS, ids=lambda f: f.__name__)
def test_explain_report_matches_jax(dag, shape):
    # the JAX kmeans_step is always the map2 form; the port's takes it
    # with native_kernels=off
    with _meshes(shape), _flags(native_kernels="off"):
        rj = st_j.explain(dag(st_j), cost=False)
        rt = st_t.explain(dag(st_t), cost=False)
    assert rt.cache == rj.cache == "miss"
    assert [(p["name"], p["nodes_before"], p["nodes_after"])
            for p in rt.passes] == [
        (p["name"], p["nodes_before"], p["nodes_after"]) for p in rj.passes]
    assert rt.optimized_nodes == rj.optimized_nodes
    assert [(_typed(t["node"]), t["shape"], t["tiling"], t["forced"],
             t.get("contraction")) for t in rt.tilings] == [
        (_typed(t["node"]), t["shape"], t["tiling"], t["forced"],
         t.get("contraction")) for t in rj.tilings]
    assert rt.out_tilings == rj.out_tilings
    assert rt.arg_order == rj.arg_order
    assert [(e["operand"], e["src"], e["dst"], e["bytes_per_chip"])
            for e in rt.reshard_edges] == [
        (e["operand"], e["src"], e["dst"], e["bytes_per_chip"])
        for e in rj.reshard_edges]
    assert [(lf["kind"], lf.get("shape"), lf.get("tiling"))
            for lf in rt.leaves] == [(lf["kind"], lf.get("shape"),
                                      lf.get("tiling")) for lf in rj.leaves]
    assert _close(rt.dp_cost, rj.dp_cost)
    cj, ct = rj.cost_components or {}, rt.cost_components or {}
    assert set(ct) == set(cj)
    assert all(_close(ct[k], cj[k]) for k in cj)
    for t_t, t_j in zip(rt.tilings, rj.tilings):
        assert _close(t_t.get("cost_estimate"), t_j.get("cost_estimate"))
    assert rt.mesh_epoch == 0 and rt.migrations is None
    assert rt.donation == {"last_donated_args": None,
                           "donated_dispatches": 0}


V48 = RNG.rand(48).astype(np.float32)
W48 = RNG.rand(48).astype(np.float32)
M48 = RNG.rand(64, 48).astype(np.float32)
T1 = RNG.rand(8, 16, 8).astype(np.float32)
T2 = RNG.rand(8, 16, 8).astype(np.float32)
B1 = RNG.rand(8, 16, 8).astype(np.float32)
B2 = RNG.rand(8, 8, 16).astype(np.float32)


def outer48(st):
    return st.outer(st.from_numpy(V48), st.from_numpy(W48))


def cumsum_rows(st):
    return st.cumsum(st.from_numpy(M48), axis=0)


def tensordot3(st):
    # the contracted 16 divides every mesh's strategy axis (C34: XLA
    # pads a shape that does not)
    return st.tensordot(st.from_numpy(T1), st.from_numpy(T2),
                        axes=([1, 2], [1, 2]))


def einsum_gram(st):
    m = st.from_numpy(M48)
    return st.einsum("ij,ik->jk", m, m)


def einsum_batched(st):
    return st.einsum("bij,bjk->bik", st.from_numpy(B1), st.from_numpy(B2))


def argmax_rows(st):
    return st.argmax(st.from_numpy(C), axis=1)


# the last six are the DAGs of ROADMAP C33: outer and the blocked scan
# counted, a planned contraction split by its strategy axis, argmax at
# XLA's nine ops a compare
COST_EXACT = [(dot, True), (map_chain, True), (exp_map, True),
              (map_reduce, False), (map_reduce_axis, False),
              (outer48, False), (cumsum_rows, False), (tensordot3, False),
              (einsum_gram, False), (einsum_batched, True),
              (argmax_rows, False)]


@pytest.mark.parametrize("shape", [(1, 1)] + MESHES)
@pytest.mark.parametrize("dag,with_bytes", COST_EXACT,
                         ids=lambda v: getattr(v, "__name__", str(v)))
def test_cost_analysis_per_device_matches_xla(dag, with_bytes, shape):
    n = shape[0] * shape[1]
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices()[:n], shape=shape)), \
            mesh_t.use_mesh(mesh_t.build_mesh(shape)):
        cj = st_j.explain(dag(st_j)).cost_analysis
        ct = st_t.explain(dag(st_t)).cost_analysis
    assert ct["flops"] == cj.get("flops", 0.0)
    assert ct["transcendentals"] == cj.get("transcendentals", 0.0)
    if with_bytes:
        assert ct["bytes accessed"] == cj["bytes accessed"]
    assert ct["devices"] == n
    # the program total: each node's whole count, summed
    assert ct["program"]["flops"] == sum(x["flops"] for x in ct["nodes"])


@pytest.mark.parametrize("dag", [map_reduce_axis, dot_chain],
                         ids=lambda f: f.__name__)
def test_explain_preplans_like_jax(dag):
    """Explaining a never-evaluated expr pre-plans it: the next evaluate
    of a fresh DAG of the same structure hits. The same expr hits too
    unless the smart-tiling pass stamped its choices on the raw nodes
    (a product's plan is in its signature), in both packages alike."""
    stats = []
    # an earlier test of this worker may have planned this structure
    base_t.clear_plan_cache()
    importlib.import_module("spartan_tpu.expr.base").clear_plan_cache()
    for st, prof in ((st_j, importlib.import_module(
            "spartan_tpu.utils.profiling")), (st_t, prof_t)):
        with _meshes((4, 2)):
            e = dag(st)
            r = st.explain(e)
            assert r.cache == "miss" and r.flops > 0
            prof.reset_counters()
            got = e.glom()
            same = prof.plan_cache_stats()["plan_hits"]
            prof.reset_counters()
            dag(st).glom()
            stats.append((same, prof.plan_cache_stats()["plan_hits"]))
            again = st.explain(dag(st))
            assert again.cache == "hit"
            assert again.cost_analysis == r.cost_analysis  # memoized
            assert st.explain(e).cache == "evaluated"
            assert "passes:" in str(r) and "cost_analysis" in str(r)
    assert stats[1] == stats[0]
    assert stats[0][1] == 1


def test_kernel_node_reports_its_backend_and_kernel_count():
    # config 3's shape cut to 8,192 points: one KMeansStepExpr whose
    # kernel share is the wrapper's own count (kernels/kmeans.cost), the
    # count chip_smoke.py prices the kernel's bound with
    n, d, k = 8192, 128, 64
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        pts = st_t.from_numpy(RNG.rand(n, d).astype(np.float32))
        c0 = st_t.from_numpy(RNG.rand(k, d).astype(np.float32))
        r = st_t.explain(kmeans_t.kmeans_step(pts, c0, k))
    assert r.kernels == [{"node": r.kernels[0]["node"], "op": "kmeans",
                          "backend": "plain"}]
    node = [x for x in r.cost_analysis["nodes"]
            if x["node"].startswith("KMeansStepExpr")][0]
    flops, nbytes = kk_t.cost(n, d, k)
    assert node["kernel"] == {"name": "kmeans_assign_accumulate",
                              "flops": flops, "bytes accessed": nbytes}
    assert flops == 2.0 * n * k * d + n * d
    assert nbytes == 4.0 * (n * d + 2 * k * d + k)


@pytest.mark.parametrize("native", ["on", "off"])
def test_sort_kernel_entry_matches_jax(native):
    # the sample sort's exchange kernel: 'pallas' (interpret mode on the
    # CPU) in the JAX package is 'plain' in the port; a fallback is
    # 'gspmd' there and 'expr' here, with a reason in both
    x = RNG.rand(1024).astype(np.float32)
    with _meshes((8, 1)), _flags(native_kernels=native):
        rj = st_j.explain(st_j.sort(st_j.from_numpy(x)) * 2.0, cost=False)
        rt = st_t.explain(st_t.sort(st_t.from_numpy(x)) * 2.0, cost=False)
    back = {"pallas": "plain", "gspmd": "expr"}
    assert [(k["op"], k["backend"]) for k in rt.kernels] == [
        (k["op"], back[k["backend"]]) for k in rj.kernels]
    assert all(("reason" in k) == (k["backend"] == "expr")
               for k in rt.kernels)


def test_program_count_of_the_dot_chain():
    # a chain with reshards between its products: XLA's per-device count
    # includes the partitioner's collectives, so the comparison is the
    # port's program total against the chain's own arithmetic
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        ca = st_t.explain(dot_chain(st_t)).cost_analysis
    n = 64
    want = 2 * (2.0 * n ** 3) + 2 * n * n + (n * n - n)
    assert ca["program"]["flops"] == want


def test_profiling_cost_analysis_is_explains():
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        e = map_reduce(st_t)
        assert prof_t.cost_analysis(e) == st_t.explain(e).cost_analysis
