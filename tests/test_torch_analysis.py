"""The port's static analysis (``spartan_tpu_torch/analysis``) against the
JAX package's, on the CPU.

The verifier and the lints read the DAG only, so on the DAGs of
``tests/test_analysis.py`` — clean ones and deliberately corrupted ones —
both packages must report the same findings, compared by kind, severity
and the offending node's type, on the 4x2, 8x1 and 2x4 logical meshes.
The pass checker must name a corrupting pass in both packages, and with
``FLAGS.verify_passes`` on it must pass every real pass over the DAGs of
the main path (the dot chain, the k-means step in both forms, the fusion
cases, the sample sort, the VGG stencil) without a violation and without
changing a value.
"""

import contextlib
import importlib
import warnings

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu import analysis as an_j
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.expr import base as base_j
from spartan_tpu.expr import builtins as bi_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J
from spartan_tpu_torch import analysis as an_t
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.examples import kmeans as kmeans_t
from spartan_tpu_torch.expr import base as base_t
from spartan_tpu_torch.expr import builtins as bi_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

optimize_j = importlib.import_module("spartan_tpu.expr.optimize")
optimize_t = importlib.import_module("spartan_tpu_torch.expr.optimize")

torch.set_num_threads(1)

MESHES = [(4, 2), (8, 1), (2, 4)]

PKG_J = dict(st=st_j, tiling=tiling_j, base=base_j, bi=bi_j, an=an_j,
             opt=optimize_j)
PKG_T = dict(st=st_t, tiling=tiling_t, base=base_t, bi=bi_t, an=an_t,
             opt=optimize_t)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    prev_v = FLAGS_T.verify_passes, FLAGS_T.verify_evaluate
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)
    FLAGS_T.verify_passes, FLAGS_T.verify_evaluate = prev_v


@contextlib.contextmanager
def _meshes(shape):
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)), \
            mesh_t.use_mesh(mesh_t.build_mesh(shape)):
        yield


def _arr(p, shape=(8, 8), seed=0):
    rng = np.random.RandomState(seed)
    return p["st"].from_numpy(rng.rand(*shape).astype(np.float32))


# -- the DAGs of tests/test_analysis.py (each returns (root, donate)) ----


def clean(p):
    st = p["st"]
    return ((st.as_expr(_arr(p)) + 1.0) * 2.0).sum(axis=0), ()


def tuple_root(p):
    st = p["st"]
    a, b = st.as_expr(_arr(p, seed=1)), st.as_expr(_arr(p, seed=2))
    return st.tuple_of(a + b, (a * b).sum()), ()


def wrong_shape_after_fusion(p):
    e = (p["st"].as_expr(_arr(p)) + 1.0) * 2.0
    opt = p["opt"].optimize(e)
    opt._shape = (7, 7)
    return opt, ()


def dtype_drift(p):
    e = p["st"].as_expr(_arr(p)) + 1.0
    e._dtype = np.dtype(np.int32)
    return e, ()


def cycle(p):
    e = p["st"].as_expr(_arr(p)) + 1.0
    e.inputs = (e, e.inputs[1])
    return e, ()


def bad_reduce_axis(p):
    r = p["st"].sum(p["st"].as_expr(_arr(p)), axis=0)
    r.axis = (5,)
    return r, ()


def bad_transpose_perm(p):
    t = p["st"].transpose(p["st"].as_expr(_arr(p)))
    t.perm = (0, 5)
    return t, ()


def illegal_broadcast(p):
    st = p["st"]
    e = st.as_expr(_arr(p)) + st.as_expr(_arr(p, seed=1))
    e.inputs = (e.inputs[0], st.as_expr(_arr(p, (3, 5), seed=2)))
    return e, ()


def corrupted_slice(p):
    s = p["st"].as_expr(_arr(p))[2:6]
    s._shape = (5, 8)
    return s, ()


def missing_hooks(p):
    base = p["base"]

    class NoHooksExpr(base.Expr):
        def __init__(self, c):
            super().__init__(c.shape, c.dtype)
            self.c = c

        def children(self):
            return (self.c,)

    return NoHooksExpr(p["st"].as_expr(_arr(p))), ()


def forced_tiling_rank(p):
    e = p["st"].as_expr(_arr(p)) + 1.0
    e._forced_tiling = p["tiling"].row(3)
    return e, ()


def sort_tiling_mismatch(p):
    x = p["st"].from_numpy(np.random.RandomState(3).rand(8, 16)
                           .astype(np.float32), tiling=p["tiling"].col(2))
    srt = p["st"].sort(x, axis=1)
    assert isinstance(srt, p["bi"].SampleSortExpr)
    srt._forced_tiling = p["tiling"].Tiling(("x", "y"))
    return srt, ()


def sort_tiling_consistent(p):
    x = p["st"].from_numpy(np.random.RandomState(3).rand(8, 16)
                           .astype(np.float32), tiling=p["tiling"].col(2))
    return p["st"].sort(x, axis=1), ()


def use_after_donate(p):
    st = p["st"]
    x = st.from_numpy(np.random.RandomState(5).rand(8, 8)
                      .astype(np.float32)).evaluate()
    stale = st.as_expr(x) * 2.0
    p["base"].evaluate(st.as_expr(x) + 1.0, donate=[x])
    return stale, ()


def double_donation(p):
    st = p["st"]
    y = st.from_numpy(np.random.RandomState(6).rand(8, 8)
                      .astype(np.float32)).evaluate()
    y.donate()
    v = p["base"].ValExpr
    return v(y) + v(y) * 2.0, ()


def double_donation_in_list(p):
    st = p["st"]
    y = st.from_numpy(np.random.RandomState(7).rand(8, 8)
                      .astype(np.float32)).evaluate()
    return st.as_expr(y) + 1.0, (y, y)


def donation_unused(p):
    st = p["st"]
    y = st.from_numpy(np.ones((4, 4), np.float32)).evaluate()
    z = st.from_numpy(np.ones((4, 4), np.float32)).evaluate()
    return st.as_expr(y) + 1.0, (z,)


def degenerate_tile(p):
    st = p["st"]
    x = st.from_numpy(np.ones((2, 8), np.float32),
                      tiling=p["tiling"].replicated(2))
    e = st.as_expr(x) + 1.0
    e._forced_tiling = p["tiling"].row(2)
    return e, ()


def unresolvable_tiling(p):
    e = p["st"].as_expr(p["st"].from_numpy(np.ones((8, 8), np.float32))) \
        + 1.0
    e._forced_tiling = p["tiling"].Tiling(("nope", None))
    return e, ()


DAGS = [clean, tuple_root, wrong_shape_after_fusion, dtype_drift, cycle,
        bad_reduce_axis, bad_transpose_perm, illegal_broadcast,
        corrupted_slice, missing_hooks, forced_tiling_rank,
        sort_tiling_mismatch, sort_tiling_consistent, use_after_donate,
        double_donation, double_donation_in_list, donation_unused,
        degenerate_tile, unresolvable_tiling]


def _node_type(node_repr: str) -> str:
    return node_repr.split("(")[0] if node_repr else ""


def _findings(p, root, donate):
    """(verifier violations, lint findings), each as sorted (kind,
    severity, node type) triples."""
    vios = sorted((v.kind, "error", _node_type(v.node_repr))
                  for v in p["an"].verify_dag(root))
    lints = sorted((f.kind, f.severity, _node_type(f.node_repr))
                   for f in p["an"].lint(root, donate))
    return vios, lints


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", DAGS, ids=lambda f: f.__name__)
def test_verify_and_lint_findings_match_jax(case, shape):
    with _meshes(shape):
        root_j, don_j = case(PKG_J)
        root_t, don_t = case(PKG_T)
        got_j = _findings(PKG_J, root_j, don_j)
        got_t = _findings(PKG_T, root_t, don_t)
        assert got_t == got_j
        # st.check raises exactly where the JAX package's does
        raised = []
        for p, root, don in ((PKG_J, root_j, don_j), (PKG_T, root_t, don_t)):
            try:
                warn = p["st"].check(root, donate=don)
                raised.append(("ok", sorted(f.kind for f in warn)))
            except p["an"].VerificationError:
                raised.append(("raised", None))
        assert raised[1] == raised[0]


def test_violation_names_the_user_build_site():
    with _meshes((4, 2)):
        root, _ = dtype_drift(PKG_T)
        with pytest.raises(an_t.VerificationError,
                           match=r"dtype_mismatch.*test_torch_analysis"):
            st_t.check(root)
        stale, _ = use_after_donate(PKG_T)
        with pytest.raises(an_t.VerificationError,
                           match=r"use_after_donate.*donated at .*"
                                 r"test_torch_analysis"):
            st_t.check(stale)


# -- the pass checker: corrupting passes are named ------------------------


class _Breakers:
    """Each corrupting pass of tests/test_analysis.py, built on a
    package's ``Pass`` base class."""

    @staticmethod
    def wrong_shape(p):
        class P(p["opt"].Pass):
            name = "breaker_wrong_shape"

            def run(self, root):
                return root[0:4] if root.ndim == 2 else root

        return P(), "", lambda: (p["st"].as_expr(_arr(p)) + 1.0)

    @staticmethod
    def drop_leaf(p):
        class P(p["opt"].Pass):
            name = "breaker_drop_leaf"

            def run(self, root):
                return root.inputs[0] if hasattr(root, "inputs") else root

        return P(), "dropped leaf", lambda: (
            p["st"].as_expr(_arr(p, seed=1))
            + p["st"].as_expr(_arr(p, seed=2)))

    @staticmethod
    def dtype(p):
        class P(p["opt"].Pass):
            name = "breaker_dtype"

            def run(self, root):
                return p["st"].astype(root, np.int32)

        return P(), "dtype", lambda: p["st"].as_expr(_arr(p)) * 1.5

    @staticmethod
    def corrupt_node(p):
        class P(p["opt"].Pass):
            name = "breaker_corrupt_node"

            def run(self, root):
                root._shape = tuple(reversed((root.shape[0] + 1,)
                                             + root.shape[1:]))
                return root

        return P(), "", lambda: p["st"].as_expr(_arr(p)) + 2.0

    @staticmethod
    def invent_leaf(p):
        class P(p["opt"].Pass):
            name = "breaker_invent_leaf"

            def run(self, root):
                fake = p["st"].as_expr(_arr(p, seed=9))
                kids = root.children()
                return (root.replace_children((kids[0], fake))
                        if len(kids) == 2 else root)

        return P(), "no pre-pass", lambda: (
            p["st"].as_expr(_arr(p, seed=1))
            + p["st"].as_expr(_arr(p, seed=2)))

    @staticmethod
    def swap_scalar(p):
        scalar = p["base"].ScalarExpr

        class P(p["opt"].Pass):
            name = "breaker_swap_scalar"

            def run(self, root):
                if hasattr(root, "inputs") and any(
                        isinstance(i, scalar) for i in root.inputs):
                    return root.replace_children(tuple(
                        p["st"].as_expr(99.0) if isinstance(i, scalar)
                        else i for i in root.inputs))
                return root

        return P(), "no pre-pass", lambda: p["st"].as_expr(_arr(p)) * 2.5

    @staticmethod
    def cycle(p):
        class P(p["opt"].Pass):
            name = "breaker_cycle"

            def run(self, root):
                if hasattr(root, "inputs") and len(root.inputs) == 2:
                    root.inputs = (root, root.inputs[1])
                return root

        return P(), "cycle", lambda: (p["st"].as_expr(_arr(p, seed=1))
                                      + p["st"].as_expr(_arr(p, seed=2)))


BREAKERS = ["wrong_shape", "drop_leaf", "dtype", "corrupt_node",
            "invent_leaf", "swap_scalar", "cycle"]


@pytest.mark.parametrize("breaker", BREAKERS)
def test_pass_checker_names_the_corrupting_pass(breaker):
    FLAGS_T.verify_passes = True
    assert FLAGS_J.verify_passes  # the JAX package's suite turns it on
    with _meshes((4, 2)):
        for p in (PKG_J, PKG_T):
            p["opt"]._ensure_tiling_pass()
            bad, words, build = getattr(_Breakers, breaker)(p)
            p["opt"].register_pass(bad)
            try:
                with pytest.raises(p["an"].PassInvariantError,
                                   match=f"{bad.name}.*{words}"):
                    p["opt"].optimize(build())
            finally:
                p["opt"]._PASSES.remove(bad)


# -- the real passes over the main path's DAGs -----------------------------


def _rng_arr(st, shape, seed, tiling=None):
    rng = np.random.RandomState(seed)
    return st.from_numpy(rng.rand(*shape).astype(np.float32), tiling=tiling)


def dot_chain(st):
    a, b = _rng_arr(st, (32, 32), 0), _rng_arr(st, (32, 32), 1)
    return st.dot(st.dot(a, b) * 0.5 + 1.0, b).sum(axis=0)


def kmeans_step_kernel(st):
    pts = _rng_arr(st, (8192, 128), 2)
    c = _rng_arr(st, (8, 128), 3)
    e = kmeans_t.kmeans_step(pts, c, 8)
    assert type(e).__name__ == "KMeansStepExpr"
    return e


def kmeans_step_map2(st):
    with_flag = FLAGS_T.native_kernels
    FLAGS_T.native_kernels = "off"
    try:
        pts = _rng_arr(st, (256, 16), 2)
        c = _rng_arr(st, (4, 16), 3)
        return kmeans_t.kmeans_step(pts, c, 4)
    finally:
        FLAGS_T.native_kernels = with_flag


def fusion_cases(st):
    # every registered rewrite: map and reduce fusion, the collapse of
    # a cached sub-DAG, smart tiling
    a = st.as_expr(_rng_arr(st, (16, 8), 4))
    inner = base_t.ValExpr((a * 2.0 + 1.0).evaluate())
    return ((inner + a) * (a - 0.5)).sum(axis=1) + st.exp(a).mean()


def sample_sort(st):
    x = _rng_arr(st, (1024,), 5)
    return st.sort(x) * 2.0


def vgg_stencil(st):
    x = _rng_arr(st, (2, 16, 16, 3), 6,
                 tiling=tiling_t.Tiling((None, "x", None, None)))
    w1, w2 = _rng_arr(st, (3, 3, 3, 8), 7), _rng_arr(st, (3, 3, 8, 8), 8)
    h = st.maximum(st.stencil(x, w1), 0.0)
    return st.maxpool(st.maximum(st.stencil(h, w2), 0.0))


MAIN_PATH = [dot_chain, kmeans_step_kernel, kmeans_step_map2, fusion_cases,
             sample_sort, vgg_stencil]


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("dag", MAIN_PATH, ids=lambda f: f.__name__)
def test_real_passes_pass_the_checker_on_the_main_path(dag, shape):
    """verify_passes on: every enabled pass (collapse, map fusion, reduce
    fusion, smart tiling) passes the invariant checker and the tiling
    pass lints nothing; the value equals the unchecked run's."""
    with mesh_t.use_mesh(mesh_t.build_mesh(shape)):
        FLAGS_T.verify_passes = False
        ref = dag(st_t).glom()
        FLAGS_T.verify_passes = True
        e = dag(st_t)
        with warnings.catch_warnings():
            warnings.simplefilter("error", an_t.LintWarning)
            optimize_t.optimize(e)
            got = e.glom()
    np.testing.assert_array_equal(got, ref)


def test_tiling_pass_warns_on_a_forced_tiling_it_cannot_honor():
    FLAGS_T.verify_passes = True
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x = st_t.from_numpy(np.ones((2, 8), np.float32),
                            tiling=tiling_t.replicated(2))
        e = st_t.as_expr(x) + 1.0
        e._forced_tiling = tiling_t.row(2)  # 2 rows split 4 ways
        with pytest.warns(an_t.LintWarning, match="degenerate_tile"):
            optimize_t.optimize(e)


def test_verify_evaluate_raises_on_the_miss_path():
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x = st_t.from_numpy(np.random.RandomState(8).rand(8, 8)
                            .astype(np.float32)).evaluate()
        bad = st_t.as_expr(x) - 1.0
        base_t.evaluate(st_t.as_expr(x) * 3.0, donate=[x])
        FLAGS_T.verify_evaluate = True
        with pytest.raises(an_t.VerificationError, match="use_after_donate"):
            bad.evaluate()
