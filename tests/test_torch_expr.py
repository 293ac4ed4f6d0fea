"""Parity of the PyTorch port's expr slice with the JAX package, on the
CPU: tilings and extents, map / map2 / reduce / slice / integer-array
indexing / loop, bench.py's dot chain, the plan cache, the device
default, and the rule that the port never imports JAX.

The same seeded numpy inputs go through both packages; results are
compared on the host.
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.expr import base as base_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev_dev = mesh_t.get_default_device()
    snap_t = FLAGS_T.snapshot()
    mesh_t.set_default_device("cpu")
    yield
    for name, value in snap_t.items():
        setattr(FLAGS_T, name, value)
    mesh_t.set_default_device(prev_dev)


def _geometry(extents):
    return [(e.ul, e.lr, e.array_shape) for e in extents]


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


# -- tilings and extents -------------------------------------------------


_SHAPES = [(64, 32), (63, 32), (8, 6, 4), (7,), (128,)]
_TILINGS = ["row", "col", "block", "replicated"]


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_tiling_extents_match_jax(mesh_shape):
    jm = mesh_j.build_mesh(jax_devices(), shape=mesh_shape)
    tm = mesh_t.build_mesh(mesh_shape)
    for shape in _SHAPES:
        for name in _TILINGS:
            tj = getattr(tiling_j, name)(len(shape))
            tt = getattr(tiling_t, name)(len(shape))
            assert tt.axes == tj.axes
            tj = tiling_j.sanitize(tj, shape, jm)
            tt = tiling_t.sanitize(tt, shape, tm)
            assert tt.axes == tj.axes, (shape, name)
            assert _geometry(tt.extents(shape, tm)) == _geometry(
                tj.extents(shape, jm)), (shape, name, mesh_shape)
        dj = tiling_j.default_tiling(shape, jm)
        dt = tiling_t.default_tiling(shape, tm)
        assert dt.axes == dj.axes, (shape, mesh_shape)
        hj = tiling_j.from_tile_hint(shape, [2] * len(shape), jm)
        ht = tiling_t.from_tile_hint(shape, [2] * len(shape), tm)
        assert ht.axes == hj.axes


def jax_devices():
    import jax

    return jax.devices()


@pytest.mark.parametrize("shape", [(64, 32), (63, 17)])
def test_from_reference_keeps_tiling_and_values(mesh2d, shape):
    ref = st_j.from_numpy(_rand(*shape)).value
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        got = st_t.from_reference(ref.glom(), ref.tiling.axes)
        assert got.tiling.axes == ref.tiling.axes
        assert _geometry(got.extents()) == _geometry(ref.extents())
    np.testing.assert_array_equal(got.glom(), ref.glom())
    with pytest.raises(ValueError):
        st_t.from_reference(ref.glom(), ("x",))


def test_distarray_creation_and_dtypes():
    from spartan_tpu_torch.array import distarray as da

    z = da.zeros((3, 4))
    assert z.glom().dtype == np.float32 and not z.glom().any()
    assert da.ones((2,), np.int32).glom().tolist() == [1, 1]
    assert da.full((2, 2), 7.5).glom().tolist() == [[7.5, 7.5]] * 2
    np.testing.assert_array_equal(da.arange(5).glom(), np.arange(5))
    assert da.arange(5).dtype == np.int32  # int64 host data -> int32
    assert da.from_numpy(np.ones(3)).dtype == np.float32
    r1 = da.rand(4, 5, seed=3).glom()
    np.testing.assert_array_equal(r1, da.rand(4, 5, seed=3).glom())
    assert (r1 >= 0).all() and (r1 < 1).all()
    assert da.randn(4, 5, seed=3).shape == (4, 5)
    src = np.ones((2, 2), np.float32)
    arr = da.from_numpy(src)
    src[0, 0] = 5.0  # the array owns a copy
    assert arr.glom()[0, 0] == 1.0


# -- expression results against the JAX package --------------------------


def _both(build_j, build_t, *arrays):
    """Evaluate ``build_x(*leaves)`` in both packages from the same
    numpy arrays; return the two host results."""
    got_j = build_j(*[st_j.from_numpy(a) for a in arrays]).glom()
    got_t = build_t(*[st_t.from_numpy(a) for a in arrays]).glom()
    return np.asarray(got_j), np.asarray(got_t)


_MAPS = {
    "arith": lambda st, x, y: (x + y) * 3.0 - y / 2.0,
    "maximum_abs": lambda st, x, y: st.maximum(st.absolute(x - y), 0.25),
    "compare": lambda st, x, y: (x > y) & (x < 0.9),
    "unary": lambda st, x, y: st.exp(-x) + st.sqrt(y) * st.sign(x - 0.5),
    "where": lambda st, x, y: st.where(x > 0.5, x, -y),
    "broadcast": lambda st, x, y: x + y[0],
    "scalar_first": lambda st, x, y: 2.0 - x ** 2,
}


@pytest.mark.parametrize("name", sorted(_MAPS))
def test_map_matches_jax(name):
    fn = _MAPS[name]
    a, b = _rand(16, 12, seed=1), _rand(16, 12, seed=2)
    rj, rt = _both(lambda x, y: fn(st_j, x, y), lambda x, y: fn(st_t, x, y),
                   a, b)
    assert rt.dtype == rj.dtype and rt.shape == rj.shape
    np.testing.assert_allclose(rt, rj, rtol=1e-6, atol=1e-7)


def test_user_map_and_fusion():
    a = _rand(32, 8)
    rj, rt = _both(lambda x: st_j.map(lambda v: v * v + 1.0, x) * 2.0,
                   lambda x: st_t.map(lambda v: v * v + 1.0, x) * 2.0, a)
    np.testing.assert_allclose(rt, rj, rtol=1e-6)
    # map fusion folds the chain into one MapExpr over one leaf
    x = st_t.from_numpy(a)
    dag = st_t.optimize(((x + 1.0) * 2.0 - x).sum())
    assert [type(n).__name__ for n in st_t.dag_nodes(dag)] == [
        "ValExpr", "ScalarExpr", "ScalarExpr", "ReduceExpr"]


_REDUCE = [("sum", None), ("sum", 0), ("mean", 1), ("max", None),
           ("min", 0), ("argmin", 1), ("argmax", 0), ("argmin", None)]


@pytest.mark.parametrize("op,axis", _REDUCE)
def test_reduce_matches_jax(op, axis):
    a = _rand(24, 10, seed=4)
    a[3, 2] = a[5, 2] = -1.0  # a tie: the first index wins in both
    rj, rt = _both(lambda x: getattr(x, op)(axis=axis),
                   lambda x: getattr(x, op)(axis=axis), a)
    assert rt.dtype == rj.dtype and rt.shape == rj.shape
    np.testing.assert_allclose(rt, rj, rtol=1e-6)


def test_reduce_int_and_keepdims_match_jax():
    a = np.arange(30, dtype=np.int32).reshape(5, 6)
    rj, rt = _both(lambda x: x.sum(axis=1, keepdims=True),
                   lambda x: x.sum(axis=1, keepdims=True), a)
    assert rt.dtype == rj.dtype == np.int32
    np.testing.assert_array_equal(rt, rj)
    rj, rt = _both(lambda x: x.mean(), lambda x: x.mean(), a)
    assert rt.dtype == rj.dtype
    np.testing.assert_allclose(rt, rj)


_SLICES = [
    (slice(1, 5), slice(None, None, 2)),
    (slice(None, None, -1), 3),
    (None, slice(2, None), slice(-3, None)),
    (-1,),
    (Ellipsis, slice(7, 1, -2)),
    (slice(10, None, -3), slice(None, None, -1)),
]


@pytest.mark.parametrize("idx", _SLICES, ids=range(len(_SLICES)))
def test_slice_matches_jax_and_numpy(idx):
    a = _rand(12, 9, seed=5)
    rj, rt = _both(lambda x: x[idx], lambda x: x[idx], a)
    np.testing.assert_array_equal(rt, a[idx])
    np.testing.assert_array_equal(rt, rj)


@pytest.mark.parametrize("kind", ["sorted", "unsorted_negative", "mask"])
def test_integer_array_indexing_matches_jax(kind):
    a = _rand(20, 6, seed=6)
    if kind == "sorted":
        idx = np.sort(np.random.RandomState(0).choice(20, 7, replace=False))
    elif kind == "unsorted_negative":
        idx = np.array([5, -1, 0, 5, 12])
    else:
        idx = a[:, 0] > 0.5
    rj, rt = _both(lambda x: x[idx], lambda x: x[idx], a)
    np.testing.assert_array_equal(rt, a[idx])
    np.testing.assert_array_equal(rt, rj)


def test_map2_matches_jax():
    a, b = _rand(40, 8, seed=7), _rand(5, 8, seed=8)

    def kern_j(p, c):
        d2 = ((p * p).sum(1, keepdims=True) - 2.0 * jnp.matmul(
            p, c.T, precision="highest") + (c * c).sum(1)[None, :])
        return jnp.argmin(d2, axis=1)

    def kern_t(p, c):
        d2 = ((p * p).sum(1, keepdim=True) - 2.0 * (p @ c.T)
              + (c * c).sum(1)[None, :])
        return torch.argmin(d2, dim=1).to(torch.int32)

    rj, rt = _both(lambda p, c: st_j.map2([p, c], kern_j),
                   lambda p, c: st_t.map2([p, c], kern_t), a, b)
    assert rt.dtype == rj.dtype and rt.shape == (40,)
    np.testing.assert_array_equal(rt, rj)


@pytest.mark.parametrize("iters", [0, 1, 5])
def test_loop_matches_jax(iters):
    a, b = _rand(6, 6, seed=9), _rand(6, 6, seed=10)

    def build(st, x, y):
        return st.loop(iters, lambda c, d: (c * 0.5 + d, d - 0.1 * c), x, y)

    rj = [r.glom() for r in build(st_j, st_j.from_numpy(a),
                                  st_j.from_numpy(b))]
    rt = [r.glom() for r in build(st_t, st_t.from_numpy(a),
                                  st_t.from_numpy(b))]
    # XLA contracts c * 0.5 + d into one FMA, torch rounds twice: a few
    # ulps after five steps
    for got, want in zip(rt, rj):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-7)


def test_loop_with_index_and_promoted_carry():
    a = np.zeros(4, np.int32)

    def build(st):
        return st.loop(4, lambda i, c: c + i * 0.5, st.from_numpy(a),
                       with_index=True)

    rj, rt = build(st_j).glom(), build(st_t).glom()
    assert rt.dtype == np.asarray(rj).dtype == np.float32
    np.testing.assert_allclose(rt, rj)


def _bench_chain(st, ea, eb, k):
    """bench.py's ``_build``: renorm every 8th hop when 8 | k."""
    def renorm(c):
        return c / st.absolute(c).max()

    if k % 8 == 0:
        def body8(c):
            for _ in range(8):
                c = st.dot(c, eb)
            return renorm(c)

        return st.loop(k // 8, body8, ea).sum()

    return st.loop(k, lambda c: renorm(st.dot(c, eb)), ea).sum()


@pytest.mark.parametrize("k", [3, 16])
def test_dot_chain_matches_jax(k):
    n = 256
    a, b = _rand(n, n, seed=11), _rand(n, n, seed=12)
    rj = float(_bench_chain(st_j, st_j.from_numpy(a), st_j.from_numpy(b),
                            k).glom())
    rt = float(_bench_chain(st_t, st_t.from_numpy(a), st_t.from_numpy(b),
                            k).glom())
    assert np.isfinite(rt)
    np.testing.assert_allclose(rt, rj, rtol=1e-5)


def test_dot_shapes_match_numpy():
    a, b, v = _rand(5, 7, seed=1), _rand(7, 3, seed=2), _rand(7, seed=3)
    np.testing.assert_allclose(st_t.dot(st_t.from_numpy(a),
                                        st_t.from_numpy(b)).glom(), a @ b,
                               rtol=1e-6)
    np.testing.assert_allclose((st_t.from_numpy(a) @ v).glom(), a @ v,
                               rtol=1e-6)
    np.testing.assert_allclose(st_t.dot(v, v).glom(), v @ v, rtol=1e-6)
    with pytest.raises(ValueError):
        st_t.dot(st_t.from_numpy(a), st_t.from_numpy(a))


# -- plan cache -----------------------------------------------------------


def test_plan_cache_hits_on_identical_structure():
    a, b = _rand(8, 8, seed=1), _rand(8, 8, seed=2)
    base_t.reset_plan_stats()

    def build(x):
        return (st_t.dot(x, st_t.from_numpy(b)) + 1.0).sum()

    r1 = build(st_t.from_numpy(a)).glom()
    r2 = build(st_t.from_numpy(a * 2.0)).glom()  # same structure
    stats = base_t.plan_stats()
    assert stats["plan_misses"] == 1 and stats["plan_hits"] == 1
    np.testing.assert_allclose(r2 - 8 * 8, 2.0 * (r1 - 8 * 8), rtol=1e-5)
    # a different structure misses
    (st_t.from_numpy(a) - 1.0).sum().glom()
    assert base_t.plan_stats()["plan_misses"] == 2
    # the kernel policy is part of the key
    FLAGS_T.native_kernels = "off"
    build(st_t.from_numpy(a)).glom()
    assert base_t.plan_stats()["plan_misses"] == 3


def test_plan_cache_hits_rebuilt_closures():
    """A closure rebuilt per call (kmeans_step's kernel) keys by its
    code and captured values, so the repeated structure still hits."""
    from spartan_tpu_torch.examples.kmeans import kmeans_step

    pts = st_t.from_numpy(_rand(64, 4, seed=1))
    c0 = st_t.from_numpy(_rand(3, 4, seed=2))
    base_t.reset_plan_stats()
    kmeans_step(pts, c0, 3).glom()
    kmeans_step(pts, c0, 3).glom()
    assert base_t.plan_stats()["plan_hits"] == 1
    kmeans_step(pts, c0[:2], 2).glom()  # other k: another closure value
    assert base_t.plan_stats()["plan_misses"] == 2


def test_shape_inference_runs_on_meta():
    """map2 shape inference runs the user function on meta tensors,
    argmin and index_add_ included: no data, no FLOPs."""
    from spartan_tpu_torch.examples.kmeans import _assign_and_accumulate

    calls = []

    def spy(p, c):
        calls.append(p.device.type)
        return _assign_and_accumulate(3)(p, c)

    e = st_t.map2([_rand(50, 4), _rand(3, 4)], spy)
    assert e.shape == (3, 5) and e.dtype == np.float32
    assert calls == ["meta"]


# -- device default -------------------------------------------------------


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st_t.set_default_device("cuda")
    assert st_t.get_default_device() == torch.device("cuda")
    with pytest.raises(RuntimeError, match="set_default_device"):
        st_t.from_numpy(np.ones(3, np.float32))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        st_t.build_mesh((1, 1), device="cuda")
    st_t.set_default_device("cpu")
    x = st_t.from_numpy(np.ones(3, np.float32))
    assert x.value.device == torch.device("cpu")


def test_import_default_is_cuda():
    import subprocess
    import sys

    code = ("import spartan_tpu_torch as st; "
            "print(st.get_default_device().type)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "cuda"


def test_kernel_wrapper_takes_plain_version_only_on_cpu():
    from spartan_tpu_torch.kernels import kmeans as kk

    before = kk.LAUNCHES
    p = torch.from_numpy(_rand(1024, 128, seed=3))
    kk.assign_accumulate(p, p[:4].clone(), 4)
    assert kk.LAUNCHES == before  # the plain version counts no launch
    with pytest.raises(ValueError, match="no k-means kernel"):
        kk.assign_accumulate(p.to("meta"), p[:4].to("meta"), 4)


# -- the port imports no JAX ----------------------------------------------


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(REPO, "spartan_tpu_torch")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out.extend(os.path.join(dirpath, f) for f in filenames
                   if f.endswith(".py"))
    return sorted(out)


def test_port_imports_no_jax():
    files = _port_sources()
    assert len(files) > 20
    for mod in ("array/masked.py", "utils/checkpoint.py", "utils/log.py",
                "expr/fio.py", "native/__init__.py",
                "resilience/classify.py", "resilience/loop_ckpt.py",
                "resilience/faults.py", "resilience/engine.py",
                "resilience/degrade.py", "resilience/elastic.py",
                "utils/recovery.py",
                "examples/streaming.py", "obs/__init__.py",
                "obs/metrics.py", "obs/trace.py", "utils/profiling.py",
                "parallel/redistribute.py", "expr/tiling_cost.py",
                "expr/tiling_pass.py", "parallel/shard_map.py",
                "parallel/collectives.py", "parallel/pipeline.py",
                "ops/attention.py", "analysis/__init__.py",
                "analysis/verify.py", "analysis/passes.py",
                "analysis/lints.py", "obs/explain.py", "obs/ledger.py",
                "obs/numerics.py", "obs/profile.py",
                "analysis/hlo.py", "analysis/plan_audit.py",
                "resilience/memory.py", "resilience/integrity.py",
                "persist/__init__.py", "persist/store.py",
                "persist/fingerprint.py", "serve/__init__.py",
                "serve/future.py", "serve/queue.py", "serve/coalesce.py",
                "serve/engine.py", "obs/flight.py", "obs/slo.py",
                "obs/skew.py", "expr/incremental.py", "obs/monitor.py",
                "utils/benchguard.py", "expr/partition.py",
                "kernels/gemv.py"):
        assert os.path.join(REPO, "spartan_tpu_torch", mod) in files
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "spartan_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}:"
                               f"{node.lineno}: {name}")
    assert bad == []


def test_every_jax_module_has_a_port_counterpart():
    """Each ``.py`` file of the JAX package has a file of the same path
    in the port, but ``utils/compat.py`` (a shim over jax versions), and
    the JAX package's public names (top level and ``obs``) are all the
    port's too."""
    import spartan_tpu
    import spartan_tpu.obs as obs_j
    import spartan_tpu_torch.obs as obs_t

    jax_root = os.path.join(REPO, "spartan_tpu")
    missing = []
    for dirpath, _, names in os.walk(jax_root):
        for name in names:
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), jax_root)
            if not os.path.exists(os.path.join(REPO, "spartan_tpu_torch",
                                               rel)):
                missing.append(rel)
    assert missing == [os.path.join("utils", "compat.py")]
    assert set(spartan_tpu.__all__) - set(st_t.__all__) == set()
    assert set(obs_j.__all__) - set(obs_t.__all__) == set()
    for name in ("status", "fleet_status", "compile_cache_size",
                 "clear_compile_cache"):
        assert callable(getattr(st_t, name))
