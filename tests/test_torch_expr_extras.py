"""Parity of the port's expr-core leftovers with the JAX package, on the
CPU: ``lazify``, ``tuple_of``, ``ListExpr``, ``DictExpr``/``dict_of``,
``map_with_location``, ``ndarray(reducer=)`` and ``optimize(report=)``.

The same seeded numpy inputs go through both packages, each on a mesh
of the same shape (the JAX package's virtual 8-device CPU mesh, the
port's logical mesh on the CPU); results are compared on the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J
from spartan_tpu_torch.parallel import mesh as mesh_t

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev_dev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev_dev)


def _on_meshes(shape, build_j, build_t):
    """``build_j(st_j)`` under the JAX mesh and ``build_t(st_t)`` under the
    port's logical mesh, both of ``shape``."""
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)):
        out_j = build_j(st_j)
    with mesh_t.use_mesh(mesh_t.build_mesh(shape)):
        out_t = build_t(st_t)
    return out_j, out_t


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _multi_root(st, container):
    x = st.from_numpy(_rand(8, 6, seed=1))
    y = st.from_numpy(_rand(8, 6, seed=2))
    return container(st, st.lazify(x) + y, (x * y).sum(axis=1), x.T)


def test_tuple_and_list_exprs_match_jax():
    for container, kind in ((lambda st, *e: st.tuple_of(*e), tuple),
                            (lambda st, *e: st.ListExpr(e), list)):
        got_j, got_t = _on_meshes(
            (4, 2), lambda st: _multi_root(st, container).glom(),
            lambda st: _multi_root(st, container).glom())
        assert type(got_j) is type(got_t) is kind
        assert len(got_t) == 3
        for a, b in zip(got_j, got_t):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(b, a, rtol=1e-6)


def test_dict_of_matches_jax():
    def build(st):
        x = st.from_numpy(_rand(8, 6, seed=3))
        d = st.dict_of(total=x.sum(), double=x * 2.0, rows=x.max(axis=1))
        assert isinstance(d, st.DictExpr)
        assert d["double"].shape == (8, 6)
        evaluated = d.evaluate()
        assert list(evaluated) == ["double", "rows", "total"]
        return {k: v.glom() for k, v in evaluated.items()}, d.glom()

    (ev_j, gl_j), (ev_t, gl_t) = _on_meshes((4, 2), build, build)
    for got in (ev_t, gl_t):
        assert sorted(got) == sorted(gl_j)
        for k in gl_j:
            assert got[k].shape == gl_j[k].shape
            np.testing.assert_allclose(got[k], gl_j[k], rtol=1e-6)


# Each reads the block's shape and its upper-left corner; the output is
# exact integers, so the two packages must agree bit for bit.


def _location_kernel_j(b, ul):
    r = jnp.arange(b.shape[0], dtype=jnp.int32)[:, None] + ul[0]
    c = jnp.arange(b.shape[1], dtype=jnp.int32)[None, :] + ul[1]
    return ((b > 0.5).astype(jnp.int32) + r * 100 + c
            + b.shape[0] * 1000 + b.shape[1] * 10000)


def _location_kernel_t(b, ul):
    r = torch.arange(b.shape[0], dtype=torch.int32,
                     device=b.device)[:, None] + ul[0]
    c = torch.arange(b.shape[1], dtype=torch.int32,
                     device=b.device)[None, :] + ul[1]
    return ((b > 0.5).to(torch.int32) + r * 100 + c
            + b.shape[0] * 1000 + b.shape[1] * 10000)


@pytest.mark.parametrize("shape,mesh", [
    ((8, 6), (4, 2)),    # 4 x 2 blocks of 2 x 3
    ((8, 6), (8, 1)),    # 8 x 1 blocks of 1 x 6
    ((10, 6), (4, 2)),   # 10 rows do not divide: one block at (0, 0)
], ids=["4x2", "8x1", "uneven"])
def test_map_with_location_matches_jax(shape, mesh):
    x = _rand(*shape, seed=4)

    def build(st, kern):
        # the map2's out_tiling pins the input's tiling to both mesh axes,
        # dividing or not
        src = st.map2([st.from_numpy(x)], lambda v: v * 1.0,
                      out_tiling=st.Tiling(("x", "y")))
        return st.map_with_location(src, kern).glom()

    got_j, got_t = _on_meshes(mesh, lambda st: build(st, _location_kernel_j),
                              lambda st: build(st, _location_kernel_t))
    assert got_t.dtype == got_j.dtype == np.int32
    np.testing.assert_array_equal(got_t, got_j)


def test_map_with_location_keeps_shape_check():
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        x = st_t.from_numpy(_rand(8, 6))
        with pytest.raises(ValueError, match="must preserve shape"):
            st_t.map_with_location(x, lambda b, ul: b[:1])


def test_ndarray_accepts_reducer():
    got_j, got_t = _on_meshes(
        (4, 2), lambda st: st.ndarray((8, 4), reducer="add").glom(),
        lambda st: st.ndarray((8, 4), reducer="add").glom())
    assert got_t.dtype == got_j.dtype
    np.testing.assert_array_equal(got_t, got_j)


def test_optimize_report_matches_jax():
    """Pass names and node counts of the passes both packages run; the
    JAX package's auto-tiling pass waits for the port's tiling DP."""
    x, y = _rand(8, 6, seed=5), _rand(8, 6, seed=6)

    def build(st):
        X, Y = st.from_numpy(x), st.from_numpy(y)
        root = st.tuple_of(((X * 2.0 + 1.0) * Y).sum(axis=1), (X - Y).max(),
                           st.dot(X, Y.T) + 1.0)
        report = []
        st.optimize(root, report=report)
        return [(r["name"], r["nodes_before"], r["nodes_after"])
                for r in report], [r["seconds"] for r in report]

    prev = FLAGS_J.opt_auto_tiling
    FLAGS_J.opt_auto_tiling = False
    try:
        (rep_j, _), (rep_t, secs) = _on_meshes((4, 2), build, build)
    finally:
        FLAGS_J.opt_auto_tiling = prev
    assert rep_t == rep_j
    assert [r[0] for r in rep_t] == ["collapse_cached", "map_fusion",
                                     "reduce_fusion"]
    assert all(s >= 0.0 for s in secs)
