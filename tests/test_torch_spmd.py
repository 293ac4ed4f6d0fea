"""The port's explicit SPMD layer against the JAX package, on the CPU.

``parallel/shard_map.py``'s thread runner (one thread per position of a
logical mesh) against the JAX package's ``shard_map`` on the 8-device
CPU mesh: every collective of ``parallel/collectives.py`` inside a
``shard_map`` body, ``reshard`` and ``ulysses_swap``, ``shard_map2`` and
``dot_shardmap`` on 4x2, 8x1 and 2x4, and the ``shard_map`` group forms
of the k-means, segment, histogram and stencil kernels against the JAX
group forms (the port's plain kernels, the JAX package's Pallas kernels
in interpret mode). The same seeded numpy inputs go to both packages.

Tolerances: data movement (gathers, all_to_all, permutes, reshards) is
bit-equal; a sum over positions is bit-equal to a left fold in position
order on the port, and within 1e-6 relative of the JAX package's psum
(whose order XLA picks); products and the group-form kernels within
the tolerances their own parity files use (rtol 2e-5 for k-means sums,
1e-4 relative for float32 GEMMs, rtol 1e-4 / atol 1e-5 for the stencil),
integer-valued segment sums and counts bit-equal.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.kernels import histogram as khist_j
from spartan_tpu.kernels import kmeans as kk_j
from spartan_tpu.kernels import registry as reg_j
from spartan_tpu.kernels import segment as kseg_j
from spartan_tpu.kernels import stencil as kst_j
from spartan_tpu.parallel import collectives as coll_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.utils.compat import shard_map as shard_map_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J
import spartan_tpu_torch as st_t
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.kernels import histogram as khist_t
from spartan_tpu_torch.kernels import kmeans as kk_t
from spartan_tpu_torch.kernels import segment as kseg_t
from spartan_tpu_torch.kernels import stencil as kst_t
from spartan_tpu_torch.parallel import collectives as coll_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.parallel import shard_map as smap_t

torch.set_num_threads(1)

MESHES = [(4, 2), (8, 1), (2, 4)]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    snap = FLAGS_J.snapshot()
    mesh_t.set_default_device("cpu")
    yield
    for name, value in snap.items():
        setattr(FLAGS_J, name, value)
    mesh_t.set_default_device(prev)


def _meshes(shape):
    return (mesh_j.build_mesh(jax.devices(), shape=shape),
            mesh_t.build_mesh(shape))


def _run_jax(fn, mj, in_axes, out_axes, *xs):
    specs = tuple(tiling_j.Tiling(a).spec() for a in in_axes)
    out = tiling_j.Tiling(out_axes).spec()
    with mesh_j.use_mesh(mj):
        return np.asarray(jax.jit(shard_map_j(
            fn, mesh=mj, in_specs=specs, out_specs=out,
            check_vma=False))(*[jnp.asarray(x) for x in xs]))


def _run_port(fn, mt, in_axes, out_axes, *xs):
    with mesh_t.use_mesh(mt):
        return smap_t.shard_map(
            fn, mt, tuple(tiling_t.Tiling(a) for a in in_axes),
            tiling_t.Tiling(out_axes))(
                *[torch.from_numpy(x) for x in xs]).numpy()


# -- the collectives inside shard_map ------------------------------------


def test_collectives_in_shard_map_match_jax(mesh1d):
    """tests/test_attention.py::test_collectives_in_shard_map, through
    both packages."""
    x = np.arange(8, dtype=np.float32)

    def kern_j(v):
        return (coll_j.all_reduce(v, "x") + coll_j.all_gather(v, "x").sum()
                + coll_j.ring_permute(v, "x", 1))

    def kern_t(v):
        return (coll_t.all_reduce(v, "x") + coll_t.all_gather(v, "x").sum()
                + coll_t.ring_permute(v, "x", 1))

    want = _run_jax(kern_j, mesh1d, [("x",)], ("x",), x)
    got = _run_port(kern_t, mesh_t.build_mesh((8, 1)), [("x",)], ("x",), x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.sum() * 2 + np.roll(x, 1))


# body(coll, v) per case; "move" cases must be bit-equal
_CASES = {
    "all_reduce_add": (lambda c, a, v: c.all_reduce(v, a), False),
    "all_reduce_mean": (lambda c, a, v: c.all_reduce(v, a, "mean"), False),
    "all_reduce_max": (lambda c, a, v: c.all_reduce(v, a, "max"), True),
    "all_reduce_min": (lambda c, a, v: c.all_reduce(v, a, "min"), True),
    "all_gather_0": (lambda c, a, v: c.all_gather(v, a), True),
    "all_gather_1": (lambda c, a, v: c.all_gather(v, a, gather_axis=1),
                     True),
    "all_gather_stack": (lambda c, a, v: c.all_gather(v, a, tiled=False)
                         .sum(0) * 0.5 + v, False),
    "reduce_scatter_0": (lambda c, a, v: c.reduce_scatter(v, a), False),
    "reduce_scatter_1": (lambda c, a, v: c.reduce_scatter(
        v, a, scatter_axis=1), False),
    "all_to_all": (lambda c, a, v: c.all_to_all(v, a, split_axis=1,
                                                concat_axis=0), True),
    "all_to_all_back": (lambda c, a, v: c.all_to_all(v, a, split_axis=0,
                                                     concat_axis=1), True),
    "ring_permute_fwd": (lambda c, a, v: c.ring_permute(v, a, 1), True),
    "ring_permute_back": (lambda c, a, v: c.ring_permute(v, a, -1), True),
    "axis_index": (lambda c, a, v: v * 0 + c.axis_index(a)
                   + 10 * c.axis_size(a), True),
}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("axis", ["x", "y"])
@pytest.mark.parametrize("shape", MESHES)
def test_collective_matches_jax(shape, axis, case):
    body, exact = _CASES[case]
    mj, mt = _meshes(shape)
    nx, ny = shape
    rng = np.random.RandomState(nx * 10 + ny)
    # every block (8, 8), both block dims divisible by every axis size
    x = rng.randn(8 * nx, 8 * ny).astype(np.float32)
    # the stacked output of each position: (nx*ny, ...) row-major
    ins = [("x", "y")]
    outs = (("x", "y"), None, None)
    want = _run_jax(lambda v: body(coll_j, axis, v)[None], mj, ins, outs, x)
    got = _run_port(lambda v: body(coll_t, axis, v)[None], mt, ins, outs, x)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES)
def test_sums_fold_left_in_position_order(shape):
    """The thread runner's add is ((v0 + v1) + v2) + ... in position
    order along the axis, bit for bit, and the same in every run."""
    mt = mesh_t.build_mesh(shape)
    nx, ny = shape
    x = (np.random.RandomState(3).randn(8 * nx, 8 * ny) * 1e3
         ).astype(np.float32)
    xt = torch.from_numpy(x)
    for axis in ("x", "y"):
        got = [_run_port(lambda v: coll_t.all_reduce(v, axis)[None], mt,
                         [("x", "y")], (("x", "y"), None, None), x)
               for _ in range(3)]
        for f in range(nx * ny):
            i, j = divmod(f, ny)
            line = ([xt[a * 8:(a + 1) * 8, j * 8:(j + 1) * 8]
                     for a in range(nx)] if axis == "x" else
                    [xt[i * 8:(i + 1) * 8, b * 8:(b + 1) * 8]
                     for b in range(ny)])
            acc = line[0]
            for blk in line[1:]:
                acc = acc + blk
            for g in got:
                np.testing.assert_array_equal(g[f], acc.numpy())


def test_collectives_outside_shard_map_raise():
    with pytest.raises(RuntimeError, match="outside shard_map"):
        coll_t.all_reduce(torch.ones(2))
    with pytest.raises(ValueError, match="unknown all_reduce op"):
        coll_t.all_reduce(torch.ones(2), op="prod")


def test_reshard_and_ulysses_swap_match_jax(mesh1d):
    x = np.random.RandomState(5).rand(64, 8, 4).astype(np.float32)
    want = np.asarray(coll_j.ulysses_swap(jnp.asarray(x), seq_axis=0,
                                          head_axis=1))
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        got = coll_t.ulysses_swap(torch.from_numpy(x), seq_axis=0,
                                  head_axis=1)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), x)
        y = np.random.RandomState(6).rand(8, 8).astype(np.float32)
        arr = coll_t.reshard(torch.from_numpy(y), tiling_t.Tiling(("x", None)))
        assert arr.tiling == tiling_t.Tiling(("x", None))
        arr2 = coll_t.reshard(arr, tiling_t.Tiling((None, None)))
        assert arr2.tiling == tiling_t.Tiling((None, None))
        want2 = np.asarray(coll_j.reshard(coll_j.reshard(
            jnp.asarray(y), tiling_j.Tiling(("x", None))),
            tiling_j.Tiling((None, None))))
        np.testing.assert_array_equal(arr2.glom(), want2)


# -- shard_map2 and dot_shardmap -----------------------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_shard_map2_matches_jax(shape):
    mj, mt = _meshes(shape)
    rng = np.random.RandomState(16)
    x = rng.rand(16, 8).astype(np.float32)
    c = rng.rand(3, 8).astype(np.float32)

    def scale_j(b):
        return b * 2.0 + b.sum(axis=1, keepdims=True)

    def scale_t(b):
        return b * 2.0 + b.sum(dim=1, keepdim=True)

    def nearest_j(p, cc):
        d = (p * p).sum(1)[:, None] - 2 * p @ cc.T + (cc * cc).sum(1)[None]
        return jnp.argmin(d, axis=1).astype(jnp.int32)

    def nearest_t(p, cc):
        d = (p * p).sum(1)[:, None] - 2 * p @ cc.T + (cc * cc).sum(1)[None]
        return torch.argmin(d, dim=1).to(torch.int32)

    for tj, tt in ((tiling_j.row(2), tiling_t.row(2)),
                   (tiling_j.block(2), tiling_t.block(2))):
        with mesh_j.use_mesh(mj):
            want = st_j.shard_map2([st_j.from_numpy(x)], scale_j, [tj], tj,
                                   (16, 8), np.float32).glom()
        with mesh_t.use_mesh(mt):
            got = st_t.shard_map2([st_t.from_numpy(x)], scale_t, [tt], tt,
                                  (16, 8), np.float32).glom()
        np.testing.assert_allclose(got, want, rtol=1e-6)
    with mesh_j.use_mesh(mj):
        want = st_j.shard_map2(
            [st_j.from_numpy(x), st_j.from_numpy(c)], nearest_j,
            [tiling_j.row(2), tiling_j.replicated(2)],
            tiling_j.Tiling(("x",)), (16,), np.int32).glom()
    with mesh_t.use_mesh(mt):
        expr = st_t.shard_map2(
            [st_t.from_numpy(x), st_t.from_numpy(c)], nearest_t,
            [tiling_t.row(2), tiling_t.replicated(2)],
            tiling_t.Tiling(("x",)), (16,), np.int32)
        assert isinstance(expr, st_t.ShardMap2Expr)
        got = expr.glom()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="one tiling per input"):
        st_t.shard_map2([st_t.from_numpy(x)], scale_t, [], tiling_t.row(2),
                        (16, 8))


@pytest.mark.parametrize("shape", MESHES)
def test_dot_shardmap_matches_jax(shape):
    """tests/test_dot.py::test_dot_shardmap_variant through both
    packages, with the result's tiling, and mixed dtypes: ``glom``
    returns what the JAX package's does."""
    mj, mt = _meshes(shape)
    rng = np.random.RandomState(8)
    a = rng.rand(16, 8).astype(np.float32)
    b = rng.rand(8, 12).astype(np.float32)
    bi = rng.randint(-3, 4, (8, 12)).astype(np.int32)
    ai = rng.randint(-3, 4, (16, 8)).astype(np.int32)
    for x, y in ((a, b), (a, bi), (ai, bi)):
        with mesh_j.use_mesh(mj):
            vj = st_j.dot_shardmap(st_j.from_numpy(x),
                                   st_j.from_numpy(y)).evaluate()
            want = vj.glom()
        with mesh_t.use_mesh(mt):
            expr = st_t.dot_shardmap(st_t.from_numpy(x), st_t.from_numpy(y))
            assert isinstance(expr, st_t.DotShardMapExpr)
            val = expr.evaluate()
            got = val.glom()
        # the smart-tiling pass commits the same output tiling
        assert val.tiling.axes == vj.tiling.axes
        assert got.dtype == want.dtype, (x.dtype, y.dtype)
        np.testing.assert_allclose(got, want, rtol=1e-4)
        np.testing.assert_allclose(got, x.astype(np.float64) @ y, rtol=1e-4)
    with mesh_t.use_mesh(mt), pytest.raises(ValueError, match="mismatch"):
        st_t.dot_shardmap(st_t.from_numpy(a), st_t.from_numpy(a))


def test_dot_shardmap_in_a_larger_expr_and_planned(mesh2d):
    rng = np.random.RandomState(9)
    a = rng.rand(16, 16).astype(np.float32)
    b = rng.rand(16, 16).astype(np.float32)
    want = (st_j.dot_shardmap(st_j.from_numpy(a), st_j.from_numpy(b))
            + 1.0).sum().glom()
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        got = (st_t.dot_shardmap(st_t.from_numpy(a), st_t.from_numpy(b))
               + 1.0).sum().glom()
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- the group forms of four kernels, under the thread runner --------------


@pytest.mark.parametrize("shape,valid", [((8, 1), None), ((8, 1), 8192 - 700),
                                         ((4, 2), 5000)])
def test_kmeans_group_form_matches_jax(shape, valid):
    mj, mt = _meshes(shape)
    n, d, k = 8 * 1024, 128, 8
    rng = np.random.RandomState(8)
    pts = rng.rand(n, d).astype(np.float32)
    cen = pts[:k].copy()
    with mesh_j.use_mesh(mj):
        sj, cj = kk_j.assign_accumulate(jnp.asarray(pts), jnp.asarray(cen),
                                        k, valid_rows=valid, mesh=mj)
    st_, ct = kk_t.assign_accumulate_sharded(
        torch.from_numpy(pts), torch.from_numpy(cen), k, valid, mt)
    np.testing.assert_allclose(st_.numpy(), np.asarray(sj), rtol=2e-5)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("k", [12, 16])
@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_segment_group_form_matches_jax(shape, k):
    """k = 16 takes the reduce_scatter + all_gather merge on both
    meshes, k = 12 the all_reduce one on (8, 1)."""
    mj, mt = _meshes(shape)
    rng = np.random.RandomState(7)
    vals = rng.randint(-8, 9, (1001, 16)).astype(np.float32)
    ids = rng.randint(-2, 20, 1001)
    FLAGS_J.native_kernels = "on"
    with mesh_j.use_mesh(mj):
        sel = reg_j.select("segment_sum", vals.shape, vals.dtype,
                           tiling_j.row(2), mj, force=True, num_segments=k)
        assert sel.pallas
        want = np.asarray(kseg_j.segment_sum_sharded(
            jnp.asarray(vals), jnp.asarray(ids.astype(np.int32)), k, sel,
            mesh=mj))
    got = kseg_t.segment_sum_sharded(torch.from_numpy(vals),
                                     torch.from_numpy(ids), k, mt)
    np.testing.assert_array_equal(got.numpy(), want)
    got1 = kseg_t.segment_sum_sharded(torch.from_numpy(vals[:, 0].copy()),
                                      torch.from_numpy(ids), k, mt)
    np.testing.assert_array_equal(got1.numpy(), want[:, 0])


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_bincount_group_form_matches_jax(shape):
    mj, mt = _meshes(shape)
    ids = np.random.RandomState(11).randint(-4, 70, 10_003).astype(np.int32)
    FLAGS_J.native_kernels = "on"
    with mesh_j.use_mesh(mj):
        sel = reg_j.select("bincount", ids.shape, ids.dtype,
                           tiling_j.row(1), mj, length=64)
        assert sel.pallas
        want = np.asarray(khist_j.bincount_sharded(jnp.asarray(ids), 64,
                                                    sel, mesh=mj))
    got = khist_t.bincount_group(torch.from_numpy(ids), 64, mt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), khist_t.bincount_sharded(torch.from_numpy(ids), 64,
                                              mt).numpy())


@pytest.mark.parametrize("kshape", [(3, 3), (2, 2), (5, 3)])
@pytest.mark.parametrize("shape", [(8, 1), (2, 4)])
def test_stencil_group_form_matches_jax(shape, kshape):
    mj, mt = _meshes(shape)
    rng = np.random.RandomState(9)
    img = rng.rand(2, 64, 16, 8).astype(np.float32)
    flt = rng.rand(kshape[0], kshape[1], 8, 4).astype(np.float32)
    axes = (None, "x", None, None)
    FLAGS_J.native_kernels = "on"
    with mesh_j.use_mesh(mj):
        sel = reg_j.select("stencil", img.shape, img.dtype,
                           tiling_j.Tiling(axes), mj, stride=(1, 1),
                           padding="SAME", kshape=kshape, out_channels=4)
        assert sel.pallas
        want = np.asarray(kst_j.halo_stencil(
            jnp.asarray(img), jnp.asarray(flt), tiling_j.Tiling(axes), sel,
            mesh=mj))
    got = kst_t.halo_stencil_sharded(torch.from_numpy(img),
                                     torch.from_numpy(flt),
                                     tiling_t.Tiling(axes), mt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the logical mesh's one-launch form gives the same values
    one = kst_t.halo_stencil(torch.from_numpy(img), torch.from_numpy(flt),
                             tiling_t.Tiling(axes), mt)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-6)


# -- the runner's contract -------------------------------------------------


def test_a_failing_position_raises_and_does_not_hang(monkeypatch):
    mt = mesh_t.build_mesh((8, 1))
    x = torch.arange(8.0)

    def body(v):
        if coll_t.axis_index("x") == 3:
            raise KeyError("position 3 failed")
        return coll_t.all_reduce(v, "x")

    t0 = time.perf_counter()
    with pytest.raises(KeyError, match="position 3"):
        smap_t.shard_map(body, mt, (tiling_t.row(1),), tiling_t.row(1))(x)
    assert time.perf_counter() - t0 < 30

    # a position that skips a rendezvous: the others time out and raise
    def skipper(v):
        if coll_t.axis_index("x") == 0:
            return v
        return coll_t.all_reduce(v, "x")

    monkeypatch.setattr(smap_t, "RENDEZVOUS_TIMEOUT_S", 0.5)
    t0 = time.perf_counter()
    with pytest.raises(threading.BrokenBarrierError):
        smap_t.shard_map(skipper, mt, (tiling_t.row(1),),
                         tiling_t.row(1))(x)
    assert time.perf_counter() - t0 < 30
    assert smap_t._WORKERS.busy() == 0  # every worker given back


def test_indivisible_extents_raise():
    mt = mesh_t.build_mesh((4, 2))
    with pytest.raises(ValueError, match="does not divide"):
        smap_t.shard_map(lambda v: v, mt, (tiling_t.row(2),),
                         tiling_t.row(2))(torch.zeros(6, 4))
    with pytest.raises(ValueError, match="does not split"):
        smap_t.shard_map(lambda v: coll_t.reduce_scatter(v, "x"), mt,
                         (tiling_t.row(2),), tiling_t.row(2))(
            torch.zeros(12, 4))


def test_positions_carry_the_callers_thread_state():
    from spartan_tpu_torch.obs import trace

    mt = mesh_t.build_mesh((2, 2))
    seen = []
    lock = threading.Lock()

    def body(v):
        with lock:
            seen.append((mesh_t.get_mesh() is pinned, torch.is_grad_enabled(),
                         getattr(trace._tls, "depth", 0)))
        return v

    pinned = mesh_t.build_mesh((4, 1))
    with mesh_t.use_mesh(pinned), torch.no_grad():
        depth = getattr(trace._tls, "depth", 0)
        smap_t.shard_map(body, mt, (tiling_t.row(1),), tiling_t.row(1))(
            torch.zeros(4))
    assert seen == [(True, False, depth)] * 4
    seen.clear()
    with mesh_t.use_mesh(pinned):
        smap_t.shard_map(body, mt, (tiling_t.row(1),), tiling_t.row(1))(
            torch.zeros(4))
    assert seen == [(True, True, depth)] * 4


def test_gradients_flow_across_positions():
    """A replicated scalar out of an all_reduce counts the loss once."""
    mt = mesh_t.build_mesh((4, 2))
    w = torch.randn(8, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = smap_t.shard_map(lambda b: coll_t.all_reduce((b * b).sum(), "x"),
                         mt, (tiling_t.Tiling(("x", None)),),
                         tiling_t.Tiling(()))(w)
    y.backward()
    torch.testing.assert_close(w.grad, 2 * w.detach())


def test_kernel_steps_take_the_group_form_only_on_a_group_mesh():
    """Without a group mesh the k-means step and the segment sum keep
    their one-pass forms and build no default mesh (the package's
    default device is cuda)."""
    from spartan_tpu_torch.ops import segment as seg_t

    mesh_t.set_default_device("cuda")
    try:
        assert mesh_t.ambient_group() is None
        p = torch.from_numpy(np.random.RandomState(4).rand(2048, 128)
                             .astype(np.float32))
        got = kk_t.step(p, p[:4].clone(), 4)
        s, n = kk_t.assign_accumulate_plain(p, p[:4].clone(), 4)
        torch.testing.assert_close(got, s / n.clamp_min(1.0)[:, None],
                                   rtol=0, atol=0)
    finally:
        mesh_t.set_default_device("cpu")
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        assert mesh_t.ambient_group() is None
        vals = torch.ones(16, 2)
        ids = torch.arange(16) % 4
        torch.testing.assert_close(
            seg_t.segment_sum(vals, ids, 4, impl="pallas"),
            torch.full((4, 2), 4.0))
