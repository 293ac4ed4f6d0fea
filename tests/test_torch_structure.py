"""Parity of the PyTorch port's structure ops with the JAX package, on
the CPU: the extent algebra and region fetch, transpose / reshape /
ravel / concatenate, outer, assign and write_array with every reducer,
shuffle on both modes with every combiner, the contraction family
(einsum, tensordot, matmul, inner) and the builtins ported with them
(prod, all, any, the user reduce, var, std, ptp, norm, diag, diagonal,
tril, triu, trace, outer_product, randint).

The same seeded numpy inputs go through both packages, on the 4x2 mesh
(``mesh2d``) unless a test names the 8x1 mesh. Data movement must match
exactly; contractions and sums at rtol 1e-5 (f32 sums of a few dozen
products, taken in another order); randint for its range and dtype only
(torch.Generator and jax.random draw different numbers).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spartan_tpu as st_j
from spartan_tpu.array import distarray as da_j
from spartan_tpu.array import extent as extent_j
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.array.extent import TileExtent as TE_j
from spartan_tpu.expr.contract import canonicalize as canon_j
from spartan_tpu.expr.contract import parse_einsum_2op as parse_j
import spartan_tpu_torch as st_t
from spartan_tpu_torch.array import distarray as da_t
from spartan_tpu_torch.array import extent as extent_t
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.array.extent import TileExtent as TE_t
from spartan_tpu_torch.expr.contract import ContractExpr
from spartan_tpu_torch.expr.contract import canonicalize as canon_t
from spartan_tpu_torch.expr.contract import parse_einsum_2op as parse_t
from spartan_tpu_torch.expr.map2 import Map2Expr
from spartan_tpu_torch.expr.optimize import dag_nodes
from spartan_tpu_torch.parallel import mesh as mesh_t

# the module, not the function of the same name that expr/__init__ exports
shuffle_t = importlib.import_module("spartan_tpu_torch.expr.shuffle")

torch.set_num_threads(1)

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu(mesh2d):
    """The JAX package on its 4x2 mesh, the port on the CPU on a logical
    4x2 mesh."""
    prev_dev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    with mesh_t.use_mesh(mesh_t.build_mesh((4, 2))):
        yield
    mesh_t.set_default_device(prev_dev)


@pytest.fixture()
def rows8(mesh1d):
    """Both packages on an 8x1 mesh (the JAX side's mesh1d)."""
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        yield


def _rand(*shape, seed=0):
    return np.random.RandomState(seed + sum(shape)).rand(*shape).astype(
        np.float32)


def _both(fn, *arrays):
    """``fn(st, *exprs)`` in each package on the same numpy arrays:
    (jax result, port result) as numpy."""
    ej = fn(st_j, *[st_j.from_numpy(a) for a in arrays])
    et = fn(st_t, *[st_t.from_numpy(a) for a in arrays])
    return np.asarray(ej.glom()), np.asarray(et.glom())


def _same(ref, out):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


def _close(ref, out, rtol=RTOL, atol=1e-6):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


# -- extents, fetch, reducers --------------------------------------------------


_SLICES = [(slice(2, 5), slice(3, 7)), (1,), (slice(None), -1),
           (slice(-3, None), slice(0, 0)), 4, (slice(6, 2),)]


@pytest.mark.parametrize("idx", range(len(_SLICES)))
def test_from_slice_matches_jax(idx):
    ix = _SLICES[idx]
    ej = extent_j.from_slice(ix, (10, 12))
    et = extent_t.from_slice(ix, (10, 12))
    assert (et.ul, et.lr, et.array_shape) == (ej.ul, ej.lr, ej.array_shape)
    assert et.to_slice() == ej.to_slice()


def test_from_slice_errors_match_jax():
    for bad, err in (((slice(0, 9, 2),), ValueError), ((0, 0, 0), IndexError),
                     ((12,), IndexError), (("a",), TypeError)):
        with pytest.raises(err):
            extent_j.from_slice(bad, (10, 12))
        with pytest.raises(err):
            extent_t.from_slice(bad, (10, 12))


@pytest.mark.parametrize("a,b", [
    (((0, 0), (4, 4)), ((2, 3), (6, 8))), (((0, 0), (4, 4)), ((4, 0), (6, 4))),
    (((1, 1), (9, 9)), ((3, 3), (5, 5))), (((0,), (5,)), ((5,), (9,)))])
def test_intersection_and_offsets_match_jax(a, b):
    shape = (10,) * len(a[0])
    aj, bj = TE_j(*a, shape), TE_j(b[0], b[1])
    at, bt = TE_t(*a, shape), TE_t(b[0], b[1])
    ij, it = extent_j.intersection(aj, bj), extent_t.intersection(at, bt)
    if ij is None:
        assert it is None
        return
    assert (it.ul, it.lr, it.array_shape) == (ij.ul, ij.lr, ij.array_shape)
    assert at.offset_slice(it) == aj.offset_slice(ij)
    oj, ot = ij.offset_from(aj), it.offset_from(at)
    assert (ot.ul, ot.lr, ot.array_shape) == (oj.ul, oj.lr, oj.array_shape)
    with pytest.raises(ValueError):
        TE_t((0,) * len(shape), shape).offset_from(it)


@pytest.mark.parametrize("region", [(slice(1, 5), slice(2, 9)), 3,
                                    (slice(None), 0)])
def test_fetch_matches_jax(region):
    x = _rand(8, 10)
    ref = da_j.from_numpy(x).fetch(region)
    out = da_t.from_numpy(x).fetch(region)
    _same(np.asarray(ref), out)
    r = extent_t.from_slice(region, (8, 10))
    _same(np.asarray(ref), da_t.from_numpy(x).fetch(r))


def test_canonical_reducer_matches_jax():
    for r in (None, "set", "add", "mul", "max", "min", np.add, np.multiply,
              np.maximum, np.minimum):
        assert da_t._canonical_reducer(r) == da_j._canonical_reducer(r)
    for bad in ("sub", np.subtract, len):
        with pytest.raises(ValueError):
            da_j._canonical_reducer(bad)
        with pytest.raises(ValueError):
            da_t._canonical_reducer(bad)


# -- transpose / reshape / ravel / concatenate -----------------------------------


_SHAPE_OPS = {
    "T": (lambda st, x: x.T, [(6, 8)]),
    "transpose_fn": (lambda st, x: st.transpose(x, (1, 0)), [(6, 8)]),
    "transpose_3d": (lambda st, x: x.transpose(2, 0, 1), [(2, 3, 4)]),
    "transpose_list": (lambda st, x: st.transpose(x, [0, 2, 1]), [(4, 6, 8)]),
    "reshape": (lambda st, x: x.reshape(4, 16), [(8, 8)]),
    "reshape_neg": (lambda st, x: x.reshape(-1, 32), [(8, 8)]),
    "reshape_tuple": (lambda st, x: st.reshape(x, (2, 4, 8)), [(8, 8)]),
    "ravel": (lambda st, x: x.ravel(), [(8, 8)]),
    "ravel_fn": (lambda st, x: st.ravel(x), [(3, 5, 7)]),
    "transpose_of_map": (lambda st, x: (x * 2.0 + 1.0).T, [(5, 9)]),
    "reshape_of_transpose": (lambda st, x: x.T.reshape(-1), [(6, 4)]),
    "concat0": (lambda st, x, y: st.concatenate([x, y]), [(4, 8), (6, 8)]),
    "concat1": (lambda st, x, y: st.concatenate([x, y], axis=1),
                [(4, 8), (4, 3)]),
    "concat_neg": (lambda st, x, y: st.concatenate([x, y, x], axis=-1),
                   [(2, 3, 4), (2, 3, 5)]),
}


@pytest.mark.parametrize("name", sorted(_SHAPE_OPS))
def test_shape_ops_match_jax(name):
    fn, shapes = _SHAPE_OPS[name]
    arrays = [_rand(*s, seed=i) for i, s in enumerate(shapes)]
    ref, out = _both(fn, *arrays)
    _same(ref, out)


def test_shape_op_results_do_not_alias_inputs():
    x = st_t.from_numpy(_rand(8, 8))
    for e in (x.reshape(4, 16), x.ravel(), x.T):
        out = e.evaluate()
        assert out.tensor.data_ptr() != x.value.tensor.data_ptr()


def test_concatenate_int_and_float_promote_like_jax():
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    b = _rand(2, 4)
    ref, out = _both(lambda st, x, y: st.concatenate([x, y]), a, b)
    _same(ref, out)


def test_shape_op_errors_match_jax():
    for st in (st_j, st_t):
        x = st.from_numpy(_rand(8, 8))
        with pytest.raises(ValueError):
            st.transpose(x, (0, 0))
        with pytest.raises(ValueError):
            x.reshape(3, 5)
        with pytest.raises(ValueError):
            x.reshape(-1, -1)
        with pytest.raises(ValueError):
            st.concatenate([x, st.from_numpy(np.zeros((3, 3), np.float32))])
        with pytest.raises(ValueError):
            st.concatenate([])


def test_shape_op_tilings_match_jax():
    """Output tilings over the same 4x2 mesh: transpose permutes the
    input's, reshape re-places, concatenate frees the joined axis."""
    x = _rand(8, 6)
    for fn in (lambda st, e: e.T, lambda st, e: e.reshape(4, 12),
               lambda st, e: st.concatenate([e, e], axis=1),
               lambda st, e: st.concatenate([e, e])):
        ej = fn(st_j, st_j.from_numpy(x))
        et = fn(st_t, st_t.from_numpy(x))
        assert et.out_tiling().axes == ej.out_tiling().axes


# -- outer ---------------------------------------------------------------------


def _fn_outer(a, b):
    return a * 2.0 - b


@pytest.mark.parametrize("fn", [None, _fn_outer])
@pytest.mark.parametrize("n,m", [(16, 24), (7, 5)])
def test_outer_matches_jax(fn, n, m):
    a, b = _rand(n, seed=1), _rand(m, seed=2)
    ref, out = _both(lambda st, x, y: st.outer(x, y, fn), a, b)
    _same(ref, out)
    e = st_t.outer(st_t.from_numpy(a), st_t.from_numpy(b), fn)
    assert e.out_tiling().axes == ("x", "y")


def test_outer_rejects_non_vectors():
    with pytest.raises(ValueError, match="1-D"):
        st_t.outer(st_t.from_numpy(_rand(2, 3)), st_t.from_numpy(_rand(3)))


# -- assign / write_array ------------------------------------------------------


_REGIONS = [(slice(0, 2), slice(0, 8)), (slice(0, 8), slice(0, 1)),
            (3, slice(2, 6)), (slice(1, 7), slice(1, 7))]


@pytest.mark.parametrize("reducer", [None, "set", "add", "mul", "max", "min",
                                     np.add, np.maximum])
@pytest.mark.parametrize("ridx", range(len(_REGIONS)))
def test_assign_matches_jax(reducer, ridx):
    region = _REGIONS[ridx]
    x = _rand(8, 8)
    shape = extent_t.from_slice(region, (8, 8)).shape
    v = _rand(*shape, seed=5) * 3.0 - 1.0
    ref, out = _both(lambda st, e, ve: st.assign(e, region, ve,
                                                 reducer=reducer), x, v)
    _same(ref, out)


@pytest.mark.parametrize("value", [7.0, 2, "row"])
def test_assign_broadcasts_like_jax(value):
    x = _rand(8, 8)
    region = (slice(1, 4), slice(0, 8))
    val = _rand(8, seed=3) if value == "row" else value
    ej = st_j.assign(st_j.from_numpy(x), region, val, reducer="add")
    et = st_t.assign(st_t.from_numpy(x), region, val, reducer="add")
    _same(np.asarray(ej.glom()), et.glom())


def test_assign_takes_an_extent_and_chains():
    x = _rand(6, 6)
    ej = st_j.assign(st_j.from_numpy(x), TE_j((1, 1), (3, 4), (6, 6)), 5.0)
    ej = st_j.assign(ej, (slice(0, 6), 5), 1.0, reducer="mul")
    et = st_t.assign(st_t.from_numpy(x), TE_t((1, 1), (3, 4), (6, 6)), 5.0)
    et = st_t.assign(et, (slice(0, 6), 5), 1.0, reducer="mul")
    _same(np.asarray(ej.glom()), et.glom())


@pytest.mark.parametrize("dtype,reducer", [(None, None), (np.int32, None),
                                           (np.float32, "add")])
def test_write_array_matches_jax(dtype, reducer):
    data = np.arange(6, dtype=np.float32).reshape(2, 3) + 0.5
    region = (slice(1, 3), slice(2, 5))
    ej = st_j.write_array((5, 5), region, st_j.from_numpy(data), dtype=dtype,
                          reducer=reducer)
    et = st_t.write_array((5, 5), region, st_t.from_numpy(data), dtype=dtype,
                          reducer=reducer)
    _same(np.asarray(ej.glom()), et.glom())


# -- shuffle -------------------------------------------------------------------


# Kernels emit (ul, lr) pairs, which both packages' shuffles take as
# target extents.


def _transpose_kernel(ext, block):
    yield ((ext.ul[1], ext.ul[0]), (ext.lr[1], ext.lr[0])), block.T


def _colsum_kernel(ext, block):
    yield ((0, ext.ul[1]), (1, ext.lr[1])), block.sum(axis=0, keepdims=True)


def _rowmax_kernel(ext, block):
    yield ((0, 0), (1, block.shape[1])), block.max(axis=0, keepdims=True)


def _scale_kernel(ext, block, factor=2.0):
    yield ext, factor * block
    yield ((ext.ul[0], 0), (ext.ul[0] + 1, 1)), 1.5


def _shuffle_both(a, kernel, **kw):
    """The same shuffle of row-tiled ``a`` in each package."""
    kw.setdefault("combiner", "set")
    sj = st_j.shuffle(st_j.from_numpy(a, tiling=tiling_j.row(2)), kernel,
                      **kw)
    st_ = st_t.shuffle(st_t.from_numpy(a, tiling=tiling_t.row(2)), kernel,
                       **kw)
    return np.asarray(sj.glom()), st_.glom()


_SHUFFLES = {
    "transpose_set": (_transpose_kernel, (16, 12), dict(target_shape=(12, 16))),
    "colsum_add": (_colsum_kernel, (24, 8), dict(target_shape=(1, 8),
                                                 combiner="add")),
    "rowmax_max": (_rowmax_kernel, (16, 4), dict(target_shape=(1, 4),
                                                 combiner="max")),
    "rowmax_min": (_rowmax_kernel, (16, 4), dict(target_shape=(1, 4),
                                                 combiner="min")),
    "scale_mul_ufunc": (_scale_kernel, (16, 6), dict(target_shape=(16, 6),
                                                     combiner=np.multiply)),
    "scale_add_kw": (_scale_kernel, (16, 6), dict(target_shape=(16, 6),
                                                  combiner="add",
                                                  kw={"factor": 3.0})),
    "transpose_nondivisible": (_transpose_kernel, (16, 10),
                               dict(target_shape=(10, 16))),
    "dtype_f32_tiling": (_transpose_kernel, (8, 16),
                         dict(target_shape=(16, 8), dtype=np.float64)),
}


@pytest.mark.parametrize("mode", ["sharded", "host"])
@pytest.mark.parametrize("name", sorted(_SHUFFLES))
def test_shuffle_matches_jax(rows8, name, mode):
    kernel, shape, kw = _SHUFFLES[name]
    a = _rand(*shape, seed=3)
    ref, out = _shuffle_both(a, kernel, mode=mode, **dict(kw))
    _close(ref, out, rtol=1e-6)


@pytest.mark.parametrize("workers", [1, 3, None])
def test_shuffle_into_existing_target_matches_jax(rows8, workers):
    a, base = _rand(16, 4, seed=1), _rand(16, 4, seed=2)

    def double_kernel(ext, block):
        yield ext, 2.0 * block

    sj = st_j.shuffle(st_j.from_numpy(a, tiling=tiling_j.row(2)),
                      double_kernel, target=st_j.from_numpy(
                          base, tiling=tiling_j.row(2)), combiner="add")
    tgt = st_t.from_numpy(base, tiling=tiling_t.row(2))
    st_ = st_t.shuffle(st_t.from_numpy(a, tiling=tiling_t.row(2)),
                       double_kernel, target=tgt, combiner="add",
                       workers=workers)
    _close(np.asarray(sj.glom()), st_.glom(), rtol=1e-6)
    _same(base, tgt.glom())  # the target itself is not changed


def test_shuffle_set_order_is_source_tile_then_emission(rows8):
    """Every tile writes the same cell: under 'set' the last source
    tile's last emission wins, as in the JAX package."""
    a = _rand(16, 4, seed=4)

    def corner(ext, block):
        yield ((0, 0), (1, 1)), block[:1, :1]
        yield ((0, 0), (1, 1)), block[1:2, :1]

    ref, out = _shuffle_both(a, corner, target_shape=(2, 2))
    _same(ref, out)
    assert out[0, 0] == a[15, 0]


def test_shuffle_never_gathers_the_source(rows8, monkeypatch):
    a = _rand(32, 8, seed=5)
    src = st_t.from_numpy(a, tiling=tiling_t.row(2)).evaluate()
    tile_size = max(e.size for e in src.extents())
    real_fetch = da_t.DistArray.fetch

    def no_glom(self):
        raise AssertionError("the sharded shuffle must not glom()")

    def bounded_fetch(self, region):
        assert isinstance(region, TE_t) and region.size <= tile_size
        return real_fetch(self, region)

    monkeypatch.setattr(da_t.DistArray, "glom", no_glom)
    monkeypatch.setattr(da_t.DistArray, "fetch", bounded_fetch)
    out = st_t.shuffle(src, _transpose_kernel, target_shape=(8, 32),
                       combiner="set")
    monkeypatch.undo()
    _same(a.T, out.glom())
    assert out.evaluate().tiling.axes == tiling_t.default_tiling(
        (8, 32), mesh_t.get_mesh()).axes


def test_shuffle_host_residency_bounded(rows8, monkeypatch):
    live = {"now": 0, "peak": 0}

    def hook(event, nbytes):
        live["now"] += nbytes if event == "alloc" else -nbytes
        live["peak"] = max(live["peak"], live["now"])

    monkeypatch.setattr(shuffle_t, "_block_lifecycle_hook", hook)
    a = _rand(8, 8, seed=8)

    def corner_kernel(ext, block):
        yield ((0, 0), (1, 1)), block[:1, :1]

    out = st_t.shuffle(st_t.from_numpy(a, tiling=tiling_t.row(2)),
                       corner_kernel, target_shape=(1024, 256),
                       tiling=tiling_t.row(2), combiner="set")
    assert 0 < live["peak"] <= 1024 * 256 * 4 // 8
    assert live["now"] == 0
    assert float(out.glom()[0, 0]) == a[7, 0]


def test_shuffle_kernels_run_concurrently(rows8):
    import threading

    state = {"active": 0, "peak": 0}
    lock = threading.Lock()
    both_in = threading.Event()

    def slow_kernel(ext, block):
        with lock:
            state["active"] += 1
            state["peak"] = max(state["peak"], state["active"])
            if state["active"] >= 2:
                both_in.set()
        both_in.wait(timeout=5.0)
        with lock:
            state["active"] -= 1
        yield ext, block

    a = _rand(32, 4, seed=7)
    out = st_t.shuffle(st_t.from_numpy(a, tiling=tiling_t.row(2)),
                       slow_kernel, target_shape=(32, 4), combiner="set",
                       workers=4)
    _same(a, out.glom())
    assert state["peak"] >= 2


@pytest.mark.parametrize("workers", [1, 4])
def test_shuffle_kernel_error_propagates(rows8, workers):
    def bad_kernel(ext, block):
        if ext.ul[0] >= 8:
            raise ValueError(f"kernel failed on tile {ext.ul}")
        yield ext, block

    with pytest.raises(ValueError, match="kernel failed on tile"):
        st_t.shuffle(st_t.from_numpy(np.ones((16, 4), np.float32),
                                     tiling=tiling_t.row(2)),
                     bad_kernel, target_shape=(16, 4), combiner="set",
                     workers=workers)


def test_shuffle_argument_errors():
    x = st_t.from_numpy(np.ones((4, 4), np.float32))
    with pytest.raises(ValueError, match="target_shape"):
        st_t.shuffle(x, _transpose_kernel)
    with pytest.raises(ValueError, match="combiner"):
        st_t.shuffle(x, _transpose_kernel, target_shape=(4, 4),
                     combiner=np.subtract)
    with pytest.raises(ValueError, match="mode"):
        st_t.shuffle(x, _transpose_kernel, target_shape=(4, 4), mode="x")


# -- contractions --------------------------------------------------------------


_EINSUMS = {
    "batched": ("bij,bjk->bik", [(16, 32, 24), (16, 24, 40)], True),
    "ellipsis": ("...ij,...jk->...ik", [(16, 32, 24), (16, 24, 40)], True),
    "implicit": ("ij,jk", [(12, 24), (24, 8)], True),
    "outer_labels": ("i,j->ij", [(5,), (7,)], True),
    "contract_all": ("ij,ij->", [(6, 9), (6, 9)], True),
    "free_sum": ("ij,jk->k", [(6, 9), (9, 4)], True),
    "chain3": ("ij,jk,kl->il", [(24, 32), (32, 40), (40, 16)], True),
    "chain4": ("bij,bjk,kl,lm->bim", [(6, 8, 10), (6, 10, 12), (12, 5),
                                      (5, 7)], True),
    "shared3": ("ab,bc,b->ac", [(4, 8), (8, 5), (8,)], True),
    "diagonal": ("ii,ij->j", [(24, 24), (24, 12)], False),
    "broadcast_batch": ("bij,bjk->bik", [(1, 8, 8), (16, 8, 8)], False),
    "single": ("ij->ji", [(5, 6)], False),
}


@pytest.mark.parametrize("name", sorted(_EINSUMS))
def test_einsum_matches_jax(name):
    spec, shapes, contract = _EINSUMS[name]
    arrays = [_rand(*s, seed=i) for i, s in enumerate(shapes)]
    ref, out = _both(lambda st, *xs: st.einsum(spec, *xs), *arrays)
    _close(ref, out, rtol=1e-4 if len(shapes) > 2 else RTOL)
    e = st_t.einsum(spec, *[st_t.from_numpy(a) for a in arrays])
    assert isinstance(e, ContractExpr) == contract
    if not contract:
        assert isinstance(e, Map2Expr)


def test_einsum_chain_is_pairwise():
    arrays = [_rand(*s, seed=i) for i, s in
              enumerate([(6, 8, 10), (6, 10, 12), (12, 5), (5, 7)])]
    e = st_t.einsum("bij,bjk,kl,lm->bim",
                    *[st_t.from_numpy(a) for a in arrays])
    assert len([n for n in dag_nodes(e) if isinstance(n, ContractExpr)]) == 3


@pytest.mark.parametrize("axes", [[[2], [0]], 1, ([1, 2], [0, 1]), 0])
def test_tensordot_matches_jax(axes):
    a = _rand(6, 8, 24)
    b = _rand(24, 10) if axes in ([[2], [0]], 1) else _rand(8, 24, 3)
    if axes == 0:
        b = _rand(3, 2)
    ref, out = _both(lambda st, x, y: st.tensordot(x, y, axes=axes), a, b)
    _close(ref, out)


def test_tensordot_rejects_bad_axes_like_jax():
    for st in (st_j, st_t):
        a, b = st.from_numpy(_rand(4, 5)), st.from_numpy(_rand(5, 6))
        with pytest.raises(ValueError):
            st.tensordot(a, b, axes=3)
        with pytest.raises(ValueError):
            st.tensordot(a, b, axes=([0, 1], [0]))
        with pytest.raises(ValueError):
            st.tensordot(a, b, axes=([5], [0]))


@pytest.mark.parametrize("sa,sb", [((8, 16, 24), (8, 24, 12)),
                                   ((8, 16, 24), (24, 12)),
                                   ((2, 3, 4, 5), (3, 5, 6)),
                                   ((6, 7), (7, 3)), ((7,), (7, 3))])
def test_matmul_matches_jax(sa, sb):
    ref, out = _both(lambda st, x, y: st.matmul(x, y), _rand(*sa),
                     _rand(*sb, seed=1))
    _close(ref, out)


@pytest.mark.parametrize("sa,sb", [((12, 24), (8, 24)), ((24,), (24,)),
                                   ((3, 4, 6), (5, 6))])
def test_inner_matches_jax(sa, sb):
    ref, out = _both(lambda st, x, y: st.inner(x, y), _rand(*sa),
                     _rand(*sb, seed=2))
    _close(ref, out)


@pytest.mark.parametrize("spec,ndims", [("bij,bjk->bik", (3, 3)),
                                        ("...ij,...jk->...ik", (4, 3)),
                                        ("ij,jk", (2, 2)),
                                        ("ii,ij->j", (2, 2)),
                                        ("i,j->ij", (1, 1)),
                                        ("ab,bc->ca", (2, 2)),
                                        ("...i,...i", (3, 2))])
def test_parse_einsum_matches_jax(spec, ndims):
    assert parse_t(spec, *ndims) == parse_j(spec, *ndims)


def test_canonicalize_matches_jax():
    ops = (("x", "q"), ("q", "z"))
    assert canon_t(ops, ("x", "z")) == canon_j(ops, ("x", "z"))


def test_contract_node_metadata():
    a, b = st_t.from_numpy(_rand(4, 6)), st_t.from_numpy(_rand(6, 5))
    e = st_t.einsum("ij,jk->ik", a, b)
    assert e.flops() == 2.0 * 4 * 6 * 5
    assert e.contraction_labels == ("b",)
    assert e._dot_plan is None
    assert e.out_tiling().axes == ("x", "y")


@pytest.mark.parametrize("offset", [0, 1, -2])
def test_trace_and_outer_product_match_jax(offset):
    x = _rand(6, 6)
    ref, out = _both(lambda st, e: st.trace(e, offset=offset), x)
    _close(ref, out)
    xi = np.arange(20, dtype=np.int32).reshape(4, 5)
    ref, out = _both(lambda st, e: st.trace(e, offset=offset), xi)
    _same(ref, out)
    ref, out = _both(lambda st, u, v: st.outer_product(u, v), _rand(3, 2),
                     _rand(5))
    _same(ref, out)


# -- reductions and builtins ---------------------------------------------------


_REDUCE_CASES = [(None, False), (0, False), (1, True), ((0, 2), False),
                 ((0, 1, 2), True)]


@pytest.mark.parametrize("op", ["prod", "all", "any"])
@pytest.mark.parametrize("case", range(len(_REDUCE_CASES)))
@pytest.mark.parametrize("kind", ["f32", "i32", "bool"])
def test_prod_all_any_match_jax(op, case, kind):
    axis, keepdims = _REDUCE_CASES[case]
    rng = np.random.RandomState(case)
    if kind == "f32":
        x = (rng.rand(3, 4, 5) * 1.5 + 0.25).astype(np.float32)
        x[1, 2, 3] = 0.0
    elif kind == "i32":
        x = rng.randint(-2, 3, (3, 4, 5)).astype(np.int32)
    else:
        x = rng.rand(3, 4, 5) > 0.2
    ref, out = _both(lambda st, e: getattr(st, op)(e, axis=axis,
                                                   keepdims=keepdims), x)
    _close(ref, out, rtol=1e-5 if kind == "f32" else 0, atol=0)


def test_expr_all_any_methods_match_jax():
    x = _rand(4, 6) > 0.3
    for fn in (lambda st, e: e.all(), lambda st, e: e.any(axis=1),
               lambda st, e: e.all(axis=0, keepdims=True)):
        ref, out = _both(fn, x)
        _same(ref, out)


def test_general_reduce_matches_jax():
    x = _rand(6, 8)
    ej = st_j.reduce(st_j.from_numpy(x), axis=1,
                     local_reduce_fn=lambda v, axis: jnp.max(v, axis=axis),
                     accumulate_fn=np.maximum)
    et = st_t.reduce(st_t.from_numpy(x), axis=1,
                     local_reduce_fn=lambda v, axis: torch.amax(v, dim=axis),
                     accumulate_fn=np.maximum)
    _same(np.asarray(ej.glom()), et.glom())
    assert et.out_tiling().axes == ej.out_tiling().axes
    ej = st_j.reduce(st_j.from_numpy(x), local_reduce_fn=lambda v, axis:
                     jnp.sum(v, axis=axis), dtype=np.float32)
    et = st_t.reduce(st_t.from_numpy(x), local_reduce_fn=lambda v, axis:
                     torch.sum(v) if axis is None else torch.sum(v, axis),
                     dtype=np.float32)
    _close(np.asarray(ej.glom()), et.glom())


_STATS = {
    "var": lambda st, e: st.var(e),
    "var_axis_ddof": lambda st, e: st.var(e, axis=0, ddof=1),
    "std_keepdims": lambda st, e: st.std(e, axis=1, keepdims=True),
    "std_axes": lambda st, e: st.std(e, axis=(0, 1)),
    "ptp": lambda st, e: st.ptp(e),
    "ptp_axis": lambda st, e: st.ptp(e, axis=1),
    "norm2": lambda st, e: st.norm(e),
    "norm1": lambda st, e: st.norm(e, ord=1),
    "diag_of_matrix": lambda st, e: st.diag(e),
    "diagonal": lambda st, e: st.diagonal(e),
    "diag_of_vector": lambda st, e: st.diag(e[0]),
    "tril": lambda st, e: st.tril(e),
    "tril_k": lambda st, e: st.tril(e, 1),
    "triu": lambda st, e: st.triu(e),
    "triu_k": lambda st, e: st.triu(e, -2),
}


@pytest.mark.parametrize("name", sorted(_STATS))
def test_stats_and_matrix_builtins_match_jax(name):
    x = _rand(7, 7) * 4.0 - 2.0
    ref, out = _both(_STATS[name], x)
    _close(ref, out)


def test_norm_and_diag_errors():
    x = st_t.from_numpy(_rand(2, 2, 2))
    with pytest.raises(ValueError, match="norm order"):
        st_t.norm(x, ord=3)
    with pytest.raises(ValueError, match="1-D or 2-D"):
        st_t.diag(x)
    with pytest.raises(ValueError, match="2-D"):
        st_t.diagonal(x)


@pytest.mark.parametrize("low,high", [(0, 10), (-5, 5), (3, 4)])
def test_randint_range_and_dtype(low, high):
    ej = st_j.randint(50, 40, low=low, high=high, seed=3)
    et = st_t.randint(50, 40, low=low, high=high, seed=3)
    rj, rt = np.asarray(ej.glom()), et.glom()
    assert rt.dtype == rj.dtype == np.int32 and rt.shape == rj.shape
    assert rt.min() >= low and rt.max() < high
    assert np.array_equal(rt, st_t.randint(50, 40, low=low, high=high,
                                           seed=3).glom())
    if high - low > 1:
        assert len(np.unique(rt)) == high - low


def test_randint_range_is_part_of_the_plan_key():
    a = st_t.randint(8, low=0, high=2, seed=1).glom()
    b = st_t.randint(8, low=100, high=102, seed=1).glom()
    assert a.max() < 2 and b.min() >= 100
