"""Parity of the PyTorch port's sparse slice with the JAX package, on the
CPU: the windowed sorted-segment sum, ``SparseDistArray`` and PageRank.

The same seeded numpy inputs go through both packages. The JAX
``SegmentPlan.segment_sum`` runs its Pallas kernel in interpret mode (as
tests/test_sparse.py runs it); the port's plan runs the windowed
kernel's plain version, since its tensors lie on the CPU. Sparse arrays
are compared entry for entry: the same ``nse``, the same padding pattern.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

from spartan_tpu.array.sparse import SparseDistArray as SpJ
from spartan_tpu.examples.pagerank import pagerank as pagerank_j
from spartan_tpu.ops import segment as seg_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu_torch import SparseDistArray as SpT
from spartan_tpu_torch.examples.pagerank import pagerank as pagerank_t
from spartan_tpu_torch.kernels import segment as kseg_t
from spartan_tpu_torch.ops import segment as seg_t
from spartan_tpu_torch.parallel import mesh as mesh_t

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU, on a logical 8x1 mesh (the JAX tests' mesh1d
    shape)."""
    prev_dev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        yield
    mesh_t.set_default_device(prev_dev)


@pytest.fixture()
def one_device():
    """Both packages on a one-device mesh (the JAX windowed path's
    requirement)."""
    mj = mesh_j.build_mesh(jax.devices()[:1], shape=(1, 1))
    with mesh_j.use_mesh(mj), mesh_t.use_mesh(mesh_t.build_mesh((1, 1))):
        yield


def _np(a):
    return np.asarray(jax.device_get(a))


def _state(sp_j):
    """A JAX-package sparse array's state, glommed."""
    return _np(sp_j.data), _np(sp_j.rows), _np(sp_j.cols)


def _same_layout(sp_t, sp_j, data_exact=True):
    assert sp_t.shape == sp_j.shape
    assert sp_t.nnz == sp_j.nnz and sp_t.nse == sp_j.nse
    d_j, r_j, c_j = _state(sp_j)
    np.testing.assert_array_equal(sp_t.rows.numpy(), r_j)
    np.testing.assert_array_equal(sp_t.cols.numpy(), c_j)
    assert sp_t.rows.dtype == sp_t.cols.dtype == torch.int32
    if data_exact:
        np.testing.assert_array_equal(sp_t.data.numpy(), d_j)
    else:
        np.testing.assert_allclose(sp_t.data.numpy(), d_j, rtol=1e-6)


def _random_sparse(n, m, density, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, m) * (rng.rand(n, m) < density)).astype(np.float32)


# -- the windowed sorted-segment sum ---------------------------------------


def _plan_case(case):
    """The five cases of tests/test_sparse.py:138-232: ids, n, values."""
    if case == "random":
        rng = np.random.RandomState(3)
        ids = np.sort(rng.randint(0, 3000, size=20000).astype(np.int32))
        return ids, 3000, rng.rand(20000).astype(np.float32)
    if case == "out_of_range":
        return (np.array([0, 1, 1, 5, 7, 9, 9], np.int32), 6,
                np.arange(1, 8, dtype=np.float32))
    if case == "partial_trailing_block":
        return (np.array([5, 139999], np.int32), 140000,
                np.array([1.5, 2.0], np.float32))
    if case == "skewed":
        return (np.zeros(24576, np.int32), 256 * 1024,
                np.ones(24576, np.float32))
    assert case == "negative"
    return (np.array([-3, -1, 0, 2, 2, 5, 9], np.int32), 6,
            np.arange(1, 8, dtype=np.float32))


@pytest.mark.parametrize("case", ["random", "out_of_range",
                                  "partial_trailing_block", "skewed",
                                  "negative"])
def test_windowed_segsum_matches_jax(case):
    """The windowed kernel's plain version against the JAX plan's kernel
    (interpret mode). Integer-valued cases are exact in both: bit-equal.
    The random case sums ~7 values in [0, 1) per slot in another order:
    at most 2 * 7 * 2^-24 relative, so rtol 1e-6."""
    ids, n, vals = _plan_case(case)
    pj = seg_j.SegmentPlan(ids, n)
    ref = _np(pj.segment_sum(jnp.asarray(pj.reorder(vals))))
    pt = seg_t.SegmentPlan(ids, n)
    before = dict(kseg_t.LAUNCHES)
    out = pt.segment_sum(torch.from_numpy(pt.reorder(vals)))
    assert kseg_t.LAUNCHES == before  # CPU: the plain version
    assert out.dtype == torch.float32 and tuple(out.shape) == (n,)
    if case == "random":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    else:
        np.testing.assert_array_equal(out.numpy(), ref)
    keep = (ids >= 0) & (ids < n)
    expect = np.zeros(n, np.float64)
    np.add.at(expect, ids[keep], vals[keep])
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-6)


def test_windowed_segsum_checks_its_stream():
    pt = seg_t.SegmentPlan(np.array([0, 3, 3], np.int32), 10)
    vals = torch.from_numpy(pt.reorder(np.ones(3, np.float32)))
    with pytest.raises(ValueError, match="do not form"):
        kseg_t.windowed_segsum(vals[:-1], pt._ids2d, pt._wb,
                               rows_pad=pt.rows_pad, nsteps=pt.nsteps,
                               outblk=pt.outblk, sub=pt.SUB)
    with pytest.raises(ValueError, match="no windowed_segsum kernel"):
        kseg_t.windowed_segsum(vals.to("meta"), pt._ids2d, pt._wb,
                               rows_pad=pt.rows_pad, nsteps=pt.nsteps,
                               outblk=pt.outblk, sub=pt.SUB)


# -- SparseDistArray ------------------------------------------------------


@pytest.mark.parametrize("pad_to", [None, 128])
def test_from_coo_matches_jax(mesh1d, pad_to):
    """Same sort, duplicate sums, nse (padded to the 8-way mesh) and
    padding pattern."""
    rng = np.random.RandomState(0)
    n, m, k = 32, 16, 100
    rows = rng.randint(0, n, k)
    cols = rng.randint(0, m, k)
    data = rng.rand(k).astype(np.float32)
    a_j = SpJ.from_coo(rows, cols, data, (n, m), pad_to=pad_to)
    a_t = SpT.from_coo(rows, cols, data, (n, m), pad_to=pad_to)
    _same_layout(a_t, a_j)
    assert a_t.nse % 8 == 0
    np.testing.assert_array_equal(a_t.glom(), np.asarray(a_j.glom()))


def test_from_dense_scipy_and_one_device_padding(one_device):
    dense = _random_sparse(20, 16, 0.2, seed=0)
    _same_layout(SpT.from_dense(dense), SpJ.from_dense(dense))
    mat = sps.random(30, 20, density=0.1, random_state=1, format="csr")
    a_t, a_j = SpT.from_scipy(mat), SpJ.from_scipy(mat)
    _same_layout(a_t, a_j)
    assert a_t.nse == a_t.nnz  # one device: no padding
    np.testing.assert_allclose(a_t.glom(), mat.toarray(), rtol=1e-6)


def test_from_reference_transpose_scale_rsums(mesh1d):
    dense = _random_sparse(12, 8, 0.3, seed=4)
    a_j = SpJ.from_dense(dense)
    a_t = SpT.from_reference(*_state(a_j), a_j.shape, a_j.nnz)
    _same_layout(a_t, a_j)
    # transpose: a permutation on the device, padding rewritten to the
    # transposed shape's out-of-range pattern
    _same_layout(a_t.transpose(), a_j.transpose())
    np.testing.assert_array_equal(a_t.T.glom(), dense.T)
    # scale_rows: one f32 product per entry, bit-equal
    scale = np.arange(12, dtype=np.float32) / 7
    _same_layout(a_t.scale_rows(scale), a_j.scale_rows(scale))
    # rsums: sums of ~2-3 values in another order
    np.testing.assert_allclose(a_t.rsums().numpy(), _np(a_j.rsums()),
                               rtol=1e-6)


def test_transition_matches_jax(mesh1d):
    """The transition of a 0/1 link matrix: out-degrees are exact, so
    every entry agrees bit for bit, padding included."""
    rng = np.random.RandomState(5)
    n = 300
    rows = np.repeat(np.arange(n), 4)
    cols = rng.randint(0, n, rows.size)
    ones = np.ones(rows.size, np.float32)
    l_j = SpJ.from_coo(rows, cols, ones, (n, n))
    l_t = SpT.from_coo(rows, cols, ones, (n, n))
    t_j, t_t = l_j.transition(), l_t.transition()
    _same_layout(t_t, t_j)
    assert l_t.transition() is t_t
    l_t.clear_cache()
    assert l_t.transition() is not t_t


def test_spmv_matches_jax_windowed(one_device):
    """SpMV through the windowed path in both packages (JAX: Pallas in
    interpret mode; port: the plain version) on a one-device mesh."""
    rng = np.random.RandomState(4)
    n = 700
    mat = sps.random(n, n, density=0.01, random_state=rng, format="coo")
    a_j, a_t = SpJ.from_scipy(mat), SpT.from_scipy(mat)
    x = rng.rand(n).astype(np.float32)
    assert a_t.default_impl(1) == "windowed"
    y_j = _np(a_j.spmv(x, impl="windowed"))
    y_t = a_t.spmv(x)
    assert a_t._plan.padded_size == a_j._plan.padded_size
    # ~7 products per row summed in other orders
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(y_t.numpy(), mat.tocsr() @ x, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("impl", [None, "windowed", "bcoo", "xla", "onehot",
                                  "pallas"])
def test_spmv_paths_match_dense(impl):
    dense = _random_sparse(24, 16, 0.25, seed=1)
    sp = SpT.from_dense(dense)
    x = np.random.RandomState(2).rand(16).astype(np.float32)
    np.testing.assert_allclose(sp.spmv(x, impl=impl).numpy(), dense @ x,
                               rtol=1e-5, atol=1e-6)
    if impl != "windowed":
        xm = np.random.RandomState(3).rand(16, 4).astype(np.float32)
        assert sp.default_impl(2) == "bcoo"
        np.testing.assert_allclose(sp.spmv(xm, impl=impl).numpy(),
                                   dense @ xm, rtol=1e-5, atol=1e-6)


def test_spmv_refuses_what_it_cannot_run():
    sp = SpT.from_dense(np.eye(8, dtype=np.float32))
    with pytest.raises(ValueError, match="vector x only"):
        sp.spmv(np.ones((8, 2), np.float32), impl="windowed")
    with pytest.raises(ValueError, match="multi-GPU"):
        sp.spmv(np.ones(8, np.float32), impl="sharded")
    big = SpT(sp.data, sp.rows, sp.cols, (SpT._PLAN_MAX_ROWS + 1, 8),
              sp.nnz)
    assert big.default_impl(1) == "bcoo"
    with pytest.raises(ValueError, match="at most"):
        big.spmv(np.ones(8, np.float32), impl="windowed")


def test_duplicate_entries_sum():
    rows, cols, data = [0, 0, 1, 0], [5, 2, 3, 5], [1.0, 2.0, 3.0, 4.0]
    a = SpT.from_coo(rows, cols, data, (2, 8))
    want = sps.coo_matrix((data, (rows, cols)), shape=(2, 8)).toarray()
    np.testing.assert_allclose(a.glom(), want)
    x = np.arange(8, dtype=np.float32)
    for impl in (None, "bcoo", "xla"):
        np.testing.assert_allclose(a.spmv(x, impl=impl).numpy(), want @ x,
                                   rtol=1e-6)


# -- PageRank -----------------------------------------------------------


def _links(n, deg, seed):
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n), deg)
    cols = rng.randint(0, n, n * deg)
    return rows, cols, np.ones(n * deg, np.float32)


@pytest.mark.parametrize("tol", [0.0, 1e-7])
def test_pagerank_matches_jax(mesh1d, tol):
    """2,048 pages x 8 links, BASELINE config 5's generator at a small
    size. The port runs the fused windowed loop (tol = 0) or the
    per-iteration spmv with its convergence test; the JAX package on the
    CPU runs its sharded spmv. Sums of ~8 terms in other orders over 20
    iterations: rtol 1e-5 of the largest rank."""
    rows, cols, ones = _links(2048, 8, seed=4)
    r_j = np.asarray(pagerank_j(SpJ.from_coo(rows, cols, ones, (2048, 2048)),
                                num_iter=20, tol=tol))
    r_t = pagerank_t(SpT.from_coo(rows, cols, ones, (2048, 2048)),
                     num_iter=20, tol=tol)
    assert r_t.dtype == np.float32 and r_t.shape == (2048,)
    assert np.abs(r_t - r_j).max() <= 1e-5 * r_j.max()
    assert abs(float(r_t.sum()) - 1.0) <= 1e-5


def test_pagerank_star_graph(mesh1d):
    """tests/test_examples.py::test_pagerank on the port, against the
    JAX package's ranks."""
    n = 8
    rows = np.concatenate([np.arange(1, n), [0]])
    cols = np.concatenate([np.zeros(n - 1, np.int64), [1]])
    ones = np.ones(n, np.float32)
    ranks = pagerank_t(SpT.from_coo(rows, cols, ones, (n, n)), num_iter=40)
    assert ranks.argmax() == 0
    assert ranks[1] > ranks[2]  # node 1 gets node 0's rank
    np.testing.assert_allclose(ranks.sum(), 1.0, rtol=1e-3)
    ref = np.asarray(pagerank_j(SpJ.from_coo(rows, cols, ones, (n, n)),
                                num_iter=40))
    np.testing.assert_allclose(ranks, ref, rtol=1e-5, atol=1e-7)


def test_pagerank_fused_path_takes_the_windowed_kernel(monkeypatch):
    """tol = 0 runs num_iter windowed segment sums and nothing else: on
    the card each is one launch of the windowed kernel."""
    rows, cols, ones = _links(512, 4, seed=1)
    links = SpT.from_coo(rows, cols, ones, (512, 512))
    calls = []
    real = kseg_t.windowed_segsum

    def spy(*a, **kw):
        calls.append(kw["starts"])
        return real(*a, **kw)

    monkeypatch.setattr(kseg_t, "windowed_segsum", spy)
    pagerank_t(links, num_iter=7)
    assert len(calls) == 7 and all(s is not None for s in calls)
