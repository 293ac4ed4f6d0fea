"""The port's checkpoints on the CPU: round trips, the on-disk format
shared with the JAX package (a checkpoint written by either package
loads in the other bit for bit, with the same manifest), CRC checks,
atomic saves, the blob I/O pool and ``SparseDistArray.from_coo_device``
against the JAX package.

The JAX side runs on the virtual CPU mesh, the port on a logical mesh of
the same shape (4x2 and 8x1). Every comparison here is bit-equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spartan_tpu as st_j
import spartan_tpu_torch as st_t
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.array.sparse import SparseDistArray as SparseJ
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.utils import checkpoint as ckpt_j
from spartan_tpu_torch import native as native_t
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.array.sparse import SparseDistArray as SparseT
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.utils import checkpoint as ckpt_t

torch.set_num_threads(1)

MESHES = [(4, 2), (8, 1)]
DTYPES = ["float32", "int32", "bool", "uint8"]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)


def _jmesh(shape):
    return mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape))


def _tmesh(shape):
    return mesh_t.use_mesh(mesh_t.build_mesh(shape))


def _values(dtype, shape=(16, 8), seed=3):
    rng = np.random.RandomState(seed)
    if dtype == "bool":
        return rng.rand(*shape) < 0.5
    if dtype == "float32":
        return rng.randn(*shape).astype(np.float32)
    return rng.randint(0, 200, shape).astype(dtype)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _blobs(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".bin"))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_checkpoints_cross_between_the_packages(tmp_path, mesh, dtype):
    """JAX save -> port load and port save -> JAX load are bit-equal, and
    both packages write the same manifest and blob names."""
    x = _values(dtype)
    axes = ("x", "y") if mesh == (4, 2) else ("x", None)
    pj, pt = str(tmp_path / "jax"), str(tmp_path / "port")
    with _jmesh(mesh):
        arr_j = st_j.from_numpy(x, tiling=tiling_j.Tiling(axes)).evaluate()
        ckpt_j.save(pj, arr_j)
    with _tmesh(mesh):
        arr_t = st_t.from_numpy(x, tiling=tiling_t.Tiling(axes)).evaluate()
        ckpt_t.save(pt, arr_t)
        back_t = ckpt_t.load(pj)
        assert back_t.tiling.axes == axes
        host, _ = ckpt_t._load_host(pj)
        np.testing.assert_array_equal(host, x)
        got = back_t.glom()
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(got, x)
    with _jmesh(mesh):
        back_j = ckpt_j.load(pt)
        assert back_j.tiling.axes == axes
        got = np.asarray(back_j.glom())
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(got, x)
    assert _manifest(pt) == _manifest(pj)
    assert _blobs(pt) == _blobs(pj)
    for f in _blobs(pt):
        with open(os.path.join(pt, f), "rb") as a, \
                open(os.path.join(pj, f), "rb") as b:
            assert a.read() == b.read()


@pytest.mark.parametrize("tiling", [("x", "y"), ("x", None), (None, "y"),
                                    (None, None)])
def test_dense_round_trip_and_blob_count(tmp_path, tiling):
    """One blob per logical tile; a replicated axis is written once."""
    x = _values("float32", (8, 6))
    with _tmesh((4, 2)):
        arr = st_t.from_numpy(x, tiling=tiling_t.Tiling(tiling)).evaluate()
        ckpt_t.save(str(tmp_path / "c"), arr)
        want = len(arr.extents())
        assert len(_blobs(str(tmp_path / "c"))) == want
        back = ckpt_t.load(str(tmp_path / "c"))
        np.testing.assert_array_equal(back.glom(), x)
        assert back.tiling == arr.tiling
        other = ckpt_t.load(str(tmp_path / "c"), tiling=tiling_t.row(2))
        np.testing.assert_array_equal(other.glom(), x)
        assert other.tiling == tiling_t.row(2)
    assert want == {("x", "y"): 8, ("x", None): 4, (None, "y"): 2,
                    (None, None): 1}[tiling]


def test_tree_round_trip(tmp_path):
    rng = np.random.RandomState(4)
    state = {"w": st_t.from_numpy(rng.rand(8, 4).astype(np.float32)),
             "b": st_t.from_numpy(rng.rand(4).astype(np.float32))}
    with _tmesh((4, 2)):
        ckpt_t.save_tree(str(tmp_path), state)
        back = ckpt_t.load_tree(str(tmp_path))
    assert set(back) == {"w", "b"}
    for k in state:
        np.testing.assert_array_equal(back[k].glom(), state[k].glom())


def test_fio_round_trips(tmp_path):
    x = _values("float32", (8, 4))
    np.save(str(tmp_path / "x.npy"), x)
    e = st_t.from_file(str(tmp_path / "x.npy"))
    np.testing.assert_array_equal(e.glom(), x)
    st_t.save(str(tmp_path / "d"), e * 2.0)  # an expr is evaluated first
    np.testing.assert_array_equal(st_t.load(str(tmp_path / "d")).glom(),
                                  x * 2.0)
    np.testing.assert_array_equal(st_t.from_file(str(tmp_path / "d")).glom(),
                                  x * 2.0)


def test_crc_failure_names_the_shard(tmp_path):
    x = _values("float32", (8, 4))
    path = str(tmp_path / "c")
    with _tmesh((4, 1)):
        ckpt_t.save(path, st_t.from_numpy(x, tiling=tiling_t.row(2)))
        name = _blobs(path)[2]
        with open(os.path.join(path, name), "r+b") as f:
            f.seek(5)
            byte = f.read(1)
            f.seek(5)
            f.write(bytes([byte[0] ^ 0x10]))
        with pytest.raises(ValueError, match=name):
            ckpt_t.load(path)


def test_failed_save_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "c")
    old = _values("float32", (8, 4), seed=1)
    ckpt_t.save(path, st_t.from_numpy(old))

    def broken(paths, arrays, nthreads=8):
        raise OSError("disk full")

    monkeypatch.setattr(native_t, "write_blobs", broken)
    with pytest.raises(OSError, match="disk full"):
        ckpt_t.save(path, st_t.from_numpy(_values("float32", (8, 4), 2)))
    monkeypatch.undo()
    np.testing.assert_array_equal(ckpt_t.load(path).glom(), old)
    assert sorted(os.listdir(tmp_path)) == ["c"]  # no temporary left


def test_blob_pool_round_trip_and_missing_file(tmp_path):
    rng = np.random.RandomState(1)
    arrays = [rng.rand(16, 8).astype(np.float32) for _ in range(5)]
    paths = [str(tmp_path / f"b{i}.bin") for i in range(5)]
    native_t.write_blobs(paths, arrays)
    outs = [np.empty_like(a) for a in arrays]
    native_t.read_blobs(paths, outs)
    for a, b in zip(arrays, outs):
        np.testing.assert_array_equal(a, b)
    assert native_t.route().startswith("libspartan_blob_io_")
    with pytest.raises(OSError, match="nope.bin"):
        native_t.read_blobs([str(tmp_path / "nope.bin")],
                            [np.empty(4, np.float32)])


def _coo_case(seed):
    """Duplicates (values multiples of 1/8, so sums are exact in any
    order) and rows past the matrix."""
    rng = np.random.RandomState(seed)
    n, m, nnz = 30, 20, 150
    rows = rng.randint(0, n + 3, nnz).astype(np.int32)  # some >= n
    cols = rng.randint(0, m, nnz).astype(np.int32)
    rows[:20], cols[:20] = rows[20:40], cols[20:40]  # duplicates
    data = (rng.randint(1, 64, nnz) / 8.0).astype(np.float32)
    return rows, cols, data, (n, m)


@pytest.mark.parametrize("mesh", MESHES)
def test_from_coo_device_matches_jax(mesh):
    rows, cols, data, shape = _coo_case(5)
    with _jmesh(mesh):
        sj = SparseJ.from_coo_device(jnp.asarray(rows), jnp.asarray(cols),
                                     jnp.asarray(data), shape)
        want = [np.asarray(a) for a in (sj.data, sj.rows, sj.cols)]
        dense_j = np.asarray(sj.glom())
    with _tmesh(mesh):
        stt = SparseT.from_coo_device(torch.from_numpy(rows),
                                      torch.from_numpy(cols),
                                      torch.from_numpy(data), shape)
        got = [a.numpy() for a in (stt.data, stt.rows, stt.cols)]
        dense_t = stt.glom()
    assert stt.nnz == sj.nnz
    assert stt.nse == sj.nse
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(dense_t, dense_j)


def test_from_coo_device_sums_a_heavy_duplicate():
    """One coordinate repeated 100,000 times beside scattered entries:
    bit-equal to the JAX package on exact values (multiples of 1/8), and
    on random values within 1e-6 relative of the float64 sum (a pairwise
    tree's error) and the same bits on a second run."""
    rng = np.random.RandomState(8)
    n, m, heavy, rest = 50, 40, 100_000, 300
    rows = np.concatenate([np.full(heavy, 7), rng.randint(0, n, rest)])
    cols = np.concatenate([np.full(heavy, 11), rng.randint(0, m, rest)])
    perm = rng.permutation(heavy + rest)
    rows, cols = rows[perm].astype(np.int32), cols[perm].astype(np.int32)
    exact = (rng.randint(1, 64, heavy + rest) / 8.0).astype(np.float32)
    with _jmesh((8, 1)):
        sj = SparseJ.from_coo_device(jnp.asarray(rows), jnp.asarray(cols),
                                     jnp.asarray(exact), (n, m))
        want = [np.asarray(a) for a in (sj.data, sj.rows, sj.cols)]
    with _tmesh((8, 1)):
        stt = SparseT.from_coo_device(torch.from_numpy(rows),
                                      torch.from_numpy(cols),
                                      torch.from_numpy(exact), (n, m))
        assert stt.nnz == sj.nnz
        for g, w in zip((stt.data, stt.rows, stt.cols), want):
            np.testing.assert_array_equal(g.numpy(), w)
        noisy = rng.rand(heavy + rest).astype(np.float32)
        runs = [SparseT.from_coo_device(torch.from_numpy(rows),
                                        torch.from_numpy(cols),
                                        torch.from_numpy(noisy), (n, m))
                for _ in range(2)]
    assert torch.equal(runs[0].data, runs[1].data)
    oracle = np.zeros((n, m))
    np.add.at(oracle, (rows, cols), noisy.astype(np.float64))
    np.testing.assert_allclose(runs[0].glom(), oracle, rtol=1e-6)


def test_sparse_checkpoint_round_trip_and_cross_package(tmp_path):
    import scipy.sparse as ss

    rng = np.random.RandomState(21)
    n, m, nnz = 40, 28, 150
    r, c = rng.randint(0, n, nnz), rng.randint(0, m, nnz)
    v = rng.rand(nnz).astype(np.float32)
    oracle = ss.coo_matrix((v, (r, c)), shape=(n, m)).toarray()
    with _jmesh((8, 1)):
        sj = SparseJ.from_coo(r, c, v, (n, m))
        ckpt_j.save_sparse(str(tmp_path / "jax"), sj)
        want = [np.asarray(a) for a in (sj.data, sj.rows, sj.cols)]
    with _tmesh((8, 1)):
        sp = SparseT.from_coo(r, c, v, (n, m))
        ckpt_t.save_sparse(str(tmp_path / "port"), sp)
        own = ckpt_t.load_sparse(str(tmp_path / "port"))
        cross = ckpt_t.load_sparse(str(tmp_path / "jax"))
    for back in (own, cross):
        assert back.shape == (n, m) and back.nnz == sp.nnz
        np.testing.assert_array_equal(back.glom(), sp.glom())
        for g, w in zip((back.data, back.rows, back.cols), want):
            np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_allclose(own.glom(), oracle, rtol=1e-6)
    with _jmesh((8, 1)):
        back_j = ckpt_j.load_sparse(str(tmp_path / "port"))
        assert back_j.nnz == sp.nnz
        np.testing.assert_array_equal(np.asarray(back_j.glom()), sp.glom())
