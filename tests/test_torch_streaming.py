"""Parity of the port's streaming classes (``examples/streaming.py``)
with the JAX package, on the CPU: ``OnlineKMeans`` (``partial_fit`` and
``refine``), ``SlidingWindowStats`` and ``IncrementalPageRank``, at small
sizes, on the same seeded numpy inputs (JAX on its 4x2 CPU mesh, the
port on a logical 4x2 mesh).

Tolerances: 1e-6 relative for elementwise window statistics; 1e-5 where
a reduction or a product sums in another order (the centers, the
matvecs).
"""

import jax
import numpy as np
import pytest
import torch

import spartan_tpu as st_j  # noqa: F401 - configures the JAX package
import spartan_tpu_torch as st_t  # noqa: F401
from spartan_tpu.examples import streaming as sj
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu_torch.examples import streaming as stm
from spartan_tpu_torch.ops import kmeans as ops_kmeans_t
from spartan_tpu_torch.parallel import mesh as mesh_t

torch.set_num_threads(1)

SUM_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)


def _both(run, mesh=(4, 2)):
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=mesh)):
        out_j = [np.asarray(a) for a in run(sj)]
    with mesh_t.use_mesh(mesh_t.build_mesh(mesh)):
        out_t = [np.asarray(a) for a in run(stm)]
    return out_j, out_t


def _close(got, want, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6)


def _clustered(n, d, k, seed):
    rng = np.random.RandomState(seed)
    true = (rng.rand(k, d) * 4.0).astype(np.float32)
    pts = (true[rng.randint(0, k, n)]
           + 0.05 * rng.randn(n, d)).astype(np.float32)
    c0 = (true + 0.3 * rng.randn(k, d)).astype(np.float32)
    return pts, c0


@pytest.mark.parametrize("d", [8, 128])
def test_online_kmeans_matches_jax(d, monkeypatch):
    """Four mini-batches, then three Lloyd iterations. At d = 128 the
    port's ``refine`` takes the fused pass (its plain version here, one
    call per iteration), the JAX package the map2 form: on clustered data
    both assign alike, so the centers agree to summation order."""
    k = 4
    pts, c0 = _clustered(2048, d, k, seed=d)
    batches = [pts[i * 256:(i + 1) * 256] for i in range(4)]
    steps = []
    real = ops_kmeans_t.step
    monkeypatch.setattr(ops_kmeans_t, "step",
                        lambda *a, **kw: steps.append(1) or real(*a, **kw))

    def run(mod):
        ok = mod.OnlineKMeans(c0)
        fits = [ok.partial_fit(b).glom() for b in batches]
        return fits + [ok._counts.glom(), ok.refine(pts, iters=3).glom()]

    out_j, out_t = _both(run)
    _close(out_t, out_j, SUM_RTOL)
    assert len(steps) == (3 if d == 128 else 0)


def test_sliding_window_stats_match_jax():
    rng = np.random.RandomState(5)
    pushes = [rng.randn(n, 4).astype(np.float32) for n in (10, 30, 40, 7)]

    def run(mod):
        sw = mod.SlidingWindowStats(64, 4)
        out = []
        for rows in pushes:  # the third push wraps around the ring
            sw.push(rows)
            mean, std = sw.stats()
            out += [mean.glom(), std.glom()]
        out.append(sw.normalized(mean, std).glom())
        out.append(sw.buf.glom())
        return out

    out_j, out_t = _both(run)
    _close(out_t[-1:], out_j[-1:], 0)  # the window itself, bit-equal
    _close(out_t[:-1], out_j[:-1], SUM_RTOL)


def test_sliding_window_single_row_push():
    sw = stm.SlidingWindowStats(4, 3)
    sw.push(np.array([1.0, 2.0, 3.0], np.float32))
    np.testing.assert_array_equal(sw.buf.glom()[0], [1.0, 2.0, 3.0])
    assert sw._head == 1 and sw._filled == 1


def test_incremental_pagerank_matches_jax():
    rng = np.random.RandomState(6)
    n = 32
    a = rng.rand(n, n).astype(np.float32)
    a /= a.sum(axis=1, keepdims=True)  # a Markov step r @ A
    new = [rng.rand(n, 4).astype(np.float32) * 0.1 for _ in range(3)]

    def run(mod):
        pr = mod.IncrementalPageRank(a, rebase_every=2)
        out = []
        for j, vals in enumerate(new):
            pr.insert_edges(slice(4 * j, 4 * j + 4), vals)
            out.append(pr.step().glom())  # the third step rebases first
        out.append(pr.rebase(4).glom())
        out.append(pr.A.glom())
        return out

    out_j, out_t = _both(run)
    _close(out_t[-1:], out_j[-1:], 0)  # the updated matrix, bit-equal
    _close(out_t[:-1], out_j[:-1], SUM_RTOL)
    a64 = a.astype(np.float64)
    for j, vals in enumerate(new):
        a64[:, 4 * j:4 * j + 4] = vals
    np.testing.assert_array_equal(out_t[-1], a64.astype(np.float32))


def test_incremental_pagerank_rejects_non_square():
    with pytest.raises(ValueError, match="square"):
        stm.IncrementalPageRank(np.ones((3, 4), np.float32))
