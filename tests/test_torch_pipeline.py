"""The port's GPipe pipeline (``parallel/pipeline.py``) against the JAX
package's (``spartan_tpu/parallel/pipeline.py``), on the CPU.

The shapes of tests/test_pipeline.py: ``tanh(x W + b)`` stages, one per
row position of the 4x2 mesh (the JAX side on the 8-device CPU mesh,
the port on the thread runner over a logical 4x2 mesh), and also 8x1.
The same seeded numpy weights and microbatches go through both
packages. Tolerances are tests/test_pipeline.py's: forward rtol/atol
1e-5, loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.parallel import pipeline as pipe_j
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.parallel import pipeline as pipe_t

torch.set_num_threads(1)

MESHES = [(4, 2), (8, 1)]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)


def _stage_j(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _stage_t(params, x):
    w, b = params
    return torch.tanh(x @ w + b)


def _make(n_stages, n_micro=6, mb=4, d=8, seed=0):
    rng = np.random.RandomState(seed)
    ws = rng.randn(n_stages, d, d).astype(np.float32) * 0.3
    bs = rng.randn(n_stages, d).astype(np.float32) * 0.1
    x = rng.randn(n_micro, mb, d).astype(np.float32)
    return ws, bs, x


def _both(shape):
    return (mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)),
            mesh_t.use_mesh(mesh_t.build_mesh(shape)))


@pytest.mark.parametrize("n_micro", [6, 1])
@pytest.mark.parametrize("shape", MESHES)
def test_forward_matches_jax(shape, n_micro):
    ws, bs, x = _make(shape[0], n_micro=n_micro)
    mj, mt = _both(shape)
    with mj:
        want = np.asarray(pipe_j.pipeline_apply(
            _stage_j, (jnp.asarray(ws), jnp.asarray(bs)), jnp.asarray(x)))
    with mt:
        got = pipe_t.pipeline_apply(
            _stage_t, (torch.from_numpy(ws), torch.from_numpy(bs)),
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    seq = x
    for s in range(shape[0]):
        seq = np.tanh(seq @ ws[s] + bs[s])
    np.testing.assert_allclose(got, seq, rtol=1e-5, atol=1e-5)


def _sq_j(a, b):
    return jnp.mean((a - b) ** 2)


def _sq_t(a, b):
    return torch.mean((a - b) ** 2)


@pytest.mark.parametrize("shape", MESHES)
def test_loss_and_grads_match_jax(shape):
    ws, bs, x = _make(shape[0], n_micro=4, seed=1)
    tgt = np.random.RandomState(2).randn(*x.shape).astype(np.float32) * 0.1
    mj, mt = _both(shape)
    with mj:
        lj = pipe_j.pipeline_loss(_stage_j, _sq_j,
                                  (jnp.asarray(ws), jnp.asarray(bs)),
                                  jnp.asarray(x), jnp.asarray(tgt))
        loss_j, grads_j = pipe_j.pipeline_grad(
            _stage_j, _sq_j, (jnp.asarray(ws), jnp.asarray(bs)),
            jnp.asarray(x), jnp.asarray(tgt))
    with mt:
        params = (torch.from_numpy(ws), torch.from_numpy(bs))
        lt = pipe_t.pipeline_loss(_stage_t, _sq_t, params,
                                  torch.from_numpy(x), torch.from_numpy(tgt))
        loss_t, grads_t = pipe_t.pipeline_grad(
            _stage_t, _sq_t, params, torch.from_numpy(x),
            torch.from_numpy(tgt))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    assert isinstance(grads_t, tuple) and len(grads_t) == 2
    for g, wg in zip(grads_t, jax.tree.leaves(grads_j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-4,
                                   atol=1e-5)

    # and against the sequential stack through torch.autograd
    w2 = torch.from_numpy(ws).requires_grad_(True)
    b2 = torch.from_numpy(bs).requires_grad_(True)
    out = torch.from_numpy(x)
    for s in range(shape[0]):
        out = torch.tanh(out @ w2[s] + b2[s])
    seq = torch.stack([_sq_t(out[i], torch.from_numpy(tgt[i]))
                       for i in range(out.shape[0])]).mean()
    seq.backward()
    torch.testing.assert_close(grads_t[0], w2.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(grads_t[1], b2.grad, rtol=1e-4, atol=1e-5)


def test_dict_params_and_errors():
    ws, bs, x = _make(8)
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        params = {"w": torch.from_numpy(ws), "b": torch.from_numpy(bs)}
        loss, grads = pipe_t.pipeline_grad(
            lambda p, a: torch.tanh(a @ p["w"] + p["b"]), _sq_t, params,
            torch.from_numpy(x), torch.zeros(x.shape))
        assert set(grads) == {"w", "b"}
        assert grads["w"].shape == ws.shape and torch.isfinite(loss)
        with pytest.raises(ValueError, match="at least one microbatch"):
            pipe_t.pipeline_apply(_stage_t, (torch.from_numpy(ws),
                                             torch.from_numpy(bs)),
                                  torch.zeros((0, 4, 8)))
        with pytest.raises(ValueError, match="leading extent"):
            pipe_t.pipeline_apply(_stage_t, (torch.from_numpy(ws[:4]),
                                             torch.from_numpy(bs[:4])),
                                  torch.from_numpy(x))
