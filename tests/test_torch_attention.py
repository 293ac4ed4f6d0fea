"""The port's attention (``ops/attention.py``) against the JAX package's
(``spartan_tpu/ops/attention.py``), on the CPU.

The same seeded (L, H, D) float32 inputs go through both packages:
dense, blockwise (even and uneven block splits), ring and Ulysses
attention, causal and not, on the 8x1 mesh (the JAX side on the 8-device
CPU mesh, the port on the thread runner over a logical 8x1 mesh), and
ring/Ulysses also on 4x2. Tolerance: rtol 2e-4 / atol 2e-5, the JAX
package's own against its dense oracle (tests/test_attention.py): f32
softmax sums over up to L keys in different orders.
"""

import jax
import numpy as np
import pytest
import torch

from spartan_tpu.ops import attention as att_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu_torch.ops import attention as att_t
from spartan_tpu_torch.parallel import mesh as mesh_t

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = mesh_t.get_default_device()
    mesh_t.set_default_device("cpu")
    yield
    mesh_t.set_default_device(prev)


def _qkv(l=64, h=8, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(l, h, d).astype(np.float32) * 0.3
                 for _ in range(3))


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l,block", [(64, 16), (60, 16), (64, 64), (50, 7)])
def test_dense_and_blockwise_match_jax(l, block, causal):
    q, k, v = _qkv(l=l, seed=l)
    dj = jax.jit(lambda a, b, c: att_j.dense_attention(a, b, c, causal))(
        q, k, v)
    bj = jax.jit(lambda a, b, c: att_j.blockwise_attention(
        a, b, c, block_size=block, causal=causal))(q, k, v)
    dt = att_t.dense_attention(*_t((q, k, v)), causal=causal)
    bt = att_t.blockwise_attention(*_t((q, k, v)), block_size=block,
                                   causal=causal)
    _close(dt.numpy(), dj)
    _close(bt.numpy(), bj)
    _close(bt.numpy(), dt.numpy())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_ring_attention_matches_jax(shape, causal):
    q, k, v = _qkv(l=64, seed=1 + causal)
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)):
        want = np.asarray(att_j.ring_attention(q, k, v, causal=causal))
    with mesh_t.use_mesh(mesh_t.build_mesh(shape)):
        got = att_t.ring_attention(*_t((q, k, v)), causal=causal)
    _close(got.numpy(), want)
    _close(got.numpy(), att_t.dense_attention(*_t((q, k, v)),
                                              causal=causal).numpy())


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_ulysses_attention_matches_jax(shape, causal):
    q, k, v = _qkv(l=64, h=8, seed=3 + causal)
    with mesh_j.use_mesh(mesh_j.build_mesh(jax.devices(), shape=shape)):
        want = np.asarray(att_j.ulysses_attention(q, k, v, causal=causal))
    with mesh_t.use_mesh(mesh_t.build_mesh(shape)):
        got = att_t.ulysses_attention(*_t((q, k, v)), causal=causal)
    _close(got.numpy(), want)


def test_indivisible_lengths_are_rejected_as_in_jax(mesh1d):
    q, k, v = _qkv(l=60)
    with pytest.raises(ValueError):
        att_j.ring_attention(q, k, v)
    q2, k2, v2 = _qkv(l=64, h=6)
    with pytest.raises(ValueError):
        att_j.ulysses_attention(q2, k2, v2)
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        with pytest.raises(ValueError, match="sequence length 60"):
            att_t.ring_attention(*_t((q, k, v)))
        with pytest.raises(ValueError, match="head count 6"):
            att_t.ulysses_attention(*_t((q2, k2, v2)))


def test_dense_attention_head_groups_change_no_value(monkeypatch):
    """The head grouping that bounds dense attention's memory (one group
    at a time) gives the same bits as one group of every head."""
    q, k, v = _t(_qkv(l=32, h=8, seed=9))
    whole = att_t.dense_attention(q, k, v, causal=True)
    monkeypatch.setattr(att_t, "_SCORE_ELEMS", 32 * 32 * 3)
    grouped = att_t.dense_attention(q, k, v, causal=True)
    torch.testing.assert_close(grouped, whole, rtol=0, atol=0)


def test_float64_inputs_accumulate_in_float64():
    q, k, v = (x.double() for x in _t(_qkv(l=32, seed=10)))
    out = att_t.blockwise_attention(q, k, v, block_size=8)
    assert out.dtype == torch.float64
    torch.testing.assert_close(out, att_t.dense_attention(q, k, v),
                               rtol=1e-12, atol=1e-13)
