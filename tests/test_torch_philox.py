"""The port's counter-based random fills (``utils/philox.py``) on the
CPU: Philox4x32-10 against the known-answer vectors of its authors
(Salmon et al., SC 2011; the Random123 library's ``kat_vectors``), the
three draws' formulas on the words, a draw that spans several chunks,
and the staging bound. The draws' blocks on meshes and ranks are held
in ``tests/test_torch_local_storage.py``. Everything is exact."""

import math

import numpy as np
import pytest
import torch

from spartan_tpu_torch.array.extent import TileExtent
from spartan_tpu_torch.utils import philox

# (counter, key, output) of Philox4x32-10
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("case", range(len(KAT)))
def test_philox_known_answers(case):
    ctr, key, want = KAT[case]
    got = philox.philox([torch.tensor([c]) for c in ctr], key)
    assert tuple(int(w) for w in got) == want


def _words(seed, n):
    i = torch.arange(n, dtype=torch.int64)
    return [w.numpy() for w in philox.philox(
        [i & 0xFFFFFFFF, i >> 32, torch.zeros_like(i), torch.zeros_like(i)],
        (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF))]


def test_draws_follow_their_formulas_on_the_words():
    n, seed = 5000, (7 << 32) + 99
    w0, w1, _, _ = _words(seed, n)
    full = philox.whole((n,))
    u = philox.draw("uniform", seed, (n,), full, torch.float32, "cpu")
    np.testing.assert_array_equal(
        u.numpy(), ((w0 >> 8).astype(np.float64) * 2.0 ** -24).astype(
            np.float32))
    assert u.min() >= 0.0 and u.max() < 1.0
    z = philox.draw("normal", seed, (n,), full, torch.float64, "cpu")
    u1 = ((w0 >> 8) + 1) * 2.0 ** -24
    u2 = (w1 >> 8) * 2.0 ** -24
    want = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * math.pi * u2)
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-12, atol=1e-12)
    for lo, hi in ((0, 10), (-5, 3), (-2 ** 31, 2 ** 31 - 1), (4, 5)):
        r = philox.draw("randint", seed, (n,), full, torch.int64, "cpu",
                        (lo, hi)).numpy()
        x = (w0.astype(object) << 32) | w1.astype(object)
        exact = np.array([lo + (v * (hi - lo) >> 64) for v in x], np.int64)
        np.testing.assert_array_equal(r, exact)
        assert r.min() >= lo and r.max() < hi


def test_randint_has_no_modulo_bias_and_rejects_an_empty_range():
    r = philox.draw("randint", 3, (300_000,), philox.whole((300_000,)),
                    torch.int32, "cpu", (0, 3)).numpy()
    counts = np.bincount(r, minlength=3)
    assert np.abs(counts / r.size - 1 / 3).max() < 0.005
    with pytest.raises(ValueError):
        philox.draw("randint", 3, (4,), philox.whole((4,)), torch.int32,
                    "cpu", (5, 5))
    with pytest.raises(ValueError):
        philox.draw("gamma", 3, (4,), philox.whole((4,)), torch.float32,
                    "cpu")


def test_a_draw_across_chunks_equals_its_blocks():
    n = philox.CHUNK + 4097
    shape = (n // 7, 7)
    whole = philox.draw("uniform", 11, shape, philox.whole(shape),
                        torch.float32, "cpu")
    for ul, lr in (((0, 0), (shape[0], 3)),
                   ((philox.CHUNK // 7 - 2, 2), (shape[0], 7)),
                   ((5, 1), (6, 2)), ((0, 0), (0, 7))):
        ext = TileExtent(ul, lr, shape)
        got = philox.draw("uniform", 11, shape, ext, torch.float32, "cpu")
        assert torch.equal(got, whole[ext.to_slice()])
    # a seed's draw is a function of the flat index alone
    v = philox.draw("uniform", 11, (n,), philox.whole((n,)), torch.float32,
                    "cpu")
    assert torch.equal(v[:shape[0] * 7].view(shape), whole)


def test_staging_is_bounded_by_the_chunk():
    assert philox.staging_bytes(10) == 48 * 10
    assert philox.staging_bytes(10 ** 9) == 48 * philox.CHUNK
    meta = philox.draw("normal", 1, (10 ** 6,), philox.whole((10 ** 6,)),
                       torch.float32, "meta")
    assert meta.device.type == "meta" and meta.shape == (10 ** 6,)
