"""Parity of the PyTorch port's stencil path with the JAX package, on the
CPU: ``stencil`` with the H axis pinned (kernel path and library path on
both sides), ``conv_block_plain`` against the JAX package's Pallas
``conv_block`` in interpret mode, ``halo_exchange`` against a numpy
construction, the fallbacks and their reasons, the kernel selection
against the JAX rule over a sweep, pooling, and the VGG-16 block-1
pattern at a small size.

The same seeded numpy inputs go through both packages; the JAX side runs
on the 8x1 mesh as tests/test_kernels.py does (``native_kernels=on``:
Pallas in interpret mode; ``off``: ``lax.conv``). Convolutions compare at
rtol 1e-4 / atol 1e-5 (test_kernels.py's tolerance: f32 sums of up to
KH*KW*C products in different orders), data movement exactly.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spartan_tpu as st_j
from spartan_tpu.array import tiling as tiling_j
from spartan_tpu.kernels import registry as reg_j
from spartan_tpu.kernels import stencil as kst_j
from spartan_tpu.parallel import mesh as mesh_j
from spartan_tpu.utils.config import FLAGS as FLAGS_J
import spartan_tpu_torch as st_t
from spartan_tpu_torch.array import tiling as tiling_t
from spartan_tpu_torch.array.distarray import from_numpy as from_numpy_t
from spartan_tpu_torch.kernels import registry as reg_t
from spartan_tpu_torch.kernels import stencil as kst_t
from spartan_tpu_torch.parallel import mesh as mesh_t
from spartan_tpu_torch.utils.config import FLAGS as FLAGS_T

torch.set_num_threads(1)

H_PINNED = (None, "x", None, None)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU, on a logical 8x1 mesh; every FLAGS value a
    test sets (in either package) restored afterwards."""
    prev_dev = mesh_t.get_default_device()
    snap_j, snap_t = FLAGS_J.snapshot(), FLAGS_T.snapshot()
    mesh_t.set_default_device("cpu")
    with mesh_t.use_mesh(mesh_t.build_mesh((8, 1))):
        yield
    for name, value in snap_j.items():
        setattr(FLAGS_J, name, value)
    for name, value in snap_t.items():
        setattr(FLAGS_T, name, value)
    mesh_t.set_default_device(prev_dev)


def _rand(*shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _img_flt(k):
    rng = np.random.RandomState(9)
    img = rng.rand(2, 64, 16, 8).astype(np.float32)
    flt = rng.rand(k, k, 8, 4).astype(np.float32)
    return img, flt


@functools.lru_cache(maxsize=None)
def _jax_stencil(k: int, mode: str) -> np.ndarray:
    """The JAX package's H-pinned stencil of the (2, 64, 16, 8) image with
    a k x k filter to O=4, under native_kernels=``mode``."""
    img, flt = _img_flt(k)
    prev = FLAGS_J.native_kernels
    m = mesh_j.build_mesh(jax.devices(), shape=(8, 1))
    try:
        FLAGS_J.native_kernels = mode
        with mesh_j.use_mesh(m):
            xe = st_j.as_expr(img)
            xe._forced_tiling = tiling_j.Tiling(H_PINNED)
            e = st_j.stencil(xe, flt)
            assert reg_j.node_selection(e).pallas == (mode == "on")
            return np.asarray(e.glom())
    finally:
        FLAGS_J.native_kernels = prev


def _port_input(img, pin):
    if pin == "forced":
        xe = st_t.as_expr(img)
        xe._forced_tiling = tiling_t.Tiling(H_PINNED)
        return xe
    return from_numpy_t(img, tiling=tiling_t.Tiling(H_PINNED))


@pytest.mark.parametrize("pin", ["forced", "tiling"])
@pytest.mark.parametrize("port_mode", ["auto", "off"])
@pytest.mark.parametrize("jax_mode", ["on", "off"])
@pytest.mark.parametrize("k", [3, 2])
def test_stencil_matches_jax_h_pinned(k, jax_mode, port_mode, pin):
    """The even 2x2 filter checks XLA's asymmetric SAME split (the extra
    row and column go high)."""
    ref = _jax_stencil(k, jax_mode)
    img, flt = _img_flt(k)
    FLAGS_T.native_kernels = port_mode
    e = st_t.stencil(_port_input(img, pin), flt)
    sel = reg_t.node_selection(e)
    assert sel.native == (port_mode == "auto"), sel.reason
    before = dict(kst_t.LAUNCHES)
    out = e.glom()
    assert kst_t.LAUNCHES == before  # CPU tensors: the plain version
    assert out.shape == ref.shape == (2, 64, 16, 4)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_pinned_tiling_changes_out_tiling_and_plan_key():
    img, flt = _img_flt(3)
    plain = st_t.as_expr(img)
    pinned = st_t.as_expr(img)
    pinned._forced_tiling = tiling_t.Tiling(H_PINNED)
    assert pinned.out_tiling().axes == H_PINNED
    assert st_t.stencil(pinned, flt).out_tiling().axes == H_PINNED
    from spartan_tpu_torch.expr import base as base_t

    # the default placement tiles H (the largest axis) here too, yet the
    # pin stays part of the plan key
    assert plain.out_tiling().axes == H_PINNED
    k_plain, _ = base_t.plan_signature(st_t.stencil(plain, flt))
    k_pinned, _ = base_t.plan_signature(st_t.stencil(pinned, flt))
    assert k_plain != k_pinned
    whole = st_t.as_expr(img)
    whole._forced_tiling = tiling_t.replicated(4)
    assert not reg_t.node_selection(st_t.stencil(whole, flt)).native


@pytest.mark.parametrize("b,hp,wp,c,kh,kw,o", [
    (3, 10, 18, 5, 3, 3, 4), (2, 6, 9, 3, 2, 2, 7), (1, 12, 12, 2, 5, 5, 3),
    (2, 3, 17, 3, 3, 1, 10)])
def test_conv_block_plain_matches_jax_kernel(b, hp, wp, c, kh, kw, o):
    x = _rand(b, hp, wp, c, seed=hp + wp)
    w = _rand(kh, kw, c, o, seed=c + o) - 0.5
    ref = np.asarray(kst_j.conv_block(jnp.asarray(x), jnp.asarray(w), 8,
                                      interpret=True))
    out = kst_t.conv_block_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(out.shape) == ref.shape == (b, hp - kh + 1, wp - kw + 1, o)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    # the wrapper on a CPU tensor runs the plain version, launching nothing
    before = dict(kst_t.LAUNCHES)
    same = kst_t.conv_block(torch.from_numpy(x), torch.from_numpy(w))
    assert kst_t.LAUNCHES == before
    assert torch.equal(same, out)


def _np_halo(x, kh, kw, p):
    """Shard s's block: rows [s*hs - lo, s*hs + hs + hi) of x padded with
    SAME's zeros."""
    n, h, w, c = x.shape
    hs = h // p
    hlo, wlo = (kh - 1) // 2, (kw - 1) // 2
    xp = np.pad(x, ((0, 0), (hlo, kh - 1 - hlo), (wlo, kw - 1 - wlo),
                    (0, 0)))
    return np.stack([xp[:, s * hs:s * hs + hs + kh - 1] for s in range(p)])


@pytest.mark.parametrize("kh,kw,p,h", [(3, 3, 8, 64), (2, 2, 8, 16),
                                       (5, 5, 2, 10), (4, 1, 4, 16),
                                       (1, 3, 2, 4), (3, 3, 1, 5)])
def test_halo_exchange_matches_numpy(kh, kw, p, h):
    x = _rand(2, h, 7, 3, seed=kh * 10 + p) - 0.5
    out = kst_t.halo_exchange(torch.from_numpy(x), kh, kw, p)
    want = _np_halo(x, kh, kw, p)
    assert tuple(out.shape) == want.shape == (p, 2, h // p + kh - 1,
                                              7 + kw - 1, 3)
    np.testing.assert_array_equal(out.numpy(), want)


def test_halo_blocks_conv_equals_unsharded_conv():
    """conv_block over the p shards' halo blocks in the unsharded layout
    equals the VALID conv of the whole SAME-padded image."""
    x = torch.from_numpy(_rand(3, 24, 9, 5, seed=1))
    w = torch.from_numpy(_rand(3, 2, 5, 6, seed=2))
    blocks = kst_t.halo_exchange(x, 3, 2, 4)
    out = kst_t.conv_block(blocks, w)
    whole = torch.nn.functional.pad(x, (0, 0, 0, 1, 1, 1))
    ref = kst_t.conv_block_plain(whole, w)
    assert out.shape == ref.shape == (3, 24, 9, 6)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)


def test_conv_block_and_halo_contracts():
    x = torch.zeros((2, 6, 6, 3))
    w = torch.zeros((3, 3, 3, 4))
    with pytest.raises(TypeError, match="float32"):
        kst_t.conv_block(x.double(), w.double())
    with pytest.raises(ValueError, match="does not fit"):
        kst_t.conv_block(x, torch.zeros((3, 3, 2, 4)))
    with pytest.raises(ValueError, match="takes x"):
        kst_t.conv_block(x[0], w)
    with pytest.raises(ValueError, match="does not split"):
        kst_t.halo_exchange(x, 3, 3, 4)
    with pytest.raises(ValueError, match="no conv_block kernel"):
        kst_t.conv_block(x.to("meta"), w.to("meta"))
    # the kernel's own limits: a filter whose taps do not fit shared memory
    assert kst_t.cuda_limits(3, 3, 64, 64, 256) == ""
    assert "shared memory" in kst_t.cuda_limits(15, 15, 64, 64, 8)
    assert "grid z" in kst_t.cuda_limits(3, 3, 3, 4, 70000)


@pytest.mark.parametrize("c,route", [(1, "simt"), (3, "simt"), (4, "simt"),
                                     (5, "mma"), (13, "mma"), (64, "mma")])
def test_conv_route_rule_and_its_limits(c, route):
    """C <= 4 goes to the SIMT kernel, C > 4 to the tensor-core kernel;
    each route takes every filter up to 10x10 (the tensor-core route
    with fewer staging slots) and refuses 15x15."""
    assert kst_t.route(c) == route
    assert kst_t.cuda_limits(3, 3, c, 64, 256) == ""
    assert kst_t.cuda_limits(10, 10, c, 64, 8) == ""
    assert "shared memory" in kst_t.cuda_limits(15, 15, c, 64, 8)
    assert "grid y" in kst_t.cuda_limits(3, 3, c, 64 * 65536, 8)


@pytest.mark.parametrize("case", ["h_unsharded", "stride", "valid",
                                  "selected"])
def test_fallbacks_keep_the_jax_reason_and_result(case):
    img, flt = _img_flt(3)
    stride, padding, tiling = 1, "SAME", H_PINNED
    if case == "h_unsharded":
        tiling = (None, None, None, None)
    elif case == "stride":
        stride = 2
    elif case == "valid":
        padding = "VALID"
    FLAGS_J.native_kernels = "on"
    FLAGS_T.native_kernels = "on"
    m = mesh_j.build_mesh(jax.devices(), shape=(8, 1))
    with mesh_j.use_mesh(m):
        xe = st_j.as_expr(img)
        xe._forced_tiling = tiling_j.Tiling(tiling)
        ej = st_j.stencil(xe, flt, stride=stride, padding=padding)
        sel_j = reg_j.node_selection(ej)
        ref = np.asarray(ej.glom())
    xt = st_t.as_expr(img)
    xt._forced_tiling = tiling_t.Tiling(tiling)
    et = st_t.stencil(xt, flt, stride=stride, padding=padding)
    sel_t = reg_t.node_selection(et)
    if case == "selected":
        assert sel_j.pallas and sel_t.native
    else:
        assert not sel_j.pallas and not sel_t.native
        assert sel_t.reason == sel_j.reason
    out = et.glom()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_unselected_conv_matches_jax_at_odd_shapes():
    """The library path's explicit XLA padding: odd sizes, even filters,
    strides 2 and 3, SAME and VALID."""
    FLAGS_J.native_kernels = "off"
    FLAGS_T.native_kernels = "off"
    for (h, w, kh, kw, s, pad) in [(9, 7, 2, 4, (2, 3), "SAME"),
                                  (10, 11, 3, 3, (2, 2), "SAME"),
                                  (9, 7, 2, 3, (3, 1), "VALID"),
                                  (5, 6, 4, 4, (1, 1), "SAME")]:
        img = _rand(2, h, w, 3, seed=h * w) - 0.5
        flt = _rand(kh, kw, 3, 5, seed=kh * kw) - 0.5
        ref = np.asarray(st_j.stencil(img, flt, stride=s,
                                      padding=pad).glom())
        e = st_t.stencil(img, flt, stride=s, padding=pad)
        out = e.glom()
        assert e.shape == out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


_SWEEP_SHAPES = [(2, 64, 16, 8), (1, 24, 5, 3), (2, 20, 7, 3), (4, 8, 8, 3),
                 (2, 16, 0, 3), (1, 64, 400, 700)]
_SWEEP_TILINGS = [H_PINNED, (None, None, None, None), ("x", None, None, None),
                  (None, "y", None, None), (None, "x", "y", None),
                  (None, ("x", "y"), None, None)]


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
@pytest.mark.parametrize("shape", _SWEEP_SHAPES)
def test_selection_agrees_with_jax(mesh_shape, shape):
    """Every check of the JAX rule, its VMEM budget included, gives the
    same decision and reason; the CUDA kernel's own limits add nothing
    at these shapes."""
    FLAGS_J.native_kernels = "on"
    FLAGS_T.native_kernels = "on"
    m_j = mesh_j.build_mesh(jax.devices(), shape=mesh_shape)
    m_t = mesh_t.build_mesh(mesh_shape)
    n_cases = 0
    for axes in _SWEEP_TILINGS:
        for dtype in (np.float32, np.int32):
            for kshape, o, stride, pad in [((3, 3), 4, (1, 1), "SAME"),
                                           ((2, 2), 64, (1, 1), "SAME"),
                                           ((5, 5), 8, (1, 1), "SAME"),
                                           ((3, 3), 4, (2, 2), "SAME"),
                                           ((3, 3), 4, (1, 1), "VALID")]:
                kw = dict(stride=stride, padding=pad, kshape=kshape,
                          out_channels=o)
                sj = reg_j.select("stencil", shape, dtype,
                                  tiling_j.Tiling(axes), m_j, **kw)
                stt = reg_t.select("stencil", shape, dtype,
                                   tiling_t.Tiling(axes), m_t, **kw)
                assert stt.native == sj.pallas, (axes, dtype, kw, sj, stt)
                if not sj.pallas:
                    assert stt.reason == sj.reason
                n_cases += 1
    assert n_cases == len(_SWEEP_TILINGS) * 2 * 5


def test_selection_flags():
    tiling = tiling_t.Tiling(H_PINNED)
    FLAGS_T.native_kernels = "off"
    sel = reg_t.select("stencil", (2, 64, 16, 8), np.float32, tiling,
                       kshape=(3, 3), out_channels=4)
    assert not sel.native and "native_kernels=off" in sel.reason
    for mode in ("auto", "on"):
        FLAGS_T.native_kernels = mode
        assert reg_t.select("stencil", (2, 64, 16, 8), np.float32, tiling,
                            kshape=(3, 3), out_channels=4).native


def _jax_pool(fn, img, **kw):
    return np.asarray(getattr(st_j, fn)(img, **kw).glom())


@pytest.mark.parametrize("fn", ["maxpool", "avgpool"])
@pytest.mark.parametrize("kw", [dict(window=2), dict(window=3, stride=2),
                                dict(window=3, stride=2, padding="SAME"),
                                dict(window=(2, 3), stride=(1, 2),
                                     padding="SAME"),
                                dict(window=2, padding="SAME")])
def test_pooling_matches_jax(fn, kw):
    img = _rand(2, 9, 7, 3, seed=3) - 0.5
    img[0, 4, 3, 1] = np.nan  # NaN propagates through lax.max and add
    img[1, 0, 0, 0] = -np.inf
    ref = _jax_pool(fn, img, **kw)
    out = getattr(st_t, fn)(img, **kw).glom()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    if fn == "maxpool":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def _vgg_params():
    rng = np.random.RandomState(30)
    widths = (3, 8, 8)
    params = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        w = (rng.randn(3, 3, cin, cout) * np.sqrt(2.0 / (9 * cin))
             ).astype(np.float32)
        b = (0.01 * rng.randn(cout)).astype(np.float32)
        params.append((w, b))
    img = rng.randn(2, 32, 32, 3).astype(np.float32)
    return img, params


def _vgg(st, x, params):
    h = x
    for w, b in params:
        h = st.maximum(st.stencil(h, w) + b, 0.0)
    return st.maxpool(h, 2)


@pytest.mark.parametrize("mode", ["on", "off"])
def test_vgg_block1_matches_jax(mode):
    """conv3-8, ReLU, conv3-8, ReLU, maxpool 2 at batch 2, 32x32x3: both
    convolutions take the kernel path on each side under ``on`` (the H
    tiling carries through the bias-and-ReLU map)."""
    img, params = _vgg_params()
    FLAGS_J.native_kernels = mode
    m = mesh_j.build_mesh(jax.devices(), shape=(8, 1))
    with mesh_j.use_mesh(m):
        xe = st_j.as_expr(img)
        xe._forced_tiling = tiling_j.Tiling(H_PINNED)
        ref = np.asarray(_vgg(st_j, xe, params).glom())
    FLAGS_T.native_kernels = "auto" if mode == "on" else "off"
    calls = []
    real = kst_t.halo_stencil

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    kst_t.halo_stencil = counted
    try:
        x = from_numpy_t(img, tiling=tiling_t.Tiling(H_PINNED))
        out = _vgg(st_t, x, params).glom()
    finally:
        kst_t.halo_stencil = real
    assert len(calls) == (2 if mode == "on" else 0)
    assert out.shape == ref.shape == (2, 16, 16, 8)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
