"""Halo-exchange stencil: the hand-written CUDA conv kernel and its plain
version (port of ``spartan_tpu/kernels/stencil.py``).

:func:`halo_stencil` is the SAME-padded stride-1 NHWC convolution of an
operand whose H axis is tiled over ``p`` logical shards, with the JAX
program's structure: :func:`halo_exchange` builds each shard's block from
its own rows and its neighbours' boundary rows (zeros above shard 0 and
below shard p-1, as the ppermute delivers them, and SAME's zero columns
on W), then :func:`conv_block` convolves every shard's block VALID.

On CUDA tensors :func:`conv_block` launches ``spartan_tpu_torch/csrc/
stencil.cu`` (built with ``nvcc`` for ``sm_90a`` at first use, bound
through ``ctypes``), one launch for all shards' blocks, writing the
unsharded ``(N, H, W, O)`` result directly. :func:`route` picks the
kernel by a static rule on C: C <= 4 takes the SIMT direct conv (FP32
FMAs), C > 4 the tensor-core implicit GEMM (3xTF32 ``mma.sync``, about
f32 accuracy). On CPU tensors it runs
:func:`conv_block_plain`, the TPU kernel's formulation (KH*KW shifted
slices, each a ``(rows, C) @ (C, O)`` product in f32); any other device
raises. :func:`halo_stencil_sharded` is the JAX package's ``shard_map``
form: the boundary rows travel by ``ring_permute`` and each position
runs one :func:`conv_block` on its own block. On a group mesh
(``parallel/mesh.py``) :func:`halo_stencil` keeps only each rank's
block and runs that body on it (:func:`halo_stencil_local`). The conv is
the torch custom operator ``spartan_tpu_torch::conv_block``: on ``meta``
tensors its shape rule answers, and under ``torch.func.vmap`` its
batching rule launches it once a client.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..parallel import mesh as mesh_mod
from . import build as build_mod

# Kernel launches so far: the wrapper adds one where it launches a CUDA
# kernel and nowhere else (the plain version does not count).
# "conv_block" counts every launch, "conv_block_mma" those of the
# tensor-core route.
LAUNCHES: Dict[str, int] = {"conv_block": 0, "conv_block_mma": 0}

# csrc/stencil.cu's CTA tiles (output rows, columns, channels) and the
# input channels staged per chunk, per route; the tensor-core route stages
# a pixel's 8 channels at a pitch of 12 floats, in a ring of 2 stages
_SIMT_TILE, _SIMT_CK = (8, 32, 64), 4
_MMA_TILE, _MMA_CK, _MMA_PITCH = (4, 32, 64), 8, 12
_MAX_GRID_YZ = 65535


def _same_pad(k: int) -> Tuple[int, int]:
    """XLA SAME padding split for stride 1: total k-1, low half first."""
    lo = (k - 1) // 2
    return lo, k - 1 - lo


def route(c: int) -> str:
    """The kernel that convolves ``c`` input channels: "simt" (FP32 FMAs
    on the CUDA cores; C <= 4, where the work is bound by bytes) or "mma"
    (3xTF32 on the tensor cores; C > 4). A static rule, never a
    fallback."""
    return "simt" if c <= 4 else "mma"


def _smem(kh: int, kw: int, c: int) -> int:
    """Shared memory of the least launch of ``route(c)``'s kernel: one
    chunk's filter taps and input tile (the tensor-core route adds ring
    stages only where they fit)."""
    if route(c) == "simt":
        th, tw, to = _SIMT_TILE
        return 4 * (kh * kw * _SIMT_CK * to
                    + _SIMT_CK * (th + kh - 1) * (tw + kw - 1))
    th, tw, to = _MMA_TILE
    return 4 * (kh * kw * _MMA_CK * to
                + (th + kh - 1) * (tw + kw - 1) * _MMA_PITCH)


def cuda_limits(kh: int, kw: int, c: int, o: int, blocks: int) -> str:
    """Why the kernel cannot convolve ``blocks`` blocks of ``c`` channels
    with a (kh, kw, c, o) filter, or "" when it can: one chunk's filter
    taps and input tile must fit a block's shared memory, and the blocks
    and output-channel tiles must fit the launch grid."""
    smem = _smem(kh, kw, c)
    if smem > build_mod.SMEM_PER_BLOCK:
        return (f"a {kh}x{kw} filter needs {smem}B of shared memory > "
                f"{build_mod.SMEM_PER_BLOCK}B per block")
    if blocks > _MAX_GRID_YZ:
        return f"{blocks} shard blocks > {_MAX_GRID_YZ} (grid z)"
    to = _SIMT_TILE[2] if route(c) == "simt" else _MMA_TILE[2]
    if -(-o // to) > _MAX_GRID_YZ:
        return f"{o} output channels > {_MAX_GRID_YZ * to} (grid y)"
    return ""


def conv_block_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's body in torch: VALID conv of ``x`` (B, Hp, Wp, C)
    with ``w`` (KH, KW, C, O) as KH*KW shifted-slice ``(rows, C) @ (C, O)``
    products summed in f32. Returns (B, Hp-KH+1, Wp-KW+1, O); halo blocks
    (p, N, Hp, Wp, C) give :func:`conv_block`'s unsharded layout."""
    if x.ndim == 5:
        p, n = x.shape[:2]
        out = conv_block_plain(x.reshape(p * n, *x.shape[2:]), w)
        ho, wo, o = out.shape[1:]
        return out.reshape(p, n, ho, wo, o).transpose(0, 1).reshape(
            n, p * ho, wo, o)
    b, hp, wp, c = x.shape
    kh, kw, _, o = w.shape
    ho, wo = hp - kh + 1, wp - kw + 1
    acc = torch.zeros((b * ho * wo, o), dtype=torch.float32, device=x.device)
    for dh in range(kh):
        for dw in range(kw):
            patch = x[:, dh:dh + ho, dw:dw + wo, :].reshape(-1, c)
            acc = acc + patch @ w[dh, dw]
    return acc.reshape(b, ho, wo, o)


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.spartan_conv_block, lib.spartan_conv_block_mma):
        fn.argtypes = [vp, vp, vp] + [i32] * 8 + [vp]
        fn.restype = i32


def _load() -> ctypes.CDLL:
    """``csrc/stencil.cu``, built with nvcc for sm_90a at first use."""
    return build_mod.load("stencil", _bind)


def _launch(x5: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    p, n, hp, wp, c = x5.shape
    kh, kw, _, o = w.shape
    why = cuda_limits(kh, kw, c, o, p * n)
    if why:
        raise ValueError(f"conv_block kernel cannot take this input: {why}")
    dev = x5.device
    out = torch.empty((n, p * (hp - kh + 1), wp - kw + 1, o),
                      dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _load()
    mma = route(c) == "mma"
    fn = lib.spartan_conv_block_mma if mma else lib.spartan_conv_block
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x5.data_ptr(), w.data_ptr(), out.data_ptr(), p * n, n, hp,
                 wp, c, kh, kw, o, stream)
    build_mod.check(err, "conv_block kernel launch")
    build_mod.count_launch(LAUNCHES, "conv_block")
    if mma:
        build_mod.count_launch(LAUNCHES, "conv_block_mma")
    return out


# -- the operator and its batching rule ---------------------------------
#
# The conv is a torch custom operator with a shape rule and a batching
# rule (``build.per_client``: one launch a client, on either route; the
# filter usually shared); the wrapper calls it through ``build.call``.


def _conv_impl(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on the card, the plain version on the CPU."""
    if build_mod.on_card(x, "conv_block"):
        x5 = x if x.ndim == 5 else x.unsqueeze(0)
        return _launch(x5.contiguous(), w.contiguous())
    return conv_block_plain(x, w)


_conv_op = torch.library.custom_op("spartan_tpu_torch::conv_block",
                                   mutates_args=())(_conv_impl)


@_conv_op.register_fake
def _conv_fake(x, w):
    kh, kw, _, o = w.shape
    ho, wo = x.shape[-3] - kh + 1, x.shape[-2] - kw + 1
    if x.ndim == 5:  # halo blocks (p, N, ...): the unsharded output
        return x.new_empty((x.shape[1], x.shape[0] * ho, wo, o))
    return x.new_empty((x.shape[0], ho, wo, o))


_conv_op.register_vmap(build_mod.per_client(_conv_op))


def conv_block(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID f32 conv of ``x`` with ``w`` (KH, KW, C, O): for ``x``
    (B, Hp, Wp, C) the result is (B, Hp-KH+1, Wp-KW+1, O); for the p
    shards' halo blocks (p, N, Hp, Wp, C) of :func:`halo_exchange` it is
    the unsharded (N, p*(Hp-KH+1), Wp-KW+1, O). One kernel launch on a
    CUDA tensor; the plain version on a CPU tensor; on ``meta`` tensors
    in the plan audit's dry walk the operator's shape rule."""
    if x.ndim not in (4, 5) or w.ndim != 4:
        raise ValueError(f"conv_block takes x (B, Hp, Wp, C) or (p, N, Hp, "
                         f"Wp, C) and w (KH, KW, C, O); got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"conv_block is float32 only, got {x.dtype} and "
                        f"{w.dtype}")
    kh, kw, c, _ = w.shape
    if x.shape[-1] != c or x.shape[-3] < kh or x.shape[-2] < kw:
        raise ValueError(f"conv_block: x {tuple(x.shape)} does not fit the "
                         f"filter {tuple(w.shape)}")
    build_mod.on_card(x, "conv_block")  # raises for another device
    return build_mod.call(_conv_op, _conv_impl, x, w)


def halo_exchange(x: torch.Tensor, kh: int, kw: int, p: int) -> torch.Tensor:
    """Each of the ``p`` H-shards' SAME-padded blocks of ``x`` (N, H, W, C):
    (p, N, H/p + KH-1, W + KW-1, C). Shard s's block holds the previous
    shard's last ``lo`` rows, its own H/p rows and the next shard's first
    ``hi`` rows (zeros beyond the first and last shard), between ``wlo``
    and ``whi`` zero columns, where (lo, hi) and (wlo, whi) are XLA's SAME
    split of KH-1 and KW-1 (the extra row or column goes high). Built out
    of place (a zero-padded copy of ``x``, each block a window of its
    rows), so that a batched walk can take it."""
    n, h, w, c = x.shape
    if h % p:
        raise ValueError(f"H {h} does not split into {p} shards")
    hs = h // p
    hlo, hhi = _same_pad(kh)
    wlo, whi = _same_pad(kw)
    if hs < max(hlo, hhi):
        raise ValueError(f"shard H {hs} cannot supply a {kh}-row halo")
    # padded row hlo + r is x's row r: shard s's block starts at s * hs
    xpad = torch.nn.functional.pad(x, (0, 0, wlo, whi, hlo, hhi))
    return torch.stack([xpad[:, s * hs:s * hs + hs + kh - 1]
                        for s in range(p)])


def _halo_body(w: torch.Tensor, tiling, mesh: mesh_mod.Mesh, h: int):
    """The per-position body of the sharded stencil over an H of ``h``
    rows: the previous position's last ``lo`` rows and the next one's
    first ``hi`` rows by ``ring_permute`` (zeros at the ends, which is
    SAME's zero pad), W padded with zeros, one :func:`conv_block`."""
    from ..parallel import collectives as coll

    axis = tiling.axes[1]
    p = int(mesh.shape[axis])
    kh, kw = int(w.shape[0]), int(w.shape[1])
    hlo, hhi = _same_pad(kh)
    wlo, whi = _same_pad(kw)
    if h % p or h // p < max(hlo, hhi):
        raise ValueError(f"H {h} does not split into {p} shards "
                         f"of at least {max(hlo, hhi)} halo rows")

    def body(xl, wl):
        hs = xl.shape[1]
        me = coll.axis_index(axis)
        parts = []
        if hlo:
            top = coll.ring_permute(xl[:, hs - hlo:].contiguous(), axis, 1)
            parts.append(torch.zeros_like(top) if me == 0 else top)
        parts.append(xl)
        if hhi:
            bot = coll.ring_permute(xl[:, :hhi].contiguous(), axis, -1)
            parts.append(torch.zeros_like(bot) if me == p - 1 else bot)
        xpad = torch.nn.functional.pad(torch.cat(parts, 1),
                                       (0, 0, wlo, whi))
        return conv_block(xpad, wl)

    return body


def halo_stencil_sharded(x: torch.Tensor, w: torch.Tensor, tiling,
                         mesh: Optional[mesh_mod.Mesh] = None
                         ) -> torch.Tensor:
    """The JAX package's ``shard_map`` form of :func:`halo_stencil`:
    each position exchanges its halo rows with its neighbours and runs
    one :func:`conv_block` on its block (:func:`_halo_body`). Returns
    (N, H, W, O) f32, whole on every position."""
    from ..parallel.shard_map import shard_map

    mesh = mesh or mesh_mod.get_mesh()
    out_t = tiling.with_axis(2, None).with_axis(3, None)
    return shard_map(_halo_body(w, tiling, mesh, int(x.shape[1])), mesh,
                     (tiling, None), out_t)(x, w.to(torch.float32))


def halo_stencil_local(x, w: torch.Tensor, tiling):
    """The sharded stencil on a group mesh ``DistArray`` of images as the
    ranks store them (moved to ``tiling`` first): one
    :func:`conv_block` a rank on its block and its neighbours' halo
    rows. Returns the rank's (n, h, W, O) block of the output, tiled as
    ``tiling`` with W and O whole."""
    from ..parallel import redistribute as redist_mod
    from ..parallel.shard_map import shard_map_local

    mesh = x.mesh
    x = redist_mod.relayout(x, tiling)
    out_t = tiling.with_axis(2, None).with_axis(3, None)
    return shard_map_local(_halo_body(w, tiling, mesh, int(x.shape[1])),
                           mesh, (tiling, None), out_t)(
        x.local, w.to(torch.float32))


def halo_stencil(x: torch.Tensor, w: torch.Tensor, tiling,
                 mesh: Optional[mesh_mod.Mesh] = None) -> torch.Tensor:
    """SAME-padded stride-1 NHWC conv of ``x`` (N, H, W, C) with ``w``
    (KH, KW, C, O), H tiled over ``tiling.axes[1]``: on a logical mesh
    the halo exchange feeding one :func:`conv_block` over all shards, on
    a group mesh :func:`halo_stencil_local` on the rank's block of ``x``
    and the blocks gathered. Returns (N, H, W, O) f32."""
    mesh = mesh or mesh_mod.get_mesh()
    if mesh.is_group:
        from ..array.distarray import from_tensor
        from ..parallel import collectives as coll

        blk = halo_stencil_local(from_tensor(x, tiling, mesh), w, tiling)
        shape = tuple(x.shape[:3]) + (int(w.shape[3]),)
        return coll.gather_whole(
            blk, tiling.with_axis(2, None).with_axis(3, None), shape, mesh)
    p = int(mesh.shape[tiling.axes[1]])
    kh, kw = int(w.shape[0]), int(w.shape[1])
    blocks = halo_exchange(x, kh, kw, p)
    return conv_block(blocks, w.to(torch.float32))


def cost(blocks_shape: Tuple[int, ...], w_shape: Tuple[int, ...]
         ) -> Tuple[float, float]:
    """(operations, bytes) of one :func:`conv_block` launch over halo
    blocks of ``blocks_shape`` (p, N, Hp, Wp, C) with a (KH, KW, C, O)
    filter: 2·KH·KW·C FLOPs per output element; the blocks and the filter
    read once, the output written once, in float32. The count
    ``chip_smoke.py`` divides by the card's rates for the kernel's bound,
    and the stencil node's ``cost_analysis`` (``st.explain``)."""
    p, n, hp, wp, c = (int(s) for s in blocks_shape)
    kh, kw, _, o = (int(s) for s in w_shape)
    ho, wo = hp - kh + 1, wp - kw + 1
    out = p * n * ho * wo * o
    return (2.0 * out * kh * kw * c,
            4.0 * (p * n * hp * wp * c + kh * kw * c * o + out))


def halo_blocks_shape(x_shape: Tuple[int, ...], kh: int, kw: int,
                      p: int) -> Tuple[int, ...]:
    """The shape :func:`halo_exchange` gives ``p`` H-shards of an (N, H,
    W, C) operand."""
    n, h, w, c = (int(s) for s in x_shape)
    return (p, n, h // p + kh - 1, w + kw - 1, c)
