"""2-D stencil and pooling ops (port of ``spartan_tpu/ops/stencil.py``).

:func:`stencil` builds a :class:`StencilExpr`, an NHWC convolution with
HWIO filters. When ``kernels.select("stencil")`` picks the kernel (the
operand's H axis tiled over more than one logical shard, stride 1, SAME
padding, f32) it runs ``kernels/stencil.py::halo_stencil``: the halo
exchange and the hand-written conv kernel on the card (on a group mesh,
one kernel per rank after a real halo exchange). Every other case
convolves with ``torch.nn.functional.conv2d`` under XLA's padding rule,
as the JAX package's ``lax.conv_general_dilated`` does (cuDNN's TF32 is
off, ``spartan_tpu_torch/__init__.py``). :func:`maxpool` and
:func:`avgpool` are ``lax.reduce_window`` max and add (the add divided
by the whole window, edges included) over the spatial axes, a
:class:`PoolExpr` each (the JAX package's are ``map2`` calls): on a
group mesh each rank pools its H block, with halo rows from its
neighbours where a window crosses a block edge.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from ..expr.base import Expr, as_expr
from ..utils import dtypes

Stride = Union[int, Tuple[int, int]]


def _pair(v: Stride) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _xla_pads(size: Sequence[int], window: Sequence[int],
              stride: Sequence[int], padding: str) -> Tuple[int, ...]:
    """``F.pad``'s (W lo, W hi, H lo, H hi) for XLA's ``padding`` over
    the (H, W) axes: VALID pads nothing; SAME pads each axis by
    max((ceil(n / s) - 1) * s + k - n, 0), the low half first."""
    if padding == "VALID":
        return (0, 0, 0, 0)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    pads = []
    for n, k, s in zip(size, window, stride):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    (hlo, hhi), (wlo, whi) = pads
    return (wlo, whi, hlo, hhi)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: Tuple[int, int],
              padding: str) -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, stride, padding, ("NHWC", "HWIO",
    "NHWC"))``: pad explicitly, then a VALID ``F.conv2d`` on the NCHW
    view (torch's own ``padding="same"`` rejects stride > 1 and splits an
    even filter's pad the other way)."""
    pad = _xla_pads(x.shape[1:3], w.shape[:2], stride, padding)
    xc = F.pad(x.permute(0, 3, 1, 2), pad)
    out = F.conv2d(xc, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride)
    return out.permute(0, 2, 3, 1)


def _conv_shape(x: Expr, w: Expr, stride: Tuple[int, int],
                padding: str) -> Tuple[int, ...]:
    """The output shape of :func:`conv_nhwc` (computed, not traced: a
    first convolution on ``meta`` tensors costs a second of imports)."""
    if x.ndim != 4 or w.ndim != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"stencil takes images (N, H, W, C) and filters "
                         f"(KH, KW, C, O); got {x.shape} and {w.shape}")
    pad = _xla_pads(x.shape[1:3], w.shape[:2], stride, padding)
    hw = []
    for n, k, s, lo, hi in zip(x.shape[1:3], w.shape[:2], stride,
                               pad[2::-2], pad[3::-2]):
        if n + lo + hi < k:
            raise ValueError(f"filter {w.shape[:2]} larger than the padded "
                             f"image {x.shape[1:3]}")
        hw.append((n + lo + hi - k) // s + 1)
    return (x.shape[0], hw[0], hw[1], w.shape[3])


class StencilExpr(Expr):
    """NHWC convolution with the kernel layer's lowering seam:
    ``kernels.select("stencil", ...)`` decides from the shape, the
    operand's tiling and the flags whether the node runs the halo
    exchange and the conv kernel or ``F.conv2d``."""

    def __init__(self, x: Expr, w: Expr, stride: Tuple[int, int],
                 padding: str):
        self.x = x
        self.w = w
        self.stride = tuple(int(s) for s in stride)
        self.padding = str(padding)
        super().__init__(_conv_shape(x, w, self.stride, self.padding),
                         x.dtype)

    def children(self) -> Tuple[Expr, ...]:
        return (self.x, self.w)

    def replace_children(self, new_children) -> "StencilExpr":
        return StencilExpr(new_children[0], new_children[1],
                           self.stride, self.padding)

    def _conv(self, xv: Any, wv: Any) -> Any:
        return conv_nhwc(xv, wv, self.stride, self.padding)

    def _lower(self, env: Dict[int, Any]) -> Any:
        from ..kernels import registry as kernels_mod

        xv = self.x.lower(env)
        wv = self.w.lower(env)
        if kernels_mod.node_selection(self).native:
            from ..kernels import stencil as kstencil

            return kstencil.halo_stencil(xv, wv, self.x.out_tiling())
        return self._conv(xv, wv)

    def _lower_local(self, env) -> Any:
        """On a group mesh, where the kernel path is selected: each rank
        runs one ``conv_block`` on its stored block with its neighbours'
        halo rows (``kernels/stencil.halo_stencil_local``)."""
        from ..kernels import registry as kernels_mod

        t = self.x.out_tiling()
        if t.axes[1] is None or not t.divisible(self.x.shape, env.mesh) \
                or not kernels_mod.node_selection(self).native:
            return NotImplemented
        from ..array.distarray import DistArray
        from ..array import tiling as tiling_mod
        from ..kernels import stencil as kstencil

        w = self.w.lower_local(env).retile(
            tiling_mod.replicated(self.w.ndim)).local
        blk = kstencil.halo_stencil_local(self.x.lower_local(env), w, t)
        out_t = t.with_axis(2, None).with_axis(3, None)
        return DistArray.from_local(blk, out_t, self.shape, env.mesh)

    def _sig(self, ctx) -> Tuple:
        return ("stencil", self.stride, self.padding,
                ctx.of(self.x), ctx.of(self.w))

    def cost(self) -> Dict[str, float]:
        """2·KH·KW·C FLOPs per output element. On the kernel route the
        ``conv_block`` launch's own count (``kernels/stencil.cost``,
        under ``kernel``) plus the halo exchange's copy (the operand read,
        the halo blocks written); else the operands read once and the
        output written once."""
        from ..expr.base import io_bytes
        from ..kernels import registry as kernels_mod

        kh, kw, c, o = self.w.shape
        flops = 2.0 * self.size * kh * kw * c
        out = {"flops": flops, "transcendentals": 0.0,
               "bytes accessed": io_bytes((self.x, self.w), self)}
        sel = kernels_mod.node_selection(self)
        if sel is not None and sel.native:
            from ..kernels import stencil as kstencil
            from ..parallel import mesh as mesh_mod

            p = int(mesh_mod.get_mesh().shape[self.x.out_tiling().axes[1]])
            blocks = kstencil.halo_blocks_shape(self.x.shape, kh, kw, p)
            kf, kb = kstencil.cost(blocks, self.w.shape)
            halo = 4.0 * (self.x.size + float(np.prod(blocks)))
            out.update({"flops": kf, "bytes accessed": kb + halo,
                        "kernel": {"name": "conv_block", "flops": kf,
                                   "bytes accessed": kb}})
        return out

    def _default_tiling(self) -> Tiling:
        # batch and H tilings carry through (the halo path keeps them);
        # the W window and the output channels stay whole
        tx = self.x.out_tiling()
        return Tiling((tx.axes[0], tx.axes[1], None, None))

    def operand_requirement(self, t: Tiling, child_idx: int):
        # the images' batch and H placements (each rank works on its H
        # block on a group mesh); W and C whole, a filter read whole
        if child_idx:
            return tiling_mod.replicated(self.children()[child_idx].ndim)
        return Tiling((t.axes[0], t.axes[1], None, None))


def stencil(images, filters, stride: Stride = 1,
            padding: str = "SAME") -> Expr:
    """images (N, H, W, C), filters (KH, KW, C, O) -> (N, H', W', O)."""
    return StencilExpr(as_expr(images), as_expr(filters),
                       _pair(stride), padding)


def _pool_fill(kind: str, dtype: torch.dtype):
    """The value a pooling window's padding holds: -inf for a float max
    (an integer's least value, 0 for bool), 0 for a sum."""
    if kind != "max" or dtype.is_floating_point:
        return float("-inf") if kind == "max" else 0.0
    return torch.iinfo(dtype).min if dtype != torch.bool else 0


def _pool_nchw(xc: torch.Tensor, kind: str, window, stride) -> torch.Tensor:
    """The VALID pooling of the padded NCHW ``xc``, back as NHWC."""
    if kind == "max":
        if xc.dtype.is_floating_point:
            out = F.max_pool2d(xc, window, stride)
        else:
            # max_pool2d has no integer kernel: pool in float64 (every
            # int32 and smaller value is exact there) and cast back
            out = dtypes.call(lambda t: F.max_pool2d(
                t.to(torch.float64), window, stride).to(t.dtype), xc)
        return out.permute(0, 2, 3, 1)
    summed = F.avg_pool2d(xc, window, stride, divisor_override=1)
    return summed.permute(0, 2, 3, 1) / float(window[0] * window[1])


def _pool_input(x: torch.Tensor, w, s, padding: str,
                fill: float) -> torch.Tensor:
    """The NCHW view of ``x`` padded with ``fill`` by XLA's rule."""
    pad = _xla_pads(x.shape[1:3], w, s, padding)
    return F.pad(x.permute(0, 3, 1, 2), pad, value=fill)


def _maxpool(x, window, stride, padding):
    """Floats pad with -inf; integers with their dtype's least value and
    keep their dtype (``reduce_window`` with -inf as the init value)."""
    xc = _pool_input(x, window, stride, padding, _pool_fill("max", x.dtype))
    return _pool_nchw(xc, "max", window, stride)


def _avgpool(x, window, stride, padding):
    """Integers are summed in a float32 copy and give float32, as
    ``reduce_window(x, 0.0, add) / denom`` does."""
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    xc = _pool_input(x, window, stride, padding, 0.0)
    return _pool_nchw(xc, "avg", window, stride)


_POOL = {"max": _maxpool, "avg": _avgpool}


class PoolExpr(Expr):
    """Max or average pooling of NHWC images over the spatial axes
    (``lax.reduce_window``), a node so that a group mesh can pool each
    rank's H block in place: where a window crosses a block edge the
    rank takes the rows it lacks from its neighbours (one
    ``ring_permute`` each way, as the halo stencil does), and a 2x2
    stride-2 pool of even blocks needs none."""

    def __init__(self, x: Expr, kind: str, window: Tuple[int, int],
                 stride: Tuple[int, int], padding: str):
        if x.ndim != 4:
            raise ValueError(f"{kind}pool takes images (N, H, W, C); got "
                             f"{x.shape}")
        self.x = x
        self.kind = kind
        self.window = tuple(int(v) for v in window)
        self.stride = tuple(int(v) for v in stride)
        self.padding = str(padding)
        pad = _xla_pads(x.shape[1:3], self.window, self.stride,
                        self.padding)
        hw = []
        for n, k, st, lo, hi in zip(x.shape[1:3], self.window, self.stride,
                                    pad[2::-2], pad[3::-2]):
            if n + lo + hi < k:
                raise ValueError(f"window {self.window} larger than the "
                                 f"padded image {x.shape[1:3]}")
            hw.append((n + lo + hi - k) // st + 1)
        dt = x.dtype
        if kind == "avg" and not np.issubdtype(dt, np.floating):
            dt = np.dtype(np.float32)
        super().__init__((x.shape[0], hw[0], hw[1], x.shape[3]), dt)

    def children(self) -> Tuple[Expr, ...]:
        return (self.x,)

    def replace_children(self, new_children) -> "PoolExpr":
        return PoolExpr(new_children[0], self.kind, self.window,
                        self.stride, self.padding)

    def _lower(self, env: Dict[int, Any]) -> Any:
        return _POOL[self.kind](self.x.lower(env), self.window, self.stride,
                                self.padding)

    def _sig(self, ctx) -> Tuple:
        return ("pool", self.kind, self.window, self.stride, self.padding,
                ctx.of(self.x))

    def _default_tiling(self) -> Tiling:
        # batch and H tilings carry through (the halo path keeps them);
        # the W window and the channels stay whole
        tx = self.x.out_tiling()
        return Tiling((tx.axes[0], tx.axes[1], None, None))

    def operand_requirement(self, t: Tiling, child_idx: int):
        # the images' batch and H placements (each rank works on its H
        # block on a group mesh); W and C whole, a filter read whole
        if child_idx:
            return tiling_mod.replicated(self.children()[child_idx].ndim)
        return Tiling((t.axes[0], t.axes[1], None, None))

    def _halo(self, mesh, tiling: Tiling):
        """(rows from the previous block, rows from the next) the ranks
        along H's mesh axis take, the most any rank needs, or None where
        a window reaches past a neighbour's block (decided from shapes:
        every rank takes the same collectives)."""
        ax = tiling.axes[1]
        p = int(mesh.shape[ax]) if ax is not None else 1
        h, ho = self.x.shape[1], self.shape[1]
        if p == 1:
            return 0, 0
        if h % p or ho % p:
            return None
        hb, hob = h // p, ho // p
        plo = _xla_pads(self.x.shape[1:3], self.window, self.stride,
                        self.padding)[2]
        lo_n = hi_n = 0
        for i in range(p):
            r0 = max(0, i * hob * self.stride[0] - plo)
            r1 = min(h, ((i + 1) * hob - 1) * self.stride[0]
                     + self.window[0] - plo)
            lo_n = max(lo_n, i * hb - r0)
            hi_n = max(hi_n, r1 - (i + 1) * hb)
        if lo_n > hb or hi_n > hb:
            return None
        return lo_n, hi_n

    def card_staging(self, mesh) -> float:
        """What the pooling holds beyond its input and output at its
        peak (``resilience/memory.py``): the padded NCHW copy it pools
        (with a float32 copy of integer input to an average, a float64
        pass of integer input to a max, the sum beside the average),
        and on a group mesh the rows a rank's windows read, joined with
        its neighbours' halo rows."""
        n, h, w, c = self.x.shape
        out_elems = float(np.prod(self.shape))
        pads = _xla_pads(self.x.shape[1:3], self.window, self.stride,
                         self.padding)
        rows, halo = h + pads[2] + pads[3], 0.0
        if mesh.is_group:
            t_in, t_out = self._local_tilings(tiling_mod.sanitize(
                self.x.out_tiling(), self.x.shape, mesh), mesh)
            lohi = self._halo(mesh, t_in)
            if lohi is None or t_out.axes != t_in.axes:
                return 0.0
            n = t_in.block_extent(self.x.shape, mesh).shape[0]
            out_elems = float(t_out.block_extent(self.shape, mesh).size)
            ax = t_in.axes[1]
            p = int(mesh.shape[ax]) if ax is not None else 1
            # the padded rows a rank's windows read
            rows = (self.shape[1] // p - 1) * self.stride[0] \
                + self.window[0]
            if any(lohi):
                # the halo rows sent and received, the joined block
                halo = float(n * w * c) * (2 * sum(lohi) + h // p
                                           + sum(lohi))
        padded = float(n) * c * rows * (w + pads[0] + pads[1])
        fin = np.issubdtype(self.x.dtype, np.floating)
        isz = float(self.x.dtype.itemsize)
        osz = float(self.dtype.itemsize)
        out = out_elems * osz
        if self.kind == "avg":
            conv = 0.0 if fin else float(n) * h * w * c * 4.0
            # the sum and the quotient beside the padded copy
            return max(conv + (halo + padded) * 4.0,
                       padded * 4.0 + 2.0 * out) - out
        # the card's max_pool2d writes int64 indices beside its output;
        # an integer max pools a float64 copy
        extra = 8.0 * out_elems + (0.0 if fin else 8.0 * (padded
                                                          + out_elems))
        return max((halo + padded) * isz, padded * isz + extra + out) - out

    def _local_tilings(self, xt: Tiling, mesh):
        """(the input's, the output's) tilings of the local rule: batch
        and H placed as the input's, W and C whole."""
        t_in = tiling_mod.sanitize(Tiling((xt.axes[0], xt.axes[1], None,
                                           None)), self.x.shape, mesh)
        t_out = tiling_mod.sanitize(Tiling(t_in.axes), self.shape, mesh)
        return t_in, t_out

    def _lower_local(self, env) -> Any:
        """Each rank pools its block of H rows (W and C whole), with
        the halo rows a window crossing its block edge needs from its
        neighbours."""
        from ..array.distarray import DistArray
        from ..parallel import collectives as coll
        from ..parallel import redistribute as redist_mod
        from ..parallel.shard_map import shard_map_local

        mesh = env.mesh
        x = self.x.lower_local(env)
        t_in, t_out = self._local_tilings(x.tiling, mesh)
        halo = self._halo(mesh, t_in)
        if t_out.axes != t_in.axes or halo is None:
            return NotImplemented
        lo_n, hi_n = halo
        ax = t_in.axes[1]
        h, ho = self.x.shape[1], self.shape[1]
        kh, sh = self.window[0], self.stride[0]
        pads = _xla_pads(self.x.shape[1:3], self.window, self.stride,
                         self.padding)
        kind, window, stride = self.kind, self.window, self.stride

        def body(xl):
            if kind == "avg" and not xl.dtype.is_floating_point:
                xl = xl.to(torch.float32)
            fill = _pool_fill(kind, xl.dtype)
            p = coll.axis_size(ax) if ax is not None else 1
            me = coll.axis_index(ax) if ax is not None else 0
            hb, hob = h // p, ho // p
            parts = []
            if lo_n:
                parts.append(coll.ring_permute(
                    xl[:, hb - lo_n:].contiguous(), ax, 1))
            parts.append(xl)
            if hi_n:
                parts.append(coll.ring_permute(
                    xl[:, :hi_n].contiguous(), ax, -1))
            ext = torch.cat(parts, 1) if len(parts) > 1 else xl
            # rows of the padded image this rank's windows read
            w0 = me * hob * sh
            w1 = ((me + 1) * hob - 1) * sh + kh
            r0, r1 = max(0, w0 - pads[2]), min(h, w1 - pads[2])
            base = me * hb - lo_n
            rows = ext[:, r0 - base:r1 - base]
            top = max(0, pads[2] - w0)
            bot = max(0, w1 - pads[2] - h)
            xc = F.pad(rows.permute(0, 3, 1, 2),
                       (pads[0], pads[1], top, bot), value=fill)
            del parts, ext, rows, xl  # the joined rows, before pooling
            return _pool_nchw(xc, kind, window, stride)

        x = redist_mod.relayout(x, t_in)
        blk = shard_map_local(body, mesh, (t_in,), t_out)(x.local)
        return DistArray.from_local(blk, t_out, self.shape, mesh)


def maxpool(images, window: Stride = 2, stride: Stride = None,
            padding: str = "VALID") -> Expr:
    """images (N, H, W, C) max-pooled over the spatial axes (NaN
    propagates, as ``lax.max`` does)."""
    w = _pair(window)
    s = _pair(stride) if stride is not None else w
    return PoolExpr(as_expr(images), "max", w, s, padding)


def avgpool(images, window: Stride = 2, stride: Stride = None,
            padding: str = "VALID") -> Expr:
    """images (N, H, W, C) average-pooled over the spatial axes: each
    window's sum divided by the window's full size, at the edges too."""
    w = _pair(window)
    s = _pair(stride) if stride is not None else w
    return PoolExpr(as_expr(images), "avg", w, s, padding)
