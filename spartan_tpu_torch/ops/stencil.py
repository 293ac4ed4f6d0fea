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
by the whole window, edges included) over the spatial axes.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..array.tiling import Tiling
from ..expr.base import Expr, as_expr
from ..expr.map2 import map2
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

    def _sig(self, ctx) -> Tuple:
        return ("stencil", self.stride, self.padding,
                ctx.of(self.x), ctx.of(self.w))

    def _default_tiling(self) -> Tiling:
        # batch and H tilings carry through (the halo path keeps them);
        # the W window and the output channels stay whole
        tx = self.x.out_tiling()
        return Tiling((tx.axes[0], tx.axes[1], None, None))


def stencil(images, filters, stride: Stride = 1,
            padding: str = "SAME") -> Expr:
    """images (N, H, W, C), filters (KH, KW, C, O) -> (N, H', W', O)."""
    return StencilExpr(as_expr(images), as_expr(filters),
                       _pair(stride), padding)


def _pool_input(x: torch.Tensor, w, s, padding: str,
                fill: float) -> torch.Tensor:
    """The NCHW view of ``x`` padded with ``fill`` by XLA's rule."""
    pad = _xla_pads(x.shape[1:3], w, s, padding)
    return F.pad(x.permute(0, 3, 1, 2), pad, value=fill)


def _maxpool(x, window, stride, padding):
    """Floats pad with -inf; integers with their dtype's least value and
    keep their dtype (``reduce_window`` with -inf as the init value)."""
    if x.dtype.is_floating_point:
        xc = _pool_input(x, window, stride, padding, float("-inf"))
        return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)
    # max_pool2d has no integer kernel: pool in float64 (every int32 and
    # smaller value is exact there) and cast back
    fill = torch.iinfo(x.dtype).min if x.dtype != torch.bool else 0
    xc = _pool_input(x, window, stride, padding, fill)
    return dtypes.call(lambda t: F.max_pool2d(t.to(torch.float64), window,
                                              stride).to(t.dtype),
                       xc).permute(0, 2, 3, 1)


def _avgpool(x, window, stride, padding):
    """Integers are summed in a float32 copy and give float32, as
    ``reduce_window(x, 0.0, add) / denom`` does."""
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    xc = _pool_input(x, window, stride, padding, 0.0)
    summed = F.avg_pool2d(xc, window, stride, divisor_override=1)
    return summed.permute(0, 2, 3, 1) / float(window[0] * window[1])


def maxpool(images, window: Stride = 2, stride: Stride = None,
            padding: str = "VALID") -> Expr:
    """images (N, H, W, C) max-pooled over the spatial axes (NaN
    propagates, as ``lax.max`` does)."""
    w = _pair(window)
    s = _pair(stride) if stride is not None else w
    return map2([as_expr(images)], _maxpool,
                fn_kw={"window": w, "stride": s, "padding": padding})


def avgpool(images, window: Stride = 2, stride: Stride = None,
            padding: str = "VALID") -> Expr:
    """images (N, H, W, C) average-pooled over the spatial axes: each
    window's sum divided by the window's full size, at the edges too."""
    w = _pair(window)
    s = _pair(stride) if stride is not None else w
    return map2([as_expr(images)], _avgpool,
                fn_kw={"window": w, "stride": s, "padding": padding})
