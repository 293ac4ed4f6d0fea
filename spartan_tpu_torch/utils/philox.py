"""Counter-based random fills: Philox4x32-10 keyed by a seed.

The value at flat index ``i`` of a draw is a function of ``(seed, i)``
alone: the Philox4x32-10 block of the counter ``(i mod 2**32,
i >> 32, 0, 0)`` under the key ``(seed mod 2**32, (seed >> 32) mod
2**32)`` (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011). So a block of an array equals the same slice of the whole
draw on any mesh, any rank and either device, and a group rank makes
only its block (``expr/ndarray.py``'s ``RandomExpr``, ``DistArray``'s
``rand``/``randn``).

The rounds are plain torch integer ops on int64 tensors holding 32-bit
words: every product is split into 16-bit halves, so no intermediate
passes 2**49. The words become:

* ``uniform``: ``(w0 >> 8) * 2**-24``, exact in float32, so the CPU and
  the card give the same bits;
* ``normal``: Box-Muller, ``sqrt(-2 log u1) cos(2 pi u2)`` with
  ``u1 = ((w0 >> 8) + 1) * 2**-24`` and ``u2 = (w1 >> 8) * 2**-24``, in
  float64 and rounded once to the output's type;
* ``randint``: ``low + floor(((w0 << 32) | w1) * (high - low) / 2**64)``,
  the 64-bit word times the range, with no modulo bias.

A draw runs in chunks of at most :data:`CHUNK` elements over six int64
buffers it allocates once (:func:`staging_bytes`), so its peak beside
its output is bounded whatever the array's size.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from ..array.extent import TileExtent

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
ROUNDS = 10
_BUFFERS = 6
# elements a chunk: its six int64 buffers hold at most 64 MiB
CHUNK = (64 << 20) // (8 * _BUFFERS)

KINDS = ("uniform", "normal", "randint")


def staging_bytes(numel: int) -> int:
    """The bytes a draw of ``numel`` elements holds beside its output:
    its six int64 word buffers."""
    return _BUFFERS * 8 * min(int(numel), CHUNK)


def _half(m: int, c: torch.Tensor, s: torch.Tensor, t: torch.Tensor
          ) -> torch.Tensor:
    """One multiply of a round: ``c`` <- the high word of ``m * c`` and
    returns the buffer holding the low word (``s``); ``t`` is scratch.
    With ``A = (c >> 16) m`` and ``B = (c & 0xFFFF) m`` (each < 2**48),
    ``m c = (A + (B >> 16)) 2**16 + (B & 0xFFFF)``."""
    torch.bitwise_right_shift(c, 16, out=t)
    t.mul_(m)  # A
    c.bitwise_and_(0xFFFF).mul_(m)  # B
    torch.bitwise_right_shift(c, 16, out=s)
    t.add_(s)  # S = A + (B >> 16) < 2**49
    c.bitwise_and_(0xFFFF)
    torch.bitwise_and(t, 0xFFFF, out=s)
    s.bitwise_left_shift_(16).bitwise_or_(c)  # low word
    torch.bitwise_right_shift(t, 16, out=c)  # high word
    return s


def _rounds(c0, c1, c2, c3, a, b, key: Tuple[int, int]):
    """Philox4x32-10 on the counter words ``c0..c3`` (int64 tensors),
    in place over them and the scratch ``a``, ``b``. Returns the four
    output words and the two buffers left free, all among the six."""
    k0, k1 = key
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        # (hi0, lo0) = m0 c0: c0 <- hi0, a <- lo0
        lo0 = _half(_M0, c0, a, b)
        c3.bitwise_xor_(c0).bitwise_xor_(k1)  # c2' = hi0 ^ c3 ^ k1
        # (hi1, lo1) = m1 c2: c2 <- hi1, c0 <- lo1
        lo1 = _half(_M1, c2, c0, b)
        c1.bitwise_xor_(c2).bitwise_xor_(k0)  # c0' = hi1 ^ c1 ^ k0
        c0, c1, c2, c3, a, b = c1, lo1, c3, lo0, c2, b
    return (c0, c1, c2, c3), (a, b)


def philox(counter: Sequence[torch.Tensor], key: Tuple[int, int]
           ) -> Tuple[torch.Tensor, ...]:
    """The four Philox4x32-10 output words of each counter (four int64
    tensors of words below 2**32) under ``key`` (two 32-bit ints)."""
    c = [t.to(torch.int64).clone() for t in counter]
    a = torch.empty_like(c[0])
    b = torch.empty_like(c[0])
    return _rounds(*c, a, b, (int(key[0]) & _MASK,
                              int(key[1]) & _MASK))[0]


def _flat_index(ext: TileExtent, shape: Sequence[int], start: int,
                out: torch.Tensor, tmp: torch.Tensor,
                tmp2: torch.Tensor) -> None:
    """``out`` <- the flat indices in ``shape`` of the block elements
    ``start .. start + out.numel()`` of ``ext`` (row-major)."""
    n = out.numel()
    bs = tuple(int(h - l) for l, h in zip(ext.ul, ext.lr))
    strides = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * int(shape[d + 1])
    if all(bs[d] == int(shape[d]) for d in range(1, len(shape))):
        # whole trailing dims: the block is one run of the array
        base = sum(int(u) * s for u, s in zip(ext.ul, strides))
        torch.arange(base + start, base + start + n, out=out)
        return
    torch.arange(start, start + n, out=tmp)
    out.zero_()
    for d in range(len(shape) - 1, -1, -1):
        torch.remainder(tmp, bs[d], out=tmp2)
        tmp2.add_(int(ext.ul[d])).mul_(strides[d])
        out.add_(tmp2)
        tmp.floor_divide_(bs[d])


def _to_range(hi: torch.Tensor, lo: torch.Tensor, r: int,
              t: torch.Tensor) -> torch.Tensor:
    """``floor((hi * 2**32 + lo) * r / 2**64)`` for words ``hi``, ``lo``
    and ``r`` < 2**32, in 16-bit halves (``lo`` and ``t`` are
    overwritten; the result is left in ``hi``)."""
    # t = floor(lo * r / 2**32)
    torch.bitwise_right_shift(lo, 16, out=t)
    t.mul_(r)
    lo.bitwise_and_(0xFFFF).mul_(r).bitwise_right_shift_(16)
    t.add_(lo).bitwise_right_shift_(16)
    # floor((hi * r + t) / 2**32), hi = hh * 2**16 + hl
    torch.bitwise_and(hi, 0xFFFF, out=lo)
    lo.mul_(r).add_(t).bitwise_right_shift_(16)
    hi.bitwise_right_shift_(16).mul_(r).add_(lo).bitwise_right_shift_(16)
    return hi


def _fill(out: torch.Tensor, kind: str, seed: int, shape: Sequence[int],
         ext: TileExtent, params: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Write into ``out`` (contiguous, of ``ext``'s shape) the block
    ``ext`` of the draw ``kind`` of ``shape`` under ``seed``; ``params``
    is randint's ``[low, high)``. Returns ``out``."""
    if kind not in KINDS:
        raise ValueError(f"unknown random kind {kind!r}")
    total = out.numel()
    if total == 0 or out.device.type == "meta":
        return out
    flat = out.view(-1)
    dev = out.device
    n = min(total, CHUNK)
    bufs = [torch.empty(n, dtype=torch.int64, device=dev)
            for _ in range(_BUFFERS)]
    key = (int(seed) & _MASK, (int(seed) >> 32) & _MASK)
    lo_r, hi_r = (int(p) for p in params)
    if kind == "randint" and not 0 < hi_r - lo_r <= _MASK + 1:
        raise ValueError(f"randint needs low < high within 2**32, got "
                         f"[{lo_r}, {hi_r})")
    for s in range(0, total, CHUNK):
        m = min(CHUNK, total - s)
        c0, c1, c2, c3, a, b = (t[:m] for t in bufs)
        _flat_index(ext, shape, s, a, c2, c3)
        torch.bitwise_and(a, _MASK, out=c0)
        torch.bitwise_right_shift(a, 32, out=c1)
        c2.zero_()
        c3.zero_()
        (w0, w1, _, _), (f0, f1) = _rounds(c0, c1, c2, c3, a, b, key)
        dst = flat[s:s + m]
        if kind == "uniform":
            dst.copy_(w0.bitwise_right_shift_(8))
            dst.mul_(2.0 ** -24)
        elif kind == "normal":
            u1 = f0.view(torch.float64)
            u1.copy_(w0.bitwise_right_shift_(8).add_(1))
            u1.mul_(2.0 ** -24).log_().mul_(-2.0).sqrt_()
            u2 = f1.view(torch.float64)
            u2.copy_(w1.bitwise_right_shift_(8))
            u2.mul_(2.0 ** -24 * 2.0 * math.pi).cos_().mul_(u1)
            dst.copy_(u2)
        else:
            dst.copy_(_to_range(w0, w1, hi_r - lo_r, f0).add_(lo_r))
    return out


def draw(kind: str, seed: int, shape: Sequence[int], ext: TileExtent,
         dtype: torch.dtype, device, params: Tuple[int, int] = (0, 0)
         ) -> torch.Tensor:
    """The block ``ext`` of the draw ``kind`` of ``shape`` under
    ``seed``, as a new tensor of ``dtype`` on ``device``."""
    out = torch.empty(tuple(int(h - l) for l, h in zip(ext.ul, ext.lr)),
                      dtype=dtype, device=device)
    return _fill(out, kind, seed, shape, ext, params)


def whole(shape: Sequence[int]) -> TileExtent:
    """The extent of a whole array of ``shape``."""
    shape = tuple(int(s) for s in shape)
    return TileExtent((0,) * len(shape), shape, shape)

