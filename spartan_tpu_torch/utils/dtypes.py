"""numpy <-> torch dtype mapping.

Expr metadata keeps numpy dtypes (as in the JAX package); tensors carry
torch dtypes. Host data is canonicalized the way the JAX package's
default (64-bit mode off) stores it: float64 becomes float32, int64
becomes int32 and uint64 becomes uint32, so the same numpy input gives
arrays of the same dtype in both packages.

bfloat16 host arrays are ml_dtypes' numpy type (what JAX hands out); it
is recognised by its name, so this module never imports ml_dtypes.

Torch has few kernels for uint16 and uint32 (no add, compare or max):
:func:`call` runs an op on such operands in int64, where every value is
exact, and casts an integer result back, wrapping as the unsigned type
would. It is the one place that rule lives.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}

_CANONICAL = {
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.complex128): np.dtype(np.complex64),
}

_BF16 = "bfloat16"

# dtypes torch has few kernels for, and the type they are computed in
_NARROW_KERNELS = (torch.uint16, torch.uint32)
_WIDE = torch.int64


def _is_bf16(dt: np.dtype) -> bool:
    return dt.name == _BF16


def to_torch(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = np.dtype(dtype)
    if _is_bf16(dt):
        return torch.bfloat16
    return _NP_TO_TORCH[dt]


def to_numpy(dtype: Any) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            # ml_dtypes' type, registered with numpy by whoever made
            # bfloat16 host data (JAX does at import)
            return np.dtype(_BF16)
        return _TORCH_TO_NP[dtype]
    return np.dtype(dtype)


def canonical(dtype: Any) -> np.dtype:
    """The dtype an array of ``dtype`` host data is stored as."""
    dt = to_numpy(dtype)
    return _CANONICAL.get(dt, dt)


def from_host(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor holding ``arr`` (already canonical and C-ordered);
    bfloat16 goes through its 16-bit pattern."""
    if _is_bf16(arr.dtype):
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array (copied to the host); bfloat16 comes back as
    ml_dtypes' bfloat16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(to_numpy(torch.bfloat16))
    return t.numpy()


def is_unsigned(dtype: torch.dtype) -> bool:
    return dtype in (torch.uint8,) + _NARROW_KERNELS


def widen(t: torch.Tensor) -> torch.Tensor:
    """``t``, in int64 when it is uint16 or uint32 (same order, exact
    values): for ops whose result is not of the operand's type, such as
    the indices of a top-k."""
    return t.to(_WIDE) if t.dtype in _NARROW_KERNELS else t


def call(fn: Callable, *args: Any, **kw: Any) -> Any:
    """``fn(*args, **kw)``. Where a tensor operand is uint16 or uint32,
    which torch has few kernels for, every such operand is computed in
    int64 instead and an int64 result is cast back to the operands'
    promoted dtype (0-d operands are weak, as Python scalars are in
    JAX), canonicalized as stored: so ``uint32 + uint32`` wraps modulo
    2^32, a comparison stays bool and a division stays float."""
    narrow = [a for a in args
              if isinstance(a, torch.Tensor) and a.dtype in _NARROW_KERNELS]
    if not narrow:
        return fn(*args, **kw)
    strong = [to_numpy(a.dtype) for a in args
              if isinstance(a, torch.Tensor) and a.ndim > 0] or \
        [to_numpy(a.dtype) for a in narrow]
    want = to_torch(canonical(np.result_type(*strong)))
    out = fn(*[a.to(_WIDE) if isinstance(a, torch.Tensor)
               and a.dtype in _NARROW_KERNELS else a for a in args], **kw)
    if isinstance(out, torch.Tensor) and out.dtype == _WIDE:
        return out.to(want)
    return out


def _promote2(a: np.dtype, b: np.dtype) -> np.dtype:
    """JAX's type-promotion lattice for two strong dtypes (64-bit types
    included; :func:`result_type` canonicalizes the join)."""
    if a == b:
        return a
    ka, kb = a.kind, b.kind
    if ka == "b":
        return b
    if kb == "b":
        return a
    fa = ka in "fc" or _is_bf16(a)
    fb = kb in "fc" or _is_bf16(b)
    if fa and fb:
        if {a.name, b.name} == {"float16", _BF16}:
            return np.dtype(np.float32)
        return a if a.itemsize >= b.itemsize else b
    if fa or fb:
        # an integer against a float: the float's type
        return a if fa else b
    if ka == kb:
        return a if a.itemsize >= b.itemsize else b
    u, s = (a, b) if ka == "u" else (b, a)
    if s.itemsize > u.itemsize:
        return s
    if u.itemsize >= 8:
        # uint64 with a signed integer has no integer join in JAX
        return np.dtype(np.float64)
    return np.dtype("int%d" % (16 * u.itemsize))


def result_type(*dts: Any) -> np.dtype:
    """The dtype JAX (64-bit types off) gives an operation over operands
    of ``dts`` -- e.g. float32 for float32 and int32, float16 for
    float16 and int32, int32 for int8 and uint32 -- where numpy would
    widen to 64 bits. The port's stored dtypes never need more."""
    out = to_numpy(dts[0])
    for d in dts[1:]:
        out = _promote2(out, to_numpy(d))
    return canonical(out)


def contract(fn: Callable, dtype: Any, *operands: torch.Tensor,
             **kw: Any) -> torch.Tensor:
    """``fn(*operands, **kw)`` -- a matmul, einsum or tensordot -- with
    every operand in ``dtype``. Torch has no bool product kernel: a bool
    contraction is a sum of 0/1 products, taken in float32 and compared
    with 0 (exact, since it is 0 only when every product is), which is
    JAX's bool result; uint16/uint32 go through :func:`call`."""
    dt = to_torch(dtype)
    if dt == torch.bool:
        return fn(*[o.to(torch.float32) for o in operands], **kw) != 0
    return call(fn, *[o.to(dt) for o in operands], **kw)


def scalar_dtype(value: Any) -> torch.dtype:
    """The dtype a Python scalar leaf is carried as (a 0-d tensor):
    bool, int32 or float32. A 0-d tensor does not promote the dtype of
    a dimensioned operand of the same kind, which matches JAX's weakly
    typed Python scalars."""
    if isinstance(value, bool):
        return torch.bool
    if isinstance(value, int):
        return torch.int32
    return torch.float32
