"""Local (fused elementwise) expression trees — the map-fusion unit.

Port of ``spartan_tpu/expr/local.py``: ``LocalInput``/``LocalConst``/
``LocalUfunc``/``LocalCall``. A fused tree is emitted as torch calls
over the node's input tensors. Ufunc names are numpy's; each maps to
the torch function with the same elementwise semantics.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from ..utils import dtypes


def _is_bool(v: Any) -> bool:
    return isinstance(v, bool) or (isinstance(v, torch.Tensor)
                                   and v.dtype == torch.bool)


def _promote_bool(v: Any, other: Any) -> Any:
    """The bool operand ``v`` in the dtype JAX promotes it to against
    ``other``: a tensor's dtype, or a Python scalar's weak int32/float32."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(other, torch.Tensor):
        return v.to(other.dtype)
    return v.to(dtypes.scalar_dtype(other))


def _subtract(a: Any, b: Any) -> Any:
    """``a - b``; torch refuses a bool operand, JAX promotes it (bool -
    bool stays an error in both)."""
    if _is_bool(a) and not _is_bool(b):
        a = _promote_bool(a, b)
    elif _is_bool(b) and not _is_bool(a):
        b = _promote_bool(b, a)
    return torch.sub(a, b)


def _bool_keeps(fn: Callable) -> Callable:
    """``fn``, except that a bool tensor comes back as it is: torch has
    no bool kernel for abs, ceil or floor, and JAX returns the bool."""
    def op(v: Any) -> Any:
        return v if _is_bool(v) else fn(v)

    op.__name__ = fn.__name__
    return op


def _rint(v: Any) -> Any:
    """``np.rint`` with JAX's dtypes: bool and integers round to float32
    (their values), floats round half to even in their own type."""
    if not (v.dtype.is_floating_point or v.dtype.is_complex):
        return dtypes.call(lambda w: w.to(torch.float32), v)
    return torch.round(v)


def _square(v: Any) -> Any:
    """``v * v``; a bool squares to int32, as JAX's does."""
    if _is_bool(v):
        return v.to(torch.int32)
    return torch.square(v)


def _power(a: Any, b: Any) -> Any:
    """``a ** b``; two bool operands are int32 (JAX's promotion)."""
    if _is_bool(a) and _is_bool(b):
        a, b = a.to(torch.int32), b.to(torch.int32)
    return torch.pow(a, b)


def _mod(a: Any, b: Any) -> Any:
    """``np.mod`` (the divisor's sign). Integer division by 0 (or False)
    gives 0, as in JAX, where torch raises; two bools are int32."""
    if _is_bool(a) and _is_bool(b):
        a, b = a.to(torch.int32), b.to(torch.int32)
    elif _is_bool(a):
        a = _promote_bool(a, b)
    elif _is_bool(b):
        b = _promote_bool(b, a)
    if a.dtype.is_floating_point or b.dtype.is_floating_point or \
            a.dtype.is_complex or b.dtype.is_complex:
        return torch.remainder(a, b)
    zero = b == 0
    out = torch.remainder(a, torch.where(zero, torch.ones_like(b), b))
    return torch.where(zero.to(out.device), torch.zeros_like(out), out)


# numpy ufunc name -> (torch fn, arity)
UFUNCS: Dict[str, Tuple[Callable, int]] = {
    # binary arithmetic
    "add": (torch.add, 2),
    "subtract": (_subtract, 2),
    "multiply": (torch.mul, 2),
    "divide": (torch.true_divide, 2),
    "true_divide": (torch.true_divide, 2),
    "floor_divide": (torch.floor_divide, 2),
    "mod": (_mod, 2),  # numpy sign convention (of divisor)
    "power": (_power, 2),
    "maximum": (torch.maximum, 2),
    "minimum": (torch.minimum, 2),
    "arctan2": (torch.atan2, 2),
    "hypot": (torch.hypot, 2),
    # comparisons / logic
    "equal": (torch.eq, 2),
    "not_equal": (torch.ne, 2),
    "less": (torch.lt, 2),
    "less_equal": (torch.le, 2),
    "greater": (torch.gt, 2),
    "greater_equal": (torch.ge, 2),
    "logical_and": (torch.logical_and, 2),
    "logical_or": (torch.logical_or, 2),
    "logical_xor": (torch.logical_xor, 2),
    "bitwise_and": (torch.bitwise_and, 2),
    "bitwise_or": (torch.bitwise_or, 2),
    "bitwise_xor": (torch.bitwise_xor, 2),
    # unary
    "negative": (torch.neg, 1),
    "absolute": (_bool_keeps(torch.abs), 1),
    "exp": (torch.exp, 1),
    "log": (torch.log, 1),
    "log2": (torch.log2, 1),
    "log10": (torch.log10, 1),
    "log1p": (torch.log1p, 1),
    "expm1": (torch.expm1, 1),
    "sqrt": (torch.sqrt, 1),
    "square": (_square, 1),
    "sign": (torch.sign, 1),
    "sin": (torch.sin, 1),
    "cos": (torch.cos, 1),
    "tan": (torch.tan, 1),
    "arcsin": (torch.asin, 1),
    "arccos": (torch.acos, 1),
    "arctan": (torch.atan, 1),
    "sinh": (torch.sinh, 1),
    "cosh": (torch.cosh, 1),
    "tanh": (torch.tanh, 1),
    "floor": (_bool_keeps(torch.floor), 1),
    "ceil": (_bool_keeps(torch.ceil), 1),
    "rint": (_rint, 1),  # round half to even, like np.rint
    "logical_not": (torch.logical_not, 1),
    "invert": (torch.bitwise_not, 1),
    "isnan": (torch.isnan, 1),
    "isinf": (torch.isinf, 1),
    "isfinite": (torch.isfinite, 1),
    "reciprocal": (torch.reciprocal, 1),
    "conjugate": (torch.conj, 1),
    # ternary
    "where": (torch.where, 3),
    "clip": (torch.clamp, 3),
}


class LocalExpr:
    """Node of a fused elementwise tree. Immutable; hashable via key()."""

    def emit(self, inputs: Sequence[Any]) -> Any:
        """Compute this tree over the input tensors."""
        raise NotImplementedError

    def key(self) -> Tuple:
        """Structural cache key."""
        raise NotImplementedError

    def remap(self, mapping: Dict[int, "LocalExpr"]) -> "LocalExpr":
        """Substitute LocalInput indices (fusion splicing)."""
        raise NotImplementedError


class LocalInput(LocalExpr):
    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = idx

    def emit(self, inputs):
        return inputs[self.idx]

    def key(self):
        return ("in", self.idx)

    def remap(self, mapping):
        return mapping.get(self.idx, self)

    def __repr__(self):
        return f"$i{self.idx}"


class LocalConst(LocalExpr):
    """A constant folded into the tree (python scalar)."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value

    def emit(self, inputs):
        return self.value

    def key(self):
        return ("const", type(self.value).__name__, float(self.value)
                if isinstance(self.value, (int, float, bool)) else
                repr(self.value))

    def remap(self, mapping):
        return self

    def __repr__(self):
        return f"{self.value!r}"


class LocalUfunc(LocalExpr):
    __slots__ = ("name", "args")

    def __init__(self, name: str, args: Sequence[LocalExpr]):
        if name not in UFUNCS:
            raise ValueError(f"unknown ufunc {name!r}")
        self.name = name
        self.args = tuple(args)

    def emit(self, inputs):
        fn = UFUNCS[self.name][0]
        return dtypes.call(fn, *[a.emit(inputs) for a in self.args])

    def key(self):
        return ("uf", self.name) + tuple(a.key() for a in self.args)

    def remap(self, mapping):
        return LocalUfunc(self.name, [a.remap(mapping) for a in self.args])

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


class LocalCall(LocalExpr):
    """A user-supplied function of torch tensors over the inputs (the
    reference's ``FnCallExpr``); its identity is part of the plan key."""

    __slots__ = ("fn", "args", "fn_kw")

    def __init__(self, fn: Callable, args: Sequence[LocalExpr],
                 fn_kw: Tuple[Tuple[str, Any], ...] = ()):
        self.fn = fn
        self.args = tuple(args)
        self.fn_kw = tuple(fn_kw)

    def emit(self, inputs):
        return self.fn(*[a.emit(inputs) for a in self.args],
                       **dict(self.fn_kw))

    def key(self):
        from .base import fn_key

        return (("call", fn_key(self.fn), self.fn_kw)
                + tuple(a.key() for a in self.args))

    def remap(self, mapping):
        return LocalCall(self.fn, [a.remap(mapping) for a in self.args],
                         self.fn_kw)

    def __repr__(self):
        name = getattr(self.fn, "__name__", "fn")
        return f"{name}({', '.join(map(repr, self.args))})"

