"""Masked arrays: the lazy ``numpy.ma`` counterpart (port of
``spartan_tpu/array/masked.py``).

A :class:`MaskedDistArray` is a pair of lazy exprs of one shape: the
data and a bool mask (True = invalid, the ``numpy.ma`` convention).
Arithmetic joins the masks; reductions fill masked elements with the
reduction's identity and reduce as usual, so a masked program is an
ordinary expr DAG and rides the same optimizer and plan cache.

The mask-aware general ops (``st.dot``, ``st.sort``, ``st.argsort``,
``st.median``, ``st.concatenate``, ``st.map``) dispatch here when an
operand is masked; every other op refuses a masked operand in
``as_expr``. Sorts order valid elements first and masked ones last, in
``lax.sort``'s order (stable, -0.0 == +0.0, NaN after +inf). The median
is ``jnp.nanmedian``'s: the two middle values averaged as
``0.5 * lo + 0.5 * hi`` (``torch.median`` would return the lower one).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..expr import builtins as bi
from ..expr.base import Expr, as_expr
from ..expr.map import map as map_expr
from ..expr.reduce import max as _rmax
from ..expr.reduce import min as _rmin
from ..expr.reduce import prod as _rprod
from ..expr.reduce import sum as _rsum
from ..ops.sort import sort_key


def _mask_of(x: Any) -> Optional[Expr]:
    return x.mask if isinstance(x, MaskedDistArray) else None


def _data_of(x: Any) -> Any:
    return x.data if isinstance(x, MaskedDistArray) else x


def _union(a: Optional[Expr], b: Optional[Expr]) -> Optional[Expr]:
    if a is None:
        return b
    if b is None:
        return a
    return a | b


class MaskedDistArray:
    """Lazy (data, mask) pair; ``mask[i] == True`` means element i is
    invalid. Arithmetic propagates masks by union; reductions skip masked
    elements. ``glom()`` returns a ``numpy.ma`` array."""

    def __init__(self, data: Any, mask: Any):
        self.data = as_expr(data)
        self.mask = as_expr(mask)
        if self.mask.shape != self.data.shape:
            raise ValueError(
                f"mask shape {self.mask.shape} != data shape "
                f"{self.data.shape}")

    # -- construction ---------------------------------------------------

    @staticmethod
    def from_numpy(arr: Any) -> "MaskedDistArray":
        """From a ``numpy.ma`` masked array (or a plain array: no mask)."""
        from ..expr.builtins import from_numpy

        if isinstance(arr, np.ma.MaskedArray):
            data = np.ma.getdata(arr)
            mask = np.ma.getmaskarray(arr)
        else:
            data = np.asarray(arr)
            mask = np.zeros(data.shape, bool)
        return MaskedDistArray(from_numpy(data), from_numpy(mask))

    @staticmethod
    def masked_invalid(x: Any) -> "MaskedDistArray":
        """Mask NaN/Inf elements (``numpy.ma.masked_invalid``)."""
        x = as_expr(x)
        return MaskedDistArray(x, ~bi.isfinite(x))

    @staticmethod
    def masked_where(cond: Any, x: Any) -> "MaskedDistArray":
        """Mask where ``cond`` is True (``numpy.ma.masked_where``)."""
        return MaskedDistArray(as_expr(x), as_expr(cond))

    # -- properties -----------------------------------------------------

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    def __repr__(self) -> str:
        return f"MaskedDistArray(shape={self.shape}, dtype={self.dtype})"

    # -- arithmetic (mask union, numpy.ma semantics) --------------------

    def _binop(self, other: Any, op) -> "MaskedDistArray":
        mask = _union(self.mask, _mask_of(other))
        return MaskedDistArray(op(self.data, _data_of(other)), mask)

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._binop(o, lambda a, b: b / a)

    def __pow__(self, o):
        return self._binop(o, lambda a, b: a ** b)

    def __rpow__(self, o):
        return self._binop(o, lambda a, b: b ** a)

    def __neg__(self):
        return MaskedDistArray(-self.data, self.mask)

    def __abs__(self):
        return MaskedDistArray(bi.absolute(self.data), self.mask)

    # -- mask queries ---------------------------------------------------

    def count(self, axis=None, keepdims: bool = False) -> Expr:
        """Number of unmasked elements (``numpy.ma`` ``count``), int32."""
        valid = bi.where(self.mask, 0, 1)
        return _rsum(valid, axis=axis, keepdims=keepdims)

    def filled(self, fill_value: Any = 0) -> Expr:
        """Data with masked elements replaced by ``fill_value`` (promoted
        as ``jnp.where`` promotes a Python scalar)."""
        return bi.where(self.mask, fill_value, self.data)

    # -- reductions (skip masked elements) ------------------------------

    def sum(self, axis=None, keepdims: bool = False) -> Expr:
        return _rsum(self.filled(0), axis=axis, keepdims=keepdims)

    def prod(self, axis=None) -> Expr:
        return _rprod(self.filled(1), axis=axis)

    def mean(self, axis=None, keepdims: bool = False) -> Expr:
        """Masked mean; fully masked slices are NaN (0/0) whatever
        ``keepdims``."""
        return (self.sum(axis, keepdims=keepdims)
                / self.count(axis, keepdims=keepdims))

    def var(self, axis=None) -> Expr:
        """Masked variance (ddof=0). Per axis, the mean keeps its dims to
        broadcast back; masked positions are zeroed before the square sum,
        so fully masked slices come out NaN and leak nowhere."""
        if axis is None:
            d = self.filled(0) - self.mean(None)
            sq = bi.where(self.mask, 0.0, d * d)
            return _rsum(sq, axis=None) / self.count(None)
        d = self.data - self.mean(axis, keepdims=True)
        sq = bi.where(self.mask, 0.0, d * d)
        return _rsum(sq, axis=axis) / self.count(axis)

    def std(self, axis=None) -> Expr:
        return bi.sqrt(self.var(axis))

    def max(self, axis=None) -> "MaskedDistArray":
        """Masked max; fully masked slices come back masked."""
        out = _rmax(_fill_extreme(self, lo=True), axis=axis)
        return MaskedDistArray(out, bi.equal(self.count(axis), 0))

    def min(self, axis=None) -> "MaskedDistArray":
        out = _rmin(_fill_extreme(self, lo=False), axis=axis)
        return MaskedDistArray(out, bi.equal(self.count(axis), 0))

    def average(self, axis=None, weights: Any = None) -> Expr:
        """``numpy.ma.average``: a weighted mean skipping masked elements;
        a 1-D ``weights`` of length ``shape[axis]`` broadcasts along the
        axis. A zero weight sum gives NaN where numpy.ma raises."""
        if weights is None:
            return self.mean(axis)
        w = as_expr(weights)
        nd = len(self.shape)
        if w.ndim == 1 and nd == 1 and w.shape != self.shape:
            raise ValueError(
                f"Length of weights {w.shape[0]} not compatible "
                f"with data of shape {self.shape}")
        if w.ndim == 1 and nd > 1 and w.shape != self.shape:
            if axis is None:
                raise TypeError(
                    "Axis must be specified when shapes of data and "
                    "weights differ")
            if w.shape[0] != self.shape[axis % nd]:
                raise ValueError(
                    f"Length of weights {w.shape[0]} not compatible "
                    f"with axis {axis} of shape {self.shape}")
            bshape = [1] * nd
            bshape[axis % nd] = w.shape[0]
            w = w.reshape(tuple(bshape))
        wv = bi.where(self.mask, 0.0, w)
        num = _rsum(self.filled(0) * wv, axis=axis)
        den = _rsum(wv, axis=axis)
        return num / den

    def anom(self, axis=None) -> "MaskedDistArray":
        """``numpy.ma.anom``: data minus the masked mean along ``axis``,
        masked where the input is."""
        mean = (self.mean(None) if axis is None
                else self.mean(axis, keepdims=True))
        return MaskedDistArray(self.data - mean, self.mask)

    def compressed(self) -> np.ndarray:
        """The unmasked elements as a 1-D host array."""
        return np.ma.compressed(self.glom())

    # -- materialization ------------------------------------------------

    def glom(self) -> np.ma.MaskedArray:
        return np.ma.masked_array(np.asarray(self.data.glom()),
                                  np.asarray(self.mask.glom(), bool))

    def evaluate(self) -> "MaskedDistArray":
        """Both halves in one plan."""
        from ..expr.base import ValExpr, tuple_of

        d, m = tuple_of(self.data, self.mask).evaluate()
        return MaskedDistArray(ValExpr(d), ValExpr(m))


def _extreme(dtype: np.dtype, lo: bool):
    """The identity of max (``lo``) or min for ``dtype``."""
    if dtype == np.bool_:
        return not lo
    if np.issubdtype(dtype, np.floating):
        info = np.finfo(dtype)
        return float(info.min if lo else info.max)
    info = np.iinfo(dtype)
    return int(info.min if lo else info.max)


def _fill_with(d: torch.Tensor, m: torch.Tensor, value: Any) -> torch.Tensor:
    return torch.where(m, torch.tensor(value, dtype=d.dtype, device=d.device),
                       d)


def _fill_extreme(x: MaskedDistArray, lo: bool) -> Expr:
    """The data with masked elements set to the max (``lo``) or min
    identity, in the data's own dtype."""
    return map_expr(_fill_with, x.data, x.mask,
                    fn_kw={"value": _extreme(np.dtype(x.dtype), lo)})


# -- mask-aware general ops ----------------------------------------------


def _zeros_mask(x: Expr) -> Expr:
    return map_expr(lambda v: torch.zeros(v.shape, dtype=torch.bool,
                                          device=v.device), x)


def _valid_f32(x: Any) -> Expr:
    """1.0 where valid, 0.0 where masked (all ones for plain arrays)."""
    if isinstance(x, MaskedDistArray):
        return bi.where(x.mask, 0.0, 1.0)
    return map_expr(lambda v: torch.ones(v.shape, dtype=torch.float32,
                                         device=v.device), as_expr(x))


def masked_dot(a: Any, b: Any, precision=None) -> MaskedDistArray:
    """``numpy.ma.dot`` (strict=False): masked elements contribute 0, and
    a result cell is masked only where no valid pair fed it. Two GEMMs:
    the filled data, and the count of valid pairs as float32 0/1
    products (exact up to 2^24)."""
    from ..expr.dot import dot as _dot

    da = a.filled(0) if isinstance(a, MaskedDistArray) else as_expr(a)
    db = b.filled(0) if isinstance(b, MaskedDistArray) else as_expr(b)
    data = _dot(da, db, precision=precision)
    cnt = _dot(_valid_f32(a), _valid_f32(b))
    return MaskedDistArray(data, bi.equal(cnt, 0.0))


def masked_concatenate(arrays, axis: int = 0) -> MaskedDistArray:
    """Concatenate masked and plain operands; a plain operand brings an
    all-False mask (``numpy.ma.concatenate``)."""
    from ..expr.reshape import concatenate as _concat

    datas = [_data_of(a) if isinstance(a, MaskedDistArray)
             else as_expr(a) for a in arrays]
    masks = [a.mask if isinstance(a, MaskedDistArray)
             else _zeros_mask(as_expr(a)) for a in arrays]
    return MaskedDistArray(_concat(datas, axis), _concat(masks, axis))


def _valid_first(d: torch.Tensor, m: torch.Tensor, ax: int) -> torch.Tensor:
    """Indices along ``ax`` that order valid elements first, each part by
    value in ``lax.sort`` order, ties by index: a stable sort by value,
    then a stable sort by the mask."""
    by_value = torch.sort(sort_key(d), dim=ax, stable=True).indices
    # the flags die with their sort (no name holds them past it)
    order = torch.sort(m.to(torch.int8).gather(ax, by_value), dim=ax,
                       stable=True).indices
    return by_value.gather(ax, order)


def _sorted_values(d: torch.Tensor, m: torch.Tensor, ax: int) -> torch.Tensor:
    return d.gather(ax, _valid_first(d, m, ax))


def _sorted_mask(m: torch.Tensor, ax: int) -> torch.Tensor:
    # False for the first (valid count) slots along the axis: from the
    # counts, with no second sort
    k = (~m).sum(dim=ax, keepdim=True)
    shape = [1] * m.ndim
    shape[ax] = m.shape[ax]
    iota = torch.arange(m.shape[ax], device=m.device).reshape(shape)
    return iota >= k


def _map_along(fn, ax: int, *args) -> Expr:
    """``map_expr(fn, *args, fn_kw={"ax": ax})`` (the same plan key)
    with the hint that ``fn`` works along axis ``ax`` and keeps the
    shape (``LocalCall(along=)``): on a group mesh a block that holds the
    axis whole runs it in place, as the builtin sorts do."""
    from ..expr.local import LocalCall, LocalInput
    from ..expr.map import MapExpr

    inputs = tuple(as_expr(a) for a in args)
    return MapExpr(inputs, LocalCall(
        fn, tuple(LocalInput(i) for i in range(len(inputs))),
        (("ax", ax),), along=ax))


def masked_sort(x: MaskedDistArray, axis: int = -1) -> MaskedDistArray:
    """``numpy.ma.sort``: valid elements sorted, masked ones last."""
    from ..expr.builtins import _checked_axis

    ax = _checked_axis(axis, len(x.shape))
    return MaskedDistArray(
        _map_along(_sorted_values, ax, x.data, x.mask),
        _map_along(_sorted_mask, ax, x.mask))


def _argsort_valid_first(d: torch.Tensor, m: torch.Tensor,
                         ax: int) -> torch.Tensor:
    return _valid_first(d, m, ax).to(torch.int32)


def masked_argsort(x: MaskedDistArray, axis: int = -1) -> Expr:
    """int32 indices ordering valid elements first (``numpy.ma``
    ``argsort``), ties to the lowest index."""
    from ..expr.builtins import _checked_axis

    ax = _checked_axis(axis, len(x.shape))
    return _map_along(_argsort_valid_first, ax, x.data, x.mask)


def _median_valid(d: torch.Tensor, m: torch.Tensor, axis) -> torch.Tensor:
    """``jnp.nanmedian`` of the unmasked elements along ``axis`` (all when
    None), NaN where a valid element is NaN or no element is valid."""
    v = d.to(torch.float32)
    if axis is None:
        v, m, ax = v.reshape(-1), m.reshape(-1), 0
    else:
        ax = axis % v.ndim
    gone = m | torch.isnan(v)
    s = v.gather(ax, _valid_first(v, gone, ax))
    cnt = (~gone).sum(dim=ax, keepdim=True)
    lo = (cnt - 1).clamp_min(0) // 2
    hi = cnt // 2
    # q * (count - 1) at q = 0.5: the weights are (1, 0) on an odd count
    # and (0.5, 0.5) on an even one, as jnp's linear interpolation has them
    hw = torch.where(cnt % 2 == 0, 0.5, 0.0).to(torch.float32)
    med = s.gather(ax, lo) * (1.0 - hw) + s.gather(ax, hi) * hw
    bad = (cnt == 0) | (~m & torch.isnan(v)).any(dim=ax, keepdim=True)
    return torch.where(bad, float("nan"), med).squeeze(ax)


def masked_median(x: MaskedDistArray, axis=None) -> Expr:
    """``numpy.ma.median``: the median of the unmasked elements, float32.
    A valid NaN makes its slice NaN (``numpy.ma`` does not treat NaN as
    missing) and a fully masked slice is NaN. Along an axis, each output
    element reads its own line along it (``LocalCall(drops=)``): on a
    group mesh each rank takes the medians of its block's lines, the
    operands first moved so that the axis is whole in a block where it
    is split; over every element it reads its operands whole (counted)."""
    if axis is None:
        return map_expr(_median_valid, x.data, x.mask, fn_kw={"axis": axis})
    from ..expr.builtins import _checked_axis
    from ..expr.local import LocalCall, LocalInput
    from ..expr.map import MapExpr

    inputs = (as_expr(x.data), as_expr(x.mask))
    return MapExpr(inputs, LocalCall(
        _median_valid, (LocalInput(0), LocalInput(1)), (("axis", axis),),
        drops=_checked_axis(axis, len(x.shape))))
