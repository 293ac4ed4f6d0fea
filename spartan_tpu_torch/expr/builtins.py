"""NumPy-surface builtins over the expr DAG (port of
``spartan_tpu/expr/builtins.py``): creation, elementwise wrappers, the
reductions and ``dot`` it re-exports, and the sort/select half (sample
sort, argsort, order statistics, top-k, bincount, histogram, unique,
prefix scans), the statistics (var, std, ptp, norm), the matrix shape
helpers (diag, diagonal, tril, triu, trace) and the contraction builtins
(einsum, tensordot, matmul, inner, outer_product) over
``expr/contract.py``. ``dot``, ``sort``, ``argsort``, ``median`` and
``concatenate`` take masked operands (``array/masked.py``).
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np
import torch

from ..array import distarray as da
from ..utils import dtypes
from .base import Expr, ValExpr, as_expr
from .local import LocalInput, LocalUfunc
from .map import MapExpr, build_binop, build_unop, map as map_expr
from .map2 import map2
from .ndarray import CreateExpr, RandomExpr, ndarray
from .reduce import (all, any, argmax, argmin, max, mean, min, prod,
                     reduce, sum)

__all__ = [
    "zeros", "ones", "full", "arange", "eye", "identity", "rand", "randn",
    "randint", "astype", "absolute", "abs", "exp", "log", "sqrt", "square",
    "sign", "sin", "cos", "tan", "tanh", "maximum", "minimum", "where",
    "clip", "sum", "mean", "max", "min", "prod", "all", "any", "argmax",
    "argmin", "reduce", "norm", "diag", "diagonal", "tril", "triu",
    "concatenate", "ravel", "var", "std", "ptp", "outer_product", "einsum",
    "tensordot", "matmul", "trace", "inner",
    "ndarray", "dot", "power", "equal", "from_numpy", "isnan", "isinf",
    "isfinite", "logical_not", "log1p", "expm1", "log2", "log10", "floor",
    "ceil", "rint", "negative", "reciprocal", "add", "subtract",
    "multiply", "divide", "true_divide", "mod", "not_equal", "greater",
    "greater_equal", "less", "less_equal", "logical_and", "logical_or",
    "logical_xor", "bincount", "count_nonzero", "count_zero", "size",
    "sort", "argsort", "median", "percentile", "quantile", "topk",
    "histogram", "unique_counts", "unique", "linspace", "take", "cumsum",
    "cumprod", "scan",
]


# -- creation -----------------------------------------------------------


def zeros(shape, dtype=np.float32, tile_hint=None, tiling=None) -> Expr:
    return CreateExpr(shape, dtype, "zeros", (), tiling, tile_hint)


def ones(shape, dtype=np.float32, tile_hint=None, tiling=None) -> Expr:
    return CreateExpr(shape, dtype, "ones", (), tiling, tile_hint)


def full(shape, fill_value, dtype=np.float32, tile_hint=None,
         tiling=None) -> Expr:
    return CreateExpr(shape, dtype, "full", (fill_value,), tiling, tile_hint)


def arange(*args, dtype=None, tile_hint=None, tiling=None) -> Expr:
    probe = np.arange(*args, dtype=dtype)
    return CreateExpr(probe.shape, dtypes.canonical(probe.dtype), "arange",
                      tuple(args), tiling, tile_hint)


def eye(n, m=None, k=0, dtype=np.float32, tile_hint=None) -> Expr:
    m = n if m is None else m
    return CreateExpr((n, m), dtype, "eye", (n, m, k), None, tile_hint)


def identity(n, dtype=np.float32) -> Expr:
    return eye(n, dtype=dtype)


def rand(*shape, seed=None, tile_hint=None, tiling=None) -> Expr:
    return RandomExpr(shape, "uniform", seed, np.float32, tiling, tile_hint)


def randn(*shape, seed=None, tile_hint=None, tiling=None) -> Expr:
    return RandomExpr(shape, "normal", seed, np.float32, tiling, tile_hint)


def randint(*shape, low=0, high=10, seed=None, tile_hint=None) -> Expr:
    """int32 uniform in [low, high) from a seeded ``torch.Generator``."""
    e = RandomExpr(shape, "randint", seed, np.int32, None, tile_hint)
    e.params_range = (int(low), int(high))
    return e


def from_numpy(arr, tiling=None, tile_hint=None, device=None) -> Expr:
    return ValExpr(da.from_numpy(arr, tiling=tiling, tile_hint=tile_hint,
                                 device=device))


# -- elementwise wrappers ----------------------------------------------


def _unary(name):
    def fn(x) -> Expr:
        return build_unop(name, x)

    fn.__name__ = name
    return fn


absolute = _unary("absolute")
abs = absolute
exp = _unary("exp")
log = _unary("log")
sqrt = _unary("sqrt")
square = _unary("square")
sign = _unary("sign")
sin = _unary("sin")
cos = _unary("cos")
tan = _unary("tan")
tanh = _unary("tanh")
isnan = _unary("isnan")
isinf = _unary("isinf")
isfinite = _unary("isfinite")
logical_not = _unary("logical_not")
log1p = _unary("log1p")
expm1 = _unary("expm1")
log2 = _unary("log2")
log10 = _unary("log10")
floor = _unary("floor")
ceil = _unary("ceil")
rint = _unary("rint")
negative = _unary("negative")
reciprocal = _unary("reciprocal")


def _binary(name):
    def fn(a, b) -> Expr:
        return build_binop(name, a, b)

    fn.__name__ = name
    return fn


add = _binary("add")
subtract = _binary("subtract")
multiply = _binary("multiply")
true_divide = _binary("true_divide")
divide = true_divide
mod = _binary("mod")
not_equal = _binary("not_equal")
greater = _binary("greater")
greater_equal = _binary("greater_equal")
less = _binary("less")
less_equal = _binary("less_equal")
logical_and = _binary("logical_and")
logical_or = _binary("logical_or")
logical_xor = _binary("logical_xor")
maximum = _binary("maximum")
minimum = _binary("minimum")
power = _binary("power")
equal = _binary("equal")


def where(cond, a, b) -> Expr:
    inputs = (as_expr(cond), as_expr(a), as_expr(b))
    return MapExpr(inputs, LocalUfunc(
        "where", (LocalInput(0), LocalInput(1), LocalInput(2))))


def clip(x, lo, hi) -> Expr:
    inputs = (as_expr(x), as_expr(lo), as_expr(hi))
    return MapExpr(inputs, LocalUfunc(
        "clip", (LocalInput(0), LocalInput(1), LocalInput(2))))


def astype(x, dtype) -> Expr:
    tdt = dtypes.to_torch(dtypes.canonical(dtype))
    return map_expr(lambda v: v.to(tdt), as_expr(x))


def dot(a, b, precision=None) -> Expr:
    from .dot import dot as _dot

    return _dot(a, b, precision=precision)


# -- shape-flavoured / misc builtins -----------------------------------------


def ravel(x) -> Expr:
    from .reshape import ravel as _ravel

    return _ravel(x)


def concatenate(arrays, axis=0) -> Expr:
    from .reshape import concatenate as _concat

    return _concat(arrays, axis)


def norm(x, ord=2) -> Expr:
    x = as_expr(x)
    if ord == 2:
        return sqrt(sum(x * x))
    if ord == 1:
        return sum(absolute(x))
    raise ValueError(f"unsupported norm order {ord}")


def diag(x) -> Expr:
    """1-D -> diagonal matrix; 2-D -> its diagonal (NumPy semantics)."""
    x = as_expr(x)
    if x.ndim == 1:
        return map_expr(torch.diag, x)
    if x.ndim == 2:
        return diagonal(x)
    raise ValueError("diag requires 1-D or 2-D input")


def diagonal(x) -> Expr:
    x = as_expr(x)
    if x.ndim != 2:
        raise ValueError("diagonal requires a 2-D input")
    return map_expr(lambda v: torch.diagonal(v).clone(), x)


def tril(x, k=0) -> Expr:
    return map_expr(lambda v: dtypes.call(torch.tril, v, k), as_expr(x))


def triu(x, k=0) -> Expr:
    return map_expr(lambda v: dtypes.call(torch.triu, v, k), as_expr(x))


def var(x, axis=None, ddof: int = 0, keepdims: bool = False) -> Expr:
    """Variance in two passes: the mean, then the mean squared
    deviation."""
    x = as_expr(x)
    m = mean(x, axis=axis, keepdims=True)
    d = x - m
    n = x.size if axis is None else _axis_count(x.shape, axis)
    out = sum(d * d, axis=axis, keepdims=keepdims) / float(n - ddof)
    if out.ndim == 0 and out.dtype != d.dtype and \
            np.dtype(d.dtype).itemsize < 4:
        # a whole float16/bfloat16 sum is 0-d, and torch promotes it
        # against the 0-d divisor; JAX's Python divisor is weak
        out = astype(out, d.dtype)
    return out


def std(x, axis=None, ddof: int = 0, keepdims: bool = False) -> Expr:
    return sqrt(var(x, axis=axis, ddof=ddof, keepdims=keepdims))


def ptp(x, axis=None) -> Expr:
    return max(x, axis=axis) - min(x, axis=axis)


def _axis_count(shape, axis) -> int:
    if isinstance(axis, (int, np.integer)):
        axis = (int(axis),)
    n = 1
    for a in axis:
        n *= shape[a % len(shape)]
    return n


# -- contractions --------------------------------------------------------------


def _contract_whole(fn, *xs, **kw):
    """``fn`` over the operands in their common dtype (``jnp``'s
    promotion with 64-bit types off)."""
    return dtypes.contract(fn, dtypes.result_type(*[x.dtype for x in xs]),
                           *xs, **kw)


def _einsum_whole(*xs, subscripts):
    return _contract_whole(functools.partial(torch.einsum, subscripts), *xs)


def einsum(subscripts: str, *operands, precision=None) -> Expr:
    """NumPy-style einsum over lazy operands. Two-operand contractions
    (ellipsis batching included) are one ``ContractExpr``; three or more
    operands become a chain of them along ``np.einsum_path``'s greedy
    order. Specs outside that family (diagonals, broadcasting ellipses,
    single-operand reductions) run one ``torch.einsum`` over the whole
    operands."""
    from .contract import contract, contract_chain, parse_einsum

    exprs = [as_expr(o) for o in operands]
    parsed = parse_einsum(subscripts, tuple(e.ndim for e in exprs))
    if parsed is not None:
        per_op, out_labels = parsed
        if len(exprs) == 2:
            e = contract(exprs[0], exprs[1], per_op[0], per_op[1],
                         out_labels, precision=precision)
            if e is not None:
                return e
        elif len(exprs) > 2:
            e = contract_chain(exprs, per_op, out_labels,
                               precision=precision)
            if e is not None:
                return e
    return map2(exprs, _einsum_whole, fn_kw={"subscripts": subscripts})


def _tensordot_whole(x, y, axes):
    return _contract_whole(torch.tensordot, x, y, dims=axes)


def tensordot(a, b, axes=2) -> Expr:
    """NumPy ``tensordot`` as a contraction: the free axes of ``a``, then
    those of ``b``; contracted pairs share labels."""
    from .contract import _CANON, contract

    a, b = as_expr(a), as_expr(b)
    if isinstance(axes, (list, tuple)):
        ax0, ax1 = axes

        def _norm(xs, nd):
            out = []
            for x in np.atleast_1d(xs):
                x = int(x)
                if not -nd <= x < nd:
                    raise ValueError(
                        f"tensordot axis {x} out of range for ndim {nd}")
                out.append(x % nd)
            return tuple(out)

        ax_a = _norm(ax0, a.ndim)
        ax_b = _norm(ax1, b.ndim)
        if len(ax_a) != len(ax_b):
            raise ValueError(
                f"tensordot axes lists differ in length: "
                f"{len(ax_a)} vs {len(ax_b)}")
    else:
        k = int(axes)
        if k > a.ndim or k > b.ndim:
            raise ValueError(
                f"tensordot axes={k} exceeds operand ranks "
                f"{a.ndim} and {b.ndim}")
        ax_a = tuple(range(a.ndim - k, a.ndim))
        ax_b = tuple(range(k))
    la = [_CANON[i] for i in range(a.ndim)]
    lb = [_CANON[a.ndim + i] for i in range(b.ndim)]
    for i, j in zip(ax_a, ax_b):
        lb[j] = la[i]
    out = tuple(la[i] for i in range(a.ndim) if i not in ax_a) + \
        tuple(lb[j] for j in range(b.ndim) if j not in ax_b)
    e = contract(a, b, tuple(la), tuple(lb), out)
    if e is not None:
        return e
    return map2([a, b], _tensordot_whole,
                fn_kw={"axes": (list(ax_a), list(ax_b))})


def _matmul_whole(x, y):
    return _contract_whole(torch.matmul, x, y)


def matmul(a, b, precision=None) -> Expr:
    """``a @ b``: 1-D/2-D operands are a ``DotExpr``; batched operands a
    batched contraction (``torch.matmul`` over the whole operands when
    the batch axes broadcast)."""
    from .contract import _CANON, contract
    from .dot import dot as dot_expr

    a, b = as_expr(a), as_expr(b)
    if a.ndim <= 2 and b.ndim <= 2:
        return dot_expr(a, b, precision=precision)
    e = None
    if a.ndim >= 2 and b.ndim >= 2:
        nb = (a.ndim if a.ndim >= b.ndim else b.ndim) - 2
        batch = [_CANON[i] for i in range(nb)]
        la = tuple(batch[nb - (a.ndim - 2):]) + (_CANON[nb], _CANON[nb + 1])
        lb = tuple(batch[nb - (b.ndim - 2):]) + (_CANON[nb + 1],
                                                 _CANON[nb + 2])
        out = tuple(batch) + (_CANON[nb], _CANON[nb + 2])
        e = contract(a, b, la, lb, out, precision=precision)
    if e is not None:
        return e
    return map2([a, b], _matmul_whole)


def _trace(v, offset):
    """``jnp.trace``: integer sums are uint32 for unsigned and int32 for
    signed operands (and bool), summed in int64 and wrapped."""
    d = torch.diagonal(v, offset, 0, 1)
    if d.dtype.is_floating_point or d.dtype.is_complex:
        return d.sum(-1)
    acc = torch.uint32 if dtypes.is_unsigned(d.dtype) else torch.int32
    return d.to(torch.int64).sum(-1).to(acc)


def trace(x, offset: int = 0) -> Expr:
    return map2([as_expr(x)], _trace, fn_kw={"offset": offset})


def _inner_whole(x, y):
    return _contract_whole(torch.inner, x, y)


def inner(a, b) -> Expr:
    """NumPy ``inner``: 1-D operands are a dot; otherwise the last-axis
    contraction."""
    from .contract import _CANON, contract

    a, b = as_expr(a), as_expr(b)
    if a.ndim == 1 and b.ndim == 1:
        return dot(a, b)
    if a.ndim >= 1 and b.ndim >= 1:
        la = tuple(_CANON[i] for i in range(a.ndim - 1)) + ("z",)
        lb = tuple(_CANON[a.ndim - 1 + i]
                   for i in range(b.ndim - 1)) + ("z",)
        e = contract(a, b, la, lb, la[:-1] + lb[:-1])
        if e is not None:
            return e
    return map2([a, b], _inner_whole)


def outer_product(a, b) -> Expr:
    """NumPy ``np.outer``: the flattened outer product (not the tile-pair
    ``outer`` of ``expr/outer.py``)."""
    return map_expr(lambda u, v: u.reshape(-1)[:, None]
                    * v.reshape(-1)[None, :], as_expr(a), as_expr(b))


# -- counting -------------------------------------------------------------


def _bincount_expr_path(v: torch.Tensor, length: int) -> torch.Tensor:
    """``jnp.bincount(v.ravel(), length=length)``, the expr path: negative
    ids count in bucket 0, ids >= length are dropped (a scatter-add into a
    dropped slot keeps the shape static). int32."""
    ids = v.reshape(-1).to(torch.int64).clamp_min(0)
    ids = torch.where(ids < length, ids, length)
    out = torch.zeros((length + 1,), dtype=torch.int32, device=v.device)
    out.scatter_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
    return out[:length]


class BincountExpr(Expr):
    """Counts of ints in ``[0, length)``, the histogram family's
    reduction. When ``kernels.select("bincount")`` picks the kernel it
    runs ``kernels/histogram.py::bincount_sharded`` (the hand-written
    kernel on the card); otherwise the expr path's scatter-add. Negative
    ids count in bucket 0 and ids >= length are dropped on both paths
    (``jnp.bincount`` parity). int32."""

    def __init__(self, x: Expr, length: int):
        self.x = x
        self.length = int(length)
        super().__init__((self.length,), np.int32)

    def children(self):
        return (self.x,)

    def replace_children(self, new_children) -> "BincountExpr":
        return BincountExpr(new_children[0], self.length)

    def _lower(self, env) -> Any:
        from ..kernels import registry as kernels_mod

        v = self.x.lower(env)
        if kernels_mod.node_selection(self).native:
            from ..kernels import histogram as khist

            return khist.bincount_sharded(v.reshape(-1), self.length)
        return _bincount_expr_path(v, self.length)

    def _sig(self, ctx):
        return ("bincount", self.length, ctx.of(self.x))

    def _default_tiling(self):
        from ..array import tiling as tiling_mod

        return tiling_mod.replicated(1)


def bincount(x, minlength: Optional[int] = None,
             length: Optional[int] = None) -> Expr:
    """Counts of nonnegative ints. A static ``length``/``minlength`` keeps
    the output shape static; it defaults to ``x.max() + 1``, computed
    eagerly."""
    x = as_expr(x)
    n = length or minlength
    if n is None:
        n = int(max(x).glom()) + 1
    return BincountExpr(x, n)


def count_nonzero(x) -> Expr:
    x = as_expr(x)
    return sum(astype(x != 0, np.int32))


def count_zero(x) -> Expr:
    x = as_expr(x)
    return sum(astype(x == 0, np.int32))


def size(x) -> int:
    return as_expr(x).size


# -- sorting -------------------------------------------------------------


class SampleSortExpr(Expr):
    """Distributed sample sort over the logical row shards
    (``ops/sort.py``): local sort, splitter samples, bucket exchange
    (packed by the ``partition_pack`` kernel when selected), local merge,
    rebalance to even shards. Any length (a validity channel carries
    ragged tails); N-d arrays sort along ``axis`` with every other
    position a row of the same program. With ``indices=True`` it is the
    distributed argsort (source indices ride as a payload)."""

    def __init__(self, x: Expr, indices: bool = False, axis: int = -1):
        self.x = x
        self.indices = indices
        self.axis = _checked_axis(axis, x.ndim)
        super().__init__(x.shape, np.int32 if indices else x.dtype)

    def children(self):
        return (self.x,)

    def replace_children(self, new_children) -> "SampleSortExpr":
        return SampleSortExpr(new_children[0], self.indices, self.axis)

    def _moved_in_tiling(self):
        """The operand's tiling with the sort axis moved last (what the
        lowering's movedim produces)."""
        from ..array.tiling import Tiling

        axes = list(self.x.out_tiling().axes)
        axes.append(axes.pop(self.axis))
        return Tiling(axes)

    def _lower(self, env) -> Any:
        # uint16/uint32 keys sort as int64 (same order, exact values)
        return dtypes.call(self._sort, self.x.lower(env))

    def _sort(self, v: torch.Tensor) -> torch.Tensor:
        from ..ops import sort as sort_ops

        if self.x.ndim <= 1:
            fn = (sort_ops.sample_argsort if self.indices
                  else sort_ops.sample_sort)
            return fn(v)
        last = self.x.ndim - 1
        if self.axis != last:
            v = torch.movedim(v, self.axis, last)
        out = sort_ops.sample_sort_axis(v, with_indices=self.indices,
                                        in_tiling=self._moved_in_tiling())
        if self.axis != last:
            out = torch.movedim(out, last, self.axis)
        return out

    def _sig(self, ctx):
        return ("sample_sort", self.indices, self.axis, ctx.of(self.x))

    def _default_tiling(self):
        from ..array import tiling as tiling_mod
        from ..ops import sort as sort_ops

        if self.ndim <= 1:
            return tiling_mod.row(1)
        # batch axes keep the operand's placements; the sort axis comes
        # back on the collective axis (the helpers _run uses)
        moved = self._moved_in_tiling()
        name = sort_ops.collective_axis(moved)
        axes = list(sort_ops.batch_axes(moved, name, self.ndim))
        axes.insert(self.axis, name)
        return tiling_mod.Tiling(axes)


def _checked_axis(axis: int, ndim: int) -> int:
    nd = ndim if ndim else 1
    if not -nd <= axis < nd:
        raise ValueError(
            f"sort axis {axis} out of range for ndim {ndim}")
    return axis % nd


def _distributed_sortable(x: Expr, axis: int) -> bool:
    """True when the sample sort replaces the local sort: a row axis of
    more than one logical shard, and (for N-d operands) the sort axis
    tiled."""
    from ..array import tiling as tiling_mod
    from ..parallel import mesh as mesh_mod

    p = int(mesh_mod.get_mesh().shape.get(tiling_mod.AXIS_ROW, 1))
    if p <= 1 or x.ndim == 0 or x.size == 0:
        return False
    if x.ndim == 1:
        return True
    return x.out_tiling().axes[axis % x.ndim] is not None


def sort(x, axis: int = -1) -> Expr:
    """Sorted copy along an axis (``lax.sort`` order: NaN last, stable).
    Arrays tiled along the sort axis on a mesh of more than one row shard
    run the sample sort; everything else is a local stable sort. Masked
    operands sort valid-first, masked-last (``numpy.ma``)."""
    from ..array.masked import MaskedDistArray, masked_sort

    if isinstance(x, MaskedDistArray):
        return masked_sort(x, axis=axis)
    x = as_expr(x)
    ax = _checked_axis(axis, x.ndim)
    if _distributed_sortable(x, ax):
        return SampleSortExpr(x, axis=ax)
    from ..ops.sort import stable_argsort

    return map_expr(lambda v: dtypes.call(
        lambda w: w.gather(ax, stable_argsort(w, ax)), v), x)


def argsort(x, axis: int = -1) -> Expr:
    """int32 indices that sort ``x`` (stable); arrays tiled along the
    sort axis run the distributed sample argsort (see :func:`sort`).
    Masked operands order valid elements first (``numpy.ma``)."""
    from ..array.masked import MaskedDistArray, masked_argsort

    if isinstance(x, MaskedDistArray):
        return masked_argsort(x, axis=axis)
    x = as_expr(x)
    ax = _checked_axis(axis, x.ndim)
    if _distributed_sortable(x, ax):
        return SampleSortExpr(x, indices=True, axis=ax)
    from ..ops.sort import stable_argsort

    return map_expr(lambda v: stable_argsort(v, ax).to(torch.int32), x)


# -- order statistics -------------------------------------------------------


def _float_result(dtype) -> np.dtype:
    """``jnp.result_type(dtype, float32)`` with 64-bit types off."""
    return np.dtype(np.float64 if np.dtype(dtype) == np.float64
                    else np.float32)


def _nan_poison(x: Expr, rdt, axis=None) -> Any:
    """0 when ``x`` is NaN-free, NaN otherwise (per slice of ``axis``),
    added to the distributed order statistics so they propagate NaN like
    the local path. Counts NaNs only, so inf never poisons."""
    if not np.issubdtype(np.dtype(rdt), np.floating) or \
            not np.issubdtype(np.dtype(x.dtype), np.floating):
        return 0.0
    cnt = sum(map_expr(lambda v: torch.isnan(v).to(torch.float32), x),
              axis=axis)
    tdt = dtypes.to_torch(rdt)
    return map_expr(
        lambda c: torch.where(c > 0, float("nan"), 0.0).to(tdt), cnt)


def _axis_order_stat_path(x: Expr, axis) -> Any:
    """The normalized axis when an order statistic along ``axis`` should
    ride the sample sort (the operand tiled along it), else None."""
    if x.ndim == 0 or x.size == 0:
        return None
    if x.ndim == 1:
        if axis not in (None, 0, -1):
            return None
        return 0 if _distributed_sortable(x, 0) else None
    if axis is None or not isinstance(axis, (int, np.integer)):
        return None
    ax = _checked_axis(int(axis), x.ndim)
    return ax if _distributed_sortable(x, ax) else None


def _order_stat_interp(x: Expr, ax: int, positions, rdt):
    """Linearly interpolated order statistics of ``x`` along ``ax`` at
    fractional ``positions``, read off one sample sort; each drops
    ``ax``. Operands are promoted to ``rdt`` before combining."""
    n = x.shape[ax]
    s = SampleSortExpr(x, axis=ax)
    pre = (slice(None),) * ax
    outs = []
    for pos in positions:
        lo = int(np.floor(pos))
        hi = lo + 1 if lo + 1 <= n - 1 else n - 1
        fr = float(pos - lo)
        outs.append((1.0 - fr) * astype(s[pre + (lo,)], rdt)
                    + fr * astype(s[pre + (hi,)], rdt))
    return outs


def _quantile_local(v: torch.Tensor, q, axis) -> torch.Tensor:
    """``jnp.percentile``/``jnp.median`` on one tensor (linear
    interpolation, NaN propagates), in ``jnp``'s result type: a float16
    or bfloat16 operand keeps its type (interpolated in float32)."""
    rdt = dtypes.to_torch(_float_result(dtypes.to_numpy(v.dtype)))
    if v.dtype in (torch.float16, torch.bfloat16):
        qt = torch.tensor(q, dtype=rdt, device=v.device)
        return torch.quantile(v.to(rdt), qt, dim=axis).to(v.dtype)
    qt = torch.tensor(q, dtype=rdt, device=v.device)
    return torch.quantile(v.to(rdt), qt, dim=axis)


def median(x, axis=None) -> Expr:
    """Median; operands tiled along the reduction axis ride the sample
    sort (two order statistics of the sorted result). Masked operands
    take the median of the unmasked elements (fully masked slices NaN)."""
    from ..array.masked import MaskedDistArray, masked_median

    if isinstance(x, MaskedDistArray):
        return masked_median(x, axis=axis)
    x = as_expr(x)
    ax = _axis_order_stat_path(x, axis)
    if ax is not None:
        rdt = _float_result(x.dtype)
        n = x.shape[ax]
        (out,) = _order_stat_interp(x, ax, [(n - 1) / 2.0], rdt)
        return out + _nan_poison(x, rdt, axis=ax)
    return map_expr(lambda v: _quantile_local(v, 0.5, axis), x)


def percentile(x, q, axis=None) -> Expr:
    """Percentile (linear interpolation), scalar or 1-D ``q``; the 1-D
    tiled case reads every quantile off one sample sort."""
    x = as_expr(x)
    scalar_q = np.ndim(q) == 0
    qa = np.atleast_1d(np.asarray(q, dtype=np.float64))
    if qa.ndim != 1:
        raise NotImplementedError(
            "spartan_tpu_torch.percentile supports scalar or 1-D q only; "
            f"got q with shape {qa.shape}")
    if qa.size == 0 or np.any(qa < 0.0) or np.any(qa > 100.0) or \
            np.any(np.isnan(qa)):
        raise ValueError(f"percentile q={q} outside [0, 100]")
    ax = _axis_order_stat_path(x, axis)
    if ax is not None and scalar_q:
        rdt = _float_result(x.dtype)
        n = x.shape[ax]
        (out,) = _order_stat_interp(
            x, ax, [float(qa[0]) / 100.0 * (n - 1)], rdt)
        return out + _nan_poison(x, rdt, axis=ax)
    if ax is not None and x.ndim == 1:
        n = x.shape[0]
        rdt = _float_result(x.dtype)
        pos = qa / 100.0 * (n - 1)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, n - 1)
        frac = pos - lo
        s = SampleSortExpr(x)
        w = as_expr(frac.astype(np.float64))
        out = (1.0 - w) * astype(take(s, lo), rdt) \
            + w * astype(take(s, hi), rdt)
        return astype(out, rdt) + _nan_poison(x, rdt)
    qq = float(qa[0]) / 100.0 if scalar_q else tuple((qa / 100.0).tolist())
    return map_expr(lambda v: _quantile_local(v, qq, axis), x)


def quantile(x, q, axis=None) -> Expr:
    """``np.quantile``: :func:`percentile` with q in [0, 1]."""
    qa = np.asarray(q, dtype=np.float64)
    if qa.size and (np.any(qa < 0.0) or np.any(qa > 1.0)):
        raise ValueError(f"quantile q={q} outside [0, 1]")
    return percentile(x, qa * 100.0 if np.ndim(q) else float(qa) * 100.0,
                      axis=axis)


# -- top-k -----------------------------------------------------------------


class TopKExpr(Expr):
    """INDICES of the distributed top-k (``ops/sort.py``
    distributed_topk): each logical shard's candidates (the
    ``shard_topk`` kernel when selected), their gather and a final top-k.
    Values are a k-element gather on top (:func:`topk`)."""

    def __init__(self, x: Expr, k: int, largest: bool):
        self.x = x
        self.k = int(k)
        self.largest = bool(largest)
        super().__init__((self.k,), np.dtype(np.int32))

    def children(self):
        return (self.x,)

    def replace_children(self, new_children) -> "TopKExpr":
        return TopKExpr(new_children[0], self.k, self.largest)

    def _lower(self, env) -> Any:
        from ..ops.sort import distributed_topk

        return distributed_topk(dtypes.widen(self.x.lower(env)), self.k,
                                largest=self.largest)[1]

    def _sig(self, ctx):
        return ("topk", self.k, self.largest, ctx.of(self.x))

    def _default_tiling(self):
        from ..array import tiling as tiling_mod

        return tiling_mod.replicated(1)


def topk(x, k: int, largest: bool = True):
    """(values, int32 indices) of the k largest (or smallest) elements of
    a 1-D array, best first, ties to the lowest index (``lax.top_k``). On
    a mesh of p > 1 row shards with ``k <= ceil(n / p)`` each shard's k
    candidates are merged; a bigger k slices the sample argsort."""
    from ..array import tiling as tiling_mod
    from ..parallel import mesh as mesh_mod

    x = as_expr(x)
    if x.ndim != 1:
        raise ValueError(f"topk needs a 1-D operand, got {x.shape}")
    k = int(k)
    n = x.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"topk needs 1 <= k <= {n}, got {k}")
    p = int(mesh_mod.get_mesh().shape.get(tiling_mod.AXIS_ROW, 1))
    if p > 1 and k > -(-n // p):
        si = SampleSortExpr(x, indices=True)
        if largest:
            idx = map_expr(lambda v: v.flip(0), si[n - k:])
        else:
            idx = si[:k]
    else:
        idx = TopKExpr(x, k, largest)
    vals = map_expr(lambda v, i: dtypes.call(
        lambda w: w[i.to(torch.int64)], v), x, idx)
    return vals, idx


# -- histogram ---------------------------------------------------------------


def _hist_edges(lo, hi, bins: int, device=None) -> torch.Tensor:
    """The bin edges, ``jnp.linspace(lo, hi, bins + 1)``'s formula in
    f32: ``lo * (1 - i / bins) + hi * (i / bins)``, the last edge pinned
    to ``hi``. Both the bucketing maps and the returned edges evaluate
    it, so counts never disagree with the edges the caller receives."""
    lo = torch.as_tensor(lo, dtype=torch.float32, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=device)
    step = (torch.arange(bins, dtype=torch.float32, device=lo.device)
            / torch.tensor(float(bins), dtype=torch.float32,
                           device=lo.device))
    return torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])


def _edges_device(z: torch.Tensor) -> torch.device:
    """Where edges computed from no array input live: the mesh's device
    (``meta`` while the plan infers shapes)."""
    from ..parallel import mesh as mesh_mod

    return z.device if z.device.type == "meta" else \
        mesh_mod.get_mesh().device


def _hist_expand(lo: torch.Tensor, hi: torch.Tensor):
    """np.histogram's degenerate-range rule: all-equal data spans
    value +/- 0.5."""
    return (torch.where(hi > lo, lo, lo - 0.5),
            torch.where(hi > lo, hi, hi + 0.5))


def _search_right(edges: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``jnp.searchsorted(edges, v, side="right")``: compared in
    ``lax.sort`` order, so NaN lies above every edge."""
    from ..ops.sort import sort_key

    return torch.searchsorted(sort_key(edges), sort_key(v), right=True)


def histogram(x, bins: int = 10, range=None):
    """``np.histogram`` with a static bin count: (int32 counts, f32
    edges). Bucketing is a map over the operand and the counting the
    bincount reduction; ``range`` defaults to the operand's (min, max),
    computed in the same plan. With an explicit ``range`` values outside
    it are dropped; a degenerate range or constant data expands by
    +/- 0.5, as numpy does. Non-finite data with ``range=None`` gives
    non-finite edges (numpy raises; the JAX package's guard for this
    runs only under its numerics audit)."""
    x = as_expr(x)
    bins = int(bins)
    if bins <= 0:
        raise ValueError(f"histogram needs bins >= 1, got {bins}")
    if range is not None:
        lo, hi = float(range[0]), float(range[1])
        if not (np.isfinite(lo) and np.isfinite(hi)) or hi < lo:
            raise ValueError(
                f"histogram range {range}: bounds must be finite "
                f"with max >= min")
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
    if x.size == 0:
        lo0, hi0 = (lo, hi) if range is not None else (0.0, 1.0)
        return (zeros((bins,), np.int32),
                as_expr(np.linspace(lo0, hi0, bins + 1).astype(np.float32)))
    if range is not None:
        def bucket(v, lo=lo, hi=hi, bins=bins):
            e = _hist_edges(lo, hi, bins, v.device)
            vv = v.to(torch.float32)
            idx = _search_right(e, vv) - 1
            # np.histogram: the last bin is closed on the right
            idx = torch.where(vv == e[-1], bins - 1, idx)
            oob = (vv < e[0]) | (vv > e[-1])
            return torch.where(oob, bins, idx).to(torch.int32)

        counts = bincount(map_expr(bucket, x), length=bins)
        edges = map2([as_expr(0.0)],
                     lambda _z, lo=lo, hi=hi, bins=bins:
                     _hist_edges(lo, hi, bins, _edges_device(_z)))
        return counts, edges
    from .reduce import max as _rmax
    from .reduce import min as _rmin

    lo_e, hi_e = _rmin(x), _rmax(x)

    def bucket2(v, lo, hi):
        lo, hi = _hist_expand(lo.to(torch.float32), hi.to(torch.float32))
        e = _hist_edges(lo, hi, bins)
        idx = _search_right(e, v.to(torch.float32)) - 1
        return idx.clamp(0, bins - 1).to(torch.int32)

    counts = bincount(map_expr(bucket2, x, lo_e, hi_e), length=bins)

    def edges_fn(lo, hi):
        lo, hi = _hist_expand(lo.to(torch.float32), hi.to(torch.float32))
        return _hist_edges(lo, hi, bins)

    edges = map_expr(edges_fn, lo_e, hi_e)
    return counts, edges


# -- unique ------------------------------------------------------------------


def unique_counts(x, size: int) -> Expr:
    """Counts of each value in [0, size): static-shape unique()."""
    return bincount(x, length=size)


def _scatter_unique(v, r, f, size, fill):
    """Slot ``r`` of the output takes ``v`` where ``f`` marks a new
    value; ranks past ``size`` drop (a dropped slot keeps the shape
    static)."""
    slot = torch.where((f == 1) & (r < size), r.to(torch.int64), size)
    out = torch.full((size + 1,), fill, dtype=v.dtype, device=v.device)
    out.scatter_(0, slot, v)
    return out[:size]


def _new_value_flags(v: torch.Tensor) -> torch.Tensor:
    """1 where a sorted value differs from its predecessor (slot 0
    always); NaNs compare unequal, so each NaN is a value of its own."""
    first = torch.arange(v.shape[0], device=v.device) == 0
    return torch.where(first, 1, (v != torch.roll(v, 1)).to(torch.int32)
                       ).to(torch.int32)


def unique(x, size: int, fill_value=0.0, return_counts: bool = False):
    """Sorted unique values with a static output size (``jnp.unique``'s
    ``size=``: padded with ``fill_value`` past the distinct count,
    distinct values beyond ``size`` dropped). One pipeline: sort (the
    sample sort where the operand is tiled), new-value flags, a prefix
    scan for dense ranks, a scatter into the output; the counts are the
    bincount of the ranks. N-d operands flatten, as np.unique does."""
    x = as_expr(x)
    size = int(size)
    if size <= 0:
        raise ValueError(f"unique needs size >= 1, got {size}")
    if x.ndim != 1:
        x = ravel(x)
    if x.size == 0:
        vals = full((size,), fill_value, x.dtype)
        if not return_counts:
            return vals
        return vals, zeros((size,), np.int32)
    s = sort(x)
    flags = map_expr(_new_value_flags, s)
    rank = cumsum(flags) - 1
    vals = map2([s, rank, flags], _scatter_unique,
                fn_kw={"size": size, "fill": fill_value})
    if not return_counts:
        return vals
    return vals, bincount(rank, length=size)


# -- creation and gathers ------------------------------------------------------


def linspace(start, stop, num=50, endpoint=True, dtype=np.float32,
             tile_hint=None, tiling=None) -> Expr:
    return CreateExpr((int(num),), dtype, "linspace",
                      (float(start), float(stop), int(num), bool(endpoint)),
                      tiling, tile_hint)


def take(x, indices, axis=None) -> Expr:
    """Gather elements by integer index (NumPy ``take``). Indices enter
    the DAG as an input, and out-of-range indices raise up front."""
    x = as_expr(x)
    idx_np = np.asarray(indices)
    if axis is not None and x.ndim == 0:
        raise ValueError(
            f"take axis {axis} out of range for a 0-d operand")
    ax = None if axis is None else _checked_axis(int(axis), x.ndim)
    bound = x.size if ax is None else x.shape[ax]
    if idx_np.size and (idx_np.min() < -bound or idx_np.max() >= bound):
        raise IndexError(
            f"take indices out of bounds for axis size {bound}: "
            f"range [{idx_np.min()}, {idx_np.max()}]")

    def gather(v, i):
        i = i.to(torch.int64)
        if ax is None:
            flat = v.reshape(-1)
            return flat[torch.where(i < 0, i + flat.numel(), i)]
        i = torch.where(i < 0, i + v.shape[ax], i)
        return torch.index_select(v, ax, i.reshape(-1)).reshape(
            v.shape[:ax] + i.shape + v.shape[ax + 1:])

    return map_expr(gather, x, as_expr(idx_np))


# -- prefix scans ----------------------------------------------------------


class BlockedScanExpr(Expr):
    """Prefix scan over the tiled leading axis (``ops/scan.py``): a local
    scan per logical shard, then each shard combined with the exclusive
    scan of the shards' totals."""

    def __init__(self, x: Expr, op: str):
        self.x = x
        self.op = op
        super().__init__(x.shape, x.dtype)

    def children(self):
        return (self.x,)

    def replace_children(self, new_children) -> "BlockedScanExpr":
        return BlockedScanExpr(new_children[0], self.op)

    def _lower(self, env) -> Any:
        from ..ops import scan as scan_ops

        return scan_ops.blocked_scan(self.x.lower(env), self.op,
                                     in_axes=self.x.out_tiling().axes)

    def _sig(self, ctx):
        return ("blocked_scan", self.op, self.x.out_tiling().axes,
                ctx.of(self.x))

    def _default_tiling(self):
        from ..array import tiling as tiling_mod
        from ..ops import scan as scan_ops

        t = scan_ops.scan_axes(self.x.out_tiling().axes, self.ndim)
        return tiling_mod.sanitize(t, self.shape)


def _blocked_scannable(x: Expr, axis: int, op: str) -> bool:
    """The blocked scan's guard: the leading axis, a length that splits
    into the row shards, a dtype the cumulative op preserves, and not a
    layout whose axis 0 is local while another axis is tiled."""
    from ..array import tiling as tiling_mod
    from ..ops import scan as scan_ops
    from ..parallel import mesh as mesh_mod

    if x.ndim < 1 or axis not in (0, -x.ndim):
        return False
    p = int(mesh_mod.get_mesh().shape.get(tiling_mod.AXIS_ROW, 1))
    if p <= 1 or x.shape[0] == 0 or x.shape[0] % p != 0:
        return False
    probe = torch.empty(x.shape, dtype=dtypes.to_torch(x.dtype),
                        device="meta")
    if scan_ops._LOCAL[op](probe, 0).dtype != probe.dtype:
        return False
    t = x.out_tiling()
    if x.ndim >= 2 and t.axes[0] is None and t.sharded_axes():
        return False
    return True


def scan(x, axis: Optional[int] = 0, op: str = "add") -> Expr:
    """Prefix scan along an axis: the blocked scan along a tiled leading
    axis, the local cumulative op otherwise; ``axis=None`` scans the
    flattened array, as ``jnp.cumsum`` does."""
    from ..ops import scan as scan_ops

    x = as_expr(x)
    if op not in scan_ops._LOCAL:
        raise ValueError(f"unknown scan op {op!r}")
    fn = scan_ops._LOCAL[op]
    if axis is None:
        return map_expr(lambda v: fn(v.reshape(-1), 0), x)
    if _blocked_scannable(x, axis, op):
        return BlockedScanExpr(x, op)
    return map_expr(lambda v: fn(v, axis), x)


def cumsum(x, axis: Optional[int] = 0) -> Expr:
    return scan(x, axis=axis, op="add")


def cumprod(x, axis: Optional[int] = 0) -> Expr:
    return scan(x, axis=axis, op="mul")
