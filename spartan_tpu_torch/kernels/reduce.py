"""Fixed-order float32 sums, means and products along axes: the
hand-written CUDA kernel and its plain version. The JAX package has no
Pallas counterpart: it leaves a reduction to XLA
(``spartan_tpu/expr/reduce.py``).

The port adds the kernel for the incremental engine
(``expr/incremental.py``), as it added ``fixed_order_dot``
(``kernels/gemv.py``) for vector products: a reduction restricted to a
window of its kept axes is bit-equal to the whole reduction inside that
window only where each kept element is reduced in the same order in
both, and torch's reduction picks its launch, and its split of a long
reduced axis over blocks, from the shape. Here the order is the
contract, and only R and :data:`KS` shape it. The operand is viewed as
``(P, R, Q)``: P the kept axes before the reduced ones, R the reduced
axes flattened in ascending order, Q the kept axes after them (a reduced
set that is not one run of the layout is moved together first, one
``movedim(...).contiguous()`` copy). Slice ``s`` covers
``r in [s*KS, min(R, (s+1)*KS))``; ``part[s, p, q]`` is a fold over the
slice's r in ascending order that starts from the identity (0.0 for
``sum`` and ``mean``, 1.0 for ``prod``); ``out[p, q]`` is a fold from
the identity over the slices in ascending order. Every add and product
is rounded on its own; ``mean`` is that sum divided once by R. So for
every window of the kept axes ``fixed_order_reduce(x)[window]`` equals
``fixed_order_reduce(x[window])``, and a sum of a matrix along axis 0
equals ``fixed_order_dot(ones(R), x)`` bit for bit, on the card and in
the plain version alike (``1.0 * a`` is exact).

:func:`fixed_order_reduce` launches the reduction entry points of
``spartan_tpu_torch/csrc/gemv.cu`` (the GEMV's pass 1 and fold,
templated on the op; built with ``nvcc`` for ``sm_90a`` at first use,
bound through ``ctypes``) on CUDA tensors, and runs
:func:`fixed_order_reduce_plain` on CPU tensors; any other device raises,
and a build or launch failure raises: nothing falls back to
``torch.sum``. Q >= 2 takes the vector-matrix pass with P in its grid, Q
= 1 the matrix-vector pass with rows = P; a mean is that sum, then one
division by R (:func:`divide`). The operand is read through its strides
where its (P, R, Q) view has a unit stride along Q, or along R where
Q = 1, so a window view of the kept axes is not copied; any other
layout is made contiguous first. The reduction is the torch custom operator
``spartan_tpu_torch::fixed_order_reduce``: on ``meta`` tensors its shape
rule answers, and under ``torch.func.vmap`` its batching rule launches
it once a client.

:func:`routes` says where ``expr/reduce.py`` lowers a reduction through
it: a float32 ``sum``, ``mean`` or ``prod`` along some but not all axes
on the card (an integer mean's float32 cast included). On the CPU the
lowering keeps ``torch.sum``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..utils import dtypes
from . import build as build_mod
from . import gemv

# the reduced axis's slice (csrc/gemv.cu's KS, shared with the GEMV)
KS = gemv.KS

# the ops; the first two in csrc/gemv.cu's ReduceCode order (a mean is a
# sum there)
OPS = ("sum", "prod", "mean")

# Kernel launches so far: the wrapper adds one where it launches the
# CUDA kernel and nowhere else (the plain version does not count).
LAUNCHES: Dict[str, int] = {"fixed_order_reduce": 0}


def _dims(axis: Any, ndim: int) -> Tuple[int, ...]:
    if isinstance(axis, int):
        axis = (axis,)
    return tuple(sorted({int(a) % ndim for a in axis}))


def takes(dtype: Any, op: str, axis: Any, ndim: int) -> bool:
    """True for a reduction the kernel computes: ``op`` one of
    :data:`OPS` along some but not all of ``ndim`` axes of float32 data,
    or a ``mean`` of integer or bool data (reduced in its float32
    cast)."""
    if op not in OPS or axis is None or ndim == 0:
        return False
    if not 0 < len(_dims(axis, ndim)) < ndim:
        return False
    dt = dtypes.to_torch(dtype)
    return dt == torch.float32 or (
        op == "mean" and not (dt.is_floating_point or dt.is_complex))


def routes(device: torch.device, dtype: Any, op: str, axis: Any,
           ndim: int) -> bool:
    """True where ``expr/reduce.py`` lowers the reduction ``op`` over
    ``axis`` of an operand of ``ndim`` axes and ``dtype`` on ``device``
    through :func:`fixed_order_reduce`: :func:`takes` on the card. The
    incremental engine and the memory model ask the same question of a
    reduction's node (``expr/incremental.py::reduce_granule``)."""
    return device.type == "cuda" and takes(dtype, op, axis, ndim)


def out_shape(shape: Sequence[int], dims: Sequence[int],
              keepdim: bool) -> List[int]:
    if keepdim:
        return [1 if d in dims else n for d, n in enumerate(shape)]
    return [n for d, n in enumerate(shape) if d not in dims]


def _gathered(x: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """``x`` with its reduced axes moved together at the first one's
    place (the kept axes keep their order): a view, copied by
    :func:`layout` where it is not one run of the layout."""
    run = tuple(range(dims[0], dims[0] + len(dims)))
    return x if dims == run else x.movedim(dims, run)


def split(shape: Sequence[int], dims: Sequence[int]) -> Tuple[int, int, int]:
    """(P, R, Q) of a reduction of ``shape`` over ``dims``."""
    d0, kept = dims[0], [d for d in range(len(shape)) if d not in dims]
    return (math.prod(shape[d] for d in kept if d < d0),
            math.prod(shape[d] for d in dims),
            math.prod(shape[d] for d in kept if d > d0))


def moves(shape: Sequence[int], dims: Sequence[int]) -> bool:
    """True where the reduced axes of a contiguous operand of ``shape``
    are not one run of its layout (axes of size 1 aside), so
    :func:`layout` copies it: the memory model's question."""
    big = [d for d in range(len(shape)) if shape[d] != 1]
    red = [i for i, d in enumerate(big) if d in dims]
    return bool(red) and red != list(range(red[0], red[0] + len(red)))


def _merged(sizes: Sequence[int], strides: Sequence[int]) -> Optional[int]:
    """The stride of axes merged into one, 0 where they hold one element,
    or None where their strides do not merge (or repeat an element)."""
    live = [(n, s) for n, s in zip(sizes, strides) if n != 1]
    if any(s == 0 for _, s in live):
        return None
    for (_, s0), (n1, s1) in zip(live, live[1:]):
        if s0 != s1 * n1:
            return None
    return live[-1][1] if live else 0


def layout(x: torch.Tensor, dims: Tuple[int, ...]
           ) -> Tuple[str, torch.Tensor, Tuple[int, ...], bool]:
    """The entry point and operand of the reduction of ``x`` over
    ``dims``: ``("outer", a, (sp, sr, P, R, Q), copied)`` for A (P, R, Q)
    with a unit stride along Q, or ``("inner", a, (lda, P, R), copied)``
    for A (P, R) with a unit stride along R; ``copied`` where ``a`` is a
    copy of ``x`` (non-adjacent reduced axes, or a layout neither entry
    point reads)."""
    p, r, q = split(x.shape, dims)
    copied = False
    g = _gathered(x, dims)
    if g is not x and moves(x.shape, dims):
        g, copied = g.contiguous(), True
    for attempt in (0, 1):
        d0, d1 = dims[0], dims[0] + len(dims)
        sp, sr, sq = (_merged(g.shape[a:b], g.stride()[a:b])
                      for a, b in ((0, d0), (d0, d1), (d1, g.ndim)))
        if None not in (sp, sr, sq):
            if q > 1 and sq == 1 and (r == 1 or sr >= q):
                return "outer", g, (sp, sr if r > 1 else q, p, r, q), copied
            if q == 1 and (r == 1 or sr == 1) and (p == 1 or sp >= r):
                return "inner", g, (sp if p > 1 else r, p, r), copied
        if attempt == 0:
            g, copied = g.contiguous(), True
    raise AssertionError("a contiguous operand has a (P, R, Q) layout")


def scratch_shape(shape: Sequence[int], dims: Sequence[int]
                  ) -> Tuple[int, ...]:
    """The slice buffer a launch allocates for a contiguous operand of
    ``shape``, as (S, batches, ceil(columns / 32) * 32) floats, S =
    ceil(R / KS) (the batches P and the columns Q where Q > 1, else one
    batch of P columns); (0,) where S = 1."""
    p, r, q = split(shape, dims)
    s = -(-r // KS)
    if s <= 1:
        return (0,)
    rows, cols = (p, q) if q > 1 else (1, p)
    return (s, rows, -(-cols // 32) * 32)


def scratch_bytes(shape: Sequence[int], dims: Sequence[int]) -> int:
    """The bytes a launch holds beside its operand and output for a
    contiguous operand of ``shape``: the slice buffer, and the moved
    copy of the operand where :func:`moves` holds."""
    extra = 4 * math.prod(scratch_shape(shape, dims))
    if moves(shape, dims):
        extra += 4 * math.prod(shape)
    return extra


def divide(out: torch.Tensor, count: int,
           inplace: bool = False) -> torch.Tensor:
    """A mean's one division of its sum by ``count``, correctly rounded
    (a 0-d tensor on the sum's device: torch computes a CUDA tensor
    divided by a host scalar as a product with its reciprocal); into
    ``out`` where ``inplace``."""
    d = torch.full((), float(count), dtype=out.dtype, device=out.device)
    return out.div_(d) if inplace else out / d


def fixed_order_reduce_plain(x: torch.Tensor, op: str, axis: Any,
                             keepdim: bool = False) -> torch.Tensor:
    """The kernel's order in torch elementwise ops, on any device: a
    (P, S, Q) accumulator takes ``acc = acc op x_slice[:, :, j]`` at each
    of a slice's ``KS`` positions (the last, shorter slice on its own),
    then the slices fold from the identity in order; a mean divides the
    sum once. Every add and product is its own rounded op, so this is the
    kernel's bits."""
    dims = _dims(axis, x.ndim)
    p, r, q = split(x.shape, dims)
    v = _gathered(x, dims).reshape(p, r, q)
    ident = 1.0 if op == "prod" else 0.0
    fn = torch.mul if op == "prod" else torch.add
    full = r // KS
    parts = []
    if full:
        xs = v[:, :full * KS].unflatten(1, (full, KS))
        acc = torch.full((p, full, q), ident, dtype=x.dtype, device=x.device)
        for j in range(KS):
            acc = fn(acc, xs[:, :, j])
        parts.append(acc)
    if r > full * KS:
        acc = torch.full((p, 1, q), ident, dtype=x.dtype, device=x.device)
        for j in range(full * KS, r):
            acc = fn(acc, v[:, j:j + 1])
        parts.append(acc)
    out = torch.full((p, q), ident, dtype=x.dtype, device=x.device)
    for part in parts:
        for row in part.unbind(1):
            out = fn(out, row)
    if op == "mean":
        out = divide(out, r)
    return out.reshape(out_shape(x.shape, dims, keepdim))


def _launch(x: torch.Tensor, op: str, dims: List[int],
            keepdim: bool) -> torch.Tensor:
    dims = tuple(dims)
    shape = out_shape(x.shape, dims, keepdim)
    p, r, q = split(x.shape, dims)
    dev = x.device
    # csrc/gemv.cu's library holds the reduction's entry points
    # (gemv._bind declares them)
    lib = gemv._load()
    with torch.cuda.device(dev):
        if p * q == 0:
            return torch.empty(shape, dtype=x.dtype, device=dev)
        if r == 0:
            out = torch.full(shape, 1.0 if op == "prod" else 0.0,
                             dtype=x.dtype, device=dev)
            return divide(out, 0) if op == "mean" else out
        kind, a, args, _ = layout(x, dims)
        rows, cols = (args[2], args[4]) if kind == "outer" else (1, args[1])
        s = -(-r // KS)
        out = torch.empty((p * q,), dtype=x.dtype, device=dev)
        # the slices' values: a batch's tiles of 32 columns, each S x 32
        # (csrc/gemv.cu)
        part = (torch.empty((rows * -(-cols // 32) * s * 32,),
                            dtype=x.dtype, device=dev) if s > 1 else None)
        pp = part.data_ptr() if part is not None else None
        code = OPS.index("sum" if op == "mean" else op)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "outer":
            err = lib.spartan_reduce_outer(a.data_ptr(), *args, code, pp,
                                           out.data_ptr(), stream)
        else:
            err = lib.spartan_reduce_inner(a.data_ptr(), *args, code, pp,
                                           out.data_ptr(), stream)
    build_mod.check(err, "fixed_order_reduce kernel launch")
    build_mod.count_launch(LAUNCHES, "fixed_order_reduce")
    if op == "mean":
        out = divide(out, r, inplace=True)
    return out.reshape(shape)


# -- the operator and its batching rule ---------------------------------
#
# The reduction is a torch custom operator with a shape rule and a
# batching rule (``build.per_client``: one launch a client); the wrapper
# calls it through ``build.call``.


def _reduce_impl(x: torch.Tensor, op: str, dims: List[int],
                 keepdim: bool) -> torch.Tensor:
    """The CUDA kernel on the card, the plain version on the CPU."""
    if not build_mod.on_card(x, "fixed_order_reduce"):
        return fixed_order_reduce_plain(x, op, dims, keepdim)
    return _launch(x, op, dims, keepdim)


_reduce_op = torch.library.custom_op("spartan_tpu_torch::fixed_order_reduce",
                                     mutates_args=())(_reduce_impl)


@_reduce_op.register_fake
def _reduce_fake(x, op, dims, keepdim):
    return x.new_empty(out_shape(x.shape, dims, keepdim))


_reduce_op.register_vmap(build_mod.per_client(_reduce_op))


def fixed_order_reduce(x: torch.Tensor, op: str, axis: Any,
                       keepdim: bool = False) -> torch.Tensor:
    """The reduction ``op`` (``sum``, ``mean`` or ``prod``) of a float32
    ``x`` over ``axis`` (an int or a tuple of ints), each output element
    reduced in the order the module docstring states. On ``meta`` tensors
    the operator's shape rule answers."""
    if op not in OPS:
        raise ValueError(f"fixed_order_reduce takes {OPS}, not {op!r}")
    if x.dtype != torch.float32:
        raise TypeError(f"fixed_order_reduce takes a float32 operand, not "
                        f"{x.dtype}")
    if x.ndim == 0:
        raise ValueError("fixed_order_reduce takes an operand with axes")
    dims = list(_dims(axis, x.ndim))
    if not dims:
        raise ValueError("fixed_order_reduce takes at least one axis")
    return build_mod.call(_reduce_op, _reduce_impl, x, op, dims,
                          bool(keepdim))
