"""Fixed-order float32 vector products: the hand-written CUDA kernel and
its plain version. The JAX package has no Pallas counterpart: it leaves
a vector product to XLA (``spartan_tpu/expr/dot.py``).

The port adds the kernel for the incremental engine
(``expr/incremental.py``). A product restricted to a window of its
output is bit-equal to the whole product inside that window only where
each output element is summed in the same order in both, and cuBLAS
picks its kernel and its split of the contraction from the output's
width. Here the order is the contract, and only K and :data:`KS` shape
it: the contraction is cut into slices of ``KS`` elements; each slice's
sum is a fold from 0.0 over its k in ascending order, each product and
each sum rounded on its own; the output is a fold from 0.0 over the
slices' sums in ascending order. So ``fixed_order_dot(x, A)[lo:hi]``
equals ``fixed_order_dot(x, A[:, lo:hi])`` bit for bit, and so does a
row window of a matrix-vector product, on the card and in the plain
version alike (the kernel rounds with ``__fmul_rn``/``__fadd_rn``, so it
gives the plain version's bits).

:func:`fixed_order_dot` takes one 1-D and one 2-D float32 operand
(``x @ A`` or ``A @ x``) and launches ``spartan_tpu_torch/csrc/gemv.cu``
on CUDA tensors (built with ``nvcc`` for ``sm_90a`` at first use, bound
through ``ctypes``) or runs :func:`fixed_order_dot_plain` on CPU
tensors; any other device raises, and a build or launch failure raises:
nothing falls back to ``torch.matmul``. The matrix is read through its
strides: a column window ``A[:, lo:hi]`` (vector-matrix) or a row window
``A[lo:hi]`` (matrix-vector) is not copied, and a transposed matrix
takes the other entry point over its base storage (``A.T @ u`` is
``u @ A``); any other layout is made contiguous first. The product is
the torch custom operator ``spartan_tpu_torch::fixed_order_dot``: on
``meta`` tensors its shape rule answers, and under ``torch.func.vmap``
its batching rule launches it once a client.

:func:`routes` says where ``expr/dot.py`` lowers a product through it:
a float32 product of one 1-D and one 2-D operand on the card. On the
CPU the lowering keeps ``torch.matmul``.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple

import torch

from ..utils import dtypes
from . import build as build_mod

# the contraction slice the order is built on (csrc/gemv.cu's KS)
KS = 256

# Kernel launches so far: the wrapper adds one where it launches the
# CUDA kernel and nowhere else (the plain version does not count).
LAUNCHES: Dict[str, int] = {"fixed_order_dot": 0}


def takes(a: Any, b: Any, dtype: Any) -> bool:
    """True for a product with a float32 result of one 1-D and one 2-D
    operand (``a`` and ``b`` need only ``ndim``): the shapes the kernel
    computes."""
    return (sorted((a.ndim, b.ndim)) == [1, 2]
            and dtypes.to_torch(dtype) == torch.float32)


def routes(a: Any, b: Any, dtype: Any) -> bool:
    """True where ``expr/dot.py`` lowers ``a @ b`` (result ``dtype``)
    through :func:`fixed_order_dot`: :func:`takes` on CUDA operands
    (``a`` and ``b`` need ``ndim`` and ``device``). The incremental
    engine asks the same question of a product's node
    (``expr/incremental.py::product_granule``)."""
    return (a.device.type == "cuda" and b.device.type == "cuda"
            and takes(a, b, dtype))


def _vector_matrix(a: torch.Tensor, b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``a @ b`` as ``x @ B``: the vector and a (K, M) view of the
    matrix (``A.T`` of a matrix-vector product, not copied)."""
    return (a, b) if a.ndim == 1 else (b, a.t())


def fixed_order_dot_plain(a: torch.Tensor, b: torch.Tensor
                          ) -> torch.Tensor:
    """The kernel's order in torch elementwise ops, on any device: an
    (S, M) accumulator takes ``acc = acc + x_slice * B_slice`` at each
    of a slice's ``KS`` positions (the last, shorter slice on its own),
    then the slices fold from 0.0 in order. Every product and sum is
    its own rounded op, so this is the kernel's bits."""
    x, bmat = _vector_matrix(a, b)
    k, m = bmat.shape
    full = k // KS
    parts = []
    if full:
        xs = x[:full * KS].reshape(full, KS)
        bs = bmat[:full * KS].unflatten(0, (full, KS))
        acc = torch.zeros((full, m), dtype=bmat.dtype, device=bmat.device)
        for j in range(KS):
            acc = acc + xs[:, j:j + 1] * bs[:, j]
        parts.append(acc)
    if k > full * KS:
        acc = torch.zeros((1, m), dtype=bmat.dtype, device=bmat.device)
        for j in range(full * KS, k):
            acc = acc + x[j] * bmat[j:j + 1]
        parts.append(acc)
    out = torch.zeros((m,), dtype=bmat.dtype, device=bmat.device)
    for part in parts:
        for row in part:
            out = out + row
    return out


def _bind(lib: ctypes.CDLL) -> None:
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.spartan_gemv_slice.argtypes = []
    lib.spartan_gemv_slice.restype = ctypes.c_int
    lib.spartan_vecmat.argtypes = [vp, vp, i64, i64, i64, vp, vp, vp]
    lib.spartan_vecmat.restype = ctypes.c_int
    lib.spartan_matvec.argtypes = [vp, i64, vp, i64, i64, vp, vp, vp]
    lib.spartan_matvec.restype = ctypes.c_int
    # the reduction's entry points (kernels/reduce.py) share the library
    i32 = ctypes.c_int
    lib.spartan_reduce_outer.argtypes = [vp, i64, i64, i64, i64, i64, i32,
                                         vp, vp, vp]
    lib.spartan_reduce_outer.restype = ctypes.c_int
    lib.spartan_reduce_inner.argtypes = [vp, i64, i64, i64, i32, vp, vp, vp]
    lib.spartan_reduce_inner.restype = ctypes.c_int
    if lib.spartan_gemv_slice() != KS:
        raise RuntimeError(f"csrc/gemv.cu slices the contraction by "
                           f"{lib.spartan_gemv_slice()}, kernels/gemv.py "
                           f"by {KS}")


def _load() -> ctypes.CDLL:
    """``csrc/gemv.cu``, built with nvcc for sm_90a at first use."""
    return build_mod.load("gemv", _bind)


def layout(a: torch.Tensor, b: torch.Tensor
           ) -> Tuple[str, torch.Tensor, torch.Tensor, int]:
    """The entry point and operands of ``a @ b``: ``("vecmat", x, A,
    lda)`` for ``x (K,) @ A (K, M)`` or ``("matvec", A, x, lda)`` for
    ``A (M, K) @ x (K,)``, where A's last stride is 1 and its rows lie
    ``lda`` elements apart. A window view keeps its storage; a
    transposed matrix maps onto the other entry point over its base; any
    other layout is copied contiguous."""
    x, bmat = _vector_matrix(a, b)
    k, m = bmat.shape
    if bmat.stride(1) == 1 and bmat.stride(0) >= m:
        return "vecmat", x, bmat, bmat.stride(0)
    if bmat.stride(0) == 1 and bmat.stride(1) >= k:
        return "matvec", bmat.t(), x, bmat.stride(1)
    return "vecmat", x, bmat.contiguous(), m


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    kind, first, second, lda = layout(a, b)
    mat, vec = (second, first) if kind == "vecmat" else (first, second)
    vec = vec.contiguous()
    k = vec.shape[0]
    m = mat.shape[1] if kind == "vecmat" else mat.shape[0]
    dev = mat.device
    lib = _load()
    with torch.cuda.device(dev):
        if k == 0 or m == 0:
            return torch.zeros((m,), dtype=mat.dtype, device=dev)
        out = torch.empty((m,), dtype=mat.dtype, device=dev)
        s = -(-k // KS)
        # the slices' sums, tiled by 32 columns (csrc/gemv.cu)
        part = (torch.empty((-(-m // 32), s, 32), dtype=mat.dtype,
                            device=dev) if s > 1 else None)
        pp = part.data_ptr() if part is not None else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "vecmat":
            err = lib.spartan_vecmat(vec.data_ptr(), mat.data_ptr(), lda, k,
                                     m, pp, out.data_ptr(), stream)
        else:
            err = lib.spartan_matvec(mat.data_ptr(), lda, vec.data_ptr(), k,
                                     m, pp, out.data_ptr(), stream)
    build_mod.check(err, "fixed_order_dot kernel launch")
    build_mod.count_launch(LAUNCHES, "fixed_order_dot")
    return out


# -- the operator and its batching rule ---------------------------------
#
# The product is a torch custom operator with a shape rule and a batching
# rule (``build.per_client``: one launch a client; the matrix usually
# shared); the wrapper calls it through ``build.call``.


def _dot_impl(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on the card, the plain version on the CPU."""
    if not build_mod.on_card(a, "fixed_order_dot"):
        return fixed_order_dot_plain(a, b)
    return _launch(a, b)


_dot_op = torch.library.custom_op("spartan_tpu_torch::fixed_order_dot",
                                  mutates_args=())(_dot_impl)


@_dot_op.register_fake
def _dot_fake(a, b):
    return a.new_empty((b.shape[1] if a.ndim == 1 else a.shape[0],))


_dot_op.register_vmap(build_mod.per_client(_dot_op))


def fixed_order_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of one 1-D and one 2-D float32 operand, each output
    element summed in the order the module docstring states. On ``meta``
    tensors the operator's shape rule answers."""
    if sorted((a.ndim, b.ndim)) != [1, 2] or a.shape[-1] != b.shape[0]:
        raise ValueError(f"fixed_order_dot takes x (K,) @ A (K, M) or "
                         f"A (M, K) @ x (K,), not {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"fixed_order_dot takes float32 operands, not "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError("fixed_order_dot's operands must be on one device")
    return build_mod.call(_dot_op, _dot_impl, a, b)
