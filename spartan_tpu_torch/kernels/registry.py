"""Kernel selection policy (port of ``spartan_tpu/kernels/registry.py``).

``select(op, ...)`` decides, from flags and static shapes only, whether
an op runs through its hand-written kernel module (``native``) or the
expr path (``expr``), with the reason for every fallback.
``FLAGS.native_kernels``: ``auto`` and ``on`` pick the kernel module
whenever its constraints hold — the module then launches the CUDA
kernel for CUDA tensors and its plain torch version for CPU tensors;
``off`` keeps the expr path. Ops listed in ``_MEASURED_OFF`` keep their
library path under ``auto`` as in the JAX package, and ``force=True``
(an explicit ``impl=``) skips the flag and that table but never the
constraint checks. A CUDA kernel computes its own offsets, so the JAX
package's TPU lane/sublane grid derivation (``derive``) is carried only
as far as a constraint reads it (the segment rule's entry block, the
empty-operand check of the 1-D rules).

The sort/select rules (``topk``, ``bincount``, ``sort_exchange``) make
the JAX package's decision on every check but one: the TPU's working-set
budget. The TPU kernels of bincount and the sort exchange keep a whole
shard's ids or keys resident in VMEM, so the JAX package refuses them
past ~2M ids per shard (and bincount past ~2,000 buckets for int32 ids);
the CUDA kernels stream from device memory and have their own, looser
limits (``cuda_limits`` of each kernel module), which replace that
budget. Everywhere else the decision, and under ``force`` or ``on`` the
reason, are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..array import tiling as tiling_mod
from ..parallel import mesh as mesh_mod
from ..utils.config import FLAGS

LANE = 128
# the JAX package's per-kernel working-set budget, kept by the k-means
# and segment rules so that no shape their TPU kernels reject is taken
# here; the sort/select rules replace it (module docstring)
VMEM_BUDGET = 8 * 1024 * 1024


def mode() -> str:
    """Resolved backend family: ``native`` or ``expr``."""
    return "expr" if FLAGS.native_kernels == "off" else "native"


def policy_key() -> Tuple:
    """The kernel-policy component of the plan cache key: a plan built
    for the kernel path must never alias its expr-path twin."""
    return (mode(),)


@dataclasses.dataclass(frozen=True)
class Selection:
    """One selection decision: which path runs this op here."""

    op: str
    backend: str                     # "native" | "expr"
    reason: str

    @property
    def native(self) -> bool:
        return self.backend == "native"


def _fallback(op: str, reason: str) -> Selection:
    return Selection(op, "expr", reason)


# Ops whose kernel the JAX package measured slower than the library op
# on its own chip keep the library op under ``auto``, here as there,
# until a measurement on the card settles it. ``native_kernels=on`` and
# ``force`` still select them.
_MEASURED_OFF: Dict[str, str] = {
    "segment_sum": (
        "kept on the library scatter under native_kernels=auto, as in the "
        "JAX package, whose kernel measured slower than its scatter on "
        "its own chip; the card's A/B (chip_smoke.py [segment]) has not "
        "changed this policy. Select the kernel with segment_impl=pallas "
        "or native_kernels=on"),
}


def _sel_kmeans(shape, dtype, tiling, mesh, params) -> Selection:
    op = "kmeans"
    n, d = shape
    k = int(params["k"])
    if np.dtype(dtype) != np.float32:
        return _fallback(op, f"dtype {np.dtype(dtype)} != float32")
    if d % LANE:
        return _fallback(op, f"d {d} not a multiple of 128")
    if k > LANE:
        return _fallback(op, f"k {k} > 128 padded centers")
    p = _row_shards(mesh)
    if n % p:
        return _fallback(op, f"n {n} not divisible by {p} shards")
    block = int(params.get("block", 1024))
    if (n // max(p, 1)) % block:
        return _fallback(op, f"shard rows {n // max(p, 1)} not a "
                             f"multiple of the {block} point block")
    need = 4 * (block * d + 2 * LANE * d + 2 * LANE)
    if need > VMEM_BUDGET:
        return _fallback(op, f"point block working set {need}B > VMEM "
                             f"budget {VMEM_BUDGET}B")
    # the CUDA kernel's own limits (kernels/kmeans.py)
    from . import kmeans as kmeans_kernel

    why = kmeans_kernel.cuda_limits(d, k)
    if why:
        return _fallback(op, why)
    return Selection(op, "native", "selected")


def _sel_segment(shape, dtype, tiling, mesh, params) -> Selection:
    """The JAX package's ``_sel_segment``: the same decision for every
    shape, dtype and mesh shape."""
    op = "segment_sum"
    k = int(params["num_segments"])
    if np.dtype(dtype) != np.float32:
        return _fallback(op, f"vals dtype {np.dtype(dtype)} != float32")
    if len(shape) not in (1, 2):
        return _fallback(op, "only 1-D/2-D value streams")
    d = shape[1] if len(shape) == 2 else 1
    p = _row_shards(mesh)
    n_pad = -(-shape[0] // p) * p
    if n_pad == 0 or d == 0:
        return _fallback(op, "empty operand")
    # the JAX package's derive() for this row-tiled f32 stream: a 1-D
    # shard is lifted to (ceil(rows / 128), 128) and its block counts
    # 128 entries a row; a block is min(512, shard rows) rows, rounded
    # up to the f32 sublane quantum 8
    rows = n_pad // p
    lifted = len(shape) == 1
    if lifted:
        rows = -(-rows // LANE)
    brows = -(-min(512, rows) // 8) * 8
    be = brows * LANE if lifted else brows
    k_pad = -(-k // 8) * 8
    d_pad = -(-d // LANE) * LANE
    need = 4 * (be * k_pad + k_pad * d_pad + be * d_pad)
    if need > VMEM_BUDGET:
        return _fallback(op, f"one-hot working set {need}B > VMEM "
                             f"budget {VMEM_BUDGET}B")
    # the CUDA kernel's own limit (kernels/segment.py); the budget above
    # already keeps k far below it
    from . import segment as segment_kernel

    why = segment_kernel.cuda_limits(k)
    if why:
        return _fallback(op, why)
    return Selection(op, "native", "selected")


def _row_shards(mesh) -> int:
    """The collective size of a kernel's row-axis merge (the JAX
    package's ``_collective_size``): the mesh's row-axis positions —
    logical shards on a logical mesh, the ranks along the row axis on a
    group mesh, where each rank runs the kernel on its own shard."""
    return max(int(mesh.shape.get(tiling_mod.AXIS_ROW, 1)), 1)


def _derive_1d(n: int, mesh) -> str:
    """Why the JAX package's ``derive`` cannot cover a row-tiled stream of
    ``n`` elements, or "": it must be nonempty and split into the mesh's
    row shards."""
    if n == 0:
        return "empty operand"
    if n % _row_shards(mesh):
        return (f"tiling {tiling_mod.row(1).axes} does not divide shape "
                f"{(n,)} over mesh {dict(mesh.shape)}")
    return ""


def _sel_bincount(shape, dtype, tiling, mesh, params) -> Selection:
    op = "bincount"
    length = int(params["length"])
    if len(shape) != 1:
        return _fallback(op, "only 1-D operands (ravel falls back)")
    if not np.issubdtype(np.dtype(dtype), np.integer):
        return _fallback(op, f"ids dtype {np.dtype(dtype)} not integral")
    if length > 4096:
        return _fallback(op, f"length {length} > 4096 (one-hot block "
                             "exceeds the VMEM budget)")
    p = _row_shards(mesh)
    n_pad = -(-shape[0] // p) * p
    why = _derive_1d(n_pad, mesh)
    if why:
        return _fallback(op, why)
    # in place of the TPU's one-hot working-set budget: the CUDA
    # kernel's own limits (kernels/histogram.py)
    from . import histogram as histogram_kernel

    why = histogram_kernel.cuda_limits(length, n_pad)
    if why:
        return _fallback(op, why)
    return Selection(op, "native", "selected")


def _sel_topk(shape, dtype, tiling, mesh, params) -> Selection:
    op = "topk"
    k = int(params["k"])
    if len(shape) != 1:
        return _fallback(op, "only 1-D operands")
    if np.dtype(dtype).itemsize != 4:
        return _fallback(op, f"dtype {np.dtype(dtype)} is not 4-byte "
                             "(extraction keys are f32/i32 lanes)")
    if k > LANE:
        return _fallback(op, f"k {k} > 128 (candidate row exceeds one "
                             "lane tile; the sample argsort handles it)")
    p = _row_shards(mesh)
    m = -(-shape[0] // p)
    why = _derive_1d(m * p, mesh)
    if why:
        return _fallback(op, why)
    from . import topk as topk_kernel

    why = topk_kernel.cuda_limits(dtype, m, k)
    if why:
        return _fallback(op, why)
    return Selection(op, "native", "selected")


def _sel_exchange(shape, dtype, tiling, mesh, params) -> Selection:
    op = "sort_exchange"
    m = int(params["m"])
    p = int(params["p"])
    if p < 2:
        return _fallback(op, "single shard: no exchange to pack")
    if np.dtype(dtype).itemsize != 4:
        return _fallback(op, f"dtype {np.dtype(dtype)} is not 4-byte "
                             "(the exact lane-roll splits 16-bit halves)")
    why = _derive_1d(m * p, mesh)
    if why:
        return _fallback(op, why)
    # in place of the TPU's resident-shard budget: the CUDA kernel's own
    # limits (kernels/exchange.py)
    from . import exchange as exchange_kernel

    why = exchange_kernel.cuda_limits(dtype, m)
    if why:
        return _fallback(op, why)
    return Selection(op, "native", "selected")


def _sel_stencil(shape, dtype, tiling, mesh, params) -> Selection:
    """The JAX package's ``_sel_stencil``, its working-set budget
    included (the VGG-16 widths stay far inside it), then the CUDA
    kernel's own limits."""
    op = "stencil"
    if len(shape) != 4:
        return _fallback(op, "only NHWC operands")
    if np.dtype(dtype) != np.float32:
        return _fallback(op, f"dtype {np.dtype(dtype)} != float32")
    if tuple(params.get("stride", (1, 1))) != (1, 1):
        return _fallback(op, "only stride 1 (strided shards misalign "
                             "with the halo rule)")
    if params.get("padding", "SAME") != "SAME":
        return _fallback(op, "only SAME padding (halo ppermute zeros "
                             "match SAME's zero pad)")
    h_axis = tiling.axes[1]
    if not isinstance(h_axis, str) or int(mesh.shape.get(h_axis, 1)) < 2:
        return _fallback(op, "H axis not mesh-sharded: GSPMD needs no "
                             "halo exchange here")
    if any(a is not None for a in (tiling.axes[2], tiling.axes[3])):
        return _fallback(op, "W/C axes must be unsharded")
    p = int(mesh.shape[h_axis])
    n, h, w, c = shape
    if h % p:
        return _fallback(op, f"H {h} not divisible by {p} shards")
    kh, kw = (int(k) for k in params["kshape"])
    o = int(params["out_channels"])
    hs = h // p
    if hs < kh:
        return _fallback(op, f"shard H {hs} smaller than filter {kh}")
    # the JAX package's derive() over one image's (H, W, C): nonempty
    if w == 0 or c == 0:
        return _fallback(op, "empty operand")
    wp = w + kw - 1
    need = 4 * ((hs + kh - 1) * wp * c + kh * kw * c * o)
    if need > VMEM_BUDGET:
        return _fallback(op, f"per-image working set {need}B > VMEM "
                             f"budget {VMEM_BUDGET}B")
    from . import stencil as stencil_kernel

    why = stencil_kernel.cuda_limits(kh, kw, c, o, n * p)
    if why:
        return _fallback(op, why)
    return Selection(op, "native", "selected")


_CHECKS = {"kmeans": _sel_kmeans, "segment_sum": _sel_segment,
           "bincount": _sel_bincount, "topk": _sel_topk,
           "sort_exchange": _sel_exchange, "stencil": _sel_stencil}


def select(op: str, shape, dtype, tiling: Optional[tiling_mod.Tiling],
           mesh=None, force: bool = False, **params: Any) -> Selection:
    """The per-op decision (pure: flags + static shapes only).

    ``force=True`` skips ``FLAGS.native_kernels`` and the measured-off
    table (an explicit ``impl=``), never the constraint checks."""
    if op not in _CHECKS:
        raise KeyError(f"unknown kernel op {op!r}; known: "
                       f"{sorted(_CHECKS)}")
    if not force:
        if mode() == "expr":
            return _fallback(op, "FLAGS.native_kernels=off")
        if FLAGS.native_kernels == "auto" and op in _MEASURED_OFF:
            return _fallback(op, _MEASURED_OFF[op])
    mesh = mesh or mesh_mod.get_mesh()
    shape = tuple(int(s) for s in shape)
    return _CHECKS[op](shape, np.dtype(dtype), tiling, mesh, params)


def node_selection(node: Any) -> Optional[Selection]:
    """The Selection an expr node's lowering asks for, or None when the
    node type never routes through the kernel layer. Matched by class
    name so this module imports no expr module. The JAX package's ragged
    transport, which carries 1-D sorts on its own chip, has no port: a
    sample sort's exchange is always the padded, packed one."""
    name = type(node).__name__
    mesh = mesh_mod.get_mesh()
    if name == "TopKExpr":
        return select("topk", node.x.shape, node.x.dtype, tiling_mod.row(1),
                      mesh, k=node.k)
    if name == "BincountExpr":
        return select("bincount", node.x.shape, node.x.dtype,
                      node.x.out_tiling(), mesh, length=node.length)
    if name == "SampleSortExpr":
        from ..ops import sort as sort_ops

        moved = (node._moved_in_tiling() if node.x.ndim > 1
                 else node.x.out_tiling())
        axis = sort_ops.collective_axis(moved, mesh)
        p = int(mesh.shape.get(axis, 1))
        n = node.x.shape[node.axis] if node.x.ndim else 0
        m = -(-n // p) if p else n
        return select("sort_exchange", (n,), node.x.dtype, moved, mesh,
                      p=p, m=m)
    if name == "StencilExpr":
        return select("stencil", node.x.shape, node.x.dtype,
                      node.x.out_tiling(), mesh, stride=node.stride,
                      padding=node.padding, kshape=node.w.shape[:2],
                      out_channels=node.w.shape[3])
    return None
