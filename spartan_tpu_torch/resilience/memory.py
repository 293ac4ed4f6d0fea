"""Predictive memory governor: model a plan's peak memory, admit against
it, degrade before dying (port of ``spartan_tpu/resilience/memory.py``).

1. **The model** (:func:`estimate_report`, run in ``_build_plan`` under
   a ``memory_model`` phase and stored on ``report["memory"]``):

   * ``peak_bytes_per_chip`` — the JAX package's figure, by its rules:
     a per-chip live-set schedule over the optimized DAG's post-order,
     each node's output shard (under its sanitized tiling) live from
     its emit until its last consumer; leaves resident throughout;
     reshard staging priced like ``tiling_cost.reshard_cost``; a
     reduction's fused pre-reduce tree at operand size; a contraction
     ``max(partial, staging)``; an early-exit loop's carries twice;
     a user ``map2`` kernel at least reads its operands.
   * ``peak_bytes_card`` — the port's own walk, which is what a card
     holds: the same schedule (the walk frees each value at its last
     consumer, ``expr/base.py``) over the bytes the walk allocates —
     the whole arrays on a logical mesh (every position's block lives
     on the one card), the rank's blocks on a group mesh — with the
     port's rules where its walk differs from XLA's program:

     - a fused map or pre-reduce tree is evaluated op by op by torch:
       the intermediates it holds at once, by a walk of the tree, in
       units of its output (a user function proven elementwise on a
       group mesh: by its traced program, ``expr/partition.py``);
     - a user ``map2`` on a group mesh: where proven row-partitionable,
       its operands' row blocks where they move and its replayed
       program's intermediates at the block's rows (a partial beside
       its all-reduce, a flip's reversed block beside its exchange);
       otherwise each split operand gathered whole;
     - a call that reduces an axis away on a group mesh (the masked
       median along an axis): its operands' blocks where they move and
       its program traced at the blocks' shapes;
     - on a group mesh a node's relayouts stage a new block for each
       operand it reads in another layout;
     - the k-split on a group mesh holds its whole partial product and
       the all-reduce's result at once (PR 13 measured it); a planned
       product on a logical mesh is one matmul (its output only);
     - the halo stencil stages the padded halo blocks beside its
       output (the kernel writes the output in place); on a group mesh
       each rank's rows joined with the halo rows, then padded;
     - a node that knows what its lowering stages says so
       (``card_staging(mesh)``): the local rules' piece exchanges
       (send and receive buffers), copies, the blocked scan's local
       scan, pooling's padded copy, the sample sort's stages;
     - ``st.loop`` re-walks its body from Python each iteration: the
       body's own peak with the carries, old and new, live.

   Admission and validation use ``peak_bytes_card``.
   :func:`validate_plan` measures it on the card (the walk's peak over
   the bytes resident before it, plus the plan's leaves) and records
   ``memory_prediction_error_ratio``.

2. **Predictive degradation** (:func:`maybe_degrade` before the first
   dispatch of a miss, :func:`redirect_governed` on hits of a plan
   already judged over budget): past ``FLAGS.hbm_budget_bytes`` (0 =
   the card's total memory, ``torch.cuda.mem_get_info``; None on the
   CPU unless set) the cheapest ladder rung whose modeled peak fits is
   chosen up front (:func:`choose_rung`), and it evaluates the same
   rung-forced clone the reactive ladder would.

3. **Admission** (:func:`request_bytes`, :func:`resident_cache_bytes_
   per_chip`): kept for ``serve/``.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs import ledger as ledger_mod
from ..obs.metrics import METRICS_FLAG as _METRICS_FLAG
from ..obs.metrics import REGISTRY
from ..utils import profiling as prof
from ..utils.config import FLAGS
from ..utils.log import log_debug, log_warn
from . import degrade

_GOVERNOR_FLAG = FLAGS.define_bool(
    "memory_governor", True,
    "Master switch for the predictive memory governor: estimate every "
    "plan's peak memory at build time and pick an OOM-ladder rung "
    "BEFORE the first dispatch when the prediction exceeds the budget. "
    "Inert when no budget is known (hbm_budget_bytes=0 on the CPU). "
    "Off = the reactive ladder only.")
_BUDGET_FLAG = FLAGS.define_int(
    "hbm_budget_bytes", 0,
    "Per-card memory budget the governor enforces. 0 = auto-detect the "
    "card's total memory (torch.cuda.mem_get_info); None on the CPU, "
    "where the governor stays inert unless this is set.")

# sentinel: the governor declined to act; evaluate() proceeds normally
NOT_HANDLED = object()

_budget_lock = threading.Lock()
_budget_memo: Tuple[Optional[Tuple[int, int]], Optional[int]] = (None, None)


def _detect_budget() -> Optional[int]:
    """The card's total memory, or None off the card."""
    from ..parallel import mesh as mesh_mod

    try:
        dev = mesh_mod.get_mesh().device
        if dev.type != "cuda":
            return None
        return int(torch.cuda.mem_get_info(dev)[1])
    except Exception:  # noqa: BLE001 - no budget is a valid answer
        return None


def hbm_budget_bytes() -> Optional[int]:
    """The enforced budget: ``FLAGS.hbm_budget_bytes`` when set, else
    the card's memory, else None (no governing possible). Memoized on
    the flags' mutation count and the mesh epoch."""
    global _budget_memo
    from ..parallel import mesh as mesh_mod
    from ..utils import config as config_mod

    ver = (config_mod.mutation_count(), mesh_mod._EPOCH)
    memo_ver, budget = _budget_memo
    if memo_ver == ver:
        return budget
    explicit = _BUDGET_FLAG._value
    budget = int(explicit) if explicit else _detect_budget()
    with _budget_lock:
        _budget_memo = (ver, budget)
    return budget


# -- the JAX package's per-chip model ------------------------------------


def _full_bytes(shape, dtype) -> float:
    return float(int(np.prod(shape)) if shape else 1) \
        * np.dtype(dtype).itemsize


def _shard_bytes(shape, dtype, tiling, mesh) -> float:
    """Per-chip bytes of ``shape``/``dtype`` laid out as ``tiling``."""
    from ..array import tiling as tiling_mod
    from ..expr.tiling_cost import _parallelism

    t = tiling_mod.sanitize(tiling, shape, mesh)
    return _full_bytes(shape, dtype) / _parallelism(t, mesh)


def _node_shard_bytes(n: Any, mesh) -> float:
    from ..array import tiling as tiling_mod

    try:
        t = n.out_tiling()
    except Exception:
        t = tiling_mod.replicated(n.ndim)
    return _shard_bytes(n.shape, n.dtype, t, mesh)


def _staging_bytes(child: Any, req, mesh) -> float:
    """Destination-shard bytes a reshard edge materializes (zero when
    nothing moves); the planner's schedule peak when it is on."""
    from ..expr.tiling_cost import reshard_cost
    from ..parallel import redistribute as redist_mod

    try:
        src = child.out_tiling()
    except Exception:
        return 0.0
    if src.axes == req.axes:
        return 0.0
    nbytes = _full_bytes(child.shape, child.dtype)
    if reshard_cost(src, req, nbytes, mesh) <= 0.0:
        return 0.0  # e.g. replicated source: shards carved locally
    if redist_mod.planner_on():
        frac = redist_mod.staging_frac(src, req, mesh)
        if frac is not None:
            return frac * nbytes
    return _shard_bytes(child.shape, child.dtype, req, mesh)


def _schedule(nodes: List[Any], roots: Tuple[Any, ...], size_of, transient,
              args: Dict[int, Tuple[str, float]], distinct: bool
              ) -> Tuple[float, List]:
    """The live-set walk in post-order: (peak over the args, the top
    contributors at the peak). A node's output is live from its emit
    until its last consumer is emitted, its transient only across its
    emit; leaves are resident (``args``). ``distinct``: a consumer
    counts once however often it reads a child (the port's walk), else
    once per edge (the JAX package's model)."""
    def kids(n: Any):
        cs = n.children()
        return tuple({c._id: c for c in cs}.values()) if distinct else cs

    root_ids = {r._id for r in roots}
    refs: Dict[int, int] = {}
    for n in nodes:
        for c in kids(n):
            refs[c._id] = refs.get(c._id, 0) + 1
    leaf_entries = list(args.values())
    live: Dict[int, Tuple[str, float]] = {}
    live_sum = 0.0
    peak = 0.0
    peak_top: List[Tuple[str, float]] = []
    for n in nodes:
        if n._id in args:
            continue
        size = size_of(n)
        tr = transient(n)
        here = live_sum + size + tr
        if here > peak:
            peak = here
            peak_top = sorted(
                [(f"{type(n).__name__}#{n._id} {n.shape}", size + tr)]
                + list(live.values()) + leaf_entries,
                key=lambda kv: -kv[1])[:5]
        if size > 0:
            live[n._id] = (f"{type(n).__name__}#{n._id} {n.shape}", size)
            live_sum += size
        for c in kids(n):
            refs[c._id] -= 1
            if refs[c._id] == 0 and c._id in live and \
                    c._id not in root_ids:
                live_sum -= live.pop(c._id)[1]
    return peak, peak_top


def _dag_parts(dag: Any):
    from ..expr.base import TupleExpr
    from ..expr.optimize import dag_nodes

    nodes = dag_nodes(dag)
    roots = dag.elements if isinstance(dag, TupleExpr) else (dag,)
    return nodes, roots


def estimate_dag(dag: Any, out_tilings, mesh) -> Dict[str, Any]:
    """The JAX package's per-chip live-set schedule (module docstring,
    ``peak_bytes_per_chip``)."""
    from ..expr.base import ScalarExpr, TupleExpr, ValExpr
    from ..expr.loop import CarryExpr, LoopExpr
    from ..expr.map import MapExpr
    from ..expr.map2 import Map2Expr
    from ..expr.reduce import GeneralReduceExpr, ReduceExpr
    from ..expr.tiling_cost import _contraction_view, _operand_requirement

    nodes, roots = _dag_parts(dag)
    alias_free: set = set()
    for n in nodes:
        if isinstance(n, LoopExpr) and not n.early_exit:
            for b in n.body_roots:
                if isinstance(b, MapExpr):
                    alias_free.add(b._id)

    args: Dict[int, Tuple[str, float]] = {}
    out_map: Dict[int, float] = {}
    for r, t in zip(roots, out_tilings):
        out_map[r._id] = _shard_bytes(r.shape, r.dtype, t, mesh)
    out_bytes = sum(out_map.values())

    sizes: Dict[int, float] = {}
    for n in nodes:
        if isinstance(n, ScalarExpr):
            # the JAX package's scalar leaf is a numpy scalar of the
            # Python value's type (8 bytes for an int or a float)
            args[n._id] = (f"{type(n).__name__}#{n._id} {n.shape}",
                           float(np.result_type(type(n.pyvalue)).itemsize))
            sizes[n._id] = 0.0
        elif isinstance(n, ValExpr):
            args[n._id] = (f"{type(n).__name__}#{n._id} {n.shape}",
                           _node_shard_bytes(n, mesh))
            sizes[n._id] = 0.0
        elif isinstance(n, (CarryExpr, TupleExpr, LoopExpr)) \
                or n._id in alias_free:
            sizes[n._id] = 0.0
        elif n._id in out_map:
            sizes[n._id] = out_map[n._id]
        else:
            sizes[n._id] = _node_shard_bytes(n, mesh)

    def transient(n: Any) -> float:
        kids = n.children()
        if isinstance(n, LoopExpr):
            if not n.early_exit:
                return 0.0
            return 2.0 * sum(
                _node_shard_bytes(b, mesh) for b in n.body_roots)
        if isinstance(n, Map2Expr):
            return sum(_node_shard_bytes(c, mesh) for c in kids)
        if isinstance(n, (ReduceExpr, GeneralReduceExpr)) and kids:
            pre = getattr(n, "_pre_shape", None) or kids[0].shape
            best = 0.0
            for c in kids:
                try:
                    t = c.out_tiling()
                except Exception:
                    continue
                best = max(best, _shard_bytes(pre, c.dtype, t, mesh))
            return best
        cview = _contraction_view(n)
        if cview is not None and len(kids) >= 2:
            partial = _node_shard_bytes(n, mesh)
            staging = 0.0
            plan = getattr(n, "_dot_plan", None)
            reqs = None
            if plan is not None:
                try:
                    reqs = cview[1](plan[0], plan[1])
                except Exception:
                    reqs = None
            if reqs is not None:
                for c, req in zip(kids, reqs):
                    staging += _staging_bytes(c, req, mesh)
            return max(partial, staging)
        staging = 0.0
        try:
            t = n.out_tiling()
        except Exception:
            return 0.0
        for i, c in enumerate(kids):
            try:
                req = _operand_requirement(n, t, c, i)
            except Exception:
                req = None
            if req is not None:
                staging += _staging_bytes(c, req, mesh)
        return staging

    peak, top = _schedule(nodes, roots, lambda n: sizes[n._id], transient,
                          args, distinct=False)
    args_bytes = sum(b for _, b in args.values())
    total = args_bytes + peak
    return {
        "peak_bytes_per_chip": int(total),
        "args_bytes": int(args_bytes),
        "out_bytes": int(out_bytes),
        "temp_bytes": int(max(0.0, total - args_bytes - out_bytes)),
        "top": [{"node": k, "bytes": int(v)} for k, v in top],
    }


# -- the port's card model ------------------------------------------------


def tree_units(tree: Any) -> float:
    """The intermediates a fused elementwise tree holds at once while
    torch evaluates it op by op, in units of its output (its own result
    included): each op's arguments are held until it returns, the
    inputs and constants cost nothing here."""
    from ..expr.local import LocalCall, LocalUfunc

    if not isinstance(tree, (LocalUfunc, LocalCall)):
        return 0.0
    held = 0.0
    peak = 0.0
    for a in tree.args:
        peak = max(peak, held + tree_units(a))
        if isinstance(a, (LocalUfunc, LocalCall)):
            held += 1.0
    # a package function that knows its own temporaries (histogram's
    # bucketing: ``LocalCall.units``) holds that many at its peak
    return max(peak, held + float(getattr(tree, "units", None) or 1.0))


def _card_bytes(n: Any, mesh) -> float:
    """Bytes of ``n``'s value on the card: the whole array on a logical
    mesh, the rank's block on a group mesh."""
    if not mesh.is_group:
        return _full_bytes(n.shape, n.dtype)
    return _node_shard_bytes(n, mesh)


def _group_staging(n: Any, reqs, mesh) -> float:
    """On a group mesh, the blocks a node's relayouts stage: each child
    whose layout differs from the one the node reads it in is moved
    (or sliced) into a new block of the required tiling."""
    from ..expr.base import ScalarExpr

    out = 0.0
    for c, req in zip(n.children(), reqs):
        if req is None or isinstance(c, ScalarExpr):
            continue
        try:
            src = c.out_tiling()
        except Exception:
            continue
        if src.axes != req.axes:
            out += _shard_bytes(c.shape, c.dtype, req, mesh)
    return out


def _card_transient(n: Any, mesh) -> float:
    from ..expr.contract import ContractExpr
    from ..expr.dot import DotExpr
    from ..expr.loop import LoopExpr
    from ..expr.map import MapExpr
    from ..expr.reduce import ReduceExpr
    from ..expr.tiling_cost import _contraction_view, _operand_requirement
    from ..ops.stencil import StencilExpr

    out = _card_bytes(n, mesh)
    group = mesh.is_group
    own = getattr(n, "card_staging", None)
    if own is not None:
        # a node whose lowering (its local rule on a group mesh) knows
        # what it stages: exchange buffers, copies, the sort's stages
        return own(mesh)
    if isinstance(n, MapExpr):
        # a call that reduces an axis away, on a group mesh: its
        # operands' moved blocks and its traced program at their shape
        drop = n.drop_staging(mesh)
        if drop is not None:
            return drop
        # a user function proven elementwise: its traced program's units
        units = n.card_units(mesh)
        if units is None:
            units = tree_units(n.op)
        tr = max(0.0, units - 1.0) * out
        if group:
            t = n.out_tiling()
            tr += _group_staging(n, [_operand_requirement(n, t, c, i)
                                     for i, c in enumerate(n.inputs)],
                                 mesh)
        return tr
    if isinstance(n, ReduceExpr):
        units = tree_units(n.pre)
        scratch = _reduce_scratch(n, mesh)
        if not units:
            return scratch
        if not group:
            return units * _full_bytes(n._pre_shape, n._pre_dtype) + scratch
        t = n.out_tiling()
        for a in (n.axis or ()):
            if not n.keepdims:
                t = t.add_axis(a, None)
        return (units * _shard_bytes(n._pre_shape, n._pre_dtype, t, mesh)
                + scratch)
    if isinstance(n, (DotExpr, ContractExpr)):
        plan = getattr(n, "_dot_plan", None)
        if not group or plan is None or _contraction_view(n) is None:
            return 0.0
        grid, k = plan
        tr = _group_staging(n, _contraction_view(n)[1](grid, k), mesh)
        if k is not None and mesh.shape.get(k, 1) > 1:
            # the k-split: the whole partial product block beside the
            # all-reduce's result (PR 13 measured both live at once)
            tr += _shard_bytes(n.shape, n.dtype, grid, mesh)
        return tr
    if isinstance(n, StencilExpr):
        from ..kernels import registry as kernels_mod
        from ..kernels import stencil as kstencil

        if group:
            return _halo_local_staging(n, mesh, out)
        if not kernels_mod.node_selection(n).native:
            return 0.0
        t = n.x.out_tiling()
        p = int(mesh.shape[t.axes[1]]) if t.axes[1] is not None else 1
        kh, kw = int(n.w.shape[0]), int(n.w.shape[1])
        # the kernel writes its output in place: the padded halo blocks
        # are all it stages
        return _full_bytes(kstencil.halo_blocks_shape(
            n.x.shape, kh, kw, p), np.float32)
    if isinstance(n, LoopExpr):
        return _loop_peak(n, mesh)
    return 0.0


def _reduce_scratch(n: Any, mesh) -> float:
    """What the fixed-order reduction kernel holds beside its operand and
    output where the reduction ``n`` lowers through it on ``mesh``'s
    device (``kernels/reduce.py::routes``): its slice buffer and, for
    reduced axes that are not one run of the layout, the moved copy of
    the operand (of the rank's block on a group mesh)."""
    from ..kernels import reduce as kreduce

    if not kreduce.routes(mesh.device, n._pre_dtype, n.op, n.axis,
                          len(n._pre_shape)):
        return 0.0
    shape = tuple(n._pre_shape)
    if mesh.is_group:
        shape = tuple(n._pre_tiling().block_extent(shape, mesh).shape)
    return float(kreduce.scratch_bytes(shape, n.axis))


def _halo_local_staging(n: Any, mesh, out: float) -> float:
    """The halo stencil's local rule on a group mesh: the rank's rows
    joined with its neighbours' halo rows and that block padded along W
    live together, then the padded block beside the output (the kernel
    writes it in place)."""
    from ..array import tiling as tiling_mod
    from ..kernels import registry as kernels_mod

    t = tiling_mod.sanitize(n.x.out_tiling(), n.x.shape, mesh)
    if t.axes[1] is None or not kernels_mod.node_selection(n).native:
        return 0.0
    nb, hb, w, c = t.block_extent(n.x.shape, mesh).shape
    kh, kw = int(n.w.shape[0]), int(n.w.shape[1])
    rows = hb + kh - 1
    halo = 2.0 * 2.0 * (kh - 1) * nb * w * c * 4.0
    cat = 4.0 * nb * rows * w * c
    xpad = 4.0 * nb * rows * (w + kw - 1) * c
    return max(halo + cat + xpad, xpad + out) - out


def _loop_peak(loop: Any, mesh) -> float:
    """An ``st.loop``'s walk from Python: each iteration walks the body
    with the carries live, and the new carries live beside the old
    until the iteration ends."""
    from ..expr.base import ScalarExpr, ValExpr
    from ..expr.loop import CarryExpr
    from ..expr.optimize import dag_nodes

    body_roots = tuple(loop.body_roots)
    nodes = []
    seen = set()
    for r in body_roots:
        for n in dag_nodes(r):
            if n._id not in seen:
                seen.add(n._id)
                nodes.append(n)
    carries = sum(_card_bytes(b, mesh) for b in body_roots)
    args = {n._id: ("", 0.0) for n in nodes
            if isinstance(n, (ValExpr, ScalarExpr, CarryExpr))}
    peak, _ = _schedule(nodes, body_roots, lambda n: _card_bytes(n, mesh),
                        lambda n: _card_transient(n, mesh), args,
                        distinct=True)
    return carries + peak


def card_estimate(dag: Any, out_tilings, mesh) -> Dict[str, Any]:
    """``peak_bytes_card``: the port's walk on the card (module
    docstring), with its args, outputs and top contributors."""
    from ..expr.base import ScalarExpr, TupleExpr, ValExpr
    from ..expr.loop import CarryExpr, LoopExpr

    from ..expr.optimize import dag_nodes

    nodes, roots = _dag_parts(dag)
    args: Dict[int, Tuple[str, float]] = {}
    body: set = set()
    for n in nodes:
        if isinstance(n, (ValExpr, ScalarExpr)):
            args[n._id] = (f"{type(n).__name__}#{n._id} {n.shape}",
                           _card_bytes(n, mesh))
        elif isinstance(n, LoopExpr):
            # a loop body is walked in its own env each iteration: its
            # values live in the loop's transient, not the outer walk
            for r in n.body_roots:
                body.update(m._id for m in dag_nodes(r))

    def size_of(n: Any) -> float:
        if n._id in args or n._id in body or isinstance(
                n, (CarryExpr, TupleExpr, LoopExpr)):
            return 0.0
        return _card_bytes(n, mesh)

    peak, top = _schedule(nodes, roots, size_of,
                          lambda n: 0.0 if n._id in body
                          else _card_transient(n, mesh), args,
                          distinct=True)
    args_bytes = sum(b for _, b in args.values())
    out_bytes = sum(_card_bytes(r, mesh) for r in roots
                    if r._id not in args)
    return {"peak_bytes_card": int(args_bytes + peak),
            "card_args_bytes": int(args_bytes),
            "card_out_bytes": int(out_bytes),
            "card_top": [{"node": k, "bytes": int(v)} for k, v in top]}


def estimate_report(dag: Any, out_tilings, mesh) -> Optional[Dict]:
    """``_build_plan``'s entry point: the estimate stored on
    ``report["memory"]`` (with the budget and the
    ``memory_predicted_bytes`` gauge). Advisory: a modeling failure
    returns None rather than failing the plan."""
    try:
        mem = estimate_dag(dag, out_tilings, mesh)
        mem.update(card_estimate(dag, out_tilings, mesh))
    except Exception as e:  # noqa: BLE001 - the model is advisory
        log_debug("memory governor: estimate failed (%s: %s)",
                  type(e).__name__, e)
        return None
    mem["budget_bytes"] = hbm_budget_bytes()
    mem["governed_rung"] = None
    if _METRICS_FLAG._value:
        REGISTRY.gauge(
            "memory_predicted_bytes",
            "modeled peak bytes on the card of the most recently built "
            "plan").set(float(mem["peak_bytes_card"]))
    return mem


def donation_credit(mem: Dict[str, Any], donated: List[Any],
                    mesh) -> float:
    """Bytes the budget check may discount for donated leaves: the port
    frees them after the walk, so up to the outputs' bytes of them
    never sit beside the result once it is returned."""
    if not donated:
        return 0.0
    credit = 0.0
    for arr in donated:
        try:
            credit += (_full_bytes(arr.shape, arr.dtype)
                       if not mesh.is_group
                       else _shard_bytes(arr.shape, arr.dtype, arr.tiling,
                                         mesh))
        except Exception:
            continue
    return min(credit, float(mem.get("card_out_bytes", 0)))


# -- validation on the card ----------------------------------------------


def validate_plan(plan: Any, mesh=None,
                  donate_pos: Tuple[int, ...] = ()) -> Optional[Dict]:
    """Measure the plan's walk on the card against ``peak_bytes_card``:
    reset the peak statistics, walk the plan over its own leaves,
    and take the peak over the bytes resident before it, plus the
    leaves the model counts as resident. Records
    ``memory_prediction_error_ratio`` (predicted / measured) and the
    cost ledger's ``peak_hbm`` actual. None off the card."""
    from ..expr import base
    from ..parallel import mesh as mesh_mod

    if plan is None or plan.report is None:
        return None
    mem = plan.report.get("memory")
    if not mem:
        return None
    if mesh is None:
        mesh = mesh_mod.get_mesh()
    if mesh.device.type != "cuda":
        return None
    leaves = base.plan_leaves(plan)
    dev = mesh.device
    torch.cuda.synchronize(dev)
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with prof.phase("memory_validate"):
        env = base.walk_env(plan, leaves, mesh)
        out = plan.dag.lower_local(env) if mesh.is_group \
            else plan.dag.lower(env)
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    del env, out
    actual = int(peak - resident + mem["card_args_bytes"])
    predicted = int(mem["peak_bytes_card"])
    ratio = predicted / actual if actual > 0 else None
    result = {"measured_peak_bytes": actual,
              "resident_bytes": int(resident),
              "predicted_bytes": predicted,
              "error_ratio": (round(ratio, 4) if ratio is not None
                              else None)}
    mem["validation"] = result
    ledger_mod.note_memory_actual(plan.report.get("plan_key"), predicted,
                                  actual)
    if _METRICS_FLAG._value and ratio is not None:
        REGISTRY.counter(
            "memory_validations",
            "plans validated against their measured walk").inc()
        REGISTRY.gauge(
            "memory_prediction_error_ratio",
            "predicted / measured peak bytes of the last validated "
            "plan (1.0 = exact)").set(float(ratio))
    return result


def predict(expr: Any, mesh=None) -> Optional[Dict]:
    """The memory estimate of ``expr``'s plan (builds and caches the
    plan without running it, like ``st.explain``)."""
    from ..expr import base
    from ..parallel import mesh as mesh_mod

    if mesh is None:
        mesh = mesh_mod.get_mesh()
    root = expr if isinstance(expr, base.Expr) else base.as_expr(expr)
    if root._result is not None:
        return None
    plan_key, rctx = base.plan_signature(root, mesh)
    plan = base.lookup_plan(plan_key)
    if plan is None:
        plan, _dag, _ = base._build_plan(root, mesh, rctx, plan_key)
    if plan is None or plan.report is None:
        return None
    return plan.report.get("memory")


# -- predictive degradation ------------------------------------------------


def _count(name: str, help_: str) -> None:
    if _METRICS_FLAG._value:
        REGISTRY.counter(name, help_).inc()


def _rung_estimate(expr: Any, rung: str, mesh
                   ) -> Tuple[Optional[Any], Optional[int]]:
    """Build (or look up) the rung's re-planned clone without running
    it, and read its modeled card peak. The plan is cached under the
    rung-keyed signature, so the follow-up ``_replan_evaluate`` hits
    it."""
    from ..expr import base

    clone = degrade.clone_for_replan(expr)
    with degrade._RungCtx(rung):
        plan_key, rctx = base.plan_signature(clone, mesh)
        plan = base.lookup_plan(plan_key)
        if plan is None:
            plan, _dag, _ = base._build_plan(clone, mesh, rctx, plan_key)
    if plan is None or plan.report is None:
        return None, None
    mem = plan.report.get("memory")
    if not mem:
        return plan, None
    return plan, int(mem["peak_bytes_card"])


def choose_rung(expr: Any, mesh, budget: int
                ) -> Tuple[Optional[str], Optional[int]]:
    """The cheapest sufficient ladder rung under ``budget``: each
    rung's re-plan is estimated in ladder order and the first that fits
    wins; ``chunked`` is the unmodeled last resort where it applies."""
    from ..expr.base import TupleExpr

    for rung in ("finer_tiling", "fusion_off"):
        _plan, peak = _rung_estimate(expr, rung, mesh)
        if peak is not None and peak <= budget:
            return rung, peak
    if (not isinstance(expr, TupleExpr) and expr.ndim > 0
            and int(expr.shape[0]) >= 2):
        return "chunked", None
    return None, None


def _record_predictive(expr: Any, plan: Any, rung: str,
                       rung_peak: Optional[int]) -> Dict[str, Any]:
    from .engine import _resilience_record

    rec = _resilience_record(expr, plan)
    rec["rung"] = rung
    rec["degraded"] = True
    rec["origin"] = "predictive"
    if rung_peak is not None:
        rec["rung_predicted_bytes"] = int(rung_peak)
    mem = (plan.report or {}).get("memory")
    if mem:
        mem["governed_rung"] = rung
        if rung_peak is not None:
            mem["governed_peak_bytes"] = int(rung_peak)
    return rec


def _evaluate_rung(expr: Any, rung: str, donated: List[Any], mesh,
                   plan: Any) -> Any:
    """Run the chosen rung; an OOM despite the model falls back to the
    reactive ladder."""
    from . import classify as classify_mod

    try:
        with prof.span("degrade", rung=rung, origin="predictive"):
            if rung == "chunked":
                return degrade._chunked_evaluate(expr, mesh)
            return degrade._replan_evaluate(expr, donated, rung)
    except degrade.NotApplicable:
        raise
    except Exception as e:  # noqa: BLE001 - fall back to the ladder
        if classify_mod.classify(e) != classify_mod.OOM:
            raise
        log_warn("memory governor: predicted rung %r still OOMed; "
                 "falling back to the reactive ladder", rung)
        return degrade.run_ladder(e, expr, donated, mesh, plan)


def maybe_degrade(expr: Any, plan: Any, plan_key: Any,
                  donated: List[Any], mesh) -> Any:
    """The miss-path enforcement point (``evaluate()`` calls it after
    ``_build_plan``, before the first dispatch). Returns the result when
    the governor degraded, else :data:`NOT_HANDLED`."""
    if not _GOVERNOR_FLAG._value or not FLAGS.oom_degrade:
        return NOT_HANDLED
    if degrade.active_rung() is not None:
        return NOT_HANDLED  # already inside a degraded re-plan
    mem = plan.report.get("memory") if plan.report else None
    if not mem:
        return NOT_HANDLED
    budget = hbm_budget_bytes()
    if not budget:
        return NOT_HANDLED
    need = mem["peak_bytes_card"] - donation_credit(mem, donated, mesh)
    need += resident_cache_bytes_per_chip(mesh)
    if need <= budget:
        return NOT_HANDLED
    rung, rung_peak = choose_rung(expr, mesh, budget)
    if rung is None:
        _count("memory_governor_unsatisfiable",
               "over-budget plans no ladder rung could bring under "
               "the budget (dispatched anyway)")
        return NOT_HANDLED
    log_warn("memory governor: predicted peak %.1f MiB > budget "
             "%.1f MiB; degrading to rung %r BEFORE dispatch",
             need / 2 ** 20, budget / 2 ** 20, rung)
    _count("resilience_predictive_degrades",
           "plans degraded predictively (before any dispatch/OOM)")
    rec = _record_predictive(expr, plan, rung, rung_peak)
    from ..expr import base

    plan.governed_rung = rung
    if plan_key is not None:
        stored = base.lookup_plan(plan_key)
        if stored is not None:
            stored.governed_rung = rung
    try:
        result = _evaluate_rung(expr, rung, donated, mesh, plan)
    except degrade.NotApplicable:
        return NOT_HANDLED
    expr._result = result
    expr._resilience = rec
    return result


def redirect_governed(expr: Any, plan: Any, donated: List[Any],
                      mesh) -> Any:
    """The hit-path enforcement point: a plan already judged over budget
    (``plan.governed_rung``) runs its rung again. Falls through when the
    governor or the budget has since been turned off."""
    if not _GOVERNOR_FLAG._value or not FLAGS.oom_degrade:
        return NOT_HANDLED
    if degrade.active_rung() is not None:
        return NOT_HANDLED
    if not hbm_budget_bytes():
        return NOT_HANDLED
    rung = plan.governed_rung
    _count("memory_governor_redirects",
           "plan-cache hits re-routed to their governed rung")
    rec = _record_predictive(expr, plan, rung, (plan.report or {}).get(
        "memory", {}).get("governed_peak_bytes"))
    try:
        result = _evaluate_rung(expr, rung, donated, mesh, plan)
    except degrade.NotApplicable:
        return NOT_HANDLED
    expr._result = result
    expr._resilience = rec
    return result


def resident_cache_bytes_per_chip(mesh) -> int:
    """Bytes of a card pinned by the incremental engine's result cache
    (``expr/incremental.py``, ``FLAGS.result_cache_bytes``): cached
    results and the leaf snapshots they keep alive are tensors a new
    walk cannot reuse, so the governor charges them like any other
    resident set. The JAX package divides its total over the mesh's
    chips, which hold the sharded results; on a logical mesh the whole
    cache sits on the one card (``peak_bytes_card`` is priced the same
    way), and the engine caches nothing on a group mesh. Zero when the
    cache is empty or off."""
    from ..expr import incremental as inc_mod

    return 0 if mesh.is_group else inc_mod.cache_bytes()


# -- admission -------------------------------------------------------------


def request_bytes(plan: Any, leaves: List[Any], mesh) -> int:
    """Predicted card peak of one request: the plan's (its governed
    rung's, when one was chosen), or before the plan exists the leaves'
    bytes (every walk holds its inputs)."""
    mem = None
    if plan is not None and plan.report is not None:
        mem = plan.report.get("memory")
    if mem:
        return int(mem.get("governed_peak_bytes")
                   or mem["peak_bytes_card"])
    from ..expr.base import _leaf_array

    floor = 0.0
    for leaf in leaves:
        arr = _leaf_array(leaf)
        if arr is None:
            continue
        floor += (_full_bytes(arr.shape, arr.dtype) if not mesh.is_group
                  else _shard_bytes(arr.shape, arr.dtype, arr.tiling,
                                    mesh))
    return int(floor)
