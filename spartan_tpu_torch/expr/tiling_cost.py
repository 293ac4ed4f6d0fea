"""Smart tiling: a cost-driven tiling assignment over the expr DAG.

Port of ``spartan_tpu/expr/tiling_cost.py``. Per-node candidate
tilings; an edge's cost is the bytes a redistribution between producer
and consumer tilings moves; compute cost rewards tilings that spread a
node over more logical shards (owner-computes). A bottom-up table and a
top-down commit pick the cheapest assignment, written as
``_forced_tiling`` (materialization points) and ``_dot_plan``
(contractions) on the DAG's nodes: both key the plan cache, and
``Expr.lower`` passes forced tilings through
``parallel/redistribute.constrain``.

The candidate order, the ``_OP_MOVE_EPS`` tie-break and every weight
are the JAX package's, so on the same logical mesh the port commits the
same tilings. On a logical mesh the values do not change (a tiling is
metadata over one tensor); on a group mesh the committed tilings and
GEMM plans are carried out on the ranks' blocks.

Cost model (per-shard bytes, ring collectives over n shards):
  * same tiling, or source replicated: 0
  * sharded -> replicated (all-gather): size * (n-1)/n
  * sharded -> differently sharded (all-to-all): size * (n-1)/n
  * compute: size * C / p, where p = shards the tiling spreads over,
    C weights FLOP cost against interconnect bytes.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..array import tiling as tiling_mod
from ..array.tiling import Tiling
from ..parallel import mesh as mesh_mod
from ..parallel import redistribute as redist_mod
from ..utils.config import FLAGS
from .base import Expr, ScalarExpr, TupleExpr, ValExpr
from .map import MapExpr
from .reduce import GeneralReduceExpr, ReduceExpr
from .reshape import TransposeExpr
from .slice import SliceExpr

# Bytes-equivalent weight of local compute relative to interconnect
# bytes — applied to OUTPUT BYTES of non-contraction nodes only, where
# elementwise work is memory-bound and output bytes are the right
# proxy (~2 reads + 1 write of HBM per output byte, plus epsilon ALU).
# Contractions are priced by FLOPs instead (_flop_weight below) — the
# round-4 model priced GEMM compute by output bytes too, which is
# dimensionally wrong (a 2mnk contraction's cost grows with k at fixed
# output size) and forced a hand-chosen override here.
_COMPUTE_WEIGHT = 4.0

# Bytes-equivalent cost of one contraction FLOP: (sec/FLOP) divided by
# (sec/interconnect-byte), keyed by the mesh device's type. The cpu
# value is the JAX package's committed calibration for its 8-device CPU
# mesh (so CPU plans match it); "cuda" takes the fallback, and
# calibrate_flop_weight measures the value on a group of ranks.
# Override with --tiling_flop_weight.
_FLOP_WEIGHT_DEFAULTS = {"cpu": 0.005}
_FLOP_WEIGHT_FALLBACK = 1e-3

# Weight on operand-reshard bytes in contraction plans, relative to
# output psum bytes. Operand gathers sit on the critical path BEFORE
# the matmul and replicate operand memory, while the output all-reduce
# pipelines with the epilogue — so a byte of operand movement costs
# more wall time than a byte of psum. CALIBRATED by the measured-arm
# sweep (benchmarks/tiling_ab.py --sweep, 8 GEMM layout combos + 2
# einsum batched-matmul combos x all candidate plans on the 8-device
# CPU mesh): under receive-bytes reshard pricing, weights 4 and 5 both
# bring EVERY combo's pick within 20% of its best measured arm
# (including row_t x row_t, the round-4 residual — now 1.00); 5
# measured best overall (max pick/best 1.145, within run noise).
# Override with --tiling_operand_move_weight.
_OPERAND_MOVE_WEIGHT = 5.0

# Tie-break epsilon on the same quantity: keeps plan choice
# deterministic on exact byte ties regardless of the weight above.
_OP_MOVE_EPS = 2.0 ** -20


def _mesh_n(mesh) -> int:
    return mesh_mod.device_count(mesh)


def op_class(node: Expr) -> str:
    """The node's cost-model op class — the vocabulary the calibration
    profile's per-class factors are keyed by (obs/ledger.CLASSES):
    contraction nodes are FLOP-priced, everything else is priced by
    output bytes under its class factor; 'reshard' and 'psum' are edge
    classes, not node classes."""
    if _contraction_view(node) is not None:
        return "contraction"
    if isinstance(node, MapExpr):
        return "map"
    if isinstance(node, (ReduceExpr, GeneralReduceExpr)):
        return "reduce"
    if isinstance(node, TransposeExpr):
        return "transpose"
    if isinstance(node, SliceExpr):
        return "slice"
    return "other"


def _cal_factors() -> Optional[Dict[str, float]]:
    """The active calibration profile's per-op-class factors, or None
    when ``FLAGS.cost_calibration`` is off or no profile is installed
    (obs/ledger owns the profile; one read per table build). The
    profile's fingerprint is part of ``_opt_flags_key``, so calibrated
    and uncalibrated plans never alias."""
    from ..obs import ledger

    return ledger.factors()


def _parallelism(t: Tiling, mesh) -> int:
    p = 1
    for n in t.tiles_per_dim(mesh):
        p *= n
    return p


def candidates(node: Expr, mesh) -> List[Tiling]:
    """Candidate output tilings for a node (divisible ones only):
    row / col / block plus their mesh-axis-swapped (transposed)
    variants, replicated, and — for rank >= 3 (batched contractions)
    — every single-axis placement on the TRAILING axes too, which the
    leading-axes-only vocabulary above cannot express. A node with a
    ``fixed_tiling`` offers its own layout only."""
    nd = node.ndim
    if node.fixed_tiling:
        return [tiling_mod.sanitize(node._default_tiling(), node.shape,
                                    mesh)]
    cands = {tiling_mod.replicated(nd)}
    if nd >= 1:
        cands.add(tiling_mod.row(nd))
        if mesh.shape.get(tiling_mod.AXIS_COL, 1) > 1:
            cands.add(tiling_mod.row_t(nd))
    if nd >= 2:
        cands.add(tiling_mod.col(nd))
        cands.add(tiling_mod.block(nd))
        if mesh.shape.get(tiling_mod.AXIS_ROW, 1) > 1:
            cands.add(tiling_mod.col_t(nd))
        if (mesh.shape.get(tiling_mod.AXIS_ROW, 1) > 1
                and mesh.shape.get(tiling_mod.AXIS_COL, 1) > 1):
            cands.add(tiling_mod.block_t(nd))
    rep = tiling_mod.replicated(nd)
    for i in range(2, nd):
        for ax in (tiling_mod.AXIS_ROW, tiling_mod.AXIS_COL):
            if mesh.shape.get(ax, 1) <= 1:
                continue
            cands.add(rep.with_axis(i, ax))
            other = (tiling_mod.AXIS_COL if ax == tiling_mod.AXIS_ROW
                     else tiling_mod.AXIS_ROW)
            if mesh.shape.get(other, 1) > 1:
                # pair placements: batch-row + trailing (dp x tp) AND
                # the two trailing-most axes together (within-batch
                # block — survives an indivisible batch axis)
                cands.add(rep.with_axis(0, other).with_axis(i, ax))
                cands.add(rep.with_axis(nd - 2, other)
                          .with_axis(nd - 1, ax))
    out = []
    for t in cands:
        if tiling_mod.sanitize(t, node.shape, mesh) == t:
            out.append(t)
    # Deterministic order, row-sharded outputs first: exact cost ties
    # resolve to the earlier candidate, and sharding axis 0 wins ties
    # (XLA's row-major layouts make row-sharded outputs cheaper than
    # the cost-equivalent col-sharded ones — measured in the --sweep).
    out.sort(key=lambda t: (not t.axes or t.axes[0] is None,
                            tuple(a is None for a in t.axes),
                            str(t.axes)))
    return out or [tiling_mod.replicated(nd)]


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= mesh.shape.get(a, 1)
        return n
    return mesh.shape.get(ax, 1)


def reshard_cost(src: Tiling, dst: Tiling, nbytes: float, mesh) -> float:
    """Per-chip RECEIVE bytes to move from ``src`` to ``dst`` layout.

    Each chip ends holding ``nbytes / p_dst`` and already holds the
    expected overlap between its source shard and its destination
    shard; the difference is what the interconnect must deliver.
    Per-axis overlap fractions: an axis sharded by the SAME mesh axis
    on both sides is fully aligned (fraction = per-axis dst share); an
    axis whose split changed contributes the product of both shares
    (aligned-grid expected intersection). This prices partial
    replication correctly — e.g. a (y, None) -> (x, y) redistribute of
    a matrix replicated over x receives nbytes/16 per chip, not the
    full-mesh all-to-all the round-4 model charged (the source of its
    documented row_t x row_t mispick)."""
    if src.axes == dst.axes:
        return 0.0
    dst_frac = 1.0
    local_frac = 1.0
    for s_ax, d_ax in zip(src.axes, dst.axes):
        s = _axis_size(mesh, s_ax)
        d = _axis_size(mesh, d_ax)
        dst_frac /= d
        if s_ax == d_ax:
            local_frac /= d
        else:
            local_frac /= s * d
    return nbytes * max(0.0, dst_frac - local_frac)


def _operand_requirement(node: Expr, t: Tiling, child: Expr,
                         child_idx: int) -> Optional[Tiling]:
    """The operand tiling node wants from ``child`` when producing ``t``.
    None = no preference (child keeps its own best; GSPMD negotiates)."""
    if isinstance(node, MapExpr):
        if child.shape == node.shape:
            return t
        return tiling_mod.replicated(child.ndim)  # broadcast operand
    if isinstance(node, (ReduceExpr, GeneralReduceExpr)):
        pre_shape = getattr(node, "_pre_shape", child.shape)
        if child.shape != pre_shape:
            # broadcast operand of a fused pre-reduce tree
            return tiling_mod.replicated(child.ndim)
        if node.axis is None:
            return None  # full reduction reads any layout equally
        t_in = t
        if not (isinstance(node, ReduceExpr) and node.keepdims):
            for a in node.axis:
                t_in = t_in.add_axis(a, None)
        return t_in
    if isinstance(node, TransposeExpr):
        inv = np.argsort(node.perm)
        return t.transpose(tuple(int(i) for i in inv))
    if isinstance(node, SliceExpr):
        return None
    # DotExpr is strategy-searched inline in assign_tilings.build; any
    # other node says what it wants itself
    return node.operand_requirement(t, child_idx)


def _dot_strategies(t: Tiling, mesh) -> List[Optional[str]]:
    """Contraction placements for an output grid: None = contraction
    replicated (gathered operands); a mesh axis = contraction sharded
    there, merged by an output psum. Only axes the output grid does
    not already use are available."""
    used = {a for a in t.axes if a is not None}
    out: List[Optional[str]] = [None]
    for ax in mesh.axis_names:
        if ax not in used and mesh.shape.get(ax, 1) > 1:
            out.append(ax)
    return out


def _contraction_view(node: Expr):
    """``(flops, reqs_fn)`` for nodes the planner strategy-searches —
    2-D DotExpr GEMMs and every ContractExpr (einsum / tensordot /
    batched matmul / inner). ``reqs_fn(t, s)`` maps an output grid +
    contraction placement to the two operand tilings the lowering will
    constrain; None for non-contraction nodes."""
    from .contract import ContractExpr
    from .dot import DotExpr

    if isinstance(node, DotExpr) and node.a.ndim == 2 \
            and node.b.ndim == 2:
        m, k = node.a.shape
        n = node.b.shape[1]

        def reqs(t: Tiling, s: Optional[str]):
            return Tiling((t.axes[0], s)), Tiling((s, t.axes[1]))

        return 2.0 * m * k * n, reqs, True
    if isinstance(node, ContractExpr):
        return (node.flops(), node.plan_operand_tilings,
                bool(node.contraction_labels))
    return None


def _compute_weight() -> float:
    w = float(FLAGS.tiling_compute_weight or 0.0)
    return w if w > 0 else _COMPUTE_WEIGHT


def _flop_weight(mesh=None) -> float:
    w = float(FLAGS.tiling_flop_weight or 0.0)
    if w > 0:
        return w
    mesh = mesh or mesh_mod.get_mesh()
    return _FLOP_WEIGHT_DEFAULTS.get(mesh.device.type,
                                     _FLOP_WEIGHT_FALLBACK)


def _operand_move_weight() -> float:
    w = float(FLAGS.tiling_operand_move_weight or 0.0)
    return w if w > 0 else _OPERAND_MOVE_WEIGHT


def _memory_weight() -> float:
    """Soft memory pressure (FLAGS.tiling_memory_weight, default 0):
    bytes-equivalent penalty per byte of a candidate's PER-CHIP output
    residency. Positive values bias the DP toward finer tilings —
    the gentle end of the memory governor's spectrum (docs/MEMORY.md),
    before a budget breach forces a whole degradation rung."""
    return float(FLAGS.tiling_memory_weight or 0.0)


def _build_table(root: Expr, mesh) -> Dict:
    """Bottom-up candidate cost table:
    ``table[node_id][tiling] = (cost, per-child picks, strategy)``
    where strategy is the chosen contraction placement for GEMMs."""
    table: Dict[int, Dict[Tiling, Tuple[float, Tuple, Optional[str]]]] = {}
    weight = _compute_weight()
    flop_w = _flop_weight(mesh)
    move_w = _operand_move_weight()
    mem_w = _memory_weight()
    # profile-guided calibration (obs/ledger): per-op-class factors
    # multiply the matching cost terms; identity when no profile is
    # active. Applied symmetrically to selection (best_child's move
    # weight) and pricing so the DP stays self-consistent.
    cal = _cal_factors()
    reshard_f = cal.get("reshard", 1.0) if cal else 1.0
    psum_f = cal.get("psum", 1.0) if cal else 1.0
    flop_f = cal.get("contraction", 1.0) if cal else 1.0
    # redistribution planner (parallel/redistribute): edges priced by
    # the modeled collective schedule (per-collective calibrated
    # factors applied INSIDE edge_cost, clamped at the receive-bytes
    # floor) instead of the raw receive-bytes heuristic. The flag is
    # part of _opt_flags_key, so planned and heuristic plans never
    # alias; when on, the per-edge factor weight moves inside the
    # planner (move_unit 1.0) and the psum term is calibrated by its
    # reduce-scatter + all-gather halves, matching class_components.
    planner = redist_mod.planner_on()
    move_unit = 1.0 if planner else reshard_f
    if planner and cal:
        psum_f = 0.5 * (cal.get("reduce_scatter", 1.0)
                        + cal.get("all_gather", 1.0))

    def nbytes(e: Expr) -> float:
        return float(e.size) * e.dtype.itemsize

    def move_cost(tc: Tiling, req: Tiling, nb: float) -> float:
        if planner:
            return redist_mod.edge_cost(tc, req, nb, mesh, cal)
        return reshard_cost(tc, req, nb, mesh)

    def best_child(c: Expr, req: Optional[Tiling], w: float = 1.0
                   ) -> Tuple[float, Optional[Tiling], float]:
        """Cheapest child entry under requirement ``req``, with the
        reshard move charged at weight ``w`` (GEMM operand moves use
        _OPERAND_MOVE_WEIGHT so selection and plan pricing agree —
        otherwise a reshard-heavy child could win selection at weight
        1 and then be priced at w). Returns (total, pick, move)."""
        best_cost = None
        best_pick = None
        best_move = 0.0
        for tc, entry in table[c._id].items():
            move = (0.0 if req is None
                    else move_cost(tc, req, nbytes(c)))
            total = entry[0] + w * move
            # on a total tie prefer the lower-move entry, so the move
            # fed into the _OP_MOVE_EPS tie-break is itself
            # deterministic (not dict-iteration-order dependent)
            if (best_cost is None or total < best_cost
                    or (total == best_cost and move < best_move)):
                best_cost, best_pick, best_move = total, tc, move
        return best_cost or 0.0, best_pick, best_move

    def build(node: Expr) -> None:
        if node._id in table:
            return
        for c in node.children():
            build(c)
        entries: Dict[Tiling, Tuple[float, Tuple, Optional[str]]] = {}
        if isinstance(node, (ValExpr, ScalarExpr)):
            entries[node.out_tiling()] = (0.0, (), None)
            table[node._id] = entries
            return
        kids = node.children()
        cview = _contraction_view(node)
        node_f = cal.get(op_class(node), 1.0) if cal else 1.0
        for t in candidates(node, mesh):
            # soft memory term: per-chip output residency of this
            # candidate, charged on contraction and non-contraction
            # nodes alike (0 when the weight flag is off)
            memcost = (mem_w * nbytes(node) / _parallelism(t, mesh)
                       if mem_w else 0.0)
            compute = (nbytes(node) * weight * node_f
                       / _parallelism(t, mesh))
            if cview is not None:
                # search contraction strategies: s=None gathers the
                # contraction onto the output grid, s=mesh-axis shards
                # it there and pays an output psum — reqs_fn mirrors
                # the node's _lower exactly. Compute is FLOP-priced
                # (2mnk-style, _flop_weight): a sharded contraction
                # multiplies the parallelism by the strategy axis.
                flops, reqs_fn, has_contraction = cview
                best = None
                strategies = (_dot_strategies(t, mesh)
                              if has_contraction else [None])
                for s in strategies:
                    req_a, req_b = reqs_fn(t, s)
                    ca, pa, ma = best_child(kids[0], req_a,
                                            move_w * move_unit)
                    cb, pb, mb = best_child(kids[1], req_b,
                                            move_w * move_unit)
                    psum = 0.0
                    if s is not None:
                        # ring all-reduce of each chip's PARTIAL — the
                        # output shard under grid t, not the full
                        # array: reduce-scatter + all-gather moves
                        # ~2 x shard x (ns-1)/ns per chip
                        ns = _axis_size(mesh, s)
                        psum = (2.0 * nbytes(node) * psum_f
                                / _parallelism(t, mesh)
                                * (ns - 1) / ns)
                    fl = (flops * flop_w * flop_f
                          / (_parallelism(t, mesh) * _axis_size(mesh, s)))
                    # operand movement is charged at move_w inside
                    # best_child (critical path before the matmul —
                    # see _OPERAND_MOVE_WEIGHT); the epsilon keeps
                    # exact ties deterministic
                    tot = (ca + cb + psum + fl + memcost
                           + (ma + mb) * _OP_MOVE_EPS)
                    if best is None or tot < best[0]:
                        best = (tot, (pa, pb), s)
                entries[t] = (best[0], best[1], best[2])
                continue
            comm = 0.0
            picks: List[Tiling] = []
            for i, c in enumerate(kids):
                req = _operand_requirement(node, t, c, i)
                ccost, pick, _ = best_child(c, req, move_unit)
                comm += ccost
                picks.append(pick)
            entries[t] = (comm + compute + memcost, tuple(picks), None)
        table[node._id] = entries

    roots = root.elements if isinstance(root, TupleExpr) else (root,)
    for r in roots:
        build(r)
    return table


def assign_tilings(root: Expr) -> Expr:
    from .contract import ContractExpr
    from .dot import DotExpr, DotShardMapExpr

    mesh = mesh_mod.get_mesh()
    if _mesh_n(mesh) <= 1:
        return root  # single device: everything is replicated anyway
    from ..utils import profiling as prof

    prof.count("tiling_dp_runs")
    table = _build_table(root, mesh)

    def commit(node: Expr, t: Tiling, force: bool) -> None:
        if isinstance(node, (ValExpr, ScalarExpr)):
            return
        entry = table[node._id].get(t)
        if entry is not None and getattr(node, "_plan_cost", None) is None:
            # cost-model estimate for the chosen tiling (bytes-equivalent
            # units, subtree-cumulative) — surfaced by st.explain
            node._plan_cost = entry[0]
        # Constrain only MATERIALIZATION points: GEMMs (whose lowering
        # derives operand layouts from the chosen plan) and the root.
        # Forcing every intermediate (e.g. a transpose) pins layouts XLA
        # would otherwise optimize through — measured 25% slower and 2x
        # the collectives on the dot-T-dot chain (benchmarks/tiling_ab).
        # A plan equal to the node's natural behavior is skipped: a
        # redundant with_sharding_constraint is not free, it steers
        # XLA's propagation pass into worse solutions. 2-D GEMMs get
        # their searched plan recorded on a SEPARATE attribute
        # (``_dot_plan`` — operand placement, consumed by
        # DotExpr._lower) so the plan always reaches the lowering
        # without forcing a redundant *output* constraint when the
        # chosen grid equals the default.
        strategy = entry[2] if entry is not None else None
        is_gemm = isinstance(node, (DotExpr, DotShardMapExpr,
                                    ContractExpr))
        plans_operands = (isinstance(node, ContractExpr)
                          or (isinstance(node, DotExpr)
                              and node.a.ndim == 2 and node.b.ndim == 2))
        nondefault = t is not None and t != node._default_tiling()
        if plans_operands:
            # first visit wins (diamond DAGs); the forced output — when
            # non-default — always matches the recorded operand plan
            if entry is not None and node._dot_plan is None:
                node._dot_plan = (t, strategy)
                if nondefault and node._forced_tiling is None:
                    node._forced_tiling = t
        elif node._forced_tiling is None and (
                (force and nondefault) or (is_gemm and nondefault)):
            node._forced_tiling = t
        if entry is None:
            return
        for c, tc in zip(node.children(), entry[1]):
            if tc is not None:
                commit(c, tc, False)

    roots = root.elements if isinstance(root, TupleExpr) else (root,)
    for r in roots:
        best_t = min(table[r._id], key=lambda t: table[r._id][t][0])
        commit(r, best_t, True)
    return root


def gemm_plan_costs(root: Expr) -> Dict:
    """Candidate ``(output tiling, strategy, model cost)`` lists for
    every planned contraction node in ``root`` (2-D GEMMs and
    ContractExpr einsum/tensordot/batched-matmul) — the validation
    surface for the cost model (benchmarks/tiling_ab.py --sweep and
    tests/test_tiling_calibration.py force each candidate as a
    measured arm and compare the model's ranking against wall time).
    Returns ``{node: [(Tiling, strategy, cost), ...]}``."""
    from .optimize import dag_nodes

    mesh = mesh_mod.get_mesh()
    if _mesh_n(mesh) <= 1:
        return {}
    table = _build_table(root, mesh)
    out = {}
    for n in dag_nodes(root):
        if _contraction_view(n) is not None and n._id in table:
            out[n] = sorted(
                ((t, e[2], e[0]) for t, e in table[n._id].items()),
                key=lambda x: x[2])
    return out


def class_components(root: Expr, mesh=None) -> Dict[str, float]:
    """Per-op-class decomposition of the CHOSEN plan's modeled cost.

    Re-prices the optimized DAG at its committed tilings
    (``out_tiling()``, post-assignment) with the same formulas as
    ``_build_table`` — node compute under its class, contraction FLOPs
    under 'contraction', operand moves under 'reshard', output
    all-reduces under 'psum' — WITHOUT the candidate search. This is
    the vector the cost ledger records per plan and ``fit_profile``
    regresses measured dispatch time against: the classes are exactly
    the terms a calibration factor can scale, so a fitted profile's
    corrections mean the same thing here and in the DP. Uncalibrated
    by construction (factors of 1): a profile fitted FROM these
    components corrects the base model, not itself. Empty on a
    single-device mesh (no DP ran)."""
    from .base import ScalarExpr, ValExpr
    from .optimize import dag_nodes

    mesh = mesh or mesh_mod.get_mesh()
    if _mesh_n(mesh) <= 1:
        return {}
    weight = _compute_weight()
    flop_w = _flop_weight(mesh)
    move_w = _operand_move_weight()
    # planner on: reshard edges decompose into their chosen schedule's
    # per-collective bytes (all_gather / all_to_all) and psum into its
    # reduce-scatter + all-gather halves, so fit_profile calibrates
    # each collective's factor independently (obs/ledger.CLASSES)
    planner = redist_mod.planner_on()
    comp: Dict[str, float] = {}

    def add(cls: str, v: float) -> None:
        if v:
            comp[cls] = comp.get(cls, 0.0) + float(v)

    def move(child: Expr, req: Optional[Tiling], w: float) -> None:
        if req is None:
            return
        try:
            src = child.out_tiling()
        except Exception:
            return
        nb = float(child.size) * child.dtype.itemsize
        if planner:
            for cls, v in redist_mod.edge_components(src, req, nb,
                                                     mesh).items():
                add(cls, w * v)
            return
        add("reshard", w * reshard_cost(src, req, nb, mesh))

    def add_psum(v: float) -> None:
        if planner:
            # a ring all-reduce is reduce-scatter + all-gather of the
            # shard — split the modeled bytes so each half calibrates
            # under its own collective class
            add("reduce_scatter", 0.5 * v)
            add("all_gather", 0.5 * v)
        else:
            add("psum", v)

    for n in dag_nodes(root):
        if isinstance(n, (ValExpr, ScalarExpr)):
            continue
        try:
            t = n.out_tiling()
        except Exception:
            continue
        nbytes = float(n.size) * n.dtype.itemsize
        kids = n.children()
        cview = _contraction_view(n)
        if cview is not None and len(kids) >= 2:
            flops, reqs_fn, _has = cview
            plan = getattr(n, "_dot_plan", None)
            grid, s = plan if plan is not None else (t, None)
            par = _parallelism(grid, mesh)
            add("contraction", flops * flop_w
                / (par * _axis_size(mesh, s)))
            if s is not None:
                ns = _axis_size(mesh, s)
                add_psum(2.0 * nbytes / par * (ns - 1) / ns)
            try:
                reqs = reqs_fn(grid, s)
            except Exception:
                reqs = None
            if reqs is not None:
                for c, req in zip(kids, reqs):
                    move(c, req, move_w)
            continue
        add(op_class(n), nbytes * weight / _parallelism(t, mesh))
        for i, c in enumerate(kids):
            try:
                req = _operand_requirement(n, t, c, i)
            except Exception:
                req = None
            move(c, req, 1.0)
    return {k: round(v, 3) for k, v in comp.items()}


def calibrate_flop_weight(n: int = 512, iters: int = 5,
                          mesh=None) -> float:
    """Measure the bytes-equivalent cost of one FLOP on this mesh, as
    the JAX package does: a one-rank ``n x n`` matmul (``2n^3`` FLOPs)
    timed against a row -> replicated gather of the same matrix over
    the group (``n^2 * itemsize * (p - 1) / p`` bytes a rank receives),
    returning ``(t_mm / flops) / (t_ag / bytes)``. On a group mesh of
    more than one rank the gather is a real one (``DistArray.retile``
    through ``torch.distributed``; on a gloo group of CUDA ranks that
    includes the host staging). A logical mesh lives in one process
    with no interconnect to time, and a one-rank group has nothing to
    gather: both return :func:`_flop_weight`, as the JAX package does on
    one device. Every rank of the group must call it, and every rank
    returns the same value (each time is the slowest rank's), so ranks
    that plan with it plan alike."""
    from ..array import distarray as da
    from ..parallel import collectives as coll

    mesh = mesh or mesh_mod.get_mesh()
    p = _mesh_n(mesh)
    if not mesh.is_group or p <= 1:
        return _flop_weight(mesh)
    dev = mesh.device

    def wait():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    x = np.random.RandomState(0).rand(n, n).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    wait()
    xt @ xt
    wait()
    t0 = time.perf_counter()
    for _ in range(iters):
        xt @ xt
    wait()
    t_mm = (time.perf_counter() - t0) / iters
    rows = da.from_numpy(x, tiling=tiling_mod.row(2), mesh=mesh)
    rep = tiling_mod.replicated(2)
    rows.retile(rep)
    wait()
    t0 = time.perf_counter()
    for _ in range(iters):
        rows.retile(rep)
    wait()
    t_ag = (time.perf_counter() - t0) / iters
    # ranks time differently; a weight that differed between them could
    # give them different plans, and so different collectives
    t_mm, t_ag = coll.reduce_over(
        torch.tensor([t_mm, t_ag], dtype=torch.float64, device=dev),
        tuple(mesh.shape), "max", mesh).tolist()
    if t_ag <= 0:
        return _flop_weight(mesh)
    flops = 2.0 * n * n * n
    ag_bytes = float(n) * n * x.dtype.itemsize * (p - 1) / p
    return float((t_mm / flops) / (t_ag / ag_bytes))


def explain(root: Expr) -> str:
    """Debug dump of chosen tilings (for the ablation reports)."""
    from .optimize import dag_nodes

    lines = []
    for n in dag_nodes(root):
        lines.append(f"{type(n).__name__}#{n._id} shape={n.shape} "
                     f"tiling={n.out_tiling().axes}")
    return "\n".join(lines)
