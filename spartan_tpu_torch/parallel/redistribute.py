"""Cost-modeled redistribution planner: explicit collective decomposition
of reshard edges (port of ``spartan_tpu/parallel/redistribute.py``).

1. **Enumeration** (:func:`schedules`): legal decompositions of a
   ``src -> dst`` Tiling transition into sequences of three steps —

   * ``all_gather`` (un-shard an array axis: mesh axis released),
   * ``all_to_all`` (move a mesh axis between two array axes in ONE
     exchange — each shard keeps ``1/p`` of its block),
   * ``slice`` (carve a replicated axis onto a free mesh axis: no
     traffic, each shard takes its own destination block).

2. **Pricing** (:meth:`Schedule.cost`): per-shard receive bytes per
   step, weighted by a per-collective calibration factor, plus the
   schedule's peak staging bytes weighted by
   ``FLAGS.tiling_memory_weight``, clamped at the receive-bytes floor
   (``tiling_cost.reshard_cost``).

3. **Decision + lowering** (:func:`decide`, :func:`constrain`): the
   cheapest schedule against the gather-everything-then-slice
   reference. Where the model predicts a strict win for a one-step
   ``all_to_all`` and every intermediate tiling divides the shape,
   :func:`constrain` runs the schedule (:func:`apply_schedule`);
   otherwise it returns the tensor it was given.

On a logical mesh (one device, ``parallel/mesh.py``)
:func:`apply_schedule` runs the schedule over a list of per-logical-shard
blocks of the one tensor: ``all_gather`` is a concatenation,
``all_to_all`` a split and re-concatenation and ``slice`` a block pick.
With the planner off, or with no predicted win, :func:`constrain`
returns its input with no copy: the tensor already holds every shard's
values.

On a group mesh each rank holds only its block (``array/distarray.py``),
so a layout change is a real move: :func:`relayout` runs the cheapest
schedule with :func:`apply_schedule_group`, whose ``all_gather`` and
``all_to_all`` steps are ``torch.distributed`` collectives over the
step's mesh-axis sub-group and whose ``slice`` is local; where no
schedule applies (a tuple-sharded axis, an uneven intermediate) the
piece exchange (:func:`move_pieces`) sends each rank only the runs of
its destination block it does not hold, in one ``all_to_all``. The
same exchange carries the local rules whose output blocks are no
schedule's (reshape, concatenate, slice, diagonal).
:func:`constrain` takes and returns such a local block (a
``DistArray``) whatever the planner flag says: the consumer reads the
blocks of the layout it asked for. Every step copies values and never
computes, so both forms are bit-equal to their input.

Everything is behind ``FLAGS.redistribution_planner`` (default off; one
flag read per constrained edge when off). The flag is in
``expr/base._opt_flags_key``, so planned and unplanned plans never
alias in the plan cache. Calibration factors (``_cal_factors``) come
from the cost ledger's active profile (``obs/ledger.factors``) under
``FLAGS.cost_calibration``; every factor is 1 otherwise.

Across meshes of different shapes (elastic recovery, a checkpoint
restored onto another grid), :func:`plan_transition` prices the
migration on the two grids and :func:`plan_rehome` plans one live
array's move onto a rebuilt mesh (``DistArray.rehome``).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..array.tiling import Tiling
from ..utils import profiling as prof
from ..utils.config import FLAGS
from . import mesh as mesh_mod

# hot paths read ._value directly (one attribute load per constrained
# edge when the planner is off)
_PLANNER_FLAG = FLAGS.flag("redistribution_planner")


def planner_on() -> bool:
    """One flag read — the hot-path gate every consumer shares."""
    return _PLANNER_FLAG._value


class Step(NamedTuple):
    """One step in a redistribution schedule.

    ``kind`` is 'all_gather' (release ``mesh_axis`` from array axis
    ``axis``), 'all_to_all' (move ``mesh_axis`` from array axis
    ``axis`` to ``to_axis``), or 'slice' (carve array axis ``axis``
    onto ``mesh_axis`` locally)."""

    kind: str
    axis: int
    mesh_axis: str
    to_axis: Optional[int] = None

    def describe(self) -> str:
        if self.kind == "all_to_all":
            return (f"all_to_all[{self.mesh_axis}:"
                    f"{self.axis}->{self.to_axis}]")
        if self.kind == "transfer":  # the cross-grid hop has no axis
            return "transfer"
        return f"{self.kind}[{self.mesh_axis}:{self.axis}]"


class Schedule:
    """A priced decomposition of one ``src -> dst`` redistribution.

    Byte quantities are stored as FRACTIONS of the full array's bytes
    (they scale linearly), so one enumeration per ``(src, dst, mesh
    shape)`` serves every array size: ``comm_frac`` maps collective
    class -> per-chip receive fraction, ``peak_frac`` is the largest
    per-chip intermediate any step materializes (the staging memory
    the redistribution paper trades against bytes), ``states`` the
    intermediate tilings (divisibility is checked against them before
    the explicit lowering is allowed)."""

    __slots__ = ("steps", "comm_frac", "peak_frac", "states")

    def __init__(self, steps: Tuple[Step, ...],
                 comm_frac: Dict[str, float], peak_frac: float,
                 states: Tuple[Tuple, ...]):
        self.steps = steps
        self.comm_frac = comm_frac
        self.peak_frac = peak_frac
        self.states = states

    def comm_bytes(self, nbytes: float,
                   factors: Optional[Dict[str, float]] = None) -> float:
        """Per-chip receive bytes, each collective class under its
        calibrated factor (identity without a profile)."""
        total = 0.0
        for cls, frac in self.comm_frac.items():
            f = factors.get(cls, 1.0) if factors else 1.0
            total += frac * nbytes * f
        return total

    def cost(self, nbytes: float,
             factors: Optional[Dict[str, float]] = None,
             mem_weight: Optional[float] = None) -> float:
        """The planner's objective: factored interconnect bytes + peak
        staging bytes under ``FLAGS.tiling_memory_weight``."""
        if mem_weight is None:
            mem_weight = float(
                getattr(FLAGS, "tiling_memory_weight", 0.0) or 0.0)
        return (self.comm_bytes(nbytes, factors)
                + mem_weight * self.peak_frac * nbytes)

    def describe(self) -> str:
        return " + ".join(s.describe() for s in self.steps) or "noop"

    def to_dict(self) -> Dict[str, Any]:
        return {"steps": [s.describe() for s in self.steps],
                "comm_frac": {k: round(v, 6)
                              for k, v in self.comm_frac.items()},
                "peak_frac": round(self.peak_frac, 6)}

    def __repr__(self) -> str:
        return f"Schedule({self.describe()})"


def _axis_size(sizes: Dict[str, int], ax: Any) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):  # multi-axis split (flat_row)
        p = 1
        for sub in ax:
            p *= sizes.get(sub, 1)
        return p
    return sizes.get(ax, 1)


def _parallelism(state: Tuple, sizes: Dict[str, int]) -> int:
    p = 1
    for a in state:
        p *= _axis_size(sizes, a)
    return p


# (src axes, dst axes, sorted mesh items) -> tuple of Schedules. The
# vocabulary is tiny (candidate tilings squared per mesh shape), so the
# memo never needs eviction; fractions are size-independent.
_sched_memo: Dict[Tuple, Tuple[Schedule, ...]] = {}


def _enumerate(src_axes: Tuple, dst_axes: Tuple,
               sizes: Dict[str, int]) -> Tuple[Schedule, ...]:
    """DFS over tiling states from ``src`` to ``dst`` with the three
    productive moves (gather a mismatched axis, slice a wanted axis
    onto a free mesh axis, all_to_all a mesh axis straight to where
    the destination wants it). Every simple path is a legal schedule;
    the caller prices and picks."""
    ndim = len(src_axes)
    out: List[Schedule] = []
    max_depth = 2 * ndim + 2

    def dfs(state: Tuple, steps: Tuple[Step, ...],
            comm: Dict[str, float], peak: float,
            states: Tuple[Tuple, ...], seen: frozenset) -> None:
        if state == dst_axes:
            out.append(Schedule(steps, dict(comm), peak, states))
            return
        if len(steps) >= max_depth or len(out) >= 64:
            return
        p_all = _parallelism(state, sizes)
        local = 1.0 / p_all
        used = {a for a in state if a is not None}
        for i in range(ndim):
            cur, want = state[i], dst_axes[i]
            if cur is not None and cur != want:
                m, p = cur, _axis_size(sizes, cur)
                # all_gather: release m from axis i — each chip
                # receives the (p-1) peer shards of the gathered axis
                nxt = state[:i] + (None,) + state[i + 1:]
                if nxt not in seen:
                    c = dict(comm)
                    c["all_gather"] = (c.get("all_gather", 0.0)
                                       + (p - 1) / p_all)
                    dfs(nxt, steps + (Step("all_gather", i, m),),
                        c, max(peak, local * p), states + (nxt,),
                        seen | {nxt})
                # all_to_all: move m to the axis j the destination
                # wants it on — each chip keeps 1/p of its shard
                for j in range(ndim):
                    if j == i or state[j] is not None \
                            or dst_axes[j] != m:
                        continue
                    nxt = list(state)
                    nxt[i], nxt[j] = None, m
                    nxt = tuple(nxt)
                    if nxt in seen:
                        continue
                    c = dict(comm)
                    c["all_to_all"] = (c.get("all_to_all", 0.0)
                                       + (p - 1) / p * local)
                    dfs(nxt, steps + (Step("all_to_all", i, m, j),),
                        c, max(peak, local), states + (nxt,),
                        seen | {nxt})
            elif cur is None and want is not None and want not in used:
                # slice: carve axis i onto the free mesh axis the
                # destination wants — no wire traffic
                nxt = state[:i] + (want,) + state[i + 1:]
                if nxt in seen:
                    continue
                p = _axis_size(sizes, want)
                dfs(nxt, steps + (Step("slice", i, want),),
                    dict(comm), max(peak, local / p),
                    states + (nxt,), seen | {nxt})

    dfs(src_axes, (), {}, 0.0, (), frozenset({src_axes}))
    return tuple(out)


def schedules(src: Tiling, dst: Tiling, mesh) -> Tuple[Schedule, ...]:
    """Every legal decomposition of ``src -> dst`` on ``mesh`` (empty
    when the transition is a no-op, uses tuple-sharded mesh axes the
    step vocabulary cannot express, or mismatches rank)."""
    if src.axes == dst.axes or len(src.axes) != len(dst.axes):
        return ()
    if any(isinstance(a, tuple) for a in src.axes + dst.axes):
        return ()  # multi-axis splits: GSPMD owns these
    key = (src.axes, dst.axes, tuple(sorted(mesh.shape.items())))
    hit = _sched_memo.get(key)
    if hit is None:
        hit = _sched_memo[key] = _enumerate(
            src.axes, dst.axes, dict(mesh.shape))
    return hit


def _canonical_frac(src_axes: Tuple, dst_axes: Tuple,
                    sizes: Dict[str, int]) -> float:
    """The gather-everything-then-slice reference — the model of
    GSPMD's generic lowering: every mismatched sharded source axis is
    fully gathered (in axis order), destination shards carved locally
    after. Returns the per-chip receive fraction."""
    state = list(src_axes)
    frac = 0.0
    for i, (cur, want) in enumerate(zip(src_axes, dst_axes)):
        if cur is not None and cur != want:
            p_all = 1
            for a in state:
                p_all *= _axis_size(sizes, a)
            frac += (_axis_size(sizes, cur) - 1) / p_all
            state[i] = None
    return frac


class Decision(NamedTuple):
    """What the planner chose for one reshard edge: the best
    ``schedule``, whether the ``explicit`` lowering should be emitted,
    the modeled ``cost`` / ``gspmd_cost`` (bytes-equivalent, factored),
    and a human ``reason`` for the explain report."""

    schedule: Schedule
    explicit: bool
    cost: float
    gspmd_cost: float
    reason: str


def decide(src: Tiling, dst: Tiling, shape: Tuple[int, ...], dtype: Any,
           mesh, factors: Optional[Dict[str, float]] = None
           ) -> Optional[Decision]:
    """Plan one edge: cheapest schedule + the explicit-vs-fallback
    call. None when the transition needs no schedule (same layout /
    rank mismatch / inexpressible). ``factors`` are the calibration
    profile's per-collective multipliers (``obs/ledger.factors()``) —
    the same dict the tiling DP prices with, so the lowering and the
    DP always agree on the winner."""
    scheds = schedules(src, dst, mesh)
    if not scheds:
        return None
    nbytes = float(int(np.prod(shape)) if shape else 1) \
        * np.dtype(dtype).itemsize
    best = min(scheds, key=lambda s: (s.cost(nbytes, factors),
                                      len(s.steps), s.describe()))
    gspmd = _canonical_frac(src.axes, dst.axes, dict(mesh.shape))
    g_f = factors.get("all_gather", 1.0) if factors else 1.0
    gspmd_cost = gspmd * nbytes * g_f
    cost = best.cost(nbytes, factors)
    if mesh_mod.device_count(mesh) <= 1:
        return Decision(best, False, cost, gspmd_cost,
                        "single device: nothing to move")
    if cost >= gspmd_cost or not best.steps:
        return Decision(best, False, cost, gspmd_cost,
                        "no modeled win over generic lowering")
    if len(best.steps) != 1 or best.steps[0].kind != "all_to_all":
        # The explicit lowering is emitted ONLY for the one-step
        # all_to_all transition (a mesh axis moving between two array
        # axes): that is the decomposition GSPMD's generic lowering
        # misses — it materializes the gathered axis — and the ONLY
        # shape the per-edge CPU A/B (benchmarks/redistribution.py
        # edge_ab) measures at or below the GSPMD arm. Gather/slice
        # routes and multi-step mixes measured WORSE: XLA fuses its
        # own gathers/slices better than an opaque shard_map can.
        # The DP still PRICES the full schedule (the model is about
        # edge cost, not lowering), and explain reports it.
        return Decision(best, False, cost, gspmd_cost,
                        "multi-step schedule: GSPMD's fused lowering "
                        "measured cheaper; modeled price kept")
    for state in (src.axes,) + best.states:
        if not Tiling(state).divisible(shape, mesh):
            return Decision(best, False, cost, gspmd_cost,
                            "indivisible intermediate: GSPMD pads")
    return Decision(best, True, cost, gspmd_cost,
                    f"modeled {cost:.0f} < gspmd {gspmd_cost:.0f} "
                    "bytes-equivalent")


def edge_cost(src: Tiling, dst: Tiling, nbytes: float, mesh,
              factors: Optional[Dict[str, float]] = None) -> float:
    """The tiling DP's planned edge price: the cheapest schedule's
    modeled cost (per-collective factors applied), clamped at the
    receive-bytes floor — the modeled cost can reorder schedules but
    never under-bids the bytes a correct redistribution must deliver.
    Falls back to the floor (under the legacy 'reshard' factor) for
    transitions the step vocabulary cannot express."""
    from ..expr.tiling_cost import reshard_cost  # lazy: layer order

    floor = reshard_cost(src, dst, nbytes, mesh)
    if floor <= 0.0:
        return floor  # same layout, or local carve: nothing to plan
    scheds = schedules(src, dst, mesh)
    if not scheds:
        f = factors.get("reshard", 1.0) if factors else 1.0
        return floor * f
    best = min(s.cost(nbytes, factors) for s in scheds)
    return max(best, floor)


def edge_components(src: Tiling, dst: Tiling, nbytes: float, mesh
                    ) -> Dict[str, float]:
    """Per-collective byte decomposition of one planned edge — the
    calibration vector ``tiling_cost.class_components`` records so
    ``obs/ledger.fit_profile`` can fit each collective's factor
    independently. Uncalibrated by construction (raw schedule bytes);
    falls back to the legacy lump 'reshard' class when unplannable."""
    from ..expr.tiling_cost import reshard_cost  # lazy: layer order

    scheds = schedules(src, dst, mesh)
    if scheds:
        best = min(scheds, key=lambda s: s.cost(nbytes))
        return {cls: frac * nbytes
                for cls, frac in best.comm_frac.items() if frac > 0}
    moved = reshard_cost(src, dst, nbytes, mesh)
    return {"reshard": moved} if moved > 0 else {}


def staging_frac(src: Tiling, dst: Tiling, mesh) -> Optional[float]:
    """Peak per-chip staging of the chosen schedule, as a fraction of
    the full array's bytes — the memory governor's schedule-derived
    reshard-staging price (``resilience/memory._staging_bytes``).
    None when no schedule exists (the layout-fraction fallback
    applies)."""
    scheds = schedules(src, dst, mesh)
    if not scheds:
        return None
    return min(scheds, key=lambda s: s.cost(1.0)).peak_frac


def _cal_factors() -> Optional[Dict[str, float]]:
    """The active calibration profile's factors (lazy import: obs sits
    beside, not below, the parallel layer)."""
    from ..obs import ledger

    return ledger.factors()


# -- cross-MESH-SHAPE transitions (elastic re-tiling) ---------------------
#
# Everything above plans src -> dst transitions on ONE mesh. An elastic
# recovery (parallel/mesh.rebuild_mesh after host/device loss) changes
# the mesh SHAPE: an M-device grid becomes an N-device survivor grid,
# and every live array and restored loop carry must be re-partitioned
# across grids. The same decomposition idea applies ("Memory-efficient
# array redistribution", PAPERS.md), with one extra step kind:
#
#   * ``transfer`` — the cross-grid hop itself: each destination chip
#     receives its shard of the CURRENT tiling state under the
#     destination grid's sizes. A fully-replicated state transfers for
#     free onto a survivor subset (every survivor already holds a full
#     copy); a sharded state re-fetches one destination-local shard per
#     chip (shard boundaries shift when the grid size changes).
#
# A cross-mesh schedule is then [gathers on the source grid]* +
# transfer + [local slices on the destination grid]*. The degenerate
# all-gather-everything + transfer(free) + slice route is the model of
# the gather fallback (host round-trip / GSPMD re-tile) — the route
# :meth:`DistArray.rehome` always had; the planner's job is to emit
# the cheaper direct repartition where every intermediate state
# divides the shape on its grid, and a REASONED fallback otherwise
# (tuple-sharded ``flat_row`` axes stay fallback: the step vocabulary
# cannot express a two-axis peel, and the reason says so).


class MigrationDecision(NamedTuple):
    """The planner's verdict for one cross-mesh-shape migration:
    ``schedule`` (None when nothing was plannable), ``route`` —
    ``direct`` (divisible repartition: executed as a sharding-to-
    sharding transfer), ``gather`` (replicate-then-carve fallback) or
    ``noop`` — the modeled per-chip wire ``cost`` (factored), total
    modeled ``bytes`` on the wire, and a human ``reason`` for the
    recovery span / ``st.explain`` migrations section."""

    schedule: Optional[Schedule]
    route: str
    cost: float
    bytes: float
    reason: str


# (src axes, dst axes, src grid items, dst grid items) -> schedules.
_cross_memo: Dict[Tuple, Tuple[Schedule, ...]] = {}


def _enumerate_cross(src_axes: Tuple, dst_axes: Tuple,
                     src_sizes: Dict[str, int],
                     dst_sizes: Dict[str, int]) -> Tuple[Schedule, ...]:
    """DFS over cross-grid schedules: phase 0 releases source-grid
    shardings (``all_gather`` priced on the SOURCE sizes), one
    ``transfer`` hops grids (receive = the state's local fraction on
    the DESTINATION sizes; free when replicated — survivors hold a
    full copy), phase 1 carves destination shardings (``slice``,
    free). ``states`` records (phase, axes) so divisibility is checked
    against the right grid."""
    ndim = len(src_axes)
    out: List[Schedule] = []

    def local(state: Tuple, sizes: Dict[str, int]) -> float:
        return 1.0 / _parallelism(state, sizes)

    def dfs_dst(state: Tuple, steps: Tuple[Step, ...],
                comm: Dict[str, float], peak: float,
                states: Tuple[Tuple, ...]) -> None:
        if state == dst_axes:
            out.append(Schedule(steps, dict(comm), peak, states))
            return
        if len(steps) >= 2 * ndim + 3 or len(out) >= 64:
            return
        used = {a for a in state if a is not None}
        for i in range(ndim):
            cur, want = state[i], dst_axes[i]
            if cur is None and want is not None and want not in used:
                nxt = state[:i] + (want,) + state[i + 1:]
                dfs_dst(nxt, steps + (Step("slice", i, want),),
                        comm, max(peak, local(nxt, dst_sizes)),
                        states + (("dst", nxt),))

    def dfs_src(state: Tuple, steps: Tuple[Step, ...],
                comm: Dict[str, float], peak: float,
                states: Tuple[Tuple, ...]) -> None:
        if len(out) >= 64:
            return
        # the transfer hop is legal from any state every destination
        # axis of which is either already right or still carvable:
        # phase 1 only ADDS shardings, never releases them
        ok = all(c is None or c == w
                 for c, w in zip(state, dst_axes))
        if ok:
            frac = (0.0 if all(a is None for a in state)
                    else local(state, dst_sizes))
            c = dict(comm)
            if frac > 0:
                c["transfer"] = c.get("transfer", 0.0) + frac
            dfs_dst(state,
                    steps + (Step("transfer", -1, "grid"),),
                    c, max(peak, local(state, dst_sizes)),
                    states + (("dst", state),))
        if len(steps) >= ndim + 1:
            return
        for i in range(ndim):
            cur = state[i]
            if cur is None:
                continue
            # release this source-grid sharding (all_gather on src)
            p = _axis_size(src_sizes, cur)
            nxt = state[:i] + (None,) + state[i + 1:]
            c = dict(comm)
            c["all_gather"] = (c.get("all_gather", 0.0)
                               + (p - 1) / _parallelism(state,
                                                        src_sizes))
            dfs_src(nxt, steps + (Step("all_gather", i, cur),),
                    c, max(peak, local(nxt, src_sizes)),
                    states + (("src", nxt),))

    dfs_src(src_axes, (), {}, local(src_axes, src_sizes),
            (("src", src_axes),))
    return tuple(out)


def cross_mesh_schedules(src: Tiling, src_sizes: Dict[str, int],
                         dst: Tiling, dst_sizes: Dict[str, int]
                         ) -> Tuple[Schedule, ...]:
    """Every legal cross-grid decomposition of ``src`` on the
    ``src_sizes`` grid -> ``dst`` on the ``dst_sizes`` grid. Empty for
    rank mismatches and tuple-sharded (flat_row) axes — the step
    vocabulary cannot peel a two-axis split, so those take the gather
    fallback with a recorded reason (:func:`plan_transition`)."""
    if len(src.axes) != len(dst.axes):
        return ()
    if any(isinstance(a, tuple) for a in src.axes + dst.axes):
        return ()
    key = (src.axes, dst.axes, tuple(sorted(src_sizes.items())),
           tuple(sorted(dst_sizes.items())))
    hit = _cross_memo.get(key)
    if hit is None:
        hit = _cross_memo[key] = _enumerate_cross(
            src.axes, dst.axes, dict(src_sizes), dict(dst_sizes))
    return hit


def _divides(axes: Tuple, shape: Tuple[int, ...],
             sizes: Dict[str, int]) -> bool:
    for d, a in zip(shape, axes):
        p = _axis_size(sizes, a)
        if p > 1 and int(d) % p != 0:
            return False
    return True


def plan_transition(src: Tiling, dst: Tiling,
                    src_sizes: Dict[str, int],
                    dst_sizes: Dict[str, int],
                    shape: Tuple[int, ...], dtype: Any,
                    factors: Optional[Dict[str, float]] = None
                    ) -> MigrationDecision:
    """Plan ONE cross-mesh-shape migration (elastic re-tiling): the
    cheapest schedule and whether the direct repartition route is
    safe, or the reasoned gather fallback. Never raises — migration
    planning is advisory; the executor (``DistArray.rehome``,
    checkpoint restore) always has the gather route."""
    nbytes = float(int(np.prod(shape)) if shape else 1) \
        * np.dtype(dtype).itemsize
    same_grid = dict(src_sizes) == dict(dst_sizes)
    if src.axes == dst.axes and same_grid:
        return MigrationDecision(None, "noop", 0.0, 0.0,
                                 "same tiling on the same grid")
    if any(isinstance(a, tuple) for a in src.axes + dst.axes):
        # flat_row and friends: a tuple-sharded axis needs a two-axis
        # peel the step vocabulary cannot express — documented status
        # (docs/REDISTRIBUTION.md), reasoned fallback, not a crash
        p_src = _parallelism(src.axes, src_sizes)
        moved = nbytes * (1.0 - 1.0 / max(p_src, 1))
        return MigrationDecision(
            None, "gather", moved, moved,
            "tuple-sharded (flat_row) axes: outside the step "
            "vocabulary; gather fallback")
    scheds = cross_mesh_schedules(src, src_sizes, dst, dst_sizes)
    if not scheds:
        p_src = _parallelism(src.axes, src_sizes)
        moved = nbytes * (1.0 - 1.0 / max(p_src, 1))
        return MigrationDecision(
            None, "gather", moved, moved,
            "no cross-grid schedule (rank/axis mismatch): gather "
            "fallback")
    best = min(scheds, key=lambda s: (s.cost(nbytes, factors),
                                      len(s.steps), s.describe()))
    # divisibility per phase: pre-transfer states must divide on the
    # SOURCE grid, post-transfer states on the DESTINATION grid — an
    # indivisible intermediate means padded shards whose boundaries
    # the direct repartition would mis-slice
    for phase, axes in best.states:
        sizes = src_sizes if phase == "src" else dst_sizes
        if not _divides(axes, shape, sizes):
            moved = best.comm_bytes(nbytes)
            return MigrationDecision(
                best, "gather", best.cost(nbytes, factors), moved,
                f"indivisible intermediate {axes} on the "
                f"{'survivor' if phase == 'dst' else 'source'} grid: "
                "gather fallback")
    moved = best.comm_bytes(nbytes)
    return MigrationDecision(
        best, "direct", best.cost(nbytes, factors), moved,
        f"planned {best.describe()} "
        f"(~{int(moved)} modeled wire bytes)")


def plan_rehome(arr: Any, dst_mesh) -> Tuple[Tiling, MigrationDecision]:
    """Plan one live array's migration onto ``dst_mesh`` (elastic
    recovery): the destination tiling is the source tiling sanitized for
    the survivor grid (axes that no longer divide are dropped), the
    decision :func:`plan_transition` under the calibration factors."""
    from ..array import tiling as tiling_mod

    shape = tuple(int(s) for s in arr.shape)
    dst_t = tiling_mod.sanitize(arr.tiling, shape, dst_mesh)
    dec = plan_transition(
        arr.tiling, dst_t, {k: int(v) for k, v in arr.mesh.shape.items()},
        {k: int(v) for k, v in dst_mesh.shape.items()},
        shape, arr.dtype, _cal_factors())
    return dst_t, dec


def _coords(mesh) -> List[Dict[str, int]]:
    """Every logical shard's mesh coordinate, row-major over the mesh
    axes (the JAX package's shard order)."""
    names = mesh.axis_names
    return [dict(zip(names, c))
            for c in itertools.product(*(range(mesh.shape[a])
                                         for a in names))]


def _key(c: Dict[str, int]) -> Tuple:
    return tuple(sorted(c.items()))


def _block(t: torch.Tensor, axes: Tuple, c: Dict[str, int],
           sizes: Dict[str, int]) -> torch.Tensor:
    """Shard ``c``'s block of the full tensor ``t`` under ``axes`` (a
    view; divisibility checked by the caller)."""
    for i, a in enumerate(axes):
        if a is not None:
            n = t.shape[i] // sizes[a]
            t = t.narrow(i, c[a] * n, n)
    return t


def apply_schedule(val: torch.Tensor, schedule: Schedule, src: Tiling,
                   dst: Tiling, mesh) -> torch.Tensor:
    """Run one schedule over the logical shards: split ``val`` into each
    shard's ``src`` block, apply the steps to the per-shard blocks
    (``all_gather``: concatenate the peers' blocks; ``all_to_all``:
    split along the destination axis and concatenate the peers' chunks
    along the source axis; ``slice``: keep this shard's block), then
    assemble the full tensor from the ``dst`` blocks. Copies only, so
    the result is bit-equal to ``val``. Callers must have checked
    divisibility (``decide`` does)."""
    sizes = dict(mesh.shape)
    coords = _coords(mesh)
    local = {_key(c): _block(val, src.axes, c, sizes) for c in coords}
    for step in schedule.steps:
        m, p = step.mesh_axis, sizes[step.mesh_axis]

        def peer(c: Dict[str, int], k: int) -> torch.Tensor:
            return local[_key({**c, m: k})]

        nxt = {}
        for c in coords:
            if step.kind == "all_gather":
                blk = torch.cat([peer(c, k) for k in range(p)],
                                dim=step.axis)
            elif step.kind == "all_to_all":
                blk = torch.cat(
                    [torch.chunk(peer(c, k), p, dim=step.to_axis)[c[m]]
                     for k in range(p)], dim=step.axis)
            else:  # slice: carve this shard's destination block
                blk = torch.chunk(local[_key(c)], p, dim=step.axis)[c[m]]
            nxt[_key(c)] = blk
        local = nxt
    out = torch.empty_like(val)
    free = [a for a in mesh.axis_names if a not in dst.axes]
    for c in coords:
        if all(c[a] == 0 for a in free):  # one writer per block
            _block(out, dst.axes, c, sizes).copy_(local[_key(c)])
    return out


def _best(src: Tiling, dst: Tiling, shape: Tuple[int, ...], dtype: Any,
          mesh) -> Optional[Schedule]:
    """The cheapest schedule of ``src -> dst`` (``decide``'s pick) when
    every state it passes through divides ``shape``, else None."""
    scheds = schedules(src, dst, mesh)
    if not scheds:
        return None
    nbytes = float(int(np.prod(shape)) if shape else 1) \
        * np.dtype(dtype).itemsize
    best = min(scheds, key=lambda s: (s.cost(nbytes), len(s.steps),
                                      s.describe()))
    for state in (src.axes,) + best.states:
        if not Tiling(state).divisible(shape, mesh):
            return None
    return best


def apply_schedule_group(block: torch.Tensor, schedule: Schedule,
                         shape: Tuple[int, ...], mesh) -> torch.Tensor:
    """Run one schedule on this rank's block of a group mesh array:
    ``all_gather`` gathers the step's array axis over its mesh-axis
    sub-group, ``all_to_all`` sends chunk ``j`` of the destination axis
    to position ``j`` and concatenates the chunks received along the
    source axis, and ``slice`` keeps this rank's chunk. Returns the
    rank's block under the schedule's destination tiling. Callers check
    divisibility (:func:`relayout` does)."""
    from . import collectives as coll

    for step in schedule.steps:
        m = step.mesh_axis
        if step.kind == "all_gather":
            block = coll.gather_dim(block, step.axis, m,
                                    int(shape[step.axis]), mesh)
        elif step.kind == "all_to_all":
            block = coll.exchange(block, m, step.to_axis, step.axis, mesh)
        else:  # slice: this rank's chunk, in storage of its own
            block = block.chunk(mesh.shape[m], step.axis)[
                mesh.coords[m]].clone()
    return block


# -- the piece exchange (a group mesh) ------------------------------------
#
# A node whose output blocks are not the blocks of one schedule (a
# reshape, a concatenation, a slice, a diagonal, an uneven relayout)
# moves only the pieces that change owner. Every position's part of
# each operand is a region of the OUTPUT array, known from shapes and
# tilings alone; the rows of those regions and of the output blocks in
# row-major order (``array/extent.flat_runs``) meet in runs, each sent
# by one holder to one receiver in ONE all_to_all of uneven pieces.
# Every rank computes the same table, so every rank makes the same
# collective, or none when no piece changes owner.


class Piece(NamedTuple):
    """One operand of :func:`move_pieces`: ``block`` is this rank's part
    (contiguous; its shape the region's), ``extent_of(coords)`` the
    region of the output the part of the position ``coords`` covers
    (None where it holds none), and ``free`` the mesh axes along which
    positions hold the same part (one of them, the receiver's own line,
    sends it)."""

    block: Any
    extent_of: Any
    free: Tuple[str, ...]


class RunSet:
    """A piece's region given by its row-major runs in the output (a
    reshaped block, which is no box of the output). Hashable: the route
    table is memoized on the pieces' regions."""

    __slots__ = ("runs", "_key")

    def __init__(self, runs, shape):
        self.runs = runs
        self._key = (runs[0].tobytes(), runs[1].tobytes(), tuple(shape))

    def __hash__(self) -> int:
        return hash(self._key)

    def __eq__(self, other) -> bool:
        return isinstance(other, RunSet) and other._key == self._key


def _runs_of(region, shape):
    from ..array import extent as extent_mod

    if isinstance(region, RunSet):
        return region.runs
    return extent_mod.flat_runs(region, shape)


class _Route(NamedTuple):
    """This rank's share of a piece exchange: runs as (piece, offsets
    in the piece's flat block, offsets in the output's flat block,
    lengths)."""

    send: Tuple  # per rank: ((piece, src offsets, lengths), ...)
    recv: Tuple  # per rank: ((dst offsets, lengths), ...)
    self_runs: Tuple  # ((piece, src offsets, dst offsets, lengths), ...)
    in_splits: Tuple[int, ...]
    out_splits: Tuple[int, ...]
    moves: bool  # any piece changes owner anywhere in the group


_route_memo: Dict[Tuple, _Route] = {}


def _merge_runs(src: np.ndarray, dst: np.ndarray, ln: np.ndarray):
    """Join runs contiguous on both sides."""
    if ln.shape[0] <= 1:
        return src, dst, ln
    brk = np.ones(ln.shape[0], bool)
    brk[1:] = ((src[:-1] + ln[:-1] != src[1:])
               | (dst[:-1] + ln[:-1] != dst[1:]))
    idx = np.flatnonzero(brk)
    sums = np.add.reduceat(ln, idx)
    return src[idx], dst[idx], sums


def _local_starts(runs) -> np.ndarray:
    return np.cumsum(runs[1]) - runs[1]


def _route(exts: Tuple, frees: Tuple, dst: Tiling, shape, mesh) -> _Route:
    """The run table of one exchange at this rank (memoized on its
    extents: a plan's walks repeat it)."""
    from ..array import extent as extent_mod

    me = mesh.pos
    key = (exts, frees, dst, tuple(shape), tuple(sorted(
        mesh.shape.items())), me)
    hit = _route_memo.get(key)
    if hit is not None:
        return hit
    coords = _coords(mesh)
    n = len(coords)
    out_runs = [extent_mod.flat_runs(dst.block_extent(shape, mesh, c),
                                     shape) for c in coords]
    src_runs = [[None if e is None else _runs_of(e, shape) for e in pe]
                for pe in exts]

    def pair(s: int, d: int):
        """The runs s sends d: (piece, src offsets, dst offsets, lens)."""
        out = []
        for j, (pe, free) in enumerate(zip(src_runs, frees)):
            runs = pe[s]
            if runs is None or any(coords[s][a] != coords[d][a]
                                   for a in free):
                continue
            st, ln, ai, bj = extent_mod.intersect_runs(runs, out_runs[d])
            if ln.shape[0] == 0:
                continue
            so = _local_starts(runs)[ai] + (st - runs[0][ai])
            do = _local_starts(out_runs[d])[bj] + (st - out_runs[d][0][bj])
            out.append((j,) + _merge_runs(so, do, ln))
        return out

    moves = False
    for s in range(n):
        for d in range(n):
            if s != d and pair(s, d):
                moves = True
                break
        if moves:
            break
    send, recv, in_splits, out_splits = [], [], [], []
    for r in range(n):
        if r == me:
            send.append(())
            recv.append(())
            in_splits.append(0)
            out_splits.append(0)
            continue
        to = pair(me, r)
        send.append(tuple((j, so, ln) for j, so, _, ln in to))
        in_splits.append(int(sum(int(ln.sum()) for _, _, _, ln in to)))
        frm = pair(r, me)
        recv.append(tuple((do, ln) for _, _, do, ln in frm))
        out_splits.append(int(sum(int(ln.sum()) for _, _, _, ln in frm)))
    own = tuple(pair(me, me))
    got = sum(out_splits) + sum(int(ln.sum()) for *_, ln in own)
    want = int(out_runs[me][1].sum())
    if got != want:
        raise RuntimeError(f"piece exchange covers {got} of the {want} "
                           f"elements of this rank's block")
    route = _Route(tuple(send), tuple(recv), own, tuple(in_splits),
                   tuple(out_splits), moves)
    if len(_route_memo) > 256:
        _route_memo.clear()
    _route_memo[key] = route
    return route


def _runs_view(flat: torch.Tensor, offs: np.ndarray, lens: np.ndarray):
    """The runs of the flat contiguous ``flat`` as one strided view
    (one run, or equal runs at a constant stride), else None."""
    if offs.shape[0] == 1:
        return flat.narrow(0, int(offs[0]), int(lens[0]))
    ln = int(lens[0])
    if not (lens == ln).all():
        return None
    step = np.diff(offs)
    if not (step == step[0]).all() or int(step[0]) < ln:
        return None
    return flat.as_strided((offs.shape[0], ln), (int(step[0]), 1),
                           flat.storage_offset() + int(offs[0]))


_LOOP_RUNS = 256  # irregular runs copied one by one up to this many


def _copy_runs(dst: torch.Tensor, d_off: np.ndarray, src: torch.Tensor,
               s_off: np.ndarray, lens: np.ndarray) -> None:
    """``dst``'s runs at ``d_off`` = ``src``'s at ``s_off`` (both flat,
    contiguous; equal ``lens``)."""
    if lens.shape[0] == 0:
        return
    dv, sv = _runs_view(dst, d_off, lens), _runs_view(src, s_off, lens)
    if dv is not None and sv is not None:
        dv.copy_(sv)
        return
    if lens.shape[0] <= _LOOP_RUNS:
        for a, b, n in zip(d_off.tolist(), s_off.tolist(), lens.tolist()):
            dst.narrow(0, a, n).copy_(src.narrow(0, b, n))
        return
    base = np.cumsum(lens) - lens
    step = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(base,
                                                                  lens)
    si = torch.from_numpy(np.repeat(s_off, lens) + step).to(src.device)
    di = torch.from_numpy(np.repeat(d_off, lens) + step).to(dst.device)
    dst.index_copy_(0, di, src.index_select(0, si))


def move_pieces(pieces, dst: Tiling, shape, dtype, mesh) -> torch.Tensor:
    """This rank's block of the output of ``shape`` under ``dst``,
    assembled from the :class:`Piece` s the positions hold: the runs a
    rank holds of its own block are copied in place, the rest arrive in
    one ``all_to_all`` of uneven pieces (:func:`collectives.exchange_v`,
    skipped when no piece changes owner anywhere). Copies only, so the
    values are bit-equal to the pieces'."""
    from . import collectives as coll

    shape = tuple(int(s) for s in shape)
    coords = _coords(mesh)
    exts = tuple(tuple(p.extent_of(c) for c in coords) for p in pieces)
    frees = tuple(tuple(p.free) for p in pieces)
    route = _route(exts, frees, dst, shape, mesh)
    dev = mesh.device
    for p in pieces:
        if p.block is not None:
            dev = p.block.device
            break
    out = torch.empty(dst.block_extent(shape, mesh).shape, dtype=dtype,
                      device=dev)
    flat_out = out.view(-1)
    flats = [None if p.block is None else p.block.contiguous().view(-1)
             for p in pieces]
    for j, so, do, ln in route.self_runs:
        _copy_runs(flat_out, do, flats[j], so, ln)
    if not route.moves:
        return out
    # the route is by position, the exchange by rank (a rotated mesh's
    # ranks hold other positions)
    rop = mesh.rank_of_pos
    by_rank = (range(len(coords)) if rop is None
               else [rop.index(r) for r in range(len(coords))])
    send = torch.empty(sum(route.in_splits), dtype=dtype, device=dev)
    pos = 0
    for p in by_rank:
        for j, so, ln in route.send[p]:
            total = int(ln.sum())
            _copy_runs(send.narrow(0, pos, total),
                       np.cumsum(ln) - ln, flats[j], so, ln)
            pos += total
    recv = coll.exchange_v(send, [route.in_splits[p] for p in by_rank],
                           [route.out_splits[p] for p in by_rank], mesh)
    del send
    pos = 0
    for p in by_rank:
        for do, ln in route.recv[p]:
            total = int(ln.sum())
            _copy_runs(flat_out, do, recv.narrow(0, pos, total),
                       np.cumsum(ln) - ln, ln)
            pos += total
    return out


def _copy_temp(d_off: np.ndarray, s_off: np.ndarray, lens: np.ndarray,
               itemsize: int) -> float:
    """Bytes :func:`_copy_runs` allocates for one copy: none for strided
    views or a loop of copies; two int64 index tensors and the gathered
    values on the index path."""
    if lens.shape[0] <= _LOOP_RUNS:
        return 0.0
    # a constant stride on both sides copies between views
    return 0.0 if _regular(d_off, lens) and _regular(s_off, lens) \
        else float(lens.sum()) * (16 + itemsize)


def _regular(offs: np.ndarray, lens: np.ndarray) -> bool:
    if offs.shape[0] == 1:
        return True
    step = np.diff(offs)
    return bool((lens == lens[0]).all() and (step == step[0]).all()
                and step[0] >= lens[0])


def exchange_staging(pieces_exts, frees, dst: Tiling, shape, mesh,
                     itemsize: int) -> float:
    """The bytes :func:`move_pieces` holds beside its output at this
    rank, at its peak: the send and received buffers live together
    (with the index tensors of an irregular copy), or an irregular copy
    of the rank's own runs before them (``resilience/memory.py``'s card
    model). ``pieces_exts`` are the pieces' ``extent_of`` functions."""
    coords = _coords(mesh)
    exts = tuple(tuple(f(c) for c in coords) for f in pieces_exts)
    route = _route(exts, tuple(tuple(f) for f in frees), dst,
                   tuple(int(s) for s in shape), mesh)
    own = max((_copy_temp(do, so, ln, itemsize)
               for _, so, do, ln in route.self_runs), default=0.0)
    if not route.moves:
        return own
    moved = max([_copy_temp(np.cumsum(ln) - ln, so, ln, itemsize)
                 for runs in route.send for _, so, ln in runs]
                + [_copy_temp(do, np.cumsum(ln) - ln, ln, itemsize)
                   for runs in route.recv for do, ln in runs] + [0.0])
    return max(own, float(sum(route.in_splits) + sum(route.out_splits))
               * itemsize + moved)


def free_axes(tiling: Tiling, mesh) -> Tuple[str, ...]:
    """The mesh axes ``tiling`` leaves unused (positions along them hold
    the same block)."""
    from ..array import tiling as tiling_mod

    used = {sub for a in tiling.axes for sub in tiling_mod.mesh_axes_of(a)}
    return tuple(a for a in mesh.axis_names if a not in used)


def same_blocks(a: Tiling, b: Tiling, shape, mesh) -> bool:
    """True when every position holds the same block of ``shape`` under
    ``a`` as under ``b`` (a size-1 mesh axis splits nothing)."""
    return all(a.block_extent(shape, mesh, c) == b.block_extent(shape, mesh,
                                                                 c)
               for c in _coords(mesh))


def block_piece(arr: Any) -> Piece:
    """A group mesh ``DistArray`` as one piece of an exchange of its own
    shape."""
    t, shape, mesh = arr.tiling, arr.shape, arr.mesh
    return Piece(arr.local,
                 lambda c: t.block_extent(shape, mesh, c),
                 free_axes(t, mesh))


def relayout(arr: Any, dst: Tiling) -> Any:
    """``arr`` (a DistArray on a group mesh) under ``dst``: each rank
    ends with its ``dst`` block. The cheapest schedule runs over the
    group (:func:`apply_schedule_group`); without one (an uneven or
    tuple-split layout) the pieces that change owner move in one
    exchange (:func:`move_pieces`), and a replicated source slices
    without moving a byte. A :class:`~..array.tiling.BoxTiling` on
    either side always takes the piece exchange."""
    from ..array.distarray import DistArray

    from ..array.tiling import BoxTiling

    src = arr.tiling
    if src == dst:
        return arr
    mesh, shape = arr.mesh, arr.shape
    if isinstance(src, BoxTiling) or isinstance(dst, BoxTiling):
        # a box's blocks follow its parent's grid: no schedule; where
        # every position already holds its destination part, nothing
        # moves and the block is not copied
        if all(src.block_extent(shape, mesh, c)
               == dst.block_extent(shape, mesh, c) for c in _coords(mesh)):
            return DistArray.from_local(arr.local, dst, shape, mesh)
        sched = None
    else:
        sched = _best(src, dst, shape, arr.dtype, mesh)
    if sched is not None:
        block = apply_schedule_group(arr.local, sched, shape, mesh)
    else:
        block = move_pieces([block_piece(arr)], dst, shape,
                            arr.local.dtype, mesh)
    return DistArray.from_local(block, dst, shape, mesh)


def constrain(val: Any, tiling: Tiling, mesh=None,
              src: Optional[Tiling] = None) -> Any:
    """The tiling seam: request ``tiling`` for the value ``val`` whose
    natural layout is ``src``. With the planner on and ``src`` known,
    an edge where the model predicts a win over the generic lowering
    runs its schedule (:func:`apply_schedule`, counted
    ``redistribute_explicit``); an edge without a win counts
    ``redistribute_fallback``. Otherwise — planner off, unknown source,
    the same layout — ``val`` comes back as it is, with no copy.

    On a group mesh ``val`` is a local block (a ``DistArray``) and
    comes back under ``tiling`` by a real move (:func:`relayout`)."""
    if getattr(val, "mesh", None) is not None and val.mesh.is_group:
        return relayout(val, tiling)
    if _PLANNER_FLAG._value and src is not None \
            and src.axes != tiling.axes:
        if mesh is None:
            mesh = mesh_mod.get_mesh()
        shape = tuple(int(s) for s in getattr(val, "shape", ()))
        from ..utils import dtypes

        d = decide(src, tiling, shape, dtypes.to_numpy(val.dtype), mesh,
                   _cal_factors())
        if d is not None and d.explicit:
            prof.count("redistribute_explicit")
            return apply_schedule(val, d.schedule, src, tiling, mesh)
        if d is not None:
            prof.count("redistribute_fallback")
    return val


def rotate_block(arr: Any, rmesh) -> Tuple[Any, int, int]:
    """``arr`` (a DistArray on an unrotated group mesh) on ``rmesh``, a
    rotation of that mesh over the same group (``mesh.rotated_mesh``):
    each rank ends with the block of its coordinates in ``rmesh``. A
    rank whose block there is the one it holds keeps it (every rank of
    a replicated array does); every other rank receives it from the
    rank that holds those coordinates unrotated, all in one
    ``all_to_all`` of uneven pieces (none when nothing moves). Returns
    (the array on ``rmesh``, bytes this rank sent, bytes it
    received)."""
    from ..array.distarray import DistArray
    from . import collectives as coll

    mesh, t, shape = arr.mesh, arr.tiling, arr.shape
    coords = _coords(mesh)
    rop = rmesh.rank_of_pos
    n = len(coords)
    # src[d]: the rank that sends rank d its rotated block, or None
    src: List[Optional[int]] = []
    for d in range(n):
        p = rop.index(d)
        same = (t.block_extent(shape, mesh, coords[d])
                == t.block_extent(shape, mesh, coords[p]))
        src.append(None if same else p)
    if all(s is None for s in src):
        return DistArray.from_local(arr.local, t, shape, rmesh), 0, 0
    me = mesh.rank
    blk = arr.local.contiguous()
    want = t.block_extent(shape, rmesh).shape
    # a rotation is a permutation: a rank sends to at most one rank
    to = [blk.numel() if src[d] == me else 0 for d in range(n)]
    frm = [int(np.prod(want, dtype=np.int64)) if src[me] == s else 0
           for s in range(n)]
    send = blk.reshape(-1) if any(to) else blk.new_empty(0)
    recv = coll.exchange_v(send, to, frm, mesh)
    out = blk if src[me] is None else recv.view(want)
    return (DistArray.from_local(out, t, shape, rmesh),
            sum(to) * blk.element_size(), sum(frm) * blk.element_size())
