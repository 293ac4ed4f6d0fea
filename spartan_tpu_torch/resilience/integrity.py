"""Silent-data-corruption sentinel: detect, attribute, quarantine (port
of ``spartan_tpu/resilience/integrity.py``).

**Detect** (``FLAGS.integrity_check``). Every Nth non-donating walk of a
plan (N = ``max(1, FLAGS.profile_sample_every)``, the profiler's
cadence) gets two pieces of evidence: a CRC32 of each logical block of
the result just produced, and a redundant re-walk of the same plan on a
rotated mesh (``parallel/mesh.rotated_mesh``: the same shape, every
logical coordinate held by another position). Healthy, the two walks
are bit-equal; any disagreement is a violation, and the corrupt result
is never returned: :func:`maybe_check` raises :class:`IntegrityError`
(class ``sdc``) before ``expr/base.py::_run`` wraps it, and the policy
engine runs the plan again.

**Attribute.** For each logical block the CRCs of both walks vote;
every position holding a minority value is implicated (a tie
implicates every holder: the position of the first walk and its
rotated shadow). Implicated positions take strikes in a window of the
last 32 violations; because the rotation advances on every check, a
shadow is implicated once while a position that corrupts every result
is implicated every time. Strikes that age out of the window exonerate.

**Remedy.** A position whose strikes reach
``FLAGS.sdc_quarantine_strikes`` is quarantined through
``elastic.quarantine_device`` (drain, ``rebuild_mesh`` without it,
evict the dead epoch's plans); its arrays rehome when next used.

**One card.** The port's positions on one card are logical: the
rotated mesh is a permutation of position ids over the same device, and
the re-walk computes the same values. A block's CRC is byte-identical
to the JAX package's ``shard_checksums`` for the same values, keyed by
the same logical index, where the output's tiling gives every position
a block of its own. Where it does not (a replicated or partly
replicated output), the positions' copies are one tensor on one card:
each position is then held to its row-major chunk of the array's
elements (keyed ``("chunk", lo, hi)``), so a corrupt byte implicates
the position whose chunk it falls in. The chaos kind ``sdc@N[#d]``
(``resilience/faults.py``) flips one seeded bit in position d's unit
through :func:`flip_bit`, the same byte and bit the JAX package flips
in a block.

**Group mesh.** Each rank is one position of the grid and holds its
own block, so the evidence is the JAX package's per shard: each rank
computes the CRC of its own output block, keyed by the JAX package's
``shard_checksums`` index (each dim's ``(lo, hi)``, ``(0, -1)`` where
the dim is whole), under its rank id; nothing is gathered. The re-walk
runs on the rotated mesh over the same group (``mesh.rotated_mesh``:
rank r holds the coordinates of the position rotation k gives it),
after each leaf's block has moved to the rank that holds its
coordinates there (``redistribute.rotate_block``: one all-to-all;
replicated leaves do not move). Every rank's records from both walks
meet in one all-gather, and every rank runs the same vote over the same
ballots, so every rank reaches the same verdict, strikes and
quarantine, and raises the same error or none. The cadence counts each
plan's walks on every rank: a rank that walks a plan the others do not
walks out of step, and the ballots' check of the plan, walk count and
rotation raises on every rank (or the group's timeout does, should a
rank not reach the gather at all).

A process group cannot drop a member in its processes, so a quarantine
there is recorded, noted to the monitor and counted as on one card,
and the error it raises is classified ``fatal_mesh``: the policy
engine and a checkpointed ``st.loop`` end rather than retry, and a
world without that rank resumes from the per-rank snapshots
(``resilience/loop_ckpt.py``). The decision and the strikes are the JAX
package's; the remedy is a restart.

Not covered: corruption in an unsampled walk (the cadence is a screen,
not a proof), corruption that hits both walks alike, and donated walks
(their inputs are gone, so no re-walk exists; they are skipped).
"""

from __future__ import annotations

import threading
import zlib
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..obs import profile as profile_mod
from ..obs import trace as trace_mod
from ..obs.metrics import METRICS_FLAG as _METRICS_FLAG
from ..obs.metrics import REGISTRY, labeled
from ..utils.config import FLAGS
from ..utils.log import log_warn

_CHECK_FLAG = FLAGS.define_bool(
    "integrity_check", False,
    "Screen sampled walks for silent data corruption: a CRC32 per "
    "logical block and a redundant re-walk on a rotated mesh (rides the "
    "profile_sample_every cadence). A disagreement raises "
    "IntegrityError (class 'sdc') instead of returning the corrupt "
    "result; repeat offenders are quarantined out of the mesh. One "
    "flag read per walk when off.")
_STRIKES_FLAG = FLAGS.define_int(
    "sdc_quarantine_strikes", 3,
    "In-window strikes that confirm a suspect position and trigger its "
    "quarantine (rebuild_mesh without it). Positions whose strikes age "
    "out of the window first are exonerated.")

# strike window, in violations: older strikes age out
_WINDOW = 32
_COUNTS_MAX = 256
_LAST_MAX = 32
_HISTORY_MAX = 16

_lock = threading.Lock()
_tls = threading.local()

_counts: Dict[str, int] = {}                 # plan digest -> walks seen
_last_by_plan: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
_strikes: Dict[int, Any] = {}                # position id -> deque of seqs
_exonerated: Dict[int, int] = {}
_history: Any = deque(maxlen=_HISTORY_MAX)   # quarantine records
_seq = 0
_checks = 0
_violations = 0


class IntegrityError(RuntimeError):
    """A sampled walk failed its checksum cross-check: the result just
    produced disagrees per block with a redundant re-walk of the same
    plan. The result is discarded (never wrapped, cached or returned);
    the policy engine runs the plan again. ``suspects`` names the
    implicated positions; ``quarantined`` is set when this violation
    crossed the strike threshold and the suspect left the mesh (the
    retry then meets a ``StaleMeshError``: rehome the inputs)."""

    fault_kind = "sdc"

    def __init__(self, msg: str, suspects: Sequence[int] = (),
                 quarantined: Optional[int] = None, restart: bool = False):
        super().__init__(msg)
        self.suspects = tuple(suspects)
        self.quarantined = quarantined
        if restart:
            # a group mesh cannot drop the rank in its processes: the
            # world ends (resilience/classify: fatal_mesh) and restarts
            self.fault_kind = "sdc_quarantine"


# -- the checksum walk ------------------------------------------------------


def _units(shape: Tuple[int, ...], tiling: Any, mesh: Any
           ) -> List[Tuple[Tuple, int, Any]]:
    """(index key, position id, block) per position: its block of the
    output's tiling when every position has one of its own, else its
    row-major chunk of the flattened elements (module docstring). A
    block is a tuple of slices; a chunk a (lo, hi) element range."""
    from ..array import extent as extent_mod
    from ..array import tiling as tiling_mod
    from ..parallel import mesh as mesh_mod

    nx, ny = mesh.shape[mesh_mod.AXIS_ROW], mesh.shape[mesh_mod.AXIS_COL]
    ndev = nx * ny
    t = tiling_mod.sanitize(tiling, shape, mesh)
    p = 1
    for n in t.tiles_per_dim(mesh):
        p *= int(n)
    out = []
    if p == ndev:
        for pos in range(ndev):
            coords = {mesh_mod.AXIS_ROW: pos // ny,
                      mesh_mod.AXIS_COL: pos % ny}
            key, sl = [], []
            for d, a in zip(shape, t.axes):
                n = tiling_mod.tile_count(a, mesh)
                if n == 1:
                    key.append((0, -1))
                    sl.append(slice(None))
                    continue
                lo, hi = extent_mod.compute_splits(int(d), n)[
                    tiling_mod.tile_index(a, coords, mesh)]
                key.append((lo, hi))
                sl.append(slice(lo, hi))
            out.append((tuple(key), mesh.ids[pos], tuple(sl)))
        return out
    size = 1
    for d in shape:
        size *= int(d)
    splits = extent_mod.compute_splits(size, ndev)
    for pos in range(ndev):
        lo, hi = splits[pos] if pos < len(splits) else (size, size)
        out.append((("chunk", lo, hi), mesh.ids[pos], (lo, hi)))
    return out


def _unit_bytes(t: torch.Tensor, unit: Any) -> torch.Tensor:
    """The unit of ``t`` as a contiguous uint8 CPU tensor (a copy)."""
    if isinstance(unit, tuple) and unit and isinstance(unit[0], int):
        blk = t.reshape(-1)[unit[0]:unit[1]]
    else:
        blk = t[unit] if unit else t
    return blk.contiguous().cpu().reshape(-1).view(torch.uint8).clone()


def shard_checksums(t: torch.Tensor, tiling: Any, mesh: Any
                    ) -> List[Tuple[Tuple, int, int]]:
    """``(index_key, position_id, crc32)`` per position of the output
    ``t`` under ``tiling`` on ``mesh``, sorted (one read of each block
    to the host; the sampled path only)."""
    recs = []
    for key, pid, unit in _units(tuple(t.shape), tiling, mesh):
        recs.append((key, int(pid),
                     zlib.crc32(_unit_bytes(t, unit).numpy().tobytes())))
    recs.sort()
    return recs


def flip_bit(out: Any, victim: int, seed: int, occurrence: int,
             tilings: Sequence[Any], mesh: Any) -> Any:
    """The chaos ``sdc`` kind's surgery: one seeded bit flipped in the
    first output's unit held by position ``victim`` (the JAX package's
    byte and bit: ``crc32(f"{seed}:sdc:{occurrence}")`` picks the byte
    of the unit and, shifted by 8, the bit). Returns a corrupt copy,
    or ``out`` unchanged when the victim holds no unit."""
    outs = out if isinstance(out, tuple) else (out,)
    word = zlib.crc32(f"{seed}:sdc:{occurrence}".encode())
    if mesh.is_group:
        return _flip_group(out, outs, victim, word, tilings, mesh)
    for i, (o, t) in enumerate(zip(outs, tilings)):
        if not isinstance(o, torch.Tensor) or o.numel() == 0:
            continue
        for _key, pid, unit in _units(tuple(o.shape), t, mesh):
            if int(pid) != int(victim):
                continue
            flat = _unit_bytes(o, unit)
            if flat.numel() == 0:
                break
            flat[word % flat.numel()] ^= (1 << ((word >> 8) % 8))
            bad = o.clone()
            fixed = flat.view(o.dtype).to(o.device)
            if isinstance(unit, tuple) and unit and isinstance(unit[0],
                                                               int):
                bad.reshape(-1)[unit[0]:unit[1]] = fixed
            else:
                bad[unit] = fixed.reshape(bad[unit].shape)
            lst = list(outs)
            lst[i] = bad
            return tuple(lst) if isinstance(out, tuple) else bad
    return out


def _flip_group(out: Any, outs: Sequence[Any], victim: int, word: int,
                tilings: Sequence[Any], mesh: Any) -> Any:
    """:func:`flip_bit` on a group mesh: every rank brings its outputs
    to their tilings (a relayout may be a collective), and only the
    victim's rank flips the bit, in its own block of the first output
    whose block there is not empty."""
    from ..array.distarray import DistArray
    from ..parallel import redistribute as redist_mod

    lst = [redist_mod.relayout(o, t) if isinstance(o, DistArray) else o
           for o, t in zip(outs, tilings)]
    if mesh.rank == int(victim):
        for i, o in enumerate(lst):
            if not isinstance(o, DistArray) or o.local.numel() == 0:
                continue
            flat = _unit_bytes(o.local, ())
            flat[word % flat.numel()] ^= (1 << ((word >> 8) % 8))
            lst[i] = DistArray.from_local(
                flat.view(o.local.dtype).to(o.local.device).reshape(
                    o.local.shape), o.tiling, o.shape, mesh)
            break
    return tuple(lst) if isinstance(out, tuple) else lst[0]


def block_records(o: Any, tiling: Any, mesh: Any
                  ) -> List[Tuple[Tuple, int, int]]:
    """This rank's record on a group mesh: ``(index_key, rank,
    crc32)`` of its block of the output ``o`` (a local value) under
    ``tiling``, keyed as the JAX package's ``shard_checksums`` keys the
    shard at the rank's coordinates."""
    from ..array import tiling as tiling_mod
    from ..parallel import redistribute as redist_mod

    t = tiling_mod.sanitize(tiling, o.shape, mesh)
    o = redist_mod.relayout(o, t)
    ext = o.block_extent()
    key = tuple((0, -1) if tiling_mod.tile_count(a, mesh) == 1 else (lo, hi)
                for a, lo, hi in zip(t.axes, ext.ul, ext.lr))
    crc = zlib.crc32(_unit_bytes(o.local, ()).numpy().tobytes())
    return [(key, int(mesh.rank), crc)]


# -- detect -------------------------------------------------------------------


def maybe_check(plan: Any, out: Any, leaves: Sequence[Any],
                donated: bool, mesh: Any) -> None:
    """The walk's hook (``expr/base.py::_run``, before the result is
    wrapped): every Nth non-donating walk of a plan gets the
    cross-check. Raises :class:`IntegrityError` on a failed check."""
    if donated:
        return  # the inputs are gone: no re-walk exists
    report = plan.report
    digest = report.get("plan_key") if report else None
    if digest is None:
        return
    n = max(1, profile_mod._SAMPLE_FLAG._value)
    with _lock:
        c = _counts.get(digest, 0) + 1
        _counts[digest] = c
        while len(_counts) > _COUNTS_MAX:
            _counts.pop(next(iter(_counts)))
    if c % n != 0:
        return
    _check(plan, out, leaves, mesh, digest, c)


def _rewalk(plan: Any, leaves: Sequence[Any], mesh: Any) -> Any:
    """The plan walked again on ``mesh`` (a rotated logical mesh), from
    the same leaves."""
    from ..expr import base
    from ..parallel import mesh as mesh_mod

    with mesh_mod.use_mesh(mesh):
        env = base.walk_env(plan, leaves, mesh)
        return plan.dag.lower(env)


def _rewalk_group(plan: Any, leaves: Sequence[Any], mesh: Any,
                  rmesh: Any, moved: Dict[str, int]) -> Any:
    """The plan walked again on the rotated group mesh ``rmesh``: each
    leaf's block first moves to the rank holding its coordinates there
    (``moved`` adds up this rank's bytes sent and received)."""
    from ..expr import base
    from ..parallel import mesh as mesh_mod
    from ..parallel import redistribute as redist_mod

    seeds = None
    if rmesh is not mesh:  # a one-rank group walks again in place
        seeds = []
        for leaf in leaves:
            arr, sent, recv = redist_mod.rotate_block(
                base._leaf_local(leaf, mesh), rmesh)
            moved["sent"] += sent
            moved["recv"] += recv
            seeds.append(arr)
    with mesh_mod.use_mesh(rmesh), base.launch_guard(rmesh):
        env = base.walk_env(plan, leaves, rmesh, seeds)
        del seeds
        return plan.dag.lower_local(env)


def _stable_tag(plan: Any) -> str:
    """A digest of the plan that is the same in every process (the
    report's ``plan_key`` hashes with the process's string hash)."""
    from ..persist import fingerprint

    try:
        return fingerprint.stable_digest(plan.key)
    except fingerprint.UnstableKeyError:  # a user function in the key
        return fingerprint.stable_digest(
            [type(plan.dag).__name__, list(plan.dag.shape)]
            + [list(t.axes) for t in plan.out_tilings])


def _ballots(mesh: Any, mine: Tuple) -> Tuple[List[List[Tuple]],
                                              List[List[Tuple]]]:
    """Every rank's records of both walks, from one all-gather over the
    group: (primary, reference), each per output and sorted. Raises on
    every rank when the ranks sampled different walks."""
    import torch.distributed as dist

    got: List[Any] = [None] * dist.get_world_size(mesh.group)
    dist.all_gather_object(got, mine, group=mesh.group)
    heads = {g[0] for g in got}
    if len(heads) != 1:
        raise RuntimeError(
            f"integrity: the ranks checked different walks (plan, walk, "
            f"rotation) {sorted(heads)}; every rank must walk every plan "
            "for the sampled walks to line up")
    n_out = len(mine[1])
    primary = [sorted(r for g in got for r in g[1][i]) for i in range(n_out)]
    reference = [sorted(r for g in got for r in g[2][i])
                 for i in range(n_out)]
    return primary, reference


def _check(plan: Any, out: Any, leaves: Sequence[Any], mesh: Any,
           digest: str, walk: int = 0) -> None:
    global _checks, _violations
    from ..parallel import mesh as mesh_mod

    moved = {"sent": 0, "recv": 0}
    with trace_mod.span("integrity_check", plan=digest):
        outs = out if plan.is_tuple else (out,)
        with _lock:
            k = 1 + (_checks % max(1, len(mesh.ids) - 1))
        if mesh.is_group:
            rmesh = mesh_mod.rotated_mesh(mesh, k) or mesh
            mine = [block_records(o, t, mesh)
                    for o, t in zip(outs, plan.out_tilings)]
            out2 = _rewalk_group(plan, leaves, mesh, rmesh, moved)
            outs2 = out2 if plan.is_tuple else (out2,)
            theirs = [block_records(o, t, rmesh)
                      for o, t in zip(outs2, plan.out_tilings)]
            del out2, outs2
            primary, reference = _ballots(
                mesh, ((_stable_tag(plan), walk, k), mine, theirs))
        else:
            primary = [shard_checksums(o, t, mesh)
                       for o, t in zip(outs, plan.out_tilings)]
            rmesh = mesh_mod.rotated_mesh(mesh, k) or mesh
            out2 = _rewalk(plan, leaves, rmesh)
            outs2 = out2 if plan.is_tuple else (out2,)
            reference = [shard_checksums(o, t, rmesh)
                         for o, t in zip(outs2, plan.out_tilings)]
        disagreements = _compare(primary, reference)
    with _lock:
        _checks += 1
        checks = _checks
    verdict: Dict[str, Any] = {
        "verdict": "ok" if not disagreements else "violation",
        "plan": digest, "check": checks, "rotation": k,
        "t": trace_mod.now(),
    }
    if mesh.is_group:
        verdict.update(moved_sent=moved["sent"], moved_recv=moved["recv"])
    if _METRICS_FLAG._value:
        REGISTRY.counter(
            "integrity_checks",
            "sampled walks screened by the SDC sentinel (checksum and "
            "rotated re-walk cross-check)").inc()
    if not disagreements:
        _stamp(digest, plan, verdict)
        return
    implicated = sorted({d for rec in disagreements
                         for d in rec["devices"]})
    verdict.update(shards=len(disagreements), suspects=implicated)
    with _lock:
        _violations += 1
    if _METRICS_FLAG._value:
        REGISTRY.counter(
            "integrity_violations",
            "integrity checks whose block checksums disagreed between "
            "the walk and its rotated re-walk").inc()
    trace_mod.instant("integrity_violation", error=True, plan=digest,
                      shards=len(disagreements), suspects=str(implicated))
    log_warn("integrity: violation on plan %s — %d block(s) disagree, "
             "implicating positions %s", digest, len(disagreements),
             implicated)
    suspect = note_violation(implicated)
    with _lock:
        verdict["strikes"] = {str(d): len(_strikes.get(d, ()))
                              for d in implicated}
    if suspect is not None:
        verdict["quarantined"] = suspect
        _stamp(digest, plan, verdict)
        if mesh.is_group:
            _quarantine_group(suspect, digest)
            raise IntegrityError(
                f"integrity violation: block checksum mismatch on plan "
                f"{digest} ({len(disagreements)} block(s)); rank "
                f"{suspect} crossed {max(1, _STRIKES_FLAG._value)} strikes "
                "and is quarantined — the result was discarded; a process "
                "group cannot drop a rank in its processes: restart the "
                "world without it and resume from the per-rank snapshots",
                suspects=implicated, quarantined=suspect, restart=True)
        _quarantine(suspect, digest)
        raise IntegrityError(
            f"integrity violation: block checksum mismatch on plan "
            f"{digest} ({len(disagreements)} block(s)); position "
            f"{suspect} crossed {max(1, _STRIKES_FLAG._value)} strikes "
            "and was quarantined — the result was discarded; rehome the "
            "inputs onto the rebuilt mesh", suspects=implicated,
            quarantined=suspect)
    _stamp(digest, plan, verdict)
    raise IntegrityError(
        f"integrity violation: block checksum mismatch on plan {digest} "
        f"({len(disagreements)} block(s), suspect positions "
        f"{implicated}) — the result was discarded; a clean retry "
        "follows", suspects=implicated)


def _compare(primary: List[List[Tuple]], reference: List[List[Tuple]]
             ) -> List[Dict[str, Any]]:
    """Vote per logical block: every CRC from both walks is a ballot,
    and the positions holding a minority value are implicated (a tie
    implicates every holder)."""
    out: List[Dict[str, Any]] = []
    for leaf, (a_recs, b_recs) in enumerate(zip(primary, reference)):
        by_index: Dict[Any, List[Tuple[int, int]]] = {}
        for idx, dev, crc in a_recs + b_recs:
            by_index.setdefault(idx, []).append((dev, crc))
        for idx, votes in sorted(by_index.items(), key=lambda kv:
                                 str(kv[0])):
            crcs = [crc for _, crc in votes]
            if len(set(crcs)) <= 1:
                continue
            counts: Dict[int, int] = {}
            for crc in crcs:
                counts[crc] = counts.get(crc, 0) + 1
            best = max(counts.values())
            majority = {crc for crc, n in counts.items() if n == best}
            if len(majority) > 1:
                losers = {dev for dev, _ in votes}
            else:
                truth = next(iter(majority))
                losers = {dev for dev, crc in votes if crc != truth}
            out.append({"leaf": leaf, "index": str(idx),
                        "devices": sorted(losers)})
    return out


# -- attribute ----------------------------------------------------------------


def note_violation(implicated: Sequence[int]) -> Optional[int]:
    """Record one violation's implicated positions in the strike window;
    returns the position to quarantine when one crossed
    ``FLAGS.sdc_quarantine_strikes`` (the worst offender, ties to the
    lowest id), else None. Positions whose strikes all aged out are
    exonerated. Pure bookkeeping (the JAX package's sequence)."""
    global _seq
    threshold = max(1, _STRIKES_FLAG._value)
    with _lock:
        _seq += 1
        seq = _seq
        for d in implicated:
            _strikes.setdefault(int(d), deque(maxlen=_WINDOW)).append(seq)
        for d in list(_strikes):
            dq = _strikes[d]
            while dq and dq[0] <= seq - _WINDOW:
                dq.popleft()
            if not dq:
                del _strikes[d]
                _exonerated[d] = _exonerated.get(d, 0) + 1
                if _METRICS_FLAG._value:
                    REGISTRY.gauge(
                        labeled("integrity_strikes", device=str(d)),
                        "in-window SDC strikes per position").set(0.0)
                log_warn("integrity: position %d exonerated (strikes "
                         "aged out of the window)", d)
        if _METRICS_FLAG._value:
            for d in implicated:
                REGISTRY.gauge(
                    labeled("integrity_strikes", device=str(d)),
                    "in-window SDC strikes per position"
                ).set(float(len(_strikes.get(int(d), ()))))
        worst: Optional[int] = None
        for d in sorted(_strikes):
            n = len(_strikes[d])
            if n >= threshold and (worst is None
                                   or n > len(_strikes[worst])):
                worst = d
        return worst


# -- remedy -------------------------------------------------------------------


def _quarantine(suspect: int, digest: str) -> None:
    """Planned eviction of a confirmed suspect: the monitor's ``sdc``
    anomaly, then ``elastic.quarantine_device`` (drain -> rebuild_mesh
    without the suspect -> evict the dead epoch -> resume)."""
    from ..obs import monitor as monitor_mod
    from ..parallel import mesh as mesh_mod
    from . import elastic as elastic_mod

    with _lock:
        strikes = len(_strikes.get(suspect, ()))
    threshold = max(1, _STRIKES_FLAG._value)
    monitor_mod.note_anomaly(
        "sdc", key=f"device{suspect}", value=float(strikes),
        threshold=float(threshold),
        detail=f"integrity violations implicated position {suspect} "
               f"{strikes}x in-window (plan {digest}); quarantining")
    if _METRICS_FLAG._value:
        REGISTRY.counter(
            "integrity_quarantines",
            "suspect positions evicted from the mesh by the SDC "
            "sentinel's planned quarantine").inc()
    epoch_from = mesh_mod.mesh_epoch()
    elastic_mod.quarantine_device(suspect, reason="sdc")
    rec = {"device": int(suspect), "strikes": strikes,
           "epoch_from": epoch_from, "epoch_to": mesh_mod.mesh_epoch(),
           "plan": digest, "t": trace_mod.now()}
    with _lock:
        _history.append(rec)
        _strikes.pop(suspect, None)
    log_warn("integrity: position %d quarantined after %d strikes "
             "(mesh epoch %d -> %d)", suspect, strikes, rec["epoch_from"],
             rec["epoch_to"])


def _quarantine_group(suspect: int, digest: str) -> None:
    """A confirmed suspect on a group mesh, on every rank alike: the
    monitor's ``sdc`` anomaly, the count and the history record. No
    rebuild: the caller raises, and the world restarts without the
    rank (module docstring)."""
    from ..obs import monitor as monitor_mod
    from ..parallel import mesh as mesh_mod

    with _lock:
        strikes = len(_strikes.get(suspect, ()))
    threshold = max(1, _STRIKES_FLAG._value)
    monitor_mod.note_anomaly(
        "sdc", key=f"device{suspect}", value=float(strikes),
        threshold=float(threshold),
        detail=f"integrity violations implicated rank {suspect} "
               f"{strikes}x in-window (plan {digest}); quarantining: "
               "restart the world without it")
    if _METRICS_FLAG._value:
        REGISTRY.counter(
            "integrity_quarantines",
            "suspect positions evicted from the mesh by the SDC "
            "sentinel's planned quarantine").inc()
    epoch = mesh_mod.mesh_epoch()
    rec = {"device": int(suspect), "strikes": strikes,
           "epoch_from": epoch, "epoch_to": epoch, "plan": digest,
           "remedy": "restart", "t": trace_mod.now()}
    with _lock:
        _history.append(rec)
        _strikes.pop(suspect, None)
    log_warn("integrity: rank %d quarantined after %d strikes; the group "
             "ends and restarts without it", suspect, strikes)


# -- surfaces -----------------------------------------------------------------


def _stamp(digest: str, plan: Any, verdict: Dict[str, Any]) -> None:
    with _lock:
        _last_by_plan[digest] = verdict
        _last_by_plan.move_to_end(digest)
        while len(_last_by_plan) > _LAST_MAX:
            _last_by_plan.popitem(last=False)
    if plan.report is not None:
        plan.report["integrity"] = dict(verdict)
    pending = getattr(_tls, "last_check", None)
    if pending is None:
        pending = {"checks": 0, "violations": 0}
        _tls.last_check = pending
    pending["checks"] += 1
    pending["plan"] = digest
    pending["verdict"] = verdict["verdict"]
    if verdict["verdict"] != "ok":
        pending["violations"] += 1
        pending["suspects"] = verdict.get("suspects")
    if verdict.get("quarantined") is not None:
        pending["quarantined"] = verdict["quarantined"]


def take_last_check() -> Optional[Dict[str, Any]]:
    """Pop the calling thread's integrity summary since the last pop."""
    out = getattr(_tls, "last_check", None)
    _tls.last_check = None
    return out


def status() -> Optional[Dict[str, Any]]:
    """Checks run, violations, in-window strikes per position,
    exonerations and the quarantine history; None when the sentinel has
    never run."""
    with _lock:
        if not _checks and not _history and not _strikes:
            return None
        return {
            "checks": _checks,
            "violations": _violations,
            "strikes": {str(d): len(dq)
                        for d, dq in sorted(_strikes.items())},
            "exonerated": {str(d): n
                           for d, n in sorted(_exonerated.items())},
            "quarantined": [dict(r) for r in _history],
            "window": _WINDOW,
            "threshold": max(1, _STRIKES_FLAG._value),
        }


def current() -> Dict[str, Dict[str, Any]]:
    """The latest verdict per plan digest (bounded)."""
    with _lock:
        return {k: dict(v) for k, v in _last_by_plan.items()}


def quarantine_history() -> List[Dict[str, Any]]:
    with _lock:
        return [dict(r) for r in _history]


def reset() -> None:
    """Drop all sentinel state (counters, strikes, history)."""
    global _seq, _checks, _violations
    with _lock:
        _counts.clear()
        _last_by_plan.clear()
        _strikes.clear()
        _exonerated.clear()
        _history.clear()
        _seq = 0
        _checks = 0
        _violations = 0
    _tls.last_check = None
