"""Collective records and their wire-byte model (port of
``spartan_tpu/analysis/hlo.py``, without its parser).

The JAX package parses the post-GSPMD HLO text of a compiled plan for
its collective instructions. The port runs no XLA program: there is no
HLO here and no parser. Its plan auditor (``analysis/plan_audit.py``)
lists the collectives a group walk of the plan issues, and this module
keeps the parts of the JAX file that are not the parser, under the same
names: the :class:`CollectiveOp` record with its payload rule, the ring
model :func:`modeled_bytes`, and :func:`collective_multiset`.

The byte model (ring algorithms, uniform links): per participant of a
``g``-way group moving ``B`` payload bytes, ``all-gather`` /
``reduce-scatter`` / ``all-to-all`` cost ``B*(g-1)/g``, ``all-reduce``
``2*B*(g-1)/g`` (reduce-scatter + all-gather), ``collective-permute``
``B`` (one send per position). What matters is that it is
deterministic, monotone in payload and platform independent.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

#: the port's collective op names -> the JAX package's HLO kind names
KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather",
        "all_to_all": "all-to-all", "ring_permute": "collective-permute",
        "reduce_scatter": "reduce-scatter"}


def modeled_bytes(kind: str, payload_bytes: float, group: int) -> float:
    """Per-position modeled wire bytes (ring model; module docstring)."""
    if group <= 1:
        return 0.0
    ring = payload_bytes * (group - 1) / group
    if kind == "all-reduce":
        return 2.0 * ring
    if kind == "collective-permute":
        return payload_bytes
    return ring  # all-gather / reduce-scatter / all-to-all


class CollectiveOp:
    """One collective of a plan's group walk."""

    __slots__ = ("kind", "result_bytes", "operand_bytes", "group_size",
                 "bytes_moved", "scope_digest", "op_name", "source")

    def __init__(self, kind: str, result_bytes: float,
                 operand_bytes: float, group_size: int,
                 scope_digest: Optional[str], op_name: Optional[str],
                 source: Optional[str]):
        self.kind = kind
        self.result_bytes = result_bytes
        self.operand_bytes = operand_bytes
        self.group_size = group_size
        # payload: what each participant contributes — the operand
        # side for reducing/scattering ops, the (gathered) result for
        # all-gather, where the output is what travels
        payload = (result_bytes if kind == "all-gather"
                   else max(operand_bytes, result_bytes)
                   if kind == "all-to-all" else operand_bytes
                   or result_bytes)
        self.bytes_moved = modeled_bytes(kind, payload, group_size)
        self.scope_digest = scope_digest
        self.op_name = op_name
        self.source = source

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "result_bytes": self.result_bytes,
                "operand_bytes": self.operand_bytes,
                "group_size": self.group_size,
                "bytes_moved": self.bytes_moved,
                "scope_digest": self.scope_digest,
                "op_name": self.op_name, "source": self.source}

    def __repr__(self) -> str:
        who = f" @{self.scope_digest}" if self.scope_digest else ""
        return (f"<{self.kind} g={self.group_size} "
                f"~{self.bytes_moved:.0f}B{who}>")


def result_bytes(kind: str, operand_bytes: float, group: int) -> float:
    """A position's result bytes of one collective over ``group``
    positions: an all-gather ``g`` blocks, a reduce-scatter one ``g``-th,
    the others their operand's size."""
    if kind == "all-gather":
        return float(operand_bytes) * max(1, group)
    if kind == "reduce-scatter":
        return float(operand_bytes) / max(1, group)
    return float(operand_bytes)


def collective_multiset(ops: List[CollectiveOp]) -> Dict[str, int]:
    """``{kind: count}`` over the plan."""
    out: Dict[str, int] = {}
    for op in ops:
        out[op.kind] = out.get(op.kind, 0) + 1
    return out
