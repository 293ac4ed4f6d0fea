"""Plan-time lints: donation protocol and tiling-consistency checks
(port of ``spartan_tpu/analysis/lints.py``).

These run over the RAW DAG before anything runs, catching at plan time
what the donation protocol only catches mid-walk (use-after-donate
reading a released tensor) or silently tolerates (double-donation — an
array that feeds two leaf slots), plus the declared-tiling vs kernel
divergence class: a ``SampleSortExpr`` whose forced output tiling
contradicts the tiling its ``partition_pack`` exchange produces (the
collective axis and batch axes of ``ops/sort.py``) forces a spurious
reshard.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..expr.base import Expr, ScalarExpr, ValExpr
from .verify import walk


class LintWarning(UserWarning):
    """Category for warning-level lint findings surfaced via
    ``warnings.warn`` (e.g. by the smart-tiling pass)."""


class LintFinding:
    """One lint finding. ``severity`` is ``"error"`` (``st.check``
    raises) or ``"warning"`` (reported, never fatal)."""

    __slots__ = ("severity", "kind", "message", "node_repr", "site")

    def __init__(self, severity: str, kind: str, message: str,
                 node: Optional[Expr] = None):
        self.severity = severity
        self.kind = kind
        self.message = message
        self.node_repr = repr(node) if node is not None else ""
        self.site = getattr(node, "_site", None)

    def __str__(self) -> str:
        loc = (f" [built at {self.site[0]}:{self.site[1]} "
               f"(in {self.site[2]})]" if self.site else "")
        on = f" on {self.node_repr}" if self.node_repr else ""
        return f"{self.kind}: {self.message}{on}{loc}"

    __repr__ = __str__


def _fmt_site(site) -> str:
    return (f"{site[0]}:{site[1]} (in {site[2]})" if site
            else "<unknown site>")


def _leaf_array(leaf: Expr):
    from ..array.distarray import DistArray

    if isinstance(leaf, ValExpr):
        return leaf.value
    if isinstance(leaf, ScalarExpr):
        return None
    r = leaf._result
    return r if isinstance(r, DistArray) else None


def plan_frontier(root: Expr) -> List[Expr]:
    """The nodes the plan signature treats as leaves — ``ValExpr`` /
    ``ScalarExpr`` leaves plus any interior node carrying a cached
    ``_result`` (the collapse frontier): exactly the slots a walk of the
    plan seeds from (expr/base.py ``_PlanSigCtx``)."""
    from ..array.distarray import DistArray

    out: List[Expr] = []
    seen: set = set()
    stack = [root]
    while stack:
        n = stack.pop()
        if n._id in seen:
            continue
        seen.add(n._id)
        if (isinstance(n, (ValExpr, ScalarExpr))
                or isinstance(n._result, DistArray)):
            out.append(n)
            continue
        try:
            stack.extend(k for k in n.children() if isinstance(k, Expr))
        except Exception:
            pass
    return out


def donation_findings(root: Expr,
                      donate: Sequence[Any] = ()) -> List[LintFinding]:
    """Use-after-donate and double-donation, detected by a DAG walk
    before anything runs."""
    from ..array.distarray import DistArray
    from ..expr.base import _norm_donate

    findings: List[LintFinding] = []
    donated_args = _norm_donate(donate)

    # donate=[x, x]: the same tensor released twice in one call
    seen_args: List[DistArray] = []
    for d in donated_args:
        if any(d is s for s in seen_args):
            findings.append(LintFinding(
                "error", "double_donation",
                f"{d!r} appears more than once in donate=[...]; one "
                "buffer cannot be released twice"))
        else:
            seen_args.append(d)

    # leaf census: every DistArray behind a plan-frontier slot
    slots: Dict[int, Tuple[DistArray, List[Expr]]] = {}
    for n in plan_frontier(root):
        arr = _leaf_array(n)
        if arr is None:
            continue
        ent = slots.setdefault(id(arr), (arr, []))
        ent[1].append(n)

    for arr, leaves in slots.values():
        if arr.is_donated:
            site = _fmt_site(getattr(arr, "_donate_site", None))
            findings.append(LintFinding(
                "error", "use_after_donate",
                f"leaf reads {arr!r} whose buffer was already released "
                f"by a donating evaluation (donated at {site}); rebuild "
                "the array or keep a copy instead of reusing the "
                "donated handle", leaves[0]))
            continue
        marked = arr._donate_next or any(arr is d for d in donated_args)
        if marked and len(leaves) > 1:
            findings.append(LintFinding(
                "error", "double_donation",
                f"{arr!r} is marked for donation but feeds "
                f"{len(leaves)} distinct leaf slots of this DAG; one "
                "buffer cannot back two donated arguments — donate a "
                "single shared leaf, or drop the donation", leaves[0]))
    # donating an array the DAG never reads donates nothing
    for d in seen_args:
        if id(d) not in slots and not d.is_donated:
            findings.append(LintFinding(
                "warning", "donation_unused",
                f"donate includes {d!r}, which is not a leaf of this "
                "DAG; its buffer will not be released by this "
                "evaluation"))
    return findings


def tiling_findings(nodes: List[Expr]) -> List[LintFinding]:
    """Declared-tiling consistency: the sort cross-check plus
    unresolvable / degenerate tiling warnings."""
    from ..expr.builtins import SampleSortExpr
    from ..parallel import mesh as mesh_mod

    mesh = mesh_mod.get_mesh()
    findings: List[LintFinding] = []
    for n in nodes:
        try:
            t = n.out_tiling()
        except NotImplementedError:
            findings.append(LintFinding(
                "error", "missing_tiling",
                f"{type(n).__name__} implements no _default_tiling and "
                "has no forced tiling", n))
            continue
        except Exception:
            continue  # tiling derivable only in a richer context
        if t.ndim != n.ndim:
            findings.append(LintFinding(
                "error", "tiling_rank",
                f"out_tiling rank {t.ndim} != node rank {n.ndim}", n))
            continue

        # unresolvable: names a mesh axis the ambient mesh lacks
        names = [a for ax in t.axes if ax is not None
                 for a in (ax if isinstance(ax, tuple) else (ax,))]
        unknown = [a for a in names if a not in mesh.shape]
        if unknown:
            findings.append(LintFinding(
                "warning", "unresolvable_tiling",
                f"tiling {t.axes} names mesh axes {unknown} absent "
                f"from the ambient mesh {dict(mesh.shape)}; the "
                "constraint cannot be honored", n))
            continue
        # degenerate / non-dividing tiles
        for i, (d, parts) in enumerate(zip(n.shape, t.tiles_per_dim(mesh))):
            if parts > 1 and d < parts:
                findings.append(LintFinding(
                    "warning", "degenerate_tile",
                    f"axis {i} (size {d}) is split {parts} ways — "
                    "fewer elements than shards; the layout degrades "
                    "to padding/replication", n))
            elif parts > 1 and d % parts != 0:
                findings.append(LintFinding(
                    "warning", "unresolvable_tiling",
                    f"axis {i} (size {d}) does not divide into "
                    f"{parts} shards; the shards are uneven and the "
                    "planned layout will not materialize exactly", n))

        # a sort whose DECLARED output tiling contradicts the tiling its
        # partition_pack exchange produces (the collective axis and
        # batch axes of ops/sort.py) forces a spurious reshard
        if isinstance(n, SampleSortExpr) and n._forced_tiling is not None:
            expected = n._default_tiling()
            if t.axes != expected.axes:
                findings.append(LintFinding(
                    "error", "sort_tiling_mismatch",
                    f"declared/forced output tiling {t.axes} diverges "
                    f"from the tiling the sort's exchange produces "
                    f"{expected.axes} (collective axis / batch axes are "
                    "fixed by ops/sort.py collective_axis/batch_axes); "
                    "the constraint forces a spurious reshard after "
                    "the exchange", n))
    return findings


def forced_tiling_findings(root: Expr) -> List[LintFinding]:
    """Tiling-pass output check: findings for forced tilings the
    mesh/shape cannot honor (read by the smart-tiling pass under
    ``FLAGS.verify_passes`` and by :func:`lint`)."""
    nodes, cycle = walk(root)
    if cycle is not None:
        return []
    return tiling_findings([n for n in nodes if n._forced_tiling is not None])


def lint(expr: Any, donate: Sequence[Any] = ()) -> List[LintFinding]:
    """All plan-time lint findings for a DAG (never raises)."""
    from ..expr.base import as_expr

    root = expr if isinstance(expr, Expr) else as_expr(expr)
    nodes, cycle = walk(root)
    if cycle is not None:
        return [LintFinding(
            "error", "cycle", "expression graph contains a cycle", cycle)]
    findings = donation_findings(root, donate)
    findings.extend(tiling_findings(nodes))
    return findings
