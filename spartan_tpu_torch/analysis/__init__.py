"""Static analysis over the lazy expression DAG (port of
``spartan_tpu/analysis``): the checking layer for the optimizer
pipeline. Nothing here runs a kernel.

* :mod:`verify` — the DAG well-formedness verifier. One traversal
  re-derives every node's shape/dtype from its children (via the node's
  own ``replace_children`` constructor, which IS the shape rule) and
  validates structure: acyclicity, child types, broadcast legality, axis
  bounds, ``_sig`` coverage.
* :mod:`passes` — optimizer-pass invariant checking. With
  ``FLAGS.verify_passes`` on (env ``SPARTAN_TPU_TORCH_VERIFY_PASSES``)
  ``optimize()`` snapshots the DAG around every registered ``Pass`` and
  asserts shape/dtype/leaf preservation plus well-formedness, naming the
  offending pass.
* :mod:`lints` — plan-time lints: use-after-donate and double-donation
  before anything runs, the sample sort's declared tiling against the
  tiling its exchange produces, and unresolvable/degenerate tilings.

* :mod:`plan_audit` (with :mod:`hlo`'s records and byte model) — the
  static communication audit, ``st.audit_plan``: the collectives a
  group walk of the plan issues, listed by a dry walk on shapes alone
  (the JAX package reads them out of post-GSPMD HLO), with
  ``full_gather`` / ``replicated_intermediate`` / ``missed_donation``
  findings.

Public surface (``st.check`` / ``st.lint``):

* ``check(expr, donate=())`` — raise :class:`VerificationError` on any
  violation or error-severity lint; returns the warning-level findings
  otherwise.
* ``lint(expr, donate=())`` — return ALL findings without raising.
"""

from typing import Any, List, Sequence

from .lints import LintFinding, LintWarning, lint
from .passes import PassInvariantError
from .plan_audit import AuditFinding, PlanAudit, audit_plan
from .verify import VerificationError, Violation, verify_dag, walk

__all__ = ["check", "lint", "verify_dag", "walk", "Violation",
           "LintFinding", "LintWarning", "VerificationError",
           "PassInvariantError", "audit_plan", "PlanAudit",
           "AuditFinding"]


def check(expr: Any, donate: Sequence[Any] = ()) -> List[LintFinding]:
    """Statically verify an expression DAG (nothing runs).

    Runs the well-formedness verifier plus the plan-time lints and
    raises :class:`VerificationError` — annotated with each offending
    node's user build site — if anything error-severity surfaces.
    Returns the warning-level findings (possibly empty) otherwise."""
    from ..expr.base import Expr, as_expr

    root = expr if isinstance(expr, Expr) else as_expr(expr)
    problems: List[str] = []
    vios = verify_dag(root)
    problems.extend(str(v) for v in vios)
    findings: List[LintFinding] = []
    if not any(v.kind == "cycle" for v in vios):
        # lints traverse out_tiling()/children; unsafe over a cyclic DAG
        findings = lint(root, donate)
        problems.extend(str(f) for f in findings if f.severity == "error")
    if problems:
        raise VerificationError(
            "expression DAG failed static verification:\n  "
            + "\n  ".join(problems))
    return [f for f in findings if f.severity != "error"]
