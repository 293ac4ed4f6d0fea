"""Deprecated caller-level recovery (port of
``spartan_tpu/utils/recovery.py``).

``evaluate()`` runs the resilience policy engine itself (classifier,
retry, the OOM ladder, elastic recovery), so callers normally need
nothing more. :func:`evaluate_with_recovery` is kept as a thin
deprecated shim over :func:`spartan_tpu_torch.resilience.engine.
retry_evaluate`: on a retryable failure it drops the cached result
(``invalidate``: the DAG is the recovery log), calls
``on_failure(attempt, exc)`` and evaluates again. With the default
``retryable=None`` the classifier decides, so deterministic errors are
not retried; an explicit tuple keeps the isinstance rule.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Tuple

# kept for importers of the old module; the classifier supersedes it
_DEFAULT_RETRYABLE: Tuple[type, ...] = (RuntimeError, OSError)


def evaluate_with_recovery(expr: Any, retries: int = 2,
                           backoff_s: float = 0.0,
                           retryable: Optional[Tuple[type, ...]] = None,
                           on_failure: Optional[Callable] = None):
    """Evaluate ``expr``, re-evaluating it from lineage on a retryable
    failure.

    .. deprecated::
        ``evaluate()`` runs the policy engine itself; use it directly,
        or ``resilience.engine.retry_evaluate`` for an explicit
        caller-level loop."""
    warnings.warn(
        "evaluate_with_recovery is deprecated: evaluate() now runs the "
        "resilience policy engine itself (classifier + retry + OOM "
        "degradation + elastic recovery). For an explicit caller-level "
        "loop use spartan_tpu_torch.resilience.engine.retry_evaluate.",
        DeprecationWarning, stacklevel=2)
    from ..resilience.engine import retry_evaluate

    return retry_evaluate(expr, retries=retries, backoff_s=backoff_s,
                          retryable=retryable, on_failure=on_failure)
