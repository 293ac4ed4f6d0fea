"""Regression guard for the port's measured figures (port of
``spartan_tpu/utils/benchguard.py``).

``spartan_tpu_torch/utils/thresholds.json`` commits per-platform bounds
(``min`` for rates, ``max`` for durations) on the figures of
``chip_smoke.py`` that hold steady from run to run; :func:`check`
grades a metrics dict against them. Its one platform, ``cuda``, records
the card's name and power limit as ``nvidia-smi`` gives them, because a
bound taken on one card says nothing of another: ``chip_smoke.py``'s
``[benchguard]`` phase grades a run only on the card the file names and
prints ``ungraded: <card>`` elsewhere, as an unguarded platform grades
all-pass here. The JAX package's ``benchmarks/thresholds.json`` is its
own and is not read.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

THRESHOLDS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "thresholds.json")


def load_thresholds(platform: str,
                    path: Optional[str] = None) -> Dict[str, Any]:
    """The committed thresholds for ``platform`` (e.g. 'cuda'); empty
    when the file or the platform entry is missing (an unguarded
    platform grades as all-pass)."""
    p = path or THRESHOLDS_PATH
    try:
        with open(p) as f:
            table = json.load(f)
    except (OSError, ValueError):
        return {}
    entry = table.get(platform, {})
    return entry if isinstance(entry, dict) else {}


def check(metrics: Dict[str, float], platform: str,
          path: Optional[str] = None) -> Dict[str, Any]:
    """Grade ``metrics`` against the committed thresholds.

    Returns ``{"pass": bool, "checked": n, "results": {metric: {"value",
    "min"|"max", "pass"}}}``. Metrics without a committed threshold are
    reported unchecked rather than failed, so a new metric does not
    break older files."""
    thr = load_thresholds(platform, path)
    results: Dict[str, Any] = {}
    ok = True
    checked = 0
    for name, value in metrics.items():
        rule = thr.get(name)
        if not isinstance(rule, dict) or value is None:
            results[name] = {"value": value, "pass": None}
            continue
        entry: Dict[str, Any] = {"value": value}
        good = True
        if "min" in rule:
            entry["min"] = rule["min"]
            good = good and value >= rule["min"]
        if "max" in rule:
            entry["max"] = rule["max"]
            good = good and value <= rule["max"]
        entry["pass"] = good
        results[name] = entry
        checked += 1
        ok = ok and good
    return {"pass": ok, "checked": checked, "results": results}
