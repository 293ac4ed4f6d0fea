"""Smart-tiling pass: choose tilings via the cost model (port of
``spartan_tpu/expr/tiling_pass.py``).

Builds the candidate table and runs the DP of ``tiling_cost.py``,
writing ``_forced_tiling`` / ``_dot_plan`` on the DAG's nodes. It runs
only on plan-cache misses: ``evaluate`` keys the complete plan, these
choices included, on the raw DAG's signature, so iterative applications
run the cost model once per structure, not once per step. Under
``FLAGS.verify_passes`` the tilings it wrote are linted
(``analysis/lints.forced_tiling_findings``) and each warning-level
finding is raised as a ``LintWarning`` warning.
"""

from __future__ import annotations

from .base import Expr
from .optimize import Pass, register_pass


class SmartTilingPass(Pass):
    name = "auto_tiling"
    flag = "opt_auto_tiling"

    def run(self, root: Expr) -> Expr:
        from ..utils import profiling as prof
        from ..utils.config import FLAGS
        from . import tiling_cost

        # a "tiling" sub-span (nested under "pass:auto_tiling" in the
        # trace ring): the candidate table and DP are the dominant
        # per-miss planning cost
        with prof.phase("tiling"):
            root = tiling_cost.assign_tilings(root)
        if FLAGS.verify_passes:
            # forced tilings the mesh/shape cannot honor are reshards or
            # uneven shards the plan did not price: warn at plan time
            import warnings

            from ..analysis.lints import LintWarning, forced_tiling_findings

            for f in forced_tiling_findings(root):
                if f.severity == "warning":
                    warnings.warn(str(f), LintWarning, stacklevel=2)
        return root


register_pass(SmartTilingPass())
