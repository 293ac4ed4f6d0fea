"""Smart-tiling pass: choose tilings via the cost model (port of
``spartan_tpu/expr/tiling_pass.py``).

Builds the candidate table and runs the DP of ``tiling_cost.py``,
writing ``_forced_tiling`` / ``_dot_plan`` on the DAG's nodes. It runs
only on plan-cache misses: ``evaluate`` keys the complete plan, these
choices included, on the raw DAG's signature, so iterative applications
run the cost model once per structure, not once per step. The JAX
package's ``FLAGS.verify_passes`` lints wait for ``analysis/lints.py``
(ROADMAP A4).
"""

from __future__ import annotations

from .base import Expr
from .optimize import Pass, register_pass


class SmartTilingPass(Pass):
    name = "auto_tiling"
    flag = "opt_auto_tiling"

    def run(self, root: Expr) -> Expr:
        from ..utils import profiling as prof
        from . import tiling_cost

        # a "tiling" sub-span (nested under "pass:auto_tiling" in the
        # trace ring): the candidate table and DP are the dominant
        # per-miss planning cost
        with prof.phase("tiling"):
            return tiling_cost.assign_tilings(root)


register_pass(SmartTilingPass())
