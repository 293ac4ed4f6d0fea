"""Typed global FLAGS registry (the port's own copy of
``spartan_tpu/utils/config.py``, holding only the flags this package
reads).

Flags gate the optimizer passes (the smart-tiling pass and its cost
weights among them), the plan cache, the kernel layer, the
redistribution planner, loop-carry sharding and the observability
layer, and set the checkpointed loop's restore budget.
Each flag takes its initial value from the environment variable
``SPARTAN_TPU_TORCH_<NAME>`` when that is set.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

# Bumped on every flag write: memoized keys over flag values (the plan
# cache's optimizer-flag key, expr/base.py) stay valid until it moves.
_mutations = 0


def mutation_count() -> int:
    return _mutations


def _parse_bool(text: str) -> bool:
    return text.lower() in ("1", "true", "yes", "on")


def _parse_int_list(text: str) -> List[int]:
    return [int(x) for x in text.split(",") if x]


class Flag:
    """A single typed flag with a default and an env-var override. Hot
    paths read ``_value`` directly (one attribute load)."""

    def __init__(self, name: str, default: Any, help: str = "",
                 parser: Callable[[str], Any] = str):
        self.name = name
        self.default = default
        self.help = help
        self.parser = parser
        self._value = default
        env = os.environ.get("SPARTAN_TPU_TORCH_" + name.upper())
        if env is not None:
            self._value = parser(env)
        # reset() restores the value as configured at definition time
        # (env override included), not the compiled-in default
        self._initial = self._value

    @property
    def value(self) -> Any:
        return self._value

    @value.setter
    def value(self, v: Any) -> None:
        global _mutations
        self._value = v
        _mutations += 1

    def parse(self, text: str) -> None:
        self.value = self.parser(text)

    def reset(self) -> None:
        self.value = self._initial


class FlagRegistry:
    """Global registry; modules register flags at import time.

    Access as attributes: ``FLAGS.opt_map_fusion``."""

    def __init__(self) -> None:
        object.__setattr__(self, "_flags", {})
        object.__setattr__(self, "_lock", threading.Lock())

    def define(self, name: str, default: Any, help: str = "",
               parser: Optional[Callable[[str], Any]] = None) -> Flag:
        with self._lock:
            if name in self._flags:
                return self._flags[name]
            if parser is None:
                parser = _parse_bool if isinstance(default, bool) else str
            flag = Flag(name, default, help, parser)
            self._flags[name] = flag
            return flag

    def define_bool(self, name: str, default: bool, help: str = "") -> Flag:
        return self.define(name, default, help, _parse_bool)

    def define_str(self, name: str, default: str, help: str = "") -> Flag:
        return self.define(name, default, help, str)

    def define_int(self, name: str, default: int, help: str = "") -> Flag:
        return self.define(name, default, help, int)

    def define_float(self, name: str, default: float,
                     help: str = "") -> Flag:
        return self.define(name, default, help, float)

    def define_int_list(self, name: str, default: List[int],
                        help: str = "") -> Flag:
        return self.define(name, default, help, _parse_int_list)

    def flag(self, name: str) -> Flag:
        """The Flag object itself: hot paths keep it and read
        ``._value`` instead of going through ``__getattr__``."""
        return self._flags[name]

    def __getattr__(self, name: str) -> Any:
        flags: Dict[str, Flag] = object.__getattribute__(self, "_flags")
        if name in flags:
            return flags[name]._value
        raise AttributeError(f"undefined flag: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        flags: Dict[str, Flag] = object.__getattribute__(self, "_flags")
        if name not in flags:
            raise AttributeError(
                f"undefined flag: {name}; call FLAGS.define() first")
        flags[name].value = value

    def parse_args(self, argv: Optional[List[str]] = None) -> List[str]:
        """Parse ``--flag=value`` / ``--flag value`` arguments for the
        defined flags; returns the arguments it does not know."""
        import argparse

        parser = argparse.ArgumentParser(add_help=False)
        for flag in self._flags.values():
            parser.add_argument("--" + flag.name, type=str, default=None)
        ns, rest = parser.parse_known_args(argv)
        for flag in self._flags.values():
            text = getattr(ns, flag.name, None)
            if text is not None:
                flag.parse(text)
        return rest

    def __contains__(self, name: str) -> bool:
        return name in self._flags

    def __iter__(self) -> Iterator[Flag]:
        return iter(self._flags.values())

    def reset_all(self) -> None:
        """Every flag back to its value at definition time."""
        for flag in self._flags.values():
            flag.reset()

    def snapshot(self) -> Dict[str, Any]:
        return {f.name: f.value for f in self._flags.values()}

    def snapshot_nondefault(self) -> Dict[str, Any]:
        """Flags whose value differs from the compiled-in default: the
        compact record of the flag state a measurement ran under."""
        return {f.name: f.value for f in self._flags.values()
                if f.value != f.default}


FLAGS = FlagRegistry()

FLAGS.define_bool("opt_map_fusion", True,
                  "Fuse chained elementwise map exprs into one kernel.")
FLAGS.define_bool("opt_reduce_fusion", True,
                  "Fuse a map producer into a consuming reduce.")
FLAGS.define_bool("opt_collapse_cached", True,
                  "Collapse already-evaluated sub-DAGs into leaves.")
FLAGS.define_bool("opt_auto_tiling", True,
                  "Smart-tiling pass: pick tilings via the cost model.")
FLAGS.define_bool(
    "plan_cache", True,
    "Cache the evaluation plan (optimized DAG, leaf order, out tilings) "
    "keyed on the RAW DAG's structural signature, so steady-state "
    "evaluate() skips the optimizer stack and re-signing entirely.")
FLAGS.define_str(
    "native_kernels", "auto",
    "Hand-written kernel layer (spartan_tpu_torch/kernels): auto and on "
    "= the fused kernel module runs whenever its constraints hold "
    "(the CUDA kernel for CUDA tensors, its plain torch version for CPU "
    "tensors); off = the expr path always. Part of the plan cache key.")
FLAGS.define_int(
    "loop_restore_max", 3,
    "Max checkpoint restores per checkpointed st.loop run before the "
    "failure propagates (guards against a persistently failing segment "
    "looping forever).")
FLAGS.define_float(
    "tiling_compute_weight", 0.0,
    "Bytes-priced compute weight for NON-contraction nodes in the "
    "smart-tiling cost model (0 = built-in default).")
FLAGS.define_float(
    "tiling_flop_weight", 0.0,
    "Bytes-equivalent cost of one contraction FLOP in the smart-tiling "
    "cost model (0 = per-device-type default; calibrate with "
    "tiling_cost.calibrate_flop_weight).")
FLAGS.define_float(
    "tiling_operand_move_weight", 0.0,
    "Weight on GEMM operand-reshard bytes vs output-psum bytes in the "
    "smart-tiling cost model (0 = built-in calibrated default).")
FLAGS.define_float(
    "tiling_memory_weight", 0.0,
    "Soft memory term in the smart-tiling cost model: each candidate "
    "tiling's cost gains weight x its per-shard OUTPUT bytes. 0 = off. "
    "Part of the plan cache key.")
FLAGS.define_bool(
    "trace_annotations", True,
    "While a torch.profiler capture is active, wrap every expr node's "
    "evaluation in a record_function range named after the node, so "
    "device profiles attribute kernels back to expr nodes (no cost "
    "when no profiler is recording).")
FLAGS.define_bool(
    "trace_loop_steps", False,
    "Record one 'loop_step' span per st.loop iteration in the trace "
    "ring (host clock marks between iterations, never a device sync). "
    "Part of the loop's structural signature.")
FLAGS.define_str(
    "profile_dir", os.path.join(tempfile.gettempdir(),
                                "spartan_tpu_torch_profile"),
    "Default destination for explicit device-profile captures "
    "(utils/profiling.profile_trace -> obs.trace.device_profile).")
FLAGS.define_bool(
    "trace", True,
    "Record host-side spans (evaluate/sign/optimize/per-pass/tiling/"
    "build/dispatch) into the in-memory ring buffer for st.trace_export. "
    "A clock pair and a deque append per span; never a device sync.")
FLAGS.define_int(
    "trace_ring", 4096,
    "Maximum spans retained in the in-memory trace ring buffer; older "
    "spans are dropped when it wraps.")
FLAGS.define_bool(
    "metrics", True,
    "Record counters and phase histograms into the obs metrics registry "
    "(st.metrics). Gates the utils/profiling layer (count/record_phase); "
    "plan-cache behaviour is unaffected, only its visibility.")
FLAGS.define_int(
    "metrics_hist_window", 2048,
    "Samples retained per histogram for the p50/p95 estimates "
    "(count/sum/max are exact and unwindowed).")
FLAGS.define_bool(
    "redistribution_planner", False,
    "Plan every tiling->tiling reshard edge as an explicit collective "
    "schedule (all_gather / all_to_all / slice) chosen by a cost model: "
    "the tiling DP prices edges by the modeled schedule, and the "
    "lowering runs the explicit schedule over the logical shards where "
    "the model predicts a win (parallel/redistribute.py). Part of the "
    "plan cache key.")
FLAGS.define_bool(
    "shard_loop_carries", False,
    "Shard large replicated loop carries across the mesh: a carry whose "
    "init is replicated and at least shard_carry_min_bytes large takes "
    "the default divisible tiling for the whole loop. Part of the plan "
    "cache key and of the loop's signature.")
FLAGS.define_int(
    "shard_carry_min_bytes", 1 << 16,
    "Minimum carry size (bytes) for shard_loop_carries to shard it.")
FLAGS.define_bool(
    "verify_passes", False,
    "Bracket every optimizer pass with the invariant checker "
    "(analysis/passes.py): shape/dtype/leaf preservation + DAG "
    "well-formedness, failures naming the offending pass. Runs only "
    "on plan-cache misses (env SPARTAN_TPU_TORCH_VERIFY_PASSES).")
FLAGS.define_bool(
    "verify_evaluate", False,
    "Run st.check (DAG verifier + plan-time lints: use-after-donate, "
    "double-donation, tiling consistency) on evaluate()'s plan-cache "
    "MISS path, before the optimizer. Hits stay dispatch-bound.")
