"""Typed global FLAGS registry (the port's own copy of
``spartan_tpu/utils/config.py``, holding only the flags this package
reads).

Flags gate the optimizer passes, the plan cache and the kernel layer,
and set the checkpointed loop's restore budget.
Each flag takes its initial value from the environment variable
``SPARTAN_TPU_TORCH_<NAME>`` when that is set.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional


def _parse_bool(text: str) -> bool:
    return text.lower() in ("1", "true", "yes", "on")


class Flag:
    """A single typed flag with a default and an env-var override."""

    def __init__(self, name: str, default: Any, help: str = "",
                 parser: Callable[[str], Any] = str):
        self.name = name
        self.default = default
        self.help = help
        self.parser = parser
        self.value = default
        env = os.environ.get("SPARTAN_TPU_TORCH_" + name.upper())
        if env is not None:
            self.value = parser(env)


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

    def __getattr__(self, name: str) -> Any:
        flags: Dict[str, Flag] = object.__getattribute__(self, "_flags")
        if name in flags:
            return flags[name].value
        raise AttributeError(f"undefined flag: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        flags: Dict[str, Flag] = object.__getattribute__(self, "_flags")
        if name not in flags:
            raise AttributeError(
                f"undefined flag: {name}; call FLAGS.define() first")
        flags[name].value = value

    def snapshot(self) -> Dict[str, Any]:
        return {f.name: f.value for f in self._flags.values()}


FLAGS = FlagRegistry()

FLAGS.define_bool("opt_map_fusion", True,
                  "Fuse chained elementwise map exprs into one kernel.")
FLAGS.define_bool("opt_reduce_fusion", True,
                  "Fuse a map producer into a consuming reduce.")
FLAGS.define_bool("opt_collapse_cached", True,
                  "Collapse already-evaluated sub-DAGs into leaves.")
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
