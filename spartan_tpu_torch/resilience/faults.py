"""Deterministic fault injection: ``st.chaos`` / ``FLAGS.fault_inject``
(port of ``spartan_tpu/resilience/faults.py``).

Failures are injected at the seams where real ones surface, and
deterministically, so every recovery path of the resilience package
runs on the CPU and repeats from a seed.

Injection sites:

* ``compile`` / ``dispatch`` — every run of a plan in
  ``expr/base.evaluate``: ``compile`` on a plan's first run, ``dispatch``
  on later ones (both count as dispatch occurrences). Faults:
  ``transient`` (UNAVAILABLE), ``oom`` (RESOURCE_EXHAUSTED), ``slow``
  (a sleep), ``device_loss`` (a persistent loss of one logical
  position, classified ``fatal_mesh``) on any run; ``compile`` (a
  deterministic INVALID_ARGUMENT) on first runs only.
* ``checkpoint`` — ``utils/checkpoint`` save and load. Fault: ``io``
  (an ``OSError``).
* ``recover`` — inside elastic recovery (``resilience/elastic``): the
  drain / rebuild / evict phases and each rehome pass. Fault:
  ``recover`` (an UNAVAILABLE-style transient, so the operation that
  triggered recovery retries and finishes it).

Spec grammar: comma-separated ``kind[@N][xCOUNT][#DEV][:PROB][=DUR]``
tokens, the JAX package's:

=========  ==============================================================
 suffix     meaning
=========  ==============================================================
 ``@N``     fire at occurrence ``N`` (0-based) of the kind's site
 ``xC``     ...and the ``C-1`` following occurrences (default 1)
 ``#D``     victim position id for ``device_loss``; default: the
            highest id still in the mesh
 ``:P``     instead of ``@N``: fire each occurrence with seeded
            probability ``P`` (same seed -> same fault sequence)
 ``=S``     duration in seconds (``slow`` only; default 0.05)
=========  ==============================================================

``sdc@N[#D]`` silently corrupts the result of walk occurrence ``N``:
one seeded bit flipped in position ``D``'s unit (default: the highest
id in the mesh) after the walk, through ``resilience/integrity.
flip_bit``. Nothing raises: the corruption reaches the caller unless
the integrity sentinel (``FLAGS.integrity_check``) catches it.

Injected exceptions carry ``injected=True`` and the real-world message
patterns, so they go through the same classifier
(:mod:`resilience.classify`) as genuine faults. Every fired fault adds
to ``resilience_faults_injected`` and records a ``chaos`` instant span.
With no plan installed a seam costs one module-attribute read.
"""

from __future__ import annotations

import random
import re
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

from ..obs import trace as trace_mod
from ..obs.metrics import METRICS_FLAG as _METRICS_FLAG
from ..obs.metrics import REGISTRY
from ..utils.config import FLAGS
from ..utils.log import log_warn

FLAGS.define_str(
    "fault_inject", "",
    "Deterministic fault-injection spec (chaos testing): comma-"
    "separated tokens like 'transient@2', 'oom@4x3', 'transient:0.05', "
    "'slow@3=0.5', 'compile@0', 'io@1', 'device_loss@2#3'. Installed by "
    "st.initialize() or st.chaos(); empty = no injection.")
FLAGS.define_int(
    "fault_seed", 0,
    "Seed for probabilistic fault-injection tokens (kind:prob): the "
    "same seed reproduces the same fault sequence.")


class InjectedTransientError(RuntimeError):
    """Injected analogue of a transient runtime error (UNAVAILABLE)."""

    injected = True
    fault_kind = "transient"


class InjectedOOMError(RuntimeError):
    """Injected analogue of an allocation failure (RESOURCE_EXHAUSTED)."""

    injected = True
    fault_kind = "oom"


class InjectedCompileError(RuntimeError):
    """Injected analogue of a deterministic build error."""

    injected = True
    fault_kind = "compile"


class InjectedCheckpointError(OSError):
    """Injected checkpoint IO failure."""

    injected = True
    fault_kind = "io"


class InjectedRecoveryError(RuntimeError):
    """Injected fault inside elastic recovery (the ``recover`` seam): a
    transient, so the triggering operation retries, re-enters the
    idempotent recovery and finishes it."""

    injected = True
    fault_kind = "recover"


class InjectedDeviceLossError(RuntimeError):
    """Injected analogue of the persistent loss of one logical position
    (DATA_LOSS / halted client): classified ``fatal_mesh``.
    ``failed_devices`` names the casualty's position id."""

    injected = True
    fault_kind = "device_loss"

    def __init__(self, msg: str, failed_devices=()):
        super().__init__(msg)
        self.failed_devices = tuple(failed_devices)


def _pick_victim(dev: Optional[int]) -> int:
    """A token's victim: its explicit ``#D`` position id, else the
    highest id still in the mesh (so a second loss takes a fresh
    survivor)."""
    from ..parallel import mesh as mesh_mod

    ids = sorted(mesh_mod.get_mesh().ids)
    if dev is not None:
        if dev not in ids:
            raise ValueError(f"chaos victim #{dev} is not in the current "
                             f"mesh (positions {ids})")
        return dev
    return ids[-1]


def _make_device_loss(msg: str, site: str, idx: int,
                      dev: Optional[int] = None) -> InjectedDeviceLossError:
    victim = _pick_victim(dev)
    return InjectedDeviceLossError(
        msg.format(site=site, idx=idx, dev=victim), failed_devices=(victim,))


_EXC = {
    "transient": (InjectedTransientError,
                  "UNAVAILABLE: injected transient fault "
                  "(chaos {site}#{idx})"),
    "oom": (InjectedOOMError,
            "RESOURCE_EXHAUSTED: injected out-of-memory: failed to "
            "allocate device buffer (chaos {site}#{idx})"),
    "compile": (InjectedCompileError,
                "INVALID_ARGUMENT: injected compile error "
                "(chaos {site}#{idx})"),
    "io": (InjectedCheckpointError,
           "injected checkpoint IO error (chaos {site}#{idx})"),
    "recover": (InjectedRecoveryError,
                "UNAVAILABLE: injected recovery fault (chaos "
                "{site}#{idx})"),
    "device_loss": (InjectedDeviceLossError,
                    "DATA_LOSS: injected device loss: device {dev} "
                    "halted (client has been halted; chaos "
                    "{site}#{idx})"),
}

_KINDS = ("transient", "oom", "slow", "compile", "io", "device_loss",
          "recover", "sdc")
# kinds whose token may name a victim with #D
_VICTIM_KINDS = ("device_loss", "sdc")
_TOKEN = re.compile(
    r"^(?P<kind>[a-z_]+)"
    r"(?:@(?P<at>\d+))?"
    r"(?:x(?P<count>\d+))?"
    r"(?:#(?P<dev>\d+))?"
    r"(?::(?P<prob>[0-9.]+))?"
    r"(?:=(?P<dur>[0-9.]+))?$")


class FaultSpec:
    """One parsed token of a chaos spec."""

    __slots__ = ("kind", "at", "count", "dev", "prob", "dur")

    def __init__(self, token: str):
        m = _TOKEN.match(token.strip())
        if not m or m.group("kind") not in _KINDS:
            raise ValueError(
                f"bad fault token {token!r}: expected "
                f"kind[@N][xCOUNT][#DEV][:PROB][=DUR] with kind in "
                f"{_KINDS}")
        self.kind = m.group("kind")
        self.at = int(m.group("at")) if m.group("at") is not None else None
        self.count = int(m.group("count") or 1)
        self.dev = (int(m.group("dev")) if m.group("dev") is not None
                    else None)
        self.prob = float(m.group("prob")) if m.group("prob") else 0.0
        self.dur = float(m.group("dur")) if m.group("dur") else 0.05
        if self.at is None and not self.prob:
            raise ValueError(
                f"fault token {token!r} needs a deterministic site "
                "(@N) or a probability (:p)")
        if self.dev is not None and self.kind not in _VICTIM_KINDS:
            raise ValueError(
                f"fault token {token!r}: #DEV victim selection only "
                f"applies to {_VICTIM_KINDS}")

    def hits(self, idx: int, seed: int) -> bool:
        if self.at is not None and self.at <= idx < self.at + self.count:
            return True
        if self.prob:
            # per-occurrence seeded draw: deterministic given (seed,
            # kind, idx), independent of call interleaving and of the
            # process (crc32, not str hash)
            word = zlib.crc32(f"{seed}:{self.kind}:{idx}".encode())
            return random.Random(word).random() < self.prob
        return False

    def __repr__(self) -> str:
        return (f"FaultSpec({self.kind}, at={self.at}, "
                f"count={self.count}, dev={self.dev}, "
                f"prob={self.prob})")


class ChaosPlan:
    """A seeded, installed fault-injection plan (see the module
    docstring). A context manager: entering installs it, exiting
    uninstalls it. ``fired`` records every injected fault (kind, site,
    occurrence)."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)
        self.specs: List[FaultSpec] = [
            FaultSpec(tok) for tok in spec.split(",") if tok.strip()]
        self.fired: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._n_dispatch = 0
        self._n_compile = 0
        self._n_checkpoint = 0
        self._n_recover = 0
        # an armed sdc corruption: (spec, occurrence), set by fire() and
        # consumed after the walk by corrupt_output()
        self._pending_sdc: Optional[Any] = None

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {"dispatch": self._n_dispatch,
                    "compile": self._n_compile,
                    "checkpoint": self._n_checkpoint,
                    "recover": self._n_recover}

    def _record(self, spec: FaultSpec, site: str, idx: int) -> None:
        rec = {"kind": spec.kind, "site": site, "occurrence": idx}
        with self._lock:
            self.fired.append(rec)
        if _METRICS_FLAG._value:
            REGISTRY.counter(
                "resilience_faults_injected",
                "synthetic faults raised by the chaos plan").inc()
        trace_mod.instant("chaos", error=spec.kind != "slow",
                          kind=spec.kind, site=site, occurrence=idx)
        log_warn("chaos: injecting %s fault at %s#%d", spec.kind, site,
                 idx)

    def fire(self, site: str) -> None:
        """Consult the plan at one injection site; raises (or sleeps,
        for ``slow``) when a token matches the current occurrence."""
        with self._lock:
            rec_idx = ckpt_idx = disp_idx = comp_idx = None
            if site == "checkpoint":
                ckpt_idx = self._n_checkpoint
                self._n_checkpoint += 1
            elif site == "recover":
                # the recovery seam counts its own occurrences
                rec_idx = self._n_recover
                self._n_recover += 1
            else:
                disp_idx = self._n_dispatch
                self._n_dispatch += 1
                if site == "compile":
                    comp_idx = self._n_compile
                    self._n_compile += 1
        for spec in self.specs:
            if spec.kind == "io":
                idx = ckpt_idx
            elif spec.kind == "compile":
                idx = comp_idx
            elif spec.kind == "recover":
                idx = rec_idx
            else:  # transient / oom / slow / device_loss: any run
                idx = disp_idx
            if idx is None or not spec.hits(idx, self.seed):
                continue
            self._record(spec, site, idx)
            if spec.kind == "slow":
                time.sleep(spec.dur)
                continue
            if spec.kind == "sdc":
                # silent corruption raises nothing here: arm the flip
                # corrupt_output() applies to this walk's result
                with self._lock:
                    self._pending_sdc = (spec, idx)
                continue
            exc_type, msg = _EXC[spec.kind]
            if spec.kind == "device_loss":
                raise _make_device_loss(msg, site, idx, spec.dev)
            raise exc_type(msg.format(site=site, idx=idx))

    def corrupt_output(self, out: Any, tilings: Any, mesh: Any) -> Any:
        """Apply an armed ``sdc`` corruption to a walk's result: one
        seeded bit flipped in the victim position's unit
        (``integrity.flip_bit``). Consumes the armed record; ``out``
        unchanged when nothing is armed or the victim left the mesh. On
        a group mesh every rank consumes the record (the ranks' plans
        stay in step) and only the victim's rank flips the bit, in its
        own block."""
        with self._lock:
            pending, self._pending_sdc = self._pending_sdc, None
        if pending is None:
            return out
        spec, idx = pending
        try:
            victim = _pick_victim(spec.dev)
        except ValueError:
            return out  # the victim was quarantined: nothing to corrupt
        from . import integrity as integrity_mod

        return integrity_mod.flip_bit(out, victim, self.seed, idx, tilings,
                                      mesh)

    def install(self) -> "ChaosPlan":
        global _ACTIVE
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None

    def __enter__(self) -> "ChaosPlan":
        return self.install()

    def __exit__(self, *exc: Any) -> None:
        self.uninstall()

    def __repr__(self) -> str:
        return (f"ChaosPlan({self.spec!r}, seed={self.seed}, "
                f"fired={len(self.fired)})")


# The one installed plan; the seams read this module attribute.
_ACTIVE: Optional[ChaosPlan] = None


def chaos(spec: Optional[str] = None, seed: Optional[int] = None
          ) -> Optional[ChaosPlan]:
    """Install a deterministic fault-injection plan (``st.chaos``).

    ``spec`` defaults to ``FLAGS.fault_inject``, ``seed`` to
    ``FLAGS.fault_seed``. An empty spec clears any installed plan and
    returns None. The plan is a context manager::

        with st.chaos("transient@1,oom@3", seed=0):
            result = expr.evaluate()   # survives both faults
    """
    global _ACTIVE
    if spec is None:
        spec = FLAGS.fault_inject
    if seed is None:
        seed = FLAGS.fault_seed
    if not spec:
        _ACTIVE = None
        return None
    return ChaosPlan(spec, seed).install()


def chaos_clear() -> None:
    """Uninstall any active chaos plan."""
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[ChaosPlan]:
    return _ACTIVE


def install_from_flags() -> Optional[ChaosPlan]:
    """Install a plan from ``FLAGS.fault_inject`` if set (called by
    ``st.initialize()``); no-op when the flag is empty."""
    if FLAGS.fault_inject:
        return chaos(FLAGS.fault_inject, FLAGS.fault_seed)
    return None


def fire(site: str) -> None:
    """Module-level injection hook: no-op unless a plan is installed."""
    plan = _ACTIVE
    if plan is not None:
        plan.fire(site)


def corrupt_output(out: Any, tilings: Any, mesh: Any) -> Any:
    """The post-walk hook of the ``sdc`` kind (``expr/base.py::_run``,
    which reads ``_ACTIVE`` first: one attribute read with chaos off)."""
    plan = _ACTIVE
    if plan is None:
        return out
    return plan.corrupt_output(out, tilings, mesh)
