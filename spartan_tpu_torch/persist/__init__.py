"""Warm-start persistence: the crash-safe store of plan decisions (port
of ``spartan_tpu/persist``).

The JAX package makes its plan cache and compiled XLA executables
durable, so a restarted replica serves its plan set with no recompile.
The port compiles nothing; what a plan-cache miss pays for is planning,
and the costly part of it is the smart-tiling DP. The store keeps, per
plan, the DP's decisions for every node of the optimized DAG in
post-order — the committed tiling, the GEMM plan and the cost estimate
— with the output tilings and raw argument order, the pass report and
``dp_cost``, the plan's ``report["audit"]`` and ``report["memory"]``
and the calibration fingerprint. On a hit the rewrite passes still run;
the smart-tiling pass then stamps the stored decisions instead of
running its DP (``expr/tiling_pass.py``), provided the DAG it is given
has the stored structural signature (node types, shapes, dtypes and
edges in post-order); otherwise the entry is rejected as
``meta_mismatch`` and the DP runs.

Addressing and safety (``fingerprint.py`` / ``store.py``): entries are
keyed by a process-stable digest of the plan key ``evaluate()``
computes, extended with an environment fingerprint (Python, torch and
CUDA versions, the device and its capability, the mesh shape and
epoch, ``_opt_flags_key``, the kernel policy); writes are atomic temp
dirs promoted by ``os.replace`` with CRC32 manifests; every rejection
(``manifest``, ``crc``, ``version``, ``fingerprint``, ``meta``,
``meta_mismatch``, ``io`` chaos) degrades to a normal plan build and is
counted in ``persist_load_errors{reason=...}``. ``FLAGS.
persist_cache_dir`` ("" = off) turns it on: off, the miss path reads one
flag and a hit nothing.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

from ..obs.metrics import METRICS_FLAG as _METRICS_FLAG
from ..obs.metrics import REGISTRY, labeled
from ..utils.config import FLAGS
from ..utils.log import log_debug, log_warn
from .fingerprint import (UnstableKeyError, entry_digest, env_fingerprint,
                          stable_digest)
from .store import Entry, PersistRejected, PersistStore, axes_to_json

__all__ = [
    "PersistStore", "PersistRejected", "Entry", "UnstableKeyError",
    "stable_digest", "active", "lookup", "maybe_store", "maybe_gc",
    "evict_stale", "prewarm", "write_manifest", "stats", "reset",
]

_DIR_FLAG = FLAGS.define_str(
    "persist_cache_dir", "",
    "Crash-safe on-disk store of plan decisions (spartan_tpu_torch/"
    "persist): evaluate()'s miss path reads it before optimizing and "
    "writes each new plan once built, so a process restart "
    "plans its plan set without running the tiling DP. Entries are "
    "fingerprint-keyed and CRC-verified; any mismatch or corruption "
    "degrades to a normal plan build. Empty = off.")
FLAGS.define_float(
    "persist_lease_ttl_s", 60.0,
    "Writer-lease time-to-live for a shared persist_cache_dir: an older "
    "lease file is abandoned (its writer crashed) and may be broken.")
FLAGS.define_float(
    "persist_prewarm_timeout_s", 30.0,
    "Per-entry timeout for prewarm: one slow or hostile entry cannot "
    "stall the rest of the set.")
FLAGS.define_int(
    "persist_max_bytes", 0,
    "Size bound on the persist store: after each stored entry, the "
    "least recently used entries are evicted until the store fits. "
    "0 = unbounded.")
FLAGS.define_float(
    "persist_ttl_s", 0.0,
    "Age bound on persist-store entries: an entry not loaded for longer "
    "than this is evicted by the post-store GC sweep. 0 = no TTL.")

_lock = threading.Lock()
_store: Optional[PersistStore] = None
_store_dir: Optional[str] = None
_failed_dir: Optional[str] = None

# plan_key -> digest (None: unstable) memo: digesting is per plan
_digest_memo: Dict[Tuple, Optional[str]] = {}
_DIGEST_MEMO_MAX = 1024

# what the last _build_plan on this thread did (disk hit vs plan)
_TLS = threading.local()


def _count(name: str, n: int = 1, **labels: str) -> None:
    if _METRICS_FLAG._value and n:
        full = labeled(name, **labels) if labels else name
        REGISTRY.counter(full, "persistent plan store "
                         "(spartan_tpu_torch/persist)").inc(n)


def active() -> Optional[PersistStore]:
    """The process's store for ``FLAGS.persist_cache_dir``, or None
    when persistence is off (one flag read). A directory that cannot be
    created disables the store for that path (warned once)."""
    global _store, _store_dir, _failed_dir
    d = _DIR_FLAG._value
    if not d:
        return None
    if _store is not None and _store_dir == d:
        return _store
    if _failed_dir == d:
        return None
    with _lock:
        if _store is not None and _store_dir == d:
            return _store
        try:
            _store = PersistStore(d)
            _store_dir = d
            _failed_dir = None
        except OSError as e:
            log_warn("persist: cannot open cache dir %r (%s); "
                     "persistence disabled for this path", d, e)
            _count("persist_store_errors", reason="open")
            _failed_dir = d
            _store = None
            _store_dir = None
    return _store


def reset() -> None:
    """Forget the store singleton, the digest memo and the prewarm
    table (the disk is untouched)."""
    global _store, _store_dir, _failed_dir
    with _lock:
        _store = None
        _store_dir = None
        _failed_dir = None
        _digest_memo.clear()
    _TLS.__dict__.clear()


def digest_for(plan_key: Tuple, mesh: Any) -> Optional[str]:
    """Process-stable on-disk address of one plan key (memoized), or
    None when the key has no stable representation (counted)."""
    hit = _digest_memo.get(plan_key, "")
    if hit != "":
        return hit
    try:
        digest = entry_digest(plan_key, env_fingerprint(mesh))
    except UnstableKeyError as e:
        log_debug("persist: unstable plan key (%s)", e)
        _count("persist_unstable_keys")
        digest = None
    if len(_digest_memo) >= _DIGEST_MEMO_MAX:
        _digest_memo.clear()
    _digest_memo[plan_key] = digest
    return digest


# -- evaluate() seams -------------------------------------------------------


def note_build(source: str, digest: Optional[str] = None,
               reason: Optional[str] = None) -> None:
    _TLS.last = {"source": source, "digest": digest, "reason": reason}


def take_build_source() -> Optional[Dict[str, Any]]:
    """Pop this thread's last persist outcome (disk hit vs plan)."""
    last = getattr(_TLS, "last", None)
    _TLS.last = None
    return last


def lookup(plan_key: Optional[Tuple], mesh: Any
           ) -> Tuple[Optional[Entry], Optional[str], Optional[str]]:
    """Consult the store for one plan key (the miss path's first act,
    before the optimizer). Returns ``(entry, digest, reject_reason)``;
    a None entry means plan normally (a clean miss, the store off, an
    unstable key, or a rejected entry — the reason says which)."""
    store = active()
    if store is None or plan_key is None:
        return None, None, None
    digest = digest_for(plan_key, mesh)
    if digest is None:
        return None, None, "unstable_key"
    try:
        entry = store.load(digest, env_fingerprint(mesh))
    except PersistRejected as e:
        log_warn("persist: entry %s rejected (%s); planning normally",
                 digest[:12], e)
        _count("persist_load_errors", reason=e.reason)
        return None, digest, e.reason
    except (OSError, UnstableKeyError) as e:
        log_warn("persist: load failed for %s (%s: %s); planning "
                 "normally", digest[:12], type(e).__name__, e)
        _count("persist_load_errors", reason="io")
        return None, digest, "io"
    if entry is None:
        _count("persist_misses")
        return None, digest, None
    # the hit is counted once the plan's own checks accept the entry
    return entry, digest, None


def note_hit() -> None:
    _count("persist_hits")


def reject_entry(entry: Entry, reason: str) -> None:
    """An entry that passed the fingerprint and CRC checks but not the
    plan's own: count the reason and purge it (it can never load)."""
    log_warn("persist: entry %s rejected (%s); planning normally and "
             "purging", entry.digest[:12], reason)
    _count("persist_load_errors", reason=reason)
    store = active()
    if store is not None:
        store.purge(entry.digest)


def plan_meta(plan: Any) -> Optional[Dict[str, Any]]:
    """The JSON record of one built plan that the store keeps (None for
    a plan without the DP record or a raw argument order)."""
    report = plan.report or {}
    rec = report.get("persist") or {}
    arg_order = report.get("arg_order")
    if arg_order is None or "decisions" not in rec:
        return None
    meta = {
        "structure": rec["structure"],
        "decisions": rec["decisions"],
        "out_tilings": [axes_to_json(t.axes) for t in plan.out_tilings],
        "is_tuple": plan.is_tuple,
        "arg_order": list(arg_order),
        "nargs": len(arg_order),
        "passes": report.get("passes"),
        "dp_cost": report.get("dp_cost"),
        "cost_components": report.get("cost_components"),
        "calibration": FLAGS.cost_calibration_fingerprint or None,
    }
    # the audit and memory verdicts ride the entry when computed: a
    # warm restart reads them instead of re-walking
    for key in ("audit", "memory"):
        if report.get(key) is not None:
            meta[key] = report[key]
    return meta


def maybe_store(plan: Any, mesh: Any) -> bool:
    """Persist a newly built plan (``expr/base._build_plan``; on
    ``evaluate()``'s miss path after its audit, before its first walk).
    No-raise: a failed persist is counted, never propagated."""
    store = active()
    digest = getattr(plan, "persist_digest", None)
    if store is None or digest is None:
        return False
    try:
        meta = plan_meta(plan)
        if meta is None:
            _count("persist_store_skipped", reason="uncacheable")
            return False
        json.dumps(meta)  # JSON-safe, or it is not persisted
        landed = store.save(digest, env_fingerprint(mesh), meta)
    except Exception as e:  # noqa: BLE001 - persistence is best effort:
        # IO errors, chaos faults and unserializable reports all degrade
        # to "this plan is simply not persisted"
        log_warn("persist: store failed for %s (%s: %s)",
                 digest[:12], type(e).__name__, str(e)[:120])
        _count("persist_store_errors", reason="io")
        return False
    if landed:
        _count("persist_stores")
        rec = (plan.report or {}).get("persist")
        if rec is not None:
            rec["stored"] = True
        maybe_gc(protect=(digest,))
    return landed


def maybe_gc(protect: Tuple[str, ...] = ()) -> int:
    """Apply the store's size and age bounds (``FLAGS.persist_max_bytes``
    / ``persist_ttl_s``, LRU by manifest mtime) after a store landed.
    No-raise; evictions land in ``persist_evictions``."""
    max_bytes = int(FLAGS.persist_max_bytes or 0)
    ttl_s = float(FLAGS.persist_ttl_s or 0.0)
    if not max_bytes and not ttl_s:
        return 0
    store = active()
    if store is None:
        return 0
    try:
        n = store.gc(max_bytes, ttl_s, protect=tuple(protect))
    except Exception as e:  # noqa: BLE001 - GC is hygiene
        log_warn("persist: GC sweep failed (%s: %s)",
                 type(e).__name__, str(e)[:120])
        return 0
    if n:
        _count("persist_evictions", n)
    return n


_last_evicted = 0


def evict_stale() -> int:
    """Purge entries stored under a dead mesh epoch: the disk half of
    elastic recovery's eviction (``resilience/elastic._evict``).
    No-raise; returns entries purged."""
    global _last_evicted
    store = active()
    if store is None:
        _last_evicted = 0
        return 0
    from ..parallel import mesh as mesh_mod

    try:
        n = store.evict_epochs_before(mesh_mod._EPOCH)
    except OSError as e:
        log_warn("persist: eviction scan failed (%s)", e)
        n = 0
    _count("persist_evicted", n)
    _last_evicted = n
    return n


def last_evicted() -> int:
    return _last_evicted


# -- prewarm ------------------------------------------------------------------


def _manifest_digests(manifest: Union[str, Dict[str, Any], List[str]],
                      store: PersistStore) -> List[str]:
    if manifest == "all":
        return store.digests()
    if isinstance(manifest, str):
        with open(manifest) as f:
            manifest = json.load(f)
    if isinstance(manifest, dict):
        return [str(d) for d in manifest.get("entries", [])]
    return [str(d) for d in manifest]


def prewarm(manifest: Union[str, Dict[str, Any], List[str]] = "all",
            timeout_s: Optional[float] = None) -> Dict[str, Any]:
    """Read a configured plan set into the in-memory prewarm table
    (``serve/`` at startup, off the request path). ``manifest``: a path
    to a JSON ``{"entries": [digest, ...]}`` file, that dict or list, or
    ``"all"``. Each entry loads on its own daemon thread with a timeout:
    one hostile, missing or slow entry is counted and skipped. Returns
    ``{loaded, missing, errors, skipped, total}``."""
    from ..obs import trace as trace_mod

    stats_ = {"loaded": 0, "missing": 0, "errors": 0, "skipped": 0,
              "total": 0}
    store = active()
    if store is None:
        stats_["skipped"] = -1  # store off: nothing to prewarm
        return stats_
    if timeout_s is None:
        timeout_s = FLAGS.persist_prewarm_timeout_s
    try:
        digests = _manifest_digests(manifest, store)
    except (OSError, ValueError) as e:
        log_warn("persist: unreadable prewarm manifest (%s)", e)
        _count("persist_prewarm_errors", reason="manifest")
        stats_["errors"] += 1
        return stats_
    stats_["total"] = len(digests)
    try:
        from ..parallel import mesh as mesh_mod

        fp = env_fingerprint(mesh_mod.get_mesh())
    except Exception as e:  # noqa: BLE001 - an unfingerprintable
        # environment disables the prewarm, never the process
        log_warn("persist: prewarm fingerprint failed (%s: %s)",
                 type(e).__name__, e)
        _count("persist_prewarm_errors", reason="fingerprint")
        stats_["errors"] = len(digests)
        return stats_
    with trace_mod.span("prewarm", entries=len(digests)):
        for digest in digests:
            outcome: Dict[str, Any] = {}

            def _load(digest=digest, outcome=outcome):
                try:
                    outcome["found"] = store.preload(digest, fp)
                except Exception as e:  # noqa: BLE001 - per-entry
                    # isolation: a hostile entry must not sink the set
                    outcome["error"] = e

            t = threading.Thread(target=_load, daemon=True,
                                 name="spartan-prewarm")
            t.start()
            t.join(timeout_s)
            if t.is_alive():
                stats_["errors"] += 1
                _count("persist_prewarm_errors", reason="timeout")
                log_warn("persist: prewarm entry %s timed out after "
                         "%.1fs; skipped", str(digest)[:12], timeout_s)
            elif "error" in outcome:
                e = outcome["error"]
                stats_["errors"] += 1
                _count("persist_prewarm_errors",
                       reason=getattr(e, "reason", "io"))
                log_warn("persist: prewarm entry %s failed (%s: %s); "
                         "skipped", str(digest)[:12], type(e).__name__,
                         str(e)[:120])
            elif outcome.get("found"):
                stats_["loaded"] += 1
                _count("persist_prewarm_loaded")
            else:
                stats_["missing"] += 1
                _count("persist_prewarm_missing")
                log_warn("persist: prewarm entry %s not in store; "
                         "skipped", str(digest)[:12])
    return stats_


def write_manifest(path: str, digests: Optional[List[str]] = None) -> int:
    """Write a prewarm manifest of the current store (0 with the store
    off)."""
    store = active()
    if store is None:
        return 0
    return store.write_manifest(path, digests)


def stats() -> Dict[str, Any]:
    """The store's directory, entry count and prewarm table size (the
    ``persist_*`` counters live in ``st.metrics()``)."""
    store = active()
    if store is None:
        return {"enabled": False}
    digests = store.digests()
    return {"enabled": True, "dir": store.root, "entries": len(digests),
            "preloaded": store.preloaded_count()}
