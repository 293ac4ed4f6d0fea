"""Crash-safe on-disk store of plan decisions (port of
``spartan_tpu/persist/store.py``).

Layout (``FLAGS.persist_cache_dir``)::

    <dir>/
      entry_<digest>/            one persisted plan
        manifest.json            version + fingerprint + per-file CRC32
        plan.json                the plan's decisions and report
      entry_<digest>.tmp-<pid>/  in-flight write (atomically promoted)
      entry_<digest>.lease       writer lease (multi-process arbitration)

The JAX package stores serialized XLA executables beside the plan; the
port has none, so an entry holds what is costly to recompute: the
decisions of the smart-tiling DP per node of the optimized DAG, and the
plan report's audit and memory verdicts (``persist/__init__.py``).

Write discipline is the checkpoint contract: every file lands in a
temp dir next to the final path, the manifest (a CRC32 per sibling
file) is written last, and one ``os.replace`` promotes the whole
entry: a reader or a crash sees a complete entry or none. Readers take
no lock; a writer first creates ``entry_<digest>.lease`` with
``O_EXCL`` (the loser of a race skips: the winner's entry is
equivalent), and a lease older than ``FLAGS.persist_lease_ttl_s`` is
broken. Every failure — a missing or corrupt file (CRC named), version
or fingerprint skew, an unparseable plan, an ``io`` chaos fault — is a
:class:`PersistRejected` (or ``OSError``) the package turns into "plan
normally".
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ..utils.config import FLAGS
from ..utils.log import log_debug, log_warn
from .fingerprint import FORMAT_VERSION

_MANIFEST = "manifest.json"
_PLAN = "plan.json"


class PersistRejected(RuntimeError):
    """A store entry was rejected (corrupt / stale / foreign); carries
    the machine-readable ``reason`` surfaced in metrics and
    ``st.explain``."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


def _fire_io_fault() -> None:
    """Chaos seam: ``io`` tokens (resilience/faults.py) fire on the
    persist load and store paths, sharing the checkpoint site's
    occurrence counter; one module-attribute read when chaos is off."""
    from ..resilience import faults as _faults

    if _faults._ACTIVE is not None:
        _faults.fire("checkpoint")


def axes_to_json(axes: Tuple) -> List[Any]:
    return [list(a) if isinstance(a, tuple) else a for a in axes]


class Entry:
    """One restored store entry: the plan decisions ``expr.base.
    _build_plan`` stamps instead of running the DP, and the metadata it
    checks them against."""

    __slots__ = ("digest", "meta", "out_tilings_json", "is_tuple",
                 "arg_order", "nargs", "audit", "memory")

    def __init__(self, digest: str, plan_meta: Dict[str, Any]):
        self.digest = digest
        self.meta = plan_meta
        self.out_tilings_json = plan_meta["out_tilings"]
        self.is_tuple = bool(plan_meta["is_tuple"])
        ao = plan_meta["arg_order"]
        self.arg_order = tuple(int(i) for i in ao) if ao is not None else None
        self.nargs = int(plan_meta["nargs"])
        self.audit = plan_meta.get("audit")
        self.memory = plan_meta.get("memory")

    def matches(self, out_tilings, is_tuple: bool,
                arg_order: Optional[Tuple[int, ...]], nargs: int) -> bool:
        """The plan this process just derived agrees with the stored
        metadata."""
        return (self.out_tilings_json == [axes_to_json(t.axes)
                                          for t in out_tilings]
                and self.is_tuple == is_tuple
                and self.arg_order == arg_order
                and self.nargs == nargs)


class PersistStore:
    """One process's handle on a (possibly shared) store directory."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        # prewarm's in-memory table: digest -> Entry, consulted before
        # the disk
        self._preloaded: Dict[str, Entry] = {}

    def _entry_dir(self, digest: str) -> str:
        return os.path.join(self.root, f"entry_{digest}")

    def has(self, digest: str) -> bool:
        return os.path.exists(
            os.path.join(self._entry_dir(digest), _MANIFEST))

    def digests(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        out = []
        for n in sorted(names):
            if n.startswith("entry_") and "." not in n and os.path.exists(
                    os.path.join(self.root, n, _MANIFEST)):
                out.append(n[len("entry_"):])
        return out

    # -- load (lock-free reader) -----------------------------------------

    def _read_checked(self, edir: str, manifest: Dict[str, Any],
                      fname: str) -> bytes:
        rec = (manifest.get("files") or {}).get(fname)
        if rec is None:
            raise PersistRejected("manifest", f"no CRC record for {fname}")
        with open(os.path.join(edir, fname), "rb") as f:
            data = f.read()
        if zlib.crc32(data) != int(rec.get("crc32", -1)):
            raise PersistRejected(
                "crc", f"{fname} failed CRC32 verification (manifest "
                f"{rec.get('crc32')}, read {zlib.crc32(data)}): the "
                "file is corrupt or truncated")
        return data

    def load(self, digest: str, fingerprint: Dict[str, Any],
             prewarm_ok: bool = True) -> Optional[Entry]:
        """Restore one entry, or None on a clean miss. Raises
        :class:`PersistRejected` / ``OSError`` on anything hostile."""
        if prewarm_ok:
            hit = self._preloaded.get(digest)
            if hit is not None:
                return hit
        edir = self._entry_dir(digest)
        mpath = os.path.join(edir, _MANIFEST)
        if not os.path.exists(mpath):
            return None
        # chaos fires only where there is an entry to read: a clean miss
        # consumes no io occurrence
        _fire_io_fault()
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except ValueError as e:
            raise PersistRejected("manifest", f"unparseable: {e}")
        if manifest.get("version") != FORMAT_VERSION:
            raise PersistRejected(
                "version", f"store format {manifest.get('version')} != "
                f"{FORMAT_VERSION}")
        if manifest.get("fingerprint") != fingerprint:
            raise PersistRejected(
                "fingerprint", "environment fingerprint mismatch "
                "(torch/device/mesh/flags changed since this entry "
                "was written)")
        plan_raw = self._read_checked(edir, manifest, _PLAN)
        try:
            plan_meta = json.loads(plan_raw.decode())
            entry = Entry(digest, plan_meta)
        except (ValueError, KeyError, TypeError) as e:
            raise PersistRejected("meta", f"plan.json unusable: {e}")
        try:
            # recency: the GC evicts LRU-by-mtime
            os.utime(mpath)
        except OSError:
            pass
        return entry

    # -- save (lease writer) ---------------------------------------------

    def _acquire_lease(self, digest: str) -> Optional[str]:
        lease = self._entry_dir(digest) + ".lease"
        for attempt in (0, 1):
            try:
                fd = os.open(lease, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                with os.fdopen(fd, "w") as f:
                    f.write(str(os.getpid()))
                return lease
            except FileExistsError:
                try:
                    age = time.time() - os.path.getmtime(lease)
                except OSError:
                    continue  # vanished: retry the O_EXCL create
                if attempt == 0 and age > FLAGS.persist_lease_ttl_s:
                    # a writer died mid-persist: break the stale lease
                    try:
                        os.unlink(lease)
                    except OSError:
                        pass
                    continue
                return None  # a live writer elsewhere: it wins
        return None

    def save(self, digest: str, fingerprint: Dict[str, Any],
             plan_meta: Dict[str, Any]) -> bool:
        """Persist one entry atomically; True when this process's write
        landed (False: another writer holds the lease, or the entry
        exists). Raises on IO failure (the package counts and swallows
        it)."""
        final = self._entry_dir(digest)
        if os.path.exists(os.path.join(final, _MANIFEST)):
            return False
        lease = self._acquire_lease(digest)
        if lease is None:
            return False
        tmp = final + f".tmp-{os.getpid()}"
        try:
            _fire_io_fault()
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            data = json.dumps(plan_meta, sort_keys=True).encode()
            with open(os.path.join(tmp, _PLAN), "wb") as f:
                f.write(data)
            manifest = {
                "version": FORMAT_VERSION,
                "digest": digest,
                "fingerprint": fingerprint,
                "mesh_epoch": fingerprint.get("mesh_epoch", 0),
                "created_unix": time.time(),
                "files": {_PLAN: {"crc32": zlib.crc32(data),
                                  "bytes": len(data)}},
            }
            # the manifest is the commit marker: written last
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
            if os.path.isdir(final):  # raced a writer without a lease
                return False
            os.replace(tmp, final)
            log_debug("persist: stored entry %s (%d bytes)", digest[:12],
                      len(data))
            return True
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            try:
                os.unlink(lease)
            except OSError:
                pass

    # -- eviction / hygiene ----------------------------------------------

    def entry_stats(self) -> List[Tuple[float, int, str]]:
        """(mtime, bytes, digest) per committed entry: the GC's
        LRU-by-mtime view (the manifest is touched on every load)."""
        out: List[Tuple[float, int, str]] = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if not name.startswith("entry_") or "." in name:
                continue
            edir = os.path.join(self.root, name)
            try:
                mtime = os.path.getmtime(os.path.join(edir, _MANIFEST))
                size = sum(os.path.getsize(os.path.join(edir, f))
                           for f in os.listdir(edir))
            except OSError:
                continue  # raced an eviction
            out.append((mtime, int(size), name[len("entry_"):]))
        return out

    def total_bytes(self) -> int:
        return sum(b for _, b, _ in self.entry_stats())

    def gc(self, max_bytes: int = 0, ttl_s: float = 0.0,
           protect: Tuple[str, ...] = ()) -> int:
        """Drop entries unused for ``ttl_s``, then evict LRU until the
        store fits ``max_bytes`` (0 disables either bound); ``protect``
        digests are never evicted. Returns entries evicted."""
        if not max_bytes and not ttl_s:
            return 0
        entries = sorted(self.entry_stats())  # oldest first
        now = time.time()
        evicted = 0
        live: List[Tuple[float, int, str]] = []
        for mtime, size, digest in entries:
            if digest in protect:
                live.append((mtime, size, digest))
                continue
            if ttl_s and now - mtime > ttl_s:
                self.purge(digest)
                evicted += 1
            else:
                live.append((mtime, size, digest))
        if max_bytes:
            total = sum(s for _, s, _ in live)
            for mtime, size, digest in live:
                if total <= max_bytes:
                    break
                if digest in protect:
                    continue
                self.purge(digest)
                total -= size
                evicted += 1
        if evicted:
            log_warn("persist: GC evicted %d entr%s (max_bytes=%s, "
                     "ttl_s=%s)", evicted, "y" if evicted == 1 else "ies",
                     max_bytes, ttl_s)
        return evicted

    def purge(self, digest: str) -> None:
        """Drop one entry (best effort)."""
        shutil.rmtree(self._entry_dir(digest), ignore_errors=True)
        self._preloaded.pop(digest, None)

    def evict_epochs_before(self, epoch: int) -> int:
        """Purge entries stored under a dead mesh epoch (and any whose
        manifest no longer parses): ``expr.base.evict_stale_plans``'s
        disk half after an elastic ``rebuild_mesh``."""
        n = 0
        try:
            names = os.listdir(self.root)
        except OSError:
            return 0
        for name in names:
            if not name.startswith("entry_"):
                continue
            path = os.path.join(self.root, name)
            if not os.path.isdir(path) or ".tmp-" in name:
                continue
            try:
                with open(os.path.join(path, _MANIFEST)) as f:
                    entry_epoch = int(json.load(f).get("mesh_epoch", 0))
                if entry_epoch >= epoch:
                    continue
            except (OSError, ValueError, TypeError):
                pass  # unreadable manifest: reap it
            shutil.rmtree(path, ignore_errors=True)
            self._preloaded.pop(name[len("entry_"):], None)
            n += 1
        if n:
            log_warn("persist: evicted %d dead-epoch entr%s from %s",
                     n, "y" if n == 1 else "ies", self.root)
        return n

    # -- prewarm ----------------------------------------------------------

    def preload(self, digest: str, fingerprint: Dict[str, Any]) -> bool:
        """Read one entry into the in-memory prewarm table. False on a
        clean miss; raises like :meth:`load`."""
        entry = self.load(digest, fingerprint, prewarm_ok=False)
        if entry is None:
            return False
        self._preloaded[digest] = entry
        return True

    def preloaded_count(self) -> int:
        return len(self._preloaded)

    def write_manifest(self, path: str,
                       digests: Optional[List[str]] = None) -> int:
        """Write a prewarm manifest listing ``digests`` (default: every
        entry in the store). Atomic via temp + replace."""
        entries = list(digests) if digests is not None else self.digests()
        tmp = path + f".tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"version": FORMAT_VERSION, "entries": entries}, f,
                      indent=1)
        os.replace(tmp, path)
        return len(entries)
