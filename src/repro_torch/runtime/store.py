"""Disk-backed, content-addressed plan store: reuse plans ACROSS sessions.

The in-memory :class:`repro_torch.api.cache.PlanCache` dies with its session; a
serving deployment re-pays the memo search on every process start. The
``PlanStore`` persists compiled :class:`~repro_torch.core.search.OptimizationResult`
objects under a directory, addressed by the same content-stable key
vocabulary the in-memory cache uses:

  * **logical key** — SHA-256 of (program fingerprint, cost-catalog key,
    optimizer-config key). One file per logical key: a new compilation of
    the same program under fresh statistics supersedes the stale entry.
  * **stats fingerprint** — a CONTENT hash of the per-table statistics the
    plan was costed against, stored WITH the entry. A lookup whose
    fingerprint differs is a *stale* hit (counted separately from cold
    misses): the data moved, the plan must be recompiled. Content hashes —
    not the in-memory cache's process-local version counters — are what let
    a restarted server (whose counters reset) still warm-start from the
    store when its statistics are byte-equal.

Entries are pickled (plans embed Region/F-IR/Query trees); a human-readable
``index.json`` sidecar carries per-entry metadata (fingerprint, estimated
cost, stats token) for inspection and the example scripts. Writes are
atomic (tempfile + ``os.replace``) so concurrent sessions sharing a store
directory never observe torn entries.

**Cold-compile races** resolve first-writer-wins: two sessions compiling
the same cold program both run the memo search, but :meth:`put` re-reads
before writing — when a valid entry for the same statistics already landed,
the second writer DISCARDS its own result and returns the stored one, so
every session serves the one canonical plan (``races`` counts these). A
racer that slips between the re-read and the replace merely overwrites with
an equivalent artifact: alpha-normalized codegen (``core.fir.NameGen``)
makes two compilations of the same program under the same statistics
byte-identical, which is also what makes the dedupe meaningful at all.

``max_entries`` bounds the directory: stores past the bound GC their
least-recently-used plans (access order approximated by file mtime, which
:meth:`get` refreshes on every hit).
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import tempfile
from typing import Dict, Optional

__all__ = ["PlanStore", "content_address"]

_FORMAT_VERSION = 1


def content_address(ident) -> str:
    """Stable short content hash of a repr-stable identity tuple — the
    addressing scheme shared by the plan store and the compiled-artifact
    cache (:mod:`repro_torch.compiled.manager`), so the two tiers' artifacts can
    be correlated in telemetry and on disk."""
    return hashlib.sha256(repr(ident).encode()).hexdigest()[:32]


class _Corrupt:
    """Sentinel: an entry file exists but cannot be trusted."""


_CORRUPT = _Corrupt()


class PlanStore:
    """A directory of compiled plans shared by many sessions."""

    def __init__(self, root: str, max_entries: Optional[int] = None):
        if max_entries is not None and max_entries < 1:
            raise ValueError("max_entries must be >= 1 (or None: unbounded)")
        self.root = os.fspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.stale = 0
        self.puts = 0
        self.races = 0
        self.gc_evictions = 0
        self.errors = 0

    # ----------------------------------------------------------- addressing
    @staticmethod
    def logical_key(key) -> str:
        """Content hash of the plan's identity minus its stats token. The
        execution-context fingerprint is part of the identity: a plan
        compiled for serving (batch_size=64) and one compiled one-shot are
        different artifacts and coexist in the store."""
        ident = (key.program_fp, key.catalog_key, key.config_key,
                 getattr(key, "context_key", ()))
        return content_address(ident)

    def _path(self, lk: str) -> str:
        return os.path.join(self.root, f"{lk}.plan")

    @classmethod
    def coerce(cls, store) -> "PlanStore":
        """Accept a PlanStore instance or a directory path (the shared
        coercion used by CobraSession and ServingRuntime)."""
        return store if isinstance(store, cls) else cls(store)

    # -------------------------------------------------------------- get/put
    def get(self, key, stats_fp=None) -> Optional[object]:
        """Return the stored OptimizationResult for ``key``, or None.

        ``stats_fp`` is the content fingerprint of the caller's CURRENT
        statistics for the plan's tables; when provided, entry validity is
        judged by it (restart-stable). Without it, the key's version token
        is compared instead. Misses distinguish *cold* (no entry for the
        program at all) from *stale* (an entry exists but was compiled
        against different table statistics)."""
        path = self._path(self.logical_key(key))
        payload = self._load(path)
        if payload is None:
            self.misses += 1
            return None
        if payload is _CORRUPT:
            self.errors += 1
            return None
        if not self._valid(payload, key, stats_fp):
            self.stale += 1
            return None
        self.hits += 1
        try:
            os.utime(path)  # refresh LRU recency for the GC bound
        except OSError:
            pass
        return payload["result"]

    def _load(self, path: str):
        """None = no entry; _CORRUPT = unreadable/wrong format."""
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                payload = pickle.load(f)
        except FileNotFoundError:
            return None  # GC'd between the exists check and the open
        except Exception:
            return _CORRUPT
        if not isinstance(payload, dict) \
                or payload.get("format") != _FORMAT_VERSION:
            return _CORRUPT
        return payload

    @staticmethod
    def _valid(payload, key, stats_fp) -> bool:
        if stats_fp is not None:
            return payload.get("stats_fp") == stats_fp
        return payload["stats_token"] == key.stats_version

    def put(self, key, result, stats_fp=None):
        """Persist ``result``; returns the CANONICAL stored result.

        First-writer-wins with re-read: when another session already stored
        a plan for this key that is valid for the same statistics, this
        session's freshly-compiled result is discarded and the stored one
        returned — callers should serve the return value, so racing
        sessions converge on one canonical plan. A stale existing entry
        (different statistics) is superseded as before."""
        lk = self.logical_key(key)
        path = self._path(lk)
        existing = self._load(path)
        if isinstance(existing, dict) and self._valid(existing, key, stats_fp):
            self.races += 1
            return existing["result"]
        payload = {
            "format": _FORMAT_VERSION,
            "program_fp": key.program_fp,
            "stats_token": key.stats_version,
            "stats_fp": stats_fp,
            "result": result,
        }
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        except Exception:
            self.errors += 1
            if os.path.exists(tmp):
                os.unlink(tmp)
            return result
        self.puts += 1
        try:
            # best-effort metadata sidecar: concurrent writers may lose an
            # index record to the read-modify-write race, but never a plan —
            # entry validity comes from the .plan payload alone
            self._index_add(lk, key, result)
        except Exception:
            self.errors += 1
        self._gc()
        return result

    # -------------------------------------------------------------------- GC
    def _gc(self) -> None:
        """Drop least-recently-used plans beyond ``max_entries``."""
        if self.max_entries is None:
            return
        try:
            entries = []
            for n in os.listdir(self.root):
                if not n.endswith(".plan"):
                    continue
                p = os.path.join(self.root, n)
                try:
                    entries.append((os.path.getmtime(p), p, n[:-5]))
                except OSError:
                    continue  # concurrently removed
            excess = len(entries) - self.max_entries
            if excess <= 0:
                return
            entries.sort()  # oldest mtime (= least recently used) first
            dropped = []
            for _, p, lk in entries[:excess]:
                try:
                    os.unlink(p)
                    dropped.append(lk)
                    self.gc_evictions += 1
                except OSError:
                    pass
            if dropped:
                self._index_drop(dropped)
        except Exception:
            self.errors += 1

    # ----------------------------------------------------------- inspection
    def _index_path(self) -> str:
        return os.path.join(self.root, "index.json")

    def _index_add(self, lk: str, key, result) -> None:
        index = self.index()
        index[lk] = {
            "program_fp": key.program_fp,
            "stats_token": [list(tv) for tv in key.stats_version]
            if isinstance(key.stats_version, tuple) else key.stats_version,
            "context": repr(getattr(key, "context_key", ())),
            "est_cost_s": float(getattr(result, "est_cost", 0.0)),
            "program": getattr(getattr(result, "program", None), "name", "?"),
        }
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(index, f, indent=1, sort_keys=True)
        os.replace(tmp, self._index_path())

    def _index_drop(self, keys) -> None:
        try:
            index = self.index()
            for lk in keys:
                index.pop(lk, None)
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(index, f, indent=1, sort_keys=True)
            os.replace(tmp, self._index_path())
        except Exception:
            pass  # sidecar only; the .plan files are the source of truth

    def index(self) -> Dict[str, Dict]:
        try:
            with open(self._index_path()) as f:
                return json.load(f)
        except Exception:
            return {}

    def __len__(self) -> int:
        return sum(1 for n in os.listdir(self.root) if n.endswith(".plan"))

    def clear(self) -> None:
        for n in os.listdir(self.root):
            if n.endswith(".plan") or n == "index.json":
                os.unlink(os.path.join(self.root, n))

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self), "hits": self.hits,
                "misses": self.misses, "stale": self.stale,
                "puts": self.puts, "races": self.races,
                "gc_evictions": self.gc_evictions, "errors": self.errors}
