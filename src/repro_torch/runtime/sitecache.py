"""Serving-level shared site cache: cross-batch, cross-program result reuse.

The per-batch site cache in :mod:`repro_torch.runtime.batch` dies with its batch:
the second batch of an identical workload re-fetches every query site, and
two programs sharing a site (multi-query optimization at the serving layer)
never share a fetch. The ``SiteCache`` lifts that cache to serving scope —
one instance owned by :class:`~repro_torch.runtime.serving.ServingRuntime` and
threaded into every ``run_batch`` — so an identical site is fetched from
the server ONCE PER STATS EPOCH instead of once per batch.

**Keys are self-invalidating.** An entry is addressed by

    (query-tree key, normalized full-content binding key, epoch)

where the *epoch* is ``DatabaseServer.site_epoch(tables)`` — the (stats
version, data version) pair of every base table the query scans. Any
``analyze()`` bumps the stats version; any write (``add_table``,
``replace_table``, interpreter ``UPDATE``) bumps the data version; either
moves the epoch, so a lookup after the change simply misses and re-fetches.
A cached result can therefore never be served over rows (or under
statistics) it was not computed from — cached executions stay bit-identical
to uncached ones by construction, even when an ``analyze()`` or a table
write lands between (or inside) batches. ``invalidate_tables`` additionally
drops dead entries eagerly (memory hygiene; correctness never depends on
it), and an optional TTL expires entries whose epoch never moves.

**Binding-diversity observation.** Every lookup at a parameterized site is
also an observation: the cache tracks, per exact site
(:func:`~repro_torch.core.context.query_site_key`) and per table group
(:func:`~repro_torch.core.context.param_group_key`), how many lookups it saw and
how many DISTINCT bindings among them. The distinct fraction d is exactly
the amortization the cost model needs for parameterized sites — d·B of a
batch's B invocations pay a server fetch, the rest are local hits — and is
published (with hysteresis) by
:meth:`~repro_torch.runtime.feedback.FeedbackController.observe_bindings` into
the serving :class:`~repro_torch.core.context.ExecutionContext`, where
:meth:`~repro_torch.core.cost.CostModel.param_site_amortization` consumes it.

Entries carry the *era* (batch sequence number) they were inserted in, so
``run_batch`` can tell in-batch reuse (``site_hits``) from cross-batch /
cross-program sharing (``shared_site_hits``) in its telemetry.

**Oversize spilling.** A result above ``entry_max_bytes`` would evict most
of the working set for at most one reuse, so the byte-budgeted cache never
admits it to memory. With a ``spill_dir`` configured, such results spill to
a content-addressed disk tier (the same addressing scheme as the plan
store, :func:`~repro_torch.runtime.store.content_address`) instead of being
dropped: a later lookup at the same epoch-keyed key reloads the pickled
result from disk (``spill_hits``), still saving the server round trip. The
spill index lives in memory keyed identically to resident entries, so
epoch keys, TTL, and ``invalidate_tables`` govern spilled results exactly
like resident ones — a spilled result can never be served over rows it
was not computed from. Without a ``spill_dir`` the pre-existing bypass
behavior (count and drop) is unchanged.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from ..core.context import param_group_key, query_site_key
from ..relational.algebra import Query

__all__ = ["SiteCache", "Uncacheable", "approx_result_bytes", "freeze_value",
           "param_key"]

# a site's distinct-binding tracking stops growing here; at the cap the
# observed fraction is frozen (the estimate up to that point) instead of
# decaying toward 0 as total keeps climbing
_MAX_DISTINCT_TRACKED = 4096


class Uncacheable(Exception):
    """A query binding with no faithful hashable identity."""


def approx_result_bytes(value) -> int:
    """Approximate resident size of one cached result, in bytes.

    Tables report their wire size (nrows x row_bytes — the same number the
    cost model charges for fetching them, so a byte budget is commensurate
    with transfer cost); arrays their buffer size; everything else a cheap
    structural estimate. Exactness is NOT required — the budget bounds
    memory approximately, correctness never depends on it."""
    wb = getattr(value, "wire_bytes", None)
    if wb is not None:
        return int(wb() if callable(wb) else wb)
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        return int(nb)
    if isinstance(value, (str, bytes, bytearray)):
        return len(value)
    if isinstance(value, (list, tuple, set, frozenset)):
        return 56 + 16 * len(value)
    return 64


def freeze_value(v):
    """Hashable FULL-CONTENT identity of one binding value."""
    if isinstance(v, (int, float, str, bool, bytes)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return tuple(freeze_value(x) for x in v)
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", None) == 0:
        return item()                      # numpy scalar
    tobytes = getattr(v, "tobytes", None)
    if tobytes is not None:
        return (getattr(v, "shape", None), str(getattr(v, "dtype", "")),
                tobytes())                 # full-content array identity
    raise Uncacheable(type(v).__name__)


def param_key(params) -> Tuple:
    """Hashable FULL-CONTENT identity of a parameter binding. Raises
    :class:`Uncacheable` for values it cannot represent faithfully — the
    caller then bypasses the cache rather than risk serving a stale result
    for a colliding key."""
    if not params:
        return ()
    return tuple((k, freeze_value(params[k])) for k in sorted(params))


class _Entry:
    __slots__ = ("value", "stamp", "era", "tables", "nbytes")

    def __init__(self, value, stamp: float, era: int,
                 tables: Tuple[str, ...], nbytes: int):
        self.value = value
        self.stamp = stamp
        self.era = era
        self.tables = tables
        self.nbytes = nbytes


class _SpillEntry:
    """Index record for one oversize result spilled to disk: everything a
    resident entry carries except the value itself, which lives at
    ``path``."""

    __slots__ = ("path", "stamp", "era", "tables", "nbytes")

    def __init__(self, path: str, stamp: float, era: int,
                 tables: Tuple[str, ...], nbytes: int):
        self.path = path
        self.stamp = stamp
        self.era = era
        self.tables = tables
        self.nbytes = nbytes


def _spill_encode(value):
    """Picklable form of a cached result. Tables decompose to host numpy
    columns (device tensors round-trip through host anyway; this keeps the
    on-disk format torch-version-independent) plus the device name."""
    from ..relational.table import Table
    if isinstance(value, Table):
        return ("table", value.name, value.schema,
                {n: value.host(n) for n in value.columns}, str(value.device))
    return ("pickle", value)


def _spill_decode(obj):
    if obj[0] == "table":
        from ..relational.table import Table
        _, name, schema, cols, device = obj
        return Table(name, schema, cols, device=device)
    return obj[1]


class _SiteStats:
    """Per-site binding-diversity aggregate (one observation per lookup).

    Bindings are tracked by Python hash, not by payload — diversity needs a
    distinct COUNT, so retaining full frozen bindings (which for array
    parameters embed the whole ``tobytes()``) would pin dead payload for
    the cache's lifetime."""

    __slots__ = ("total", "distinct", "frozen_fraction")

    def __init__(self):
        self.total = 0
        self.distinct: set = set()
        self.frozen_fraction: float = -1.0   # <0: still tracking live

    def observe(self, pkey) -> None:
        self.total += 1
        if self.frozen_fraction < 0:
            self.distinct.add(hash(pkey))
            if len(self.distinct) >= _MAX_DISTINCT_TRACKED:
                # freeze the estimate at saturation: past the cap we can no
                # longer count distinct values, and letting total keep
                # dividing would make a fully diverse site read as ~0
                self.frozen_fraction = len(self.distinct) / self.total
                self.distinct.clear()

    @property
    def n_distinct(self) -> int:
        if self.frozen_fraction >= 0:
            return _MAX_DISTINCT_TRACKED
        return len(self.distinct)

    @property
    def fraction(self) -> float:
        if self.frozen_fraction >= 0:
            return self.frozen_fraction
        return len(self.distinct) / self.total if self.total else 0.0


class SiteCache:
    """Serving-scoped, epoch-keyed query-result cache with TTL."""

    def __init__(self, ttl_s: Optional[float] = None,
                 max_entries: int = 4096, clock=time.monotonic,
                 max_bytes: Optional[int] = None,
                 entry_max_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None):
        if ttl_s is not None and ttl_s <= 0:
            raise ValueError("ttl_s must be > 0 (or None: no TTL)")
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError("max_bytes must be >= 1 (or None: no byte bound)")
        if entry_max_bytes is not None and entry_max_bytes < 1:
            raise ValueError("entry_max_bytes must be >= 1 (or None)")
        self.ttl_s = ttl_s
        self.max_entries = max_entries
        # approximate resident-byte budget (None = entry count only); a
        # single result above entry_max_bytes (default: a quarter of the
        # budget) is never cached at all — one oversize value would
        # otherwise evict the whole working set for a single reuse
        self.max_bytes = max_bytes
        if entry_max_bytes is None and max_bytes is not None:
            entry_max_bytes = max(1, max_bytes // 4)
        self.entry_max_bytes = entry_max_bytes
        # oversize disk tier: None keeps the bypass behavior (drop + count)
        self.spill_dir = spill_dir
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
        self._spilled: "OrderedDict[Tuple, _SpillEntry]" = OrderedDict()
        self.bytes_used = 0
        self._clock = clock
        self._entries: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        self.era = 0                    # batch sequence number (new_era())
        # telemetry
        self.hits = 0
        self.shared_hits = 0            # hit on an entry from an earlier era
        self.misses = 0
        self.expirations = 0
        self.evictions = 0
        self.invalidations = 0
        self.oversize_bypasses = 0
        self.spills = 0                 # oversize results written to disk
        self.spill_hits = 0             # lookups served from the disk tier
        # binding-diversity observation: exact site (telemetry) and table
        # group (what the feedback controller publishes into the context)
        self._site_stats: Dict[str, _SiteStats] = {}
        self._group_stats: Dict[str, _SiteStats] = {}
        self._group_tables: Dict[str, Tuple[str, ...]] = {}

    # --------------------------------------------------------------- keying
    @staticmethod
    def site_key(q: Query, pkey: Tuple, epoch: Tuple, origin: int = 0) -> Tuple:
        """``origin`` is the DatabaseServer's ``instance_token``: one cache
        serving executables over DIFFERENT databases must never collide on
        identically-named tables (epochs are per-server counters that start
        at the same values everywhere)."""
        return (origin, q.key(), pkey, epoch)

    def new_era(self) -> int:
        """Mark a batch boundary: hits on entries inserted before the
        current era count as cross-batch (shared) reuse."""
        self.era += 1
        return self.era

    # -------------------------------------------------------------- get/put
    def lookup(self, key: Tuple) -> Optional[Tuple[object, bool]]:
        """(result, crossed-era?) for ``key``, or None. An entry past its
        TTL is expired (a miss); a hit refreshes LRU recency. The boolean is
        True when the entry was inserted in an earlier era (a cross-batch /
        cross-program share)."""
        entry = self._entries.get(key)
        if entry is None:
            return self._lookup_spilled(key)
        if self.ttl_s is not None and self._clock() - entry.stamp > self.ttl_s:
            del self._entries[key]
            self.bytes_used -= entry.nbytes
            self.expirations += 1
            self.misses += 1
            return None
        self.hits += 1
        cross = entry.era < self.era
        if cross:
            self.shared_hits += 1
        self._entries.move_to_end(key)
        return entry.value, cross

    def get(self, key: Tuple):
        """The cached result for ``key``, or None (see :meth:`lookup`)."""
        found = self.lookup(key)
        return None if found is None else found[0]

    def _lookup_spilled(self, key: Tuple) -> Optional[Tuple[object, bool]]:
        """Disk-tier fallthrough for a key absent from memory. Same TTL and
        era semantics as resident entries; an unreadable spill file is a
        plain miss (the value is a cache, never the source of truth)."""
        sp = self._spilled.get(key)
        if sp is None:
            self.misses += 1
            return None
        if self.ttl_s is not None and self._clock() - sp.stamp > self.ttl_s:
            self._drop_spilled(key)
            self.expirations += 1
            self.misses += 1
            return None
        try:
            with open(sp.path, "rb") as f:
                value = _spill_decode(pickle.load(f))
        except (OSError, pickle.PickleError, EOFError):
            self._drop_spilled(key)
            self.misses += 1
            return None
        self.hits += 1
        self.spill_hits += 1
        cross = sp.era < self.era
        if cross:
            self.shared_hits += 1
        return value, cross

    def _drop_spilled(self, key: Tuple) -> None:
        sp = self._spilled.pop(key, None)
        if sp is not None:
            try:
                os.unlink(sp.path)
            except OSError:
                pass

    def _spill(self, key: Tuple, value, tables: Tuple[str, ...],
               nbytes: int) -> None:
        from .store import content_address
        path = os.path.join(self.spill_dir, content_address(key) + ".pkl")
        tmp = None
        try:
            fd, tmp = tempfile.mkstemp(dir=self.spill_dir, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                pickle.dump(_spill_encode(value), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        except Exception:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            self.oversize_bypasses += 1   # spill failed: behave as a bypass
            return
        self._spilled[key] = _SpillEntry(path, self._clock(), self.era,
                                         tuple(tables), nbytes)
        self.spills += 1

    def put(self, key: Tuple, value, tables: Tuple[str, ...]) -> None:
        nbytes = approx_result_bytes(value) \
            if (self.max_bytes is not None
                or self.entry_max_bytes is not None
                or self.spill_dir is not None) else 0
        if self.entry_max_bytes is not None and nbytes > self.entry_max_bytes:
            if self.spill_dir is not None:
                # too big for memory, still worth a round trip: disk tier
                self._spill(key, value, tables, nbytes)
                return
            # bypass: caching this result would evict much of the working
            # set for at most one reuse; skipping it only costs a re-fetch
            self.oversize_bypasses += 1
            return
        old = self._entries.get(key)
        if old is not None:
            self.bytes_used -= old.nbytes
        self._entries[key] = _Entry(value, self._clock(), self.era,
                                    tuple(tables), nbytes)
        self._entries.move_to_end(key)
        self.bytes_used += nbytes
        while len(self._entries) > self.max_entries or (
                self.max_bytes is not None
                and self.bytes_used > self.max_bytes and self._entries):
            _, dropped = self._entries.popitem(last=False)
            self.bytes_used -= dropped.nbytes
            self.evictions += 1

    # --------------------------------------------------------- invalidation
    def invalidate_tables(self, tables) -> int:
        """Eagerly drop entries touching any of ``tables``. Epoch keys
        already make such entries unreachable (their epoch moved); this
        frees the memory and keeps telemetry honest."""
        drop = set(tables)
        stale = [k for k, e in self._entries.items() if drop & set(e.tables)]
        for k in stale:
            self.bytes_used -= self._entries[k].nbytes
            del self._entries[k]
        stale_spilled = [k for k, e in self._spilled.items()
                         if drop & set(e.tables)]
        for k in stale_spilled:
            self._drop_spilled(k)
        self.invalidations += len(stale) + len(stale_spilled)
        return len(stale) + len(stale_spilled)

    def clear(self) -> None:
        self._entries.clear()
        for k in list(self._spilled):
            self._drop_spilled(k)
        self.bytes_used = 0

    def __len__(self) -> int:
        return len(self._entries)

    # ---------------------------------------------- binding-diversity stats
    def observe_binding(self, q: Query, tables: Tuple[str, ...],
                        pkey: Tuple) -> None:
        """Record one lookup at a PARAMETERIZED site (``pkey`` non-empty):
        feeds the per-site and per-group distinct-binding fractions."""
        self._site_stats.setdefault(query_site_key(q),
                                    _SiteStats()).observe(pkey)
        from ..core.context import param_prov_key
        from ..core.cost import query_param_cols
        for gkey in (param_group_key(tables),
                     param_prov_key(tables, query_param_cols(q))):
            self._group_tables.setdefault(gkey, tuple(sorted(tables)))
            self._group_stats.setdefault(gkey, _SiteStats()).observe(pkey)

    def binding_fractions(self) -> Dict[str, float]:
        """Distinct-binding fraction per table group (``qdiv:…`` keys) and
        per provenance group (``qprov:…`` keys) — the publishable
        granularities (exact query trees change under rewriting; table
        sets and param-compared columns survive it)."""
        return {g: s.fraction for g, s in self._group_stats.items()}

    def site_binding_stats(self) -> Dict[str, Dict[str, float]]:
        """Per exact site (``qsite:…``): lookups, distinct bindings,
        fraction. Telemetry granularity."""
        return {site: {"lookups": s.total, "distinct": s.n_distinct,
                       "fraction": s.fraction}
                for site, s in self._site_stats.items()}

    def group_tables(self, gkey: str) -> Tuple[str, ...]:
        return self._group_tables.get(gkey, ())

    # ------------------------------------------------------------ telemetry
    def stats(self) -> Dict[str, object]:
        lookups = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "shared_hits": self.shared_hits,
            "misses": self.misses,
            "hit_rate": self.hits / lookups if lookups else 0.0,
            "expirations": self.expirations,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "bytes_used": self.bytes_used,
            "max_bytes": self.max_bytes,
            "oversize_bypasses": self.oversize_bypasses,
            "spills": self.spills,
            "spill_hits": self.spill_hits,
            "spilled_entries": len(self._spilled),
            "param_sites": len(self._site_stats),
        }

    def describe(self) -> str:
        s = self.stats()
        return (f"SiteCache: {s['entries']} entries, "
                f"{s['hits']} hit(s) ({s['shared_hits']} cross-batch), "
                f"{s['misses']} miss(es), "
                f"{s['invalidations']} invalidation(s)")
