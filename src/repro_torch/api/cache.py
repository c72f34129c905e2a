"""Stats-versioned plan cache: compile once, execute many.

Keyed by (program fingerprint, cost-catalog key, optimizer-config key,
stats token). The stats token is the vector of PER-TABLE statistics
versions for exactly the tables the program touches (``program_tables``),
so a cached plan is invalidated when the statistics its cost model
consumed go stale — the winning plan may legitimately flip (e.g. P1 join
→ P2 prefetch) after cardinalities shift — while an ``analyze()`` of an
unrelated table leaves it hot.

Entries are LRU-evicted beyond ``max_entries``; hit/miss/eviction counters
feed ``CobraSession.telemetry``. The disk-backed, cross-session variant
lives in ``repro_torch.runtime.store.PlanStore`` and shares this key vocabulary.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from ..core.context import ONE_SHOT

__all__ = ["ArtifactCache", "PlanCache", "PlanCacheKey",
           "program_fingerprint", "program_tables", "program_write_tables",
           "program_read_tables", "program_sites", "program_param_sites",
           "query_tables"]


def program_fingerprint(program) -> str:
    """Stable content hash of a Program's structural key (name excluded, so
    two identically-shaped programs share compiled plans)."""
    key = program.key()
    # drop the name component ("P", name, body_key, outputs) -> structure
    # only; declared inputs (name, default) are NOT part of Program.key()
    # but change run() semantics, so they must distinguish fingerprints
    structural = (key[0],) + tuple(key[2:]) + (tuple(program.inputs),)
    return hashlib.sha256(repr(structural).encode()).hexdigest()[:32]


def query_tables(q) -> Tuple[str, ...]:
    """All base tables a relational ``Query`` tree scans."""
    from ..relational.algebra import scan_tables
    return scan_tables(q)


def program_tables(program) -> Tuple[str, ...]:
    """All base tables a Program touches (queries, ORM navigations, cache
    lookups, prefetches, updates). The plan-cache key carries the stats
    versions of exactly these tables."""
    from ..core.regions import (BasicBlock, CondRegion, ICacheLookup, ILoadAll,
                                INav, IExpr, LoopRegion, Prefetch, SeqRegion,
                                UpdateRow, WhileRegion)
    out = set()

    def from_expr(e):
        if not isinstance(e, IExpr):
            return
        if isinstance(e, ILoadAll):
            out.add(e.table)
            return
        if isinstance(e, INav):
            out.add(e.target)
        if isinstance(e, ICacheLookup):
            out.add(e.table)
        q = getattr(e, "query", None)
        if q is not None:
            out.update(query_tables(q))
        for attr in ("base", "left", "right", "keyexpr"):
            k = getattr(e, attr, None)
            if k is not None:
                from_expr(k)
        for a in getattr(e, "args", ()):
            from_expr(a)
        for _, b in getattr(e, "bindings", ()):
            from_expr(b)

    def from_stmt(s):
        if isinstance(s, Prefetch):
            out.update(query_tables(s.query))
            return
        if isinstance(s, UpdateRow):
            out.add(s.table)
        for attr in ("expr", "val", "keyexpr", "valexpr"):
            e = getattr(s, attr, None)
            if e is not None:
                from_expr(e)

    def walk(r):
        if isinstance(r, BasicBlock):
            from_stmt(r.stmt)
        elif isinstance(r, SeqRegion):
            for p in r.parts:
                walk(p)
        elif isinstance(r, LoopRegion):
            from_expr(r.source)
            walk(r.body)
        elif isinstance(r, CondRegion):
            from_expr(r.pred)
            walk(r.then_r)
            if r.else_r is not None:
                walk(r.else_r)
        elif isinstance(r, WhileRegion):
            from_expr(r.pred)
            walk(r.body)

    walk(program.body)
    return tuple(sorted(out))


def program_write_tables(program) -> Tuple[str, ...]:
    """The base tables a Program WRITES (``UpdateRow`` statements only).

    The write-set half of the read/write split: sites over tables outside
    this set stay shareable through the serving site cache even when the
    program mutates other tables (``runtime.batch``'s write-set-aware
    sequential path)."""
    from ..core.regions import write_tables
    return write_tables(program)


def program_read_tables(program) -> Tuple[str, ...]:
    """The base tables a Program only READS: ``program_tables`` minus
    ``program_write_tables``."""
    writes = set(program_write_tables(program))
    return tuple(t for t in program_tables(program) if t not in writes)


def program_param_sites(program) -> Tuple[str, ...]:
    """The PARAMETERIZED query-site groups a Program contains (``qdiv:…``
    keys, one per distinct base-table set among its parameterized query /
    scalar-query / prefetch sites).

    These are the sites whose fetch cost depends on how often bindings
    repeat at runtime: the serving site cache observes their distinct-
    binding fraction and the cost model amortizes by it
    (:meth:`~repro_torch.core.cost.CostModel.param_site_amortization`). Like
    iteration sites, they participate in a program's context fingerprint,
    so a published diversity moves exactly the plans that can act on it.

    Groups over tables the program WRITES are excluded: the runtime never
    caches those sites (each invocation must see earlier writes), so no
    published diversity can be delivered there — the cost model refuses it
    too (its ``write_tables`` guard) and keying plans on it would only
    cause spurious recompiles."""
    from ..core.context import param_group_key
    return _param_site_keys(program,
                            lambda q: param_group_key(query_tables(q)))


def program_param_prov_sites(program) -> Tuple[str, ...]:
    """The parameterized sites' PROVENANCE keys (``qprov:…``,
    :func:`~repro_torch.core.context.param_prov_key`): one per distinct
    (base-table set, param-compared columns) pair among the program's
    parameterized sites. Finer than :func:`program_param_sites`'s table
    groups — this is what lets two differently-diverse sites over one
    table carry separately-published diversities — with the same
    write-table exclusion."""
    from ..core.context import param_prov_key
    from ..core.cost import query_param_cols
    return _param_site_keys(
        program,
        lambda q: param_prov_key(query_tables(q), query_param_cols(q)))


def _param_site_keys(program, key_of) -> Tuple[str, ...]:
    """Shared walk behind :func:`program_param_sites` /
    :func:`program_param_prov_sites`: apply ``key_of`` to every
    parameterized (or pre-bound) query site over non-written tables."""
    from ..core.cost import query_has_params
    from ..core.regions import (BasicBlock, IExpr, LoopRegion, Prefetch,
                                Region)
    out = set()
    written = set(program_write_tables(program))

    def from_query(q, bindings=()):
        if (bindings or query_has_params(q)) \
                and not written & set(query_tables(q)):
            out.add(key_of(q))

    def from_expr(e):
        if not isinstance(e, IExpr):
            return
        q = getattr(e, "query", None)
        if q is not None:
            from_query(q, getattr(e, "bindings", ()))
        for attr in ("base", "left", "right", "keyexpr"):
            k = getattr(e, attr, None)
            if k is not None:
                from_expr(k)
        for a in getattr(e, "args", ()):
            from_expr(a)
        for _, b in getattr(e, "bindings", ()):
            from_expr(b)

    def walk(r: Region):
        if isinstance(r, BasicBlock):
            s = r.stmt
            if isinstance(s, Prefetch):
                from_query(s.query)
            for attr in ("expr", "val", "keyexpr", "valexpr"):
                e = getattr(s, attr, None)
                if e is not None:
                    from_expr(e)
        elif isinstance(r, LoopRegion):
            from_expr(r.source)
        pred = getattr(r, "pred", None)
        if pred is not None:
            from_expr(pred)
        for c in r.children():
            walk(c)

    walk(program.body)
    return tuple(sorted(out))


def program_sites(program) -> Tuple[str, ...]:
    """The observation sites a Program contains that table statistics
    cannot estimate: while guards and cursor loops over collection (non-
    query) sources (iteration counts), plus its parameterized query-site
    groups (binding diversity, :func:`program_param_sites`). An
    :class:`~repro_torch.core.context.ExecutionContext`'s fingerprint restricts
    its observed stats to exactly these, so observations at other programs'
    sites leave this program's plans hot."""
    from ..core.context import loop_site_key, while_site_key
    from ..core.regions import (ILoadAll, IQuery, LoopRegion, Region,
                                WhileRegion)
    out = []

    def walk(r: Region):
        if isinstance(r, WhileRegion):
            out.append(while_site_key(r.pred))
        elif isinstance(r, LoopRegion) and not isinstance(
                r.source, (IQuery, ILoadAll)):
            out.append(loop_site_key(r.var, r.source))
        for c in r.children():
            walk(c)

    walk(program.body)
    out.extend(program_param_sites(program))
    out.extend(program_param_prov_sites(program))
    return tuple(sorted(set(out)))


@dataclasses.dataclass(frozen=True)
class PlanCacheKey:
    program_fp: str
    catalog_key: Tuple
    config_key: Tuple
    # per-table stats token ((table, version), ...) for the tables the
    # program touches; any hashable works (unit tests use plain ints)
    stats_version: object
    # ExecutionContext fingerprint (batch size + observed iteration stats
    # restricted to the program's sites); default = one-shot/no-stats, so
    # directly-constructed keys in unit tests keep working
    context_key: Tuple = ONE_SHOT.fingerprint()


class PlanCache:
    """A small LRU over compiled :class:`~repro_torch.core.search.OptimizationResult`s."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._entries: "OrderedDict[PlanCacheKey, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: PlanCacheKey) -> Optional[object]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            # a stale sibling (same program/catalog/config, older stats
            # version) counts as an invalidation, not a cold miss
            for k in self._entries:
                if (k.program_fp == key.program_fp
                        and k.catalog_key == key.catalog_key
                        and k.config_key == key.config_key
                        and k.stats_version != key.stats_version):
                    self.invalidations += 1
                    break
            return None
        self.hits += 1
        self._entries.move_to_end(key)
        return entry

    def put(self, key: PlanCacheKey, value: object) -> None:
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.evictions += 1

    def drop_stale(self, current_stats_version: int) -> int:
        """Eagerly drop entries compiled against older statistics."""
        stale = [k for k in self._entries
                 if k.stats_version != current_stats_version]
        for k in stale:
            del self._entries[k]
        return len(stale)

    def clear(self) -> None:
        self._entries.clear()

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "invalidations": self.invalidations}


class ArtifactCache:
    """LRU over compiled execution artifacts (the lowered-executable tier).

    The compiled sibling of :class:`PlanCache`: where the plan cache memoizes
    the *optimizer's* output (which plan wins), this memoizes the *lowering's*
    output (the columnar executable for that plan), content-addressed by the
    same fingerprint vocabulary (see ``runtime.store.content_address``).
    Invalidation is predicate-based because artifact staleness is decided by
    the owner (:class:`repro_torch.compiled.manager.CompileManager` drops artifacts
    whose programs touch drifted tables)."""

    def __init__(self, max_entries: int = 64):
        self.max_entries = max_entries
        self._entries: "OrderedDict[object, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key) -> Optional[object]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        self._entries.move_to_end(key)
        return entry

    def put(self, key, value) -> None:
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.evictions += 1

    def invalidate(self, pred) -> int:
        """Drop every entry for which ``pred(key, value)`` is true."""
        stale = [k for k, v in self._entries.items() if pred(k, v)]
        for k in stale:
            del self._entries[k]
        self.invalidations += len(stale)
        return len(stale)

    def clear(self) -> None:
        self._entries.clear()

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "invalidations": self.invalidations}
