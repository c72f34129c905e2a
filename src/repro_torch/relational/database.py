"""Simulated client/server database environment.

The paper evaluates Cobra against a real MySQL server over ethernet with a
network simulator (Sec. VIII). This container has neither, so we model the
*same knobs the paper's cost catalog exposes*:

  C_NRT       network round-trip time
  BW          network bandwidth
  C_Q^F/C_Q^L server time to first/last row (from a simple server model —
              the paper "consulted the database query optimizer" for these)
  C_Z         per-imperative-statement cost
  AF_Q        amortization factor for prefetched queries

Two distinct views (kept deliberately separate):

  * ``DatabaseServer.run(query)``      — actually executes (torch compute) and
    returns TRUE timing from true cardinalities → the *simulated wall clock*
    ("actual running time" axis of Fig. 13).
  * ``DatabaseServer.estimate(query)`` — cardinality/cost ESTIMATES from table
    statistics only → what Cobra's cost model consumes.

``ClientEnv`` owns the simulated clock, the ORM id-cache (Hibernate caches
fetched rows by primary key — needed to reproduce Fig. 13b), and the
client-side prefetch cache (``cacheByColumn`` / ``lookup``, footnote 3).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from .algebra import (Aggregate, Join, Limit, OrderBy, Project, Query, Scan,
                      Select)
from .table import Table, resolve_device

__all__ = [
    "NetworkProfile", "ServerModel", "TableStats", "QueryEstimate",
    "DatabaseServer", "ClientEnv", "SLOW_REMOTE", "FAST_LOCAL",
]


# --------------------------------------------------------------------------
# Environment profiles (paper Sec. VIII, Experiment 1/2 settings)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NetworkProfile:
    name: str
    bandwidth_bytes_per_s: float
    rtt_s: float

    @property
    def c_nrt(self) -> float:
        return self.rtt_s


# bandwidth 500 kbps, latency 250 ms  (paper: "slow remote network")
SLOW_REMOTE = NetworkProfile("slow_remote", bandwidth_bytes_per_s=500e3 / 8, rtt_s=0.250)
# bandwidth 6 gbps, rtt 0.5 ms        (paper: "fast local network")
FAST_LOCAL = NetworkProfile("fast_local", bandwidth_bytes_per_s=6e9 / 8, rtt_s=0.5e-3)


@dataclasses.dataclass(frozen=True)
class ServerModel:
    """A simple DB-server timing model (stand-in for 'consult the optimizer').

    All rates in rows/second; overheads in seconds. Values loosely calibrated
    to a MySQL 5.7-class server on the paper's hardware.
    """

    startup_s: float = 2e-4            # parse/plan/dispatch per query
    scan_rows_per_s: float = 8e6       # sequential scan emit rate
    index_lookup_s: float = 3e-5       # one B-tree point lookup
    hash_build_rows_per_s: float = 6e6
    hash_probe_rows_per_s: float = 7e6
    sort_rows_per_s: float = 2.5e6     # n log n folded into effective rate
    agg_rows_per_s: float = 9e6
    emit_rows_per_s: float = 1.2e7     # result serialization


@dataclasses.dataclass(frozen=True)
class TableStats:
    nrows: int
    row_bytes: int
    distinct: Mapping[str, int]        # per-column NDV
    minmax: Mapping[str, Tuple[float, float]]
    # per-column histograms (repro_torch.stats.histogram) — empty when the
    # server was built with StatsConfig(histograms=False); their reprs
    # carry content digests, so stats_fingerprint() content-addresses
    # them through repr(TableStats) unchanged
    hists: Mapping[str, "object"] = dataclasses.field(default_factory=dict)

    def ndv(self, col: str) -> int:
        return max(1, int(self.distinct.get(col, max(1, self.nrows // 10))))

    def hist(self, col: str):
        """The column's :class:`~repro_torch.stats.histogram.ColumnHistogram`,
        or None (no histogram statistics for it)."""
        return self.hists.get(col)


@dataclasses.dataclass(frozen=True)
class QueryEstimate:
    """What the optimizer knows about a query before running it (Fig. 12 terms)."""

    n_rows: float          # N_Q
    row_bytes: float       # S_row(Q)
    first_row_s: float     # C_Q^F
    last_row_s: float      # C_Q^L

    @property
    def result_bytes(self) -> float:
        return self.n_rows * self.row_bytes


# --------------------------------------------------------------------------
# Server
# --------------------------------------------------------------------------

_INSTANCE_TOKENS = itertools.count(1)


class DatabaseServer:
    """The simulated server. Its tables live on ``device`` (the card unless
    the caller names another: ``device=None`` without CUDA raises); every
    table installed is moved there."""

    def __init__(self, tables: Dict[str, Table], model: ServerModel = ServerModel(),
                 stats_config=None, device=None):
        from ..stats.histogram import DEFAULT_STATS_CONFIG
        self.device = resolve_device(device)
        self.tables = {n: t.to(self.device) for n, t in tables.items()}
        self.model = model
        self.stats_config = stats_config if stats_config is not None \
            else DEFAULT_STATS_CONFIG
        # process-unique identity: result caches shared across sessions key
        # on it so two servers' identically-named tables never collide
        self.instance_token = next(_INSTANCE_TOKENS)
        self._stats: Dict[str, TableStats] = {}
        self._stats_version = 0
        self._table_versions: Dict[str, int] = {}
        self._data_versions: Dict[str, int] = {}
        # per-column histogram builds since startup — the ANALYZE work
        # counter targeted re-analyzes are judged by (tests/bench)
        self.histogram_builds = 0
        self.analyze()

    def table(self, name: str) -> Table:
        return self.tables[name]

    def add_table(self, t: Table) -> None:
        """Install (or replace) a table AND refresh its statistics."""
        t = t.to(self.device)
        self.tables[t.name] = t
        self._stats[t.name] = self._compute_stats(t)
        self._stats_version += 1
        self._table_versions[t.name] = self._table_versions.get(t.name, 0) + 1
        self._data_versions[t.name] = self._data_versions.get(t.name, 0) + 1

    def replace_table(self, t: Table) -> None:
        """Replace a table's DATA without refreshing statistics — like a bulk
        load on a real server before anyone runs ANALYZE. Estimates go stale
        (``estimate()`` keeps consulting the old stats) while ``run()`` sees
        the new rows; the serving runtime's feedback controller exists to
        detect exactly this drift and trigger a re-analyze. The table's DATA
        version does bump (result caches must never serve the old rows)."""
        t = t.to(self.device)
        self.tables[t.name] = t
        self._data_versions[t.name] = self._data_versions.get(t.name, 0) + 1

    # ----------------------------------------------------------- statistics
    @property
    def stats_version(self) -> int:
        """Monotonic counter over statistics refreshes. Any change to the
        stats a cost model may have consumed (``analyze()``, table
        replacement) bumps it; plan caches key on it for invalidation."""
        return self._stats_version

    def table_version(self, name: str) -> int:
        """Per-table stats version. Plan caches key compiled programs on the
        versions of only the tables they touch, so refreshing an unrelated
        table's statistics leaves those plans hot."""
        return self._table_versions.get(name, 0)

    def data_version(self, name: str) -> int:
        """Per-table DATA version: bumps whenever a table's rows change
        (``add_table``, ``replace_table``, interpreter updates), whether or
        not statistics were refreshed. Result caches — the serving-level
        :class:`~repro_torch.runtime.sitecache.SiteCache` — key on it so a cached
        query result is never served over rows it was not computed from."""
        return self._data_versions.get(name, 0)

    def stats_token(self, tables) -> Tuple[Tuple[str, int], ...]:
        """Cache-key component: (table, stats version) for each named table."""
        return tuple((t, self.table_version(t)) for t in sorted(set(tables)))

    def site_epoch(self, tables) -> Tuple[Tuple[str, int, int], ...]:
        """Result-cache validity token: (table, stats version, data version)
        per named table. Any ``analyze()`` or write to one of the tables
        changes the epoch, so epoch-keyed cached results self-invalidate."""
        return tuple((t, self.table_version(t), self.data_version(t))
                     for t in sorted(set(tables)))

    def stats_fingerprint(self, tables) -> Tuple[Tuple[str, str], ...]:
        """CONTENT hash of the named tables' current statistics.

        Version counters are process-local (a restarted server re-analyzes
        from zero), so the cross-session plan store compares this instead:
        a stored plan stays warm across restarts as long as the statistics
        it was costed on are byte-equal, regardless of how many ``analyze()``
        calls either process has issued."""
        import hashlib
        out = []
        for t in sorted(set(tables)):
            st = self._stats.get(t)
            digest = ("missing" if st is None else
                      hashlib.sha256(repr(st).encode()).hexdigest()[:16])
            out.append((t, digest))
        return tuple(out)

    def analyze(self, *tables: str,
                columns: Optional[Tuple[str, ...]] = None) -> int:
        """Refresh table statistics. With no arguments every table is
        re-analyzed (the legacy behaviour); naming tables refreshes only
        those, bumping only their per-table versions. ``columns`` makes
        the refresh *targeted*: scalar statistics (row counts, NDV,
        min/max) always recompute, but histograms rebuild only for the
        named columns — the others carry over from the previous stats —
        which is what the feedback controller's q-error path requests
        when one site's estimate went bad."""
        names = tables or tuple(self.tables)
        for name in names:
            self._stats[name] = self._compute_stats(
                self.tables[name], columns=columns,
                prev=self._stats.get(name) if columns else None)
            self._table_versions[name] = self._table_versions.get(name, 0) + 1
        self._stats_version += 1
        return self._stats_version

    def _compute_stats(self, t: Table,
                       columns: Optional[Tuple[str, ...]] = None,
                       prev: Optional[TableStats] = None) -> TableStats:
        from ..stats.histogram import build_histogram
        distinct, minmax, hists = {}, {}, {}
        want = None if columns is None else set(columns)
        for f in t.schema.fields:
            arr = t.host(f.name)
            if arr.size:
                distinct[f.name] = int(len(np.unique(arr)))
                minmax[f.name] = (float(arr.min()), float(arr.max()))
            else:
                distinct[f.name] = 1
                minmax[f.name] = (0.0, 0.0)
            if not self.stats_config.histograms:
                continue
            if want is not None and f.name not in want:
                # targeted analyze: keep the previous histogram (possibly
                # stale — exactly the staleness the q-error signal scores)
                carried = prev.hist(f.name) if prev is not None else None
                if carried is not None:
                    hists[f.name] = carried
                continue
            hists[f.name] = build_histogram(arr, self.stats_config)
            self.histogram_builds += 1
        return TableStats(t.nrows, t.row_bytes, distinct, minmax, hists)

    def stats(self, name: str) -> TableStats:
        return self._stats[name]

    # ----------------------------------------------------------- execution
    def run(self, query: Query, params: Optional[Mapping[str, object]] = None
            ) -> Tuple[Table, float, float]:
        """Execute and return (result, true C_Q^F, true C_Q^L)."""
        result = query.execute(self, params)
        first, last = self._true_times(query, params)
        return result, first, last

    def _true_times(self, q: Query, params) -> Tuple[float, float]:
        """Server time model evaluated on TRUE cardinalities (post-execution)."""
        m = self.model
        total = m.startup_s
        blocking = m.startup_s

        def walk(node: Query) -> int:
            nonlocal total, blocking
            if isinstance(node, Scan):
                n = self.table(node.table).nrows
                total += n / m.scan_rows_per_s
                return n
            if isinstance(node, Select):
                n_in = walk(node.child)
                out = node.execute(self, params).nrows
                return out
            if isinstance(node, Project):
                return walk(node.child)
            if isinstance(node, Join):
                nl = walk(node.left)
                nr = walk(node.right)
                build = min(nl, nr)
                probe = max(nl, nr)
                total += build / m.hash_build_rows_per_s + probe / m.hash_probe_rows_per_s
                blocking += build / m.hash_build_rows_per_s
                return node.execute(self, params).nrows
            if isinstance(node, Aggregate):
                n_in = walk(node.child)
                total += n_in / m.agg_rows_per_s
                blocking = total  # aggregation is blocking
                return node.execute(self, params).nrows
            if isinstance(node, OrderBy):
                n_in = walk(node.child)
                total += n_in / m.sort_rows_per_s
                blocking = total  # sort is blocking
                return n_in
            if isinstance(node, Limit):
                return min(node.k, walk(node.child))
            raise TypeError(f"unknown node {node}")

        n_out = walk(q)
        total += n_out / m.emit_rows_per_s
        first = min(blocking, total)
        last = total
        return first, last

    # ----------------------------------------------------------- estimation
    def estimate(self, q: Query, params_known: bool = False) -> QueryEstimate:
        """Cardinality + server-time estimates from statistics only."""
        m = self.model
        total = m.startup_s
        blocking = m.startup_s

        def est_rows(node: Query) -> Tuple[float, float]:
            """returns (est rows, est row_bytes)"""
            nonlocal total, blocking
            if isinstance(node, Scan):
                st = self.stats(node.table)
                total += st.nrows / m.scan_rows_per_s
                return float(st.nrows), float(st.row_bytes)
            if isinstance(node, Select):
                n, rb = est_rows(node.child)
                sel = self._selectivity(node)
                return max(1.0, n * sel), rb
            if isinstance(node, Project):
                n, rb = est_rows(node.child)
                try:
                    rb_exact = float(node.output_schema(self).row_bytes)
                    return n, max(4.0, rb_exact)
                except Exception:
                    sch_cols = len(node.cols) + len(node.computed)
                    return n, max(4.0, rb * sch_cols / max(1, sch_cols + 2))
            if isinstance(node, Join):
                nl, rbl = est_rows(node.left)
                nr, rbr = est_rows(node.right)
                ndv_l = self._ndv_of(node.left, node.left_key)
                ndv_r = self._ndv_of(node.right, node.right_key)
                out = nl * nr / max(ndv_l, ndv_r, 1.0)
                build = min(nl, nr)
                probe = max(nl, nr)
                total += build / m.hash_build_rows_per_s + probe / m.hash_probe_rows_per_s
                blocking += build / m.hash_build_rows_per_s
                return max(1.0, out), rbl + rbr
            if isinstance(node, Aggregate):
                n, rb = est_rows(node.child)
                total += n / m.agg_rows_per_s
                blocking = total
                if not node.group_by:
                    return 1.0, 8.0 * len(node.aggs)
                groups = 1.0
                for g in node.group_by:
                    groups *= self._ndv_of(node.child, g)
                return min(n, groups), 8.0 * (len(node.group_by) + len(node.aggs))
            if isinstance(node, OrderBy):
                n, rb = est_rows(node.child)
                total += n / m.sort_rows_per_s
                blocking = total
                return n, rb
            if isinstance(node, Limit):
                n, rb = est_rows(node.child)
                return min(float(node.k), n), rb
            raise TypeError(f"unknown node {node}")

        n, rb = est_rows(q)
        total += n / m.emit_rows_per_s
        return QueryEstimate(n_rows=n, row_bytes=rb,
                             first_row_s=min(blocking, total), last_row_s=total)

    def _selectivity(self, node: Select) -> float:
        from ..stats.selectivity import predicate_selectivity
        sel = predicate_selectivity(
            node.pred,
            resolve=lambda col: self._hist_of(node.child, col),
            ndv_of=lambda col: self._ndv_of(node.child, col))
        return 0.5 if sel is None else sel

    def _hist_of(self, node: Query, col: str):
        """The column's histogram at the Select's input, resolved like
        ``_ndv_of``: walk row-preserving nodes down to the base Scan. Join
        and post-aggregate inputs return None (their output distribution
        is not a base column's), falling back to the scalar estimates."""
        if isinstance(node, Scan):
            st = self._stats.get(node.table)
            return st.hist(col) if st is not None else None
        if isinstance(node, (Select, Project, OrderBy, Limit)):
            kids = node.children()
            return self._hist_of(kids[0], col) if kids else None
        return None

    def _ndv_of(self, node: Query, col: str) -> float:
        if isinstance(node, Scan):
            return float(self.stats(node.table).ndv(col))
        if isinstance(node, (Select, Project, OrderBy, Limit, Aggregate)):
            kids = node.children()
            return self._ndv_of(kids[0], col) if kids else 100.0
        if isinstance(node, Join):
            try:
                return self._ndv_of(node.left, col)
            except Exception:
                return self._ndv_of(node.right, col)
        return 100.0


# --------------------------------------------------------------------------
# Client environment (simulated clock + caches)
# --------------------------------------------------------------------------

class ClientEnv:
    """Application-side runtime: clock, ORM id-cache, prefetch cache.

    Charges time per Sec. VI:
        C_Q = C_NRT + C_Q^F + max(N_Q*S_row/BW, C_Q^L − C_Q^F)
    """

    def __init__(self, db: DatabaseServer, network: NetworkProfile,
                 c_z: float = 30e-9, orm_cache: bool = True):
        self.db = db
        self.network = network
        self.c_z = c_z              # per-imperative-statement cost (paper: 30ns)
        self.clock = 0.0
        self.orm_cache_enabled = orm_cache
        self._orm_cache: Dict[Tuple[str, object], Dict[str, object]] = {}
        self._prefetch_cache: Dict[Tuple[str, str], Dict[object, list]] = {}
        self.query_log: list = []
        self.n_queries = 0
        self.n_round_trips = 0
        # (site_key, iteration_count) per executed while loop / collection-
        # source cursor loop — the observations the feedback controller
        # folds into an ExecutionContext's StatsProfile
        self.iteration_log: list = []

    def record_iterations(self, site: str, count: int) -> None:
        self.iteration_log.append((site, int(count)))

    # ---------------------------------------------------------------- clock
    def charge_statement(self, n: int = 1) -> None:
        self.clock += self.c_z * n

    def _charge_query(self, n_rows: int, row_bytes: int, first_s: float, last_s: float) -> float:
        transfer = n_rows * row_bytes / self.network.bandwidth_bytes_per_s
        cost = self.network.c_nrt + first_s + max(transfer, last_s - first_s)
        self.clock += cost
        self.n_queries += 1
        self.n_round_trips += 1
        return cost

    # --------------------------------------------------------------- queries
    def execute_query(self, q: Query, params: Optional[Mapping[str, object]] = None) -> Table:
        result, first_s, last_s = self.db.run(q, params)
        cost = self._charge_query(result.nrows, result.row_bytes, first_s, last_s)
        self.query_log.append((q.sql(), result.nrows, cost))
        return result

    def point_lookup(self, table: str, key_col: str, key_val) -> Optional[Dict[str, object]]:
        """ORM-style navigation (o.customer): point query w/ Hibernate id-cache."""
        ck = (table, key_val)
        if self.orm_cache_enabled and ck in self._orm_cache:
            self.charge_statement()
            return self._orm_cache[ck]
        t = self.db.table(table)
        # index lookup: server time is one B-tree probe, one row out
        arr = t.host(key_col)
        idx = np.flatnonzero(arr == key_val)
        m = self.db.model
        self._charge_query(len(idx), t.row_bytes,
                           m.startup_s + m.index_lookup_s,
                           m.startup_s + m.index_lookup_s + len(idx) / m.emit_rows_per_s)
        self.query_log.append((f"SELECT * FROM {table} WHERE {key_col} = {key_val}", len(idx), None))
        if len(idx) == 0:
            return None
        row = t.row(int(idx[0]))
        if self.orm_cache_enabled:
            self._orm_cache[ck] = row
        return row

    # --------------------------------------------------- prefetch cache (N1)
    def cache_by_column(self, t: Table, col: str) -> None:
        """``Utils.cacheByColumn`` from the paper (footnote 3)."""
        index: Dict[object, list] = {}
        arr = t.host(col)
        # building the local hash index costs C_Z per row
        self.charge_statement(t.nrows)
        order = np.argsort(arr, kind="stable")
        sorted_keys = arr[order]
        # store as (table, sorted keys, order) for O(log n) lookups
        self._prefetch_cache[(t.name, col)] = {
            "table": t, "keys": sorted_keys, "order": order,
        }

    def lookup_cache(self, table_name: str, col: str, key_val) -> Optional[Dict[str, object]]:
        entry = self._prefetch_cache.get((table_name, col))
        if entry is None:
            raise KeyError(f"no prefetch cache for ({table_name}, {col})")
        self.charge_statement()
        keys = entry["keys"]
        lo = np.searchsorted(keys, key_val, side="left")
        if lo < len(keys) and keys[lo] == key_val:
            return entry["table"].row(int(entry["order"][lo]))
        return None

    def lookup_cache_all(self, table_name: str, col: str, key_val) -> list:
        entry = self._prefetch_cache.get((table_name, col))
        if entry is None:
            raise KeyError(f"no prefetch cache for ({table_name}, {col})")
        self.charge_statement()
        keys = entry["keys"]
        lo = np.searchsorted(keys, key_val, side="left")
        hi = np.searchsorted(keys, key_val, side="right")
        t = entry["table"]
        return [t.row(int(entry["order"][i])) for i in range(lo, hi)]

    def has_cache(self, table_name: str, col: str) -> bool:
        return (table_name, col) in self._prefetch_cache

    def reset(self) -> None:
        self.clock = 0.0
        self._orm_cache.clear()
        self._prefetch_cache.clear()
        self.query_log.clear()
        self.n_queries = 0
        self.n_round_trips = 0
