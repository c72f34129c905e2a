"""Sharded database coordinator: scatter-gather execution over N shards.

``ShardedDatabase`` is a drop-in :class:`~repro_torch.relational.database
.DatabaseServer`: sessions, client environments, the interpreter's direct
table reads/writes, and the cost model all work against it unchanged. Under
the hood each table lives horizontally partitioned (or replicated) across N
plain per-shard ``DatabaseServer`` instances (see
:class:`~repro_torch.cluster.partition.Partitioner`), and ``run()`` executes
query sites shard-parallel where a bit-exact merge exists:

  * **pruned** — an equality predicate on the partition key routes the
    whole query to the one shard owning those rows (all matching rows are
    colocated, in original relative order — no merge needed);
  * **replicated** — a query over replicated tables only runs on one
    replica (every replica is a full copy);
  * **ordered merge** — row-preserving shapes (Scan/Select/Project chains,
    and joins of a partitioned side against a replicated side) execute on
    every shard, partials are concatenated and stable-sorted by the hidden
    ``__gpos`` provenance column: exactly the unsharded row order;
  * **partial-aggregate combine** — aggregates whose fold is exact under
    re-association (count, min, max, and sum/avg over integer columns —
    avg ships as a (sum, count) partial-state pair with one final
    division) run per shard and combine; float sums/avgs are NOT combined
    (float addition is order-sensitive) and fall back to gathering the
    child. An integer avg combines only while its rows and running sums
    stay below 2**24, where the unsharded fp32 sum is exact in any order;
    past that bound (checked on per-shard min/max partials) it gathers too;
  * **gather** — anything else executes against the coordinator's merged
    views, which are themselves rebuilt from the shards — always correct,
    never shard-parallel.

**Global statistics.** ``analyze()`` computes statistics over the MERGED
table content, so ``estimate()`` (inherited unchanged) returns exactly the
numbers an unsharded server would — the optimizer picks the same plans,
and drift detection fires on the same evidence. Version counters
(``stats_version`` / ``table_version`` / ``data_version``) are derived as
sums over the per-shard counters: a write or ``analyze()`` on ONE shard —
even one issued directly against the shard, bypassing the coordinator —
moves the coordinator's epoch, so epoch-keyed site caches self-invalidate
with per-shard precision and the bit-identity guarantee survives
mid-stream writes.

**Writes.** ``add_table``/``replace_table`` (the interpreter's UPDATE path
funnels through ``add_table``) re-partition the written rows to their
owning shards; merged views are rebuilt lazily when any shard's data
version moves.

Simulated timing: a scattered site charges the slowest shard's server time
(shards work in parallel) plus a merge pass over the gathered rows; a
pruned site charges only its one shard. Output bit-identity never depends
on the clock — the non-negotiable invariant is on results and database
state, asserted program-by-program in ``tests/test_torch_cluster.py``.

**Device.** The coordinator, every shard server and every merged view live
on ONE device, the coordinator's (the card unless the caller names another;
``device=None`` without CUDA raises). The shards are logical partitions on
that device, not a placement across several. Provenance (``__gpos``) and
the partial-aggregate folds are read through the tables' host mirrors, so
merge order and combined values do not depend on where the tables live.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.trace import NOOP_TRACER
from ..relational.algebra import (Aggregate, AggSpec, BoolOp, Cmp, Col, Join,
                                  Limit, Lit, OrderBy, Param, Project, Query,
                                  Scan, Select, scan_tables)
from ..relational.database import DatabaseServer, ServerModel
from ..relational.table import Field, Schema, Table, np_dtype_name
from .partition import GPOS, Partitioner, strip_gpos

__all__ = ["ShardedDatabase"]

# combine function per aggregate: how per-shard partials fold into the
# global value (count partials ADD; min/max fold through themselves)
_COMBINE_FUNC = {"count": "sum", "sum": "sum", "min": "min", "max": "max"}

# fp32 holds every integer below 2**24 exactly: an integer avg over fewer
# rows, whose values bound every running sum below it, sums exactly in ANY
# order, so its (sum, count) partial states give the unsharded fp32 avg
# bit for bit. Past it the unsharded sum rounds, in its own order.
_FP32_EXACT = 1 << 24


def _avg_states_exact(n, lo, hi) -> bool:
    """Row counts ``n`` and value bounds ``lo``/``hi`` (per group, or one
    each) keep an integer fp32 sum exact: ``n < 2**24`` and
    ``n * max(|lo|, |hi|) < 2**24``."""
    n = np.asarray(n, dtype=np.int64)
    m = np.maximum(np.abs(np.asarray(lo, dtype=np.int64)),
                   np.abs(np.asarray(hi, dtype=np.int64)))
    return bool(np.all(n < _FP32_EXACT) and np.all(n * m < _FP32_EXACT))


class _GatheredView:
    """A one-table shim database for applying a non-distributable head
    node (OrderBy / Limit / Aggregate) locally over an already-gathered
    child result — the head executes through the SAME node code as the
    unsharded server, so its output is bit-identical by construction."""

    def __init__(self, t: Table):
        self._t = t

    def table(self, name: str) -> Table:
        return self._t


class ShardedDatabase(DatabaseServer):
    """N-shard coordinator that is itself a ``DatabaseServer``."""

    def __init__(self, tables: Dict[str, Table], *, n_shards: int,
                 keys: Optional[Mapping[str, str]] = None,
                 model: ServerModel = ServerModel(),
                 merge_rows_per_s: Optional[float] = None,
                 tracer=None, stats_config=None, device=None):
        # base init computes GLOBAL stats over the unsharded tables and
        # calls the (guarded) analyze(); cluster structures come after
        self._cluster_ready = False
        super().__init__(tables, model, stats_config=stats_config,
                         device=device)
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.partitioner = Partitioner(n_shards, keys)
        self.n_shards = n_shards
        self.merge_rows_per_s = merge_rows_per_s or model.agg_rows_per_s
        # shards share the coordinator's histogram config: merging
        # per-shard histograms requires identical bucket/MCV/sketch shapes
        self.shards: List[DatabaseServer] = [
            DatabaseServer({}, model, stats_config=self.stats_config,
                           device=self.device)
            for _ in range(n_shards)]
        for t in self.tables.values():
            for k, part in enumerate(self.partitioner.shard_tables(t)):
                self.shards[k].add_table(part)
        # per-table shard data-version tuple at last merged-view rebuild;
        # a direct write to any ONE shard invalidates the view lazily
        self._merged_sync: Dict[str, Tuple[int, ...]] = {
            name: self._shard_data_versions(name) for name in self.tables}
        # telemetry: how each query site actually executed
        self.pruned_queries = 0
        self.replicated_queries = 0
        self.scattered_queries = 0
        self.gathered_queries = 0
        self.shard_queries = [0] * n_shards     # per-shard routed load
        self._cluster_ready = True

    @classmethod
    def shard(cls, db: DatabaseServer, n_shards: int,
              keys: Optional[Mapping[str, str]] = None,
              **kw) -> "ShardedDatabase":
        """Partition an existing server's tables across ``n_shards``, on
        that server's device unless ``device=`` names another."""
        kw.setdefault("device", db.device)
        return cls(db.tables, n_shards=n_shards, keys=keys,
                   model=db.model, **kw)

    # ------------------------------------------------------ derived versions
    def _shard_data_versions(self, name: str) -> Tuple[int, ...]:
        return tuple(s.data_version(name) for s in self.shards)

    @property
    def stats_version(self) -> int:
        if not self._cluster_ready:
            return self._stats_version
        return sum(s.stats_version for s in self.shards)

    def table_version(self, name: str) -> int:
        if not self._cluster_ready:
            return super().table_version(name)
        return sum(s.table_version(name) for s in self.shards)

    def data_version(self, name: str) -> int:
        if not self._cluster_ready:
            return super().data_version(name)
        return sum(s.data_version(name) for s in self.shards)

    def shard_versions(self, name: str) -> Tuple[Tuple[int, int], ...]:
        """Per-shard (table_version, data_version) for the named table —
        the fine-grained view behind the summed coordinator epoch."""
        return tuple((s.table_version(name), s.data_version(name))
                     for s in self.shards)

    # -------------------------------------------------------- merged views
    def _partitioned(self, name: str) -> bool:
        """Partitioned IN PRACTICE: a declared key column that the current
        table actually has. A program installing a fresh table under a
        partitioned name without the key column gets it replicated (see
        ``Partitioner.shard_assignment``), and classification must agree —
        its shard copies carry no ``__gpos``, so an ordered merge would
        have nothing to order by."""
        key = self.partitioner.key_column(name)
        t = self.tables.get(name)
        return key is not None and t is not None and t.schema.has(key)

    def table(self, name: str) -> Table:
        if self._cluster_ready:
            self._refresh_merged(name)
        return self.tables[name]

    def _refresh_merged(self, name: str) -> None:
        cur = self._shard_data_versions(name)
        if self._merged_sync.get(name) == cur:
            return
        self.tables[name] = self._rebuild_merged(name)
        self._merged_sync[name] = cur

    def _rebuild_merged(self, name: str) -> Table:
        parts = [s.table(name) for s in self.shards]
        if self.partitioner.key_column(name) is None \
                or not parts[0].schema.has(self.partitioner.key_column(name)):
            # replicated (declared, or in practice — the key column is
            # absent so shard_tables stored full copies): shard 0 is the
            # canonical replica
            return strip_gpos(parts[0])
        stripped = [strip_gpos(p) for p in parts]
        merged = stripped[0]
        for p in stripped[1:]:
            merged = merged.concat_rows(p)
        if all(p.schema.has(GPOS) for p in parts):
            g = np.concatenate([p.host(GPOS) for p in parts]) \
                if merged.nrows else np.asarray([], dtype=np.int64)
            if len(np.unique(g)) == len(g):
                # valid provenance: restore the exact global row order
                return merged.take(np.argsort(g, kind="stable"))
        # provenance missing or inconsistent (a shard was replaced
        # directly): shard-order concatenation defines the global order
        return merged

    # --------------------------------------------------------------- writes
    def add_table(self, t: Table) -> None:
        if not self._cluster_ready:
            return super().add_table(t)
        t = t.to(self.device)
        self.tables[t.name] = t
        self._stats[t.name] = self._compute_stats(t)
        for k, part in enumerate(self.partitioner.shard_tables(t)):
            self.shards[k].add_table(part)
        self._merged_sync[t.name] = self._shard_data_versions(t.name)

    def replace_table(self, t: Table) -> None:
        if not self._cluster_ready:
            return super().replace_table(t)
        # bulk load without ANALYZE: statistics stay stale, data moves
        t = t.to(self.device)
        self.tables[t.name] = t
        for k, part in enumerate(self.partitioner.shard_tables(t)):
            self.shards[k].replace_table(part)
        self._merged_sync[t.name] = self._shard_data_versions(t.name)

    def analyze(self, *tables: str,
                columns: Optional[Tuple[str, ...]] = None) -> int:
        if not self._cluster_ready:
            return super().analyze(*tables, columns=columns)
        names = tables or tuple(self.tables)
        for name in names:
            # GLOBAL statistics over the merged content: estimate() stays
            # bit-identical to an unsharded server's
            self._refresh_merged(name)
            for s in self.shards:
                s.analyze(name, columns=columns)
            prev = self._stats.get(name) if columns is not None else None
            if self._partitioned(name):
                self._stats[name] = self._merged_stats(
                    name, columns=columns, prev=prev)
            else:
                self._stats[name] = self._compute_stats(
                    self.tables[name], columns=columns, prev=prev)
        return self.stats_version

    def _merged_stats(self, name: str,
                      columns: Optional[Tuple[str, ...]] = None,
                      prev=None):
        """Coordinator statistics for a PARTITIONED table: scalars over the
        merged content, histograms by the lossless merge of the freshly
        analyzed per-shard histograms — ``merge_histograms`` is associative
        and the bucket/MCV/sketch derivation deterministic, so every merged
        histogram is bit-for-bit what a direct build over the merged rows
        produces (the reconciliation property ``tests/test_stats.py``
        asserts). The shards' hidden ``__gpos`` provenance column never has
        a coordinator-side field, so it drops out here by construction."""
        from ..stats.histogram import merge_all
        t = self.tables[name]
        # columns=() computes the scalar statistics without building (or
        # charging histogram_builds for) any coordinator-side histogram
        st = self._compute_stats(t, columns=())
        if not self.stats_config.histograms:
            return st
        hists = {}
        for f in t.schema.fields:
            if columns is not None and f.name not in columns:
                carried = prev.hist(f.name) if prev is not None else None
                if carried is not None:
                    hists[f.name] = carried
                continue
            shard_hists = [h for h in (s._stats[name].hist(f.name)
                                       for s in self.shards) if h is not None]
            if shard_hists:
                hists[f.name] = merge_all(shard_hists)
        return dataclasses.replace(st, hists=hists)

    # ------------------------------------------------------------ execution
    def run(self, query: Query, params: Optional[Mapping[str, object]] = None
            ) -> Tuple[Table, float, float]:
        if not self._cluster_ready:
            return super().run(query, params)
        tables = scan_tables(query)
        for t in tables:
            self._refresh_merged(t)
        parted = [t for t in tables if self._partitioned(t)]
        if not parted:
            self.replicated_queries += 1
            self.shard_queries[0] += 1
            result, first, last = self.shards[0].run(query, params)
            return strip_gpos(result), first, last
        k = self._prune_shard(query, params, parted)
        if k is not None:
            self.pruned_queries += 1
            self.shard_queries[k] += 1
            if self.tracer.enabled:
                self.tracer.event("scatter-gather", sql=query.sql(),
                                  mode="pruned", shard=k)
            result, first, last = self.shards[k].run(query, params)
            return strip_gpos(result), first, last
        kind = self._classify(query)
        if kind in ("part", "agg", "gather-child"):
            return self._scatter(query, params, kind)
        # no exact distributed merge: execute on the merged views — the
        # unsharded code path, charged at unsharded (single-node) cost
        self.gathered_queries += 1
        return super().run(query, params)

    # ----------------------------------------------------- merge planning
    def _classify(self, node: Query) -> Optional[str]:
        """How this subtree distributes:

        ``"repl"``  — touches only replicated tables (any replica answers);
        ``"part"``  — per-shard partials ordered-merge exactly by __gpos;
        ``"agg"``   — Aggregate over a "part" child with exactly-combinable
                      folds (partial-aggregate combine);
        ``"gather-child"`` — head node applies locally over its gathered
                      "part" child;
        ``None``    — no exact distributed execution (gather fallback).
        """
        if isinstance(node, Scan):
            return "part" if self._partitioned(node.table) else "repl"
        if isinstance(node, (Select, Project)):
            c = self._classify(node.child)
            return c if c in ("part", "repl") else None
        if isinstance(node, Join):
            left = self._classify(node.left)
            right = self._classify(node.right)
            if left == "repl" and right == "repl":
                return "repl"
            if left == "part" and right == "repl":
                # right is a full copy on every shard: each left row finds
                # ALL its matches on its own shard, in the same order the
                # unsharded join emits them
                return "part"
            return None
        if isinstance(node, Aggregate):
            c = self._classify(node.child)
            if c == "repl":
                return "repl"
            if c == "part":
                return "agg" if self._combinable(node) else "gather-child"
            return None
        if isinstance(node, (OrderBy, Limit)):
            c = self._classify(node.child)
            if c == "repl":
                return "repl"
            if c == "part":
                return "gather-child"
            return None
        return None

    def _combinable(self, node: Aggregate) -> bool:
        """True when every fold is exact under re-association: count / min /
        max always, sum and avg only over integer columns — float addition
        is order-sensitive, and bit-identity outranks shard-parallel sums.
        avg distributes as (sum, count) partial states with one final
        division (see :meth:`_scatter_agg`), so its guard is sum's."""
        for a in node.aggs:
            if a.func in ("count", "min", "max"):
                continue
            if a.func not in ("sum", "avg"):
                return False
            try:
                f = node.child.output_schema(self).field(a.col)
            except Exception:
                return False
            if np.dtype(f.dtype).kind not in "iu":
                return False
        return True

    # ---------------------------------------------------------- prune path
    def _prune_shard(self, query: Query, params, parted: Sequence[str]
                     ) -> Optional[int]:
        """The single shard owning every row the query can touch, or None.

        Sound only when exactly one partitioned table is involved and EVERY
        scan of it sits under Select predicates pinning the partition key
        to one value (conjunct ``key == literal/param``). Predicates are
        only collected through row-preserving ancestors (Select / Project /
        OrderBy) — a Limit or Aggregate between the Select and the Scan
        would make per-shard execution observe a different row set, and a
        Join's output columns may not be the scan's, so collection restarts
        below those nodes."""
        if len(parted) != 1:
            return None
        tname = parted[0]
        key_col = self.partitioner.key_column(tname)
        values: List[object] = []
        ok = [True]

        def eq_value(preds) -> Optional[object]:
            for p in preds:
                if not (isinstance(p, Cmp) and p.op == "=="):
                    continue
                for a, b in ((p.left, p.right), (p.right, p.left)):
                    if isinstance(a, Col) and a.name == key_col:
                        if isinstance(b, Lit):
                            return b.value
                        if isinstance(b, Param) and params \
                                and b.name in params:
                            return params[b.name]
            return None

        def conjuncts(pred) -> List:
            if isinstance(pred, BoolOp) and pred.op == "and":
                return conjuncts(pred.left) + conjuncts(pred.right)
            return [pred]

        def walk(node: Query, preds: List) -> None:
            if not ok[0]:
                return
            if isinstance(node, Scan):
                if node.table != tname:
                    return
                v = eq_value(preds)
                if v is None:
                    ok[0] = False
                else:
                    values.append(v)
                return
            if isinstance(node, Select):
                walk(node.child, preds + conjuncts(node.pred))
                return
            if isinstance(node, (Project, OrderBy)):
                walk(node.child, preds)
                return
            # Join / Aggregate / Limit: outer predicates don't push through
            for c in node.children():
                walk(c, [])

        walk(query, [])
        if not ok[0] or not values:
            return None
        shards = {self.partitioner.shard_of(tname, v) for v in values}
        if len(shards) != 1 or None in shards:
            return None
        return shards.pop()

    # -------------------------------------------------------- scatter path
    def _retain_gpos(self, node: Query) -> Query:
        """Rewrite the partitioned spine of a "part" subtree so every
        Project keeps the ``__gpos`` provenance column flowing upward."""
        if isinstance(node, Project):
            child = self._retain_gpos(node.child)
            cols = node.cols if GPOS in node.cols else node.cols + (GPOS,)
            return Project(cols, child, node.computed)
        if isinstance(node, Select):
            return Select(node.pred, self._retain_gpos(node.child))
        if isinstance(node, Join):
            # only the left (partitioned) side carries provenance
            return dataclasses.replace(node, left=self._retain_gpos(node.left))
        return node

    def _scatter_rows(self, node: Query, params
                      ) -> Tuple[Table, float, float]:
        """Execute a "part" subtree on every shard and ordered-merge the
        partials by ``__gpos`` — the exact unsharded row order."""
        rewritten = self._retain_gpos(node)
        parts, last = [], 0.0
        for k, s in enumerate(self.shards):
            r, _, l = s.run(rewritten, params)
            self.shard_queries[k] += 1
            parts.append(r)
            last = max(last, l)
        merged = parts[0]
        for p in parts[1:]:
            merged = merged.concat_rows(p)
        order = np.argsort(merged.host(GPOS), kind="stable") \
            if merged.nrows else np.asarray([], dtype=np.int64)
        merged = strip_gpos(merged.take(order))
        # shards work in parallel: the gather blocks on the slowest shard,
        # then pays one merge pass over the gathered rows
        t = last + merged.nrows / self.merge_rows_per_s
        return merged, t, t

    @staticmethod
    def _partial_aggs(node: Aggregate
                      ) -> Tuple[Tuple[AggSpec, ...], Tuple[AggSpec, ...]]:
        """(per-shard probe aggs, coordinator combine aggs). An avg fold
        has no associative partial of its own, so it ships as a (sum,
        count) partial-state pair — ``out__avs`` / ``out__avn`` — whose
        partials ADD; :meth:`_finalize_avg` performs the single final
        division. Its min/max partials (``out__avlo`` / ``out__avhi``)
        bound its running sums for :func:`_avg_states_exact`."""
        probe, combine = [], []
        for a in node.aggs:
            if a.func == "avg":
                probe.append(AggSpec("sum", a.col, a.out + "__avs"))
                probe.append(AggSpec("count", None, a.out + "__avn"))
                probe.append(AggSpec("min", a.col, a.out + "__avlo"))
                probe.append(AggSpec("max", a.col, a.out + "__avhi"))
                combine.append(AggSpec("sum", a.out + "__avs",
                                       a.out + "__avs"))
                combine.append(AggSpec("sum", a.out + "__avn",
                                       a.out + "__avn"))
                combine.append(AggSpec("min", a.out + "__avlo",
                                       a.out + "__avlo"))
                combine.append(AggSpec("max", a.out + "__avhi",
                                       a.out + "__avhi"))
            else:
                probe.append(a)
                combine.append(AggSpec(_COMBINE_FUNC[a.func], a.out, a.out))
        return tuple(probe), tuple(combine)

    def _finalize_avg(self, node: Aggregate, result: Table) -> Table:
        """Collapse each avg fold's combined (sum, count) state into the
        output column, reproducing the unsharded grouped-avg math —
        ``float32(s) / max(float32(c), 1)`` — with ONE division after all
        partials have been added: the same IEEE division, on the same
        device, as the unsharded ``Aggregate`` avg."""
        fields, cols = [], {}
        for g in node.group_by:
            fields.append(result.schema.field(g))
            cols[g] = result.column(g)
        for a in node.aggs:
            if a.func == "avg":
                s = result.column(a.out + "__avs").to(torch.float32)
                c = result.column(a.out + "__avn").to(torch.float32)
                fields.append(Field(a.out, "float32"))
                cols[a.out] = s / torch.clamp(c, min=1.0)
            else:
                fields.append(result.schema.field(a.out))
                cols[a.out] = result.column(a.out)
        return Table("agg", Schema(tuple(fields)), cols,
                     device=result.device)

    def _scatter_agg(self, node: Aggregate, params
                     ) -> Optional[Tuple[Table, float, float]]:
        """Partial-aggregate combine: run the probe Aggregate per shard,
        fold the partials (count/sum/avg-states add, min/max fold) — exact
        for the folds :meth:`_combinable` admits. None when an avg fold's
        rows or running sums reach 2**24 (:func:`_avg_states_exact`): the
        caller gathers the child instead."""
        avgs = [a.out for a in node.aggs if a.func == "avg"]
        probe_aggs, combine_aggs = self._partial_aggs(node)
        probe = Aggregate(node.group_by, probe_aggs, node.child) \
            if node.group_by else Aggregate(
                (), probe_aggs + (AggSpec("count", None, "__pn"),),
                node.child)
        parts, last = [], 0.0
        for k, s in enumerate(self.shards):
            r, _, l = s.run(probe, params)
            self.shard_queries[k] += 1
            parts.append(r)
            last = max(last, l)
        if node.group_by:
            merged = parts[0]
            for p in parts[1:]:
                merged = merged.concat_rows(p)
            combine = Aggregate(node.group_by, combine_aggs,
                                Scan("__partials"))
            result = combine.execute(_GatheredView(merged), None)
            if not all(_avg_states_exact(
                    result.host(o + "__avn"), result.host(o + "__avlo"),
                    result.host(o + "__avhi")) for o in avgs):
                return None
            if avgs:
                result = self._finalize_avg(node, result)
        else:
            live = [p for p in parts if int(p.host("__pn")[0])]
            if live and not all(_avg_states_exact(
                    sum(int(p.host(o + "__avn")[0]) for p in live),
                    min(int(p.host(o + "__avlo")[0]) for p in live),
                    max(int(p.host(o + "__avhi")[0]) for p in live))
                    for o in avgs):
                return None
            result = self._combine_global(node, parts)
        t = last + max(1, result.nrows) / self.merge_rows_per_s
        return result, t, t

    def _combine_global(self, node: Aggregate,
                        parts: Sequence[Table]) -> Table:
        """Fold ungrouped per-shard partials, mirroring
        ``Aggregate._global``'s field assembly exactly (dtypes included).
        Empty shards are excluded from min/max folds via the piggybacked
        ``__pn`` partial row count. Min/max/sum partials fold as 0-d tensors
        in the column's own type (an int32 sum wraps, as the unsharded
        int32 sum does)."""
        live = [p for p in parts if int(p.host("__pn")[0])]
        fields, cols = [], {}
        fold = {"sum": torch.add, "count": torch.add,
                "min": torch.minimum, "max": torch.maximum}
        for a in node.aggs:
            if a.func == "count":
                val = sum(int(p.host(a.out)[0]) for p in parts)
                dt = "int32"
            elif not live:
                val, dt = 0, "float32"   # the unsharded empty-input branch
            elif a.func == "avg":
                # (sum, count) partial state: integer partial sums and row
                # counts add exactly. The unsharded global avg rounds as
                # jnp.mean does, its division a reciprocal multiply, so the
                # single final fold must too — a true divide rounds
                # differently (499.5 vs 499.50003).
                s = sum(int(p.host(a.out + "__avs")[0]) for p in live)
                n = sum(int(p.host(a.out + "__avn")[0]) for p in live)
                val = np.float32(s) * (np.float32(1)
                                       / np.float32(max(n, 1)))
                dt = "float32"
            else:
                vals = [p.column(a.out)[0] for p in live]
                val = vals[0]
                for v in vals[1:]:
                    val = fold[a.func](val, v)
                dt = np_dtype_name(val)
                val = val.item()
            fields.append(Field(a.out, dt))
            cols[a.out] = np.asarray(
                [val], dtype=np.dtype(dt) if np.dtype(dt).itemsize < 8
                else np.dtype(dt.replace("64", "32")))
        return Table("agg", Schema(tuple(fields)), cols, device=self.device)

    def _scatter(self, query: Query, params, kind: str
                 ) -> Tuple[Table, float, float]:
        self.scattered_queries += 1
        if self.tracer.enabled:
            self.tracer.event("scatter-gather", sql=query.sql(), mode=kind,
                              shards=self.n_shards)
        if kind == "part":
            return self._scatter_rows(query, params)
        if kind == "agg":
            out = self._scatter_agg(query, params)
            if out is not None:
                return out
        # gather-child (or an avg past fp32's exact range): distribute the
        # child, apply the head node locally
        # through the unsharded node code over the gathered (exact-order)
        # child result
        gathered, _, t = self._scatter_rows(query.child, params)
        head = dataclasses.replace(query, child=Scan(gathered.name))
        result = head.execute(_GatheredView(gathered), params)
        m = self.model
        if isinstance(query, OrderBy):
            t += gathered.nrows / m.sort_rows_per_s
        elif isinstance(query, Aggregate):
            t += gathered.nrows / m.agg_rows_per_s
        return strip_gpos(result), t, t

    # ------------------------------------------------------------ telemetry
    def stats_dict(self) -> Dict[str, object]:
        return {
            "n_shards": self.n_shards,
            "pruned_queries": self.pruned_queries,
            "replicated_queries": self.replicated_queries,
            "scattered_queries": self.scattered_queries,
            "gathered_queries": self.gathered_queries,
            "shard_queries": list(self.shard_queries),
        }

    def describe(self) -> str:
        s = self.stats_dict()
        return (f"ShardedDatabase[{self.n_shards} shard(s)]: "
                f"{s['pruned_queries']} pruned, "
                f"{s['scattered_queries']} scattered, "
                f"{s['replicated_queries']} replicated, "
                f"{s['gathered_queries']} gathered "
                f"({self.partitioner.describe()})")
