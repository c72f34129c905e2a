"""Cobra's cost model (Sec. VI, Fig. 12).

    C_Q        = C_NRT + C_Q^F + max(N_Q · S_row(Q) / BW,  C_Q^L − C_Q^F)
    C_prefetch = C_Q / AF_Q
    C_seq      = Σ children
    C_cond     = p·C_true + (1−p)·C_false + C_p
    C_fold     = N_Q · C_f + C_Db(Q)
    C_loop     = K · C_body          (non-fold loops; K estimated)
    C_block    = Σ C_Z per statement
    other F-IR operators: C_Y each

All database-dependent terms (N_Q, S_row, C_Q^F, C_Q^L) come from
``DatabaseServer.estimate`` — statistics only, never true execution (the
paper consulted the DB optimizer the same way). ORM point lookups are
costed with the Hibernate id-cache modeled: first access per distinct key
is a round trip, the rest are local hits.

**Execution-context awareness.** The model is constructed from
``(db, catalog, context)`` — an :class:`~repro_torch.core.context.ExecutionContext`
describing the runtime the plan is compiled for:

  * ``batch_size`` B > 1 models :class:`~repro_torch.runtime.batch.BatchClientEnv`
    sharing across a batch: a query site whose bindings cannot differ
    between invocations (no ``Param`` anywhere in the tree) is fetched from
    the server once per batch, so its cost amortizes to C_Q / B per
    invocation (:meth:`CostModel.amortize`); ORM point lookups amortize the
    same way (the batch env's id-cache and bulk navigation fetch are
    shared).
  * **parameterized** sites amortize by the OBSERVED distinct-binding
    fraction d when the context's stats carry one for the site's table
    group (:meth:`CostModel.param_site_amortization`): the serving site
    cache serves repeated bindings locally, so only the d·B distinct
    bindings in a batch pay a server fetch — per-invocation cost
    C_Q · max(d, 1/B). Without an observation they stay un-amortized
    (conservative — their bindings may all differ).
  * observed iteration counts from ``context.stats`` replace the catalog
    defaults for while guards (``while_iters_default``) and cursor loops
    over collection sources (``loop_iters_default``) — the sites whose
    cardinality table statistics cannot estimate.

``CostModel`` is a pluggable protocol: ``OptimizerConfig.cost_model``
accepts any class with this constructor signature and method surface, and
the memo search costs plans through it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..relational.algebra import (Cmp, Col, Param, Query, Scalar, Scan,
                                  Select, scan_tables)
from ..relational.database import DatabaseServer, NetworkProfile
from .context import (ExecutionContext, ONE_SHOT, loop_site_key,
                      param_group_key, param_prov_key, while_site_key)
from .fir import (FCacheLookupAllE, FCacheLookupE, FCondE, FExpr, FFoldE,
                  FPointLookup, FQueryE, FSelLookupE, FTupleE, fir_children)

__all__ = ["CostCatalog", "CostModel", "query_has_params",
           "query_param_cols", "query_pred_cols"]


def _embedded_scalars(node):
    """Every Scalar hanging off one dataclass node — covers predicates,
    computed-projection pairs, and whatever scalar slots future operators
    add, without naming fields."""
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, Scalar):
            yield v
        elif isinstance(v, tuple):
            for item in v:
                if isinstance(item, Scalar):
                    yield item
                elif isinstance(item, tuple):
                    yield from (x for x in item if isinstance(x, Scalar))


def query_has_params(q: Query) -> bool:
    """True iff a relational tree contains a ``Param`` anywhere (predicates
    and computed projections included) — the sites whose bindings may differ
    between batched invocations, so they never amortize."""
    def scalar_has(s: Scalar) -> bool:
        if isinstance(s, Param):
            return True
        return any(scalar_has(k) for k in _embedded_scalars(s))

    if any(scalar_has(s) for s in _embedded_scalars(q)):
        return True
    return any(query_has_params(c) for c in q.children())


def query_param_cols(q: Query) -> Tuple[str, ...]:
    """Sorted names of the columns a relational tree compares against a
    ``Param`` — with the table set, the rewrite-stable identity of a
    parameterized site (:func:`~repro_torch.core.context.param_prov_key`):
    rewrites rename parameters, but a σ's predicate column survives as the
    rewritten form's lookup key column."""
    cols = set()

    def scalar_has_param(s: Scalar) -> bool:
        if isinstance(s, Param):
            return True
        return any(scalar_has_param(k) for k in _embedded_scalars(s))

    def from_scalar(s: Scalar) -> None:
        if isinstance(s, Cmp):
            for a, b in ((s.left, s.right), (s.right, s.left)):
                if isinstance(a, Col) and scalar_has_param(b):
                    cols.add(a.name)
        for k in _embedded_scalars(s):
            from_scalar(k)

    def walk(node: Query) -> None:
        for s in _embedded_scalars(node):
            from_scalar(s)
        for c in node.children():
            walk(c)

    walk(q)
    return tuple(sorted(cols))


def query_pred_cols(q: Query) -> Tuple[str, ...]:
    """Sorted names of every column a relational tree COMPARES (either side
    of any ``Cmp``, against params, literals or other columns) — the
    columns whose histograms a targeted re-analyze rebuilds when the
    site's cardinality estimate drifts (the feedback controller's q-error
    path)."""
    cols = set()

    def from_scalar(s: Scalar) -> None:
        if isinstance(s, Cmp):
            for side in (s.left, s.right):
                if isinstance(side, Col):
                    cols.add(side.name)
        for k in _embedded_scalars(s):
            from_scalar(k)

    def walk(node: Query) -> None:
        for s in _embedded_scalars(node):
            from_scalar(s)
        for c in node.children():
            walk(c)

    walk(q)
    return tuple(sorted(cols))


@dataclasses.dataclass
class CostCatalog:
    """The tunable cost-catalog file of Sec. VIII."""

    network: NetworkProfile
    c_z: float = 30e-9          # per imperative statement (paper: 30 ns)
    c_y: float = 30e-9          # per F-IR operator evaluation
    af: float = 1.0             # amortization factor AF_Q
    loop_iters_default: float = 1000.0
    cond_prob_default: float = 0.5
    while_iters_default: float = 8.0  # K for guarded (while) loops


class CostModel:
    def __init__(self, db: DatabaseServer, catalog: CostCatalog,
                 context: Optional[ExecutionContext] = None):
        self.db = db
        self.cat = catalog
        self.context = context if context is not None else ONE_SHOT
        # the program's write set, assigned by run_search before costing:
        # sites over written tables are never served from a shared cache,
        # so no batch/diversity amortization may be claimed for them
        self.write_tables: frozenset = frozenset()

    # ------------------------------------------------------------ batching
    @property
    def batch_size(self) -> float:
        return float(max(1, self.context.batch_size))

    def amortize(self, cost: float) -> float:
        """Per-invocation share of a cost paid once per batch."""
        return cost / self.batch_size

    def tables_shareable(self, tables) -> bool:
        """False when ``tables`` intersects the program's write set: the
        runtime refetches such sites every invocation (each must observe
        earlier writes), so no cache amortization may be priced in."""
        return not (self.write_tables and self.write_tables & set(tables))

    def source_amortizable(self, source: FExpr) -> bool:
        """Can this fold source's server fetch be shared across a batch?
        Only binding-free query sites over tables the program never
        writes: identical every invocation, so the batch env's site cache
        serves all but the first from local state."""
        return (isinstance(source, FQueryE)
                and not query_has_params(source.query)
                and self.tables_shareable(scan_tables(source.query)))

    def param_site_amortization(self, q: Query) -> float:
        """Per-invocation fraction of a PARAMETERIZED query site's fetch
        cost under batching. When the context's stats carry an observed
        distinct-binding fraction d for the site's table group (published
        by the serving site cache through the feedback controller), only
        the distinct bindings in a batch pay a server fetch — the repeats
        are local cache hits — so the per-invocation share is
        ``max(d, 1/B)``. With no group-level observation, the site's
        PROVENANCE key (``qprov:`` — table set + the columns the site
        compares against parameters, an identity that survives rewrites
        renaming the parameters themselves) is consulted instead, so a
        context built with per-site fractions prices two
        differently-diverse sites over the same table separately. Without
        either observation: 1.0 (no sharing assumed, today's conservative
        behavior). Sites over tables the program WRITES never amortize —
        the runtime refetches such sites every invocation regardless of
        what diversity another (read-only) program published for the same
        table group."""
        if self.batch_size <= 1:
            return 1.0
        tables = scan_tables(q)
        if self.write_tables and self.write_tables & set(tables):
            return 1.0
        d = self.context.stats.binding_for(param_group_key(tables))
        if d is None:
            d = self.context.stats.binding_for(
                param_prov_key(tables, query_param_cols(q)))
        if d is None:
            return 1.0
        return min(1.0, max(float(d), 1.0 / self.batch_size))

    def fold_source_amortization(self, source: FExpr) -> float:
        """Binding-diversity amortization factor for a NON-binding-free fold
        source (binding-free sources take the full 1/B path via
        :meth:`source_amortizable`). Covers parameterized query sources and
        the per-key σ lookups T5-style rewrites emit."""
        if isinstance(source, FQueryE):
            return self.param_site_amortization(source.query)
        if isinstance(source, FSelLookupE):
            q = Select(Cmp("==", Col(source.key_col), Param("k")),
                       Scan(source.table))
            return self.param_site_amortization(q)
        return 1.0

    # ----------------------------------------------------- iteration counts
    def while_iters(self, pred) -> float:
        """K for a guarded loop: the observed count for this while site when
        the context carries one, else the catalog default."""
        observed = self.context.stats.iters_for(while_site_key(pred))
        return observed if observed is not None else self.cat.while_iters_default

    # ------------------------------------------------------------- queries
    def query_cost(self, q: Query) -> float:
        est = self.db.estimate(q)
        transfer = est.result_bytes / self.cat.network.bandwidth_bytes_per_s
        return (self.cat.network.c_nrt + est.first_row_s
                + max(transfer, est.last_row_s - est.first_row_s))

    def query_rows(self, q: Query) -> float:
        return self.db.estimate(q).n_rows

    def prefetch_cost(self, q: Query) -> float:
        return self.query_cost(q) / max(self.cat.af, 1e-9)

    def point_query_cost(self, table: str) -> float:
        """One indexed point lookup round trip."""
        m = self.db.model
        st = self.db.stats(table)
        transfer = st.row_bytes / self.cat.network.bandwidth_bytes_per_s
        server = m.startup_s + m.index_lookup_s
        return self.cat.network.c_nrt + server + transfer

    def ndv(self, table: str, col: str) -> float:
        return float(self.db.stats(table).ndv(col))

    def rows_per_key(self, table: str, col: str) -> float:
        """Expected rows served per key of a per-key cache lookup over
        ``table.col``. Histogram-grade when the table's stats carry one:
        the key is bound from the data's own distribution, so the expected
        group size is Σ f_v·(f_v/N) = ``param_eq_fraction() × N`` — far
        above N/NDV under skew, and degenerating to it when uniform.
        Without a histogram: the scalar N/NDV rule."""
        st = self.db.stats(table)
        hist = st.hist(col)
        if hist is not None:
            return hist.param_eq_fraction() * st.nrows
        return st.nrows / max(self.ndv(table, col), 1.0)

    # ---------------------------------------------------------------- fold
    def fold_source(self, fold: FFoldE) -> Tuple[float, float]:
        """(C_Db(Q), N_Q) for the fold's source."""
        src = fold.source
        if isinstance(src, FQueryE):
            return self.query_cost(src.query), self.query_rows(src.query)
        if isinstance(src, FSelLookupE):
            q = Select(Cmp("==", Col(src.key_col), Param("k")), Scan(src.table))
            return self.query_cost(q), self.db.estimate(q).n_rows
        if isinstance(src, FCacheLookupAllE):
            return self.cat.c_y, self.rows_per_key(src.table, src.key_col)
        raise TypeError(f"fold source {src!r}")

    def slot_row_cost(self, expr: FExpr, n_rows: float) -> float:
        """Per-row cost C_f of one tuple slot's update expression.

        Dependent aggregations were inlined at construction, so each slot is
        self-contained."""
        c = self.cat
        if isinstance(expr, FCondE):
            # ?(pred, g): pred evaluated every row; g on p fraction
            p = c.cond_prob_default
            return (self._ops_cost(expr.pred, n_rows)
                    + p * self.slot_row_cost(expr.then, n_rows) + c.c_y)
        return self._ops_cost(expr, n_rows)

    def _ops_cost(self, e: FExpr, n_rows: float) -> float:
        c = self.cat
        if isinstance(e, FPointLookup):
            # ORM id-cache: distinct keys pay a round trip once; rest are
            # hits. In a batch the id-cache (and the bulk navigation fetch)
            # is shared across invocations, so the round trips amortize.
            ndv = min(n_rows, self.ndv(e.table, e.key_col))
            per_row = (ndv * self.amortize(self.point_query_cost(e.table))
                       + (n_rows - ndv) * c.c_z) / max(n_rows, 1.0)
            return per_row + self._ops_cost(e.keyexpr, n_rows)
        if isinstance(e, FCacheLookupE):
            return c.c_y + self._ops_cost(e.keyexpr, n_rows)
        if isinstance(e, FFoldE):
            # nested fold: per-OUTER-row cost of running the inner loop
            src = e.source
            if isinstance(src, FQueryE):
                inner_q_cost = self.query_cost_correlated(src.query)
                inner_rows = self.query_rows_correlated(src.query)
            elif isinstance(src, FSelLookupE):
                q = Select(Cmp("==", Col(src.key_col), Param("k")), Scan(src.table))
                inner_q_cost = self.query_cost(q)
                inner_rows = self.db.estimate(q).n_rows
            elif isinstance(src, FCacheLookupAllE):
                inner_q_cost = c.c_y
                inner_rows = self.rows_per_key(src.table, src.key_col)
            else:
                inner_q_cost = c.c_y
                inner_rows = self.cat.loop_iters_default
            assert isinstance(e.func, FTupleE)
            per_inner = sum(self.slot_row_cost(i, inner_rows) for i in e.func.items)
            return inner_q_cost + inner_rows * (per_inner + c.c_z)
        if isinstance(e, FQueryE):
            return self.query_cost(e.query)
        base = c.c_y
        for k in fir_children(e):
            base += self._ops_cost(k, n_rows)
        return base

    # correlated query (σ with Param): selectivity from stats
    def query_cost_correlated(self, q: Query) -> float:
        return self.query_cost(q)

    def query_rows_correlated(self, q: Query) -> float:
        return self.db.estimate(q).n_rows

    # --------------------------------------------------------- region costs
    def block_cost(self, stmt) -> float:
        """Imperative statement cost: C_Z + any embedded query costs."""
        from .regions import (CacheByColumn, ILoadAll, INav, IQuery, Prefetch,
                              UpdateRow)
        c = self.cat.c_z
        if isinstance(stmt, Prefetch):
            return self.prefetch_cost(stmt.query)
        if isinstance(stmt, CacheByColumn):
            return c  # hash-index build charged per-row at runtime; est. small
        if isinstance(stmt, UpdateRow):
            return self.cat.network.c_nrt + self.db.model.index_lookup_s
        expr = getattr(stmt, "expr", None)
        if expr is not None:
            c += self._iexpr_cost(expr)
        for attr in ("keyexpr", "valexpr"):
            e2 = getattr(stmt, attr, None)
            if e2 is not None:
                c += self._iexpr_cost(e2)
        return c

    def _iexpr_cost(self, e) -> float:
        from .regions import ICacheLookup, ILoadAll, INav, IQuery
        if isinstance(e, IQuery):
            return self.query_cost(e.query)
        if isinstance(e, ILoadAll):
            return self.query_cost(Scan(e.table))
        if isinstance(e, INav):
            return self.point_query_cost(e.target)
        if isinstance(e, ICacheLookup):
            return self.cat.c_y
        out = 0.0
        for attr in ("left", "right", "base", "keyexpr"):
            k = getattr(e, attr, None)
            if k is not None and hasattr(k, "key"):
                out += self._iexpr_cost(k) if not isinstance(k, str) else 0.0
        for k in getattr(e, "args", ()):
            out += self._iexpr_cost(k)
        return out

    def loop_iters(self, source, var: Optional[str] = None) -> float:
        """K for non-fold loops. Query sources are estimated from table
        statistics; collection sources (worklists, accumulated lists) have
        no statistics, so the context's observed count for this loop site —
        when the feedback loop published one — replaces the catalog
        default."""
        from .regions import ILoadAll, IQuery
        if isinstance(source, IQuery):
            return self.query_rows(source.query)
        if isinstance(source, ILoadAll):
            return float(self.db.stats(source.table).nrows)
        if var is not None:
            observed = self.context.stats.iters_for(loop_site_key(var, source))
            if observed is not None:
                return observed
        return self.cat.loop_iters_default

    def loop_source_cost(self, source) -> float:
        """Cost of evaluating a cursor loop's source once per invocation —
        amortized for binding-free query sources (fetched once per batch),
        and by the observed distinct-binding fraction for parameterized
        query sources whose bindings repeat across the batch."""
        from .regions import ILoadAll, IQuery
        full = self._iexpr_cost(source)
        if isinstance(source, ILoadAll):
            return self.amortize(full) \
                if self.tables_shareable((source.table,)) else full
        if isinstance(source, IQuery):
            if not source.bindings and not query_has_params(source.query) \
                    and self.tables_shareable(scan_tables(source.query)):
                return self.amortize(full)
            return full * self.param_site_amortization(source.query)
        return full
