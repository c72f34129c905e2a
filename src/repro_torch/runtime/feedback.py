"""Feedback-driven re-optimization: close the loop from observed runtimes
back into the cost model.

Cobra's premise is that the best rewrite depends on runtime parameters —
and those drift. A plan compiled when ``orders`` had 100 rows keeps being
served long after a bulk load grew it to 4000, because the optimizer only
ever consults table *statistics*, not the data. The controller watches the
serving path's true executions (``DatabaseServer.run()`` cardinalities and
wall-clock, logged by :class:`~repro_torch.runtime.batch.BatchClientEnv`),
compares each against ``DatabaseServer.estimate()`` — the same numbers the
cost model consumed at compile time — and, when the ratio exceeds a
configurable threshold, re-analyzes exactly the drifted tables. Per-table
stats versions then invalidate exactly the plans that touch those tables;
everything else stays hot. The serving runtime recompiles the affected
executables, and the memo search may pick a different winner (e.g. P1 join
→ P2 prefetch) under the fresh statistics.

Two drift signals per query site:

  * **cardinality** (``kind="rows"``) — observed vs estimated row count;
  * **wall-clock** (``kind="wall_clock"``) — observed execution time vs the
    cost the planner would charge this query NOW (``CostModel.query_cost``).
    This catches shifts that leave row counts stable — wider payloads,
    selectivity moving between columns, server-side regressions — which the
    row signal is blind to. Wall-clock is noisier, so its threshold
    (``cost_drift_threshold``) defaults looser, and it only fires where the
    row signal did not (no double-counted events per site).

Besides the drift signals, the controller **records observed iteration
counts** per while-loop / collection-loop site (the counts the cost model
only ever estimated with ``while_iters_default`` / ``loop_iters_default``)
and **observed binding-diversity fractions** per parameterized-site group
(the serving site cache's measurement of how often bindings repeat across
a batch — the amortization the cost model's 0/1 binding-free rule cannot
see), and **publishes** both as a
:class:`~repro_torch.core.context.StatsProfile` — the stats half of an
:class:`~repro_torch.core.context.ExecutionContext`. A site's published value
only moves when the running mean drifts past ``iters_publish_threshold``
(ratio) / ``binding_publish_delta`` (absolute, fractions live in [0, 1]),
so context fingerprints — and hence plan-cache keys — stay stable under
observation noise, and a publish is precisely the event that triggers a
context-driven recompile in :class:`~repro_torch.runtime.serving.ServingRuntime`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..api.cache import query_tables
from ..core.context import StatsProfile
from ..obs.metrics import MetricsRegistry, registry_counter
from ..stats.qerror import QErrorTracker

__all__ = ["DriftEvent", "FeedbackController"]


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """One query site whose observed behaviour left the trusted band."""

    sql: str
    tables: Tuple[str, ...]
    est_rows: float
    observed_rows: float
    ratio: float
    kind: str = "rows"          # "rows" | "wall_clock"
    est_s: float = 0.0          # wall_clock events: modeled query cost
    observed_s: float = 0.0     # wall_clock events: observed execution time

    def describe(self) -> str:
        if self.kind == "wall_clock":
            return (f"{self.sql!r}: est {self.est_s:.4g}s, observed "
                    f"{self.observed_s:.4g}s ({self.ratio:.1f}x wall-clock "
                    f"drift) -> tables {list(self.tables)}")
        return (f"{self.sql!r}: est {self.est_rows:.0f} rows, observed "
                f"{self.observed_rows:.0f} ({self.ratio:.1f}x drift) "
                f"-> tables {list(self.tables)}")


class FeedbackController:
    """Observes served executions; decides when statistics must be refreshed."""

    # registry-backed telemetry counters (see repro_torch.obs.metrics): legacy
    # `controller.refreshes` reads/writes stay valid as views
    refreshes = registry_counter()
    observed_queries = registry_counter()
    observed_wall_s = registry_counter()
    iters_publishes = registry_counter()
    binding_publishes = registry_counter()
    swap_checks = registry_counter()
    swaps_accepted = registry_counter()
    swaps_rejected = registry_counter()
    analyzes_fired = registry_counter()
    analyzes_deduped = registry_counter()

    def __init__(self, session, drift_threshold: float = 3.0,
                 cost_drift_threshold: Optional[float] = 10.0,
                 iters_publish_threshold: float = 1.5,
                 binding_publish_delta: float = 0.15):
        if drift_threshold <= 1.0:
            raise ValueError("drift_threshold must be > 1 (a ratio)")
        if cost_drift_threshold is not None and cost_drift_threshold <= 1.0:
            raise ValueError("cost_drift_threshold must be > 1 (a ratio) "
                             "or None to disable wall-clock drift")
        if iters_publish_threshold <= 1.0:
            raise ValueError("iters_publish_threshold must be > 1 (a ratio)")
        if not 0.0 < binding_publish_delta < 1.0:
            raise ValueError("binding_publish_delta must be in (0, 1) "
                             "(an absolute delta on a fraction)")
        self.session = session
        # must exist before the registry_counter descriptors are written
        self.metrics = MetricsRegistry()
        self.drift_threshold = drift_threshold
        self.cost_drift_threshold = cost_drift_threshold
        self.iters_publish_threshold = iters_publish_threshold
        self.binding_publish_delta = binding_publish_delta
        self.events: List[DriftEvent] = []
        self.refreshes = 0
        self.observed_queries = 0
        self.observed_wall_s = 0.0
        # per-site aggregates: sql -> [count, total rows, total wall-clock]
        self._sites: Dict[str, List[float]] = {}
        # per-iteration-site aggregates: site_key -> [count, total iters]
        self._iter_sites: Dict[str, List[float]] = {}
        # published (hysteresis-stable) iteration counts per site — the
        # values a StatsProfile fingerprint is built from
        self._published_iters: Dict[str, float] = {}
        self.iters_publishes = 0
        # per-parameterized-group aggregates: group -> [n batches, Σ fraction]
        self._binding_sites: Dict[str, List[float]] = {}
        self._published_bindings: Dict[str, float] = {}
        self.binding_publishes = 0
        # anti-regression plan-swap guard (validate_swap)
        self.swap_checks = 0
        self.swaps_accepted = 0
        self.swaps_rejected = 0
        self.swap_log: List[Dict[str, object]] = []
        # per-site q-error accounting (the rows-drift ratio IS the q-error)
        self.qerrors = QErrorTracker()
        # table -> predicate columns of the sites whose q-error tripped,
        # consumed by refresh() as the targeted re-analyze column set
        self._pending_columns: Dict[str, set] = {}
        # single-fire guard: table -> data version it was last analyzed at.
        # The drift and q-error triggers may both request the same table in
        # one batch; analyze() must run once per (table, data epoch).
        self._analyzed_data_versions: Dict[str, int] = {}
        self.analyzes_fired = 0
        self.analyzes_deduped = 0

    # ------------------------------------------------------------- observing
    def _estimated_cost_s(self, q) -> float:
        """What the cost model would charge this query under CURRENT stats —
        the planner's promise the observed wall-clock is held against."""
        from ..core.cost import CostModel
        return CostModel(self.session.db, self.session.catalog).query_cost(q)

    def observe(self, observations: Sequence[Tuple[object, int, float]]
                ) -> List[str]:
        """Compare observed (query, rows, wall_s) against current estimates;
        return the sorted list of tables whose estimates have drifted."""
        db = self.session.db
        drifted = set()
        for q, n_rows, wall_s in observations:
            self.observed_queries += 1
            self.observed_wall_s += wall_s or 0.0
            sql = q.sql()
            agg = self._sites.setdefault(sql, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += n_rows
            agg[2] += wall_s or 0.0
            est = db.estimate(q).n_rows
            # the per-site q-error: max((obs+1)/(est+1), (est+1)/(obs+1)).
            # +1 smoothing keeps empty results from dividing by zero while
            # still flagging est≈0 vs observed≫0
            ratio = self.qerrors.observe(sql, est, n_rows,
                                         tables=query_tables(q))
            if ratio > self.drift_threshold:
                tables = query_tables(q)
                drifted.update(tables)
                # targeted re-analyze: the site's estimate went bad, so
                # refresh() rebuilds histograms for exactly the columns its
                # predicates compare (scalars always recompute)
                from ..core.cost import query_pred_cols
                cols = query_pred_cols(q)
                if cols:
                    for t in tables:
                        self._pending_columns.setdefault(t, set()).update(cols)
                self.events.append(DriftEvent(
                    sql=sql, tables=tables, est_rows=est,
                    observed_rows=float(n_rows), ratio=float(ratio)))
                continue  # the row signal already flagged this site
            if self.cost_drift_threshold is None or not wall_s:
                continue
            est_s = self._estimated_cost_s(q)
            if est_s <= 0:
                continue
            cratio = max(wall_s / est_s, est_s / wall_s)
            if cratio > self.cost_drift_threshold:
                tables = query_tables(q)
                drifted.update(tables)
                self.events.append(DriftEvent(
                    sql=sql, tables=tables, est_rows=est,
                    observed_rows=float(n_rows), ratio=float(cratio),
                    kind="wall_clock", est_s=float(est_s),
                    observed_s=float(wall_s)))
        return sorted(drifted)

    def observe_iterations(self, observations: Sequence[Tuple[str, int]]
                           ) -> bool:
        """Fold (site_key, iteration_count) observations — the interpreter's
        per-while/per-collection-loop records — into the per-site running
        means, and re-publish any site whose mean left the hysteresis band
        around its published value. Returns True when at least one site's
        published value moved (the caller's recompile trigger)."""
        changed = False
        for site, count in observations:
            agg = self._iter_sites.setdefault(site, [0, 0.0])
            agg[0] += 1
            agg[1] += count
            mean = agg[1] / agg[0]
            published = self._published_iters.get(site)
            if published is None:
                self._published_iters[site] = mean
                self.iters_publishes += 1
                changed = True
                continue
            ratio = max((mean + 1.0) / (published + 1.0),
                        (published + 1.0) / (mean + 1.0))
            if ratio > self.iters_publish_threshold:
                self._published_iters[site] = mean
                self.iters_publishes += 1
                changed = True
        return changed

    def observe_bindings(self, observations: Sequence[Tuple[str, int, int]]
                         ) -> bool:
        """Fold per-batch (group_site, total_lookups, distinct_bindings)
        observations — the site cache's binding-diversity measurements —
        into per-group running means of the distinct fraction, and
        re-publish any group whose mean left the hysteresis band
        (``binding_publish_delta``, absolute) around its published value.
        Returns True when at least one published fraction moved (the
        caller's recompile trigger)."""
        changed = False
        for site, total, distinct in observations:
            if total <= 0:
                continue
            frac = min(1.0, distinct / total)
            agg = self._binding_sites.setdefault(site, [0, 0.0])
            agg[0] += 1
            agg[1] += frac
            mean = agg[1] / agg[0]
            published = self._published_bindings.get(site)
            if published is None or \
                    abs(mean - published) > self.binding_publish_delta:
                self._published_bindings[site] = mean
                self.binding_publishes += 1
                changed = True
        return changed

    def stats_profile(self) -> StatsProfile:
        """The published iteration counts and binding-diversity fractions
        (plus per-query-site mean wall-clock) as the StatsProfile an
        ExecutionContext carries into the cost model. Published — not raw —
        values keep context fingerprints, and with them plan-cache keys,
        stable between publish events."""
        wall = {sql: agg[2] / max(agg[0], 1)
                for sql, agg in self._sites.items() if agg[2]}
        return StatsProfile.of(iters=dict(self._published_iters),
                               site_wall_s=wall,
                               bindings=dict(self._published_bindings),
                               qerrors=self.qerrors.latest())

    # ----------------------------------------------------- plan-swap guarding
    def _replay_cost_s(self, program, bindings) -> float:
        """Simulated cost of ``program`` over ``bindings`` replayed BATCHED
        (one shared env, like the serving path runs it): a serving-context
        plan's win comes from cross-invocation amortization — prefetch and
        site-cache reuse pay off across a batch, not per invocation — so a
        one-shot replay would systematically mis-rank it."""
        from ..core.regions import Interpreter
        from .batch import BatchClientEnv
        env = BatchClientEnv(self.session.db, self.session.catalog.network,
                             c_z=self.session.catalog.c_z)
        interp = Interpreter(env, "fast")
        for p in bindings:
            interp.run(program, dict(p) or None)
        return env.clock

    def validate_swap(self, old_exe, new_exe, bindings) -> bool:
        """Anti-regression guard: before a drift-triggered recompile replaces
        a running plan, replay the last observed bindings against the old
        and the new plan and keep the OLD one unless the new is actually at
        least as cheap on the workload just served. Cost estimates triggered
        the recompile; real executions decide the swap.

        Accepts without replay when there is nothing to replay against, or
        when either program mutates tables (replaying writes against the
        live database would corrupt it). Returns True to swap."""
        from .batch import program_has_updates
        self.swap_checks += 1
        bindings = list(bindings)
        old_s = new_s = None
        if not bindings or program_has_updates(old_exe.program) \
                or program_has_updates(new_exe.program):
            accept = True
        else:
            old_s = self._replay_cost_s(old_exe.program, bindings)
            new_s = self._replay_cost_s(new_exe.program, bindings)
            # epsilon-tolerant: a bit-identical replan must never be
            # rejected over float noise
            accept = new_s <= old_s * (1.0 + 1e-6)
        if accept:
            self.swaps_accepted += 1
            self.session.plan_swaps_accepted = getattr(
                self.session, "plan_swaps_accepted", 0) + 1
        else:
            self.swaps_rejected += 1
            self.session.plan_swaps_rejected = getattr(
                self.session, "plan_swaps_rejected", 0) + 1
        outcome = {
            "program": getattr(old_exe.source, "name", "?"),
            "accepted": accept,
            "replayed": len(bindings) if old_s is not None else 0,
            "old_replay_s": old_s,
            "new_replay_s": new_s,
        }
        self.swap_log.append(outcome)
        # the judged executable carries its own verdict (PlanReport's
        # swap_checked/swap_accepted/swap_replayed fields read it)
        try:
            new_exe.swap_outcome = {"checked": True, **outcome}
        except AttributeError:
            pass  # stub executables in tests need not carry the field
        tracer = getattr(self.session, "tracer", None)
        if tracer is not None and tracer.enabled:
            tracer.event("swap-verdict", program=outcome["program"],
                         accepted=accept, replayed=outcome["replayed"])
        return accept

    # -------------------------------------------------------------- reacting
    def refresh(self, tables: Sequence[str]) -> None:
        """Re-analyze the drifted tables only: their stats versions bump, so
        exactly the plans touching them fall out of the caches.

        Targeted and deduplicated: a table whose drift came through the
        q-error path re-analyzes only the pending predicate columns'
        histograms (scalars always recompute), and a table already analyzed
        at its current DATA version is skipped entirely — the drift and
        q-error triggers may both name one table in a batch, but analyze()
        single-fires per (table, data epoch) (``analyzes_deduped`` counts
        the suppressions)."""
        if not tables:
            return
        db = self.session.db
        fired = False
        for t in tables:
            ver = db.data_version(t)
            if self._analyzed_data_versions.get(t) == ver:
                self.analyzes_deduped += 1
                continue
            cols = self._pending_columns.pop(t, None)
            db.analyze(t, columns=tuple(sorted(cols)) if cols else None)
            self._analyzed_data_versions[t] = ver
            self.analyzes_fired += 1
            fired = True
        if fired:
            self.refreshes += 1

    # ------------------------------------------------------------- telemetry
    def telemetry(self) -> Dict[str, object]:
        return {
            "observed_queries": self.observed_queries,
            "observed_wall_s": self.observed_wall_s,
            "drift_events": len(self.events),
            "drift_events_wall_clock": sum(
                1 for e in self.events if e.kind == "wall_clock"),
            "stats_refreshes": self.refreshes,
            "analyzes_fired": self.analyzes_fired,
            "analyzes_deduped": self.analyzes_deduped,
            "qerror_sites": {sql: {"n": s.n, "mean": s.mean,
                                   "worst": s.worst, "last": s.last}
                             for sql, s in self.qerrors.sites().items()},
            "iteration_sites": {site: {"n": int(n), "avg_iters": tot / max(n, 1),
                                       "published": self._published_iters.get(site)}
                                for site, (n, tot) in self._iter_sites.items()},
            "iters_publishes": self.iters_publishes,
            "binding_sites": {site: {"n": int(n), "avg_fraction": tot / max(n, 1),
                                     "published": self._published_bindings.get(site)}
                              for site, (n, tot) in self._binding_sites.items()},
            "binding_publishes": self.binding_publishes,
            "swap_checks": self.swap_checks,
            "swaps_accepted": self.swaps_accepted,
            "swaps_rejected": self.swaps_rejected,
            "swaps": list(self.swap_log),
            "sites": {sql: {"n": int(n), "avg_rows": rows / max(n, 1),
                            "wall_s": wall}
                      for sql, (n, rows, wall) in self._sites.items()},
        }
