"""Execution context: *where* a plan will run, as optimizer input.

Cobra's cost model (Sec. VI) prices a program as if it executes once, on a
cold client. The serving runtime invalidates both assumptions: ``run_batch``
shares one client environment across a whole batch (a parameterless query
site is fetched from the server once per batch — the paper's batching
transformation applied at the serving layer), and the feedback loop observes
true while-loop iteration counts where the catalog only has a default. The
:class:`ExecutionContext` packages exactly those runtime parameters —

  * ``batch_size``   — how many invocations share one client environment;
  * ``hw``           — an optional hardware-profile override (the step-program
    planner's HW table; program plans ignore it but key on it);
  * ``stats``        — a :class:`StatsProfile` of observed per-site iteration
    counts and wall-clock feedback published by the
    :class:`~repro_torch.runtime.feedback.FeedbackController`

— and threads them from ``CobraSession.compile()`` / ``ServingRuntime``
into :class:`~repro_torch.core.cost.CostModel`, so the memo search can pick a
*different* winning alternative for one-shot vs high-traffic execution of
the same program. Context identity (:meth:`ExecutionContext.fingerprint`)
is part of every plan-cache/plan-store key, restricted to the iteration
sites a program actually contains so an unrelated site's observation leaves
other programs' plans hot (mirroring per-table stats versions).

Iteration **sites** are stable content keys: :func:`while_site_key` hashes a
while guard's expression key, :func:`loop_site_key` a cursor loop's
(var, source) pair — the same key the interpreter records observations
under and the cost model looks estimates up by.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Mapping, Optional, Sequence, Tuple

__all__ = ["ExecutionContext", "StatsProfile", "ONE_SHOT",
           "while_site_key", "loop_site_key", "query_site_key",
           "param_group_key", "param_prov_key"]


def _site_hash(key: Tuple) -> str:
    return hashlib.sha256(repr(key).encode()).hexdigest()[:12]


def while_site_key(pred) -> str:
    """Stable site id of a guarded (while) loop, from its guard expression."""
    return "while:" + _site_hash(pred.key())


def loop_site_key(var: str, source) -> str:
    """Stable site id of a cursor loop over a non-query (collection) source —
    the loops whose iteration count table statistics cannot estimate."""
    return "loop:" + _site_hash((var, source.key()))


def query_site_key(query) -> str:
    """Stable site id of one exact query tree — the key the serving-level
    :class:`~repro_torch.runtime.sitecache.SiteCache` tracks per-site binding
    diversity under (telemetry granularity)."""
    return "qsite:" + _site_hash(query.key())


def param_group_key(tables) -> str:
    """Stable id of a PARAMETERIZED-site group: all parameterized query
    sites over one base-table set. Binding-diversity statistics publish at
    this granularity because rewrites change the exact query tree (T5 turns
    a σ into an aggregate over it) while the table set survives every
    rewrite — so a diversity observed under the running plan prices the
    *other* alternatives of the same site too."""
    return "qdiv:" + _site_hash(tuple(sorted(tables)))


def param_prov_key(tables, param_cols) -> str:
    """Stable PROVENANCE id of a parameterized query site: the site's
    base-table set *plus the columns its parameters are compared
    against*. Finer than :func:`param_group_key` — two differently-diverse
    sites over one table filter different columns (W_E's
    ``t_role_id = :rid`` vs SCAN's ``t_state = :k``), so their diversity
    observations publish (and price) separately — yet still coarse enough
    to survive every rewrite: T2/T5-style transformations rebuild the
    query tree (even renaming the parameter to a synthetic ``:k``) but
    preserve the tables scanned and the predicate column, which becomes
    the rewritten form's lookup key column. The cost model consults the
    provenance key first and falls back to the table-group key."""
    return "qprov:" + _site_hash((tuple(sorted(tables)),
                                  tuple(sorted(param_cols))))


@dataclasses.dataclass(frozen=True)
class StatsProfile:
    """Observed runtime statistics, published by the feedback controller.

    ``iters`` maps iteration sites (``while:…`` / ``loop:…`` keys) to the
    observed iteration count the cost model should use instead of the
    catalog default (``while_iters_default`` / ``loop_iters_default``).
    ``bindings`` maps parameterized-site groups (``qdiv:…`` keys, see
    :func:`param_group_key`) to the observed distinct-binding fraction in
    [0, 1] — the serving site cache's measurement of how often a
    parameterized site's bindings actually repeat across a batch, which
    the cost model uses to amortize parameterized fetches instead of the
    0/1 binding-free rule. ``site_wall_s`` maps query sites (by SQL text)
    to observed mean wall-clock seconds — the default
    :class:`~repro_torch.core.cost.CostModel` does not consume it (wall-clock
    drift feeds the stats-version invalidation path instead), but custom
    cost models may calibrate against it. ``qerrors`` maps query sites
    (by SQL text) to their latest observed q-error — max(est/act, act/est)
    of the site's cardinality estimate, tracked by the feedback
    controller's :class:`~repro_torch.stats.qerror.QErrorTracker`; it is the
    signal behind targeted re-analyzes and the per-site column
    ``explain()``/``triage()`` surface. ``iters`` and ``bindings``
    participate in plan identity; ``site_wall_s`` and ``qerrors`` do not
    (q-error moves with every observation — keying plans on it would
    thrash the caches re-analyze exists to protect).
    """

    iters: Tuple[Tuple[str, float], ...] = ()
    site_wall_s: Tuple[Tuple[str, float], ...] = ()
    bindings: Tuple[Tuple[str, float], ...] = ()
    qerrors: Tuple[Tuple[str, float], ...] = ()

    @classmethod
    def of(cls, iters: Optional[Mapping[str, float]] = None,
           site_wall_s: Optional[Mapping[str, float]] = None,
           bindings: Optional[Mapping[str, float]] = None,
           qerrors: Optional[Mapping[str, float]] = None) -> "StatsProfile":
        return cls(
            iters=tuple(sorted((k, float(v)) for k, v in (iters or {}).items())),
            site_wall_s=tuple(sorted((k, float(v))
                              for k, v in (site_wall_s or {}).items())),
            bindings=tuple(sorted((k, float(v))
                           for k, v in (bindings or {}).items())),
            qerrors=tuple(sorted((k, float(v))
                          for k, v in (qerrors or {}).items())))

    def iters_for(self, site: str) -> Optional[float]:
        for k, v in self.iters:
            if k == site:
                return v
        return None

    def binding_for(self, site: str) -> Optional[float]:
        for k, v in self.bindings:
            if k == site:
                return v
        return None

    def wall_for(self, sql: str) -> Optional[float]:
        for k, v in self.site_wall_s:
            if k == sql:
                return v
        return None

    def qerror_for(self, sql: str) -> Optional[float]:
        for k, v in self.qerrors:
            if k == sql:
                return v
        return None

    def as_dicts(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        return dict(self.iters), dict(self.site_wall_s)


_EMPTY_STATS = StatsProfile()


@dataclasses.dataclass(frozen=True)
class ExecutionContext:
    """The runtime parameters a plan is optimized *for*."""

    batch_size: int = 1
    hw: Tuple[Tuple[str, float], ...] = ()   # optional HW-profile override
    stats: StatsProfile = _EMPTY_STATS

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if isinstance(self.hw, dict):
            object.__setattr__(self, "hw", tuple(sorted(self.hw.items())))

    @classmethod
    def serving(cls, batch_size: int,
                stats: Optional[StatsProfile] = None) -> "ExecutionContext":
        return cls(batch_size=batch_size, stats=stats or _EMPTY_STATS)

    def with_stats(self, stats: StatsProfile) -> "ExecutionContext":
        return dataclasses.replace(self, stats=stats)

    # -------------------------------------------------------------- identity
    def fingerprint(self, sites: Optional[Sequence[str]] = None) -> Tuple:
        """Plan-key component. ``sites`` restricts the stats part to the
        iteration sites and parameterized-site groups one program contains,
        so observations at sites the program doesn't have never invalidate
        its plans (the per-table stats-version idea, applied to iteration
        and binding-diversity statistics)."""
        if sites is None:
            rel = self.stats.iters
            rel_b = self.stats.bindings
        else:
            want = set(sites)
            rel = tuple(kv for kv in self.stats.iters if kv[0] in want)
            rel_b = tuple(kv for kv in self.stats.bindings if kv[0] in want)
        return ("ctx", self.batch_size, self.hw, rel, rel_b)

    def describe(self) -> str:
        n = len(self.stats.iters)
        b = len(self.stats.bindings)
        return (f"batch={self.batch_size}"
                + (f", {n} observed iteration site(s)" if n else "")
                + (f", {b} binding-diversity site(s)" if b else ""))


ONE_SHOT = ExecutionContext()
