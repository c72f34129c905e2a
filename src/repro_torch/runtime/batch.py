"""Batched execution: amortize server round-trips across parameter bindings.

``Executable.run(**params)`` opens a fresh :class:`ClientEnv` per
invocation — every query site pays its round trip every time. The paper's
batching transformation amortizes ``C_NRT`` by combining many parameter
bindings into one server interaction; this module applies the same idea at
the serving layer:

  * **site cache** — one :class:`BatchClientEnv` serves the whole batch;
    an ``executeQuery`` site with identical bindings is fetched from the
    server ONCE per batch, later invocations reuse the local result for a
    C_Z charge. The cache is a :class:`~repro_torch.runtime.sitecache.SiteCache`:
    epoch-keyed (per-table stats + data versions), so an ``analyze()`` or a
    write landing mid-stream makes affected entries miss instead of serving
    stale rows. Pass a serving-scoped instance (``site_cache=``) and the
    sharing extends ACROSS batches and programs — an identical site is
    fetched once per stats epoch, not once per batch;
  * **bulk navigation fetch** — the vectorized interpreter's ORM-navigation
    path (``core.vectorize._vec_nav``) asks this env to fetch ALL missing
    keys of a navigation site in one combined round trip
    (``WHERE key IN (...)``-style) instead of one point query per key;
  * **write-set-aware mutating programs** — a program containing ``UPDATE``
    statements still executes each invocation on an isolated environment
    (sharing fetched state across invocations is unsound once the data the
    program WRITES mutates mid-batch), but sites over tables the program
    never updates (``program_write_tables``) keep site-cache sharing: the
    read-only part of a mutating workload amortizes like any other;
  * **observation log** — every true server execution records (query,
    observed cardinality, wall-clock), and every parameterized lookup
    records its binding, for the feedback controller (drift detection and
    binding-diversity amortization).

Outputs are bit-for-bit identical to per-invocation ``run()``: the caches
only avoid refetching data proven unchanged (epoch keys), never change
what is computed.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

from ..core.context import param_group_key, param_prov_key
from ..core.regions import (BasicBlock, Interpreter, Program, Region,
                            UpdateRow)
from ..obs.trace import NOOP_TRACER
from ..relational.algebra import scan_tables
from ..relational.database import ClientEnv, NetworkProfile
from .sitecache import SiteCache, Uncacheable, param_key

__all__ = ["BatchClientEnv", "BatchResult", "run_batch",
           "program_has_updates"]

# back-compat aliases (the canonical definitions moved to runtime.sitecache)
_Uncacheable = Uncacheable
_param_key = param_key


def program_has_updates(program: Program) -> bool:
    found = [False]

    def walk(r: Region):
        if isinstance(r, BasicBlock) and isinstance(r.stmt, UpdateRow):
            found[0] = True
        for c in r.children():
            walk(c)

    walk(program.body)
    return found[0]


# distinct sentinel per uncacheable binding: it counts as its own distinct
# value in the diversity statistics (conservative: looks fully diverse)
_unique_token = itertools.count()


class BatchClientEnv(ClientEnv):
    """A client environment sharing a :class:`SiteCache` — per batch by
    default, serving-scoped when one is passed in."""

    def __init__(self, db, network: NetworkProfile, c_z: float = 30e-9,
                 orm_cache: bool = True,
                 site_cache: Optional[SiteCache] = None,
                 write_set: Sequence[str] = (),
                 tracer=None):
        super().__init__(db, network, c_z=c_z, orm_cache=orm_cache)
        self.site_cache = site_cache if site_cache is not None else SiteCache()
        self.write_set: Set[str] = set(write_set)
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        # id(query) -> [query, hits, shared_hits, fetches, fetched_rows];
        # flushed as ONE aggregated span event per site per batch
        # (flush_site_events) so per-invocation tracing cost stays at a
        # dict update, not a span allocation
        self._site_log: Dict[int, list] = {}
        self.site_hits = 0          # in-batch reuse
        self.shared_site_hits = 0   # cross-batch / cross-program reuse
        # (query, observed rows, observed wall-clock) per true execution —
        # consumed by runtime.feedback.FeedbackController
        self.observations: List[Tuple[object, int, float]] = []
        # per-batch binding-diversity log: group key -> set of binding keys
        # (+ total lookups) at PARAMETERIZED sites, merged by run_batch
        self.binding_sets: Dict[str, set] = {}
        self.binding_totals: Dict[str, int] = {}

    def _site_rec(self, q) -> list:
        rec = self._site_log.get(id(q))
        if rec is None:
            rec = self._site_log[id(q)] = [q, 0, 0, 0, 0]
        return rec

    def flush_site_events(self) -> None:
        """Emit one aggregated ``site-hit``/``site-fetch`` event per query
        site touched this batch (called by ``run_batch`` inside its batch
        span while the tracer is enabled)."""
        for q, hits, shared, fetches, rows in self._site_log.values():
            sql = q.sql()
            if fetches:
                self.tracer.event("site-fetch", sim=self.clock, sql=sql,
                                  n=fetches, rows=rows)
            if hits or shared:
                self.tracer.event("site-hit", sim=self.clock, sql=sql,
                                  n=hits + shared, shared=shared)
        self._site_log.clear()

    # ----------------------------------------------------------------- exec
    def _fetch(self, q, params):
        t = super().execute_query(q, params)
        self.observations.append((q, t.nrows, self.query_log[-1][2]))
        return t

    def _observe_binding(self, q, tables, pkey) -> None:
        self.site_cache.observe_binding(q, tables, pkey)
        from ..core.cost import query_param_cols
        # hash, not payload: diversity needs a distinct COUNT, and frozen
        # array bindings embed their full tobytes(). Record under both the
        # coarse per-table group and the finer provenance key (tables +
        # param-compared columns) so differently-diverse sites over one
        # table publish separate diversity fractions.
        h = hash(pkey)
        for gkey in (param_group_key(tables),
                     param_prov_key(tables, query_param_cols(q))):
            self.binding_sets.setdefault(gkey, set()).add(h)
            self.binding_totals[gkey] = self.binding_totals.get(gkey, 0) + 1

    def execute_query(self, q, params: Optional[Mapping[str, object]] = None):
        tables = scan_tables(q)
        if self.write_set and self.write_set & set(tables):
            # a site over tables this program UPDATES: never cached — each
            # invocation must observe its own (and earlier) writes. No
            # diversity observation either: publishing an amortization the
            # runtime can never deliver here would mis-price plans.
            return self._fetch(q, params)
        try:
            pkey = param_key(params)
        except Uncacheable:
            # no faithful key: bypass the cache, count the binding as its
            # own distinct value (conservative diversity)
            if params:
                self._observe_binding(
                    q, tables, ("__uncacheable__", next(_unique_token)))
            return self._fetch(q, params)
        if pkey:
            self._observe_binding(q, tables, pkey)
        cache = self.site_cache
        key = cache.site_key(q, pkey, self.db.site_epoch(tables),
                             origin=self.db.instance_token)
        found = cache.lookup(key)
        if found is not None:
            # local reuse: the result is already client-side; one C_Z to
            # hand the cursor over, no server round trip
            result, cross = found
            if cross:
                self.shared_site_hits += 1
            else:
                self.site_hits += 1
            self.charge_statement()
            if self.tracer.enabled:
                self._site_rec(q)[2 if cross else 1] += 1
            return result
        t = self._fetch(q, params)
        if self.tracer.enabled:
            rec = self._site_rec(q)
            rec[3] += 1
            rec[4] += t.nrows
        cache.put(key, t, tables)
        return t

    def bulk_nav_charge(self, table, n_misses: int) -> None:
        """Charge ONE combined fetch for all missing keys of a navigation
        site (called from ``core.vectorize._vec_nav``): a single round trip
        whose server time is ``n_misses`` index probes and whose payload is
        ``n_misses`` rows — instead of ``n_misses`` separate point queries."""
        m = self.db.model
        self._charge_query(
            n_misses, table.row_bytes,
            m.startup_s + m.index_lookup_s,
            m.startup_s + n_misses * m.index_lookup_s
            + n_misses / m.emit_rows_per_s)


@dataclasses.dataclass
class BatchResult(Sequence):
    """Per-invocation results plus batch-level telemetry."""

    results: List            # ExecutionResult per parameter set, in order
    simulated_s: float       # total simulated clock for the whole batch
    n_queries: int
    n_round_trips: int
    batched: bool            # False -> sequential fallback (program updates)
    site_hits: int = 0
    shared_site_hits: int = 0  # served by an EARLIER batch's / program's fetch
    observations: List = dataclasses.field(default_factory=list)
    # (site_key, iteration_count) per executed while / collection loop —
    # consumed by FeedbackController.observe_iterations into a StatsProfile
    iteration_observations: List = dataclasses.field(default_factory=list)
    # (group_site_key, total_lookups, distinct_bindings) per parameterized
    # site group — consumed by FeedbackController.observe_bindings
    binding_observations: List = dataclasses.field(default_factory=list)
    # which execution tier served the batch: "interpreter" or "compiled"
    # (the splicing interpreter with kernel-backed columnar loops)
    tier: str = "interpreter"

    def __getitem__(self, i):
        return self.results[i]

    def __len__(self):
        return len(self.results)

    @property
    def outputs(self) -> List[Dict[str, object]]:
        return [r.outputs for r in self.results]

    def describe(self) -> str:
        kind = "batched" if self.batched else "sequential-fallback"
        return (f"{len(self.results)} invocation(s) [{kind}]: "
                f"{self.simulated_s:.4g}s simulated, "
                f"{self.n_round_trips} round trip(s), "
                f"{self.site_hits} site reuse(s), "
                f"{self.shared_site_hits} shared site reuse(s)")


def _merge_binding_logs(envs) -> List[Tuple[str, int, int]]:
    sets: Dict[str, set] = {}
    totals: Dict[str, int] = {}
    for env in envs:
        for g, s in env.binding_sets.items():
            sets.setdefault(g, set()).update(s)
        for g, n in env.binding_totals.items():
            totals[g] = totals.get(g, 0) + n
    return [(g, totals[g], len(sets[g])) for g in sorted(totals)]


def _input_diversity_fallback(binding_obs, source_program,
                              param_sets) -> List[Tuple[str, int, int]]:
    """Attribute the batch's PROGRAM-INPUT diversity to parameterized site
    groups the running plan never executed (e.g. the prefetch form of W_E
    executes zero parameterized queries).

    Sound only for NON-mutating programs (the caller's batched branch): a
    read-only program is a pure function of its inputs, so identical
    inputs imply identical binding sequences at every site — the input
    distinct fraction UPPER-bounds any site's; distinct inputs may still
    repeat bindings, so this only ever over-estimates diversity (the
    conservative direction: less amortization). A mutating program's
    bindings can depend on rows earlier invocations wrote, so the
    sequential branch never applies this fallback. Cache-level
    observations, when present for a group, take precedence."""
    from ..api.cache import program_param_prov_sites, program_param_sites
    groups = [g for g in program_param_sites(source_program)
              if g.startswith("qdiv:")]
    groups += list(program_param_prov_sites(source_program))
    if not groups or not param_sets:
        return binding_obs
    seen = {g for g, _, _ in binding_obs}
    missing = [g for g in groups if g not in seen]
    if not missing:
        return binding_obs
    distinct = set()
    for p in param_sets:
        try:
            distinct.add(param_key(p))
        except Uncacheable:
            distinct.add(("__uncacheable__", next(_unique_token)))
    out = list(binding_obs)
    for g in missing:
        out.append((g, len(param_sets), len(distinct)))
    return out


def _resolve_lowered(program: Program, executable, tier: str, compiler,
                     n_invocations: int):
    """The :class:`~repro_torch.compiled.lower.LoweredProgram` to run this batch
    on, or None for the interpreter tier.

    ``tier="compiled"`` forces a lowering (memoized on the executable when
    one is given); ``"interpreter"`` forces it off; ``"auto"`` (default)
    defers to the :class:`~repro_torch.compiled.manager.CompileManager` — no
    compiler means no promotion, matching pre-compiled-tier behavior."""
    if tier not in ("auto", "interpreter", "compiled"):
        raise ValueError(f"tier must be 'auto', 'interpreter' or 'compiled', "
                         f"got {tier!r}")
    if tier == "interpreter":
        return None
    if tier == "compiled":
        if executable is not None:
            return executable.lower()
        from ..compiled.lower import lower_program
        return lower_program(program)
    if compiler is not None and executable is not None:
        return compiler.lowered_for(executable, n_invocations)
    return None


def _make_interp(env, mode: str, lowered):
    if lowered is None:
        return Interpreter(env, mode)
    from ..compiled.exec import SplicingInterpreter
    return SplicingInterpreter(env, lowered, mode)


def run_batch(session, program: Program,
              param_sets: Sequence[Mapping[str, object]], *,
              network: Optional[NetworkProfile] = None, mode: str = "fast",
              executable=None,
              site_cache: Optional[SiteCache] = None,
              tier: str = "auto", compiler=None) -> BatchResult:
    """Execute ``program`` once per parameter set on a shared batch env.

    ``site_cache`` plugs in a serving-scoped
    :class:`~repro_torch.runtime.sitecache.SiteCache` so fetches are shared
    across batches and programs; without one, a private per-batch cache
    preserves the classic one-fetch-per-site-per-batch behavior.

    ``tier`` selects the execution tier: ``"auto"`` (compiled when the
    ``compiler`` — a :class:`~repro_torch.compiled.manager.CompileManager` — says
    the pair is hot), ``"compiled"`` (force), ``"interpreter"`` (force
    off). Compiled batches are bit-identical to interpreted ones — same
    outputs, same simulated clock — only wall time differs."""
    from ..api.cache import program_write_tables as _write_tables
    from ..api.session import ExecutionResult

    param_sets = [dict(p) for p in param_sets]
    declared = {n for n, _ in program.inputs}
    for p in param_sets:
        unknown = set(p) - declared
        if unknown:
            raise TypeError(
                f"unknown program input(s) {sorted(unknown)}; "
                f"{program.name} declares {sorted(declared) or 'no inputs'}")

    cache = site_cache if site_cache is not None else SiteCache()
    cache.new_era()
    # binding diversity is a property of the SOURCE program's sites; the
    # executed (rewritten) program may have compiled them away entirely
    source = getattr(executable, "source", None) or program

    tracer = getattr(session, "tracer", NOOP_TRACER)
    lowered = _resolve_lowered(program, executable, tier, compiler,
                               len(param_sets))
    tier_used = "interpreter" if lowered is None else "compiled"
    if executable is not None:
        executable.last_tier = tier_used
    if lowered is not None:
        # run the lowering's OWN program tree: compiled-loop bindings are by
        # region identity, and the lowering was built from a program with
        # this exact fingerprint
        program = lowered.program
        session.compiled_executions = getattr(
            session, "compiled_executions", 0) + len(param_sets)

    if program_has_updates(program):
        # correctness first: a mutating program may change what later
        # invocations should observe, so each one gets an isolated env —
        # but sites over tables the program never WRITES are still shared
        # through the (epoch-keyed) site cache, and iteration/binding
        # observations are harvested per env, so mutating programs feed
        # the feedback loop's StatsProfile too
        write_set = _write_tables(program)
        envs, results, iteration_obs, observations = [], [], [], []
        with tracer.span("batch", program=program.name, n=len(param_sets),
                         tier=tier_used, batched=False) as bsp:
            for p in param_sets:
                env = BatchClientEnv(session.db,
                                     network or session.catalog.network,
                                     c_z=session.catalog.c_z,
                                     site_cache=cache,
                                     write_set=write_set, tracer=tracer)
                outputs = _make_interp(env, mode, lowered).run(program,
                                                               p or None)
                results.append(ExecutionResult(
                    outputs=outputs, simulated_s=env.clock,
                    n_queries=env.n_queries,
                    n_round_trips=env.n_round_trips))
                iteration_obs.extend(env.iteration_log)
                observations.extend(env.observations)
                envs.append(env)
            if tracer.enabled:
                for e in envs:
                    e.flush_site_events()
                bsp.attrs["simulated_s"] = sum(r.simulated_s
                                               for r in results)
        session.executions += len(param_sets)
        if executable is not None:
            executable.n_runs += len(param_sets)
        return BatchResult(
            results=results,
            simulated_s=sum(r.simulated_s for r in results),
            n_queries=sum(r.n_queries for r in results),
            n_round_trips=sum(r.n_round_trips for r in results),
            batched=False,
            site_hits=sum(e.site_hits for e in envs),
            shared_site_hits=sum(e.shared_site_hits for e in envs),
            observations=observations,
            iteration_observations=iteration_obs,
            # cache-level observations only: input diversity does not bound
            # a mutating program's binding sequences (they may depend on
            # rows earlier invocations wrote)
            binding_observations=_merge_binding_logs(envs),
            tier=tier_used)

    env = BatchClientEnv(session.db, network or session.catalog.network,
                         c_z=session.catalog.c_z, site_cache=cache,
                         tracer=tracer)
    interp = _make_interp(env, mode, lowered)
    results = []
    with tracer.span("batch", sim_clock=lambda: env.clock,
                     program=program.name, n=len(param_sets),
                     tier=tier_used, batched=True):
        clock0, q0, rt0 = 0.0, 0, 0
        for p in param_sets:
            outputs = interp.run(program, p or None)
            results.append(ExecutionResult(
                outputs=outputs, simulated_s=env.clock - clock0,
                n_queries=env.n_queries - q0,
                n_round_trips=env.n_round_trips - rt0))
            clock0, q0, rt0 = env.clock, env.n_queries, env.n_round_trips
        if tracer.enabled:
            env.flush_site_events()
    session.executions += len(param_sets)
    if executable is not None:
        executable.n_runs += len(param_sets)
    return BatchResult(results=results, simulated_s=env.clock,
                       n_queries=env.n_queries,
                       n_round_trips=env.n_round_trips, batched=True,
                       site_hits=env.site_hits,
                       shared_site_hits=env.shared_site_hits,
                       observations=list(env.observations),
                       iteration_observations=list(env.iteration_log),
                       binding_observations=_input_diversity_fallback(
                           _merge_binding_logs([env]), source, param_sets),
                       tier=tier_used)
