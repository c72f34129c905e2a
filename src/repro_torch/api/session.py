"""`CobraSession` — the unified public surface of the framework.

One object owns the database handle, the cost catalog, the optimizer
configuration, and a stats-versioned plan cache::

    session = CobraSession(db, CostCatalog(SLOW_REMOTE),
                           config=OptimizerConfig.preset("paper-exp1-3"))
    exe = session.compile(make_p0())       # memo search runs (once)
    out = exe.run()                        # execute the rewritten program
    exe2 = session.compile(make_p0())      # served from the plan cache
    db.analyze()                           # stats changed -> version bump
    exe3 = session.compile(make_p0())      # recompiled against fresh stats

The same session also fronts the distributed step planner
(``core.planner.plan``) through :meth:`CobraSession.plan_step`, so program
rewriting and step-program sharding share one configuration/result
vocabulary: both return a :class:`PlanReport` (domain ``"program"`` vs
``"step"``) with the chosen alternative, its estimated cost, the number of
alternatives considered, and memo statistics. The step planner costs plans
with the ``analysis.roofline.HW`` table (one H100 SXM by default), which
``ExecutionContext.hw`` overlays per session.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

from ..core.context import ExecutionContext, ONE_SHOT
from ..core.cost import CostCatalog
from ..core.regions import Interpreter, Program
from ..core.search import OptimizationResult, run_search
from ..obs.metrics import MetricsRegistry, registry_counter
from ..obs.trace import NOOP_TRACER
from ..relational.database import ClientEnv, DatabaseServer, NetworkProfile, SLOW_REMOTE
from .cache import (PlanCache, PlanCacheKey, program_fingerprint,
                    program_sites, program_tables)
from .config import OptimizerConfig

__all__ = ["CobraSession", "Executable", "ExecutionResult", "PlanReport"]


# --------------------------------------------------------------------------
# Shared result vocabulary (program rewriting AND step-program planning)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PlanReport:
    """What any Cobra planning pass reports, regardless of domain."""

    domain: str                 # "program" (SQL/prefetch rewriting) | "step" (TPU sharding)
    name: str                   # program name or arch/workload cell
    choice: object              # search.Plan | planner.PlanChoice
    est_cost_s: float           # model-estimated cost of the winner
    alternatives: int           # alternatives enumerated by the search
    memo_stats: Dict[str, int]
    opt_time_s: float
    artifact: object            # rewritten Program | planner terms dict
    from_cache: bool = False
    # ExecutionContext fingerprint the plan was costed under (telemetry:
    # serving plans are distinguishable from one-shot plans at a glance)
    context_fp: Tuple = ONE_SHOT.fingerprint()
    # which execution tier last served this plan ("interpreter"|"compiled")
    tier: str = "interpreter"
    # anti-regression swap-guard outcome for the recompile that produced
    # this plan (FeedbackController.validate_swap): was it checked, was the
    # swap accepted, how many bindings were replayed
    swap_checked: bool = False
    swap_accepted: Optional[bool] = None
    swap_replayed: int = 0
    # True when a compile-time budget tripped during saturation and this
    # plan came from the greedy best-first fallback over a partial memo
    budget_exhausted: bool = False

    @property
    def binding_diversity(self) -> Dict[str, float]:
        """The observed distinct-binding fractions this plan was costed
        under (from the context fingerprint, restricted to the program's
        parameterized-site groups). Empty = never observed (the cost model
        assumed no binding sharing)."""
        if len(self.context_fp) > 4:
            return dict(self.context_fp[4])
        return {}

    def describe(self) -> str:
        src = "cache" if self.from_cache else "search"
        batch = self.context_fp[1] if len(self.context_fp) > 1 else 1
        ctx = f", batch={batch}" if batch != 1 else ""
        div = self.binding_diversity
        if div:
            avg = sum(div.values()) / len(div)
            ctx += f", binding-diversity~{avg:.2f}@{len(div)} site(s)"
        if self.budget_exhausted:
            ctx += ", BUDGET EXHAUSTED (greedy fallback)"
        return (f"[{self.domain}] {self.name}: est {self.est_cost_s:.4g}s "
                f"over {self.alternatives} alternatives "
                f"({self.opt_time_s*1e3:.1f}ms, {src}{ctx})")


@dataclasses.dataclass
class ExecutionResult(Mapping):
    """Outputs of one program execution plus its simulated-clock telemetry."""

    outputs: Dict[str, object]
    simulated_s: float
    n_queries: int
    n_round_trips: int

    # Mapping over outputs so ``exe.run()["result"]`` reads naturally.
    def __getitem__(self, k):
        return self.outputs[k]

    def __iter__(self):
        return iter(self.outputs)

    def __len__(self):
        return len(self.outputs)


class Executable:
    """A compiled program: the chosen plan + rewritten region IR, runnable
    many times against the session's database."""

    def __init__(self, session: "CobraSession", source: Program,
                 result: OptimizationResult, from_cache: bool,
                 context: Optional[ExecutionContext] = None):
        self.session = session
        self.source = source
        self.result = result
        self.from_cache = from_cache
        self.context = context if context is not None else ONE_SHOT
        self.n_runs = 0
        self._lowered: Dict[str, object] = {}  # backend -> LoweredProgram
        # which tier served the most recent run_batch (set by runtime.batch)
        self.last_tier = "interpreter"
        # swap-guard verdict for the recompile that produced this executable
        # (set by FeedbackController.validate_swap when it judged this plan)
        self.swap_outcome: Optional[Dict[str, object]] = None

    # ------------------------------------------------------------ plan view
    @property
    def program(self) -> Program:
        """The rewritten (optimized) program."""
        return self.result.program

    @property
    def plan(self):
        return self.result.plan

    @property
    def est_cost_s(self) -> float:
        return self.result.est_cost

    @property
    def report(self) -> PlanReport:
        swap = self.swap_outcome or {}
        return PlanReport(
            domain="program", name=self.source.name, choice=self.result.plan,
            est_cost_s=self.result.est_cost,
            alternatives=self.result.alternatives,
            memo_stats=self.result.memo_stats,
            opt_time_s=self.result.opt_time_s, artifact=self.result.program,
            from_cache=self.from_cache,
            context_fp=self.context.fingerprint(
                sites=program_sites(self.source)),
            tier=self.last_tier,
            swap_checked=bool(swap.get("checked", False)),
            swap_accepted=swap.get("accepted"),
            swap_replayed=int(swap.get("replayed", 0)),
            budget_exhausted=bool(getattr(self.result, "budget_exhausted",
                                          False)))

    def describe(self) -> str:
        body = repr(self.program.body)
        kind = ("prefetch" if "prefetch" in body
                else "join" if "JOIN" in body else "original-shape")
        return f"{self.report.describe()} -> {kind}"

    def explain(self, *, feedback=None, site_cache=None,
                compiler=None) -> str:
        """EXPLAIN-style rendering of the winning plan: the region tree
        annotated per site with estimated cost, estimated-vs-observed
        counts (q-error), cache/tier status, and which rules derived it
        (rewrite provenance). Pass the serving runtime's ``feedback`` /
        ``site_cache`` / ``compiler`` to annotate with observed serving
        statistics (``ServingRuntime.explain(name)`` does)."""
        from ..obs.explain import explain_plan
        return explain_plan(self, feedback=feedback, site_cache=site_cache,
                            compiler=compiler)

    def scan(self, *, feedback=None, stats=None):
        """Run the bad-plan-pattern catalog over the REWRITTEN program
        (:func:`repro_torch.obs.signals.scan_plan`); returns the list of
        :class:`~repro_torch.obs.signals.Signal`\\ s still present after the
        optimizer had its say."""
        from ..obs.signals import scan_plan
        return scan_plan(self, feedback=feedback, stats=stats)

    # ------------------------------------------------------------ execution
    def run(self, *, network: Optional[NetworkProfile] = None,
            mode: str = "fast", **params) -> ExecutionResult:
        """Execute the optimized program. ``params`` bind program inputs
        (e.g. ``run(worklist=[1, 3, 5])``)."""
        self.n_runs += 1
        self.session.executions += 1
        return self.session.execute(self.program, network=network, mode=mode,
                                    **params)

    def lower(self, backend: Optional[str] = None):
        """The compiled-tier lowering of this plan
        (:class:`~repro_torch.compiled.lower.LoweredProgram`), memoized per
        backend: columnar loops bound to vectorized kernel-backed
        executables, everything else kept on the interpreter."""
        from ..compiled.lower import lower_program, resolve_backend
        be = resolve_backend(backend)
        lowered = self._lowered.get(be)
        if lowered is None:
            lowered = lower_program(self.program, be)
            self._lowered[be] = lowered
        return lowered

    def run_batch(self, param_sets: Sequence[Mapping[str, object]], *,
                  network: Optional[NetworkProfile] = None,
                  mode: str = "fast", site_cache=None,
                  tier: str = "auto", compiler=None):
        """Execute the optimized program over a BATCH of parameter bindings.

        The whole batch shares one client environment: each query site is
        fetched from the server once per batch (a shared site cache plus a
        bulk navigation fetch in the vectorized interpreter), amortizing
        C_NRT across invocations exactly like the paper's batching
        transformation. Pass a serving-scoped
        :class:`~repro_torch.runtime.sitecache.SiteCache` (``site_cache=``) to
        extend the sharing across batches and programs (one fetch per site
        per stats epoch). Returns a
        :class:`repro_torch.runtime.batch.BatchResult` whose per-invocation
        outputs match per-invocation :meth:`run` bit-for-bit. Programs
        containing updates execute sequentially on isolated environments,
        but sites over tables they never write still share the cache
        (write-set analysis).

        ``tier``/``compiler`` select the execution tier (see
        :func:`repro_torch.runtime.batch.run_batch`): ``tier="compiled"`` forces
        the kernel-backed columnar tier, ``"interpreter"`` forces it off,
        and the default ``"auto"`` promotes through a
        :class:`~repro_torch.compiled.manager.CompileManager` when one is
        passed — always bit-identical to the interpreted tier."""
        from ..runtime.batch import run_batch
        return run_batch(self.session, self.program, param_sets,
                         network=network, mode=mode, executable=self,
                         site_cache=site_cache, tier=tier, compiler=compiler)

    def run_baseline(self, *, network: Optional[NetworkProfile] = None,
                     mode: str = "fast", **params) -> ExecutionResult:
        """Execute the ORIGINAL (unoptimized) program for comparison."""
        return self.session.execute(self.source, network=network, mode=mode,
                                    **params)


# --------------------------------------------------------------------------
# Session
# --------------------------------------------------------------------------

class CobraSession:
    """Compile-once / execute-many frontend over one simulated database."""

    # telemetry counters live in the session's MetricsRegistry; these
    # descriptors keep `session.memo_runs += 1`-style call sites (and the
    # telemetry dict shape) working unchanged as backwards-compatible views
    compile_calls = registry_counter()
    memo_runs = registry_counter()      # actual memo build+saturate+search passes
    executions = registry_counter()
    compiled_executions = registry_counter()  # served by the compiled tier
    # feedback plan-swap guard outcomes (runtime.feedback.validate_swap)
    plan_swaps_accepted = registry_counter()
    plan_swaps_rejected = registry_counter()

    def __init__(self, db: DatabaseServer,
                 catalog: Optional[CostCatalog] = None,
                 config: Optional[OptimizerConfig] = None,
                 plan_cache_entries: int = 256,
                 plan_store=None,
                 context: Optional[ExecutionContext] = None,
                 tracer=None):
        self.db = db
        # observability: the registry must exist before the first counter
        # write below (the descriptors route attribute writes through it)
        self.metrics = MetricsRegistry()
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.catalog = catalog if catalog is not None else CostCatalog(SLOW_REMOTE)
        self.config = config if config is not None else OptimizerConfig()
        # default ExecutionContext compiles are costed for (one-shot unless
        # the session serves batches); per-compile `context=` overrides it
        self.context = context if context is not None else ONE_SHOT
        self.plan_cache = PlanCache(plan_cache_entries)
        # cross-program memo-group sharing: saturated loop groups replay
        # into later compiles (other programs, context-driven recompiles);
        # hit/miss counters land in self.metrics at hit time
        from ..core.memopool import MemoPool
        self.memo_pool = MemoPool(metrics=self.metrics)
        # optional disk-backed cross-session store (a PlanStore or a dir path)
        if plan_store is not None:
            from ..runtime.store import PlanStore
            plan_store = PlanStore.coerce(plan_store)
        self.plan_store = plan_store
        self._step_cache: Dict[Tuple, PlanReport] = {}
        # zero the registry-backed telemetry counters (class descriptors)
        self.compile_calls = 0
        self.memo_runs = 0
        self.executions = 0
        self.compiled_executions = 0
        self.plan_swaps_accepted = 0
        self.plan_swaps_rejected = 0

    # ------------------------------------------------------------- keys
    def _catalog_key(self, catalog: CostCatalog) -> Tuple:
        return dataclasses.astuple(catalog)

    def _cache_key(self, program: Program, catalog: CostCatalog,
                   config: OptimizerConfig,
                   rules_override: Optional[Sequence],
                   context: Optional[ExecutionContext] = None) -> PlanCacheKey:
        context = context if context is not None else self.context
        if rules_override is not None:
            config_key = ("cfg", config.choice,
                          tuple(r.name for r in rules_override),
                          config._cost_model_key(),
                          config.topk, config.max_combos, config.max_rounds,
                          config.node_budget, config.wall_budget_s)
        else:
            config_key = config.cache_key()
        # per-table stats versions of exactly the tables the program touches:
        # an analyze() on an unrelated table leaves this plan's entry hot.
        # The context fingerprint is likewise restricted to the program's
        # iteration sites, so observed stats at other programs' sites never
        # invalidate this plan.
        return PlanCacheKey(
            program_fp=program_fingerprint(program),
            catalog_key=self._catalog_key(catalog),
            config_key=config_key,
            stats_version=self.db.stats_token(program_tables(program)),
            context_key=context.fingerprint(sites=program_sites(program)))

    # ---------------------------------------------------------- compilation
    def compile(self, program: Program, *,
                config: Optional[OptimizerConfig] = None,
                catalog: Optional[CostCatalog] = None,
                rules: Optional[Sequence] = None,
                context: Optional[ExecutionContext] = None) -> Executable:
        """Optimize ``program`` (or fetch its cached plan) -> :class:`Executable`.

        ``config``/``catalog``/``context`` override the session defaults for
        this call — ``context`` is the :class:`ExecutionContext` the plan is
        costed for (batch size + observed iteration statistics), so a
        serving deployment can compile a *different* plan than one-shot for
        the same program. ``rules`` takes pre-built ``Rule`` objects (the
        back-compat path used by ``repro_torch.core.optimize``)."""
        cfg = config if config is not None else self.config
        cat = catalog if catalog is not None else self.catalog
        ctx = context if context is not None else self.context
        self.compile_calls += 1

        key = self._cache_key(program, cat, cfg, rules, ctx)
        if cfg.use_plan_cache:
            cached = self.plan_cache.get(key)
            if cached is not None:
                return Executable(self, program, cached, from_cache=True,
                                  context=ctx)
            if self.plan_store is not None:
                # store validity is judged by statistics CONTENT, so a
                # restarted process (version counters back at zero) still
                # warm-starts from byte-equal stats
                stats_fp = self.db.stats_fingerprint(program_tables(program))
                stored = self.plan_store.get(key, stats_fp=stats_fp)
                if stored is not None:
                    # warmed from disk: promote into the in-memory LRU so
                    # repeated compiles in this session stay O(1)
                    self.plan_cache.put(key, stored)
                    return Executable(self, program, stored, from_cache=True,
                                      context=ctx)

        rule_objs = list(rules) if rules is not None else cfg.resolve_rules()
        with self.tracer.span("compile", program=program.name) as sp:
            result = run_search(program, self.db, cat, choice=cfg.choice,
                                rules=rule_objs, topk=cfg.topk,
                                max_combos=cfg.max_combos,
                                max_rounds=cfg.max_rounds,
                                context=ctx, cost_model=cfg.cost_model,
                                tracer=self.tracer, budget=cfg.budget(),
                                memo_pool=self.memo_pool)
            if self.tracer.enabled:
                sp.attrs["est_cost_s"] = result.est_cost
                sp.attrs["alternatives"] = result.alternatives
        self.memo_runs += 1
        self.metrics.observe("compile_opt_time_s", result.opt_time_s)
        if cfg.use_plan_cache:
            if self.plan_store is not None:
                # first-writer-wins: if another session compiled the same
                # cold program concurrently, serve ITS stored plan so every
                # session converges on the one canonical artifact
                result = self.plan_store.put(
                    key, result,
                    stats_fp=self.db.stats_fingerprint(program_tables(program)))
            self.plan_cache.put(key, result)
        return Executable(self, program, result, from_cache=False, context=ctx)

    # ------------------------------------------------------------ execution
    def execute(self, program: Program, *,
                network: Optional[NetworkProfile] = None,
                mode: str = "fast", **params) -> ExecutionResult:
        """Run any program (optimized or not) against the session database
        on a fresh simulated client, returning outputs + clock telemetry."""
        declared = {n for n, _ in program.inputs}
        unknown = set(params) - declared
        if unknown:
            raise TypeError(
                f"unknown program input(s) {sorted(unknown)}; "
                f"{program.name} declares {sorted(declared) or 'no inputs'}")
        env = ClientEnv(self.db, network or self.catalog.network,
                        c_z=self.catalog.c_z)
        outputs = Interpreter(env, mode).run(program, params or None)
        return ExecutionResult(outputs=outputs, simulated_s=env.clock,
                               n_queries=env.n_queries,
                               n_round_trips=env.n_round_trips)

    # --------------------------------------------- distributed-planner facade
    def plan_step(self, arch: Union[str, object], seq_len: int,
                  global_batch: int, kind: str,
                  mesh: Tuple[int, ...] = (1, 16, 16),
                  top_k: int = 1) -> Union[PlanReport, list]:
        """Front the step-program planner with the same result vocabulary.

        Accepts an architecture name (resolved via ``models.arch.get_arch``)
        or an ``ArchConfig``. ``top_k > 1`` returns the K best reports."""
        from ..core.planner import enumerate_plans, plan as planner_plan
        cfg = arch
        if isinstance(arch, str):
            from ..models.arch import get_arch
            cfg = get_arch(arch)
        name = f"{getattr(cfg, 'name', arch)}/{kind}/T{seq_len}/B{global_batch}"
        # the hardware profile is a memo-key component like the catalog is
        # for program plans: an HW-table override (e.g. a different chip's
        # peak FLOPs) must not be served a plan costed for the old hardware
        from ..analysis.roofline import HW
        # a context-pinned HW profile overlays the global table for this
        # plan; the cache keys on the EFFECTIVE values, so a global HW
        # override (e.g. a different chip's peak FLOPs) still invalidates
        # and a pinned profile is genuinely what the plan is costed for
        override = dict(self.context.hw)
        hw_key = tuple(sorted({**HW, **override}.items()))
        key = (name, tuple(mesh), top_k, hw_key)
        cached = self._step_cache.get(key)
        if cached is not None:
            return cached

        t0 = time.perf_counter()
        saved = {k: HW[k] for k in override if k in HW}
        added = set(override) - set(HW)
        HW.update(override)
        try:
            out = planner_plan(cfg, seq_len, global_batch, kind, mesh=mesh,
                               top_k=top_k)
        finally:
            HW.update(saved)
            for k in added:
                HW.pop(k, None)
        dt = time.perf_counter() - t0
        if top_k == 1:
            report = PlanReport(
                domain="step", name=name, choice=out["choice"],
                est_cost_s=out["cost_s"], alternatives=out["n_alternatives"],
                memo_stats=out["memo"], opt_time_s=dt, artifact=out["terms"])
        else:
            n_alts = len(enumerate_plans(cfg, kind))
            report = [PlanReport(domain="step", name=name, choice=c["choice"],
                                 est_cost_s=c["cost_s"], alternatives=n_alts,
                                 memo_stats={}, opt_time_s=dt,
                                 artifact=c["terms"])
                      for c in out]
        self._step_cache[key] = report
        return report

    # ------------------------------------------------------- tracing frontend
    def trace(self, fn=None, *, name: Optional[str] = None,
              relations: Sequence[Tuple] = ()):
        """Decorator: compile a **plain Python function** into an
        :class:`Executable` via AST lifting (``repro_torch.api.lift``).

        Every parameter becomes a declared program input (its Python default
        is the input default); real ``for``/``if``/``while`` +
        ``break``/``continue`` and early ``return`` lower to Region IR; the
        returned value(s) become the program outputs. ``relations`` registers
        ORM FK relationships (``(table, fk_field, target, target_key[,
        attr])``) so ``row.<attr>`` traces to navigation. The decorated name
        binds to an Executable compiled by this session — plan-cache/store
        backed like any other ``compile()``::

            from repro_torch.api import q, col, param

            @session.trace
            def hours(worklist=()):
                out = []
                for wid in worklist:
                    for y in q("tasks").where(col("t_role_id")
                                              .eq(param("r"))).bind(r=wid):
                        out.append(y.t_hours)
                return out

            hours.run(worklist=[1, 2])

        **Builder escape hatch**: a function whose first parameter is named
        ``b`` or ``builder`` is instead called with a
        :class:`~repro_torch.api.builder.ProgramBuilder` (the lifter's own
        lowering target) and may use the full builder vocabulary directly —
        for programs outside the liftable subset.
        """
        from .builder import ProgramBuilder

        def decorate(f):
            params = list(inspect.signature(f).parameters.items())
            if params and params[0][0] in ("b", "builder"):
                b = ProgramBuilder(name or f.__name__)
                handles = []
                for pname, p in params[1:]:
                    default = () if p.default is inspect.Parameter.empty \
                        else p.default
                    handles.append(b.input(pname, default))
                out = f(b, *handles)
                if out is None:
                    outputs: Tuple = ()
                elif isinstance(out, (tuple, list)):
                    outputs = tuple(out)
                else:
                    outputs = (out,)
                return self.compile(b.build(outputs=outputs))
            from .lift import lift_program
            return self.compile(lift_program(f, name=name or f.__name__,
                                             relations=relations))

        return decorate(fn) if fn is not None else decorate

    # ------------------------------------------------------------- telemetry
    def analyze(self, *tables: str,
                columns: Optional[Tuple[str, ...]] = None) -> int:
        """Refresh table statistics (bumps the named tables' stats versions,
        or every table's when none are named, invalidating exactly the
        cached plans that touch them); returns the new global version.
        ``columns`` restricts the (comparatively expensive) histogram
        rebuilds to the named columns — scalar statistics always refresh —
        which is how the feedback controller's q-error path re-analyzes
        only the columns whose estimates drifted."""
        self.db.analyze(*tables, columns=columns)
        return self.db.stats_version

    @property
    def telemetry(self) -> Dict[str, int]:
        # a backwards-compatible view over the metrics registry: the counter
        # reads go through the registry_counter descriptors, and the
        # cache/store stats are mirrored into the registry as gauges so
        # `session.metrics.snapshot()` carries the full picture
        t = {"compile_calls": self.compile_calls,
             "memo_runs": self.memo_runs,
             "executions": self.executions,
             "compiled_executions": self.compiled_executions,
             "plan_swaps_accepted": self.plan_swaps_accepted,
             "plan_swaps_rejected": self.plan_swaps_rejected,
             "memo_pool_hits": self.memo_pool.hits,
             "memo_pool_misses": self.memo_pool.misses,
             "memo_pool_entries": len(self.memo_pool),
             "stats_version": self.db.stats_version}
        self.metrics.gauge("memo_pool_entries", len(self.memo_pool))
        self.metrics.gauge("stats_version", self.db.stats_version)
        cache_stats = {f"cache_{k}": v
                       for k, v in self.plan_cache.stats().items()}
        t.update(cache_stats)
        self.metrics.ingest(cache_stats)
        if self.plan_store is not None:
            store_stats = {f"store_{k}": v
                           for k, v in self.plan_store.stats().items()}
            t.update(store_stats)
            self.metrics.ingest(store_stats)
        return t
