"""The serving request loop: batch, execute, observe, re-optimize.

``ServingRuntime`` fronts a :class:`~repro_torch.api.session.CobraSession` for
high-throughput workloads::

    rt = ServingRuntime(session, store="plans/", batch_size=32)
    rt.register(make_p0())
    responses = rt.serve([("P0", {}), ("P0", {}), ("W_E", {"worklist": [1]})])

Request processing per cycle:

  1. requests are grouped by program and chunked into batches of at most
     ``batch_size``;
  2. each batch executes through :func:`repro_torch.runtime.batch.run_batch`
     against the runtime's **shared site cache**
     (:class:`~repro_torch.runtime.sitecache.SiteCache`) — one server round trip
     per query site per STATS EPOCH, shared across batches and across
     programs (serving-layer MQO); epoch keys + ``analyze()``/write
     invalidation keep every cached result bit-identical to an uncached
     fetch;
  3. the batch's observation log feeds the
     :class:`~repro_torch.runtime.feedback.FeedbackController`; if observed
     cardinalities drifted past the threshold, the drifted tables are
     re-analyzed (per-table stats versions bump, their site-cache entries
     drop) and every registered program touching them is recompiled before
     the next batch — the memo search may pick a different winner under
     the fresh statistics;
  4. responses are returned in the original request order.

Every compile goes through the runtime's **serving context** — an
:class:`~repro_torch.core.context.ExecutionContext` whose ``batch_size`` is the
runtime's and whose :class:`~repro_torch.core.context.StatsProfile` is whatever
the feedback controller has published (observed while-loop and worklist-
loop iteration counts, plus per-site binding-diversity fractions measured
at the site cache). The memo search therefore costs plans for batched
execution — C_NRT of binding-free sites amortized across the batch, and
of parameterized sites by their OBSERVED distinct-binding fraction — and
may legitimately pick a different winner than a one-shot session would for
the very same program. When a batch's iteration or binding observations
move a published value, the context fingerprint changes and the affected
programs are recompiled under the new context (programs without that site
keep their keys, hence their plans, untouched).

The module-level :func:`serve` is the one-call convenience wrapper.

On the port the loop is host Python, as in the reference; the tables live
on the session's device, and with the compiled tier on
(``compile_hot_plans``) the promoted plans' probes and folds launch the
CUDA kernels of :mod:`repro_torch.kernels` on the card. The simulated clock
and the drift decisions never read wall time, so they agree with the
reference package's on the same data.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from ..api.cache import program_fingerprint, program_tables
from ..core.context import ExecutionContext
from ..core.regions import Program
from ..obs.metrics import MetricsRegistry, merge_snapshots, registry_counter
from ..obs.trace import NOOP_TRACER
from .feedback import FeedbackController
from .sitecache import SiteCache

__all__ = ["ServingRuntime", "serve"]


class ServingRuntime:
    # registry-backed telemetry counters (repro_torch.obs.metrics); the legacy
    # attribute reads/writes and telemetry() dict shape are unchanged views
    requests_served = registry_counter()
    batches_run = registry_counter()
    recompiles = registry_counter()
    context_recompiles = registry_counter()
    swaps_rejected = registry_counter()
    simulated_s = registry_counter()
    n_round_trips = registry_counter()

    def __init__(self, session, *, store=None, batch_size: int = 16,
                 drift_threshold: float = 3.0,
                 cost_drift_threshold: Optional[float] = 10.0,
                 feedback: bool = True,
                 context: Optional[ExecutionContext] = None,
                 site_cache: Optional[SiteCache] = None,
                 site_cache_ttl_s: Optional[float] = None,
                 site_cache_entries: int = 4096,
                 site_cache_max_bytes: Optional[int] = None,
                 compile_hot_plans: Optional[int] = None,
                 compile_backend: Optional[str] = None,
                 replay_window: int = 8,
                 tracer=None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if replay_window < 0:
            raise ValueError("replay_window must be >= 0")
        self.session = session
        # observability: the runtime's OWN registry (sharing the session's
        # would collide when several runtimes front one session); the tracer
        # defaults to the session's so compile + serve spans share one tree
        self.metrics = MetricsRegistry()
        self.tracer = tracer if tracer is not None else \
            getattr(session, "tracer", NOOP_TRACER)
        if store is not None:
            from .store import PlanStore
            session.plan_store = PlanStore.coerce(store)
        self.batch_size = batch_size
        # the serving-scoped shared site cache: one fetch per identical
        # query site per stats epoch, across batches AND programs
        self.site_cache = site_cache if site_cache is not None else \
            SiteCache(ttl_s=site_cache_ttl_s, max_entries=site_cache_entries,
                      max_bytes=site_cache_max_bytes)
        # the base serving context; observed stats are layered onto it as
        # the feedback controller publishes them
        self._base_context = context if context is not None else \
            ExecutionContext(batch_size=batch_size)
        self.feedback: Optional[FeedbackController] = (
            FeedbackController(session, drift_threshold,
                               cost_drift_threshold=cost_drift_threshold)
            if feedback else None)
        # compiled execution tier: promote hot (program, plan, context)
        # pairs after `compile_hot_plans` interpreted invocations (argument
        # overrides the session config's knob; None/0 = tier off)
        threshold = compile_hot_plans if compile_hot_plans is not None \
            else getattr(session.config, "compile_hot_plans", None)
        if threshold:
            from ..compiled.manager import CompileManager
            self.compiler = CompileManager(session, threshold=threshold,
                                           backend=compile_backend)
        else:
            self.compiler = None
        self._programs: Dict[str, Program] = {}
        self._executables: Dict[str, object] = {}
        # last-K observed bindings per program — the anti-regression guard's
        # replay workload when a recompile proposes a different plan
        self.replay_window = replay_window
        self._recent: Dict[str, deque] = {}
        # zero the registry-backed telemetry counters (class descriptors)
        self.requests_served = 0
        self.batches_run = 0
        self.recompiles = 0
        self.context_recompiles = 0
        self.swaps_rejected = 0
        self.simulated_s = 0.0
        self.n_round_trips = 0
        # per-program request counts — the traffic shares triage() weights by
        self._requests_by_program: Dict[str, int] = {}

    # -------------------------------------------------------------- context
    def current_context(self) -> ExecutionContext:
        """The ExecutionContext serving compiles are costed for right now:
        the runtime's batch size + the feedback controller's published
        iteration statistics."""
        if self.feedback is None:
            return self._base_context
        return self._base_context.with_stats(self.feedback.stats_profile())

    # ---------------------------------------------------------- registration
    def register(self, program: Program, name: Optional[str] = None):
        """Register (and compile) a program for serving; returns its
        Executable. Compilation is costed under the serving context (batch
        size + observed stats) and goes through the session, so the plan
        cache/store make repeated registration cheap."""
        name = name or program.name
        self._programs[name] = program
        self._executables[name] = self.session.compile(
            program, context=self.current_context())
        return self._executables[name]

    def executable(self, name: str):
        exe = self._executables.get(name)
        if exe is None:
            raise KeyError(f"no program registered as {name!r}; "
                           f"known: {sorted(self._programs)}")
        return exe

    # --------------------------------------------------------------- serving
    def serve(self, requests: Iterable[Tuple[str, Mapping[str, object]]]
              ) -> List[object]:
        """Process a request stream; returns one ExecutionResult per request,
        in request order."""
        todo = list(requests)
        responses: List[Optional[object]] = [None] * len(todo)
        # group by program, preserving each request's original position
        by_program: Dict[str, List[int]] = {}
        for i, (name, _params) in enumerate(todo):
            self.executable(name)  # fail fast on unknown programs
            by_program.setdefault(name, []).append(i)

        with self.tracer.span("serve", n_requests=len(todo)):
            for name, indices in by_program.items():
                for lo in range(0, len(indices), self.batch_size):
                    chunk = indices[lo:lo + self.batch_size]
                    batch = self.serve_batch(name,
                                             [todo[i][1] for i in chunk])
                    for i, result in zip(chunk, batch.results):
                        responses[i] = result
        return responses

    def serve_batch(self, name: str,
                    params: Sequence[Mapping[str, object]]):
        """Execute ONE already-formed batch of same-program requests through
        the full serving path — site cache, compiled tier, replay capture,
        feedback/recompile — and return the BatchResult (``.results`` in
        request order). ``serve()`` forms fixed-size batches and calls this;
        a cluster's deadline-driven batch former calls it directly with the
        batches the router actually coalesced."""
        exe = self.executable(name)
        self._requests_by_program[name] = \
            self._requests_by_program.get(name, 0) + len(params)
        batch = exe.run_batch(params, site_cache=self.site_cache,
                              compiler=self.compiler)
        if self.replay_window:
            recent = self._recent.setdefault(
                name, deque(maxlen=self.replay_window))
            recent.extend(dict(p) for p in params)
        self.requests_served += len(params)
        self.batches_run += 1
        self.simulated_s += batch.simulated_s
        self.n_round_trips += batch.n_round_trips
        self._after_batch(batch)
        return batch

    def _after_batch(self, batch) -> None:
        if self.feedback is None:
            return
        stats_moved = False
        if batch.iteration_observations:
            stats_moved = self.feedback.observe_iterations(
                batch.iteration_observations)
        if batch.binding_observations:
            stats_moved |= self.feedback.observe_bindings(
                batch.binding_observations)
        drifted = self.feedback.observe(batch.observations) \
            if batch.observations else []
        if drifted:
            self.feedback.refresh(drifted)
            # the re-analyze moved the drifted tables' stats epoch, so
            # their site-cache entries are already unreachable; drop them
            # eagerly too
            self.site_cache.invalidate_tables(drifted)
            if self.compiler is not None:
                # same epoch discipline for compiled artifacts: drop the
                # lowerings (and promotion heat) of plans touching the
                # drifted tables — their replacements start cold
                self.compiler.invalidate_tables(drifted)
            self._recompile_touching(drifted)
        if stats_moved:
            # a published iteration count or binding-diversity fraction
            # moved: the serving context's fingerprint changed, so
            # recompile under the new context. The fingerprint is
            # restricted per program to its own sites — programs without
            # the moved site (and any the drift branch just recompiled
            # under this same context) hit the plan cache.
            self._recompile_for_context()

    def _guarded_swap(self, name: str, new_exe) -> None:
        """Install ``new_exe`` as the serving plan for ``name`` — unless the
        anti-regression guard, replaying the last observed bindings against
        both plans, finds the old plan actually cheaper on the workload just
        served (estimates proposed the swap; real executions veto it)."""
        old = self._executables.get(name)
        if old is None or self.feedback is None or program_fingerprint(
                new_exe.program) == program_fingerprint(old.program):
            # nothing running yet, guarding disabled, or the "new" plan is
            # the same program — no behavioral change to validate
            self._executables[name] = new_exe
            return
        if self.feedback.validate_swap(old, new_exe,
                                       list(self._recent.get(name, ()))):
            self._executables[name] = new_exe
        else:
            self.swaps_rejected += 1

    def _recompile_touching(self, tables: Sequence[str]) -> None:
        """Recompile registered programs whose table set intersects
        ``tables``; per-table stats versions keep the others' plans hot."""
        drifted = set(tables)
        ctx = self.current_context()
        for name, program in self._programs.items():
            if drifted & set(program_tables(program)):
                self._guarded_swap(name,
                                   self.session.compile(program, context=ctx))
                self.recompiles += 1

    def _recompile_for_context(self) -> None:
        """Recompile every registered program under the refreshed context;
        only those whose per-program context fingerprint actually changed
        miss the cache (and count as context recompiles)."""
        ctx = self.current_context()
        for name, program in self._programs.items():
            exe = self.session.compile(program, context=ctx)
            if not exe.from_cache:
                self.context_recompiles += 1
                self.recompiles += 1
            self._guarded_swap(name, exe)

    # --------------------------------------------------------- observability
    def explain(self, name: str) -> str:
        """EXPLAIN the named program's CURRENT serving plan, annotated with
        this runtime's observed statistics (feedback sites, site-cache
        binding diversity, compiled-tier status)."""
        return self.executable(name).explain(feedback=self.feedback,
                                             site_cache=self.site_cache,
                                             compiler=self.compiler)

    def scan(self, name: str):
        """Bad-plan signals still present in the named program's current
        serving plan (:func:`repro_torch.obs.signals.scan_plan`)."""
        return self.executable(name).scan(feedback=self.feedback)

    def triage(self):
        """Rank every served program by traffic-weighted estimated win
        (observed drift × invocation share × signal severity) — the fleet
        view that routes re-optimization effort where the traffic is.
        Returns :class:`~repro_torch.obs.triage.TriageRow`\\ s, highest first."""
        from ..obs.triage import triage_fleet
        return triage_fleet(self)

    def metrics_snapshot(self) -> Dict[str, object]:
        """One flat snapshot across every component registry (serving,
        session, feedback) plus the site-cache / compiler stats dicts
        ingested as gauges — diff two snapshots to see a serve cycle."""
        self.metrics.ingest(self.site_cache.stats(), prefix="site_cache_")
        if self.compiler is not None:
            self.metrics.ingest(self.compiler.metrics.snapshot(),
                                prefix="compiled_")
        parts = {"serving": self.metrics.snapshot(),
                 "session": self.session.metrics.snapshot()}
        if self.feedback is not None:
            parts["feedback"] = self.feedback.metrics.snapshot()
        return merge_snapshots(**parts)

    # ------------------------------------------------------------- telemetry
    def telemetry(self) -> Dict[str, object]:
        t = {"requests_served": self.requests_served,
             "batches_run": self.batches_run,
             "recompiles": self.recompiles,
             "context_recompiles": self.context_recompiles,
             "simulated_s": self.simulated_s,
             "round_trips": self.n_round_trips,
             "context": self.current_context().describe(),
             "programs": sorted(self._programs)}
        t["swaps_rejected"] = self.swaps_rejected
        t.update({f"session_{k}": v for k, v in self.session.telemetry.items()})
        t.update({f"site_cache_{k}": v
                  for k, v in self.site_cache.stats().items()})
        if self.feedback is not None:
            fb = self.feedback.telemetry()
            fb.pop("sites", None)  # keep the summary flat
            fb.pop("iteration_sites", None)
            fb.pop("binding_sites", None)
            fb.pop("swaps", None)
            t.update({f"feedback_{k}": v for k, v in fb.items()})
        if self.compiler is not None:
            t.update({f"compiled_{k}": v
                      for k, v in self.compiler.telemetry().items()})
        return t


def serve(session, programs: Sequence[Program],
          requests: Iterable[Tuple[str, Mapping[str, object]]],
          **runtime_kw) -> Tuple[List[object], ServingRuntime]:
    """One-call serving loop: register ``programs``, process ``requests``,
    return (responses, runtime) so callers can inspect telemetry."""
    rt = ServingRuntime(session, **runtime_kw)
    for p in programs:
        rt.register(p)
    return rt.serve(requests), rt
