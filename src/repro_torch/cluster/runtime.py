"""Sharded multi-worker serving: shard workers behind a router + former.

``ClusterRuntime`` splits serving across N :class:`ShardWorker`\\ s — one
per shard of a :class:`~repro_torch.cluster.database.ShardedDatabase`. Each
worker is a full :class:`~repro_torch.runtime.serving.ServingRuntime`: its own
:class:`~repro_torch.api.session.CobraSession`, its own byte-budgeted
:class:`~repro_torch.runtime.sitecache.SiteCache` (optionally with an oversize
spill tier), its own :class:`~repro_torch.runtime.feedback.FeedbackController`.
What they share is the data plane (the ONE sharded database — so a write
or ``analyze()`` on any worker moves the coordinator's per-shard epochs
and every worker's epoch-keyed cached sites for exactly the affected
tables self-invalidate) and, when configured, one disk-backed
:class:`~repro_torch.runtime.store.PlanStore` — a plan search won on one worker
warm-starts the identical compile on every other, because the shared
database gives them byte-equal stats fingerprints.

The request path::

    serve(requests)
      → Router: (program, bindings) → worker          [affinity or hash]
      → BatchFormer: deadline/max-batch flushes        [dynamic batches]
      → ShardWorker.serve_formed(batch)                [full serving path]
      → responses reassembled in request order

Each worker feeds its OBSERVED formed-batch sizes back into its serving
context: when the running mean drifts past ``publish_threshold`` from the
context's current ``batch_size``, the worker republishes the context and
recompiles — the batch-aware cost model prices exactly the batches the
router forms, so the batch-64 plan flip emerges from deadline-driven
formation rather than a fixed-size config.

**Bit-identity.** For every example program, ``ClusterRuntime.serve()``
returns request-for-request the same outputs (and leaves the same database
state) as a single-worker ``ServingRuntime.serve()`` over the same stream
— including under mid-stream writes, ``analyze()``, and drift-triggered
plan swaps. The pieces: the sharded database's scatter-gather merges are
bit-exact (``tests/test_torch_cluster.py`` asserts per query shape); plan swaps
only exchange semantics-preserving rewrites; and ordering of mutations is
preserved per affinity key — same-key requests route to the same worker's
FIFO queue, while cross-key writes touch different shard rows and
commute. Simulated CLOCKS legitimately differ (that is the point: pruned
sites charge one shard, scatters charge the slowest shard plus a merge);
identity is over results and data.

The workers are logical: N shard workers in one Python thread over one
sharded database on one device (the card in production), as in the
reference package, which has no multi-device placement either.

Timing is discrete-event: worker clocks advance per formed batch
(``busy[w] = max(busy[w], flush_s) + batch.simulated_s``), the cluster
makespan is the slowest worker's clock, and per-request latency histograms
(queueing + service) land in the cluster registry.
"""

from __future__ import annotations

import dataclasses
import os
from collections import deque
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from ..api.cache import program_fingerprint
from ..api.session import CobraSession
from ..core.regions import Program
from ..obs.metrics import (MetricsRegistry, combine_snapshots,
                           merge_snapshots, registry_counter)
from ..obs.trace import NOOP_TRACER
from ..runtime.serving import ServingRuntime
from ..runtime.sitecache import SiteCache
from .database import ShardedDatabase
from .partition import Partitioner
from .router import BatchFormer, FormedBatch, Request, Router

__all__ = ["ShardWorker", "ClusterRuntime"]


class ShardWorker(ServingRuntime):
    """A ServingRuntime that serves router-formed batches and publishes the
    batch sizes it actually observes into its serving context."""

    batch_publishes = registry_counter()
    bit_vetoes = registry_counter()

    def __init__(self, session, worker_id: int, *,
                 publish_threshold: float = 1.5,
                 bit_guard_swaps: bool = True, **kw):
        super().__init__(session, **kw)
        if publish_threshold < 1.0:
            raise ValueError("publish_threshold must be >= 1.0")
        self.worker_id = worker_id
        self.publish_threshold = publish_threshold
        self.bit_guard_swaps = bit_guard_swaps
        self._formed_sizes: deque = deque(maxlen=32)
        self.batch_publishes = 0
        self.bit_vetoes = 0
        self._bit_guard = False

    def serve_formed(self, batch: FormedBatch):
        """Execute one formed batch through the full serving path; returns
        the BatchResult (results in the batch's request order)."""
        self._observe_formed(batch.size)
        return self.serve_batch(batch.program,
                                [dict(r.params) for r in batch.requests])

    def _observe_formed(self, size: int) -> None:
        self._formed_sizes.append(size)
        self.metrics.observe("formed_batch_size", size)
        mean = sum(self._formed_sizes) / len(self._formed_sizes)
        target = max(1, int(round(mean)))
        cur = self._base_context.batch_size
        ratio = max(target, cur) / max(1, min(target, cur))
        if ratio >= self.publish_threshold:
            # the router is forming materially different batches than the
            # context was costed for: republish and recompile, so the
            # batch-aware amortization prices the REAL batch size
            self._base_context = dataclasses.replace(
                self._base_context, batch_size=target)
            self.batch_size = target
            self.batch_publishes += 1
            self._bit_guard = True
            try:
                self._recompile_for_context()
            finally:
                self._bit_guard = False

    def _guarded_swap(self, name: str, new_exe) -> None:
        """The single-runtime guard plus, for PUBLISH-driven recompiles, a
        BIT-IDENTITY veto. Formed-size context publishes are a
        cluster-only mechanism — no single-worker baseline ever recompiles
        because a batch former changed its batch sizes — so a publish may
        propose plans a fixed-size runtime would never compile, and a
        proposal whose replayed outputs differ in even one bit from the
        incumbent's (e.g. a DB-side float32 SUM replacing a client-side
        float64 fold) is vetoed. Feedback-driven swaps (drift, published
        iteration stats) deliberately do NOT get the veto: they mirror the
        single-worker runtime's own recompile discipline decision-for-
        decision, which is what keeps cluster serving bit-identical to a
        single worker across those swaps. Mutating programs can't be
        replayed against the live database; they fall through to the base
        guard unchanged, exactly like the cost guard does.

        ``bit_guard_swaps=False`` turns the veto off: publishes then swap
        under the base cost guard alone, so a plan pair whose outputs
        differ in the float low bits (the SCAN batch-64 flip) can follow
        the formed sizes freely — at the price of the strict bit-identity
        guarantee across such flips."""
        old = self._executables.get(name)
        if self.bit_guard_swaps and self._bit_guard and old is not None \
                and program_fingerprint(
                    new_exe.program) != program_fingerprint(old.program):
            from ..runtime.batch import program_has_updates
            if not (program_has_updates(old.program)
                    or program_has_updates(new_exe.program)):
                # no observed bindings yet (a context publish can precede
                # the program's first request) → probe with the program's
                # defaults; bindings the program can't run without are
                # skipped rather than guessed
                bindings = list(self._recent.get(name, ())) or [{}]
                for b in bindings:
                    try:
                        o = old.run(**b).outputs
                        n = new_exe.run(**b).outputs
                    except Exception:
                        continue
                    if o != n:
                        self.bit_vetoes += 1
                        self.swaps_rejected += 1
                        return
        super()._guarded_swap(name, new_exe)


class ClusterRuntime:
    """N shard workers fronted by a router and a deadline batch former."""

    requests_served = registry_counter()
    batches_formed = registry_counter()
    serve_cycles = registry_counter()

    def __init__(self, db, *, n_workers: int,
                 partition_keys: Optional[Mapping[str, str]] = None,
                 affinity: Optional[Mapping[str, str]] = None,
                 deadline_s: float = 0.01, max_batch: int = 64,
                 store=None, catalog=None, config=None,
                 context=None, tracer=None,
                 site_cache_entries: int = 4096,
                 site_cache_max_bytes: Optional[int] = None,
                 site_cache_ttl_s: Optional[float] = None,
                 site_cache_spill_dir: Optional[str] = None,
                 entry_max_bytes: Optional[int] = None,
                 publish_threshold: float = 1.5,
                 bit_guard_swaps: bool = True,
                 initial_batch_size: Optional[int] = None,
                 **worker_kw):
        """``db`` is a :class:`ShardedDatabase` (``n_workers`` must match
        its shard count) or a plain ``DatabaseServer`` to shard here using
        ``partition_keys``. ``store`` (path or PlanStore) is coerced ONCE
        and shared by every worker. ``affinity`` maps program name → the
        parameter whose binding routes it (see :class:`Router`).
        ``initial_batch_size`` sets the batch size workers COMPILE for at
        registration (default ``max_batch``); the formed-size publishing
        then retargets it to whatever the former actually makes.
        Remaining keyword arguments pass through to each
        :class:`ShardWorker`."""
        if isinstance(db, ShardedDatabase):
            if db.n_shards != n_workers:
                raise ValueError(
                    f"db has {db.n_shards} shards but n_workers={n_workers}"
                    " — one worker per shard")
            self.db = db
        else:
            self.db = ShardedDatabase.shard(db, n_workers,
                                            keys=partition_keys,
                                            tracer=tracer)
        self.n_workers = n_workers
        self.tracer = tracer if tracer is not None else NOOP_TRACER
        self.metrics = MetricsRegistry()
        self.router = Router(n_workers, affinity)
        self.former = BatchFormer(deadline_s=deadline_s, max_batch=max_batch)
        if store is not None:
            from ..runtime.store import PlanStore
            store = PlanStore.coerce(store)
        self.store = store
        self.workers: List[ShardWorker] = []
        for w in range(n_workers):
            session = CobraSession(self.db, catalog=catalog, config=config,
                                   context=context, tracer=self.tracer)
            spill = None
            if site_cache_spill_dir is not None:
                spill = os.path.join(site_cache_spill_dir, f"w{w}")
            cache = SiteCache(ttl_s=site_cache_ttl_s,
                              max_entries=site_cache_entries,
                              max_bytes=site_cache_max_bytes,
                              entry_max_bytes=entry_max_bytes,
                              spill_dir=spill)
            self.workers.append(ShardWorker(
                session, w, publish_threshold=publish_threshold,
                bit_guard_swaps=bit_guard_swaps, store=store,
                batch_size=initial_batch_size or max_batch,
                site_cache=cache, context=context, tracer=self.tracer,
                **worker_kw))
        self._programs: Dict[str, Program] = {}
        self.requests_served = 0
        self.batches_formed = 0
        self.serve_cycles = 0
        self.last_makespan_s = 0.0
        self._busy = [0.0] * n_workers

    # ---------------------------------------------------------- registration
    def register(self, program: Program, name: Optional[str] = None,
                 affinity_param: Optional[str] = None):
        """Register a program on EVERY worker (the shared plan store makes
        the first worker's search warm-start the rest). ``affinity_param``
        optionally declares the binding the router should place it by."""
        name = name or program.name
        self._programs[name] = program
        if affinity_param is not None:
            self.router.affinity[name] = affinity_param
        exes = [w.register(program, name) for w in self.workers]
        return exes[0]

    # --------------------------------------------------------------- serving
    def serve(self, requests: Iterable[Tuple[str, Mapping[str, object]]],
              arrivals: Optional[Sequence[float]] = None) -> List[object]:
        """Route, form, and execute a request stream; returns one result
        per request in the original stream order. ``arrivals`` optionally
        gives each request's arrival time (default: all at t=0, which
        flushes full batches immediately)."""
        todo = list(requests)
        if arrivals is not None and len(arrivals) != len(todo):
            raise ValueError("arrivals must match the request count")
        routed = []
        for i, (name, params) in enumerate(todo):
            self.workers[0].executable(name)  # fail fast on unknown programs
            routed.append(Request(
                index=i, program=name, params=params,
                worker=self.router.route(name, params),
                arrival_s=arrivals[i] if arrivals is not None else 0.0))
        batches = self.former.form(routed)
        responses: List[Optional[object]] = [None] * len(todo)
        busy = list(self._busy)
        t0 = max(busy) if busy else 0.0
        with self.tracer.span("cluster_serve", n_requests=len(todo),
                              n_batches=len(batches)):
            for b in batches:
                worker = self.workers[b.worker]
                with self.tracer.span("flush", worker=b.worker,
                                      program=b.program, size=b.size,
                                      reason=b.reason):
                    result = worker.serve_formed(b)
                start = max(busy[b.worker], t0 + b.flush_s)
                busy[b.worker] = start + result.simulated_s
                self.metrics.observe("batch_service_s", result.simulated_s,
                                     worker=b.worker)
                for r, res in zip(b.requests, result.results):
                    responses[r.index] = res
                    self.metrics.observe(
                        "request_latency_s",
                        busy[b.worker] - (t0 + r.arrival_s))
                self.batches_formed += 1
        self._busy = busy
        self.requests_served += len(todo)
        self.serve_cycles += 1
        self.last_makespan_s = (max(busy) - t0) if todo else 0.0
        self.metrics.gauge("makespan_s", self.last_makespan_s)
        return responses

    # --------------------------------------------------------- observability
    def triage(self):
        """Cluster-wide triage: the union of every worker's fleet, ranked
        with per-shard request counts and hot-shard skew folded in."""
        from ..obs.triage import triage_cluster
        return triage_cluster(self)

    def worker_dump(self, w: int) -> Dict[str, Dict]:
        """One worker's structured metrics dump: its serving, session, and
        feedback registries (plus site-cache gauges) under stable
        prefixes — the unit :func:`combine_snapshots` folds."""
        rt = self.workers[w]
        reg = MetricsRegistry()
        reg.ingest(rt.metrics.dump(), prefix="serving_")
        reg.ingest(rt.session.metrics.dump(), prefix="session_")
        if rt.feedback is not None:
            reg.ingest(rt.feedback.metrics.dump(), prefix="feedback_")
        reg.ingest(rt.site_cache.stats(), prefix="site_cache_")
        if rt.compiler is not None:
            reg.ingest(rt.compiler.metrics.dump(), prefix="compiled_")
        return reg.dump()

    def metrics_dump(self) -> List[Dict[str, Dict]]:
        """Per-worker structured dumps, in worker order."""
        return [self.worker_dump(w) for w in range(self.n_workers)]

    def metrics_snapshot(self) -> Dict[str, object]:
        """One flat snapshot: the cluster's own registry (router / former /
        shard-database stats ingested as gauges) plus the per-worker
        registries AGGREGATED via :func:`combine_snapshots` — counters in
        the ``workers_`` section are exact sums of the per-worker values."""
        self.metrics.ingest(self.router.stats_dict(), prefix="router_")
        self.metrics.ingest(self.former.stats_dict(), prefix="former_")
        self.metrics.ingest(self.db.stats_dict(), prefix="db_")
        combined = combine_snapshots(*self.metrics_dump())
        agg = MetricsRegistry()
        agg.ingest(combined)
        return merge_snapshots(cluster=self.metrics.snapshot(),
                               workers=agg.snapshot())

    def telemetry(self) -> Dict[str, object]:
        t = {"n_workers": self.n_workers,
             "requests_served": self.requests_served,
             "batches_formed": self.batches_formed,
             "makespan_s": self.last_makespan_s,
             "programs": sorted(self._programs)}
        t.update({f"router_{k}": v for k, v in
                  self.router.stats_dict().items()})
        t.update({f"former_{k}": v for k, v in
                  self.former.stats_dict().items()})
        t.update({f"db_{k}": v for k, v in self.db.stats_dict().items()})
        t["worker_requests"] = [w.requests_served for w in self.workers]
        t["worker_batches"] = [w.batches_run for w in self.workers]
        t["worker_simulated_s"] = [w.simulated_s for w in self.workers]
        return t

    def explain(self, name: str, worker: int = 0) -> str:
        return self.workers[worker].explain(name)
