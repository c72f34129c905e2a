"""Serving runtime: batched execution, persistent plans, feedback re-planning.

The subsystem that fronts :class:`~repro_torch.api.session.CobraSession` for
production-shaped workloads:

  * :mod:`repro_torch.runtime.batch` — ``run_batch`` / ``BatchClientEnv``: one
    server round trip per query site per batch of parameter bindings
    (``C_NRT`` amortization, the paper's batching transformation applied at
    the serving layer), write-set-aware for mutating programs;
  * :mod:`repro_torch.runtime.sitecache` — ``SiteCache``: the serving-scoped,
    epoch-keyed query-result cache shared across batches AND programs
    (serving-layer MQO), with TTL + analyze()/write invalidation and
    per-site binding-diversity observation;
  * :mod:`repro_torch.runtime.store` — ``PlanStore``: disk-backed,
    content-addressed plan cache shared across sessions/processes;
  * :mod:`repro_torch.runtime.feedback` — ``FeedbackController``: observed-vs-
    estimated cardinality drift triggers per-table re-analyze + recompile;
    observed iteration counts and binding-diversity fractions publish into
    the serving ExecutionContext;
  * :mod:`repro_torch.runtime.serving` — ``ServingRuntime`` / ``serve()``: the
    request loop wiring them together, including the compiled execution
    tier (:mod:`repro_torch.compiled`): a ``CompileManager`` promotes hot
    (program, plan, context) pairs to kernel-backed columnar executables
    after ``compile_hot_plans`` interpreted invocations.

``chip_smoke.py`` (phases ``serving`` and ``cluster``) drives the loop on the
card at TPC-DS SF1.
"""

from .batch import BatchClientEnv, BatchResult, program_has_updates, run_batch
from .feedback import DriftEvent, FeedbackController
from .serving import ServingRuntime, serve
from .sitecache import SiteCache, Uncacheable
from .store import PlanStore

__all__ = [
    "BatchClientEnv", "BatchResult", "run_batch", "program_has_updates",
    "SiteCache", "Uncacheable",
    "PlanStore", "DriftEvent", "FeedbackController",
    "ServingRuntime", "serve",
]
