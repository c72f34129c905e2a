"""Batched runtime: batched execution, the serving site cache, persistent plans.

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
    content-addressed plan cache shared across sessions/processes.

The serving loop and the feedback controller of the reference package
(``runtime/serving.py``, ``runtime/feedback.py``) are not ported yet.
"""

from .batch import BatchClientEnv, BatchResult, program_has_updates, run_batch
from .sitecache import SiteCache, Uncacheable
from .store import PlanStore

__all__ = [
    "BatchClientEnv", "BatchResult", "run_batch", "program_has_updates",
    "SiteCache", "Uncacheable", "PlanStore",
]
