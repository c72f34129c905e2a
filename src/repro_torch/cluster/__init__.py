"""Sharded multi-worker serving cluster.

The serving tier above :mod:`repro_torch.runtime`: a
:class:`~repro_torch.cluster.database.ShardedDatabase` partitions the data plane
across N shards with bit-exact scatter-gather merges, and a
:class:`~repro_torch.cluster.runtime.ClusterRuntime` fronts N
:class:`~repro_torch.cluster.runtime.ShardWorker`\\ s with a deterministic
:class:`~repro_torch.cluster.router.Router` and a deadline-driven
:class:`~repro_torch.cluster.router.BatchFormer`. See each module's docstring
for the invariants; the headline one: cluster serving is bit-identical to
single-worker serving for every example program.
"""

from .database import ShardedDatabase
from .partition import GPOS, Partitioner, strip_gpos
from .router import BatchFormer, FormedBatch, Request, Router, \
    uniform_arrivals
from .runtime import ClusterRuntime, ShardWorker

__all__ = [
    "ShardedDatabase", "Partitioner", "GPOS", "strip_gpos",
    "Router", "BatchFormer", "Request", "FormedBatch", "uniform_arrivals",
    "ClusterRuntime", "ShardWorker",
]
