"""Horizontal partitioning of columnar tables across shards.

The :class:`Partitioner` is the cluster's data-placement policy, in the
spirit of the mesh + ``PartitionSpec`` idiom of the reference package's
``launch/sharding.py``: each table is either

  * **partitioned** — rows hashed to shards by one declared key column
    (``shard = int(key) % n_shards``, a deterministic modulo hash so tests
    and benchmarks can craft uniform or skewed placements on purpose), or
  * **replicated** — every shard holds a full copy (the small-dimension-
    table option: a join against a replicated table never crosses shards).

Partition tables carry a hidden provenance column ``__gpos`` — each row's
global position in the unsharded table — declared with ``wire_bytes=0`` so
row sizes, transfer charges, and the cost model are untouched by it.
``__gpos`` is what makes scatter-gather *ordered* merges exact: concat the
per-shard partials, stable-argsort by ``__gpos``, drop the column, and the
global result is bit-identical to the unsharded execution, row order
included. The column never escapes the cluster layer:
:class:`~repro_torch.cluster.database.ShardedDatabase` strips it from every
result it returns.

Placement is decided on the host: keys are read through the table's numpy
mirror (:meth:`~repro_torch.relational.table.Table.host`) and each
partition is a gather of host row indices, so shard contents and row order
do not depend on the device the table lives on.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..relational.table import Field, Table

__all__ = ["GPOS", "GPOS_FIELD", "Partitioner", "strip_gpos"]

# hidden provenance column on partition tables: global row position in the
# unsharded table; wire_bytes=0 keeps row_bytes (hence every simulated
# transfer and cost-model figure) identical to the unsharded schema
GPOS = "__gpos"
GPOS_FIELD = Field(GPOS, "int64", wire_bytes=0)


class Partitioner:
    """Deterministic row→shard placement: hash-partition by key column,
    replicate everything else."""

    def __init__(self, n_shards: int, keys: Optional[Mapping[str, str]] = None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = n_shards
        # table -> partition key column; tables not listed are replicated
        self.keys: Dict[str, str] = dict(keys or {})

    def key_column(self, table: str) -> Optional[str]:
        """The named table's partition key column, or None if replicated."""
        return self.keys.get(table)

    def shard_of(self, table: str, value) -> Optional[int]:
        """Owning shard of the rows with ``key == value`` (None when the
        table is replicated or the value has no integer identity)."""
        if table not in self.keys:
            return None
        try:
            return int(value) % self.n_shards
        except (TypeError, ValueError):
            return None

    def shard_assignment(self, t: Table) -> Optional[np.ndarray]:
        """Per-row shard ids for a partitioned table (None if replicated,
        or if the declared key column is absent — e.g. a program installed
        a fresh table under this name; such tables replicate)."""
        key = self.keys.get(t.name)
        if key is None or not t.schema.has(key):
            return None
        return t.host(key).astype(np.int64) % self.n_shards

    def split(self, t: Table) -> List[Table]:
        """The table's shard partitions, each carrying ``__gpos`` (the
        rows' global positions). Rows keep their relative order inside
        each partition, so a ``__gpos``-ordered merge of the partitions
        reconstructs the original table exactly."""
        shard = self.shard_assignment(t)
        if shard is None:
            raise ValueError(f"table {t.name!r} is not partitioned")
        out = []
        for k in range(self.n_shards):
            idx = np.flatnonzero(shard == k)
            out.append(t.take(idx).with_column(GPOS_FIELD, idx))
        return out

    def shard_tables(self, t: Table) -> List[Table]:
        """What each shard stores for this table: its partition (with
        ``__gpos``) when partitioned, the full table when replicated."""
        if self.shard_assignment(t) is None:
            return [t] * self.n_shards
        return self.split(t)

    def describe(self) -> str:
        parts = ", ".join(f"{t} by {c}" for t, c in sorted(self.keys.items()))
        return (f"Partitioner({self.n_shards} shard(s); "
                f"partitioned: {parts or 'none'}; others replicated)")


def strip_gpos(t: Table) -> Table:
    """Drop every provenance column (``__gpos``, or a join-renamed
    ``<table>___gpos``) from a result before it leaves the cluster layer."""
    keep = [c for c in t.schema.names if not c.endswith(GPOS)]
    if len(keep) == len(t.schema.names):
        return t
    return t.select_columns(keep)
