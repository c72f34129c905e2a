"""Carry a database across from host data: numpy tables in, a server out.

``database_from_numpy`` builds the port's :class:`DatabaseServer` from plain
numpy tables, so any producer of columnar data — the reference package's
tables exported to numpy, a loader, a generator — feeds the port the very
same rows::

    tables = {"orders": ([("o_id", "int64", 8), ...], {"o_id": ids, ...})}
    db = database_from_numpy(tables, device="cuda")
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np

from .relational.database import DatabaseServer
from .relational.table import Field, Schema, Table

__all__ = ["database_from_numpy"]

FieldSpec = Tuple[str, str, int]   # (name, dtype, wire bytes)


def database_from_numpy(
        tables: Mapping[str, Tuple[Sequence[FieldSpec], Mapping[str, np.ndarray]]],
        device=None, stats_config=None) -> DatabaseServer:
    """``{table: ([(field, dtype, wire_bytes), ...], {column: array})}`` ->
    a :class:`DatabaseServer` whose tables live on ``device`` (the card by
    default; ``device=None`` without CUDA raises). Columns are stored in the
    port's storage dtypes (64-bit narrows to 32-bit); statistics are
    computed from the host arrays, so they equal the producer's."""
    out = {}
    for name, (fields, cols) in tables.items():
        schema = Schema(tuple(Field(f, dt, wb) for f, dt, wb in fields))
        out[name] = Table(name, schema, {f.name: cols[f.name]
                                         for f in schema.fields},
                          device=device)
    return DatabaseServer(out, stats_config=stats_config, device=device)
