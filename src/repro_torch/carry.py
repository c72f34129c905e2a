"""Carry data across from the host: numpy tables or parameters in.

``database_from_numpy`` builds the port's :class:`DatabaseServer` from plain
numpy tables, so any producer of columnar data — the reference package's
tables exported to numpy, a loader, a generator — feeds the port the very
same rows::

    tables = {"orders": ([("o_id", "int64", 8), ...], {"o_id": ids, ...})}
    db = database_from_numpy(tables, device="cuda")

``params_from_numpy`` turns a model's parameter tree, as numpy arrays with
each stack of layers on a leading (L, ...) axis (the reference package's
pytree layout), into the port's parameters, so the same weights give the
same logits::

    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    params = params_from_numpy(tree, arch, device="cuda")
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence, Tuple

import numpy as np
import torch

from .relational.database import DatabaseServer
from .relational.table import Field, Schema, Table, resolve_device

__all__ = ["database_from_numpy", "params_from_numpy"]

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


def _tensor(arr, device) -> torch.Tensor:
    """A host array as a tensor of the same element type on ``device``.
    bfloat16 arrays (numpy has no such type; JAX hands out ml_dtypes'
    ``bfloat16``) go across bit for bit as 16-bit words."""
    a = np.ascontiguousarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _unstack(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def _leading(tree) -> int:
    """The leading (layer) length of a stacked tree's leaves."""
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return int(np.shape(tree)[0])


def _convert(tree, device):
    if isinstance(tree, Mapping):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


# the reference's stacked sub-trees, and the length each has for an arch
_STACKS = {
    "layers": lambda a: a.n_layers - (a.n_dense_layers if a.moe else 0),
    "dense_layers": lambda a: a.n_dense_layers,
    "enc": lambda a: a.n_enc_layers,
    "dec": lambda a: a.n_dec_layers,
}


def params_from_numpy(tree: Mapping[str, Any], arch, device=None) -> dict:
    """The reference's parameter tree (numpy leaves; its stacks
    ``"layers"``, ``"dense_layers"``, ``"enc"`` and ``"dec"`` on a leading
    layer axis) -> the port's parameters, each stack a list of per-layer
    dictionaries (``shared_attn``, Zamba2's one shared block, stays one),
    on ``device`` (the card by default; ``device=None`` without CUDA
    raises). Every leaf keeps its dtype. A stack whose length is not the
    one ``arch`` gives it (an MoE model's ``layers`` holds ``n_layers -
    n_dense_layers``) raises ``ValueError``."""
    dev = resolve_device(device)
    out = {}
    for key, sub in tree.items():
        if key in _STACKS:
            n, want = _leading(sub), _STACKS[key](arch)
            if n != want:
                raise ValueError(f"params_from_numpy: {key!r} stacks {n} "
                                 f"layers; {arch.name} has {want}")
            out[key] = [_convert(_unstack(sub, i), dev) for i in range(n)]
        else:
            out[key] = _convert(sub, dev)
    return out
