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

``params_to_numpy`` is its inverse, and ``opt_state_from_numpy`` /
``opt_state_to_numpy`` carry an optimizer's state both ways (AdamW's
``{"m", "v"}``, trees like the parameters; Adafactor's ``{"slots"}``, kept
in the reference's stacked layout by the port too), so a reference
checkpoint loads into the port and the port writes the reference's
layout. :func:`reference_leaves` and :func:`restack` are the map between
the two layouts that the port's optimizers and checkpointer share: a
stack's leaf is one reference leaf, its per-layer tensors in layer order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from .relational.database import DatabaseServer
from .relational.table import Field, Schema, Table, resolve_device

__all__ = ["database_from_numpy", "params_from_numpy", "params_to_numpy",
           "opt_state_from_numpy", "opt_state_to_numpy", "reference_leaves",
           "restack", "tensor_to_numpy"]

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


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host array of its type; bf16 widened to float32 (numpy
    has no bf16; the widening is exact). Always a copy, on the CPU too (a
    CPU tensor's ``.numpy()`` shares its memory), so the array is a
    snapshot that later in-place updates of the tensor leave alone."""
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dtype, copy=True).numpy()


def reference_leaves(tree, prefix: Tuple[str, ...] = ()
                     ) -> Dict[Tuple[str, ...], Tuple[List[torch.Tensor], bool]]:
    """The reference's leaves of a port tree, by key path: a plain leaf as
    ``([tensor], False)``; each leaf of a stack (a list of per-layer
    dictionaries, the reference's leading layer axis) as ``(its per-layer
    tensors in layer order, True)``. Paths follow the dictionaries' own
    order."""
    out: Dict[Tuple[str, ...], Tuple[List[torch.Tensor], bool]] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(reference_leaves(v, prefix + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        layers = [reference_leaves(e) for e in tree]
        for path in (layers[0] if layers else {}):
            out[prefix + path] = ([lay[path][0][0] for lay in layers], True)
    else:
        out[prefix] = ([tree], False)
    return out


def restack(template, values: Mapping[Tuple[str, ...], Any],
            prefix: Tuple[str, ...] = ()):
    """A tree shaped like the port tree ``template`` whose leaves come from
    ``values`` (keyed as :func:`reference_leaves` keys them): a plain
    leaf's value as it is, a stack's leaf's value split along its leading
    axis into the layers."""
    if isinstance(template, Mapping):
        return {k: restack(v, values, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [restack(e, {p[len(prefix):]: v[i]
                            for p, v in values.items()
                            if p[:len(prefix)] == prefix})
                for i, e in enumerate(template)]
    return values[prefix]


def _to_numpy_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    return tensor_to_numpy(tree)


def params_to_numpy(params: Mapping[str, Any], arch) -> dict:
    """The inverse of :func:`params_from_numpy`: the port's parameters as
    the reference's tree of host arrays, each stack (a list of per-layer
    dictionaries) on a leading layer axis. bf16 leaves come back as
    float32 arrays holding the same values (numpy has no bf16). A stack
    whose length is not the one ``arch`` gives it raises ``ValueError``."""
    out = {}
    for key, sub in params.items():
        if key in _STACKS:
            if len(sub) != _STACKS[key](arch):
                raise ValueError(f"params_to_numpy: {key!r} holds {len(sub)} "
                                 f"layers; {arch.name} has "
                                 f"{_STACKS[key](arch)}")
            leaves = reference_leaves(sub)
            stacked = {p: np.stack([tensor_to_numpy(t) for t in ts])
                       for p, (ts, _) in leaves.items()}
            out[key] = _nest(stacked)
        else:
            out[key] = _to_numpy_tree(sub)
    return out


def _nest(flat: Mapping[Tuple[str, ...], Any]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def opt_state_to_numpy(state: Mapping[str, Any], arch) -> dict:
    """An optimizer's state in the reference's layout: AdamW's ``m`` / ``v``
    through :func:`params_to_numpy`; Adafactor's ``slots`` (already
    stacked) as host arrays."""
    out = {}
    for key, sub in state.items():
        out[key] = _to_numpy_tree(sub) if key == "slots" \
            else params_to_numpy(sub, arch)
    return out


def opt_state_from_numpy(tree: Mapping[str, Any], arch, device=None) -> dict:
    """The reference's optimizer state (numpy leaves) -> the port's, on
    ``device`` (the card by default): AdamW's ``m`` / ``v`` through
    :func:`params_from_numpy`; Adafactor's ``slots`` keep their stacks."""
    dev = resolve_device(device)
    return {key: _convert(sub, dev) if key == "slots"
            else params_from_numpy(sub, arch, device=dev)
            for key, sub in tree.items()}
