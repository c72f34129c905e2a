"""Sharding policies: logical-name → partition spec rules + param spec trees.

The port of ``repro.launch.sharding``. A ``MeshPolicy`` is what the Cobra
distributed planner emits: activation rules (consumed by ``pol.cs`` inside
the layers), a parameter-sharding strategy, a remat policy, and
microbatching. Divisibility is always checked — a rule that does not
divide a concrete dimension is dropped for that tensor (e.g. 8 KV heads on
a 16-way model axis stay replicated).

Strategies:
  dp       pure data parallel (params replicated)
  fsdp     params sharded on ("pod","data") dim-0 (ZeRO-3 style)
  tp       Megatron tensor parallel on "model" (heads / ffn / vocab / experts)
  fsdp_tp  both — the production default
  *_sp     + sequence parallelism: long-context activations/KV shard the
           sequence dim on "data"

A spec is a :class:`P`, as the reference's ``PartitionSpec``: one entry per
tensor dim, each None, a mesh axis name or a tuple of names; every spec
function returns the reference's spec. The mesh is a ``DeviceMesh``
(``launch.mesh``). :func:`placements` turns a spec into DTensor placements,
one per mesh dim: ``Shard(d)`` where the spec names that mesh dim for
tensor dim d, ``Replicate()`` elsewhere.

The port's layer stacks are lists, one dictionary a layer, where the
reference stacks each leaf on a leading layer axis and spots a stacked
leaf by its leading size (``param_specs``' layer counts). The port gives a
list element its unstacked spec directly; the reference's heuristic runs
only on leaves outside lists (Adafactor's slots keep the stacked layout).

``MeshPolicy`` has the reference's fields but ``use_kernels``: the port's
kernels run whenever a tensor is on the card, and no policy switches them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from ..models.arch import ArchConfig

__all__ = ["MeshPolicy", "make_policy", "param_specs", "batch_specs",
           "cache_specs", "named_sharding", "NamedSharding", "placements",
           "distribute_tree", "STRATEGIES", "P"]

STRATEGIES = ("dp", "fsdp", "tp", "fsdp_tp", "tp_sp", "fsdp_tp_sp",
              "fsdp_tp_ep")
# fsdp_tp_ep: like fsdp_tp, but MoE expert weights are FULLY owned by their
# (expert-on-model × ffn-on-data) shard — no per-layer weight regather; the
# contraction instead reduces the (E/16, C, d) activation buffer over data,
# which is ~14× smaller than the expert weights for kimi-k2 (§Perf).


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _sizes(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes(mesh: DeviceMesh):
    names = mesh.mesh_dim_names
    data = tuple(n for n in ("pod", "data") if n in names)
    data = data if len(data) > 1 else (data[0] if data else None)
    model = "model" if "model" in names else None
    return data, model


def _divisible(shape, spec, mesh: DeviceMesh) -> P:
    """Drop spec axes that don't divide the corresponding dim."""
    sizes = _sizes(mesh)

    def axis_size(entry):
        if entry is None:
            return 1
        if isinstance(entry, (tuple, list)):
            n = 1
            for e in entry:
                n *= sizes[e]
            return n
        return sizes[entry]

    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is not None and dim % axis_size(entry) == 0:
            out.append(entry)
        else:
            out.append(None)
    return P(*out)


def placements(spec: P, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """The DTensor placements of ``spec``: ``Shard(d)`` on each mesh dim
    that entry d names, ``Replicate()`` on the others. The names of one
    multi-axis entry must come in mesh-dim order (DTensor shards a tensor
    dim by its mesh dims left to right, as ``("pod", "data")`` reads)."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is out of the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass
class MeshPolicy:
    mesh: DeviceMesh
    strategy: str = "fsdp_tp"
    remat: str = "none"            # none | full | dots | dots_no_batch
    seq_shard: bool = False        # sequence parallelism (long context)
    microbatch: int = 1
    unroll_layers: bool = False   # moot: the port's layer loops are unrolled
    rules: Dict[str, P] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.rules:
            self.rules = default_activation_rules(self.mesh, self.strategy,
                                                  self.seq_shard)

    def cs(self, x, name: str):
        """The sharding constraint: a DTensor redistributed to the rule's
        placements (after ``_divisible``); a plain tensor unchanged."""
        spec = self.rules.get(name)
        if spec is None or not isinstance(x, DTensor):
            return x
        spec = _divisible(x.shape, spec, self.mesh)
        return x.redistribute(self.mesh, placements(spec, self.mesh))

    def describe(self) -> dict:
        return {"strategy": self.strategy, "remat": self.remat,
                "seq_shard": self.seq_shard, "microbatch": self.microbatch,
                "unroll_layers": self.unroll_layers}


def default_activation_rules(mesh: DeviceMesh, strategy: str,
                             seq_shard: bool) -> Dict[str, P]:
    data, model = _axes(mesh)
    tp = model if "tp" in strategy or strategy == "fsdp_tp" else None
    if seq_shard:
        # long-context: batch=1 → put data axis on sequence instead
        return {
            "act_btd": P(None, data, None),
            "act_btf2": P(None, data, tp),
            "act_bthd": P(None, data, tp, None),
            "act_btkd": P(None, data, None, None),
            "logits": P(None, data, tp),
            "moe_ecd": P(tp, None, None),
            "kv_seq": P(None, None, data, None, None),
        }
    return {
        "act_btd": P(data, None, None),
        "act_btf2": P(data, None, tp),
        "act_bthd": P(data, None, tp, None),
        "act_btkd": P(data, None, tp, None),
        "logits": P(data, None, tp),
        "moe_ecd": P(tp, None, None),
        "kv_seq": P(None, data, None, None, None),
    }


def make_policy(mesh: DeviceMesh, strategy: str = "fsdp_tp",
                remat: str = "none", seq_shard: bool = False,
                microbatch: int = 1, unroll_layers: bool = False
                ) -> MeshPolicy:
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy {strategy!r} not in {STRATEGIES}")
    return MeshPolicy(mesh=mesh, strategy=strategy, remat=remat,
                      seq_shard="sp" in strategy or seq_shard,
                      microbatch=microbatch, unroll_layers=unroll_layers)


# --------------------------------------------------------------------------
# Parameter sharding
# --------------------------------------------------------------------------

_TP_RULES = [
    # (path regex, spec builder over (data, model)) — specs are for the
    # UNSTACKED tensor; a leading scan/layer dim gets None prepended.
    (r"\btok$",      lambda d, m: P(m, None)),        # vocab-sharded embed
    (r"\bunembed$",  lambda d, m: P(None, m)),
    (r"\bwq$|\bwk$|\bwv$|\bwq_b$|\bwkv_b$", lambda d, m: P(None, m)),
    (r"\bwo$",       lambda d, m: P(m, None)),
    (r"\bw_in$",     lambda d, m: P(None, m)),        # mlp gate+up
    (r"\bw_out$",    lambda d, m: P(m, None)),
    (r"\brouter$",   lambda d, m: P(None, None)),
    (r"moe.*w_in$",  lambda d, m: P(m, None, None)),  # experts on model (EP)
    (r"moe.*w_out$", lambda d, m: P(m, None, None)),
    (r"\bwr$|\bwk$|\bwv$|\bwg$", lambda d, m: P(None, m)),   # rwkv
    (r"\bcm_k$",     lambda d, m: P(None, m)),
    (r"\bcm_v$",     lambda d, m: P(m, None)),
]


def _spec_for(path: str, shape, data, model, strategy: str,
              stacked: bool) -> P:
    spec = P()
    base_shape = shape[1:] if stacked else shape
    is_moe_w = re.search(r"moe.*w_(in|out)$", path) is not None
    if "ep" in strategy and model is not None and is_moe_w:
        # full expert ownership: (E on model, ffn on data) — no regather
        spec = P(model, None, data) if path.endswith("w_in") \
            else P(model, data, None)
        entries = list(tuple(spec) + (None,) * (len(base_shape) - len(spec)))
        if stacked:
            entries = [None] + entries
        return P(*entries)
    if "tp" in strategy and model is not None:
        for pat, builder in _TP_RULES:
            if re.search(pat, path):
                spec = builder(data, model)
                break
    entries = list(tuple(spec) + (None,) * (len(base_shape) - len(spec)))
    if "fsdp" in strategy and data is not None:
        # ZeRO-3: shard the largest still-unsharded dim on the data axis
        order = sorted(range(len(base_shape)), key=lambda i: -base_shape[i])
        for i in order:
            if entries[i] is None:
                entries[i] = data
                break
    if stacked:
        entries = [None] + entries
    return P(*entries)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(params_tree, cfg: ArchConfig, mesh: DeviceMesh,
                strategy: str = "fsdp_tp"):
    """Spec tree matching the (possibly meta) param tree, or an optimizer
    state over it. A list element (one layer of a stack) gets its
    unstacked spec; a leaf outside lists is judged stacked, as the
    reference judges every leaf, when its leading dim is a layer count and
    its path is under a stack (Adafactor's stacked slots)."""
    data, model = _axes(mesh)
    layer_counts = {cfg.n_layers, cfg.n_enc_layers, cfg.n_dec_layers,
                    cfg.n_dense_layers, cfg.n_layers - cfg.n_dense_layers,
                    max(1, cfg.n_layers // max(1, cfg.hybrid_every or 1))}
    layer_counts.discard(0)

    def one(path, leaf):
        in_list = any(isinstance(k, int) for k in path)
        p = "/".join(str(k) for k in path if not isinstance(k, int))
        shape = tuple(leaf.shape)
        stacked = (not in_list and len(shape) >= 2
                   and shape[0] in layer_counts
                   and ("layers" in p or "enc" in p or "dec" in p))
        spec = _spec_for(p, shape, data, model, strategy, stacked)
        return _divisible(shape, spec, mesh)

    return _map_with_path(one, params_tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: DeviceMesh
    spec: P

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return placements(self.spec, self.mesh)

    def place(self, x: torch.Tensor) -> DTensor:
        """The full tensor ``x`` (the same on every rank) as a DTensor."""
        return distribute_tensor(x, self.mesh, self.placements)


def named_sharding(mesh: DeviceMesh, spec_tree):
    return _map_with_path(lambda _, s: NamedSharding(mesh, s), spec_tree)


def distribute_tree(mesh: DeviceMesh, spec_tree, tree):
    """Each leaf of ``tree`` (whole, the same on every rank) as a DTensor
    placed by its spec in ``spec_tree``."""
    if isinstance(tree, dict):
        return {k: distribute_tree(mesh, spec_tree[k], v)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute_tree(mesh, s, v) for s, v in zip(spec_tree, tree)]
    return NamedSharding(mesh, spec_tree).place(tree)


# --------------------------------------------------------------------------
# Batch / cache sharding
# --------------------------------------------------------------------------

def batch_specs(mesh: DeviceMesh, batch_tree, seq_shard: bool = False):
    """Batch dims shard on ("pod","data"); long-context (batch=1) shards the
    sequence dim instead."""
    data, model = _axes(mesh)

    def one(_, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return P()
        if seq_shard and len(shape) >= 2:
            spec = P(None, data)     # (B=1, T, ...) → shard T
        else:
            spec = P(data)
        return _divisible(shape, spec, mesh)

    return _map_with_path(one, batch_tree)


def cache_specs(mesh: DeviceMesh, cache_tree, seq_shard: bool = False):
    """KV caches: (L, B, S, ...) — batch on data AND sequence on model
    (flash-decode style: partial softmax over the S shards). long_500k
    (batch=1) shards S on data+model. State caches (ssm/wkv/shift) shard
    batch on data, heads on model."""
    data, model = _axes(mesh)
    seq_keys = ("k", "v", "xk", "xv", "lat", "rope")

    def one(path, leaf):
        name = str(path[-1])
        shape = tuple(leaf.shape)
        if name in seq_keys and len(shape) >= 3:
            if seq_shard:
                combined = (tuple(data) if isinstance(data, tuple)
                            else (data,)) + ((model,) if model else ())
                spec = P(None, None, combined)
            else:
                spec = P(None, data, model)
        elif len(shape) >= 3:                      # ssm/wkv states (L,B,H,..)
            spec = P(None, data, model)
        elif len(shape) == 2:
            spec = P(None, data)
        else:
            spec = P()
        return _divisible(shape, spec, mesh)

    return _map_with_path(one, cache_tree)

