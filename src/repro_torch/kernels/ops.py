"""Public kernel entry points, dispatched on the tensor's device.

A CUDA tensor goes to the hand-written Hopper kernels (``join_probe``,
``build_direct_table``, ``segment_reduce``, ``flash_attention`` with its
backward ``flash_attention_bwd``, ``rwkv6_scan`` with its backward
``rwkv6_scan_bwd``); a CPU tensor to their
plain torch versions in :mod:`.ref`.
The reference package's off-by-default ``use_pallas`` switch has no
counterpart: on the card the kernels always run. ``equi_probe`` keeps the
reference's key-space gate — a direct-address table only for
``key_space <= 1 << 22``, the searchsorted plain version otherwise (and
whenever no ``key_space`` is given). ``attention`` and ``rwkv_scan`` keep
the reference's layouts, (B,H,T,hd) and (B,H,T,K/V); the reference's
``block_q``/``block_k`` (TPU tile shapes) and the scan's ``chunk`` are not
arguments, since the CUDA kernels pick their own tiles.

Under a mesh ``attention`` and ``rwkv_scan`` take DTensors and run the
kernel (or its plain version, on the CPU) on each rank's local shard:
attention and the scan are independent per (row, head), so a shard of
rows (batch) and of heads needs no collective. The shards kept are q's
(r's) own on the batch and head dims, where they divide the counts; any
other placement (the sequence, under sequence parallelism) is gathered
first. Where the query heads divide the axis and the KV heads do not (8
KV heads on 16 ranks), K/V come replicated and each rank slices the one
KV head its query heads read, as the reference's sharding of q alone
does; their gradients are then partial sums over the axis. No kernel
receives a DTensor.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)
from torch.distributed.tensor.experimental import local_map

from . import adamw, ref
from .flash_attention import flash_attention, flash_attention_bwd
from .join_probe import build_direct_table, join_probe
from .rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd
from .segment_reduce import segment_reduce

__all__ = ["segment_reduce", "equi_probe", "build_direct_table",
           "join_probe", "attention", "rwkv_scan", "launch_counts",
           "reset_launch_counts", "KERNELS", "fit_shards", "shard_start"]

# every kernel wrapper with a launch count, by name (``adamw`` is the
# module, whose ``launches`` counts both of its kernels' launches)
KERNELS = {"join_probe": join_probe,
           "build_direct_table": build_direct_table,
           "segment_reduce": segment_reduce,
           "flash_attention": flash_attention,
           "flash_attention_bwd": flash_attention_bwd,
           "rwkv6_scan": rwkv6_scan,
           "rwkv6_scan_bwd": rwkv6_scan_bwd,
           "adamw": adamw}

MAX_DIRECT_KEY_SPACE = 1 << 22


def equi_probe(probe_keys, table_keys, key_space: Optional[int] = None):
    """Index of each probe key's match in table_keys (-1 if absent)."""
    if key_space is not None and key_space <= MAX_DIRECT_KEY_SPACE:
        table = build_direct_table(table_keys, key_space)
        return join_probe(probe_keys, table)
    return ref.join_probe_ref(probe_keys, table_keys)


def fit_shards(x: DTensor, sizes: Dict[int, Sequence[int]]
               ) -> Tuple[Placement, ...]:
    """x's placements, each ``Shard(d)`` of a dim d in ``sizes`` kept while
    the shards so far divide every size listed for d and ``Replicate()``
    in its place otherwise (left to right, as DTensor nests the shards of
    one dim); the other placements as they are."""
    div = dict.fromkeys(sizes, 1)
    out = []
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim in sizes:
            n = div[p.dim] * x.device_mesh.size(i)
            if all(c % n == 0 for c in sizes[p.dim]):
                div[p.dim] = n
            else:
                p = Replicate()
        out.append(p)
    return tuple(out)


def shard_start(x: DTensor, dim: int) -> int:
    """The global index of this rank's first element of ``dim``, on which
    x is sharded evenly (its shards nested left to right)."""
    size, start = x.shape[dim], 0
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            size //= x.device_mesh.size(i)
            start += x.device_mesh.get_local_rank(i) * size
    return start


def _row_head_shards(x: DTensor, heads: Sequence[int]
                     ) -> Tuple[Placement, ...]:
    """x's placements kept where they shard its batch (dim 0) evenly, or
    its heads (dim 1) evenly for every head count in ``heads``;
    ``Replicate()`` on every other mesh dim."""
    fit = fit_shards(x, {0: (x.shape[0],), 1: tuple(heads)})
    return tuple(p if isinstance(p, Shard) and p.dim in (0, 1)
                 else Replicate() for p in fit)


def attention(q, k, v, causal: bool = True, window: Optional[int] = None,
              chunk: Optional[int] = None, scale: Optional[float] = None):
    """q (B,H,Tq,hd), k (B,KV,Tk,hd), v (B,KV,Tk,hdv) with hdv <= hd ->
    (B,H,Tq,hdv); queries at the tail."""
    kw = dict(causal=causal, window=window, chunk=chunk, scale=scale)
    if not isinstance(q, DTensor):
        return flash_attention(q, k, v, **kw)
    mesh, (H, KV) = q.device_mesh, (q.shape[1], k.shape[1])
    pl = _row_head_shards(q, (H,))
    n = math.prod(mesh.size(i) for i, p in enumerate(pl) if p == Shard(1))
    one_kv = KV % n != 0 and n % KV == 0
    if one_kv:                      # one KV head a rank: K/V replicated
        kv_pl = tuple(Replicate() if p == Shard(1) else p for p in pl)
        kv_grad = tuple(Partial() if p == Shard(1) else p for p in pl)
    else:
        if KV % n != 0:             # no even split: every head on each rank
            pl = _row_head_shards(q, (H, KV))
        kv_pl = kv_grad = pl        # the KV heads shard beside q's
    q = q.redistribute(mesh, pl)
    ql = q.to_local()
    kl, vl = (t.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
              for t in (k, v))
    if one_kv:
        j = shard_start(q, 1) * KV // H
        kl, vl = kl[:, j:j + 1], vl[:, j:j + 1]
    return DTensor.from_local(flash_attention(ql, kl, vl, **kw), mesh, pl,
                              run_check=False)


def rwkv_scan(r, k, v, w_log, u, state=None):
    """r/k/w_log (B,H,T,K), v (B,H,T,V), u (H,K) -> (y, final fp32 state)."""
    if not isinstance(r, DTensor):
        return rwkv6_scan(r, k, v, w_log, u, state=state)
    pl = _row_head_shards(r, (r.shape[1],))
    u_pl = tuple(Shard(0) if p == Shard(1) else Replicate() for p in pl)
    args, in_pl = [r, k, v, w_log, u], [pl, pl, pl, pl, u_pl]
    if state is not None:
        args.append(state)
        in_pl.append(pl)
    return local_map(rwkv6_scan, out_placements=(pl, pl),
                     in_placements=tuple(in_pl), device_mesh=r.device_mesh,
                     redistribute_inputs=True)(*args)


def launch_counts() -> Dict[str, int]:
    """CUDA launches per kernel wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Zero every wrapper's count (and the backward kernels' counts by
    body)."""
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in (flash_attention_bwd, rwkv6_scan_bwd):
        fn.launches_by_body = dict.fromkeys(fn.launches_by_body, 0)
