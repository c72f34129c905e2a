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
"""

from __future__ import annotations

from typing import Dict, Optional

from . import ref
from .flash_attention import flash_attention, flash_attention_bwd
from .join_probe import build_direct_table, join_probe
from .rwkv6_scan import rwkv6_scan, rwkv6_scan_bwd
from .segment_reduce import segment_reduce

__all__ = ["segment_reduce", "equi_probe", "build_direct_table",
           "join_probe", "attention", "rwkv_scan", "launch_counts",
           "reset_launch_counts", "KERNELS"]

# every kernel wrapper with a launch count, by name
KERNELS = {"join_probe": join_probe,
           "build_direct_table": build_direct_table,
           "segment_reduce": segment_reduce,
           "flash_attention": flash_attention,
           "flash_attention_bwd": flash_attention_bwd,
           "rwkv6_scan": rwkv6_scan,
           "rwkv6_scan_bwd": rwkv6_scan_bwd}

MAX_DIRECT_KEY_SPACE = 1 << 22


def equi_probe(probe_keys, table_keys, key_space: Optional[int] = None):
    """Index of each probe key's match in table_keys (-1 if absent)."""
    if key_space is not None and key_space <= MAX_DIRECT_KEY_SPACE:
        table = build_direct_table(table_keys, key_space)
        return join_probe(probe_keys, table)
    return ref.join_probe_ref(probe_keys, table_keys)


def attention(q, k, v, causal: bool = True, window: Optional[int] = None,
              chunk: Optional[int] = None, scale: Optional[float] = None):
    """q (B,H,Tq,hd), k (B,KV,Tk,hd), v (B,KV,Tk,hdv) with hdv <= hd ->
    (B,H,Tq,hdv); queries at the tail."""
    return flash_attention(q, k, v, causal=causal, window=window, chunk=chunk,
                           scale=scale)


def rwkv_scan(r, k, v, w_log, u, state=None):
    """r/k/w_log (B,H,T,K), v (B,H,T,V), u (H,K) -> (y, final fp32 state)."""
    return rwkv6_scan(r, k, v, w_log, u, state=state)


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
