"""Plain versions of the port's kernels, and the numpy twins.

  * torch plain versions — the CPU dispatch of every kernel wrapper, and
    what ``chip_smoke.py`` holds each CUDA kernel against on the card:
    :func:`build_direct_table_ref` and :func:`slot_gather_ref` (the
    ``join_probe`` build and probe), :func:`join_probe_ref` (the
    searchsorted probe ``ops.equi_probe`` takes without a key space) and
    :func:`segment_reduce_ref`, and for the LM kernels
    :func:`flash_attention_ref` and :func:`rwkv6_scan_ref`;
  * numpy twins (``*_np``) — the ``"numpy"`` compiled backend, copied from
    the reference package.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["build_direct_table_ref", "slot_gather_ref", "join_probe_ref",
           "segment_reduce_ref", "flash_attention_ref", "rwkv6_scan_ref",
           "join_probe_np", "segment_reduce_np", "SEGMENT_OPS"]

SEGMENT_OPS = ("sum", "count", "min", "max")


def build_direct_table_ref(table_keys: torch.Tensor, key_space: int) -> torch.Tensor:
    """slot[j] = row index of build key j, else -1. With duplicate keys the
    smallest row index wins (the first stable match, as in
    :func:`join_probe_np`); keys outside [0, key_space) are skipped."""
    keys = table_keys.to(torch.int64)
    rows = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    ok = (keys >= 0) & (keys < key_space)
    slots = torch.full((key_space,), -1, dtype=torch.int32, device=keys.device)
    return slots.scatter_reduce_(0, keys[ok], rows[ok], reduce="amin",
                                 include_self=False)


def slot_gather_ref(probe_keys: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[key] when 0 <= key < len(table), else -1 (int32)."""
    m = table.shape[0]
    keys = probe_keys.to(torch.int64)
    if m == 0:
        return torch.full(keys.shape, -1, dtype=torch.int32, device=keys.device)
    valid = (keys >= 0) & (keys < m)
    got = table[keys.clamp(0, m - 1)]
    return torch.where(valid, got, torch.full_like(got, -1)).to(torch.int32)


def join_probe_ref(probe_keys: torch.Tensor, table_keys: torch.Tensor) -> torch.Tensor:
    """For each probe key: index of its match in table_keys (unique) or -1."""
    n = probe_keys.shape[0]
    dev = probe_keys.device
    if n == 0:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    if table_keys.shape[0] == 0:
        return torch.full((n,), -1, dtype=torch.int32, device=dev)
    dt = torch.promote_types(probe_keys.dtype, table_keys.dtype)
    probe_keys, table_keys = probe_keys.to(dt), table_keys.to(dt)
    order = torch.argsort(table_keys, stable=True)
    sk = table_keys[order]
    pos = torch.clamp(torch.searchsorted(sk, probe_keys), 0, len(order) - 1)
    idx = order[pos]
    found = table_keys[idx] == probe_keys
    return torch.where(found, idx, torch.full_like(idx, -1)).to(torch.int32)


def segment_reduce_ref(values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, op: str = "sum") -> torch.Tensor:
    """Per-segment sum/count/min/max as float32 (num_segments,).

    Sums and counts accumulate in float64 and round once, so the result does
    not depend on summation order: it is the order-free reference the
    kernel's fixed-order float32 sums are held to. Empty min/max segments
    give 0 (the TPU kernel's convention); ids outside [0, num_segments) are
    skipped."""
    if op not in SEGMENT_OPS:
        raise ValueError(op)
    dev = values.device
    vals = values.to(torch.float32)
    segs = segment_ids.to(torch.int64)
    ok = (segs >= 0) & (segs < num_segments)
    vals, segs = vals[ok], segs[ok]
    if op in ("sum", "count"):
        src = torch.ones_like(vals, dtype=torch.float64) if op == "count" \
            else vals.to(torch.float64)
        out = torch.zeros((num_segments,), dtype=torch.float64, device=dev)
        return out.index_add_(0, segs, src).to(torch.float32)
    fill = float("inf") if op == "min" else float("-inf")
    out = torch.full((num_segments,), fill, dtype=torch.float32, device=dev)
    out.scatter_reduce_(0, segs, vals, reduce="amin" if op == "min" else "amax",
                        include_self=True)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        chunk: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,Tq,hd), k (B,KV,Tk,hd), v (B,KV,Tk,hdv), GQA broadcast, fp32
    softmax; the queries sit at the tail of the keys. A row with every key
    masked gives 0 (softmax over -inf is NaN, set to 0), as the kernel's
    max(l, 1e-30) does. Returns (B,H,Tq,hdv) in q's type (hdv = hd but for
    MLA, whose v head is narrower)."""
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    rep = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.reshape(B, KV, rep, Tq, hd).float()
    scores = torch.einsum("bkrqh,bksh->bkrqs", qf, k.float()) * scale
    qpos = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
    kpos = torch.arange(Tk, device=q.device)[None, :]
    m = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    if chunk is not None:
        m &= torch.div(kpos, chunk, rounding_mode="floor") == \
            torch.div(qpos, chunk, rounding_mode="floor")
    scores.masked_fill_(~m, float("-inf"))
    p = torch.softmax(scores, dim=-1)
    del scores
    p.nan_to_num_(nan=0.0)
    out = torch.einsum("bkrqs,bksh->bkrqh", p, v.float())
    return out.reshape(B, H, Tq, v.shape[-1]).to(q.dtype)


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w_log: torch.Tensor, u: torch.Tensor,
                   state: Optional[torch.Tensor] = None):
    """The exact sequential WKV recurrence: r/k/w_log (B,H,T,K), v
    (B,H,T,V), u (H,K), state (B,H,K,V) fp32 (zeros when None). Returns
    (y (B,H,T,V) in r's type, final state fp32)."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    S = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device) \
        if state is None else state.float()
    uf = u.float()
    ys = []
    for t in range(T):
        rt, kt, vt = (x[:, :, t].float() for x in (r, k, v))
        bonus = (rt * uf * kt).sum(-1)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, S) + bonus[..., None] * vt)
        S = S * torch.exp(w_log[:, :, t].float())[..., None] \
            + kt[..., :, None] * vt[..., None, :]
    y = torch.stack(ys, dim=2) if ys else \
        torch.zeros((B, H, 0, V), dtype=torch.float32, device=r.device)
    return y.to(r.dtype), S


def join_probe_np(probe_keys, table_keys):
    """numpy twin of :func:`join_probe_ref` (the numpy compiled backend)."""
    probe_keys = np.asarray(probe_keys)
    table_keys = np.asarray(table_keys)
    n = probe_keys.shape[0]
    if n == 0:
        return np.zeros((0,), np.int32)
    if table_keys.shape[0] == 0:
        return np.full((n,), -1, np.int32)
    order = np.argsort(table_keys, kind="stable")
    sk = table_keys[order]
    pos = np.clip(np.searchsorted(sk, probe_keys), 0, len(order) - 1)
    idx = order[pos]
    found = table_keys[idx] == probe_keys
    return np.where(found, idx, -1).astype(np.int32)


def segment_reduce_np(values, segment_ids, num_segments: int, op: str = "sum"):
    """numpy twin of :func:`segment_reduce_ref`, with the kernel's
    empty-group convention for min/max (empty groups report 0)."""
    values = np.asarray(values, np.float32)
    segment_ids = np.asarray(segment_ids)
    if op == "count":
        values = np.ones_like(values)
        op = "sum"
    if op == "sum":
        out = np.zeros((num_segments,), np.float32)
        np.add.at(out, segment_ids, values)
        return out
    if op == "min":
        out = np.full((num_segments,), np.inf, np.float32)
        np.minimum.at(out, segment_ids, values)
    elif op == "max":
        out = np.full((num_segments,), -np.inf, np.float32)
        np.maximum.at(out, segment_ids, values)
    else:
        raise ValueError(op)
    return np.where(np.isfinite(out), out, 0.0).astype(np.float32)
