"""Plain versions of the port's kernels, and the numpy twins.

  * torch plain versions — the CPU dispatch of every kernel wrapper, and
    what ``chip_smoke.py`` holds each CUDA kernel against on the card:
    :func:`build_direct_table_ref` and :func:`slot_gather_ref` (the
    ``join_probe`` build and probe), :func:`join_probe_ref` (the
    searchsorted probe ``ops.equi_probe`` takes without a key space) and
    :func:`segment_reduce_ref`, and for the LM kernels
    :func:`flash_attention_ref` (with its log-sum-exp),
    :func:`flash_attention_bwd_ref` (its gradients),
    :func:`rwkv6_scan_ref` and :func:`rwkv6_scan_bwd_ref` (its gradients);
  * numpy twins (``*_np``) — the ``"numpy"`` compiled backend, copied from
    the reference package.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["build_direct_table_ref", "slot_gather_ref", "join_probe_ref",
           "segment_reduce_ref", "flash_attention_ref",
           "flash_attention_bwd_ref", "rwkv6_scan_ref", "rwkv6_scan_bwd_ref",
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


def _attention_mask(Tq: int, Tk: int, causal: bool, window: Optional[int],
                    chunk: Optional[int], device) -> torch.Tensor:
    """(Tq, Tk) booleans, True where query i (at position Tk - Tq + i) may
    see key j: the kernels' causal / window / chunk masks."""
    qpos = torch.arange(Tq, device=device)[:, None] + (Tk - Tq)
    kpos = torch.arange(Tk, device=device)[None, :]
    m = torch.ones((Tq, Tk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    if chunk is not None:
        m &= torch.div(kpos, chunk, rounding_mode="floor") == \
            torch.div(qpos, chunk, rounding_mode="floor")
    return m


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        chunk: Optional[int] = None,
                        scale: Optional[float] = None,
                        return_lse: bool = False):
    """q (B,H,Tq,hd), k (B,KV,Tk,hd), v (B,KV,Tk,hdv), GQA broadcast, fp32
    softmax; the queries sit at the tail of the keys. A row with every key
    masked gives 0 (softmax over -inf is NaN, set to 0), as the kernel's
    max(l, 1e-30) does. Returns (B,H,Tq,hdv) in q's type (hdv = hd but for
    MLA, whose v head is narrower); with ``return_lse`` also each row's
    log-sum-exp of its scaled scores, fp32 (B,H,Tq) (+inf for a row with
    every key masked, so that exp(s - lse) is 0 there), which the backward
    reads."""
    B, H, Tq, hd = q.shape
    KV, Tk = k.shape[1], k.shape[2]
    rep = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.reshape(B, KV, rep, Tq, hd).float()
    scores = torch.einsum("bkrqh,bksh->bkrqs", qf, k.float()) * scale
    m = _attention_mask(Tq, Tk, causal, window, chunk, q.device)
    scores.masked_fill_(~m, float("-inf"))
    lse = None
    if return_lse:
        lse = torch.logsumexp(scores, dim=-1).reshape(B, H, Tq)
        lse = torch.where(torch.isneginf(lse), torch.full_like(lse, math.inf),
                          lse)
    p = torch.softmax(scores, dim=-1)
    del scores
    # in place only where autograd does not need softmax's output
    p = p.nan_to_num(nan=0.0) if p.requires_grad else p.nan_to_num_(nan=0.0)
    out = torch.einsum("bkrqs,bksh->bkrqh", p, v.float())
    out = out.reshape(B, H, Tq, v.shape[-1]).to(q.dtype)
    return (out, lse) if return_lse else out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, causal: bool = True,
                            window: Optional[int] = None,
                            chunk: Optional[int] = None,
                            scale: Optional[float] = None):
    """The gradients of :func:`flash_attention_ref` from its saved output
    ``o`` and log-sum-exp ``lse`` (B,H,Tq), given the output's gradient
    ``do``: the standard formulas, in fp32::

        D  = rowsum(dO * O)            P  = exp(S * scale - lse)
        dV = P^T dO                    dS = P * (dO V^T - D)
        dQ = dS K * scale              dK = dS^T Q * scale

    under the forward's masks, each GQA group's heads summed into its K/V
    head. Returns (dq, dk, dv) in q's, k's and v's types. The plain version
    beside the ``flash_attention_bwd`` kernel."""
    B, H, Tq, hd = q.shape
    KV, Tk, hdv = k.shape[1], k.shape[2], v.shape[3]
    rep = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.reshape(B, KV, rep, Tq, hd).float()
    kf, vf = k.float(), v.float()
    dof = do.reshape(B, KV, rep, Tq, hdv).float()
    delta = (dof * o.reshape(B, KV, rep, Tq, hdv).float()).sum(-1)
    s = torch.einsum("bkrqh,bksh->bkrqs", qf, kf) * scale
    m = _attention_mask(Tq, Tk, causal, window, chunk, q.device)
    p = torch.exp(s - lse.reshape(B, KV, rep, Tq, 1).float())
    del s
    p.masked_fill_(~m, 0.0)
    dv = torch.einsum("bkrqs,bkrqh->bksh", p, dof)
    ds = torch.einsum("bkrqh,bksh->bkrqs", dof, vf)
    ds.sub_(delta[..., None]).mul_(p)
    del p
    dq = torch.einsum("bkrqs,bksh->bkrqh", ds, kf) * scale
    dk = torch.einsum("bkrqs,bkrqh->bksh", ds, qf) * scale
    return (dq.reshape(B, H, Tq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def rwkv6_scan_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w_log: torch.Tensor, u: torch.Tensor,
                       state: Optional[torch.Tensor], dy: torch.Tensor,
                       ds_out: Optional[torch.Tensor]):
    """The gradients of :func:`rwkv6_scan_ref` given ``dy`` (B,H,T,V) on y
    and ``ds_out`` (B,H,K,V) on the final state (zeros when None), as a
    reverse sequential recurrence in fp32. With G_T = ds_out and
    G_{t-1} = diag(exp w_t) G_t + r_t (x) dy_t::

        dr_t = S_{t-1} dy_t + (u * k_t)(v_t . dy_t)
        dk_t = G_t v_t + (u * r_t)(v_t . dy_t)
        dv_t = G_t^T k_t + (sum_k r_t u k_t) dy_t
        dw_t = exp(w_t) * sum_v (S_{t-1} * G_t)
        du = sum_{b,t} (r_t * k_t)(v_t . dy_t)        (H, K)
        dstate = G_0

    Returns (dr, dk, dv in r's type; dw_log, du, dstate fp32). The plain
    version beside the ``rwkv6_scan_bwd`` kernel."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, wf, dyf = (x.float() for x in (r, k, v, w_log, dy))
    uf = u.float()
    S = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device) \
        if state is None else state.float()
    states = []                          # S_{t-1} for each t
    for t in range(T):
        states.append(S)
        S = S * torch.exp(wf[:, :, t])[..., None] \
            + kf[:, :, t, :, None] * vf[:, :, t, None, :]
    G = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device) \
        if ds_out is None else ds_out.float()
    vd = (vf * dyf).sum(-1)                                  # (B, H, T)
    bonus = (rf * uf[:, None] * kf).sum(-1)                  # (B, H, T)
    dr, dk, dv, dw = (torch.zeros_like(x) for x in (rf, kf, vf, wf))
    for t in range(T - 1, -1, -1):
        d = torch.exp(wf[:, :, t])
        dr[:, :, t] = torch.einsum("bhkv,bhv->bhk", states[t], dyf[:, :, t]) \
            + uf * kf[:, :, t] * vd[:, :, t, None]
        dk[:, :, t] = torch.einsum("bhkv,bhv->bhk", G, vf[:, :, t]) \
            + uf * rf[:, :, t] * vd[:, :, t, None]
        dv[:, :, t] = torch.einsum("bhkv,bhk->bhv", G, kf[:, :, t]) \
            + bonus[:, :, t, None] * dyf[:, :, t]
        dw[:, :, t] = d * (states[t] * G).sum(-1)
        G = d[..., None] * G + rf[:, :, t, :, None] * dyf[:, :, t, None, :]
    du = (rf * kf * vd[..., None]).sum((0, 2))
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw, du, G)


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
