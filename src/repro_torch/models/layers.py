"""Model layers in PyTorch (params = dictionaries of tensors).

The port of ``repro.models.layers``, for every family of the reference:

  * GQA attention with RoPE or M-RoPE (Qwen2-VL), optional sliding window
    (SWA) and chunked local attention, and MLA (multi-head latent
    attention, MiniCPM3: the cache holds the latent, K/V are expanded from
    it), all through :func:`repro_torch.kernels.ops.attention` (the
    hand-written CUDA kernel on the card, its plain version on the CPU);
  * SwiGLU MLP, and MoE with top-k routing and the reference's
    capacity-based dispatch into an (E, C, d) buffer (the expert products
    are two batched matmuls, as in the reference, outside any kernel);
  * the RWKV6 time/channel mix, whose WKV recurrence goes through
    :func:`repro_torch.kernels.ops.rwkv_scan`, and Mamba2 (SSD, one decay
    per head), whose scan is the chunked :func:`decay_linear_attention`
    (the reference layer's own scan, a plain function on both devices:
    the reference has no kernel for it);
  * embeddings and the shared norm/linear primitives.

Parameters keep the reference's dtypes: matrices bf16 by default, the
norms, ``w0``, ``u``, the router and Mamba2's ``dt_bias`` / ``A_log`` /
``D`` fp32. Random initialisation takes an explicit ``torch.Generator``
(the reference's ``jax.random`` keys give other numbers;
``repro_torch.carry.params_from_numpy`` carries the reference's parameters
across instead).

Sharding: every layer takes a policy ``pol`` and calls ``pol.cs(x, name)``
at the reference's sites (a ``launch.sharding.MeshPolicy`` redistributes a
DTensor there to the rule named ``name``); :data:`NULL_POLICY` is the no-op
the reference uses on one device. Under a mesh the parameters and
activations are DTensors: a view that splits a sharded dim into (heads,
head dim) goes through :func:`split_heads`, and the kernels run on each
rank's local shard (``kernels.ops``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels import ops
from .arch import ArchConfig

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# Sharding policy hook
# --------------------------------------------------------------------------

class NullPolicy:
    """No-op policy (single device / tests)."""

    def cs(self, x, name: str):
        return x

    remat: str = "none"


NULL_POLICY = NullPolicy()


def split_heads(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.view(*shape)``, a view that splits x's last dim into (heads,
    head dim). DTensor cannot view a dim sharded over more ranks than the
    heads divide (2 KV heads on a 4-way axis; XLA reshards such a view
    silently), so a DTensor is first replicated on each mesh dim that would
    split a head: the placement that ``_divisible`` allows after the view."""
    if isinstance(x, DTensor):
        pl = ops.fit_shards(x, {x.ndim - 1: (shape[-2],)})
        if pl != tuple(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.view(*shape)


def write_slots(cache: torch.Tensor, idx: int, x: torch.Tensor) -> None:
    """``cache[:, idx:idx + T] = x`` in place: cache (B, S, ...), x (B, T,
    ...). A DTensor cache whose slots are sharded (``cache_specs`` puts S on
    the model axis) is written on each rank's own slots: DTensor cannot
    write in place through a slice of a sharded dim."""
    T = x.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, idx:idx + T].copy_(x)
        return
    mesh, pl = cache.device_mesh, cache.placements
    start = ops.shard_start(cache, 1)
    x_pl = tuple(Replicate() if p.is_shard(1) or p.is_partial() else p
                 for p in pl)

    def write(c, xl):
        lo, hi = max(idx, start), min(idx + T, start + c.shape[1])
        if lo < hi:
            c[:, lo - start:hi - start].copy_(xl[:, lo - idx:hi - idx])
    local_map(write, out_placements=None, in_placements=(tuple(pl), x_pl),
              device_mesh=mesh, redistribute_inputs=True)(cache, x)


# --------------------------------------------------------------------------
# Primitives
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)
    return (y * w).to(dt)


def init_rms(d: int, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Normal(0, 1/sqrt(fan_in)) (or ``scale``), drawn in fp32 from ``gen``
    on ``device`` (the generator's own device when None), cast to dtype.
    A stack of matrices (MoE's experts) is drawn one matrix at a time, so
    the fp32 draw never holds more than one (kimi-k2's 384 experts are
    22.5 GB of bf16 a projection)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    device = gen.device if device is None else device
    if len(shape) > 2:
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = dense_init(gen, shape[1:], s, dtype, device)
        return out
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (x * s).to(dtype)


def act_fn(kind: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[kind]


# --------------------------------------------------------------------------
# RoPE / M-RoPE
# --------------------------------------------------------------------------

def rope_freqs(hd_rot: int, theta: float = 1e4, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd_rot, 2, dtype=torch.float32,
                                         device=device) / hd_rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4,
               mrope_sections: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """x: (B, T, H, hd). positions: (B, T), or (B, T, 3) for M-RoPE.

    M-RoPE (Qwen2-VL): the rotary half-dims are split into sections, each
    rotated by its own position stream (temporal / height / width). For text
    tokens the three streams coincide."""
    B, T, H, hd = x.shape
    half = hd // 2
    freqs = rope_freqs(hd, theta, device=x.device)            # (half,)
    if mrope_sections is None:
        ang = positions[..., None].float() * freqs             # (B,T,half)
    else:
        if positions.ndim != 3 or positions.shape[-1] != len(mrope_sections):
            raise ValueError(f"M-RoPE needs (B, T, {len(mrope_sections)}) "
                             f"positions, got {tuple(positions.shape)}")
        parts, start = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(positions[..., i:i + 1].float()
                         * freqs[start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)                          # (B,T,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin,
                      x2f * cos + x1f * sin], dim=-1).to(x.dtype)


def default_mrope_sections(hd: int) -> Tuple[int, int, int]:
    half = hd // 2
    a = half // 4
    return (half - 2 * a, a, a)  # e.g. hd=128 -> (32,16,16)


# --------------------------------------------------------------------------
# Attention (GQA + SWA/chunked) and MLA
# --------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.attn_kind == "mla":
        qr = cfg.q_lora_rank or d
        kvr = cfg.kv_lora_rank or d
        qk_dim = cfg.qk_rope_dim + cfg.qk_nope_dim
        dev = gen.device
        return {
            "wq_a": dense_init(gen, (d, qr)),
            "q_norm": init_rms(qr, device=dev),
            "wq_b": dense_init(gen, (qr, H * qk_dim)),
            "wkv_a": dense_init(gen, (d, kvr + cfg.qk_rope_dim)),
            "kv_norm": init_rms(kvr, device=dev),
            "wkv_b": dense_init(gen, (kvr, H * (cfg.qk_nope_dim + cfg.vhd))),
            "wo": dense_init(gen, (H * cfg.vhd, d)),
        }
    return {
        "wq": dense_init(gen, (d, H * hd)),
        "wk": dense_init(gen, (d, KV * hd)),
        "wv": dense_init(gen, (d, KV * hd)),
        "wo": dense_init(gen, (H * hd, d)),
    }


def _attn_mask(Tq: int, Tk: int, q_offset: int, causal: bool,
               window: Optional[int], chunk: Optional[int], device=None):
    """(Tq, Tk) boolean mask. q position i attends k position j."""
    qpos = q_offset + torch.arange(Tq, device=device)[:, None]
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


def sdpa(q, k, v, mask=None, scale=None, pol=NULL_POLICY):
    """q: (B,Tq,H,hd) k/v: (B,Tk,KV,hd[v]); GQA broadcast; fp32 softmax;
    masked scores -1e30. The plain reference of what attention_gqa computes
    through the kernel (the reference layer calls this directly)."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qh = q.reshape(B, Tq, KV, rep, hd)
    scores = torch.einsum("bqkrh,bskh->bkrqs", qh.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask[None, None, None], scores,
                             torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqs,bskh->bqkrh", p, v.float())
    return out.reshape(B, Tq, H, v.shape[-1]).to(q.dtype)


def attention_gqa(params: Params, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor, cache: Optional[Dict] = None,
                  cache_index=None, pol=NULL_POLICY):
    """Returns (out, cache). cache: {"k","v"} of (B, S_max, KV, hd).

    Unlike the reference's functional ``dynamic_update_slice``, the cache
    is updated IN PLACE (a copied full-width KV cache would be gigabytes a
    step) and the same dictionary is returned. Attention then runs over the
    cache sliced to the written slots ``[:cache_index + T]``: the kernel
    puts the queries at the tail of the keys, so their positions are
    ``cache_index + i``, and the causal / window masks equal the
    reference's full-length masks with unwritten slots masked out.

    M-RoPE takes (B, T, 3) positions, or (B, T) ones repeated to the three
    streams (text tokens), as the reference does."""
    B, T, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = pol.cs(split_heads(x @ params["wq"], B, T, H, hd), "act_bthd")
    k = pol.cs(split_heads(x @ params["wk"], B, T, KV, hd), "act_btkd")
    v = pol.cs(split_heads(x @ params["wv"], B, T, KV, hd), "act_btkd")
    if cfg.rope_kind == "mrope":
        secs = default_mrope_sections(hd)
        pos3 = positions if positions.ndim == 3 else \
            positions[..., None].expand(*positions.shape, 3)
        q = apply_rope(q, pos3, mrope_sections=secs)
        k = apply_rope(k, pos3, mrope_sections=secs)
    elif cfg.rope_kind == "rope":
        q = apply_rope(q, positions)
        k = apply_rope(k, positions)
    if cache is not None:
        idx = int(cache_index)
        write_slots(cache["k"], idx, k)
        write_slots(cache["v"], idx, v)
        k = cache["k"][:, :idx + T]
        v = cache["v"][:, :idx + T]
    out = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=True, window=cfg.window, chunk=cfg.chunk_size)
    out = pol.cs(out.transpose(1, 2), "act_bthd")
    y = out.reshape(B, T, H * hd) @ params["wo"]
    return pol.cs(y, "act_btd"), cache


def attention_mla(params: Params, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor, cache: Optional[Dict] = None,
                  cache_index=None, pol=NULL_POLICY):
    """MLA: KV compressed to a latent of kv_lora_rank (+ one shared rope
    key). Returns (out, cache); cache {"lat": (B, S_max, kv_lora_rank),
    "rope": (B, S_max, qk_rope_dim)} holds the latent, not K/V.

    As in :func:`attention_gqa`, the cache is written IN PLACE at
    ``cache_index`` and the same dictionary is returned; K and V are
    expanded from the latent over the written slots ``[:cache_index + T]``
    only, and the kernel runs with q·k head dim ``qk_nope + qk_rope`` and v
    head dim ``v_head_dim`` (96 and 64 for minicpm3-4b) at the reference's
    scale 1/sqrt(qk_nope + qk_rope). Types follow jnp's promotion: the
    latent read from an fp32 cache makes K/V fp32 under bf16 queries."""
    B, T, d = x.shape
    H = cfg.n_heads
    nope, rdim, vhd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.vhd
    kvr = cfg.kv_lora_rank or d

    q_lat = rms_norm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
    q = split_heads(q_lat @ params["wq_b"], B, T, H, nope + rdim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions)

    kv_all = x @ params["wkv_a"]                       # (B,T,kvr+rdim)
    kv_lat = rms_norm(kv_all[..., :kvr], params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv_all[..., kvr:][:, :, None, :], positions)[:, :, 0]

    if cache is not None:
        idx = int(cache_index)
        write_slots(cache["lat"], idx, kv_lat)
        write_slots(cache["rope"], idx, k_rope)
        kv_lat = cache["lat"][:, :idx + T]
        k_rope = cache["rope"][:, :idx + T]
    Tk = kv_lat.shape[1]

    # in the type jnp promotes the pair to (the fp32 latent times bf16
    # weights is an fp32 product); torch refuses mixed-type products
    dt = torch.promote_types(kv_lat.dtype, params["wkv_b"].dtype)
    kv = split_heads(kv_lat.to(dt) @ params["wkv_b"].to(dt),
                     B, Tk, H, nope + vhd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].to(k_nope.dtype)
                   .expand(B, Tk, H, rdim)], dim=-1)
    qfull = torch.cat([q_nope, q_rope], dim=-1)
    out = ops.attention(qfull.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True, window=cfg.window,
                        chunk=cfg.chunk_size,
                        scale=1.0 / math.sqrt(nope + rdim))
    y = out.transpose(1, 2).reshape(B, T, H * vhd) @ params["wo"]
    return pol.cs(y, "act_btd"), cache


# --------------------------------------------------------------------------
# MLP / MoE
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, ff: int) -> Params:
    return {"w_in": dense_init(gen, (d, 2 * ff)),   # fused gate+up
            "w_out": dense_init(gen, (ff, d))}


def mlp(params: Params, x: torch.Tensor, act: str = "silu", pol=NULL_POLICY):
    gu = pol.cs(x @ params["w_in"], "act_btf2")
    g, u = torch.chunk(gu, 2, dim=-1)
    h = act_fn(act)(g.float()).to(x.dtype) * u
    return pol.cs(h @ params["w_out"], "act_btd")


def init_moe(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d = cfg.d_model
    mff = cfg.moe_d_ff or cfg.d_ff
    E = cfg.n_experts
    p = {"router": dense_init(gen, (d, E), dtype=torch.float32),
         "w_in": dense_init(gen, (E, d, 2 * mff)),
         "w_out": dense_init(gen, (E, mff, d))}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d, mff * cfg.n_shared_experts)
    return p


def moe_dispatch(params: Params, xf: torch.Tensor, cfg: ArchConfig,
                 gate_idx: Optional[torch.Tensor] = None):
    """The reference's top-k routing and capacity dispatch of the tokens
    ``xf`` (n, d). Returns ``(probs, gate_vals, flat_expert, keep, dst,
    cap)``: the fp32 router softmax (n, E); each token's k gates,
    renormalised (n, k); each (token, slot)'s expert (n·k,); whether it
    fits its expert's capacity ``cap = max(8, ceil(n·k / E · cf))``; and
    its row of the (E·cap + 1, d) buffer, the last row taking every
    overflowing assignment. ``gate_idx`` (n, k), when given, routes the
    tokens to those experts in place of the router's top k (the router's
    probabilities there still give the gates): a replay of another call's
    routing.

    The position of an assignment within its expert is its rank in a
    stable sort by expert, so an expert keeps its first ``cap``
    assignments in token order, as the reference's (stable) ``jnp.argsort``
    does. ``jax.lax.top_k`` breaks ties towards the lower expert index,
    which ``torch.topk`` does not promise: the top k come from a stable
    descending sort."""
    n = xf.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xf.float() @ params["router"].float(), dim=-1)
    if gate_idx is None:
        gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                         stable=True)
        gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]
    else:
        gate_vals = probs.gather(1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    cap = int(max(8, math.ceil(n * k / E * cfg.capacity_factor)))
    flat_expert = gate_idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_e = flat_expert[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(E, dtype=sorted_e.dtype, device=xf.device))
    pos_sorted = torch.arange(n * k, device=xf.device) - seg_start[sorted_e]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < cap
    dst = torch.where(keep, flat_expert * cap + pos,
                      torch.full_like(pos, E * cap))
    return probs, gate_vals, flat_expert, keep, dst, cap


def on_replicas(fn, *args):
    """``fn(*args)``; with DTensor arguments, every rank runs ``fn`` on full
    (gathered) copies and the tensors it returns are replicated DTensors.
    For ops that DTensor has no sharding rules for (MoE routing's sorts,
    searches, index writes and counts)."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)
    rep = [Replicate()] * mesh.ndim
    out = fn(*(a.redistribute(mesh, rep).to_local()
               if isinstance(a, DTensor) else a for a in args))
    wrap = lambda o: DTensor.from_local(  # noqa: E731
        o, mesh, rep, run_check=False) if isinstance(o, torch.Tensor) else o
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def moe(params: Params, x: torch.Tensor, cfg: ArchConfig, pol=NULL_POLICY):
    """Top-k routing with capacity-based dispatch (:func:`moe_dispatch`):
    the kept assignments are scattered into an (E, cap, d) buffer, the
    experts run as two batched products, and each token gathers its
    outputs weighted by its renormalised gates; overflowing assignments
    are dropped (Switch-style). Adds the shared expert. Returns (y, the
    Switch load-balance aux loss ``E * sum_e f_e p_e``). Under a mesh the
    routing, the scatter and the gather run :func:`on_replicas`, the
    expert products on the ``moe_ecd`` rule's shards."""
    B, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n = B * T
    xf = x.reshape(n, d)
    probs, gate_vals, flat_expert, keep, dst, cap = on_replicas(
        lambda router, xf: moe_dispatch({"router": router}, xf, cfg),
        params["router"], xf)

    def scatter(xf, dst):
        # every buffer row but the trash row (the last) is written at most
        # once
        buf = torch.zeros((E * cap + 1, d), dtype=x.dtype, device=x.device)
        buf[dst] = xf.repeat_interleave(k, dim=0)
        return buf[:-1]
    buf = pol.cs(on_replicas(scatter, xf, dst).view(E, cap, d), "moe_ecd")

    gu = torch.bmm(buf, params["w_in"])
    g, u = torch.chunk(gu, 2, dim=-1)
    h = act_fn(cfg.act)(g.float()).to(x.dtype) * u
    out = pol.cs(torch.bmm(h, params["w_out"]), "moe_ecd")

    def combine(out, dst, gate_vals, keep):
        out_flat = torch.cat([out.reshape(E * cap, d),
                              torch.zeros((1, d), dtype=out.dtype,
                                          device=x.device)])
        w = (gate_vals.reshape(-1) * keep).to(x.dtype)
        return (out_flat[dst] * w[:, None]).view(n, k, d).sum(dim=1)
    y = on_replicas(combine, out, dst, gate_vals, keep)
    if cfg.n_shared_experts:
        y = y + mlp(params["shared"], xf, cfg.act)

    me = probs.mean(dim=0)
    # bincount(minlength=E) as a scatter-add (meta tensors have no
    # bincount: its size depends on the data)
    ce = on_replicas(lambda fe: torch.zeros(E, dtype=fe.dtype,
                                            device=fe.device).scatter_add_(
        0, fe, torch.ones_like(fe)), flat_expert).float() / (n * k)
    aux = E * torch.sum(me * ce)
    if isinstance(y, DTensor):
        # back to the tokens' own shards, which the view to (B, T, d) splits
        # evenly (the shared expert's can shard n over more ranks than B)
        y = y.redistribute(xf.device_mesh, xf.placements)
    return pol.cs(y.view(B, T, d), "act_btd"), aux


# --------------------------------------------------------------------------
# Chunked decay linear attention (shared by RWKV6 and Mamba2)
# --------------------------------------------------------------------------

def decay_linear_attention(r, kk, v, w_log, u=None, state=None,
                           chunk: Optional[int] = None,
                           scalar_decay: bool = False, pol=NULL_POLICY):
    """The reference layer's chunked scan for
    ``S_t = diag(exp(w_log_t)) S_{t-1} + k_t (x) v_t``, with output::

        u given  (RWKV6):  y_t = r_t . S_{t-1} + (u * k_t . r_t) v_t
        u None   (Mamba2): y_t = r_t . S_t     (current token decayed in)

    Shapes: r/k/w_log (B,H,T,K), v (B,H,T,V), state (B,H,K,V). Returns (y
    in r's type, the final fp32 state). Every exponent is <= 0: the
    inter-chunk terms factor through the running log-decay A, the
    intra-chunk decay comes from pairwise differences, a (C, C) outer
    difference of ``A[..., 0]`` when the decay is one per head
    (``scalar_decay``, Mamba2: chunk 128) or a (C, C, K) difference tensor
    per channel (RWKV6: chunk 32). T is zero-padded to a multiple of C
    (padded tokens leave the state as it was).

    The port's RWKV6 layer runs :func:`ops.rwkv_scan` (a CUDA kernel on
    the card) instead, and is held to this form; Mamba2's layer runs this
    function on both devices, as the reference's does (it has no kernel
    for it)."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    C = min(chunk if chunk is not None else (128 if scalar_decay else 32), T)
    T_p = -(-T // C) * C
    if T_p != T:
        pad = (0, 0, 0, T_p - T)
        r, kk, v, w_log = (F.pad(a, pad) for a in (r, kk, v, w_log))
    nC = T_p // C
    rc = r.reshape(B, H, nC, C, K)
    kc = kk.reshape(B, H, nC, C, K)
    vc = v.reshape(B, H, nC, C, V)
    wc = w_log.reshape(B, H, nC, C, K).float()
    S = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device) \
        if state is None else state.float()
    rwkv_mode = u is not None
    tt = torch.arange(C, device=r.device)
    mask = tt[:, None] > tt[None, :] if rwkv_mode else tt[:, None] >= tt[None, :]
    if rwkv_mode:
        uu = (u[None, :, None, :] if u.ndim == 2 else u).float()
    ys = []
    for c in range(nC):
        rf, kf, vf = rc[:, :, c].float(), kc[:, :, c].float(), vc[:, :, c].float()
        wC = wc[:, :, c]
        A = torch.cumsum(wC, dim=2)              # A_t = sum_{r<=t} w_r (<= 0)
        A_end = A[:, :, -1:, :]
        A_q = A - wC if rwkv_mode else A         # A_{t-1}, or A_t
        y = torch.einsum("bhtk,bhkv->bhtv", rf * torch.exp(A_q), S)
        if scalar_decay:
            d = A_q[..., 0][:, :, :, None] - A[..., 0][:, :, None, :]
            D = torch.exp(torch.where(mask, d, torch.full_like(d, float("-inf"))))
            qk = torch.einsum("bhtk,bhsk->bhts", rf, kf)
            y = y + torch.einsum("bhts,bhsv->bhtv", qk * D, vf)
        else:
            diff = A_q[:, :, :, None, :] - A[:, :, None, :, :]    # (B,H,C,C,K)
            D = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                      torch.full_like(diff, float("-inf"))))
            y = y + torch.einsum("bhtk,bhtsk,bhsk,bhsv->bhtv", rf, D, kf, vf)
        if rwkv_mode:
            bonus = torch.einsum("bhtk,bhtk->bht", rf, uu * kf)
            y = y + bonus[..., None] * vf
        k_carry = kf * torch.exp(A_end - A)
        S = S * torch.exp(A_end[:, :, 0, :])[..., None] \
            + torch.einsum("bhsk,bhsv->bhkv", k_carry, vf)
        ys.append(y)
    y = torch.stack(ys, dim=2).reshape(B, H, T_p, V)[:, :, :T]
    return y.to(r.dtype), S


# --------------------------------------------------------------------------
# RWKV6 block
# --------------------------------------------------------------------------

def init_rwkv6(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    dev = gen.device
    lora = max(32, d // 16)

    def uniform_mix(rows):   # token-shift mixes in [0.45, 0.55)
        x = torch.rand((rows, d), generator=gen, dtype=torch.float32, device=dev)
        return (x * 0.1 + 0.45).to(torch.bfloat16)

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)

    return {
        "mix": uniform_mix(5),           # r, k, v, w, g
        "wr": dense_init(gen, (d, d)),
        "wk": dense_init(gen, (d, d)),
        "wv": dense_init(gen, (d, d)),
        "wg": dense_init(gen, (d, d)),
        "wo": dense_init(gen, (d, d)),
        "w0": normal((d,)) * 0.3 - 6.0,
        "w_lora_a": dense_init(gen, (d, lora)),
        "w_lora_b": dense_init(gen, (lora, d), scale=0.01),
        "u": normal((H, hd)) * 0.3,
        "ln_x": init_rms(d, device=dev),
        # channel mix
        "cm_mix": uniform_mix(2),
        "cm_k": dense_init(gen, (d, cfg.d_ff)),
        "cm_v": dense_init(gen, (cfg.d_ff, d)),
        "cm_r": dense_init(gen, (d, d)),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """shifted(x)[t] = x[t-1]; position 0 takes `last` (decode state)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def rwkv6_block(params: Params, x: torch.Tensor, cfg: ArchConfig,
                state: Optional[Dict] = None, pol=NULL_POLICY):
    """Time-mix with data-dependent decay + channel-mix.
    state: {"shift_t","shift_c": (B,d), "wkv": (B,H,hd,hd)}. Returns
    (out, new_state); the caller writes new_state into its cache.

    The token-shift states are read in the activations' type (a cache kept
    in fp32 holds bf16 activations exactly), so the block's types do not
    depend on the cache's: r/k/v reach the scan in the activations' type,
    w_log, u and the WKV state in fp32."""
    B, T, d = x.shape
    H = cfg.n_heads
    hd = d // H
    if state is None:
        state = {"shift_t": torch.zeros((B, d), dtype=x.dtype, device=x.device),
                 "shift_c": torch.zeros((B, d), dtype=x.dtype, device=x.device),
                 "wkv": None}
    prev = _token_shift(x, state["shift_t"].to(x.dtype))
    mix = params["mix"].to(x.dtype)
    delta = prev - x
    xr = x + delta * mix[0]
    xk = x + delta * mix[1]
    xv = x + delta * mix[2]
    xw = x + delta * mix[3]
    xg = x + delta * mix[4]
    r = split_heads(xr @ params["wr"], B, T, H, hd)
    k = split_heads(xk @ params["wk"], B, T, H, hd)
    v = split_heads(xv @ params["wv"], B, T, H, hd)
    g = F.silu((xg @ params["wg"]).float())
    # data-dependent decay: w = exp(-exp(w0 + lora(xw)))  in (0, 1)
    dd = params["w0"] + (torch.tanh(xw.float() @ params["w_lora_a"].float())
                         @ params["w_lora_b"].float())
    w_log = split_heads(-torch.exp(torch.clamp(dd, -12.0, 2.0)), B, T, H, hd)

    y, wkv = ops.rwkv_scan(r.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), w_log.transpose(1, 2),
                           params["u"], state=state["wkv"])
    y = y.transpose(1, 2).reshape(B, T, d)
    y = rms_norm(y, params["ln_x"], cfg.norm_eps) * g.to(x.dtype)
    out_t = y @ params["wo"]

    # channel mix
    xc = x + out_t
    prev_c = _token_shift(xc, state["shift_c"].to(xc.dtype))
    cmix = params["cm_mix"].to(x.dtype)
    delta_c = prev_c - xc
    xk2 = xc + delta_c * cmix[0]
    xr2 = xc + delta_c * cmix[1]
    kk = torch.square(F.relu((xk2 @ params["cm_k"]).float()))
    cm = kk.to(x.dtype) @ params["cm_v"]
    rr = torch.sigmoid((xr2 @ params["cm_r"]).float()).to(x.dtype)
    out = xc + rr * cm
    new_state = {"shift_t": x[:, -1, :], "shift_c": xc[:, -1, :], "wkv": wkv}
    return pol.cs(out, "act_btd"), new_state


# --------------------------------------------------------------------------
# Mamba2 block (SSD, scalar per-head decay)
# --------------------------------------------------------------------------

def init_mamba2(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, dn, H = cfg.d_model, cfg.ssm_state, cfg.n_heads
    dev = gen.device
    return {
        "w_in": dense_init(gen, (d, 4 * d + 2 * dn + H)),  # x(2d),z(2d),B,C,dt
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=dev)),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm": init_rms(2 * d, device=dev),
        "w_out": dense_init(gen, (2 * d, d)),
    }


def mamba2_block(params: Params, x: torch.Tensor, cfg: ArchConfig,
                 state: Optional[torch.Tensor] = None, pol=NULL_POLICY):
    """SSD: ``y_t = sum_{s<=t} exp(A * sum dt) (C_t . B_s) x_s + D x_t`` per
    head, through :func:`decay_linear_attention` in its scalar-decay mode
    with r = C and k = B shared by the heads and v = dt * x. ``state``: the
    fp32 SSM state (B, H, dn, P) or None. Returns (out, new fp32 state).

    Types follow jnp's promotion as the reference's: dt and the decay are
    fp32, v is x's type (dt cast to it), ``D`` is cast to x's type."""
    B, T, d = x.shape
    H, dn = cfg.n_heads, cfg.ssm_state
    P = 2 * d // H
    zxbcdt = x @ params["w_in"]
    xs, z, Bm, Cm, dt = torch.split(zxbcdt, [2 * d, 2 * d, dn, dn, H], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])            # (B,T,H)
    a = -torch.exp(params["A_log"])                            # (H,)
    w_log = dt * a                                             # (B,T,H) <= 0
    xh = split_heads(xs, B, T, H, P)
    r = Cm[:, None].expand(B, H, T, dn).to(x.dtype)
    k = Bm[:, None].expand(B, H, T, dn).to(x.dtype)
    v = (xh * dt[..., None].to(xh.dtype)).transpose(1, 2)
    w = w_log.transpose(1, 2)[..., None].expand(B, H, T, dn)
    y, new_state = decay_linear_attention(r, k, v, w, state=state,
                                          scalar_decay=True)
    y = y.transpose(1, 2).reshape(B, T, 2 * d)
    y = y + (xh * params["D"].to(xh.dtype)[None, None, :, None]
             ).reshape(B, T, 2 * d)
    y = rms_norm(y, params["norm"], cfg.norm_eps) * \
        F.silu(z.float()).to(x.dtype)
    return pol.cs(y @ params["w_out"], "act_btd"), new_state


# --------------------------------------------------------------------------
# Embedding
# --------------------------------------------------------------------------

def init_embed(gen: torch.Generator, cfg: ArchConfig) -> Params:
    p = {"tok": dense_init(gen, (cfg.vocab_size, cfg.d_model), scale=0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), scale=0.02)
    return p


def embed(params: Params, tokens: torch.Tensor, pol=NULL_POLICY) -> torch.Tensor:
    """The token rows of the table. ``F.embedding``, not ``index_select``:
    on CUDA the latter's backward adds rows with atomics, in another order
    each run, while the embedding backward sorts the tokens and sums each
    row in a fixed order, so a training step is bit-identical run to run.

    A DTensor table is looked up on each rank's shard (:func:`_embed_shards`)."""
    table = params["tok"]
    if isinstance(table, DTensor):
        return pol.cs(_embed_shards(tokens, table), "act_btd")
    return pol.cs(F.embedding(tokens.long(), table), "act_btd")


def _embed_shards(tokens, table: DTensor) -> DTensor:
    """The lookup of (gathered) tokens in a table sharded on its rows (the
    vocabulary) and columns: each rank looks up the tokens its rows hold
    and zeroes the others, so the rows' mesh dims leave a partial sum (one
    nonzero term a token, an exact sum). DTensor's own masked lookup loses
    its mask when the result's gradient arrives as a plain partial sum."""
    mesh, pl = table.device_mesh, table.placements
    rep = [Replicate()] * mesh.ndim
    if isinstance(tokens, DTensor):
        tokens = tokens.redistribute(mesh, rep)
    start = ops.shard_start(table, 0)
    out_pl = tuple(Partial() if p.is_shard(0) else
                   Shard(2) if p.is_shard(1) else Replicate() for p in pl)

    def lookup(tok, rows_local):
        idx = tok.long() - start
        hit = (idx >= 0) & (idx < rows_local.shape[0])
        y = F.embedding(idx.clamp(0, rows_local.shape[0] - 1), rows_local)
        return y * hit[..., None].to(y.dtype)
    return local_map(lookup, out_placements=(out_pl,),
                     in_placements=(tuple(rep), tuple(pl)),
                     device_mesh=mesh)(tokens, table)


def unembed(params: Params, x: torch.Tensor, cfg: ArchConfig,
            pol=NULL_POLICY) -> torch.Tensor:
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    return pol.cs(x @ w, "logits")
