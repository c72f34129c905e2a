"""Model assembly: init, forward, prefill/decode, for every family of the
reference: ``dense`` transformers (GQA/SWA with RoPE or M-RoPE, chunked
local attention, MLA), ``rwkv6``, Mamba2 and the Zamba2 hybrid, MoE, and
encoder-decoder.

The port of ``repro.models.model``. The reference runs its layer stacks
under ``jax.lax.scan`` over stacked parameters; here each stack
(``params["layers"]``, ``"dense_layers"``, ``"enc"``, ``"dec"``) is a list
of per-layer dictionaries and the stack is a Python loop.

Caches (decode), one tensor per kind with the layer (or site) index first,
updated IN PLACE by :func:`forward` (which returns the same dictionary):
  gqa      {"k","v"}                      (L, B, S_max, KV, hd)
  mla      {"lat","rope"}                 (L, B, S_max, kvr | rdim)  (the latent)
  rwkv6    {"shift_t","shift_c","wkv"}    (L, B, d) / (L, B, H, hd, hd)
  mamba2   {"ssm"}                        (L, B, H, dn, P), fp32
  zamba2   {"ssm"} + {"k","v"}            (n_sites, B, S_max, KV, hd): one
           KV slot per application site of the ONE shared attention block
  enc-dec  {"k","v","xk","xv"}            (L_dec, B, S_max, KV, hd): the
           decoder's self K/V and the cross K/V of the encoder's output
MoE models keep the gqa (or mla) caches over all ``n_layers``: the leading
``n_dense_layers`` then the MoE layers.

Modality frontends are stubs, as in the reference: a vision model
(qwen2-vl) takes precomputed patch embeddings (B, T, d_model) as inputs
in place of tokens, and the encoder of an encoder-decoder model (seamless's
speech encoder) precomputed frame embeddings as ``enc_inputs``.

The training losses: :func:`lm_loss` (next-token cross entropy in fp32,
labels -100 masked) and :func:`loss_fn` (the forward over a batch plus
the weighted MoE aux loss), differentiated by autograd: on the card the
attention's backward is the ``flash_attention_bwd`` kernel, on the CPU
autograd through the plain attention.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .arch import ArchConfig
from .layers import (NULL_POLICY, apply_rope, attention_gqa, attention_mla,
                     embed, init_attention, init_embed, init_mamba2, init_mlp,
                     init_moe, init_rms, init_rwkv6, mamba2_block, mlp, moe,
                     rms_norm, rwkv6_block, unembed)
from ..kernels import ops

__all__ = ["init_params", "make_caches", "forward", "lm_loss", "loss_fn"]

Params = Dict[str, Any]


def _n_sites(cfg: ArchConfig) -> int:
    """Application sites of Zamba2's shared attention block."""
    return max(1, cfg.n_layers // max(1, cfg.hybrid_every))


# --------------------------------------------------------------------------
# Initialization
# --------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, kind: str) -> Params:
    if kind == "rwkv6":
        return {"rwkv": init_rwkv6(gen, cfg)}
    d, dev = cfg.d_model, gen.device
    p: Params = {"ln1": init_rms(d, device=dev)}
    if kind == "dense":
        p.update(attn=init_attention(gen, cfg), mlp=init_mlp(gen, d, cfg.d_ff),
                 ln2=init_rms(d, device=dev))
    elif kind == "moe":
        p.update(attn=init_attention(gen, cfg), moe=init_moe(gen, cfg),
                 ln2=init_rms(d, device=dev))
    elif kind == "mamba2":
        p["mamba"] = init_mamba2(gen, cfg)
    elif kind == "cross":   # decoder block: self-attn + cross-attn + mlp
        p.update(attn=init_attention(gen, cfg), cross=init_attention(gen, cfg),
                 ln_cross=init_rms(d, device=dev),
                 mlp=init_mlp(gen, d, cfg.d_ff), ln2=init_rms(d, device=dev))
    else:
        raise ValueError(kind)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random parameters drawn from ``gen`` on the generator's device, in
    the reference's tree with lists for its stacks: ``{"embed", "ln_f"}``
    and ``"layers"`` (dense, RWKV6, MoE); ``"dense_layers"`` before an MoE
    stack; ``"shared_attn"`` (one block) beside Zamba2's Mamba2 layers;
    ``"enc"``, ``"dec"`` and ``"ln_enc"`` for an encoder-decoder model."""
    block = lambda kind: _init_block(gen, cfg, kind)   # noqa: E731
    p: Params = {"embed": init_embed(gen, cfg),
                 "ln_f": init_rms(cfg.d_model, device=gen.device)}
    if cfg.enc_dec:
        p["enc"] = [block("dense") for _ in range(cfg.n_enc_layers)]
        p["dec"] = [block("cross") for _ in range(cfg.n_dec_layers)]
        p["ln_enc"] = init_rms(cfg.d_model, device=gen.device)
    elif cfg.ssm_kind in ("rwkv6", "mamba2"):
        p["layers"] = [block(cfg.ssm_kind) for _ in range(cfg.n_layers)]
        if cfg.ssm_kind == "mamba2" and cfg.shared_attn:
            p["shared_attn"] = block("dense")
    elif cfg.moe:
        if cfg.n_dense_layers:
            p["dense_layers"] = [block("dense")
                                 for _ in range(cfg.n_dense_layers)]
        p["layers"] = [block("moe")
                       for _ in range(cfg.n_layers - cfg.n_dense_layers)]
    else:
        p["layers"] = [block("dense") for _ in range(cfg.n_layers)]
    return p


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------

def make_caches(cfg: ArchConfig, batch: int, s_max: int,
                dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Zeroed decode caches on ``device``."""
    B = batch
    zeros = lambda *shape, dt=dtype: torch.zeros(  # noqa: E731
        shape, dtype=dt, device=device)
    KV, hd = cfg.n_kv_heads, cfg.hd
    if cfg.enc_dec:
        L = cfg.n_dec_layers
        return {name: zeros(L, B, s_max, KV, hd)
                for name in ("k", "v", "xk", "xv")}
    if cfg.ssm_kind == "rwkv6":
        L, d, H = cfg.n_layers, cfg.d_model, cfg.n_heads
        hd = d // H
        return {"shift_t": zeros(L, B, d), "shift_c": zeros(L, B, d),
                "wkv": zeros(L, B, H, hd, hd, dt=torch.float32)}
    if cfg.ssm_kind == "mamba2":
        H = cfg.n_heads
        c = {"ssm": zeros(cfg.n_layers, B, H, cfg.ssm_state,
                          2 * cfg.d_model // H, dt=torch.float32)}
        if cfg.shared_attn:
            c["k"] = zeros(_n_sites(cfg), B, s_max, KV, hd)
            c["v"] = zeros(_n_sites(cfg), B, s_max, KV, hd)
        return c
    L = cfg.n_layers
    if cfg.attn_kind == "mla":
        return {"lat": zeros(L, B, s_max, cfg.kv_lora_rank),
                "rope": zeros(L, B, s_max, cfg.qk_rope_dim)}
    # absolute positions; the window masks reads (as in the reference)
    return {"k": zeros(L, B, s_max, KV, hd), "v": zeros(L, B, s_max, KV, hd)}


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _layer_cache(caches, l, names=None):
    """Layer (or site) ``l``'s views of ``caches``, or None."""
    if caches is None:
        return None
    return {name: caches[name][l] for name in (names or caches)}


def _attend(bp, h, cfg, positions, cache, idx, pol):
    attn_fn = attention_mla if cfg.attn_kind == "mla" else attention_gqa
    a, _ = attn_fn(bp["attn"], rms_norm(h, bp["ln1"], cfg.norm_eps),
                   cfg, positions, cache, idx, pol)
    return h + a


def _dense_block(bp, h, cfg, positions, cache, idx, pol):
    h = _attend(bp, h, cfg, positions, cache, idx, pol)
    return h + mlp(bp["mlp"], rms_norm(h, bp["ln2"], cfg.norm_eps), cfg.act,
                   pol)


def _moe_block(bp, h, cfg, positions, cache, idx, pol):
    h = _attend(bp, h, cfg, positions, cache, idx, pol)
    y, aux = moe(bp["moe"], rms_norm(h, bp["ln2"], cfg.norm_eps), cfg, pol)
    return h + y, aux


def _mamba_layer(bp, h, cfg, caches, l, pol):
    state = None if caches is None else caches["ssm"][l]
    y, new_state = mamba2_block(bp["mamba"], rms_norm(h, bp["ln1"],
                                                      cfg.norm_eps),
                                cfg, state, pol)
    if caches is not None:
        caches["ssm"][l].copy_(new_state)
    return h + y


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def forward(params: Params, cfg: ArchConfig, inputs: torch.Tensor,
            positions: torch.Tensor, caches=None, cache_index=None,
            pol=NULL_POLICY, enc_inputs=None):
    """Returns (logits, caches, aux_loss).

    inputs: int tokens (B,T) (int32 or int64) or precomputed embeddings
    (B,T,d) from a stubbed modality frontend (qwen2-vl's vision patches).
    enc_inputs: an encoder-decoder model's encoder-side embeddings (B, T_enc,
    d) (seamless's stubbed speech frontend), or None at decode. With
    ``caches`` the step writes its keys/values (or recurrent state) into
    them in place at ``cache_index`` and returns the same dictionary.
    aux_loss: the MoE layers' load-balance losses summed (0 elsewhere)."""
    if inputs.dtype in (torch.int32, torch.int64):
        h = embed(params["embed"], inputs, pol)
    else:
        h = inputs.to(torch.bfloat16)
    idx = int(cache_index) if cache_index is not None else 0
    aux = torch.zeros((), dtype=torch.float32, device=h.device)

    if cfg.enc_dec:
        h = _forward_encdec(params, cfg, h, positions, caches, idx, pol,
                            enc_inputs)
    elif cfg.ssm_kind == "mamba2":
        h = _forward_zamba(params, cfg, h, positions, caches, idx, pol)
    elif cfg.ssm_kind == "rwkv6":
        for l, bp in enumerate(params["layers"]):
            state = _layer_cache(caches, l, ("shift_t", "shift_c", "wkv"))
            h, new_state = rwkv6_block(bp["rwkv"], h, cfg, state, pol)
            if caches is not None:
                for name, value in new_state.items():
                    caches[name][l].copy_(value)
    elif cfg.moe:
        # the caches' leading n_dense_layers entries are the dense layers'
        nd = cfg.n_dense_layers
        for l, bp in enumerate(params.get("dense_layers", [])):
            h = _dense_block(bp, h, cfg, positions, _layer_cache(caches, l),
                             idx, pol)
        for l, bp in enumerate(params["layers"]):
            h, a = _moe_block(bp, h, cfg, positions,
                              _layer_cache(caches, nd + l), idx, pol)
            aux = aux + a
    else:
        for l, bp in enumerate(params["layers"]):
            h = _dense_block(bp, h, cfg, positions, _layer_cache(caches, l),
                             idx, pol)
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    logits = unembed(params["embed"], h, cfg, pol)
    return logits, caches, aux


def _forward_zamba(params, cfg, h, positions, caches, idx, pol):
    """Mamba2 layers; with ``shared_attn`` (Zamba2) the ONE shared dense
    block runs after every ``hybrid_every`` of them, with the same
    parameters at each site and site g's own KV cache slot, then the tail
    of ``n_layers % hybrid_every`` Mamba2 layers."""
    layers = params["layers"]
    if not cfg.shared_attn:
        for l, bp in enumerate(layers):
            h = _mamba_layer(bp, h, cfg, caches, l, pol)
        return h
    every = max(1, cfg.hybrid_every)
    n_sites = _n_sites(cfg)
    for g in range(n_sites):
        for l in range(g * every, min((g + 1) * every, cfg.n_layers)):
            h = _mamba_layer(layers[l], h, cfg, caches, l, pol)
        h = _dense_block(params["shared_attn"], h, cfg, positions,
                         _layer_cache(caches, g, ("k", "v")), idx, pol)
    for l in range(n_sites * every, cfg.n_layers):
        h = _mamba_layer(layers[l], h, cfg, caches, l, pol)
    return h


def _encode(params, cfg, enc_inputs, pol):
    """The bidirectional encoder over the frame embeddings: RoPE at
    positions 0..T_enc-1, attention with no mask, window or chunk."""
    he = enc_inputs.to(torch.bfloat16)
    B, T, _ = he.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos = torch.arange(T, device=he.device)[None].expand(B, T)
    for bp in params["enc"]:
        x = rms_norm(he, bp["ln1"], cfg.norm_eps)
        q = apply_rope((x @ bp["attn"]["wq"]).view(B, T, H, hd), pos)
        k = apply_rope((x @ bp["attn"]["wk"]).view(B, T, KV, hd), pos)
        v = (x @ bp["attn"]["wv"]).view(B, T, KV, hd)
        out = ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=False)
        he = he + out.transpose(1, 2).reshape(B, T, H * hd) @ bp["attn"]["wo"]
        he = he + mlp(bp["mlp"], rms_norm(he, bp["ln2"], cfg.norm_eps),
                      cfg.act, pol)
    return rms_norm(he, params["ln_enc"], cfg.norm_eps)


def _forward_encdec(params, cfg, h, positions, caches, idx, pol, enc_inputs):
    """Encoder-decoder (seamless): the encoder over ``enc_inputs``, then the
    causal decoder, each block self-attention, cross attention over the
    encoder's output, MLP.

    At a prefill with ``enc_inputs`` and caches, each layer's cross K/V are
    written into ``xk``/``xv`` at slot 0; a decode step (``enc_inputs``
    None) reads them there. As in the reference (``model.py:395-404``),
    cross attention with caches runs unmasked over the WHOLE S_max-long
    cross cache, unwritten zero slots included; without caches over the
    T_enc encoder outputs only. A decode with no encoder run before it
    (``Server.generate`` passes no ``enc_inputs``) attends over a zero
    cross cache."""
    enc_out = None if enc_inputs is None else _encode(params, cfg,
                                                      enc_inputs, pol)
    B, T, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for l, bp in enumerate(params["dec"]):
        h = _attend(bp, h, cfg, positions, _layer_cache(caches, l, ("k", "v")),
                    idx, pol)
        x = rms_norm(h, bp["ln_cross"], cfg.norm_eps)
        q = (x @ bp["cross"]["wq"]).view(B, T, H, hd)
        if enc_out is not None:
            Te = enc_out.shape[1]
            xk = (enc_out @ bp["cross"]["wk"]).view(B, Te, KV, hd)
            xv = (enc_out @ bp["cross"]["wv"]).view(B, Te, KV, hd)
            if caches is not None:
                caches["xk"][l, :, :Te].copy_(xk)
                caches["xv"][l, :, :Te].copy_(xv)
                xk, xv = caches["xk"][l], caches["xv"][l]
        else:
            xk, xv = caches["xk"][l], caches["xv"][l]
        out = ops.attention(q.transpose(1, 2), xk.transpose(1, 2),
                            xv.transpose(1, 2), causal=False)
        h = h + out.transpose(1, 2).reshape(B, T, H * hd) @ bp["cross"]["wo"]
        h = h + mlp(bp["mlp"], rms_norm(h, bp["ln2"], cfg.norm_eps), cfg.act,
                    pol)
    return h


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            pol=NULL_POLICY) -> torch.Tensor:
    """Next-token cross entropy in fp32; labels -100 are masked."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    nll = lse - gold
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            pol=NULL_POLICY, aux_weight: float = 0.01) -> torch.Tensor:
    """The batch's loss: ``embeds`` (a stubbed frontend's) or ``tokens``,
    ``positions`` (0..T-1 by default), ``enc_embeds`` for an
    encoder-decoder model, ``labels``; plus ``aux_weight`` times the MoE
    aux loss."""
    inputs = batch.get("embeds", batch.get("tokens"))
    positions = batch.get("positions")
    if positions is None:
        B, T = inputs.shape[:2]
        positions = torch.arange(T, device=inputs.device)[None].expand(B, T)
    logits, _, aux = forward(params, cfg, inputs, positions, pol=pol,
                             enc_inputs=batch.get("enc_embeds"))
    return lm_loss(logits, batch["labels"], pol) + aux_weight * aux
