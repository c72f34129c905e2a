"""Model assembly: init, forward, prefill/decode, for the families the port
serves (``dense`` transformers: GQA/SWA with RoPE or M-RoPE, and MLA; and
``rwkv6``).

The port of ``repro.models.model``. The reference runs its layer stacks
under ``jax.lax.scan`` over stacked parameters; here ``params["layers"]``
is a list of per-layer dictionaries and the stack is a Python loop.

Caches (decode), one tensor per kind with the layer index first, updated
IN PLACE by :func:`forward` (which returns the same dictionary):
  gqa      {"k","v"}                      (L, B, S_max, KV, hd)
  mla      {"lat","rope"}                 (L, B, S_max, kvr | rdim)  (the latent)
  rwkv6    {"shift_t","shift_c","wkv"}    (L, B, d) / (L, B, H, hd, hd)

Modality frontends are stubs, as in the reference: a vision model
(qwen2-vl) takes precomputed patch embeddings (B, T, d_model) as inputs
in place of tokens.

MoE, Mamba2/Zamba2 and encoder-decoder models raise
``NotImplementedError`` (ROADMAP A2); the training losses (``lm_loss``,
``loss_fn``) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .arch import ArchConfig
from .layers import (NULL_POLICY, attention_gqa, attention_mla, embed,
                     init_attention, init_embed, init_mlp, init_rms,
                     init_rwkv6, mlp, rms_norm, rwkv6_block, unembed)

__all__ = ["init_params", "make_caches", "forward"]

Params = Dict[str, Any]

_LATER = "not ported yet (ROADMAP A2)"


def _kind(cfg: ArchConfig) -> str:
    if cfg.enc_dec:
        raise NotImplementedError(f"encoder-decoder models are {_LATER}")
    if cfg.ssm_kind == "rwkv6":
        return "rwkv6"
    if cfg.ssm_kind is not None:
        raise NotImplementedError(f"{cfg.ssm_kind} models are {_LATER}")
    if cfg.moe:
        raise NotImplementedError(f"MoE models are {_LATER}")
    if cfg.attn_kind not in ("gqa", "mla"):
        raise NotImplementedError(f"{cfg.attn_kind} attention is {_LATER}")
    return "dense"


# --------------------------------------------------------------------------
# Initialization
# --------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ArchConfig, kind: str) -> Params:
    if kind == "rwkv6":
        return {"rwkv": init_rwkv6(gen, cfg)}
    dev = gen.device
    return {"ln1": init_rms(cfg.d_model, device=dev),
            "attn": init_attention(gen, cfg),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff),
            "ln2": init_rms(cfg.d_model, device=dev)}


def init_params(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random parameters drawn from ``gen`` on the generator's device:
    ``{"embed", "ln_f", "layers": [per-layer dict] * n_layers}``."""
    kind = _kind(cfg)
    return {"embed": init_embed(gen, cfg),
            "ln_f": init_rms(cfg.d_model, device=gen.device),
            "layers": [_init_block(gen, cfg, kind)
                       for _ in range(cfg.n_layers)]}


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------

def make_caches(cfg: ArchConfig, batch: int, s_max: int,
                dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Zeroed decode caches on ``device``."""
    B = batch
    if _kind(cfg) == "rwkv6":
        L, d, H = cfg.n_layers, cfg.d_model, cfg.n_heads
        hd = d // H
        return {"shift_t": torch.zeros((L, B, d), dtype=dtype, device=device),
                "shift_c": torch.zeros((L, B, d), dtype=dtype, device=device),
                "wkv": torch.zeros((L, B, H, hd, hd), dtype=torch.float32,
                                   device=device)}
    if cfg.attn_kind == "mla":
        L = cfg.n_layers
        return {"lat": torch.zeros((L, B, s_max, cfg.kv_lora_rank),
                                   dtype=dtype, device=device),
                "rope": torch.zeros((L, B, s_max, cfg.qk_rope_dim),
                                    dtype=dtype, device=device)}
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    # absolute positions; the window masks reads (as in the reference)
    return {"k": torch.zeros((L, B, s_max, KV, hd), dtype=dtype, device=device),
            "v": torch.zeros((L, B, s_max, KV, hd), dtype=dtype, device=device)}


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _dense_block(bp, h, cfg, positions, cache, idx, pol):
    attn_fn = attention_mla if cfg.attn_kind == "mla" else attention_gqa
    a, _ = attn_fn(bp["attn"], rms_norm(h, bp["ln1"], cfg.norm_eps),
                   cfg, positions, cache, idx, pol)
    h = h + a
    return h + mlp(bp["mlp"], rms_norm(h, bp["ln2"], cfg.norm_eps), cfg.act,
                   pol)


def forward(params: Params, cfg: ArchConfig, inputs: torch.Tensor,
            positions: torch.Tensor, caches=None, cache_index=None,
            pol=NULL_POLICY, enc_inputs=None):
    """Returns (logits, caches, aux_loss).

    inputs: int tokens (B,T) (int32 or int64) or precomputed embeddings
    (B,T,d) from a stubbed modality frontend (qwen2-vl's vision patches).
    With ``caches`` the step writes its keys/values (or recurrent state)
    into them in place at ``cache_index`` and returns the same dictionary."""
    if enc_inputs is not None:
        raise NotImplementedError(f"encoder-decoder models are {_LATER}")
    kind = _kind(cfg)
    if inputs.dtype in (torch.int32, torch.int64):
        h = embed(params["embed"], inputs, pol)
    else:
        h = inputs.to(torch.bfloat16)
    idx = int(cache_index) if cache_index is not None else 0
    for l, bp in enumerate(params["layers"]):
        if kind == "dense":
            cache_l = None if caches is None else \
                {name: c[l] for name, c in caches.items()}
            h = _dense_block(bp, h, cfg, positions, cache_l, idx, pol)
        else:
            state = None if caches is None else \
                {name: caches[name][l] for name in ("shift_t", "shift_c", "wkv")}
            h, new_state = rwkv6_block(bp["rwkv"], h, cfg, state, pol)
            if caches is not None:
                for name, value in new_state.items():
                    caches[name][l].copy_(value)
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    logits = unembed(params["embed"], h, cfg, pol)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, caches, aux
