"""An ``mla`` model's operations (the ``mfu`` readers'): 2 a matmul
parameter a token forward (the latent's expansion by ``wkv_b`` included:
a prefill expands each token once), plus attention's q.k products over
``qk_nope + qk_rope`` and p.v products over ``v_head_dim`` for every
pair the causal mask leaves visible. Embedding lookups, norms, RoPE and
elementwise work are not counted."""

from __future__ import annotations

from typing import Iterable

from .flash_attention import visible


def matmul_params(cfg) -> int:
    d, H, V = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["vocab_size"]
    qr, kvr = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nope, rdim, vhd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], \
        cfg["v_head_dim"]
    ff = cfg["intermediate_size"]
    attn = (d * qr + qr * H * (nope + rdim) + d * (kvr + rdim)
            + kvr * H * (nope + vhd) + H * vhd * d)
    return cfg["num_hidden_layers"] * (attn + 3 * d * ff) + d * V


def mixer_flops(cfg, T: int) -> float:
    """Attention's products of one row of T tokens, all layers, forward."""
    pairs, _ = visible(T, T, True, None)
    width = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] \
        + cfg["v_head_dim"]
    return cfg["num_hidden_layers"] * 2.0 * cfg["num_attention_heads"] \
        * width * pairs


def forward_flops(cfg, lengths: Iterable[int]) -> float:
    n = matmul_params(cfg)
    return sum(2.0 * n * T + mixer_flops(cfg, T) for T in lengths)
