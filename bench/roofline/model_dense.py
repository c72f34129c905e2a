"""A ``dense`` model's operations (the ``mfu`` readers'): 2 a matmul
parameter a token forward, plus attention's q.k and p.v products over
the pairs the causal and window masks leave visible; a training step
three times the forward (forward and backward). Embedding lookups, norms
and elementwise work are not counted."""

from __future__ import annotations

from typing import Iterable

from .flash_attention import visible


def matmul_params(cfg) -> int:
    d, H, KV = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    hd, ff, V = cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"]
    layer = d * H * hd + 2 * d * KV * hd + H * hd * d + 2 * d * ff + ff * d
    return cfg["num_hidden_layers"] * layer + d * V


def mixer_flops(cfg, T: int) -> float:
    """Attention's products of one row of T tokens, all layers, forward."""
    pairs, _ = visible(T, T, True, cfg.get("sliding_window"))
    return cfg["num_hidden_layers"] * 2.0 * cfg["num_attention_heads"] \
        * 2 * cfg["head_dim"] * pairs


def forward_flops(cfg, lengths: Iterable[int]) -> float:
    n = matmul_params(cfg)
    return sum(2.0 * n * T + mixer_flops(cfg, T) for T in lengths)


def train_flops(cfg, rows: int, T: int) -> float:
    return 3.0 * forward_flops(cfg, [T] * rows)
