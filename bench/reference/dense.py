"""The plain model of the ``dense`` family (h2o-danube-1.8b): a decoder of
pre-norm blocks, GQA attention with RoPE and an optional sliding window,
a SwiGLU MLP, RMS norms, untied embeddings.

The port's documented model (``repro_torch/models``): RoPE rotates the two
halves of each head (theta 10,000) at the given positions; the causal and
window masks are by slot (a served token at slot Tmax + t sees every
earlier slot, the prompt's pads too, as the server's cache does); scores
are scaled by 1/sqrt(head dim); the MLP's input projection holds the gate
then the up half. Plain PyTorch, fp32 from bf16 weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.weights import Leaf
from .common import rms_norm


def layout(cfg):
    d, H, KV = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    hd, ff, V = cfg["head_dim"], cfg["intermediate_size"], cfg["vocab_size"]

    def mat(rows, cols, std=None):
        return Leaf((rows, cols), "bfloat16", 0.0,
                    1.0 / math.sqrt(rows) if std is None else std)

    ones = Leaf((d,), "float32", 1.0, 0.0)
    return {"embed": {"tok": mat(V, d, 0.02), "unembed": mat(d, V, 0.02)},
            "ln_f": ones,
            "layers": [{"ln1": ones,
                        "attn": {"wq": mat(d, H * hd), "wk": mat(d, KV * hd),
                                 "wv": mat(d, KV * hd), "wo": mat(H * hd, d)},
                        "mlp": {"w_in": mat(d, 2 * ff), "w_out": mat(ff, d)},
                        "ln2": ones}
                       for _ in range(cfg["num_hidden_layers"])]}


def rope(x, positions, theta: float):
    """x (T, heads, hd) rotated at ``positions`` (T,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window, prec):
    """q (T, H, hd), k/v (T, KV, hd): causal (and windowed) by slot."""
    T, H, hd = q.shape
    KV = k.shape[1]
    qg = prec.q(q).view(T, KV, H // KV, hd).permute(1, 2, 0, 3)
    kg, vg = prec.q(k).permute(1, 0, 2), prec.q(v).permute(1, 0, 2)
    s = torch.einsum("grtd,gsd->grts", qg, kg) / math.sqrt(hd)
    i = torch.arange(T, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window is not None:
        mask &= i[None, :] > i[:, None] - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("grts,gsd->grtd", prec.q(p), vg)
    return o.permute(2, 0, 1, 3).reshape(T, H * hd)


def block(bp, h, positions, cfg, prec):
    T = h.shape[0]
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], \
        cfg["head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    a = bp["attn"]
    x = rms_norm(h, bp["ln1"], eps)
    q = rope(prec.mm(x, a["wq"]).view(T, H, hd), positions, theta)
    k = rope(prec.mm(x, a["wk"]).view(T, KV, hd), positions, theta)
    v = prec.mm(x, a["wv"]).view(T, KV, hd)
    h = h + prec.mm(attention(q, k, v, cfg.get("sliding_window"), prec),
                    a["wo"])
    x = rms_norm(h, bp["ln2"], eps)
    g, u = prec.mm(x, bp["mlp"]["w_in"]).chunk(2, dim=-1)
    return h + prec.mm(F.silu(g) * u, bp["mlp"]["w_out"])


def hidden(params, cfg, tokens, positions, prec, remat: bool):
    h = params["embed"]["tok"][tokens.long()].float()
    for bp in params["layers"]:
        if remat:
            h = checkpoint(block, bp, h, positions, cfg, prec,
                           use_reentrant=False)
        else:
            h = block(bp, h, positions, cfg, prec)
    return rms_norm(h, params["ln_f"], cfg["rms_norm_eps"])
