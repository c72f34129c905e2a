"""The plain model of the ``mla`` family (minicpm3-4b): MiniCPM3's decoder
of pre-norm blocks, multi-head latent attention (MLA) with RoPE on a part
of each head, a SwiGLU MLP, RMS norms, untied embeddings, and MiniCPM's
three scalings (arXiv:2404.06395): the embedding times ``scale_emb``,
each residual branch times ``scale_depth / sqrt(layers)``, the final
norm's output over ``hidden_size / dim_model_base`` before the head.

MLA (DeepSeek-V2's attention): the query through a rank-``q_lora_rank``
bottleneck with its own RMS norm; keys and values from a latent of
``kv_lora_rank`` (RMS-normed) expanded by ``wkv_b`` to each head's
``qk_nope_head_dim`` key part and ``v_head_dim`` value, beside one
``qk_rope_head_dim`` key part shared by all heads that carries the
rotation; scores over ``qk_nope + qk_rope`` at 1/sqrt of that width.

Departures from the published model, each the port's documented one:

* RoPE: plain rotary at theta 10,000 on the ``qk_rope`` dims. The
  published model scales these frequencies by LongRoPE's ``short_factor``
  table (its attention factor is 1 at 32,768 positions or fewer), which
  is not in the repository;
* rotate-half pairing: dim i turns with dim i + qk_rope / 2;
* the causal mask is by slot: a served token at slot Tmax + t sees every
  earlier slot, the prompt's pads too, as the server's cache does.

Attention runs in query blocks of ``QUERY_BLOCK`` rows, each against the
keys up to its last row only (the key blocks the causal mask hides
entirely are skipped: exact), so that 16k-token sequences fit on the
card. Plain PyTorch, fp32 from bf16 weights; imports nothing of the
program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.weights import Leaf
from .common import rms_norm
from .dense import rope

QUERY_BLOCK = 512


def layout(cfg):
    d, H, V = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["vocab_size"]
    qr, kvr = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    nope, rdim, vhd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], \
        cfg["v_head_dim"]
    ff = cfg["intermediate_size"]

    def mat(rows, cols, std=None):
        return Leaf((rows, cols), "bfloat16", 0.0,
                    1.0 / math.sqrt(rows) if std is None else std)

    def ones(n):
        return Leaf((n,), "float32", 1.0, 0.0)

    return {"embed": {"tok": mat(V, d, 0.02), "unembed": mat(d, V, 0.02)},
            "ln_f": ones(d),
            "layers": [{"ln1": ones(d),
                        "attn": {"wq_a": mat(d, qr), "q_norm": ones(qr),
                                 "wq_b": mat(qr, H * (nope + rdim)),
                                 "wkv_a": mat(d, kvr + rdim),
                                 "kv_norm": ones(kvr),
                                 "wkv_b": mat(kvr, H * (nope + vhd)),
                                 "wo": mat(H * vhd, d)},
                        "mlp": {"w_in": mat(d, 2 * ff), "w_out": mat(ff, d)},
                        "ln2": ones(d)}
                       for _ in range(cfg["num_hidden_layers"])]}


def attention(q, k, v, prec):
    """q, k (T, H, qk), v (T, H, hdv): causal by slot, in query blocks."""
    T, H, qk = q.shape
    q, k, v = prec.q(q), prec.q(k), prec.q(v)
    out = []
    for a in range(0, T, QUERY_BLOCK):
        b = min(a + QUERY_BLOCK, T)
        s = torch.einsum("thd,shd->hts", q[a:b], k[:b]) / math.sqrt(qk)
        i = torch.arange(a, b, device=q.device)
        hidden = torch.arange(b, device=q.device)[None, :] > i[:, None]
        p = torch.softmax(s.masked_fill(hidden, float("-inf")), dim=-1)
        out.append(torch.einsum("hts,shd->thd", prec.q(p), v[:b]))
    return torch.cat(out).reshape(T, H * v.shape[-1])


def block(bp, h, positions, cfg, prec):
    T = h.shape[0]
    H, kvr = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rdim, vhd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], \
        cfg["v_head_dim"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    branch = cfg["scale_depth"] / math.sqrt(cfg["num_hidden_layers"])
    a = bp["attn"]
    x = rms_norm(h, bp["ln1"], eps)
    q = prec.mm(rms_norm(prec.mm(x, a["wq_a"]), a["q_norm"], eps), a["wq_b"])
    q = q.view(T, H, nope + rdim)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], positions, theta)], -1)
    kv_a = prec.mm(x, a["wkv_a"])
    lat = rms_norm(kv_a[:, :kvr], a["kv_norm"], eps)
    k_rope = rope(kv_a[:, None, kvr:], positions, theta)          # (T, 1, r)
    kv = prec.mm(lat, a["wkv_b"]).view(T, H, nope + vhd)
    k = torch.cat([kv[..., :nope], k_rope.expand(T, H, rdim)], -1)
    o = attention(q, k, kv[..., nope:], prec)
    h = h + prec.mm(o, a["wo"]) * branch
    x = rms_norm(h, bp["ln2"], eps)
    g, u = prec.mm(x, bp["mlp"]["w_in"]).chunk(2, dim=-1)
    return h + prec.mm(F.silu(g) * u, bp["mlp"]["w_out"]) * branch


def hidden(params, cfg, tokens, positions, prec, remat: bool):
    h = params["embed"]["tok"][tokens.long()].float() * cfg["scale_emb"]
    for bp in params["layers"]:
        if remat:
            h = checkpoint(block, bp, h, positions, cfg, prec,
                           use_reentrant=False)
        else:
            h = block(bp, h, positions, cfg, prec)
    return rms_norm(h, params["ln_f"], cfg["rms_norm_eps"]) \
        / (cfg["hidden_size"] / cfg["dim_model_base"])
