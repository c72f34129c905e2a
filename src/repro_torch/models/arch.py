"""Architecture configuration schema covering all 10 assigned architectures.

One dataclass describes dense GQA/MLA/SWA transformers, RWKV6, Mamba2
hybrids, MoE (top-1 and top-k), enc-dec, and modality-frontend stubs.
``scaled()`` produces the reduced smoke-test configs; full configs live in
``repro_torch.configs``. Pure Python, copied from the reference package;
the port serves every family it describes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ArchConfig", "register_arch", "get_arch", "list_archs"]

_REGISTRY = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | ssm | hybrid | vlm | audio | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention flavor
    attn_kind: str = "gqa"         # gqa | mla | none
    window: Optional[int] = None   # sliding-window size (SWA)
    chunk_size: Optional[int] = None  # chunked local attention (llama4-style)
    rope_kind: str = "rope"        # rope | mrope | none

    # MLA (MiniCPM3 / Kimi-K2 style latent attention)
    q_lora_rank: Optional[int] = None
    kv_lora_rank: Optional[int] = None
    qk_rope_dim: int = 64
    qk_nope_dim: int = 64
    v_head_dim: Optional[int] = None

    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 1
    moe_d_ff: Optional[int] = None
    n_shared_experts: int = 0
    n_dense_layers: int = 0        # leading dense layers before MoE stack
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_kind: Optional[str] = None  # rwkv6 | mamba2
    ssm_state: int = 64
    hybrid_every: int = 0           # shared attn block every N ssm layers
    shared_attn: bool = False       # zamba2: ONE attn block's params shared

    # encoder-decoder
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend: Optional[str] = None  # vision | audio | None

    # MiniCPM's scalings (arXiv:2404.06395); the defaults add no operation
    scale_emb: Optional[float] = None     # the token embedding's output times it
    scale_depth: Optional[float] = None   # each residual branch times it / sqrt(n_layers)
    dim_model_base: Optional[int] = None  # the head's input over d_model / it

    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    act: str = "silu"
    dtype: str = "bfloat16"
    max_seq_len: int = 8192

    # ------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vhd(self) -> int:
        return self.v_head_dim if self.v_head_dim is not None else self.hd

    @property
    def subquadratic(self) -> bool:
        """Can this arch run 500k-token decode without a full-attention KV?"""
        if self.ssm_kind is not None and self.hybrid_every == 0 and not self.shared_attn:
            return True
        if self.ssm_kind is not None:  # hybrid: few attn layers, linear state
            return True
        if self.window is not None or self.chunk_size is not None:
            return True
        return False

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs can decode (seamless has a decoder)

    def n_params(self) -> float:
        """Approximate parameter count (for 6·N·D roofline math)."""
        d, L = self.d_model, self.n_layers
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.attn_kind == "mla":
            q = d * (self.q_lora_rank or d) + \
                (self.q_lora_rank or d) * self.n_heads * (self.qk_rope_dim + self.qk_nope_dim)
            kv = d * (self.kv_lora_rank or d) + \
                (self.kv_lora_rank or d) * self.n_heads * (self.qk_nope_dim + self.vhd)
            o = self.n_heads * self.vhd * d
            attn = q + kv + o
        elif self.attn_kind == "none":
            attn = 0.0
        else:
            attn = d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd \
                + self.n_heads * self.hd * d
        mlp_dense = 3 * d * self.d_ff
        if self.ssm_kind == "rwkv6":
            per_layer = 4 * d * d + 2 * d * self.d_ff + 2.5 * d * d
            return embed + L * per_layer
        if self.ssm_kind == "mamba2":
            # w_in: x(2d)+z(2d)+B,C,dt; w_out: 2d→d — no per-layer MLP (zamba2)
            ssm = d * (4 * d + 2 * self.ssm_state + self.n_heads) + 2 * d * d
            total = embed + L * ssm
            if self.shared_attn:
                total += attn + mlp_dense  # the ONE shared block
            return total
        if self.moe:
            mff = self.moe_d_ff or self.d_ff
            moe_mlp = 3 * d * mff * self.n_experts \
                + 3 * d * mff * self.n_shared_experts
            n_moe = L - self.n_dense_layers
            return embed + L * attn + self.n_dense_layers * mlp_dense + n_moe * moe_mlp
        if self.enc_dec:
            Lt = self.n_enc_layers + self.n_dec_layers
            cross = self.n_dec_layers * attn
            return embed + Lt * (attn + mlp_dense) + cross
        return embed + L * (attn + mlp_dense)

    def n_active_params(self) -> float:
        """Active parameters per token (MoE: routed top-k + shared only)."""
        if not self.moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        mff = self.moe_d_ff or self.d_ff
        full = self.n_params()
        all_experts = (L - self.n_dense_layers) * 3 * d * mff * self.n_experts
        active = (L - self.n_dense_layers) * 3 * d * mff * self.top_k
        return full - all_experts + active

    # ------------------------------------------------------------- scaling
    def scaled(self, n_layers: int = 2, d_model: int = 64, n_heads: int = 4,
               n_kv_heads: Optional[int] = None, d_ff: int = 128,
               vocab: int = 256, n_experts: Optional[int] = None) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        kv = n_kv_heads if n_kv_heads is not None else max(1, n_heads // 2)
        if self.attn_kind != "gqa":
            kv = n_heads if self.n_kv_heads == self.n_heads else kv
        updates = dict(
            n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=min(kv, n_heads), d_ff=d_ff, vocab_size=vocab,
            head_dim=d_model // n_heads, max_seq_len=256,
        )
        if self.attn_kind == "mla":
            updates.update(q_lora_rank=32, kv_lora_rank=32, qk_rope_dim=8,
                           qk_nope_dim=8, v_head_dim=d_model // n_heads)
        if self.moe:
            ne = n_experts if n_experts is not None else min(self.n_experts, 8)
            updates.update(n_experts=ne, top_k=min(self.top_k, ne),
                           moe_d_ff=d_ff, n_dense_layers=min(self.n_dense_layers, 1))
        if self.window is not None:
            updates.update(window=32)
        if self.chunk_size is not None:
            updates.update(chunk_size=32)
        if self.enc_dec:
            updates.update(n_enc_layers=n_layers, n_dec_layers=n_layers)
        if self.ssm_kind is not None:
            updates.update(ssm_state=16)
        if self.hybrid_every:
            updates.update(hybrid_every=max(1, n_layers // 2))
        return dataclasses.replace(self, **updates)


def register_arch(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        import importlib
        importlib.import_module("repro_torch.configs")  # registers all assigned archs
    return _REGISTRY[name]


def list_archs():
    import importlib
    importlib.import_module("repro_torch.configs")  # registers all assigned archs
    return sorted(_REGISTRY)
