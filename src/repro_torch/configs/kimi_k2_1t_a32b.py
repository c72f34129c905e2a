"""kimi-k2-1t-a32b — trillion-parameter MoE: 384 experts top-8 + 1 shared,
per-expert d_ff=2048 (the assigned spec), GQA kv=8, first layer dense
[arXiv:2501.kimi2; unverified, paper-table]."""
from ..models.arch import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=18432,              # dense layers use the wide MLP
    vocab_size=163840, head_dim=128,
    attn_kind="gqa", rope_kind="rope",
    moe=True, n_experts=384, top_k=8, moe_d_ff=2048,
    n_shared_experts=1, n_dense_layers=1,
))
