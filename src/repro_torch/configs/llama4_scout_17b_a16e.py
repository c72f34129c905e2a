"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert, chunked
local attention (iRoPE-style) [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""
from ..models.arch import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    attn_kind="gqa", rope_kind="rope", chunk_size=8192,
    moe=True, n_experts=16, top_k=1, moe_d_ff=8192,
    n_shared_experts=1, n_dense_layers=0,
))
