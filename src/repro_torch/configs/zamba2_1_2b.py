"""zamba2-1.2b — Mamba2 backbone with ONE shared attention block applied
periodically [arXiv:2411.15242; hf]."""
from ..models.arch import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    attn_kind="gqa", rope_kind="rope", ssm_kind="mamba2", ssm_state=64,
    hybrid_every=6, shared_attn=True,
))
