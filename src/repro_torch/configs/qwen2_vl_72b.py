"""qwen2-vl-72b — VLM backbone with M-RoPE; vision frontend is a STUB
(input_specs provides precomputed patch embeddings) [arXiv:2409.12191; hf]."""
from ..models.arch import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    attn_kind="gqa", rope_kind="mrope", frontend="vision",
))
