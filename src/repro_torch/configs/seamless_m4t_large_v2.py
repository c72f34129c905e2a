"""seamless-m4t-large-v2 — audio enc-dec; speech frontend is a STUB
(input_specs provides precomputed frame embeddings) [arXiv:2308.11596; hf]."""
from ..models.arch import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206, head_dim=64,
    attn_kind="gqa", rope_kind="rope", frontend="audio",
    enc_dec=True, n_enc_layers=24, n_dec_layers=24,
))
