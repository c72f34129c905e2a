"""minicpm3-4b — dense transformer with MLA (multi-head latent attention)
and MiniCPM's scaled embedding, residual branches and logits
[hf:openbmb/MiniCPM3-4B; hf; the scalings arXiv:2404.06395]."""
from ..models.arch import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73448, head_dim=64,
    attn_kind="mla", rope_kind="rope",
    q_lora_rank=768, kv_lora_rank=256, qk_rope_dim=32, qk_nope_dim=64,
    v_head_dim=64,
    scale_emb=12.0, scale_depth=1.4, dim_model_base=256,
    max_seq_len=32768,
))
