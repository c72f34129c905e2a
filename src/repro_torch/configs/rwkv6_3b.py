"""rwkv6-3b (Finch) — attention-free RNN with data-dependent decay
[arXiv:2404.05892; hf]. head size 64 -> 40 heads."""
from ..models.arch import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65536, head_dim=64,
    attn_kind="none", rope_kind="none", ssm_kind="rwkv6", ssm_state=64,
))
