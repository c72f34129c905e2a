"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf]."""
from ..models.arch import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32000, head_dim=80,
    attn_kind="gqa", rope_kind="rope", window=4096,
))
