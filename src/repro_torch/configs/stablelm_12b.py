"""stablelm-12b — dense GQA transformer [hf:stabilityai/stablelm-2-1_6b family; hf]."""
from ..models.arch import ArchConfig, register_arch

CONFIG = register_arch(ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab_size=100352, head_dim=160,
    attn_kind="gqa", rope_kind="rope",
))
