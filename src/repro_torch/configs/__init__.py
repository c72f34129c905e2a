"""Assigned architecture configs (--arch <id>). Importing this package
registers all 10 architectures with the registry in repro_torch.models.arch."""

from . import (h2o_danube_1_8b, internlm2_20b, kimi_k2_1t_a32b,
               llama4_scout_17b_a16e, minicpm3_4b, qwen2_vl_72b, rwkv6_3b,
               seamless_m4t_large_v2, stablelm_12b, zamba2_1_2b)
from ..models.arch import get_arch, list_archs

# the submodule imports above are side-effecting (each registers its arch);
# re-export them so the bindings are part of the package surface
__all__ = [
    "h2o_danube_1_8b", "internlm2_20b", "kimi_k2_1t_a32b",
    "llama4_scout_17b_a16e", "minicpm3_4b", "qwen2_vl_72b", "rwkv6_3b",
    "seamless_m4t_large_v2", "stablelm_12b", "zamba2_1_2b",
    "get_arch", "list_archs", "ALL_ARCHS",
]

ALL_ARCHS = [
    "stablelm-12b", "minicpm3-4b", "h2o-danube-1.8b", "internlm2-20b",
    "rwkv6-3b", "zamba2-1.2b", "qwen2-vl-72b", "seamless-m4t-large-v2",
    "llama4-scout-17b-a16e", "kimi-k2-1t-a32b",
]

# (shape name, seq_len, global_batch, step kind)
SHAPES = {
    "train_4k":    dict(seq_len=4096,   global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768,  global_batch=32,  kind="prefill"),
    "decode_32k":  dict(seq_len=32768,  global_batch=128, kind="decode"),
    "long_500k":   dict(seq_len=524288, global_batch=1,   kind="decode"),
}

__all__ = ["ALL_ARCHS", "SHAPES", "get_arch", "list_archs"]
