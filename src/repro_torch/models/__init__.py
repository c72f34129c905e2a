"""Model definitions: architecture registry, layers, assembly and the
training losses, for all ten registered architectures (dense GQA/SWA with
RoPE or M-RoPE, MLA, RWKV6, Mamba2 / Zamba2, MoE, encoder-decoder)."""

from .arch import ArchConfig, get_arch, list_archs, register_arch
from .model import forward, init_params, lm_loss, loss_fn, make_caches
from .layers import NULL_POLICY, NullPolicy

__all__ = [
    "ArchConfig", "get_arch", "list_archs", "register_arch",
    "forward", "init_params", "make_caches", "lm_loss", "loss_fn",
    "NULL_POLICY", "NullPolicy",
]
