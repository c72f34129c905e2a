"""Model definitions: architecture registry, layers, assembly (dense GQA/SWA
with RoPE or M-RoPE, MLA and RWKV6 so far; the other families raise until
ROADMAP A2)."""

from .arch import ArchConfig, get_arch, list_archs, register_arch
from .model import forward, init_params, make_caches
from .layers import NULL_POLICY, NullPolicy

__all__ = [
    "ArchConfig", "get_arch", "list_archs", "register_arch",
    "forward", "init_params", "make_caches",
    "NULL_POLICY", "NullPolicy",
]
