"""Launch layer: LM serving. Meshes, sharding policies and the training
loop are not ported yet (ROADMAP A3)."""
from . import serve

__all__ = ["serve"]
