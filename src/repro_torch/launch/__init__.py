"""Launch layer: LM serving (``serve``), the training loop (``train``:
``TrainConfig``, ``train``, ``main``) and its step builders (``specs``).
Meshes, sharding policies and the dry-run are not ported yet (ROADMAP A3).
The training modules load on first use, so ``python -m
repro_torch.launch.train`` runs its module once."""
import importlib

from . import serve

__all__ = ["serve", "specs", "train", "TrainConfig"]


def __getattr__(name):
    if name in ("specs", "train"):
        return importlib.import_module(f"{__name__}.{name}")
    if name == "TrainConfig":
        return importlib.import_module(f"{__name__}.train").TrainConfig
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
