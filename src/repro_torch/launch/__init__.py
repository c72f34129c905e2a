"""Launch layer: meshes (``mesh``), sharding policies (``sharding``), LM
serving (``serve``), the training loop (``train``: ``TrainConfig``,
``train``, ``main``), its step builders and abstract inputs (``specs``),
and the dry-run (``dryrun``).

The dry-run is NOT imported here: it runs as ``python -m
repro_torch.launch.dryrun``. The training modules load on first use, so
``python -m repro_torch.launch.train`` runs its module once."""
import importlib

from . import serve
from .mesh import make_mesh, make_production_mesh, mesh_info
from .sharding import (STRATEGIES, MeshPolicy, batch_specs, make_policy,
                       param_specs)

__all__ = ["make_mesh", "make_production_mesh", "mesh_info", "MeshPolicy",
           "STRATEGIES", "batch_specs", "make_policy", "param_specs",
           "serve", "specs", "train", "TrainConfig"]


def __getattr__(name):
    if name in ("specs", "train"):
        return importlib.import_module(f"{__name__}.{name}")
    if name == "TrainConfig":
        return importlib.import_module(f"{__name__}.train").TrainConfig
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
