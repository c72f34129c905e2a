"""Compiled plan execution tier.

Lowers a winning plan's data-parallel regions — cursor loops with slot
queries, prefetch+lookup joins, fold/aggregation bodies — to columnar
vectorized executables backed by the ``repro_torch.kernels`` CUDA kernels
(``join_probe``, ``segment_reduce``; their plain torch versions for CPU
tables), or the ``kernels.ref`` numpy reference paths. Regions outside the
columnar vocabulary (``while`` guards, early exits, update-carrying
bodies) keep their interpreter binding; the :class:`SplicingInterpreter`
splices compiled segments around them, so every program runs end to end
on whichever mix of tiers its regions support.

Execution is **bit- and clock-identical** to the interpreted tier by
construction: compiled loops run through the same
:func:`repro_torch.core.vectorize.exec_loop_plan` statement walk (which owns all
simulated-time charging), and the kernel-backed probe indices are keyed by
the same (instance, stats version, data version) epochs the serving
SiteCache tracks, so mid-stream ``analyze()``/writes rebuild them instead
of serving stale gathers.

  lower   — compilability-driven lowering: ``lower_program`` ->
            :class:`LoweredProgram` (bound :class:`CompiledLoop` s)
  exec    — kernel-backed :class:`~repro_torch.core.vectorize.LoopHooks` and the
            :class:`SplicingInterpreter` tiered fallback
  manager — :class:`CompileManager`: heat-based promotion of hot
            (program, plan, context) pairs, content-addressed artifact
            cache, drift-driven invalidation
"""

from .exec import SplicingInterpreter
from .lower import (CompiledLoop, LoweredProgram, available_backends,
                    lower_program, resolve_backend)
from .manager import CompiledArtifact, CompileManager

__all__ = [
    "CompiledLoop", "LoweredProgram", "lower_program",
    "available_backends", "resolve_backend",
    "SplicingInterpreter",
    "CompileManager", "CompiledArtifact",
]
