"""Serving observability: trace spans and the metrics registry.

  * :mod:`repro_torch.obs.trace` — nested wall+simulated-clock spans (compile →
    saturation rounds; serve → batch → site fetch → kernel invoke → swap
    verdicts), JSONL export, text flamegraph rendering; a no-op tracer by
    default so the hot path pays only a branch;
  * :mod:`repro_torch.obs.metrics` — labeled counters/gauges/histograms with
    ``snapshot()``/``diff()``; the legacy telemetry dicts are
    backwards-compatible views over per-component registries.

The plan diagnostics of the reference package (``explain``, ``signals``,
``triage``) are not ported yet.
"""

from .metrics import MetricsRegistry, merge_snapshots, registry_counter
from .render import fmt_seconds, markdown_table
from .trace import NOOP_TRACER, NoopTracer, Span, Tracer

__all__ = [
    "MetricsRegistry", "registry_counter", "merge_snapshots",
    "fmt_seconds", "markdown_table",
    "Tracer", "NoopTracer", "Span", "NOOP_TRACER",
]
