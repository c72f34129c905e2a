"""Serving observability: trace spans, metrics registry, plan diagnostics.

Four pieces, threaded through every tier of the framework:

  * :mod:`repro_torch.obs.trace` — nested wall+simulated-clock spans (compile →
    saturation rounds; serve → batch → site fetch → kernel invoke → swap
    verdicts), JSONL export, text flamegraph rendering; a no-op tracer by
    default so the hot path pays only a branch; and the LM paths'
    process-wide recorder ``PROGRAM`` (train step phases, data waits,
    decode steps), recording while a ``torch.profiler`` records, or
    always once :func:`program_tracing` says ``"on"``;
  * :mod:`repro_torch.obs.metrics` — labeled counters/gauges/histograms with
    ``snapshot()``/``diff()``; the legacy telemetry dicts are
    backwards-compatible views over per-component registries;
  * :mod:`repro_torch.obs.explain` / :mod:`repro_torch.obs.signals` —
    ``explain()`` renders the winning region tree annotated with estimated
    cost, rule provenance, estimated-vs-observed counts and q-error;
    ``scan_plan()`` detects known bad-plan patterns (N+1 navigation,
    query-inside-while, unbatched writes, cache-hostile binding diversity,
    interpreter-bound hot loops) as structured
    :class:`~repro_torch.obs.signals.Signal`\\ s;
  * :mod:`repro_torch.obs.triage` — ranks a serving fleet's programs by
    traffic-weighted estimated win so re-optimization follows the traffic.

``signals``/``explain``/``triage`` load lazily (PEP 562): they import the
API layer, which itself imports ``obs.trace``/``obs.metrics``.
"""

from .metrics import MetricsRegistry, merge_snapshots, registry_counter
from .render import fmt_seconds, markdown_table
from .trace import (NOOP_TRACER, PROGRAM, NoopTracer, ProgramRecorder, Span,
                    Tracer, program_span, program_tracing)

__all__ = [
    "MetricsRegistry", "registry_counter", "merge_snapshots",
    "fmt_seconds", "markdown_table",
    "Tracer", "NoopTracer", "Span", "NOOP_TRACER", "ProgramRecorder",
    "PROGRAM", "program_span", "program_tracing",
    "Signal", "scan_plan", "explain_plan", "TriageRow", "triage_fleet",
    "render_triage",
]

_LAZY = {
    "Signal": ("signals", "Signal"),
    "scan_plan": ("signals", "scan_plan"),
    "explain_plan": ("explain", "explain_plan"),
    "TriageRow": ("triage", "TriageRow"),
    "triage_fleet": ("triage", "triage_fleet"),
    "render_triage": ("triage", "render_triage"),
}


def __getattr__(name):
    entry = _LAZY.get(name)
    if entry is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    mod = importlib.import_module(f".{entry[0]}", __name__)
    val = getattr(mod, entry[1])
    globals()[name] = val
    return val
