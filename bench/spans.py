"""The program's own spans, for the ``program_span`` readers.

The port's LM paths record spans into one process-wide recorder,
``repro_torch.obs.trace.PROGRAM``, and by default only while a
``torch.profiler`` records: in a run, the harness's traced units. A
reader takes the spans of one name that opened after the run began, and
only where the traced segment they belong to is whole, as the device
trace's readers do. The training trace is tried up to three times and
keeps its last try, so its steps are the last ``units`` recorded: the
steps of a try it discarded lie ahead of them. A checkout whose program
has no recorder gives no spans, and its readers then find nothing.

``device_ms`` is the CUDA stream's time between a span's two marks: the
device work enqueued inside it plus any idle inside. ``wall_s`` is the
host's time in the span.
"""

from __future__ import annotations

import statistics
from typing import List, Optional

from bench import tracing


def recorded(run, name: str, segment: str, **attrs) -> list:
    """The program's spans called ``name`` with the attribute values
    ``attrs`` that opened after ``run`` began, where ``run``'s traced
    segment ``segment`` is whole; [] where it is not, or the program keeps
    no spans."""
    if tracing.whole(run.segments, segment) is None:
        return []
    try:
        from repro_torch.obs import trace
    except ImportError:
        return []
    program = getattr(trace, "PROGRAM", None)
    if program is None:
        return []
    return [s for s in program.spans(name) if s.wall_start >= run.t0
            and all(s.attrs.get(k) == v for k, v in attrs.items())]


def median_host_ms(spans: list) -> Optional[float]:
    """The median of the spans' host times, in ms (None without spans)."""
    if not spans:
        return None
    return statistics.median(s.wall_s for s in spans) * 1e3


def train_steps(run) -> list:
    """The ``train.step`` spans of the training trace's kept try: the last
    ``units`` recorded; [] where the trace is not whole."""
    steps = recorded(run, "train.step", "train")
    if not steps:
        return []
    return steps[-tracing.whole(run.segments, "train")[-1]["units"]:]


def step_device_ms(run, phase: str) -> Optional[float]:
    """The median over the training trace's kept steps of the summed
    ``device_ms`` of their child spans called ``phase``, in ms (None where
    no step has all of them marked)."""
    per_step: List[float] = []
    for step in train_steps(run):
        ms = [c.device_ms for c in step.children if c.name == phase]
        if ms and None not in ms:
            per_step.append(sum(ms))
    return statistics.median(per_step) if per_step else None
