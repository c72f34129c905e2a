"""The program's spans inside a traced batch's decode steps, for the
``program_span`` readers of serving cells.

The server opens one ``serve.step`` span (attribute ``phase``) a step;
the spans the model opens inside it (``mla.expand``, ``mla.attend``: one
a layer) are its children. Under the decode trace every decode step's
``serve.step`` is recorded, the first too: its ``serve.decode`` opened
before the profiler started, so there it is a root.

Unlike ``spans.recorded``, these readers do not ask the device trace to
be whole. A decode trace sometimes loses the events at its end, the last
layers' launches among them (ROADMAP E1), and the harness traces a batch
once; the spans were recorded all the same, and their device marks are
CUDA events of their own, which a trace that misses kernels leaves as
they are. They ask only that the decode trace ran in this run.
"""

from __future__ import annotations

import statistics
from typing import List, Optional


def decode_steps(run) -> list:
    """The ``serve.step`` spans of phase ``decode`` opened after ``run``
    began, where ``run`` traced a batch's decode steps; [] where it did
    not, or the program keeps no spans."""
    if not any(s["name"] == "decode" for s in run.segments):
        return []
    try:
        from repro_torch.obs import trace
    except ImportError:
        return []
    program = getattr(trace, "PROGRAM", None)
    if program is None:
        return []
    return [s for s in program.spans("serve.step") if s.wall_start >= run.t0
            and s.attrs.get("phase") == "decode"]


def decode_step_device_ms(run, name: str) -> Optional[float]:
    """The median over the traced batch's decode steps of the summed
    ``device_ms`` of the step's child spans called ``name``, in ms (None
    where no step has all of them marked)."""
    per_step: List[float] = []
    for step in decode_steps(run):
        ms = [c.device_ms for c in step.children if c.name == name]
        if ms and None not in ms:
            per_step.append(sum(ms))
    return statistics.median(per_step) if per_step else None
