"""A kernel's share of its roofline over traced segments: the sum of its
calls' least times (from the shapes, ``roofline/<kernel>.py``) over the
sum of the traced device time of its launches (by the kernel's name
pieces). Nothing where no segment of the phase is whole or no launch of
the kernel was traced."""

from __future__ import annotations

from typing import Optional

from bench import harness, tracing


def share(run, kernel: str, phase: str) -> Optional[float]:
    segs = tracing.whole(run.segments, phase)
    if segs is None:
        return None
    mod = harness.roofline(kernel)
    precision = run.config["torch_dtype"]
    least = sum(n * mod.least_s(call, precision)
                for s in segs for call, n in mod.calls(run.config, s["work"]))
    spent = sum(tracing.time_in(s["events"], mod.PIECES) for s in segs)
    if least <= 0 or spent <= 0:
        return None
    return 100.0 * least / spent
