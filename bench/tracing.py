"""Device traces of a few units of work (training steps, a prefill, a
batch's decode steps) by ``torch.profiler``, and what is read from them.

The helpers are copies of ``chip_smoke.py``'s ``_busy_union_ms``,
``_kernel_name``, ``_trace_whole``, ``_warm_profiler`` and the pieces of
``_device_ms_by_kind``'s classifier, kept here so that the yardstick does
not move with the program. Only the card's activity is traced: a trace
of the host's ops as well would take minutes to parse at tens of
thousands of launches a step. A trace can miss the kernels launched
first in it, so each is opened over a warm-up step of small stand-in
kernels, and a trace is held only where it is whole: each expected
kernel seen as many times as the traced work launches it, and (for
repeated units) every name a multiple of the units.

A segment is ``{"name", "wall_s", "units", "work", "events", "faults"}``:
``events`` the device activities as ``(name, start_us, end_us)``,
``wall_s`` the host's clock over the traced units (ended by a
synchronize), ``work`` what the roofline readers need to count the
units' operations.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

TRACE_WARM_S = 0.25
TRACE_TRIES = 3

# pieces of the names of the port's hand-written kernels and of cuBLAS's
# products (``_device_ms_by_kind``'s); the rest is eager elementwise,
# copy, cast, fill and reduction work
HAND_WRITTEN = ("flash_fwd", "flash_combine", "flash_bwd", "rwkv6_")
GEMM = ("gemm", "cutlass", "xmma", "nvjet", "cublas")

Event = Tuple[str, float, float]


def kernel_name(name: str) -> str:
    """A device event's name without its signature: ``void f<64>(...)``
    reads ``f<64>``."""
    return re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", name)


def is_eager(name: str) -> bool:
    """Neither a hand-written kernel of the port nor a cuBLAS product."""
    low = name.lower()
    return not any(p in low for p in HAND_WRITTEN + GEMM)


def warm_profiler(device) -> None:
    """Small kernels on the card for ``TRACE_WARM_S`` seconds: the
    profiler's warm-up step, so that the traced work is not what a trace
    misses at its start."""
    import torch
    x = torch.zeros(1024, device=device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < TRACE_WARM_S:
        for _ in range(64):
            x.add_(1.0)
        torch.cuda.synchronize(device)


def device_events(prof) -> List[Event]:
    from torch.autograd import DeviceType
    return sorted((kernel_name(e.name), e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep"))


def faults_of(events: Sequence[Event], units: int,
              expect: Dict[str, int], repeated: bool) -> List[str]:
    """What keeps a trace from being whole: each expected name piece seen
    another number of times than expected, and where ``repeated`` (the
    units launch the same work) each name seen a count that is not a
    multiple of ``units``."""
    counts: Dict[str, int] = {}
    for name, _, _ in events:
        counts[name] = counts.get(name, 0) + 1
    if not counts:
        return ["no device events"]
    out = []
    for piece, n in expect.items():
        seen = sum(c for name, c in counts.items() if piece in name)
        if seen != n:
            out.append(f"{piece} x{seen}, expected {n}")
    if repeated:
        out += [f"{n} x{c}" for n, c in counts.items() if c % units]
    return out


class Session:
    """One trace, opened over a warm-up step and closed by :meth:`close`
    (so a trace may begin and end inside a call of the program)."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile, schedule
        import torch
        cuda = torch.device(device).type == "cuda"
        self._sync = (lambda: torch.cuda.synchronize(device)) if cuda \
            else (lambda: None)
        # on the CPU (the tests) the host's ops: no device events
        self.prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                        else ProfilerActivity.CPU],
                            schedule=schedule(wait=0, warmup=1, active=1,
                                              repeat=1))
        self.prof.start()
        if cuda:
            warm_profiler(device)
        self.prof.step()
        self.t0 = time.perf_counter()

    def close(self) -> Tuple[float, List[Event]]:
        self._sync()
        wall = time.perf_counter() - self.t0
        self.prof.step()
        self.prof.stop()
        return wall, device_events(self.prof)


def segment(name: str, wall: float, events: List[Event], units: int,
            work: dict, expect: Dict[str, int], repeated: bool) -> dict:
    return {"name": name, "wall_s": wall, "units": units, "work": work,
            "events": events,
            "faults": faults_of(events, units, expect, repeated)}


def trace_units(name: str, fn: Callable[[], None], units: int, work: dict,
                expect: Dict[str, int], device) -> dict:
    """``units`` calls of ``fn`` under a trace, tried up to
    ``TRACE_TRIES`` times until whole; the last try's segment either
    way (its ``faults`` then say why it is not)."""
    for _ in range(TRACE_TRIES):
        s = Session(device)
        for _ in range(units):
            fn()
        wall, events = s.close()
        seg = segment(name, wall, events, units, work, expect, True)
        if not seg["faults"]:
            break
    return seg


def busy_s(events: Iterable[Event]) -> float:
    """The union of the intervals in which the card ran anything, in
    seconds (each instant counted once, however activities overlap)."""
    total, end = 0.0, float("-inf")
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e6


def time_in(events: Iterable[Event], pieces: Sequence[str]) -> float:
    """Seconds of device activity whose name holds one of ``pieces``."""
    return sum(b - a for n, a, b in events
               if any(p in n for p in pieces)) / 1e6


def whole(segments: Iterable[dict], name: str) -> Optional[List[dict]]:
    """The segments called ``name``, or None where there are none or any
    is not whole (its readers then return nothing)."""
    segs = [s for s in segments if s["name"] == name]
    if not segs or any(s["faults"] for s in segs):
        return None
    return segs


def breakdown(segments: Sequence[dict], top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps, each named by the segment and the activities on either side."""
    by_name: Dict[str, float] = {}
    gaps = []
    for s in segments:
        ev = sorted(s["events"], key=lambda e: e[1])
        for n, a, b in ev:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
        end, last = None, None
        for n, a, b in ev:
            if end is not None and a > end:
                gaps.append((f"{s['name']}: after {last[:60]} before {n[:60]}",
                             (a - end) / 1e6))
            if end is None or b > end:
                end, last = b, n
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(gaps, key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, t] for n, t in ops],
            "idle_gaps": [[n, t] for n, t in gaps]}
