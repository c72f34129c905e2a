"""Trace spans: nested wall-clock + simulated-clock timing, near-free off.

A :class:`Tracer` records a tree of :class:`Span`\\ s — compile → rule
saturation rounds → costing; serve → batch → site fetch / cache hit →
compiled-kernel invoke → swap verdicts. Each span carries wall time
(``perf_counter``), its ends on the profiler's clock (``time.time_ns()``,
the clock ``torch.profiler`` stamps its trace with) and, when the caller
passes a ``sim_clock`` callable (e.g. ``lambda: env.clock``), the
simulated clock interval too. Export as JSONL (:meth:`Tracer.export_jsonl`)
or render a text flamegraph-style tree (:meth:`Tracer.render`).

The default everywhere is the module singleton :data:`NOOP_TRACER`: its
``span()`` returns a shared no-op handle, so an instrumented hot path pays
one attribute load and a branch — nothing is allocated, nothing recorded.
Hot inner loops guard event emission with ``if tracer.enabled:``.

The LM paths (the train step of ``launch.specs``, ``launch.serve.Server``,
``data.Prefetcher``) record into one process-wide recorder instead,
:data:`PROGRAM`, through :func:`program_span`: whoever drives them (the
benchmark, an operator's script) reads it afterwards without handing a
tracer in. :func:`program_tracing` sets its mode:

  * ``"profiler"`` (the default): a span records only if a
    ``torch.profiler`` is recording when it opens, so a traced window
    gets its spans and an untraced one pays one check a span;
  * ``"on"``: every span records.

A span opened with a tensor as ``mark`` also records a CUDA timing event
on the current stream of that tensor's device at each end (drawn from a
pool, never synchronized on the hot path); :attr:`Span.device_ms` reads
the stream's time between them once the work is done. No span adds a
``record_function`` range or any other event to a profiler's device
trace. The recorder keeps the newest :data:`PROGRAM_CAPACITY` root
spans, each with its children.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["Span", "Tracer", "NoopTracer", "NOOP_TRACER", "ProgramRecorder",
           "PROGRAM", "PROGRAM_CAPACITY", "program_span", "program_tracing"]


class Span:
    __slots__ = ("name", "attrs", "wall_start", "wall_end", "start_ns",
                 "end_ns", "sim_start", "sim_end", "children", "_marks",
                 "_device_ms")

    def __init__(self, name: str, attrs: Optional[Dict[str, object]] = None):
        self.name = name
        self.attrs: Dict[str, object] = attrs or {}
        self.wall_start: float = 0.0
        self.wall_end: Optional[float] = None
        self.start_ns: int = 0                 # time.time_ns() at entry
        self.end_ns: Optional[int] = None
        self.sim_start: Optional[float] = None
        self.sim_end: Optional[float] = None
        self.children: List["Span"] = []
        self._marks = None      # (device index, start event, end event)
        self._device_ms: Optional[float] = None

    @property
    def wall_s(self) -> float:
        end = self.wall_end if self.wall_end is not None \
            else time.perf_counter()
        return end - self.wall_start

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds on the marked CUDA stream from the span's entry
        mark to its exit mark: the device work enqueued in between plus
        any idle inside. None for a span without marks (none asked for,
        or not on a CUDA device) or still open. The first read waits for
        the exit mark to complete, then returns both events to the pool."""
        marks = self._marks
        if marks is not None and marks[2] is not None:
            index, start, end = marks
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._marks = None
            _EVENTS.give(index, start, end)
        return self._device_ms

    @device_ms.setter
    def device_ms(self, ms: Optional[float]) -> None:
        self._marks = None
        self._device_ms = ms

    @property
    def sim_s(self) -> Optional[float]:
        if self.sim_start is None or self.sim_end is None:
            return None
        return self.sim_end - self.sim_start

    def __repr__(self):
        return f"Span({self.name!r}, {len(self.children)} child(ren))"


class _SpanHandle:
    """Context manager entering/exiting one span on its tracer's stack;
    with a tensor as ``mark``, the span's device marks on the current
    stream of that tensor's device where it is a CUDA device (the host
    stamps enclose the marks)."""

    __slots__ = ("tracer", "span", "sim_clock", "mark")

    def __init__(self, tracer: "Tracer", span: Span,
                 sim_clock: Optional[Callable[[], float]],
                 mark: Optional[torch.Tensor] = None):
        self.tracer = tracer
        self.span = span
        self.sim_clock = sim_clock
        self.mark = mark

    def __enter__(self) -> Span:
        t, sp = self.tracer, self.span
        stack = t._stack
        (stack[-1].children if stack else t.roots).append(sp)
        stack.append(sp)
        if self.sim_clock is not None:
            sp.sim_start = self.sim_clock()
        sp.start_ns = time.time_ns()
        sp.wall_start = time.perf_counter()
        if self.mark is not None and self.mark.device.type == "cuda":
            index = self.mark.device.index
            sp._marks = (index, _mark(index), None)
        return sp

    def __exit__(self, exc_type, exc, tb):
        sp = self.span
        marks = sp._marks
        if marks is not None:
            sp._marks = (marks[0], marks[1], _mark(marks[0]))
        sp.wall_end = time.perf_counter()
        sp.end_ns = time.time_ns()
        if self.sim_clock is not None:
            sp.sim_end = self.sim_clock()
        stack = self.tracer._stack
        # robust to mismatched exits: pop until (and including) our span
        while stack:
            if stack.pop() is sp:
                break
        return False


class Tracer:
    """Recording tracer. ``enabled`` is True so call sites can guard
    per-event work with a single branch."""

    enabled = True

    def __init__(self):
        self.reset()

    # ------------------------------------------------------------ recording
    def span(self, name: str,
             sim_clock: Optional[Callable[[], float]] = None,
             mark: Optional[torch.Tensor] = None, **attrs) -> _SpanHandle:
        return _SpanHandle(self, Span(name, attrs), sim_clock, mark)

    def event(self, name: str,
              sim_clock: Optional[Callable[[], float]] = None,
              sim: Optional[float] = None, **attrs) -> Span:
        """A zero-duration span attached to the current parent. Hot call
        sites pass the simulated clock by value (``sim=``) to skip the
        callable indirection."""
        sp = Span(name, attrs)
        now = time.perf_counter()
        sp.wall_start = sp.wall_end = now
        sp.start_ns = sp.end_ns = time.time_ns()
        if sim is None and sim_clock is not None:
            sim = sim_clock()
        if sim is not None:
            sp.sim_start = sp.sim_end = sim
        stack = self._stack
        (stack[-1].children if stack else self.roots).append(sp)
        return sp

    def reset(self) -> None:
        self.roots: List[Span] = []
        self._stack: List[Span] = []

    # ------------------------------------------------------------ inspection
    def well_nested(self) -> bool:
        """Every span closed, and every child's wall interval inside its
        parent's (the invariant mid-stream analyze()/replace_table/plan
        swaps must not break)."""
        if self._stack:
            return False
        eps = 1e-9

        def check(sp: Span) -> bool:
            if sp.wall_end is None or sp.wall_end + eps < sp.wall_start:
                return False
            for c in sp.children:
                if c.wall_start + eps < sp.wall_start:
                    return False
                if c.wall_end is None or c.wall_end > sp.wall_end + eps:
                    return False
                if not check(c):
                    return False
            return True

        return all(check(r) for r in self.roots)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        """Flattened depth-first span list, optionally filtered by name."""
        out: List[Span] = []

        def walk(sp: Span):
            if name is None or sp.name == name:
                out.append(sp)
            for c in sp.children:
                walk(c)

        for r in self.roots:
            walk(r)
        return out

    # -------------------------------------------------------------- export
    def to_dicts(self) -> List[Dict[str, object]]:
        """Flatten to one dict per span with id/parent/depth links — the
        JSONL record shape."""
        out: List[Dict[str, object]] = []

        def walk(sp: Span, parent_id: Optional[int], depth: int):
            sid = len(out)
            rec: Dict[str, object] = {
                "id": sid, "parent": parent_id, "depth": depth,
                "name": sp.name, "wall_s": sp.wall_s,
                "start_ns": sp.start_ns, "end_ns": sp.end_ns,
            }
            if sp.sim_s is not None:
                rec["sim_s"] = sp.sim_s
            if sp.device_ms is not None:
                rec["device_ms"] = sp.device_ms
            if sp.attrs:
                rec["attrs"] = dict(sp.attrs)
            out.append(rec)
            for c in sp.children:
                walk(c, sid, depth + 1)

        for r in self.roots:
            walk(r, None, 0)
        return out

    def export_jsonl(self, path: str) -> int:
        """Write one JSON record per span; returns the record count."""
        recs = self.to_dicts()
        with open(path, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec, default=str) + "\n")
        return len(recs)

    def render(self, min_wall_s: float = 0.0) -> str:
        """Text flamegraph-style tree: nesting by indentation, wall (and
        simulated, when captured) duration per span."""
        from .render import fmt_seconds
        lines: List[str] = []

        def walk(sp: Span, prefix: str, is_last: bool, top: bool):
            if sp.wall_s < min_wall_s:
                return
            connector = "" if top else ("└─ " if is_last else "├─ ")
            parts = [f"{sp.name}  {fmt_seconds(sp.wall_s)} wall"]
            if sp.sim_s is not None:
                parts.append(f"{sp.sim_s:.4g}s sim")
            if sp.attrs:
                parts.append(" ".join(f"{k}={v}" for k, v in sp.attrs.items()))
            lines.append(prefix + connector + "  ".join(parts))
            kids = [c for c in sp.children if c.wall_s >= min_wall_s]
            child_prefix = prefix if top else \
                prefix + ("   " if is_last else "│  ")
            for i, c in enumerate(kids):
                walk(c, child_prefix, i == len(kids) - 1, False)

        for r in self.roots:
            walk(r, "", True, True)
        return "\n".join(lines)


class _NoopHandle:
    __slots__ = ()

    def __enter__(self) -> Span:
        return _NOOP_SPAN

    def __exit__(self, exc_type, exc, tb):
        return False


class NoopTracer:
    """The default tracer: a branch and nothing else on the hot path."""

    enabled = False

    roots: List[Span] = []

    def span(self, name: str, sim_clock=None, **attrs) -> _NoopHandle:
        return _NOOP_HANDLE

    def event(self, name: str, sim_clock=None, sim=None, **attrs) -> Span:
        return _NOOP_SPAN

    def reset(self) -> None:
        pass

    def well_nested(self) -> bool:
        return True

    def spans(self, name=None) -> List[Span]:
        return []

    def to_dicts(self) -> List[Dict[str, object]]:
        return []

    def export_jsonl(self, path: str) -> int:
        return 0

    def render(self, min_wall_s: float = 0.0) -> str:
        return ""


_NOOP_SPAN = Span("noop")
_NOOP_HANDLE = _NoopHandle()
NOOP_TRACER = NoopTracer()


# --------------------------------------------------------------------------
# the program recorder: the LM paths' process-wide spans
# --------------------------------------------------------------------------

PROGRAM_CAPACITY = 100_000
_MODES = ("profiler", "on")
_mode = "profiler"
_profiler_enabled = torch._C._autograd._profiler_enabled


class _EventPool:
    """Timing events for device marks, by device index. A span's two
    events come back once its ``device_ms`` has been read (creating an
    event costs a driver call)."""

    def __init__(self):
        self._free: Dict[int, list] = {}

    def take(self, index: int):
        free = self._free.get(index)
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def give(self, index: int, *events) -> None:
        self._free.setdefault(index, []).extend(events)


_EVENTS = _EventPool()


def _mark(index: int):
    event = _EVENTS.take(index)
    event.record(torch.cuda.current_stream(index))
    return event


class ProgramRecorder(Tracer):
    """A :class:`Tracer` that keeps only the newest ``capacity`` root
    spans (each with its children) and a stack of open spans per thread;
    a span whose parent was not recorded is a root."""

    def __init__(self, capacity: int = PROGRAM_CAPACITY):
        self.capacity = capacity
        super().__init__()

    @property
    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def reset(self) -> None:
        self.roots: "collections.deque[Span]" = collections.deque(
            maxlen=self.capacity)
        self._local = threading.local()


PROGRAM = ProgramRecorder()
"""The spans of the port's LM paths, read after the fact (by the
benchmark's ``program_span`` readers, or an operator's script)."""


def program_tracing(mode: Optional[str] = None) -> str:
    """Set :data:`PROGRAM`'s mode, ``"profiler"`` or ``"on"`` (None keeps
    it), and return the mode it had."""
    global _mode
    before = _mode
    if mode is not None:
        if mode not in _MODES:
            raise ValueError(f"program tracing mode {mode!r}; one of "
                             f"{_MODES}")
        _mode = mode
    return before


def program_span(name: str, mark: Optional[torch.Tensor] = None):
    """A span of the LM paths in :data:`PROGRAM`, recorded as the mode
    says; with a tensor as ``mark``, device marks on the current stream
    of its device where that is a CUDA device. A span not recorded costs
    the mode check and one call asking torch whether a profiler records,
    and allocates nothing: its handle is the shared no-op one, whose span
    takes ``attrs`` writes that nothing reads."""
    if _mode == "on" or _profiler_enabled():
        return _SpanHandle(PROGRAM, Span(name), None, mark)
    return _NOOP_HANDLE
