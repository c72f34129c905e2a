"""Trace spans: nested wall-clock + simulated-clock timing, near-free off.

A :class:`Tracer` records a tree of :class:`Span`\\ s — compile → rule
saturation rounds → costing; serve → batch → site fetch / cache hit →
compiled-kernel invoke → swap verdicts. Each span carries wall time
(``perf_counter``) and, when the caller passes a ``sim_clock`` callable
(e.g. ``lambda: env.clock``), the simulated clock interval too. Export as
JSONL (:meth:`Tracer.export_jsonl`) or render a text flamegraph-style tree
(:meth:`Tracer.render`).

The default everywhere is the module singleton :data:`NOOP_TRACER`: its
``span()`` returns a shared no-op handle, so an instrumented hot path pays
one attribute load and a branch — nothing is allocated, nothing recorded.
Hot inner loops guard event emission with ``if tracer.enabled:``.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional

__all__ = ["Span", "Tracer", "NoopTracer", "NOOP_TRACER"]


class Span:
    __slots__ = ("name", "attrs", "wall_start", "wall_end",
                 "sim_start", "sim_end", "children")

    def __init__(self, name: str, attrs: Optional[Dict[str, object]] = None):
        self.name = name
        self.attrs: Dict[str, object] = attrs or {}
        self.wall_start: float = 0.0
        self.wall_end: Optional[float] = None
        self.sim_start: Optional[float] = None
        self.sim_end: Optional[float] = None
        self.children: List["Span"] = []

    @property
    def wall_s(self) -> float:
        end = self.wall_end if self.wall_end is not None \
            else time.perf_counter()
        return end - self.wall_start

    @property
    def sim_s(self) -> Optional[float]:
        if self.sim_start is None or self.sim_end is None:
            return None
        return self.sim_end - self.sim_start

    def __repr__(self):
        return f"Span({self.name!r}, {len(self.children)} child(ren))"


class _SpanHandle:
    """Context manager entering/exiting one span on its tracer's stack."""

    __slots__ = ("tracer", "span", "sim_clock")

    def __init__(self, tracer: "Tracer", span: Span,
                 sim_clock: Optional[Callable[[], float]]):
        self.tracer = tracer
        self.span = span
        self.sim_clock = sim_clock

    def __enter__(self) -> Span:
        t = self.tracer
        parent = t._stack[-1] if t._stack else None
        (parent.children if parent is not None else t.roots).append(self.span)
        t._stack.append(self.span)
        if self.sim_clock is not None:
            self.span.sim_start = self.sim_clock()
        self.span.wall_start = time.perf_counter()
        return self.span

    def __exit__(self, exc_type, exc, tb):
        self.span.wall_end = time.perf_counter()
        if self.sim_clock is not None:
            self.span.sim_end = self.sim_clock()
        stack = self.tracer._stack
        # robust to mismatched exits: pop until (and including) our span
        while stack:
            if stack.pop() is self.span:
                break
        return False


class Tracer:
    """Recording tracer. ``enabled`` is True so call sites can guard
    per-event work with a single branch."""

    enabled = True

    def __init__(self):
        self.roots: List[Span] = []
        self._stack: List[Span] = []

    # ------------------------------------------------------------ recording
    def span(self, name: str,
             sim_clock: Optional[Callable[[], float]] = None,
             **attrs) -> _SpanHandle:
        return _SpanHandle(self, Span(name, attrs), sim_clock)

    def event(self, name: str,
              sim_clock: Optional[Callable[[], float]] = None,
              sim: Optional[float] = None, **attrs) -> Span:
        """A zero-duration span attached to the current parent. Hot call
        sites pass the simulated clock by value (``sim=``) to skip the
        callable indirection."""
        sp = Span(name, attrs)
        now = time.perf_counter()
        sp.wall_start = sp.wall_end = now
        if sim is None and sim_clock is not None:
            sim = sim_clock()
        if sim is not None:
            sp.sim_start = sp.sim_end = sim
        parent = self._stack[-1] if self._stack else None
        (parent.children if parent is not None else self.roots).append(sp)
        return sp

    def reset(self) -> None:
        self.roots = []
        self._stack = []

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
            }
            if sp.sim_s is not None:
                rec["sim_s"] = sp.sim_s
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
