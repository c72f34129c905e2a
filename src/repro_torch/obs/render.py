"""Shared text-rendering helpers: one duration formatter, one table path.

Every human-facing formatter in the repo (trace trees, ``explain()``,
triage tables, the analysis/ report generators) goes through these two
functions, so durations and tables read identically everywhere.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

__all__ = ["fmt_seconds", "markdown_table"]


def fmt_seconds(s: Optional[float], none: str = "—") -> str:
    """``1.23s`` / ``4.5ms`` / ``678µs`` — None renders as a dash."""
    if s is None:
        return none
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s*1e3:.1f}ms"
    return f"{s*1e6:.0f}µs"


def markdown_table(headers: Sequence[str],
                   rows: Iterable[Sequence[object]]) -> str:
    lines = ["| " + " | ".join(str(h) for h in headers) + " |",
             "|" + "---|" * len(headers)]
    for row in rows:
        lines.append("| " + " | ".join(str(c) for c in row) + " |")
    return "\n".join(lines)
