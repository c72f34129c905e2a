"""Predicate selectivity from per-column histograms.

:func:`predicate_selectivity` is the histogram-grade replacement for the
scalar rules ``DatabaseServer._selectivity`` shipped with (1/NDV equality,
the System-R 1/3 range default). It receives a *resolver* — a callable
mapping a column name to the :class:`~repro_torch.stats.histogram.ColumnHistogram`
of the Select's input (or ``None``) — so it works unchanged for base-table
scans, stacked Selects, and join inputs, and degrades per-column to the
legacy scalar estimate wherever a histogram is missing (fresh table,
``StatsConfig(histograms=False)``, sketch-only analyze).

Pricing rules:

  * ``col == literal``   — MCV exact match, else bucket average frequency;
  * ``col != literal``   — complement of the above;
  * ``col <op> literal`` — MCV mass + linear interpolation in the
    containing equi-depth bucket;
  * ``col == :param``    — the *expected* selectivity over bindings drawn
    from the column's own distribution (Σ (f/N)², exactly 1/NDV for
    uniform columns — see ``ColumnHistogram.param_eq_fraction``);
  * ``col != :param``    — its complement;
  * range vs ``:param``  — 1/3 (no binding distribution to price from);
  * conjunction/disjunction — independence, as before.
"""

from __future__ import annotations

from typing import Callable, Optional

from .histogram import ColumnHistogram

__all__ = ["predicate_selectivity"]

_RANGE_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}


def predicate_selectivity(pred, resolve: Callable[[str], Optional[ColumnHistogram]],
                          ndv_of: Callable[[str], float]) -> Optional[float]:
    """Selectivity of ``pred`` using histograms where available.

    Returns ``None`` when the predicate shape is not one this estimator
    prices (caller falls through to its own default)."""
    from ..relational.algebra import BoolOp, Cmp, Col, Lit, Param

    if isinstance(pred, BoolOp):
        l = predicate_selectivity(pred.left, resolve, ndv_of)
        r = predicate_selectivity(pred.right, resolve, ndv_of)
        if l is None or r is None:
            return None
        return l * r if pred.op == "and" else min(1.0, l + r)
    if not isinstance(pred, Cmp):
        return None
    # normalize to (col OP rhs); flip the operator when the column is on
    # the right (5 < col  ≡  col > 5)
    op, col, rhs = pred.op, None, None
    if isinstance(pred.left, Col):
        col, rhs = pred.left, pred.right
    elif isinstance(pred.right, Col):
        col, rhs = pred.right, pred.left
        op = _RANGE_FLIP.get(op, op)
    if col is None:
        return None
    hist = resolve(col.name)

    if isinstance(rhs, Lit) and isinstance(rhs.value, (int, float, bool)):
        if hist is not None and hist.nrows > 0:
            if op == "==":
                return hist.eq_fraction(float(rhs.value))
            if op == "!=":
                return max(0.0, 1.0 - hist.eq_fraction(float(rhs.value)))
            if op in _RANGE_FLIP:
                return hist.range_fraction(op, float(rhs.value))
        # legacy scalar fallback for this column
        if op == "==":
            return 1.0 / ndv_of(col.name)
        if op == "!=":
            return 1.0 - 1.0 / ndv_of(col.name)
        if op in _RANGE_FLIP:
            return 1.0 / 3.0
        return None

    if isinstance(rhs, Param):
        if op == "==":
            if hist is not None and hist.nrows > 0:
                return hist.param_eq_fraction()
            return 1.0 / ndv_of(col.name)
        if op == "!=":
            if hist is not None and hist.nrows > 0:
                return max(0.0, 1.0 - hist.param_eq_fraction())
            return 1.0 - 1.0 / ndv_of(col.name)
        if op in _RANGE_FLIP:
            return 1.0 / 3.0
        return None

    # Col-vs-Col and computed comparands: legacy scalar rules
    if op == "==":
        return 1.0 / ndv_of(col.name)
    if op == "!=":
        return 1.0 - 1.0 / ndv_of(col.name)
    if op in _RANGE_FLIP:
        return 1.0 / 3.0
    return None
