"""Statistics subsystem: per-column histograms, selectivity, q-error.

Replaces the scalar per-table cardinalities the cost model launched with:

  * :mod:`repro_torch.stats.histogram` — ``analyze()``'s per-column equi-depth
    histograms + distinct-count sketches, with a lossless associative
    ``merge()`` (sharded coordinator stats reconcile bit-for-bit);
  * :mod:`repro_torch.stats.selectivity` — histogram-grade predicate
    selectivity consumed by ``DatabaseServer.estimate()`` / the cost
    model (equality/range from buckets, per-parameter expected
    selectivity for correlated sites);
  * :mod:`repro_torch.stats.qerror` — the per-site q-error feedback signal the
    :class:`~repro_torch.runtime.feedback.FeedbackController` uses to trigger
    targeted per-column re-analyzes.
"""

from .histogram import (ColumnHistogram, StatsConfig, build_histogram,
                        merge_all, merge_histograms)
from .qerror import QErrorTracker, q_error
from .selectivity import predicate_selectivity

__all__ = ["ColumnHistogram", "StatsConfig", "build_histogram",
           "merge_all", "merge_histograms", "predicate_selectivity",
           "q_error", "QErrorTracker"]
