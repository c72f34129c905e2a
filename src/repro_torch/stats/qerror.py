"""q-error: the feedback signal that scores cardinality estimates.

``q_error(est, act) = max((act+1)/(est+1), (est+1)/(act+1))`` — the
standard symmetric multiplicative error (1.0 = perfect), +1-smoothed so
empty results neither divide by zero nor hide an est≈0-vs-observed≫0 miss.

:class:`QErrorTracker` keeps a per-site running account of it for the
:class:`~repro_torch.runtime.feedback.FeedbackController`: the controller feeds
every observed (estimated, actual) pair in, reads back the site's latest
q-error to decide whether a *targeted per-column re-analyze* is due, and
publishes the per-site values into ``StatsProfile``/``explain()``/
``triage()``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

__all__ = ["q_error", "QErrorTracker", "SiteQError"]


def q_error(estimated: float, observed: float) -> float:
    """Symmetric multiplicative estimation error; 1.0 is a perfect
    estimate, and over/under-estimation by the same factor score the
    same. +1 smoothing keeps empty results finite."""
    e, o = float(estimated) + 1.0, float(observed) + 1.0
    return max(e / o, o / e)


@dataclasses.dataclass
class SiteQError:
    """Running q-error account of one query site."""

    n: int = 0
    total: float = 0.0
    worst: float = 1.0
    last: float = 1.0
    last_est: float = 0.0
    last_observed: float = 0.0
    tables: Tuple[str, ...] = ()

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 1.0


class QErrorTracker:
    """Per-site q-error accounting keyed by the site's SQL text (the same
    key the feedback controller aggregates observations under)."""

    def __init__(self):
        self._sites: Dict[str, SiteQError] = {}

    def observe(self, sql: str, estimated: float, observed: float,
                tables: Tuple[str, ...] = ()) -> float:
        qe = q_error(estimated, observed)
        s = self._sites.setdefault(sql, SiteQError())
        s.n += 1
        s.total += qe
        s.worst = max(s.worst, qe)
        s.last = qe
        s.last_est = float(estimated)
        s.last_observed = float(observed)
        if tables:
            s.tables = tuple(tables)
        return qe

    def site(self, sql: str) -> SiteQError:
        return self._sites.get(sql, SiteQError())

    def sites(self) -> Dict[str, SiteQError]:
        return dict(self._sites)

    def latest(self) -> Dict[str, float]:
        """sql -> last observed q-error, every tracked site."""
        return {sql: s.last for sql, s in self._sites.items()}

    def worst_sites(self) -> List[Tuple[str, float]]:
        return sorted(((sql, s.worst) for sql, s in self._sites.items()),
                      key=lambda kv: -kv[1])

    def __len__(self) -> int:
        return len(self._sites)
