"""Fleet triage: rank served programs by traffic-weighted estimated win.

Re-optimization effort should follow the traffic: a mildly-bad plan
serving 80% of requests is worth more attention than a terrible plan
served twice. :func:`triage_fleet` scores every program registered on a
:class:`~repro_torch.runtime.serving.ServingRuntime` as

    score = invocation_share × drift × (1 + Σ signal severity)

where *drift* is the worst observed estimate-vs-reality ratio among the
feedback controller's drift events touching the program's tables (1.0
when estimates held), and the signal severities come from
:func:`~repro_torch.obs.signals.scan_plan` over the CURRENT serving plan.

:func:`triage_cluster` is the sharded-cluster view: the same scoring over
the union of every worker's fleet, with per-shard request counts, the hot
shard, and its skew factor folded in — a program whose traffic piles onto
one worker scores higher than its cluster-wide share alone would say,
because that one worker IS its bottleneck.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .render import markdown_table

__all__ = ["TriageRow", "triage_fleet", "triage_cluster", "render_triage"]


@dataclasses.dataclass(frozen=True)
class TriageRow:
    name: str
    requests: int
    share: float            # fraction of all served requests
    drift: float            # worst observed drift ratio on its tables (>= 1)
    severity: float         # Σ scan_plan signal severities on current plan
    signals: Tuple[str, ...]
    score: float
    qerror: float = 1.0     # worst tracked per-site q-error on its tables
    # cluster columns (triage_cluster only; single-runtime rows keep the
    # defaults, so render/consumers handle both shapes)
    shard_requests: Tuple[int, ...] = ()  # this program's requests per worker
    hot_shard: int = -1                   # worker serving the most of them
    shard_share: float = 0.0              # hot shard's fraction of them
    skew: float = 1.0                     # shard_share × n_workers (1 = even)

    def describe(self) -> str:
        sig = ",".join(self.signals) or "-"
        hot = (f", hot shard {self.hot_shard} ({self.skew:.1f}x skew)"
               if self.shard_requests else "")
        return (f"{self.name}: score {self.score:.3f} "
                f"(share {self.share:.2f}, drift {self.drift:.1f}x, "
                f"q-error {self.qerror:.1f}, signals {sig}{hot})")


def triage_fleet(rt) -> List[TriageRow]:
    """Score and rank every program registered on ``rt`` (a
    :class:`~repro_torch.runtime.serving.ServingRuntime`), highest first."""
    from ..api.cache import program_tables
    from .signals import scan_plan

    counts = dict(getattr(rt, "_requests_by_program", {}))
    total = sum(counts.values())
    events = rt.feedback.events if rt.feedback is not None else []
    qsites = (rt.feedback.qerrors.sites()
              if rt.feedback is not None else {})

    rows: List[TriageRow] = []
    for name in sorted(rt._programs):
        program = rt._programs[name]
        exe = rt._executables[name]
        requests = counts.get(name, 0)
        share = requests / total if total else 0.0
        tables = set(program_tables(program))
        drift = 1.0
        for e in events:
            if tables & set(e.tables):
                drift = max(drift, float(e.ratio))
        qerr = 1.0
        for s in qsites.values():
            if tables & set(s.tables):
                qerr = max(qerr, float(s.worst))
        found = scan_plan(exe, feedback=rt.feedback)
        severity = sum(s.severity for s in found)
        rows.append(TriageRow(
            name=name, requests=requests, share=share, drift=drift,
            severity=severity,
            signals=tuple(sorted({s.kind for s in found})),
            score=share * drift * (1.0 + severity), qerror=qerr))
    rows.sort(key=lambda r: (-r.score, r.name))
    return rows


def triage_cluster(cluster) -> List[TriageRow]:
    """Score and rank every program registered on a
    :class:`~repro_torch.cluster.runtime.ClusterRuntime`, highest first.

    Same scoring as :func:`triage_fleet` with one extra factor — the hot
    shard's skew (its share of the program's traffic × worker count; 1.0
    when spread evenly) — and the per-shard request counts as columns."""
    from ..api.cache import program_tables
    from .signals import scan_plan

    workers = list(cluster.workers)
    n = len(workers)
    per_shard: dict = {}
    for w, rt in enumerate(workers):
        for name, c in getattr(rt, "_requests_by_program", {}).items():
            per_shard.setdefault(name, [0] * n)[w] += c
    total = sum(sum(v) for v in per_shard.values())

    rows: List[TriageRow] = []
    for name in sorted(cluster._programs):
        program = cluster._programs[name]
        counts = per_shard.get(name, [0] * n)
        requests = sum(counts)
        hot = counts.index(max(counts))
        # judge the plan (and feedback evidence) on the hot worker — the
        # one whose serving this program actually bottlenecks
        rt = workers[hot]
        exe = rt._executables.get(name) or workers[0]._executables[name]
        share = requests / total if total else 0.0
        tables = set(program_tables(program))
        drift = 1.0
        qerr = 1.0
        for w in workers:
            for e in (w.feedback.events if w.feedback is not None else []):
                if tables & set(e.tables):
                    drift = max(drift, float(e.ratio))
            if w.feedback is not None:
                for s in w.feedback.qerrors.sites().values():
                    if tables & set(s.tables):
                        qerr = max(qerr, float(s.worst))
        found = scan_plan(exe, feedback=rt.feedback)
        severity = sum(s.severity for s in found)
        shard_share = counts[hot] / requests if requests else 0.0
        skew = shard_share * n if requests else 1.0
        rows.append(TriageRow(
            name=name, requests=requests, share=share, drift=drift,
            severity=severity,
            signals=tuple(sorted({s.kind for s in found})),
            score=share * drift * (1.0 + severity) * max(1.0, skew),
            qerror=qerr,
            shard_requests=tuple(counts), hot_shard=hot,
            shard_share=shard_share, skew=skew))
    rows.sort(key=lambda r: (-r.score, r.name))
    return rows


def render_triage(rows: List[TriageRow]) -> str:
    if any(r.shard_requests for r in rows):
        return markdown_table(
            ["program", "requests", "share", "shards", "hot", "skew",
             "drift", "q-error", "severity", "signals", "score"],
            [(r.name, r.requests, f"{r.share:.2f}",
              "/".join(str(c) for c in r.shard_requests) or "—",
              r.hot_shard if r.shard_requests else "—", f"{r.skew:.1f}x",
              f"{r.drift:.1f}x", f"{r.qerror:.1f}", f"{r.severity:.2f}",
              ",".join(r.signals) or "—", f"{r.score:.3f}")
             for r in rows])
    return markdown_table(
        ["program", "requests", "share", "drift", "q-error", "severity",
         "signals", "score"],
        [(r.name, r.requests, f"{r.share:.2f}", f"{r.drift:.1f}x",
          f"{r.qerror:.1f}", f"{r.severity:.2f}",
          ",".join(r.signals) or "—", f"{r.score:.3f}") for r in rows])
