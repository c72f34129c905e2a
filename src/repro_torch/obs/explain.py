"""``Executable.explain()`` — EXPLAIN-style rendering of a winning plan.

The output answers the three questions a cost-based rewriter must be able
to answer to be trusted (the Froid lesson: surface the rewritten
imperative logic *inside* the plan view):

  * **why this plan** — header with estimated cost, alternatives searched,
    the execution context it was costed for, and the rewrite provenance
    (which rules derived the winning plan's nodes, plus per-rule
    alternative counts and per-phase optimizer time);
  * **where the time goes** — the region tree annotated per site with the
    model's estimated cost and, when serving observations exist, the
    estimated-vs-observed row/iteration counts and their q-error;
  * **what the runtime does with it** — execution tier, swap-guard
    verdict, per-site cache/binding-diversity status, compiled-tier
    verdict per loop.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .render import fmt_seconds

from ..stats.qerror import q_error

__all__ = ["explain_plan", "q_error"]


def _cost_model(exe):
    from ..core.cost import CostModel
    from ..core.regions import write_tables
    cls = getattr(exe.session.config, "cost_model", None) or CostModel
    cm = cls(exe.session.db, exe.session.catalog, exe.context)
    cm.write_tables = frozenset(write_tables(exe.program))
    return cm


def explain_plan(exe, *, feedback=None, site_cache=None,
                 compiler=None) -> str:
    """Render the EXPLAIN text for ``exe`` (an
    :class:`~repro_torch.api.session.Executable`). ``feedback`` /
    ``site_cache`` / ``compiler`` (a serving runtime's components) add
    observed-vs-estimated annotations; without them the output is purely
    model-side."""
    from ..core.context import (loop_site_key, query_site_key,
                                while_site_key)
    from ..core.regions import (BasicBlock, CondRegion, ILoadAll, LoopRegion,
                                Prefetch, SeqRegion, WhileRegion,
                                compilability)

    report = exe.report
    result = exe.result
    cm = _cost_model(exe)
    db = exe.session.db

    # observed serving statistics, keyed the way the annotations join them
    obs_sites: Dict[str, Dict[str, float]] = {}
    obs_iters: Dict[str, Dict[str, object]] = {}
    qerror_sites: Dict[str, Dict[str, float]] = {}
    if feedback is not None:
        fb = feedback.telemetry()
        obs_sites = fb.get("sites", {})
        obs_iters = fb.get("iteration_sites", {})
        qerror_sites = fb.get("qerror_sites", {})
    site_bindings: Dict[str, Dict[str, float]] = {}
    if site_cache is not None:
        site_bindings = site_cache.site_binding_stats()
    notes = compilability(exe.program)

    lines: List[str] = []
    lines.append(f"EXPLAIN {exe.source.name} -> {exe.program.name}")
    lines.append(f"  {report.describe()}")
    swap = ""
    if report.swap_checked:
        verdict = "accepted" if report.swap_accepted else "REJECTED"
        swap = (f"; swap-guard {verdict} "
                f"({report.swap_replayed} binding(s) replayed)")
    lines.append(f"  tier: {report.tier}{swap}")
    rules_fired = tuple(getattr(result, "rules_fired", ()) or ())
    rule_hits = dict(getattr(result, "rule_hits", {}) or {})
    if rules_fired:
        lines.append("  rules fired (winning plan): "
                     + " -> ".join(rules_fired))
    if rule_hits:
        hits = ", ".join(f"{r}:{n}" for r, n in sorted(rule_hits.items()))
        lines.append(f"  alternatives per rule: {hits}")
    phases = dict(getattr(result, "phase_times", {}) or {})
    if phases:
        lines.append("  optimizer phases: " + ", ".join(
            f"{k}={fmt_seconds(v)}" for k, v in phases.items()))
    rule_stats = dict(getattr(result, "rule_stats", {}) or {})
    for phase in sorted(rule_stats):
        per_rule = rule_stats[phase]
        if not per_rule:
            continue
        body = ", ".join(
            f"{name} fired {st.get('fired', 0)}/{st.get('matched', 0)} "
            f"(missed {st.get('missed', 0)})"
            for name, st in sorted(per_rule.items()))
        lines.append(f"    saturation phase {phase}: {body}")
    if getattr(report, "budget_exhausted", False):
        lines.append("  budget: EXHAUSTED -> greedy best-first fallback "
                     "(plan valid; raise node_budget/wall_budget_s for the "
                     "full search)")
    lines.append("  plan:")

    def fetch_annotation(q, binding_site: Optional[str] = None) -> str:
        est = db.estimate(q).n_rows
        parts = [f"est {est:.0f} row(s)", f"~{cm.query_cost(q):.4g}s"]
        seen = obs_sites.get(q.sql())
        if seen:
            o = seen.get("avg_rows", 0.0)
            parts.append(f"observed {o:.0f} over {int(seen.get('n', 0))} "
                         f"exec(s), q-error {q_error(est, o):.1f}")
        qe = qerror_sites.get(q.sql())
        if qe:
            parts.append(f"tracked q-error last {qe.get('last', 1.0):.1f} "
                         f"/ worst {qe.get('worst', 1.0):.1f}")
        if binding_site is not None:
            b = site_bindings.get(binding_site)
            if b:
                parts.append(f"binding diversity {b.get('fraction', 0):.2f} "
                             f"({int(b.get('distinct', 0))}/"
                             f"{int(b.get('lookups', 0))} distinct)")
        return "; ".join(parts)

    def stmt_line(stmt) -> str:
        if isinstance(stmt, Prefetch):
            am = cm.amortize(cm.prefetch_cost(stmt.query))
            note = f"prefetch cost ~{cm.prefetch_cost(stmt.query):.4g}s"
            if cm.batch_size > 1:
                note += f", ~{am:.4g}s amortized over batch={cm.batch_size:g}"
            return f"{stmt!r}   [{note}; {fetch_annotation(stmt.query)}]"
        ann: List[str] = []
        from .signals import _stmt_exprs, _query_of
        for e in _stmt_exprs(stmt):
            q = _query_of(e)
            if q is not None:
                ann.append(fetch_annotation(q, query_site_key(q)))
            elif isinstance(e, ILoadAll):
                ann.append(f"full fetch of {e.table} "
                           f"({db.table(e.table).nrows} row(s))")
        return f"{stmt!r}" + (f"   [{'; '.join(ann)}]" if ann else "")

    def iter_annotation(site: str, est: float) -> str:
        parts = [f"est {est:g} iter(s)"]
        seen = obs_iters.get(site)
        if seen:
            o = float(seen.get("avg_iters", 0.0))
            parts.append(f"observed {o:g}, q-error {q_error(est, o):.1f}")
        return ", ".join(parts)

    def walk(r, depth: int) -> None:
        pad = "    " + "  " * depth
        if isinstance(r, BasicBlock):
            lines.append(pad + stmt_line(r.stmt))
            return
        if isinstance(r, SeqRegion):
            for c in r.parts:
                walk(c, depth)
            return
        if isinstance(r, LoopRegion):
            site = loop_site_key(r.var, r.source)
            note = notes.get(r.key())
            tier = ""
            if note is not None:
                tier = (", columnar (compiled tier)"
                        if note.verdict == "columnar"
                        else f", interpreter ({note.reason})")
            # a loop over a query IS a fetch site: join the feedback
            # controller's per-site q-error account against it too
            from .signals import _query_of
            qerr = ""
            q = _query_of(r.source)
            if q is not None:
                qe = qerror_sites.get(q.sql())
                if qe:
                    qerr = (f", tracked q-error last "
                            f"{qe.get('last', 1.0):.1f} / worst "
                            f"{qe.get('worst', 1.0):.1f}")
            lines.append(pad + f"for {r.var} : {r.source!r}   "
                         f"[{iter_annotation(site, cm.loop_iters(r.source, r.var))}"
                         f"{qerr}{tier}]")
            walk(r.body, depth + 1)
            return
        if isinstance(r, WhileRegion):
            site = while_site_key(r.pred)
            lines.append(pad + f"while {r.pred!r}   "
                         f"[{iter_annotation(site, cm.while_iters(r.pred))}]")
            walk(r.body, depth + 1)
            return
        if isinstance(r, CondRegion):
            lines.append(pad + f"if {r.pred!r}")
            walk(r.then_r, depth + 1)
            if r.else_r is not None:
                lines.append(pad + "else")
                walk(r.else_r, depth + 1)
            return
        lines.append(pad + repr(r))

    walk(exe.program.body, 0)

    from .signals import scan_plan
    found = scan_plan(exe, feedback=feedback)
    if found:
        lines.append("  signals:")
        for s in found:
            lines.append(f"    {s.describe()}")
    return "\n".join(lines)
