"""Bad-plan-pattern catalog: structured signals over a (rewritten) plan.

:func:`scan_plan` walks a program's region tree — for an
:class:`~repro_torch.api.session.Executable` that is the REWRITTEN program, so a
pattern the optimizer already eliminated (N+1 navigation folded into a
join, a per-iteration query hoisted to a batch-amortized prefetch) no
longer fires — and emits one :class:`Signal` per detected pattern:

  * ``n_plus_one`` — ORM navigation or a parameterized query inside a
    cursor-loop body: one point query per iterated row;
  * ``query_in_while`` — a server fetch inside a guarded (while) body,
    re-executed every data-dependent iteration; a binding-free prefetch
    under a BATCHED context is exempt (the site cache serves it once per
    batch — exactly the rewrite the optimizer uses to fix this pattern);
  * ``unbatched_writes`` — ``UPDATE`` statements inside a loop/while body,
    one server round trip per iteration;
  * ``diverse_bindings`` — a parameterized-site group whose OBSERVED
    distinct-binding fraction is high: the site cache cannot amortize it,
    so the plan pays nearly full fetch cost per invocation;
  * ``interpreter_hot_loop`` — a hot plan whose loops the compiled tier
    rejects (early exit, nested iteration, …), pinned row-at-a-time.

Severity is a coarse [0, 1] ranking weight (``triage`` multiplies it into
the traffic share), not a probability.
"""

from __future__ import annotations

import dataclasses
from typing import List

__all__ = ["Signal", "scan_plan"]

# observed distinct-binding fraction above which a parameterized site is
# considered cache-hostile (nearly every binding misses)
DIVERSE_BINDING_FRACTION = 0.8
# invocations after which a plan counts as hot for interpreter_hot_loop
HOT_RUNS = 3


@dataclasses.dataclass(frozen=True)
class Signal:
    """One detected bad-plan pattern, anchored to a site."""

    kind: str        # n_plus_one | query_in_while | unbatched_writes |
    #                  diverse_bindings | interpreter_hot_loop
    severity: float  # [0, 1] ranking weight
    site: str        # region/site key the pattern anchors to
    detail: str      # human-readable one-liner
    program: str = ""

    def describe(self) -> str:
        return f"[{self.kind} {self.severity:.2f}] {self.detail}"


def _query_of(e):
    return getattr(e, "query", None)


def _walk_exprs(e, out: List) -> None:
    """Collect every IExpr reachable from ``e`` (the api.cache walker
    idiom: fixed child attributes + args + bindings)."""
    from ..core.regions import IExpr
    if not isinstance(e, IExpr):
        return
    out.append(e)
    for attr in ("base", "left", "right", "keyexpr", "valexpr"):
        sub = getattr(e, attr, None)
        if isinstance(sub, IExpr):
            _walk_exprs(sub, out)
    for sub in getattr(e, "args", ()) or ():
        _walk_exprs(sub, out)
    for _, sub in getattr(e, "bindings", ()) or ():
        _walk_exprs(sub, out)


def _stmt_exprs(stmt) -> List:
    out: List = []
    for attr in ("expr", "keyexpr", "valexpr", "val"):
        _walk_exprs(getattr(stmt, attr, None), out)
    return out


def _is_parameterized(e) -> bool:
    from ..core.cost import query_has_params
    q = _query_of(e)
    if q is None:
        return False
    if getattr(e, "bindings", ()):
        return True
    try:
        return query_has_params(q)
    except Exception:
        return False


def scan_plan(target, *, feedback=None, stats=None,
              hot_runs_threshold: int = HOT_RUNS) -> List[Signal]:
    """Detect known bad-plan patterns in ``target`` (an Executable or a
    plain Program); returns :class:`Signal`\\ s ranked most severe first.

    For an Executable the REWRITTEN program is scanned under the context
    it was compiled for, so every signal answers "what is still wrong
    AFTER the optimizer had its say". ``stats`` (a
    :class:`~repro_torch.core.context.StatsProfile`) or ``feedback`` (a
    :class:`~repro_torch.runtime.feedback.FeedbackController`) supply observed
    binding-diversity fractions for ``diverse_bindings``."""
    from ..api.cache import program_param_sites
    from ..core.context import while_site_key, loop_site_key
    from ..core.regions import (BasicBlock, CondRegion, ICacheLookup, ILoadAll,
                                INav, LoopRegion, Prefetch, Program, Region,
                                UpdateRow, WhileRegion, compilability)

    if isinstance(target, (Program, Region)):
        program = target if isinstance(target, Program) else \
            Program("anonymous", target, ())
        context = None
        n_runs = 0
    else:
        program = target.program
        context = target.context
        n_runs = target.n_runs
    batch_size = context.batch_size if context is not None else 1
    name = program.name
    signals: List[Signal] = []

    def emit(kind: str, severity: float, site: str, detail: str) -> None:
        signals.append(Signal(kind=kind, severity=min(1.0, severity),
                              site=site, detail=detail, program=name))

    # ---------------------------------------------- structural region walk
    def check_fetches(exprs, in_loop, in_while, where: str) -> None:
        """Emit fetch-in-iteration signals for every server-touching
        expression in ``exprs`` (statement operands or a loop's source)."""
        for e in exprs:
            q = _query_of(e)
            is_fetch = q is not None or isinstance(e, ILoadAll)
            if isinstance(e, ICacheLookup):
                continue  # local cache lookup, no server interaction
            if in_while and is_fetch:
                what = q.sql() if q is not None else f"loadAll({e.table})"
                emit("query_in_while", 0.7, in_while,
                     f"server fetch in a {where} inside a while body, "
                     f"re-executed every data-dependent iteration: {what}")
            if in_loop:
                if isinstance(e, INav):
                    emit("n_plus_one", 0.8, in_loop,
                         f"ORM navigation ->{e.target} in a loop body: "
                         f"one point query per iterated row")
                elif is_fetch and _is_parameterized(e):
                    emit("n_plus_one", 0.8, in_loop,
                         f"parameterized query per loop iteration "
                         f"({where}): {q.sql()}")

    def walk(r: Region, loop_sites: tuple, while_sites: tuple) -> None:
        in_loop = loop_sites[-1] if loop_sites else None
        in_while = while_sites[-1] if while_sites else None
        if isinstance(r, BasicBlock):
            stmt = r.stmt
            if isinstance(stmt, UpdateRow) and (in_loop or in_while):
                emit("unbatched_writes", 0.5, in_loop or in_while,
                     f"UPDATE {stmt.table} inside an iteration body — "
                     f"one round trip per iteration")
            if isinstance(stmt, Prefetch):
                # a binding-free prefetch inside a while body re-fetches
                # per iteration in one-shot execution; under a batched
                # context the site cache serves it once per batch — the
                # optimizer's own fix for query_in_while
                if in_while and batch_size <= 1:
                    emit("query_in_while", 0.7, in_while,
                         f"prefetch re-executed each while iteration: "
                         f"{stmt.query.sql()}")
            check_fetches(_stmt_exprs(stmt), in_loop, in_while, "statement")
            return
        if isinstance(r, LoopRegion):
            # the loop's SOURCE is itself a fetch site: iterated inside an
            # enclosing while/loop it re-executes per outer iteration
            src_exprs: List = []
            _walk_exprs(r.source, src_exprs)
            check_fetches(src_exprs, in_loop, in_while, "loop source")
            walk(r.body, loop_sites + (loop_site_key(r.var, r.source),),
                 while_sites)
            return
        if isinstance(r, WhileRegion):
            walk(r.body, loop_sites,
                 while_sites + (while_site_key(r.pred),))
            return
        if isinstance(r, CondRegion):
            for c in r.children():
                walk(c, loop_sites, while_sites)
            return
        for c in r.children():
            walk(c, loop_sites, while_sites)

    walk(program.body, (), ())

    # -------------------------------------- observed binding diversity
    profile = stats
    if profile is None and context is not None and context.stats.bindings:
        profile = context.stats
    published = {}
    if profile is not None:
        published.update(dict(profile.bindings))
    if feedback is not None:
        published.update({k: v for k, v in
                          getattr(feedback, "_published_bindings", {}).items()
                          if v is not None})
    for group in program_param_sites(program):
        frac = published.get(group)
        if frac is not None and frac >= DIVERSE_BINDING_FRACTION:
            emit("diverse_bindings", frac, group,
                 f"parameterized site group {group}: observed "
                 f"distinct-binding fraction {frac:.2f} — the site cache "
                 f"cannot amortize it")

    # -------------------------------------------- compiled-tier eligibility
    if n_runs >= hot_runs_threshold:
        for note in compilability(program).values():
            if note.kind == "loop" and note.verdict == "interpreter":
                emit("interpreter_hot_loop", 0.4, note.site,
                     f"hot plan ({n_runs} invocation(s)) with a loop the "
                     f"compiled tier rejects: {note.reason}")

    signals.sort(key=lambda s: (-s.severity, s.kind, s.site))
    return signals
