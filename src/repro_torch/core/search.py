"""Volcano/Cascades search over the Region DAG + code generation.

Cost of an OR-node = min over members; cost of an AND-node = operator cost +
children (Sec. III-A). Two Cobra-specific extensions:

  * **shared resources** — a fold (its source query + loop shell) chosen by
    several ``slot-project`` alternatives, and a prefetched cache used by
    several loops, are counted ONCE per plan. Plans carry a resource set;
    combination points (seq, assemble) merge resource sets by key. This is
    the DAG-costing idea Cobra inherits from the PyroJ/MQO optimizer [14].
  * **top-K plan lists per group** — local minima are not globally optimal
    under sharing, so each group exposes its K best plans and combination
    points enumerate the cross product (bounded); exact at our program sizes.

``optimize`` = build memo → saturate rules → search → generate the program.
``heuristic_choice`` reproduces the [4]-style comparator: push as much into
SQL as possible, never prefetch (Fig. 15's "Heuristic" bars).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..relational.algebra import Query, Scan, scan_tables
from .cost import CostCatalog, CostModel, query_has_params
from .dag import AndNode, Budget, Memo, expand, expand_exhaustive
from .fir import FExpr, FPrefetchE, NameGen, fold_to_loop
from .regions import (Assign, BasicBlock, CondRegion, IBin, IQuery,
                      IQueryValues, IScalarQuery, IVar, LoopRegion, Program,
                      Region, SeqRegion, WhileRegion)
from .rules import RuleContext, _get_parts, build_memo, default_rules

__all__ = ["optimize", "run_search", "OptimizationResult", "Plan",
           "best_plans", "plan_cost"]

_TOPK = 4
_MAX_COMBOS = 4096


@dataclasses.dataclass(frozen=True)
class Plan:
    and_id: int
    op: str
    payload: object
    children: Tuple["Plan", ...]
    base: float                          # own cost excluding shared resources
    resources: Tuple[Tuple[object, float], ...]  # (key, cost), deduped by key

    @property
    def total(self) -> float:
        return self.base + sum(c for _, c in self.resources)


def _merge_resources(*resource_sets) -> Tuple[Tuple[object, float], ...]:
    seen: Dict[object, float] = {}
    for rs in resource_sets:
        for k, c in rs:
            seen.setdefault(k, c)
    return tuple(sorted(seen.items(), key=lambda kv: repr(kv[0])))


def _combine(children_lists: Sequence[List[Plan]],
             max_combos: int = _MAX_COMBOS) -> List[Tuple[Plan, ...]]:
    combos = 1
    for cl in children_lists:
        combos *= max(1, len(cl))
    if combos > max_combos:
        # greedy: take each child's best only
        return [tuple(cl[0] for cl in children_lists)]
    return list(itertools.product(*children_lists))


class Searcher:
    def __init__(self, memo: Memo, cm: CostModel, ctx: RuleContext,
                 choice: str = "cost", topk: int = _TOPK,
                 max_combos: int = _MAX_COMBOS):
        self.memo = memo
        self.cm = cm
        self.ctx = ctx
        self.choice = choice  # "cost" | "heuristic"
        self.topk = topk
        self.max_combos = max_combos
        self._cache: Dict[int, List[Plan]] = {}
        self._in_progress: set = set()

    # ------------------------------------------------------------- search
    def group_plans(self, g: int) -> List[Plan]:
        g = self.memo.find(g)
        if g in self._cache:
            return self._cache[g]
        if g in self._in_progress:
            return []  # cycle through merged groups: prune
        self._in_progress.add(g)
        plans: List[Plan] = []
        for a in self.memo.members(g):
            plans.extend(self.and_plans(a))
        self._in_progress.discard(g)
        plans = self._rank(plans)[:self.topk]
        self._cache[g] = plans
        return plans

    def _rank(self, plans: List[Plan]) -> List[Plan]:
        if self.choice == "heuristic":
            return sorted(plans, key=lambda p: (-_sql_push_score(p), p.total))
        return sorted(plans, key=lambda p: p.total)

    def and_plans(self, a: int) -> List[Plan]:
        node = self.memo.node(a)
        kids = [self.group_plans(c) for c in self.memo.canonical_children(a)]
        if any(len(k) == 0 for k in kids):
            return []
        out: List[Plan] = []
        for combo in _combine(kids, self.max_combos):
            base, res = self._compose(node, combo)
            out.append(Plan(a, node.op, node.payload, combo, base, res))
        return out

    # ------------------------------------------------------------ costing
    def _amortized_once(self, key) -> bool:
        """True when a body resource is fetched once per BATCH rather than
        once per loop iteration: its site is binding-free (flagged at
        creation) and the context batches invocations, so the shared
        site cache serves every re-execution after the first."""
        return self.cm.batch_size > 1 and key[-1] is True

    def _compose(self, node: AndNode, children: Tuple[Plan, ...]
                 ) -> Tuple[float, Tuple[Tuple[object, float], ...]]:
        """Full cost composition for one AND-node given chosen child plans.

        Resource kinds: ("fold", ·, amortizable) = per-execution loop shell
        (source query + header), multiplied when nested under an imperative
        loop; ("prefetch", ·, amortizable) = one-time hoistable cache fill —
        NEVER multiplied (the [13] heuristic hoists it to the earliest
        program point). The trailing flag marks binding-free server fetches,
        whose cost is stored already amortized by the context's batch size
        (one fetch per batch, shared via the batch env's site cache)."""
        cm = self.cm
        cat = cm.cat
        if node.op == "block":
            stmt = node.payload
            from .regions import Prefetch
            if isinstance(stmt, Prefetch):
                amortizable = (not query_has_params(stmt.query)
                               and cm.tables_shareable(
                                   scan_tables(stmt.query)))
                key = ("prefetch", _query_table(stmt.query), stmt.col,
                       amortizable)
                cost = cm.prefetch_cost(stmt.query)
                cost = cm.amortize(cost) if amortizable else \
                    cost * cm.param_site_amortization(stmt.query)
                return 0.0, ((key, cost),)
            return cm.block_cost(stmt), ()
        if node.op == "seq":
            base = sum(p.base for p in children)
            return base, _merge_resources(*[p.resources for p in children])
        if node.op == "cond":
            p = cat.cond_prob_default
            if len(children) == 1:
                base = cat.c_z + p * children[0].base
            else:
                base = cat.c_z + p * children[0].base + (1 - p) * children[1].base
            return base, _merge_resources(*[c.resources for c in children])
        if node.op == "loop":
            var, source = node.payload
            k = cm.loop_iters(source, var)
            body = children[0]
            # binding-free fold sources under a batched context are fetched
            # once per batch (site cache), not once per iteration
            per_iter = sum(c for key, c in body.resources
                           if key[0] == "fold" and not self._amortized_once(key))
            once = sum(c for key, c in body.resources
                       if key[0] == "fold" and self._amortized_once(key))
            prefetch_res = tuple((key, c) for key, c in body.resources
                                 if key[0] != "fold")
            base = (k * (body.base + per_iter + cat.c_z) + once
                    + cm.loop_source_cost(source))
            return base, prefetch_res
        if node.op == "while":
            # guarded loop: iteration count is data dependent, so charge the
            # context's observed count for this site (catalog default when
            # none). EVERY body resource is multiplied (a prefetch inside a
            # while body re-executes each iteration and is never hoisted
            # across the guard) — EXCEPT binding-free fetches under a
            # batched context, which the shared site cache turns into one
            # fetch per batch. Nothing escapes upward as a shared resource —
            # conservative by construction.
            k = cm.while_iters(node.payload)
            body = children[0]
            per_iter = sum(c for key, c in body.resources
                           if not self._amortized_once(key))
            once = sum(c for key, c in body.resources
                       if self._amortized_once(key))
            base = k * (body.base + per_iter + cat.c_z) + cat.c_z + once
            return base, ()
        if node.op == "assemble":
            base = sum(p.base for p in children)
            return base, _merge_resources(*[p.resources for p in children])
        if node.op == "slot-project":
            _, var, i, payload = node.payload
            pre, fold = _get_parts(payload)
            src_cost, n = cm.fold_source(fold)
            slot = cm.slot_row_cost(fold.func.items[i], n)
            res: List[Tuple[object, float]] = []
            if cm.source_amortizable(fold.source):
                # only the server fetch is shared across a batch; the local
                # loop shell (n · C_Z) runs every execution — under a
                # while/loop it must still multiply by K, so it rides as a
                # separate never-amortized fold resource (same dedup)
                res.append((("fold", fold.key(), True), cm.amortize(src_cost)))
                res.append((("fold", fold.key(), "shell", False),
                            n * cat.c_z))
            else:
                # parameterized source: the serving site cache still serves
                # repeated bindings, so the fetch amortizes by the OBSERVED
                # distinct-binding fraction (1.0 when never observed)
                f = cm.fold_source_amortization(fold.source)
                res.append((("fold", fold.key(), False),
                            src_cost * f + n * cat.c_z))
            for p in pre:
                if isinstance(p, FPrefetchE):
                    p_am = (not query_has_params(p.query)
                            and cm.tables_shareable(scan_tables(p.query)))
                    p_cost = cm.prefetch_cost(p.query)
                    res.append((("prefetch", _query_table(p.query), p.col,
                                 p_am),
                                cm.amortize(p_cost) if p_am else
                                p_cost * cm.param_site_amortization(p.query)))
            return n * slot, tuple(res)
        if node.op == "slot-query":
            _, var, q, op, col, binding = node.payload
            qc = cm.query_cost(q)
            if binding is None and not query_has_params(q) \
                    and cm.tables_shareable(scan_tables(q)):
                qc = cm.amortize(qc)
            else:
                qc = qc * cm.param_site_amortization(q)
            return qc + cat.c_z, ()
        if node.op == "slot-query-rows":
            _, var, q, col = node.payload
            qc = cm.query_cost(q)
            if not query_has_params(q) \
                    and cm.tables_shareable(scan_tables(q)):
                qc = cm.amortize(qc)
            else:
                qc = qc * cm.param_site_amortization(q)
            return qc + cat.c_z, ()
        raise TypeError(f"unknown op {node.op}")


def _query_table(q: Query) -> str:
    while True:
        kids = q.children()
        if isinstance(q, Scan):
            return q.table
        if not kids:
            return q.sql()
        q = kids[0]


def _sql_push_score(p: Plan) -> int:
    """Heuristic comparator [4]: more computation pushed into SQL = better;
    prefetching is never chosen (it was proposed for other goals [13])."""
    score = 0
    if p.op == "slot-query-rows":
        score += 100
    if p.op == "slot-query":
        score += 80
    if p.op == "slot-project":
        _, _, _, payload = p.payload
        pre, fold = _get_parts(payload)
        if pre:  # prefetch-based plan: heuristic refuses
            score -= 1000
        from .fir import FSelLookupE, fir_contains, FCacheLookupAllE, FCacheLookupE

        def has(t):
            return fir_contains(fold, lambda x: isinstance(x, t))

        if has(FSelLookupE):
            score += 40  # σ pushed to the database
        if has(FCacheLookupAllE) or has(FCacheLookupE):
            score -= 1000
    if p.op == "assemble":
        score += 1  # prefer F-IR over raw imperative loop
    for c in p.children:
        score += _sql_push_score(c)
    return score


# --------------------------------------------------------------------------
# Code generation from a chosen plan
# --------------------------------------------------------------------------

def plan_to_region(plan: Plan, emitted_prefetch: Optional[set] = None,
                   names: Optional[NameGen] = None) -> Region:
    if emitted_prefetch is None:
        emitted_prefetch = set()
    if names is None:
        # one alpha-normalized name source per codegen run: identical plans
        # emit byte-identical IR (see fir.NameGen)
        names = NameGen()
    if plan.op == "block":
        return BasicBlock(plan.payload)
    if plan.op == "seq":
        return SeqRegion(tuple(plan_to_region(c, emitted_prefetch, names)
                               for c in plan.children))
    if plan.op == "cond":
        pred = plan.payload
        then = plan_to_region(plan.children[0], emitted_prefetch, names)
        els = plan_to_region(plan.children[1], emitted_prefetch, names) \
            if len(plan.children) > 1 else None
        return CondRegion(pred, then, els)
    if plan.op == "loop":
        var, source = plan.payload
        return LoopRegion(var, source, plan_to_region(plan.children[0],
                                                      emitted_prefetch, names))
    if plan.op == "while":
        # a prefetch chosen inside the body must also be emitted there (the
        # guard may skip every iteration), so the body codegens with a FRESH
        # dedup set — nothing is considered already-emitted across the guard
        body = plan_to_region(plan.children[0], set(), names)
        return WhileRegion(plan.payload, body)
    if plan.op == "assemble":
        return _assemble_to_region(plan, emitted_prefetch, names)
    raise TypeError(f"cannot codegen {plan.op}")


def _assemble_to_region(plan: Plan, emitted_prefetch: set,
                        names: NameGen) -> Region:
    from .regions import Prefetch

    parts: List[Region] = []
    # group slot-projects by their payload expression (one loop per fold)
    fold_slots: Dict[object, Tuple[FExpr, List[int]]] = {}
    queries: List[Tuple[str, object]] = []
    for c in plan.children:
        if c.op == "slot-project":
            _, var, i, payload = c.payload
            k = payload.key()
            fold_slots.setdefault(k, (payload, []))[1].append(i)
        elif c.op == "slot-query":
            _, var, q, op, col, binding = c.payload
            queries.append((var, ("agg", q, op, col, binding)))
        elif c.op == "slot-query-rows":
            _, var, q, col = c.payload
            queries.append((var, ("rows", q, col)))
        else:
            raise TypeError(c.op)

    # which vars end up covered by a loop (incl. dependency closure)?
    covered: set = set()
    loops: List[Region] = []
    for payload, slots in fold_slots.values():
        pre, fold = _get_parts(payload)
        for p in pre:
            if isinstance(p, FPrefetchE):
                key = (_query_table(p.query), p.col)
                if key not in emitted_prefetch:
                    emitted_prefetch.add(key)
                    parts.append(BasicBlock(Prefetch(p.query, p.col)))
        region = fold_to_loop(fold, slots=slots, names=names)
        loops.append(region)
        covered.update(_loop_assigned_vars(region))

    for var, spec in queries:
        if var in covered:
            continue  # dependency closure already computes it in a loop
        if spec[0] == "agg":
            _, q, op, col, binding = spec
            bindings = ()
            if binding is not None:
                from .fir import _val_to_iexpr
                bindings = (("k", _val_to_iexpr(binding, {}, [], names)),)
            parts.append(BasicBlock(Assign(
                var, IBin(op, IVar(var), IScalarQuery(q, col, bindings)))))
        else:
            _, q, col = spec
            if col is None:
                parts.append(BasicBlock(Assign(var, IQuery(q))))
            else:
                parts.append(BasicBlock(Assign(var, IQueryValues(q, col))))
    parts.extend(loops)
    return SeqRegion(tuple(parts)) if len(parts) != 1 else parts[0]


def _loop_assigned_vars(r: Region) -> set:
    out = set()

    def walk(x: Region):
        if isinstance(x, BasicBlock):
            out.update(x.stmt.defs())
        for c in x.children():
            walk(c)

    walk(r)
    return {v for v in out if not v.startswith("__")}


# --------------------------------------------------------------------------
# Prefetch hoisting ("prefetch at the earliest program point", [13])
# --------------------------------------------------------------------------

def hoist_prefetches(region: Region) -> Region:
    """Move whole-relation Prefetch statements to the program start, deduped.
    Tables that the program updates are NOT hoisted (stale-cache safety,
    Sec. VIII 'threats to validity')."""
    from .regions import NoOp, Prefetch, UpdateRow

    updated: set = set()

    def find_updates(r: Region):
        if isinstance(r, BasicBlock) and isinstance(r.stmt, UpdateRow):
            updated.add(r.stmt.table)
        for c in r.children():
            find_updates(c)

    find_updates(region)
    hoisted: List = []
    seen: set = set()

    def strip(r: Region) -> Optional[Region]:
        if isinstance(r, BasicBlock):
            if isinstance(r.stmt, Prefetch):
                tbl = _query_table(r.stmt.query)
                if tbl not in updated:
                    key = (tbl, r.stmt.col)
                    if key not in seen:
                        seen.add(key)
                        hoisted.append(r)
                    return None
            return r
        if isinstance(r, SeqRegion):
            parts = tuple(p for p in (strip(x) for x in r.parts) if p is not None)
            if not parts:
                return None
            return SeqRegion(parts) if len(parts) > 1 else parts[0]
        if isinstance(r, LoopRegion):
            body = strip(r.body)
            if body is None:
                body = BasicBlock(NoOp("hoisted"))
            return LoopRegion(r.var, r.source, body, r.label)
        if isinstance(r, (CondRegion, WhileRegion)):
            # prefetch under a condition/guard is not unconditionally
            # hoistable (the branch or while body may never execute)
            return r
        return r

    core = strip(region)
    if not hoisted:
        return region
    parts = tuple(hoisted) + ((core,) if core is not None else ())
    return SeqRegion(parts) if len(parts) > 1 else parts[0]


# --------------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------------

@dataclasses.dataclass
class OptimizationResult:
    program: Program
    plan: Plan
    est_cost: float
    memo_stats: Dict[str, int]
    opt_time_s: float
    alternatives: int
    # per-phase optimizer wall time (build/saturate/search/codegen) and
    # rewrite provenance: total alternatives per rule across the whole memo,
    # plus the ordered rule chain that derived the WINNING plan's nodes.
    # Defaults keep plans pickled by older PlanStores loadable.
    phase_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    rule_hits: Dict[str, int] = dataclasses.field(default_factory=dict)
    rules_fired: Tuple[str, ...] = ()
    # saturation budget outcome: True when a node/wall budget tripped and
    # the plan came from the greedy best-first fallback over a partial memo
    budget_exhausted: bool = False
    # per-phase per-rule saturation accounting:
    # phase -> rule -> {"matched", "fired", "missed"}
    rule_stats: Dict[str, Dict[str, Dict[str, int]]] = \
        dataclasses.field(default_factory=dict)


def _plan_rules(plan: Plan, memo: Memo) -> Tuple[str, ...]:
    """The rules that derived the winning plan's AND-nodes, ancestors first
    (via the provenance chain), deduped preserving order."""
    out: List[str] = []
    seen_rules = set()

    def chase(and_id: int) -> None:
        seen_ids = set()
        chain: List[str] = []
        a = and_id
        while a in memo.provenance and a not in seen_ids:
            seen_ids.add(a)
            rule, src = memo.provenance[a]
            chain.append(rule)
            a = src
        for rule in reversed(chain):  # ancestors (earliest rewrites) first
            if rule not in seen_rules:
                seen_rules.add(rule)
                out.append(rule)

    def walk(p: Plan) -> None:
        chase(p.and_id)
        for c in p.children:
            walk(c)

    walk(plan)
    return tuple(out)


def run_search(program: Program, db, catalog: CostCatalog, *,
               choice: str = "cost", rules: Optional[Sequence] = None,
               topk: int = _TOPK, max_combos: int = _MAX_COMBOS,
               max_rounds: int = 64, context=None,
               cost_model=None, tracer=None,
               budget: Optional[Budget] = None, memo_pool=None,
               exhaustive: bool = False) -> OptimizationResult:
    """One full memo pass: build → saturate rules → search → codegen.

    ``context`` is an :class:`~repro_torch.core.context.ExecutionContext` (batch
    size + observed iteration stats) the plan is costed for; ``cost_model``
    is a pluggable :class:`~repro_torch.core.cost.CostModel`-protocol class,
    constructed as ``cost_model(db, catalog, context)``. ``tracer`` (an
    :class:`repro_torch.obs.trace.Tracer`) records one span per phase and per
    saturation round.

    ``budget`` (a :class:`~repro_torch.core.dag.Budget`) bounds saturation: when
    it trips, the search degrades to GREEDY best-first (top-1 per group,
    best-child-only combination) over the partial memo and the result
    reports ``budget_exhausted`` — never an error. ``memo_pool`` (a
    :class:`~repro_torch.core.memopool.MemoPool`) replays saturated groups
    shared with earlier compiles and harvests new ones. ``exhaustive``
    switches to the reference rescan-everything saturation loop
    (:func:`~repro_torch.core.dag.expand_exhaustive`) — used by the parity tests
    and ``make bench-compile``; the winning plan must be identical.

    This is the uncached engine; callers wanting compile-once/execute-many
    semantics should go through ``repro_torch.api.CobraSession``, which fronts
    this with a stats-versioned plan cache."""
    import contextlib

    def _span(name):
        if tracer is not None and tracer.enabled:
            return tracer.span(name)
        return contextlib.nullcontext()

    phases: Dict[str, float] = {}
    t0 = time.perf_counter()
    ctx = RuleContext(db=db)
    with _span("build-memo"):
        memo, root = build_memo(program, ctx)
    t1 = time.perf_counter()
    phases["build_memo"] = t1 - t0
    rule_list = list(rules) if rules is not None else default_rules()
    prefired: set = set()
    replayed = 0
    if memo_pool is not None and not exhaustive:
        with _span("memo-pool-seed"):
            replayed, prefired = memo_pool.seed(memo, ctx, rule_list)
    with _span("saturate"):
        if exhaustive:
            stats = expand_exhaustive(memo, rule_list, ctx,
                                      max_rounds=max_rounds, tracer=tracer)
        else:
            stats = expand(memo, rule_list, ctx, max_rounds=max_rounds,
                           tracer=tracer, budget=budget, prefired=prefired)
    exhausted = bool(stats.get("budget_exhausted"))
    if memo_pool is not None and not exhaustive and not exhausted:
        # a partial (budgeted) memo must never be harvested — later
        # compiles would replay it as if saturated
        memo_pool.harvest(memo, ctx, rule_list, prefired)
    if replayed:
        # pooled alternatives are part of the searched space: report them
        # like a cold compile would so plan reports stay comparable
        stats["alternatives_added"] = \
            stats.get("alternatives_added", 0) + replayed
        stats["pool_replayed"] = replayed
    t2 = time.perf_counter()
    phases["saturate"] = t2 - t1
    cm = (cost_model or CostModel)(db, catalog, context)
    # sites over tables the program writes are refetched every invocation
    # (the serving cache refuses them), so the model must not amortize them
    from .regions import write_tables
    cm.write_tables = frozenset(write_tables(program))
    if exhausted:
        # greedy best-first fallback: keep only the best plan per group and
        # never enumerate combination cross-products
        topk, max_combos = 1, 1
    searcher = Searcher(memo, cm, ctx, choice=choice, topk=topk,
                        max_combos=max_combos)
    with _span("search"):
        plans = searcher.group_plans(root)
    t3 = time.perf_counter()
    phases["search"] = t3 - t2
    if not plans:
        raise RuntimeError("no plan found")
    best = plans[0]
    with _span("codegen"):
        region = hoist_prefetches(plan_to_region(best))
    out = Program(f"{program.name}_{choice}", region, program.outputs,
                  program.inputs)
    t4 = time.perf_counter()
    phases["codegen"] = t4 - t3
    dt = t4 - t0
    return OptimizationResult(out, best, best.total, stats, dt,
                              stats.get("alternatives_added", 0),
                              phase_times=phases,
                              rule_hits=dict(memo.rule_hits),
                              rules_fired=_plan_rules(best, memo),
                              budget_exhausted=exhausted,
                              rule_stats={p: {r: dict(c) for r, c in rs.items()}
                                          for p, rs in memo.rule_stats.items()})


def optimize(program: Program, db, catalog: CostCatalog,
             choice: str = "cost", rules: Optional[Sequence] = None
             ) -> OptimizationResult:
    """Back-compat shim over :class:`repro_torch.api.CobraSession`.

    rules=None uses the full Fig. 11 rule set; pass a restricted list
    (e.g. without T3) to reproduce the paper's Experiment-1/2/3 alternative
    space {P0, P1, P2} exactly. New code should hold a session and use
    ``session.compile(program)`` so repeated optimizations hit the plan
    cache instead of re-running memo expansion."""
    from ..api import CobraSession, OptimizerConfig
    session = CobraSession(db, catalog, config=OptimizerConfig(choice=choice))
    return session.compile(program, rules=rules).result
