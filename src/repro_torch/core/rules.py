"""Program transformation rules (Fig. 11) over the Region DAG.

Memo layout produced by ``build_memo`` + the F-IR conversion rule:

  loop group ──┬── AND("loop", [body])            (original imperative loop)
               └── AND("assemble", [g_v1 .. g_vk]) (F-IR form, Fig. 10)
  g_vi        ──┬── AND("slot-project", payload=(var, i, fold-or-seq expr))
               ├── AND("slot-query",       ...)    from T5  (γ aggregate)
               └── AND("slot-query-rows",  ...)    from T1/T4 (collection query)

Fold-rewriting rules (T2/N2 correlated+plain, N1, N1a) fire on
``slot-project`` nodes and add new ``slot-project`` alternatives whose
payload embeds the rewritten fold (possibly wrapped in seq(prefetch, ...)).
Slot-extraction rules (T1, T4, T5) fire on ``slot-project`` nodes and add
``slot-query[-rows]`` alternatives. Duplicate detection in the memo makes
the cyclic pairs (T2 ↔ N2) terminate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..relational.algebra import (AggSpec, Aggregate, Arith, Cmp, Col, Func,
                                  Join, Lit, Param, Project, Query, Scalar,
                                  Scan, Select)
from .dag import AndNode, Memo, Rule
from .fir import (FAcc, FBin, FCacheLookupAllE, FCacheLookupE, FCall, FCondE,
                  FConst, FExpr, FField, FFoldE, FInsert, FPointLookup,
                  FProjectE, FQueryE, FRow, FSelLookupE, FSeqE, FTupleE,
                  FVarRef, FIRConversionError, FPrefetchE, fir_children,
                  fir_contains, fir_map, loop_to_fir)
from .regions import (Assign, BasicBlock, CondRegion, IConst, IEmptyList,
                      IEmptyMap, LoopRegion, Program, Region, SeqRegion,
                      WhileRegion)

__all__ = ["RuleContext", "build_memo", "default_rules"]

_AGG_OF_OP = {"+": "sum", "min": "min", "max": "max"}


@dataclasses.dataclass
class RuleContext:
    db: object                      # DatabaseServer (for schemas/stats)
    loop_regions: Dict[int, LoopRegion] = dataclasses.field(default_factory=dict)
    empty_vars: Dict[Tuple, frozenset] = dataclasses.field(default_factory=dict)
    # loop AND-id -> vars known empty/zero at loop entry
    empty_at_loop: Dict[int, frozenset] = dataclasses.field(default_factory=dict)


# --------------------------------------------------------------------------
# Memo construction (Step 1+2 of Sec. IV-B: region tree → initial Region DAG)
# --------------------------------------------------------------------------

def build_memo(program: Program, ctx: RuleContext) -> Tuple[Memo, int]:
    memo = Memo()
    root = _insert_region(memo, program.body, ctx, known_empty=frozenset())
    return memo, root


def _insert_region(memo: Memo, r: Region, ctx: RuleContext,
                   known_empty: frozenset) -> int:
    if isinstance(r, BasicBlock):
        g, _ = memo.insert(AndNode("block", (), r.stmt))
        return g
    if isinstance(r, SeqRegion):
        children = []
        empty = set(known_empty)
        for p in r.parts:
            g = _insert_region(memo, p, ctx, frozenset(empty))
            children.append(g)
            _track_empties(p, empty)
        g, _ = memo.insert(AndNode("seq", tuple(children)))
        return g
    if isinstance(r, CondRegion):
        tg = _insert_region(memo, r.then_r, ctx, known_empty)
        kids = (tg,) if r.else_r is None else (
            tg, _insert_region(memo, r.else_r, ctx, known_empty))
        g, _ = memo.insert(AndNode("cond", kids, r.pred))
        return g
    if isinstance(r, LoopRegion):
        bg = _insert_region(memo, r.body, ctx, frozenset())
        g, a = memo.insert(AndNode("loop", (bg,), (r.var, r.source)))
        ctx.loop_regions[a] = r
        ctx.empty_at_loop[a] = known_empty
        return g
    if isinstance(r, WhileRegion):
        # the while itself has no F-IR form (iteration count is data
        # dependent), but its body is inserted like any region: cursor loops
        # nested inside still grow their own alternatives (T1/T3/T5, ...).
        # known_empty resets — the body re-executes, so nothing stays fresh.
        bg = _insert_region(memo, r.body, ctx, frozenset())
        g, _ = memo.insert(AndNode("while", (bg,), r.pred))
        return g
    raise TypeError(f"cannot insert region {r!r}")


def _track_empties(r: Region, empty: set) -> None:
    """Maintain which vars hold a fresh empty collection / zero scalar."""
    if isinstance(r, BasicBlock) and isinstance(r.stmt, Assign):
        e = r.stmt.expr
        if isinstance(e, (IEmptyList, IEmptyMap)) or (
                isinstance(e, IConst) and e.value in (0, 0.0)):
            empty.add(r.stmt.target)
        else:
            empty.discard(r.stmt.target)
    elif isinstance(r, (SeqRegion, CondRegion, LoopRegion, WhileRegion)):
        # conservative: any nested def invalidates
        for p in r.children():
            _track_empties(p, empty)
        if isinstance(r, (LoopRegion, WhileRegion)):
            empty.clear()


# --------------------------------------------------------------------------
# F-IR ⇄ relational scalar translation
# --------------------------------------------------------------------------

class _NotScalar(Exception):
    pass


def _fexpr_to_scalar(e: FExpr, colmap: Dict[Tuple[str, str], str]) -> Scalar:
    """F-IR value expr → relational Scalar over (joined) query columns.

    colmap: (row_name, field) → output column name."""
    if isinstance(e, FConst):
        return Lit(e.value)
    if isinstance(e, FField) and isinstance(e.base, FRow):
        out = colmap.get((e.base.name, e.col))
        if out is None:
            raise _NotScalar(f"unmapped column {e!r}")
        return Col(out)
    if isinstance(e, FBin):
        l = _fexpr_to_scalar(e.left, colmap)
        r = _fexpr_to_scalar(e.right, colmap)
        if e.op in ("+", "-", "*", "/", "min", "max"):
            return Arith(e.op, l, r)
        if e.op in ("==", "!=", "<", "<=", ">", ">="):
            return Cmp(e.op, l, r)
        raise _NotScalar(e.op)
    if isinstance(e, FCall):
        return Func(e.func, tuple(_fexpr_to_scalar(a, colmap) for a in e.args))
    raise _NotScalar(f"not scalar-translatable: {e!r}")


def _row_fields(e: FExpr, row: str) -> List[str]:
    out = []

    def walk(x: FExpr):
        if isinstance(x, FField) and isinstance(x.base, FRow) and x.base.name == row:
            out.append(x.col)
        for k in fir_children(x):
            walk(k)

    walk(e)
    return out


def _only_over_rows(e: FExpr, rows: frozenset) -> bool:
    """True iff e references only given row vars + constants (no accs/lookups)."""
    if isinstance(e, (FAcc, FVarRef, FPointLookup, FSelLookupE, FCacheLookupE,
                      FCacheLookupAllE, FFoldE, FQueryE)):
        return False
    if isinstance(e, FRow):
        return e.name in rows
    return all(_only_over_rows(k, rows) for k in fir_children(e))


def _get_parts(payload: FExpr) -> Tuple[Tuple[FExpr, ...], FFoldE]:
    """(prefetch parts, fold) from a slot payload expr."""
    if isinstance(payload, FSeqE):
        return payload.parts[:-1], payload.parts[-1]  # type: ignore
    return (), payload  # type: ignore


def _mk_payload(prefetches: Sequence[FExpr], fold: FFoldE) -> FExpr:
    if prefetches:
        return FSeqE(tuple(prefetches) + (fold,))
    return fold


# --------------------------------------------------------------------------
# Rule: cursor loop → F-IR (Fig. 9, modeled as a transformation, Sec. V-C)
# --------------------------------------------------------------------------

def rule_fir_convert(memo: Memo, and_id: int, ctx: RuleContext) -> int:
    node = memo.node(and_id)
    loop = ctx.loop_regions.get(and_id)
    if loop is None:
        return 0
    try:
        fold, index = loop_to_fir(loop)
    except FIRConversionError:
        return 0
    group = memo.owner(and_id)
    var_groups = []
    for var, i in sorted(index.items(), key=lambda kv: kv[1]):
        g, _ = memo.insert(AndNode("slot-project", (), ("slot", var, i, fold)))
        var_groups.append(g)
    memo.insert(AndNode("assemble", tuple(var_groups), ("assemble", fold.acc_names)),
                group=group)
    # propagate emptiness info to slot rules via ctx keyed by (fold key, var)
    for var in fold.acc_names:
        if var in ctx.empty_at_loop.get(and_id, frozenset()):
            ctx.empty_vars[(fold.key(), var)] = frozenset([var])
    return 1


# --------------------------------------------------------------------------
# Slot-extraction rules: T1, T5, T4
# --------------------------------------------------------------------------

def _slot(memo: Memo, and_id: int):
    node = memo.node(and_id)
    if node.op != "slot-project":
        return None
    _, var, i, payload = node.payload
    pre, fold = _get_parts(payload)
    return node, var, i, pre, fold


def rule_T1(memo: Memo, and_id: int, ctx: RuleContext) -> int:
    """fold(insert, {}, Q) ≡ Q — the collection is the query result itself."""
    s = _slot(memo, and_id)
    if s is None:
        return 0
    node, var, i, pre, fold = s
    if pre or not isinstance(fold.source, FQueryE):
        return 0
    upd = fold.func.items[i]
    if not (isinstance(upd, FInsert) and isinstance(upd.coll, FAcc)
            and upd.coll.name == var and isinstance(upd.val, FRow)
            and upd.val.name == fold.row_name):
        return 0
    if (fold.key(), var) not in ctx.empty_vars:
        return 0  # init not provably empty
    memo.insert(AndNode("slot-query-rows", (), ("rows", var, fold.source.query, None)),
                group=memo.owner(and_id))
    return 1


def rule_T5(memo: Memo, and_id: int, ctx: RuleContext) -> int:
    """fold(op, id, π_A(Q)) ≡ γ_op_agg(A)(Q) — scalar aggregation extraction.

    Handles the guarded form by first conceptually applying T2 (σ push)."""
    s = _slot(memo, and_id)
    if s is None:
        return 0
    node, var, i, pre, fold = s
    if pre:
        return 0
    binding: Optional[FExpr] = None
    if isinstance(fold.source, FQueryE):
        base_q = fold.source.query
    elif isinstance(fold.source, FSelLookupE):
        src = fold.source
        # correlated aggregate: σ_{A=:k}(R) — the key expr must be evaluable
        # at the region entry (no reference to this fold's row)
        if fir_contains(src.keyexpr, lambda x: isinstance(x, FRow)):
            return 0
        base_q = Select(Cmp("==", Col(src.key_col), Param("k")), Scan(src.table))
        binding = src.keyexpr
    else:
        return 0
    upd = fold.func.items[i]
    if isinstance(upd, FCondE):
        try:
            pred = _fexpr_to_scalar(upd.pred, _self_colmap(upd.pred, fold.row_name))
        except _NotScalar:
            return 0
        if not _only_over_rows(upd.pred, frozenset([fold.row_name])):
            return 0
        base_q = Select(pred, base_q)
        upd = upd.then
    if not (isinstance(upd, FBin) and upd.op in _AGG_OF_OP):
        return 0
    l_acc = isinstance(upd.left, FAcc) and upd.left.name == var
    r_acc = isinstance(upd.right, FAcc) and upd.right.name == var
    if l_acc == r_acc:
        return 0
    h = upd.right if l_acc else upd.left
    if not _only_over_rows(h, frozenset([fold.row_name])):
        return 0
    # build γ query
    if isinstance(h, FConst) and h.value == 1 and upd.op == "+":
        agg_q: Query = Aggregate((), (AggSpec("count", None, "agg_out"),), base_q)
    else:
        fields = _row_fields(h, fold.row_name)
        colmap = {(fold.row_name, c): c for c in fields}
        try:
            hs = _fexpr_to_scalar(h, colmap)
        except _NotScalar:
            return 0
        if isinstance(hs, Col):
            agg_q = Aggregate((), (AggSpec(_AGG_OF_OP[upd.op], hs.name, "agg_out"),),
                              base_q)
        else:
            proj = Project((), base_q, computed=(("h_val", hs),))
            agg_q = Aggregate((), (AggSpec(_AGG_OF_OP[upd.op], "h_val", "agg_out"),),
                              proj)
    memo.insert(AndNode("slot-query", (),
                        ("agg", var, agg_q, upd.op, "agg_out", binding)),
                group=memo.owner(and_id))
    return 1


def _self_colmap(e: FExpr, row: str) -> Dict[Tuple[str, str], str]:
    return {(row, c): c for c in _row_fields(e, row)}


def rule_T4(memo: Memo, and_id: int, ctx: RuleContext) -> int:
    """fold(fold(insert, id, σ_pred(Q2)), {}, Q1) ≡ Q1 ⋈_pred Q2 — nested
    cursor loops become a relational join evaluated at the database."""
    s = _slot(memo, and_id)
    if s is None:
        return 0
    node, var, i, pre, fold = s
    if pre or not isinstance(fold.source, FQueryE):
        return 0
    upd = fold.func.items[i]
    if isinstance(upd, FProjectE):
        upd = upd.base
    if not isinstance(upd, FFoldE) or upd.acc_names != (var,):
        return 0
    inner = upd
    in_upd = inner.func.items[0]
    # inner source must be a correlated σ on the outer row
    if not isinstance(inner.source, FSelLookupE):
        return 0
    keyexpr = inner.source.keyexpr
    if not (isinstance(keyexpr, FField) and isinstance(keyexpr.base, FRow)
            and keyexpr.base.name == fold.row_name):
        return 0
    if not (isinstance(in_upd, FInsert) and isinstance(in_upd.coll, FAcc)
            and in_upd.coll.name == var):
        return 0
    if (fold.key(), var) not in ctx.empty_vars:
        return 0
    val = in_upd.val
    rows = frozenset([fold.row_name, inner.row_name])
    if not _only_over_rows(val, rows):
        return 0
    # join: Q1 ⋈_{B = A} R   (B on outer, A on inner table)
    q1 = fold.source.query
    r_name = inner.source.table
    join = Join(q1, Scan(r_name), keyexpr.col, inner.source.key_col)
    # column mapping after the join (right duplicates get prefixed)
    try:
        left_names = set(q1.output_schema(ctx.db).names)
        right_names = ctx.db.table(r_name).schema.names
    except Exception:
        return 0
    colmap: Dict[Tuple[str, str], str] = {}
    for c in _row_fields(val, fold.row_name):
        colmap[(fold.row_name, c)] = c
    for c in _row_fields(val, inner.row_name):
        colmap[(inner.row_name, c)] = f"{r_name}_{c}" if c in left_names else c
    try:
        vs = _fexpr_to_scalar(val, colmap)
    except _NotScalar:
        return 0
    if isinstance(vs, Col):
        out_q: Query = Project((vs.name,), join)
        out_col = vs.name
    else:
        out_q = Project((), join, computed=(("join_val", vs),))
        out_col = "join_val"
    memo.insert(AndNode("slot-query-rows", (), ("rows", var, out_q, out_col)),
                group=memo.owner(and_id))
    return 1


def rule_point_to_join(memo: Memo, and_id: int, ctx: RuleContext) -> int:
    """SQL translation of iterative point lookups [4]: a fold whose function
    navigates σ1_{R.A = t.B}(R) becomes a fold over Q ⋈_{B=A} R (program P1
    of Fig. 3). The fold's row set is preserved by FK integrity (the lookup
    is an ORM relationship navigation)."""
    s = _slot(memo, and_id)
    if s is None:
        return 0
    node, var, i, pre, fold = s
    if pre or not isinstance(fold.source, FQueryE):
        return 0
    # find point lookups keyed by own-row fields; all uses must be FField
    lookups: Dict[Tuple[str, str, str], FPointLookup] = {}
    bad = []

    def scan(e: FExpr, parent_is_field: bool = False):
        if isinstance(e, FPointLookup):
            k = e.keyexpr
            if (isinstance(k, FField) and isinstance(k.base, FRow)
                    and k.base.name == fold.row_name):
                if not parent_is_field:
                    bad.append(e)
                lookups[(e.table, e.key_col, k.col)] = e
            else:
                bad.append(e)
            return
        for c in fir_children(e):
            scan(c, parent_is_field=isinstance(e, FField))

    scan(fold.func)
    if not lookups or bad:
        return 0
    try:
        left_names = set(fold.source.query.output_schema(ctx.db).names)
    except Exception:
        return 0
    q = fold.source.query
    renames: Dict[Tuple[str, str], str] = {}
    for (table, key_col, bcol) in sorted(lookups):
        rnames = ctx.db.table(table).schema.names
        for c in rnames:
            renames[(table, c)] = f"{table}_{c}" if c in left_names else c
        q = Join(q, Scan(table), bcol, key_col)
        left_names |= {renames[(table, c)] for c in rnames}

    def rewrite(e: FExpr) -> FExpr:
        if isinstance(e, FField) and isinstance(e.base, FPointLookup):
            pl = e.base
            return FField(FRow(fold.row_name), renames[(pl.table, e.col)])
        return e

    new_func = fir_map(fold.func, rewrite)
    new_fold = FFoldE(new_func, fold.init, FQueryE(q), fold.acc_names,
                      fold.row_name)
    return _add_slot_variant(memo, and_id, var, i, new_fold, ctx, fold)


# --------------------------------------------------------------------------
# Fold-rewriting rules: T2/N2 (plain + correlated), N1, N1a
# --------------------------------------------------------------------------

def _add_slot_variant(memo: Memo, and_id: int, var: str, i: int,
                      payload: FExpr, ctx: RuleContext = None,
                      old_fold: FFoldE = None) -> int:
    if ctx is not None and old_fold is not None:
        _, new_fold = _get_parts(payload)
        for v in old_fold.acc_names:
            if (old_fold.key(), v) in ctx.empty_vars:
                ctx.empty_vars[(new_fold.key(), v)] = frozenset([v])
    memo.insert(AndNode("slot-project", (), ("slot", var, i, payload)),
                group=memo.owner(and_id))
    return 1


def rule_T2_correlated(memo: Memo, and_id: int, ctx: RuleContext) -> int:
    """?(t2.A == k, g) over Scan(R) ≡ g over σ_{A=k}(R): push an equality
    guard into the (possibly correlated) source of a nested fold."""
    s = _slot(memo, and_id)
    if s is None:
        return 0
    node, var, i, pre, fold = s
    new = 0

    def rewrite(e: FExpr) -> FExpr:
        nonlocal new
        if isinstance(e, FFoldE) and isinstance(e.source, FQueryE) \
                and isinstance(e.source.query, Scan) and len(e.acc_names) == 1:
            u = e.func.items[0]
            if isinstance(u, FCondE) and isinstance(u.pred, FBin) and u.pred.op == "==":
                for a, b in ((u.pred.left, u.pred.right),
                             (u.pred.right, u.pred.left)):
                    if (isinstance(a, FField) and isinstance(a.base, FRow)
                            and a.base.name == e.row_name
                            and not fir_contains(
                                b, lambda x: isinstance(x, FRow)
                                and x.name == e.row_name)):
                        new += 1
                        return FFoldE(FTupleE((u.then,)), e.init,
                                      FSelLookupE(e.source.query.table, a.col, b),
                                      e.acc_names, e.row_name)
        return e

    new_fold = fir_map(fold, rewrite)
    if new == 0 or new_fold == fold:
        return 0
    return _add_slot_variant(memo, and_id, var, i, _mk_payload(pre, new_fold), ctx, fold)


def rule_N2_correlated(memo: Memo, and_id: int, ctx: RuleContext) -> int:
    """Reverse of T2-correlated: σ_{A=k}(R) source → Scan(R) + guard (N2)."""
    s = _slot(memo, and_id)
    if s is None:
        return 0
    node, var, i, pre, fold = s
    new = 0

    def rewrite(e: FExpr) -> FExpr:
        nonlocal new
        if isinstance(e, FFoldE) and isinstance(e.source, FSelLookupE) \
                and len(e.acc_names) == 1:
            u = e.func.items[0]
            pred = FBin("==", FField(FRow(e.row_name), e.source.key_col),
                        e.source.keyexpr)
            new += 1
            return FFoldE(FTupleE((FCondE(pred, u),)), e.init,
                          FQueryE(Scan(e.source.table)), e.acc_names, e.row_name)
        return e

    new_fold = fir_map(fold, rewrite)
    if new == 0 or new_fold == fold:
        return 0
    return _add_slot_variant(memo, and_id, var, i, _mk_payload(pre, new_fold), ctx, fold)


def rule_T2_plain(memo: Memo, and_id: int, ctx: RuleContext) -> int:
    """fold(?(pred, g), id, Q) ≡ fold(g, id, σ_pred(Q)) — uncorrelated form."""
    s = _slot(memo, and_id)
    if s is None:
        return 0
    node, var, i, pre, fold = s
    if not isinstance(fold.source, FQueryE):
        return 0
    upd = fold.func.items[i]
    if not isinstance(upd, FCondE):
        return 0
    if not _only_over_rows(upd.pred, frozenset([fold.row_name])):
        return 0
    try:
        pred = _fexpr_to_scalar(upd.pred, _self_colmap(upd.pred, fold.row_name))
    except _NotScalar:
        return 0
    if len(fold.acc_names) != 1:
        return 0  # σ push must preserve the other slots' row set
    new_fold = FFoldE(FTupleE((upd.then,)), fold.init,
                      FQueryE(Select(pred, fold.source.query)),
                      fold.acc_names, fold.row_name)
    return _add_slot_variant(memo, and_id, var, i, _mk_payload(pre, new_fold), ctx, fold)


def rule_N2_plain(memo: Memo, and_id: int, ctx: RuleContext) -> int:
    """fold(g, id, σ_pred(Q)) ≡ fold(?(pred, g), id, Q) — rule N2."""
    s = _slot(memo, and_id)
    if s is None:
        return 0
    node, var, i, pre, fold = s
    if not (isinstance(fold.source, FQueryE)
            and isinstance(fold.source.query, Select)
            and len(fold.acc_names) == 1):
        return 0
    sel = fold.source.query
    pred_f = _scalar_to_fexpr(sel.pred, fold.row_name)
    if pred_f is None:
        return 0
    new_fold = FFoldE(FTupleE((FCondE(pred_f, fold.func.items[i]),)), fold.init,
                      FQueryE(sel.child), fold.acc_names, fold.row_name)
    return _add_slot_variant(memo, and_id, var, i, _mk_payload(pre, new_fold), ctx, fold)


def _scalar_to_fexpr(s: Scalar, row: str) -> Optional[FExpr]:
    from ..relational.algebra import BoolOp
    if isinstance(s, Col):
        return FField(FRow(row), s.name)
    if isinstance(s, Lit):
        return FConst(s.value)
    if isinstance(s, (Cmp, Arith)):
        l = _scalar_to_fexpr(s.left, row)
        r = _scalar_to_fexpr(s.right, row)
        if l is None or r is None:
            return None
        return FBin(s.op, l, r)
    if isinstance(s, BoolOp):
        l = _scalar_to_fexpr(s.left, row)
        r = _scalar_to_fexpr(s.right, row)
        if l is None or r is None:
            return None
        return FBin(s.op, l, r)
    if isinstance(s, Func):
        args = tuple(_scalar_to_fexpr(a, row) for a in s.args)
        if any(a is None for a in args):
            return None
        return FCall(s.name, args)
    return None


def rule_N1(memo: Memo, and_id: int, ctx: RuleContext) -> int:
    """N1: iterative point lookups → prefetch(R, A) + local cache lookups."""
    s = _slot(memo, and_id)
    if s is None:
        return 0
    node, var, i, pre, fold = s
    targets = set()

    def collect(e: FExpr):
        if isinstance(e, FPointLookup):
            targets.add((e.table, e.key_col))
        for k in fir_children(e):
            collect(k)

    collect(fold)
    if not targets:
        return 0

    def rewrite(e: FExpr) -> FExpr:
        if isinstance(e, FPointLookup):
            return FCacheLookupE(e.table, e.key_col, e.keyexpr)
        return e

    new_fold = fir_map(fold, rewrite)
    prefetches = tuple(FPrefetchE(Scan(t), c) for t, c in sorted(targets))
    existing = tuple(p for p in pre
                     if not (isinstance(p, FPrefetchE)
                             and any(isinstance(q, FPrefetchE)
                                     and q.key() == p.key() for q in prefetches)))
    return _add_slot_variant(memo, and_id, var, i,
                             _mk_payload(existing + prefetches, new_fold), ctx, fold)


def rule_N1_all(memo: Memo, and_id: int, ctx: RuleContext) -> int:
    """N1 (set form): an inner fold over a correlated σ source → prefetch the
    whole relation + iterate the local multi-row cache lookup."""
    s = _slot(memo, and_id)
    if s is None:
        return 0
    node, var, i, pre, fold = s
    targets = set()

    def rewrite(e: FExpr) -> FExpr:
        if isinstance(e, FFoldE) and isinstance(e.source, FSelLookupE):
            src = e.source
            targets.add((src.table, src.key_col))
            return FFoldE(e.func, e.init,
                          FCacheLookupAllE(src.table, src.key_col, src.keyexpr),
                          e.acc_names, e.row_name)
        return e

    new_fold = fir_map(fold, rewrite)
    if not targets:
        return 0
    prefetches = tuple(FPrefetchE(Scan(t), c) for t, c in sorted(targets))
    return _add_slot_variant(memo, and_id, var, i,
                             _mk_payload(tuple(pre) + prefetches, new_fold), ctx, fold)


def rule_T3(memo: Memo, and_id: int, ctx: RuleContext) -> int:
    """T3: push a scalar function h(Q.A) into the query as a computed
    projection — fold(g(v, h(Q.A)), id, Q) ≡ fold(g, id, π_h(A)(Q))."""
    s = _slot(memo, and_id)
    if s is None:
        return 0
    node, var, i, pre, fold = s
    if not isinstance(fold.source, FQueryE):
        return 0
    upd = fold.func.items[i]
    # find a call h(t.A...) over own-row fields only
    found: List[FCall] = []

    def scan_calls(e: FExpr):
        if isinstance(e, FCall) and _only_over_rows(e, frozenset([fold.row_name])) \
                and _row_fields(e, fold.row_name):
            found.append(e)
            return
        for k in fir_children(e):
            scan_calls(k)

    scan_calls(upd)
    if not found:
        return 0
    target = found[0]
    fields = _row_fields(target, fold.row_name)
    colmap = {(fold.row_name, c): c for c in fields}
    try:
        hs = _fexpr_to_scalar(target, colmap)
    except _NotScalar:
        return 0
    # other slots must not need dropped columns — keep all original columns
    keep_cols = tuple(dict.fromkeys(
        c for j in range(len(fold.acc_names))
        for c in _row_fields(fold.func.items[j], fold.row_name)))
    new_q = Project(keep_cols, fold.source.query, computed=(("h_val", hs),))

    def rewrite(e: FExpr) -> FExpr:
        if e == target:
            return FField(FRow(fold.row_name), "h_val")
        return e

    new_items = tuple(fir_map(it, rewrite) for it in fold.func.items)
    new_fold = FFoldE(FTupleE(new_items), fold.init, FQueryE(new_q),
                      fold.acc_names, fold.row_name)
    return _add_slot_variant(memo, and_id, var, i, _mk_payload(pre, new_fold), ctx, fold)


# --------------------------------------------------------------------------
# Rule registry
# --------------------------------------------------------------------------

def default_rules() -> List[Rule]:
    return [
        # toFIR is a NORMALIZATION: it rewrites imperative loops into the
        # F-IR form every other rule matches on, so it saturates first —
        # the explore phase then starts from a fully-normalized frontier
        Rule("toFIR", "loop", rule_fir_convert, phase="normalize"),
        Rule("T1", "slot-project", rule_T1),
        Rule("T2", "slot-project", rule_T2_plain),
        Rule("T2c", "slot-project", rule_T2_correlated),
        Rule("N2", "slot-project", rule_N2_plain),
        Rule("N2c", "slot-project", rule_N2_correlated),
        Rule("T3", "slot-project", rule_T3),
        Rule("T4", "slot-project", rule_T4),
        Rule("T4j", "slot-project", rule_point_to_join),
        Rule("T5", "slot-project", rule_T5),
        Rule("N1", "slot-project", rule_N1),
        Rule("N1a", "slot-project", rule_N1_all),
    ]
