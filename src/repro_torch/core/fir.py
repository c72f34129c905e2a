"""F-IR: the fold intermediate representation (Sec. V).

F-IR algebraically represents cursor loops: variables at region end are
expressions over region-entry values (``FVarRef``) and the loop's source
query. The paper's extension over [4] — ``tuple`` + ``project`` — lets a
single ``fold`` return ALL accumulated variables, including *dependent*
aggregations (cumulative sum, Fig. 7/8), by removing precondition P2.

Node vocabulary beyond the paper's figures (needed to express its example
workloads): ``FPointLookup`` (single-row correlated σ — what an ORM
navigation denotes), ``FSelLookupE`` (multi-row correlated σ — an iterative
query inside a loop), ``FCacheLookupE``/``FCacheLookupAllE`` (rule N1's
``lookup``), and nested ``FFoldE`` (nested cursor loops — rule T4's LHS).

This module provides:

  * the node vocabulary (hashable dataclass trees);
  * ``loop_to_fir`` — the Fig. 9 conversion (cursor loop region → ``fold``
    over a tuple of update expressions; P2 removed; nested loops supported);
  * ``eval_fir`` — a reference evaluator against a ClientEnv (the oracle for
    rule-equivalence property tests);
  * ``fir_to_region`` — code generation from F-IR back to imperative regions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple


from ..relational.algebra import Cmp, Col, Param, Query, Scan, Select
from ..relational.table import Table
from .regions import (Assign, BasicBlock, CollectionAdd, CondRegion, IBin,
                      ICacheLookup, ICall, IConst, IEmptyList, IEmptyMap,
                      IExpr, IField, INav, IQuery, IVar, LoopRegion, MapPut,
                      NoOp, Prefetch, Region, SeqRegion, Stmt, _BIN_OPS,
                      _FUNCTIONS)

__all__ = [
    "FExpr", "FConst", "FVarRef", "FAcc", "FRow", "FField", "FBin", "FCall",
    "FInsert", "FMapPutE", "FTupleE", "FProjectE", "FCondE", "FPointLookup",
    "FSelLookupE", "FCacheLookupE", "FCacheLookupAllE", "FQueryE", "FFoldE",
    "FSeqE", "FPrefetchE", "loop_to_fir", "FIRConversionError", "eval_fir",
    "fir_to_region", "fir_children", "fir_rebuild", "fir_map", "fold_to_loop",
    "NameGen", "fold_accumulators",
]


# --------------------------------------------------------------------------
# Node vocabulary
# --------------------------------------------------------------------------

class FExpr:
    def key(self) -> Tuple:
        raise NotImplementedError

    def __hash__(self):
        return hash(self.key())

    def __eq__(self, other):
        return isinstance(other, FExpr) and self.key() == other.key()


@dataclasses.dataclass(frozen=True, eq=False)
class FConst(FExpr):
    value: object

    def key(self):
        return ("fconst", self.value)

    def __repr__(self):
        return repr(self.value)


@dataclasses.dataclass(frozen=True, eq=False)
class FVarRef(FExpr):
    """Value of a program variable at region entry (the input state X0)."""

    name: str

    def key(self):
        return ("fvar", self.name)

    def __repr__(self):
        return f"@{self.name}"


@dataclasses.dataclass(frozen=True, eq=False)
class FAcc(FExpr):
    """Parametric accumulator reference — ``<v>`` in the paper's notation."""

    name: str

    def key(self):
        return ("facc", self.name)

    def __repr__(self):
        return f"<{self.name}>"


@dataclasses.dataclass(frozen=True, eq=False)
class FRow(FExpr):
    """A fold's tuple variable (one row of that fold's source)."""

    name: str = "t"

    def key(self):
        return ("frow", self.name)

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True, eq=False)
class FField(FExpr):
    base: FExpr
    col: str

    def key(self):
        return ("ffield", self.base.key(), self.col)

    def __repr__(self):
        return f"{self.base!r}.{self.col}"


@dataclasses.dataclass(frozen=True, eq=False)
class FBin(FExpr):
    op: str
    left: FExpr
    right: FExpr

    def key(self):
        return ("fbin", self.op, self.left.key(), self.right.key())

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class FCall(FExpr):
    func: str
    args: Tuple[FExpr, ...]

    def key(self):
        return ("fcall", self.func, tuple(a.key() for a in self.args))

    def __repr__(self):
        return f"{self.func}({', '.join(map(repr, self.args))})"


@dataclasses.dataclass(frozen=True, eq=False)
class FInsert(FExpr):
    """Collection insertion function (``insert`` in T1/T4)."""

    coll: FExpr
    val: FExpr

    def key(self):
        return ("finsert", self.coll.key(), self.val.key())

    def __repr__(self):
        return f"insert({self.coll!r}, {self.val!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class FMapPutE(FExpr):
    map: FExpr
    mkey: FExpr
    val: FExpr

    def key(self):
        return ("fmapput", self.map.key(), self.mkey.key(), self.val.key())

    def __repr__(self):
        return f"mapput({self.map!r}, {self.mkey!r}, {self.val!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class FTupleE(FExpr):
    """The paper's new ``tuple`` operator (Sec. V-B)."""

    items: Tuple[FExpr, ...]

    def key(self):
        return ("ftuple", tuple(i.key() for i in self.items))

    def __repr__(self):
        return f"tuple({', '.join(map(repr, self.items))})"


@dataclasses.dataclass(frozen=True, eq=False)
class FProjectE(FExpr):
    """The paper's new ``project`` operator — inverse of ``tuple``."""

    base: FExpr
    index: int

    def key(self):
        return ("fproject", self.base.key(), self.index)

    def __repr__(self):
        return f"project{self.index}({self.base!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class FCondE(FExpr):
    """``?(pred, g)`` — conditional execution operator (T2/N2)."""

    pred: FExpr
    then: FExpr

    def key(self):
        return ("fcond", self.pred.key(), self.then.key())

    def __repr__(self):
        return f"?({self.pred!r}, {self.then!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class FPointLookup(FExpr):
    """Correlated point query σ_{key_col = key}(table) returning ONE row
    (what an ORM navigation denotes — the N+1 pattern)."""

    table: str
    key_col: str
    keyexpr: FExpr

    def key(self):
        return ("fpoint", self.table, self.key_col, self.keyexpr.key())

    def __repr__(self):
        return f"σ1[{self.table}.{self.key_col}={self.keyexpr!r}]"


@dataclasses.dataclass(frozen=True, eq=False)
class FSelLookupE(FExpr):
    """Correlated σ_{key_col = key}(table) returning a SET of rows — an
    iterative query executed at the database per outer row."""

    table: str
    key_col: str
    keyexpr: FExpr

    def key(self):
        return ("fsel", self.table, self.key_col, self.keyexpr.key())

    def __repr__(self):
        return f"σ[{self.table}.{self.key_col}={self.keyexpr!r}]"


@dataclasses.dataclass(frozen=True, eq=False)
class FCacheLookupE(FExpr):
    """Local single-row cache lookup (``lookup`` of rule N1)."""

    table: str
    key_col: str
    keyexpr: FExpr

    def key(self):
        return ("fcachelkp", self.table, self.key_col, self.keyexpr.key())

    def __repr__(self):
        return f"lookup[{self.table}.{self.key_col}={self.keyexpr!r}]"


@dataclasses.dataclass(frozen=True, eq=False)
class FCacheLookupAllE(FExpr):
    """Local multi-row cache lookup (all rows matching the key)."""

    table: str
    key_col: str
    keyexpr: FExpr

    def key(self):
        return ("fcachelkpall", self.table, self.key_col, self.keyexpr.key())

    def __repr__(self):
        return f"lookupAll[{self.table}.{self.key_col}={self.keyexpr!r}]"


@dataclasses.dataclass(frozen=True, eq=False)
class FQueryE(FExpr):
    """A relational query leaf (executed at the database)."""

    query: Query

    def key(self):
        return ("fquery", self.query.key())

    def __repr__(self):
        return f"Q[{self.query.sql()}]"


@dataclasses.dataclass(frozen=True, eq=False)
class FFoldE(FExpr):
    """fold(func, init, source) — func over (<accs>, row_name)."""

    func: FExpr   # FTupleE of per-accumulator update expressions
    init: FExpr   # FTupleE of entry values
    source: FExpr  # FQueryE | FSelLookupE | FCacheLookupAllE
    acc_names: Tuple[str, ...]
    row_name: str = "t"

    def key(self):
        return ("ffold", self.func.key(), self.init.key(), self.source.key(),
                self.acc_names, self.row_name)

    def __repr__(self):
        return f"fold({self.func!r}, {self.init!r}, {self.source!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class FPrefetchE(FExpr):
    """prefetch(R, A): side-effecting cache fill (rule N1's seq head)."""

    query: Query
    col: str

    def key(self):
        return ("fprefetch", self.query.key(), self.col)

    def __repr__(self):
        return f"prefetch({self.query.sql()!r}, by={self.col})"


@dataclasses.dataclass(frozen=True, eq=False)
class FSeqE(FExpr):
    """Sequential combination inside F-IR (N1 produces seq(prefetch, fold))."""

    parts: Tuple[FExpr, ...]

    def key(self):
        return ("fseq", tuple(p.key() for p in self.parts))

    def __repr__(self):
        return f"seq({', '.join(map(repr, self.parts))})"


# --------------------------------------------------------------------------
# Generic traversal
# --------------------------------------------------------------------------

def fir_children(e: FExpr) -> Tuple[FExpr, ...]:
    if isinstance(e, (FConst, FVarRef, FAcc, FRow, FQueryE, FPrefetchE)):
        return ()
    if isinstance(e, FField):
        return (e.base,)
    if isinstance(e, FBin):
        return (e.left, e.right)
    if isinstance(e, FCall):
        return e.args
    if isinstance(e, FInsert):
        return (e.coll, e.val)
    if isinstance(e, FMapPutE):
        return (e.map, e.mkey, e.val)
    if isinstance(e, FTupleE):
        return e.items
    if isinstance(e, FProjectE):
        return (e.base,)
    if isinstance(e, FCondE):
        return (e.pred, e.then)
    if isinstance(e, (FPointLookup, FSelLookupE, FCacheLookupE, FCacheLookupAllE)):
        return (e.keyexpr,)
    if isinstance(e, FFoldE):
        return (e.func, e.init, e.source)
    if isinstance(e, FSeqE):
        return e.parts
    raise TypeError(type(e))


def fir_rebuild(e: FExpr, new_children: Sequence[FExpr]) -> FExpr:
    c = tuple(new_children)
    if isinstance(e, (FConst, FVarRef, FAcc, FRow, FQueryE, FPrefetchE)):
        return e
    if isinstance(e, FField):
        return FField(c[0], e.col)
    if isinstance(e, FBin):
        return FBin(e.op, c[0], c[1])
    if isinstance(e, FCall):
        return FCall(e.func, c)
    if isinstance(e, FInsert):
        return FInsert(c[0], c[1])
    if isinstance(e, FMapPutE):
        return FMapPutE(c[0], c[1], c[2])
    if isinstance(e, FTupleE):
        return FTupleE(c)
    if isinstance(e, FProjectE):
        return FProjectE(c[0], e.index)
    if isinstance(e, FCondE):
        return FCondE(c[0], c[1])
    if isinstance(e, FPointLookup):
        return FPointLookup(e.table, e.key_col, c[0])
    if isinstance(e, FSelLookupE):
        return FSelLookupE(e.table, e.key_col, c[0])
    if isinstance(e, FCacheLookupE):
        return FCacheLookupE(e.table, e.key_col, c[0])
    if isinstance(e, FCacheLookupAllE):
        return FCacheLookupAllE(e.table, e.key_col, c[0])
    if isinstance(e, FFoldE):
        return FFoldE(c[0], c[1], c[2], e.acc_names, e.row_name)
    if isinstance(e, FSeqE):
        return FSeqE(c)
    raise TypeError(type(e))


def fir_map(e: FExpr, fn) -> FExpr:
    """Bottom-up rewrite."""
    kids = tuple(fir_map(k, fn) for k in fir_children(e))
    return fn(fir_rebuild(e, kids))


def fir_contains(e: FExpr, pred) -> bool:
    if pred(e):
        return True
    return any(fir_contains(k, pred) for k in fir_children(e))


# --------------------------------------------------------------------------
# Loop → F-IR conversion (Fig. 9, precondition P2 removed)
# --------------------------------------------------------------------------

class FIRConversionError(Exception):
    pass


def _row_name_for(loop_var: str) -> str:
    """Deterministic F-IR row name for a cursor loop.

    Derived from the loop variable (unique within a lexical scope) instead of
    a global counter, so converting the same program twice — in one process
    or across sessions — yields byte-identical F-IR. Content-stable names are
    what lets the disk-backed plan store dedupe compiled programs."""
    return f"t_{loop_var}"


def _iexpr_to_fir(e: IExpr, subst: Dict[str, FExpr], row_names: Dict[str, str]) -> FExpr:
    """Translate an imperative expression. `subst` resolves intermediate
    assignments (variables expressed over region-entry values — Sec. V-A);
    `row_names` maps loop variables to F-IR row names."""
    if isinstance(e, IConst):
        return FConst(e.value)
    if isinstance(e, IVar):
        if e.name in row_names:
            return FRow(row_names[e.name])
        if e.name in subst:
            return subst[e.name]
        return FVarRef(e.name)
    if isinstance(e, IField):
        return FField(_iexpr_to_fir(e.base, subst, row_names), e.field)
    if isinstance(e, IBin):
        return FBin(e.op, _iexpr_to_fir(e.left, subst, row_names),
                    _iexpr_to_fir(e.right, subst, row_names))
    if isinstance(e, ICall):
        return FCall(e.func, tuple(_iexpr_to_fir(a, subst, row_names) for a in e.args))
    if isinstance(e, INav):
        base = _iexpr_to_fir(e.base, subst, row_names)
        if isinstance(base, (FPointLookup, FCacheLookupE)):
            keyexpr: FExpr = FField(base, e.fk_field)
        elif isinstance(base, FRow):
            keyexpr = FField(base, e.fk_field)
        else:
            raise FIRConversionError(f"nav base too complex: {e!r}")
        return FPointLookup(e.target, e.target_key, keyexpr)
    if isinstance(e, ICacheLookup):
        k = _iexpr_to_fir(e.keyexpr, subst, row_names)
        if e.all_matches:
            return FCacheLookupAllE(e.table, e.col, k)
        return FCacheLookupE(e.table, e.col, k)
    if isinstance(e, IQuery):
        q = e.query
        if (len(e.bindings) == 1 and isinstance(q, Select)
                and isinstance(q.child, Scan) and isinstance(q.pred, Cmp)
                and q.pred.op == "=="):
            pname, bexpr = e.bindings[0]
            lhs, rhs = q.pred.left, q.pred.right
            if isinstance(rhs, Col) and isinstance(lhs, Param):
                lhs, rhs = rhs, lhs
            if isinstance(lhs, Col) and isinstance(rhs, Param) and rhs.name == pname:
                return FSelLookupE(q.child.table, lhs.name,
                                   _iexpr_to_fir(bexpr, subst, row_names))
        if e.bindings:
            raise FIRConversionError(f"correlated query too complex: {e!r}")
        return FQueryE(e.query)
    if isinstance(e, IEmptyList):
        return FConst(())
    if isinstance(e, IEmptyMap):
        return FConst(())
    if hasattr(e, "table") and type(e).__name__ == "ILoadAll":
        return FQueryE(Scan(e.table))
    raise FIRConversionError(f"cannot represent {e!r} in F-IR")


def loop_to_fir(loop: LoopRegion) -> Tuple[FFoldE, Dict[str, int]]:
    """Fig. 9 ``loopToFold``: returns (fold expr, var → tuple index).

    Handles straight-line bodies with optional guards, nested cursor loops
    (nested folds — rule T4's LHS), and dependent aggregations (P2 removed)."""
    fold = _convert_loop(loop, subst={}, row_names={})
    return fold, {a: i for i, a in enumerate(fold.acc_names)}


def _source_to_fir(src: IExpr, subst, row_names) -> FExpr:
    out = _iexpr_to_fir(src, subst, row_names)
    if isinstance(out, (FQueryE, FSelLookupE, FCacheLookupAllE)):
        return out
    raise FIRConversionError(f"loop source not a query/lookup: {src!r}")


def _convert_loop(loop: LoopRegion, subst: Dict[str, FExpr],
                  row_names: Dict[str, str]) -> FFoldE:
    source = _source_to_fir(loop.source, subst, row_names)
    row_name = _row_name_for(loop.var)
    row_names = {**row_names, loop.var: row_name}

    parts = _body_parts(loop.body)
    subst = dict(subst)
    acc_update: Dict[str, FExpr] = {}
    acc_order: List[str] = []

    def acc_ref(name: str) -> FExpr:
        return acc_update.get(name, FAcc(name))

    def ctx() -> Dict[str, FExpr]:
        return {**subst, **{a: acc_ref(a) for a in acc_order}}

    def record(name: str, upd: FExpr) -> None:
        if name not in acc_order:
            acc_order.append(name)
        acc_update[name] = upd

    def handle_stmt(stmt: Stmt, guard: Optional[IExpr]) -> None:
        if isinstance(stmt, Assign):
            e = stmt.expr
            if isinstance(e, IBin) and any(
                    isinstance(s, IVar) and s.name == stmt.target
                    for s in (e.left, e.right)):
                l_is = isinstance(e.left, IVar) and e.left.name == stmt.target
                other = e.right if l_is else e.left
                other_f = _iexpr_to_fir(other, ctx(), row_names)
                cur = acc_ref(stmt.target)
                upd = FBin(e.op, cur, other_f) if l_is else FBin(e.op, other_f, cur)
                if guard is not None:
                    upd = FCondE(_iexpr_to_fir(guard, ctx(), row_names), upd)
                record(stmt.target, upd)
                return
            if guard is not None:
                raise FIRConversionError("guarded temp assignment")
            subst[stmt.target] = _iexpr_to_fir(e, ctx(), row_names)
            return
        if isinstance(stmt, CollectionAdd):
            val = _iexpr_to_fir(stmt.expr, ctx(), row_names)
            upd: FExpr = FInsert(acc_ref(stmt.target), val)
            if guard is not None:
                upd = FCondE(_iexpr_to_fir(guard, ctx(), row_names), upd)
            record(stmt.target, upd)
            return
        if isinstance(stmt, MapPut):
            c = ctx()
            upd = FMapPutE(acc_ref(stmt.target),
                           _iexpr_to_fir(stmt.keyexpr, c, row_names),
                           _iexpr_to_fir(stmt.valexpr, c, row_names))
            if guard is not None:
                upd = FCondE(_iexpr_to_fir(guard, c, row_names), upd)
            record(stmt.target, upd)
            return
        if isinstance(stmt, NoOp):
            return
        raise FIRConversionError(f"statement not representable: {stmt!r}")

    for part, guard in parts:
        if isinstance(part, LoopRegion):
            if guard is not None:
                raise FIRConversionError("guarded nested loop")
            inner = _convert_loop(part, ctx(), row_names)
            if len(inner.acc_names) != 1:
                raise FIRConversionError("nested loop with multiple accumulators")
            name = inner.acc_names[0]
            # inner fold starts from the CURRENT value: the accumulator's
            # update-so-far, a resolved temp (e.g. s = 0 just before), or the
            # region-entry value.
            start = acc_update.get(name, subst.get(name, FAcc(name)))
            inner = FFoldE(inner.func, FTupleE((start,)), inner.source,
                           inner.acc_names, inner.row_name)
            subst.pop(name, None)
            record(name, FProjectE(inner, 0))
        else:
            handle_stmt(part, guard)

    if not acc_order:
        raise FIRConversionError("loop has no accumulated variables")

    # unwrap project0(fold) single-slot markers for nested folds
    def unwrap(e: FExpr) -> FExpr:
        if isinstance(e, FProjectE) and isinstance(e.base, FFoldE) \
                and len(e.base.acc_names) == 1 and e.index == 0:
            return e.base
        return e

    func = FTupleE(tuple(unwrap(acc_update[a]) for a in acc_order))
    init = FTupleE(tuple(FVarRef(a) for a in acc_order))
    return FFoldE(func, init, source, tuple(acc_order), row_name)


def _body_parts(region: Region) -> List[Tuple[object, Optional[IExpr]]]:
    """Flatten a loop body to [(Stmt-or-LoopRegion, guard)]."""
    out: List[Tuple[object, Optional[IExpr]]] = []

    def walk(r: Region, guard: Optional[IExpr]) -> None:
        if isinstance(r, BasicBlock):
            out.append((r.stmt, guard))
        elif isinstance(r, SeqRegion):
            for p in r.parts:
                walk(p, guard)
        elif isinstance(r, CondRegion):
            if guard is not None or r.else_r is not None:
                raise FIRConversionError("nested/else conditions")
            walk(r.then_r, r.pred)
        elif isinstance(r, LoopRegion):
            out.append((r, guard))
        else:
            raise FIRConversionError(f"region not representable: {r!r}")

    walk(region, None)
    return out


def fold_accumulators(loop: LoopRegion) -> Optional[Dict[str, str]]:
    """Scalar-accumulator reduction ops of a cursor loop as F-IR sees them.

    Converts the loop to its fold form and pattern-matches each slot's
    update expression: ``{acc: op}`` where ``op`` is the ``FBin`` operator
    of an ``acc = acc <op> e`` update (unwrapping one guard ``FCondE``),
    or ``"other"`` for collection/map/non-reduction slots. Returns ``None``
    when the loop has no F-IR form at all. The compiled tier's lowering
    (:mod:`repro_torch.compiled.lower`) uses this as a semantic cross-check on
    the syntactic accumulator recognition before it folds a column with a
    reduction kernel: a slot both analyses agree is an order-insensitive
    ``+``/``min``/``max`` fold is safe to compute as one reduction."""
    try:
        fold, idx = loop_to_fir(loop)
    except FIRConversionError:
        return None
    out: Dict[str, str] = {}
    for name, i in idx.items():
        upd = fold.func.items[i]
        if isinstance(upd, FCondE):
            upd = upd.then
        if isinstance(upd, FBin):
            l_is = isinstance(upd.left, FAcc) and upd.left.name == name
            r_is = isinstance(upd.right, FAcc) and upd.right.name == name
            if l_is != r_is:
                out[name] = upd.op
                continue
        out[name] = "other"
    return out


# --------------------------------------------------------------------------
# Reference evaluator (oracle)
# --------------------------------------------------------------------------

class _CondSkip:
    """Marker: ?(pred, g) with false pred → accumulator keeps previous value."""

    def __repr__(self):
        return "<skip>"


_COND_SKIP = _CondSkip()


def eval_fir(e: FExpr, env, state: Mapping[str, object],
             accs: Optional[Dict[str, object]] = None,
             rows: Optional[Dict[str, Mapping[str, object]]] = None):
    """Evaluate F-IR against a live ClientEnv. Side effects (queries,
    prefetches, lookups) charge simulated time on `env` — the evaluator both
    checks semantic equivalence and measures plan cost."""
    accs = accs or {}
    rows = rows or {}
    if isinstance(e, FConst):
        return [] if e.value == () else e.value
    if isinstance(e, FVarRef):
        v = state[e.name]
        return list(v) if isinstance(v, list) else (dict(v) if isinstance(v, dict) else v)
    if isinstance(e, FAcc):
        return accs[e.name]
    if isinstance(e, FRow):
        return rows[e.name]
    if isinstance(e, FField):
        return eval_fir(e.base, env, state, accs, rows)[e.col]
    if isinstance(e, FBin):
        return _BIN_OPS[e.op](eval_fir(e.left, env, state, accs, rows),
                              eval_fir(e.right, env, state, accs, rows))
    if isinstance(e, FCall):
        return _FUNCTIONS[e.func](*[eval_fir(a, env, state, accs, rows) for a in e.args])
    if isinstance(e, FInsert):
        coll = eval_fir(e.coll, env, state, accs, rows)
        val = eval_fir(e.val, env, state, accs, rows)
        return list(coll) + [val]
    if isinstance(e, FMapPutE):
        m = dict(eval_fir(e.map, env, state, accs, rows))
        m[eval_fir(e.mkey, env, state, accs, rows)] = eval_fir(e.val, env, state, accs, rows)
        return m
    if isinstance(e, FTupleE):
        return tuple(eval_fir(i, env, state, accs, rows) for i in e.items)
    if isinstance(e, FProjectE):
        return eval_fir(e.base, env, state, accs, rows)[e.index]
    if isinstance(e, FCondE):
        if bool(eval_fir(e.pred, env, state, accs, rows)):
            return eval_fir(e.then, env, state, accs, rows)
        return _COND_SKIP
    if isinstance(e, FPointLookup):
        k = eval_fir(e.keyexpr, env, state, accs, rows)
        return env.point_lookup(e.table, e.key_col, k)
    if isinstance(e, FSelLookupE):
        k = eval_fir(e.keyexpr, env, state, accs, rows)
        q = Select(Cmp("==", Col(e.key_col), Param("k")), Scan(e.table))
        return env.execute_query(q, {"k": k})
    if isinstance(e, FCacheLookupE):
        k = eval_fir(e.keyexpr, env, state, accs, rows)
        return env.lookup_cache(e.table, e.key_col, k)
    if isinstance(e, FCacheLookupAllE):
        k = eval_fir(e.keyexpr, env, state, accs, rows)
        return env.lookup_cache_all(e.table, e.key_col, k)
    if isinstance(e, FQueryE):
        return env.execute_query(e.query)
    if isinstance(e, FPrefetchE):
        t = env.execute_query(e.query)
        env.cache_by_column(t, e.col)
        return None
    if isinstance(e, FSeqE):
        out = None
        for p in e.parts:
            out = eval_fir(p, env, state, accs, rows)
        return out
    if isinstance(e, FFoldE):
        src = eval_fir(e.source, env, state, accs, rows)
        src_rows = src.to_rows() if isinstance(src, Table) else list(src)
        init = eval_fir(e.init, env, state, accs, rows)
        cur = {n: init[i] for i, n in enumerate(e.acc_names)}
        assert isinstance(e.func, FTupleE)
        # Each tuple item is expressed over iteration-START accumulator
        # values (<v>) and the row — dependent aggregations were inlined at
        # construction time (Fig. 8: the cSum item embeds <sum>+Q.sale_amt).
        for rr in src_rows:
            rbind = {**rows, e.row_name: rr}
            new = {}
            for i, n in enumerate(e.acc_names):
                v = eval_fir(e.func.items[i], env, state, {**accs, **cur}, rbind)
                new[n] = cur[n] if v is _COND_SKIP else v
            cur = new
        return tuple(cur[n] for n in e.acc_names)
    raise TypeError(f"cannot eval {e!r}")


# --------------------------------------------------------------------------
# Code generation: F-IR → imperative regions
# --------------------------------------------------------------------------

class NameGen:
    """Alpha-normalized codegen names.

    One instance is created per code-generation run (``plan_to_region`` /
    ``fir_to_region`` entry), numbering each prefix from 1 in tree-walk
    order. Because the walk over a chosen plan is deterministic, two
    searches of the same program — even in different processes — emit
    byte-identical imperative IR, which lets the cross-session plan store
    dedupe compiled programs (previously a global counter made every run's
    gensyms unique and alpha-equivalence had to be normalized away in
    tests)."""

    def __init__(self):
        self._n: Dict[str, int] = {}

    def fresh(self, prefix: str = "tmp") -> str:
        n = self._n.get(prefix, 0) + 1
        self._n[prefix] = n
        return f"__{prefix}{n}"


def _val_to_iexpr(e: FExpr, row_vars: Dict[str, str], pre: List[Region],
                  names: Optional[NameGen] = None) -> IExpr:
    """Translate a value-producing F-IR expr to an imperative expr. `pre`
    collects statements (cache/nav lookups into temporaries)."""
    if names is None:
        names = NameGen()
    if isinstance(e, FConst):
        return IEmptyList() if e.value == () else IConst(e.value)
    if isinstance(e, FVarRef):
        return IVar(e.name)
    if isinstance(e, FAcc):
        return IVar(e.name)
    if isinstance(e, FRow):
        return IVar(row_vars[e.name])
    if isinstance(e, FField):
        return IField(_val_to_iexpr(e.base, row_vars, pre, names), e.col)
    if isinstance(e, FBin):
        return IBin(e.op, _val_to_iexpr(e.left, row_vars, pre, names),
                    _val_to_iexpr(e.right, row_vars, pre, names))
    if isinstance(e, FCall):
        return ICall(e.func, tuple(_val_to_iexpr(a, row_vars, pre, names)
                                   for a in e.args))
    if isinstance(e, FPointLookup):
        tmp = names.fresh("nav")
        base_key = _val_to_iexpr(e.keyexpr, row_vars, pre, names)
        if isinstance(base_key, IField) and isinstance(base_key.base, IVar):
            pre.append(BasicBlock(Assign(tmp, INav(base_key.base, base_key.field,
                                                   e.table, e.key_col))))
        else:
            pre.append(BasicBlock(Assign(tmp, IQuery(
                Select(Cmp("==", Col(e.key_col), Param("k")), Scan(e.table)),
                (("k", base_key),)))))
        return IVar(tmp)
    if isinstance(e, FCacheLookupE):
        tmp = names.fresh("lkp")
        pre.append(BasicBlock(Assign(tmp, ICacheLookup(
            e.table, e.key_col, _val_to_iexpr(e.keyexpr, row_vars, pre, names)))))
        return IVar(tmp)
    if isinstance(e, FQueryE):
        return IQuery(e.query)
    raise TypeError(f"cannot codegen value {e!r}")


def _source_to_iexpr(src: FExpr, row_vars: Dict[str, str], pre: List[Region],
                     names: NameGen) -> IExpr:
    if isinstance(src, FQueryE):
        return IQuery(src.query)
    if isinstance(src, FSelLookupE):
        key = _val_to_iexpr(src.keyexpr, row_vars, pre, names)
        return IQuery(Select(Cmp("==", Col(src.key_col), Param("k")), Scan(src.table)),
                      (("k", key),))
    if isinstance(src, FCacheLookupAllE):
        key = _val_to_iexpr(src.keyexpr, row_vars, pre, names)
        return ICacheLookup(src.table, src.key_col, key, all_matches=True)
    raise TypeError(f"cannot codegen source {src!r}")


def fold_to_loop(fold: FFoldE, slots: Optional[Sequence[int]] = None,
                 row_vars: Optional[Dict[str, str]] = None,
                 names: Optional[NameGen] = None) -> Region:
    """Generate a loop for (a subset of slots of) a fold.

    ``slots=None`` keeps all slots. A kept slot that references another
    accumulator transitively forces that slot to stay (dependency closure)."""
    assert isinstance(fold.func, FTupleE)
    if names is None:
        names = NameGen()
    row_vars = dict(row_vars or {})
    loop_var = names.fresh("r")
    row_vars[fold.row_name] = loop_var

    keep = set(range(len(fold.acc_names))) if slots is None else set(slots)
    # dependency closure over FAcc references
    changed = True
    while changed:
        changed = False
        for i in sorted(keep):
            expr = fold.func.items[i]
            for j, nm in enumerate(fold.acc_names):
                if j not in keep and fir_contains(expr, lambda x: isinstance(x, FAcc)
                                                  and x.name == nm):
                    keep.add(j)
                    changed = True

    pre_src: List[Region] = []
    src_expr = _source_to_iexpr(fold.source, row_vars, pre_src, names)

    body: List[Region] = []
    for i in sorted(keep):
        body.extend(_update_to_parts(fold.func.items[i], fold.acc_names[i],
                                     row_vars, names))
    inner: Region = SeqRegion(tuple(body)) if len(body) != 1 else body[0]
    loop = LoopRegion(loop_var, src_expr, inner)
    if pre_src:
        return SeqRegion(tuple(pre_src) + (loop,))
    return loop


def _update_to_parts(upd: FExpr, name: str, row_vars: Dict[str, str],
                     names: NameGen) -> List[Region]:
    pre: List[Region] = []
    if isinstance(upd, FCondE):
        pred = _val_to_iexpr(upd.pred, row_vars, pre, names)
        inner = _update_to_parts(upd.then, name, row_vars, names)
        body: Region = SeqRegion(tuple(inner)) if len(inner) != 1 else inner[0]
        return pre + [CondRegion(pred, body)]
    if isinstance(upd, FFoldE):
        # nested fold accumulating into `name`
        assert upd.acc_names == (name,)
        return pre + [fold_to_loop(upd, row_vars=row_vars, names=names)]
    if isinstance(upd, FProjectE) and isinstance(upd.base, FFoldE):
        return _update_to_parts(upd.base, name, row_vars, names)
    if isinstance(upd, FInsert):
        val = _val_to_iexpr(upd.val, row_vars, pre, names)
        return pre + [BasicBlock(CollectionAdd(name, val))]
    if isinstance(upd, FMapPutE):
        k = _val_to_iexpr(upd.mkey, row_vars, pre, names)
        v = _val_to_iexpr(upd.val, row_vars, pre, names)
        return pre + [BasicBlock(MapPut(name, k, v))]
    val = _val_to_iexpr(upd, row_vars, pre, names)
    return pre + [BasicBlock(Assign(name, val))]


def fir_to_region(e: FExpr, slots: Optional[Sequence[int]] = None,
                  names: Optional[NameGen] = None) -> Region:
    """Generate an imperative region computing `e` (a fold/seq alternative)."""
    if names is None:
        names = NameGen()
    if isinstance(e, FSeqE):
        parts: List[Region] = []
        for p in e.parts[:-1]:
            parts.append(fir_to_region(p, names=names))
        parts.append(fir_to_region(e.parts[-1], slots, names=names))
        return SeqRegion(tuple(parts))
    if isinstance(e, FPrefetchE):
        return BasicBlock(Prefetch(e.query, e.col))
    if isinstance(e, FFoldE):
        return fold_to_loop(e, slots, names=names)
    raise TypeError(f"cannot codegen region for {e!r}")
