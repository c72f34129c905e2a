"""Imperative program IR with single-entry/single-exit regions (Sec. III-B, IV).

A program is a tree of regions:

    BasicBlock   — one statement (the paper treats each statement as a block)
    SeqRegion    — ordered children
    LoopRegion   — cursor loop ``for (t : <source>) { body }``
    CondRegion   — if/else
    WhileRegion  — guarded loop ``while (pred) { body }``

Early-exit statements (``BreakStmt``/``ContinueStmt``/``ReturnStmt``) cover
the imperative constructs the paper's Sec. V limitations call out: the
interpreters execute them faithfully (as non-local exits), while the
rewriting layers stay conservative — a cursor loop containing an exit is
never converted to F-IR or vectorized, and a ``while`` body participates in
rewrites only through the ordinary loops nested inside it.

Regions are *state transitions* ``R : X0 → X1`` (Sec. IV-A); the state is the
environment of program variables. Two interpreters execute regions against a
``ClientEnv`` (simulated client/server database, Sec. VIII):

  * ``Interpreter(mode="exact")`` — row-at-a-time semantics, the ground truth.
  * ``Interpreter(mode="fast")``  — vectorized execution of recognized cursor-
    loop bodies (columnar numpy compute) charging identical simulated time.
    Property-tested equivalent to ``exact`` (tests/test_properties.py).

Statement/expression vocabulary covers the paper's workloads: ORM loadAll /
relationship navigation (the N+1 pattern), executeQuery, prefetch +
cacheByColumn/lookup (footnote 3), collection/map accumulation, scalar
aggregation, and DB updates (left intact by F-IR, Sec. V-A).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..relational.algebra import Query, Scan
from ..relational.database import ClientEnv
from ..relational.table import Table
from .context import loop_site_key, while_site_key

__all__ = [
    # expressions
    "IExpr", "IConst", "IVar", "IField", "IBin", "ICall", "IQuery", "ILoadAll",
    "INav", "ICacheLookup", "IEmptyList", "IEmptyMap", "IIndex", "ILen",
    "IScalarQuery", "IQueryValues",
    # statements
    "Stmt", "Assign", "CollectionAdd", "MapPut", "Prefetch", "CacheByColumn",
    "UpdateRow", "NoOp", "BreakStmt", "ContinueStmt", "ReturnStmt",
    # regions
    "Region", "BasicBlock", "SeqRegion", "LoopRegion", "CondRegion",
    "WhileRegion", "Program",
    "Interpreter", "register_function", "get_function", "write_tables",
    "CompileNote", "compilability",
]

# --------------------------------------------------------------------------
# Registered pure functions (like myFunc in Fig. 3) — must be torch-vectorizable
# --------------------------------------------------------------------------

_FUNCTIONS: Dict[str, Callable] = {
    "myFunc": lambda *args: sum(a * (i + 1) for i, a in enumerate(args)),
    "combine": lambda a, b: a * 31 + b,
    "scale": lambda a: a * 3,
}


def register_function(name: str, fn: Callable) -> None:
    _FUNCTIONS[name] = fn
    # the SQL-translation rules (T3/T4) push calls into relational computed
    # columns, so every program function is also a relational scalar func
    from ..relational.algebra import register_scalar_func
    register_scalar_func(name, fn)


def _register_builtins() -> None:
    for _n, _f in list(_FUNCTIONS.items()):
        register_function(_n, _f)


def get_function(name: str) -> Callable:
    return _FUNCTIONS[name]


# --------------------------------------------------------------------------
# Expressions
# --------------------------------------------------------------------------

class IExpr:
    def key(self) -> Tuple:
        raise NotImplementedError

    def __hash__(self):
        return hash(self.key())

    def __eq__(self, other):
        return isinstance(other, IExpr) and self.key() == other.key()

    def free_vars(self) -> Tuple[str, ...]:
        return ()


@dataclasses.dataclass(frozen=True, eq=False)
class IConst(IExpr):
    value: object

    def key(self):
        return ("iconst", self.value)

    def __repr__(self):
        return repr(self.value)


@dataclasses.dataclass(frozen=True, eq=False)
class IVar(IExpr):
    name: str

    def key(self):
        return ("ivar", self.name)

    def free_vars(self):
        return (self.name,)

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True, eq=False)
class IField(IExpr):
    """Row-field access ``t.col`` where ``t`` holds a row (dict)."""

    base: IExpr
    field: str

    def key(self):
        return ("ifield", self.base.key(), self.field)

    def free_vars(self):
        return self.base.free_vars()

    def __repr__(self):
        return f"{self.base!r}.{self.field}"


_BIN_OPS: Dict[str, Callable] = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b, "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "and": lambda a, b: torch.logical_and(a, b) if isinstance(a, torch.Tensor) else (a and b),
    "or": lambda a, b: torch.logical_or(a, b) if isinstance(a, torch.Tensor) else (a or b),
    "min": lambda a, b: torch.minimum(a, b) if isinstance(a, torch.Tensor) else min(a, b),
    "max": lambda a, b: torch.maximum(a, b) if isinstance(a, torch.Tensor) else max(a, b),
}


@dataclasses.dataclass(frozen=True, eq=False)
class IBin(IExpr):
    op: str
    left: IExpr
    right: IExpr

    def key(self):
        return ("ibin", self.op, self.left.key(), self.right.key())

    def free_vars(self):
        return self.left.free_vars() + self.right.free_vars()

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class ICall(IExpr):
    func: str
    args: Tuple[IExpr, ...]

    def key(self):
        return ("icall", self.func, tuple(a.key() for a in self.args))

    def free_vars(self):
        out: Tuple[str, ...] = ()
        for a in self.args:
            out += a.free_vars()
        return out

    def __repr__(self):
        return f"{self.func}({', '.join(map(repr, self.args))})"


@dataclasses.dataclass(frozen=True, eq=False)
class IQuery(IExpr):
    """``executeQuery(q)`` — q may contain Param(:p) bound from imperative exprs."""

    query: Query
    bindings: Tuple[Tuple[str, IExpr], ...] = ()

    def key(self):
        return ("iquery", self.query.key(), tuple((n, e.key()) for n, e in self.bindings))

    def free_vars(self):
        out: Tuple[str, ...] = ()
        for _, e in self.bindings:
            out += e.free_vars()
        return out

    def __repr__(self):
        return f"executeQuery({self.query.sql()!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class ILoadAll(IExpr):
    """ORM ``loadAll(Entity.class)`` — a full-table fetch."""

    table: str

    def key(self):
        return ("iloadall", self.table)

    def __repr__(self):
        return f"loadAll({self.table})"


@dataclasses.dataclass(frozen=True, eq=False)
class INav(IExpr):
    """ORM relationship navigation ``o.customer`` → lazy point query.

    ``base.fk_field`` is the foreign key; resolves one row of ``target``
    (keyed by ``target_key``) through the ORM id-cache.
    """

    base: IExpr
    fk_field: str
    target: str
    target_key: str

    def key(self):
        return ("inav", self.base.key(), self.fk_field, self.target, self.target_key)

    def free_vars(self):
        return self.base.free_vars()

    def __repr__(self):
        return f"{self.base!r}->{self.target}"


@dataclasses.dataclass(frozen=True, eq=False)
class ICacheLookup(IExpr):
    """``Utils.lookupCache`` over a prefetched, column-keyed cache."""

    table: str
    col: str
    keyexpr: IExpr
    all_matches: bool = False  # True → list of rows, False → single row

    def key(self):
        return ("icachelookup", self.table, self.col, self.keyexpr.key(), self.all_matches)

    def free_vars(self):
        return self.keyexpr.free_vars()

    def __repr__(self):
        return f"lookupCache({self.table}.{self.col}, {self.keyexpr!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class IScalarQuery(IExpr):
    """Execute a query and return one scalar (first row of `col`; 0 if empty)."""

    query: Query
    col: str
    bindings: Tuple[Tuple[str, "IExpr"], ...] = ()

    def key(self):
        return ("iscalarquery", self.query.key(), self.col,
                tuple((n, e.key()) for n, e in self.bindings))

    def free_vars(self):
        out: Tuple[str, ...] = ()
        for _, e in self.bindings:
            out += e.free_vars()
        return out

    def __repr__(self):
        return f"scalarQuery({self.query.sql()!r}, {self.col})"


@dataclasses.dataclass(frozen=True, eq=False)
class IQueryValues(IExpr):
    """Execute a query and return `col` as a Python list (collection value)."""

    query: Query
    col: str

    def key(self):
        return ("iqueryvalues", self.query.key(), self.col)

    def __repr__(self):
        return f"queryValues({self.query.sql()!r}, {self.col})"


@dataclasses.dataclass(frozen=True, eq=False)
class IEmptyList(IExpr):
    def key(self):
        return ("iemptylist",)

    def __repr__(self):
        return "{}"


@dataclasses.dataclass(frozen=True, eq=False)
class IEmptyMap(IExpr):
    def key(self):
        return ("iemptymap",)

    def __repr__(self):
        return "Map()"


@dataclasses.dataclass(frozen=True, eq=False)
class IIndex(IExpr):
    """Subscript read ``base[key]`` on a collection/map/query-result value.

    The field is named ``keyexpr`` (not ``index``) so the generic IExpr
    walkers — table extraction in ``api.cache`` and the operator-cost
    traversal in ``core.cost`` — cover it without special cases."""

    base: IExpr
    keyexpr: IExpr

    def key(self):
        return ("iindex", self.base.key(), self.keyexpr.key())

    def free_vars(self):
        return self.base.free_vars() + self.keyexpr.free_vars()

    def __repr__(self):
        return f"{self.base!r}[{self.keyexpr!r}]"


@dataclasses.dataclass(frozen=True, eq=False)
class ILen(IExpr):
    base: IExpr

    def key(self):
        return ("ilen", self.base.key())

    def free_vars(self):
        return self.base.free_vars()

    def __repr__(self):
        return f"len({self.base!r})"


# --------------------------------------------------------------------------
# Statements
# --------------------------------------------------------------------------

class Stmt:
    def key(self) -> Tuple:
        raise NotImplementedError

    def __hash__(self):
        return hash(self.key())

    def __eq__(self, other):
        return isinstance(other, Stmt) and self.key() == other.key()

    def defs(self) -> Tuple[str, ...]:
        return ()

    def uses(self) -> Tuple[str, ...]:
        return ()


@dataclasses.dataclass(frozen=True, eq=False)
class Assign(Stmt):
    target: str
    expr: IExpr

    def key(self):
        return ("assign", self.target, self.expr.key())

    def defs(self):
        return (self.target,)

    def uses(self):
        return self.expr.free_vars()

    def __repr__(self):
        return f"{self.target} = {self.expr!r}"


@dataclasses.dataclass(frozen=True, eq=False)
class CollectionAdd(Stmt):
    target: str
    expr: IExpr

    def key(self):
        return ("colladd", self.target, self.expr.key())

    def defs(self):
        return (self.target,)

    def uses(self):
        return (self.target,) + self.expr.free_vars()

    def __repr__(self):
        return f"{self.target}.add({self.expr!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class MapPut(Stmt):
    target: str
    keyexpr: IExpr
    valexpr: IExpr

    def key(self):
        return ("mapput", self.target, self.keyexpr.key(), self.valexpr.key())

    def defs(self):
        return (self.target,)

    def uses(self):
        return (self.target,) + self.keyexpr.free_vars() + self.valexpr.free_vars()

    def __repr__(self):
        return f"{self.target}.put({self.keyexpr!r}, {self.valexpr!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class Prefetch(Stmt):
    """``prefetch(R, A)``: fetch a query result and cache it keyed by column A."""

    query: Query
    col: str
    cache_name: Optional[str] = None  # defaults to root table name

    def key(self):
        return ("prefetch", self.query.key(), self.col)

    def __repr__(self):
        return f"prefetch({self.query.sql()!r}, by={self.col})"


@dataclasses.dataclass(frozen=True, eq=False)
class CacheByColumn(Stmt):
    """``Utils.cacheByColumn(collection_var, col)`` on an already-fetched table."""

    var: str
    col: str

    def key(self):
        return ("cachebycolumn", self.var, self.col)

    def uses(self):
        return (self.var,)

    def __repr__(self):
        return f"cacheByColumn({self.var}, {self.col!r})"


@dataclasses.dataclass(frozen=True, eq=False)
class UpdateRow(Stmt):
    """DB update — F-IR leaves updates intact (Sec. V limitations)."""

    table: str
    set_col: str
    val: IExpr
    key_col: str
    keyexpr: IExpr

    def key(self):
        return ("update", self.table, self.set_col, self.val.key(),
                self.key_col, self.keyexpr.key())

    def uses(self):
        return self.val.free_vars() + self.keyexpr.free_vars()

    def __repr__(self):
        return (f"UPDATE {self.table} SET {self.set_col}={self.val!r} "
                f"WHERE {self.key_col}={self.keyexpr!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class NoOp(Stmt):
    note: str = ""

    def key(self):
        return ("noop", self.note)

    def __repr__(self):
        return f"noop({self.note})"


@dataclasses.dataclass(frozen=True, eq=False)
class BreakStmt(Stmt):
    """Exit the nearest enclosing loop (``break``)."""

    def key(self):
        return ("break",)

    def __repr__(self):
        return "break"


@dataclasses.dataclass(frozen=True, eq=False)
class ContinueStmt(Stmt):
    """Skip to the next iteration of the nearest enclosing loop."""

    def key(self):
        return ("continue",)

    def __repr__(self):
        return "continue"


@dataclasses.dataclass(frozen=True, eq=False)
class ReturnStmt(Stmt):
    """Early exit from the whole program body.

    Program outputs stay the declared variable names; a return site assigns
    them first (the frontend lowers ``return e`` that way), then exits."""

    def key(self):
        return ("return",)

    def __repr__(self):
        return "return"


# --------------------------------------------------------------------------
# Regions
# --------------------------------------------------------------------------

_region_counter = itertools.count()


class Region:
    label: str

    def key(self) -> Tuple:
        raise NotImplementedError

    def __hash__(self):
        return hash(self.key())

    def __eq__(self, other):
        return isinstance(other, Region) and self.key() == other.key()

    def children(self) -> Tuple["Region", ...]:
        return ()


@dataclasses.dataclass(frozen=True, eq=False)
class BasicBlock(Region):
    stmt: Stmt
    label: str = ""

    def key(self):
        return ("B", self.stmt.key())

    def __repr__(self):
        return f"B[{self.stmt!r}]"


@dataclasses.dataclass(frozen=True, eq=False)
class SeqRegion(Region):
    parts: Tuple[Region, ...]
    label: str = ""

    def key(self):
        return ("S", tuple(p.key() for p in self.parts))

    def children(self):
        return self.parts

    def __repr__(self):
        return "S[" + "; ".join(map(repr, self.parts)) + "]"


@dataclasses.dataclass(frozen=True, eq=False)
class LoopRegion(Region):
    """Cursor loop ``for (var : source) body``. Source: IQuery/ILoadAll/IVar."""

    var: str
    source: IExpr
    body: Region
    label: str = ""

    def key(self):
        return ("L", self.var, self.source.key(), self.body.key())

    def children(self):
        return (self.body,)

    def __repr__(self):
        return f"L[for {self.var} : {self.source!r} {{ {self.body!r} }}]"


@dataclasses.dataclass(frozen=True, eq=False)
class CondRegion(Region):
    pred: IExpr
    then_r: Region
    else_r: Optional[Region] = None
    label: str = ""

    def key(self):
        return ("C", self.pred.key(), self.then_r.key(),
                self.else_r.key() if self.else_r else None)

    def children(self):
        return (self.then_r,) + ((self.else_r,) if self.else_r else ())

    def __repr__(self):
        e = f" else {{ {self.else_r!r} }}" if self.else_r else ""
        return f"C[if {self.pred!r} {{ {self.then_r!r} }}{e}]"


@dataclasses.dataclass(frozen=True, eq=False)
class WhileRegion(Region):
    """Guarded loop ``while (pred) body`` — iteration count is data-dependent,
    so the region itself is never folded to F-IR; loops nested in its body
    still participate in rewrites individually."""

    pred: IExpr
    body: Region
    label: str = ""

    def key(self):
        return ("W", self.pred.key(), self.body.key())

    def children(self):
        return (self.body,)

    def __repr__(self):
        return f"W[while {self.pred!r} {{ {self.body!r} }}]"


@dataclasses.dataclass(frozen=True, eq=False)
class Program:
    """Outermost region + the variables whose final values are the output state."""

    name: str
    body: Region
    outputs: Tuple[str, ...]
    inputs: Tuple[Tuple[str, object], ...] = ()

    def key(self):
        return ("P", self.name, self.body.key(), self.outputs)


def seq(*parts: Union[Region, Stmt]) -> SeqRegion:
    rs = tuple(BasicBlock(p) if isinstance(p, Stmt) else p for p in parts)
    return SeqRegion(rs)


def write_tables(program: Program) -> Tuple[str, ...]:
    """The base tables a Program WRITES (``UpdateRow`` statements), sorted.

    The canonical write-set walk: the serving runtime's write-set-aware
    batching and the cost model's amortization guard (a site over a
    written table can never be served from a shared cache) both consume
    it; ``repro_torch.api.cache.program_write_tables`` delegates here."""
    out = set()

    def walk(r: Region):
        if isinstance(r, BasicBlock) and isinstance(r.stmt, UpdateRow):
            out.add(r.stmt.table)
        for c in r.children():
            walk(c)

    walk(program.body)
    return tuple(sorted(out))


# --------------------------------------------------------------------------
# Compilability analysis
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompileNote:
    """Per-region verdict of the compiled tier's lowering analysis.

    ``verdict`` is ``"columnar"`` (the region lowers to a vectorized
    executable) or ``"interpreter"`` (it stays on the row-at-a-time /
    splicing interpreter); ``reason`` names the construct that forced the
    interpreter tier. ``site`` is the region's iteration-site key, so
    annotations join against the feedback controller's observed counts."""

    kind: str      # "loop" | "while"
    verdict: str   # "columnar" | "interpreter"
    reason: str
    site: str


def _has_early_exit(r: Region) -> bool:
    if isinstance(r, BasicBlock):
        return isinstance(r.stmt, (BreakStmt, ContinueStmt, ReturnStmt))
    return any(_has_early_exit(c) for c in r.children())


def _has_nested_iteration(r: Region) -> bool:
    if isinstance(r, (LoopRegion, WhileRegion)):
        return True
    return any(_has_nested_iteration(c) for c in r.children())


def _loop_reject_reason(r: LoopRegion) -> str:
    """Coarse diagnosis of WHY ``analyze_loop`` rejected a loop body. The
    authoritative accept/reject is ``vectorize.analyze_loop``; this only
    names the blocking construct for annotations/telemetry."""
    if _has_early_exit(r.body):
        return "early-exit (break/continue/return pins iteration order)"
    if _has_nested_iteration(r.body):
        return "nested loop in body"

    def has_else(x: Region) -> bool:
        if isinstance(x, CondRegion) and x.else_r is not None:
            return True
        return any(has_else(c) for c in x.children())

    if has_else(r.body):
        return "if/else body (only a single guard if vectorizes)"
    return "statement outside the columnar vocabulary"


def compilability(program: Union[Program, Region]) -> Dict[Tuple, CompileNote]:
    """Annotate every iteration region with its compiled-tier verdict.

    Returns ``{region.key(): CompileNote}``. Loops whose bodies
    ``vectorize.analyze_loop`` accepts are ``"columnar"`` — the compiled
    tier lowers exactly those; ``while`` regions (data-dependent iteration
    counts) and rejected loop bodies stay ``"interpreter"``, and the
    compiled executable splices its columnar segments around them."""
    from .vectorize import analyze_loop

    notes: Dict[Tuple, CompileNote] = {}
    body = program.body if isinstance(program, Program) else program

    def walk(r: Region) -> None:
        if isinstance(r, LoopRegion):
            if analyze_loop(r, {}) is not None:
                notes[r.key()] = CompileNote(
                    kind="loop", verdict="columnar", reason="",
                    site=loop_site_key(r.var, r.source))
            else:
                notes[r.key()] = CompileNote(
                    kind="loop", verdict="interpreter",
                    reason=_loop_reject_reason(r),
                    site=loop_site_key(r.var, r.source))
        elif isinstance(r, WhileRegion):
            notes[r.key()] = CompileNote(
                kind="while", verdict="interpreter",
                reason="data-dependent iteration count",
                site=while_site_key(r.pred))
        for c in r.children():
            walk(c)

    walk(body)
    return notes


# --------------------------------------------------------------------------
# Interpreter
# --------------------------------------------------------------------------

class _Row(dict):
    """A row value; dict with attribute-ish access by field name."""


class _BreakSignal(Exception):
    """Raised by BreakStmt; caught by the nearest enclosing loop."""


class _ContinueSignal(Exception):
    """Raised by ContinueStmt; caught by the nearest enclosing loop."""


class _ReturnSignal(Exception):
    """Raised by ReturnStmt; caught at Program level (Interpreter.run)."""


# runaway-while backstop: a genuine program never gets close, a bad guard
# fails loudly instead of hanging the test suite
MAX_WHILE_ITERS = 1_000_000


class Interpreter:
    """Executes regions against a ClientEnv; accumulates simulated time there."""

    def __init__(self, env: ClientEnv, mode: str = "exact"):
        assert mode in ("exact", "fast")
        self.env = env
        self.mode = mode

    # ------------------------------------------------------------ public API
    def run(self, program: Program, init_state: Optional[Mapping[str, object]] = None
            ) -> Dict[str, object]:
        state: Dict[str, object] = dict(program.inputs)
        if init_state:
            state.update(init_state)
        try:
            self.exec_region(program.body, state)
        except _ReturnSignal:
            pass  # early `return`: outputs are the state at the exit point
        return {v: state.get(v) for v in program.outputs}

    # ---------------------------------------------------------------- exprs
    def eval(self, e: IExpr, state: Dict[str, object]):
        env = self.env
        if isinstance(e, IConst):
            return e.value
        if isinstance(e, IVar):
            return state[e.name]
        if isinstance(e, IField):
            row = self.eval(e.base, state)
            return row[e.field]
        if isinstance(e, IBin):
            return _BIN_OPS[e.op](self.eval(e.left, state), self.eval(e.right, state))
        if isinstance(e, ICall):
            return _FUNCTIONS[e.func](*[self.eval(a, state) for a in e.args])
        if isinstance(e, IQuery):
            params = {n: self.eval(x, state) for n, x in e.bindings}
            return env.execute_query(e.query, params or None)
        if isinstance(e, ILoadAll):
            return env.execute_query(Scan(e.table))
        if isinstance(e, INav):
            row = self.eval(e.base, state)
            return env.point_lookup(e.target, e.target_key, row[e.fk_field])
        if isinstance(e, ICacheLookup):
            k = self.eval(e.keyexpr, state)
            if e.all_matches:
                return env.lookup_cache_all(e.table, e.col, k)
            return env.lookup_cache(e.table, e.col, k)
        if isinstance(e, IScalarQuery):
            params = {n: self.eval(x, state) for n, x in e.bindings}
            t = env.execute_query(e.query, params or None)
            if t.nrows == 0:
                return 0
            return t.host(e.col)[0].item()
        if isinstance(e, IQueryValues):
            t = env.execute_query(e.query)
            return t.host(e.col).tolist()
        if isinstance(e, IEmptyList):
            return []
        if isinstance(e, IEmptyMap):
            return {}
        if isinstance(e, IIndex):
            v = self.eval(e.base, state)
            k = self.eval(e.keyexpr, state)
            if isinstance(v, Table):
                return _Row(v.to_rows()[int(k)])
            out = v[k]
            return _Row(out) if isinstance(out, dict) and not isinstance(
                out, _Row) else out
        if isinstance(e, ILen):
            v = self.eval(e.base, state)
            return v.nrows if isinstance(v, Table) else len(v)
        raise TypeError(f"cannot eval {e!r}")

    # ----------------------------------------------------------- statements
    def exec_stmt(self, s: Stmt, state: Dict[str, object]) -> None:
        env = self.env
        if isinstance(s, Assign):
            env.charge_statement()
            state[s.target] = self.eval(s.expr, state)
        elif isinstance(s, CollectionAdd):
            env.charge_statement()
            state.setdefault(s.target, [])
            state[s.target].append(self.eval(s.expr, state))
        elif isinstance(s, MapPut):
            env.charge_statement()
            state.setdefault(s.target, {})
            state[s.target][self.eval(s.keyexpr, state)] = self.eval(s.valexpr, state)
        elif isinstance(s, Prefetch):
            t = env.execute_query(s.query)
            env.cache_by_column(
                t if s.cache_name is None else
                Table(s.cache_name, t.schema, t.columns, device=t.device),
                s.col)
            state[f"__prefetch_{t.name}_{s.col}"] = t
        elif isinstance(s, CacheByColumn):
            v = state[s.var]
            assert isinstance(v, Table), "cacheByColumn expects a query result"
            env.cache_by_column(v, s.col)
        elif isinstance(s, UpdateRow):
            # one round trip per update statement; value computed client-side
            val = self.eval(s.val, state)
            key = self.eval(s.keyexpr, state)
            m = env.db.model
            env._charge_query(1, 16, m.startup_s + m.index_lookup_s,
                              m.startup_s + m.index_lookup_s)
            t = env.db.table(s.table)
            arr = t.host(s.key_col)
            idx = np.flatnonzero(arr == key)
            if len(idx):
                col = t.host(s.set_col).copy()
                col[idx] = val
                env.db.add_table(t.with_column(t.schema.field(s.set_col), col))
        elif isinstance(s, NoOp):
            env.charge_statement()
        elif isinstance(s, BreakStmt):
            env.charge_statement()
            raise _BreakSignal()
        elif isinstance(s, ContinueStmt):
            env.charge_statement()
            raise _ContinueSignal()
        elif isinstance(s, ReturnStmt):
            env.charge_statement()
            raise _ReturnSignal()
        else:
            raise TypeError(f"cannot exec {s!r}")

    # -------------------------------------------------------------- regions
    def exec_region(self, r: Region, state: Dict[str, object]) -> None:
        if isinstance(r, BasicBlock):
            self.exec_stmt(r.stmt, state)
        elif isinstance(r, SeqRegion):
            for p in r.parts:
                self.exec_region(p, state)
        elif isinstance(r, CondRegion):
            self.env.charge_statement()
            if bool(self.eval(r.pred, state)):
                self.exec_region(r.then_r, state)
            elif r.else_r is not None:
                self.exec_region(r.else_r, state)
        elif isinstance(r, LoopRegion):
            src = self.eval(r.source, state)
            if self.mode == "fast":
                from .vectorize import try_exec_loop_fast
                if try_exec_loop_fast(self, r, src, state):
                    return
            self._exec_loop_exact(r, src, state)
        elif isinstance(r, WhileRegion):
            iters = 0
            try:
                while True:
                    self.env.charge_statement()  # guard evaluation
                    if not bool(self.eval(r.pred, state)):
                        break
                    iters += 1
                    if iters > MAX_WHILE_ITERS:
                        raise RuntimeError(
                            f"while loop exceeded {MAX_WHILE_ITERS} iterations "
                            f"(guard {r.pred!r} never became false)")
                    try:
                        self.exec_region(r.body, state)
                    except _ContinueSignal:
                        continue
                    except _BreakSignal:
                        break
            finally:
                # observed iteration count for this while site — the number
                # the cost model only ever estimated (while_iters_default);
                # the feedback controller folds these into a StatsProfile
                self.env.record_iterations(while_site_key(r.pred), iters)
        else:
            raise TypeError(f"cannot exec region {r!r}")

    def _exec_loop_exact(self, r: LoopRegion, src, state: Dict[str, object]) -> None:
        rows: Sequence
        if isinstance(src, Table):
            rows = src.to_rows()
        elif isinstance(src, list):
            rows = src
            # collection-source loops have no table statistics behind them;
            # record the true length so feedback can replace the cost
            # model's loop_iters_default for this site
            if not isinstance(r.source, (IQuery, ILoadAll)):
                self.env.record_iterations(loop_site_key(r.var, r.source),
                                           len(rows))
        else:
            raise TypeError(f"cannot iterate {type(src)}")
        for row in rows:
            self.env.charge_statement()  # loop header/advance
            state[r.var] = _Row(row) if isinstance(row, dict) else row
            try:
                self.exec_region(r.body, state)
            except _ContinueSignal:
                continue
            except _BreakSignal:
                break
        state.pop(r.var, None)


_register_builtins()
