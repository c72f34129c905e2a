"""Tracing program builder: the lowering target of the Region IR frontends.

The primary way into Cobra is a **plain Python function** handed to
``session.trace`` / ``repro_torch.api.lift``: the AST lifter lowers real
``for``/``if``/``while`` code onto THIS builder, which is the single
emission path for Region IR. Use the builder directly as the **escape
hatch** — programs outside the liftable subset (or tooling that constructs
programs programmatically) record statements as straight-line code inside
``with``-scoped loops and conditionals and produce the identical IR::

    b = ProgramBuilder("P0")
    b.relate("orders", "o_customer_sk", "customer", "c_customer_sk",
             name="customer")
    result = b.let("result", b.empty_list())
    with b.loop(b.load_all("orders"), var="o") as o:
        cust = b.let("cust", o.customer)           # ORM navigation (N+1)
        val = b.let("val", b.call("myFunc", o.o_id, cust.c_birth_year))
        b.add(result, val)
    p0 = b.build(outputs=(result,))

Control flow covers everything the lifter emits: ``loop``/``when``/
``otherwise`` plus ``while_`` guarded loops and the early-exit statements
``brk``/``cont``/``ret`` (break / continue / early return).

Three kinds of handles flow through user code:

  * :class:`Expr` — wraps an ``IExpr``; Python operators (``+ - * / ==``,
    ...) trace into ``IBin`` nodes, attribute access into ``IField`` (or
    ``INav`` when a relationship is registered for the variable's table).
  * :class:`Q` — a fluent relational query handle from :func:`q`:
    ``q("tasks").where(col("t_role_id").eq(param("rid"))).bind(rid=x.r_id)``.
  * :class:`VarHandle` — a named program variable (from ``let`` / ``loop``).

Scoping rule (matches the hand-built programs exactly): a loop body or
conditional branch with one region stays unwrapped; multiple regions become
a ``SeqRegion``; the program top level is always a ``SeqRegion``.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..relational.algebra import (AggSpec, Aggregate, Col, Join, Limit,
                                  OrderBy, Param, Project, Query, Scalar,
                                  Scan, Select)
from ..core.regions import (Assign, BasicBlock, BreakStmt, CacheByColumn,
                            CollectionAdd, CondRegion, ContinueStmt, IBin,
                            ICacheLookup, ICall, IConst, IEmptyList, IEmptyMap,
                            IExpr, IField, IIndex, ILen, ILoadAll, INav,
                            IQuery, IQueryValues, IScalarQuery, IVar,
                            LoopRegion, MapPut, NoOp, Prefetch, Program,
                            Region, ReturnStmt, SeqRegion, Stmt, UpdateRow,
                            WhileRegion)

__all__ = ["ProgramBuilder", "Expr", "VarHandle", "Q", "q", "col", "param"]


# --------------------------------------------------------------------------
# Relational query handles
# --------------------------------------------------------------------------

def col(name: str) -> Col:
    """Column reference for relational predicates/projections."""
    return Col(name)


def param(name: str) -> Param:
    """Named query parameter, bound later via ``Q.bind(name=<expr>)``."""
    return Param(name)


class Q:
    """Fluent wrapper over a relational ``Query`` tree plus pending
    parameter bindings (imperative expressions for each ``Param``)."""

    __slots__ = ("query", "bindings")

    def __init__(self, query: Query,
                 bindings: Tuple[Tuple[str, IExpr], ...] = ()):
        self.query = query
        self.bindings = bindings

    # ------------------------------------------------------------- operators
    def where(self, pred: Scalar) -> "Q":
        return Q(Select(pred, self.query), self.bindings)

    def select(self, *cols: str, **computed: Scalar) -> "Q":
        return Q(Project(tuple(cols), self.query,
                         tuple(sorted(computed.items()))), self.bindings)

    def join(self, other: Union["Q", Query, str], left_key: str,
             right_key: str) -> "Q":
        rhs = q(other)
        return Q(Join(self.query, rhs.query, left_key, right_key),
                 self.bindings + rhs.bindings)

    def order_by(self, *keys: str, descending: bool = False) -> "Q":
        return Q(OrderBy(tuple(keys), self.query, descending), self.bindings)

    def limit(self, k: int) -> "Q":
        return Q(Limit(k, self.query), self.bindings)

    def agg(self, group_by: Sequence[str] = (), **aggs) -> "Q":
        """``.agg(total=("sum", "o_amt"), n=("count", None))``"""
        specs = tuple(AggSpec(func, c, out)
                      for out, (func, c) in sorted(aggs.items()))
        return Q(Aggregate(tuple(group_by), specs, self.query), self.bindings)

    def bind(self, **exprs) -> "Q":
        """Bind query ``Param``s to imperative expressions."""
        new = tuple((n, _ir(e)) for n, e in sorted(exprs.items()))
        return Q(self.query, self.bindings + new)

    def sql(self) -> str:
        return self.query.sql()

    def __repr__(self):
        return f"q[{self.query.sql()}]"


def q(source: Union[str, Query, Q]) -> Q:
    """Query handle: ``q("orders")`` scans a table; also accepts an existing
    relational ``Query`` tree or another handle (idempotent)."""
    if isinstance(source, Q):
        return source
    if isinstance(source, Query):
        return Q(source)
    if isinstance(source, str):
        return Q(Scan(source))
    raise TypeError(f"q() takes a table name or Query, got {type(source)}")


# --------------------------------------------------------------------------
# Imperative expression handles
# --------------------------------------------------------------------------

def _ir(v) -> IExpr:
    """Coerce a user-facing value into an IExpr."""
    if isinstance(v, Expr):
        return v._ir
    if isinstance(v, IExpr):
        return v
    if isinstance(v, (int, float, str, bool)):
        return IConst(v)
    raise TypeError(f"cannot trace {type(v).__name__} into an expression")


class Expr:
    """Traced expression handle; operators build ``IBin`` / ``IField`` IR."""

    __slots__ = ("_ir", "_builder", "_table")

    def __init__(self, ir: IExpr, builder: Optional["ProgramBuilder"] = None,
                 table: Optional[str] = None):
        object.__setattr__(self, "_ir", ir)
        object.__setattr__(self, "_builder", builder)
        object.__setattr__(self, "_table", table)

    @property
    def ir(self) -> IExpr:
        return self._ir

    # ------------------------------------------------------------ operators
    def _bin(self, op, other, swap=False):
        l, r = _ir(self), _ir(other)
        if swap:
            l, r = r, l
        return Expr(IBin(op, l, r), self._builder)

    def __add__(self, o):      return self._bin("+", o)
    def __radd__(self, o):     return self._bin("+", o, swap=True)
    def __sub__(self, o):      return self._bin("-", o)
    def __rsub__(self, o):     return self._bin("-", o, swap=True)
    def __mul__(self, o):      return self._bin("*", o)
    def __rmul__(self, o):     return self._bin("*", o, swap=True)
    def __truediv__(self, o):  return self._bin("/", o)
    def __rtruediv__(self, o): return self._bin("/", o, swap=True)
    def __eq__(self, o):       return self._bin("==", o)   # type: ignore[override]
    def __ne__(self, o):       return self._bin("!=", o)   # type: ignore[override]
    def __lt__(self, o):       return self._bin("<", o)
    def __le__(self, o):       return self._bin("<=", o)
    def __gt__(self, o):       return self._bin(">", o)
    def __ge__(self, o):       return self._bin(">=", o)

    def and_(self, o):         return self._bin("and", o)
    def or_(self, o):          return self._bin("or", o)
    def min_(self, o):         return self._bin("min", o)
    def max_(self, o):         return self._bin("max", o)

    __hash__ = None  # traced handles are not container keys

    def __bool__(self):
        raise TypeError(
            "a traced Expr has no truth value — use it inside "
            "ProgramBuilder.when(...) instead of a Python `if`")

    # ----------------------------------------------------------- navigation
    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        b, table = self._builder, self._table
        if b is not None and table is not None:
            rel = b._relationships.get((table, name))
            if rel is not None:
                fk, target, target_key = rel
                return Expr(INav(self._ir, fk, target, target_key), b,
                            table=target)
        return Expr(IField(self._ir, name), b)

    def nav(self, fk_field: str, target: str, target_key: str) -> "Expr":
        """Explicit ORM relationship navigation (the N+1 point query)."""
        return Expr(INav(self._ir, fk_field, target, target_key),
                    self._builder, table=target)

    def __getitem__(self, key) -> "Expr":
        """Subscript read ``coll[key]`` / ``m[key]`` on a traced value."""
        return Expr(IIndex(self._ir, _ir(key)), self._builder)

    def len(self) -> "Expr":
        return Expr(ILen(self._ir), self._builder)

    def __repr__(self):
        return f"Expr[{self._ir!r}]"


class VarHandle(Expr):
    """A named program variable (the result of ``let`` or a loop cursor)."""

    __slots__ = ("name",)

    def __init__(self, name: str, builder: "ProgramBuilder",
                 table: Optional[str] = None):
        super().__init__(IVar(name), builder, table)
        object.__setattr__(self, "name", name)

    def __repr__(self):
        return f"VarHandle[{self.name}]"


def _var_name(v: Union[str, VarHandle]) -> str:
    return v.name if isinstance(v, VarHandle) else v


# --------------------------------------------------------------------------
# The builder
# --------------------------------------------------------------------------

class ProgramBuilder:
    """Records statements into region scopes; ``build()`` emits a Program."""

    def __init__(self, name: str):
        self.name = name
        self._scopes: List[List[Region]] = [[]]
        self._relationships: Dict[Tuple[str, str], Tuple[str, str, str]] = {}
        self._inputs: List[Tuple[str, object]] = []
        self._fresh = itertools.count()

    # ------------------------------------------------------------- plumbing
    def _emit(self, region: Region) -> Region:
        self._scopes[-1].append(region)
        return region

    def _stmt(self, stmt: Stmt) -> Region:
        return self._emit(BasicBlock(stmt))

    def _close_scope(self, parts: List[Region]) -> Region:
        if not parts:
            return BasicBlock(NoOp("empty-scope"))
        if len(parts) == 1:
            return parts[0]
        return SeqRegion(tuple(parts))

    def _fresh_var(self, prefix: str = "v") -> str:
        return f"_{prefix}{next(self._fresh)}"

    # ---------------------------------------------------------- registration
    def relate(self, table: str, fk_field: str, target: str, target_key: str,
               name: Optional[str] = None) -> None:
        """Register a FK relationship so ``row.<name>`` traces to ORM
        navigation (``INav``), like a Hibernate ``@ManyToOne`` attribute."""
        self._relationships[(table, name or target)] = (fk_field, target,
                                                        target_key)

    def input(self, name: str, default: object = ()) -> VarHandle:
        """Declare a program input (bound per-execution via ``run(**params)``)."""
        self._inputs.append((name, default))
        return VarHandle(name, self)

    # ---------------------------------------------------------- expressions
    def const(self, value) -> Expr:
        return Expr(IConst(value), self)

    def var(self, name: str) -> VarHandle:
        return VarHandle(name, self)

    def empty_list(self) -> Expr:
        return Expr(IEmptyList(), self)

    def empty_map(self) -> Expr:
        return Expr(IEmptyMap(), self)

    def call(self, func: str, *args) -> Expr:
        return Expr(ICall(func, tuple(_ir(a) for a in args)), self)

    def load_all(self, table: str) -> Expr:
        """ORM ``loadAll(Entity.class)`` — full-table fetch."""
        return Expr(ILoadAll(table), self, table=table)

    def query(self, source: Union[str, Query, Q]) -> Expr:
        """``executeQuery(q)`` as an expression (a ``Table`` value)."""
        h = q(source)
        tbl = h.query.table if isinstance(h.query, Scan) else None
        return Expr(IQuery(h.query, h.bindings), self, table=tbl)

    def scalar_query(self, source: Union[str, Query, Q], column: str) -> Expr:
        h = q(source)
        return Expr(IScalarQuery(h.query, column, h.bindings), self)

    def query_values(self, source: Union[str, Query, Q], column: str) -> Expr:
        h = q(source)
        return Expr(IQueryValues(h.query, column), self)

    def cache_lookup(self, table: str, column: str, key,
                     all_matches: bool = False) -> Expr:
        """``Utils.lookupCache`` over a prefetched column-keyed cache."""
        return Expr(ICacheLookup(table, column, _ir(key), all_matches), self,
                    table=table)

    # ----------------------------------------------------------- statements
    def let(self, name: str, expr) -> VarHandle:
        """``name = expr`` — also the (re)assignment form."""
        self._stmt(Assign(name, _ir(expr)))
        table = expr._table if isinstance(expr, Expr) else None
        return VarHandle(name, self, table=table)

    def assign(self, target: Union[str, VarHandle], expr) -> VarHandle:
        return self.let(_var_name(target), expr)

    def add(self, target: Union[str, VarHandle], expr) -> None:
        """``target.add(expr)`` — collection append."""
        self._stmt(CollectionAdd(_var_name(target), _ir(expr)))

    def put(self, target: Union[str, VarHandle], key, value) -> None:
        """``target.put(key, value)`` — map insert."""
        self._stmt(MapPut(_var_name(target), _ir(key), _ir(value)))

    def prefetch(self, source: Union[str, Query, Q], by: str,
                 cache_name: Optional[str] = None) -> None:
        """``prefetch(R, A)``: fetch + cache keyed by column ``by``."""
        self._stmt(Prefetch(q(source).query, by, cache_name))

    def cache_by_column(self, var: Union[str, VarHandle], column: str) -> None:
        self._stmt(CacheByColumn(_var_name(var), column))

    def update_row(self, table: str, set_col: str, value, key_col: str,
                   key) -> None:
        """``UPDATE table SET set_col = value WHERE key_col = key``."""
        self._stmt(UpdateRow(table, set_col, _ir(value), key_col, _ir(key)))

    def noop(self, note: str = "") -> None:
        self._stmt(NoOp(note))

    # --------------------------------------------------------- control flow
    @contextlib.contextmanager
    def loop(self, source, var: Optional[str] = None, label: str = ""):
        """Cursor loop ``for (var : source)``; yields the cursor handle.

        ``source`` may be a ``Q``/``Query``/table name (executed as a query),
        an expression from :meth:`load_all`, or any traced collection
        expression (e.g. a worklist input variable)."""
        if isinstance(source, (str, Query, Q)) and not isinstance(source, Expr):
            src_expr = self.load_all(source) if isinstance(source, str) \
                else self.query(source)
        else:
            src_expr = source
        src_ir = _ir(src_expr)
        table = src_expr._table if isinstance(src_expr, Expr) else None
        name = var or self._fresh_var()
        cursor = VarHandle(name, self, table=table)
        self._scopes.append([])
        try:
            yield cursor
        finally:
            body = self._close_scope(self._scopes.pop())
            self._emit(LoopRegion(name, src_ir, body, label))

    @contextlib.contextmanager
    def while_(self, pred, label: str = ""):
        """Guarded loop ``while pred { ... }`` (a :class:`WhileRegion`)."""
        self._scopes.append([])
        try:
            yield
        finally:
            body = self._close_scope(self._scopes.pop())
            self._emit(WhileRegion(_ir(pred), body, label))

    def brk(self) -> None:
        """``break`` — exit the nearest enclosing loop."""
        self._stmt(BreakStmt())

    def cont(self) -> None:
        """``continue`` — skip to the next iteration of the nearest loop."""
        self._stmt(ContinueStmt())

    def ret(self) -> None:
        """Early ``return`` — exit the program; outputs keep their current
        values (assign them before calling this)."""
        self._stmt(ReturnStmt())

    @contextlib.contextmanager
    def when(self, pred):
        """Conditional region ``if pred { ... }``; chain :meth:`otherwise`."""
        self._scopes.append([])
        try:
            yield
        finally:
            then_r = self._close_scope(self._scopes.pop())
            self._emit(CondRegion(_ir(pred), then_r))

    @contextlib.contextmanager
    def otherwise(self):
        """Else-branch for the immediately preceding :meth:`when` block."""
        prev = self._scopes[-1][-1] if self._scopes[-1] else None
        if not isinstance(prev, CondRegion) or prev.else_r is not None:
            raise RuntimeError("otherwise() must directly follow a when() block")
        self._scopes.append([])
        try:
            yield
        finally:
            else_r = self._close_scope(self._scopes.pop())
            self._scopes[-1][-1] = CondRegion(prev.pred, prev.then_r, else_r,
                                              prev.label)

    # ---------------------------------------------------------------- build
    def build(self, outputs: Sequence[Union[str, VarHandle]] = (),
              inputs: Optional[Sequence[Tuple[str, object]]] = None) -> Program:
        if len(self._scopes) != 1:
            raise RuntimeError("unclosed loop()/when() scope at build()")
        body = SeqRegion(tuple(self._scopes[0]))  # top level is always a seq
        ins = tuple(inputs) if inputs is not None else tuple(self._inputs)
        return Program(self.name, body, tuple(_var_name(o) for o in outputs),
                       ins)
