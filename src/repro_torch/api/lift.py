"""AST lifting: compile a **plain Python function** to Region IR.

This is Cobra's real-application frontend. Where :mod:`repro_torch.api.builder`
asks for builder calls (``b.loop(...)``, ``b.let(...)``), the lifter takes
ordinary imperative code — the form application logic actually arrives in —
and lowers its AST onto the builder, which stays the single emission path
for Region IR::

    from repro_torch.api import load_all

    @session.trace(relations=[("orders", "o_customer_sk",
                               "customer", "c_customer_sk", "customer")])
    def P0():
        result = []
        for o in load_all("orders"):
            cust = o.customer                      # ORM navigation (N+1)
            val = myFunc(o.o_id, cust.c_birth_year)
            result.append(val)
        return result

Supported constructs (all lower to the same IR the builder emits by hand):

  * ``for x in <source>`` over query handles (``q(...)``), ``load_all``,
    or traced collection variables — :class:`~repro_torch.core.regions.LoopRegion`;
  * ``if``/``elif``/``else`` over traced predicates — ``CondRegion``;
  * ``while`` + ``break``/``continue`` — ``WhileRegion`` and the early-exit
    statements (paper Sec. V limitations, now first-class);
  * early ``return`` anywhere — ``ReturnStmt`` (outputs are the declared
    names; a return of expressions assigns them first);
  * list/dict accumulation (``xs = []; xs.append(v)``, ``m = {}; m[k] = v``)
    and subscript reads on traced values (``xs[0]``, ``m[key]`` —
    :class:`~repro_torch.core.regions.IIndex`), augmented assignment, scalar
    arithmetic/comparisons/boolean operators;
  * **list/set/dict comprehensions** over traced collections/queries
    (``[f(t.x) for t in load_all("tasks") if t.y > 0]``,
    ``{t.k: t.x for t in ...}``, ``{t.x for t in ...}``) — lowered to the
    same loop-accumulation IR an explicit loop emits (fresh accumulator +
    ``LoopRegion`` + guarded ``CollectionAdd``/``MapPut``; a set is the
    keyed map with the member as its own key); generator expressions and
    nested comprehensions stay ``LiftError``;
  * calls to :func:`~repro_torch.core.regions.register_function`-registered pure
    functions by name, plus ``len``/``min``/``max`` builtins;
  * **small pure helper functions inlined automatically** — an unregistered
    helper reached through the closure/globals whose body is simple
    ``name = expr`` assignments plus a single trailing ``return expr`` (no
    loops, branches, queries, or markers) is inlined by expression
    substitution, producing IR byte-identical to inlining it by hand; a
    helper outside that subset raises :class:`LiftError` naming the
    violated constraint and its location;
  * ORM attribute navigation (``row.customer``) via the ``relations``
    mapping — the Hibernate-style entity relationships that in a real ORM
    live outside the code.

**Partial evaluation.** Names that do not refer to program state resolve at
trace time from the function's closure/globals: query construction
(``q("tasks").where(col(...).eq(param(...))).bind(rid=x.r_id)``) executes
immediately and only its *result* (a query handle with symbolic parameter
bindings) enters the IR, exactly as it would in builder-style code.

Anything outside this vocabulary raises :class:`LiftError` pointing at the
offending source line, with the builder as the documented escape hatch.
"""

from __future__ import annotations

import ast
import builtins
import inspect
import operator
import textwrap
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.regions import _FUNCTIONS, Program
from ..relational.algebra import Query
from .builder import Expr, ProgramBuilder, Q
from .builder import q as _q

__all__ = [
    "LiftError", "lift_program", "lift_source",
    # tracing markers (recognized by identity inside lifted functions)
    "load_all", "cache_lookup", "scalar_query", "query_values",
    "prefetch", "update_row", "cache_by_column", "noop",
]


class LiftError(Exception):
    """A construct the lifter cannot lower, with source location context.

    The message names the unsupported construct and where it is; the
    builder API (``repro_torch.api.ProgramBuilder``) remains the escape hatch
    for programs outside the liftable vocabulary."""


# --------------------------------------------------------------------------
# Tracing markers
# --------------------------------------------------------------------------
# These exist to be *recognized by identity* when a lifted function calls
# them; they are never executed. Each mirrors a ProgramBuilder method.

def _marker(fn):
    def stub(*args, **kwargs):
        raise LiftError(
            f"{fn.__name__}() is a tracing marker — it only has meaning "
            f"inside a function being lifted by session.trace / lift_program")
    stub.__name__ = fn.__name__
    stub.__doc__ = fn.__doc__
    return stub


@_marker
def load_all(table):
    """ORM ``loadAll(Entity.class)`` — full-table fetch (expression)."""


@_marker
def cache_lookup(table, column, key, all_matches=False):
    """``Utils.lookupCache`` over a prefetched column-keyed cache."""


@_marker
def scalar_query(source, column):
    """Execute a query, return one scalar (first row of ``column``)."""


@_marker
def query_values(source, column):
    """Execute a query, return ``column`` as a list value."""


@_marker
def prefetch(source, by, cache_name=None):
    """``prefetch(R, A)`` — fetch + cache keyed by column (statement)."""


@_marker
def update_row(table, set_col, value, key_col, key):
    """``UPDATE table SET set_col = value WHERE key_col = key``."""


@_marker
def cache_by_column(var, column):
    """``Utils.cacheByColumn`` on an already-fetched query result."""


@_marker
def noop(note=""):
    """An explicit no-op statement."""


_EXPR_MARKERS = {"load_all", "cache_lookup", "scalar_query", "query_values"}
_STMT_MARKERS = {"prefetch", "update_row", "cache_by_column", "noop"}
_MARKERS = {name: globals()[name] for name in _EXPR_MARKERS | _STMT_MARKERS}


# --------------------------------------------------------------------------
# Operator tables
# --------------------------------------------------------------------------

_BINOPS = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/"}
_STATIC_BINOPS = {ast.Add: operator.add, ast.Sub: operator.sub,
                  ast.Mult: operator.mul, ast.Div: operator.truediv,
                  ast.Mod: operator.mod, ast.Pow: operator.pow,
                  ast.FloorDiv: operator.floordiv}
_CMPOPS = {ast.Eq: "==", ast.NotEq: "!=", ast.Lt: "<", ast.LtE: "<=",
           ast.Gt: ">", ast.GtE: ">="}
_PY_OPS = {"+": operator.add, "-": operator.sub, "*": operator.mul,
           "/": operator.truediv,
           "==": operator.eq, "!=": operator.ne, "<": operator.lt,
           "<=": operator.le, ">": operator.gt, ">=": operator.ge,
           "and": lambda a, b: a and b, "or": lambda a, b: a or b,
           "min": min, "max": max}


class _Static:
    """A trace-time (partially-evaluated) binding in the local scope."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


_SCALARS = (bool, int, float, str)

# sentinel: the call is not even an inlining candidate (fall through to the
# generic cannot-call error rather than an inliner-specific one)
_NOT_INLINED = object()


# --------------------------------------------------------------------------
# The lifter
# --------------------------------------------------------------------------

class _Lifter:
    def __init__(self, fnode: ast.FunctionDef, env: Dict[str, object], *,
                 name: str, relations: Sequence[Tuple],
                 inputs: Sequence[Tuple[str, object]],
                 filename: str = "<lifted>", line_offset: int = 0):
        self.fnode = fnode
        self.env = env
        self.filename = filename
        self.line_offset = line_offset
        self.b = ProgramBuilder(name)
        for rel in relations:
            self.b.relate(*rel)
        self.scope: Dict[str, object] = {}
        for pname, default in inputs:
            self.scope[pname] = self.b.input(pname, default)
        self.out_names: Tuple[str, ...] = self._scan_outputs(fnode)
        self._comp_depth = 0           # comprehensions never nest
        self._in_while_test = False    # comprehensions can't lower there
        self._inline_depth = 0         # helper-inlining recursion guard

    # ------------------------------------------------------------ diagnostics
    def _err(self, node, msg: str) -> LiftError:
        line = self.line_offset + getattr(node, "lineno", 0)
        return LiftError(
            f"cannot lift {self.fnode.name}(): {msg} "
            f"[{self.filename}:{line}] — use repro_torch.api.ProgramBuilder for "
            f"constructs outside the lifted subset")

    def _need_static(self, value, node, what: str):
        if isinstance(value, Expr):
            raise self._err(node, f"{what} must be a trace-time value, not a "
                                  f"traced expression")
        return value

    # ---------------------------------------------------------------- outputs
    def _scan_outputs(self, fnode: ast.FunctionDef) -> Tuple[str, ...]:
        """Canonical output names: from the LAST value-carrying ``return``.

        Elements that are plain names keep them; expressions get positional
        ``_ret{i}`` names. Every other return site must match the arity (a
        bare early ``return`` is always allowed: outputs keep their current
        values)."""
        rets: List[ast.Return] = []

        def walk(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue  # rejected later with a targeted error
                if isinstance(child, ast.Return):
                    rets.append(child)
                walk(child)

        walk(fnode)
        valued = [r for r in rets if r.value is not None]
        if not valued:
            return ()
        v = valued[-1].value
        elems = list(v.elts) if isinstance(v, ast.Tuple) else [v]
        return tuple(e.id if isinstance(e, ast.Name) else f"_ret{i}"
                     for i, e in enumerate(elems))

    def _lower_return(self, node: ast.Return, is_final: bool) -> None:
        if node.value is not None:
            v = node.value
            elems = list(v.elts) if isinstance(v, ast.Tuple) else [v]
            if len(elems) != len(self.out_names):
                raise self._err(
                    node, f"return arity mismatch: this site returns "
                          f"{len(elems)} value(s), the program declares "
                          f"outputs {list(self.out_names)}")
            for canonical, e in zip(self.out_names, elems):
                if isinstance(e, ast.Name) and e.id == canonical:
                    v = self.scope.get(canonical)
                    if v is None:
                        raise self._err(e, f"returned name {canonical!r} was "
                                           f"never assigned")
                    if not isinstance(v, Expr):
                        raise self._err(
                            e, f"returned name {canonical!r} is a trace-time "
                               f"{type(v.value).__name__}, not traced program "
                               f"state — iterate it in a loop and accumulate "
                               f"the rows instead")
                    continue
                val = self._expr(e)
                if not isinstance(val, (Expr,) + _SCALARS):
                    raise self._err(e, "can only return traced expressions, "
                                       "scalars, or assigned variables")
                self.scope[canonical] = self.b.let(canonical, val)
        if not is_final:
            self.b.ret()

    # ------------------------------------------------------------------ build
    def lift(self) -> Program:
        body = self.fnode.body
        for i, stmt in enumerate(body):
            self._stmt(stmt, is_final=(i == len(body) - 1))
        return self.b.build(outputs=self.out_names)

    # ------------------------------------------------------------- statements
    def _stmt(self, node: ast.stmt, is_final: bool = False) -> None:
        if isinstance(node, ast.Expr):
            if isinstance(node.value, ast.Constant) and isinstance(
                    node.value.value, str):
                return  # docstring
            if isinstance(node.value, ast.Call):
                self._call_stmt(node.value)
                return
            raise self._err(node, "expression statement has no effect")
        if isinstance(node, ast.Assign):
            self._assign(node)
            return
        if isinstance(node, ast.AugAssign):
            self._aug_assign(node)
            return
        if isinstance(node, ast.For):
            self._for(node)
            return
        if isinstance(node, ast.If):
            self._if(node)
            return
        if isinstance(node, ast.While):
            self._while(node)
            return
        if isinstance(node, ast.Break):
            self.b.brk()
            return
        if isinstance(node, ast.Continue):
            self.b.cont()
            return
        if isinstance(node, ast.Return):
            self._lower_return(node, is_final)
            return
        if isinstance(node, ast.Pass):
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            raise self._err(node, "nested function definitions are not "
                                  "liftable — register it as a pure function "
                                  "(register_function) or inline it")
        raise self._err(node, f"unsupported statement "
                              f"{type(node).__name__!r}")

    def _assign(self, node: ast.Assign) -> None:
        if len(node.targets) != 1:
            raise self._err(node, "chained assignment (a = b = ...)")
        target = node.targets[0]
        if isinstance(target, ast.Name):
            self._bind(target.id, self._expr(node.value), node)
            return
        if isinstance(target, ast.Subscript):
            base = target.value
            if not (isinstance(base, ast.Name)
                    and isinstance(self.scope.get(base.id), Expr)):
                raise self._err(node, "subscript assignment requires a traced "
                                      "map variable (m = {}; m[k] = v)")
            key = self._expr(target.slice)
            val = self._expr(node.value)
            self.b.put(base.id, key, val)
            return
        raise self._err(node, f"unsupported assignment target "
                              f"{type(target).__name__!r}")

    def _bind(self, name: str, value, node) -> None:
        """Name binding: program state becomes a ``let``; everything else
        (query handles, helpers) stays a trace-time binding."""
        if isinstance(value, (Expr,) + _SCALARS):
            self.scope[name] = self.b.let(name, value)
        else:
            self.scope[name] = _Static(value)

    def _aug_assign(self, node: ast.AugAssign) -> None:
        if not isinstance(node.target, ast.Name):
            raise self._err(node, "augmented assignment target must be a "
                                  "plain variable")
        name = node.target.id
        cur = self.scope.get(name)
        if not isinstance(cur, Expr):
            raise self._err(node, f"{name!r} is not a traced program "
                                  f"variable (assign it first)")
        opname = _BINOPS.get(type(node.op))
        if opname is None:
            raise self._err(node, f"unsupported augmented operator "
                                  f"{type(node.op).__name__!r}")
        self.scope[name] = self.b.let(name, cur._bin(opname,
                                                     self._expr(node.value)))

    def _for(self, node: ast.For) -> None:
        if node.orelse:
            raise self._err(node, "for/else")
        if not isinstance(node.target, ast.Name):
            raise self._err(node, "loop target must be a single variable")
        src = self._expr(node.iter)
        if not isinstance(src, (Expr, Q, Query, str)):
            raise self._err(node.iter,
                            f"cannot iterate a trace-time "
                            f"{type(src).__name__} — loop sources are query "
                            f"handles (q(...)), load_all(...), or traced "
                            f"collection variables")
        var = node.target.id
        with self.b.loop(src, var=var) as cursor:
            self.scope[var] = cursor
            for s in node.body:
                self._stmt(s)

    def _if(self, node: ast.If) -> None:
        pred = self._expr(node.test)
        if not isinstance(pred, Expr):
            raise self._err(node.test,
                            "condition is a trace-time constant — lifted "
                            "branches must test traced program state")
        with self.b.when(pred):
            for s in node.body:
                self._stmt(s)
        if node.orelse:
            with self.b.otherwise():
                for s in node.orelse:
                    self._stmt(s)

    def _while(self, node: ast.While) -> None:
        if node.orelse:
            raise self._err(node, "while/else")
        # the guard is lowered OUTSIDE the WhileRegion and re-evaluated by
        # the interpreter each iteration — that only works for pure
        # expressions. A comprehension would emit its accumulation loop
        # here, frozen at entry, silently diverging from Python's
        # re-evaluate-every-iteration semantics — reject it.
        self._in_while_test = True
        try:
            pred = self._expr(node.test)
        finally:
            self._in_while_test = False
        if not isinstance(pred, (Expr, bool, int)):
            raise self._err(node.test, "while guard must be a traced "
                                       "expression (or the literal True)")
        with self.b.while_(pred):
            for s in node.body:
                self._stmt(s)

    def _call_stmt(self, call: ast.Call) -> None:
        func = call.func
        # collection/map mutation methods on traced variables
        if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
            holder = self.scope.get(func.value.id)
            if isinstance(holder, Expr):
                args = [self._expr(a) for a in call.args]
                if func.attr in ("append", "add") and len(args) == 1:
                    self.b.add(func.value.id, args[0])
                    return
                if func.attr == "put" and len(args) == 2:
                    self.b.put(func.value.id, args[0], args[1])
                    return
                raise self._err(call, f"unsupported method .{func.attr}() on "
                                      f"traced variable {func.value.id!r}")
        f = self._maybe_static(func)
        marker = self._marker_name(f)
        if marker in _STMT_MARKERS:
            args, kwargs = self._call_args(call)
            try:
                getattr(self.b, marker)(*args, **kwargs)
            except TypeError as e:
                raise self._err(call, f"{marker}(): {e}")
            return
        value = self._expr(call)
        if isinstance(value, Expr):
            raise self._err(call, "traced expression used as a statement has "
                                  "no effect — assign it to a variable")
        # trace-time call already executed for its (trace-time) effect

    # ------------------------------------------------------------ expressions
    def _expr(self, node: ast.expr):
        """Lower to a traced :class:`Expr` or a trace-time Python value."""
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            return self._name(node)
        if isinstance(node, ast.Attribute):
            base = self._expr(node.value)
            if isinstance(base, Expr):
                if node.attr.startswith("_"):
                    raise self._err(node, f"traced attribute {node.attr!r}")
                return getattr(base, node.attr)  # IField / INav
            try:
                return getattr(base, node.attr)
            except AttributeError:
                raise self._err(node, f"trace-time object "
                                      f"{type(base).__name__} has no "
                                      f"attribute {node.attr!r}")
        if isinstance(node, ast.BinOp):
            l, r = self._expr(node.left), self._expr(node.right)
            opname = _BINOPS.get(type(node.op))
            if opname is not None:
                return self._apply_op(opname, l, r, node)
            static_op = _STATIC_BINOPS.get(type(node.op))
            if static_op is not None and not isinstance(l, Expr) \
                    and not isinstance(r, Expr):
                return static_op(l, r)
            raise self._err(node, f"unsupported operator "
                                  f"{type(node.op).__name__!r} on traced "
                                  f"values")
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise self._err(node, "chained comparison (a < b < c)")
            opname = _CMPOPS.get(type(node.ops[0]))
            if opname is None:
                raise self._err(node, f"unsupported comparison "
                                      f"{type(node.ops[0]).__name__!r}")
            return self._apply_op(opname, self._expr(node.left),
                                  self._expr(node.comparators[0]), node)
        if isinstance(node, ast.BoolOp):
            opname = "and" if isinstance(node.op, ast.And) else "or"
            vals = [self._expr(v) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                out = self._apply_op(opname, out, v, node)
            return out
        if isinstance(node, ast.UnaryOp):
            v = self._expr(node.operand)
            if isinstance(node.op, ast.USub) and not isinstance(v, Expr):
                return -v
            if isinstance(node.op, ast.Not) and not isinstance(v, Expr):
                return not v
            raise self._err(node, f"unsupported unary "
                                  f"{type(node.op).__name__!r} on a traced "
                                  f"value")
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.List):
            if not node.elts:
                return self.b.empty_list()
            vals = [self._expr(e) for e in node.elts]
            if any(isinstance(v, Expr) for v in vals):
                raise self._err(node, "list literals of traced values — "
                                      "initialize empty and .append()")
            return vals
        if isinstance(node, ast.Dict):
            if not node.keys:
                return self.b.empty_map()
            raise self._err(node, "non-empty dict literals — initialize "
                                  "empty and assign m[k] = v")
        if isinstance(node, ast.Tuple):
            vals = [self._expr(e) for e in node.elts]
            if any(isinstance(v, Expr) for v in vals):
                raise self._err(node, "tuples of traced values")
            return tuple(vals)
        if isinstance(node, ast.Subscript):
            if isinstance(node.slice, ast.Slice):
                raise self._err(node, "slice reads (a[i:j]) — index one "
                                      "element at a time")
            base = self._expr(node.value)
            key = self._expr(node.slice)
            # traced collection/map read -> IIndex (Expr.__getitem__);
            # trace-time base -> ordinary Python subscript
            if isinstance(base, Expr) and not isinstance(key,
                                                         (Expr,) + _SCALARS):
                raise self._err(node, f"subscript key must be a traced "
                                      f"expression or scalar, not a "
                                      f"trace-time {type(key).__name__}")
            return base[key]
        if isinstance(node, ast.ListComp):
            return self._comp(node, "list")
        if isinstance(node, ast.SetComp):
            return self._comp(node, "set")
        if isinstance(node, ast.DictComp):
            return self._comp(node, "dict")
        if isinstance(node, ast.GeneratorExp):
            raise self._err(node, "generator expressions — materialize with "
                                  "a list/set/dict comprehension or an "
                                  "explicit loop")
        if isinstance(node, ast.IfExp):
            raise self._err(node, "conditional expressions — write an "
                                  "explicit if statement")
        if isinstance(node, ast.Lambda):
            raise self._err(node, "lambda — register it as a pure function "
                                  "(register_function)")
        raise self._err(node, f"unsupported expression "
                              f"{type(node).__name__!r}")

    def _name(self, node: ast.Name):
        name = node.id
        if name in self.scope:
            v = self.scope[name]
            return v.value if isinstance(v, _Static) else v
        if name in self.env:
            return self.env[name]
        raise self._err(node, f"unknown name {name!r} (not a program "
                              f"variable, parameter, or closure/global)")

    def _apply_op(self, opname: str, l, r, node):
        if isinstance(l, Expr):
            return l._bin(opname, r)
        if isinstance(r, Expr):
            return r._bin(opname, l, swap=True)  # preserves operand order
        try:
            return _PY_OPS[opname](l, r)
        except Exception as e:
            raise self._err(node, f"trace-time {opname!r} failed: {e}")

    # -------------------------------------------------------- comprehensions
    def _comp(self, node, kind: str):
        """Lower ``[elt for v in src if cond ...]`` (and the ``{...}`` set
        and ``{k: v ...}`` dict forms) onto the loop-accumulation path an
        explicit loop takes: a fresh empty accumulator (``empty_list`` for
        lists, ``empty_map`` for sets and dicts), a ``LoopRegion`` over the
        source, one nested ``CondRegion`` per ``if`` clause, and the
        accumulation statement — ``CollectionAdd`` of the element for
        lists, ``MapPut`` of (key, value) for dicts, and ``MapPut`` of
        (element, element) for sets (a set IS the keyed map with the member
        as its own key, exactly what ``m[e] = e`` in an explicit loop
        emits). The value of the expression is the accumulator variable."""
        if self._in_while_test:
            raise self._err(node, "a comprehension in a while guard — its "
                                  "loop would run once at entry instead of "
                                  "every iteration; compute it inside the "
                                  "loop body into a variable")
        if self._comp_depth:
            raise self._err(node, "nested comprehensions — write explicit "
                                  "loops")
        if len(node.generators) != 1:
            raise self._err(node, "comprehensions with multiple `for` "
                                  "clauses — write explicit nested loops")
        gen = node.generators[0]
        if getattr(gen, "is_async", 0):
            raise self._err(node, "async comprehensions")
        if not isinstance(gen.target, ast.Name):
            raise self._err(node, "comprehension target must be a single "
                                  "variable")
        src = self._expr(gen.iter)
        if not isinstance(src, (Expr, Q, Query, str)):
            raise self._err(
                gen.iter, f"cannot iterate a trace-time "
                          f"{type(src).__name__} — comprehension sources "
                          f"are query handles (q(...)), load_all(...), or "
                          f"traced collection variables")
        var = gen.target.id
        acc_name = self.b._fresh_var("comp")
        init = self.b.empty_list() if kind == "list" else self.b.empty_map()
        acc = self.b.let(acc_name, init)
        _missing = object()
        saved = self.scope.get(var, _missing)

        def lowered(part: ast.expr, what: str):
            val = self._expr(part)
            if not isinstance(val, (Expr,) + _SCALARS):
                raise self._err(
                    part, f"comprehension {what} must be a traced "
                          f"expression or scalar, not a trace-time "
                          f"{type(val).__name__}")
            return val

        self._comp_depth += 1
        try:
            with self.b.loop(src, var=var) as cursor:
                self.scope[var] = cursor

                def emit(i: int) -> None:
                    if i == len(gen.ifs):
                        if kind == "dict":
                            k = lowered(node.key, "key")
                            self.b.put(acc_name, k,
                                       lowered(node.value, "value"))
                        elif kind == "set":
                            e = lowered(node.elt, "element")
                            self.b.put(acc_name, e, e)
                        else:
                            self.b.add(acc_name, lowered(node.elt, "element"))
                        return
                    pred = self._expr(gen.ifs[i])
                    if not isinstance(pred, Expr):
                        raise self._err(
                            gen.ifs[i], "comprehension condition is a "
                                        "trace-time constant — it must test "
                                        "traced program state")
                    with self.b.when(pred):
                        emit(i + 1)

                emit(0)
        finally:
            self._comp_depth -= 1
            if saved is _missing:
                self.scope.pop(var, None)
            else:
                self.scope[var] = saved
        return acc

    # ------------------------------------------------------------------ calls
    def _maybe_static(self, node: ast.expr):
        """Resolve an expression to a trace-time value if possible, else
        None (no IR is emitted either way)."""
        try:
            if isinstance(node, ast.Name):
                v = self.scope.get(node.id)
                if isinstance(v, _Static):
                    return v.value
                if v is not None:
                    return None  # traced
                return self.env.get(node.id)
            if isinstance(node, ast.Attribute):
                base = self._maybe_static(node.value)
                if base is None or isinstance(base, Expr):
                    return None
                return getattr(base, node.attr, None)
        except Exception:
            return None
        return None

    def _marker_name(self, f) -> Optional[str]:
        for mname, mf in _MARKERS.items():
            if f is mf:
                return mname
        return None

    def _call_args(self, call: ast.Call):
        args = [self._expr(a) for a in call.args]
        kwargs = {}
        for kw in call.keywords:
            if kw.arg is None:
                raise self._err(call, "**kwargs expansion in calls")
            kwargs[kw.arg] = self._expr(kw.value)
        return args, kwargs

    def _call(self, node: ast.Call):
        func = node.func
        # registered pure functions called by name trace to ICall — when the
        # name is unbound or bound to the registered callable itself, so
        # lifted functions stay runnable as ordinary Python too. A DIFFERENT
        # callable shadowing a registered name is the user's and falls
        # through to normal handling (a traced-arg call on it then errors
        # loudly instead of silently running the registry entry).
        if isinstance(func, ast.Name) and func.id not in self.scope \
                and func.id in _FUNCTIONS:
            bound = self.env.get(func.id)
            if bound is None or bound is _FUNCTIONS[func.id]:
                args, kwargs = self._call_args(node)
                if kwargs:
                    raise self._err(node, f"registered function {func.id!r} "
                                          f"takes positional arguments only")
                return self.b.call(func.id, *args)
        f = self._expr(func)
        if isinstance(f, Expr):
            raise self._err(node, "calling a traced value")
        for rname, rfn in _FUNCTIONS.items():
            if f is rfn:  # registered callable reached through a binding
                args, kwargs = self._call_args(node)
                if kwargs:
                    raise self._err(node, f"registered function {rname!r} "
                                          f"takes positional arguments only")
                return self.b.call(rname, *args)
        marker = self._marker_name(f)
        args, kwargs = self._call_args(node)
        if marker in _EXPR_MARKERS:
            try:
                return getattr(self.b, marker)(*args, **kwargs)
            except TypeError as e:
                raise self._err(node, f"{marker}(): {e}")
        if marker in _STMT_MARKERS:
            raise self._err(node, f"{marker}() is a statement, not an "
                                  f"expression")
        if f is builtins.len:
            (a,) = args
            return a.len() if isinstance(a, Expr) else len(a)
        if f in (builtins.min, builtins.max):
            if any(isinstance(a, Expr) for a in args):
                if len(args) != 2:
                    raise self._err(node, f"traced {f.__name__}() takes "
                                          f"exactly two arguments")
                return self._apply_op(f.__name__, args[0], args[1], node)
            return f(*args, **kwargs)
        traced = (any(isinstance(a, Expr) for a in args)
                  or any(isinstance(v, Expr) for v in kwargs.values()))
        if not traced:
            try:
                return f(*args, **kwargs)
            except LiftError:
                raise
            except Exception as e:
                raise self._err(node, f"trace-time call failed: {e!r}")
        # traced arguments on a trace-time callable: only the relational
        # query surface accepts them (Q.bind embeds traced parameter exprs)
        if f is _q or isinstance(getattr(f, "__self__", None), Q):
            try:
                return f(*args, **kwargs)
            except Exception as e:
                raise self._err(node, f"query construction failed: {e!r}")
        inlined = self._inline_call(node, f, args, kwargs)
        if inlined is not _NOT_INLINED:
            return inlined
        fname = getattr(f, "__name__", repr(f))
        raise self._err(node, f"cannot call {fname!r} on traced values — "
                              f"register_function({fname!r}, fn) makes it "
                              f"traceable as a pure function, or a small "
                              f"single-return helper is inlined automatically")

    # ---------------------------------------------------------- helper inlining
    _INLINE_MAX_DEPTH = 8

    def _inline_call(self, node: ast.Call, f, args, kwargs):
        """Inline a small pure helper called with traced arguments.

        The inlined subset is exactly what manual inlining by expression
        substitution supports: a body of simple ``name = expr`` assignments
        followed by a single ``return expr``, no loops/branches/queries and
        no query markers. Parameters and intermediate names bind in a
        TEMPORARY scope without emitting ``let`` statements, so the IR is
        byte-identical to the user substituting the helper's expression by
        hand (a temp used twice duplicates its expression, exactly as
        manual substitution would).

        Returns ``_NOT_INLINED`` when ``f`` is not even a candidate (not a
        plain source-available Python function) — the caller falls through
        to its generic error. A candidate that VIOLATES the inlinable
        subset raises a located :class:`LiftError` naming the constraint."""
        if not inspect.isfunction(f):
            return _NOT_INLINED
        shadowed = _FUNCTIONS.get(f.__name__)
        if shadowed is not None and f is not shadowed:
            # a local helper sharing a registered function's name is
            # ambiguous — NEVER resolve it silently, in either direction
            raise self._err(
                node, f"local callable {f.__name__!r} shadows the registered "
                      f"function of the same name — rename the helper, or "
                      f"register_function({f.__name__!r}, fn) to replace the "
                      f"registry entry")
        try:
            lines, lnum = inspect.getsourcelines(f)
            fnode, _ = _function_node("".join(lines))
        except (OSError, TypeError, SyntaxError, LiftError):
            return _NOT_INLINED
        fname = f.__name__

        def inline_err(msg: str) -> LiftError:
            return self._err(node, f"cannot inline helper {fname}(): {msg}")

        if self._inline_depth >= self._INLINE_MAX_DEPTH:
            raise inline_err(f"inlining recursion deeper than "
                             f"{self._INLINE_MAX_DEPTH} (is it recursive?)")
        try:
            bound = inspect.signature(f).bind(*args, **kwargs)
            bound.apply_defaults()
        except TypeError as e:
            raise inline_err(f"argument mismatch: {e}")
        # body shape: optional docstring, simple assigns, one trailing return
        body = list(fnode.body)
        if body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            body = body[1:]
        if not body or not isinstance(body[-1], ast.Return) \
                or body[-1].value is None:
            raise inline_err("body must end in a single `return <expr>`")
        assigns: List[ast.Assign] = []
        for stmt in body[:-1]:
            if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                raise inline_err(
                    f"only `name = expr` assignments and a trailing return "
                    f"are inlinable, found {type(stmt).__name__!r} at line "
                    f"{lnum - 1 + getattr(stmt, 'lineno', 0)}")
            assigns.append(stmt)
        helper_env = _base_env(getattr(f, "__globals__", {}))
        if getattr(f, "__closure__", None):
            for cname, cell in zip(f.__code__.co_freevars, f.__closure__):
                try:
                    helper_env[cname] = cell.cell_contents
                except ValueError:
                    pass
        self._check_inlinable_exprs(
            [a.value for a in assigns] + [body[-1].value],
            helper_env, inline_err)
        # evaluate in the helper's own environment: a temp scope holding the
        # bound parameters (traced Exprs pass through; trace-time values stay
        # static) — crucially no b.let, so nothing is emitted for the binding
        scope: Dict[str, object] = {}
        for pname, v in bound.arguments.items():
            scope[pname] = v if isinstance(v, Expr) else _Static(v)
        saved = (self.scope, self.env, self.filename, self.line_offset)
        self.scope, self.env = scope, helper_env
        self.filename = f.__code__.co_filename
        self.line_offset = lnum - 1
        self._inline_depth += 1
        try:
            for stmt in assigns:
                v = self._expr(stmt.value)
                scope[stmt.targets[0].id] = \
                    v if isinstance(v, Expr) else _Static(v)
            return self._expr(body[-1].value)
        finally:
            self._inline_depth -= 1
            self.scope, self.env, self.filename, self.line_offset = saved

    def _check_inlinable_exprs(self, exprs: Sequence[ast.expr], helper_env,
                               inline_err) -> None:
        """Reject constructs manual expression substitution could not
        produce: anything that emits IR statements (loops via
        comprehensions) or touches the database (query construction,
        tracing markers) from inside the helper."""
        forbidden = (ast.ListComp, ast.SetComp, ast.DictComp,
                     ast.GeneratorExp, ast.Lambda, ast.IfExp, ast.Await,
                     ast.Yield, ast.YieldFrom, ast.NamedExpr)
        for e in exprs:
            for sub in ast.walk(e):
                if isinstance(sub, forbidden):
                    raise inline_err(
                        f"{type(sub).__name__!r} in the body — inlined "
                        f"helpers are straight-line scalar expressions")
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Name):
                    target = helper_env.get(sub.func.id)
                    if target is _q or self._marker_name(target) is not None:
                        raise inline_err(
                            f"{sub.func.id}() in the body — inlined helpers "
                            f"must not construct queries or use tracing "
                            f"markers; call the query at the call site and "
                            f"pass the value in")


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def _function_node(source: str) -> Tuple[ast.FunctionDef, str]:
    tree = ast.parse(textwrap.dedent(source))
    for stmt in tree.body:
        if isinstance(stmt, ast.FunctionDef):
            return stmt, source
    raise LiftError("no function definition found in source")


def _base_env(extra: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    env: Dict[str, object] = dict(vars(builtins))
    if extra:
        env.update(extra)
    return env


def lift_program(fn, *, name: Optional[str] = None,
                 relations: Sequence[Tuple] = ()) -> Program:
    """Lift a plain Python function to a :class:`~repro_torch.core.regions.Program`.

    Parameters become declared program inputs (their Python defaults are the
    input defaults); the returned value(s) become the program outputs;
    ``relations`` registers ORM FK relationships as
    ``(table, fk_field, target, target_key[, attribute_name])`` tuples so
    ``row.<attribute>`` lowers to navigation (``INav``)."""
    try:
        lines, lnum = inspect.getsourcelines(fn)
    except (OSError, TypeError) as e:
        raise LiftError(f"cannot lift {getattr(fn, '__name__', fn)!r}: "
                        f"source is unavailable ({e}); pass source text to "
                        f"lift_source() instead")
    fnode, _ = _function_node("".join(lines))
    env = _base_env(getattr(fn, "__globals__", {}))
    if getattr(fn, "__closure__", None):
        for cname, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                env[cname] = cell.cell_contents
            except ValueError:
                pass  # unfilled cell
    inputs = []
    for pname, p in inspect.signature(fn).parameters.items():
        if p.kind not in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                          inspect.Parameter.KEYWORD_ONLY):
            raise LiftError(f"cannot lift {fn.__name__}(): *args/**kwargs "
                            f"parameters are not liftable program inputs")
        default = () if p.default is inspect.Parameter.empty else p.default
        inputs.append((pname, default))
    lifter = _Lifter(fnode, env, name=name or fn.__name__,
                     relations=relations, inputs=inputs,
                     filename=fn.__code__.co_filename, line_offset=lnum - 1)
    return lifter.lift()


def lift_source(source: str, *, env: Optional[Dict[str, object]] = None,
                name: Optional[str] = None,
                relations: Sequence[Tuple] = ()) -> Program:
    """Lift a function from *source text* (no live function object needed).

    ``env`` supplies the trace-time names the function body references
    (``q``, ``col``, ``param``, markers, constants). Parameter defaults must
    be literals. Used by tooling and the round-trip property tests."""
    fnode, _ = _function_node(source)
    args = fnode.args
    if args.vararg or args.kwarg:
        raise LiftError(f"cannot lift {fnode.name}(): *args/**kwargs")

    def literal(a, d):
        if d is None:
            return ()
        try:
            return ast.literal_eval(d)
        except ValueError:
            raise LiftError(f"cannot lift {fnode.name}(): parameter "
                            f"{a.arg!r} default must be a literal")

    positional = list(args.posonlyargs) + list(args.args)
    defaults = [None] * (len(positional) - len(args.defaults)) \
        + list(args.defaults)
    inputs = [(a.arg, literal(a, d)) for a, d in zip(positional, defaults)]
    inputs += [(a.arg, literal(a, d))
               for a, d in zip(args.kwonlyargs, args.kw_defaults)]
    lifter = _Lifter(fnode, _base_env(env), name=name or fnode.name,
                     relations=relations, inputs=inputs)
    return lifter.lift()
