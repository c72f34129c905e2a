"""Relational algebra over columnar torch tables.

Query trees are what Cobra's F-IR relational leaves (σ, π, ⋈, γ — Fig. 11)
denote. Every node can:

  * ``execute(db)``   — produce a concrete ``Table`` (vectorized torch compute
    on the table's device)
  * ``sql()``         — render as SQL text (for logs / EXPERIMENTS.md)
  * structural hash / equality — required by the Region DAG's duplicate
    detection (Volcano/Cascades memoization).

Scalar expressions (``Col``, ``Lit``, arithmetic, comparisons, boolean
combinators, ``Func``) evaluate column-vectorized over a table.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .table import Field, Schema, Table, host_to_device, np_dtype_name

__all__ = [
    "Scalar", "Col", "Lit", "Arith", "Cmp", "BoolOp", "Not", "Func", "Param",
    "Query", "Scan", "Select", "Project", "Join", "Aggregate", "OrderBy", "Limit",
    "AggSpec", "equi_join_indices", "register_scalar_func", "scan_tables",
]

# --------------------------------------------------------------------------
# Scalar expressions
# --------------------------------------------------------------------------

_SCALAR_FUNCS: Dict[str, Callable] = {
    "abs": torch.abs,
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "log": torch.log,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "neg": torch.neg,
    "square": torch.square,
    # jnp.mod is a floor-mod (sign of the divisor): torch.remainder, not fmod
    "mod100": lambda x: torch.remainder(x, 100),
}


def register_scalar_func(name: str, fn: Callable) -> None:
    _SCALAR_FUNCS[name] = fn


class Scalar:
    """Base class for scalar (per-row) expressions."""

    def eval(self, table: Table, params: Optional[Mapping[str, object]] = None):
        raise NotImplementedError

    def key(self) -> Tuple:
        raise NotImplementedError

    def columns(self) -> Tuple[str, ...]:
        return ()

    def __hash__(self):
        return hash(self.key())

    def __eq__(self, other):
        return isinstance(other, Scalar) and self.key() == other.key()

    # sugar
    def __add__(self, o):  return Arith("+", self, _wrap(o))
    def __radd__(self, o): return Arith("+", _wrap(o), self)
    def __sub__(self, o):  return Arith("-", self, _wrap(o))
    def __mul__(self, o):  return Arith("*", self, _wrap(o))
    def __truediv__(self, o): return Arith("/", self, _wrap(o))
    def eq(self, o):  return Cmp("==", self, _wrap(o))
    def ne(self, o):  return Cmp("!=", self, _wrap(o))
    def lt(self, o):  return Cmp("<", self, _wrap(o))
    def le(self, o):  return Cmp("<=", self, _wrap(o))
    def gt(self, o):  return Cmp(">", self, _wrap(o))
    def ge(self, o):  return Cmp(">=", self, _wrap(o))
    def and_(self, o): return BoolOp("and", self, _wrap(o))
    def or_(self, o):  return BoolOp("or", self, _wrap(o))


def _wrap(v) -> "Scalar":
    if isinstance(v, Scalar):
        return v
    return Lit(v)


@dataclasses.dataclass(frozen=True, eq=False)
class Col(Scalar):
    name: str

    def eval(self, table, params=None):
        return table.column(self.name)

    def key(self):
        return ("col", self.name)

    def columns(self):
        return (self.name,)

    def sql(self):
        return self.name


@dataclasses.dataclass(frozen=True, eq=False)
class Lit(Scalar):
    value: object

    def eval(self, table, params=None):
        return _full(table, self.value)

    def key(self):
        return ("lit", self.value)

    def sql(self):
        return repr(self.value)


@dataclasses.dataclass(frozen=True, eq=False)
class Param(Scalar):
    """A runtime parameter (e.g. the loop variable's field in a correlated query)."""

    name: str

    def eval(self, table, params=None):
        if params is None or self.name not in params:
            raise KeyError(f"unbound query parameter {self.name!r}")
        return _full(table, params[self.name])

    def key(self):
        return ("param", self.name)

    def sql(self):
        return f":{self.name}"


def _full(table, value) -> torch.Tensor:
    """A literal broadcast to the table's rows. ``jnp.full`` infers int32 /
    float32 / bool from a Python scalar (x64 off); ``torch.full`` would infer
    int64 for an int, so the dtype is passed explicitly."""
    if isinstance(value, (bool, np.bool_)):
        dt = torch.bool
    elif isinstance(value, (int, np.integer)):
        dt = torch.int32
    elif isinstance(value, (float, np.floating)):
        dt = torch.float32
    else:
        raise TypeError(f"unsupported literal {value!r}")
    return torch.full((table.nrows,), value, dtype=dt, device=table.device)


_ARITH = {
    "+": torch.add, "-": torch.sub, "*": torch.mul, "/": torch.div,
    "min": torch.minimum, "max": torch.maximum,
}
_CMP = {
    "==": torch.eq, "!=": torch.ne, "<": torch.lt, "<=": torch.le,
    ">": torch.gt, ">=": torch.ge,
}


@dataclasses.dataclass(frozen=True, eq=False)
class Arith(Scalar):
    op: str
    left: Scalar
    right: Scalar

    def eval(self, table, params=None):
        return _ARITH[self.op](self.left.eval(table, params), self.right.eval(table, params))

    def key(self):
        return ("arith", self.op, self.left.key(), self.right.key())

    def columns(self):
        return self.left.columns() + self.right.columns()

    def sql(self):
        return f"({_sql(self.left)} {self.op} {_sql(self.right)})"


@dataclasses.dataclass(frozen=True, eq=False)
class Cmp(Scalar):
    op: str
    left: Scalar
    right: Scalar

    def eval(self, table, params=None):
        return _CMP[self.op](self.left.eval(table, params), self.right.eval(table, params))

    def key(self):
        return ("cmp", self.op, self.left.key(), self.right.key())

    def columns(self):
        return self.left.columns() + self.right.columns()

    def sql(self):
        op = {"==": "=", "!=": "<>"}.get(self.op, self.op)
        return f"{_sql(self.left)} {op} {_sql(self.right)}"


@dataclasses.dataclass(frozen=True, eq=False)
class BoolOp(Scalar):
    op: str  # "and" | "or"
    left: Scalar
    right: Scalar

    def eval(self, table, params=None):
        l = self.left.eval(table, params)
        r = self.right.eval(table, params)
        return torch.logical_and(l, r) if self.op == "and" else torch.logical_or(l, r)

    def key(self):
        return ("bool", self.op, self.left.key(), self.right.key())

    def columns(self):
        return self.left.columns() + self.right.columns()

    def sql(self):
        return f"({_sql(self.left)} {self.op.upper()} {_sql(self.right)})"


@dataclasses.dataclass(frozen=True, eq=False)
class Not(Scalar):
    child: Scalar

    def eval(self, table, params=None):
        return torch.logical_not(self.child.eval(table, params))

    def key(self):
        return ("not", self.child.key())

    def columns(self):
        return self.child.columns()

    def sql(self):
        return f"NOT ({_sql(self.child)})"


@dataclasses.dataclass(frozen=True, eq=False)
class Func(Scalar):
    name: str
    args: Tuple[Scalar, ...]

    def eval(self, table, params=None):
        fn = _SCALAR_FUNCS[self.name]
        return fn(*[a.eval(table, params) for a in self.args])

    def key(self):
        return ("func", self.name, tuple(a.key() for a in self.args))

    def columns(self):
        out: Tuple[str, ...] = ()
        for a in self.args:
            out += a.columns()
        return out

    def sql(self):
        return f"{self.name}({', '.join(_sql(a) for a in self.args)})"


def _sql(e: Scalar) -> str:
    return e.sql() if hasattr(e, "sql") else repr(e)


# --------------------------------------------------------------------------
# Join index machinery (host-side; bulk gathers stay on the device)
# --------------------------------------------------------------------------

def equi_join_indices(lk: np.ndarray, rk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All (li, ri) pairs with lk[li] == rk[ri], via sort+searchsorted."""
    lk = np.asarray(lk)
    rk = np.asarray(rk)
    order = np.argsort(rk, kind="stable")
    rk_sorted = rk[order]
    lo = np.searchsorted(rk_sorted, lk, side="left")
    hi = np.searchsorted(rk_sorted, lk, side="right")
    counts = hi - lo
    li = np.repeat(np.arange(len(lk)), counts)
    starts = np.repeat(lo, counts)
    base = np.repeat(np.cumsum(counts) - counts, counts)
    run_off = np.arange(len(li)) - base
    ri = order[starts + run_off]
    return li, ri


# --------------------------------------------------------------------------
# Query algebra
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AggSpec:
    func: str  # sum | count | min | max | avg
    col: Optional[str]  # None for count(*)
    out: str

    def key(self):
        return ("agg", self.func, self.col, self.out)

    def sql(self):
        arg = self.col if self.col is not None else "*"
        return f"{self.func}({arg}) AS {self.out}"


class Query:
    """Base class for relational algebra nodes."""

    def execute(self, db, params: Optional[Mapping[str, object]] = None) -> Table:
        raise NotImplementedError

    def key(self) -> Tuple:
        raise NotImplementedError

    def sql(self) -> str:
        raise NotImplementedError

    def children(self) -> Tuple["Query", ...]:
        return ()

    def output_schema(self, db) -> Schema:
        raise NotImplementedError

    def __hash__(self):
        return hash(self.key())

    def __eq__(self, other):
        return isinstance(other, Query) and self.key() == other.key()

    def __repr__(self):
        return f"{type(self).__name__}[{self.sql()}]"


@dataclasses.dataclass(frozen=True, eq=False)
class Scan(Query):
    table: str

    def execute(self, db, params=None):
        return db.table(self.table)

    def key(self):
        return ("scan", self.table)

    def sql(self):
        return f"SELECT * FROM {self.table}"

    def output_schema(self, db):
        return db.table(self.table).schema


@dataclasses.dataclass(frozen=True, eq=False)
class Select(Query):
    pred: Scalar
    child: Query

    def execute(self, db, params=None):
        t = self.child.execute(db, params)
        if t.nrows == 0:
            return t
        mask = self.pred.eval(t, params)
        return t.filter_mask(mask)

    def key(self):
        return ("select", self.pred.key(), self.child.key())

    def children(self):
        return (self.child,)

    def sql(self):
        return f"SELECT * FROM ({self.child.sql()}) WHERE {_sql(self.pred)}"

    def output_schema(self, db):
        return self.child.output_schema(db)


@dataclasses.dataclass(frozen=True, eq=False)
class Project(Query):
    """π — keeps `cols` and adds computed columns {name: scalar expr}."""

    cols: Tuple[str, ...]
    child: Query
    computed: Tuple[Tuple[str, Scalar], ...] = ()

    def execute(self, db, params=None):
        t = self.child.execute(db, params)
        out = t.select_columns([c for c in self.cols]) if self.cols else t.select_columns([])
        for name, expr in self.computed:
            vals = expr.eval(t, params)
            out = out.with_column(Field(name, np_dtype_name(vals)), vals)
        return out

    def key(self):
        return ("project", self.cols, tuple((n, e.key()) for n, e in self.computed), self.child.key())

    def children(self):
        return (self.child,)

    def sql(self):
        items = list(self.cols) + [f"{_sql(e)} AS {n}" for n, e in self.computed]
        return f"SELECT {', '.join(items) or '*'} FROM ({self.child.sql()})"

    def output_schema(self, db):
        base = self.child.output_schema(db).subset(self.cols)
        for name, _ in self.computed:
            base = base.concat(Schema.of(Field(name, "float64")))
        return base


@dataclasses.dataclass(frozen=True, eq=False)
class Join(Query):
    """Inner equi-join on left.left_key == right.right_key."""

    left: Query
    right: Query
    left_key: str
    right_key: str

    def execute(self, db, params=None):
        lt = self.left.execute(db, params)
        rt = self.right.execute(db, params)
        li, ri = equi_join_indices(lt.host(self.left_key),
                                   rt.host(self.right_key))
        lsel = lt.take(li)
        rsel = rt.take(ri)
        # disambiguate duplicate names by prefixing right side
        lnames = set(lsel.schema.names)
        ren = {n: f"{rt.name}_{n}" for n in rsel.schema.names if n in lnames}
        rsel = rsel.rename(ren)
        cols = dict(lsel.columns)
        cols.update(rsel.columns)
        out = Table(f"{lt.name}_join_{rt.name}", lsel.schema.concat(rsel.schema),
                    cols, device=lt.device)
        out._host.update(lsel._host)
        out._host.update(rsel._host)
        return out

    def key(self):
        return ("join", self.left_key, self.right_key, self.left.key(), self.right.key())

    def children(self):
        return (self.left, self.right)

    def sql(self):
        return (f"SELECT * FROM ({self.left.sql()}) l JOIN ({self.right.sql()}) r "
                f"ON l.{self.left_key} = r.{self.right_key}")

    def output_schema(self, db):
        ls = self.left.output_schema(db)
        rs = self.right.output_schema(db)
        lnames = set(ls.names)
        rf = []
        rprefix = self.right.table if isinstance(self.right, Scan) else "r"
        for f in rs.fields:
            rf.append(dataclasses.replace(f, name=f"{rprefix}_{f.name}") if f.name in lnames else f)
        return ls.concat(Schema(tuple(rf)))


def _sum(x: torch.Tensor) -> torch.Tensor:
    # jnp.sum keeps int32 (and gives int32 for bool); torch.sum widens to int64
    if x.dtype in (torch.bool, torch.int32):
        return torch.sum(x, dtype=torch.int32)
    return torch.sum(x)


def _mean(x: torch.Tensor) -> torch.Tensor:
    # jnp.mean lowers its division to a reciprocal multiply in float32:
    # keep that rounding (a true divide gives 499.5 where it gives 499.50003)
    recip = np.float32(1) / np.float32(x.shape[0])
    return torch.sum(x.to(torch.float32)) * float(recip)


_AGG_FUNCS = {
    "sum": _sum,
    "min": lambda x: torch.min(x),
    "max": lambda x: torch.max(x),
    "avg": _mean,
}


def _segment_sum(arr: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: per-group sum in the input's dtype (bool
    counts as int32, like jnp)."""
    if arr.dtype == torch.bool:
        arr = arr.to(torch.int32)
    out = torch.zeros((n,), dtype=arr.dtype, device=arr.device)
    return out.index_add_(0, seg, arr)


def _segment_extreme(arr: torch.Tensor, seg: torch.Tensor, n: int,
                     reduce: str) -> torch.Tensor:
    """``jax.ops.segment_min`` / ``segment_max`` over non-empty groups."""
    out = torch.zeros((n,), dtype=arr.dtype, device=arr.device)
    return out.scatter_reduce_(0, seg, arr, reduce=reduce, include_self=False)


@dataclasses.dataclass(frozen=True, eq=False)
class Aggregate(Query):
    """γ — group-by aggregation. Empty group_by = single global group."""

    group_by: Tuple[str, ...]
    aggs: Tuple[AggSpec, ...]
    child: Query

    def execute(self, db, params=None):
        t = self.child.execute(db, params)
        if not self.group_by:
            return self._global(t)
        return self._grouped(t)

    def _global(self, t: Table) -> Table:
        fields, cols = [], {}
        for a in self.aggs:
            if a.func == "count":
                val, dt = t.nrows, "int32"
            else:
                arr = t.column(a.col)
                if t.nrows == 0:
                    val, dt = 0, "float32"
                else:
                    val = _AGG_FUNCS[a.func](arr)
                    dt = "float32" if a.func == "avg" else np_dtype_name(val)
                    val = val.item()
            fields.append(Field(a.out, dt))
            cols[a.out] = np.asarray([val], dtype=np.dtype(dt) if np.dtype(dt).itemsize<8 else np.dtype(dt.replace("64","32")))
        return Table("agg", Schema(tuple(fields)), cols, device=t.device)

    def _grouped(self, t: Table) -> Table:
        keys = [t.host(g) for g in self.group_by]
        if t.nrows == 0:
            uniq_idx = np.asarray([], dtype=np.int64)
            inv = np.asarray([], dtype=np.int64)
            ngroups = 0
        else:
            stacked = np.stack(keys, axis=1)
            _, uniq_idx, inv = np.unique(stacked, axis=0, return_index=True, return_inverse=True)
            inv = inv.reshape(-1)
            ngroups = int(inv.max()) + 1 if len(inv) else 0
        fields, cols = [], {}
        for g in self.group_by:
            f = None
            for tf in t.schema.fields:
                if tf.name == g:
                    f = tf
            fields.append(f)
            cols[g] = t.host(g)[uniq_idx]
        # groups come from np.unique, so none is empty: the segment ops
        # below never see an identity-only group
        dev = t.device
        seg = host_to_device(inv, dev, dtype=np.int64)
        for a in self.aggs:
            if a.func == "count":
                vals = _segment_sum(torch.ones((t.nrows,), dtype=torch.int32,
                                               device=dev), seg, ngroups)
                dt = "int32"
            else:
                arr = t.column(a.col)
                if a.func == "sum":
                    vals = _segment_sum(arr, seg, ngroups)
                elif a.func == "min":
                    vals = _segment_extreme(arr, seg, ngroups, "amin")
                elif a.func == "max":
                    vals = _segment_extreme(arr, seg, ngroups, "amax")
                elif a.func == "avg":
                    s = _segment_sum(arr.to(torch.float32), seg, ngroups)
                    c = _segment_sum(torch.ones((t.nrows,), dtype=torch.float32,
                                                device=dev), seg, ngroups)
                    vals = s / torch.clamp(c, min=1.0)
                else:
                    raise ValueError(a.func)
                dt = "float32" if a.func == "avg" else np_dtype_name(vals)
            fields.append(Field(a.out, dt))
            cols[a.out] = vals
        return Table("agg", Schema(tuple(fields)), cols, device=dev)

    def key(self):
        return ("aggregate", self.group_by, tuple(a.key() for a in self.aggs), self.child.key())

    def children(self):
        return (self.child,)

    def sql(self):
        items = list(self.group_by) + [a.sql() for a in self.aggs]
        gb = f" GROUP BY {', '.join(self.group_by)}" if self.group_by else ""
        return f"SELECT {', '.join(items)} FROM ({self.child.sql()}){gb}"

    def output_schema(self, db):
        base = self.child.output_schema(db).subset(self.group_by) if self.group_by else Schema(())
        for a in self.aggs:
            base = base.concat(Schema.of(Field(a.out, "float64")))
        return base


@dataclasses.dataclass(frozen=True, eq=False)
class OrderBy(Query):
    keys: Tuple[str, ...]
    child: Query
    descending: bool = False

    def execute(self, db, params=None):
        return self.child.execute(db, params).sort_by(self.keys, self.descending)

    def key(self):
        return ("orderby", self.keys, self.descending, self.child.key())

    def children(self):
        return (self.child,)

    def sql(self):
        d = " DESC" if self.descending else ""
        return f"{self.child.sql()} ORDER BY {', '.join(self.keys)}{d}"

    def output_schema(self, db):
        return self.child.output_schema(db)


@dataclasses.dataclass(frozen=True, eq=False)
class Limit(Query):
    k: int
    child: Query

    def execute(self, db, params=None):
        return self.child.execute(db, params).head(self.k)

    def key(self):
        return ("limit", self.k, self.child.key())

    def children(self):
        return (self.child,)

    def sql(self):
        return f"{self.child.sql()} LIMIT {self.k}"

    def output_schema(self, db):
        return self.child.output_schema(db)


def scan_tables(q: Query) -> Tuple[str, ...]:
    """All base tables a relational ``Query`` tree scans (sorted).

    The canonical table-extraction walk: plan-cache stats tokens
    (``repro_torch.api.cache.query_tables``), the serving-level site cache's
    invalidation epochs, and the cost model's binding-diversity group keys
    all share this identity so a table name means the same thing in every
    layer."""
    out = set()

    def walk(node: Query):
        if isinstance(node, Scan):
            out.add(node.table)
        for c in node.children():
            walk(c)

    walk(q)
    return tuple(sorted(out))
