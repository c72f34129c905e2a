"""Vectorized execution of recognized cursor loops.

``Interpreter(mode="fast")`` delegates here. ``analyze_loop`` statically
recognizes straight-line loop bodies (optionally with one guard ``if``)
built from the statement vocabulary of `regions.py`; ``exec_loop_vectorized``
then executes the loop columnar (numpy bulk ops) while charging the
*identical* simulated time the exact row-at-a-time interpreter would charge
(per-statement C_Z counts, per-query costs, ORM-cache hit/miss pattern).

Property tests (tests/test_properties.py) assert state AND clock equivalence
between the two modes on randomized programs/data. Unrecognized loops fall
back to exact mode — equivalence is never compromised for speed.

The columnar executor is split in two layers so the compiled tier
(:mod:`repro_torch.compiled`) can reuse it: ``exec_loop_plan`` owns the statement
walk and ALL simulated-time charging, while the data-movement primitives
(navigation gather, prefetch-cache lookup, accumulator fold) are pluggable
:class:`LoopHooks`. The fast interpreter passes the defaults; the compiled
tier passes kernel-backed, artifact-cached implementations — both charge
identically because the charging lives in the shared walk.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..relational.table import Table
from .regions import (Assign, BasicBlock, BreakStmt, CollectionAdd, CondRegion,
                      ContinueStmt, IBin, ICacheLookup, ICall, IConst, IField,
                      ILen, INav, IVar, LoopRegion, MapPut, NoOp, Region,
                      ReturnStmt, SeqRegion, Stmt, UpdateRow, _BIN_OPS,
                      _FUNCTIONS)

__all__ = ["analyze_loop", "exec_loop_plan", "try_exec_loop_fast",
           "LoopHooks", "LoopPlan"]

_ACC_OPS = {"+", "min", "max"}
_ACC_IDENTITY = {"+": 0.0, "min": np.inf, "max": -np.inf}


@dataclasses.dataclass
class LoopPlan:
    stmts: List[Tuple[Stmt, Optional["IExpr"]]]  # (stmt, guard pred or None)
    accumulators: List[str]


# --------------------------------------------------------------------------
# Static recognition
# --------------------------------------------------------------------------

def _flatten(region: Region) -> Optional[List[Tuple[Stmt, Optional[object]]]]:
    """Flatten body to [(stmt, guard)] — straight-line + at most one-level if."""
    out: List[Tuple[Stmt, Optional[object]]] = []

    def walk(r: Region, guard) -> bool:
        if isinstance(r, BasicBlock):
            out.append((r.stmt, guard))
            return True
        if isinstance(r, SeqRegion):
            return all(walk(p, guard) for p in r.parts)
        if isinstance(r, CondRegion):
            if guard is not None or r.else_r is not None:
                return False  # nested/else guards: fall back to exact
            out.append((("__guard__", r.pred), guard))
            return walk(r.then_r, r.pred)
        return False  # nested loop etc.

    return out if walk(region, None) else None


def _is_pure_vec(e, rowvars: set, rowtmps: set, scalartmps: set) -> bool:
    if isinstance(e, IConst):
        return True
    if isinstance(e, IVar):
        return True  # invariant scalar, tmp column, or accumulator column
    if isinstance(e, IField):
        return isinstance(e.base, IVar) and (e.base.name in rowvars or e.base.name in rowtmps)
    if isinstance(e, IBin):
        return all(_is_pure_vec(x, rowvars, rowtmps, scalartmps) for x in (e.left, e.right))
    if isinstance(e, ICall):
        return all(_is_pure_vec(x, rowvars, rowtmps, scalartmps) for x in e.args)
    return False


def analyze_loop(r: LoopRegion, invariants: Dict[str, object]) -> Optional[LoopPlan]:
    flat = _flatten(r.body)
    if flat is None:
        return None
    rowvars = {r.var}
    rowtmps: set = set()
    scalartmps: set = set()
    accs: List[str] = []
    # Soundness rule for cross-iteration state: a statement may reference a
    # body-ASSIGNED variable only after its defining statement in body order
    # (then its per-row column — including an accumulator's running value —
    # is available). Referencing it BEFORE its definition means reading the
    # previous iteration's value, which has no columnar form outside the
    # matched `acc = acc <op> x` shape; those loops run exact.
    body_defs = {s.target for s, _ in flat
                 if isinstance(s, Assign)}
    defined: set = set()

    def refs_ok(e) -> bool:
        return all(nm not in body_defs or nm in defined
                   for nm in e.free_vars())

    for stmt, guard in flat:
        if isinstance(stmt, tuple) and stmt[0] == "__guard__":
            if not (_is_pure_vec(stmt[1], rowvars, rowtmps, scalartmps)
                    and refs_ok(stmt[1])):
                return None
            continue
        if isinstance(stmt, (BreakStmt, ContinueStmt, ReturnStmt)):
            # early exit makes iteration order observable: which rows ran
            # depends on per-row state, so columnar execution is unsound —
            # every invocation (batched ones included) falls back to the
            # exact row-at-a-time interpreter, which honors the exit point
            return None
        if isinstance(stmt, Assign):
            e = stmt.expr
            if isinstance(e, INav):
                if not (isinstance(e.base, IVar) and (e.base.name in rowvars or e.base.name in rowtmps)):
                    return None
                if guard is not None:
                    return None  # guarded nav: cache-state depends on mask order; exact only
                rowtmps.add(stmt.target)
                defined.add(stmt.target)
                continue
            if isinstance(e, ICacheLookup) and not e.all_matches:
                if not (_is_pure_vec(e.keyexpr, rowvars, rowtmps, scalartmps)
                        and refs_ok(e.keyexpr)):
                    return None
                rowtmps.add(stmt.target)
                defined.add(stmt.target)
                continue
            # scalar accumulator: acc = acc <op> expr | expr <op> acc
            if isinstance(e, IBin) and e.op in _ACC_OPS \
                    and stmt.target not in defined:
                l_is_acc = isinstance(e.left, IVar) and e.left.name == stmt.target
                r_is_acc = isinstance(e.right, IVar) and e.right.name == stmt.target
                if l_is_acc != r_is_acc:
                    other = e.right if l_is_acc else e.left
                    if _is_pure_vec(other, rowvars, rowtmps, scalartmps) \
                            and refs_ok(other):
                        if stmt.target not in accs:
                            accs.append(stmt.target)
                        scalartmps.add(stmt.target)
                        defined.add(stmt.target)
                        continue
                    return None
            if _is_pure_vec(e, rowvars, rowtmps, scalartmps) and refs_ok(e):
                scalartmps.add(stmt.target)
                defined.add(stmt.target)
                continue
            return None
        if isinstance(stmt, CollectionAdd):
            if not (_is_pure_vec(stmt.expr, rowvars, rowtmps, scalartmps)
                    and refs_ok(stmt.expr)):
                return None
            continue
        if isinstance(stmt, MapPut):
            if not (_is_pure_vec(stmt.keyexpr, rowvars, rowtmps, scalartmps)
                    and refs_ok(stmt.keyexpr)
                    and _is_pure_vec(stmt.valexpr, rowvars, rowtmps, scalartmps)
                    and refs_ok(stmt.valexpr)):
                return None
            continue
        if isinstance(stmt, UpdateRow):
            if not (_is_pure_vec(stmt.val, rowvars, rowtmps, scalartmps)
                    and refs_ok(stmt.val)
                    and _is_pure_vec(stmt.keyexpr, rowvars, rowtmps, scalartmps)
                    and refs_ok(stmt.keyexpr)):
                return None
            continue
        if isinstance(stmt, NoOp):
            continue
        return None
    return LoopPlan(stmts=flat, accumulators=accs)


# --------------------------------------------------------------------------
# Vectorized execution
# --------------------------------------------------------------------------

class _ColEnv:
    """Column environment: per-row values as arrays; invariants as scalars."""

    def __init__(self, n: int, state: Dict[str, object], device=None):
        self.n = n
        self.state = state
        self.device = device                   # the loop source's device
        self.cols: Dict[str, object] = {}      # var -> np array (length n) or scalar
        self.rows: Dict[str, Dict[str, np.ndarray]] = {}  # row-typed var -> col dict

    def lookup(self, name: str):
        if name in self.cols:
            return self.cols[name]
        if name in self.state:
            return self.state[name]
        raise KeyError(name)


def _eval_vec(e, ce: _ColEnv):
    if isinstance(e, IConst):
        return e.value
    if isinstance(e, IVar):
        if e.name in ce.rows:
            return ce.rows[e.name]
        return ce.lookup(e.name)
    if isinstance(e, IField):
        base = _eval_vec(e.base, ce)
        return base[e.field]
    if isinstance(e, IBin):
        return _BIN_OPS[e.op](_as_arr(_eval_vec(e.left, ce)), _as_arr(_eval_vec(e.right, ce)))
    if isinstance(e, ICall):
        return _FUNCTIONS[e.func](*[_as_arr(_eval_vec(a, ce)) for a in e.args])
    if isinstance(e, ILen):
        v = _eval_vec(e.base, ce)
        return v.nrows if isinstance(v, Table) else len(v)
    raise TypeError(f"cannot vec-eval {e!r}")


def _as_arr(v):
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return v
    return v


def _broadcast(v, n):
    a = np.asarray(v)
    if a.ndim == 0:
        return np.broadcast_to(a, (n,)).copy()
    return a


@dataclasses.dataclass
class LoopHooks:
    """Pluggable data-movement primitives for the columnar walk.

    Every hook must be observationally identical to the default (same
    values, same ORM-cache mutations, same exceptions) — only HOW the
    gather/fold is computed may differ (cached indices, CUDA kernels).
    Simulated-time charging stays in :func:`exec_loop_plan`, shared by all
    hook sets, so clock equivalence cannot drift."""

    nav: object = None            # (env, ce, target, INav, n) -> None
    cache_lookup: object = None   # (env, ce, target, ICacheLookup, n) -> None
    accumulate: object = None     # (ce, stmt, IBin, mask|None, state) -> None
    row_source: object = None     # (Table) -> {col: np.ndarray}


def _default_row_source(src: Table) -> Dict[str, np.ndarray]:
    return {c: src.host(c) for c in src.schema.names}


def try_exec_loop_fast(interp, r: LoopRegion, src, state: Dict[str, object]) -> bool:
    """Attempt vectorized execution. Returns False to request exact fallback."""
    if not isinstance(src, Table) or src.nrows == 0:
        return False
    plan = analyze_loop(r, state)
    if plan is None:
        return False
    exec_loop_plan(interp.env, r, src, state, plan)
    return True


def exec_loop_plan(env, r: LoopRegion, src: Table, state: Dict[str, object],
                   plan: LoopPlan, hooks: Optional[LoopHooks] = None) -> None:
    """Columnar execution of a recognized loop under a precomputed plan.

    Owns the statement walk and EVERY ``charge_statement``/query charge —
    the one code path both the fast interpreter and the compiled tier run
    through, so their simulated clocks are identical by construction."""
    hooks = hooks or LoopHooks()
    nav = hooks.nav or _vec_nav
    cache_lookup = hooks.cache_lookup or _vec_cache_lookup
    accumulate = hooks.accumulate or _vec_accumulate
    row_source = hooks.row_source or _default_row_source
    n = src.nrows
    ce = _ColEnv(n, state, src.device)
    ce.rows[r.var] = row_source(src)

    env.charge_statement(n)  # loop header per iteration
    mask = np.ones(n, dtype=bool)
    active = n

    for stmt, guard in plan.stmts:
        if isinstance(stmt, tuple) and stmt[0] == "__guard__":
            env.charge_statement(int(mask.sum()))  # cond evaluation per row
            pred = np.broadcast_to(np.asarray(_eval_vec(stmt[1], ce)), (n,))
            mask = mask & pred.astype(bool)
            active = int(mask.sum())
            continue
        nexec = active if guard is not None else n
        if isinstance(stmt, Assign):
            e = stmt.expr
            if isinstance(e, INav):
                nav(env, ce, stmt.target, e, n)
                env.charge_statement(nexec)  # the assign itself
                continue
            if isinstance(e, ICacheLookup):
                cache_lookup(env, ce, stmt.target, e, n)
                env.charge_statement(nexec)   # assign
                env.charge_statement(nexec)   # lookup_cache charge
                continue
            if stmt.target in plan.accumulators and isinstance(e, IBin) and e.op in _ACC_OPS:
                accumulate(ce, stmt, e, mask if guard is not None else None, state)
                env.charge_statement(nexec)
                continue
            val = _eval_vec(e, ce)
            ce.cols[stmt.target] = _broadcast(val, n) if not isinstance(val, dict) else val
            env.charge_statement(nexec)
            continue
        if isinstance(stmt, CollectionAdd):
            vals = _broadcast(_eval_vec(stmt.expr, ce), n)
            sel = vals[mask] if guard is not None else vals
            state.setdefault(stmt.target, [])
            state[stmt.target].extend(sel.tolist())
            env.charge_statement(nexec)
            continue
        if isinstance(stmt, MapPut):
            keys = _broadcast(_eval_vec(stmt.keyexpr, ce), n)
            vals = _broadcast(_eval_vec(stmt.valexpr, ce), n)
            if guard is not None:
                keys, vals = keys[mask], vals[mask]
            d = state.setdefault(stmt.target, {})
            for k, v in zip(keys.tolist(), vals.tolist()):
                d[k] = v
            env.charge_statement(nexec)
            continue
        if isinstance(stmt, UpdateRow):
            _vec_update(env, ce, stmt, mask if guard is not None else None, n)
            continue
        if isinstance(stmt, NoOp):
            env.charge_statement(nexec)
            continue
        raise AssertionError(f"unplanned stmt {stmt!r}")

    # export final accumulator values (a kernel-folded accumulator has
    # already written its scalar into `state` and left no running column)
    for acc in plan.accumulators:
        col = ce.cols.get(acc)
        if isinstance(col, np.ndarray):
            state[acc] = col[-1].item()


def _vec_nav(env, ce: _ColEnv, target: str, e: INav, n: int) -> None:
    base = ce.rows[e.base.name]
    keys = np.asarray(base[e.fk_field])
    t = env.db.table(e.target)
    tkeys = t.host(e.target_key)
    order = np.argsort(tkeys, kind="stable")
    pos = np.searchsorted(tkeys[order], keys)
    pos = np.clip(pos, 0, len(order) - 1)
    gidx = order[pos]
    found = tkeys[gidx] == keys
    if not found.all():
        raise KeyError(f"navigation {e!r}: missing keys (FK violation)")
    ce.rows[target] = {c: t.host(c)[gidx] for c in t.schema.names}
    # ORM cache accounting: first occurrence of an uncached key = point query;
    # every other occurrence = cache hit (1 statement).
    uniq, first_idx = np.unique(keys, return_index=True)
    new_keys = [k for k in uniq.tolist() if (e.target, k) not in env._orm_cache]
    n_misses = len(new_keys)
    n_hits = n - n_misses
    env.charge_statement(n_hits)
    m = env.db.model
    # A batching client env (runtime.batch.BatchClientEnv) combines all
    # missing keys into ONE bulk fetch — a single round trip per navigation
    # site instead of one per distinct key, amortizing C_NRT exactly like the
    # paper's batching transformation. The plain serving path keeps the
    # faithful N+1 accounting.
    bulk = getattr(env, "bulk_nav_charge", None)
    if bulk is not None and n_misses:
        bulk(t, n_misses)
    else:
        for _ in range(n_misses):
            env._charge_query(1, t.row_bytes,
                              m.startup_s + m.index_lookup_s,
                              m.startup_s + m.index_lookup_s + 1 / m.emit_rows_per_s)
    if env.orm_cache_enabled and n_misses:
        tk_order = np.searchsorted(tkeys[order], np.asarray(new_keys))
        rows_idx = order[tk_order]
        for k, i in zip(new_keys, rows_idx.tolist()):
            env._orm_cache[(e.target, k)] = t.row(int(i))


def _vec_cache_lookup(env, ce: _ColEnv, target: str, e: ICacheLookup, n: int) -> None:
    entry = env._prefetch_cache.get((e.table, e.col))
    if entry is None:
        raise KeyError(f"no prefetch cache for ({e.table}, {e.col})")
    keys = _broadcast(_eval_vec(e.keyexpr, ce), n)
    ckeys, corder = entry["keys"], entry["order"]
    pos = np.searchsorted(ckeys, keys)
    pos = np.clip(pos, 0, len(ckeys) - 1)
    found = ckeys[pos] == keys
    if not found.all():
        raise KeyError(f"cache lookup {e!r}: missing keys")
    gidx = corder[pos]
    t = entry["table"]
    ce.rows[target] = {c: t.host(c)[gidx] for c in t.schema.names}


def _vec_accumulate(ce: _ColEnv, stmt: Assign, e: IBin, mask, state) -> None:
    acc = stmt.target
    l_is_acc = isinstance(e.left, IVar) and e.left.name == acc
    other = e.right if l_is_acc else e.left
    delta = _broadcast(_eval_vec(other, ce), ce.n).astype(np.float64)
    if mask is not None:
        delta = np.where(mask, delta, _ACC_IDENTITY[e.op])
    a0 = float(state.get(acc, 0.0) if acc not in ce.cols else np.asarray(ce.cols[acc])[-1])
    if acc in ce.cols and isinstance(ce.cols[acc], np.ndarray):
        a0 = float(ce.cols[acc][-1])
    elif acc in state:
        a0 = float(state[acc])
    if e.op == "+":
        run = a0 + np.cumsum(delta)
    elif e.op == "min":
        run = np.minimum(a0, np.minimum.accumulate(delta))
    else:
        run = np.maximum(a0, np.maximum.accumulate(delta))
    ce.cols[acc] = run


def _vec_update(env, ce: _ColEnv, stmt: UpdateRow, mask, n: int) -> None:
    vals = _broadcast(_eval_vec(stmt.val, ce), n)
    keys = _broadcast(_eval_vec(stmt.keyexpr, ce), n)
    if mask is not None:
        vals, keys = vals[mask], keys[mask]
    m = env.db.model
    for _ in range(len(keys)):
        env._charge_query(1, 16, m.startup_s + m.index_lookup_s,
                          m.startup_s + m.index_lookup_s)
    t = env.db.table(stmt.table)
    arr = t.host(stmt.key_col)
    col = t.host(stmt.set_col).copy()
    order = np.argsort(arr, kind="stable")
    pos = np.searchsorted(arr[order], keys)
    pos = np.clip(pos, 0, len(order) - 1)
    gidx = order[pos]
    hit = arr[gidx] == keys
    col[gidx[hit]] = vals[hit]
    env.db.add_table(t.with_column(t.schema.field(stmt.set_col), col))
