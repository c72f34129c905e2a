"""The paper's example programs and workloads, as plain Python functions.

  * ``make_p0 / make_p1 / make_p2`` — Fig. 3 (Hibernate N+1 / SQL join /
    prefetch) over TPC-DS-sized ``orders`` / ``customer`` tables.
  * ``make_m0`` — Fig. 7 (dependent aggregations: sum + cumulative sum).
  * ``make_wilos_<X>`` — one representative program per Wilos pattern A–F
    (Fig. 14), matching the paper's descriptions.
  * ``make_scan`` — a while/early-exit worklist program (beyond the paper's
    Sec. V limitations): state-by-state triage with a data-dependent stop.
  * data generators with configurable cardinalities, many-to-one ratio and
    predicate selectivity (Sec. VIII experiment setup). Each takes the
    ``device`` its tables live on (the card by default; ``device=None``
    without CUDA raises) and draws its data from
    ``numpy.random.default_rng(seed)``, so the same seed gives the same
    rows on every device and in the reference package.

Every program is ordinary imperative Python — real ``for``/``if``/``while``
loops, ``break``, early ``return``, ``list.append`` — compiled to Region IR
by the AST lifter (``repro_torch.api.lift``). The lifter lowers onto
``repro_torch.api.ProgramBuilder`` (the documented escape hatch for programs
outside the liftable subset) and emits byte-identical IR to hand-built
region trees (asserted in tests/test_lift.py and tests/test_api.py).
"""

from __future__ import annotations


import numpy as np

from .api.builder import col, param, q
from .api.lift import (cache_lookup, lift_program, load_all, prefetch,
                       update_row)
from .core.regions import Program, get_function
from .relational.database import DatabaseServer
from .relational.table import Field, Schema, Table

__all__ = [
    "make_orders_customer_db", "make_sales_db", "make_wilos_db",
    "make_skew_db", "make_skew_probe",
    "make_p0", "make_p1", "make_p2", "make_m0", "make_scan",
    "make_wilos_a", "make_wilos_b", "make_wilos_c", "make_wilos_d",
    "make_wilos_e", "make_wilos_f", "WILOS_PROGRAMS",
    "make_synthetic", "synthetic_source",
]

# make the programs' pure functions available to relational computed columns
# (rule T4 translates imperative calls into projected scalar expressions);
# the module-level names also let the plain-Python programs below run as
# ordinary Python and are how the lifter traces the calls (by registry name)
from .relational.algebra import register_scalar_func as _reg

myFunc = get_function("myFunc")
combine = get_function("combine")
scale = get_function("scale")

for _name in ("myFunc", "combine", "scale"):
    _reg(_name, get_function(_name))

# ORM entity mapping for the Fig. 3 programs — the Hibernate-style
# relationship metadata that in a real application lives in annotations,
# passed to the lifter so ``o.customer`` traces to navigation
ORDERS_CUSTOMER_REL = ("orders", "o_customer_sk",
                       "customer", "c_customer_sk", "customer")


# --------------------------------------------------------------------------
# Data generators
# --------------------------------------------------------------------------

def make_orders_customer_db(n_orders: int, n_customers: int,
                            seed: int = 0, device=None) -> DatabaseServer:
    """TPC-DS-sized rows: customer ≈ 132 B, orders (store_sales-ish) ≈ 100 B."""
    rng = np.random.default_rng(seed)
    customer = Table.from_columns(
        "customer",
        Schema.of(Field("c_customer_sk", "int64", 8),
                  Field("c_birth_year", "int32", 4),
                  Field("c_credit", "float32", 4),
                  Field("c_payload", "int32", 116)),  # varchar payload stand-in
        c_customer_sk=np.arange(n_customers, dtype=np.int64),
        c_birth_year=rng.integers(1930, 2005, n_customers),
        c_credit=rng.uniform(0, 1e4, n_customers).astype(np.float32),
        c_payload=rng.integers(0, 1 << 20, n_customers),
        device=device,
    )
    orders = Table.from_columns(
        "orders",
        Schema.of(Field("o_id", "int64", 8),
                  Field("o_customer_sk", "int64", 8),
                  Field("o_amt", "float32", 4),
                  Field("o_payload", "int32", 80)),
        o_id=np.arange(n_orders, dtype=np.int64),
        o_customer_sk=rng.integers(0, n_customers, n_orders),
        o_amt=rng.uniform(1, 500, n_orders).astype(np.float32),
        o_payload=rng.integers(0, 1 << 20, n_orders),
        device=device,
    )
    return DatabaseServer({"customer": customer, "orders": orders},
                          device=device)


def make_sales_db(n_sales: int, n_months: int = 12, seed: int = 1,
                  device=None) -> DatabaseServer:
    rng = np.random.default_rng(seed)
    sales = Table.from_columns(
        "sales",
        Schema.of(Field("month", "int32", 4), Field("sale_amt", "float32", 4),
                  Field("s_payload", "int32", 92)),
        month=rng.integers(1, n_months + 1, n_sales),
        sale_amt=rng.uniform(1, 100, n_sales).astype(np.float32),
        s_payload=rng.integers(0, 1 << 20, n_sales),
        device=device,
    )
    return DatabaseServer({"sales": sales}, device=device)


def make_wilos_db(n_big: int, ratio: int = 10, seed: int = 2,
                  device=None) -> DatabaseServer:
    """Two relations with a many-to-one FK (ratio:1), per the Exp-4 setup
    (mapping ratio 10:1, selectivity 20%)."""
    rng = np.random.default_rng(seed)
    n_small = max(1, n_big // ratio)
    small = Table.from_columns(
        "roles",
        Schema.of(Field("r_id", "int64", 8), Field("r_rank", "int32", 4),
                  Field("r_payload", "int32", 120)),
        r_id=np.arange(n_small, dtype=np.int64),
        r_rank=rng.integers(0, 5, n_small),  # 20% selectivity on == one rank
        r_payload=rng.integers(0, 1 << 20, n_small),
        device=device,
    )
    big = Table.from_columns(
        "tasks",
        Schema.of(Field("t_id", "int64", 8), Field("t_role_id", "int64", 8),
                  Field("t_state", "int32", 4), Field("t_hours", "float32", 4),
                  Field("t_payload", "int32", 76)),
        t_id=np.arange(n_big, dtype=np.int64),
        t_role_id=rng.integers(0, n_small, n_big),
        t_state=rng.integers(0, 5, n_big),
        t_hours=rng.uniform(0, 40, n_big).astype(np.float32),
        t_payload=rng.integers(0, 1 << 20, n_big),
        device=device,
    )
    return DatabaseServer({"roles": small, "tasks": big}, device=device)


def make_skew_db(n: int = 20000, ndv: int = 50, hot: float = 0.9,
                 seed: int = 7, stats_config=None,
                 device=None) -> DatabaseServer:
    """Zipf-ish single-hot-key relation for the scalar-vs-histogram plan
    flip (the statistics subsystem's acceptance demo): ``hot`` of the
    ``events`` rows share key 0, the rest spread uniformly over the other
    ``ndv - 1`` keys. The scalar 1/NDV rule prices a per-key probe at
    N/NDV rows; the histogram's ``param_eq_fraction`` (Σ (f_v/N)², the
    key drawn from the data's own distribution) prices it near
    ``hot²·N`` — ~40× more under the defaults — which is what flips the
    per-key-query plan to a prefetch. ``e_units`` is integral so every
    plan's accumulation is exact and outputs stay bit-identical across
    the flip. ``stats_config`` selects the arm
    (``StatsConfig(histograms=False)`` = the scalar control)."""
    rng = np.random.default_rng(seed)
    n_hot = int(n * hot)
    keys = np.concatenate([
        np.zeros(n_hot, dtype=np.int64),
        rng.integers(1, max(ndv, 2), n - n_hot).astype(np.int64)])
    rng.shuffle(keys)
    events = Table.from_columns(
        "events",
        Schema.of(Field("e_id", "int64", 8), Field("e_key", "int64", 8),
                  Field("e_units", "int32", 4),
                  Field("e_payload", "int32", 104)),
        e_id=np.arange(n, dtype=np.int64),
        e_key=keys,
        e_units=rng.integers(0, 100, n),
        e_payload=rng.integers(0, 1 << 20, n),
        device=device,
    )
    return DatabaseServer({"events": events}, stats_config=stats_config,
                          device=device)


def make_skew_probe() -> Program:
    """Per-key probe over the skewed ``events`` relation (W_E-shaped): for
    each worklist key, fetch its rows and accumulate the integral
    ``e_units``. The optimizer's choice — correlated per-key queries vs
    one prefetch served locally — hinges entirely on the expected rows per
    key, i.e. on which statistics arm the database was built with."""
    def W_S(worklist=()):
        result = []
        for wid in worklist:
            per_key = q("events").where(col("e_key")
                                        .eq(param("kid"))).bind(kid=wid)
            for y in per_key:
                result.append(y.e_units)
        return result

    return lift_program(W_S)


# --------------------------------------------------------------------------
# Fig. 3 — P0 / P1 / P2
# --------------------------------------------------------------------------

def make_p0() -> Program:
    """Hibernate ORM program: per-order navigation → N+1 selects."""
    def P0():
        result = []
        for o in load_all("orders"):
            cust = o.customer  # lazy relationship → point query
            val = myFunc(o.o_id, cust.c_birth_year)
            result.append(val)
        return result

    return lift_program(P0, relations=[ORDERS_CUSTOMER_REL])


def make_p1() -> Program:
    """Rewritten to a single SQL join (Fig. 3b)."""
    def P1():
        result = []
        for r in q("orders").join("customer", "o_customer_sk",
                                  "c_customer_sk"):
            val = myFunc(r.o_id, r.c_birth_year)
            result.append(val)
        return result

    return lift_program(P1)


def make_p2() -> Program:
    """Rewritten to prefetch + local cache lookups (Fig. 3c)."""
    def P2():
        result = []
        prefetch("customer", by="c_customer_sk")
        for o in load_all("orders"):
            cust = cache_lookup("customer", "c_customer_sk", o.o_customer_sk)
            val = myFunc(o.o_id, cust.c_birth_year)
            result.append(val)
        return result

    return lift_program(P2)


# --------------------------------------------------------------------------
# Fig. 7 — M0 (dependent aggregations)
# --------------------------------------------------------------------------

def make_m0() -> Program:
    def M0():
        monthly = q("sales").select("month", "sale_amt").order_by("month")
        total = 0.0
        cSum = {}
        for t in monthly:
            total = total + t.sale_amt
            cSum[t.month] = total
        return total, cSum

    return lift_program(M0)


# --------------------------------------------------------------------------
# Wilos patterns A–F (Fig. 14)
# --------------------------------------------------------------------------

def make_wilos_a() -> Program:
    """A: nested loops with intermittent updates. The inner loop filters an
    inner relation imperatively; the outer loop issues DB updates, so only
    the inner loop can move to SQL — or be prefetched (Cobra's choice)."""
    def W_A():
        for x in load_all("roles"):
            cnt = 0
            for y in load_all("tasks"):
                if y.t_role_id == x.r_id:
                    cnt = cnt + 1
            update_row("roles", "r_rank", cnt, "r_id", x.r_id)

    return lift_program(W_A)


def make_wilos_b() -> Program:
    """B: multiple aggregations in one loop — a scalar count plus a collection
    touching every row. Extracting the count to SQL adds a query (heuristic);
    Cobra keeps the original single query."""
    def W_B():
        n = 0
        items = []
        for t in load_all("tasks"):
            n = n + 1
            items.append(scale(t.t_hours))
        return n, items

    return lift_program(W_B)


def make_wilos_c() -> Program:
    """C: nested-loops join implemented imperatively."""
    def W_C():
        result = []
        for x in load_all("tasks"):
            for y in load_all("roles"):
                if y.r_id == x.t_role_id:
                    result.append(combine(x.t_hours, y.r_rank))
        return result

    return lift_program(W_C)


def make_wilos_d() -> Program:
    """D: a per-row 'function' (inlined) aggregating a correlated query."""
    def W_D():
        result = []
        for x in load_all("roles"):
            s = 0.0
            tasks_of_role = q("tasks").where(col("t_role_id")
                                             .eq(param("rid"))).bind(rid=x.r_id)
            for y in tasks_of_role:
                s = s + y.t_hours
            result.append(s)
        return result

    return lift_program(W_D)


def make_wilos_e() -> Program:
    """E: the same relation filtered differently across (recursive) calls —
    modeled as a loop over a worklist issuing per-key σ queries."""
    def W_E(worklist=()):
        result = []
        for wid in worklist:
            per_key = q("tasks").where(col("t_role_id")
                                       .eq(param("rid"))).bind(rid=wid)
            for y in per_key:
                result.append(y.t_hours)
        return result

    return lift_program(W_E)


def make_wilos_f() -> Program:
    """F: different column subsets of one relation used by different callees —
    two narrow queries vs. one prefetch of the whole relation."""
    def W_F():
        hours = 0.0
        for a in q("tasks").select("t_hours"):
            hours = hours + a.t_hours
        states = 0
        for b in q("tasks").select("t_state"):
            states = states + b.t_state
        return hours, states

    return lift_program(W_F)


WILOS_PROGRAMS = {
    "A": make_wilos_a, "B": make_wilos_b, "C": make_wilos_c,
    "D": make_wilos_d, "E": make_wilos_e, "F": make_wilos_f,
}


# --------------------------------------------------------------------------
# SYN — synthetic compile-throughput stress program (scale knob)
# --------------------------------------------------------------------------

def synthetic_source(scale: int = 10, stmts_per_loop: int = 700) -> str:
    """Source text of a batch-application-sized program: ``scale + 2``
    query loops (rotating the T5 scalar-sum / T1 collection / guarded-sum
    shapes, plus one fixed correlated nested join) buried in
    ``stmts_per_loop`` straight-line scalar statements per loop — the shape
    of real ORM business logic, where rewritable query sites are a sliver
    of the region tree. Scaling ``scale`` scales program size ~linearly
    while the rewrite surface stays a handful of loops, which is exactly
    the regime where delta-driven rule scheduling beats rescan-everything
    saturation: the exhaustive loop re-visits every block/cond skeleton
    node every round, the applicability index never enqueues them at all.

    Deterministic text (no randomness), so the lifted IR — and therefore
    the memo fingerprint and execution outputs — are reproducible."""
    lines = ["def SYN():", "    z0 = 0.0"]
    rets: list = []
    zc = 0
    n_loops = scale + 2
    for i in range(n_loops):
        for j in range(stmts_per_loop):
            zc += 1
            k = i * stmts_per_loop + j
            if j % 7 == 3:
                lines.append(f"    if z{zc - 1} > {k}:")
                lines.append(f"        z{zc} = z{zc - 1} + {2 * k + 1}")
                lines.append("    else:")
                lines.append(f"        z{zc} = z{zc - 1} - {k + 1}")
            else:
                lines.append(f"    z{zc} = z{zc - 1} + {k + 1}")
        acc = f"acc{i}"
        rets.append(acc)
        lines.append(f"    {acc} = 0.0")
        kind = i % 3
        if kind == 0:  # scalar aggregation -> T5
            lines.append(f"    for t{i} in load_all('tasks'):")
            lines.append(f"        {acc} = {acc} + t{i}.t_hours")
        elif kind == 1:  # whole-row collection -> T1
            lines.append(f"    res{i} = []")
            lines.append(f"    for t{i} in load_all('roles'):")
            lines.append(f"        res{i}.append(t{i}.r_rank)")
            lines.append(f"    {acc} = {acc} + len(res{i})")
        else:  # guarded aggregation -> T2/T5
            lines.append(f"    for t{i} in load_all('tasks'):")
            lines.append(f"        if t{i}.t_state == {i % 5}:")
            lines.append(f"            {acc} = {acc} + t{i}.t_hours")
    # one fixed (unscaled) correlated nested join for rule-chain depth
    lines.append("    deep0 = 0.0")
    lines.append("    for ra in load_all('roles'):")
    lines.append("        for tb in load_all('tasks'):")
    lines.append("            if tb.t_role_id == ra.r_id:")
    lines.append("                deep0 = deep0 + tb.t_hours")
    rets.append("deep0")
    lines.append("    return " + ", ".join(rets + [f"z{zc}"]))
    return "\n".join(lines)


def make_synthetic(scale: int = 10, stmts_per_loop: int = 700) -> Program:
    """Lift :func:`synthetic_source` (runs against :func:`make_wilos_db`
    tables). The program returns every accumulator plus the final scalar
    chain value, so batch outputs expose any plan-divergence bit-for-bit."""
    from .api.lift import lift_source
    return lift_source(
        synthetic_source(scale, stmts_per_loop),
        env={"load_all": load_all, "q": q, "col": col, "param": param,
             "len": len})


# --------------------------------------------------------------------------
# SCAN — while + early exit (beyond the paper's Sec. V limitations)
# --------------------------------------------------------------------------

def make_scan() -> Program:
    """While-loop triage with a data-dependent stop: walk task states in
    priority order, accumulating per-state hours via a correlated query,
    until the running total crosses the threshold (``break``).

    The ``while`` itself and the early exit stay imperative — no F-IR form
    exists for a guard whose iteration count is data dependent — but the
    inner aggregation loop is still rewritten by T5 into a correlated
    ``SELECT SUM(t_hours) WHERE t_state = :k`` whose binding re-evaluates
    each round, so the cost-based win survives inside the guarded region.

    SCAN is also the canonical context-flip program: compiled one-shot the
    T5 aggregate wins (one round trip per round), while under
    ``ExecutionContext(batch_size>=8)`` the binding-free prefetch site
    inside the while body amortizes across the batch and wins instead —
    and observed iteration counts published by the feedback loop (instead
    of ``while_iters_default``) move the flip point (tests/test_context.py,
    ``make bench-batch``)."""
    def SCAN(threshold=100.0, max_state=5):
        state = 0
        total = 0.0
        while state < max_state:
            s = 0.0
            for t in q("tasks").where(col("t_state").eq(param("k"))) \
                               .bind(k=state):
                s = s + t.t_hours
            total = total + s
            state = state + 1
            if total > threshold:
                break
        return total, state

    return lift_program(SCAN)
