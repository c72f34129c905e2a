"""Quickstart on the card: point Cobra at plain Python code (the Fig. 3 ORM
program), with the PyTorch port (``repro_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The twin of ``examples/quickstart.py``: the same acts, sizes, programs and
printed lines, the tables on ``--device`` (the card by default; without
CUDA only ``--device cpu`` runs, and the default raises).

  1. P0 (the Hibernate N+1 program) is an ordinary Python function handed
     to ``session.trace``: the AST lifter compiles it to Region IR and the
     memo search picks the cheapest rewrite.
  2. ``Executable.run()`` executes the rewritten program; ``run_baseline()``
     runs the original for comparison.
  3. Re-compiling the same program is a plan-cache hit.
  4. ``while`` + ``break`` lift too: SCAN keeps its guarded loop
     imperative while the aggregation inside it moves into SQL.

``main(argv)`` also returns what it prints, per act: the plan chosen, the
simulated seconds, the plan-cache counters, the row counts, and whether
``analyze()`` after a data change flips the winner between the join and
the prefetch (the walkthrough's step 3, which the reference's docstring
describes and this twin checks).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.api import (CobraSession, OptimizerConfig, col, load_all,
                             param, q)
from repro_torch.core import CostCatalog
from repro_torch.core.regions import get_function
from repro_torch.programs import make_orders_customer_db, make_wilos_db
from repro_torch.relational.database import SLOW_REMOTE

myFunc = get_function("myFunc")


def p0():
    """Fig. 3a as the application would actually write it."""
    result = []
    for o in load_all("orders"):
        cust = o.customer                     # ORM navigation → N+1
        val = myFunc(o.o_id, cust.c_birth_year)
        result.append(val)
    return result


def scan(threshold=100.0, max_state=5):
    """While + early exit: per-state triage until the threshold is hit."""
    state = 0
    total = 0.0
    while state < max_state:
        s = 0.0
        for t in q("tasks").where(col("t_state").eq(param("k"))).bind(k=state):
            s = s + t.t_hours
        total = total + s
        state = state + 1
        if total > threshold:
            break
    return total, state


RELATIONS = [("orders", "o_customer_sk", "customer", "c_customer_sk",
              "customer")]


def plan_kind(exe) -> str:
    return "P2 (prefetch)" if "prefetch" in repr(exe.program.body) \
        else "P1 (SQL join)"


def analyze_flip(device) -> dict:
    """Step 3's data change: P0 compiled against few orders and many
    customers, then the tables replaced by many orders over few customers
    and ``analyze()`` run: the stats version moves, the next compile misses
    the cache and its winner flips."""
    small = make_orders_customer_db(200, 7300, device=device)
    session = CobraSession(small, CostCatalog(SLOW_REMOTE),
                           config=OptimizerConfig.preset("paper-exp1-3"))
    before = session.trace(p0, name="P0", relations=RELATIONS)
    grown = make_orders_customer_db(20000, 1000, device=device)
    small.replace_table(grown.table("orders"))
    small.replace_table(grown.table("customer"))
    small.analyze()
    after = session.compile(before.source)
    return {"before": plan_kind(before), "after": plan_kind(after),
            "recompiled": not after.from_cache,
            "flipped": plan_kind(before) != plan_kind(after)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the tables' device: the card by default, or cpu")
    args = ap.parse_args(argv)
    figures = {"cells": []}
    for n_orders, n_cust, label in [(200, 7300, "few orders, many customers"),
                                    (20000, 1000, "many orders, few customers")]:
        db = make_orders_customer_db(n_orders, n_cust, device=args.device)
        session = CobraSession(db, CostCatalog(SLOW_REMOTE),
                               config=OptimizerConfig.preset("paper-exp1-3"))
        print(f"\n=== {label}: orders={n_orders} customers={n_cust} "
              f"(slow remote network) ===")

        exe = session.trace(p0, name="P0", relations=RELATIONS)
        baseline = exe.run_baseline()
        print(f"original P0 (N+1 selects):      {baseline.simulated_s:8.2f}s "
              f"simulated, {baseline.n_queries} queries")

        opt = exe.run()
        kind = plan_kind(exe)
        print(f"Cobra chose {kind:20s}: {opt.simulated_s:8.2f}s "
              f"(est {exe.est_cost_s:.2f}s, optimized in "
              f"{exe.result.opt_time_s*1e3:.0f}ms)")

        # full rule set (beyond-paper T3∘T4j projection-pushed join)
        exe_full = session.compile(exe.source,
                                   config=OptimizerConfig.preset("full"))
        full = exe_full.run()
        print(f"Cobra, full rule set (T3∘T4j):  {full.simulated_s:8.2f}s")

        # compile-once / execute-many: second compile is a cache hit
        again = session.compile(exe.source)
        assert again.from_cache, "repeated compile must hit the plan cache"
        t = session.telemetry
        print(f"plan cache: {t['cache_hits']} hit(s), "
              f"{t['memo_runs']} memo run(s) for {t['compile_calls']} compiles")

        assert baseline["result"] == opt["result"] == full["result"], \
            "all rewrites must be semantics-preserving"
        print(f"results identical across all programs "
              f"({len(baseline['result'])} rows) — speedup "
              f"{baseline.simulated_s/opt.simulated_s:.0f}x / "
              f"{baseline.simulated_s/full.simulated_s:.0f}x")
        figures["cells"].append({
            "orders": n_orders, "customers": n_cust, "plan": kind,
            "baseline_simulated_s": baseline.simulated_s,
            "simulated_s": opt.simulated_s,
            "full_simulated_s": full.simulated_s,
            "baseline_queries": baseline.n_queries,
            "cache_hits": t["cache_hits"], "memo_runs": t["memo_runs"],
            "compile_calls": t["compile_calls"],
            "rows": len(baseline["result"]), "identical": True,
            "opt_time_s": exe.result.opt_time_s})

    # ---- while + early exit (beyond the paper's builder coverage) ---------
    print("\n=== while + break: per-state SCAN over tasks ===")
    session = CobraSession(make_wilos_db(3000, device=args.device),
                           CostCatalog(SLOW_REMOTE))
    exe = session.trace(scan, name="SCAN")
    base = exe.run_baseline(threshold=20000.0)
    opt = exe.run(threshold=20000.0)
    assert "scalarQuery" in repr(exe.program.body), \
        "the aggregation inside the while body should move into SQL"
    print(f"original (row-at-a-time σ loops): {base.simulated_s:6.2f}s, "
          f"stopped after {base['state']} state(s)")
    print(f"rewritten (correlated SELECT SUM): {opt.simulated_s:6.2f}s — "
          f"{exe.report.describe()}")
    assert base["state"] == opt["state"]
    figures["scan"] = {"baseline_simulated_s": base.simulated_s,
                       "simulated_s": opt.simulated_s,
                       "states": opt["state"]}
    figures["analyze_flip"] = analyze_flip(args.device)
    return figures


if __name__ == "__main__":
    main()
