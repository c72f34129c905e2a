"""Serving walkthrough on the card: batched execution, persistent plans,
feedback, with the PyTorch port (``repro_torch``).

    PYTHONPATH=src python examples/serve_programs_torch.py               # card
    PYTHONPATH=src python examples/serve_programs_torch.py --device cpu

The twin of ``examples/serve_programs.py``: the same acts, sizes, programs
and printed lines, every table on ``--device`` (the card by default;
without CUDA only ``--device cpu`` runs, and the default raises). On the
card the compiled tier's probes and folds run the port's CUDA kernels.
``main(argv)`` also returns the figures it prints (memo runs, store hits,
round trips, the drift flip, the tiers, the hot shard).

Three acts:

  1. **Cold start + warm start.** Session A compiles P0 and M0 into a
     shared ``PlanStore`` directory. Session B — a "new process" — opens
     the same store and compiles both programs WITHOUT running the memo
     search (cross-session cache hits).
  2. **Batched serving.** A ``ServingRuntime`` processes a mixed request
     stream; each batch pays one server round trip per query site instead
     of one per request, so simulated throughput scales with batch size.
     Registration compiles under the runtime's ``ExecutionContext``
     (batch_size=16), so SCAN — a while/early-exit program lifted from
     plain Python — gets a DIFFERENT plan than a one-shot compile: the
     batch-amortized prefetch beats the per-iteration aggregate query.
     Each request's ``threshold`` parameter still makes every invocation
     stop after a different number of rounds, even mid-batch.
  3. **Drift + re-optimization.** A bulk load grows ``orders`` 40x without
     ANALYZE. The feedback controller notices observed cardinalities
     leaving the estimated band, re-analyzes only the drifted tables, and
     recompiles P0 — whose winning plan flips from P1 (join) to P2
     (prefetch). M0's plan (sales only) stays hot throughout. Before the
     new plan replaces the running one, the anti-regression guard replays
     the last observed bindings against both.
  4. **Hot promotion to the compiled tier.** A runtime with
     ``compile_hot_plans=24`` serves the same P0 stream: the first batch
     is interpreted (heat below threshold), the pair goes hot mid-stream,
     and every later batch runs the kernel-backed columnar executable —
     same outputs, same simulated clock, less wall time per batch.
  5. **Observability.** ``rt.explain("P0")`` renders the drift-flipped
     plan with its rewrite provenance, estimated-vs-observed counts and
     q-errors, cache/binding status, and any bad-plan signals still
     present; ``rt.triage()`` ranks the whole fleet by traffic-weighted
     estimated win so re-optimization effort follows the requests.
  6. **Sharded cluster + hot-shard triage.** A 4-worker
     ``ClusterRuntime`` partitions ``tasks`` by ``t_role_id`` and routes
     W_E requests by their worklist key. A uniform key stream spreads
     across the fleet; a skewed stream (every key a multiple of 4) pins
     ALL the work on worker 0 — cluster ``triage()`` grows per-shard
     request columns and flags the hot shard with its skew factor.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.api import CobraSession, OptimizerConfig
from repro_torch.core import CostCatalog
from repro_torch.programs import (make_m0, make_orders_customer_db, make_p0,
                                  make_sales_db, make_scan, make_wilos_db)
from repro_torch.relational.database import SLOW_REMOTE
from repro_torch.runtime import PlanStore, ServingRuntime


def make_db(device=None):
    # all served programs are plain Python functions lifted to Region IR
    # (repro_torch.programs) — one simulated server hosts every table they
    # touch
    db = make_orders_customer_db(100, 5000, device=device)
    db.add_table(make_sales_db(800, device=device).table("sales"))
    wilos = make_wilos_db(2000, device=device)
    db.add_table(wilos.table("tasks"))
    db.add_table(wilos.table("roles"))
    return db


def fresh_session(store, device=None):
    return CobraSession(make_db(device), CostCatalog(SLOW_REMOTE),
                        config=OptimizerConfig.preset("paper-exp1-3"),
                        plan_store=store)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the tables' device: the card by default, or cpu")
    dev = ap.parse_args(argv).device
    figures = {}
    store_dir = tempfile.mkdtemp(prefix="cobra_plans_")
    store = PlanStore(store_dir)

    # ---- act 1: compile once, reuse across sessions -----------------------
    print(f"=== plan store at {store_dir} ===")
    session_a = fresh_session(store, dev)
    session_a.compile(make_p0())
    session_a.compile(make_m0())
    print(f"session A: {session_a.memo_runs} memo run(s), "
          f"{store.puts} plan(s) persisted")

    session_b = fresh_session(store, dev)
    exe_p0 = session_b.compile(make_p0())
    exe_m0 = session_b.compile(make_m0())
    assert exe_p0.from_cache and exe_m0.from_cache
    print(f"session B: {session_b.memo_runs} memo run(s) — both programs "
          f"warm from the store ({store.hits} hit(s))")
    print(f"  P0 plan: {exe_p0.describe()}")
    figures["store"] = {"session_a_memo_runs": session_a.memo_runs,
                        "puts": store.puts,
                        "session_b_memo_runs": session_b.memo_runs,
                        "hits": store.hits}

    # ---- act 2: batched serving ------------------------------------------
    rt = ServingRuntime(session_b, batch_size=16, drift_threshold=3.0)
    rt.register(make_p0())
    rt.register(make_m0())
    rt.register(make_scan())

    single = rt.executable("P0").run()
    batch = rt.executable("P0").run_batch([{}] * 16)
    print(f"\n=== batched serving (slow remote network) ===")
    print(f"per-invocation P0: {single.simulated_s:6.2f}s simulated/request, "
          f"{single.n_round_trips} round trip(s) each")
    print(f"batch of 16:       {batch.simulated_s / 16:6.2f}s/request, "
          f"{batch.n_round_trips} round trip(s) total "
          f"({16 / batch.simulated_s:.1f} req/s vs "
          f"{1 / single.simulated_s:.1f} req/s)")

    responses = rt.serve([("P0", {}), ("M0", {})] * 8)
    print(f"served {len(responses)} mixed requests in {rt.batches_run} "
          f"batch(es), {rt.n_round_trips} round trips")

    # the shared SiteCache carries fetches ACROSS batches: replaying the
    # same workload touches the server zero times (one fetch per site per
    # stats epoch, invalidated by analyze()/writes — never stale)
    before = rt.n_round_trips
    rt.serve([("P0", {}), ("M0", {})] * 8)
    print(f"replayed workload: {rt.n_round_trips - before} new round "
          f"trip(s) — {rt.site_cache.describe()}")

    # the serving context changes which plan wins: one-shot SCAN keeps the
    # per-iteration aggregate query, batch-16 SCAN amortizes the prefetch
    one_shot_scan = session_b.compile(make_scan())
    served_scan = rt.executable("SCAN")
    print(f"SCAN one-shot: {one_shot_scan.describe()}")
    print(f"SCAN batch=16: {served_scan.describe()}")
    assert "prefetch" not in repr(one_shot_scan.program.body)
    assert "prefetch" in repr(served_scan.program.body), \
        "the serving context should amortize the in-while prefetch site"

    # SCAN is a while/early-exit program (plain Python `while` + `break`);
    # each request's threshold stops it after a different number of rounds,
    # respected per invocation even inside one shared batch
    scans = rt.serve([("SCAN", {"threshold": th})
                      for th in (100.0, 2e4, 1e9) * 2])
    rounds = sorted({r["state"] for r in scans})
    print(f"SCAN requests stopped after {rounds} round(s) "
          f"(per-invocation early exit inside a shared batch)")
    figures["batching"] = {
        "single_simulated_s": single.simulated_s,
        "batch16_simulated_s": batch.simulated_s,
        "batch16_round_trips": batch.n_round_trips,
        "mixed_requests": len(responses), "batches": rt.batches_run,
        "scan_rounds": rounds,
        "scan_one_shot_prefetch": "prefetch" in repr(
            one_shot_scan.program.body),
        "scan_batch16_prefetch": "prefetch" in repr(
            served_scan.program.body)}

    # ---- act 3: drift-driven re-optimization ------------------------------
    print(f"\n=== bulk load: orders 100 -> 4000 rows, no ANALYZE ===")
    grown = make_orders_customer_db(4000, 500, device=dev)
    session_b.db.replace_table(grown.table("orders"))
    session_b.db.replace_table(grown.table("customer"))

    rt.serve([("P0", {})] * 8 + [("M0", {})] * 4)
    fb = rt.feedback
    print(f"feedback: {len(fb.events)} drift event(s), "
          f"{fb.refreshes} stats refresh(es), {rt.recompiles} recompile(s)")
    if fb.events:
        print(f"  first event: {fb.events[0].describe()}")
    print(f"  P0 now: {rt.executable('P0').describe()}")
    assert "prefetch" in repr(rt.executable("P0").program.body), \
        "fresh statistics should flip P0's winner to the prefetch plan"
    assert session_b.compile(make_m0()).from_cache, \
        "M0 touches only `sales` — its plan must survive the drift"
    print("  M0 plan stayed hot through the drift (per-table stats versions)")
    figures["drift"] = {"events": len(fb.events),
                        "refreshes": fb.refreshes,
                        "recompiles": rt.recompiles,
                        "p0_prefetch": "prefetch" in repr(
                            rt.executable("P0").program.body)}

    t = rt.telemetry()
    print(f"\ntelemetry: {t['requests_served']} requests, "
          f"{t['session_memo_runs']} memo runs total, "
          f"store {t['session_store_hits']} hit(s)/"
          f"{t['session_store_puts']} put(s)")

    # ---- act 4: hot promotion to the compiled tier ------------------------
    # a fresh runtime over the (grown) database: the first 16-request batch
    # stays interpreted (heat 16 < 24), the second crosses the threshold,
    # is lowered ONCE, and every batch from then on runs the kernel-backed
    # columnar executable — bit-identical outputs and simulated clock,
    # smaller wall clock
    print(f"\n=== compiled execution tier (compile_hot_plans=24) ===")
    session_c = fresh_session(store, dev)
    rt_hot = ServingRuntime(session_c, batch_size=16, compile_hot_plans=24)
    rt_hot.register(make_p0())
    # an interpreter-only twin serves the IDENTICAL stream for the
    # bit-identity check (comparing early vs late batches of one stateful
    # stream would conflate tiers with site-cache warmth)
    rt_cold = ServingRuntime(fresh_session(store, dev), batch_size=16)
    walls, tiers, hot_out, cold_out = [], [], [], []
    for _ in range(3):
        before = rt_hot.compiler.compiled_batches
        t0 = time.perf_counter()
        hot_out.extend(rt_hot.serve([("P0", {})] * 16))
        walls.append(time.perf_counter() - t0)
        tiers.append("compiled" if rt_hot.compiler.compiled_batches > before
                     else "interpreter")
    rt_cold.register(make_p0())
    for _ in range(3):
        cold_out.extend(rt_cold.serve([("P0", {})] * 16))
    for i, (wall, tier) in enumerate(zip(walls, tiers)):
        print(f"batch {i + 1}: {tier:>11s} tier, {wall * 1e3:6.1f}ms wall")
    assert tiers[0] == "interpreter" and tiers[-1] == "compiled", \
        "the pair should go hot (and stay hot) mid-stream"
    assert all(a.outputs == b.outputs and a.simulated_s == b.simulated_s
               for a, b in zip(hot_out, cold_out)), \
        "compiled and interpreted serving must be bit-identical"
    ct = rt_hot.compiler.telemetry()
    print(f"compiler: {ct['compiles']} lowering(s) "
          f"({ct['compile_s_total'] * 1e3:.1f}ms), "
          f"{ct['interpreted_batches']} interpreted / "
          f"{ct['compiled_batches']} compiled batch(es), "
          f"backend={ct['backend']}")
    figures["compiled_tier"] = {
        "tiers": tiers, "walls_s": walls,
        "identical": True, "lowerings": ct["compiles"],
        "interpreted_batches": ct["interpreted_batches"],
        "compiled_batches": ct["compiled_batches"]}

    # ---- act 5: observability — EXPLAIN the flipped plan, triage the fleet
    # the drift-era runtime (act 3) has served real traffic: its feedback
    # controller holds observed row/iteration counts, so EXPLAIN can show
    # estimate-vs-observed q-errors per site on the plan the swap guard
    # just accepted
    print(f"\n=== EXPLAIN the drift-flipped P0 plan ===")
    print(rt.explain("P0"))

    from repro_torch.obs import render_triage
    rows = rt.triage()
    print(f"\n=== fleet triage (share x drift x severity) ===")
    print(render_triage(rows))
    print(f"top: {rows[0].describe()}")
    figures["triage_top"] = rows[0].describe()

    # ---- act 6: sharded cluster, skewed fleet, hot-shard triage -----------
    # tasks is hash-partitioned on t_role_id over 4 shard workers; W_E is
    # affinity-routed by its worklist key, so a request's per-key query
    # lands on the worker whose shard holds that key. Distinct keys make
    # real per-request work (repeats would just hit the SiteCache).
    from repro_torch.cluster import ClusterRuntime
    from repro_torch.programs import make_wilos_e

    print(f"\n=== sharded cluster: 4 workers, skewed vs uniform keys ===")
    makespans = {}
    for label, key in (("uniform", lambda i: i),
                       ("skewed", lambda i: 4 * i)):
        cl = ClusterRuntime(make_wilos_db(2000, device=dev), n_workers=4,
                            partition_keys={"tasks": "t_role_id"},
                            affinity={"W_E": "worklist"},
                            deadline_s=0.01, max_batch=8)
        cl.register(make_wilos_e())
        cl.serve([("W_E", {"worklist": [key(i)]}) for i in range(48)])
        makespans[label] = cl.last_makespan_s
        served = [w.requests_served for w in cl.workers]
        print(f"{label:>8s}: worker requests {served}, "
              f"router skew {cl.router.skew():.1f}x, "
              f"makespan {cl.last_makespan_s:.2f}s simulated")
    print(f"skew costs {makespans['skewed'] / makespans['uniform']:.1f}x "
          f"the uniform makespan — and triage points at the hot shard:")
    rows = cl.triage()                      # cl is the skewed cluster
    print(render_triage(rows))
    hot = rows[0]
    assert hot.shard_requests[hot.hot_shard] == 48 and hot.skew == 4.0, \
        "every skewed key is 0 mod 4 — shard 0 must own all 48 requests"
    print(f"hot shard {hot.hot_shard} owns "
          f"{hot.shard_requests[hot.hot_shard]}/48 requests "
          f"({hot.skew:.1f}x its fair share)")
    figures["cluster"] = {"makespans_s": makespans,
                          "hot_shard": hot.hot_shard,
                          "hot_shard_requests":
                              hot.shard_requests[hot.hot_shard],
                          "skew": hot.skew}
    return figures


if __name__ == "__main__":
    main()
