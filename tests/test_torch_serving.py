"""The port's serving loop, feedback controller and plan diagnostics against
the JAX package, on the same data.

Each scenario runs in both packages: the reference's tables are carried
across to the port as numpy (``_torch_parity.carry``, port on the CPU), and
where the compiled tier's counters are compared the reference runs with its
Pallas dispatch on (``reference_pallas``). Port and reference must agree on:

  * the drift events (sql, ratio, kind, tables), ``recompiles``, each
    recompiled ``program.body.key()`` and the swap guard's ``swap_log``;
  * the responses (integers exact, fp32 aggregates within ``rtol=1e-5``)
    and the simulated clock;
  * the ``scan_plan`` signals before and after the rewrite;
  * the ``explain()`` text, apart from its wall-time fields;
  * ``render_triage`` of the fleet.

The classes mirror the serving, feedback and wall-clock-drift tests of
``tests/test_runtime.py`` and the signals, explain and triage tests of
``tests/test_obs.py``.
"""

import re
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")

import repro.programs as RP  # noqa: E402
import repro_torch.programs as TP  # noqa: E402
from _torch_parity import assert_values_match, carry, reference_pallas  # noqa: E402
from repro.api import CobraSession as RefSession  # noqa: E402
from repro.api import ExecutionContext as RefContext  # noqa: E402
from repro.api import OptimizerConfig as RefConfig  # noqa: E402
from repro.api.cache import program_param_sites as ref_param_sites  # noqa: E402
from repro.core import CostCatalog as RefCatalog  # noqa: E402
from repro.core import LoopRegion as RefLoopRegion  # noqa: E402
from repro.core import WhileRegion as RefWhileRegion  # noqa: E402
from repro.core import loop_site_key as ref_loop_site_key  # noqa: E402
from repro.core import while_site_key as ref_while_site_key  # noqa: E402
from repro.core.context import StatsProfile as RefStatsProfile  # noqa: E402
from repro.core.cost import CostModel as RefCostModel  # noqa: E402
from repro.obs import render_triage as ref_render_triage  # noqa: E402
from repro.obs import scan_plan as ref_scan_plan  # noqa: E402
from repro.relational.algebra import Scan as RefScan  # noqa: E402
from repro.relational.database import FAST_LOCAL as REF_FAST  # noqa: E402
from repro.relational.database import SLOW_REMOTE as REF_SLOW  # noqa: E402
from repro.runtime import FeedbackController as RefFeedback  # noqa: E402
from repro.runtime import ServingRuntime as RefRuntime  # noqa: E402
from repro.runtime import serve as ref_serve  # noqa: E402
from repro_torch.api import CobraSession, ExecutionContext, OptimizerConfig  # noqa: E402
from repro_torch.api import lift_program  # noqa: E402
from repro_torch.api.cache import program_param_sites  # noqa: E402
from repro_torch.api.lift import update_row  # noqa: E402
from repro_torch.core import CostCatalog, LoopRegion, WhileRegion  # noqa: E402
from repro_torch.core import loop_site_key, while_site_key  # noqa: E402
from repro_torch.core.context import StatsProfile  # noqa: E402
from repro_torch.core.cost import CostModel  # noqa: E402
from repro_torch.obs import explain_plan, render_triage, scan_plan  # noqa: E402
from repro_torch.obs import triage_fleet  # noqa: E402
from repro_torch.relational.algebra import Scan  # noqa: E402
from repro_torch.relational.database import FAST_LOCAL, SLOW_REMOTE  # noqa: E402
from repro_torch.runtime import FeedbackController, ServingRuntime, serve  # noqa: E402

# the two packages behind one vocabulary, so a scenario is written once
REF = SimpleNamespace(
    name="ref", P=RP, Session=RefSession, Config=RefConfig,
    Catalog=RefCatalog, Context=RefContext, Runtime=RefRuntime,
    Feedback=RefFeedback, serve=ref_serve, scan_plan=ref_scan_plan,
    render_triage=ref_render_triage, StatsProfile=RefStatsProfile,
    param_sites=ref_param_sites, CostModel=RefCostModel, Scan=RefScan,
    LoopRegion=RefLoopRegion, WhileRegion=RefWhileRegion,
    loop_site_key=ref_loop_site_key, while_site_key=ref_while_site_key,
    nets={"slow": REF_SLOW, "fast": REF_FAST})
PORT = SimpleNamespace(
    name="port", P=TP, Session=CobraSession, Config=OptimizerConfig,
    Catalog=CostCatalog, Context=ExecutionContext, Runtime=ServingRuntime,
    Feedback=FeedbackController, serve=serve, scan_plan=scan_plan,
    render_triage=render_triage, StatsProfile=StatsProfile,
    param_sites=program_param_sites, CostModel=CostModel, Scan=Scan,
    LoopRegion=LoopRegion, WhileRegion=WhileRegion,
    loop_site_key=loop_site_key, while_site_key=while_site_key,
    nets={"slow": SLOW_REMOTE, "fast": FAST_LOCAL})
SIDES = (REF, PORT)


def make_db(side, maker, *args, **kw):
    """The reference database factory's rows, in ``side``'s package."""
    db = getattr(RP, maker)(*args, **kw)
    return db if side is REF else carry(db)


def paper_session(side, db, net="slow", **kw):
    return side.Session(db, side.Catalog(side.nets[net]),
                        config=side.Config.preset("paper-exp1-3"), **kw)


def signals(found):
    return [(s.kind, s.severity, s.site, s.detail, s.program) for s in found]


def events(fb):
    return [(e.sql, e.tables, e.est_rows, e.observed_rows, e.ratio, e.kind,
             e.est_s, e.observed_s) for e in fb.events]


def without_wall_times(text):
    """EXPLAIN text minus its wall-clock fields: the compile's own time in
    the header and the optimizer's per-phase times."""
    text = re.sub(r"alternatives \([0-9.]+ms, ", "alternatives (<t>, ", text)
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith("  optimizer phases: "))


def find(region, cls):
    if isinstance(region, cls):
        return region
    for c in region.children():
        hit = find(c, cls)
        if hit is not None:
            return hit
    return None


# --------------------------------------------------------------------------
# Feedback-driven re-optimization through the serving loop
# --------------------------------------------------------------------------

def drift_serve(side, compile_hot_plans=None, n_requests=8):
    """Compile P0 against 100 orders / 5000 customers, bulk-load the
    4000 / 500 profile WITHOUT analyze, serve ``n_requests`` P0 requests
    in batches of 4. Returns (runtime, responses, plan keys before and
    after, database)."""
    db = make_db(side, "make_orders_customer_db", 100, 5000)
    session = paper_session(side, db)
    grown = make_db(side, "make_orders_customer_db", 4000, 500)
    rt = side.Runtime(session, batch_size=4, drift_threshold=3.0,
                      compile_hot_plans=compile_hot_plans)
    rt.register(side.P.make_p0())
    assert "JOIN" in repr(rt.executable("P0").program.body)
    before = rt.executable("P0").program.body.key()
    db.replace_table(grown.table("orders"))
    db.replace_table(grown.table("customer"))
    out = rt.serve([("P0", {})] * n_requests)
    return rt, out, (before, rt.executable("P0").program.body.key()), db


class TestServingParity:
    @pytest.mark.parametrize("compile_hot_plans", [None, 2])
    def test_drift_flip_matches_reference(self, compile_hot_plans):
        with reference_pallas():
            ref = drift_serve(REF, compile_hot_plans)
        port = drift_serve(PORT, compile_hot_plans)
        (r_rt, r_out, r_keys, _), (p_rt, p_out, p_keys, _) = ref, port
        assert p_keys == r_keys and p_keys[0] != p_keys[1]
        assert "prefetch" in repr(p_rt.executable("P0").program.body)
        assert p_rt.recompiles == r_rt.recompiles >= 1
        assert events(p_rt.feedback) == events(r_rt.feedback)
        assert p_rt.feedback.swap_log == r_rt.feedback.swap_log
        assert p_rt.simulated_s == r_rt.simulated_s
        assert p_rt.n_round_trips == r_rt.n_round_trips
        for i, (a, b) in enumerate(zip(r_out, p_out)):
            assert_values_match(a.outputs, b.outputs, f"request {i}")
        if compile_hot_plans:
            keep = ("compiles", "compiled_batches", "interpreted_batches",
                    "noop_lowerings")
            assert {k: p_rt.compiler.telemetry()[k] for k in keep} == \
                {k: r_rt.compiler.telemetry()[k] for k in keep}
            assert p_rt.compiler.compiled_batches > 0

    def test_recompiled_plan_computes_the_right_answer(self):
        rt, out, _, db = drift_serve(PORT)
        base = rt.session.execute(TP.make_p0())
        final = rt.executable("P0").run()
        assert sorted(final["result"]) == sorted(base["result"])
        orders, customer = db.table("orders"), db.table("customer")
        year = dict(zip(customer.host("c_customer_sk").tolist(),
                        customer.host("c_birth_year").tolist()))
        want = [o + 2 * year[c] for o, c in zip(
            orders.host("o_id").tolist(), orders.host("o_customer_sk").tolist())]
        assert out[-1]["result"] == want

    def test_no_drift_no_recompile(self):
        outs = {}
        for side in SIDES:
            rt = side.Runtime(paper_session(
                side, make_db(side, "make_orders_customer_db", 200, 100)),
                batch_size=4)
            rt.register(side.P.make_p0())
            outs[side.name] = rt.serve([("P0", {})] * 8)
            assert rt.recompiles == 0 and rt.feedback.refreshes == 0
        for a, b in zip(outs["ref"], outs["port"]):
            assert_values_match(a.outputs, b.outputs)

    def test_unrelated_program_stays_hot_through_drift(self):
        memo = {}
        for side in SIDES:
            db = make_db(side, "make_orders_customer_db", 100, 5000)
            db.add_table(make_db(side, "make_sales_db", 300).table("sales"))
            session = paper_session(side, db)
            rt = side.Runtime(session, batch_size=4, drift_threshold=3.0)
            rt.register(side.P.make_p0())
            rt.register(side.P.make_m0())
            registered = session.memo_runs
            grown = make_db(side, "make_orders_customer_db", 4000, 500)
            db.replace_table(grown.table("orders"))
            db.replace_table(grown.table("customer"))
            rt.serve([("P0", {}), ("M0", {})] * 3)
            assert rt.recompiles >= 1
            assert session.memo_runs == registered + rt.recompiles
            assert session.compile(side.P.make_m0(),
                                   context=rt.current_context()).from_cache
            memo[side.name] = (registered, session.memo_runs, rt.recompiles)
        assert memo["port"] == memo["ref"]

    def test_serve_preserves_request_order_across_programs(self):
        outs = {}
        for side in SIDES:
            db = make_db(side, "make_orders_customer_db", 100, 50)
            db.add_table(make_db(side, "make_sales_db", 100).table("sales"))
            responses, rt = side.serve(
                paper_session(side, db), [side.P.make_p0(), side.P.make_m0()],
                [("P0", {}), ("M0", {}), ("P0", {})], batch_size=2)
            assert len(responses) == 3 and rt.requests_served == 3
            assert "result" in responses[0] and "total" in responses[1]
            outs[side.name] = [r.outputs for r in responses]
        assert_values_match(outs["ref"], outs["port"])

    def test_telemetry_matches_reference(self):
        tele = {}
        for side in SIDES:
            rt = drift_serve(side)[0]
            t = rt.telemetry()
            tele[side.name] = {k: v for k, v in t.items()
                               if not k.endswith(("_s", "wall_s", "_seconds"))
                               or k == "simulated_s"}
        for k in ("requests_served", "batches_run", "recompiles",
                  "context_recompiles", "swaps_rejected", "simulated_s",
                  "round_trips", "context", "programs",
                  "feedback_drift_events", "feedback_stats_refreshes",
                  "feedback_analyzes_fired", "feedback_swap_checks",
                  "feedback_swaps_accepted"):
            assert tele["port"][k] == tele["ref"][k], k


class TestFeedbackController:
    def test_controller_detects_cardinality_drift(self):
        seen = {}
        for side in SIDES:
            db = make_db(side, "make_orders_customer_db", 100, 5000)
            session = paper_session(side, db)
            exe = session.compile(side.P.make_p0())
            grown = make_db(side, "make_orders_customer_db", 4000, 500)
            db.replace_table(grown.table("orders"))
            db.replace_table(grown.table("customer"))
            batch = exe.run_batch([{}] * 2)
            fb = side.Feedback(session, drift_threshold=3.0)
            drifted = fb.observe(batch.observations)
            assert "orders" in drifted
            assert fb.events and fb.events[0].ratio > 3.0
            assert fb.telemetry()["drift_events"] >= 1
            seen[side.name] = (drifted, events(fb),
                               fb.telemetry()["qerror_sites"])
        assert seen["port"] == seen["ref"]

    def test_refresh_is_targeted_and_single_fires(self):
        counts = {}
        for side in SIDES:
            db = make_db(side, "make_orders_customer_db", 100, 5000)
            session = paper_session(side, db)
            db.replace_table(make_db(side, "make_orders_customer_db", 4000,
                                     500).table("orders"))
            fb = side.Feedback(session)
            fb.refresh(["orders"])
            fb.refresh(["orders"])          # same data epoch: deduplicated
            counts[side.name] = (fb.analyzes_fired, fb.analyzes_deduped,
                                 fb.refreshes, db.stats("orders").nrows)
        assert counts["port"] == counts["ref"] == (1, 1, 1, 4000)

    def test_query_tables_helper(self):
        from repro_torch.api import q, query_tables
        h = q("orders").join("customer", "o_customer_sk", "c_customer_sk")
        assert query_tables(h.query) == ("customer", "orders")


# --------------------------------------------------------------------------
# Observed iteration counts
# --------------------------------------------------------------------------

class TestIterationObservations:
    def _scan_setup(self, side):
        session = paper_session(side, make_db(side, "make_wilos_db", 200,
                                              ratio=10))
        return session, session.compile(side.P.make_scan())

    def test_run_batch_logs_while_iterations(self):
        counts = {}
        for side in SIDES:
            _, exe = self._scan_setup(side)
            site = side.while_site_key(find(exe.source.body,
                                            side.WhileRegion).pred)
            batch = exe.run_batch([{"threshold": 1e9}] * 3)
            counts[side.name] = (site, [n for s, n in
                                        batch.iteration_observations
                                        if s == site])
        assert counts["port"] == counts["ref"]
        assert counts["port"][1] == [5, 5, 5]

    def test_controller_records_iterations_in_telemetry(self):
        tele = {}
        for side in SIDES:
            session, exe = self._scan_setup(side)
            fb = side.Feedback(session)
            batch = exe.run_batch([{"threshold": 1e9}] * 2)
            fb.observe_iterations(batch.iteration_observations)
            t = fb.telemetry()
            (site_stats,) = t["iteration_sites"].values()
            assert site_stats["n"] == 2
            assert site_stats["avg_iters"] == pytest.approx(5.0)
            assert t["iters_publishes"] == 1
            tele[side.name] = (t["iteration_sites"],
                               fb.stats_profile().iters)
        assert tele["port"] == tele["ref"]

    def test_publish_hysteresis(self):
        session, _ = self._scan_setup(PORT)
        fb = FeedbackController(session)
        assert fb.observe_iterations([("loop:site", 10)])          # first
        assert not fb.observe_iterations([("loop:site", 11)])      # in band
        assert fb.stats_profile().iters_for("loop:site") == \
            pytest.approx(10.0)
        assert fb.observe_iterations([("loop:site", 100)] * 10)
        assert fb.stats_profile().iters_for("loop:site") > 50

    def test_worklist_loop_length_recorded(self):
        obs = {}
        for side in SIDES:
            session = paper_session(side, make_db(side, "make_wilos_db", 200,
                                                  ratio=10))
            exe = session.compile(side.P.make_wilos_e())
            loop = find(exe.source.body, side.LoopRegion)
            site = side.loop_site_key(loop.var, loop.source)
            batch = exe.run_batch([{"worklist": [1, 2, 3]}])
            assert (site, 3) in batch.iteration_observations
            obs[side.name] = batch.iteration_observations
        assert obs["port"] == obs["ref"]

    def test_sequential_fallback_still_records_iterations(self):
        def f(worklist=()):
            for wid in worklist:
                update_row("roles", "r_rank", 1, "r_id", wid)

        session = paper_session(PORT, make_db(PORT, "make_wilos_db", 100,
                                              ratio=10))
        exe = session.compile(lift_program(f))
        batch = exe.run_batch([{"worklist": [1, 2, 3, 4]}])
        assert not batch.batched                 # update -> sequential path
        loop = find(exe.source.body, LoopRegion)
        assert (loop_site_key(loop.var, loop.source), 4) in \
            batch.iteration_observations

    def test_publish_threshold_validation(self):
        session, _ = self._scan_setup(PORT)
        with pytest.raises(ValueError, match="iters_publish_threshold"):
            FeedbackController(session, iters_publish_threshold=1.0)


# --------------------------------------------------------------------------
# Wall-clock drift (observed time against the modeled query cost)
# --------------------------------------------------------------------------

class TestWallClockDrift:
    def _fb(self, side, **kw):
        session = paper_session(side, make_db(side, "make_sales_db", 500))
        return session, side.Feedback(session, drift_threshold=3.0, **kw)

    def test_wall_clock_drift_flags_tables(self):
        seen = {}
        for side in SIDES:
            session, fb = self._fb(side, cost_drift_threshold=5.0)
            query = side.Scan("sales")
            est_rows = session.db.estimate(query).n_rows
            est_s = side.CostModel(session.db, session.catalog).query_cost(query)
            assert fb.observe([(query, int(est_rows), est_s * 20.0)]) == \
                ["sales"]
            (event,) = fb.events
            assert event.kind == "wall_clock"
            assert event.ratio == pytest.approx(20.0, rel=1e-6)
            assert "wall-clock" in event.describe()
            assert fb.telemetry()["drift_events_wall_clock"] == 1
            seen[side.name] = (events(fb), event.describe())
        assert seen["port"] == seen["ref"]

    def test_in_band_wall_clock_is_quiet(self):
        session, fb = self._fb(PORT, cost_drift_threshold=5.0)
        query = Scan("sales")
        est_rows = session.db.estimate(query).n_rows
        est_s = CostModel(session.db, session.catalog).query_cost(query)
        assert fb.observe([(query, int(est_rows), est_s * 1.5)]) == []
        assert not fb.events

    def test_row_drift_takes_precedence_no_double_event(self):
        seen = {}
        for side in SIDES:
            session, fb = self._fb(side, cost_drift_threshold=5.0)
            query = side.Scan("sales")
            est_rows = session.db.estimate(query).n_rows
            assert fb.observe([(query, int(est_rows) * 10, 1e9)]) == ["sales"]
            assert len(fb.events) == 1 and fb.events[0].kind == "rows"
            seen[side.name] = events(fb)
        assert seen["port"] == seen["ref"]

    def test_wall_clock_drift_disabled_with_none(self):
        session, fb = self._fb(PORT, cost_drift_threshold=None)
        query = Scan("sales")
        est_rows = session.db.estimate(query).n_rows
        assert fb.observe([(query, int(est_rows), 1e9)]) == []

    def test_threshold_validation(self):
        session, _ = self._fb(PORT)
        with pytest.raises(ValueError, match="cost_drift_threshold"):
            FeedbackController(session, cost_drift_threshold=0.5)

    def test_serving_runtime_plumbs_cost_threshold(self):
        session, _ = self._fb(PORT)
        assert ServingRuntime(session, cost_drift_threshold=7.0
                              ).feedback.cost_drift_threshold == 7.0
        assert ServingRuntime(session, cost_drift_threshold=None
                              ).feedback.cost_drift_threshold is None

    def test_observed_wall_is_the_simulated_clock(self):
        """The serving path feeds the simulated query cost as ``wall_s``, so
        a drift decision is the same in both packages, run after run."""
        seen = {}
        for side in SIDES:
            rt = drift_serve(side)[0]
            seen[side.name] = (rt.feedback.observed_wall_s,
                               rt.feedback.telemetry()["sites"])
        assert seen["port"] == seen["ref"]


# --------------------------------------------------------------------------
# Bad-plan signals: detected as written, gone after the rewrite
# --------------------------------------------------------------------------

class TestScanPlan:
    @pytest.mark.parametrize("maker", ["make_p0", "make_scan", "make_wilos_a",
                                       "make_wilos_e", "make_m0"])
    def test_signals_as_written_match_reference(self, maker):
        ref = ref_scan_plan(getattr(RP, maker)())
        port = scan_plan(getattr(TP, maker)())
        assert signals(port) == signals(ref)

    def test_p0_n_plus_one_detected_then_rewritten_away(self):
        found = scan_plan(TP.make_p0())
        assert [s.kind for s in found] == ["n_plus_one"]
        assert found[0].severity == pytest.approx(0.8)
        session = paper_session(PORT, make_db(PORT, "make_orders_customer_db",
                                              300, 600))
        assert session.compile(TP.make_p0()).scan() == []

    def test_scan_query_in_while_detected_then_rewritten_away(self):
        assert {s.kind for s in scan_plan(TP.make_scan())} == \
            {"query_in_while"}
        after = {}
        for side in SIDES:
            session = paper_session(side, make_db(side, "make_wilos_db", 300,
                                                  ratio=10))
            exe = session.compile(side.P.make_scan(),
                                  context=side.Context(batch_size=16))
            assert "prefetch" in repr(exe.program.body)
            after[side.name] = signals(exe.scan())
        assert after["port"] == after["ref"] == []

    def test_wilos_e_n_plus_one_then_prefetch_rewrite(self):
        assert "n_plus_one" in {s.kind for s in scan_plan(TP.make_wilos_e())}
        session = paper_session(PORT, make_db(PORT, "make_wilos_db", 300,
                                              ratio=10), "fast")
        exe = session.compile(TP.make_wilos_e(),
                              context=ExecutionContext(batch_size=64))
        assert "prefetch" in repr(exe.program.body)
        assert exe.scan() == []

    def test_diverse_bindings_from_observed_stats(self):
        for side in SIDES:
            we = side.P.make_wilos_e()
            groups = side.param_sites(we)
            assert groups
            hostile = side.StatsProfile.of(bindings={g: 1.0 for g in groups})
            assert "diverse_bindings" in {
                s.kind for s in side.scan_plan(we, stats=hostile)}
            friendly = side.StatsProfile.of(bindings={g: 0.1 for g in groups})
            assert "diverse_bindings" not in {
                s.kind for s in side.scan_plan(we, stats=friendly)}
        assert program_param_sites(TP.make_wilos_e()) == \
            ref_param_sites(RP.make_wilos_e())

    def test_interpreter_hot_loop_needs_heat(self):
        session = paper_session(PORT, make_db(PORT, "make_wilos_db", 200,
                                              ratio=10))
        exe = session.compile(TP.make_wilos_a())
        assert "interpreter_hot_loop" not in {s.kind for s in exe.scan()}
        for _ in range(3):
            exe.run()
        assert "interpreter_hot_loop" in {s.kind for s in exe.scan()}

    def test_signals_rank_most_severe_first(self):
        sigs = scan_plan(TP.make_wilos_a())
        assert [s.severity for s in sigs] == \
            sorted((s.severity for s in sigs), reverse=True)


# --------------------------------------------------------------------------
# EXPLAIN, the PlanReport's tier and swap fields, fleet triage
# --------------------------------------------------------------------------

class TestExplainAndTriage:
    def test_explain_we_matches_reference(self):
        texts = {}
        for side in SIDES:
            session = paper_session(side, make_db(side, "make_wilos_db", 300,
                                                  ratio=10), "fast")
            rt = side.Runtime(session, batch_size=8, drift_threshold=1e9)
            rt.register(side.P.make_wilos_e())
            rt.serve([("W_E", {"worklist": [i % 4]}) for i in range(16)])
            texts[side.name] = rt.explain("W_E")
        text = texts["port"]
        assert "EXPLAIN W_E" in text
        assert "rules fired (winning plan):" in text
        assert "est " in text and "observed " in text and "q-error" in text
        assert "tier: interpreter" in text
        assert without_wall_times(text) == without_wall_times(texts["ref"])

    def test_explain_and_scan_on_a_one_shot_executable(self):
        session = paper_session(PORT, make_db(PORT, "make_orders_customer_db",
                                              300, 600))
        exe = session.compile(TP.make_p0())
        assert exe.explain() == explain_plan(exe)
        assert exe.explain().startswith("EXPLAIN P0")
        ref_exe = paper_session(REF, make_db(
            REF, "make_orders_customer_db", 300, 600)).compile(RP.make_p0())
        assert without_wall_times(exe.explain()) == \
            without_wall_times(ref_exe.explain())

    def test_report_tier_after_hot_promotion(self):
        session = paper_session(PORT, make_db(PORT, "make_orders_customer_db",
                                              300, 30), "fast")
        rt = ServingRuntime(session, batch_size=8, compile_hot_plans=2)
        rt.register(TP.make_p0())
        exe = rt.executable("P0")
        assert exe.report.tier == "interpreter"
        rt.serve([("P0", {})] * 24)
        assert exe.report.tier == "compiled"
        assert "tier: compiled" in rt.explain("P0")

    def test_report_swap_fields_after_drift(self):
        texts = {}
        for side in SIDES:
            rt = drift_serve(side)[0]
            r = rt.executable("P0").report
            assert r.swap_checked and r.swap_accepted is True
            assert r.swap_replayed > 0
            texts[side.name] = rt.explain("P0")
            assert "swap-guard accepted" in texts[side.name]
        assert without_wall_times(texts["port"]) == \
            without_wall_times(texts["ref"])

    def test_triage_ranks_by_traffic_weighted_win(self):
        tables = {}
        for side in SIDES:
            db = make_db(side, "make_orders_customer_db", 100, 5000)
            db.add_table(make_db(side, "make_sales_db", 300).table("sales"))
            session = paper_session(side, db)
            rt = side.Runtime(session, batch_size=4, drift_threshold=3.0)
            rt.register(side.P.make_p0())
            rt.register(side.P.make_m0())
            grown = make_db(side, "make_orders_customer_db", 4000, 500)
            db.replace_table(grown.table("orders"))
            db.replace_table(grown.table("customer"))
            rt.serve([("P0", {})] * 8 + [("M0", {})] * 4)
            rows = rt.triage()
            assert [r.name for r in rows][0] == "P0"
            p0, m0 = rows[0], next(r for r in rows if r.name == "M0")
            assert p0.drift > 3.0 and m0.drift == 1.0 and p0.score > m0.score
            assert abs(sum(r.share for r in rows) - 1.0) < 1e-9
            tables[side.name] = side.render_triage(rows)
        assert tables["port"].splitlines()[0].startswith("| program |")
        assert tables["port"] == tables["ref"]

    def test_triage_fleet_is_the_runtime_view(self):
        rt = drift_serve(PORT)[0]
        assert triage_fleet(rt) == rt.triage()
        assert "score" in rt.triage()[0].describe()

