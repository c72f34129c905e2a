"""The port's main path against the JAX package: compile -> batch ->
compiled tier, on the same data.

For every example program, with the default rules and with the empty rule
set (the program as written), the reference and the port compile against
the same rows (the reference's tables carried across as numpy) and must
give:

  * the same rewritten program (``program.body.key()``), estimated cost and
    simulated clock;
  * equal outputs: integers exact, fp32 SQL aggregates within ``rtol=1e-5``
    (XLA and torch reduce in different orders);
  * the same ``kernel_probes`` / ``kernel_folds`` counters, with the
    reference's Pallas kernels on (interpret mode);

and inside the port the compiled tier must equal the interpreted tier bit
for bit and clock for clock.
"""

import pytest

pytest.importorskip("jax")

import repro.programs as RP  # noqa: E402
import repro_torch.programs as TP  # noqa: E402
from _torch_parity import assert_values_match, carry, reference_pallas  # noqa: E402
from repro.api import CobraSession as RefSession  # noqa: E402
from repro.api import OptimizerConfig as RefConfig  # noqa: E402
from repro.api import RuleSet as RefRuleSet  # noqa: E402
from repro.core import CostCatalog as RefCatalog  # noqa: E402
from repro.core import ExecutionContext as RefContext  # noqa: E402
from repro.relational.database import SLOW_REMOTE as REF_SLOW  # noqa: E402
from repro_torch.api import CobraSession, OptimizerConfig, RuleSet  # noqa: E402
from repro_torch.core import CostCatalog, ExecutionContext  # noqa: E402
from repro_torch.relational.database import SLOW_REMOTE  # noqa: E402

# program -> (factory name, reference database factory, parameter sets)
PROGRAMS = {
    "P0": ("make_p0", lambda: RP.make_orders_customer_db(300, 30), [{}] * 2),
    "P1": ("make_p1", lambda: RP.make_orders_customer_db(300, 30), [{}] * 2),
    "P2": ("make_p2", lambda: RP.make_orders_customer_db(300, 30), [{}] * 2),
    "M0": ("make_m0", lambda: RP.make_sales_db(200), [{}] * 2),
    "SCAN": ("make_scan", lambda: RP.make_wilos_db(200), [{}] * 2),
    "W_A": ("make_wilos_a", lambda: RP.make_wilos_db(120), [{}] * 2),
    "W_B": ("make_wilos_b", lambda: RP.make_wilos_db(200), [{}] * 2),
    "W_C": ("make_wilos_c", lambda: RP.make_wilos_db(120), [{}] * 2),
    "W_D": ("make_wilos_d", lambda: RP.make_wilos_db(200), [{}] * 2),
    "W_E": ("make_wilos_e", lambda: RP.make_wilos_db(200),
            [{"worklist": [0, 1, 2]}, {"worklist": [1]}, {"worklist": []}]),
    "W_F": ("make_wilos_f", lambda: RP.make_wilos_db(200), [{}] * 2),
    "SKEW": ("make_skew_probe", lambda: RP.make_skew_db(2000),
             [{"worklist": [0, 1, 2]}, {"worklist": [3]}]),
}
RULES = ("default", "empty")


def ref_config(rules):
    return RefConfig(rule_set=RefRuleSet([])) if rules == "empty" else RefConfig()


def port_config(rules):
    return OptimizerConfig(rule_set=RuleSet([])) if rules == "empty" \
        else OptimizerConfig()


def counters(exe):
    return [(cl.kernel_probes, cl.kernel_folds)
            for cl in exe.lower()._loops.values()]


def assert_batches_identical(a, b):
    """Bit for bit and clock for clock (the compiled-tier contract)."""
    assert a.n_queries == b.n_queries
    assert a.n_round_trips == b.n_round_trips
    assert a.simulated_s == b.simulated_s
    assert len(a.results) == len(b.results)
    for ra, rb in zip(a.results, b.results):
        assert ra.outputs == rb.outputs
        assert ra.simulated_s == rb.simulated_s


def port_run(name, rules, ref_db_rows, tier):
    """Compile and run one program in the port, on a fresh carried copy of
    the reference rows (the update programs write to their database)."""
    make, _, params = PROGRAMS[name]
    db = carry(ref_db_rows)
    exe = CobraSession(db, CostCatalog(SLOW_REMOTE),
                       config=port_config(rules)).compile(getattr(TP, make)())
    return exe, exe.run_batch(params, tier=tier)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_port_matches_reference(name, rules):
    make, mkdb, params = PROGRAMS[name]
    rows = mkdb()                 # the rows both packages compute over
    ref_db = mkdb()               # the reference's own (written) copy
    ref_exe = RefSession(ref_db, RefCatalog(REF_SLOW),
                         config=ref_config(rules)).compile(getattr(RP, make)())
    with reference_pallas():
        ref_batch = ref_exe.run_batch(params, tier="compiled")
    exe, batch = port_run(name, rules, rows, "compiled")

    assert exe.program.body.key() == ref_exe.program.body.key()
    assert exe.est_cost_s == ref_exe.est_cost_s
    assert batch.tier == ref_batch.tier == "compiled"
    assert batch.simulated_s == ref_batch.simulated_s
    assert batch.n_queries == ref_batch.n_queries
    assert batch.n_round_trips == ref_batch.n_round_trips
    for got, want in zip(batch.results, ref_batch.results):
        assert_values_match(want.outputs, got.outputs, name)
    assert counters(exe) == counters(ref_exe)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_port_compiled_equals_interpreted(name, rules):
    rows = PROGRAMS[name][1]()
    _, compiled = port_run(name, rules, rows, "compiled")
    _, interp = port_run(name, rules, rows, "interpreter")
    assert compiled.tier == "compiled" and interp.tier == "interpreter"
    assert_batches_identical(compiled, interp)


@pytest.mark.parametrize("name", ["P0", "P2", "W_B", "W_F"])
def test_numpy_backend_equals_kernels_backend(name, monkeypatch):
    """The ``"numpy"`` backend (``REPRO_COMPILED_BACKEND``) runs the numpy
    twins where the ``"kernels"`` backend runs the kernel wrappers: same
    outputs and clock. As in the reference, only the kernels backend counts
    probes; both count folds."""
    rows = PROGRAMS[name][1]()
    exe, kernels = port_run(name, "empty", rows, "compiled")
    assert {cl.backend for cl in exe.lower()._loops.values()} == {"kernels"}
    assert sum(p + f for p, f in counters(exe)) > 0
    monkeypatch.setenv("REPRO_COMPILED_BACKEND", "numpy")
    exe, numpy_ = port_run(name, "empty", rows, "compiled")
    assert {cl.backend for cl in exe.lower()._loops.values()} == {"numpy"}
    assert sum(p for p, _ in counters(exe)) == 0
    assert_batches_identical(kernels, numpy_)


@pytest.mark.parametrize("batch_size", [1, 64])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_batch_context_plans_match(name, batch_size):
    """Batch-aware costing picks the same plan in both packages."""
    make, mkdb, _ = PROGRAMS[name]
    rows = mkdb()
    ref_exe = RefSession(rows, RefCatalog(REF_SLOW)).compile(
        getattr(RP, make)(), context=RefContext(batch_size=batch_size))
    exe = CobraSession(carry(rows), CostCatalog(SLOW_REMOTE)).compile(
        getattr(TP, make)(), context=ExecutionContext(batch_size=batch_size))
    assert exe.program.body.key() == ref_exe.program.body.key()
    assert exe.est_cost_s == ref_exe.est_cost_s


def test_main_path_kernels_are_reached(monkeypatch):
    """With the program as written, P0's navigation probes and W_B's
    accumulator fold go through the kernel wrappers (the plain versions on
    the CPU), once per request."""
    monkeypatch.delenv("REPRO_COMPILED_BACKEND", raising=False)
    exe, _ = port_run("P0", "empty", PROGRAMS["P0"][1](), "compiled")
    assert counters(exe) == [(2, 0)]
    exe, _ = port_run("W_B", "empty", PROGRAMS["W_B"][1](), "compiled")
    assert counters(exe) == [(0, 2)]


@pytest.mark.parametrize("rules", RULES)
def test_mid_stream_analyze_and_write(rules):
    """An ``analyze()`` and a table write between compiled batches: the
    port's compiled tier equals its interpreter and the reference under the
    same interleaving (epoch keys rebuild the probe index and its slot
    table)."""
    def interleave(db, exe, tier, write):
        batches = [exe.run_batch([{}] * 2, tier=tier)]
        db.analyze()
        batches.append(exe.run_batch([{}] * 2, tier=tier))
        write(db)
        batches.append(exe.run_batch([{}] * 2, tier=tier))
        return batches

    def shrink(db):
        orders = db.table("orders")
        db.replace_table(orders.head(orders.nrows - 20))

    rows = RP.make_orders_customer_db(300, 30)
    ref_db = RP.make_orders_customer_db(300, 30)
    ref_exe = RefSession(ref_db, RefCatalog(REF_SLOW),
                         config=ref_config(rules)).compile(RP.make_p0())
    with reference_pallas():
        want = interleave(ref_db, ref_exe, "compiled", shrink)
    got = {}
    for tier in ("compiled", "interpreter"):
        db = carry(rows)
        exe = CobraSession(db, CostCatalog(SLOW_REMOTE),
                           config=port_config(rules)).compile(TP.make_p0())
        got[tier] = interleave(db, exe, tier, shrink)
    for a, b, r in zip(got["compiled"], got["interpreter"], want):
        assert_batches_identical(a, b)
        assert a.simulated_s == r.simulated_s
        for x, y in zip(a.results, r.results):
            assert_values_match(y.outputs, x.outputs)


def test_epoch_moves_rebuild_probe_index():
    """P0 as written: its navigation probe index (and slot table) is built
    once per epoch, kept while the epoch holds, rebuilt when it moves."""
    from repro_torch.compiled import lower_program
    from repro_torch.runtime import BatchClientEnv
    db = carry(RP.make_orders_customer_db(200, 20))
    lowered = lower_program(TP.make_p0())
    assert lowered.n_columnar >= 1
    cl = next(iter(lowered._loops.values()))
    env = BatchClientEnv(db, SLOW_REMOTE)
    lowered.run(env)
    first = cl.index_rebuilds
    assert first >= 1 and cl.kernel_probes == 1
    lowered.run(env)
    assert cl.index_rebuilds == first
    db.analyze("customer")
    lowered.run(env)
    assert cl.index_rebuilds > first and cl.kernel_probes == 3


def test_compile_manager_promotes_and_invalidates():
    from repro_torch.compiled import CompileManager
    sess = CobraSession(carry(RP.make_orders_customer_db(150, 15)),
                        CostCatalog(SLOW_REMOTE))
    exe = sess.compile(TP.make_p0())
    mgr = CompileManager(sess, threshold=3)
    assert mgr.lowered_for(exe, n_invocations=1) is None
    assert mgr.lowered_for(exe, n_invocations=1) is None
    lowered = mgr.lowered_for(exe, n_invocations=1)
    assert lowered is not None and lowered.n_columnar >= 1
    assert mgr.lowered_for(exe) is lowered and mgr.compiles == 1
    assert mgr.invalidate_tables(["orders"]) >= 1
    assert mgr.lowered_for(exe, n_invocations=1) is None
