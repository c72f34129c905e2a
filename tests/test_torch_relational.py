"""The port's relational substrate against the JAX package.

On the ``programs.py`` databases (the reference's rows carried across as
numpy, and the port's own generators on the same seeds), every query must
give the same rows with the same schema dtypes, and the servers must give
identical estimates and statistics fingerprints. Integers compare exactly;
fp32 aggregates within ``rtol=1e-5`` (XLA and torch reduce in different
orders).
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.programs as RP  # noqa: E402
import repro.relational as RR  # noqa: E402
import repro_torch.programs as TP  # noqa: E402
import repro_torch.relational as TR  # noqa: E402
from _torch_parity import FP32_RTOL, carry, export_tables  # noqa: E402
from repro_torch.carry import database_from_numpy  # noqa: E402
from repro_torch.relational.table import resolve_device  # noqa: E402

# database -> (reference factory, port factory): the same seeds
DATABASES = {
    "orders_customer": (lambda: RP.make_orders_customer_db(400, 40),
                        lambda: TP.make_orders_customer_db(400, 40,
                                                           device="cpu")),
    "sales": (lambda: RP.make_sales_db(300),
              lambda: TP.make_sales_db(300, device="cpu")),
    "wilos": (lambda: RP.make_wilos_db(300),
              lambda: TP.make_wilos_db(300, device="cpu")),
    "skew": (lambda: RP.make_skew_db(2000),
             lambda: TP.make_skew_db(2000, device="cpu")),
}


def _orders_queries(A):
    """Queries over the orders/customer database, built from either
    package's algebra module ``A``: (query, params, ordered)."""
    amt = A.Col("o_amt")
    return {
        "scan": (A.Scan("orders"), None, False),
        "select_lt": (A.Select(A.Cmp("<", A.Col("c_birth_year"), A.Lit(1960)),
                               A.Scan("customer")), None, False),
        "select_param_bool": (A.Select(A.BoolOp(
            "and", A.Cmp(">=", amt, A.Param("lo")),
            A.Not(A.Cmp("==", A.Col("o_customer_sk"), A.Lit(3)))),
            A.Scan("orders")), {"lo": 250.0}, False),
        "join": (A.Join(A.Scan("orders"), A.Scan("customer"), "o_customer_sk",
                        "c_customer_sk"), None, True),
        "grouped_aggs": (A.Aggregate(("o_customer_sk",), (
            A.AggSpec("sum", "o_amt", "s"), A.AggSpec("count", None, "n"),
            A.AggSpec("min", "o_amt", "lo"), A.AggSpec("max", "o_amt", "hi"),
            A.AggSpec("avg", "o_amt", "mean"), A.AggSpec("sum", "o_id", "ids"),
            A.AggSpec("avg", "o_id", "mean_id")), A.Scan("orders")),
            None, False),
        "global_aggs": (A.Aggregate((), (
            A.AggSpec("sum", "o_amt", "s"), A.AggSpec("count", None, "n"),
            A.AggSpec("avg", "o_amt", "mean"), A.AggSpec("min", "o_id", "lo"),
            A.AggSpec("max", "o_id", "hi"), A.AggSpec("sum", "o_id", "ids"),
            A.AggSpec("avg", "o_id", "mean_id")), A.Scan("orders")),
            None, False),
        "computed": (A.Project(("o_id",), A.Scan("orders"), computed=(
            ("m", A.Func("mod100", (A.Arith("-", A.Col("o_id"), A.Lit(150)),))),
            ("dbl", A.Arith("*", amt, A.Lit(2.0))),
            ("k", A.Arith("+", A.Col("o_id"), A.Lit(3))),
            ("q", A.Arith("/", A.Col("o_payload"), A.Lit(7))),
            ("r", A.Func("sqrt", (amt,))),
            ("big", A.Cmp(">", amt, A.Lit(100.0))))), None, True),
        "orderby_desc": (A.OrderBy(("c_birth_year", "c_customer_sk"),
                                   A.Scan("customer"), descending=True),
                         None, True),
        "limit": (A.Limit(7, A.OrderBy(("o_amt",), A.Scan("orders"))),
                  None, True),
    }


def _other_queries(A, db_name):
    if db_name == "sales":
        return {"by_month": (A.Aggregate(("month",), (
            A.AggSpec("sum", "sale_amt", "s"), A.AggSpec("avg", "sale_amt", "m"),
            A.AggSpec("count", None, "n")), A.Scan("sales")), None, False)}
    if db_name == "wilos":
        return {
            "join": (A.Join(A.Scan("tasks"), A.Scan("roles"), "t_role_id",
                            "r_id"), None, True),
            "by_state": (A.Aggregate(("t_state",), (
                A.AggSpec("count", None, "n"), A.AggSpec("sum", "t_hours", "h"),
                A.AggSpec("max", "t_role_id", "r")), A.Scan("tasks")),
                None, False),
        }
    return {"by_key": (A.Aggregate(("e_key",), (
        A.AggSpec("sum", "e_units", "u"), A.AggSpec("min", "e_units", "lo")),
        A.Select(A.Cmp("!=", A.Col("e_key"), A.Param("k")), A.Scan("events"))),
        {"k": 0}, False)}


def queries(A, db_name):
    return _orders_queries(A) if db_name == "orders_customer" \
        else _other_queries(A, db_name)


QUERY_CASES = [(d, q) for d in DATABASES for q in queries(RR, d)]


def assert_tables_match(ref_t, port_t, ordered):
    assert port_t.schema.names == ref_t.schema.names
    assert [f.dtype for f in port_t.schema.fields] == \
        [f.dtype for f in ref_t.schema.fields]
    assert port_t.nrows == ref_t.nrows
    for f in ref_t.schema.fields:
        want = np.asarray(ref_t.column(f.name))
        got = port_t.host(f.name)
        assert got.dtype == want.dtype, f.name
    if ordered:
        names = ref_t.schema.names
        want = np.stack([np.asarray(ref_t.column(n), np.float64) for n in names], 1) \
            if names else np.zeros((0, 0))
        got = np.stack([port_t.host(n).astype(np.float64) for n in names], 1) \
            if names else np.zeros((0, 0))
    else:
        want, got = ref_t.canonical_key(), port_t.canonical_key()
    np.testing.assert_allclose(got, want, rtol=FP32_RTOL, atol=0)
    for j, f in enumerate(sorted(ref_t.schema.fields, key=lambda f: f.name)
                          if not ordered else ref_t.schema.fields):
        if np.dtype(np.asarray(ref_t.column(f.name)).dtype).kind in "iub":
            np.testing.assert_array_equal(got[:, j], want[:, j])


@pytest.mark.parametrize("db_name,query", QUERY_CASES)
def test_query_matches_reference(db_name, query):
    ref_db = DATABASES[db_name][0]()
    port_db = carry(ref_db)
    rq, params, ordered = queries(RR, db_name)[query]
    tq = queries(TR, db_name)[query][0]
    assert tq.key() == rq.key()
    ref_t, *ref_times = ref_db.run(rq, params)
    port_t, *port_times = port_db.run(tq, params)
    assert_tables_match(ref_t, port_t, ordered)
    assert port_times == ref_times                 # the true C_Q^F, C_Q^L
    for known in (False, True):
        assert dataclasses.astuple(port_db.estimate(tq, params_known=known)) \
            == dataclasses.astuple(ref_db.estimate(rq, params_known=known))


@pytest.mark.parametrize("db_name", sorted(DATABASES))
def test_generators_and_carry_give_the_same_rows(db_name):
    ref_db = DATABASES[db_name][0]()
    port_db = DATABASES[db_name][1]()
    carried = carry(ref_db)
    assert sorted(port_db.tables) == sorted(ref_db.tables)
    for name, ref_t in ref_db.tables.items():
        t = port_db.table(name)
        assert t.device == torch.device("cpu")
        assert all(c.device.type == "cpu" for c in t.columns.values())
        assert t.same_rows(carried.table(name), ordered=True)
        assert_tables_match(ref_t, t, ordered=True)
        assert port_db.stats(name).nrows == ref_db.stats(name).nrows
    names = tuple(ref_db.tables)
    assert port_db.stats_fingerprint(names) == ref_db.stats_fingerprint(names)
    assert carried.stats_fingerprint(names) == ref_db.stats_fingerprint(names)


@pytest.mark.parametrize("db_name", sorted(DATABASES))
def test_analyze_keeps_fingerprints_equal(db_name):
    ref_db = DATABASES[db_name][0]()
    port_db = carry(ref_db)
    names = tuple(ref_db.tables)
    ref_db.analyze()
    port_db.analyze()
    assert port_db.stats_fingerprint(names) == ref_db.stats_fingerprint(names)
    assert port_db.stats_version == ref_db.stats_version


def test_table_host_mirror_is_cached_and_read_only():
    t = TR.Table.from_columns("t", TR.Schema.of(TR.Field("a", "int64"),
                                                TR.Field("b", "float64")),
                              device="cpu", a=np.arange(5), b=np.ones(5))
    assert t.column("a").dtype == torch.int32            # 64-bit narrows
    assert t.column("b").dtype == torch.float32
    h = t.host("a")
    assert h is t.host("a") and not h.flags.writeable
    taken = t.take(np.asarray([4, 0]))
    assert taken.host("a").tolist() == [4, 0]
    assert taken.row(0) == {"a": 4, "b": 1.0}
    assert [r["a"] for r in t.sort_by(["a"], descending=True).to_rows()] == \
        [4, 3, 2, 1, 0]


def test_literal_and_param_dtypes_follow_jnp():
    t = TR.Table.from_columns("t", TR.Schema.of(TR.Field("a")), device="cpu",
                              a=np.arange(3))
    assert TR.Lit(3).eval(t).dtype == torch.int32
    assert TR.Lit(2.5).eval(t).dtype == torch.float32
    assert TR.Lit(True).eval(t).dtype == torch.bool
    assert TR.Param("p").eval(t, {"p": 7}).dtype == torch.int32


def test_default_device_without_cuda_raises(monkeypatch):
    """``device=None`` means the card; without CUDA the port raises rather
    than dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        TR.DatabaseServer({})
    with pytest.raises(RuntimeError):
        TP.make_orders_customer_db(10, 3)
    with pytest.raises(RuntimeError):
        TR.Table.from_columns("t", TR.Schema.of(TR.Field("a")), a=[1, 2])
    with pytest.raises(RuntimeError):
        database_from_numpy(export_tables(RP.make_sales_db(10)))
    assert resolve_device("cpu") == torch.device("cpu")
