"""The port's sharded cluster against the JAX package, on the same data.

Mirrors ``tests/test_cluster.py`` (partitioning, pruning and replication,
the scatter-gather merges per query shape at 1, 2 and 4 shards, the int-avg
and float-sum combine rules, writes and per-shard epochs, the router and
the batch former, the mixed stream with writes, ``triage_cluster``) on the
port, on the CPU, and adds the checks against the reference on the same
rows (carried across as numpy):

  * the shard contents (``__gpos`` included) and ``stats_fingerprint``;
  * every query shape's result against the reference's unsharded result
    (integers and data exact, fp32 sums within ``rtol=1e-5``: XLA and torch
    add in different orders);
  * ``ClusterRuntime.serve`` on the mixed stream: the responses, the
    makespan, the per-worker load and the final database, against the
    reference's cluster and its single worker.
"""

import functools
import tempfile

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.programs as RP  # noqa: E402
import repro_torch.programs as TP  # noqa: E402
from _torch_parity import FP32_RTOL, assert_values_match, export_tables  # noqa: E402
from repro.api import CobraSession as RefSession  # noqa: E402
from repro.cluster import ClusterRuntime as RefClusterRuntime  # noqa: E402
from repro.cluster import Partitioner as RefPartitioner  # noqa: E402
from repro.cluster import ShardedDatabase as RefShardedDatabase  # noqa: E402
from repro.obs.triage import render_triage as ref_render_triage  # noqa: E402
from repro.relational import algebra as RA  # noqa: E402
from repro.relational.database import DatabaseServer as RefDatabaseServer  # noqa: E402
from repro.runtime import ServingRuntime as RefServingRuntime  # noqa: E402
from repro_torch.api import CobraSession  # noqa: E402
from repro_torch.api.lift import lift_program, load_all, update_row  # noqa: E402
from repro_torch.carry import database_from_numpy  # noqa: E402
from repro_torch.cluster import (GPOS, BatchFormer, ClusterRuntime,  # noqa: E402
                                 Partitioner, Request, Router,
                                 ShardedDatabase, uniform_arrivals)
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.obs.triage import render_triage  # noqa: E402
from repro_torch.relational import algebra as TA  # noqa: E402
from repro_torch.runtime import ServingRuntime  # noqa: E402

PROGRAMS = ("make_wilos_e", "make_wilos_f", "make_wilos_a", "make_scan")


@functools.lru_cache(maxsize=None)
def _rows(n, seed):
    return export_tables(RP.make_wilos_db(n, seed=seed))


def fresh_db(n=1000, seed=5):
    """The port's server on the CPU, holding the reference's Wilos rows."""
    return database_from_numpy(_rows(n, seed), device="cpu")


def fresh_ref(n=1000, seed=5):
    src = RP.make_wilos_db(n, seed=seed)
    return RefDatabaseServer(dict(src.tables), src.model)


def sharded(n_shards, n=1000, seed=5):
    return ShardedDatabase.shard(fresh_db(n, seed), n_shards,
                                 keys={"tasks": "t_role_id"})


def assert_tables_equal(t0, t1, ctx=""):
    """Two port tables, bit for bit (names, types, values, row order)."""
    assert t1.schema.names == t0.schema.names, ctx
    for c in t0.schema.names:
        a, b = t0.host(c), t1.host(c)
        assert a.dtype == b.dtype, (ctx, c, a.dtype, b.dtype)
        assert np.array_equal(a, b), (ctx, c)


def assert_matches_reference(ref, port, ctx="", rtol=0.0):
    """A port table against a reference table: names, types and row order;
    values exactly, or floats within ``rtol`` where it is given."""
    assert port.schema.names == ref.schema.names, ctx
    assert [f.dtype for f in port.schema.fields] == \
        [f.dtype for f in ref.schema.fields], ctx
    for c in ref.schema.names:
        a, b = np.asarray(ref.column(c)), port.host(c)
        assert a.dtype == b.dtype, (ctx, c, a.dtype, b.dtype)
        if rtol and a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0, err_msg=ctx)
        else:
            assert np.array_equal(a, b), (ctx, c)


# --------------------------------------------------------------------------
# Partitioner
# --------------------------------------------------------------------------

class TestPartitioner:
    def test_split_preserves_rows_and_order(self):
        t = fresh_db(300).table("tasks")
        parts = Partitioner(4, {"tasks": "t_role_id"}).split(t)
        assert sum(q.nrows for q in parts) == t.nrows
        for k, q in enumerate(parts):
            assert q.schema.has(GPOS)
            assert np.all(q.host("t_role_id") % 4 == k)
            assert np.all(np.diff(q.host(GPOS)) > 0)
        allg = np.sort(np.concatenate([q.host(GPOS) for q in parts]))
        assert np.array_equal(allg, np.arange(t.nrows))

    @pytest.mark.parametrize("n_shards", [1, 2, 4])
    def test_split_matches_reference(self, n_shards):
        ref = RefPartitioner(n_shards, {"tasks": "t_role_id"}).split(
            RP.make_wilos_db(300, seed=5).table("tasks"))
        port = Partitioner(n_shards, {"tasks": "t_role_id"}).split(
            fresh_db(300).table("tasks"))
        for k, (a, b) in enumerate(zip(ref, port)):
            assert_matches_reference(a, b, f"shard {k}")

    def test_gpos_does_not_change_row_bytes(self):
        db = fresh_db(100)
        part = Partitioner(2, {"tasks": "t_role_id"}).split(db.table("tasks"))[0]
        assert part.row_bytes == db.table("tasks").row_bytes

    def test_replicated_tables(self):
        db = fresh_db(100)
        p = Partitioner(3, {"tasks": "t_role_id"})
        copies = p.shard_tables(db.table("roles"))
        assert len(copies) == 3
        for c in copies:
            assert c.nrows == db.table("roles").nrows
            assert not c.schema.has(GPOS)
        assert p.shard_of("roles", 5) is None
        assert p.shard_of("tasks", 7) == 7 % 3


# --------------------------------------------------------------------------
# ShardedDatabase: query bit-identity
# --------------------------------------------------------------------------

def query_shapes(A):
    """The query shapes of ``tests/test_cluster.py``, built from the
    relational algebra module ``A`` of either package."""
    Scan, Select, Project, Join, Cmp, Col, Lit, Param, BoolOp = (
        A.Scan, A.Select, A.Project, A.Join, A.Cmp, A.Col, A.Lit, A.Param,
        A.BoolOp)
    Aggregate, AggSpec, OrderBy, Limit = A.Aggregate, A.AggSpec, A.OrderBy, \
        A.Limit
    return [
        ("scan_part", Scan("tasks"), None),
        ("scan_repl", Scan("roles"), None),
        ("prune_lit", Select(Cmp("==", Col("t_role_id"), Lit(7)),
                             Scan("tasks")), None),
        ("prune_param", Select(Cmp("==", Col("t_role_id"), Param("rid")),
                               Scan("tasks")), {"rid": 11}),
        ("prune_and", Select(BoolOp("and",
                                    Cmp("==", Col("t_role_id"), Lit(5)),
                                    Cmp("<", Col("t_state"), Lit(3))),
                             Scan("tasks")), None),
        ("scatter_select", Select(Cmp("<", Col("t_state"), Lit(2)),
                                  Scan("tasks")), None),
        ("scatter_project", Project(("t_id", "t_state"),
                                    Select(Cmp("<", Col("t_state"), Lit(2)),
                                           Scan("tasks"))), None),
        ("join_part_repl", Join(Scan("tasks"), Scan("roles"),
                                "t_role_id", "r_id"), None),
        ("join_repl_part", Join(Scan("roles"), Scan("tasks"),
                                "r_id", "t_role_id"), None),
        ("agg_grouped_combinable",
         Aggregate(("t_state",), (AggSpec("count", None, "n"),
                                  AggSpec("min", "t_id", "lo"),
                                  AggSpec("max", "t_id", "hi"),
                                  AggSpec("sum", "t_role_id", "s")),
                   Scan("tasks")), None),
        ("agg_grouped_float_sum",
         Aggregate(("t_state",), (AggSpec("sum", "t_hours", "h"),),
                   Scan("tasks")), None),
        ("agg_global_combinable",
         Aggregate((), (AggSpec("count", None, "n"),
                        AggSpec("max", "t_id", "hi")), Scan("tasks")), None),
        ("agg_global_float",
         Aggregate((), (AggSpec("sum", "t_hours", "h"),
                        AggSpec("avg", "t_hours", "a")), Scan("tasks")), None),
        ("agg_grouped_int_avg",
         Aggregate(("t_state",), (AggSpec("avg", "t_role_id", "a"),
                                  AggSpec("count", None, "n")),
                   Scan("tasks")), None),
        ("agg_global_int_avg",
         Aggregate((), (AggSpec("avg", "t_id", "a"),
                        AggSpec("sum", "t_role_id", "s")), Scan("tasks")), None),
        ("agg_int_avg_empty_input",
         Aggregate((), (AggSpec("avg", "t_role_id", "a"),),
                   Select(Cmp("==", Col("t_state"), Lit(99)),
                          Scan("tasks"))), None),
        ("agg_empty_input",
         Aggregate((), (AggSpec("sum", "t_hours", "h"),),
                   Select(Cmp("==", Col("t_state"), Lit(99)),
                          Scan("tasks"))), None),
        ("orderby_limit", Limit(10, OrderBy(("t_state", "t_id"),
                                            Scan("tasks"))), None),
    ]


QUERY_SHAPES = query_shapes(TA)
REF_SHAPES = {tag: (q, p) for tag, q, p in query_shapes(RA)}
# fp32 sums of non-integral values: XLA and torch add in different orders
FLOAT_SUM_SHAPES = {"agg_grouped_float_sum", "agg_global_float"}


@functools.lru_cache(maxsize=None)
def ref_unsharded(tag):
    query, params = REF_SHAPES[tag]
    return fresh_ref().run(query, params)[0]


class TestShardedQueries:
    @pytest.mark.parametrize("n_shards", [1, 2, 4])
    @pytest.mark.parametrize(
        "tag,query,params", QUERY_SHAPES, ids=[s[0] for s in QUERY_SHAPES])
    def test_bit_identical_to_unsharded(self, n_shards, tag, query, params):
        r0, _, _ = fresh_db().run(query, params)
        r1, _, _ = sharded(n_shards).run(query, params)
        assert_tables_equal(r0, r1, tag)
        assert not any(c.endswith(GPOS) for c in r1.schema.names)
        assert_matches_reference(ref_unsharded(tag), r1, tag,
                                 FP32_RTOL if tag in FLOAT_SUM_SHAPES else 0.0)

    def test_prune_routes_to_single_shard(self):
        sh = sharded(4)
        sh.run(TA.Select(TA.Cmp("==", TA.Col("t_role_id"), TA.Lit(6)),
                         TA.Scan("tasks")))
        assert sh.pruned_queries == 1
        assert sh.scattered_queries == 0
        assert sh.shard_queries[6 % 4] == 1

    def test_replicated_only_never_scatters(self):
        sh = sharded(4)
        sh.run(TA.Scan("roles"))
        assert sh.replicated_queries == 1
        assert sh.scattered_queries == 0

    def test_float_sum_never_partial_combines(self):
        sh = sharded(4)
        assert not sh._combinable(TA.Aggregate(
            (), (TA.AggSpec("sum", "t_hours", "h"),), TA.Scan("tasks")))
        assert sh._combinable(TA.Aggregate(
            (), (TA.AggSpec("sum", "t_role_id", "s"),), TA.Scan("tasks")))

    def test_int_avg_partial_combines_float_avg_does_not(self):
        sh = sharded(4)
        assert sh._combinable(TA.Aggregate(
            ("t_state",), (TA.AggSpec("avg", "t_role_id", "a"),),
            TA.Scan("tasks")))
        assert not sh._combinable(TA.Aggregate(
            ("t_state",), (TA.AggSpec("avg", "t_hours", "a"),),
            TA.Scan("tasks")))

    def test_int_avg_uses_scatter_path_and_stays_bit_exact(self):
        node = TA.Aggregate(("t_state",), (TA.AggSpec("avg", "t_role_id", "a"),
                                           TA.AggSpec("sum", "t_id", "s")),
                            TA.Scan("tasks"))
        sh = sharded(4)
        before = sh.scattered_queries
        r0, _, _ = fresh_db().run(node)
        r1, _, _ = sh.run(node)
        assert sh.scattered_queries == before + 1
        assert_tables_equal(r0, r1, "grouped int avg")
        assert all("__av" not in c for c in r1.schema.names)
        assert dict(zip(r1.schema.names,
                        (f.dtype for f in r1.schema.fields)))["a"] == "float32"
        ref_node = RA.Aggregate(
            ("t_state",), (RA.AggSpec("avg", "t_role_id", "a"),
                           RA.AggSpec("sum", "t_id", "s")), RA.Scan("tasks"))
        ref = RefShardedDatabase.shard(fresh_ref(), 4,
                                       keys={"tasks": "t_role_id"})
        assert_matches_reference(ref.run(ref_node)[0], r1, "grouped int avg")

    def test_int_avg_past_fp32_exact_range_gathers_and_stays_bit_exact(self):
        """At 100,000 tasks a group's t_role_id sum passes 2**24, where
        the unsharded fp32 sum rounds in its own order: the (sum, count)
        partial states would give other bits (the reference's cluster
        does, ROADMAP C), so the port gathers the child and stays equal to
        the unsharded avg, and within fp32 order to the reference's."""
        base = fresh_db(100_000)
        sh = ShardedDatabase.shard(base, 4, keys={"tasks": "t_role_id"})
        ref = fresh_ref(100_000)
        for group_by in (("t_state",), ()):
            node = TA.Aggregate(group_by, (TA.AggSpec("avg", "t_role_id", "a"),
                                           TA.AggSpec("count", None, "n")),
                                TA.Scan("tasks"))
            r1 = sh.run(node)[0]
            assert_tables_equal(base.run(node)[0], r1, f"avg by {group_by}")
            ref_node = RA.Aggregate(
                group_by, (RA.AggSpec("avg", "t_role_id", "a"),
                           RA.AggSpec("count", None, "n")), RA.Scan("tasks"))
            assert_matches_reference(ref.run(ref_node)[0], r1,
                                     f"avg by {group_by}", FP32_RTOL)
        assert sh.scattered_queries == 2

    def test_estimates_and_stats_match_unsharded_and_reference(self):
        base, sh = fresh_db(), sharded(4)
        q = TA.Select(TA.Cmp("==", TA.Col("t_role_id"), TA.Lit(3)),
                      TA.Scan("tasks"))
        assert base.estimate(q) == sh.estimate(q)
        fp = sh.stats_fingerprint(["tasks", "roles"])
        assert base.stats_fingerprint(["tasks", "roles"]) == fp
        ref = RefShardedDatabase.shard(fresh_ref(), 4,
                                       keys={"tasks": "t_role_id"})
        assert ref.stats_fingerprint(["tasks", "roles"]) == fp
        rq = RA.Select(RA.Cmp("==", RA.Col("t_role_id"), RA.Lit(3)),
                       RA.Scan("tasks"))
        assert ref.estimate(rq).n_rows == sh.estimate(q).n_rows
        # the shards hold the reference's rows, in its order
        for k, (a, b) in enumerate(zip(ref.shards, sh.shards)):
            for name in ("tasks", "roles"):
                assert_matches_reference(a.table(name), b.table(name),
                                         f"shard {k} {name}")

    def test_shards_and_merged_views_live_on_the_coordinators_device(self):
        sh = sharded(4)
        sh.run(TA.Scan("tasks"))
        dev = torch.device("cpu")
        assert sh.device == dev
        for s in sh.shards:
            assert s.device == dev
            assert all(t.device == dev for t in s.tables.values())
        assert all(sh.table(n).device == dev for n in ("tasks", "roles"))


# --------------------------------------------------------------------------
# ShardedDatabase: writes, per-shard epochs
# --------------------------------------------------------------------------

class TestShardedWrites:
    def test_direct_shard_write_moves_coordinator_epoch(self):
        sh = sharded(4)
        e0 = sh.site_epoch(("tasks",))
        r0 = sh.site_epoch(("roles",))
        dv0 = sh.data_version("tasks")
        sv0 = sh.shard_versions("tasks")
        part = sh.shards[1].table("tasks")
        sh.shards[1].replace_table(part.head(max(1, part.nrows // 2)))
        sv1 = sh.shard_versions("tasks")
        assert sv1[1][1] == sv0[1][1] + 1
        assert [v for i, v in enumerate(sv1) if i != 1] == \
            [v for i, v in enumerate(sv0) if i != 1]
        assert sh.data_version("tasks") == dv0 + 1
        assert sh.site_epoch(("tasks",)) != e0
        assert sh.site_epoch(("roles",)) == r0
        roles = sh.table("tasks").host("t_role_id")
        assert np.count_nonzero(roles % 4 == 1) == max(1, part.nrows // 2)

    def test_replace_table_on_one_shard_remerges_in_order(self):
        sh = sharded(2)
        before = sh.table("tasks")
        part = sh.shards[0].table("tasks")
        keep = np.arange(part.nrows // 2)
        sh.shards[0].replace_table(part.take(keep))
        after = sh.table("tasks")
        assert after.nrows == before.nrows - (part.nrows - len(keep))
        it = iter(before.host("t_id").tolist())
        assert all(any(x == y for y in it) for x in after.host("t_id").tolist())

    def test_coordinator_replace_keeps_stats_stale(self):
        base, sh = fresh_db(), sharded(4)
        q = TA.Scan("tasks")
        small = base.table("tasks").head(50)
        base.replace_table(small)
        sh.replace_table(small)
        assert base.estimate(q) == sh.estimate(q)
        assert_tables_equal(base.run(q)[0], sh.run(q)[0], "post-replace")
        base.analyze("tasks")
        sh.analyze("tasks")
        assert base.estimate(q) == sh.estimate(q)
        assert base.stats_fingerprint(["tasks"]) == \
            sh.stats_fingerprint(["tasks"])

    def test_mutating_program_touching_two_shards(self):
        def W2():
            for x in load_all("roles"):
                update_row("tasks", "t_state", x.r_rank,
                           "t_role_id", x.r_id)
        prog = lift_program(W2)
        base = fresh_db()
        CobraSession(base).compile(prog).run()
        sh = sharded(2)
        CobraSession(sh).compile(prog).run()
        assert_tables_equal(base.table("tasks"), sh.table("tasks"),
                            "two-shard update")
        for k, s in enumerate(sh.shards):
            assert np.all(s.table("tasks").host("t_role_id") % 2 == k)


# --------------------------------------------------------------------------
# Router + BatchFormer
# --------------------------------------------------------------------------

class TestRouter:
    def test_affinity_routes_by_key_identity(self):
        r = Router(4, {"W_E": "worklist"})
        assert r.route("W_E", {"worklist": [6]}) == 6 % 4
        assert r.route("W_E", {"worklist": [6, 99]}) == 6 % 4
        assert r.route("W_E", {"worklist": [9]}) == 9 % 4
        assert r.affinity_routed == 3

    def test_hash_routing_is_deterministic(self):
        a, b = Router(4), Router(4)
        for i in range(20):
            params = {"x": i, "y": [i, i + 1]}
            assert a.route("P", params) == b.route("P", params)

    def test_skew_measures_hot_worker(self):
        r = Router(4, {"P": "k"})
        for _ in range(12):
            r.route("P", {"k": 8})
        assert r.skew() == pytest.approx(4.0)
        u = Router(4, {"P": "k"})
        for i in range(12):
            u.route("P", {"k": i})
        assert u.skew() == pytest.approx(1.0)


class TestBatchFormer:
    def test_burst_flushes_full_batches(self):
        batches = BatchFormer(deadline_s=0.01, max_batch=8).form(
            [Request(i, "P", {}, worker=0) for i in range(20)])
        assert [b.size for b in batches] == [8, 8, 4]
        assert [b.reason for b in batches] == ["full", "full", "deadline"]
        assert [r.index for b in batches for r in b.requests] == \
            list(range(20))

    def test_sparse_arrivals_flush_on_deadline(self):
        arr = uniform_arrivals(10, rps=50.0)
        batches = BatchFormer(deadline_s=0.05, max_batch=64).form(
            [Request(i, "P", {}, worker=0, arrival_s=arr[i])
             for i in range(10)])
        assert all(b.reason == "deadline" for b in batches)
        assert all(b.size < 64 for b in batches)
        assert sum(b.size for b in batches) == 10
        assert batches[0].flush_s == pytest.approx(arr[0] + 0.05)

    def test_forming_is_deterministic(self):
        reqs = [Request(i, "PQ"[i % 2], {}, worker=i % 3,
                        arrival_s=0.001 * (i % 5)) for i in range(30)]
        a = BatchFormer(deadline_s=0.002, max_batch=4).form(reqs)
        b = BatchFormer(deadline_s=0.002, max_batch=4).form(reqs)
        assert [(x.worker, x.program, x.flush_s, x.reason,
                 tuple(r.index for r in x.requests)) for x in a] == \
               [(x.worker, x.program, x.flush_s, x.reason,
                 tuple(r.index for r in x.requests)) for x in b]


# --------------------------------------------------------------------------
# ClusterRuntime: bit-identical to one worker, and to the reference
# --------------------------------------------------------------------------

def example_stream(n=30):
    reqs = []
    for i in range(n):
        reqs.append(("W_E", {"worklist": [i % 7]}))
        if i % 10 == 0:
            reqs.append(("W_F", {}))
        if i % 11 == 3:
            reqs.append(("W_A", {}))       # mid-stream writes
        if i % 13 == 6:
            reqs.append(("SCAN", {}))      # while-loop + early exit
    return reqs


def serve_single(reqs, batch_size=8, mid=None):
    db = fresh_db()
    rt = ServingRuntime(CobraSession(db), batch_size=batch_size)
    for mk in PROGRAMS:
        rt.register(getattr(TP, mk)())
    if mid is None:
        return rt.serve(reqs), db, rt
    out = rt.serve(reqs[:len(reqs) // 2])
    mid(db)
    out += rt.serve(reqs[len(reqs) // 2:])
    return out, db, rt


def serve_cluster(reqs, n_workers, store=None, mid=None, **kw):
    cl = ClusterRuntime(fresh_db(), n_workers=n_workers,
                        partition_keys={"tasks": "t_role_id"},
                        affinity={"W_E": "worklist"},
                        deadline_s=0.01, max_batch=8, store=store, **kw)
    for mk in PROGRAMS:
        cl.register(getattr(TP, mk)())
    if mid is None:
        return cl.serve(reqs), cl
    out = cl.serve(reqs[:len(reqs) // 2])
    mid(cl.db)
    out += cl.serve(reqs[len(reqs) // 2:])
    return out, cl


@functools.lru_cache(maxsize=None)
def ref_single_stream():
    """The reference's single ServingRuntime on the mixed stream: its
    responses and its final tables."""
    db = fresh_ref()
    rt = RefServingRuntime(RefSession(db), batch_size=8)
    for mk in PROGRAMS:
        rt.register(getattr(RP, mk)())
    out = rt.serve(example_stream())
    return [r.outputs for r in out], {n: db.table(n) for n in db.tables}


@functools.lru_cache(maxsize=None)
def ref_cluster_stream(n_workers):
    cl = RefClusterRuntime(fresh_ref(), n_workers=n_workers,
                           partition_keys={"tasks": "t_role_id"},
                           affinity={"W_E": "worklist"},
                           deadline_s=0.01, max_batch=8)
    for mk in PROGRAMS:
        cl.register(getattr(RP, mk)())
    return [r.outputs for r in cl.serve(example_stream())], cl


def assert_bit_identical(r_single, db_single, r_cluster, cl):
    assert len(r_single) == len(r_cluster)
    for i, (a, b) in enumerate(zip(r_single, r_cluster)):
        assert a.outputs == b.outputs, f"request {i} outputs diverged"
    for name in db_single.tables:
        assert_tables_equal(db_single.table(name), cl.db.table(name), name)


class TestClusterBitIdentity:
    @pytest.mark.parametrize("n_workers", [1, 2, 4])
    def test_mixed_stream_with_writes(self, n_workers):
        reqs = example_stream()
        r1, db1, _ = serve_single(reqs)
        r2, cl = serve_cluster(reqs, n_workers)
        assert_bit_identical(r1, db1, r2, cl)
        # ...and the reference's single worker on the same rows
        ref_out, ref_tables = ref_single_stream()
        for i, (a, b) in enumerate(zip(ref_out, r2)):
            assert_values_match(a, b.outputs, f"request {i}")
        for name, t in ref_tables.items():
            assert_matches_reference(t, cl.db.table(name), name)

    def test_cluster_matches_reference_cluster(self):
        ref_out, ref_cl = ref_cluster_stream(4)
        out, cl = serve_cluster(example_stream(), 4)
        for i, (a, b) in enumerate(zip(ref_out, out)):
            assert_values_match(a, b.outputs, f"request {i}")
        assert cl.last_makespan_s == ref_cl.last_makespan_s
        t, rt = cl.telemetry(), ref_cl.telemetry()
        for k in ("worker_requests", "worker_batches", "worker_simulated_s",
                  "batches_formed", "db_shard_queries", "db_pruned_queries",
                  "db_scattered_queries", "db_gathered_queries",
                  "router_routed", "former_flushes_full"):
            assert t[k] == rt[k], k
        for k, (a, b) in enumerate(zip(ref_cl.db.shards, cl.db.shards)):
            for name in ("tasks", "roles"):
                assert_matches_reference(a.table(name), b.table(name),
                                         f"shard {k} {name}")

    def test_mid_stream_analyze(self):
        reqs = example_stream(24)
        r1, db1, _ = serve_single(reqs, mid=lambda db: db.analyze())
        r2, cl = serve_cluster(reqs, 2, mid=lambda db: db.analyze())
        assert_bit_identical(r1, db1, r2, cl)

    def test_drift_triggered_replans(self):
        def grow(db):
            t = db.table("tasks")
            db.replace_table(t.take(np.tile(np.arange(t.nrows), 4)))

        reqs = example_stream(24)
        r1, db1, rt1 = serve_single(reqs, mid=grow)
        r2, cl = serve_cluster(reqs, 2, mid=grow)
        assert_bit_identical(r1, db1, r2, cl)
        assert rt1.recompiles + sum(w.recompiles for w in cl.workers) > 0

    def test_responses_in_request_order(self):
        r2, _ = serve_cluster([("W_E", {"worklist": [i % 5]})
                               for i in range(17)], 4)
        exe = CobraSession(fresh_db()).compile(TP.make_wilos_e())
        for i, res in enumerate(r2):
            assert res.outputs == exe.run(worklist=[i % 5]).outputs


# --------------------------------------------------------------------------
# ClusterRuntime: formed batches drive the serving context
# --------------------------------------------------------------------------

class TestFormedBatchContext:
    def test_worker_publishes_observed_batch_size(self):
        cl = ClusterRuntime(fresh_db(), n_workers=1,
                            partition_keys={"tasks": "t_role_id"},
                            deadline_s=0.01, max_batch=64)
        cl.register(TP.make_wilos_e())
        cl.serve([("W_E", {"worklist": [i]}) for i in range(6)],
                 arrivals=uniform_arrivals(6, rps=10.0))
        w = cl.workers[0]
        assert w.batch_publishes >= 1
        assert w._base_context.batch_size < 64
        h = w.metrics.histogram("formed_batch_size")
        assert h is not None and h["count"] >= 1

    def test_burst_forms_max_batches(self):
        cl = ClusterRuntime(fresh_db(), n_workers=1,
                            partition_keys={"tasks": "t_role_id"},
                            deadline_s=0.01, max_batch=16)
        cl.register(TP.make_wilos_e())
        cl.serve([("W_E", {"worklist": [3]}) for _ in range(32)])
        assert cl.former.flushes_full == 2
        assert cl.workers[0]._formed_sizes.count(16) == 2


class TestFormationPlanFlip:
    def _build(self, **kw):
        from repro_torch.api import OptimizerConfig
        from repro_torch.core import CostCatalog
        from repro_torch.relational.database import SLOW_REMOTE
        return ClusterRuntime(fresh_db(), n_workers=1,
                              partition_keys={"tasks": "t_role_id"},
                              deadline_s=0.01, max_batch=64,
                              initial_batch_size=1,
                              catalog=CostCatalog(SLOW_REMOTE),
                              config=OptimizerConfig.preset("paper-exp1-3"),
                              **kw)

    def test_burst_reaches_batch64_flip(self):
        cl = self._build(bit_guard_swaps=False, feedback=False)
        cl.register(TP.make_scan())
        w = cl.workers[0]
        assert w._base_context.batch_size == 1
        assert "prefetch" not in repr(w.executable("SCAN").program.body)
        cl.serve([("SCAN", {}) for _ in range(64)])
        assert cl.former.flushes_full == 1
        assert w.batch_publishes >= 1
        assert w._base_context.batch_size == 64
        assert "prefetch" in repr(w.executable("SCAN").program.body)

    def test_default_bit_guard_vetoes_divergent_flip(self):
        from repro_torch.api import OptimizerConfig
        from repro_torch.core import CostCatalog
        from repro_torch.relational.database import SLOW_REMOTE
        cl = self._build()
        cl.register(TP.make_scan())
        w = cl.workers[0]
        out = cl.serve([("SCAN", {}) for _ in range(64)])
        assert w.bit_vetoes >= 1
        assert w.swaps_rejected >= 1
        assert "prefetch" not in repr(w.executable("SCAN").program.body)
        rt = ServingRuntime(
            CobraSession(fresh_db(), catalog=CostCatalog(SLOW_REMOTE),
                         config=OptimizerConfig.preset("paper-exp1-3")),
            batch_size=1)
        rt.register(TP.make_scan())
        ref = rt.serve([("SCAN", {}) for _ in range(64)])
        assert [r.outputs for r in out] == [r.outputs for r in ref]


# --------------------------------------------------------------------------
# Shared plan store, metrics aggregation, triage, tracing
# --------------------------------------------------------------------------

class TestClusterObservability:
    def test_shared_store_warm_starts_other_workers(self):
        with tempfile.TemporaryDirectory() as d:
            cl = ClusterRuntime(fresh_db(), n_workers=4,
                                partition_keys={"tasks": "t_role_id"},
                                store=d)
            cl.register(TP.make_wilos_e())
            assert cl.store.hits >= 3

    def test_metrics_reconcile_with_worker_sums(self):
        r2, cl = serve_cluster(example_stream(20), 3)
        snap = cl.metrics_snapshot()
        assert snap["workers_serving_requests_served"] == \
            sum(w.requests_served for w in cl.workers)
        assert snap["workers_serving_batches_run"] == \
            sum(w.batches_run for w in cl.workers)
        assert snap["workers_serving_simulated_s"] == pytest.approx(
            sum(w.simulated_s for w in cl.workers))
        assert snap["cluster_requests_served"] == len(r2)
        from repro_torch.obs.metrics import combine_snapshots
        dumps = cl.metrics_dump()
        assert combine_snapshots(combine_snapshots(dumps[0], dumps[1]),
                                 dumps[2]) == \
            combine_snapshots(dumps[0], combine_snapshots(dumps[1], dumps[2]))

    def test_triage_flags_hot_shard_under_skew(self):
        stream = [("W_E", {"worklist": [4 * (i % 3)]}) for i in range(24)]
        rendered = {}
        for name, Cluster, db, P in (
                ("port", ClusterRuntime, fresh_db(), TP),
                ("ref", RefClusterRuntime, fresh_ref(), RP)):
            cl = Cluster(db, n_workers=4,
                         partition_keys={"tasks": "t_role_id"},
                         affinity={"W_E": "worklist"}, max_batch=8)
            cl.register(P.make_wilos_e())
            cl.serve(stream)
            rows = cl.triage()
            rendered[name] = (render_triage if name == "port"
                              else ref_render_triage)(rows)
            if name == "port":
                row = next(r for r in rows if r.name == "W_E")
                assert row.shard_requests == (24, 0, 0, 0)
                assert row.hot_shard == 0
                assert row.skew == pytest.approx(4.0)
        assert "hot" in rendered["port"] and "24/0/0/0" in rendered["port"]
        assert rendered["port"] == rendered["ref"]

    def test_tracer_sees_flush_and_scatter_spans(self):
        tracer = Tracer()
        cl = ClusterRuntime(fresh_db(), n_workers=2,
                            partition_keys={"tasks": "t_role_id"},
                            affinity={"W_E": "worklist"},
                            max_batch=4, tracer=tracer)
        cl.register(TP.make_wilos_e())
        cl.serve([("W_E", {"worklist": [i]}) for i in range(8)])
        names = {s.name for s in tracer.spans()}
        assert {"cluster_serve", "flush", "scatter-gather"} <= names

    def test_telemetry_shape(self):
        r2, cl = serve_cluster(example_stream(12), 2)
        t = cl.telemetry()
        assert t["requests_served"] == len(r2)
        assert len(t["worker_requests"]) == 2
        assert sum(t["worker_requests"]) == len(r2)
        assert t["router_routed"] == len(r2)
        assert t["makespan_s"] > 0
