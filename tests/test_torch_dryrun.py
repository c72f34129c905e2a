"""The port's dry-run on a small (2×4) mesh: the mirror of
``tests/test_dryrun_small.py``, in a subprocess so the fake process group
never leaks into this test session.

Validates:
  * the train and decode steps of a reduced dense arch and a reduced MoE
    arch run on meta DTensors on a 2×4 (data, model) mesh under fsdp_tp
    (train cells under ``remat="full"``), and shard: collectives > 0;
  * the two-point layer extrapolation against the full-depth count (the
    port's layer loop is always unrolled);
  * the collective types of danube's train cell;
  * GQA attention on a 16-way model axis (32 query heads, 8 KV heads):
    each rank counts the flops of its 2 query heads, not all 32;
  * ``run_cell``'s record on the 16×16 production mesh (a fake group of
    256 ranks, a small shape): the reference's keys, ``null`` with a note
    where torch has no counterpart (lower/compile times, XLA's temp and
    code sizes), and ``analysis.report`` renders it.
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.analysis.report import dryrun_summary, roofline_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import dataclasses, json, sys
from repro_torch.configs import SHAPES
from repro_torch.models.arch import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_group, make_mesh
from repro_torch.launch.sharding import make_policy

# small shapes so the cells run fast
SHAPES["train_4k"] = dict(seq_len=128, global_batch=8, kind="train")
SHAPES["decode_32k"] = dict(seq_len=128, global_batch=8, kind="decode")

out = {}
with fake_group(8):
    mesh = make_mesh((2, 4), ("data", "model"))

    def cell(cfg, shape, kind):
        pol = make_policy(mesh, strategy="fsdp_tp",
                          remat="full" if kind == "train" else "none",
                          microbatch=1)
        return dryrun._measure(cfg, shape, kind, pol)

    for arch in ("h2o-danube-1.8b", "llama4-scout-17b-a16e"):
        base = get_arch(arch).scaled(n_layers=6, d_model=64, n_heads=4,
                                     d_ff=128, vocab=512)
        for shape, kind in (("train_4k", "train"), ("decode_32k", "decode")):
            full = cell(base, shape, kind)
            f2 = cell(dataclasses.replace(base, n_layers=2), shape, kind)
            f4 = cell(dataclasses.replace(base, n_layers=4), shape, kind)
            extrap = f2["flops"] + (6 - 2) * (f4["flops"] - f2["flops"]) / 2
            b_extrap = f2["bytes"] + (6 - 2) * (f4["bytes"] - f2["bytes"]) / 2
            coll = full["collectives"]
            out[f"{arch}/{shape}"] = {
                "flops_full": full["flops"], "flops_extrap": extrap,
                "rel_err": abs(extrap - full["flops"]) / max(full["flops"], 1.0),
                "bytes_full": full["bytes"], "bytes_extrap": b_extrap,
                "n_collectives": sum(coll["counts"].values()),
                "coll_types": sorted(coll["counts"]),
                "coll_bytes": coll["bytes_per_device"],
                "memory": full["memory"],
            }
# danube's heads on a 16-way model axis: 32 query heads, 8 KV heads
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.kernels import ops, ref
meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
with fake_group(16):
    mesh = make_mesh((1, 16), ("data", "model"))
    q = distribute_tensor(meta(2, 32, 64, 16), mesh, [Replicate(), Shard(1)])
    kv = [distribute_tensor(meta(2, 8, 64, 16), mesh, [Replicate()] * 2)
          for _ in range(2)]
    flops = {}
    for name, args in (("sharded", (q, *kv)),
                       ("replicated", (q.redistribute(mesh, [Replicate()] * 2),
                                       *kv))):
        c = dryrun._LocalCounter()
        with dryrun._plain_kernels(), c:
            o = ops.attention(*args)
        flops[name] = c.flops
        flops[name + "_out"] = list(o.to_local().shape)
    for name, h, kvh in (("two_heads", 2, 1), ("all_heads", 32, 8)):
        c = dryrun._LocalCounter()
        with c:
            ref.flash_attention_ref(meta(2, h, 64, 16), meta(2, kvh, 64, 16),
                                    meta(2, kvh, 64, 16))
        flops[name] = c.flops
out["attention_16_way"] = flops
rec = dryrun.run_cell("h2o-danube-1.8b", "decode_32k", verbose=False)
with open(sys.argv[1], "w") as f:
    json.dump(rec, f)
print(json.dumps(out))
"""

# the keys the reference's run_cell writes (src/repro/launch/dryrun.py)
REF_KEYS = {"arch", "shape", "kind", "mesh", "n_devices", "status", "tokens",
            "policy", "full_compile", "full_collective_counts", "accounting",
            "flops_per_device", "bytes_per_device", "collectives",
            "roofline"}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    rec_path = d / "h2o-danube-1.8b__decode_32k__16x16.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(rec_path)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(rec_path) as f:
        rec = json.load(f)
    return json.loads(proc.stdout.strip().splitlines()[-1]), rec, str(d)


def _cells(results):
    return {k: v for k, v in results.items() if "/" in k}


def test_gqa_attention_splits_query_heads_on_a_16_way_axis(run):
    """32 query heads and 8 KV heads on 16 model ranks: each rank runs its
    2 query heads on the one KV head they read (the reference shards q
    and replicates K/V), so a rank counts the flops of 2 heads, a 16th of
    the 32 that a replicated q would run on every rank."""
    results, _, _ = run
    f = results["attention_16_way"]
    assert f["sharded"] == f["two_heads"] > 0, f
    assert f["sharded_out"] == [2, 2, 64, 16], f
    assert f["replicated"] == f["all_heads"] == 16 * f["two_heads"], f
    assert f["replicated_out"] == [2, 32, 64, 16], f


def test_cells_run_and_shard(run):
    results, _, _ = run
    results = _cells(results)
    assert len(results) == 4
    for tag, r in results.items():
        assert r["n_collectives"] > 0, f"{tag}: no collectives — not sharded?"
        assert r["coll_bytes"] > 0, tag
        assert r["memory"]["argument_size_in_bytes"] > 0, tag


def test_two_point_extrapolation_exact(run):
    """The layer stacks are homogeneous, so the linear extrapolation must
    match the full-depth count (the reference's bound: 6 %, or an absolute
    error under 1e6 where the decode cells' intercept dominates)."""
    results, _, _ = run
    for tag, r in _cells(results).items():
        abs_err = abs(r["flops_extrap"] - r["flops_full"])
        assert r["rel_err"] < 0.06 or abs_err < 1e6, (tag, r)


def test_bytes_extrapolate_and_count_no_allocation(run):
    """The bytes of a cell grow by the same amount a layer, whichever cell
    a process measures first (the first run of an op under DTensor
    allocates buffers, which move nothing), so the two-point extrapolation
    lands on the full-depth count, and the record's bytes are positive."""
    results, rec, _ = run
    for tag, r in _cells(results).items():
        assert r["bytes_full"] > 0, (tag, r)
        assert abs(r["bytes_extrap"] - r["bytes_full"]) \
            <= 0.06 * r["bytes_full"], (tag, r)
    assert rec["bytes_per_device"] > 0
    assert rec["roofline"]["memory_s"] > 0


def test_expected_collective_types(run):
    results, _, _ = run
    train = results["h2o-danube-1.8b/train_4k"]
    assert any(t in train["coll_types"] for t in ("all-reduce", "all-gather",
                                                  "reduce-scatter"))


def test_train_cells_save_less_under_remat_than_they_hold(run):
    """Under remat="full" only each layer's inputs are saved: a train cell
    saves activations, a decode cell (no grad) none."""
    results, _, _ = run
    for arch in ("h2o-danube-1.8b", "llama4-scout-17b-a16e"):
        assert results[f"{arch}/train_4k"]["memory"][
            "saved_activation_bytes"] > 0
        assert results[f"{arch}/decode_32k"]["memory"][
            "saved_activation_bytes"] == 0


def test_run_cell_record_has_the_reference_keys(run):
    _, rec, _ = run
    assert REF_KEYS <= set(rec), REF_KEYS - set(rec)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["mesh"] == "16x16"
    # what torch cannot reproduce is null, with a note naming why
    assert rec["full_compile"]["lower_s"] is None
    assert rec["full_compile"]["compile_s"] is None
    mem = rec["full_compile"]["memory"]
    assert mem["temp_size_in_bytes"] is None
    assert mem["generated_code_size_in_bytes"] is None
    assert {"lower_s", "memory", "flops"} <= set(rec["note"])
    # the full-depth count checks the extrapolation
    assert rec["flops_per_device"] == pytest.approx(
        rec["full_flops_per_device"], rel=1e-9)
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")


def test_report_renders_the_records(run):
    _, _, out_dir = run
    table = roofline_table(out_dir, mesh="16x16")
    assert "| h2o-danube-1.8b | decode_32k |" in table
    assert "ERROR" not in table
    assert "mesh 16x16: 1 compiled ok" in dryrun_summary(out_dir)
