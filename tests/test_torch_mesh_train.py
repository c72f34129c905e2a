"""The port's training loop on a (2, 2) mesh of four gloo ranks, on the CPU.

Four processes are spawned once for the module (in a subprocess with a
timeout; each rank's process group has its own timeout, so nothing can
hang), and each runs ``launch.train.train`` with ``mesh_shape=(2, 2)``:

  * smoke danube under ``dp``, ``fsdp``, ``tp`` and ``fsdp_tp``, llama4
    under ``fsdp_tp_ep``, and one more strategy for each other family
    (rwkv6, zamba2 under sequence parallelism, minicpm3's MLA, kimi-k2's
    MoE), and a danube with one KV head for four query heads under
    ``tp`` and ``fsdp_tp`` (each rank's query heads read a slice of the
    replicated K/V, whose gradients are summed over the model axis), 3
    steps each: the losses within rtol 1e-4 of the one-process port run;
  * every gradient leaf of one step of danube and of the one-KV-head
    danube on the mesh within 1e-5 of one process's (of the leaf's peak);
  * the failure drill across strategies: a run under ``fsdp_tp`` that
    crashes at step 4 (checkpoint at step 3), resumed under ``dp``, lands
    on the uninterrupted ``fsdp_tp`` run within 1e-4; and
    ``Checkpointer.restore(..., shardings=)`` places each leaf by its
    strategy's spec (the same values under ``dp`` and ``fsdp_tp``).

The parameters are carried in fp32 (``init_params`` cast, in every run;
so no architecture whose inputs are bf16 embeddings, qwen2-vl or
seamless, is among them):
a sharded contraction sums each shard's partial product in the
activations' type before the all-reduce, as XLA's SPMD does, so in bf16
the losses of ``tp`` differ from one process's by bf16 roundings (~1e-3),
not by the port's fault.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import dataclasses, datetime, json, os, queue, socket, sys, traceback
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import repro_torch.launch.train as T
from repro_torch.checkpoint import Checkpointer
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import (batch_specs, distribute_tree,
                                         make_policy, named_sharding,
                                         param_specs)
from repro_torch.models import get_arch, loss_fn
from repro_torch.models.arch import register_arch
from repro_torch.models.model import dtensor_region
from repro_torch.optim import tree_leaves, tree_map

# one KV head for four query heads: on the 2-way model axis each rank holds
# two query heads and slices the replicated KV head they read
register_arch(dataclasses.replace(
    get_arch("h2o-danube-1.8b").scaled(n_kv_heads=1), name="danube-kv1"))

_init = T.init_params
T.init_params = lambda g, a: tree_map(
    lambda t: t.float() if t.is_floating_point() else t, _init(g, a))
BASE = dict(steps=3, global_batch=8, seq_len=16, log_every=1, device="cpu")
RUNS = [(f"h2o-danube-1.8b/{s}", dict(BASE, arch="h2o-danube-1.8b",
                                      strategy=s))
        for s in ("dp", "fsdp", "tp", "fsdp_tp")]
RUNS += [(f"{a}/{s}", dict(BASE, arch=a, strategy=s))
         for a, s in (("llama4-scout-17b-a16e", "fsdp_tp_ep"),
                      ("rwkv6-3b", "fsdp_tp"), ("zamba2-1.2b", "fsdp_tp_sp"),
                      ("minicpm3-4b", "tp"), ("kimi-k2-1t-a32b", "fsdp_tp"))]
RUNS += [(f"danube-kv1/{s}", dict(BASE, arch="danube-kv1", scale="full",
                                  strategy=s)) for s in ("tp", "fsdp_tp")]
DRILL = dict(BASE, arch="h2o-danube-1.8b", steps=6, ckpt_every=3)
GRADS = [("h2o-danube-1.8b", "fsdp_tp"), ("danube-kv1", "tp"),
         ("danube-kv1", "fsdp_tp")]
quiet = lambda *_: None


# the largest gap between a gradient leaf on the (2, 2) mesh and in one
# process (the same fp32 parameters and batch), over the leaf's peak
def grad_err(arch, strategy):
    cfg = get_arch(arch)
    if arch == "h2o-danube-1.8b":
        cfg = cfg.scaled()
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (8, 16), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    mesh = make_mesh((2, 2), ("data", "model"))
    dp = distribute_tree(mesh, param_specs(params, cfg, mesh, strategy),
                         params)
    db = distribute_tree(mesh, batch_specs(mesh, batch), batch)
    got, want = [], []
    for tree, b, pol, out in (
            (dp, db, make_policy(mesh, strategy), got),
            (params, batch, T.NullPolicy(), want)):
        leaves = tree_leaves(tree)
        for p in leaves:
            p.requires_grad_(True)
        with dtensor_region(tree is dp):
            loss = loss_fn(tree, cfg, b, pol=pol)
            if tree is dp:
                loss = loss.full_tensor()
            out += torch.autograd.grad(loss, leaves)
    return max(float((a.full_tensor() - w).abs().max() / w.abs().max())
               for a, w in zip(got, want) if w.abs().max() > 0)


def losses(out):
    return [l for _, l in out["losses"]]


def worker(rank, port, tmp, q):
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4,
                                timeout=datetime.timedelta(seconds=120))
        out = {}
        for name, kw in RUNS:
            out[name] = losses(T.train(T.TrainConfig(mesh_shape=(2, 2), **kw),
                                       quiet))
        for arch, s in GRADS:
            out[f"grads/{arch}/{s}"] = grad_err(arch, s)
        out["drill/uninterrupted"] = losses(T.train(T.TrainConfig(
            mesh_shape=(2, 2), strategy="fsdp_tp",
            ckpt_dir=os.path.join(tmp, "a"), **DRILL), quiet))
        crash = os.path.join(tmp, "b")
        try:
            T.train(T.TrainConfig(mesh_shape=(2, 2), strategy="fsdp_tp",
                                  ckpt_dir=crash, fail_at=4, **DRILL), quiet)
            raise AssertionError("no injected failure")
        except RuntimeError as e:
            assert "injected failure" in str(e)
        dist.barrier()   # rank 0's checkpoint is on disk for every rank
        seen = []
        out["drill/resumed_dp"] = losses(T.train(T.TrainConfig(
            mesh_shape=(2, 2), strategy="dp", ckpt_dir=crash, **DRILL),
            seen.append))
        out["drill/resume_line"] = seen[0]
        cfg = get_arch("h2o-danube-1.8b").scaled()
        mesh = make_mesh((2, 2), ("data", "model"))
        template = {"params": T.init_params(
            torch.Generator().manual_seed(0), cfg)}
        placed = {}
        for s in ("dp", "fsdp_tp"):
            shard = {"params": named_sharding(mesh, param_specs(
                template["params"], cfg, mesh, s))}
            _, tree, _ = Checkpointer(crash).restore(template, step=3,
                                                     shardings=shard)
            leaves = tree_leaves(tree["params"])
            placed[s] = {
                "placements": sorted({str(tuple(map(str, t.placements)))
                                      for t in leaves}),
                "values": [t.full_tensor() for t in leaves]}
        out["restore/placements"] = {s: placed[s]["placements"]
                                     for s in placed}
        out["restore/same_values"] = all(
            torch.equal(a, b) for a, b in zip(placed["dp"]["values"],
                                              placed["fsdp_tp"]["values"]))
        q.put((rank, out, None))
        dist.destroy_process_group()
    except BaseException:
        q.put((rank, None, traceback.format_exc()))
        raise


if __name__ == "__main__":
    tmp = sys.argv[1]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=worker, args=(r, port, tmp, q))
             for r in range(4)]
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < len(procs):
            try:
                rank, out, err = q.get(timeout=5)
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead:
                    sys.exit(f"a rank died: exit codes {dead}")
                continue
            if err is not None:
                sys.exit(f"rank {rank} failed:\n{err}")
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    single = {}
    for name, kw in RUNS:
        single[name] = losses(T.train(T.TrainConfig(**kw), quiet))
    single["drill"] = losses(T.train(T.TrainConfig(**DRILL), quiet))
    print(json.dumps({"ranks": results, "single": single}))
"""

STRATEGY_RUNS = ["h2o-danube-1.8b/dp", "h2o-danube-1.8b/fsdp",
                 "h2o-danube-1.8b/tp", "h2o-danube-1.8b/fsdp_tp",
                 "llama4-scout-17b-a16e/fsdp_tp_ep", "rwkv6-3b/fsdp_tp",
                 "zamba2-1.2b/fsdp_tp_sp", "minicpm3-4b/tp",
                 "kimi-k2-1t-a32b/fsdp_tp", "danube-kv1/tp",
                 "danube-kv1/fsdp_tp"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    script = tmp / "mesh_train.py"     # spawned workers import it by path
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, str(script), str(tmp)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    ranks = out["ranks"]
    assert sorted(ranks) == ["0", "1", "2", "3"]
    return ranks, out["single"]


@pytest.mark.parametrize("run", ["h2o-danube-1.8b/fsdp_tp", "danube-kv1/tp",
                                 "danube-kv1/fsdp_tp"])
def test_mesh_gradients_match_one_process(results, run):
    """Every gradient leaf on the mesh equals one process's within fp32
    roundings: with one KV head for four query heads, each rank's K/V
    gradient is a partial sum that the model axis adds up (a loss within
    1e-4 after two AdamW steps would not see a missing term)."""
    ranks, _ = results
    for rank, out in ranks.items():
        assert out[f"grads/{run}"] <= 1e-5, (rank, run, out[f"grads/{run}"])


@pytest.mark.parametrize("run", STRATEGY_RUNS)
def test_mesh_training_matches_one_process(results, run):
    ranks, single = results
    want = single[run]
    for rank, out in ranks.items():
        got = out[run]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert abs(g - w) <= 1e-4 * abs(w), (rank, run, got, want)


def test_resume_under_another_strategy_lands_on_the_uninterrupted_run(
        results):
    ranks, single = results
    for rank, out in ranks.items():
        assert out["drill/resume_line"] == "[resume] step 3"
        full = out["drill/uninterrupted"]
        resumed = out["drill/resumed_dp"]
        assert len(full) == 6 and len(resumed) == 3
        for g, w in zip(resumed, full[3:]):
            assert abs(g - w) <= 1e-4 * abs(w), (rank, resumed, full)
        for g, w in zip(full, single["drill"]):
            assert abs(g - w) <= 1e-4 * abs(w), (rank, full, single["drill"])


def test_restore_with_shardings_places_each_leaf(results):
    ranks, _ = results
    for rank, out in ranks.items():
        placements = out["restore/placements"]
        assert placements["dp"] == ["('R', 'R')"]
        assert len(placements["fsdp_tp"]) > 1      # sharded leaves among them
        assert out["restore/same_values"]
