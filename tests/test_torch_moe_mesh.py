"""The port's MoE layer under a mesh routes each rank's own tokens only.

Four gloo ranks are spawned once for the module (in a subprocess with a
timeout; each rank's process group has its own timeout). On meshes (2, 2)
and (4, 1), under ``fsdp_tp_ep``, ``fsdp_tp`` and (on (2, 2), the tokens
sharded on the sequence) ``fsdp_tp_sp``, ``layers.moe`` with fp32
parameters runs on the same numpy-seeded input as ``moe`` in one process:

  * ``y`` and ``aux`` within 1e-6 (absolute), and every gradient leaf
    (the input's and the parameters') within 1e-5 of its peak;
  * each rank's ``keep`` and ``dst`` (``moe_dispatch_sharded``), gathered
    in token order, EQUAL to one process's ``moe_dispatch``: at the
    default capacity factor, at 0.5 (experts overflow, so positions
    counted per rank, or a capacity of the local batch, would drop other
    assignments), and with a zero router (every probability ties: the
    top k are experts 0..k-1, each far over its capacity).

Three configurations: llama4 ``scaled()`` (top 1 with a shared expert),
kimi-k2 ``scaled()`` (top 8 of 8 experts with a shared expert) and a
top-2 variant of llama4 without one.

Then, on meta tensors on a fake group of 8 ranks (the dry-run's counter),
meshes (1, 8), (2, 4) and (4, 2): the layer's router product counts
``2·(n/D)·d·E`` flops a rank, and its collectives (experts sharded on the
model axis alone, so the expert products move nothing) stay below the
``n·d + E·cap·d`` elements of gathering the tokens and the expert
outputs to every rank, at exactly the (E/M, cap, d) block summed over
the data axis, the (n/D, d) outputs summed over the model axis, the
per-row counts and the router means.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMON = r"""
import dataclasses
import numpy as np
import torch
from repro_torch.models import get_arch, layers
from repro_torch.models.arch import register_arch

register_arch(dataclasses.replace(
    get_arch("llama4-scout-17b-a16e").scaled(), name="moe-top2", top_k=2,
    n_shared_experts=0))
ARCHS = ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "moe-top2")


def arch(name, cf=None):
    cfg = get_arch(name)
    cfg = cfg if name == "moe-top2" else cfg.scaled()
    return cfg if cf is None else dataclasses.replace(cfg, capacity_factor=cf)


def moe_params(cfg, zero_router=False):
    p = layers.init_moe(torch.Generator().manual_seed(0), cfg)
    p = {k: ({kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict)
             else v.float()) for k, v in p.items()}
    if zero_router:
        p["router"] = torch.zeros_like(p["router"])
    return p
"""

SCRIPT = COMMON + r"""
import datetime, json, queue, socket, sys, traceback
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import (distribute_tree, make_policy,
                                         param_specs)
from repro_torch.optim import tree_leaves

B, T = 8, 32
CASES = [(a, s, mesh, cf, False)
         for a in ARCHS for mesh in ((2, 2), (4, 1))
         for s in ("fsdp_tp_ep", "fsdp_tp") for cf in (None, 0.5)]
CASES += [(a, "fsdp_tp_sp", (2, 2), cf, False) for a in ARCHS
          for cf in (None, 0.5)]
CASES += [(a, s, (2, 2), cf, True) for a in ("llama4-scout-17b-a16e",
                                              "moe-top2")
          for s in ("fsdp_tp_ep", "fsdp_tp") for cf in (None, 0.5)]


def name(a, s, mesh, cf, zero):
    return f"{a}/{s}/{mesh[0]}x{mesh[1]}/cf={cf}" + ("/zero" if zero else "")


def inputs(cfg):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((B, T, cfg.d_model),
                                             dtype=np.float32))
    c = torch.from_numpy(rng.standard_normal((B, T, cfg.d_model),
                                             dtype=np.float32))
    return x, c


def grads(fn, x, params):
    leaves = [x] + tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    y, aux, loss = fn(x, params)
    return y.detach(), aux.detach(), torch.autograd.grad(loss, leaves)


def one_process(cfg, zero):
    params = moe_params(cfg, zero)
    x, c = inputs(cfg)

    def fn(x, p):
        y, aux = layers.moe(p, x, cfg)
        return y, aux, (y * c).sum() + aux
    y, aux, g = grads(fn, x, params)
    _, _, _, keep, dst, cap = layers.moe_dispatch(
        params, x.reshape(-1, cfg.d_model), cfg)
    return y, aux, g, keep, dst


def on_mesh(cfg, zero, strategy, shape):
    mesh = make_mesh(shape, ("data", "model"))
    pol = make_policy(mesh, strategy)
    params = moe_params(cfg, zero)
    tree = distribute_tree(mesh, param_specs({"layers": [{"moe": params}]},
                                             cfg, mesh, strategy),
                           {"layers": [{"moe": params}]})["layers"][0]["moe"]
    x, c = inputs(cfg)
    x_pl = pol.placements_for("act_btd", x.shape)
    xd = distribute_tensor(x, mesh, x_pl)
    cd = distribute_tensor(c, mesh, x_pl)

    def fn(x, p):
        y, aux = layers.moe(p, x, cfg, pol)
        return y, aux, ((y * cd).sum() + aux).full_tensor()
    y, aux, g = grads(fn, xd, tree)
    out = layers.moe_dispatch_sharded(params["router"], xd.detach(), cfg)
    k = cfg.top_k

    def full(t):      # a rank's (n_l·k,) in global token order
        xl = xd.to_local()
        return DTensor.from_local(t.view(*xl.shape[:2], k), mesh, x_pl,
                                  run_check=False).full_tensor().reshape(-1)
    return (y.full_tensor(), aux.full_tensor(), [t.full_tensor() for t in g],
            full(out[3].to(torch.int64)).bool(), full(out[4]),
            [p.dim if p.is_shard() else None for p in x_pl])


def compare(case):
    a, s, shape, cf, zero = case
    cfg = arch(a, cf)
    y1, aux1, g1, keep1, dst1 = one_process(cfg, zero)
    y, aux, g, keep, dst, x_pl = on_mesh(cfg, zero, s, shape)
    return {"y_err": float((y - y1).abs().max()),
            "y_peak": float(y1.abs().max()),
            "aux_err": float((aux - aux1).abs()),
            "grad_rel": [float((u - w).abs().max() / w.abs().max())
                         for u, w in zip(g, g1)],
            "top_k": cfg.top_k, "cap": layers.moe_capacity(B * T, cfg),
            "keep_equal": bool(torch.equal(keep, keep1)),
            "dst_equal": bool(torch.equal(dst, dst1)),
            "dropped": int((~keep1).sum()), "assignments": keep1.numel(),
            "x_placements": x_pl}


def worker(rank, port, q):
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=4,
                                timeout=datetime.timedelta(seconds=120))
        torch.manual_seed(0)
        q.put((rank, {name(*c): compare(c) for c in CASES}, None))
        dist.destroy_process_group()
    except BaseException:
        q.put((rank, None, traceback.format_exc()))
        raise


if __name__ == "__main__":
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=worker, args=(r, port, q)) for r in range(4)]
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
    print(json.dumps(results))
"""

DRYRUN = COMMON + r"""
import json
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_group, make_mesh
from repro_torch.launch.sharding import (distribute_tree, make_policy,
                                         param_specs)

# the dry-run test's llama4 cell: d 64, 8 x 128 tokens, 8 experts, top 1
B, T = 8, 128


class Counter(dryrun._LocalCounter):
    # the router product: the one local (n_l, d) @ (d, E) product
    def __init__(self, d, E):
        super().__init__()
        self.d, self.E, self.router = d, E, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func.overloadpacket is torch.ops.aten.mm and out is not \
                NotImplemented and tuple(args[1].shape) == (self.d, self.E):
            self.router.append(list(args[0].shape))
        return out


def count(cfg, shape, strategy):
    mesh = make_mesh(shape, ("data", "model"))
    pol = make_policy(mesh, strategy if strategy != "experts" else "fsdp_tp")
    params = {k: (torch.empty(v.shape, dtype=v.dtype, device="meta")
                  if torch.is_tensor(v) else
                  {kk: torch.empty(vv.shape, dtype=vv.dtype, device="meta")
                   for kk, vv in v.items()})
              for k, v in layers.init_moe(torch.Generator(), cfg).items()}
    if strategy == "experts":
        # the experts on the model axis, nothing else sharded
        pol = make_policy(mesh, "fsdp_tp")
        params = {k: distribute_tensor(v, mesh, [Replicate()] + [
            Shard(0) if k != "router" else Replicate()])
            for k, v in params.items()}
    else:
        tree = {"layers": [{"moe": params}]}
        params = distribute_tree(mesh, param_specs(tree, cfg, mesh, strategy),
                                 tree)["layers"][0]["moe"]
    x = torch.empty((B, T, cfg.d_model), dtype=torch.bfloat16, device="meta")
    x = distribute_tensor(x, mesh, pol.placements_for("act_btd", x.shape))
    c = Counter(cfg.d_model, cfg.n_experts)
    with dryrun._plain_kernels(), c:
        layers.moe(params, x, cfg, pol)
    return {"router_mm": c.router, "flops": c.flops,
            "coll_bytes": c.coll_bytes, "coll_counts": c.coll_counts}


base = get_arch("llama4-scout-17b-a16e").scaled(
    n_layers=6, d_model=64, n_heads=4, d_ff=128, vocab=512)
out = {}
with fake_group(8):
    for shape in ((1, 8), (2, 4), (4, 2)):
        for strategy, cfg in (
                ("fsdp_tp_ep", base),
                ("experts", dataclasses.replace(base, n_shared_experts=0))):
            out[f"{shape[0]}x{shape[1]}/{strategy}"] = dict(
                count(cfg, shape, strategy), D=shape[0], M=shape[1],
                n=B * T, d=cfg.d_model, E=cfg.n_experts, k=cfg.top_k,
                cap=layers.moe_capacity(B * T, cfg))
print(json.dumps(out))
"""


def _run(script, timeout):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    script = tmp_path_factory.mktemp("moe_mesh") / "moe_mesh.py"
    script.write_text(SCRIPT)           # spawned workers import it by path
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(out) == ["0", "1", "2", "3"]
    return out


@pytest.fixture(scope="module")
def counts():
    return _run(DRYRUN, 300)


ARCHS = ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "moe-top2")
CASES = [f"{a}/{s}/{m}/cf={cf}" for a in ARCHS for m in ("2x2", "4x1")
         for s in ("fsdp_tp_ep", "fsdp_tp") for cf in (None, 0.5)]
CASES += [f"{a}/fsdp_tp_sp/2x2/cf={cf}" for a in ARCHS for cf in (None, 0.5)]
CASES += [f"{a}/{s}/2x2/cf={cf}/zero" for a in ("llama4-scout-17b-a16e",
                                               "moe-top2")
          for s in ("fsdp_tp_ep", "fsdp_tp") for cf in (None, 0.5)]


@pytest.mark.parametrize("case", CASES)
def test_moe_on_a_mesh_matches_one_process(ranks, case):
    """Routing equal to the bit, values within fp32 roundings of the
    sharded contractions (1e-6 of y's peak), every gradient leaf within
    1e-5 of its peak. But the router's under top-1 routing: a single
    renormalised gate is 1, so the gates give the router no gradient in
    exact arithmetic, and what they give in fp32 is rounding noise of
    g / g times the expert rows, whose last bits differ between the two
    runs; the aux loss's part, which the noise sits on, is held to 1e-3."""
    for rank, out in ranks.items():
        r = out[case]
        assert r["keep_equal"] and r["dst_equal"], (rank, case, r)
        assert r["y_err"] <= 1e-6 * r["y_peak"], (rank, case, r)
        assert r["aux_err"] <= 1e-6, (rank, case, r)
        x_grad, router_grad, *rest = r["grad_rel"]
        assert max([x_grad] + rest) <= 1e-5, (rank, case, r)
        assert router_grad <= (1e-3 if r["top_k"] == 1 else 1e-5), \
            (rank, case, r)


def test_cases_overflow_and_shard_the_tokens(ranks):
    """The cases test what they claim: at cf 0.5 experts overflow, with a
    zero router every token takes experts 0..k-1, which keep their
    capacity and drop the rest, and under sequence parallelism the tokens
    shard on T."""
    out = ranks["0"]
    for case in CASES:
        r = out[case]
        if "cf=0.5" in case:
            assert r["dropped"] > 0, (case, r)
        if case.endswith("/zero"):
            assert r["dropped"] == r["assignments"] - r["top_k"] * r["cap"], \
                (case, r)
        if "fsdp_tp_sp" in case:
            assert r["x_placements"] == [1, None], (case, r)
        else:
            assert r["x_placements"][0] == 0, (case, r)


@pytest.mark.parametrize("cell", ["1x8", "2x4", "4x2"])
def test_router_flops_split_over_the_data_axis(counts, cell):
    for strategy in ("fsdp_tp_ep", "experts"):
        c = counts[f"{cell}/{strategy}"]
        assert c["router_mm"] == [[c["n"] // c["D"], c["d"]]], c


@pytest.mark.parametrize("cell", ["1x8", "2x4", "4x2"])
def test_exchange_moves_own_rows_not_gathered_copies(counts, cell):
    c = counts[f"{cell}/experts"]
    n, d, E, cap, D, M = (c[k] for k in ("n", "d", "E", "cap", "D", "M"))
    got = sum(c["coll_bytes"].values())
    gathered = (n * d + E * cap * d) * 2           # bf16 elements
    assert got < gathered, c
    own = ((E // M * cap * d if D > 1 else 0)
           + (n // D * d if M > 1 else 0)) * 2
    # besides the rows: each row's per-expert counts (int64) and the
    # router means (E fp32), over the data axis
    small = (8 * E * 8 + 4 * E) if D > 1 else 0
    assert got == own + small, c
