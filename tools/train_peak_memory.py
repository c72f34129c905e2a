#!/usr/bin/env python3
"""Peak device memory, step walls and losses of ``launch.train.train`` at
several batch sizes, on one NVIDIA GPU: how ``chip_smoke.py`` sizes a
training phase's batch.

    python3 tools/train_peak_memory.py [--arch NAME] [--batch N ...]
                                       [--steps S] [--microbatch M]
                                       [--remat none|full|dots]
                                       [--strategy S]
                                       [--scan-bwd-body simt] [--nudge P]

For each batch (rows of 2,048 tokens, ``chip_smoke.TRAIN_T``), in the
order given, it trains the architecture at its published configuration
from seeded weights with the loop's AdamW and the ``SyntheticLM`` stream
for ``--steps`` steps, the batch split into ``--microbatch`` equal
microbatches whose gradients add up in fp32, and prints one JSON line:
``torch.cuda.max_memory_allocated`` over the run, each step's wall (host
clock to a synchronize), the losses and the kernels' launch counts (the
scan backward's by body too); a
batch that runs out of memory prints ``"oom": true`` and the next batch
still runs. Then the card's name and power limit as ``nvidia-smi`` gives
them. Imports nothing of JAX.

With ``--remat`` (other than ``none``) or ``--strategy``, the loop trains
on a 1×1 mesh of the card (``mesh_shape=(1, 1)`` in a one-rank NCCL
group, ``launch.mesh.card_group``) under ``make_policy(mesh, strategy,
remat=...)``: DTensor parameters, optimizer state and batches, each
layer's block under ``torch.utils.checkpoint``.

Two switches witness how far rounding alone moves the losses:
``--scan-bwd-body simt`` runs RWKV6's scan backward on its CUDA-core body
wherever ``scan_bwd_body`` would pick the tensor-core one, and ``--nudge
P`` moves a share ``P`` of the seeded weights' elements (drawn from a
generator seeded 1) one unit in the last place of their type away from
zero before the first step.
"""

import argparse
import contextlib
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

DEVICE = "cuda"
SEQ_LEN = 2048   # tokens a row: chip_smoke.TRAIN_T


def sync():
    import torch
    torch.cuda.synchronize()


def nudge(params, share):
    """``params`` (a tree of tensors) with a share ``share`` of every
    floating leaf's elements, drawn from a generator seeded 1, moved one
    unit in the last place away from zero in place: the bits read as an
    integer of the same width, plus one."""
    import torch
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    gen = None

    def walk(tree):
        nonlocal gen
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
        elif torch.is_tensor(tree) and tree.is_floating_point():
            if gen is None:
                gen = torch.Generator(device=tree.device).manual_seed(1)
            pick = torch.rand(tree.shape, generator=gen,
                              device=tree.device) < share
            tree.view(ints[tree.element_size()]).add_(pick.to(
                ints[tree.element_size()]))
    walk(params)
    return params


def run(arch_name, batch, steps, microbatch, mesh_shape=None,
        strategy="dp"):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    walls = []
    make = train_mod.make_train_step

    def timed_make(*a, **kw):
        fn = make(*a, **kw)

        def step(*args):
            sync()
            t0 = time.perf_counter()
            out = fn(*args)
            sync()
            walls.append(time.perf_counter() - t0)
            return out
        return step

    cfg = train_mod.TrainConfig(arch=arch_name, scale="full", steps=steps,
                                global_batch=batch, seq_len=SEQ_LEN,
                                microbatch=microbatch, log_every=1,
                                device=DEVICE, mesh_shape=mesh_shape,
                                strategy=strategy)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    train_mod.make_train_step = timed_make
    line = {"arch": arch_name, "batch": batch, "seq_len": SEQ_LEN,
            "microbatch": microbatch, "steps": steps,
            "mesh_shape": mesh_shape, "strategy": strategy}
    try:
        out = train_mod.train(cfg, progress=lambda _: None)
        line["losses"] = [loss for _, loss in out["losses"]]
        del out
    except torch.cuda.OutOfMemoryError as e:
        line["oom"] = True
        line["error"] = str(e).splitlines()[0]
    finally:
        train_mod.make_train_step = make
    line.update(peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                step_s=walls, launches={k: n for k, n in
                                        ops.launch_counts().items() if n},
                scan_bwd_launches_by_body={
                    k: n for k, n in
                    ops.rwkv6_scan_bwd.launches_by_body.items() if n})
    torch.cuda.empty_cache()
    return line


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--remat", choices=["none", "full", "dots"],
                    default="none")
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--scan-bwd-body", choices=["simt"])
    ap.add_argument("--nudge", type=float, default=0.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_peak_memory.py: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.scan_bwd_body:
        rs = importlib.import_module("repro_torch.kernels.rwkv6_scan")
        rs.scan_bwd_body = lambda *_: args.scan_bwd_body
    if args.nudge:
        from repro_torch.launch import train as train_mod
        make = train_mod.init_params
        train_mod.init_params = lambda *a, **kw: nudge(make(*a, **kw),
                                                       args.nudge)
    meshed = args.remat != "none" or args.strategy is not None
    with contextlib.ExitStack() as stack:
        if meshed:
            from repro_torch.launch import train as train_mod
            from repro_torch.launch.mesh import card_group
            stack.enter_context(card_group())
            policy = train_mod.make_policy
            train_mod.make_policy = lambda *a, **kw: policy(
                *a, remat=args.remat, **kw)
        for b in args.batch:
            line = run(args.arch, b, args.steps, args.microbatch,
                       mesh_shape=(1, 1) if meshed else None,
                       strategy=args.strategy or "dp")
            line.update(scan_bwd_body=args.scan_bwd_body, nudge=args.nudge,
                        remat=args.remat)
            print(json.dumps(line), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
