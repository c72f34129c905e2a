#!/usr/bin/env python3
"""Peak device memory, step walls and losses of ``launch.train.train`` at
several batch sizes, on one NVIDIA GPU: how ``chip_smoke.py`` sizes a
training phase's batch.

    python3 tools/train_peak_memory.py [--arch NAME] [--batch N ...]
                                       [--steps S] [--microbatch M]

For each batch (rows of 2,048 tokens, ``chip_smoke.TRAIN_T``), in the
order given, it trains the architecture at its published configuration
from seeded weights with the loop's AdamW and the ``SyntheticLM`` stream
for ``--steps`` steps, the batch split into ``--microbatch`` equal
microbatches whose gradients add up in fp32, and prints one JSON line:
``torch.cuda.max_memory_allocated`` over the run, each step's wall (host
clock to a synchronize), the losses and the kernels' launch counts; a
batch that runs out of memory prints ``"oom": true`` and the next batch
still runs. Then the card's name and power limit as ``nvidia-smi`` gives
them. Imports nothing of JAX.
"""

import argparse
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


def run(arch_name, batch, steps, microbatch):
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
                                device=DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    train_mod.make_train_step = timed_make
    line = {"arch": arch_name, "batch": batch, "seq_len": SEQ_LEN,
            "microbatch": microbatch, "steps": steps}
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
                                        ops.launch_counts().items() if n})
    torch.cuda.empty_cache()
    return line


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--microbatch", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("train_peak_memory.py: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    for b in args.batch:
        print(json.dumps(run(args.arch, b, args.steps, args.microbatch)),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
