"""End-to-end training driver on the card: a ~100M-param dense LM for a
few hundred steps, with checkpointing and auto-resume, with the PyTorch
port (``repro_torch``).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]     # card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

The twin of ``examples/train_lm.py``: the h2o-danube family at a ~100M
scale (12 layers, d=512), 8 × 128 tokens a step, a checkpoint every 50
steps, the same printed lines. It trains on ``--device`` (the card by
default, where attention and its backward are the port's CUDA kernels;
without CUDA only ``--device cpu`` runs, and the default raises).
``main(argv)`` also returns the losses and the checkpoint directory.
"""

import argparse
import dataclasses
import math
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.train import TrainConfig, train
from repro_torch.models.arch import get_arch, register_arch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="the trainer's device: the card by default, or cpu")
    args = ap.parse_args(argv)

    base = get_arch("h2o-danube-1.8b")
    cfg100m = dataclasses.replace(
        base, name="danube-100m", n_layers=12, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=1536, vocab_size=8192, head_dim=64, window=256,
        max_seq_len=512)
    register_arch(cfg100m)
    print(f"arch: {cfg100m.name} — {cfg100m.n_params()/1e6:.0f}M params")

    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="train_lm_")
    out = train(TrainConfig(
        arch="danube-100m", scale="full", steps=args.steps,
        global_batch=8, seq_len=128, ckpt_dir=ckpt, ckpt_every=50,
        log_every=10, device=args.device))
    first = out["losses"][0][1]
    last = out["losses"][-1][1]
    print(f"\nloss {first:.3f} → {last:.3f} over {args.steps} steps "
          f"({'improved' if last < first else 'no improvement'})")
    print(f"checkpoints in {ckpt} (rerun with --ckpt-dir {ckpt} to resume)")
    return {"params": cfg100m.n_params(), "losses": out["losses"],
            "first_loss": first, "last_loss": last,
            "improved": last < first,
            "finite": all(math.isfinite(l) for _, l in out["losses"]),
            "ckpt_dir": ckpt}


if __name__ == "__main__":
    main()
