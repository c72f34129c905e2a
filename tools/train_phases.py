#!/usr/bin/env python3
"""The four training phases of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 tools/train_phases.py

Builds the kernels, then runs ``chip_smoke.py``'s ``phase_train`` and
``phase_train_remat`` for danube and rwkv6-3b in the order and at the
sizes the smoke run gives them (``train_h2o-danube-1.8b``,
``train_remat_h2o-danube-1.8b``, ``train_rwkv6-3b``,
``train_remat_rwkv6-3b``), each printing its JSON line, then the card's
name and power limit as ``nvidia-smi`` gives them. Without the serving
and kernel phases that come before them in the smoke run, the lines show
how much of a training step's wall depends on what ran earlier in the
process. Exits non-zero if a phase's own checks fail. Imports nothing of
JAX.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_phases.py: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.phase_device()
    cs.phase_build()
    danube = cs.phase_train(cs.TRAIN_ARCH)
    cs.phase_train_remat(cs.TRAIN_ARCH, cs.TRAIN_BATCH, danube)
    rwkv = cs.phase_train(cs.TRAIN_RWKV_ARCH, batch=cs.TRAIN_RWKV_BATCH,
                          steps=cs.TRAIN_RWKV_STEPS,
                          microbatch=cs.TRAIN_RWKV_MICROBATCH)
    cs.phase_train_remat(cs.TRAIN_RWKV_ARCH, cs.TRAIN_RWKV_BATCH, rwkv)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
