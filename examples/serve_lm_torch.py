"""Batched serving example on the card: continuous-batching greedy decode,
with the PyTorch port (``repro_torch``).

    PYTHONPATH=src python examples/serve_lm_torch.py               # card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The twin of ``examples/serve_lm.py``: the same server configuration (smoke
h2o-danube, 8 slots, 96 positions, 24 new tokens), the same six seeded
prompts and printed lines. The server runs on ``--device`` (the card by
default, where attention is the port's CUDA kernel; without CUDA only
``--device cpu`` runs, and the default raises). Its parameters are drawn
from the server's seed, or carried in through ``main(params=...)`` (for
instance the reference's, by ``repro_torch.carry.params_from_numpy``).
``main`` also returns the figures it prints and every completion.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.serve import ServeConfig, Server

CONFIG = dict(arch="h2o-danube-1.8b", scale="smoke", max_batch=8,
              max_seq=96, max_new_tokens=24)


def make_prompts(vocab_size: int):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab_size, rng.integers(4, 20)).astype(np.int32)
            for _ in range(6)]


def main(argv=None, params=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the server's device: the card by default, or cpu")
    args = ap.parse_args(argv)
    server = Server(ServeConfig(**CONFIG), params=params, device=args.device)
    prompts = make_prompts(server.arch.vocab_size)
    t0 = time.time()
    outs = server.generate(prompts)
    dt = time.time() - t0
    n_new = sum(len(o) for o in outs)
    print(f"served {len(prompts)} requests, {n_new} new tokens "
          f"in {dt:.2f}s ({n_new/dt:.1f} tok/s, batched greedy)")
    for i, o in enumerate(outs[:3]):
        print(f"  req{i} prompt_len={len(prompts[i])} completion={o[:10]}")
    return {"requests": len(prompts), "new_tokens": n_new, "wall_s": dt,
            "tokens_per_s": n_new / dt,
            "prompt_lens": [len(p) for p in prompts], "completions": outs}


if __name__ == "__main__":
    main()
