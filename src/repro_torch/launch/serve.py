"""Batched LM serving: prefill + batched greedy decode.

  python -m repro_torch.launch.serve --arch rwkv6-3b --device cpu
  python -m repro_torch.launch.serve --arch h2o-danube-1.8b --scale full

The port of ``repro.launch.serve``. One prefill over the right-padded batch
of prompts, then batched greedy decode steps over the shared KV cache (or
recurrent state), kept in fp32 as in the reference, for any registered
architecture. Attention runs the ``flash_attention`` CUDA kernel and the
RWKV6 time-mix the ``rwkv6_scan`` kernel on the card; on the CPU both take
their plain versions. Mamba2's scan and the MoE dispatch are plain torch
on both devices, as in the reference.

As in the reference, prompts are right-padded to the longest one and
decode step t writes cache slot ``Tmax + t`` at RoPE position
``len(prompt) + t``: a shorter prompt's decode sees its pad entries (for
RWKV6 and Mamba2 the pads run through the recurrent state). The port keeps
this for parity with the reference, as it keeps the reference's serving of
an encoder-decoder model (seamless): ``generate`` passes no encoder inputs,
so the encoder never runs and the decoder attends over a zero cross cache
(drive ``models.forward`` with ``enc_inputs`` at the prefill to run it).

The server runs on the card unless the caller names another device
(``device="cpu"``); asking for the card without CUDA raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional

import numpy as np
import torch

from ..models import forward, get_arch, init_params, make_caches
from ..models.layers import NULL_POLICY
from ..relational.table import resolve_device

__all__ = ["ServeConfig", "Server", "main"]


@dataclasses.dataclass
class ServeConfig:
    arch: str = "h2o-danube-1.8b"
    scale: str = "smoke"          # "smoke": arch.scaled(); else the full config
    max_batch: int = 8
    max_seq: int = 128
    max_new_tokens: int = 16
    seed: int = 0


class Server:
    """Greedy batch server for one architecture.

    ``params`` carries parameters in (for instance the reference's, through
    ``repro_torch.carry.params_from_numpy``); without them the server draws
    its own from a generator on ``device`` seeded with ``cfg.seed``.

    After :meth:`generate`, ``step_logits`` holds each step's next-token
    logits (B, vocab) (the prefill's at each prompt's last position, then
    one per decode step) and ``timing`` the wall seconds of the prefill and
    the decode steps (each ends when its tokens reach the host)."""

    def __init__(self, cfg: ServeConfig, params=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        arch = get_arch(cfg.arch)
        self.arch = arch.scaled() if cfg.scale == "smoke" else arch
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            params = init_params(gen, self.arch)
        self.params = params
        self.step_logits: List[torch.Tensor] = []
        self.timing = {}

    def _step(self, caches, cache_index: int, tokens, positions):
        logits, caches, _ = forward(self.params, self.arch, tokens, positions,
                                    caches=caches, cache_index=cache_index,
                                    pol=NULL_POLICY)
        return logits, caches

    def generate(self, prompts: List[np.ndarray]) -> List[List[int]]:
        """Greedy-decode a batch of token prompts."""
        cfg, arch, dev = self.cfg, self.arch, self.device
        B = len(prompts)
        if not 0 < B <= cfg.max_batch:
            raise ValueError(f"{B} prompts; the server takes 1..{cfg.max_batch}")
        plens = [len(p) for p in prompts]
        Tmax = max(plens)
        if min(plens) < 1 or Tmax + cfg.max_new_tokens - 1 > cfg.max_seq:
            raise ValueError(f"prompts of {min(plens)}..{Tmax} tokens plus "
                             f"{cfg.max_new_tokens} new ones do not fit "
                             f"max_seq={cfg.max_seq}")
        t0 = time.perf_counter()
        caches = make_caches(arch, B, cfg.max_seq, dtype=torch.float32,
                             device=dev)
        # prefill: pad to Tmax; each prompt's first token is read at its end
        toks = np.zeros((B, Tmax), np.int32)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        pos = np.broadcast_to(np.arange(Tmax)[None], (B, Tmax)).astype(np.int32)
        logits, caches = self._step(caches, 0, torch.from_numpy(toks).to(dev),
                                    torch.from_numpy(pos).to(dev))
        last = torch.tensor([n - 1 for n in plens], device=dev)
        step = logits[torch.arange(B, device=dev), last]
        del logits
        self.step_logits = [step]
        nxt = torch.argmax(step, dim=-1).to(torch.int32)
        outs: List[List[int]] = [[t] for t in nxt.tolist()]
        t1 = time.perf_counter()

        cur = nxt[:, None]
        for t in range(cfg.max_new_tokens - 1):
            step_pos = torch.tensor([[plens[i] + t] for i in range(B)],
                                    dtype=torch.int32, device=dev)
            logits, caches = self._step(caches, Tmax + t, cur, step_pos)
            step = logits[:, -1]
            self.step_logits.append(step)
            nxt = torch.argmax(step, dim=-1).to(torch.int32)
            for i, tok in enumerate(nxt.tolist()):
                outs[i].append(tok)
            cur = nxt[:, None]
        t2 = time.perf_counter()
        self.timing = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                       "decode_steps": cfg.max_new_tokens - 1}
        return outs


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--scale", default="smoke", choices=("smoke", "full"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)
    cfg = ServeConfig(arch=args.arch, max_new_tokens=args.max_new_tokens,
                      max_batch=max(4, args.requests), scale=args.scale)
    server = Server(cfg, device=args.device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, server.arch.vocab_size,
                            rng.integers(4, 16)).astype(np.int32)
               for _ in range(args.requests)]
    t0 = time.time()
    outs = server.generate(prompts)
    dt = time.time() - t0
    total_new = sum(len(o) for o in outs)
    print(json.dumps({
        "requests": len(prompts),
        "device": str(server.device),
        "new_tokens": total_new,
        "tokens_per_s": round(total_new / dt, 2),
        "sample": outs[0][:8],
    }))


if __name__ == "__main__":
    main()
