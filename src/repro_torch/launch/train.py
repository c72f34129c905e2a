"""Fault-tolerant training loop.

  python -m repro_torch.launch.train --arch h2o-danube-1.8b --steps 20 \
      --device cpu --ckpt-dir /tmp/ckpt

The port of ``repro.launch.train``, the reference's loop:
  * auto-resume from the latest atomic checkpoint (params, opt state, step,
    data-pipeline cursor) — restart-identical training; the checkpoints
    are the reference's files (``repro_torch.checkpoint``), so either
    package resumes the other's;
  * async checkpoint every --ckpt-every steps and at the end, off the
    critical path;
  * failure drill: --fail-at N crashes mid-run (tests restart it and
    assert bitwise continuation);
  * microbatched gradient accumulation (--microbatch).

It runs on the card unless the config names another device
(``device="cpu"``); asking for the card without CUDA raises. On the card
the attention's backward is the hand-written ``flash_attention_bwd``
kernel and RWKV6's scan's the hand-written ``rwkv6_scan_bwd``, so every
registered architecture trains there. A step is deterministic on either
device, so a resumed run lands on the uninterrupted run's bits. The
reference's ``mesh_shape`` (a multi-device mesh), its ``strategy``
(which the reference reads only with a mesh) and its ``compress`` (int8
gradient compression between devices) wait for the port's sharding
(ROADMAP A3): set to anything but their defaults, they raise
``NotImplementedError``. Parameters are drawn from a ``torch.Generator`` seeded with
``seed`` (the reference's ``jax.random`` keys give other numbers).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import torch

from ..checkpoint import Checkpointer
from ..data import PipelineConfig, Prefetcher, SyntheticLM
from ..models import get_arch, init_params
from ..models.layers import NullPolicy
from ..relational.table import resolve_device
from .specs import make_optimizer, make_train_step

__all__ = ["TrainConfig", "train", "main"]


@dataclasses.dataclass
class TrainConfig:
    arch: str = "h2o-danube-1.8b"
    scale: str = "smoke"          # smoke (reduced cfg) | full
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 64
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    microbatch: int = 1
    compress: bool = False                # ROADMAP A3: raises
    fail_at: Optional[int] = None         # failure-injection drill
    mesh_shape: Optional[tuple] = None    # ROADMAP A3: raises
    strategy: str = "dp"                  # ROADMAP A3: raises unless dp
    log_every: int = 10
    seed: int = 0
    device: Optional[str] = None          # None: the card


def train(cfg: TrainConfig, progress=print) -> dict:
    """Runs the loop; returns ``{"final_step", "losses", "params"}``,
    ``losses`` a list of (step, loss) every ``log_every`` steps and at the
    last."""
    for knob, unset in (("mesh_shape", None), ("strategy", "dp"),
                        ("compress", False)):
        if getattr(cfg, knob) not in (unset, ()):
            raise NotImplementedError(
                f"train: {knob} needs the port's meshes and sharding "
                f"(launch/mesh.py, launch/sharding.py: ROADMAP A3); run on "
                f"one device with the defaults")
    dev = resolve_device(cfg.device)
    arch = get_arch(cfg.arch)
    if cfg.scale == "smoke":
        arch = arch.scaled()
    policy = NullPolicy()
    policy.microbatch = cfg.microbatch

    optimizer = make_optimizer(arch, total_steps=cfg.steps)
    step_fn = make_train_step(arch, policy, optimizer)

    pipe_cfg = PipelineConfig(
        global_batch=cfg.global_batch, seq_len=cfg.seq_len,
        vocab_size=arch.vocab_size, seed=cfg.seed,
        emb_dim=arch.d_model if (arch.frontend or arch.enc_dec) else None,
        enc_dec=arch.enc_dec)
    source = SyntheticLM(pipe_cfg)

    ckpt = Checkpointer(cfg.ckpt_dir) if cfg.ckpt_dir else None
    start_step = 0
    params = init_params(torch.Generator(device=dev).manual_seed(cfg.seed),
                         arch)
    opt_state = optimizer.init(params)
    data_state = {"next_index": 0}

    if ckpt is not None and ckpt.latest_step() is not None:
        start_step, tree, extras = ckpt.restore(
            {"params": params, "opt": opt_state})
        params, opt_state = tree["params"], tree["opt"]
        data_state = extras.get("data", data_state)
        progress(f"[resume] step {start_step}")

    prefetch = Prefetcher(source, start_index=data_state["next_index"])
    step = start_step
    losses = []
    t0 = time.time()
    try:
        for i in range(start_step, cfg.steps):
            if cfg.fail_at is not None and i == cfg.fail_at:
                raise RuntimeError(f"injected failure at step {i}")
            batch = {k: torch.from_numpy(v.copy()).to(dev)
                     for k, v in prefetch.get().items()}
            params, opt_state, step, metrics = step_fn(params, opt_state,
                                                       step, batch)
            if (i + 1) % cfg.log_every == 0 or i == cfg.steps - 1:
                loss = float(metrics["loss"])
                losses.append((i + 1, loss))
                progress(f"step {i+1}/{cfg.steps} loss={loss:.4f} "
                         f"gnorm={float(metrics['grad_norm']):.3f} "
                         f"({(time.time()-t0)/max(1,i+1-start_step):.2f}s/step)")
            if ckpt is not None and (i + 1) % cfg.ckpt_every == 0:
                ckpt.save(i + 1, {"params": params, "opt": opt_state},
                          extras={"data": prefetch.state()})
        if ckpt is not None:
            ckpt.save(cfg.steps, {"params": params, "opt": opt_state},
                      extras={"data": prefetch.state()}, block=True)
    finally:
        prefetch.close()
        if ckpt is not None:
            ckpt.wait()
    return {"final_step": int(step), "losses": losses, "params": params}


def main(argv=None):
    ap = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainConfig):
        name = "--" + f.name.replace("_", "-")
        if f.type in ("bool", bool):
            ap.add_argument(name, action="store_true")
        else:
            ap.add_argument(name, default=f.default, type=type(f.default)
                            if f.default is not None else str)
    args = ap.parse_args(argv)
    cfg = TrainConfig(**{f.name: getattr(args, f.name)
                         for f in dataclasses.fields(TrainConfig)})
    cfg = dataclasses.replace(cfg, steps=int(cfg.steps),
                              global_batch=int(cfg.global_batch),
                              seq_len=int(cfg.seq_len),
                              fail_at=None if cfg.fail_at is None
                              else int(cfg.fail_at))
    out = train(cfg)
    print(json.dumps({"final_step": out["final_step"],
                      "losses": out["losses"][-3:]}))


if __name__ == "__main__":
    main()
