"""Step builders: the optimizer and the train / prefill / decode steps.

The port of ``repro.launch.specs``, in part: ``make_optimizer``,
``make_train_step`` and ``step_fn``. The reference's ``abstract_params``,
``input_specs`` (abstract inputs carrying NamedShardings, which its
dry-run lowers) and ``shape_kind`` need ``launch/sharding.py`` or serve
the dry-run, and wait for the port's sharding (ROADMAP A3).

A train step takes gradients with autograd: on the card the attention's
backward is the ``flash_attention_bwd`` kernel and the RWKV6 scan's the
``rwkv6_scan_bwd`` kernel, on the CPU autograd through their plain
versions. It updates ``params`` and the optimizer state IN
PLACE and returns them (the reference's trainer donates both to its jit).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models import forward, loss_fn
from ..models.arch import ArchConfig
from ..models.layers import NULL_POLICY
from ..optim.optimizers import (Optimizer, adafactor, adamw,
                                clip_by_global_norm, tree_leaves, tree_map,
                                warmup_cosine)

__all__ = ["make_optimizer", "make_train_step", "step_fn"]


def make_optimizer(cfg: ArchConfig, total_steps: int = 10000) -> Optimizer:
    """Adafactor for ≥0.5T params (HBM budget), AdamW otherwise."""
    warmup = max(10, min(200, total_steps // 10))
    lr = warmup_cosine(3e-4, warmup, total_steps)
    if cfg.n_params() > 5e11:
        return adafactor(lr)
    return adamw(lr)


def step_fn(cfg: ArchConfig, kind: str, policy=NULL_POLICY,
            optimizer: Optional[Optimizer] = None) -> Callable:
    if kind == "train":
        return make_train_step(cfg, policy, optimizer)
    if kind == "prefill":
        @torch.no_grad()
        def prefill(params, batch):
            inp = batch.get("embeds", None)
            if inp is None:
                inp = batch["tokens"]
            if cfg.enc_dec:
                B, T = inp.shape[:2]
                dec_tokens = torch.zeros((B, min(T, 1024)), dtype=torch.int32,
                                         device=inp.device)
                pos = torch.arange(dec_tokens.shape[1], device=inp.device
                                   )[None].expand(dec_tokens.shape)
                logits, _, _ = forward(params, cfg, dec_tokens, pos,
                                       pol=policy, enc_inputs=inp)
            else:
                logits, _, _ = forward(params, cfg, inp, batch["positions"],
                                       pol=policy)
            return logits
        return prefill

    @torch.no_grad()
    def serve_step(params, caches, cache_index, batch):
        logits, new_caches, _ = forward(params, cfg, batch["tokens"],
                                        batch["positions"], caches=caches,
                                        cache_index=cache_index, pol=policy)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, new_caches
    return serve_step


def _grads(params, leaves, cfg, batch, policy):
    """(loss, gradient of each leaf) of one batch."""
    loss = loss_fn(params, cfg, batch, pol=policy)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), grads


def make_train_step(cfg: ArchConfig, policy=NULL_POLICY,
                    optimizer: Optional[Optimizer] = None) -> Callable:
    """``train_step(params, opt_state, step, batch) -> (params, opt_state,
    step + 1, {"loss", "grad_norm"})``: the gradients of the batch (summed
    over ``policy.microbatch`` equal slices in fp32 and averaged, when the
    policy sets more than one), clipped to a global norm of 1.0, then the
    optimizer's update."""
    nmb = max(1, getattr(policy, "microbatch", 1))

    def train_step(params, opt_state, step, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if nmb == 1:
                loss, grads = _grads(params, leaves, cfg, batch, policy)
            else:
                acc = [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in leaves]
                loss = 0.0
                for i in range(nmb):
                    mb = {k: v.reshape(nmb, v.shape[0] // nmb,
                                       *v.shape[1:])[i]
                          for k, v in batch.items()}
                    li, gi = _grads(params, leaves, cfg, mb, policy)
                    for a, g in zip(acc, gi):
                        a.add_(g.float())
                    loss = loss + li
                loss = loss / nmb
                grads = [a / nmb for a in acc]
        finally:
            for p in leaves:
                p.requires_grad_(False)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        updates, new_opt = optimizer.update(grads, opt_state, params, step)
        with torch.no_grad():
            for p, u in zip(leaves, tree_leaves(updates)):
                p.copy_((p.float() + u.float()).to(p.dtype))
        metrics = {"loss": loss, "grad_norm": gnorm}
        return params, new_opt, step + 1, metrics

    return train_step
