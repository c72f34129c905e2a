"""Abstract input specs for every (arch × shape) cell, and the step
builders: the optimizer and the train / prefill / decode steps.

The port of ``repro.launch.specs``. ``abstract_params`` gives meta tensors
of the parameters' shapes and types (nothing is allocated);
``input_specs`` places them, the optimizer state, the batch and the caches
as meta DTensors by the spec functions of ``launch.sharding`` (the
reference's ShapeDtypeStructs with NamedShardings), which the dry-run
runs through ``step_fn``.

A train step takes gradients with autograd: on the card the attention's
backward is the ``flash_attention_bwd`` kernel and the RWKV6 scan's the
``rwkv6_scan_bwd`` kernel, on the CPU autograd through their plain
versions. It updates ``params`` and the optimizer state IN
PLACE and returns them (the reference's trainer donates both to its jit).
Under a ``MeshPolicy`` the parameters, optimizer state and batch are
DTensors; the loss is reduced before the backward and returned, with the
gradient norm, as plain tensors.

A train step opens program spans (``obs.trace.program_span``), each with
device marks: ``train.step`` (attributes ``step``, ``microbatches``)
around ``train.forward`` and ``train.backward`` (``microbatch``) once a
microbatch, and ``train.optimizer`` around ``train.clip``,
``train.update`` and ``train.apply``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate

from ..configs import SHAPES
from ..kernels import ops
from ..models import forward, init_params, loss_fn, make_caches
from ..models.arch import ArchConfig
from ..models.layers import NULL_POLICY
from ..models.model import dtensor_region
from ..obs.trace import program_span
from ..optim.optimizers import (Optimizer, adafactor, adamw,
                                clip_by_global_norm, tree_leaves, tree_map,
                                warmup_cosine)
from .sharding import (MeshPolicy, batch_specs, cache_specs,
                       distribute_tree, param_specs)

__all__ = ["abstract_params", "make_optimizer", "input_specs", "step_fn",
           "make_train_step", "shape_kind"]


def shape_kind(shape_name: str) -> str:
    return SHAPES[shape_name]["kind"]


def abstract_params(cfg: ArchConfig):
    """The parameter tree of ``cfg`` as meta tensors (shapes and types,
    no storage). ``init_params`` runs unchanged under a fake-tensor mode,
    drawing from a throwaway generator: nothing is drawn for real, and
    every real draw stays as it is."""
    with FakeTensorMode():
        fake = init_params(torch.Generator().manual_seed(0), cfg)
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), fake)


def make_optimizer(cfg: ArchConfig, total_steps: int = 10000) -> Optimizer:
    """Adafactor for ≥0.5T params (HBM budget), AdamW otherwise."""
    warmup = max(10, min(200, total_steps // 10))
    lr = warmup_cosine(3e-4, warmup, total_steps)
    if cfg.n_params() > 5e11:
        return adafactor(lr)
    return adamw(lr)


def _batch_struct(cfg: ArchConfig, B: int, T: int, kind: str):
    meta = lambda shape, dt=torch.int32: torch.empty(  # noqa: E731
        shape, dtype=dt, device="meta")
    b: Dict[str, Any] = {}
    if kind == "train":
        if cfg.enc_dec:
            b["tokens"] = meta((B, T))
            b["enc_embeds"] = meta((B, T, cfg.d_model), torch.bfloat16)
        elif cfg.frontend:
            b["embeds"] = meta((B, T, cfg.d_model), torch.bfloat16)
        else:
            b["tokens"] = meta((B, T))
        b["labels"] = meta((B, T))
        b["positions"] = meta((B, T))
    elif kind == "prefill":
        if cfg.enc_dec or cfg.frontend:
            b["embeds"] = meta((B, T, cfg.d_model), torch.bfloat16)
        else:
            b["tokens"] = meta((B, T))
        b["positions"] = meta((B, T))
    else:  # decode: one new token against a T-token cache
        b["tokens"] = meta((B, 1))
        b["positions"] = meta((B, 1))
    return b


def input_specs(cfg: ArchConfig, shape_name: str, policy: MeshPolicy,
                optimizer: Optional[Optimizer] = None) -> Dict[str, Any]:
    """The step's arguments for the cell, as meta DTensors placed by the
    spec functions: ``params`` and ``batch``; with ``opt_state`` and
    ``step`` (train), or ``caches`` and ``cache_index`` (decode). ``step``
    and ``cache_index`` are ints (the step reads them on the host)."""
    spec = SHAPES[shape_name]
    B, T, kind = spec["global_batch"], spec["seq_len"], spec["kind"]
    mesh = policy.mesh
    seq_shard = policy.seq_shard

    p_abs = abstract_params(cfg)
    params = distribute_tree(
        mesh, param_specs(p_abs, cfg, mesh, policy.strategy), p_abs)
    batch = _batch_struct(cfg, B, T, kind)
    batch = distribute_tree(mesh, batch_specs(
        mesh, batch, seq_shard=seq_shard and kind != "decode"), batch)

    if kind == "train":
        if optimizer is None:
            raise ValueError("input_specs: a train cell needs its optimizer")
        o_abs = optimizer.init(p_abs)
        opt = distribute_tree(
            mesh, param_specs(o_abs, cfg, mesh, policy.strategy), o_abs)
        return {"params": params, "opt_state": opt, "step": 0,
                "batch": batch}
    if kind == "prefill":
        return {"params": params, "batch": batch}
    caches = make_caches(cfg, B, T, device="meta")
    caches = distribute_tree(
        mesh, cache_specs(mesh, caches, seq_shard=seq_shard), caches)
    return {"params": params, "caches": caches, "cache_index": 0,
            "batch": batch}


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


def _replicated(x):
    """A DTensor made whole on every rank (its partial sums reduced)."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _microbatch(v, i: int, nmb: int):
    """Rows [i·m, (i+1)·m) of ``v``, m = B / nmb: the reference's i-th
    microbatch (its reshape to (nmb, m, ...)). A DTensor's rows are
    gathered by the slice and sharded again as ``v``'s, on the mesh dims
    whose shards divide m (DTensor cannot reshape a sharded batch into
    microbatches fewer than its shards)."""
    m = v.shape[0] // nmb
    if not isinstance(v, DTensor):
        return v.reshape(nmb, m, *v.shape[1:])[i]
    return v[i * m:(i + 1) * m].redistribute(
        v.device_mesh, ops.fit_shards(v, {0: (m,)}))


def _grads(params, leaves, cfg, batch, policy, microbatch: int = 0):
    """(loss, gradient of each leaf) of one batch."""
    with program_span("train.forward", leaves[0]) as sp:
        sp.attrs["microbatch"] = microbatch
        loss = _replicated(loss_fn(params, cfg, batch, pol=policy))
    with program_span("train.backward", leaves[0]) as sp:
        sp.attrs["microbatch"] = microbatch
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
        with program_span("train.step", leaves[0]) as sp:
            sp.attrs["step"] = step
            sp.attrs["microbatches"] = nmb
            with dtensor_region(isinstance(leaves[0], DTensor)):
                return _step(params, leaves, opt_state, step, batch)

    def _step(params, leaves, opt_state, step, batch):
        for p in leaves:
            p.requires_grad_(True)
        try:
            if nmb == 1:
                loss, grads = _grads(params, leaves, cfg, batch, policy)
            else:
                acc = [torch.zeros_like(p, dtype=torch.float32)
                       for p in leaves]
                loss = 0.0
                for i in range(nmb):
                    mb = {k: _microbatch(v, i, nmb) for k, v in batch.items()}
                    li, gi = _grads(params, leaves, cfg, mb, policy, i)
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
        with program_span("train.optimizer", leaves[0]):
            with program_span("train.clip", leaves[0]):
                grads, gnorm = clip_by_global_norm(grads, 1.0)
            with program_span("train.update", leaves[0]):
                updates, new_opt = optimizer.update(grads, opt_state, params,
                                                    step)
            with program_span("train.apply", leaves[0]), torch.no_grad():
                for p, u in zip(leaves, tree_leaves(updates)):
                    p.copy_((p.float() + u.float()).to(p.dtype))
        metrics = {"loss": _replicated(loss), "grad_norm": _replicated(gnorm)}
        metrics = {k: v.to_local() if isinstance(v, DTensor) else v
                   for k, v in metrics.items()}
        return params, new_opt, step + 1, metrics

    return train_step
