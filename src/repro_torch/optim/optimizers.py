"""Optimizers as plain functions on the port's parameter trees.

The port of ``repro.optim.optimizers``. A parameter tree is nested
dictionaries of tensors, each stack of layers a list of per-layer
dictionaries (``repro_torch.models``); gradients and AdamW's moments are
trees of the same shape. Updates are computed in fp32 and cast back to
each leaf's type, as the reference does.

  adamw      — fp32 moments ``{"m", "v"}``; the default below 5e11 params.
               The moments are updated IN PLACE and the same state is
               returned (the reference's trainer donates them to its jit).
  adafactor  — factored second moment, no momentum: ``{"slots"}``, one
               slot per reference leaf (a stack's leaf is ONE leaf with a
               leading layer axis there, so a stack of (d,) norm weights
               is a factored (L, d) leaf), kept in the reference's stacked
               layout; its update stacks each such leaf's gradient, as the
               reference's arithmetic (the update's RMS over the whole
               stack, the column means over layers) requires.
  schedules  — linear warmup + cosine decay.
  compression — int8 per-tensor-scaled gradient quantization with error
               feedback, applied at microbatch-accumulation boundaries.

``tree_map`` and ``tree_leaves`` stand in for ``jax.tree_util`` on these
trees. Scalars of the schedules are fp32, as the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping

import torch

from ..carry import reference_leaves, restack

__all__ = ["adamw", "adafactor", "warmup_cosine", "clip_by_global_norm",
           "compress_int8", "decompress_int8", "compressed_accumulate",
           "Optimizer", "tree_map", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, step) -> (updates, new_state)


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts and lists) and the
    matching leaves of ``rest``, in a tree of the same shape."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree in its own order."""
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _f32(x) -> float:
    """An fp32 value as a Python float (exact), for a scalar operand."""
    return float(torch.as_tensor(x, dtype=torch.float32))


# --------------------------------------------------------------------------
# schedules / clipping
# --------------------------------------------------------------------------

def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return lr


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before clipping as a 0-d fp32 tensor). The leaves are scaled IN PLACE
    (the same tree is returned)."""
    leaves = tree_leaves(grads)
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    with torch.no_grad():
        for g in leaves:
            g.copy_((g.float() * scale).to(g.dtype))
    return grads, norm


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def adamw(lr: Callable, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(  # noqa: E731
            p, dtype=torch.float32, memory_format=torch.contiguous_format)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(grads, state, params, step):
        stepf = torch.as_tensor(step, dtype=torch.float32) + 1.0
        lr_t = _f32(lr(step))
        bc1 = _f32(1 - torch.tensor(b1, dtype=torch.float32) ** stepf)
        bc2 = _f32(1 - torch.tensor(b2, dtype=torch.float32) ** stepf)

        def upd(g, m, v, p):
            gf = g.float()
            m.mul_(b1).add_((1 - b1) * gf)
            v.mul_(b2).add_((1 - b2) * torch.square(gf))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
                + weight_decay * p.float()
            return (-lr_t * delta).to(p.dtype)

        with torch.no_grad():
            updates = tree_map(upd, grads, state["m"], state["v"], params)
        return updates, state

    return Optimizer(init, update)


# --------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum)
# --------------------------------------------------------------------------

def _stacked(tensors, stacked: bool) -> torch.Tensor:
    return torch.stack([t.float() for t in tensors]) if stacked \
        else tensors[0].float()


def adafactor(lr: Callable, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0
              ) -> Optimizer:
    def slot(shape, device):
        if len(shape) >= 2:
            return {"vr": torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device),
                    "vc": torch.zeros(shape[:-2] + shape[-1:],
                                      dtype=torch.float32, device=device)}
        return {"v": torch.zeros(shape, dtype=torch.float32, device=device)}

    def init(params):
        slots = {}
        for path, (ts, stacked) in reference_leaves(params).items():
            shape = ((len(ts),) if stacked else ()) + tuple(ts[0].shape)
            node = slots
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = slot(shape, ts[0].device)
        return {"slots": slots}

    def update(grads, state, params, step):
        stepf = torch.as_tensor(step, dtype=torch.float32) + 1.0
        beta = _f32(1.0 - stepf ** (-decay))
        lr_t = _f32(lr(step))
        g_leaves = reference_leaves(grads)
        out = {}
        with torch.no_grad():
            for path, (ps, stacked) in reference_leaves(params).items():
                gf = _stacked(g_leaves[path][0], stacked)
                s = state["slots"]
                for k in path:
                    s = s[k]
                g2 = torch.square(gf) + eps
                if "vr" in s:
                    vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                    vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                    rfac = torch.rsqrt(vr / torch.clamp(
                        torch.mean(vr, dim=-1, keepdim=True), min=eps))[..., None]
                    cfac = torch.rsqrt(vc)[..., None, :]
                    u = gf * rfac * cfac
                    s["vr"], s["vc"] = vr, vc
                else:
                    v = beta * s["v"] + (1 - beta) * g2
                    u = gf * torch.rsqrt(v)
                    s["v"] = v
                rms_u = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
                u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
                if weight_decay:
                    u = u + weight_decay * _stacked(ps, stacked)
                out[path] = (-lr_t * u).to(ps[0].dtype)
        return restack(params, out), state

    return Optimizer(init, update)


# --------------------------------------------------------------------------
# Gradient compression (int8 + error feedback)
# --------------------------------------------------------------------------

def compress_int8(g: torch.Tensor):
    gf = g.float()
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_accumulate(acc, g, err):
    """One microbatch contribution through the int8 channel with error
    feedback: returns (new_acc, new_err)."""
    gf = g.float() + err
    q, s = compress_int8(gf)
    deq = decompress_int8(q, s)
    return acc + deq, gf - deq
