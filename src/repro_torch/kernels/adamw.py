"""AdamW's step over a whole parameter tree on the card: the CUDA kernel
pair's wrapper.

:func:`global_norm` is the global L2 norm of a step's gradients in one
launch, in an order fixed by their sizes (so the same bits on every run);
:func:`adamw_update` is the clipped AdamW update of every leaf, its moments
and the parameter written in place, in one launch. Given the same clip
scale, it leaves m, v and p bit-identical to ``optim.clip_by_global_norm``
then ``optim.adamw``'s update then the apply of
``launch.specs.make_train_step``, which stay the plain version (the CPU,
DTensors, Adafactor). The kernels are in ``csrc/adamw.cu``; its header says
what bounds them and how.

Both read one :class:`Leaves`, which checks a step's tensors once and
copies a table of them (pointers, sizes, types) to the card from pinned
memory, since autograd hands out new gradients every step. It takes only
plain contiguous CUDA tensors, 16-byte aligned, of one device, parameters
and gradients bf16 or fp32, moments fp32, and raises on anything else:
there is no fallback. ``launches`` counts the launches (two a train
step).
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from . import build

__all__ = ["Leaves", "global_norm", "adamw_update", "launch_shape",
           "LaunchShape", "CHUNK", "launches"]

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "cobra_adamw_norm": (_P, _I32, _I64, _I64, _I32, _P, _P, _P, _P),
    "cobra_adamw_update": (_P, _I32, _I64, _I64, _I32, _P, *(_F,) * 9, _P),
}

CHUNK = 16384        # elements a block takes at a time (a multiple of 8)
# the norm's grid: 6 blocks of 256 threads on each of an H100's 132 SMs,
# all resident at its 40 registers a thread (1.19 ms at danube's leaves
# against 1.41 at 1,024 blocks, NVIDIA H100 80GB HBM3); a constant, never
# read from the card, so that the norm's order is the sizes' alone. The
# update takes one chunk a block (14.0 ms there, against 14.5 at 1,024
# blocks that each walk ~110 chunks).
_NORM_BLOCKS = 792
_TYPES = (torch.bfloat16, torch.float32)

launches = 0


class LaunchShape(NamedTuple):
    """How a list of leaves is cut: ``chunk0[i]`` is leaf i's first chunk
    (leaf i holds chunks ``chunk0[i] .. chunk0[i] + ceil(n_i / CHUNK)``),
    ``chunks`` their total, ``blocks`` the norm's grid, whose block b takes
    chunks b, b + blocks, ... A function of the sizes alone, never of the
    card, so the norm's order of summation, and its bits, are fixed by
    them. The update's grid is ``chunks`` blocks, one chunk each."""
    chunk0: List[int]
    chunks: int
    blocks: int


def launch_shape(sizes: Sequence[int]) -> LaunchShape:
    """The launch over leaves of ``sizes`` elements, none of them 0."""
    chunk0, total = [], 0
    for n in sizes:
        chunk0.append(total)
        total += -(-n // CHUNK)
    return LaunchShape(chunk0, total, min(total, _NORM_BLOCKS))


def _problem(tensors) -> Optional[str]:
    """What keeps the kernels from taking ``tensors``, or None."""
    device = None
    for t in tensors:
        if isinstance(t, DTensor):
            return "a DTensor"
        if t.dtype not in _TYPES:
            return f"a {t.dtype} tensor"
        if not t.is_contiguous():
            return "a tensor that is not contiguous"
        if t.data_ptr() % 16:
            return "a tensor whose base is not 16-byte aligned"
        if t.device.type != "cuda":
            return f"a tensor on {t.device}"
        if device is None:
            device = t.device
        elif t.device != device:
            return f"tensors on {device} and {t.device}"
    return None


def _check(groups) -> None:
    """Raise unless ``groups`` (gradients, then parameters, m and v where
    given) are lists of one length, leaf i of one shape in each, the
    moments fp32, and every tensor a plain (not a DTensor) contiguous CUDA
    tensor of one device, bf16 or fp32, its base 16-byte aligned."""
    n = len(groups[0])
    if not n:
        raise ValueError("adamw: no leaves")
    for g in groups[1:]:
        if len(g) != n:
            raise ValueError(f"adamw: {n} gradients against {len(g)} "
                             f"leaves")
    for i, ts in enumerate(zip(*groups)):
        if any(t.shape != ts[0].shape for t in ts):
            raise ValueError(f"adamw: leaf {i} of shapes "
                             f"{[tuple(t.shape) for t in ts]}")
        if any(t.dtype != torch.float32 for t in ts[2:]):
            raise ValueError(f"adamw: leaf {i}'s moments are "
                             f"{[t.dtype for t in ts[2:]]}, not fp32")
    problem = _problem(t for g in groups for t in g)
    if problem is not None:
        raise ValueError(f"adamw: {problem}")


def _rows(grads, params=None, m=None, v=None):
    """(the table's rows, flat, eight int64 words a leaf; the launch shape):
    the non-empty leaves in their order, each row g, p, m, v (0 where not
    given), n, its first chunk, whether g and p are bf16."""
    keep = [i for i, g in enumerate(grads) if g.numel()]
    shape = launch_shape([grads[i].numel() for i in keep])
    ptr = lambda ts, i: 0 if ts is None else ts[i].data_ptr()  # noqa: E731
    rows = []
    for i, c0 in zip(keep, shape.chunk0):
        g = grads[i]
        rows += [g.data_ptr(), ptr(params, i), ptr(m, i), ptr(v, i),
                 g.numel(), c0, int(g.dtype == torch.bfloat16),
                 int(params is not None
                     and params[i].dtype == torch.bfloat16)]
    return rows, shape


def _table(rows, device) -> torch.Tensor:
    """The rows on ``device``, copied from pinned memory: the copy is
    queued on the stream like a kernel, and PyTorch's host allocator keeps
    the buffer until it has run."""
    host = torch.tensor(rows, dtype=torch.int64).pin_memory()
    return host.to(device, non_blocking=True)


def _lib():
    return build.load("adamw", _SIGNATURES)


class Leaves:
    """One step's leaves as the kernels take them: checked once (the
    wrapper raises on any tensor the kernels do not take) and copied to
    the card as one table, which :func:`global_norm` and
    :func:`adamw_update` both read. ``params``, ``m`` and ``v`` may be left
    out for a norm alone."""

    def __init__(self, grads: Sequence[torch.Tensor], params=None, m=None,
                 v=None):
        groups = [list(grads)]
        if params is not None:
            groups += [list(params), list(m), list(v)]
        _check(groups)
        self.device = groups[0][0].device
        self.updates = params is not None
        rows, self.shape = _rows(*groups)
        self.table = _table(rows, self.device) if rows else None


def global_norm(leaves: Leaves) -> torch.Tensor:
    """The global L2 norm of the gradients as a 0-d fp32 tensor on their
    card: each g^2 summed in fp64 in an order fixed by the leaves' sizes,
    the square root rounded to fp32."""
    global launches
    dev, shape = leaves.device, leaves.shape
    if leaves.table is None:
        return torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    partial = torch.empty((shape.blocks,), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        counter = build.stream_counter(dev)
        err = _lib().cobra_adamw_norm(
            leaves.table.data_ptr(), len(shape.chunk0), shape.chunks, CHUNK,
            shape.blocks, partial.data_ptr(), counter.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(err, "global_norm")
    launches += 1
    return out


def _f32(x: float) -> float:
    return float(np.float32(x))


def adamw_update(leaves: Leaves, scale: torch.Tensor, *, lr: float,
                 b1: float, b2: float, eps: float, weight_decay: float,
                 bc1: float, bc2: float) -> None:
    """AdamW on every leaf in place, as ``optim.adamw``'s update and the
    train step's apply compute it: the gradient ``g * scale`` rounded to
    g's type, m and v updated, p + u with u = -lr (m / bc1 / (sqrt(v /
    bc2) + eps) + weight_decay p) rounded to p's type. ``scale`` is a 0-d
    fp32 tensor on the card; the scalars are the Python floats the eager
    update takes (``lr``, ``bc1`` and ``bc2`` already fp32 values)."""
    global launches
    if not leaves.updates:
        raise ValueError("adamw_update: leaves without parameters and "
                         "moments")
    if scale.device != leaves.device or scale.dtype != torch.float32 \
            or scale.numel() != 1:
        raise ValueError(f"adamw_update: scale {scale.dtype} of "
                         f"{scale.numel()} elements on {scale.device}")
    if leaves.table is None:
        return
    shape = leaves.shape
    one = np.float32(1.0)
    hyper = (_f32(b1), _f32(1 - b1), _f32(b2), _f32(1 - b2),
             float(one / np.float32(bc1)), float(one / np.float32(bc2)),
             _f32(eps), _f32(weight_decay), _f32(-lr))
    with torch.cuda.device(leaves.device):
        err = _lib().cobra_adamw_update(
            leaves.table.data_ptr(), len(shape.chunk0), shape.chunks, CHUNK,
            shape.chunks, scale.data_ptr(), *hyper,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "adamw_update")
    launches += 1
