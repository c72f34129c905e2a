"""Segment reduction (relational group-by aggregation): the CUDA kernel's
wrapper.

Per-segment sum / count / min / max of float32 values into a
``(num_segments,)`` float32 result, empty min/max segments giving 0. The
kernel is in ``csrc/segment_reduce.cu`` (its header says what bounds it and
how): one segment (the compiled tier's fold) streams the rows in one launch
whose last block folds the per-block partials; more segments take a pass of
per-(row block, segment tile) partials and a pass that folds them. Both fold
in an order fixed by (N, G), so the result does not depend on the run.

The wrapper dispatches on the tensor's device: a CUDA tensor launches the
kernel (and bumps ``segment_reduce.launches``), a CPU tensor takes
:func:`.ref.segment_reduce_ref`. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build, ref

__all__ = ["segment_reduce", "launch_shape", "LaunchShape"]

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_longlong
_SIGNATURES = {
    "cobra_segment_reduce": (_P, _P, _I64, _I32, _I32, _I32, _I32, _I64, _I32,
                             _P, _P, _P, _P),
}
_OPS = {"sum": 0, "count": 1, "min": 2, "max": 3}

_STREAM_ROWS = 8192      # one segment: rows a block folds in one pass (256
                         # threads x 8 vectors in flight x 4 rows)
_MAX_STREAM_BLOCKS = 1024
_CHUNK = 2048            # more segments: rows a block stages at a time
_MAX_ROW_BLOCKS = 1024   # enough blocks in flight to stream the whole card
_MAX_PARTIALS = 1 << 26  # cap on the partial buffer (float32 entries)
_MAX_TILE = 32           # segments per block tile (one warp's width)


class LaunchShape(NamedTuple):
    """How one call is cut into blocks.

    ``route`` is ``"stream"`` (one segment: one launch of ``blocks`` blocks,
    block b folding rows ``[b * rows_per_block, (b + 1) * rows_per_block)``,
    its last block folding the partials) or ``"tiled"`` (``blocks`` row
    blocks times ``tiles`` tiles of ``tg`` segments, then a launch that
    folds the partials). ``partials`` float32 entries of scratch;
    ``counters`` 4-byte ticket counters (one per stream, left zeroed by the
    launch)."""
    route: str
    blocks: int
    rows_per_block: int
    tg: int
    tiles: int
    partials: int
    counters: int


def launch_shape(n: int, num_segments: int) -> LaunchShape:
    """The launch over ``n`` rows and ``num_segments`` segments. A function
    of (n, G) alone, never of the card, so the summation order — and the
    result — is fixed by them."""
    if num_segments == 1:
        blocks = max(1, min(-(-n // _STREAM_ROWS), _MAX_STREAM_BLOCKS))
        rows = -(-n // blocks)
        rows = max(4, -(-rows // 4) * 4)      # whole 16-byte vectors
        blocks = max(1, -(-n // rows))
        return LaunchShape("stream", blocks, rows, 1, 1, blocks, 1)
    tg = 1
    while tg < min(num_segments, _MAX_TILE):
        tg *= 2
    nrb = max(1, min(-(-n // _CHUNK), _MAX_ROW_BLOCKS,
                     _MAX_PARTIALS // num_segments))
    rows = -(-n // nrb)
    tiles = -(-num_segments // tg)
    return LaunchShape("tiled", nrb, rows, tg, tiles, num_segments * nrb, 0)


def _lib():
    return build.load("segment_reduce", _SIGNATURES)


def segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, op: str = "sum") -> torch.Tensor:
    """values (N,) numeric; segment_ids (N,) integer in [0, num_segments).
    Returns (num_segments,) float32 aggregation."""
    if op not in _OPS:
        raise ValueError(op)
    if values.device.type == "cpu":
        return ref.segment_reduce_ref(values, segment_ids, num_segments, op=op)
    if values.device.type != "cuda" or segment_ids.device != values.device:
        raise ValueError(f"segment_reduce: values on {values.device}, "
                         f"segment ids on {segment_ids.device}")
    if values.ndim != 1 or segment_ids.shape != values.shape:
        raise ValueError(f"segment_reduce: shapes {tuple(values.shape)} and "
                         f"{tuple(segment_ids.shape)}")
    n = values.shape[0]
    dev = values.device
    if num_segments == 0:
        return torch.zeros((0,), dtype=torch.float32, device=dev)
    if n == 0:
        # every group is empty: sum/count identity is 0, and empty min/max
        # groups map to 0 as well
        return torch.zeros((num_segments,), dtype=torch.float32, device=dev)
    shape = launch_shape(n, num_segments)
    if shape.tiles * shape.blocks >= (1 << 31) or num_segments >= (1 << 31):
        raise ValueError(f"segment_reduce: {num_segments} segments exceed "
                         f"one launch")
    vals = values.to(torch.float32).contiguous()
    segs = segment_ids.to(torch.int32).contiguous()
    partial = torch.empty((shape.partials,), dtype=torch.float32, device=dev)
    out = torch.empty((num_segments,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        # the one-segment launch takes tickets on the current stream's own
        # counter: two streams may run two launches at once, and tickets of
        # both on one counter would elect no last block, or two
        counter = build.stream_counter(dev) if shape.counters else None
        err = _lib().cobra_segment_reduce(
            vals.data_ptr(), segs.data_ptr(), n, num_segments, _OPS[op],
            shape.tg, shape.blocks, shape.rows_per_block,
            int(build.aligned16(vals, segs)), partial.data_ptr(),
            None if counter is None else counter.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "segment_reduce")
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0
