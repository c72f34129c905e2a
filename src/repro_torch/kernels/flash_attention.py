"""Flash attention (forward): the CUDA kernel's wrapper.

The attention of the LM serving path (``models/layers.attention_gqa`` and
``attention_mla``): online-softmax attention over q ``(B, H, Tq, hd)``, k
``(B, KV, Tk, hd)`` and v ``(B, KV, Tk, hdv)`` with ``hdv <= hd`` (MLA's v
head is narrower than its q.k head; elsewhere they are equal), GQA,
causal / sliding-window / chunk-local masks and the query block at the
tail of the keys. Head dims 1..160: the kernel is instantiated for every
16-deep slice count up to 6 (hd 96), then 8 (hd 128) and 10 (hd 160), and
a head dim between takes the next one up. On the tensor cores a v narrower
than q.k is a variant of its own, built for hd 81..96 only (MLA's 96/64);
every other depth there takes ``hdv == hd``. The kernel is in
``csrc/flash_attention.cu`` (its header says what bounds it and how). q's
type picks its body: bf16 q takes the tensor cores, fp32 q the CUDA cores
(a two-way bf16 split cannot meet fp32's tolerance); the block size
follows the shape (8 warps for a long bf16 call, 4 for decode).

The wrapper dispatches on the tensor's device: a CUDA tensor launches the
kernel (and bumps ``flash_attention.launches``), a CPU tensor takes the
plain version :func:`.ref.flash_attention_ref`. There is no fallback from
one to the other. It casts nothing and copies nothing: q and k/v may be
strided views (the (B, T, H, hd) projection, the (B, S, KV, hd) cache), in
the type pairs (q, k/v) fp32/fp32, bf16/fp32 and bf16/bf16; another pair
raises. The output has q's type and is a (B, H, Tq, hdv) view of
(B, Tq, H, hdv) memory, so the caller's transpose back to (B, Tq, H·hdv)
needs no copy.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build, ref

__all__ = ["flash_attention"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "cobra_flash_attention": (
        _P, _P, _P, _P, _P, _P,                  # q, k, v, out, partials
        _I, _I, _I, _I, _I, _I, _I,              # B, H, KV, Tq, Tk, hd, hdv
        _STRIDES, _STRIDES, _STRIDES, _STRIDES,  # q, k, v, out strides
        _I, _I, _I, ctypes.c_float,              # causal, window, chunk, scale
        _I, _I, _I, _I,                          # group, n_hgroups, bt, splits
        _I, _I, _I, _P),                         # dtypes, vec, stream
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TYPE_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.bfloat16))
# keys per tile, by q's type: kKeys (CUDA cores), kKeysTc (tensor cores)
_KEYS = {torch.float32: 32, torch.bfloat16: 64}
_MAX_HD = 160        # mma depth KS <= 10 slices of 16; simt HC <= 5 of 32
_NARROW_V_HD = (81, 96)   # the mma depth (KS 6) built for hdv < hd
_MIN_TILES_PER_SPLIT = 4


def _lib():
    return build.load("flash_attention", _SIGNATURES)


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 4)(*t.stride())


def _rows(q_dtype: torch.dtype, Tq: int) -> int:
    """Query rows per block, 16 per warp: 8 warps for a long call on the
    tensor cores (each K/V tile's staging serves twice the rows), else 4."""
    return 128 if q_dtype == torch.bfloat16 and Tq >= 64 else 64


def _splits(blocks: int, key_tiles: int, sms: int) -> int:
    """Split the key range when the grid would leave SMs idle (decode)."""
    if blocks >= 2 * sms:
        return 1
    return max(1, min(-(-2 * sms // blocks),
                      key_tiles // _MIN_TILES_PER_SPLIT))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    chunk: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, Tq, hd), k (B, KV, Tk, hd), v (B, KV, Tk, hdv) with
    hdv <= hd -> (B, H, Tq, hdv) in q's type. Queries sit at the tail of
    the keys (query i at position Tk - Tq + i); ``scale`` defaults to
    1/sqrt(hd)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       chunk=chunk, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must share a device")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 \
            or k.shape[:3] != v.shape[:3] or not 0 < v.shape[3] <= k.shape[3]:
        raise ValueError(f"flash_attention: expected q (B,H,Tq,hd), k "
                         f"(B,KV,Tk,hd) and v (B,KV,Tk,hdv) with "
                         f"0 < hdv <= hd, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Tq, hd = q.shape
    KV, Tk, hdv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)} (H % KV must be 0)")
    if not 0 < hd <= _MAX_HD:
        raise ValueError(f"flash_attention: head dim {hd} outside 1..{_MAX_HD}")
    if hdv < hd and q.dtype == torch.bfloat16 and not _NARROW_V_HD[0] <= hd \
            <= _NARROW_V_HD[1]:
        raise ValueError(f"flash_attention: v head dim {hdv} below q's {hd}: "
                         f"with bf16 q the kernel takes hdv < hd only for hd "
                         f"{_NARROW_V_HD[0]}..{_NARROW_V_HD[1]} (MLA)")
    if (q.dtype, k.dtype) not in _TYPE_PAIRS or v.dtype != k.dtype:
        raise ValueError(f"flash_attention: unsupported types q {q.dtype}, "
                         f"k {k.dtype}, v {v.dtype}; the kernel takes (q, k/v) "
                         f"in {_TYPE_PAIRS}")
    for name, n in (("window", window), ("chunk", chunk)):
        if n is not None and n < 1:
            raise ValueError(f"flash_attention: {name} must be >= 1, got {n}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    # (B, Tq, H, hdv) memory seen as (B, H, Tq, hdv)
    out = torch.empty((B, Tq, H, hdv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    rep = H // KV
    block_rows = _rows(q.dtype, Tq)
    group = min(rep, block_rows)
    n_hgroups = -(-rep // group)
    bt = block_rows // group
    blocks = -(-Tq // bt) * B * KV * n_hgroups
    span = Tk if window is None else min(Tk, window + Tq)
    if chunk is not None:
        span = min(span, chunk + Tq)
    splits = _splits(blocks, -(-span // _KEYS[q.dtype]),
                     torch.cuda.get_device_properties(
                         q.device).multi_processor_count)
    part_acc = part_ml = None
    if splits > 1:
        rows = B * H * Tq
        part_acc = torch.empty((splits, rows, hdv), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((splits, rows, 2), dtype=torch.float32,
                              device=q.device)
    with torch.cuda.device(q.device):
        err = _lib().cobra_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if part_acc is None else part_acc.data_ptr(),
            0 if part_ml is None else part_ml.data_ptr(),
            B, H, KV, Tq, Tk, hd, hdv,
            _strides(q), _strides(k), _strides(v), _strides(out),
            int(causal), window or 0, chunk or 0, float(scale),
            group, n_hgroups, bt, splits,
            _DTYPES[q.dtype], _DTYPES[k.dtype],
            int(build.rows16(k) and build.rows16(v)),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
