"""Flash attention: the CUDA kernels' wrappers, forward and backward.

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
``csrc/flash_attention.cu`` (its header says what bounds it and how).
:func:`fwd_body` picks its body from what the call shows: a long bf16
call (Tq >= 64: the prefill, the training forward) at a head-dim pair the
warp-specialised wgmma body is built for ((80, 80) and (96, 64)) with q's,
k's, v's and the output's rows 16-byte aligned takes that body; any other
bf16 call (decode, rows off 16 bytes, other head dims) the ``mma.sync``
body, in 8-warp blocks for a long call and 4-warp ones for decode; fp32 q
the CUDA cores (a two-way bf16 split cannot meet fp32's tolerance). Each
launch counts in ``flash_attention.launches`` and under its body in
``flash_attention.launches_by_body``.

The wrapper dispatches on the tensor's device: a CUDA tensor launches the
kernel (and bumps its counts), a CPU tensor takes the
plain version :func:`.ref.flash_attention_ref`, which autograd
differentiates. There is no fallback from one to the other. On the card,
with grad enabled and an input that requires it (training), the call goes
through an ``autograd.Function``: its forward is the same kernel, which
then also writes each row's log-sum-exp, and its backward is
:func:`flash_attention_bwd`, the kernel of ``csrc/flash_attention_bwd.cu``
(deterministic: two calls give the same bits; bf16 on the tensor cores,
by wgmma at the training head dims, :func:`bwd_body` picks the body),
counted in ``flash_attention_bwd.launches`` and, by body, in
``flash_attention_bwd.launches_by_body``. The backward
takes q, k and v of one type, bf16 or fp32 (the training path's; a bf16 q
over an fp32 cache is serving's and raises under grad).

The forward casts nothing and copies nothing: q and k/v may be
strided views (the (B, T, H, hd) projection, the (B, S, KV, hd) cache), in
the type pairs (q, k/v) fp32/fp32, bf16/fp32 and bf16/bf16; another pair
raises. The output has q's type and is a (B, H, Tq, hdv) view of
(B, Tq, H, hdv) memory, so the caller's transpose back to (B, Tq, H·hdv)
needs no copy.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build, ref

__all__ = ["flash_attention", "flash_attention_bwd", "fwd_body", "bwd_body"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "cobra_flash_attention": (
        _P, _P, _P, _P, _P, _P, _P,              # q, k, v, out, partials, lse
        _I, _I, _I, _I, _I, _I, _I,              # B, H, KV, Tq, Tk, hd, hdv
        _STRIDES, _STRIDES, _STRIDES, _STRIDES,  # q, k, v, out strides
        _I, _I, _I, ctypes.c_float,              # causal, window, chunk, scale
        _I, _I, _I, _I,                          # group, n_hgroups, bt, splits
        _I, _I, _I, _I, _P),                     # dtypes, body, vec, stream
}
_BWD_SIGNATURES = {
    "cobra_flash_attention_bwd": (
        _P, _P, _P, _P, _P, _P, _P,              # q, k, v, o, dout, lse, delta
        _P, _P, _P,                              # dq, dk, dv
        _I, _I, _I, _I, _I, _I, _I,              # B, H, KV, Tq, Tk, hd, hdv
        _STRIDES, _STRIDES, _STRIDES, _STRIDES,  # q, k, v, o strides
        _STRIDES, _STRIDES, _STRIDES, _STRIDES,  # dout, dq, dk, dv strides
        _I, _I, _I, ctypes.c_float,              # causal, window, chunk, scale
        _I, _I, _I, _I, _P),                     # dtype, body, width, vec, stream
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TYPE_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.bfloat16))
# keys per tile, by q's type: kKeys (CUDA cores), kKeysTc (tensor cores)
_KEYS = {torch.float32: 32, torch.bfloat16: 64}
_MAX_HD = 160        # mma depth KS <= 10 slices of 16; simt HC <= 5 of 32
_NARROW_V_HD = (81, 96)   # the mma depth (KS 6) built for hdv < hd
_MIN_TILES_PER_SPLIT = 4
# the forward's bodies (their codes in csrc/flash_attention.cu), and the
# (hd, hdv) pairs its wgmma body is built for, over an fp32 or a bf16 cache
# (danube's 80; MLA's 96 with v 64), from calls of this many queries on
FWD_BODIES = {"simt": 0, "mma": 1, "wgmma": 2}
_WG_FWD_HEAD_DIMS = ((80, 80), (96, 64))
_WG_FWD_MIN_TQ = 64
# the backward's bodies (their codes in csrc/flash_attention_bwd.cu), the
# (hd, hdv) pairs its wgmma body is built for (the training head dims of
# the registered architectures), and the widths the CUDA-core body pads to
BWD_BODIES = {"simt": 0, "wgmma": 1}
_WG_HEAD_DIMS = ((64, 64), (80, 80), (96, 64), (128, 128), (160, 160))
_SIMT_WIDTHS = (64, 128, 160)


def _lib():
    return build.load("flash_attention", _SIGNATURES)


def _bwd_lib():
    return build.load("flash_attention_bwd", _BWD_SIGNATURES)


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 4)(*t.stride())


def fwd_body(q_dtype: torch.dtype, kv_dtype: torch.dtype, Tq: int, hd: int,
             hdv: int, aligned: bool) -> str:
    """The forward kernel's body for q of type ``q_dtype`` and ``Tq``
    queries over k/v of type ``kv_dtype``, q.k head dim ``hd``, v head dim
    ``hdv``, and whether q's, k's, v's and the output's rows are 16-byte
    aligned (``build.rows16``): "wgmma" for bf16 q with ``Tq >= 64`` at a
    pair of ``_WG_FWD_HEAD_DIMS`` with aligned rows (the prefill and the
    training forward); "mma" for any other bf16 q (decode, rows off 16
    bytes, other head dims); "simt" for fp32 q."""
    if (q_dtype, kv_dtype) not in _TYPE_PAIRS:
        raise ValueError(f"flash_attention: unsupported types q {q_dtype}, "
                         f"k/v {kv_dtype}")
    if not 0 < hdv <= hd <= _MAX_HD:
        raise ValueError(f"flash_attention: head dims ({hd}, {hdv}) outside "
                         f"0 < hdv <= hd <= {_MAX_HD}")
    if q_dtype == torch.float32:
        return "simt"
    if Tq >= _WG_FWD_MIN_TQ and aligned and (hd, hdv) in _WG_FWD_HEAD_DIMS:
        return "wgmma"
    return "mma"


def _rows(q_dtype: torch.dtype, Tq: int) -> int:
    """Query rows per block: 128 for a long call on the tensor cores (the
    ``mma`` body's 8 warps of 16, or the ``wgmma`` body's two consumer
    warpgroups of 64; each K/V tile's staging serves twice the rows), else
    64 (4 warps)."""
    return 128 if q_dtype == torch.bfloat16 and Tq >= 64 else 64


def _splits(blocks: int, key_tiles: int, sms: int) -> int:
    """Split the key range when the grid would leave SMs idle (decode)."""
    if blocks >= 2 * sms:
        return 1
    return max(1, min(-(-2 * sms // blocks),
                      key_tiles // _MIN_TILES_PER_SPLIT))


def _check(q, k, v, window, chunk) -> None:
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must share a device")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 \
            or k.shape[:3] != v.shape[:3] or not 0 < v.shape[3] <= k.shape[3]:
        raise ValueError(f"flash_attention: expected q (B,H,Tq,hd), k "
                         f"(B,KV,Tk,hd) and v (B,KV,Tk,hdv) with "
                         f"0 < hdv <= hd, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Tq, hd = q.shape
    KV, hdv = k.shape[1], v.shape[3]
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    chunk: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, Tq, hd), k (B, KV, Tk, hd), v (B, KV, Tk, hdv) with
    hdv <= hd -> (B, H, Tq, hdv) in q's type. Queries sit at the tail of
    the keys (query i at position Tk - Tq + i); ``scale`` defaults to
    1/sqrt(hd). Differentiable on both devices."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       chunk=chunk, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, window, chunk)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if not q.dtype == k.dtype == v.dtype:
            raise ValueError(f"flash_attention: the backward kernel takes q, "
                             f"k and v of one type, got {q.dtype}, {k.dtype}")
        return _FlashAttention.apply(q, k, v, causal, window, chunk, scale)
    return _forward(q, k, v, causal, window, chunk, scale, with_lse=False)[0]


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its rows' log-sum-exps saved; the backward
    kernel for the gradients."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, scale):
        out, lse = _forward(q, k, v, causal, window, chunk, scale,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, chunk, scale)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, *ctx.mask)
        return dq, dk, dv, None, None, None, None


def _forward(q, k, v, causal, window, chunk, scale, with_lse: bool):
    """One launch of the forward kernel on checked inputs: (out, the rows'
    log-sum-exps (B, H, Tq) fp32 when ``with_lse``, else None)."""
    B, H, Tq, hd = q.shape
    KV, Tk, hdv = k.shape[1], k.shape[2], v.shape[3]
    # (B, Tq, H, hdv) memory seen as (B, H, Tq, hdv)
    out = torch.empty((B, Tq, H, hdv), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return out, lse
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
    body = fwd_body(q.dtype, k.dtype, Tq, hd, hdv,
                    all(build.rows16(t) for t in (q, k, v, out)))
    with torch.cuda.device(q.device):
        err = _lib().cobra_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            0 if part_acc is None else part_acc.data_ptr(),
            0 if part_ml is None else part_ml.data_ptr(),
            0 if lse is None else lse.data_ptr(),
            B, H, KV, Tq, Tk, hd, hdv,
            _strides(q), _strides(k), _strides(v), _strides(out),
            int(causal), window or 0, chunk or 0, float(scale),
            group, n_hgroups, bt, splits,
            _DTYPES[q.dtype], _DTYPES[k.dtype], FWD_BODIES[body],
            int(build.rows16(k) and build.rows16(v)),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_by_body[body] += 1
    return out, lse


flash_attention.launches = 0
flash_attention.launches_by_body = dict.fromkeys(FWD_BODIES, 0)


def bwd_body(hd: int, hdv: int, dtype: torch.dtype,
             aligned: bool) -> Tuple[str, int]:
    """The backward kernel's body for q.k head dim ``hd``, v head dim
    ``hdv``, the inputs' type and whether q's, k's, v's and dout's rows are
    16-byte aligned (``build.rows16``, and o's), with the head dim it pads
    hd to:
    ("wgmma", hd) for bf16 at a pair of ``_WG_HEAD_DIMS`` with aligned rows
    (nothing padded: wgmma's depth is 16 and its width any multiple of 8);
    ("simt", the next of ``_SIMT_WIDTHS``) for fp32 and for other bf16
    (rows off 16 bytes, other head dims)."""
    if not 0 < hdv <= hd <= _MAX_HD:
        raise ValueError(f"flash_attention_bwd: head dims ({hd}, {hdv}) "
                         f"outside 0 < hdv <= hd <= {_MAX_HD}")
    if dtype not in _DTYPES:
        raise ValueError(f"flash_attention_bwd: unsupported type {dtype}")
    if dtype == torch.bfloat16 and aligned and (hd, hdv) in _WG_HEAD_DIMS:
        return "wgmma", hd
    return "simt", next(w for w in _SIMT_WIDTHS if w >= hd)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        chunk: Optional[int] = None,
                        scale: Optional[float] = None):
    """The gradients (dq, dk, dv) of :func:`flash_attention` at q, k, v,
    from its output ``o``, its rows' log-sum-exps ``lse`` (B, H, Tq) fp32
    and the output's gradient ``dout``, in the inputs' types. A CUDA
    tensor launches the kernel (and bumps ``flash_attention_bwd.launches``
    and its body's count in ``flash_attention_bwd.launches_by_body``; the
    body from :func:`bwd_body`), a CPU tensor takes
    :func:`.ref.flash_attention_bwd_ref`."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, dout,
                                           causal=causal, window=window,
                                           chunk=chunk, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    _check(q, k, v, window, chunk)
    B, H, Tq, hd = q.shape
    KV, Tk, hdv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (k, v, o, dout)):
        raise ValueError(f"flash_attention_bwd: q, k, v, o and dout must "
                         f"share a type in {list(_DTYPES)}")
    if tuple(o.shape) != (B, H, Tq, hdv) or tuple(dout.shape) != (B, H, Tq, hdv):
        raise ValueError(f"flash_attention_bwd: o and dout must be "
                         f"{(B, H, Tq, hdv)}")
    if any(t.device != q.device for t in (o, lse, dout)):
        raise ValueError("flash_attention_bwd: every input must be on one "
                         "device")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Tq) \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be contiguous "
                         f"float32 {(B, H, Tq)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    aligned = all(build.rows16(t) for t in (q, k, v, o, dout))
    body, width = bwd_body(hd, hdv, q.dtype, aligned)
    return launch_bwd(_bwd_lib(), q, k, v, o, lse, dout, causal, window,
                      chunk, scale, body, width)


def launch_bwd(lib, q, k, v, o, lse, dout, causal, window, chunk, scale,
               body: str, width: int):
    """One launch of the backward through ``lib`` (a build of
    ``csrc/flash_attention_bwd.cu``) on checked inputs, with the given body
    and padded head dim: (dq, dk, dv), each a (B, heads, T, dim) view of
    (B, T, heads, dim) memory, the projections' layout. A launch bumps
    ``flash_attention_bwd.launches`` and its body's count in
    ``flash_attention_bwd.launches_by_body``."""
    B, H, Tq, hd = q.shape
    KV, Tk, hdv = k.shape[1], k.shape[2], v.shape[3]
    dq = torch.empty((B, Tq, H, hd), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk = torch.empty((B, Tk, KV, hd), dtype=k.dtype,
                     device=q.device).transpose(1, 2)
    dv = torch.empty((B, Tk, KV, hdv), dtype=v.dtype,
                     device=q.device).transpose(1, 2)
    if B == 0 or H == 0 or (Tq == 0 and Tk == 0):   # the entry launches nothing
        return dq, dk, dv
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.cobra_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, KV, Tq, Tk, hd, hdv,
            _strides(q), _strides(k), _strides(v), _strides(o),
            _strides(dout), _strides(dq), _strides(dk), _strides(dv),
            int(causal), window or 0, chunk or 0, float(scale),
            _DTYPES[q.dtype], BWD_BODIES[body], width,
            int(all(build.rows16(t) for t in (q, k, v, o, dout))),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_body[body] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_body = dict.fromkeys(BWD_BODIES, 0)
