"""RWKV6 WKV scan: the CUDA kernel's wrapper.

The time-mix recurrence of the LM serving path (``models/layers.rwkv6_block``)::

    y_t = r_t . S_{t-1} + (sum_k r_t u k_t) v_t
    S_t = diag(exp w_t) S_{t-1} + k_t (x) v_t

over r/k/w_log ``(B, H, T, K)``, v ``(B, H, T, V)``, u ``(H, K)``, from an
initial state ``(B, H, K, V)`` (zeros when none is given). The kernel is in
``csrc/rwkv6_scan.cu`` (its header says what bounds it and how): a
chunk-parallel scan over chunks of :data:`CHUNK_LEN` tokens, whose scratch
(each chunk's state and decay, fp32) the wrapper allocates.

The wrapper dispatches on the tensor's device: a CUDA tensor launches the
kernel (and bumps ``rwkv6_scan.launches``), a CPU tensor takes the plain
version :func:`.ref.rwkv6_scan_ref`. There is no fallback from one to the
other. r/k/v may be bf16 or fp32 (one type for the three) and strided;
w_log, u and the state are fp32. y has r's type and is a (B, H, T, V) view
of (B, T, H, V) memory, so the caller's transpose back needs no copy; the
final state is a new fp32 tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, ref

__all__ = ["rwkv6_scan"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "cobra_rwkv6_scan": (
        _P, _P, _P, _P, _P, _P, _P, _P,          # r, k, v, w, u, s_in, y, s_out
        _P, _P,                                  # chunk states L, decays D
        _I, _I, _I, _I, _I,                      # B, H, T, K, V
        _STRIDES, _STRIDES, _STRIDES, _STRIDES, _STRIDES,
        _I, _I, _P),                             # dtype, vec, stream
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KS = (16, 32, 64)
_MAX_V = 256
CHUNK_LEN = 64      # tokens per chunk (kChunkLen in the kernel)


def n_chunks(T: int) -> int:
    """Chunks of the scan: 1 (the token recurrence alone) for T <= CHUNK_LEN."""
    return -(-T // CHUNK_LEN) if T > CHUNK_LEN else 1


def _lib():
    return build.load("rwkv6_scan", _SIGNATURES)


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 4)(*t.stride())


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w_log: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, H, T, V) in r's type, final state (B, H, K, V) fp32)."""
    if r.device.type == "cpu":
        return ref.rwkv6_scan_ref(r, k, v, w_log, u, state=state)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    tensors = [k, v, w_log, u] + ([state] if state is not None else [])
    if any(t.device != r.device for t in tensors):
        raise ValueError("rwkv6_scan: every input must be on one device")
    if r.ndim != 4 or k.shape != r.shape or w_log.shape != r.shape \
            or v.ndim != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"rwkv6_scan: expected r/k/w_log (B,H,T,K) and v "
                         f"(B,H,T,V), got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(w_log.shape)}, {tuple(v.shape)}")
    B, H, T, K = r.shape
    V = v.shape[-1]
    if V > _MAX_V:
        raise ValueError(f"rwkv6_scan: V = {V}; the kernel takes V <= {_MAX_V}")
    if K not in _KS:
        raise ValueError(f"rwkv6_scan: K = {K}; the kernel takes K in {_KS}")
    if tuple(u.shape) != (H, K):
        raise ValueError(f"rwkv6_scan: u must be ({H}, {K}), got {tuple(u.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"rwkv6_scan: r/k/v must share a type in "
                         f"{list(_DTYPES)}, got {r.dtype}, {k.dtype}, {v.dtype}")
    if w_log.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError("rwkv6_scan: w_log and u must be float32")
    if state is not None and (state.dtype != torch.float32
                              or tuple(state.shape) != (B, H, K, V)
                              or not state.is_contiguous()):
        raise ValueError(f"rwkv6_scan: state must be contiguous float32 "
                         f"({B}, {H}, {K}, {V})")
    if not u.is_contiguous():
        raise ValueError("rwkv6_scan: u must be contiguous")
    y = torch.empty((B, T, H, V), dtype=r.dtype, device=r.device).transpose(1, 2)
    s_out = torch.empty((B, H, K, V), dtype=torch.float32, device=r.device)
    nC = n_chunks(T)
    chunk_states = chunk_decays = None
    if nC > 1:
        chunk_states = torch.empty((B, H, nC, K, V), dtype=torch.float32,
                                   device=r.device)
        chunk_decays = torch.empty((B, H, nC, K), dtype=torch.float32,
                                   device=r.device)
    with torch.cuda.device(r.device):
        err = _lib().cobra_rwkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
            u.data_ptr(), 0 if state is None else state.data_ptr(),
            y.data_ptr(), s_out.data_ptr(),
            0 if chunk_states is None else chunk_states.data_ptr(),
            0 if chunk_decays is None else chunk_decays.data_ptr(),
            B, H, T, K, V,
            _strides(r), _strides(k), _strides(v), _strides(w_log),
            _strides(y), _DTYPES[r.dtype],
            int(all(build.rows16(t) for t in (r, k, v, w_log))),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "rwkv6_scan")
    rwkv6_scan.launches += 1
    return y, s_out


rwkv6_scan.launches = 0
