"""RWKV6 WKV scan: the CUDA kernels' wrappers, forward and backward.

The time-mix recurrence of the LM path (``models/layers.rwkv6_block``)::

    y_t = r_t . S_{t-1} + (sum_k r_t u k_t) v_t
    S_t = diag(exp w_t) S_{t-1} + k_t (x) v_t

over r/k/w_log ``(B, H, T, K)``, v ``(B, H, T, V)``, u ``(H, K)``, from an
initial state ``(B, H, K, V)`` (zeros when none is given). The forward
kernel is in ``csrc/rwkv6_scan.cu``, its gradient in
``csrc/rwkv6_scan_bwd.cu`` (their headers say what bounds them and how):
chunk-parallel scans over chunks of :data:`CHUNK_LEN` tokens, whose
scratch (each chunk's state and decay, fp32) the wrappers allocate.

The wrappers dispatch on the tensor's device: a CUDA tensor launches the
kernel (and bumps ``rwkv6_scan.launches`` or ``rwkv6_scan_bwd.launches``),
a CPU tensor takes the plain version, :func:`.ref.rwkv6_scan_ref` (which
autograd differentiates) or :func:`.ref.rwkv6_scan_bwd_ref`. There is no
fallback from one to the other. On the card, with grad enabled and an input
that requires it, the scan runs as an ``autograd.Function``: the forward
kernel keeps its chunk states and decays for the backward kernel; under
``torch.no_grad()`` (serving) nothing is kept. r/k/v may be bf16 or fp32
(one type for the three) and strided; w_log, u and the state are fp32. y
has r's type and is a (B, H, T, V) view of (B, T, H, V) memory, so the
caller's transpose back needs no copy; the final state is a new fp32
tensor. The gradients of r, k, v and w_log are such views too, dr/dk/dv in
r's type, dw_log, du and the state's in fp32. The backward has two bodies,
picked by :func:`scan_bwd_body` from the shapes, the type and the rows'
alignment: "mma", each chunk as matrix products on the tensor cores (bf16,
K 64, V a multiple of 16 up to 128: the training call), and "simt", the
token walk on the CUDA cores (everything else).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, ref

__all__ = ["rwkv6_scan", "rwkv6_scan_bwd", "scan_bwd_body"]

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
_BWD_SIGNATURES = {
    "cobra_rwkv6_scan_bwd": (
        _P, _P, _P, _P, _P, _P, _P, _P,          # r, k, v, w, u, s_in, dy, ds_out
        _P, _P, _P, _P,                          # L, D, scratch M, du_part
        _P, _P, _P, _P, _P, _P,                  # dr, dk, dv, dw, du, dstate
        _I, _I, _I, _I, _I,                      # B, H, T, K, V
        *(_STRIDES,) * 9,                        # r k v w dy dr dk dv dw
        _I, _I, _P),                             # dtype, body, stream
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KS = (16, 32, 64)
_MAX_V = 256
CHUNK_LEN = 64      # tokens per chunk (kChunkLen in both kernels)
# the backward's bodies, by their code in cobra_rwkv6_scan_bwd
BWD_BODIES = {"simt": 0, "mma": 1}
_MMA_K = 64         # the mma body's K, and its V: multiples of 16 up to 128
_MMA_MAX_V = 128


def n_chunks(T: int) -> int:
    """Chunks of the scan: 1 (the token recurrence alone) for T <= CHUNK_LEN."""
    return -(-T // CHUNK_LEN) if T > CHUNK_LEN else 1


def _lib():
    return build.load("rwkv6_scan", _SIGNATURES)


def _bwd_lib():
    return build.load("rwkv6_scan_bwd", _BWD_SIGNATURES)


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 4)(*t.stride())


def _check(r, k, v, w_log, u, state) -> None:
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


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w_log: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, H, T, V) in r's type, final state (B, H, K, V) fp32).
    Differentiable on both devices."""
    if r.device.type == "cpu":
        return ref.rwkv6_scan_ref(r, k, v, w_log, u, state=state)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    _check(r, k, v, w_log, u, state)
    inputs = [r, k, v, w_log, u] + ([state] if state is not None else [])
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _RWKV6Scan.apply(r, k, v, w_log, u, state)
    y, s_out, _, _ = _forward(r, k, v, w_log, u, state)
    return y, s_out


class _RWKV6Scan(torch.autograd.Function):
    """The forward kernel with its chunk states and decays kept; the
    backward kernel for the gradients."""

    @staticmethod
    def forward(ctx, r, k, v, w_log, u, state):
        y, s_out, chunk_states, chunk_decays = _forward(r, k, v, w_log, u,
                                                        state)
        ctx.save_for_backward(r, k, v, w_log, u, state, chunk_states,
                              chunk_decays)
        ctx.set_materialize_grads(False)
        return y, s_out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, ds_out):
        r, k, v, w_log, u, state, chunk_states, chunk_decays = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros((*r.shape[:3], v.shape[3]), dtype=r.dtype,
                             device=r.device)
        dr, dk, dv, dw, du, dstate = rwkv6_scan_bwd(
            r, k, v, w_log, u, state, dy, ds_out, chunk_states, chunk_decays)
        return dr, dk, dv, dw, du, (dstate if state is not None else None)


def _forward(r, k, v, w_log, u, state):
    """One launch of the forward kernel on checked inputs: (y, the final
    state, and the states entering each chunk (B, H, nC, K, V) and the
    chunks' decays (B, H, nC, K), both fp32, or None when nC is 1)."""
    B, H, T, K = r.shape
    V = v.shape[-1]
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
    return y, s_out, chunk_states, chunk_decays


rwkv6_scan.launches = 0


def scan_bwd_body(K: int, V: int, dtype: torch.dtype, aligned: bool) -> str:
    """The backward kernel's body for state width ``K`` x ``V``, r's type
    and whether r's, k's, v's, w_log's and dy's rows (``build.rows16``)
    and the state's base are 16-byte aligned: "mma" (the chunk as matrix
    products on the tensor cores) for bf16 at K 64 with V a multiple of 16
    up to 128 and aligned rows, "simt" (the token walk on the CUDA cores)
    for everything else the kernel takes."""
    if K not in _KS or not 0 < V <= _MAX_V:
        raise ValueError(f"rwkv6_scan_bwd: K = {K}, V = {V}; the kernel "
                         f"takes K in {_KS} and V <= {_MAX_V}")
    if dtype not in _DTYPES:
        raise ValueError(f"rwkv6_scan_bwd: unsupported type {dtype}")
    if dtype == torch.bfloat16 and aligned and K == _MMA_K \
            and V % 16 == 0 and V <= _MMA_MAX_V:
        return "mma"
    return "simt"


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w_log: torch.Tensor, u: torch.Tensor,
                   state: Optional[torch.Tensor], dy: torch.Tensor,
                   ds_out: Optional[torch.Tensor] = None,
                   chunk_states: Optional[torch.Tensor] = None,
                   chunk_decays: Optional[torch.Tensor] = None):
    """The gradients (dr, dk, dv, dw_log, du, dstate) of :func:`rwkv6_scan`
    at its inputs, given ``dy`` (B, H, T, V) in y's type on the output and
    ``ds_out`` (B, H, K, V) fp32 on the final state (zeros when None). A
    CUDA tensor launches the kernel (and bumps ``rwkv6_scan_bwd.launches``)
    and needs, when T > :data:`CHUNK_LEN`, the chunk states and decays the
    forward kernel left (:func:`_forward`); a CPU tensor takes
    :func:`.ref.rwkv6_scan_bwd_ref`. The body is :func:`scan_bwd_body`'s,
    and a launch also bumps its count in
    ``rwkv6_scan_bwd.launches_by_body``. dr, dk and dv come in r's type,
    each a (B, H, T, ·) view of (B, T, H, ·) memory as dw_log is; dw_log,
    du (H, K) and dstate in fp32."""
    if r.device.type == "cpu":
        return ref.rwkv6_scan_bwd_ref(r, k, v, w_log, u, state, dy, ds_out)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan_bwd: unsupported device {r.device}")
    _check(r, k, v, w_log, u, state)
    B, H, T, K = r.shape
    V = v.shape[-1]
    nC = n_chunks(T)
    if tuple(dy.shape) != (B, H, T, V) or dy.dtype != r.dtype \
            or dy.device != r.device:
        raise ValueError(f"rwkv6_scan_bwd: dy must be {r.dtype} "
                         f"{(B, H, T, V)} on {r.device}")
    if ds_out is not None:
        if tuple(ds_out.shape) != (B, H, K, V) or ds_out.device != r.device:
            raise ValueError(f"rwkv6_scan_bwd: ds_out must be {(B, H, K, V)} "
                             f"on {r.device}")
        ds_out = ds_out.to(torch.float32).contiguous()
    if nC > 1:
        for name, t, shape in (("chunk_states", chunk_states, (B, H, nC, K, V)),
                               ("chunk_decays", chunk_decays, (B, H, nC, K))):
            if t is None or tuple(t.shape) != shape \
                    or t.dtype != torch.float32 or not t.is_contiguous() \
                    or t.device != r.device:
                raise ValueError(f"rwkv6_scan_bwd: {name} must be the "
                                 f"forward kernel's, contiguous float32 "
                                 f"{shape}")
    aligned = all(build.rows16(t) for t in (r, k, v, w_log, dy)) \
        and (state is None or build.aligned16(state))
    return launch_bwd(_bwd_lib(), r, k, v, w_log, u, state, dy, ds_out,
                      chunk_states, chunk_decays,
                      scan_bwd_body(K, V, r.dtype, aligned))


def launch_bwd(lib, r, k, v, w_log, u, state, dy, ds_out, chunk_states,
               chunk_decays, body: str):
    """One launch of the backward through ``lib`` (a build of
    ``csrc/rwkv6_scan_bwd.cu``) on checked inputs (``ds_out`` fp32 and
    contiguous or None), with the given body: (dr, dk, dv, dw_log, du,
    dstate). A launch bumps ``rwkv6_scan_bwd.launches`` and its body's
    count in ``rwkv6_scan_bwd.launches_by_body``."""
    B, H, T, K = r.shape
    V = v.shape[-1]
    nC = n_chunks(T)
    dev = r.device
    mma = body == "mma"

    def grad(width, dtype):    # (B, T, H, width) memory seen as (B, H, T, width)
        return torch.empty((B, T, H, width), dtype=dtype,
                           device=dev).transpose(1, 2)

    dr, dk, dv = grad(K, r.dtype), grad(K, r.dtype), grad(V, r.dtype)
    dw = grad(K, torch.float32)
    du = torch.empty((H, K), dtype=torch.float32, device=dev)
    dstate = torch.empty((B, H, K, V), dtype=torch.float32, device=dev)
    adjoints = torch.empty((B, H, nC, K, V), dtype=torch.float32, device=dev) \
        if nC > 1 or mma else None
    if nC == 1:    # the forward leaves none; the mma body's phase A' writes it
        chunk_states = None
        chunk_decays = torch.empty((B, H, 1, K), dtype=torch.float32,
                                   device=dev) if mma else None
    du_part = torch.empty((B, H, nC, K), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.cobra_rwkv6_scan_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
            u.data_ptr(), 0 if state is None else state.data_ptr(),
            dy.data_ptr(), 0 if ds_out is None else ds_out.data_ptr(),
            0 if chunk_states is None else chunk_states.data_ptr(),
            0 if chunk_decays is None else chunk_decays.data_ptr(),
            0 if adjoints is None else adjoints.data_ptr(),
            du_part.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dw.data_ptr(), du.data_ptr(), dstate.data_ptr(),
            B, H, T, K, V,
            *(_strides(t) for t in (r, k, v, w_log, dy, dr, dk, dv, dw)),
            _DTYPES[r.dtype], BWD_BODIES[body],
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "rwkv6_scan_bwd")
    rwkv6_scan_bwd.launches += 1
    rwkv6_scan_bwd.launches_by_body[body] += 1
    return dr, dk, dv, dw, du, dstate


rwkv6_scan_bwd.launches = 0
rwkv6_scan_bwd.launches_by_body = dict.fromkeys(BWD_BODIES, 0)
