"""The choice of the attention forward's body, on the CPU.

``flash_attention.fwd_body`` picks which hand-written body of
``csrc/flash_attention.cu`` a call on the card launches from what the call
shows: q's and k/v's types, the number of queries, the q.k and v head dims
and whether q's, k's, v's and the output's rows are 16-byte aligned
(``build.rows16``). The warp-specialised wgmma body takes the long bf16
calls (the prefill over the fp32 cache, the training forward over bf16
k/v) at the head-dim pairs it is built for; every other bf16 call (decode,
rows off 16 bytes, other head dims) keeps the ``mma.sync`` body, and fp32 q
the CUDA cores. The choice is plain Python, so it is pinned here, over
every registered architecture's prefill and training head dims, where no
card is needed.
"""

import importlib

import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.models import get_arch
from repro_torch.models.arch import list_archs

fa = importlib.import_module("repro_torch.kernels.flash_attention")

ATTENTION_ARCHS = [n for n in list_archs() if get_arch(n).attn_kind != "none"]
# the pairs the wgmma body is built for: danube's 80; MLA's 96 with v 64
BUILT = {(80, 80), (96, 64)}
# (q, k/v) types: the serving prefill over the fp32 cache, the training
# forward
LONG_CALLS = [(torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]


def _head_dims(arch):
    """(q.k, v) head dims of an architecture's attention."""
    if arch.attn_kind == "mla":
        return arch.qk_nope_dim + arch.qk_rope_dim, arch.vhd
    return arch.hd, arch.hd


def _rows(shape, dtype, offset=False):
    """A (B, heads, T, dim) view of (B, T, heads, dim) memory, as the
    projections and the wrapper's outputs are laid out; with ``offset``, one
    element into its buffer."""
    B, H, T, d = shape
    buf = torch.zeros(B * T * H * d + int(offset), dtype=dtype)
    return buf[int(offset):].view(B, T, H, d).transpose(1, 2)


def _aligned(arch, T, q_dt, kv_dt, offset=False):
    """``build.rows16`` over a call's q, k, v and output in the layouts the
    model passes them (k and v with ``offset``: one element into their
    buffer)."""
    hd, hdv = _head_dims(arch)
    tensors = [_rows((2, arch.n_heads, T, hd), q_dt),
               _rows((2, arch.n_kv_heads, T, hd), kv_dt, offset),
               _rows((2, arch.n_kv_heads, T, hdv), kv_dt, offset),
               _rows((2, arch.n_heads, T, hdv), q_dt)]
    return all(build.rows16(t) for t in tensors)


def test_every_built_pair_is_an_architectures():
    assert {_head_dims(get_arch(n)) for n in ATTENTION_ARCHS} >= BUILT
    assert set(fa._WG_FWD_HEAD_DIMS) == BUILT
    assert fa.FWD_BODIES == {"simt": 0, "mma": 1, "wgmma": 2}


@pytest.mark.parametrize("q_dt,kv_dt", LONG_CALLS)
@pytest.mark.parametrize("name", ATTENTION_ARCHS)
def test_long_calls_take_the_wgmma_body_at_the_built_pairs(name, q_dt, kv_dt):
    arch = get_arch(name)
    hd, hdv = _head_dims(arch)
    aligned = _aligned(arch, 2048, q_dt, kv_dt)
    assert aligned
    want = "wgmma" if (hd, hdv) in BUILT else "mma"
    assert fa.fwd_body(q_dt, kv_dt, 2048, hd, hdv, aligned) == want


@pytest.mark.parametrize("q_dt,kv_dt", LONG_CALLS)
@pytest.mark.parametrize("name", ATTENTION_ARCHS)
def test_decode_keeps_the_mma_body(name, q_dt, kv_dt):
    arch = get_arch(name)
    hd, hdv = _head_dims(arch)
    assert fa.fwd_body(q_dt, kv_dt, 1, hd, hdv,
                       _aligned(arch, 1, q_dt, kv_dt)) == "mma"


@pytest.mark.parametrize("name", ATTENTION_ARCHS)
def test_rows_off_16_bytes_keep_the_mma_body(name):
    arch = get_arch(name)
    hd, hdv = _head_dims(arch)
    aligned = _aligned(arch, 300, torch.bfloat16, torch.float32, offset=True)
    assert not aligned
    assert fa.fwd_body(torch.bfloat16, torch.float32, 300, hd, hdv,
                       aligned) == "mma"


@pytest.mark.parametrize("Tq", [1, 16, 63, 64, 65, 4001, 15012])
@pytest.mark.parametrize("hd,hdv", sorted(BUILT))
def test_the_wgmma_body_from_64_queries_on(Tq, hd, hdv):
    want = "wgmma" if Tq >= 64 else "mma"
    for kv_dt in (torch.float32, torch.bfloat16):
        assert fa.fwd_body(torch.bfloat16, kv_dt, Tq, hd, hdv, True) == want


@pytest.mark.parametrize("name", ATTENTION_ARCHS)
def test_fp32_q_takes_the_cuda_cores(name):
    hd, hdv = _head_dims(get_arch(name))
    for Tq in (1, 4096):
        for aligned in (True, False):
            assert fa.fwd_body(torch.float32, torch.float32, Tq, hd, hdv,
                               aligned) == "simt"


@pytest.mark.parametrize("hd,hdv", [(64, 64), (128, 128), (160, 160),
                                    (96, 96), (80, 64), (88, 40), (16, 16),
                                    (112, 112)])
def test_other_pairs_are_not_built_for_wgmma(hd, hdv):
    for kv_dt in (torch.float32, torch.bfloat16):
        assert fa.fwd_body(torch.bfloat16, kv_dt, 4096, hd, hdv,
                           True) == "mma"


@pytest.mark.parametrize("q_dt,kv_dt,hd,hdv", [
    (torch.float32, torch.bfloat16, 80, 80),   # no fp32 q over bf16 k/v
    (torch.float16, torch.float32, 80, 80),
    (torch.bfloat16, torch.float32, 161, 161),
    (torch.bfloat16, torch.float32, 64, 80),   # v wider than q.k
    (torch.bfloat16, torch.float32, 0, 0)])
def test_what_no_body_takes_raises(q_dt, kv_dt, hd, hdv):
    with pytest.raises(ValueError):
        fa.fwd_body(q_dt, kv_dt, 4096, hd, hdv, True)


def test_the_serving_layouts_are_aligned():
    # danube's prefill: q the (B, T, H, hd) projection, k/v views of the
    # (2, B, S, KV, hd) fp32 cache; MLA's: k assembled (B, T, H, 96), v the
    # strided slice of the expanded latent (B, T, H, 64 + 64)
    B, T, S = 2, 70, 96
    q = torch.zeros(B, T, 32, 80, dtype=torch.bfloat16).transpose(1, 2)
    cache = torch.zeros(2, B, S, 8, 80)
    k, v = (cache[i, :, :T].transpose(1, 2) for i in range(2))
    out = torch.empty(B, T, 32, 80, dtype=torch.bfloat16).transpose(1, 2)
    assert all(build.rows16(t) for t in (q, k, v, out))
    kv = torch.zeros(B, T, 40, 128)
    k = torch.zeros(B, T, 40, 96).transpose(1, 2)
    v = kv[..., 64:].transpose(1, 2)
    q = torch.zeros(B, T, 40, 96, dtype=torch.bfloat16).transpose(1, 2)
    out = torch.empty(B, T, 40, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert not v.is_contiguous()
    assert all(build.rows16(t) for t in (q, k, v, out))
    assert fa.fwd_body(q.dtype, k.dtype, T, 96, 64, True) == "wgmma"


def test_reset_zeroes_the_counts_by_body():
    fa.flash_attention.launches_by_body.update(simt=3, mma=2, wgmma=5)
    fa.flash_attention.launches = 10
    ops.reset_launch_counts()
    assert fa.flash_attention.launches_by_body == {"simt": 0, "mma": 0,
                                                   "wgmma": 0}
    assert ops.launch_counts()["flash_attention"] == 0


def test_cpu_calls_count_no_launch():
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 70, 80, generator=g) for _ in range(3))
    fa.flash_attention(q.bfloat16(), k, v)
    assert ops.launch_counts()["flash_attention"] == 0
    assert set(fa.flash_attention.launches_by_body.values()) == {0}
