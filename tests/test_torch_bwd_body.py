"""The choice of the attention backward's body and padding, on the CPU.

``flash_attention.bwd_body`` picks which hand-written body of
``csrc/flash_attention_bwd.cu`` a call on the card launches, and the head
dim it pads to, from the q.k and v head dims, the inputs' type and whether
q's, k's, v's, o's and dout's rows are 16-byte aligned (``build.rows16``):
the wgmma body for bf16 at the training head dims with aligned rows, the
CUDA cores for fp32 and for any other bf16 (rows off 16 bytes, other head
dims). The choice is plain Python, so it is pinned here, over every
registered architecture's training head dims, where no card is needed.
"""

import importlib

import pytest
import torch

from repro_torch.kernels import build, ops
from repro_torch.models import get_arch
from repro_torch.models.arch import list_archs

fa = importlib.import_module("repro_torch.kernels.flash_attention")

ATTENTION_ARCHS = [n for n in list_archs() if get_arch(n).attn_kind != "none"]
SIMT_WIDTHS = (64, 128, 160)


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


def test_every_attention_architecture_is_covered():
    assert len(ATTENTION_ARCHS) == len(list_archs()) - 1   # all but rwkv6
    assert {_head_dims(get_arch(n)) for n in ATTENTION_ARCHS} \
        == set(fa._WG_HEAD_DIMS)


@pytest.mark.parametrize("name", ATTENTION_ARCHS)
def test_training_head_dims_take_the_wgmma_body(name):
    arch = get_arch(name)
    hd, hdv = _head_dims(arch)
    tensors = [_rows((2, arch.n_heads, 77, hd), torch.bfloat16),
               _rows((2, arch.n_kv_heads, 77, hd), torch.bfloat16),
               _rows((2, arch.n_kv_heads, 77, hdv), torch.bfloat16),
               _rows((2, arch.n_heads, 77, hdv), torch.bfloat16)]
    aligned = all(build.rows16(t) for t in tensors)
    assert aligned
    # nothing padded: wgmma's depth is 16 and its width any multiple of 8
    assert fa.bwd_body(hd, hdv, torch.bfloat16, aligned) == ("wgmma", hd)
    assert hd % 16 == 0 and hdv % 16 == 0


@pytest.mark.parametrize("name", ATTENTION_ARCHS)
def test_rows_off_16_bytes_take_another_hand_written_body(name):
    arch = get_arch(name)
    hd, hdv = _head_dims(arch)
    q = _rows((2, arch.n_heads, 77, hd), torch.bfloat16, offset=True)
    assert not build.rows16(q)
    assert fa.bwd_body(hd, hdv, torch.bfloat16, False) \
        == ("simt", min(w for w in SIMT_WIDTHS if w >= hd))


@pytest.mark.parametrize("name", ATTENTION_ARCHS)
def test_fp32_takes_the_cuda_cores(name):
    hd, hdv = _head_dims(get_arch(name))
    for aligned in (True, False):
        assert fa.bwd_body(hd, hdv, torch.float32, aligned) \
            == ("simt", min(w for w in SIMT_WIDTHS if w >= hd))


@pytest.mark.parametrize("hd", range(1, 161))
def test_bf16_pads_to_the_next_built_depth(hd):
    body, width = fa.bwd_body(hd, hd, torch.bfloat16, True)
    if (hd, hd) in fa._WG_HEAD_DIMS:
        assert (body, width) == ("wgmma", hd)
    else:
        assert (body, width) == ("simt", min(w for w in SIMT_WIDTHS if w >= hd))


@pytest.mark.parametrize("hd,hdv", [(96, 96), (128, 64), (112, 112),
                                    (144, 144), (16, 16), (80, 64)])
def test_other_pairs_are_not_built_for_wgmma(hd, hdv):
    assert fa.bwd_body(hd, hdv, torch.bfloat16, True)[0] != "wgmma"


@pytest.mark.parametrize("hd,hdv,dtype", [(161, 161, torch.bfloat16),
                                          (64, 80, torch.bfloat16),
                                          (0, 0, torch.float32),
                                          (64, 64, torch.float16)])
def test_what_no_body_takes_raises(hd, hdv, dtype):
    with pytest.raises(ValueError):
        fa.bwd_body(hd, hdv, dtype, True)


def test_cpu_calls_count_no_launch():
    ops.reset_launch_counts()
    assert fa.flash_attention_bwd.launches_by_body == {"simt": 0, "wgmma": 0}
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 9, 16, generator=g) for _ in range(3))
    o, lse = fa.ref.flash_attention_ref(q, k, v, return_lse=True)
    fa.flash_attention_bwd(q, k, v, o, lse, torch.ones_like(o))
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    assert set(fa.flash_attention_bwd.launches_by_body.values()) == {0}
