"""Kernel parity between the JAX package and its PyTorch port.

Each kernel of the port (``repro_torch.kernels``: ``join_probe`` with its
``build_direct_table``, and ``segment_reduce``) has a plain torch version,
which its wrapper takes for a CPU tensor. On the same inputs, made with
numpy from a seed, that plain version must agree with the reference's
Pallas kernel (interpret mode, as the reference's own parity tests run it)
and with the reference's numpy twins:

  * ``join_probe`` / ``build_direct_table``: exactly (``atol=0``);
  * ``segment_reduce``: exactly on integer-valued inputs, and within
    ``rtol=1e-5`` on random fp32 sums (the sums run in another order).

It also pins the premises the LM kernels' designs rest on: the serving
path writes bf16 values into its fp32 KV cache (so ``flash_attention``'s
tensor-core body may skip the lo half of its bf16 split), and the
chunk-parallel scan of ``rwkv6_scan`` (its three phases written out in
torch here) equals the sequential recurrence; and how the wrappers pick a
body, a block size, 16-byte copies and a chunk count.

``tests/test_torch_cuda.py`` holds the CUDA kernels against the same plain
versions on the card.
"""

import importlib
import inspect

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import build_direct_table as ref_build_direct_table  # noqa: E402
from repro.kernels import join_probe as ref_join_probe  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.kernels import segment_reduce as ref_segment_reduce  # noqa: E402
from _torch_cases import PROBE_CASES, SEGMENT_CASES, t32  # noqa: E402
from _torch_parity import FP32_RTOL, reference_pallas  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

# the module (the package re-exports its function under the same name)
sr = importlib.import_module("repro_torch.kernels.segment_reduce")


# --------------------------------------------------------------------------
# join_probe / build_direct_table
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PROBE_CASES))
def test_join_probe_plain_matches_pallas_and_numpy(name):
    probe, keys, key_space = (np.asarray(a, np.int32) if i < 2 else a
                              for i, a in enumerate(PROBE_CASES[name]))
    slots = ops.build_direct_table(t32(keys), key_space)
    got = ops.join_probe(t32(probe), slots)
    assert got.dtype == torch.int32 and got.shape == (probe.shape[0],)
    # the reference's slot table and its Pallas probe (interpret mode)
    ref_slots = ref_build_direct_table(jnp.asarray(keys, jnp.int32), key_space)
    np.testing.assert_array_equal(slots.numpy(), np.asarray(ref_slots))
    pallas = np.asarray(ref_join_probe(jnp.asarray(probe), ref_slots,
                                       block_n=256, interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    # and both packages' numpy twins
    want = ref_ref.join_probe_np(probe, keys)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.join_probe_np(probe, keys), want)


@pytest.mark.parametrize("name", sorted(PROBE_CASES))
def test_searchsorted_probe_matches_reference(name):
    """``join_probe_ref``: the probe ``equi_probe`` takes without a key
    space (the prefetch-cache lookup), against the reference's jnp one."""
    probe, keys, _ = (np.asarray(a, np.int32) if i < 2 else a
                      for i, a in enumerate(PROBE_CASES[name]))
    got = ref.join_probe_ref(t32(probe), t32(keys))
    want = np.asarray(ref_ref.join_probe_ref(jnp.asarray(probe),
                                             jnp.asarray(keys)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref.join_probe_np(probe, keys))


def test_duplicate_build_keys_match_numpy_twin():
    # duplicates are undefined in the reference's scatter; the port keeps
    # the smallest row id, the first stable match of join_probe_np
    probe = np.asarray([1, 2, 3, 4, 0], np.int32)
    keys = np.asarray([2, 4, 2, 4, 1], np.int32)
    got = ops.join_probe(t32(probe), ops.build_direct_table(t32(keys), 8))
    np.testing.assert_array_equal(got.numpy(), ref.join_probe_np(probe, keys))
    np.testing.assert_array_equal(got.numpy(), [4, 0, -1, 1, -1])


@pytest.mark.parametrize("key_space", [None, 64, (1 << 22) + 1])
def test_equi_probe_dispatch_matches_reference(key_space):
    rng = np.random.default_rng(5)
    probe = rng.integers(0, 64, size=200).astype(np.int32)
    keys = rng.permutation(64)[:40].astype(np.int32)
    got = ops.equi_probe(t32(probe), t32(keys), key_space=key_space)
    with reference_pallas():
        want = np.asarray(ref_ops.equi_probe(jnp.asarray(probe),
                                             jnp.asarray(keys),
                                             key_space=key_space))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# segment_reduce
# --------------------------------------------------------------------------


@pytest.mark.parametrize("op", ref.SEGMENT_OPS)
@pytest.mark.parametrize("name", sorted(SEGMENT_CASES))
def test_segment_reduce_plain_matches_pallas_and_numpy(name, op):
    vals, segs, groups = SEGMENT_CASES[name]
    vals = np.asarray(vals, np.float32)
    segs = np.asarray(segs, np.int32)
    got = ops.segment_reduce(torch.as_tensor(vals), t32(segs), groups, op=op)
    assert got.dtype == torch.float32 and got.shape == (groups,)
    pallas = np.asarray(ref_segment_reduce(jnp.asarray(vals), jnp.asarray(segs),
                                           groups, op=op, interpret=True))
    # integer-valued inputs: every summation order is exact
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(),
                                  ref_ref.segment_reduce_np(vals, segs, groups,
                                                            op=op))
    np.testing.assert_array_equal(ref.segment_reduce_np(vals, segs, groups,
                                                        op=op), pallas)


@pytest.mark.parametrize("groups", [1, 7, 600])
def test_segment_reduce_random_fp32_sums(groups):
    rng = np.random.default_rng(groups)
    vals = rng.uniform(-1, 1, size=5000).astype(np.float32)
    segs = rng.integers(0, groups, size=5000).astype(np.int32)
    got = ops.segment_reduce(torch.as_tensor(vals), t32(segs), groups)
    pallas = np.asarray(ref_segment_reduce(jnp.asarray(vals), jnp.asarray(segs),
                                           groups, interpret=True))
    # rtol 1e-5: fp32 sums taken in another order
    np.testing.assert_allclose(got.numpy(), pallas, rtol=FP32_RTOL, atol=1e-6)
    exact = np.zeros(groups)
    np.add.at(exact, segs, vals.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, rtol=FP32_RTOL, atol=1e-6)


def test_segment_reduce_rejects_unknown_op():
    with pytest.raises(ValueError):
        ops.segment_reduce(torch.zeros(3), torch.zeros(3, dtype=torch.int32),
                           1, op="mean")


# --------------------------------------------------------------------------
# the wrappers: dispatch, launch counts, launch shape
# --------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_without_counting():
    ops.reset_launch_counts()
    keys = t32([0, 1, 2])
    ops.join_probe(keys, ops.build_direct_table(keys, 3))
    ops.segment_reduce(torch.ones(3), keys, 3)
    x = torch.ones(1, 2, 3, 16)
    ops.attention(x, x, x)
    ops.rwkv_scan(x, x, x, -x, torch.zeros(2, 16))
    # training: the attention's backward, through autograd and directly
    xg = x.clone().requires_grad_()
    ops.attention(xg, x, x).sum().backward()
    o, lse = ref.flash_attention_ref(x, x, x, return_lse=True)
    ops.KERNELS["flash_attention_bwd"](x, x, x, o, lse, x)
    assert ops.launch_counts() == {"join_probe": 0, "build_direct_table": 0,
                                   "segment_reduce": 0, "flash_attention": 0,
                                   "flash_attention_bwd": 0, "rwkv6_scan": 0}


@pytest.mark.parametrize("call", ["join_probe", "build_direct_table",
                                  "segment_reduce", "attention", "rwkv_scan"])
def test_other_devices_raise(call):
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    x = torch.empty(1, 2, 3, 16, device="meta")
    with pytest.raises(ValueError):
        if call == "join_probe":
            ops.join_probe(meta, meta)
        elif call == "build_direct_table":
            ops.build_direct_table(meta, 4)
        elif call == "attention":
            ops.attention(x, x, x)
        elif call == "rwkv_scan":
            ops.rwkv_scan(x, x, x, x, torch.empty(2, 16, device="meta"))
        else:
            ops.segment_reduce(meta.float(), meta, 4)


@pytest.mark.parametrize("n,groups", [(1, 1), (2047, 1), (2049, 1),
                                      (2_880_404, 1), (2_880_404, 7),
                                      (5000, 600), (2_880_404, 5000),
                                      (10, 1 << 20)])
def test_segment_reduce_launch_shape_covers_every_row(n, groups):
    shape = sr.launch_shape(n, groups)
    # every row in one row block, and no row block empty
    assert (shape.blocks - 1) * shape.rows_per_block < n \
        <= shape.blocks * shape.rows_per_block
    assert 1 <= shape.blocks <= 1024
    if groups == 1:
        # one launch: whole 16-byte vectors per block, one partial per block,
        # one ticket counter
        assert shape.route == "stream"
        assert shape.rows_per_block % 4 == 0
        assert (shape.tg, shape.tiles) == (1, 1)
        assert shape.partials == shape.blocks and shape.counters == 1
    else:
        tg, tiles = shape.tg, shape.tiles
        assert shape.route == "tiled"
        assert tg & (tg - 1) == 0 and 256 % tg == 0 and tg <= 32
        assert tiles * tg >= groups > (tiles - 1) * tg
        assert shape.partials == groups * shape.blocks <= 1 << 26
        assert shape.counters == 0


def _stream_order(n):
    """The rows of ``n`` in the order the one-segment kernel folds them, per
    block and thread: thread t's vectors t, t + 256, ..., each vector's four
    rows in order, then (thread 0) the rows past the last whole vector."""
    shape = sr.launch_shape(n, 1)
    order = []
    for b in range(shape.blocks):
        r0 = b * shape.rows_per_block
        r1 = min(r0 + shape.rows_per_block, n)
        nvec = (r1 - r0) // 4
        for t in range(256):
            mine = [r0 + 4 * v + j for v in range(t, nvec, 256)
                    for j in range(4)]
            if t == 0:
                mine += list(range(r0 + 4 * nvec, r1))
            order.append(mine)
    return order


@pytest.mark.parametrize("n", [1, 3, 4, 5, 4093, 4097, 9000, 70_003])
def test_segment_reduce_stream_folds_each_row_once(n):
    rows = [r for thread in _stream_order(n) for r in thread]
    assert sorted(rows) == list(range(n))


@pytest.mark.parametrize("n,groups", [(2_880_404, 1), (2_880_404, 600),
                                      (5000, 1)])
def test_segment_reduce_launch_shape_depends_on_n_and_g_alone(n, groups):
    # two arguments, no card: the same (N, G) cut the same way anywhere
    assert list(inspect.signature(sr.launch_shape).parameters) == \
        ["n", "num_segments"]
    assert sr.launch_shape(n, groups) == sr.launch_shape(n, groups)
    assert sr.launch_shape(n + 4096, groups) != sr.launch_shape(n, groups)


def test_aligned16_decides_the_16_byte_paths():
    for dtype in (torch.float32, torch.int32):
        col = torch.zeros(64, dtype=dtype)
        assert build.aligned16(col) and build.aligned16(col, col[4:])
        assert not build.aligned16(col[1:])
        assert not build.aligned16(col, col[2:])
        assert build.aligned16(col[8:]) and not build.aligned16(col[7:])


def test_library_path_follows_source_and_flags():
    a = build.library_path("join_probe")
    b = build.library_path("segment_reduce")
    assert a != b and a.suffix == ".so" and a.parent.name == "repro_torch"
    assert build.library_path("join_probe") == a          # stable
    for flag in ("arch=compute_90a,code=sm_90a", "-shared", "-O3"):
        assert flag in build.NVCC_FLAGS


# --------------------------------------------------------------------------
# the premises of the LM kernels' designs
# --------------------------------------------------------------------------

def _bf16_exact(t: torch.Tensor) -> bool:
    return torch.equal(t, t.bfloat16().float())


@pytest.mark.parametrize("T,idx", [(6, 0), (1, 6), (5, 9)])
def test_attention_gqa_writes_bf16_values_into_the_fp32_cache(T, idx):
    """flash_attention's tensor-core body skips the lo half of an fp32 K/V
    tile when every element is a bf16 value: the serving path's cache
    (bf16 projections and RoPE written into fp32) is one."""
    from repro_torch.models import get_arch, layers
    cfg = get_arch("h2o-danube-1.8b").scaled()
    params = layers.init_attention(torch.Generator().manual_seed(T), cfg)
    B, S = 2, 16
    x = torch.as_tensor(np.random.default_rng(T).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)).bfloat16()
    pos = torch.arange(idx, idx + T, dtype=torch.int32)[None].expand(B, T)
    cache = {n: torch.zeros((B, S, cfg.n_kv_heads, cfg.hd)) for n in "kv"}
    layers.attention_gqa(params, x, cfg, pos, cache=cache, cache_index=idx)
    for n in "kv":
        written = cache[n][:, idx:idx + T]
        assert cache[n].dtype == torch.float32 and written.abs().sum() > 0
        assert _bf16_exact(cache[n])


def test_forward_fills_every_layer_cache_with_bf16_values():
    from repro_torch.models import forward, get_arch, init_params, make_caches
    cfg = get_arch("h2o-danube-1.8b").scaled()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32))
    pos = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    caches = make_caches(cfg, 2, 16, dtype=torch.float32)
    with torch.no_grad():
        forward(params, cfg, toks, pos, caches=caches, cache_index=0)
    assert caches["k"].abs().sum() > 0
    assert _bf16_exact(caches["k"]) and _bf16_exact(caches["v"])


def _chunked_scan(r, k, v, w, u, state, C):
    """The CUDA kernel's chunk-parallel scan, phase by phase, in torch:
    A (each chunk's state from zero and its decay, by suffix sums of w),
    B (the carry across chunks), C (the token recurrence inside each chunk
    from its entering state)."""
    r, k, v, w = (x.float() for x in (r, k, v, w))
    B, H, T, K = r.shape
    V = v.shape[-1]
    nC = -(-T // C) if T > C else 1
    S0 = torch.zeros((B, H, K, V)) if state is None else state.float()
    if nC == 1:
        entering = [S0]
        final = None
    else:
        L, D = [], []
        for c in range(nC):                                     # phase A
            kc, vc, wc = (x[:, :, c * C:(c + 1) * C] for x in (k, v, w))
            # E_s = sum of w after s in the chunk (<= 0): the kernel's
            # suffix sum, token by token from the chunk's end
            after = torch.empty_like(wc)
            acc = torch.zeros_like(wc[:, :, 0])
            for t in range(wc.shape[2] - 1, -1, -1):
                after[:, :, t] = acc
                acc = acc + wc[:, :, t]
            L.append(torch.einsum("bhtk,bhtv->bhkv",
                                  kc * torch.exp(after), vc))
            D.append(torch.exp(acc))
        entering, S = [], S0                                    # phase B
        for c in range(nC):
            entering.append(S)
            S = D[c][..., None] * S + L[c]
        final = S
    ys = []
    for c in range(nC):                                         # phase C
        S = entering[c]
        for t in range(c * C, min(T, (c + 1) * C) if nC > 1 else T):
            rt, kt, vt = r[:, :, t], k[:, :, t], v[:, :, t]
            bonus = (rt * u * kt).sum(-1)
            ys.append(torch.einsum("bhk,bhkv->bhv", rt, S)
                      + bonus[..., None] * vt)
            S = S * torch.exp(w[:, :, t])[..., None] \
                + kt[..., :, None] * vt[..., None, :]
        if nC == 1:
            final = S
    return torch.stack(ys, dim=2), final


@pytest.mark.parametrize("T,C,with_state,decay", [
    (200, 64, False, None), (200, 64, True, None),   # ragged tail
    (64, 64, True, None),                            # one chunk: C alone
    (1, 64, True, None),                             # decode
    (130, 64, True, -40.0),                          # -40 across a boundary
    (45, 16, False, None), (45, 16, True, -40.0),    # many short chunks
])
def test_chunk_parallel_scan_equals_the_recurrence(T, C, with_state, decay):
    from _torch_cases import rwkv_inputs
    rs = importlib.import_module("repro_torch.kernels.rwkv6_scan")
    assert rs.n_chunks(T) == (-(-T // rs.CHUNK_LEN) if T > rs.CHUNK_LEN else 1)
    r, k, v, w, u, s0 = (torch.as_tensor(a) for a in
                         rwkv_inputs(1, 3, T, 16, 16, seed=T, decay=decay))
    state = s0 if with_state else None
    y, s = _chunked_scan(r, k, v, w, u, state, C)
    y0, s_ref = ref.rwkv6_scan_ref(r, k, v, w, u, state=state)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, y0, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(s, s_ref, rtol=1e-3, atol=1e-3)
    # and the reference package's own recurrence
    y1, s1 = ref_ref.rwkv6_scan_ref(*(jnp.asarray(a.numpy()) for a in
                                      (r, k, v, w, u)),
                                    state=None if state is None
                                    else jnp.asarray(state.numpy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(y1), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(s1), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype,Tq,keys,rows", [
    (torch.bfloat16, 4500, 64, 128),    # prefill: 8-warp blocks
    (torch.bfloat16, 1, 64, 64),        # decode: 4-warp blocks
    (torch.bfloat16, 63, 64, 64),
    (torch.float32, 4500, 32, 64),      # fp32 q stays on the CUDA cores
])
def test_flash_attention_picks_its_tiles_by_type_and_shape(dtype, Tq, keys,
                                                           rows):
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    assert fa._KEYS[dtype] == keys
    assert fa._rows(dtype, Tq) == rows


@pytest.mark.parametrize("shape,dtype,view,want", [
    ((2, 10, 4, 64), torch.bfloat16, True, True),    # (B,T,H,K) seen as (B,H,T,K)
    ((2, 10, 4, 64), torch.float32, True, True),
    ((2, 3, 4, 6), torch.float32, False, False),     # rows of 24 bytes
    ((2, 3, 5, 12), torch.bfloat16, False, False),   # strides off 16 bytes
])
def test_rows16_decides_the_16_byte_copies(shape, dtype, view, want):
    t = torch.zeros(shape, dtype=dtype)
    assert build.rows16(t.transpose(1, 2) if view else t) is want
    if want:   # a unit-stride row is needed too
        assert build.rows16(t.transpose(2, 3)) is False


@pytest.mark.parametrize("T,chunks", [(1, 1), (64, 1), (65, 2), (200, 4),
                                      (4500, 71)])
def test_rwkv6_scan_chunk_count(T, chunks):
    rs = importlib.import_module("repro_torch.kernels.rwkv6_scan")
    assert rs.n_chunks(T) == chunks
