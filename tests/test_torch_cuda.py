"""The port's CUDA kernels on the card, against their plain torch versions.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips where ``torch.cuda.is_available()`` is false (decided when the test
runs). The module imports neither jax nor the reference package, so it
runs where only torch is installed::

    python3 -m pytest -q -m cuda tests/test_torch_cuda.py

  * ``join_probe`` / ``build_direct_table``: exactly (``atol=0``);
  * ``segment_reduce``: exactly on integer-valued inputs, ``rtol=1e-5`` on
    random fp32 sums (the kernel sums in float32 in a fixed blocked order,
    the plain version in float64 rounded once);
  * both at the compiled tier's sizes too, TPC-DS SF1 (2,880,404 orders
    over 100,000 customers; 1 to 5,000 groups);
  * their edges: N = 4k + 1, 2, 3 and bases off 16 bytes (``t[1:]``, the
    scalar route over the same rows in the same order, so the same bits),
    fp32 sums bit-identical call after call (the ticket counter is left at
    zero), both kernels on two streams in turn, and duplicate build keys
    under the one-launch builder;
  * the compiled tier on a card-resident database: the kernels launch, and
    the outputs and clock equal those of the same database on the CPU;
  * ``flash_attention``: the reference's attention sweep plus the serving
    shapes (hd 80, decode over a ragged cache, mixed bf16 q / fp32 cache,
    strided views), within 2e-5 for fp32 outputs and, for bf16 outputs,
    one bf16 rounding (rtol 1.6e-2, atol 1e-4): both sides accumulate in
    fp32;
  * the regimes of the tensor-core attention body: bf16 q over an fp32
    cache that holds bf16 values (its lo products skipped) and over a
    random fp32 cache (taken), Tq and Tk off the 16 / 64 tile sizes, hd
    16 / 32 / 64 / 80, the chunk mask and decode, and the branches off the
    serving shapes: hd 45 and 96 and K/V rows off 16 bytes;
  * the wide heads, hd 128 (internlm2-20b, qwen2-vl-72b) and 160
    (stablelm-12b), and the head dims padded up to them (112, 144), in
    both bodies, at prefill (two K/V stages, and the one-stage 8-warp
    blocks at hd 160 over fp32), at split-key decode, over strided cache
    views and rows off 16 bytes; at the serving shapes of each family
    (a 4,500-token prefill, decode over a ragged 4,531-slot cache, bf16
    and fp32 q over the fp32 cache); and MLA's v head narrower than its q.k
    head (hd 96, hdv 64; v a strided slice of the expanded latent), other
    narrower v widths (hd 88 and 96 on the tensor cores, 128 and 160 on
    the CUDA cores), and the refusal of a narrower v at another
    tensor-core depth;
  * the warp-specialised wgmma body of the long bf16 calls, at the
    present tolerances: hd 80 with GQA 4:1 over a bf16-exact fp32 cache
    with the 4,096 window (lo skipped) and over a random one, hd 96 / hdv
    64 with H = KV over random fp32 (every lo product taken) and v a
    strided slice, bf16 k/v with the rows' log-sum-exps, Tq off 64 and 128,
    Tq < Tk, the chunk mask and split keys; and each call counted under
    the body that ran (prefill ``wgmma``, decode ``mma``);
  * ``rwkv6_scan``: the reference's scan sweep, from zero and from a given
    state, ragged T, one-token decode, extreme decay, within 1e-3 fp32 and
    3e-2 bf16; and the chunk-parallel scan over several chunks with a
    ragged tail, over rows off 16 bytes, and the -40 decay across a chunk
    boundary;
  * ``flash_attention`` with no causal mask and bf16 q (seamless-m4t's
    encoder and cross attention), at a ragged Tq < Tk, Tq > Tk and decode
    over 4,608 keys;
  * ``flash_attention``'s backward (``flash_attention_bwd``) against its
    plain version on the same inputs, over every mask the forward serves,
    GQA and H = KV, hd 16..160, MLA's hdv < hd, ragged tiles, both types,
    and rows off 16 bytes: dq, dk, dv within two bf16 roundings of their
    peak (1e-4 of it in fp32), a second call bit-identical, the body
    ``bwd_body`` picks launched; the wgmma body's edges (hd 80 over ragged
    tiles, GQA groups of 1, 4 and 8, a chunk across tiles, causal Tq != Tk
    both ways, T 4,096) and its per-body launch counts; the training
    attention of every family the card trains at its published heads
    over 2,048 tokens, with 77-token tails; the forward's
    row log-sum-exps (single pass, split-key combine, CUDA-core body);
    training's backward through the wrappers: attention's and the scan's
    gradients from their kernels (one launch each way, a second backward
    bit-identical);
  * ``rwkv6_scan_bwd`` against ``rwkv6_scan_bwd_ref`` on the same inputs,
    over every case of ``SCAN_BWD_CASES`` (rwkv6-3b's 40 heads at
    training's T among them, the model's range of decays) and of a grid of
    decays drawn past the model's floor: training's T (2,048, 32 chunks),
    a ragged tail, one chunk, one token, a given state with a final-state
    cotangent, the decay floor -e**2 within and across a chunk boundary,
    fp32, rows off 16 bytes, K 16 / 32 with V 32 / 96: dr, dk, dv within
    two bf16 roundings of their peak (1e-4 of it in fp32), dw, du, dstate
    within 1e-4, the gradients' types and layout, a second call
    bit-identical, each on the body it names;
  * a scaled ``Server.generate`` on the card against the same server on
    the CPU (fp32 parameters: the same tokens, logits within 1e-3), for
    danube, rwkv6, qwen2-vl (M-RoPE) and minicpm3 (MLA); for
    internlm2-20b and stablelm-12b at 2 layers with their published head
    dims 128 and 160; and for zamba2 (Mamba2 + the shared block),
    seamless-m4t (decoder over its cross cache), llama4-scout and kimi-k2
    (MoE) at 2 layers with their published head dims 64 and 128; with bf16
    parameters (the tensor-core body) internlm2 and stablelm, and seamless
    with its encoder, are held to the same model with the plain attention
    on the card;
  * the serving loop on the card: the drift flip (join -> prefetch) with
    the compiled tier on, equal to the same stream on the CPU, and the
    programs as written launching the relational kernels inside it;
  * a 4-shard ``ClusterRuntime`` over card tables, bit-identical to one
    ``ServingRuntime`` over the unsharded tables, ``segment_reduce``
    launched inside its workers; every shard table, merged view and merged
    result on the card.
"""

import importlib

import numpy as np
import pytest
import torch

from _torch_cases import (ATTN_BWD_CASES, ATTN_EXTRA, ATTN_KERNEL_TOL,
                          ATTN_SWEEP, BWD_TOL, PROBE_CASES, RWKV_STATE_TOL,
                          RWKV_SWEEP, RWKV_TOL, SCAN_BWD_CASES, SEGMENT_CASES,
                          TORCH_DTYPES, attention_inputs, rwkv_inputs,
                          scan_bwd_inputs, t32)
from repro_torch.api import CobraSession, OptimizerConfig, RuleSet
from repro_torch.cluster import ClusterRuntime, ShardedDatabase
from repro_torch.core import CostCatalog
from repro_torch.kernels import build, ops, ref
from repro_torch.launch import serve
from repro_torch.models import forward, get_arch, init_params, make_caches
from repro_torch.programs import (make_orders_customer_db, make_p0,
                                  make_wilos_b, make_wilos_db, make_wilos_e,
                                  make_wilos_f)
from repro_torch.relational import SLOW_REMOTE
from repro_torch.relational import algebra as A
from repro_torch.runtime import ServingRuntime

# the modules (the package re-exports their functions under the same names)
rs = importlib.import_module("repro_torch.kernels.rwkv6_scan")
fa = importlib.import_module("repro_torch.kernels.flash_attention")

pytestmark = pytest.mark.cuda

# TPC-DS SF1: store_sales rows (the orders; the Wilos tasks at the same
# count) and customer rows, the compiled tier's sizes on the card
N_ORDERS, N_CUSTOMERS = 2_880_404, 100_000


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _sf1_probe_case():
    """P0's navigation probe at SF1: every order's customer key over the
    customers' keys, permuted."""
    rng = np.random.default_rng(11)
    return (rng.integers(0, N_CUSTOMERS, size=N_ORDERS),
            rng.permutation(N_CUSTOMERS), N_CUSTOMERS)


@pytest.mark.parametrize("case", [
    pytest.param(lambda name=name: PROBE_CASES[name], id=name)
    for name in sorted(PROBE_CASES)]
    + [pytest.param(_sf1_probe_case, id="sf1_orders_customer")])
def test_join_probe_matches_plain(cuda, case):
    probe, keys, key_space = case()
    probe, keys = t32(probe), t32(keys)
    slots = ops.build_direct_table(keys.to(cuda), key_space)
    got = ops.join_probe(probe.to(cuda), slots)
    torch.cuda.synchronize()
    plain_slots = ref.build_direct_table_ref(keys, key_space)
    assert torch.equal(slots.cpu(), plain_slots)
    assert torch.equal(got.cpu(), ref.slot_gather_ref(probe, plain_slots))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ref.join_probe_np(probe.numpy(), keys.numpy()))


def test_duplicate_build_keys_keep_the_first_row(cuda):
    keys = t32([2, 4, 2, 4, 1])
    slots = ops.build_direct_table(keys.to(cuda), 8)
    got = ops.join_probe(t32([1, 2, 3, 4, 0]).to(cuda), slots)
    assert torch.equal(slots.cpu(), ref.build_direct_table_ref(keys, 8))
    assert got.cpu().tolist() == [4, 0, -1, 1, -1]


@pytest.mark.parametrize("op", ref.SEGMENT_OPS)
@pytest.mark.parametrize("name", sorted(SEGMENT_CASES))
def test_segment_reduce_matches_plain(cuda, name, op):
    vals, segs, groups = SEGMENT_CASES[name]
    vals = torch.as_tensor(np.asarray(vals, np.float32))
    segs = t32(segs)
    got = ops.segment_reduce(vals.to(cuda), segs.to(cuda), groups, op=op)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref.segment_reduce_ref(vals, segs, groups,
                                                         op=op))


@pytest.mark.parametrize("n,groups", [
    (300_000, 1), (300_000, 7), (300_000, 600), (300_000, 5000),
    # no rows, no groups, and the compiled tier's fold at SF1
    (0, 4), (1000, 0), (5000, 1), (5000, 7), (100_000, 600),
    (N_ORDERS, 1), (N_ORDERS, 7), (N_ORDERS, 600), (N_ORDERS, 5000)])
def test_segment_reduce_random_fp32_sums(cuda, n, groups):
    rng = np.random.default_rng(groups)
    vals = torch.as_tensor(rng.uniform(-1, 1, n).astype(np.float32))
    segs = rng.integers(0, max(groups, 1), n)
    if groups > 2:
        segs[segs == 1] = 2                      # segment 1 stays empty
    segs = t32(segs)
    got = ops.segment_reduce(vals.to(cuda), segs.to(cuda), groups)
    again = ops.segment_reduce(vals.to(cuda), segs.to(cuda), groups)
    torch.cuda.synchronize()
    assert torch.equal(got, again)               # no run-to-run variation
    torch.testing.assert_close(got.cpu(),
                               ref.segment_reduce_ref(vals, segs, groups),
                               rtol=1e-5, atol=1e-5)
    # positive sums: relative to the float64 sum alone
    vals = torch.as_tensor(rng.uniform(0, 1, n).astype(np.float32))
    got = ops.segment_reduce(vals.to(cuda), segs.to(cuda), groups)
    torch.testing.assert_close(got.cpu(),
                               ref.segment_reduce_ref(vals, segs, groups),
                               rtol=1e-5, atol=0)
    ints = torch.as_tensor(rng.integers(-50, 50, n).astype(np.float32))
    for op in ref.SEGMENT_OPS:
        got = ops.segment_reduce(ints.to(cuda), segs.to(cuda), groups, op=op)
        assert torch.equal(got.cpu(), ref.segment_reduce_ref(
            ints, segs, groups, op=op)), op


def test_launches_are_counted_on_the_card_only(cuda):
    ops.reset_launch_counts()
    keys = t32([0, 1, 2])
    ops.join_probe(keys, ops.build_direct_table(keys, 3))   # CPU: plain
    assert sum(ops.launch_counts().values()) == 0
    dkeys = keys.to(cuda)
    ops.join_probe(dkeys, ops.build_direct_table(dkeys, 3))
    ops.segment_reduce(torch.ones(3, device=cuda), dkeys, 3)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"join_probe": 1, "build_direct_table": 1,
                                   "segment_reduce": 1, "flash_attention": 0,
                                   "flash_attention_bwd": 0, "rwkv6_scan": 0,
                                   "rwkv6_scan_bwd": 0, "adamw": 0}


def _view(a, offset, cuda):
    """``a`` on the card, ``offset`` elements into its buffer (a view whose
    base is off 16 bytes when ``offset`` is 1)."""
    a = np.asarray(a)
    buf = torch.as_tensor(np.concatenate([np.zeros(offset, a.dtype), a]),
                          device=cuda)
    return buf[offset:]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,m", [
    (100_001, 5000), (100_002, 5000), (100_003, 5000), (2, 5000), (7, 5000),
    (N_ORDERS + 1, N_CUSTOMERS), (N_ORDERS + 2, N_CUSTOMERS),
    (N_ORDERS + 3, N_CUSTOMERS)])
def test_join_probe_over_views_and_ragged_lengths(cuda, n, m, offset):
    rng = np.random.default_rng(n + offset)
    probe = rng.integers(-5, m + 5, size=n).astype(np.int32)
    keys = rng.permutation(m).astype(np.int32)
    dkeys = _view(keys, offset, cuda)
    slots = ops.build_direct_table(dkeys, m)
    got = ops.join_probe(_view(probe, offset, cuda), slots)
    assert build.aligned16(dkeys) == (offset == 0)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ref.join_probe_np(probe, keys))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("groups", [1, 7])
@pytest.mark.parametrize("n", [300_001, 300_002, 300_003, 3, N_ORDERS + 1,
                               N_ORDERS + 2, N_ORDERS + 3])
def test_segment_reduce_over_views_and_ragged_lengths(cuda, n, groups, offset):
    rng = np.random.default_rng(n + groups)
    ints = rng.integers(-50, 50, size=n).astype(np.float32)
    segs = rng.integers(-1, groups + 1, size=n).astype(np.int32)  # some out
    floats = rng.uniform(0, 1, size=n).astype(np.float32)
    dsegs = _view(segs, offset, cuda)
    for op in ref.SEGMENT_OPS:
        got = ops.segment_reduce(_view(ints, offset, cuda), dsegs, groups, op=op)
        want = ref.segment_reduce_ref(torch.as_tensor(ints), t32(segs), groups,
                                      op=op)
        assert torch.equal(got.cpu(), want), op
    got = ops.segment_reduce(_view(floats, offset, cuda), dsegs, groups)
    # the same bits back to back, and from the same rows in the same order
    # on the 16-byte and the scalar path
    assert torch.equal(got, ops.segment_reduce(_view(floats, offset, cuda),
                                               dsegs, groups))
    assert torch.equal(got, ops.segment_reduce(_view(floats, 1 - offset, cuda),
                                               _view(segs, 1 - offset, cuda),
                                               groups))
    torch.testing.assert_close(got.cpu(), ref.segment_reduce_ref(
        torch.as_tensor(floats), t32(segs), groups), rtol=1e-5, atol=0)


def test_segment_reduce_sums_are_bit_identical_call_after_call(cuda):
    rng = np.random.default_rng(5)
    vals = torch.as_tensor(rng.uniform(-1, 1, 2_880_404).astype(np.float32),
                           device=cuda)
    segs = torch.zeros(vals.shape[0], dtype=torch.int32, device=cuda)
    runs = [ops.segment_reduce(vals, segs, 1) for _ in range(3)]
    torch.cuda.synchronize()
    # each launch found the counter at zero and left it there
    assert all(torch.equal(r, runs[0]) for r in runs)
    assert int(build.stream_counter(vals.device)[0]) == 0


@pytest.mark.parametrize("n", [500_000, N_ORDERS])
def test_kernels_on_two_streams_in_turn(cuda, n):
    rng = np.random.default_rng(6)
    vals = torch.as_tensor(rng.uniform(-1, 1, n).astype(np.float32),
                           device=cuda)
    segs = torch.zeros(vals.shape[0], dtype=torch.int32, device=cuda)
    keys = torch.as_tensor(rng.permutation(50_000).astype(np.int32), device=cuda)
    probe = torch.as_tensor(rng.integers(0, 50_000, 500_000).astype(np.int32),
                            device=cuda)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    sums, hits = [], []
    for i in range(6):
        with torch.cuda.stream(streams[i % 2]):
            sums.append(ops.segment_reduce(vals, segs, 1))
            hits.append(ops.join_probe(probe, ops.build_direct_table(keys, 50_000)))
    torch.cuda.synchronize()
    assert all(torch.equal(s, sums[0]) for s in sums)
    assert all(torch.equal(h, hits[0]) for h in hits)
    np.testing.assert_array_equal(hits[0].cpu().numpy(), ref.join_probe_np(
        probe.cpu().numpy(), keys.cpu().numpy()))
    for s in streams:   # tickets and barrier arrivals back at zero
        with torch.cuda.stream(s):
            tickets, barrier = build.stream_counter(vals.device).tolist()
            assert tickets == 0 and barrier & 0xFFFF == 0


def test_duplicate_build_keys_keep_the_first_row_at_scale(cuda):
    rng = np.random.default_rng(7)
    keys = rng.integers(-10, 60_000, size=300_000).astype(np.int32)  # 5 per key
    got = ops.build_direct_table(torch.as_tensor(keys, device=cuda), 50_000)
    want = ref.build_direct_table_ref(t32(keys), 50_000)
    assert torch.equal(got.cpu(), want)
    probe = np.arange(-3, 50_003, dtype=np.int32)
    hits = ops.join_probe(torch.as_tensor(probe, device=cuda), got).cpu()
    assert torch.equal(hits, ref.slot_gather_ref(t32(probe), want))
    inside = slice(3, 50_003)   # keys in [0, 50,000): the first stable match
    np.testing.assert_array_equal(hits.numpy()[inside], ref.join_probe_np(
        probe[inside], np.where(keys < 50_000, keys, -1)))


def test_mixed_devices_raise(cuda):
    with pytest.raises(ValueError):
        ops.join_probe(t32([0, 1]).to(cuda), t32([0, 1]))
    with pytest.raises(ValueError):
        ops.segment_reduce(torch.ones(2, device=cuda), t32([0, 1]), 2)


@pytest.mark.parametrize("name", ["P0", "W_B", "W_F"])
def test_compiled_tier_on_the_card_equals_the_cpu(cuda, name):
    make, mkdb, kernel = {
        "P0": (make_p0, lambda d: make_orders_customer_db(3000, 300, device=d),
               "join_probe"),
        "W_B": (make_wilos_b, lambda d: make_wilos_db(3000, device=d),
                "segment_reduce"),
        "W_F": (make_wilos_f, lambda d: make_wilos_db(3000, device=d),
                "segment_reduce"),
    }[name]
    results = {}
    for dev in ("cpu", "cuda"):
        db = mkdb(dev)
        exe = CobraSession(db, CostCatalog(SLOW_REMOTE),
                           config=OptimizerConfig(rule_set=RuleSet([]))
                           ).compile(make())
        ops.reset_launch_counts()
        results[dev] = exe.run_batch([{}] * 2, tier="compiled")
        torch.cuda.synchronize()
        launched = ops.launch_counts()[kernel]
        assert (launched > 0) == (dev == "cuda")
    cpu, card = results["cpu"], results["cuda"]
    assert card.simulated_s == cpu.simulated_s
    assert [r.outputs for r in card.results] == [r.outputs for r in cpu.results]


# --------------------------------------------------------------------------
# the LM kernels
# --------------------------------------------------------------------------

def _on(a, dev, dtype="float32", offset=False):
    """``a`` on ``dev``; with ``offset``, as a view one element into its
    buffer, so its rows are off 16 bytes."""
    t = torch.as_tensor(a).to(device=dev, dtype=TORCH_DTYPES[dtype])
    if not offset:
        return t
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert not build.rows16(view)
    return view


def _attention_case(cuda, B, H, KV, Tq, Tk, hd, q_dt, kv_dt, causal, window,
                    chunk, seed=0, bf16_cache=False, offset=False):
    q, k, v = attention_inputs(B, H, KV, Tq, Tk, hd, seed=seed)
    if bf16_cache:   # what the serving path writes: bf16 values in fp32
        k, v = (torch.as_tensor(x).bfloat16().float() for x in (k, v))
    q = _on(q, cuda, q_dt)
    k, v = _on(k, cuda, kv_dt, offset), _on(v, cuda, kv_dt, offset)
    got = ops.attention(q, k, v, causal=causal, window=window, chunk=chunk)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   chunk=chunk)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == (B, H, Tq, hd)
    torch.testing.assert_close(got.float(), want.float(),
                               **ATTN_KERNEL_TOL[q_dt])


@pytest.mark.parametrize("B,H,KV,Tq,Tk,hd,dt,causal,window,chunk",
                         ATTN_SWEEP + ATTN_EXTRA)
def test_flash_attention_matches_plain(cuda, B, H, KV, Tq, Tk, hd, dt, causal,
                                       window, chunk):
    _attention_case(cuda, B, H, KV, Tq, Tk, hd, dt, dt, causal, window, chunk)


@pytest.mark.parametrize("Tq,Tk", [(1, 4500), (40, 40), (1, 33)])
def test_flash_attention_serving_types_and_splits(cuda, Tq, Tk):
    # bf16 queries over an fp32 cache, hd 80, GQA 4:1, window 4096: the
    # h2o-danube shapes; Tq = 1 takes the split-key path
    _attention_case(cuda, 2, 8, 2, Tq, Tk, 80, "bfloat16", "float32", True,
                    4096, None, seed=Tk)


# (B, H, KV, Tq, Tk, hd, kv dtype, bf16-exact cache, K/V rows off 16
# bytes, window, chunk): bf16 q, the tensor-core body
ATTN_TENSOR_CORE = [
    (1, 8, 2, 1100, 1100, 80, "float32", True, False, 1024, None),
    (1, 8, 2, 1100, 1100, 80, "float32", False, False, 1024, None),
    (2, 8, 2, 77, 200, 16, "float32", False, False, None, None),
    (1, 4, 1, 130, 130, 32, "float32", True, False, 100, None),
    (1, 4, 2, 200, 333, 64, "float32", False, False, None, None),
    (1, 8, 2, 300, 300, 80, "bfloat16", False, False, None, None),
    (1, 4, 2, 250, 250, 80, "float32", False, False, None, 64),
    (1, 4, 2, 150, 150, 64, "bfloat16", False, False, None, 48),
    # hd 45 (three 16-deep slices, an odd tail, element copies) and 96
    # (six slices), at prefill and decode
    (1, 8, 2, 200, 333, 45, "float32", False, False, None, None),
    (2, 4, 1, 1, 600, 45, "bfloat16", False, False, None, 256),
    (1, 8, 2, 300, 300, 96, "float32", False, False, 256, None),
    (2, 8, 2, 1, 900, 96, "float32", True, False, None, None),
    # K/V one element into their buffers: element copies, in 8-warp blocks
    # (two stages) and 4-warp ones
    (1, 8, 2, 300, 300, 80, "float32", False, True, 128, None),
    (1, 8, 2, 300, 300, 80, "float32", True, True, None, 64),
    (2, 8, 2, 1, 700, 64, "bfloat16", False, True, None, None),
    # danube's heads (H 32 / KV 8, hd 80) over its fp32 cache with and
    # without bf16 values, and over bf16 K/V
    (1, 32, 8, 300, 300, 80, "float32", False, False, 128, None),
    (1, 32, 8, 300, 300, 80, "bfloat16", False, False, None, None),
    (1, 32, 8, 1100, 1100, 80, "float32", True, False, 1024, None),
    (1, 32, 8, 1100, 1100, 80, "float32", False, False, 1024, None),
    # zamba2's shared block (H = KV = 32, hd 64) and llama4-scout (H 40 /
    # KV 8, hd 128, chunk 8,192: inactive below 8,192 keys) at their serving
    # prefill (4,500 tokens) and decode (over a ragged 4,531-slot cache)
    (1, 32, 32, 4500, 4500, 64, "float32", False, False, None, None),
    (4, 32, 32, 1, 4531, 64, "float32", False, False, None, None),
    (1, 40, 8, 4500, 4500, 128, "float32", False, False, None, 8192),
    (4, 40, 8, 1, 4531, 128, "float32", False, False, None, 8192),
]


@pytest.mark.parametrize("B,H,KV,Tq,Tk,hd,kv_dt,exact,offset,window,chunk",
                         ATTN_TENSOR_CORE)
def test_flash_attention_tensor_core_regimes(cuda, B, H, KV, Tq, Tk, hd, kv_dt,
                                             exact, offset, window, chunk):
    _attention_case(cuda, B, H, KV, Tq, Tk, hd, "bfloat16", kv_dt, True,
                    window, chunk, seed=Tq + hd, bf16_cache=exact,
                    offset=offset)


@pytest.mark.parametrize("exact", [True, False])
def test_flash_attention_at_decode(cuda, exact):
    # Tq 1 over a ragged cache past the window: the split-key path
    _attention_case(cuda, 4, 32, 8, 1, 4531, 80, "bfloat16", "float32", True,
                    4096, None, seed=1, bf16_cache=exact)


# (B, H, KV, Tq, Tk, hd, kv dtype, bf16-exact cache, K/V rows off 16
# bytes): bf16 q with no causal mask, the tensor-core body. seamless-m4t's
# encoder (H = KV = 16, hd 64, bf16 K/V) and cross attention over its fp32
# cross cache, at a ragged Tq < Tk and at decode (Tq 1 over 4,608 keys: the
# split-key path with no causal bound); Tq > Tk, GQA, hd 128, and K/V rows
# off 16 bytes
ATTN_NON_CAUSAL = [
    (2, 16, 16, 600, 600, 64, "bfloat16", False, False),
    (2, 16, 16, 500, 608, 64, "float32", True, False),
    (2, 16, 16, 1, 4608, 64, "float32", True, False),
    (2, 16, 16, 1, 4608, 64, "float32", False, False),
    (1, 4, 4, 77, 300, 64, "float32", False, False),
    (1, 4, 2, 300, 77, 64, "float32", False, False),
    (1, 8, 2, 200, 333, 128, "float32", False, False),
    (1, 8, 8, 130, 130, 64, "float32", True, True),
    # seamless-m4t at its serving size: the encoder over 4 x 4,608 frames,
    # the cross attention at prefill (Tq 4,500 < Tk 4,608) and at decode
    # over the fp32 cross cache, holding bf16 values or not
    (4, 16, 16, 4608, 4608, 64, "bfloat16", False, False),
    (4, 16, 16, 4500, 4608, 64, "float32", True, False),
    (4, 16, 16, 1, 4608, 64, "float32", True, False),
    (4, 16, 16, 1, 4608, 64, "float32", False, False),
]


@pytest.mark.parametrize("B,H,KV,Tq,Tk,hd,kv_dt,exact,offset",
                         ATTN_NON_CAUSAL)
def test_flash_attention_non_causal(cuda, B, H, KV, Tq, Tk, hd, kv_dt, exact,
                                    offset):
    _attention_case(cuda, B, H, KV, Tq, Tk, hd, "bfloat16", kv_dt, False,
                    None, None, seed=Tq + Tk, bf16_cache=exact, offset=offset)


# (B, H, KV, Tq, Tk, hd, q dtype, kv dtype, bf16-exact cache, K/V rows off
# 16 bytes, window): the wide heads. fp32 q takes the CUDA-core body (HC 4
# and 5), bf16 q the tensor cores (KS 8 and 10; hd 112 and 144 padded up)
ATTN_WIDE = [
    (1, 8, 2, 130, 130, 128, "float32", "float32", False, False, None),
    (2, 8, 2, 1, 700, 128, "float32", "float32", False, False, 512),
    (1, 8, 2, 300, 300, 128, "bfloat16", "float32", False, False, 256),
    (1, 8, 2, 300, 300, 128, "bfloat16", "float32", True, False, None),
    (1, 8, 2, 200, 333, 128, "bfloat16", "bfloat16", False, False, None),
    (2, 16, 2, 1, 1500, 128, "bfloat16", "float32", True, False, 1024),
    (1, 8, 2, 200, 200, 128, "bfloat16", "float32", False, True, None),
    (1, 4, 2, 100, 100, 160, "float32", "float32", False, False, None),
    (1, 8, 2, 300, 300, 160, "bfloat16", "float32", False, False, None),
    (1, 8, 2, 300, 300, 160, "bfloat16", "float32", True, False, 128),
    (1, 8, 2, 150, 150, 160, "bfloat16", "bfloat16", False, False, None),
    (2, 8, 2, 1, 1500, 160, "bfloat16", "float32", False, False, None),
    (1, 8, 2, 200, 200, 160, "bfloat16", "bfloat16", False, True, None),
    (1, 4, 2, 100, 100, 112, "bfloat16", "float32", False, False, None),
    (1, 4, 2, 1, 200, 144, "bfloat16", "float32", False, False, None),
    (1, 4, 2, 70, 70, 144, "float32", "float32", False, False, 32),
    # at their models' serving shapes: a 4,500-token prefill and decode over
    # a ragged 4,531-slot random fp32 cache, bf16 q (the tensor cores, lo
    # products taken) and fp32 q (the CUDA cores). hd 128: internlm2-20b
    # (H 48, KV 8) and qwen2-vl-72b (H 64, KV 8); hd 160: stablelm-12b (H
    # 32, KV 8), the one-stage 8-warp blocks over fp32
    (1, 48, 8, 4500, 4500, 128, "bfloat16", "float32", False, False, None),
    (1, 48, 8, 4500, 4500, 128, "float32", "float32", False, False, None),
    (4, 48, 8, 1, 4531, 128, "bfloat16", "float32", False, False, None),
    (4, 48, 8, 1, 4531, 128, "float32", "float32", False, False, None),
    (1, 64, 8, 4500, 4500, 128, "bfloat16", "float32", False, False, None),
    (1, 64, 8, 4500, 4500, 128, "float32", "float32", False, False, None),
    (4, 64, 8, 1, 4531, 128, "bfloat16", "float32", False, False, None),
    (4, 64, 8, 1, 4531, 128, "float32", "float32", False, False, None),
    (1, 32, 8, 4500, 4500, 160, "bfloat16", "float32", False, False, None),
    (1, 32, 8, 4500, 4500, 160, "float32", "float32", False, False, None),
    (4, 32, 8, 1, 4531, 160, "bfloat16", "float32", False, False, None),
    (4, 32, 8, 1, 4531, 160, "float32", "float32", False, False, None),
]


@pytest.mark.parametrize("B,H,KV,Tq,Tk,hd,q_dt,kv_dt,exact,offset,window",
                         ATTN_WIDE)
def test_flash_attention_wide_heads(cuda, B, H, KV, Tq, Tk, hd, q_dt, kv_dt,
                                    exact, offset, window):
    _attention_case(cuda, B, H, KV, Tq, Tk, hd, q_dt, kv_dt, True, window,
                    None, seed=Tq + hd, bf16_cache=exact, offset=offset)


@pytest.mark.parametrize("hd,q_dt", [(128, "bfloat16"), (160, "bfloat16"),
                                     (160, "float32")])
def test_flash_attention_wide_heads_over_cache_views(cuda, hd, q_dt):
    # the serving layout: q the (B,T,H,hd) projection, k/v slices of the
    # (2, B, S, KV, hd) fp32 cache, all seen as (B,H,T,hd) without a copy
    B, T, H, KV, S, used = 2, 7, 8, 2, 40, 30
    rng = np.random.default_rng(hd)
    q = _on(rng.standard_normal((B, T, H, hd)), cuda, q_dt)
    cache = _on(rng.standard_normal((2, B, S, KV, hd)), cuda)
    k = cache[0, :, :used].transpose(1, 2)
    v = cache[1, :, :used].transpose(1, 2)
    got = ops.attention(q.transpose(1, 2), k, v, window=16)
    want = ref.flash_attention_ref(q.transpose(1, 2).contiguous(),
                                   k.contiguous(), v.contiguous(), window=16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **ATTN_KERNEL_TOL[q_dt])
    assert got.transpose(1, 2).is_contiguous()


def _mla_inputs(cuda, B, H, Tq, Tk, q_dt, kv_dt, nope=64, rdim=32, vhd=64,
                seed=0):
    """MLA's attention inputs as ``attention_mla`` makes them: q
    (B,H,Tq,nope+rdim); the expanded latent kv (B,Tk,H,nope+vhd), k its
    nope part with the shared rope key appended (B,H,Tk,nope+rdim), v a
    strided slice of it (B,H,Tk,vhd)."""
    rng = np.random.default_rng(seed)
    q = _on(rng.standard_normal((B, Tq, H, nope + rdim)), cuda, q_dt)
    kv = _on(rng.standard_normal((B, Tk, H, nope + vhd)), cuda, kv_dt)
    rope = _on(rng.standard_normal((B, Tk, 1, rdim)), cuda, kv_dt)
    k = torch.cat([kv[..., :nope], rope.expand(B, Tk, H, rdim)], dim=-1)
    v = kv[..., nope:]
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


@pytest.mark.parametrize("B,H,Tq,Tk,q_dt,kv_dt", [
    (1, 8, 300, 300, "bfloat16", "float32"),    # prefill over the cache
    (1, 8, 200, 200, "bfloat16", "bfloat16"),   # prefill without a cache
    (2, 40, 1, 900, "bfloat16", "float32"),     # decode: split keys
    (1, 4, 100, 100, "float32", "float32"),     # the CUDA-core body
    (2, 4, 1, 333, "float32", "float32"),
    # minicpm3-4b's serving shapes (H = KV = 40): a 4,500-token prefill
    # and decode over a ragged 4,531-slot cache, both bodies
    (1, 40, 4500, 4500, "bfloat16", "float32"),
    (4, 40, 1, 4531, "bfloat16", "float32"),
    (1, 40, 4500, 4500, "float32", "float32"),
    (4, 40, 1, 4531, "float32", "float32"),
])
def test_flash_attention_mla_head_dims(cuda, B, H, Tq, Tk, q_dt, kv_dt):
    q, k, v = _mla_inputs(cuda, B, H, Tq, Tk, q_dt, kv_dt, seed=Tk)
    assert (k.shape[-1], v.shape[-1]) == (96, 64) and not v.is_contiguous()
    scale = 1.0 / np.sqrt(96)
    got = ops.attention(q, k, v, causal=True, scale=scale)
    want = ref.flash_attention_ref(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    assert got.shape == (B, H, Tq, 64) and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(),
                               **ATTN_KERNEL_TOL[q_dt])


@pytest.mark.parametrize("hd,hdv,q_dt", [
    (88, 40, "bfloat16"),    # the narrow-v variant at another width of KS 6
    (96, 96 - 16, "bfloat16"),
    (128, 64, "float32"),    # the CUDA-core body takes any hdv <= hd
    (160, 24, "float32"),
])
def test_flash_attention_narrow_v_widths(cuda, hd, hdv, q_dt):
    rng = np.random.default_rng(hd + hdv)
    B, H, KV, Tq, Tk = 2, 8, 2, 70, 90
    q = _on(rng.standard_normal((B, H, Tq, hd)), cuda, q_dt)
    k = _on(rng.standard_normal((B, KV, Tk, hd)), cuda)
    v = _on(rng.standard_normal((B, KV, Tk, hdv)), cuda)
    got = ops.attention(q, k, v, window=50)
    want = ref.flash_attention_ref(q, k, v, window=50)
    torch.cuda.synchronize()
    assert got.shape == (B, H, Tq, hdv)
    torch.testing.assert_close(got.float(), want.float(),
                               **ATTN_KERNEL_TOL[q_dt])


def _body_launched(before):
    """The bodies whose launch counts moved since ``before``, with the
    moves."""
    return {b: n - before[b] for b, n in
            fa.flash_attention.launches_by_body.items() if n != before[b]}


# (B, H, KV, Tq, Tk, hd, kv dtype, bf16-exact cache, window, chunk): bf16 q
# on the wgmma body, GQA at danube's hd 80. The serving prefill over a
# bf16-exact fp32 cache with the 4,096 window engaged (lo skipped) and over
# a random one (lo taken), bf16 k/v, Tq off 64 and 128, queries at the tail
# of the keys (Tq < Tk), the chunk mask, and split keys (few blocks)
ATTN_WGMMA = [
    (1, 8, 2, 4500, 4500, 80, "float32", True, 4096, None),
    (1, 8, 2, 1100, 1100, 80, "float32", False, 1024, None),
    (2, 8, 2, 77, 77, 80, "bfloat16", False, None, None),
    (1, 8, 2, 200, 333, 80, "float32", False, None, None),
    (2, 8, 2, 130, 1000, 80, "float32", True, 256, None),
    (1, 4, 1, 250, 250, 80, "float32", False, None, 64),
    (1, 8, 2, 64, 4000, 80, "float32", True, 4096, None),
]


@pytest.mark.parametrize("B,H,KV,Tq,Tk,hd,kv_dt,exact,window,chunk",
                         ATTN_WGMMA)
def test_flash_attention_wgmma_body(cuda, B, H, KV, Tq, Tk, hd, kv_dt, exact,
                                    window, chunk):
    before = dict(fa.flash_attention.launches_by_body)
    _attention_case(cuda, B, H, KV, Tq, Tk, hd, "bfloat16", kv_dt, True,
                    window, chunk, seed=Tq + Tk, bf16_cache=exact)
    assert _body_launched(before) == {"wgmma": 1}


@pytest.mark.parametrize("B,H,Tq,Tk,kv_dt", [
    (1, 8, 700, 700, "float32"),    # every lo product taken
    (2, 8, 77, 333, "float32"),     # Tq off 64, queries at the tail
    (1, 40, 300, 300, "bfloat16"),
])
def test_flash_attention_wgmma_body_mla(cuda, B, H, Tq, Tk, kv_dt):
    # MLA's hd 96 / hdv 64 with H = KV, v a strided slice of the expanded
    # latent as attention_mla passes it
    q, k, v = _mla_inputs(cuda, B, H, Tq, Tk, "bfloat16", kv_dt, seed=Tq)
    assert not v.is_contiguous()
    scale = 1.0 / np.sqrt(96)
    before = dict(fa.flash_attention.launches_by_body)
    got = ops.attention(q, k, v, causal=True, scale=scale)
    want = ref.flash_attention_ref(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    assert _body_launched(before) == {"wgmma": 1}
    assert got.shape == (B, H, Tq, 64) and got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(),
                               **ATTN_KERNEL_TOL["bfloat16"])


@pytest.mark.parametrize("Tq,Tk,hd,hdv,window", [
    (300, 300, 80, 80, None), (150, 400, 80, 80, 128), (200, 200, 96, 64, None),
    (2048, 2048, 80, 80, 4096)])
def test_flash_attention_wgmma_body_writes_the_log_sum_exp(cuda, Tq, Tk, hd,
                                                           hdv, window):
    # the training forward: bf16 q, k, v with the rows' log-sum-exps
    q, k, v, _ = _bwd_inputs(cuda, 2, 8, 2, Tq, Tk, hd, hdv, "bfloat16")
    before = dict(fa.flash_attention.launches_by_body)
    out, lse = fa._forward(q, k, v, True, window, None, hd ** -0.5,
                           with_lse=True)
    want_out, want = ref.flash_attention_ref(q, k, v, window=window,
                                             return_lse=True)
    torch.cuda.synchronize()
    assert _body_launched(before) == {"wgmma": 1}
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(out.float(), want_out.float(),
                               **ATTN_KERNEL_TOL["bfloat16"])


def test_flash_attention_counts_launches_by_body(cuda):
    # danube's heads: a prefill on the wgmma body, a decode step on the mma
    # body, fp32 q on the CUDA cores, K/V rows off 16 bytes on the mma body
    ops.reset_launch_counts()
    for Tq, q_dt, offset, body in ((400, "bfloat16", False, "wgmma"),
                                   (1, "bfloat16", False, "mma"),
                                   (100, "float32", False, "simt"),
                                   (400, "bfloat16", True, "mma")):
        before = dict(fa.flash_attention.launches_by_body)
        _attention_case(cuda, 2, 32, 8, Tq, 400, 80, q_dt, "float32", True,
                        4096, None, seed=Tq, bf16_cache=True, offset=offset)
        assert _body_launched(before) == {body: 1}, (Tq, q_dt, offset)
    assert ops.launch_counts()["flash_attention"] == 4
    assert fa.flash_attention.launches_by_body == {"simt": 1, "mma": 2,
                                                   "wgmma": 1}
    ops.reset_launch_counts()
    assert set(fa.flash_attention.launches_by_body.values()) == {0}


def test_flash_attention_rejects_v_wider_than_k(cuda):
    q = torch.zeros(1, 2, 4, 32, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 4, 32, device=cuda)
    with pytest.raises(ValueError, match="hdv <= hd"):
        ops.attention(q, k, torch.zeros(1, 2, 4, 48, device=cuda))
    with pytest.raises(ValueError, match="hdv <= hd"):
        ops.attention(q, k, torch.zeros(1, 2, 5, 32, device=cuda))
    with pytest.raises(ValueError, match="head dim 192"):
        ops.attention(torch.zeros(1, 2, 4, 192, device=cuda,
                                  dtype=torch.bfloat16),
                      torch.zeros(1, 2, 4, 192, device=cuda),
                      torch.zeros(1, 2, 4, 192, device=cuda))
    # on the tensor cores a narrower v is built for MLA's depth only
    for hd in (64, 128, 160):
        with pytest.raises(ValueError, match="only for hd 81..96"):
            ops.attention(torch.zeros(1, 2, 4, hd, device=cuda,
                                      dtype=torch.bfloat16),
                          torch.zeros(1, 2, 4, hd, device=cuda),
                          torch.zeros(1, 2, 4, hd // 2, device=cuda))


def test_flash_attention_reads_strided_views(cuda):
    B, T, H, KV, hd, S = 2, 7, 8, 2, 80, 20
    rng = np.random.default_rng(0)
    q = _on(rng.standard_normal((B, T, H, hd)), cuda)
    cache = _on(rng.standard_normal((2, B, S, KV, hd)), cuda)
    k, v = cache[0, :, :12].transpose(1, 2), cache[1, :, :12].transpose(1, 2)
    got = ops.attention(q.transpose(1, 2), k, v, window=8)
    want = ref.flash_attention_ref(q.transpose(1, 2).contiguous(),
                                   k.contiguous(), v.contiguous(), window=8)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert got.transpose(1, 2).is_contiguous()


def _bwd_inputs(cuda, B, H, KV, Tq, Tk, hd, hdv, dt, seed=0, offset=False):
    rng = np.random.default_rng(seed)
    return (_on(rng.standard_normal((B, H, Tq, hd)), cuda, dt, offset),
            _on(rng.standard_normal((B, KV, Tk, hd)), cuda, dt, offset),
            _on(rng.standard_normal((B, KV, Tk, hdv)), cuda, dt, offset),
            _on(rng.standard_normal((B, H, Tq, hdv)), cuda, dt, offset))


def _assert_grads_close(got, want, like, dt):
    for g, w, x in zip(got, want, like):
        assert g.dtype == x.dtype and g.shape == x.shape
        peak = float(w.abs().max())
        err = float((g.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dt] * peak + 1e-6, (err, peak)


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("B,H,KV,Tq,Tk,hd,hdv,dt,causal,window,chunk",
                         ATTN_BWD_CASES)
def test_flash_attention_backward_matches_plain(cuda, B, H, KV, Tq, Tk, hd,
                                                hdv, dt, causal, window,
                                                chunk, offset):
    # offset: every input a view one element into its buffer, its rows off
    # 16 bytes (bf16 then takes the CUDA-core body, not the wgmma body)
    q, k, v, do = _bwd_inputs(cuda, B, H, KV, Tq, Tk, hd, hdv, dt,
                              offset=offset)
    kw = dict(causal=causal, window=window, chunk=chunk)
    o, lse = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                     return_lse=True, **kw)
    o = o.to(q.dtype)
    before = dict(fa.flash_attention_bwd.launches_by_body)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       o.float(), lse, do.float(), **kw)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, (q, k, v), dt)
    # the body bwd_body picks for these inputs ran, once
    body, _ = fa.bwd_body(hd, hdv, q.dtype, not offset and all(
        build.rows16(t) for t in (q, k, v, o, do)))
    assert {b: n - before[b] for b, n in
            fa.flash_attention_bwd.launches_by_body.items() if n != before[b]} \
        == {body: 1}
    # deterministic: a second call gives the same bits
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


def test_flash_attention_backward_counts_launches_by_body(cuda):
    # danube's heads and head dim: aligned rows take the wgmma body, rows
    # off 16 bytes and fp32 the CUDA cores; each launch counts once in the
    # total and once under its body
    B, H, KV, T, hd = 1, 32, 8, 150, 80
    kw = dict(causal=True, window=4096)
    ops.reset_launch_counts()
    for dt, offset, body in (("bfloat16", False, "wgmma"),
                             ("bfloat16", True, "simt"),
                             ("float32", False, "simt")):
        q, k, v, do = _bwd_inputs(cuda, B, H, KV, T, T, hd, hd, dt,
                                  offset=offset)
        o, lse = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                         return_lse=True, **kw)
        before = dict(fa.flash_attention_bwd.launches_by_body)
        fa.flash_attention_bwd(q, k, v, o.to(q.dtype), lse, do, **kw)
        torch.cuda.synchronize()
        after = fa.flash_attention_bwd.launches_by_body
        assert {b: after[b] - before[b] for b in after} \
            == {b: int(b == body) for b in after}, (dt, offset)
    assert ops.launch_counts()["flash_attention_bwd"] == 3
    assert fa.flash_attention_bwd.launches_by_body == {"simt": 2, "wgmma": 1}
    ops.reset_launch_counts()
    assert set(fa.flash_attention_bwd.launches_by_body.values()) == {0}


@pytest.mark.parametrize("Tq,Tk,hd,dt,causal,window", [
    (150, 150, 80, "bfloat16", True, 64), (1, 4500, 80, "bfloat16", True, 4096),
    (77, 77, 32, "float32", True, None), (1, 300, 64, "float32", False, None)])
def test_flash_attention_forward_writes_the_rows_log_sum_exp(cuda, Tq, Tk, hd,
                                                             dt, causal,
                                                             window):
    # single pass, split-key combine (Tq = 1) and the CUDA-core body
    q, k, v, _ = _bwd_inputs(cuda, 2, 8, 2, Tq, Tk, hd, hd, dt)
    out, lse = fa._forward(q, k, v, causal, window, None, hd ** -0.5,
                           with_lse=True)
    want_out, want = ref.flash_attention_ref(q, k, v, causal=causal,
                                             window=window, return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(out.float(), want_out.float(),
                               **ATTN_KERNEL_TOL[dt])


def test_backward_through_the_wrappers_on_the_card(cuda):
    """Training's backward on the card: attention's and the scan's
    gradients come from their backward kernels (one launch a call), in the
    inputs' types, the same bits call after call."""
    B, H, KV, T, hd = 2, 8, 2, 96, 80
    q, k, v, do = _bwd_inputs(cuda, B, H, KV, T, T, hd, hd, "bfloat16")
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.attention(*leaves, window=64)
    assert out.grad_fn is not None
    out.backward(do)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1
    assert counts["flash_attention_bwd"] == 1
    o, lse = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                     window=64, return_lse=True)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       out.detach().float(), lse, do.float(),
                                       window=64)
    _assert_grads_close([x.grad for x in leaves], want, leaves, "bfloat16")
    # serving (no grad) launches no backward and saves nothing
    with torch.no_grad():
        assert ops.attention(*leaves, window=64).grad_fn is None
    # the scan under grad: its backward kernel, against the plain gradients
    r, kk, vv, w, u, state = (_on(a, cuda) for a in rwkv_inputs(1, 2, 70, 16,
                                                                 16))
    dy = _on(np.random.default_rng(70).standard_normal((1, 2, 70, 16)), cuda)
    grads = []
    for _ in range(2):
        sl = [x.clone().requires_grad_() for x in (r, kk, vv, w, u, state)]
        ops.reset_launch_counts()
        y, s = ops.rwkv_scan(*sl[:5], state=sl[5])
        assert y.grad_fn is not None
        y.backward(dy)
        counts = ops.launch_counts()
        assert counts["rwkv6_scan"] == 1 and counts["rwkv6_scan_bwd"] == 1
        grads.append([x.grad for x in sl])
    want = ref.rwkv6_scan_bwd_ref(r, kk, vv, w, u, state, dy, None)
    for g, wnt, x in zip(grads[0], want, (r, kk, vv, w, u, state)):
        assert g.dtype == x.dtype and g.shape == x.shape
        torch.testing.assert_close(g, wnt, rtol=1e-4,
                                   atol=1e-4 * float(wnt.abs().max()))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    # serving (no grad) launches no backward and keeps nothing
    with torch.no_grad():
        y, _ = ops.rwkv_scan(*sl[:5], state=sl[5])
    assert y.grad_fn is None and y.shape == (1, 2, 70, 16)
    # bf16 q over an fp32 cache is serving's pair: no backward for it
    with pytest.raises(ValueError, match="one type"):
        ops.attention(leaves[0], k.float(), v.float())


def _scan_case(cuda, B, H, T, K, V, dt, with_state, seed=0, decay=None,
               offset=False):
    r, k, v, w, u, s0 = rwkv_inputs(B, H, T, K, V, seed=seed, decay=decay)
    args = [_on(r, cuda, dt, offset), _on(k, cuda, dt, offset),
            _on(v, cuda, dt, offset), _on(w, cuda, offset=offset),
            _on(u, cuda)]
    state = _on(s0, cuda) if with_state else None
    y, s = ops.rwkv_scan(*args, state=state)
    y0, s_ref = ref.rwkv6_scan_ref(*args, state=state)
    torch.cuda.synchronize()
    assert y.dtype == args[0].dtype and s.dtype == torch.float32
    torch.testing.assert_close(y.float(), y0.float(), rtol=RWKV_TOL[dt],
                               atol=RWKV_TOL[dt])
    torch.testing.assert_close(s, s_ref, rtol=RWKV_STATE_TOL,
                               atol=RWKV_STATE_TOL)
    return y, s


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,H,T,K,V,chunk,dt", RWKV_SWEEP)
def test_rwkv6_scan_matches_plain(cuda, B, H, T, K, V, chunk, dt, with_state):
    _scan_case(cuda, B, H, T, K, V, dt, with_state, seed=T)


@pytest.mark.parametrize("B,H,T,K,dt", [
    (2, 3, 45, 64, "float32"), (2, 3, 1, 64, "float32"),
    (2, 3, 70, 64, "bfloat16"), (2, 3, 45, 32, "float32"),
    # rwkv6-3b's 40 heads: a 300-token prefill, one-token decode
    (1, 40, 300, 64, "bfloat16"), (4, 40, 1, 64, "bfloat16")])
def test_rwkv6_scan_serving_shapes(cuda, B, H, T, K, dt):
    # K = V (64: rwkv6-3b's heads), ragged T, one-token decode from a state
    _scan_case(cuda, B, H, T, K, K, dt, True, seed=T)


def test_rwkv6_scan_extreme_decay_is_finite(cuda):
    y, s = _scan_case(cuda, 1, 1, 64, 16, 16, "float32", False, decay=-40.0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("T,dt", [(200, "float32"), (200, "bfloat16"),
                                  (4500, "bfloat16")])
def test_rwkv6_scan_over_several_chunks(cuda, T, dt, with_state):
    # several chunks of rwkv6_scan.CHUNK_LEN tokens with a ragged tail
    assert rs.n_chunks(T) > 1 and T % rs.CHUNK_LEN
    _scan_case(cuda, 1, 4, T, 64, 64, dt, with_state, seed=T)


@pytest.mark.parametrize("T,K,dt,with_state", [(200, 16, "float32", True),
                                                (300, 64, "bfloat16", False)])
def test_rwkv6_scan_over_rows_off_16_bytes(cuda, T, K, dt, with_state):
    # r/k/v/w one element into their buffers: element staging in phases A
    # and C, full 32-token stages included
    _scan_case(cuda, 1, 4, T, K, K, dt, with_state, seed=T, offset=True)


def test_rwkv6_scan_extreme_decay_across_a_chunk_boundary(cuda):
    y, s = _scan_case(cuda, 1, 2, 130, 64, 64, "float32", True, decay=-40.0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


# the backward kernel against rwkv6_scan_bwd_ref in fp32: dr, dk, dv within
# BWD_TOL of their peak in r's type, dw, du and dstate (fp32) within its
# fp32 limit, over every case of SCAN_BWD_CASES and of the grid below (the
# same fields, inputs from scan_bwd_inputs; decay "wide" draws w_log past
# the model's floor, as far as -exp(1.5 N(0, 1))). Each case names the body
# it must run: the mma body for bf16 at K 64 with V a multiple of 16 up to
# 128 and rows 16-byte aligned, simt otherwise
SCAN_BWD_GRID = [
    ("wide, training's T", 1, 4, 2048, 64, 64, "bfloat16", False, "wide",
     False, "mma"),
    ("wide, ragged tail", 1, 4, 2000, 64, 64, "bfloat16", False, "wide",
     False, "mma"),
    ("wide, one chunk", 2, 3, 64, 64, 64, "bfloat16", True, "wide", False,
     "mma"),
    ("wide, T 37", 2, 3, 37, 64, 64, "bfloat16", True, "wide", False, "mma"),
    ("wide, K 16, V 16, T 1", 2, 3, 1, 16, 16, "float32", True, "wide",
     False, "simt"),
    ("wide, T 300", 2, 3, 300, 64, 64, "bfloat16", True, "wide", False,
     "mma"),
    ("fp32, floor across a boundary", 1, 2, 300, 64, 64, "float32", True,
     "boundary", False, "simt"),
    ("fp32, floor everywhere, T 130", 1, 2, 130, 64, 64, "float32", True,
     "floor", False, "simt"),
    ("wide, fp32, training's T", 1, 2, 2048, 64, 64, "float32", False, "wide",
     False, "simt"),
    ("wide, rows off 16 bytes", 1, 4, 300, 64, 64, "bfloat16", True, "wide",
     True, "simt"),
    ("wide, K 16, V 32", 2, 3, 200, 16, 32, "float32", True, "wide", False,
     "simt"),
    ("wide, K 32, V 96", 1, 3, 200, 32, 96, "bfloat16", True, "wide", False,
     "simt"),                                   # 2 column warps
    ("wide, K 64, V 160", 1, 3, 200, 64, 160, "bfloat16", True, "wide",
     False, "simt"),                            # 3 column warps
    ("wide, K 64, V 256", 1, 3, 200, 64, 256, "bfloat16", True, "wide",
     False, "simt"),                            # 4 column warps
    ("fp32, V 256, floor across a boundary", 1, 2, 130, 64, 256, "float32",
     True, "boundary", False, "simt"),
    ("wide, K 16, V 256", 2, 3, 200, 16, 256, "float32", True, "wide", False,
     "simt"),
    ("wide, V 256, rows off 16 bytes", 1, 2, 300, 64, 256, "bfloat16", True,
     "wide", True, "simt"),
    # the mma body's edges: its narrowest and widest V, one token, one
    # sub-chunk, the floor across a sub-chunk boundary
    ("wide, mma, V 16", 2, 3, 200, 64, 16, "bfloat16", True, "wide", False,
     "mma"),
    ("wide, mma, V 128", 1, 3, 200, 64, 128, "bfloat16", True, "wide", False,
     "mma"),
    ("wide, mma, T 1", 2, 3, 1, 64, 64, "bfloat16", True, "wide", False,
     "mma"),
    ("wide, mma, T 16", 2, 3, 16, 64, 64, "bfloat16", True, "wide", False,
     "mma"),
    ("H 2, floor across a sub-chunk boundary", 1, 2, 130, 64, 64, "bfloat16",
     True, "subchunk", False, "mma"),
]


@pytest.mark.parametrize("case", range(len(SCAN_BWD_CASES + SCAN_BWD_GRID)),
                         ids=[c[0] for c in SCAN_BWD_CASES + SCAN_BWD_GRID])
def test_rwkv6_scan_backward_matches_plain(cuda, case):
    # the forward kernel's chunk states and decays; with offset, r/k/v/w_log
    # /dy one element into their buffers. Two calls on the same inputs:
    # both on the named body, the second the same bits
    (_, B, H, T, K, V, dt, with_state, decay, offset,
     body) = (SCAN_BWD_CASES + SCAN_BWD_GRID)[case]
    r, k, v, w, u, state, dy, ds_out = scan_bwd_inputs(
        B, H, T, K, V, dt, with_state, decay, seed=300 + case, device=cuda)
    _, _, L, D = rs._forward(r, k, v, w, u, state)
    if offset:
        r, k, v, dy = (_on(x.cpu(), cuda, dt, offset=True)
                       for x in (r, k, v, dy))
        w = _on(w.cpu(), cuda, offset=True)
    args = [r, k, v, w, u]
    ops.reset_launch_counts()
    got = rs.rwkv6_scan_bwd(*args, state, dy, ds_out, L, D)
    again = rs.rwkv6_scan_bwd(*args, state, dy, ds_out, L, D)
    assert ops.launch_counts()["rwkv6_scan_bwd"] == 2
    assert rs.rwkv6_scan_bwd.launches_by_body[body] == 2, \
        rs.rwkv6_scan_bwd.launches_by_body
    want = ref.rwkv6_scan_bwd_ref(*(x.float() for x in args), state,
                                  dy.float(), ds_out)
    torch.cuda.synchronize()
    tols = [BWD_TOL[dt]] * 3 + [BWD_TOL["float32"]] * 3
    for g, wnt, tol, typ in zip(got, want, tols,
                                [r.dtype] * 3 + [torch.float32] * 3):
        assert g.dtype == typ and torch.isfinite(g.float()).all()
        err = float((g.float() - wnt).abs().max())
        assert err <= tol * float(wnt.abs().max()) + 1e-30, (err, tol)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the gradients of the projections' layout: (B, T, H, .) memory
    assert all(g.transpose(1, 2).is_contiguous() for g in got[:4])


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "rwkv6-3b"])
def test_server_on_the_card_equals_the_cpu(cuda, arch):
    cfg = serve.ServeConfig(arch=arch, max_new_tokens=4, max_seq=40)
    params = _tree(lambda t: t.float(),
                   serve.Server(cfg, device="cpu").params)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (9, 30, 4)]
    cpu = serve.Server(cfg, params=params, device="cpu")
    card = serve.Server(cfg, params=_tree(lambda t: t.to(cuda), params),
                        device=cuda)
    ops.reset_launch_counts()
    got = card.generate(prompts)
    torch.cuda.synchronize()
    kernel = "rwkv6_scan" if arch == "rwkv6-3b" else "flash_attention"
    assert ops.launch_counts()[kernel] == card.arch.n_layers * 4
    assert got == cpu.generate(prompts)
    for a, b in zip(card.step_logits, cpu.step_logits):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "minicpm3-4b"])
def test_mrope_and_mla_servers_on_the_card_equal_the_cpu(cuda, arch):
    test_server_on_the_card_equals_the_cpu(cuda, arch)


# internlm2-20b and stablelm-12b at 2 layers with their published head dims
WIDE_HEAD_ARCHS = {"internlm2-20b": (512, 128), "stablelm-12b": (640, 160)}


def _wide_head_arch(name):
    d_model, hd = WIDE_HEAD_ARCHS[name]
    cfg = get_arch(name).scaled(n_layers=2, d_model=d_model, n_heads=4)
    assert cfg.hd == hd == get_arch(name).hd
    return cfg


def _server_on_the_card_equals_the_cpu(cuda, cfg, launches_per_step):
    # fp32 parameters (the CUDA-core body), tokens equal to the CPU's and
    # logits within 1e-3, as for the smoke-scale servers
    params = _tree(lambda t: t.float(), init_params(
        torch.Generator().manual_seed(0), cfg))
    scfg = serve.ServeConfig(arch=cfg.name, max_new_tokens=4, max_seq=40)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 30, 4)]
    cpu = serve.Server(scfg, params=params, device="cpu")
    card = serve.Server(scfg, params=_tree(lambda t: t.to(cuda), params),
                        device=cuda)
    cpu.arch = card.arch = cfg
    ops.reset_launch_counts()
    got = card.generate(prompts)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == launches_per_step * 4
    assert got == cpu.generate(prompts)
    for a, b in zip(card.step_logits, cpu.step_logits):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", sorted(WIDE_HEAD_ARCHS))
def test_wide_head_servers_on_the_card_equal_the_cpu(cuda, arch):
    # the CUDA-core body at HC 4 / 5
    cfg = _wide_head_arch(arch)
    _server_on_the_card_equals_the_cpu(cuda, cfg, cfg.n_layers)


# zamba2-1.2b and seamless-m4t (hd 64), llama4-scout and kimi-k2 (hd 128) at
# 2 layers with their published head dims: (d_model, head dim)
FAMILY_ARCHS = {"zamba2-1.2b": (256, 64), "seamless-m4t-large-v2": (256, 64),
                "llama4-scout-17b-a16e": (512, 128),
                "kimi-k2-1t-a32b": (512, 128)}


def _family_arch(name):
    d_model, hd = FAMILY_ARCHS[name]
    cfg = get_arch(name).scaled(n_layers=2, d_model=d_model, n_heads=4)
    assert cfg.hd == hd == get_arch(name).hd
    return cfg


@pytest.mark.parametrize("arch", sorted(FAMILY_ARCHS))
def test_family_servers_on_the_card_equal_the_cpu(cuda, arch):
    # attention launches a step: zamba2's shared block once at each of its
    # 2 sites; seamless's decoder self and cross attention a layer (the
    # server runs no encoder); the MoE models one a layer
    cfg = _family_arch(arch)
    per_step = {"zamba2-1.2b": 2, "seamless-m4t-large-v2": 4}.get(
        arch, cfg.n_layers)
    _server_on_the_card_equals_the_cpu(cuda, cfg, per_step)


def test_encoder_decoder_in_bf16_on_the_card(cuda, monkeypatch):
    # seamless-m4t at 2 + 2 layers, bf16 parameters and fp32 cache (the
    # serving types; the encoder runs bf16 only, as the reference's): a
    # prefill with the encoder over 70 frames (attention with no causal
    # mask, bf16 K/V), then three decode steps over the cross cache, with
    # the kernel and with the plain attention, both on the card, within
    # 0.05, as the wide-head models in bf16
    cfg = _family_arch("seamless-m4t-large-v2")
    params = _tree(lambda t: t.to(cuda), init_params(
        torch.Generator().manual_seed(0), cfg))
    rng = np.random.default_rng(3)
    B, P, T = 2, 60, 63
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                           dtype=torch.int32, device=cuda)
    pos = torch.arange(T, dtype=torch.int32, device=cuda)[None].expand(B, T)
    frames = torch.as_tensor(rng.standard_normal((B, 70, cfg.d_model)),
                             dtype=torch.float32, device=cuda)

    def run():
        caches = make_caches(cfg, B, 70, dtype=torch.float32, device=cuda)
        out, _, _ = forward(params, cfg, toks[:, :P], pos[:, :P],
                            caches=caches, cache_index=0, enc_inputs=frames)
        steps = [out]
        for t in range(P, T):
            lg, _, _ = forward(params, cfg, toks[:, t:t + 1], pos[:, t:t + 1],
                               caches=caches, cache_index=t)
            steps.append(lg)
        return torch.cat(steps, dim=1).float()

    ops.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == \
        cfg.n_enc_layers + 2 * cfg.n_dec_layers * (T - P + 1)
    monkeypatch.setattr(ops, "attention", ref.flash_attention_ref)
    want = run()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("arch", sorted(WIDE_HEAD_ARCHS))
def test_wide_head_models_in_bf16_on_the_card(cuda, arch, monkeypatch):
    # bf16 parameters, fp32 cache (the serving types): the tensor-core body
    # at KS 8 / 10. A prefill and three decode steps of given tokens, with
    # the kernel and with the plain attention, both on the card: the bf16
    # attention outputs differ by one bf16 rounding, which the two bf16
    # layers carry to logits of magnitude ~1 within 0.05
    cfg = _wide_head_arch(arch)
    params = _tree(lambda t: t.to(cuda), init_params(
        torch.Generator().manual_seed(0), cfg))
    rng = np.random.default_rng(2)
    B, P, T = 2, 70, 73
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                           dtype=torch.int32, device=cuda)
    pos = torch.arange(T, dtype=torch.int32, device=cuda)[None].expand(B, T)

    def run():
        caches = make_caches(cfg, B, T, dtype=torch.float32, device=cuda)
        out, _, _ = forward(params, cfg, toks[:, :P], pos[:, :P],
                            caches=caches, cache_index=0)
        steps = [out]
        for t in range(P, T):
            lg, _, _ = forward(params, cfg, toks[:, t:t + 1], pos[:, t:t + 1],
                               caches=caches, cache_index=t)
            steps.append(lg)
        return torch.cat(steps, dim=1).float()

    ops.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers * (T - P + 1)
    monkeypatch.setattr(ops, "attention", ref.flash_attention_ref)
    want = run()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0.05, atol=0.05)


# --------------------------------------------------------------------------
# the serving loop and the sharded cluster on the card
# --------------------------------------------------------------------------

def _drift_serve(dev):
    """P0 compiled against 100 orders / 5000 customers, the 4000 / 500
    tables loaded without analyze, 8 requests in batches of 4."""
    db = make_orders_customer_db(100, 5000, device=dev)
    session = CobraSession(db, CostCatalog(SLOW_REMOTE),
                           config=OptimizerConfig.preset("paper-exp1-3"))
    rt = ServingRuntime(session, batch_size=4, drift_threshold=3.0,
                        compile_hot_plans=2)
    rt.register(make_p0())
    assert "JOIN" in repr(rt.executable("P0").program.body)
    grown = make_orders_customer_db(4000, 500, device=dev)
    db.replace_table(grown.table("orders"))
    db.replace_table(grown.table("customer"))
    return rt, rt.serve([("P0", {})] * 8)


def test_serving_drift_flip_on_the_card_equals_the_cpu(cuda):
    cpu, cpu_out = _drift_serve("cpu")
    card, out = _drift_serve("cuda")
    torch.cuda.synchronize()
    assert card.recompiles == cpu.recompiles >= 1
    assert "prefetch" in repr(card.executable("P0").program.body)
    assert card.compiler.compiled_batches > 0
    assert card.feedback.swap_log == cpu.feedback.swap_log
    assert card.simulated_s == cpu.simulated_s
    assert [r.outputs for r in out] == [r.outputs for r in cpu_out]
    assert card.executable("P0").scan() == []


def test_serving_as_written_launches_the_kernels(cuda):
    cfg = OptimizerConfig(rule_set=RuleSet([]), compile_hot_plans=1)
    outs, launched = {}, {}
    for dev in ("cpu", "cuda"):
        nav = ServingRuntime(CobraSession(
            make_orders_customer_db(3000, 300, device=dev),
            CostCatalog(SLOW_REMOTE), config=cfg))
        nav.register(make_p0())
        folds = ServingRuntime(CobraSession(
            make_wilos_db(3000, device=dev), CostCatalog(SLOW_REMOTE),
            config=cfg))
        folds.register(make_wilos_b())
        folds.register(make_wilos_f())
        ops.reset_launch_counts()
        out = nav.serve([("P0", {})] * 2) \
            + folds.serve([("W_B", {}), ("W_F", {})] * 2)
        if dev == "cuda":
            torch.cuda.synchronize()
        launched[dev] = ops.launch_counts()
        outs[dev] = [r.outputs for r in out]
    assert outs["cuda"] == outs["cpu"]
    for k in ("join_probe", "build_direct_table", "segment_reduce"):
        assert launched["cuda"][k] > 0 and launched["cpu"][k] == 0, k


def _cluster_stream():
    stream = []
    for i in range(16):
        stream.append(("W_E", {"worklist": [i % 7, 20 + i]}))
        if i % 8 == 3:
            stream.append(("W_F", {}))
        elif i % 8 == 7:
            stream.append(("W_B", {}))
    return stream


def test_cluster_on_the_card_equals_one_worker(cuda):
    cfg = OptimizerConfig(rule_set=RuleSet([]), compile_hot_plans=1)
    programs = (make_wilos_e, make_wilos_b, make_wilos_f)
    stream = _cluster_stream()
    half = len(stream) // 2
    cl = ClusterRuntime(make_wilos_db(3000, device=cuda), n_workers=4,
                        partition_keys={"tasks": "t_role_id"},
                        affinity={"W_E": "worklist"}, max_batch=8,
                        config=cfg)
    for make in programs:
        cl.register(make())
    ops.reset_launch_counts()
    out = cl.serve(stream[:half])
    cl.db.analyze()
    out += cl.serve(stream[half:])
    torch.cuda.synchronize()
    assert ops.launch_counts()["segment_reduce"] > 0
    db = make_wilos_db(3000, device=cuda)
    rt = ServingRuntime(CobraSession(db, config=cfg), batch_size=8)
    for make in programs:
        rt.register(make())
    single = rt.serve(stream[:half])
    db.analyze()
    single += rt.serve(stream[half:])
    assert [r.outputs for r in out] == [r.outputs for r in single]
    for name in ("tasks", "roles"):
        a, b = cl.db.table(name), db.table(name)
        for c in a.schema.names:
            assert np.array_equal(a.host(c), b.host(c)), (name, c)
    assert cl.metrics_snapshot()["workers_serving_requests_served"] == \
        sum(w.requests_served for w in cl.workers) == len(stream)


def test_sharded_tables_and_merges_live_on_the_card(cuda):
    base = make_wilos_db(2000, device=cuda)
    sh = ShardedDatabase.shard(base, 4, keys={"tasks": "t_role_id"})
    assert sh.device.type == "cuda"
    for s in sh.shards:
        assert s.device.type == "cuda"
        assert all(t.device.type == "cuda" for t in s.tables.values())
    queries = [
        A.Scan("tasks"),
        A.Join(A.Scan("tasks"), A.Scan("roles"), "t_role_id", "r_id"),
        A.Aggregate(("t_state",), (A.AggSpec("avg", "t_role_id", "a"),
                                   A.AggSpec("count", None, "n")),
                    A.Scan("tasks")),
        A.Aggregate((), (A.AggSpec("avg", "t_id", "a"),
                         A.AggSpec("min", "t_hours", "lo"),
                         A.AggSpec("sum", "t_role_id", "s")), A.Scan("tasks")),
    ]
    for q in queries:
        got, want = sh.run(q)[0], base.run(q)[0]
        assert got.device.type == "cuda"
        assert got.schema.names == want.schema.names
        for c in want.schema.names:
            assert np.array_equal(got.host(c), want.host(c)), (q.sql(), c)
    assert sh.scattered_queries == len(queries)
    for name in ("tasks", "roles"):
        assert sh.table(name).device.type == "cuda"


@pytest.mark.parametrize("arch,body", [("h2o-danube-1.8b", "wgmma"),
                                       ("rwkv6-3b", "mma")])
def test_remat_on_a_card_mesh(cuda, arch, body):
    """Two layers of the published width on a 1×1 mesh of the card (a
    one-rank NCCL group), fsdp_tp: under ``remat="full"`` the gradients are
    bit-equal to ``"none"``'s, the forward kernel launches twice a layer
    (forward, then recompute) and the backward once, on the family's
    tensor-core body, with DTensors never reaching a kernel."""
    import dataclasses

    from repro_torch.launch.mesh import card_group, make_mesh
    from repro_torch.launch.sharding import (batch_specs, distribute_tree,
                                             make_policy, param_specs)
    from repro_torch.models import loss_fn
    from repro_torch.models.model import dtensor_region
    from repro_torch.optim import tree_leaves
    cfg = dataclasses.replace(get_arch(arch), n_layers=2)
    fwd, bwd = {"wgmma": ("flash_attention", "flash_attention_bwd"),
                "mma": ("rwkv6_scan", "rwkv6_scan_bwd")}[body]
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 256))
                                .astype(np.int32), device=cuda)
             for k in ("tokens", "labels")}
    grads, counts = {}, {}
    with card_group():
        mesh = make_mesh((1, 1), ("data", "model"))
        for remat in ("none", "full"):
            pol = make_policy(mesh, "fsdp_tp", remat=remat)
            dp = distribute_tree(
                mesh, param_specs(params, cfg, mesh, "fsdp_tp"), params)
            db = distribute_tree(mesh, batch_specs(mesh, batch), batch)
            leaves = tree_leaves(dp)
            for p in leaves:
                p.requires_grad_(True)
            ops.reset_launch_counts()
            with dtensor_region(True):
                loss = loss_fn(dp, cfg, db, pol=pol)
                g = torch.autograd.grad(loss.full_tensor(), leaves)
            torch.cuda.synchronize()
            grads[remat] = [x.full_tensor() for x in g]
            counts[remat] = (ops.launch_counts(),
                             dict(getattr(ops, bwd).launches_by_body))
    for a, b in zip(grads["full"], grads["none"]):
        assert torch.equal(a, b)
    for remat, per_layer in (("none", 1), ("full", 2)):
        launches, by_body = counts[remat]
        assert launches[fwd] == per_layer * cfg.n_layers, (remat, launches)
        assert launches[bwd] == cfg.n_layers, (remat, launches)
        assert by_body[body] == cfg.n_layers, (remat, by_body)
