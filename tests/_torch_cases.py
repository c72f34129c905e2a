"""Kernel test cases shared by the port's CPU parity tests
(``test_torch_kernels.py``, ``test_torch_lm.py``) and its on-card tests
(``test_torch_cuda.py``), and :func:`as_reference`, the port's
architecture as the reference package describes it.

The kernels' tolerances against their plain versions are defined here
once, for the tests and for the card-side scripts (``chip_smoke.py``,
``chip_kernel_ab.py``), as are the inputs the scan's backward is timed
and tested on.

Made with numpy or torch from fixed seeds; imports neither jax nor the
reference package nor the port, so the on-card tests run where only
torch is installed.
"""

import dataclasses
import math

import numpy as np
import torch


def as_reference(cfg, jcfg):
    """The port's ``ArchConfig`` ``cfg`` held to the reference package's
    ``jcfg``: every field both dataclasses have must be equal, and the
    fields only the port has (MiniCPM's scalings) are set to their
    defaults, which add no operation, so that both sides compute alike."""
    ref = {f.name for f in dataclasses.fields(jcfg)}
    port = {f.name: f for f in dataclasses.fields(cfg)}
    assert ref <= set(port), sorted(ref - set(port))
    got = dataclasses.asdict(cfg)
    assert {k: got[k] for k in ref} == dataclasses.asdict(jcfg)
    return dataclasses.replace(cfg, **{k: f.default for k, f in port.items()
                                       if k not in ref})


def t32(a):
    return torch.as_tensor(np.asarray(a, np.int32))


def _probe_cases():
    rng = np.random.default_rng(11)
    return {
        # the cases of tests/test_kernel_parity.py::TestJoinProbeParity
        "empty_probe_side": ([], [3, 1, 4], 8),
        "empty_build_side": ([0, 1, 2], [], 0),
        "all_miss_keys": ([100, 200, 300, 7], [1, 2, 3], 512),
        "duplicate_probe_keys": ([2, 2, 5, 2, 5, 9], [9, 5, 2], 16),
        "random_sweep_past_one_block": (rng.integers(0, 4096, size=3000),
                                        rng.permutation(4096)[:1500], 4096),
        # keys below 0 and at or past the key space miss without a gather
        "out_of_range_keys": ([-7, -1, 0, 5, 8, 1 << 20], [5, 0, 6], 8),
        "dense_permutation": (rng.integers(0, 5000, size=5000),
                              rng.permutation(5000), 5000),
    }


PROBE_CASES = _probe_cases()


def _segment_cases():
    rng = np.random.default_rng(12)
    skew = np.zeros(1000, np.int32)
    skew[:3] = [7, 7, 3]
    wide = rng.integers(0, 600, size=5000)
    wide[wide == 17] = 18                          # group 17 stays empty
    return {
        # the cases of tests/test_kernel_parity.py::TestSegmentReduceParity
        "empty_input": ([], [], 4),
        "zero_groups": ([], [], 0),
        "groups_above_one_tile": (rng.integers(0, 9, size=500),
                                  rng.integers(0, 30, size=500), 30),
        "skewed_segments": (np.ones(1000), skew, 8),
        "empty_groups": ([3.0, -1.0, 5.0, 2.0, 2.0], [0, 0, 2, 2, 2], 4),
        # the compiled tier's fold: one segment of integer deltas
        "fold_one_segment": (rng.integers(0, 5, size=5000),
                             np.zeros(5000, np.int32), 1),
        # more groups than one reference tile (512), some empty
        "groups_above_pallas_tile": (rng.integers(-50, 50, size=5000),
                                     wide, 600),
    }


SEGMENT_CASES = _segment_cases()


# flash attention: the sweep of tests/test_kernels.py::ATTN_SWEEP
# (B, H, KV, Tq, Tk, hd, dtype, causal, window, chunk)
ATTN_SWEEP = [
    (1, 2, 2, 64, 64, 32, "float32", True, None, None),
    (2, 4, 2, 64, 64, 16, "float32", True, None, None),      # GQA
    (1, 2, 1, 128, 128, 32, "bfloat16", True, None, None),   # bf16 + GQA
    (1, 2, 2, 64, 64, 32, "float32", True, 16, None),        # SWA
    (1, 2, 2, 64, 64, 32, "float32", True, None, 32),        # chunked local
    (1, 1, 1, 32, 128, 32, "float32", True, None, None),     # decode-ish tail
    (1, 2, 2, 64, 64, 64, "float32", False, None, None),     # bidirectional
]

# and the shapes the serving path adds: hd 80 (h2o-danube), decode with
# Tq = 1 over a ragged Tk, ragged Tq = Tk, a masked-out tail
ATTN_EXTRA = [
    (1, 8, 2, 40, 40, 80, "float32", True, 24, None),        # hd 80, SWA
    (2, 8, 2, 1, 77, 80, "float32", True, 64, None),         # decode, ragged Tk
    (1, 4, 4, 45, 45, 32, "float32", True, None, None),      # ragged Tq = Tk
    (1, 4, 2, 3, 100, 16, "float32", True, None, 32),        # chunk tail
]

# rwkv6 scan: the sweep of tests/test_kernels.py::RWKV_SWEEP
# (B, H, T, K, V, chunk, dtype); chunk is the Pallas kernel's
RWKV_SWEEP = [
    (1, 2, 64, 16, 16, 16, "float32"),
    (2, 3, 128, 32, 32, 32, "float32"),
    (1, 2, 64, 16, 32, 64, "float32"),
    (1, 2, 96, 16, 16, 32, "bfloat16"),
]

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the reference's tolerances (tests/test_kernels.py:47 and :90)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
RWKV_TOL = {"float32": 1e-3, "bfloat16": 3e-2}
# the CUDA attention kernel against its plain version on the same inputs,
# by the output's type: both sides accumulate in fp32, so a bf16 output
# differs by one rounding at most (2**-7 relative); rtol is two bf16 ulps,
# atol covers the fp32 sums' order near zero. (The reference's 2e-2 is as
# large as a typical output over 4,096 keys.)
ATTN_KERNEL_TOL = {"float32": {"rtol": 2e-5, "atol": 2e-5},
                   "bfloat16": {"rtol": 1.6e-2, "atol": 1e-4}}
# the RWKV6 scan kernel's final state (fp32) against its plain version's,
# rtol and atol; its outputs are held to RWKV_TOL
RWKV_STATE_TOL = 1e-3

# flash attention's backward against its plain version on the same inputs
# (B, H, KV, Tq, Tk, hd, hdv, dtype, causal, window, chunk): every mask the
# forward serves (causal, sliding window, chunk, none; Tq != Tk both ways
# for cross attention), GQA and H = KV, hd 16..160 and MLA's hdv < hd,
# ragged tiles, both types, and each of the kernel's two bodies
ATTN_BWD_CASES = [
    (2, 8, 2, 150, 150, 80, 80, "bfloat16", True, 64, None),     # danube: window
    (1, 4, 4, 130, 130, 64, 64, "bfloat16", True, None, None),   # zamba2: H = KV
    (1, 8, 2, 200, 200, 128, 128, "bfloat16", True, None, None),  # qwen2-vl: hd 128
    (1, 4, 1, 100, 100, 160, 160, "bfloat16", True, None, None),  # stablelm: hd 160
    (1, 4, 4, 120, 120, 96, 64, "bfloat16", True, None, None),   # minicpm3: MLA
    (1, 4, 2, 200, 200, 128, 128, "bfloat16", True, None, 64),   # llama4: chunk
    (1, 4, 4, 100, 100, 64, 64, "bfloat16", False, None, None),  # encoder
    (1, 4, 4, 70, 130, 64, 64, "bfloat16", False, None, None),   # cross, Tq < Tk
    (1, 4, 4, 130, 70, 64, 64, "bfloat16", False, None, None),   # cross, Tq > Tk
    (1, 2, 2, 1, 33, 16, 16, "bfloat16", True, None, None),      # one query
    (1, 4, 2, 70, 70, 45, 45, "bfloat16", True, 16, None),       # hd off 8: scalar loads
    (1, 4, 2, 77, 77, 32, 32, "float32", True, None, None),
    (2, 4, 2, 50, 90, 45, 45, "float32", True, 16, None),        # tail queries
    # the wgmma body's edges (aligned rows; the offset views of the same
    # cases take the CUDA-core body): hd 80 over T off the 64 / 128 tiles,
    # GQA groups of 1, 4 and 8, a chunk across tiles, causal Tq != Tk both
    # ways, and many key tiles into one query tile
    (1, 8, 2, 77, 77, 80, 80, "bfloat16", True, None, None),
    (1, 8, 2, 150, 150, 80, 80, "bfloat16", True, None, None),
    (1, 8, 8, 150, 150, 80, 80, "bfloat16", True, None, None),   # group 1
    (1, 16, 4, 150, 150, 80, 80, "bfloat16", True, None, None),  # group 4
    (1, 64, 8, 150, 150, 128, 128, "bfloat16", True, None, None),  # qwen2-vl
    (1, 8, 2, 300, 300, 80, 80, "bfloat16", True, None, 100),    # chunk
    (1, 8, 2, 300, 170, 80, 80, "bfloat16", True, None, None),   # Tq > Tk
    (1, 8, 2, 170, 300, 80, 80, "bfloat16", True, None, None),   # Tq < Tk
    (1, 8, 2, 4096, 4096, 80, 80, "bfloat16", True, None, None),  # T 4,096
    # the training attention of each family the card trains, at its
    # published heads, head dims and masks over 2,048 queries and keys:
    # danube (window 4,096), qwen2-vl, stablelm, llama4 (chunk 8,192,
    # inactive at 2,048), zamba2's shared block, minicpm3's MLA,
    # seamless-m4t's encoder and its cross attention over 2,560 keys, and
    # llama4's heads under a chunk that crosses the sequence (768)
    (1, 32, 8, 2048, 2048, 80, 80, "bfloat16", True, 4096, None),
    (1, 64, 8, 2048, 2048, 128, 128, "bfloat16", True, None, None),
    (1, 32, 8, 2048, 2048, 160, 160, "bfloat16", True, None, None),
    (1, 40, 8, 2048, 2048, 128, 128, "bfloat16", True, None, 8192),
    (1, 32, 32, 2048, 2048, 64, 64, "bfloat16", True, None, None),
    (1, 40, 40, 2048, 2048, 96, 64, "bfloat16", True, None, None),
    (1, 16, 16, 2048, 2048, 64, 64, "bfloat16", False, None, None),
    (1, 16, 16, 2048, 2560, 64, 64, "bfloat16", False, None, None),
    (1, 40, 8, 2048, 2048, 128, 128, "bfloat16", True, None, 768),
    # short, ragged tails of each (T 77; the cross attention's over 130 keys)
    (1, 32, 8, 77, 77, 80, 80, "bfloat16", True, 4096, None),
    (1, 64, 8, 77, 77, 128, 128, "bfloat16", True, None, None),
    (1, 32, 8, 77, 77, 160, 160, "bfloat16", True, None, None),
    (1, 40, 8, 77, 77, 128, 128, "bfloat16", True, None, 8192),
    (1, 32, 32, 77, 77, 64, 64, "bfloat16", True, None, None),
    (1, 40, 40, 77, 77, 96, 64, "bfloat16", True, None, None),
    (1, 16, 16, 77, 77, 64, 64, "bfloat16", False, None, None),
    (1, 16, 16, 77, 130, 64, 64, "bfloat16", False, None, None),
    (1, 40, 8, 77, 77, 128, 128, "bfloat16", True, None, 768),
    # danube at its training batch (4 x 2,048), and beside its B 1 shape
    # the inputs the CUDA-core body takes: a head dim the wgmma body is not
    # built for (45), and fp32 (its rows off 16 bytes: the offset cases)
    (4, 32, 8, 2048, 2048, 80, 80, "bfloat16", True, 4096, None),
    (1, 32, 8, 2048, 2048, 45, 45, "bfloat16", True, 4096, None),
    (1, 32, 8, 2048, 2048, 80, 80, "float32", True, 4096, None),
]
# each backward kernel's gradients (flash attention's dq, dk, dv; the RWKV6
# scan's dr, dk, dv in r's type and dw, du, dstate in fp32) against its
# plain version's in fp32 on the same inputs, as a fraction of each
# gradient's peak: bf16 outputs two roundings (2 * 2**-8: one of the
# output, the rest the fp32 sums' order); fp32 outputs, the sums' order
BWD_TOL = {"bfloat16": 2 * 2.0 ** -8, "float32": 1e-4}

# rwkv6_scan_bwd against rwkv6_scan_bwd_ref: (label, B, H, T, K, V, type,
# a given state and final-state cotangent, decay, rows off 16 bytes, the
# body ``rwkv6_scan.scan_bwd_body`` must pick: "mma" for bf16 at K 64 with
# V a multiple of 16 up to 128 and aligned rows, "simt" otherwise), over
# :func:`scan_bwd_inputs`. decay None: the model's range, w_log =
# -exp(clamp(N(-1, 1.5), -12, 2)); "boundary": that, with the clamp's floor
# -e**2 on tokens 32..95 (across the first chunk boundary); "subchunk": the
# floor on tokens 8..23 (across the mma body's first sub-chunk boundary);
# "floor": -e**2 everywhere
SCAN_BWD_CASES = [
    ("rwkv6-3b train", 1, 40, 2048, 64, 64, "bfloat16", False, None, False,
     "mma"),
    ("ragged T", 1, 40, 2000, 64, 64, "bfloat16", False, None, False, "mma"),
    ("one chunk", 1, 40, 64, 64, 64, "bfloat16", False, None, False, "mma"),
    ("short, one chunk", 2, 40, 37, 64, 64, "bfloat16", True, None, False,
     "mma"),
    ("state and cotangent", 2, 40, 300, 64, 64, "bfloat16", True, None, False,
     "mma"),
    ("floor across a boundary", 1, 40, 300, 64, 64, "bfloat16", True,
     "boundary", False, "mma"),
    ("floor everywhere", 1, 40, 300, 64, 64, "float32", True, "floor", False,
     "simt"),
    ("fp32", 1, 40, 2048, 64, 64, "float32", False, None, False, "simt"),
    ("rows off 16 bytes", 1, 40, 2000, 64, 64, "bfloat16", True, None, True,
     "simt"),
    ("K 16, V 32", 2, 3, 200, 16, 32, "float32", True, None, False, "simt"),
    ("K 32, V 96", 1, 3, 200, 32, 96, "bfloat16", True, None, False, "simt"),
    # the widest values: 3 and 4 warps a state row in the row pass (192
    # and 256 threads), its shared memory near the card's 227 KB at V 256
    ("K 64, V 160", 1, 3, 200, 64, 160, "bfloat16", True, None, False, "simt"),
    ("K 64, V 256", 1, 3, 200, 64, 256, "bfloat16", True, None, False, "simt"),
    ("K 64, V 256, fp32", 1, 2, 130, 64, 256, "float32", True, "boundary",
     False, "simt"),
    ("K 16, V 256", 2, 3, 200, 16, 256, "float32", True, None, False, "simt"),
    # the mma body's edges: its narrowest and widest V (its shared memory
    # 204 KB at V 128), one token, one sub-chunk, the floor across a
    # sub-chunk boundary
    ("mma, V 16", 2, 3, 200, 64, 16, "bfloat16", True, None, False, "mma"),
    ("mma, V 128", 1, 3, 200, 64, 128, "bfloat16", True, None, False, "mma"),
    ("mma, T 1", 2, 40, 1, 64, 64, "bfloat16", True, None, False, "mma"),
    ("mma, T 16", 2, 40, 16, 64, 64, "bfloat16", True, None, False, "mma"),
    ("floor across a sub-chunk boundary", 1, 40, 300, 64, 64, "bfloat16",
     True, "subchunk", False, "mma"),
]


def scan_bwd_inputs(B, H, T, K, V, dtype, with_state, decay, seed, device):
    """Seeded r, k, v, w_log, u, state (or None), dy, ds_out (or None) of
    a ``SCAN_BWD_CASES`` case on ``device``; r/k/v/dy in ``dtype`` (a
    name), the rest fp32. ``decay`` as in ``SCAN_BWD_CASES``, or "wide":
    w_log = -exp(1.5 N(0, 1)), unclamped, past the model's floor."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = lambda *s: torch.randn(s, generator=g, device=device)  # noqa: E731
    r, k, v, dy = n(B, H, T, K), n(B, H, T, K), n(B, H, T, V), n(B, H, T, V)
    z = n(B, H, T, K)
    w = -torch.exp(z * 1.5) if decay == "wide" \
        else -torch.exp(torch.clamp(z * 1.5 - 1.0, -12.0, 2.0))
    if decay == "boundary":
        w[:, :, 32:96] = -math.exp(2.0)
    elif decay == "subchunk":
        w[:, :, 8:24] = -math.exp(2.0)
    elif decay == "floor":
        w.fill_(-math.exp(2.0))
    u = n(H, K) * 0.3
    state = n(B, H, K, V) if with_state else None
    ds_out = n(B, H, K, V) if with_state else None
    typ = TORCH_DTYPES[dtype]
    return (r.to(typ), k.to(typ), v.to(typ), w, u, state, dy.to(typ), ds_out)


def attention_inputs(B, H, KV, Tq, Tk, hd, seed=0):
    """q (B,H,Tq,hd), k/v (B,KV,Tk,hd) float32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Tq, hd)).astype(np.float32),
            rng.standard_normal((B, KV, Tk, hd)).astype(np.float32),
            rng.standard_normal((B, KV, Tk, hd)).astype(np.float32))


def rwkv_inputs(B, H, T, K, V, seed=0, decay=None):
    """r, k (B,H,T,K), v (B,H,T,V), w_log (B,H,T,K) <= 0, u (H,K),
    state (B,H,K,V): float32 numpy. ``decay`` fixes every w_log."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, H, T, K)).astype(np.float32)
    k = rng.standard_normal((B, H, T, K)).astype(np.float32)
    v = rng.standard_normal((B, H, T, V)).astype(np.float32)
    if decay is None:
        w = -np.exp(rng.standard_normal((B, H, T, K)) * 1.5).astype(np.float32)
    else:
        w = np.full((B, H, T, K), decay, np.float32)
    u = rng.standard_normal((H, K)).astype(np.float32)
    state = rng.standard_normal((B, H, K, V)).astype(np.float32)
    return r, k, v, w, u, state
