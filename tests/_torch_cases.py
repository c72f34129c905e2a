"""Kernel test cases shared by the port's CPU parity tests
(``test_torch_kernels.py``, ``test_torch_lm.py``) and its on-card tests
(``test_torch_cuda.py``).

Made with numpy from fixed seeds; imports neither jax nor the reference
package, so the on-card tests run where only torch is installed.
"""

import numpy as np
import torch


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
# atol covers the fp32 sums' order near zero
ATTN_KERNEL_TOL = {"float32": {"rtol": 2e-5, "atol": 2e-5},
                   "bfloat16": {"rtol": 1.6e-2, "atol": 1e-4}}

# flash attention's backward against its plain version on the same inputs
# (B, H, KV, Tq, Tk, hd, hdv, dtype, causal, window, chunk): every mask the
# forward serves (causal, sliding window, chunk, none; Tq != Tk both ways
# for cross attention), GQA and H = KV, hd 16..160 and MLA's hdv < hd,
# ragged tiles, both types
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
]
# the kernel's gradient against the plain version's, as a fraction of the
# gradient's peak: bf16 outputs two roundings (2 * 2**-8: one of the
# output, the rest the fp32 sums' order); fp32 outputs, the sums' order
ATTN_BWD_TOL = {"bfloat16": 2 * 2.0 ** -8, "float32": 1e-4}


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
