"""Kernel test cases shared by the port's CPU parity tests
(``test_torch_kernels.py``) and its on-card tests (``test_torch_cuda.py``).

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
