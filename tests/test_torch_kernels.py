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

``tests/test_torch_cuda.py`` holds the CUDA kernels against the same plain
versions on the card.
"""

import importlib

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
    assert ops.launch_counts() == {"join_probe": 0, "build_direct_table": 0,
                                   "segment_reduce": 0, "flash_attention": 0,
                                   "rwkv6_scan": 0}


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
    tg, nrb, rows_per_block, tiles = sr.launch_shape(n, groups)
    assert tg & (tg - 1) == 0 and 256 % tg == 0 and tg <= 32
    assert tiles * tg >= groups > (tiles - 1) * tg
    # every row in one row block, and no row block empty
    assert (nrb - 1) * rows_per_block < n <= nrb * rows_per_block
    assert 1 <= nrb <= 1024 and groups * nrb <= 1 << 26


def test_library_path_follows_source_and_flags():
    a = build.library_path("join_probe")
    b = build.library_path("segment_reduce")
    assert a != b and a.suffix == ".so" and a.parent.name == "repro_torch"
    assert build.library_path("join_probe") == a          # stable
    for flag in ("arch=compute_90a,code=sm_90a", "-shared", "-O3"):
        assert flag in build.NVCC_FLAGS
