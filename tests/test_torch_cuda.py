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
  * the compiled tier on a card-resident database: the kernels launch, and
    the outputs and clock equal those of the same database on the CPU.
"""

import numpy as np
import pytest
import torch

from _torch_cases import PROBE_CASES, SEGMENT_CASES, t32
from repro_torch.api import CobraSession, OptimizerConfig, RuleSet
from repro_torch.core import CostCatalog
from repro_torch.kernels import ops, ref
from repro_torch.programs import (make_orders_customer_db, make_p0,
                                  make_wilos_b, make_wilos_db, make_wilos_f)
from repro_torch.relational import SLOW_REMOTE

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(PROBE_CASES))
def test_join_probe_matches_plain(cuda, name):
    probe, keys, key_space = PROBE_CASES[name]
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


@pytest.mark.parametrize("groups", [1, 7, 600, 5000])
def test_segment_reduce_random_fp32_sums(cuda, groups):
    rng = np.random.default_rng(groups)
    vals = torch.as_tensor(rng.uniform(-1, 1, 300_000).astype(np.float32))
    segs = t32(rng.integers(0, groups, 300_000))
    got = ops.segment_reduce(vals.to(cuda), segs.to(cuda), groups)
    again = ops.segment_reduce(vals.to(cuda), segs.to(cuda), groups)
    torch.cuda.synchronize()
    assert torch.equal(got, again)               # no run-to-run variation
    torch.testing.assert_close(got.cpu(),
                               ref.segment_reduce_ref(vals, segs, groups),
                               rtol=1e-5, atol=1e-5)


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
                                   "segment_reduce": 1}


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
