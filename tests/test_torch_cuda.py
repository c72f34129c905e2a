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
    the outputs and clock equal those of the same database on the CPU;
  * ``flash_attention``: the reference's attention sweep plus the serving
    shapes (hd 80, decode over a ragged cache, mixed bf16 q / fp32 cache,
    strided views), within 2e-5 for fp32 outputs and, for bf16 outputs,
    one bf16 rounding (rtol 1.6e-2, atol 1e-4): both sides accumulate in
    fp32;
  * ``rwkv6_scan``: the reference's scan sweep, from zero and from a given
    state, ragged T, one-token decode, extreme decay, within 1e-3 fp32 and
    3e-2 bf16;
  * a scaled ``Server.generate`` on the card against the same server on
    the CPU (fp32 parameters: the same tokens, logits within 1e-3).
"""

import numpy as np
import pytest
import torch

from _torch_cases import (ATTN_EXTRA, ATTN_KERNEL_TOL, ATTN_SWEEP, PROBE_CASES,
                          RWKV_SWEEP, RWKV_TOL, SEGMENT_CASES, TORCH_DTYPES,
                          attention_inputs, rwkv_inputs, t32)
from repro_torch.api import CobraSession, OptimizerConfig, RuleSet
from repro_torch.core import CostCatalog
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
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
                                   "segment_reduce": 1, "flash_attention": 0,
                                   "rwkv6_scan": 0}


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

def _on(a, dev, dtype="float32"):
    return torch.as_tensor(a).to(device=dev, dtype=TORCH_DTYPES[dtype])


def _attention_case(cuda, B, H, KV, Tq, Tk, hd, q_dt, kv_dt, causal, window,
                    chunk, seed=0):
    q, k, v = attention_inputs(B, H, KV, Tq, Tk, hd, seed=seed)
    q, k, v = _on(q, cuda, q_dt), _on(k, cuda, kv_dt), _on(v, cuda, kv_dt)
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


def _scan_case(cuda, B, H, T, K, V, dt, with_state, seed=0, decay=None):
    r, k, v, w, u, s0 = rwkv_inputs(B, H, T, K, V, seed=seed, decay=decay)
    args = [_on(r, cuda, dt), _on(k, cuda, dt), _on(v, cuda, dt),
            _on(w, cuda), _on(u, cuda)]
    state = _on(s0, cuda) if with_state else None
    y, s = ops.rwkv_scan(*args, state=state)
    y0, s_ref = ref.rwkv6_scan_ref(*args, state=state)
    torch.cuda.synchronize()
    assert y.dtype == args[0].dtype and s.dtype == torch.float32
    torch.testing.assert_close(y.float(), y0.float(), rtol=RWKV_TOL[dt],
                               atol=RWKV_TOL[dt])
    torch.testing.assert_close(s, s_ref, rtol=1e-3, atol=1e-3)
    return y, s


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("B,H,T,K,V,chunk,dt", RWKV_SWEEP)
def test_rwkv6_scan_matches_plain(cuda, B, H, T, K, V, chunk, dt, with_state):
    _scan_case(cuda, B, H, T, K, V, dt, with_state, seed=T)


@pytest.mark.parametrize("T,dt", [(45, "float32"), (1, "float32"),
                                  (70, "bfloat16")])
def test_rwkv6_scan_serving_shapes(cuda, T, dt):
    # K = V = 64 (rwkv6-3b heads), ragged T, one-token decode from a state
    _scan_case(cuda, 2, 3, T, 64, 64, dt, True, seed=T)


def test_rwkv6_scan_extreme_decay_is_finite(cuda):
    y, s = _scan_case(cuda, 1, 1, 64, 16, 16, "float32", False, decay=-40.0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


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
