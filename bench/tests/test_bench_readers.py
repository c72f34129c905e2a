"""The trace helpers and the metric readers on recorded data: unions,
wholeness, the split by kind, percentiles and shares, where a reader
finds nothing, and the result line's shape."""

import statistics

import pytest

from tiny import tiny_config, tiny_run
from bench import harness, tracing


def test_kernel_names_and_kinds():
    assert tracing.kernel_name(
        "void flash_fwd_mma<float, 5, 8, false>(Args)") == \
        "flash_fwd_mma<float, 5, 8, false>"
    assert tracing.is_eager("vectorized_elementwise_kernel<4>")
    assert not tracing.is_eager("nvjet_tst_128x256")
    assert not tracing.is_eager("flash_combine<float>")
    assert not tracing.is_eager("rwkv6_bwd_chunk_mma<64>")


def test_busy_union_counts_each_instant_once():
    ev = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 25.0),
          ("d", 21.0, 22.0)]
    assert tracing.busy_s(ev) == pytest.approx(17e-6)
    assert tracing.time_in(ev, ("a", "c")) == pytest.approx(15e-6)


def test_wholeness():
    ev = [("flash_fwd_mma", 0, 1)] * 4 + [("add", 1, 2)] * 3
    assert tracing.faults_of(ev, 2, {"flash_fwd": 4}, False) == []
    assert tracing.faults_of(ev, 2, {"flash_fwd": 4}, True) == ["add x3"]
    assert tracing.faults_of(ev, 1, {"flash_fwd": 5}, False) == \
        ["flash_fwd x4, expected 5"]
    assert tracing.faults_of([], 1, {}, False) == ["no device events"]
    segs = [{"name": "train", "faults": []}, {"name": "train",
                                             "faults": ["x"]}]
    assert tracing.whole(segs, "train") is None
    assert tracing.whole(segs[:1], "train") == segs[:1]
    assert tracing.whole(segs, "prefill") is None


def test_breakdown_names_ops_and_gaps():
    seg = {"name": "decode", "events": [("k1", 0.0, 10.0), ("k2", 30.0, 31.0),
                                        ("k1", 31.0, 41.0)]}
    b = tracing.breakdown([seg])
    assert b["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert b["idle_gaps"] == [["decode: after k1 before k2",
                               pytest.approx(20e-6)]]


def _serve_run():
    run = tiny_run("danube-serve-docqa")
    run.host = {"window_s": 2.0, "tokens": 64, "batches": [
        {"ttft_s": 0.1 * (i + 1), "lengths": [10, 20, 30, 40],
         "decode_step_s": [0.01 * (i + 1)] * 3} for i in range(4)]}
    run.memory = {"setup_peak_bytes": 5e9, "window_peak_bytes": 4e9}
    return run


def test_serve_readers():
    run = _serve_run()
    read = lambda m: harness.reader(m).read(run)   # noqa: E731
    ttft = [0.1 * (i + 1) for i in range(4) for _ in range(4)]
    assert read("ttft_p95_ms") == pytest.approx(statistics.quantiles(
        ttft, n=100, method="inclusive")[94] * 1e3)
    assert read("serve_tokens_per_s") == 32.0
    assert read("peak_mem_gb") == 4.0
    assert read("decode_step_ms.serve") == pytest.approx(25.0)
    model = harness.roofline("model_dense")
    flops = 4 * model.forward_flops(run.config, [10, 20, 30, 40])
    assert read("mfu.prefill") == pytest.approx(
        100 * flops / (1.0 * 989e12))
    assert read("idle_share.serve") is None     # nothing traced
    assert read("flash_attention_roofline") is None


def test_train_readers_and_roofline_share():
    run = tiny_run("danube-train-4x2048")
    run.host = {"steps": 10, "window_s": 5.0, "tokens_per_step": 128}
    assert harness.reader("train_tokens_per_s").read(run) == 256.0
    model = harness.roofline("model_dense")
    assert harness.reader("mfu.train").read(run) == pytest.approx(
        100 * 10 * model.train_flops(run.config, 4, 32) / (5.0 * 989e12))
    work = {"phase": "train", "rows": 4, "seq": 32, "microbatch": 1,
            "units": 2}
    fab = harness.roofline("flash_attention_bwd")
    least = sum(n * fab.least_s(c, "bfloat16")
                for c, n in fab.calls(run.config, work))
    ev = [("flash_bwd_wg<16>", 0.0, 100.0), ("flash_bwd_delta_vec", 100.0,
                                            150.0), ("nvjet_x", 150.0, 400.0),
          ("elementwise_kernel", 400.0, 500.0)]
    run.segments = [tracing.segment("train", 1e-3, ev, 2, work, {}, True)]
    run.segments[0]["faults"] = []
    assert harness.reader("flash_attention_bwd_roofline").read(run) == \
        pytest.approx(100 * least / 150e-6)
    assert harness.reader("eager_ms.train").read(run) == pytest.approx(0.05)
    assert harness.reader("idle_share.train").read(run) == pytest.approx(50.0)
    assert harness.reader("flash_attention_roofline").read(run) is None


def test_result_line_shape():
    run = tiny_run("danube-serve-docqa", seconds=0.3)
    out = harness.execute(run, harness.benchmark())
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"ttft_p95_ms", "serve_tokens_per_s",
                                   "setup_s"}   # no memory on the CPU
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == set(run.limits)


def test_tiny_config_is_registered():
    from repro_torch.models import get_arch
    cfg = tiny_config("h2o-danube-1.8b")
    arch = get_arch(cfg["registry_name"])
    assert arch.d_model == cfg["hidden_size"] and arch.hd == cfg["head_dim"]


@pytest.mark.parametrize("cell", ["danube-train-4x2048", "danube-serve-docqa"])
def test_traced_run_on_the_cpu(cell):
    """A ``--trace 1`` run's path end to end (on the CPU the trace holds no
    device events, so its segments are not whole and the device readers
    find nothing)."""
    run = tiny_run(cell, seconds=0.3, trace=True)
    out = harness.execute(run, harness.benchmark())
    names = [s["name"] for s in run.segments]
    assert names == (["train"] if "train" in cell else ["prefill", "decode"])
    assert all(s["faults"] == ["no device events"] for s in run.segments)
    assert "breakdown" in out and out["device"]["window_s"] > 0
    host_only = {"mfu.train", "mfu.prefill", "decode_step_ms.serve"}
    assert set(out["metrics"]) <= host_only and out["metrics"]
