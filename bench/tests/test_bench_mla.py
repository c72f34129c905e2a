"""The ``mla`` family's pieces of the benchmark (minicpm3-4b and its cell
``minicpm3-serve-longdoc``): the cell driven at tiny widths on the CPU
(sound, and with faults underneath), the model's and the kernel's counts
by hand, and the MLA span readers on the program's recorder filled by
hand."""

import copy
import dataclasses
import time

import pytest
import torch

from tiny import MIXES
from bench import harness
from bench.roofline import flash_attention as fa
from bench.roofline import flash_attention_mla as fam
from bench.roofline import model_mla
import bench.control as control
from repro_torch.obs import trace

CELL, CONFIG = "minicpm3-serve-longdoc", "minicpm3-4b"
WIDTHS = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4,
              num_key_value_heads=4, q_lora_rank=32, kv_lora_rank=16,
              qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
              num_hidden_layers=2, vocab_size=256,
              max_position_embeddings=256)
# MiniCPM's scalings; None, each field's default, adds no operation
SCALINGS = ("dim_model_base", "scale_depth", "scale_emb")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(**port):
    """minicpm3-4b's file at tiny widths, its port twin registered under
    a name of its own (with ``port``'s fields changed on the port's side
    alone)."""
    from repro_torch.models.arch import get_arch, register_arch
    conf = {c["name"]: c for c in harness.benchmark()["configs"]}[CONFIG]
    cfg = copy.deepcopy(harness.load_json(harness.ROOT / conf["file"]))
    cfg.update(WIDTHS)
    fields = {field: cfg[key] for key, field in cfg["port_fields"].items()
              if field != "vhd"}
    arch = dataclasses.replace(
        get_arch(cfg["registry_name"]), name="bench-tiny-mla",
        v_head_dim=cfg["v_head_dim"],
        head_dim=cfg["hidden_size"] // cfg["num_attention_heads"],
        **dict(fields, **port))
    register_arch(arch)
    cfg["registry_name"] = arch.name
    return cfg


def _run(seed=21, seconds=1e-9, **port):
    w, _, mix, limits = harness.cell_files(CELL)
    return harness.Run(workload=w, config=_config(**port),
                       mix=dict(mix, **MIXES["serve"]), limits=limits,
                       seed=seed, seconds=seconds, trace=False, device="cpu",
                       t0=time.perf_counter())


def _execute(run):
    out = harness.execute(run, harness.benchmark())
    return out, {k: v["value"] for k, v in out["checks"].items()}


def test_the_cell_runs_sound_at_tiny_widths():
    out, got = _execute(_run())
    assert out["correct"] and set(got) == {"max_logit_gap", "max_logit_err"}
    assert out["failed"] == 0 and out["attempted"] >= 4
    assert {"ttft_p95_ms", "serve_tokens_per_s",
            "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("field", SCALINGS)
def test_a_port_that_departs_from_the_file_refuses_to_start(field):
    with pytest.raises(RuntimeError, match="departs from the file"):
        _execute(_run(**{field: None}))


@pytest.mark.parametrize("field", SCALINGS)
def test_a_server_without_a_scaling_is_not_correct(field, monkeypatch):
    """Limits at four times a sound run's readings, as
    ``test_bench_faults.py`` sets them: a server that runs with one of
    MiniCPM's scalings neutral misses them."""
    from repro_torch.launch.serve import Server
    _, sound = _execute(_run())
    step = Server._step

    def broken(self, caches, cache_index, tokens, positions):
        self.arch = dataclasses.replace(self.arch,
                                        **{field: None})
        return step(self, caches, cache_index, tokens, positions)
    monkeypatch.setattr(Server, "_step", broken)
    run = _run()
    run.limits = {k: 4 * v + 1e-6 for k, v in sound.items()}
    out, got = _execute(run)
    assert not out["correct"], (sound, got)


def test_a_decode_that_leaves_its_cache_unchanged_is_not_correct(
        monkeypatch):
    from test_bench_faults import _unchanged_cache
    _, sound = _execute(_run())
    _unchanged_cache(monkeypatch)
    run = _run()
    run.limits = {k: 4 * v + 1e-6 for k, v in sound.items()}
    assert not _execute(run)[0]["correct"]


def test_control_reads_above_the_program():
    run = _run(seed=8, seconds=0.0)
    run.mix.update(new_tokens=12, sample_requests=12)
    out = control.readings(run, control=True)
    prog, fp8 = out["program"], out["control_fp8"]
    assert any(fp8[k] >= 3 * prog[k] and fp8[k] > 0 for k in prog), out


# --------------------------------------------------------------------------
# counts from shapes
# --------------------------------------------------------------------------

def _published():
    conf = {c["name"]: c for c in harness.benchmark()["configs"]}[CONFIG]
    return harness.load_json(harness.ROOT / conf["file"])


def test_model_flops_by_hand():
    cfg = dict(hidden_size=8, num_attention_heads=2, q_lora_rank=4,
               kv_lora_rank=3, qk_nope_head_dim=2, qk_rope_head_dim=1,
               v_head_dim=2, intermediate_size=16, vocab_size=10,
               num_hidden_layers=3)
    # wq_a 8x4, wq_b 4x(2 x 3), wkv_a 8x(3 + 1), wkv_b 3x(2 x 4), wo 4x8;
    # the MLP 8x32 and 16x8
    layer = 32 + 24 + 32 + 24 + 32 + 8 * 32 + 16 * 8
    assert model_mla.matmul_params(cfg) == 3 * layer + 8 * 10
    # 4 tokens, causal: 10 pairs a head; q.k over 2 + 1, p.v over 2
    assert model_mla.mixer_flops(cfg, 4) == 3 * 2 * 2 * 5 * 10
    assert model_mla.forward_flops(cfg, [4, 1]) == (
        2 * model_mla.matmul_params(cfg) * 5 + 3 * 2 * 2 * 5 * (10 + 1))


def test_published_model_size():
    """About 4.3 B parameters, as the model card gives them:
    62 layers of 62.7 M matmul parameters and the untied 73,448 x 2,560
    embedding and head."""
    cfg = _published()
    attn = (2560 * 768 + 768 * 40 * 96 + 2560 * 288 + 256 * 40 * 128
            + 40 * 64 * 2560)
    layer = attn + 3 * 2560 * 6400
    assert model_mla.matmul_params(cfg) == 62 * layer + 2560 * 73448
    total = model_mla.matmul_params(cfg) + 73448 * 2560
    assert 4.2e9 < total < 4.4e9


def test_flash_mla_calls_flops_and_bytes_by_hand():
    cfg = dict(_published(), num_hidden_layers=3)
    (c, n), = fam.calls(cfg, {"phase": "prefill", "rows": 2, "seq": 5})
    assert n == 3 and fam.PIECES == fa.PIECES
    assert (c["B"], c["H"], c["KV"], c["Tq"], c["Tk"], c["hd"], c["hdv"]) \
        == (2, 40, 40, 5, 5, 96, 64)
    assert (c["q_bytes"], c["kv_bytes"], c["window"]) == (2, 4, None)
    # 15 pairs a head (1 + ... + 5): q.k over 96 and p.v over 64
    assert fa.flops(c) == 2 * (96 + 64) * 2 * 40 * 15
    # q and the output (2 x 40 x 5 rows of 160 bf16 values); every head's
    # 5 keys of K and V (160 fp32 values)
    assert fa.nbytes(c) == 2 * 40 * 5 * 160 * 2 + 2 * 40 * 5 * 160 * 4
    assert fam.least_s(c, "bfloat16") == pytest.approx(max(
        fa.flops(c) / 989e12, fa.nbytes(c) / 3.35e12))
    assert fam.calls(cfg, {"phase": "decode", "rows": 2, "seq": 5,
                           "steps": 4}) == []


def _prefill_run(names, layers=3):
    """A traced prefill of the published widths at 2 x 4,096 tokens,
    each of ``names`` a 2-ms launch, and a decode trace of its own."""
    cfg = dict(_published(), num_hidden_layers=layers)
    events = [(n, 10_000.0 * i, 10_000.0 * i + 2_000.0)
              for i, n in enumerate(names)]
    work = {"phase": "prefill", "rows": 2, "seq": 4096}
    fwd = sum("flash_fwd" in n for n in names)
    segs = [{"name": "prefill", "events": events, "work": work,
             "faults": [] if fwd == layers
             else [f"flash_fwd x{fwd}, expected {layers}"]},
            {"name": "decode", "faults": [], "work": {"phase": "decode"},
             "events": [("flash_fwd_mma<float, 6, 4, true>", 0.0, 9e6)]}]
    return type("R", (), {"config": cfg, "segments": segs})()


def _least_share():
    cfg = dict(_published(), num_hidden_layers=3)
    ((c, _),) = fam.calls(cfg, {"phase": "prefill", "rows": 2, "seq": 4096})
    return 100.0 * fam.least_s(c, "bfloat16") / 2e-3


@pytest.mark.parametrize("names", [
    ["flash_fwd_mma<float, 6, 8, true>", "gemm"] * 3,
    ["flash_fwd_mma<float, 6, 8, true>", "gemm"] * 2,      # lost its last
    ["flash_fwd_mma<float, 6, 8, true>", "flash_combine<4>"] * 3],
    ids=["whole", "short_of_its_last_launch", "paired_combine"])
def test_flash_mla_roofline_reads_the_launches_the_trace_holds(names):
    """Each launch's least time over its 2 ms; a paired combine's 2 ms
    count with its call's (so the share halves); the decode's launch is
    read by nothing."""
    want = _least_share() / (2 if "flash_combine<4>" in names else 1)
    read = harness.reader("flash_attention_mla_roofline").read
    assert read(_prefill_run(names)) == pytest.approx(want)


@pytest.mark.parametrize("names", [
    [], ["gemm"], ["flash_fwd_mma<float, 6, 8, true>"] * 4,
    ["flash_fwd_mma<float, 6, 8, true>"] * 2 + ["flash_combine<4>"]],
    ids=["no_events", "no_launch", "more_launches_than_layers",
         "unpaired_combine"])
def test_flash_mla_roofline_reads_nothing(names):
    read = harness.reader("flash_attention_mla_roofline").read
    assert read(_prefill_run(names)) is None
    run = _prefill_run(["flash_fwd_mma<float, 6, 8, true>"])
    run.segments = run.segments[1:]                 # no prefill traced
    assert read(run) is None


# --------------------------------------------------------------------------
# the MLA span readers
# --------------------------------------------------------------------------

READERS = {"mla_expand_ms.serve": "mla.expand",
           "mla_attend_ms.serve": "mla.attend"}


def _traced_run():
    run = _run()
    run.t0 = 0.0
    run.segments = [{"name": n, "faults": [], "events": [], "units": 1,
                     "wall_s": 1.0, "work": {}} for n in ("prefill",
                                                          "decode")]
    return run


def _fill(steps, layers=3):
    """A prefill and ``steps`` decode steps, layer l of decode step t
    expanding for (t + 1)(l + 1) device ms and attending for a tenth of
    that; the prefill's spans 1 s each."""
    rec = trace.PROGRAM
    for t in range(-1, steps):
        phase = "prefill" if t < 0 else "decode"
        with rec.span("serve.step", phase=phase):
            for layer in range(layers):
                ms = 1000.0 if t < 0 else (t + 1.0) * (layer + 1)
                with rec.span("mla.expand", slots=7) as e:
                    pass
                e.device_ms = ms
                with rec.span("mla.attend") as a:
                    pass
                a.device_ms = ms / 10


@pytest.fixture
def program():
    trace.PROGRAM.reset()
    yield trace.PROGRAM
    trace.PROGRAM.reset()


@pytest.mark.parametrize("metric,want", [("mla_expand_ms.serve", 18.0),
                                         ("mla_attend_ms.serve", 1.8)])
def test_mla_readers(program, metric, want):
    """Each step sums its layers (6 (t + 1) ms), the median over 5 steps
    is step t = 2's; the prefill's spans are left out."""
    run = _traced_run()
    _fill(5)
    assert harness.reader(metric).read(run) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_mla_readers_find_nothing(program, metric, monkeypatch):
    run = _traced_run()
    assert harness.reader(metric).read(run) is None        # no spans
    with trace.PROGRAM.span("serve.step", phase="decode"):
        with trace.PROGRAM.span(READERS[metric]):
            pass                               # the CPU: no device marks
    assert harness.reader(metric).read(run) is None
    _fill(2)
    assert harness.reader(metric).read(run) is not None
    run.t0 = float("inf")                      # spans from before the run
    assert harness.reader(metric).read(run) is None
    run.t0 = 0.0
    run.segments = run.segments[:1]            # no decode trace ran
    assert harness.reader(metric).read(run) is None
    run = _traced_run()
    monkeypatch.delattr(trace, "PROGRAM")      # the parent's program
    assert harness.reader(metric).read(run) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_mla_readers_read_a_decode_trace_that_missed_kernels(program,
                                                             metric):
    """The spans' marks are CUDA events of their own: a decode trace that
    lost launches (ROADMAP E1) leaves them as they are."""
    run = _traced_run()
    run.segments[1]["faults"] = ["flash_fwd x927, expected 930"]
    _fill(5)
    assert harness.reader(metric).read(run) == pytest.approx(
        {"mla.expand": 18.0, "mla.attend": 1.8}[READERS[metric]])


@pytest.mark.parametrize("metric", sorted(READERS) +
                         ["flash_attention_mla_roofline"])
def test_entries_list_the_cell(metric):
    (m,) = [m for m in harness.benchmark()["per_layer"]
            if m["name"] == metric]
    assert m["workloads"] == [CELL]


@pytest.mark.parametrize("metric", ["idle_share.serve",
                                    "decode_dispatch_ms.serve",
                                    "decode_wait_ms.serve"])
def test_whole_decode_trace_metrics_leave_the_cell_out(metric):
    """These read only a whole decode trace, which the serving driver takes
    once: on this cell it misses launches in some runs (ROADMAP E1), and a
    listed metric must read in every traced run of its cells."""
    (m,) = [m for m in harness.benchmark()["per_layer"]
            if m["name"] == metric]
    assert CELL not in m["workloads"]
