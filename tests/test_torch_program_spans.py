"""The spans of the port's LM paths in the process-wide program recorder
(``repro_torch.obs.trace.PROGRAM``), on the CPU at the smoke sizes:

  * ``Server.generate`` records its prefill's ``serve.step`` and one
    ``serve.decode`` a further token holding ``serve.prep``,
    ``serve.step`` and ``serve.sample``, well nested on both clocks;
  * a train step records ``train.forward`` and ``train.backward`` once a
    microbatch and ``train.optimizer`` with ``train.clip``,
    ``train.update`` and ``train.apply``; the prefetcher's ``data.wait``;
  * ``"profiler"`` with no profiler, or with one in its warm-up step,
    records nothing and allocates no span; the tokens, the step logits
    and the parameters after a step are bit-identical to ``"on"``'s;
  * ``"profiler"`` records only while a profiler records, and a child
    whose parent was not recorded is a root;
  * the spans' ``start_ns``/``end_ns`` are on the profiler's clock;
  * the recorder keeps the newest root spans only.

The one test marked ``cuda`` runs a train step on the card: every phase
has a positive ``device_ms`` and the phases fit inside the step's.
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            schedule)

from repro_torch.data import PipelineConfig, Prefetcher, SyntheticLM
from repro_torch.launch.serve import ServeConfig, Server
from repro_torch.launch.specs import make_optimizer, make_train_step
from repro_torch.models import get_arch, init_params
from repro_torch.models.layers import NullPolicy
from repro_torch.obs import trace
from repro_torch.optim.optimizers import tree_leaves

ARCH = "h2o-danube-1.8b"
NEW_TOKENS = 4


@pytest.fixture
def program():
    """The program recorder, emptied, its mode restored afterwards."""
    before = trace.program_tracing()
    trace.PROGRAM.reset()
    yield trace.PROGRAM
    trace.program_tracing(before)
    trace.PROGRAM.reset()


def _serve(mode, device="cpu"):
    trace.program_tracing(mode)
    server = Server(ServeConfig(arch=ARCH, max_new_tokens=NEW_TOKENS,
                                max_seq=32), device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, server.arch.vocab_size, n).astype(np.int32)
               for n in (5, 9, 7)]
    outs = server.generate(prompts)
    return outs, [s.cpu() for s in server.step_logits]


def _train(mode, microbatches=1, device="cpu"):
    """One train step at step 5 (past the warmup's zero rate), its batch
    through the prefetcher: the parameters after it."""
    trace.program_tracing(mode)
    cfg = get_arch(ARCH).scaled()
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    opt = make_optimizer(cfg)
    policy = NullPolicy()
    policy.microbatch = microbatches
    feed = Prefetcher(SyntheticLM(PipelineConfig(
        global_batch=4, seq_len=16, vocab_size=cfg.vocab_size)))
    try:
        batch = {k: torch.from_numpy(v.copy()).to(device)
                 for k, v in feed.get().items()}
    finally:
        feed.close()
    new, _, _, metrics = make_train_step(cfg, policy, opt)(
        params, opt.init(params), 5, batch)
    return new, metrics


def _names(spans):
    return [s.name for s in spans]


UNRECORDED = ["no profiler", "profiler warming up"]


@contextlib.contextmanager
def _unrecorded(when):
    """A stretch in which ``"profiler"`` mode records nothing: no
    profiler, or one in its warm-up step (as the benchmark's traces open
    theirs)."""
    if when == "no profiler":
        yield
        return
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    prof.start()
    try:
        yield
    finally:
        prof.stop()


def test_generate_records_its_prefill_and_each_decode_step(program):
    _serve("on")
    prefill, *decode = program.roots
    assert program.well_nested()
    assert prefill.name == "serve.step" and not prefill.children
    assert prefill.attrs == {"phase": "prefill"}
    assert _names(decode) == ["serve.decode"] * (NEW_TOKENS - 1)
    for t, d in enumerate(decode):
        assert d.attrs == {"t": t}
        assert _names(d.children) == ["serve.prep", "serve.step",
                                      "serve.sample"]
        assert [c.attrs for c in d.children] == \
            [{}, {"phase": "decode"}, {}]
    for s in program.spans():
        assert s.start_ns <= s.end_ns and s.device_ms is None
        for c in s.children:
            assert s.start_ns <= c.start_ns <= c.end_ns <= s.end_ns


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_records_each_phase(program, microbatches):
    _train("on", microbatches)
    wait, step = program.roots
    assert wait.name == "data.wait" and wait.attrs == {"index": 0}
    assert step.name == "train.step" and program.well_nested()
    assert step.attrs == {"step": 5, "microbatches": microbatches}
    *grads, opt = step.children
    assert _names(grads) == ["train.forward", "train.backward"] * microbatches
    assert [g.attrs["microbatch"] for g in grads] == \
        [i for i in range(microbatches) for _ in range(2)]
    assert opt.name == "train.optimizer"
    assert _names(opt.children) == ["train.clip", "train.update",
                                    "train.apply"]
    assert all(s.device_ms is None for s in program.spans())   # the CPU


@pytest.mark.parametrize("when", UNRECORDED)
def test_unrecorded_spans_record_nothing_and_change_nothing(program, when):
    with _unrecorded(when):
        outs, logits = _serve("profiler")
        params, metrics = _train("profiler", 2)
    assert not program.roots
    on_outs, on_logits = _serve("on")
    on_params, on_metrics = _train("on", 2)
    assert program.roots
    assert outs == on_outs
    for a, b in zip(logits, on_logits, strict=True):
        assert torch.equal(a, b)
    assert torch.equal(metrics["loss"], on_metrics["loss"])
    for a, b in zip(tree_leaves(params), tree_leaves(on_params),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("when", UNRECORDED)
def test_an_unrecorded_span_allocates_nothing(program, when):
    trace.program_tracing("profiler")
    with _unrecorded(when):
        a = trace.program_span("a")
        b = trace.program_span("b", torch.ones(1))
        assert a is b
        with a as sp:
            sp.attrs["t"] = 1
    assert not program.roots
    for mode in ("off", "sometimes"):
        with pytest.raises(ValueError, match="mode"):
            trace.program_tracing(mode)


def test_profiler_mode_records_only_while_a_profiler_records(program):
    trace.program_tracing("profiler")
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    with trace.program_span("before"):
        prof.start()                          # its warm-up step
        with trace.program_span("warmup"):
            pass
        prof.step()                           # recording
        with trace.program_span("recorded") as sp:
            with trace.program_span("child"):
                pass
        prof.step()
        prof.stop()
        with trace.program_span("after"):
            pass
    assert _names(program.spans()) == ["recorded", "child"]
    assert list(program.roots) == [sp]    # its parent was not recorded


def test_spans_share_the_profilers_clock(program):
    """A ``record_function`` range opened inside a span lies inside the
    span's ``start_ns``/``end_ns`` on the trace's absolute clock."""
    trace.program_tracing("profiler")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.program_span("outer") as sp:
            with record_function("probe"):
                torch.ones(64).sum()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    (probe,) = [e for e in prof.events() if e.name == "probe"]
    start = t0 + probe.time_range.start * 1e3
    end = t0 + probe.time_range.end * 1e3
    assert sp.start_ns <= start <= end <= sp.end_ns


def test_relational_tracer_spans_carry_the_profilers_clock():
    tracer = trace.Tracer()
    with tracer.span("compile"):
        tracer.event("round")
    outer, inner = tracer.to_dicts()
    assert outer["start_ns"] <= inner["start_ns"] == inner["end_ns"] \
        <= outer["end_ns"]


def test_the_recorder_keeps_the_newest_spans(program):
    rec = trace.ProgramRecorder(capacity=4)
    for i in range(6):
        with rec.span(f"root{i}"):
            with rec.span(f"child{i}"):
                pass
    assert _names(rec.roots) == ["root2", "root3", "root4", "root5"]
    assert _names(rec.spans())[:2] == ["root2", "child2"]
    trace.program_tracing("on")
    for _ in range(trace.PROGRAM_CAPACITY + 10):
        with trace.program_span("x"):
            pass
    assert len(program.roots) == trace.PROGRAM_CAPACITY == 100_000


@pytest.mark.cuda
def test_train_step_device_marks_on_the_card(program):
    """Every phase of a train step on the card has a positive
    ``device_ms``, and the phases' sum lies within the step's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    _train("on", 2, device="cuda")
    (step,) = program.spans("train.step")
    ms = [(s.name, s.device_ms) for s in program.spans()
          if s.name != "data.wait"]
    assert len(ms) == 9 and all(v is not None and v > 0 for _, v in ms), ms
    phases = sum(c.device_ms for c in step.children)
    assert phases <= step.device_ms
    opt = program.spans("train.optimizer")[0]
    assert sum(c.device_ms for c in opt.children) <= opt.device_ms
