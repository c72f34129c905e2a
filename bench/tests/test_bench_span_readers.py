"""The ``program_span`` readers on the program's recorder filled by hand:
each reading, and nothing where the recorder holds no matching span, the
traced segment is not whole, or the spans predate the run."""

import pytest

from tiny import tiny_run
from bench import harness
from repro_torch.obs import trace

TRAIN, SERVE = "danube-train-4x2048", "danube-serve-docqa"


def _run(cell, units=3):
    """A run whose training trace kept ``units`` steps."""
    run = tiny_run(cell)
    run.segments = [{"name": n, "faults": [], "events": [], "units": units,
                     "wall_s": 1.0, "work": {}}
                    for n in (["train"] if cell == TRAIN
                              else ["prefill", "decode"])]
    return run


def _lasts(span, ms):
    """``span``'s host time set to ``ms``."""
    span.wall_end = span.wall_start + ms / 1e3


def _fill_train(steps, microbatches=2, first=1):
    """Recorded steps ``first``, ... ``steps``: forward k, backward 2k,
    optimizer 10k device ms and 100k host ms at step k (one forward and
    backward a microbatch)."""
    rec = trace.PROGRAM
    for k in range(first, steps + 1):
        with rec.span("train.step", step=k,
                      microbatches=microbatches) as st:
            for mb in range(microbatches):
                with rec.span("train.forward", microbatch=mb) as f:
                    pass
                f.device_ms = float(k)
                with rec.span("train.backward", microbatch=mb) as b:
                    pass
                b.device_ms = 2.0 * k
            with rec.span("train.optimizer") as o:
                for child in ("train.clip", "train.update", "train.apply"):
                    with rec.span(child):
                        pass
            o.device_ms = 10.0 * k
        _lasts(st, 100.0 * k)


def _fill_serve(steps):
    """A batch whose decode step t enqueues for t + 1 ms and waits
    (t + 1) / 10 ms; its prefill's step lasts 1 s."""
    rec = trace.PROGRAM
    with rec.span("serve.step", phase="prefill") as sp:
        pass
    _lasts(sp, 1000.0)
    for t in range(steps):
        with rec.span("serve.decode", t=t):
            with rec.span("serve.prep"):
                pass
            with rec.span("serve.step", phase="decode") as sp:
                pass
            _lasts(sp, t + 1.0)
            with rec.span("serve.sample") as sp:
                pass
            _lasts(sp, (t + 1.0) / 10)


@pytest.mark.parametrize("metric,want", [
    ("forward_ms.train", 4.0), ("backward_ms.train", 8.0),
    ("optimizer_ms.train", 20.0)])
def test_train_device_readers(metric, want):
    run = _run(TRAIN)
    _fill_train(3)            # medians of 2k, 4k and 10k over k = 1, 2, 3
    assert harness.reader(metric).read(run) == pytest.approx(want)


@pytest.mark.parametrize("metric,want", [
    ("forward_ms.train", 5.0), ("backward_ms.train", 10.0),
    ("optimizer_ms.train", 25.0)])
def test_train_readers_skip_a_discarded_try(metric, want):
    """The harness tried the trace twice and kept the second try: its 2
    steps (k = 2, 3) are read, not the first try's 3 (k = 1, 2, 3)."""
    run = _run(TRAIN, units=2)
    _fill_train(3)                                 # the discarded try
    _fill_train(3, first=2)                        # the kept one
    assert harness.reader(metric).read(run) == pytest.approx(want)


@pytest.mark.parametrize("metric,want", [
    ("decode_dispatch_ms.serve", 6.5), ("decode_wait_ms.serve", 0.65)])
def test_serve_readers(metric, want):
    """The medians of the 12 decode steps; the prefill's 1 s is left
    out."""
    run = _run(SERVE)
    _fill_serve(12)
    assert harness.reader(metric).read(run) == pytest.approx(want)


METRICS = ["forward_ms.train", "backward_ms.train", "optimizer_ms.train",
           "decode_dispatch_ms.serve", "decode_wait_ms.serve"]


def _cell(metric):
    return TRAIN if metric.endswith(".train") else SERVE


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_recorded_reads_none(metric):
    assert harness.reader(metric).read(_run(_cell(metric))) is None


@pytest.mark.parametrize("metric", METRICS)
def test_spans_before_the_run_or_of_a_broken_trace_read_none(metric):
    _fill_train(2)
    _fill_serve(3)
    run = _run(_cell(metric))
    assert harness.reader(metric).read(run) is None   # opened before t0
    run.t0 = 0.0
    assert harness.reader(metric).read(run) is not None
    for s in run.segments:
        s["faults"] = ["flash_fwd x1, expected 2"]
    assert harness.reader(metric).read(run) is None


def test_unmarked_steps_read_none():
    run = _run(TRAIN)
    with trace.PROGRAM.span("train.step"):
        with trace.PROGRAM.span("train.forward"):
            pass                       # on the CPU: no device marks
    assert harness.reader("forward_ms.train").read(run) is None


@pytest.mark.parametrize("metric", METRICS)
def test_a_program_without_a_recorder_reads_none(metric, monkeypatch):
    """The parent checkout's program, which keeps no spans."""
    run = _run(_cell(metric))
    _fill_train(1)
    _fill_serve(2)
    monkeypatch.delattr(trace, "PROGRAM")
    assert harness.reader(metric).read(run) is None


@pytest.mark.parametrize("metric", METRICS)
def test_entries_read_the_program(metric):
    (m,) = [m for m in harness.benchmark()["per_layer"]
            if m["name"] == metric]
    assert m["source"] == "program_span" and m["unit"] == "ms"
    assert m["workloads"] == [_cell(metric)]
