"""Serving cells: the port's ``launch.serve.Server.generate`` in a closed
loop of ``callers`` callers, each batch formed from their pending requests
(``traffic.ServeTraffic``), greedy, on the server's fp32 cache.

Set-up draws the weights on the card from the seed, builds the server on
them and serves one batch of the mix's longest prompts (the largest shape
of the cell). The window serves batch after batch for ``--seconds``. The
benchmark's own clock stamps each call of the server's step: a request's
time to its first token runs from its hand-off to ``generate`` to the
start of the first decode step, which the server makes only once the
prefill's tokens are on the host. A batch whose server steps another
number of times, or starts its first decode step before the end of the
prefill as ``Server.timing`` gives it (the tokens on the host), stops the
run rather than read another interval.

After the window a sample of the finished requests, drawn from the seed
with the longest among them, is held to the plain reference: the widest
gap between the reference's best logit and its logit of a served token.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

from bench import tracing, traffic, weights
from bench.harness import Run, judge, reference
from bench.reference import common
from .train import _memory, _sync, check_arch


def _server_class(Server):
    class TimedServer(Server):
        """The port's server with the benchmark's clock on each step."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.stamps: List[float] = []
            self.tracer = None

        def _step(self, caches, cache_index, tokens, positions):
            self.stamps.append(time.perf_counter())
            call = lambda: super(TimedServer, self)._step(  # noqa: E731
                caches, cache_index, tokens, positions)
            if self.tracer is not None:
                return self.tracer.step(len(self.stamps) - 1, call)
            return call()
    return TimedServer


class ServeTrace:
    """Two traces of one batch: its prefill (the server's first step) and
    its decode steps (from the second step to the end of ``generate``)."""

    def __init__(self, run: Run, tmax: int, device):
        self.run, self.tmax, self.dev = run, tmax, device
        self.decode = None
        self.segments = []

    def _expect(self, phase: str, units: int) -> Dict[str, int]:
        per = self.run.config["num_hidden_layers"] * units
        return {piece: n * per for piece, n in
                self.run.config["trace_expect"][phase].items()}

    def step(self, i: int, call):
        if i == 0:
            s = tracing.Session(self.dev)
            out = call()
            wall, events = s.close()
            self.segments.append(tracing.segment(
                "prefill", wall, events, 1,
                {"phase": "prefill", "rows": self.run.mix["callers"],
                 "seq": self.tmax}, self._expect("prefill", 1), False))
            return out
        if i == 1:
            self.decode = tracing.Session(self.dev)
        return call()

    def finish(self):
        wall, events = self.decode.close()
        steps = self.run.mix["new_tokens"] - 1
        self.segments.append(tracing.segment(
            "decode", wall, events, steps,
            {"phase": "decode", "rows": self.run.mix["callers"],
             "seq": self.tmax, "steps": steps},
            self._expect("decode", steps), False))
        return self.segments


class Program:
    def __init__(self, run: Run):
        import torch
        from repro_torch.launch.serve import ServeConfig, Server
        from repro_torch.models import get_arch

        cfg, mix = run.config, run.mix
        self.dev = torch.device(run.device)
        check_arch(get_arch(cfg["registry_name"]), cfg)
        fam = reference(cfg["reference"])
        params = weights.make(fam.layout(cfg), run.seed, self.dev)
        self.server = _server_class(Server)(
            ServeConfig(arch=cfg["registry_name"], scale="full",
                        max_batch=mix["callers"], max_seq=mix["max_seq"],
                        max_new_tokens=mix["new_tokens"]),
            params=params, device=self.dev)
        self.traffic = traffic.ServeTraffic(mix, cfg["vocab_size"], run.seed)

    def serve(self, prompts) -> Dict:
        """One batch: its outputs and the benchmark's clock around it."""
        s = self.server
        s.stamps = []
        t0 = time.perf_counter()
        outs = s.generate(prompts)
        t1 = time.perf_counter()
        st, new = s.stamps, self.server.cfg.max_new_tokens
        if len(st) != new:
            raise RuntimeError(
                f"the server stepped {len(st)} times for {new} tokens: the "
                "benchmark reads a batch's first tokens at the start of its "
                "second step (one prefill, then one step a further token)")
        first = st[1] if new > 1 else t1
        prefill_s = s.timing.get("prefill_s")
        if prefill_s is None or first - t0 < prefill_s:
            raise RuntimeError(
                f"the first decode step began {first - t0!r} s after the "
                f"hand-off, before the prefill's tokens reached the host "
                f"(Server.timing prefill_s {prefill_s!r})")
        return {"outs": outs, "handoff": t0, "done": t1,
                "ttft_s": first - t0,
                "decode_step_s": [b - a for a, b in zip(st[1:], st[2:] + [t1])],
                "lengths": [len(p) for p in prompts]}


def prepare(run: Run) -> Program:
    t = time.perf_counter()
    prog = Program(run)
    t1 = time.perf_counter()
    prog.serve(prog.traffic.warm_batch())
    _sync(prog.dev)
    run.host["setup_parts_s"] = {"before": t - run.t0, "build": t1 - t,
                                 "warm_batch": time.perf_counter() - t1}
    return prog


def run(run: Run) -> None:
    import torch
    prog = prepare(run)
    run.setup_s = time.perf_counter() - run.t0
    finished = window(run, prog)
    if run.trace:
        trace(run, prog)
    del prog
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t = time.perf_counter()
    values = readings(run, finished)
    run.host["reference_s"] = time.perf_counter() - t
    run.correct, run.checks = judge(values, run.limits)


def window(run: Run, prog: Program, batches=None) -> List[Dict]:
    """Batches back to back for ``--seconds`` (or ``batches`` of them):
    the finished requests (prompt, the batch's longest prompt, served
    tokens)."""
    import torch
    run.memory["setup_peak_bytes"] = _memory(prog.dev)
    if prog.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(prog.dev)
    records, finished = [], []
    new = run.mix["new_tokens"]
    t0 = time.perf_counter()
    i = 0
    while (not i or time.perf_counter() - t0 < run.seconds) \
            if batches is None else i < batches:
        prompts = prog.traffic.batch(i)
        rec = prog.serve(prompts)
        tmax = max(rec["lengths"])
        for p, o in zip(prompts, rec.pop("outs")):
            finished.append({"prompt": p, "tmax": tmax, "served": o})
            run.attempted += 1
            run.failed += len(o) != new
        records.append(rec)
        i += 1
    wall = time.perf_counter() - t0
    run.memory["window_peak_bytes"] = _memory(prog.dev)
    # the last batch's step logits, the program's own outputs, one row a
    # served token of each request
    steps = prog.server.step_logits
    for j, f in enumerate(finished[-len(prompts):]):
        f["logits"] = torch.stack([s[j] for s in steps])
    run.host.update(batches=records, window_s=wall,
                    tokens=sum(len(f["served"]) for f in finished))
    return finished


def trace(run: Run, prog: Program) -> None:
    i = len(run.host["batches"])
    prompts = prog.traffic.batch(i)
    t = ServeTrace(run, max(len(p) for p in prompts), prog.dev)
    prog.server.stamps = []
    prog.server.tracer = t
    try:
        prog.server.generate(prompts)
    finally:
        prog.server.tracer = None
    run.segments.extend(t.finish())


def readings(run: Run, finished: List[Dict], control: str = None) -> Dict:
    """The sample's numbers against the reference (with ``control``, the
    reference in that precision in the program's place)."""
    import torch
    dev = torch.device(run.device)
    fam = reference(run.config["reference"])
    params = weights.make(fam.layout(run.config), run.seed, dev)
    sample = traffic.ServeTraffic(run.mix, run.config["vocab_size"],
                                  run.seed).sample(
        finished, run.mix["sample_requests"])
    out = common.served_readings(fam, run.config, params, sample, dev,
                                 None if control is None
                                 else common.Precision(control))
    del params
    gc.collect()
    return out
