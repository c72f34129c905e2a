"""Training cells: the port's train step (``launch.specs.make_train_step``
under a ``NullPolicy`` with the configuration's microbatch, the optimizer
of ``make_optimizer``), fed through the port's ``data.Prefetcher`` from
the benchmark's own ``traffic.SyntheticLM``, as ``launch.train.train``
drives it, without checkpoints.

Set-up draws the weights on the card from the seed, builds the step and
the optimizer state, and drives that same step through the mix's
``checked_steps`` first steps (which also build and warm every kernel):
their losses, each leaf's gradient at the first step (from AdamW's first
moment, m = (1 - b1) g) and each leaf's change after the last are what
the reference is held to. The window then runs the same step back to back
for ``--seconds`` and ends in a synchronize.
"""

from __future__ import annotations

import gc
import time

from bench import tracing, traffic, weights
from bench.harness import Run, judge, reference
from bench.reference import common

def check_arch(arch, cfg) -> None:
    """The program runs the configuration as the file states it."""
    for key, field in cfg["port_fields"].items():
        if getattr(arch, field) != cfg[key]:
            raise RuntimeError(f"the port's configuration departs from the "
                               f"file: {field} = "
                               f"{getattr(arch, field)!r}, {key} = {cfg[key]!r}")


class Program:
    """The program's state for one run: weights, optimizer, step, feed."""

    def __init__(self, run: Run):
        import torch
        from repro_torch.data import Prefetcher
        from repro_torch.launch.specs import make_optimizer, make_train_step
        from repro_torch.models import get_arch
        from repro_torch.models.layers import NullPolicy

        cfg, mix = run.config, run.mix
        self.dev = torch.device(run.device)
        self.arch = get_arch(cfg["registry_name"])
        check_arch(self.arch, cfg)
        self.fam = reference(cfg["reference"])
        self.layout = self.fam.layout(cfg)
        self.params = weights.make(self.layout, run.seed, self.dev)
        opt = mix["optimizer"]
        self.optimizer = make_optimizer(self.arch,
                                        total_steps=opt["total_steps"])
        policy = NullPolicy()
        policy.microbatch = cfg["fits"]["train_microbatch"]
        self.step_fn = make_train_step(self.arch, policy, self.optimizer)
        self.opt_state = self.optimizer.init(self.params)
        self.step = 0
        self.source = traffic.SyntheticLM(mix, cfg["vocab_size"], run.seed)
        self.feed = Prefetcher(self.source)

    def one_step(self):
        import torch
        batch = {k: torch.from_numpy(v.copy()).to(self.dev)
                 for k, v in self.feed.get().items()}
        self.params, self.opt_state, self.step, metrics = self.step_fn(
            self.params, self.opt_state, self.step, batch)
        return metrics

    def checked_steps(self, run: Run) -> dict:
        """The first steps and what they leave for the comparison."""
        import torch
        b1 = run.mix["optimizer"]["b1"]
        losses, grads = [], None
        for s in range(run.mix["checked_steps"]):
            losses.append(float(self.one_step()["loss"]))
            if s == 0:
                m = weights.leaves(self.opt_state["m"])
                grads = [x / (1 - b1) for x in
                         torch.stack([t.float().norm() for t in m]).tolist()]
        change = weights.change_norms(self.layout, run.seed, self.params,
                                      self.dev)
        return {"losses": losses, "grad_norms": grads,
                "change_norms": change}

    def close(self) -> None:
        self.feed.close()


def prepare(run: Run) -> Program:
    return Program(run)


def run(run: Run) -> None:
    import torch
    t = time.perf_counter()
    prog = prepare(run)
    t1 = time.perf_counter()
    got = prog.checked_steps(run)
    _sync(prog.dev)
    run.setup_s = time.perf_counter() - run.t0
    run.host["setup_parts_s"] = {"before": t - run.t0, "build": t1 - t,
                                 "checked_steps": time.perf_counter() - t1}
    window(run, prog)
    if run.trace:
        trace(run, prog)
    prog.close()
    del prog
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    t = time.perf_counter()
    values = compare(got, reference_readings(run, "fp32"))
    run.host["reference_s"] = time.perf_counter() - t
    run.correct, run.checks = judge(values, run.limits)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _memory(dev) -> int:
    import torch
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def window(run: Run, prog: Program) -> None:
    import torch
    mix = run.mix
    run.memory["setup_peak_bytes"] = _memory(prog.dev)
    if prog.dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(prog.dev)
    losses = []
    _sync(prog.dev)
    t0 = time.perf_counter()
    while not losses or time.perf_counter() - t0 < run.seconds:
        losses.append(prog.one_step()["loss"])
    _sync(prog.dev)
    wall = time.perf_counter() - t0
    run.memory["window_peak_bytes"] = _memory(prog.dev)
    finite = int(torch.isfinite(torch.stack(losses).float()).sum())
    run.attempted, run.failed = len(losses), len(losses) - finite
    run.host.update(steps=len(losses), window_s=wall,
                    tokens_per_step=mix["global_batch"] * mix["seq_len"])


def work(run: Run, units: int) -> dict:
    return {"phase": "train", "rows": run.mix["global_batch"],
            "seq": run.mix["seq_len"], "units": units,
            "microbatch": run.config["fits"]["train_microbatch"]}


def trace(run: Run, prog: Program) -> None:
    units = run.mix["trace_steps"]
    per = run.config["num_hidden_layers"] \
        * run.config["fits"]["train_microbatch"] * units
    expect = {piece: n * per
              for piece, n in run.config["trace_expect"]["train"].items()}
    run.segments.append(tracing.trace_units(
        "train", prog.one_step, units, work(run, units), expect, prog.dev))


def reference_readings(run: Run, precision: str, rows=None) -> dict:
    """The plain model's first steps from the same weights and batches:
    losses, first gradients and changes (each leaf's norm)."""
    import torch
    dev = torch.device(run.device)
    fam = reference(run.config["reference"])
    layout = fam.layout(run.config)
    source = traffic.SyntheticLM(run.mix, run.config["vocab_size"], run.seed)
    batches = [source.batch(i) for i in range(run.mix["checked_steps"])]
    params = weights.make(layout, run.seed, dev)
    out = common.train(fam, run.config, run.mix["optimizer"], params,
                       batches, common.Precision(precision), rows=rows)
    out["change_norms"] = weights.change_norms(layout, run.seed, params, dev)
    del params
    gc.collect()
    return out


def compare(got: dict, want: dict) -> dict:
    """The numbers compared, each a gap between the program and the
    reference (see ``cells/<workload>.json`` for their limits)."""
    values = {f"loss_gap.step{i + 1}": abs(a - b)
              for i, (a, b) in enumerate(zip(got["losses"], want["losses"]))}
    values["grad_norm_gap"] = common.worst_leaf(got["grad_norms"],
                                                want["grad_norms"])
    keep = common.movable(want["grad_norms"])
    values["change_norm_gap"] = common.worst_leaf(
        got["change_norms"], want["change_norms"], keep=keep)
    values["change_norm_gap.median_leaf"] = common.median_leaf(
        got["change_norms"], want["change_norms"], keep=keep)
    return values
