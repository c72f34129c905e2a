"""The comparison that decides ``correct`` catches each fault a cell can
have: the harness's look for a chip skipped, the rest of a run driven at
tiny widths on the CPU with the timed path broken underneath. Limits are
set as the cells' are, between a sound run's readings and the fault's:
here four times the sound run's, so that a sound run passes them."""

import numpy as np
import pytest
import torch

from tiny import tiny_run
from bench import harness
import bench.control as control

TRAIN = ["danube-train-4x2048"]
SERVE = ["danube-serve-docqa"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unchanged_state(mp):
    """The step computes its loss and returns params and optimizer state
    as they were."""
    import repro_torch.launch.specs as specs
    from repro_torch.optim.optimizers import Optimizer, tree_map
    make = specs.make_optimizer

    def broken(*a, **kw):
        opt = make(*a, **kw)
        return Optimizer(opt.init, lambda g, s, p, step: (
            tree_map(torch.zeros_like, g), s))
    mp.setattr(specs, "make_optimizer", broken)


def _half_batch(mp):
    """Half of each batch left out, the mean taken over the rest."""
    import repro_torch.launch.specs as specs
    make = specs.make_train_step

    def broken(arch, policy, optimizer):
        policy.microbatch = max(1, getattr(policy, "microbatch", 1) // 2)
        step = make(arch, policy, optimizer)

        def half(params, opt_state, i, batch):
            n = next(iter(batch.values())).shape[0] // 2
            return step(params, opt_state, i,
                        {k: v[:n] for k, v in batch.items()})
        return half
    mp.setattr(specs, "make_train_step", broken)


def _altered_token(mp):
    """A served token altered where it is produced."""
    from repro_torch.launch.serve import Server
    generate = Server.generate

    def broken(self, prompts):
        outs = generate(self, prompts)
        for o in outs:
            o[2] = (o[2] + 1) % self.arch.vocab_size
        return outs
    mp.setattr(Server, "generate", broken)


def _unchanged_cache(mp):
    """Each decode step returns the cache as it found it."""
    from repro_torch.launch.serve import Server
    step = Server._step

    def broken(self, caches, cache_index, tokens, positions):
        if cache_index == 0:
            return step(self, caches, cache_index, tokens, positions)
        kept = {k: v.clone() for k, v in caches.items()}
        logits, _ = step(self, caches, cache_index, tokens, positions)
        for k, v in kept.items():
            caches[k].copy_(v)
        return logits, caches
    mp.setattr(Server, "_step", broken)


CASES = [(c, f) for c in TRAIN for f in (_unchanged_state, _half_batch)] \
    + [(c, f) for c in SERVE for f in (_altered_token, _unchanged_cache)]


def _execute(run):
    out = harness.execute(run, harness.benchmark())
    return out["correct"], {k: v["value"] for k, v in out["checks"].items()}


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in CASES])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    ok, sound = _execute(tiny_run(cell, seed=21, seconds=1e-9))
    limits = {k: 4 * v + 1e-6 for k, v in sound.items()}
    run = tiny_run(cell, seed=21, seconds=1e-9)
    run.limits = limits
    assert _execute(run)[0]
    fault(monkeypatch)
    run = tiny_run(cell, seed=21, seconds=1e-9)
    run.limits = limits
    ok, got = _execute(run)
    assert not ok, (sound, got)


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_control_reads_above_the_program(cell):
    """The control (the reference in float8 in the program's place, and a
    training cell's half batch) fails a number the program passes, by
    three times or more, at tiny widths as on the card."""
    run = tiny_run(cell, seed=8)
    if run.mix["kind"] == "serve":
        run.mix.update(new_tokens=12, sample_requests=12)
    out = control.readings(run, control=True)
    prog = out["program"]
    for what in [k for k in ("control_fp8", "half_batch") if k in out]:
        assert any(out[what][k] >= 3 * prog[k] and out[what][k] > 0
                   for k in prog), (what, out)
    assert np.isfinite(list(prog.values())).all()


@pytest.mark.parametrize("fault", ["steps", "early_decode"])
def test_serve_clock_refuses_another_step_pattern(fault, monkeypatch):
    """The time to the first token is read at the start of the server's
    second step: a server that steps another number of times, or starts
    decoding before its prefill's tokens are on the host, stops the run."""
    from repro_torch.launch.serve import Server
    generate = Server.generate

    def broken(self, prompts):
        outs = generate(self, prompts)
        if fault == "steps":
            self.stamps.pop()
        else:
            self.timing["prefill_s"] += 60.0
        return outs
    monkeypatch.setattr(Server, "generate", broken)
    with pytest.raises(RuntimeError, match="step|prefill"):
        harness.execute(tiny_run("danube-serve-docqa", seed=21,
                                 seconds=1e-9), harness.benchmark())
