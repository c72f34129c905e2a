"""The plain references against the program's CPU path (its plain
kernels) at tiny widths, on the same weights: the model's logits, the
server's semantics (pads, slots and positions), the training steps, and
the seeded weights. The test imports
both sides; the references import nothing of the program."""

import numpy as np
import pytest
import torch

from tiny import tiny_config, tiny_run
from bench import weights
from bench.drivers import train as train_driver
from bench.reference import common, dense

FAMILIES = {"h2o-danube-1.8b": dense}


def _fp32(tree):
    return weights.tree_map(lambda t: t.float(), tree)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_logits_match_the_port(name):
    from repro_torch.models import forward, get_arch
    cfg = tiny_config(name)
    fam = FAMILIES[name]
    params = _fp32(weights.make(fam.layout(cfg), 11, "cpu"))
    T = 40
    tok = torch.randint(0, cfg["vocab_size"], (1, T),
                        generator=torch.Generator().manual_seed(1))
    pos = torch.arange(T)[None]
    want, _, _ = forward(params, get_arch(cfg["registry_name"]), tok, pos)
    rows = torch.arange(T)
    got = common.logits(fam, params, cfg, tok[0], pos[0], rows,
                        common.Precision("fp32"))
    torch.testing.assert_close(got, want[0].float(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_served_logits_match_the_server(name):
    """Every step's logits of ``Server.generate`` (right-padded prompts,
    decode at slot Tmax + t and position len + t) equal the reference's
    at the served sequence's rows."""
    from repro_torch.launch.serve import ServeConfig, Server
    cfg = tiny_config(name)
    fam = FAMILIES[name]
    params = _fp32(weights.make(fam.layout(cfg), 12, "cpu"))
    server = Server(ServeConfig(arch=cfg["registry_name"], scale="full",
                                max_batch=3, max_seq=40, max_new_tokens=5),
                    params=params, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg["vocab_size"], n).astype(np.int32)
               for n in (9, 17, 30)]
    outs = server.generate(prompts)
    for i, p in enumerate(prompts):
        req = {"prompt": p, "tmax": 30, "served": outs[i]}
        tok, pos, rows = common.served_sequence(req, "cpu")
        got = common.logits(fam, params, cfg, tok, pos, rows,
                            common.Precision("fp32"))
        want = torch.stack([s[i] for s in server.step_logits]).float()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # each served token is the reference's best there: gaps of rounding
    reqs = [{"prompt": p, "tmax": 30, "served": o,
             "logits": torch.stack([s[i] for s in server.step_logits])}
            for i, (p, o) in enumerate(zip(prompts, outs))]
    got = common.served_readings(fam, cfg, params, reqs, "cpu")
    assert got["max_logit_gap"] < 1e-4 and got["max_logit_err"] < 1e-4
    ctl = common.served_readings(fam, cfg, params, reqs, "cpu",
                                 control=common.Precision("fp8"))
    assert ctl["max_logit_err"] > 10 * got["max_logit_err"]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_training_steps_match_the_port(name):
    """Three of the port's train steps (fp32 weights, so that both sides
    round alike) against the reference's: losses, first gradients,
    changes."""
    run = tiny_run({"h2o-danube-1.8b": "danube-train-4x2048"}[name])
    fam = FAMILIES[name]
    layout = weights.tree_map(
        lambda leaf: weights.Leaf(leaf.shape, "float32", leaf.mean,
                                  leaf.std), fam.layout(run.config))
    orig = fam.layout
    fam.layout = lambda cfg: layout
    try:
        prog = train_driver.prepare(run)
        got = prog.checked_steps(run)
        prog.close()
        want = train_driver.reference_readings(run, "fp32")
    finally:
        fam.layout = orig
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(got["change_norms"], want["change_norms"],
                               rtol=2e-2, atol=1e-6)


def test_weights_same_seed_same_bits_and_change_norms():
    cfg = tiny_config("h2o-danube-1.8b")
    lay = dense.layout(cfg)
    a, b = weights.make(lay, 5, "cpu"), weights.make(lay, 5, "cpu")
    c = weights.make(lay, 6, "cpu")
    la, lb, lc = (weights.leaves(t) for t in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(la[0], lc[0])
    assert [x.dtype for x in la] == [getattr(torch, s.dtype)
                                     for s in weights.leaves(lay)]
    assert weights.change_norms(lay, 5, a, "cpu") == [0.0] * len(la)
    with torch.no_grad():
        la[3].view(-1)[7] += 1.0
    ch = weights.change_norms(lay, 5, a, "cpu")
    assert ch[3] == pytest.approx(1.0, rel=1e-2) and sum(ch) == ch[3]


def test_weights_across_draws(monkeypatch):
    """A leaf split between two draws is drawn and checked alike."""
    monkeypatch.setattr(weights, "CHUNK", 1000)
    lay = {"a": weights.Leaf((37, 61)), "b": weights.Leaf((13,), "float32",
                                                          1.0, 0.0)}
    p = weights.make(lay, 9, "cpu")
    assert torch.equal(p["b"], torch.ones(13))
    assert weights.change_norms(lay, 9, p, "cpu") == [0.0, 0.0]
