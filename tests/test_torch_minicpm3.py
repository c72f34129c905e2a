"""The port's minicpm3-4b, as published (MLA and MiniCPM's three
scalings), against the benchmark's plain reference
``bench/reference/mla.py``, on the CPU at ``arch.scaled()`` size.

The weights are the benchmark's own (``bench.weights.make`` of the
reference's ``layout``), cast to fp32 so that both sides round alike:

  * the prefill's logits;
  * a prefill, then decode steps through the fp32 latent cache, against
    the reference's full forward over the same slots (logits, not sampled
    tokens: with random weights the largest logit changes on rounding);
  * a ``Server.generate`` batch of right-padded prompts, scored by
    ``bench.reference.common.served_readings`` as the benchmark scores the
    card's runs;
  * for each scaling, the same prefill comparison failing where the port
    runs with that scaling neutral: the reference holds the port to all
    three.

``chip_smoke.py``'s decode check is also checked here: its tolerance
follows the head's division, so the divided logits are held as tightly as
undivided ones, and minicpm3's decode is held on an fp32 copy of the
weights, as zamba2's is, while danube's stays in bf16.

Tolerance: 1e-4 on the logits, as ``test_torch_models.py``'s: two fp32
implementations of the same arithmetic, their sums in another order (the
reference's attention by query blocks, the port's plain attention whole).
A neutral scaling must miss by 100 times that.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness, weights  # noqa: E402
from bench.reference import common, mla  # noqa: E402
from repro_torch.launch.serve import ServeConfig, Server  # noqa: E402
from repro_torch.models import forward, get_arch, make_caches  # noqa: E402

ARCH = "minicpm3-4b"
LOGIT_TOL = 1e-4
# MiniCPM's scalings; None, each field's default, adds no operation
SCALINGS = ("dim_model_base", "scale_depth", "scale_emb")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    """The benchmark's configuration file of minicpm3-4b with every field
    the port reads (its ``port_fields``) taken from ``arch``."""
    conf = {c["name"]: c for c in harness.benchmark()["configs"]}[ARCH]
    cfg = harness.load_json(harness.ROOT / conf["file"])
    cfg.update({key: getattr(arch, field)
                for key, field in cfg["port_fields"].items()})
    return cfg


def _setup(seed=11):
    arch = get_arch(ARCH).scaled()
    cfg = _cfg(arch)
    params = weights.tree_map(lambda t: t.float(),
                              weights.make(mla.layout(cfg), seed, "cpu"))
    return arch, cfg, params


def _ref_logits(cfg, params, tokens, positions, rows):
    with torch.no_grad():
        return common.logits(mla, params, cfg, tokens, positions, rows,
                             common.Precision("fp32"))


def _prefill_err(arch, cfg, params, T=40):
    tok = torch.randint(0, cfg["vocab_size"], (1, T),
                        generator=torch.Generator().manual_seed(1))
    pos = torch.arange(T)[None]
    with torch.no_grad():
        got, _, _ = forward(params, arch, tok, pos)
    want = _ref_logits(cfg, params, tok[0], pos[0], torch.arange(T))
    return float((got[0].float() - want).abs().max())


def test_published_scalings_are_registered():
    arch = get_arch(ARCH)
    assert (arch.scale_emb, arch.scale_depth, arch.dim_model_base,
            arch.max_seq_len) == (12.0, 1.4, 256, 32768)
    for name in ("h2o-danube-1.8b", "rwkv6-3b", "kimi-k2-1t-a32b"):
        other = get_arch(name)
        assert (other.scale_emb, other.scale_depth,
                other.dim_model_base) == (None, None, None)


def test_prefill_logits_match_the_reference():
    assert _prefill_err(*_setup()) < LOGIT_TOL


def test_decode_through_the_latent_cache_matches_a_full_forward():
    """Two rows prefilled at once, then decode steps at slot T + t,
    position T + t, each step's logits against the reference's full
    forward over the row's slots."""
    arch, cfg, params = _setup(12)
    B, T, steps, S = 2, 23, 6, 40
    g = torch.Generator().manual_seed(2)
    seq = torch.randint(0, cfg["vocab_size"], (B, T + steps), generator=g)
    caches = make_caches(arch, B, S, dtype=torch.float32)
    got = []
    with torch.no_grad():
        logits, caches, _ = forward(params, arch, seq[:, :T],
                                    torch.arange(T)[None].expand(B, T),
                                    caches=caches, cache_index=0)
        got.append(logits[:, -1])
        for t in range(steps - 1):
            pos = torch.full((B, 1), T + t)
            logits, caches, _ = forward(params, arch, seq[:, T + t:T + t + 1],
                                        pos, caches=caches,
                                        cache_index=T + t)
            got.append(logits[:, -1])
    assert caches["lat"].dtype == torch.float32
    got = torch.stack(got, dim=1)                 # (B, steps, vocab)
    n = T + steps - 1
    rows = torch.arange(T - 1, n)
    for b in range(B):
        want = _ref_logits(cfg, params, seq[b, :n], torch.arange(n), rows)
        torch.testing.assert_close(got[b].float(), want, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)


def test_server_generate_scored_as_the_benchmark_scores_it():
    """Right-padded prompts through ``Server.generate``: each served token
    is the reference's best on the served slots (a gap of rounding), and
    the step logits equal the reference's; the fp8 control misses by far
    more."""
    arch, cfg, params = _setup(13)
    server = Server(ServeConfig(arch=ARCH, max_batch=3, max_seq=48,
                                max_new_tokens=6), params=params, device="cpu")
    assert server.arch == arch
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg["vocab_size"], n).astype(np.int32)
               for n in (9, 26, 40)]
    outs = server.generate(prompts)
    reqs = [{"prompt": p, "tmax": 40, "served": o,
             "logits": torch.stack([s[i] for s in server.step_logits])}
            for i, (p, o) in enumerate(zip(prompts, outs))]
    got = common.served_readings(mla, cfg, params, reqs, "cpu")
    assert got["max_logit_gap"] < LOGIT_TOL
    assert got["max_logit_err"] < LOGIT_TOL
    ctl = common.served_readings(mla, cfg, params, reqs, "cpu",
                                 control=common.Precision("fp8"))
    assert ctl["max_logit_err"] > 10 * got["max_logit_err"]


@pytest.mark.parametrize("field", SCALINGS)
def test_a_neutral_scaling_fails_the_comparison(field):
    arch, cfg, params = _setup()
    neutral = dataclasses.replace(arch, **{field: None})
    assert _prefill_err(neutral, cfg, params) > 100 * LOGIT_TOL


@pytest.mark.parametrize("name, scale", [("h2o-danube-1.8b", 1.0),
                                         (ARCH, 10.0)])
def test_smoke_tolerance_follows_the_head_division(name, scale):
    import chip_smoke
    arch = get_arch(name)
    assert chip_smoke.head_scale(arch) == scale
    for peak in (0.3, 0.5, 2.0, 9.0):
        assert chip_smoke.logit_atol_of_head(peak, 62, arch) == pytest.approx(
            chip_smoke.logit_atol(peak * scale, 62) / scale)
    if scale != 1.0:
        # logits peaking near 0.5 once divided: held to a tenth of what
        # the undivided logits (near 5) are held to, not to the same 0.139
        assert chip_smoke.logit_atol_of_head(0.5, 62, arch) < 0.015
    assert chip_smoke._decode_checked_in_fp32(arch) == (scale != 1.0)
    assert chip_smoke._decode_checked_in_fp32(get_arch("zamba2-1.2b"))
