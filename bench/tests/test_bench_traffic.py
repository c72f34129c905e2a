"""The traffic generator: the same seed gives the same traffic, another
seed other traffic over the same set of sizes."""

import numpy as np
import pytest

import tiny  # noqa: F401
from bench import harness, traffic

SEEDS = (0, 7, 2**31 + 11, 3141592653589)


def _mix(name):
    return harness.load_json(harness.BENCH / "mixes" / f"{name}.json")


@pytest.mark.parametrize("seed", SEEDS)
def test_train_same_seed_same_rows(seed):
    mix = _mix("train-4x2048")
    a = traffic.SyntheticLM(mix, 32000, seed).batch(5)
    b = traffic.SyntheticLM(mix, 32000, seed).batch(5)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert a["tokens"].shape == (mix["global_batch"], mix["seq_len"])
    assert a["tokens"].max() < 32000 and a["tokens"].min() >= 0
    assert np.array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


def test_train_seeds_and_steps_differ():
    mix = _mix("train-4x2048")
    a = traffic.SyntheticLM(mix, 32000, 1)
    b = traffic.SyntheticLM(mix, 32000, 2)
    assert not np.array_equal(a.batch(0)["tokens"], b.batch(0)["tokens"])
    assert not np.array_equal(a.batch(0)["tokens"], a.batch(1)["tokens"])
    rows = np.concatenate([a.batch(i)["tokens"] for i in range(3)])
    assert len({r.tobytes() for r in rows}) == len(rows)


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_same_seed_same_prompts(seed):
    mix = _mix("docqa")
    a, b = (traffic.ServeTraffic(mix, 32000, seed) for _ in range(2))
    for i in (0, 3, 9):
        for p, q in zip(a.batch(i), b.batch(i)):
            assert np.array_equal(p, q)


def test_serve_seeds_differ_over_the_same_sizes():
    mix = _mix("docqa")
    n = mix["cycle_batches"]
    a, b = (traffic.ServeTraffic(mix, 32000, s) for s in (1, 2))
    assert not np.array_equal(a.batch(0)[0], b.batch(0)[0])

    def cycle(t, c):
        return [sorted(t.lengths(c * n + i)) for i in range(n)]
    # every cycle of every seed serves the same sizes, one a request ...
    for t, c in ((a, 0), (a, 1), (b, 0)):
        assert sorted(np.concatenate(cycle(t, c))) == list(a.cycle)
    # ... which the seed deals into batches anew for each cycle
    assert cycle(a, 0) != cycle(b, 0) and cycle(a, 0) != cycle(a, 1)
    # one of the cycle's longest to each batch: every seed pads alike
    for t, c in ((a, 0), (a, 1), (b, 0)):
        assert sorted(x[-1] for x in cycle(t, c)) == list(a.cycle[-n:])


def test_serve_lengths_follow_the_source():
    """The cycle's median is the source's median prompt (1,500 tokens),
    and each answer its median output (13 tokens)."""
    mix = _mix("docqa")
    t = traffic.ServeTraffic(mix, 32000, 0)
    assert len(t.cycle) == mix["cycle_batches"] * mix["callers"]
    assert abs(np.median(t.cycle) - 1500) <= 15
    assert mix["new_tokens"] == 13 and "1,500" in mix["source"]


def test_serve_lengths_in_range_and_warm_is_longest():
    mix = _mix("docqa")
    t = traffic.ServeTraffic(mix, 32000, 5)
    lens = np.concatenate([t.lengths(i) for i in range(mix["cycle_batches"])])
    assert lens.min() >= mix["prompt_min"] and lens.max() <= mix["prompt_max"]
    assert lens.max() + mix["new_tokens"] - 1 <= mix["max_seq"]
    warm = t.warm_batch()
    assert len(warm) == mix["callers"]
    assert all(len(p) == lens.max() for p in warm)


def test_sample_holds_the_longest():
    mix = _mix("docqa")
    t = traffic.ServeTraffic(mix, 32000, 5)
    finished = [{"prompt": np.zeros(n), "tmax": 0, "served": []}
                for n in range(59, 9, -1)]
    finished[-1]["logits"] = finished[-2]["logits"] = "program's"
    s = t.sample(finished, 7)
    assert len(s) == 7 and max(len(f["prompt"]) for f in s) == 59
    assert sum("logits" in f for f in s) == 2
    assert t.sample(finished, 7) == s
