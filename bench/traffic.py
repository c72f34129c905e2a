"""The one traffic generator: every mix in ``mixes/`` is parameters it
reads, and ``--seed`` draws everything that varies.

* ``train`` mixes: :class:`SyntheticLM`, a copy of the port's
  ``data.SyntheticLM`` generator (each row an arithmetic token sequence
  with ``noise`` of its tokens drawn at random, labels the next token),
  seeded by ``--seed``: rows that all differ, of a fixed shape.
* ``serve`` mixes: :class:`ServeTraffic`, a closed loop of ``callers``
  callers whose pending requests form each batch. A cycle of
  ``cycle_batches`` batches serves the same set of prompt lengths for
  every seed: the quantiles ``(j + 1/2) / n`` of ``length_dist`` over
  ``prompt_min``..``prompt_max``, one a request of the cycle. ``--seed``
  draws, for each cycle anew, which requests share a batch, and the token
  ids, uniformly over the vocabulary. It deals the lengths in strata of
  ``cycle_batches`` neighbours, one of each stratum to each batch: so each
  batch holds one of the cycle's longest prompts, and every seed pads its
  cycles alike (the same work, in other batches).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# streams of a seed
_TOKENS, _ORDER, _WARM, _SAMPLE = 1, 2, 3, 4


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), *stream]))


class SyntheticLM:
    """Batch ``index`` of a train mix, a pure function of (seed, index)."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        self.B, self.T = mix["global_batch"], mix["seq_len"]
        self.noise, self.vocab, self.seed = mix["noise"], vocab, seed

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed % (1 << 64), index, 0, 1]))
        B, T, V = self.B, self.T, self.vocab
        b = rng.integers(0, 2, (B, 1))
        t0 = rng.integers(0, V, (B, 1))
        steps = np.arange(T)[None, :]
        toks = (t0 + b * steps) % V
        noise = rng.random((B, T)) < self.noise
        toks = np.where(noise, rng.integers(0, V, (B, T)), toks)
        toks = toks.astype(np.int32)
        labels = np.concatenate([toks[:, 1:], toks[:, :1]],
                                axis=1).astype(np.int32)
        return {"tokens": toks, "labels": labels,
                "positions": np.broadcast_to(steps, (B, T)).astype(np.int32)}


def _lengths(mix: Dict, n: int) -> np.ndarray:
    """The ``n`` prompt lengths of a cycle: ``length_dist``'s quantiles at
    ``(j + 1/2) / n``, in ascending order."""
    lo, hi = mix["prompt_min"], mix["prompt_max"]
    if mix["length_dist"] != "log_uniform":
        raise ValueError(f"length_dist {mix['length_dist']!r}")
    q = (np.arange(n) + 0.5) / n
    x = np.exp(np.log(lo) + q * (np.log(hi + 1) - np.log(lo)))
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


class ServeTraffic:
    """The prompts of batch ``i`` of a serve mix, as the server takes them
    (int32 token arrays)."""

    def __init__(self, mix: Dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        self.callers, self.batches = mix["callers"], mix["cycle_batches"]
        self.cycle = _lengths(mix, self.batches * self.callers)

    def lengths(self, i: int) -> np.ndarray:
        """The prompt lengths of batch ``i``: its share of its cycle's
        requests, one of each stratum, as the seed deals them."""
        c, b = divmod(i, self.batches)
        strata = self.cycle.reshape(self.callers, self.batches)
        dealt = _rng(self.seed, _ORDER, c).permuted(strata, axis=1)
        return _rng(self.seed, _ORDER, c, b + 1).permutation(dealt[:, b])

    def batch(self, i: int) -> List[np.ndarray]:
        rng = _rng(self.seed, _TOKENS, i)
        return [rng.integers(0, self.vocab, n).astype(np.int32)
                for n in self.lengths(i)]

    def warm_batch(self) -> List[np.ndarray]:
        """``callers`` prompts of the cycle's longest length: the largest
        shape the cell serves."""
        rng = _rng(self.seed, _WARM)
        return [rng.integers(0, self.vocab, int(self.cycle[-1]))
                .astype(np.int32) for _ in range(self.callers)]

    def sample(self, finished: List[Dict], n: int) -> List[Dict]:
        """``n`` of the finished requests: the one of the longest prompt,
        those that carry the program's logits (the window's last batch),
        and the rest drawn from the seed."""
        if len(finished) <= n:
            return list(finished)
        longest = max(range(len(finished)),
                      key=lambda j: len(finished[j]["prompt"]))
        keep = {longest} | {j for j, f in enumerate(finished)
                            if "logits" in f}
        rest = [j for j in range(len(finished)) if j not in keep]
        k = max(0, min(n - len(keep), len(rest)))
        pick = _rng(self.seed, _SAMPLE).choice(len(rest), k, replace=False)
        return [finished[j] for j in sorted(keep | {rest[i] for i in pick})]
