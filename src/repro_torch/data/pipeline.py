"""Deterministic, sharded, resumable synthetic data pipeline.

Index-based and stateless per shard: batch `i` for host shard (r, W) is a
pure function of (seed, i, r, W) — so

  * resume is exact (the checkpoint stores only the step counter);
  * a re-joined or replacement host recomputes its shard without any
    coordination (straggler/failure recovery at 1000+ nodes);
  * elastic re-sharding (changing W) changes batch composition but never
    replays or skips data within a shard schedule.

A background prefetch thread keeps `prefetch` batches ready so host-side
generation overlaps device compute.

The port's own copy of ``repro.data.pipeline`` (numpy and threads, no
tensors): the same (seed, index, rank, count) gives the reference's batch
bit for bit. The trainer moves each batch to its device. The time a
consumer waits in ``Prefetcher.get`` is the program span ``data.wait``
(attribute ``index``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from ..obs.trace import program_span

__all__ = ["PipelineConfig", "SyntheticLM", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    shard_rank: int = 0
    shard_count: int = 1
    emb_dim: Optional[int] = None     # frontend-stub archs: emit embeddings
    enc_dec: bool = False

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.shard_count == 0
        return self.global_batch // self.shard_count


class SyntheticLM:
    """Markov-ish synthetic token stream (enough structure that loss falls)."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, index, c.shard_rank, c.shard_count]))
        B, T = c.local_batch, c.seq_len
        # structured stream: each row is an arithmetic token sequence
        # t_{i+1} = t_i + b (b ∈ {0,1}) with 2% noise — constant rows give a
        # trivially learnable copy-previous-token signal so smoke training
        # shows loss movement within tens of steps
        b = rng.integers(0, 2, (B, 1))
        t0 = rng.integers(0, c.vocab_size, (B, 1))
        steps = np.arange(T)[None, :]
        toks = (t0 + b * steps) % c.vocab_size
        noise = rng.random((B, T)) < 0.02
        toks = np.where(noise, rng.integers(0, c.vocab_size, (B, T)), toks)
        toks = toks.astype(np.int32)
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1).astype(np.int32)
        out = {"tokens": toks, "labels": labels,
               "positions": np.broadcast_to(steps, (B, T)).astype(np.int32)}
        if c.emb_dim:
            out["embeds"] = rng.standard_normal((B, T, c.emb_dim)).astype(np.float32)
            del out["tokens"]
        if c.enc_dec:
            out["enc_embeds"] = rng.standard_normal(
                (B, T, c.emb_dim or 1024)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


class Prefetcher:
    """Background thread keeping `depth` batches ready; resumable via
    ``state()`` / ``restore()`` (just the next index)."""

    def __init__(self, source: SyntheticLM, start_index: int = 0,
                 depth: int = 2):
        self.source = source
        self._next = start_index
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        i = self._next
        while not self._stop.is_set():
            try:
                self._q.put((i, self.source.batch(i)), timeout=0.2)
                i += 1
            except queue.Full:
                continue

    def get(self):
        with program_span("data.wait") as sp:
            i, b = self._q.get()
            sp.attrs["index"] = i
        self._next = i + 1
        return b

    def state(self) -> Dict:
        return {"next_index": self._next}

    @staticmethod
    def restore(source: SyntheticLM, state: Dict, depth: int = 2
                ) -> "Prefetcher":
        return Prefetcher(source, start_index=state["next_index"], depth=depth)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1.0)
