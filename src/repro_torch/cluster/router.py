"""Request routing and deadline-driven batch formation.

The cluster front door is two small, deterministic policies:

:class:`Router`
    Hashes each ``(program, bindings)`` request to a worker. Programs with
    a declared **affinity parameter** route by that binding's integer
    identity (``int(value) % n_workers`` — the same modulo hash the
    :class:`~repro_torch.cluster.partition.Partitioner` places rows with, so a
    request lands on the worker whose shard owns the rows it will touch,
    and a skewed key distribution produces a measurably hot worker for
    ``triage()`` to flag). Everything else routes by a stable content hash
    of the bindings, spreading uniform traffic evenly.

:class:`BatchFormer`
    Coalesces routed requests into dynamic batches under a latency
    deadline, replacing fixed-size batching: per ``(worker, program)``
    queue, a batch flushes when it reaches ``max_batch`` ("full") or when
    its OLDEST request has waited ``deadline_s`` ("deadline"). With all
    requests arriving at once (the default), every queue flushes in
    max-batch-sized runs immediately — the deadline knob matters when an
    arrival process is given, where sparse traffic flushes small batches
    at the deadline and bursts flush full ones early. The formed batch
    sizes are what the batch-aware cost model then actually sees: each
    worker publishes its observed formed size into its serving context, so
    the batch-64 plan flip happens because the former MADE batches of 64,
    not because a config said so.

Both policies are pure functions of their inputs (no wall clock, no
randomness) — the cluster's bit-identity guarantee extends to WHICH
batches form, in WHAT order, on WHICH worker.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = ["Request", "FormedBatch", "Router", "BatchFormer",
           "uniform_arrivals"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One routed request: original stream position + routing decision."""

    index: int                      # position in the request stream
    program: str
    params: Mapping[str, object]
    worker: int
    arrival_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class FormedBatch:
    """A flushed batch: same program, same worker, formed at ``flush_s``."""

    worker: int
    program: str
    requests: Tuple[Request, ...]
    flush_s: float
    reason: str                     # "full" | "deadline"

    @property
    def size(self) -> int:
        return len(self.requests)


class Router:
    """Deterministic (program, bindings) → worker placement."""

    def __init__(self, n_workers: int,
                 affinity: Optional[Mapping[str, str]] = None):
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.n_workers = n_workers
        # program -> parameter name whose binding carries shard identity
        self.affinity: Dict[str, str] = dict(affinity or {})
        self.routed = 0
        self.affinity_routed = 0
        self.worker_counts = [0] * n_workers

    def route(self, program: str, params: Mapping[str, object]) -> int:
        self.routed += 1
        w = self._affinity_worker(program, params)
        if w is None:
            w = self._hash_worker(program, params)
        else:
            self.affinity_routed += 1
        self.worker_counts[w] += 1
        return w

    def _affinity_worker(self, program: str,
                         params: Mapping[str, object]) -> Optional[int]:
        pname = self.affinity.get(program)
        if pname is None or pname not in params:
            return None
        v = params[pname]
        if isinstance(v, (list, tuple)):
            if not v:
                return None
            v = v[0]
        try:
            return int(v) % self.n_workers
        except (TypeError, ValueError):
            return None

    def _hash_worker(self, program: str,
                     params: Mapping[str, object]) -> int:
        try:
            ident = repr((program, tuple(sorted(
                (k, tuple(v) if isinstance(v, list) else v)
                for k, v in params.items()))))
        except TypeError:
            ident = repr((program, sorted(params)))
        return zlib.crc32(ident.encode()) % self.n_workers

    def skew(self) -> float:
        """Max worker share relative to a perfectly even split (1.0 =
        uniform, ``n_workers`` = everything on one worker)."""
        if not self.routed:
            return 1.0
        return max(self.worker_counts) * self.n_workers / self.routed

    def stats_dict(self) -> Dict[str, object]:
        return {"routed": self.routed,
                "affinity_routed": self.affinity_routed,
                "worker_counts": list(self.worker_counts),
                "skew": self.skew()}


class BatchFormer:
    """Deadline-driven dynamic batching over a routed request stream."""

    def __init__(self, deadline_s: float = 0.01, max_batch: int = 64):
        if deadline_s < 0:
            raise ValueError("deadline_s must be >= 0")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.deadline_s = deadline_s
        self.max_batch = max_batch
        self.flushes_full = 0
        self.flushes_deadline = 0

    def form(self, requests: Sequence[Request]) -> List[FormedBatch]:
        """Replay the arrival process and return every flushed batch, in
        flush order (ties broken by (worker, program) for determinism)."""
        queues: Dict[Tuple[int, str], List[Request]] = {}
        out: List[FormedBatch] = []

        def flush(key: Tuple[int, str], t: float, reason: str) -> None:
            q = queues.pop(key)
            out.append(FormedBatch(key[0], key[1], tuple(q), t, reason))
            if reason == "full":
                self.flushes_full += 1
            else:
                self.flushes_deadline += 1

        for r in sorted(requests, key=lambda r: (r.arrival_s, r.index)):
            # deadline-expire every queue whose oldest member would wait
            # past the deadline before this arrival lands
            for key in sorted(k for k, q in queues.items()
                              if q[0].arrival_s + self.deadline_s
                              < r.arrival_s):
                flush(key, queues[key][0].arrival_s + self.deadline_s,
                      "deadline")
            key = (r.worker, r.program)
            queues.setdefault(key, []).append(r)
            if len(queues[key]) >= self.max_batch:
                flush(key, r.arrival_s, "full")
        for key in sorted(queues):
            flush(key, queues[key][0].arrival_s + self.deadline_s,
                  "deadline")
        out.sort(key=lambda b: (b.flush_s, b.worker, b.program))
        return out

    def stats_dict(self) -> Dict[str, object]:
        return {"deadline_s": self.deadline_s, "max_batch": self.max_batch,
                "flushes_full": self.flushes_full,
                "flushes_deadline": self.flushes_deadline}


def uniform_arrivals(n: int, rps: float) -> List[float]:
    """Evenly spaced arrival times for ``n`` requests at ``rps`` req/s —
    the deterministic arrival process benches and examples use to exercise
    the deadline (all-at-once arrivals always flush full batches)."""
    if rps <= 0:
        raise ValueError("rps must be > 0")
    return [i / rps for i in range(n)]
