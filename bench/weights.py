"""Model weights made on the device from the seed.

A family's ``layout(cfg)`` (in ``reference/<family>.py``) gives the
parameter tree the port reads, each leaf a :class:`Leaf`: shape, type and
the normal distribution it is drawn from. :func:`make` draws every leaf
of one type from one flat buffer, filled by a few large ``normal_`` calls
of a ``torch.Generator`` on the device, and hands out views of it: the
same seed gives the same bits on both sides of a comparison. The program
trains the views in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Tuple

CHUNK = 1 << 27          # elements a draw
DTYPES = ("bfloat16", "float32")


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: Tuple[int, ...]
    dtype: str = "bfloat16"
    mean: float = 0.0
    std: float = 1.0     # 0: every element is ``mean``


def leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in its own order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Leaf):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def paths(tree, prefix: str = "") -> List[str]:
    """Each leaf's path (``layers.3.rwkv.wo``), in :func:`leaves` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in paths(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _offsets(layout) -> Dict[str, List[Tuple[int, Leaf, int]]]:
    """Per type, (leaf index, leaf, offset in the type's buffer)."""
    out: Dict[str, List[Tuple[int, Leaf, int]]] = {d: [] for d in DTYPES}
    size = dict.fromkeys(DTYPES, 0)
    for i, leaf in enumerate(leaves(layout)):
        out[leaf.dtype].append((i, leaf, size[leaf.dtype]))
        size[leaf.dtype] += math.prod(leaf.shape)
    return out


def _draws(layout, seed: int, device) -> Iterator[Tuple[str, int, Any]]:
    """(type, offset, chunk) of every draw, in the order :func:`make`
    makes them: each type's buffer in ``CHUNK``-element pieces."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 64))
    for dt, entries in _offsets(layout).items():
        total = sum(math.prod(leaf.shape) for _, leaf, _ in entries)
        for a in range(0, total, CHUNK):
            chunk = torch.empty(min(CHUNK, total - a),
                                dtype=getattr(torch, dt), device=device)
            chunk.normal_(generator=gen)
            yield dt, a, chunk


def _shape(x, leaf: Leaf):
    """Standard normals ``x`` as the leaf's distribution, in place."""
    if leaf.std == 0:
        return x.fill_(leaf.mean)
    x.mul_(leaf.std)
    return x.add_(leaf.mean) if leaf.mean else x


def make(layout, seed: int, device):
    """The tree of ``layout`` drawn from ``seed`` on ``device``."""
    import torch
    bufs = {}
    for dt, entries in _offsets(layout).items():
        total = sum(math.prod(leaf.shape) for _, leaf, _ in entries)
        bufs[dt] = torch.empty(total, dtype=getattr(torch, dt),
                               device=device)
    for dt, a, chunk in _draws(layout, seed, device):
        bufs[dt][a:a + chunk.numel()].copy_(chunk)
        del chunk
    flat = []
    for dt, entries in _offsets(layout).items():
        for i, leaf, off in entries:
            n = math.prod(leaf.shape)
            flat.append((i, _shape(bufs[dt][off:off + n].view(leaf.shape),
                                   leaf)))
    it = iter(t for _, t in sorted(flat, key=lambda e: e[0]))
    return tree_map(lambda _: next(it), layout)


def change_norms(layout, seed: int, params, device) -> List[float]:
    """Each leaf's ``||params - p0||``, p0 the leaves :func:`make` drew
    from ``seed``, drawn again a chunk at a time (one chunk's memory)."""
    import torch
    got = leaves(params)
    sums = [torch.zeros((), dtype=torch.float64, device=device)
            for _ in got]
    entries = _offsets(layout)
    for dt, a, chunk in _draws(layout, seed, device):
        b = a + chunk.numel()
        for i, leaf, off in entries[dt]:
            n = math.prod(leaf.shape)
            lo, hi = max(a, off), min(b, off + n)
            if lo >= hi:
                continue
            p0 = _shape(chunk[lo - a:hi - a].clone(), leaf)
            p = got[i].reshape(-1)[lo - off:hi - off]
            d = p.float() - p0.float()    # exact for bf16 and fp32 leaves
            sums[i] += d.square().sum(dtype=torch.float64)
        del chunk
    return torch.stack(sums).sqrt().tolist()
