"""Per-column statistics: frequency backbone, MCVs, equi-depth buckets,
and a mergeable distinct-count sketch.

``ColumnHistogram`` is the unit ``DatabaseServer.analyze()`` builds per
column. Its storage is an exact sorted ``(values, counts)`` frequency map —
the one representation whose ``merge()`` is **lossless, associative and
commutative by construction** (a sorted merge-add of counts), which is what
lets a :class:`~repro_torch.cluster.database.ShardedDatabase` coordinator
reconcile per-shard statistics bit-for-bit with the unsharded server's
(property-tested like ``combine_snapshots``). Everything the estimator
consumes is *derived* deterministically from that backbone:

  * **MCVs** — the ``n_mcv`` most common values with their exact
    frequencies (ties broken by value), Postgres-style;
  * **equi-depth buckets** over the residual (non-MCV) values — bucket
    boundaries placed on value frequencies so each bucket holds ~equal
    row mass; estimation inside a bucket assumes uniformity (this is the
    histogram-grade approximation — the estimator never reads the raw
    frequency map directly except for MCVs);
  * a **KMV distinct-count sketch** (k smallest deterministic 64-bit
    mixes of the values) whose union-merge is exact under re-sharding.

Because derivation is deterministic, two histograms with equal frequency
maps are equal bucket-for-bucket — so ``merge(shard parts) ==
build(whole table)`` exactly, not just approximately.

Content identity: ``repr()`` (and :meth:`content_digest`) hash the full
backbone + config, so the existing ``stats_fingerprint`` content-addressing
(``sha256(repr(TableStats))``) extends to histograms unchanged.
"""

from __future__ import annotations

import dataclasses
import hashlib
from functools import cached_property
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["StatsConfig", "ColumnHistogram", "build_histogram",
           "merge_histograms", "merge_all", "kmv_sketch", "kmv_merge",
           "kmv_estimate"]


@dataclasses.dataclass(frozen=True)
class StatsConfig:
    """Knobs for ``analyze()``'s histogram build (the tunable statistics
    half of the cost-catalog file). ``histograms=False`` reverts to the
    legacy scalar NDV estimates — the control arm of every
    scalar-vs-histogram comparison."""

    histograms: bool = True
    n_buckets: int = 16
    n_mcv: int = 8
    sketch_k: int = 256


DEFAULT_STATS_CONFIG = StatsConfig()


# --------------------------------------------------------------- KMV sketch

def _mix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit finalizer (splitmix64) over value bit patterns —
    a stand-in hash that is identical across shards and sessions."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64, copy=True)
        z += np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def kmv_sketch(values: np.ndarray, k: int) -> np.ndarray:
    """The k smallest mixed hashes of ``values`` (sorted uint64)."""
    if values.size == 0:
        return np.asarray([], dtype=np.uint64)
    bits = np.ascontiguousarray(np.asarray(values, dtype=np.float64)) \
        .view(np.uint64)
    h = np.unique(_mix64(bits))
    return h[:k]


def kmv_merge(a: np.ndarray, b: np.ndarray, k: int) -> np.ndarray:
    """Union-merge two KMV sketches: the k smallest of the union — exactly
    the sketch of the concatenated value sets (associative/commutative)."""
    return np.unique(np.concatenate([a, b]))[:k]


def kmv_estimate(sketch: np.ndarray, k: int) -> float:
    """Distinct-count estimate: exact while the sketch is not full, else
    the classic (k-1)/kth-minimum estimator."""
    if len(sketch) < k:
        return float(len(sketch))
    kth = float(sketch[k - 1]) / float(2 ** 64)
    return (k - 1) / max(kth, 1e-300)


# ------------------------------------------------------------ the histogram

@dataclasses.dataclass(frozen=True)
class ColumnHistogram:
    """Exact sorted value frequencies + derived MCVs / equi-depth buckets.

    ``values`` are float64 (int columns cast exactly for the magnitudes the
    simulator uses), ``counts`` int64. ``sketch`` is the KMV distinct-count
    sketch over the same values.
    """

    values: np.ndarray            # sorted distinct values, float64
    counts: np.ndarray            # int64, counts[i] = rows with values[i]
    config: StatsConfig = DEFAULT_STATS_CONFIG
    sketch: Optional[np.ndarray] = None

    # ------------------------------------------------------------- identity
    def content_digest(self) -> str:
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(self.values).tobytes())
        h.update(np.ascontiguousarray(self.counts).tobytes())
        h.update(repr((self.config.n_buckets, self.config.n_mcv,
                       self.config.sketch_k)).encode())
        return h.hexdigest()[:16]

    def __repr__(self) -> str:   # feeds repr(TableStats) → stats_fingerprint
        return (f"ColumnHistogram(nrows={self.nrows}, ndv={self.ndv}, "
                f"digest={self.content_digest()!r})")

    def __eq__(self, other) -> bool:
        return (isinstance(other, ColumnHistogram)
                and self.config == other.config
                and np.array_equal(self.values, other.values)
                and np.array_equal(self.counts, other.counts))

    def __hash__(self):
        return hash(self.content_digest())

    # -------------------------------------------------------------- scalars
    @cached_property
    def nrows(self) -> int:
        return int(self.counts.sum()) if self.counts.size else 0

    @property
    def ndv(self) -> int:
        return int(len(self.values))

    @property
    def vmin(self) -> float:
        return float(self.values[0]) if self.values.size else 0.0

    @property
    def vmax(self) -> float:
        return float(self.values[-1]) if self.values.size else 0.0

    def distinct_estimate(self) -> float:
        if self.sketch is not None:
            return kmv_estimate(self.sketch, self.config.sketch_k)
        return float(self.ndv)

    # ------------------------------------------------- derived summaries
    @cached_property
    def _mcv_index(self) -> np.ndarray:
        """Indices of the ``n_mcv`` most common values (count desc, value
        asc — a total, shard-independent order)."""
        k = min(self.config.n_mcv, len(self.values))
        if k == 0:
            return np.asarray([], dtype=np.int64)
        order = np.lexsort((self.values, -self.counts))
        return np.sort(order[:k])

    @cached_property
    def mcvs(self) -> Tuple[np.ndarray, np.ndarray]:
        """(values, counts) of the most common values, value-sorted."""
        i = self._mcv_index
        return self.values[i], self.counts[i]

    @cached_property
    def buckets(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Equi-depth buckets over the NON-MCV residual:
        ``(upper_bounds, bucket_counts, bucket_ndvs)`` — bucket ``i`` spans
        ``(upper_bounds[i-1], upper_bounds[i]]`` (first bucket from the
        residual minimum), holds ``bucket_counts[i]`` rows across
        ``bucket_ndvs[i]`` distinct values. Boundaries are chosen on the
        cumulative residual mass, so each bucket carries ~1/n_buckets of
        the residual rows regardless of value skew."""
        mask = np.ones(len(self.values), dtype=bool)
        mask[self._mcv_index] = False
        vals, cnts = self.values[mask], self.counts[mask]
        if vals.size == 0:
            e = np.asarray([], dtype=np.float64)
            z = np.asarray([], dtype=np.int64)
            return e, z, z
        nb = max(1, min(self.config.n_buckets, len(vals)))
        cum = np.cumsum(cnts)
        total = cum[-1]
        # first distinct value whose cumulative mass reaches each depth cut
        cuts = np.searchsorted(cum, total * np.arange(1, nb + 1) / nb)
        cuts = np.unique(np.minimum(cuts, len(vals) - 1))
        uppers = vals[cuts]
        lo = 0
        bc, bd = [], []
        for c in cuts:
            bc.append(int(cnts[lo:c + 1].sum()))
            bd.append(int(c + 1 - lo))
            lo = c + 1
        return uppers, np.asarray(bc, dtype=np.int64), \
            np.asarray(bd, dtype=np.int64)

    # ----------------------------------------------------------- estimation
    def eq_fraction(self, value: float) -> float:
        """Fraction of rows equal to ``value``: exact for MCVs, bucket
        average frequency for residual values, 0 outside the domain."""
        n = self.nrows
        if n == 0:
            return 0.0
        v = float(value)
        mv, mc = self.mcvs
        j = np.searchsorted(mv, v)
        if j < len(mv) and mv[j] == v:
            return float(mc[j]) / n
        uppers, bc, bd = self.buckets
        if uppers.size == 0 or v > uppers[-1]:
            return 0.0
        b = int(np.searchsorted(uppers, v, side="left"))
        return float(bc[b]) / max(int(bd[b]), 1) / n

    def param_eq_fraction(self) -> float:
        """Expected selectivity of ``col == :param`` with the binding drawn
        from the column's own distribution — Σ (f_v/N)², the self-join
        selectivity. Correlated rewrites (T2/T5) bind their parameter from
        rows of a related table, so frequent values are looked up often:
        under skew this is far larger than 1/NDV, and for uniform columns
        it degenerates to exactly 1/NDV. Computed from MCVs exactly plus
        the within-bucket-uniform residual approximation."""
        n = self.nrows
        if n == 0:
            return 1.0
        _, mc = self.mcvs
        s = float((mc.astype(np.float64) ** 2).sum())
        _, bc, bd = self.buckets
        if bc.size:
            s += float((bc.astype(np.float64) ** 2
                        / np.maximum(bd, 1)).sum())
        return min(1.0, s / (float(n) ** 2))

    def le_fraction(self, value: float) -> float:
        """Fraction of rows with ``col <= value`` — MCV mass counted
        exactly, residual buckets linearly interpolated."""
        n = self.nrows
        if n == 0:
            return 0.0
        v = float(value)
        mv, mc = self.mcvs
        acc = float(mc[mv <= v].sum())
        uppers, bc, _ = self.buckets
        if uppers.size:
            lo = self.values[0]
            b = int(np.searchsorted(uppers, v, side="left"))
            acc += float(bc[:b].sum())
            if b < len(uppers):
                lower = float(uppers[b - 1]) if b > 0 else float(lo)
                width = float(uppers[b]) - lower
                if v >= lower:
                    frac = 1.0 if width <= 0 else \
                        min(1.0, (v - lower) / width)
                    acc += float(bc[b]) * frac
        return min(1.0, acc / n)

    def range_fraction(self, op: str, value: float) -> float:
        """Selectivity of ``col <op> value`` for op in {<, <=, >, >=}."""
        le = self.le_fraction(value)
        eq = self.eq_fraction(value)
        if op == "<=":
            return le
        if op == "<":
            return max(0.0, le - eq)
        if op == ">":
            return max(0.0, 1.0 - le)
        if op == ">=":
            return max(0.0, 1.0 - le + eq)
        raise ValueError(f"not a range op: {op!r}")


# ------------------------------------------------------------ build / merge

def build_histogram(arr: np.ndarray,
                    config: StatsConfig = DEFAULT_STATS_CONFIG
                    ) -> ColumnHistogram:
    """Build the exact frequency backbone (and sketch) for one column."""
    a = np.asarray(arr)
    if a.size == 0:
        values = np.asarray([], dtype=np.float64)
        counts = np.asarray([], dtype=np.int64)
    else:
        values, counts = np.unique(a.astype(np.float64), return_counts=True)
        counts = counts.astype(np.int64)
    return ColumnHistogram(values=values, counts=counts, config=config,
                           sketch=kmv_sketch(values, config.sketch_k))


def merge_histograms(a: ColumnHistogram, b: ColumnHistogram
                     ) -> ColumnHistogram:
    """Lossless merge: sorted merge-add of the frequency backbones (and
    KMV union). Associative and commutative by construction, and equal —
    bucket-for-bucket, since every summary is derived deterministically —
    to building one histogram over the concatenated rows."""
    if a.config != b.config:
        raise ValueError(f"histogram config mismatch: {a.config} != {b.config}")
    v = np.concatenate([a.values, b.values])
    c = np.concatenate([a.counts, b.counts])
    uv, inverse = np.unique(v, return_inverse=True)
    uc = np.zeros(len(uv), dtype=np.int64)
    np.add.at(uc, inverse, c)
    sk = None
    if a.sketch is not None and b.sketch is not None:
        sk = kmv_merge(a.sketch, b.sketch, a.config.sketch_k)
    return ColumnHistogram(values=uv, counts=uc, config=a.config, sketch=sk)


def merge_all(hists: Sequence[ColumnHistogram]) -> ColumnHistogram:
    """Fold ``merge_histograms`` over a sequence (must be non-empty)."""
    out = hists[0]
    for h in hists[1:]:
        out = merge_histograms(out, h)
    return out
