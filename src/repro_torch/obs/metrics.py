"""Unified metrics registry: labeled counters / gauges / histograms.

One :class:`MetricsRegistry` per component (session, serving runtime,
feedback controller, compile manager) replaces the scattered ad-hoc
telemetry dicts. The legacy attributes and telemetry-dict shapes are kept
as views: a :class:`registry_counter` descriptor routes ``obj.counter += 1``
mutations — including external call sites like
``session.executions += n`` — through the owning component's registry, so
the registry value and the telemetry dict reconcile bit-for-bit by
construction.

``snapshot()`` flattens everything to ``{name{label=value,...}: number}``;
``diff(older)`` returns the numeric deltas — the two primitives every
"what changed during this serve cycle?" question needs.

**Multi-worker aggregation.** Flat snapshots cannot be merged losslessly:
histogram stats are flattened to ``name_count``/``name_min``/… suffixes, so
a combiner cannot tell a counter named ``x_min`` from a histogram's min —
summing either loses information. ``dump()`` therefore exports the
STRUCTURED form (counters / gauges / hists kept apart) and
:func:`combine_snapshots` folds any number of dumps — with disjoint or
overlapping label sets — into one: counters sum, histogram stats combine
component-wise (count/sum add, min/max fold), numeric gauges sum (across
workers, "entries held" really is the sum). The fold is associative and
commutative by construction — ``combine(a, combine(b, c)) ==
combine(combine(a, b), c)`` is pinned by property tests — which is what
lets a cluster merge per-worker registries in any order, incrementally,
and still reconcile bit-for-bit with the per-worker sums.
``ingest()`` accepts a structured dump too, merging it into the registry
(counters accumulate, hist stats fold) instead of flattening to gauges.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

__all__ = ["MetricsRegistry", "registry_counter", "merge_snapshots",
           "combine_snapshots"]

_LabelKey = Tuple[Tuple[str, object], ...]


def _key(name: str, labels: Mapping[str, object]) -> Tuple[str, _LabelKey]:
    return (name, tuple(sorted(labels.items())))


def _flat_name(name: str, labels: _LabelKey) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Labeled counters, gauges, and histograms with snapshot/diff."""

    def __init__(self):
        self._counters: Dict[Tuple[str, _LabelKey], float] = {}
        self._gauges: Dict[Tuple[str, _LabelKey], object] = {}
        self._hists: Dict[Tuple[str, _LabelKey], Dict[str, float]] = {}

    # ------------------------------------------------------------- counters
    def inc(self, name: str, value: float = 1, **labels) -> None:
        k = _key(name, labels)
        self._counters[k] = self._counters.get(k, 0) + value

    def set_counter(self, name: str, value, **labels) -> None:
        """Absolute assignment — the hook legacy ``obj.counter = 0`` /
        ``obj.counter += 1`` attribute writes route through."""
        self._counters[_key(name, labels)] = value

    def value(self, name: str, default=0, **labels):
        return self._counters.get(_key(name, labels), default)

    # --------------------------------------------------------------- gauges
    def gauge(self, name: str, value, **labels) -> None:
        self._gauges[_key(name, labels)] = value

    def gauge_value(self, name: str, default=None, **labels):
        return self._gauges.get(_key(name, labels), default)

    def ingest(self, mapping: Mapping[str, object], prefix: str = "") -> None:
        """Fold an existing telemetry dict's numeric leaves into gauges
        (the migration path for stats dicts owned by other components,
        e.g. SiteCache / PlanStore / ArtifactCache).

        A STRUCTURED dump (the :meth:`dump` shape) is merged instead of
        flattened: counters accumulate, histogram stats fold component-wise,
        gauges overwrite — so a registry can absorb another worker's
        registry without losing the counter/gauge/hist distinction."""
        if _is_structured(mapping):
            for k, v in mapping.get("counters", {}).items():
                self.inc(prefix + k, v)
            for k, v in mapping.get("gauges", {}).items():
                self.gauge(prefix + k, v)
            for k, h in mapping.get("hists", {}).items():
                self.merge_hist(prefix + k, h)
            return
        for k, v in mapping.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.gauge(prefix + k, v)

    # ----------------------------------------------------------- histograms
    def observe(self, name: str, value: float, **labels) -> None:
        k = _key(name, labels)
        h = self._hists.get(k)
        if h is None:
            self._hists[k] = {"count": 1, "sum": value,
                              "min": value, "max": value}
        else:
            h["count"] += 1
            h["sum"] += value
            h["min"] = min(h["min"], value)
            h["max"] = max(h["max"], value)

    def histogram(self, name: str, **labels) -> Optional[Dict[str, float]]:
        h = self._hists.get(_key(name, labels))
        return dict(h) if h is not None else None

    def merge_hist(self, name: str, stats: Mapping[str, float],
                   **labels) -> None:
        """Fold another histogram's (count, sum, min, max) into this one —
        the per-bucket combine :func:`combine_snapshots` and structured
        :meth:`ingest` are built on. Equivalent to having observed the other
        histogram's samples here (component-wise: counts and sums add,
        min/max fold), so merging is associative and lossless."""
        if not stats.get("count"):
            return
        k = _key(name, labels)
        h = self._hists.get(k)
        if h is None:
            self._hists[k] = {"count": stats["count"], "sum": stats["sum"],
                              "min": stats["min"], "max": stats["max"]}
        else:
            h["count"] += stats["count"]
            h["sum"] += stats["sum"]
            h["min"] = min(h["min"], stats["min"])
            h["max"] = max(h["max"], stats["max"])

    # ------------------------------------------------------- snapshot / diff
    def dump(self) -> Dict[str, Dict[str, object]]:
        """The STRUCTURED snapshot: counters, gauges, and histograms kept
        apart (flat label-rendered names inside each kind). This is the
        mergeable form — :func:`combine_snapshots` folds dumps from many
        workers; ``snapshot()``'s flat view is for humans and diffs."""
        return {
            "counters": {_flat_name(n, l): v
                         for (n, l), v in self._counters.items()},
            "gauges": {_flat_name(n, l): v
                       for (n, l), v in self._gauges.items()},
            "hists": {_flat_name(n, l): dict(h)
                      for (n, l), h in self._hists.items()},
        }

    def snapshot(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for (name, labels), v in self._counters.items():
            out[_flat_name(name, labels)] = v
        for (name, labels), v in self._gauges.items():
            out[_flat_name(name, labels)] = v
        for (name, labels), h in self._hists.items():
            base = _flat_name(name, labels)
            for stat, v in h.items():
                out[f"{base}_{stat}"] = v
        return out

    def diff(self, older: Mapping[str, object]) -> Dict[str, object]:
        """Numeric deltas of the current snapshot against an older one
        (new keys diff against zero; non-numeric values compare-and-keep)."""
        now = self.snapshot()
        out: Dict[str, object] = {}
        for k, v in now.items():
            prev = older.get(k, 0)
            if isinstance(v, (int, float)) and not isinstance(v, bool) \
                    and isinstance(prev, (int, float)):
                d = v - prev
                if d:
                    out[k] = d
            elif v != prev:
                out[k] = v
        return out


class registry_counter:
    """Class-level descriptor turning a legacy counter attribute into a
    registry-backed metric. ``obj.<name>`` reads the registry value;
    ``obj.<name> = v`` (hence ``+=``) writes it — the metric name defaults
    to the attribute name, the registry lives at ``obj.<registry_attr>``."""

    def __init__(self, metric: Optional[str] = None,
                 registry_attr: str = "metrics"):
        self.metric = metric
        self.registry_attr = registry_attr

    def __set_name__(self, owner, name):
        if self.metric is None:
            self.metric = name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return getattr(obj, self.registry_attr).value(self.metric)

    def __set__(self, obj, value):
        getattr(obj, self.registry_attr).set_counter(self.metric, value)


def merge_snapshots(**named: Mapping[str, object]) -> Dict[str, object]:
    """Combine component snapshots under name prefixes:
    ``merge_snapshots(serving=a, session=b) -> {"serving_...", ...}``.

    This is the NAMESPACING merge (components keep their identity, flat
    values pass through untouched). To AGGREGATE equal-shaped snapshots
    from many workers — summing counters, folding histograms — use
    :func:`combine_snapshots` on structured :meth:`MetricsRegistry.dump`
    outputs instead; the flat form is not losslessly combinable."""
    out: Dict[str, object] = {}
    for prefix, snap in named.items():
        for k, v in snap.items():
            out[f"{prefix}_{k}"] = v
    return out


_STRUCTURED_KEYS = frozenset({"counters", "gauges", "hists"})


def _is_structured(mapping: Mapping[str, object]) -> bool:
    return (bool(mapping) and set(mapping) <= _STRUCTURED_KEYS
            and all(isinstance(v, Mapping) for v in mapping.values()))


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def combine_snapshots(*dumps: Mapping[str, Mapping]) -> Dict[str, Dict]:
    """Fold structured dumps (:meth:`MetricsRegistry.dump`) from N workers
    into one, losslessly and associatively:

      * **counters** — sum (a metric absent from a worker counts as 0, so
        disjoint label sets union cleanly);
      * **hists** — component-wise: ``count``/``sum`` add, ``min``/``max``
        fold — exactly the stats of the concatenated sample streams;
      * **gauges** — numeric gauges sum (per-worker "entries" / "bytes_used"
        aggregate to the cluster total); non-numeric gauges must agree or
        the first value wins.

    Every per-element operation (+, min, max) is associative and
    commutative, so ``combine(a, combine(b, c)) == combine(combine(a, b),
    c)`` and worker order never matters — pinned by the property tests in
    ``tests/test_metrics_merge.py``."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, object] = {}
    hists: Dict[str, Dict[str, float]] = {}
    for d in dumps:
        if not _is_structured(d):
            raise TypeError(
                "combine_snapshots takes structured dumps "
                "(MetricsRegistry.dump()); got a flat snapshot — flat "
                "forms merge lossily (histogram suffixes are ambiguous)")
        for k, v in d.get("counters", {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, v in d.get("gauges", {}).items():
            if _num(v) and _num(gauges.get(k, 0)):
                gauges[k] = gauges.get(k, 0) + v
            else:
                gauges.setdefault(k, v)
        for k, h in d.get("hists", {}).items():
            if not h.get("count"):
                continue
            cur = hists.get(k)
            if cur is None:
                hists[k] = dict(h)
            else:
                cur["count"] += h["count"]
                cur["sum"] += h["sum"]
                cur["min"] = min(cur["min"], h["min"])
                cur["max"] = max(cur["max"], h["max"])
    return {"counters": counters, "gauges": gauges, "hists": hists}
