"""Compiled-tier execution: kernel-backed hooks + the splicing interpreter.

A :class:`~repro_torch.compiled.lower.CompiledLoop` executes through
:func:`repro_torch.core.vectorize.exec_loop_plan` — the same statement walk the
fast interpreter uses, which owns ALL simulated-time charging — but with
:class:`~repro_torch.core.vectorize.LoopHooks` that move the data differently:

  * **navigation / cache-lookup probes** run against an epoch-cached
    :class:`_ProbeIndex` (host key columns, argsort order, materialized
    column arrays, and a direct-address slot table on the table's device),
    probed by ``kernels.join_probe`` / ``kernels.ops`` on the ``"kernels"``
    backend (the CUDA kernels for a CUDA table, their plain torch versions
    for a CPU one) or ``kernels.ref.join_probe_np`` on the ``"numpy"``
    backend. The index
    is keyed by the SAME (stats version, data version, instance) epoch the
    serving :class:`~repro_torch.runtime.sitecache.SiteCache` uses, so an
    ``analyze()`` or a write landing mid-stream rebuilds it instead of
    serving stale gathers — compiled results stay bit-identical to
    interpreted ones under concurrent stats/data movement;
  * **accumulator folds** go through ``segment_reduce`` only for the
    accumulators lowering proved fold-safe AND whose runtime values pass
    the exactness gate (integer deltas within fp32's exact range);
    everything else takes the default float64 sequential-equivalent path.

The :class:`SplicingInterpreter` is the tiered fallback: a plain
:class:`~repro_torch.core.regions.Interpreter` that, on reaching a loop bound by
the lowering, executes the compiled segment and, everywhere else (``while``
guards, early-exit loops, update-carrying bodies, non-table or empty
sources at run time), defers to the exact row-at-a-time semantics.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from ..core.regions import Interpreter, IVar, LoopRegion
from ..core.vectorize import (LoopHooks, _broadcast, _eval_vec,
                              _vec_accumulate, exec_loop_plan)
from ..kernels import ref as kref
from ..relational.table import Table, host_to_device

__all__ = ["SplicingInterpreter", "make_hooks"]

# fp32 holds integers exactly up to 2**24: the kernel fold (which
# accumulates in float32) is only taken below this bound
_EXACT_FP32 = float(1 << 24)

# bounded memos: a serving process sees unbounded distinct query-result
# tables; the hooks only ever pin this many
_ROW_SOURCE_CAP = 32
_PROBE_INDEX_CAP = 64


class _RowSourceCache:
    """Memoized columnar materialization of loop-source tables.

    Keyed by object identity WITH a strong reference to the keyed table
    (``id`` alone could be recycled). In the serving path the site cache
    returns the same Table object for an unchanged site, so repeated
    batches hit this memo instead of re-converting columns."""

    def __init__(self, cap: int = _ROW_SOURCE_CAP):
        self.cap = cap
        self._memo: "OrderedDict[int, tuple]" = OrderedDict()

    def __call__(self, src: Table) -> Dict[str, np.ndarray]:
        k = id(src)
        hit = self._memo.get(k)
        if hit is not None and hit[0] is src:
            self._memo.move_to_end(k)
            return hit[1]
        cols = {c: src.host(c) for c in src.schema.names}
        self._memo[k] = (src, cols)
        while len(self._memo) > self.cap:
            self._memo.popitem(last=False)
        return cols


class _ProbeIndex:
    """Per-(table, key column) probe state, rebuilt when the epoch moves."""

    __slots__ = ("epoch", "table", "key_col", "tkeys", "order", "sorted_keys",
                 "cols", "direct")

    def __init__(self, epoch, t: Table, key_col: str):
        self.epoch = epoch
        self.table = t
        self.key_col = key_col
        self.tkeys = t.host(key_col)
        self.order = np.argsort(self.tkeys, kind="stable")
        self.sorted_keys = self.tkeys[self.order]
        self.cols = {c: t.host(c) for c in t.schema.names}
        self.direct = None   # lazily-built direct-address slot table

    def key_space(self) -> Optional[int]:
        if self.tkeys.size == 0 \
                or not np.issubdtype(self.tkeys.dtype, np.integer):
            return None
        lo, hi = int(self.tkeys.min()), int(self.tkeys.max())
        if lo < 0 or hi + 1 > (1 << 22):
            return None
        return hi + 1


class _ProbeIndexCache:
    def __init__(self, owner, cap: int = _PROBE_INDEX_CAP):
        self.owner = owner          # CompiledLoop (telemetry)
        self._memo: "OrderedDict[tuple, _ProbeIndex]" = OrderedDict()
        self.cap = cap

    def get(self, env, table_name: str, key_col: str) -> _ProbeIndex:
        epoch = (env.db.instance_token,) + tuple(
            env.db.site_epoch((table_name,)))
        k = (table_name, key_col)
        idx = self._memo.get(k)
        if idx is not None and idx.epoch == epoch:
            self._memo.move_to_end(k)
            return idx
        idx = _ProbeIndex(epoch, env.db.table(table_name), key_col)
        self._memo[k] = idx
        self.owner.index_rebuilds += 1
        while len(self._memo) > self.cap:
            self._memo.popitem(last=False)
        return idx


def _probe(cl, idx: _ProbeIndex, keys: np.ndarray) -> np.ndarray:
    """Row index in ``idx.table`` for each key, -1 on miss.

    ``"kernels"`` backend with an addressable key space: the ``join_probe``
    kernel against an epoch-cached direct-address table, built on the
    table's device by ``build_direct_table`` once per epoch (not per call
    like ``ops.equi_probe``). The keys come from the host loop columns and
    go to the device and back once per call. Everywhere else: searchsorted
    against the index's cached stable sort — value-identical to
    ``kernels.ref.join_probe_np`` on the same inputs, without re-sorting the
    build side on every probe."""
    if cl.backend == "kernels":
        ks = idx.key_space()
        if ks is not None:
            from ..kernels.join_probe import build_direct_table, join_probe
            dev = idx.table.device
            if idx.direct is None:
                idx.direct = build_direct_table(
                    idx.table.column(idx.key_col), ks)
            cl.kernel_probes += 1
            dkeys = host_to_device(keys, dev, dtype=np.int32)
            return join_probe(dkeys, idx.direct).cpu().numpy()
    n = keys.shape[0]
    if n == 0:
        return np.zeros((0,), np.int32)
    if idx.tkeys.shape[0] == 0:
        return np.full((n,), -1, np.int32)
    pos = np.clip(np.searchsorted(idx.sorted_keys, keys), 0,
                  len(idx.order) - 1)
    gidx = idx.order[pos]
    found = idx.tkeys[gidx] == keys
    return np.where(found, gidx, -1).astype(np.int32)


def make_hooks(cl) -> LoopHooks:
    """Bind kernel-backed hooks for one :class:`CompiledLoop`.

    Every hook is observationally identical to the vectorize defaults —
    same values, same ORM-cache mutations, same failure behavior — only
    the gather/fold machinery differs (epoch-cached indices + kernels)."""
    probe_cache = _ProbeIndexCache(cl)
    row_source = _RowSourceCache()

    # ------------------------------------------------------------------ nav
    def nav(env, ce, target, e, n):
        base = ce.rows[e.base.name]
        keys = np.asarray(base[e.fk_field])
        idx = probe_cache.get(env, e.target, e.target_key)
        gidx = _probe(cl, idx, keys)
        if (gidx < 0).any():
            raise KeyError(f"navigation {e!r}: missing keys (FK violation)")
        ce.rows[target] = {c: idx.cols[c][gidx] for c in idx.table.schema.names}
        # ORM cache accounting — identical to core.vectorize._vec_nav:
        # first occurrence of an uncached key = point query, every other
        # occurrence = cache hit (1 statement)
        t = idx.table
        uniq = np.unique(keys)
        new_keys = [k for k in uniq.tolist()
                    if (e.target, k) not in env._orm_cache]
        n_misses = len(new_keys)
        env.charge_statement(n - n_misses)
        m = env.db.model
        bulk = getattr(env, "bulk_nav_charge", None)
        if bulk is not None and n_misses:
            bulk(t, n_misses)
        else:
            for _ in range(n_misses):
                env._charge_query(
                    1, t.row_bytes,
                    m.startup_s + m.index_lookup_s,
                    m.startup_s + m.index_lookup_s + 1 / m.emit_rows_per_s)
        if env.orm_cache_enabled and n_misses:
            pos = np.searchsorted(idx.sorted_keys, np.asarray(new_keys))
            rows_idx = idx.order[pos]
            for k, i in zip(new_keys, rows_idx.tolist()):
                env._orm_cache[(e.target, k)] = t.row(int(i))

    # --------------------------------------------------------- cache_lookup
    def cache_lookup(env, ce, target, e, n):
        entry = env._prefetch_cache.get((e.table, e.col))
        if entry is None:
            raise KeyError(f"no prefetch cache for ({e.table}, {e.col})")
        keys = _broadcast(_eval_vec(e.keyexpr, ce), n)
        ckeys, corder = entry["keys"], entry["order"]
        if cl.backend == "kernels":
            # no key_space: the reference's dispatch, so the searchsorted
            # plain version even on the card
            from ..kernels import ops
            dev = entry["table"].device
            pos = ops.equi_probe(host_to_device(keys, dev),
                                 host_to_device(ckeys, dev)).cpu().numpy()
            cl.kernel_probes += 1
        else:
            pos = kref.join_probe_np(keys, ckeys)
        if (pos < 0).any():
            raise KeyError(f"cache lookup {e!r}: missing keys")
        gidx = corder[pos]
        t = entry["table"]
        cols = row_source(t)
        ce.rows[target] = {c: cols[c][gidx] for c in t.schema.names}

    # ----------------------------------------------------------- accumulate
    def accumulate(ce, stmt, e, mask, state):
        acc = stmt.target
        # a kernel-foldable acc has exactly one defining update and is never
        # read elsewhere in the body (lowering proved this), so it can have
        # no running column yet; its initial value lives in `state`
        if acc in cl.kernel_fold_accs and e.op == "+" and acc not in ce.cols:
            l_is_acc = isinstance(e.left, IVar) and e.left.name == acc
            other = e.right if l_is_acc else e.left
            delta = _broadcast(_eval_vec(other, ce), ce.n).astype(np.float64)
            if mask is not None:
                delta = np.where(mask, delta, 0.0)
            # exactness gate: the kernel accumulates in fp32, so it is only
            # taken for integer deltas whose running total stays within
            # fp32's exact integer range; then `a0 + total` is the same
            # single float64 add the cumsum path performs on its last
            # element — bit-identical. Anything else takes the default
            # sequential-equivalent float64 path.
            if np.all(delta == np.floor(delta)) \
                    and float(np.abs(delta).sum()) < _EXACT_FP32:
                total = _fold_sum(cl, delta, ce.device)
                if total is not None:
                    # the interpreted tier exports col[-1].item() — a float
                    state[acc] = float(state.get(acc, 0.0)) + total
                    cl.kernel_folds += 1
                    return
        _vec_accumulate(ce, stmt, e, mask, state)

    return LoopHooks(nav=nav, cache_lookup=cache_lookup,
                     accumulate=accumulate, row_source=row_source)


def _fold_sum(cl, delta: np.ndarray, device) -> Optional[float]:
    """Total of ``delta`` via the segment-reduce kernel (one segment), on
    ``device`` — the loop source table's."""
    if cl.backend == "kernels":
        from ..kernels import ops
        vals = host_to_device(delta, device, dtype=np.float32)
        out = ops.segment_reduce(vals, torch.zeros(delta.shape[0],
                                                   dtype=torch.int32,
                                                   device=device), 1,
                                 op="sum")
        return float(out[0].item())
    out = kref.segment_reduce_np(delta, np.zeros(delta.shape[0], np.int64), 1,
                                 op="sum")
    return float(out[0])


class SplicingInterpreter(Interpreter):
    """Interpreter that splices compiled columnar segments into the walk.

    Loops the lowering bound execute through
    :func:`~repro_torch.core.vectorize.exec_loop_plan` with the compiled hooks;
    every other region — and any bound loop whose run-time source is not a
    non-empty Table — takes the inherited exact path. ``mode`` governs only
    the UNBOUND loops (default ``"fast"``, like the interpreted tier), so
    the two tiers stay clock-identical statement for statement."""

    def __init__(self, env, lowered, mode: str = "fast"):
        super().__init__(env, mode)
        self.lowered = lowered

    def exec_region(self, r, state) -> None:
        if isinstance(r, LoopRegion):
            cl = self.lowered.loop_for(r)
            if cl is not None:
                src = self.eval(r.source, state)
                if isinstance(src, Table) and src.nrows > 0:
                    exec_loop_plan(self.env, r, src, state, cl.plan,
                                   hooks=cl.hooks)
                    cl.executions += 1
                    self.lowered.columnar_execs += 1
                    tracer = getattr(self.env, "tracer", None)
                    if tracer is not None and tracer.enabled:
                        tracer.event(
                            "kernel-invoke", sim=self.env.clock,
                            loop_var=r.var, rows=src.nrows,
                            backend=self.lowered.backend)
                    return
                # run-time fallback (empty or non-table source): the exact
                # path also records collection-loop iteration observations
                self.lowered.fallback_execs += 1
                self._exec_loop_exact(r, src, state)
                return
        super().exec_region(r, state)
