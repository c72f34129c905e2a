"""Cross-program memo-group sharing (`MemoPool`).

Saturation over one cursor loop is **context-independent**: the
alternatives the rules derive for a ``loop`` AND-node depend only on the
loop's region subtree, the emptiness facts at its entry, the database
schema/statistics, and the rule set — never on the surrounding program or
the execution context the plan is later costed for. A session-scoped pool
therefore keys each loop's saturated group structure by

    (canonical subtree key, entry-empty vars, stats epoch, rule set)

and replays it into the next memo that builds the same loop — the other
programs of a serving tier, and every context-driven recompile of the same
program, skip rule saturation for shared loops entirely. Replayed nodes
are marked *prefired* so ``expand`` never visits them (their alternatives
are already saturated), and provenance/rule-hit accounting is restored for
every distinct replayed alternative. The replayed MEMO is bit-identical to
a cold compile's (same fingerprint, same winning plan); only duplicate
ATTEMPTS — cold firings that re-derived an already-present variant — are
not replayed, so attempt counters can read lower than a cold compile's.

The stats epoch in the key covers exactly the tables the loop touches, so
an ``analyze()`` on an unrelated table leaves the entry hot; the rule-set
fingerprint covers name, operator, phase, and function identity, so a
session that swaps rule sets never replays stale structure. Harvesting is
conservative: any loop whose group structure deviates from the canonical
``assemble`` + slot-group shape (e.g. through an unexpected cross-loop
group merge) is simply not pooled — correctness never depends on a hit.

Hit/miss counters surface in ``session.telemetry`` and
``metrics_snapshot()`` (``memo_pool_hits`` / ``memo_pool_misses``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from .dag import AndNode, Memo

__all__ = ["MemoPool"]

_SLOT_OPS = ("slot-project", "slot-query", "slot-query-rows")


@dataclasses.dataclass(frozen=True)
class _SlotRec:
    """One harvested slot alternative: operator + payload + how it was
    derived (rule name and the index of its source member within the same
    var group; -1 = derived from the loop node itself, i.e. by toFIR)."""

    op: str
    payload: object
    rule: Optional[str]
    src: int


@dataclasses.dataclass(frozen=True)
class _PoolEntry:
    assemble_payload: object                       # ("assemble", acc_names)
    assemble_rule: Optional[str]                   # provenance of the assemble
    var_groups: Tuple[Tuple[_SlotRec, ...], ...]   # per child group, in order


def _region_tables(region) -> Tuple[str, ...]:
    from ..api.cache import program_tables

    class _Shim:
        body = region
    return program_tables(_Shim)


class MemoPool:
    """Session-scoped cache of saturated memo groups, keyed per loop."""

    def __init__(self, metrics=None):
        self._entries: Dict[Tuple, _PoolEntry] = {}
        self.hits = 0
        self.misses = 0
        self.metrics = metrics          # obs.MetricsRegistry (optional)

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------- keying
    @staticmethod
    def rules_fingerprint(rules) -> Tuple:
        """Identity of a rule list for pool keying: name, match operator,
        phase, and the function object itself (a user editing a rule
        mid-session produces a new function, hence a new fingerprint)."""
        return tuple((r.name, r.op, getattr(r, "phase", "explore"), id(r.fn))
                     for r in rules)

    def _key(self, region, empties, db, rules_fp) -> Tuple:
        return (region.key(), tuple(sorted(empties)),
                db.stats_token(_region_tables(region)), rules_fp)

    def _count(self, counter: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(f"memo_pool_{counter}")

    # -------------------------------------------------------------- seed
    def seed(self, memo: Memo, ctx, rules) -> Tuple[int, Set[int]]:
        """Replay pooled group structure into a freshly-built memo.

        For every ``loop`` AND-node whose key hits the pool, the harvested
        var groups and the ``assemble`` alternative are re-inserted (with
        provenance and rule-hit accounting restored) and all restored
        nodes — plus the loop node itself — are marked prefired.

        Returns ``(alternatives_replayed, prefired_and_ids)``."""
        prefired: Set[int] = set()
        replayed = 0
        if not ctx.loop_regions:
            return 0, prefired
        rules_fp = self.rules_fingerprint(rules)
        for and_id, region in list(ctx.loop_regions.items()):
            key = self._key(region, ctx.empty_at_loop.get(and_id, frozenset()),
                            ctx.db, rules_fp)
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                self._count("misses")
                continue
            replayed += self._replay(memo, and_id, entry, prefired)
            self.hits += 1
            self._count("hits")
        return replayed, prefired

    def _replay(self, memo: Memo, loop_id: int, entry: _PoolEntry,
                prefired: Set[int]) -> int:
        # rule-hit restoration mirrors cold-compile accounting exactly:
        # toFIR fires ONCE per loop (however many slots it creates), every
        # slot-variant rule fires once per variant it derived
        replayed = 0
        var_gids: List[int] = []
        for recs in entry.var_groups:
            g: Optional[int] = None
            ids: List[int] = []
            for rec in recs:
                g2, nid = memo.insert(AndNode(rec.op, (), rec.payload),
                                      group=g)
                g = g2
                ids.append(nid)
                prefired.add(nid)
                if rec.rule is not None:
                    src = loop_id if rec.src < 0 else ids[rec.src]
                    memo.provenance.setdefault(nid, (rec.rule, src))
                    if rec.src >= 0:
                        memo.rule_hits[rec.rule] = \
                            memo.rule_hits.get(rec.rule, 0) + 1
                        replayed += 1
            var_gids.append(g)
        _, aid = memo.insert(
            AndNode("assemble", tuple(var_gids), entry.assemble_payload),
            group=memo.owner(loop_id))
        prefired.add(aid)
        prefired.add(loop_id)
        if entry.assemble_rule is not None:
            memo.provenance.setdefault(aid, (entry.assemble_rule, loop_id))
            memo.rule_hits[entry.assemble_rule] = \
                memo.rule_hits.get(entry.assemble_rule, 0) + 1
        replayed += 1
        return replayed

    # ------------------------------------------------------------ harvest
    def harvest(self, memo: Memo, ctx, rules, prefired: Set[int]) -> int:
        """Record the saturated group structure of every un-pooled loop.

        Must only be called on a FULLY saturated memo (never after a
        budget-exhausted stop — a partial harvest would poison later
        compiles). Returns the number of entries added."""
        added = 0
        rules_fp = self.rules_fingerprint(rules)
        for and_id, region in list(ctx.loop_regions.items()):
            if and_id in prefired:
                continue        # replayed from the pool this compile
            entry = self._harvest_loop(memo, and_id)
            if entry is None:
                continue
            key = self._key(region, ctx.empty_at_loop.get(and_id, frozenset()),
                            ctx.db, rules_fp)
            if key not in self._entries:
                self._entries[key] = entry
                added += 1
        if self.metrics is not None and added:
            self.metrics.gauge("memo_pool_entries", len(self._entries))
        return added

    def _harvest_loop(self, memo: Memo, loop_id: int) -> Optional[_PoolEntry]:
        group = memo.owner(loop_id)
        assembles = [a for a in memo.members(group)
                     if memo.node(a).op == "assemble"
                     and memo.provenance.get(a, (None, None))[1] == loop_id]
        if len(assembles) != 1:
            return None         # no F-IR form, or an unexpected shape
        aid = assembles[0]
        child_gids = memo.canonical_children(aid)
        if len(set(child_gids)) != len(child_gids):
            return None         # var groups merged with each other: skip
        var_groups: List[Tuple[_SlotRec, ...]] = []
        for g in child_gids:
            members = memo.members(g)       # and-id order = creation order
            index = {m: i for i, m in enumerate(members)}
            recs: List[_SlotRec] = []
            for m in members:
                node = memo.node(m)
                if node.op not in _SLOT_OPS or node.children:
                    return None  # merged with a non-slot group: skip
                prov = memo.provenance.get(m)
                if prov is None:
                    rule, src = None, -1
                else:
                    rule, src_id = prov
                    if src_id == loop_id:
                        src = -1
                    elif src_id in index and index[src_id] < index[m]:
                        src = index[src_id]
                    else:
                        return None  # provenance crosses groups: skip
                recs.append(_SlotRec(node.op, node.payload, rule, src))
            var_groups.append(tuple(recs))
        a_prov = memo.provenance.get(aid)
        return _PoolEntry(assemble_payload=memo.node(aid).payload,
                          assemble_rule=a_prov[0] if a_prov else None,
                          var_groups=tuple(var_groups))
