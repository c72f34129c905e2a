"""The Region AND-OR DAG ("Region DAG", Sec. IV-B) — a Volcano/Cascades memo.

OR-nodes are *groups*: equivalence classes of regions/expressions — every
member computes the same state transition. AND-nodes are operators (`seq`,
`loop`, `cond`, `block`, and the F-IR operators) over child groups.

Volcano essentials implemented here:

  * **hash-consing** of AND-nodes: (op, child-group-ids, payload) → unique id,
    so re-derived expressions are detected as duplicates and cyclic rule sets
    (e.g. T2 ↔ N2) terminate;
  * **group union**: when a rule derives, inside group A, an expression whose
    root AND-node already belongs to group B, groups A and B are merged
    (union-find), exactly like Volcano's node merging;
  * **saturating expansion**: rules fire once per (AND-node, rule) pair until
    no rule produces anything new.

Saturation is **delta-driven and phased** (``expand``): every rule keeps a
cursor into a per-operator applicability index, so each fixpoint round
touches only the AND-nodes created since the rule last ran — a saturated
memo costs O(new nodes), not O(memo × rules × rounds). Rules declare a
phase (``normalize`` → ``explore`` → ``cleanup``) and each phase runs to its
own fixpoint, shrinking the explore frontier. A :class:`Budget` (node count
and/or wall clock) stops saturation gracefully mid-flight — the caller
falls back to greedy best-first search over whatever the memo holds.
``expand_exhaustive`` keeps the original rescan-everything loop as the
reference implementation for parity tests and the compile benchmark.

Payloads hold leaf content (a `Stmt`, an F-IR expr fragment, a `Query`) and
operator attributes (loop var/source, cond predicate).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time
from typing import (Callable, Dict, List, Optional, Sequence, Set,
                    Tuple)

__all__ = ["AndNode", "Memo", "Rule", "Budget", "GroupId", "AndId",
           "PHASES", "expand", "expand_exhaustive", "memo_fingerprint"]

GroupId = int
AndId = int

# saturation phases, in firing order; each runs to its own fixpoint
PHASES = ("normalize", "explore", "cleanup")


@dataclasses.dataclass(frozen=True)
class AndNode:
    """(operator, ordered child groups, payload). Payload must be hashable."""

    op: str
    children: Tuple[GroupId, ...]
    payload: object = None

    def key(self, canon: Callable[[GroupId], GroupId]) -> Tuple:
        payload_key = self.payload.key() if hasattr(self.payload, "key") else self.payload
        return (self.op, tuple(canon(c) for c in self.children), payload_key)


class Memo:
    def __init__(self):
        self._groups: Dict[GroupId, Set[AndId]] = {}
        self._ands: Dict[AndId, AndNode] = {}
        self._owner: Dict[AndId, GroupId] = {}
        self._and_index: Dict[Tuple, AndId] = {}
        self._parent: Dict[GroupId, GroupId] = {}  # union-find
        self._next_group = itertools.count()
        self._next_and = itertools.count()
        self.merges = 0
        self.duplicates = 0
        # rewrite provenance: and_id -> (rule name, source and_id) for every
        # AND-node a rule created (build_memo originals have no entry), and
        # per-rule alternative counts — recorded by expand(), consumed by
        # search.run_search to report which rules produced the winning plan
        self.provenance: Dict[AndId, Tuple[str, AndId]] = {}
        self.rule_hits: Dict[str, int] = {}
        # per-phase per-rule saturation accounting: phase -> rule ->
        # {"matched": nodes visited, "fired": applies that added something,
        #  "missed": applies that added nothing}
        self.rule_stats: Dict[str, Dict[str, Dict[str, int]]] = {}
        # memoized canonical child tuples, invalidated on group union
        self._canon_children: Dict[AndId, Tuple[GroupId, ...]] = {}

    # -------------------------------------------------------------- groups
    def find(self, g: GroupId) -> GroupId:
        # full path compression: locate the root, then point every node on
        # the walked path directly at it
        p = self._parent
        root = g
        while p.get(root, root) != root:
            root = p[root]
        while p.get(g, g) != g:
            p[g], g = root, p[g]
        return root

    def new_group(self) -> GroupId:
        g = next(self._next_group)
        self._groups[g] = set()
        self._parent[g] = g
        return g

    def members(self, g: GroupId) -> Tuple[AndId, ...]:
        return tuple(sorted(self._groups[self.find(g)]))

    def groups(self) -> List[GroupId]:
        return sorted({self.find(g) for g in self._groups})

    def node(self, a: AndId) -> AndNode:
        return self._ands[a]

    def owner(self, a: AndId) -> GroupId:
        return self.find(self._owner[a])

    def canonical_children(self, a: AndId) -> Tuple[GroupId, ...]:
        cached = self._canon_children.get(a)
        if cached is not None:
            return cached
        out = tuple(self.find(c) for c in self._ands[a].children)
        self._canon_children[a] = out
        return out

    # --------------------------------------------------------------- insert
    def insert(self, node: AndNode, group: Optional[GroupId] = None) -> Tuple[GroupId, AndId]:
        """Insert an AND-node as an alternative of `group` (or a new group).

        Duplicate detection: if an identical node exists, reuse it; if it lives
        in a different group than requested, the groups are MERGED (they have
        been proven to compute the same transition)."""
        key = node.key(self.find)
        existing = self._and_index.get(key)
        if existing is not None:
            self.duplicates += 1
            owner = self.owner(existing)
            if group is not None and self.find(group) != owner:
                self._union(owner, self.find(group))
            return self.owner(existing), existing
        a = next(self._next_and)
        node = AndNode(node.op, tuple(self.find(c) for c in node.children), node.payload)
        self._ands[a] = node
        g = self.find(group) if group is not None else self.new_group()
        self._groups[g].add(a)
        self._owner[a] = g
        self._and_index[key] = a
        return g, a

    def _union(self, a: GroupId, b: GroupId) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        self.merges += 1
        # merge smaller into larger
        if len(self._groups[ra]) < len(self._groups[rb]):
            ra, rb = rb, ra
        self._groups[ra] |= self._groups[rb]
        for m in self._groups[rb]:
            self._owner[m] = ra
        self._groups[rb] = set()
        self._parent[rb] = ra
        # child references are canonicalized lazily via find(); memoized
        # canonical tuples may now be stale — drop them all (unions are
        # rare next to lookups)
        self._canon_children.clear()

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, int]:
        # root count without per-group find() calls: a group is a root iff
        # its union-find parent is itself (unions re-point exactly the
        # losing root), so counting roots is one O(groups) pass
        p = self._parent
        return {
            "groups": sum(1 for g, pg in p.items() if g == pg),
            "and_nodes": len(self._ands),
            "duplicates_detected": self.duplicates,
            "group_merges": self.merges,
        }


@dataclasses.dataclass
class Rule:
    """A transformation rule: matches an AND-node, adds alternatives.

    `apply(memo, and_id, ctx) -> list of (AndNode trees)` — implementations
    insert directly via memo.insert(..., group=owner) and return how many
    alternatives they added (for fixpoint detection). ``phase`` assigns the
    rule to one saturation phase (see :data:`PHASES`); each phase runs to
    its own fixpoint before the next starts."""

    name: str
    op: str  # root operator this rule matches ("fold", "loop", ...)
    fn: Callable  # (memo, and_id, ctx) -> int (number of new alternatives)
    phase: str = "explore"

    def __post_init__(self):
        if self.phase not in PHASES:
            raise ValueError(f"unknown rule phase {self.phase!r}; "
                             f"must be one of {PHASES}")

    def apply(self, memo: Memo, and_id: AndId, ctx) -> int:
        return self.fn(memo, and_id, ctx)


@dataclasses.dataclass
class Budget:
    """Compile-time budget for memo saturation.

    ``node_budget`` caps the number of AND-nodes in the memo;
    ``wall_budget_s`` caps saturation wall clock. When either trips,
    ``expand`` stops IMMEDIATELY (mid-phase) and reports
    ``budget_exhausted`` — never an error; the caller degrades to greedy
    best-first search over the partial memo."""

    node_budget: Optional[int] = None
    wall_budget_s: Optional[float] = None

    def __post_init__(self):
        if self.node_budget is not None and self.node_budget < 1:
            raise ValueError("node_budget must be >= 1 (or None)")
        if self.wall_budget_s is not None and self.wall_budget_s <= 0:
            raise ValueError("wall_budget_s must be > 0 (or None)")
        self._t0 = time.perf_counter()

    @property
    def bounded(self) -> bool:
        return self.node_budget is not None or self.wall_budget_s is not None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def exhausted(self, n_nodes: int) -> bool:
        if self.node_budget is not None and n_nodes >= self.node_budget:
            return True
        if self.wall_budget_s is not None and \
                time.perf_counter() - self._t0 >= self.wall_budget_s:
            return True
        return False


def expand(memo: Memo, rules: Sequence[Rule], ctx, max_rounds: int = 64,
           tracer=None, budget: Optional[Budget] = None,
           prefired=None) -> Dict[str, int]:
    """Saturate with delta-driven, phased rule scheduling.

    Each (and_id, rule) fires at most once, as in the exhaustive loop — but
    instead of rescanning the whole memo every round, every rule holds a
    cursor into a per-operator **applicability index** (op → and-ids, dense
    ids appended as nodes are created), so a round visits only the nodes
    created since that rule last ran. Rules run grouped by phase
    (``normalize`` → ``explore`` → ``cleanup``), each phase to its own
    fixpoint; a later phase's cursors start at zero, so it still sees every
    node earlier phases produced.

    ``budget`` (a :class:`Budget`) stops saturation mid-flight, setting
    ``budget_exhausted`` in the returned stats. ``prefired`` is a set of
    AND-ids no rule should visit — memo-pool replay marks restored nodes
    this way, since their alternatives were already harvested saturated.
    ``tracer`` (an :class:`repro_torch.obs.trace.Tracer`) gets one span per
    phase round."""
    prefired = frozenset() if prefired is None else frozenset(prefired)
    if budget is not None:
        budget.start()

    # applicability index: op -> [and_id...], grown lazily; AND-ids are
    # dense sequential ints, so indexing new nodes is a range() walk.
    # Only ops some rule can match are indexed at all — on skeleton-heavy
    # programs most nodes (block/seq/cond) never enter any rule's worklist
    rule_ops = {r.op for r in rules}
    wildcard = "*" in rule_ops
    op_index: Dict[str, List[AndId]] = {op: [] for op in rule_ops
                                        if op != "*"}
    all_ids: List[AndId] = []
    indexed_upto = 0

    def _refresh() -> None:
        nonlocal indexed_upto
        n = len(memo._ands)
        ands = memo._ands
        for a in range(indexed_upto, n):
            lst = op_index.get(ands[a].op)
            if lst is not None:
                lst.append(a)
            if wildcard:
                all_ids.append(a)
        indexed_upto = n

    rounds = 0
    total_new = 0
    exhausted = False
    phase_rounds: Dict[str, int] = {}

    def _phase_round(phase: str, phase_rules: List[Rule],
                     cursors: Dict[str, int]) -> Tuple[int, bool]:
        stats_phase = memo.rule_stats.setdefault(phase, {})
        new = 0
        for r in phase_rules:
            _refresh()
            lst = all_ids if r.op == "*" else op_index.get(r.op)
            if not lst:
                continue
            pos = cursors[r.name]
            rstats = stats_phase.setdefault(
                r.name, {"matched": 0, "fired": 0, "missed": 0})
            # nodes appended to lst DURING this walk (by r itself or not yet
            # indexed) are picked up next round via the cursor
            end = len(lst)
            while pos < end:
                a = lst[pos]
                pos += 1
                if a in prefired:
                    continue
                rstats["matched"] += 1
                n_before = len(memo._ands)
                added = r.apply(memo, a, ctx)
                if added:
                    rstats["fired"] += 1
                    memo.rule_hits[r.name] = \
                        memo.rule_hits.get(r.name, 0) + added
                    for nid in range(n_before, len(memo._ands)):
                        memo.provenance.setdefault(nid, (r.name, a))
                    new += added
                else:
                    rstats["missed"] += 1
                if budget is not None and budget.exhausted(len(memo._ands)):
                    cursors[r.name] = pos
                    return new, True
            cursors[r.name] = pos
        return new, False

    for phase in PHASES:
        phase_rules = [r for r in rules
                       if getattr(r, "phase", "explore") == phase]
        if not phase_rules or exhausted:
            continue
        cursors = {r.name: 0 for r in phase_rules}
        pr = 0
        while rounds < max_rounds:
            rounds += 1
            pr += 1
            if tracer is not None and tracer.enabled:
                with tracer.span("saturate-round", round=rounds,
                                 phase=phase) as sp:
                    new, exhausted = _phase_round(phase, phase_rules, cursors)
                    sp.attrs["new_alternatives"] = new
            else:
                new, exhausted = _phase_round(phase, phase_rules, cursors)
            total_new += new
            if new == 0 or exhausted:
                break
        phase_rounds[phase] = pr

    return {"rounds": rounds, "alternatives_added": total_new,
            "budget_exhausted": exhausted,
            "phase_rounds": phase_rounds, **memo.stats()}


def expand_exhaustive(memo: Memo, rules: Sequence[Rule], ctx,
                      max_rounds: int = 64, tracer=None) -> Dict[str, int]:
    """The original saturation loop: every round rescans every AND-node
    against every rule until a full pass adds nothing. Kept as the reference
    implementation — the parity property tests and ``make bench-compile``
    assert ``expand`` reaches the identical memo fingerprint and winning
    plan, and measure the delta scheduler's speedup against this."""
    fired: Set[Tuple[AndId, str]] = set()
    rounds = 0
    total_new = 0

    def _round() -> int:
        new = 0
        for a in list(memo._ands):
            node = memo._ands[a]
            for r in rules:
                if r.op != node.op and r.op != "*":
                    continue
                tag = (a, r.name)
                if tag in fired:
                    continue
                fired.add(tag)
                n_before = len(memo._ands)
                added = r.apply(memo, a, ctx)
                if added:
                    memo.rule_hits[r.name] = \
                        memo.rule_hits.get(r.name, 0) + added
                    for nid in range(n_before, len(memo._ands)):
                        memo.provenance.setdefault(nid, (r.name, a))
                new += added
        return new

    while rounds < max_rounds:
        rounds += 1
        if tracer is not None and tracer.enabled:
            with tracer.span("saturate-round", round=rounds) as sp:
                new = _round()
                sp.attrs["new_alternatives"] = new
        else:
            new = _round()
        total_new += new
        if new == 0:
            break
    return {"rounds": rounds, "alternatives_added": total_new,
            "budget_exhausted": False, **memo.stats()}


def memo_fingerprint(memo: Memo, root: GroupId) -> str:
    """Content hash of the memo reachable from ``root``, invariant to group
    and AND-node numbering.

    Groups are relabeled canonically by a deterministic DFS from the root:
    within each group, members are ordered by structural key (operator,
    payload key, arity) — independent of insertion order — and their child
    groups visited in that order. The hash covers every reachable group's
    full member set, so two memos fingerprint equal iff they hold the same
    alternatives in the same equivalence classes (delta-scheduled and
    exhaustive saturation must agree here; the parity tests assert it)."""
    canon: Dict[GroupId, int] = {}
    order: List[GroupId] = []

    def label(g: GroupId) -> None:
        g = memo.find(g)
        if g not in canon:
            canon[g] = len(canon)
            order.append(g)

    def payload_key(node: AndNode):
        p = node.payload
        return p.key() if hasattr(p, "key") else p

    def member_sort_key(a: AndId):
        node = memo._ands[a]
        return (node.op, repr(payload_key(node)), len(node.children))

    label(root)
    i = 0
    while i < len(order):
        g = order[i]
        i += 1
        for a in sorted(memo._groups[memo.find(g)], key=member_sort_key):
            for c in memo._ands[a].children:
                label(c)

    desc = []
    for g in order:
        mems = []
        for a in memo._groups[memo.find(g)]:
            node = memo._ands[a]
            mems.append((node.op,
                         tuple(canon[memo.find(c)] for c in node.children),
                         repr(payload_key(node))))
        desc.append(tuple(sorted(mems, key=repr)))
    return hashlib.sha256(repr(tuple(desc)).encode()).hexdigest()
