"""Public rule registry: named, documented, user-registerable transformations.

Cobra's claim is a *framework*: alternatives are generated by a given set of
program transformations and the least-cost one wins. This module makes that
set first-class API instead of a closed list inside ``core/rules.py``:

    from repro_torch.api import RuleSet, cobra_rule, slot_view, add_slot_variant

    @cobra_rule("my-widen", match="slot-project",
                doc="rewrite fold sources my way")
    def my_widen(memo, and_id, ctx):
        s = slot_view(memo, and_id)
        if s is None:
            return 0                       # no match
        var, i, prefetches, fold = s.var, s.index, s.prefetches, s.fold
        ...build a rewritten payload...
        return add_slot_variant(memo, and_id, var, i, new_payload, ctx, fold)

    rules = RuleSet.default().with_rule(my_widen)
    session = CobraSession(db, catalog,
                          config=OptimizerConfig(rule_set=rules))

A rule is a **match/apply pair over memo nodes**: ``match`` names the
AND-node operator it fires on (``"slot-project"`` for fold slots, ``"loop"``
for raw cursor loops, ``"*"`` for everything), and the function body applies
the transformation by inserting alternatives into the node's group —
returning how many it added (0 = no match). Registered rules participate in
memo saturation exactly like the built-in Fig. 11 set, and their identity
(name + a source-hash revision) participates in plan fingerprints and
plan-cache/plan-store keys, so editing a rule's body invalidates plans it
helped produce.

``RuleSet`` instances are immutable-by-convention value objects: ``default()``
returns a fresh copy of the built-in registry; ``with_rule`` / ``without`` /
``subset`` derive new sets. ``OptimizerConfig.rule_set`` plugs a set into a
session; the config's ``rules=`` / ``exclude_rules=`` name filters then
select within it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.dag import Memo, Rule
from ..core.rules import _add_slot_variant, _slot, default_rules

__all__ = ["CobraRule", "RuleSet", "cobra_rule", "slot_view",
           "add_slot_variant", "SlotView"]


def _source_revision(fn: Callable) -> str:
    """Content hash of a rule function's source — editing the body changes
    the rule's identity, so plan caches never serve plans produced by an
    older behavior under the same name. Falls back to the qualified name
    when source is unavailable (REPL, exec)."""
    try:
        src = inspect.getsource(fn)
    except (OSError, TypeError):
        src = getattr(fn, "__qualname__", repr(fn))
    return hashlib.sha256(src.encode()).hexdigest()[:12]


@dataclasses.dataclass(frozen=True)
class CobraRule:
    """A named transformation: match operator + apply function + identity.

    ``before``/``after`` declare ordering constraints against other rule
    NAMES: within one saturation round this rule fires before every rule
    in ``before`` and after every rule in ``after``.
    :meth:`RuleSet.resolve` honors them with a stable topological sort
    (cycles are an error); constraints naming absent rules are ignored, so
    a rule may order itself against an optional/excluded peer.

    ``phase`` assigns the rule to one saturation phase —
    ``"normalize"`` → ``"explore"`` (default) → ``"cleanup"`` — and each
    phase runs to its own fixpoint (see :data:`repro_torch.core.dag.PHASES`).
    Ordering constraints only apply within a phase; a ``before=`` naming a
    rule in an earlier phase cannot be honored and is an error at
    :meth:`RuleSet.resolve` time."""

    name: str
    match: str                     # AND-node operator ("slot-project", "loop", "*")
    fn: Callable                   # (memo, and_id, ctx) -> int  alternatives added
    doc: str = ""
    revision: str = "builtin"      # cache-key component; source hash for user rules
    before: Tuple[str, ...] = ()   # rules this one must precede
    after: Tuple[str, ...] = ()    # rules this one must follow
    phase: str = "explore"         # saturation phase (normalize|explore|cleanup)

    def __post_init__(self):
        from ..core.dag import PHASES
        if self.phase not in PHASES:
            raise ValueError(f"unknown rule phase {self.phase!r}; "
                             f"must be one of {PHASES}")

    def to_dag_rule(self) -> Rule:
        return Rule(self.name, self.match, self.fn, phase=self.phase)

    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.name, self.revision, self.phase)

    def describe(self) -> str:
        order = "".join(
            [f" before={list(self.before)}" if self.before else "",
             f" after={list(self.after)}" if self.after else ""])
        return (f"{self.name} [{self.match}/{self.phase}] "
                f"rev {self.revision}{order}: {self.doc}")


def cobra_rule(name: Optional[str] = None, *, match: str = "slot-project",
               doc: Optional[str] = None, revision: Optional[str] = None,
               before: Sequence[str] = (), after: Sequence[str] = (),
               phase: str = "explore"):
    """Decorator: wrap a match/apply function over memo nodes as a
    :class:`CobraRule`.

    The decorated function has the same contract as the built-in rules —
    ``fn(memo, and_id, ctx) -> int`` — matching AND-nodes whose operator is
    ``match`` and inserting alternatives into their group (use
    :func:`slot_view` / :func:`add_slot_variant` for the common
    ``slot-project`` shape). ``revision`` overrides the automatic
    source-hash identity (pin it to keep plan caches warm across cosmetic
    edits). ``before``/``after`` name rules this one must precede/follow in
    each saturation round (resolved by topological sort; a cycle raises at
    :meth:`RuleSet.resolve` time). ``phase`` picks the saturation phase
    (``normalize`` → ``explore`` → ``cleanup``; each runs to its own
    fixpoint — normalization rules fire to completion before exploration
    starts)."""
    def deco(fn: Callable) -> CobraRule:
        return CobraRule(
            name=name or fn.__name__, match=match, fn=fn,
            doc=doc if doc is not None else (inspect.getdoc(fn) or ""),
            revision=revision or _source_revision(fn),
            before=tuple(before), after=tuple(after), phase=phase)

    return deco


# --------------------------------------------------------------------------
# Helpers for writing slot rules without reaching into core internals
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SlotView:
    """A destructured ``slot-project`` memo node: the accumulator variable,
    its tuple-slot index, any prefetch parts, and the fold expression."""

    var: str
    index: int
    prefetches: Tuple
    fold: object                   # core.fir.FFoldE


def slot_view(memo: Memo, and_id: int) -> Optional[SlotView]:
    """View a ``slot-project`` AND-node's payload; None when the node is not
    a slot (the standard no-match early exit for slot rules)."""
    s = _slot(memo, and_id)
    if s is None:
        return None
    _node, var, i, pre, fold = s
    return SlotView(var=var, index=i, prefetches=tuple(pre), fold=fold)


def add_slot_variant(memo: Memo, and_id: int, var: str, i: int, payload,
                     ctx=None, old_fold=None) -> int:
    """Insert a rewritten slot payload as a new alternative of the node's
    group (propagating emptiness facts from ``old_fold`` so slot-extraction
    rules can keep firing on the variant). Returns 1, the number of
    alternatives added — rule functions return it directly."""
    return _add_slot_variant(memo, and_id, var, i, payload, ctx, old_fold)


# --------------------------------------------------------------------------
# The registry
# --------------------------------------------------------------------------

class RuleSet:
    """An ordered, named registry of :class:`CobraRule` objects."""

    def __init__(self, rules: Sequence[CobraRule] = (), name: str = "custom"):
        self.name = name
        self._rules: Dict[str, CobraRule] = {}
        for r in rules:
            self.register(r)

    # ---------------------------------------------------------- construction
    @classmethod
    def default(cls) -> "RuleSet":
        """The built-in Fig. 11 transformation set (fresh copy — mutating it
        never affects other sessions)."""
        rs = cls(name="default")
        for r in default_rules():
            rs.register(CobraRule(name=r.name, match=r.op, fn=r.fn,
                                  doc=(inspect.getdoc(r.fn) or "").split("\n")[0],
                                  revision="builtin", phase=r.phase))
        return rs

    def register(self, rule=None, **cobra_rule_kw):
        """Add a rule. Three forms::

            rs.register(my_cobra_rule)           # a CobraRule object
            rs.register(dag_rule)                # a core.dag.Rule (back-compat)

            @rs.register(name="r", match="loop") # decorator form
            def r(memo, and_id, ctx): ...

        Registering a name twice replaces the previous rule (latest wins),
        so iterating on a rule in one session behaves as expected."""
        if rule is None:
            def deco(fn):
                return self.register(cobra_rule(**cobra_rule_kw)(fn))
            return deco
        if isinstance(rule, Rule):
            rule = CobraRule(name=rule.name, match=rule.op, fn=rule.fn,
                             revision=_source_revision(rule.fn),
                             phase=rule.phase)
        if not isinstance(rule, CobraRule):
            raise TypeError(f"register() takes a CobraRule or core Rule, "
                            f"got {type(rule).__name__}")
        self._rules[rule.name] = rule
        return rule

    def with_rule(self, *rules: CobraRule) -> "RuleSet":
        """A new set with ``rules`` appended (the non-mutating form)."""
        out = RuleSet(self._rules.values(), name=self.name)
        for r in rules:
            out.register(r)
        return out

    def without(self, *names: str) -> "RuleSet":
        return RuleSet([r for r in self._rules.values() if r.name not in names],
                       name=self.name)

    def subset(self, *names: str) -> "RuleSet":
        unknown = [n for n in names if n not in self._rules]
        if unknown:
            raise KeyError(f"unknown rule name(s) {unknown}; "
                           f"available: {sorted(self._rules)}")
        return RuleSet([self._rules[n] for n in names], name=self.name)

    # --------------------------------------------------------------- lookup
    def names(self) -> Tuple[str, ...]:
        return tuple(self._rules)

    def rule(self, name: str) -> CobraRule:
        try:
            return self._rules[name]
        except KeyError:
            raise KeyError(f"no rule named {name!r}; "
                           f"available: {sorted(self._rules)}") from None

    def rules(self) -> List[CobraRule]:
        return list(self._rules.values())

    def resolve(self, names: Optional[Sequence[str]] = None
                ) -> List[CobraRule]:
        """The selected rules in FIRING order: registry order, reordered
        only as needed to honor declared ``before=``/``after=`` constraints
        (stable topological sort — unconstrained rules keep their relative
        registry positions). ``names`` restricts (and pre-orders) the
        selection; constraints naming rules outside it are ignored; a
        constraint cycle raises ``ValueError`` naming its members."""
        if names is None:
            selected = list(self._rules.values())
        else:
            # dedup while keeping first position: the graph is keyed per
            # NAME, so a repeated selection must not desync Kahn's output
            # length from the selection (which would misreport a cycle)
            seen: set = set()
            selected = [self._rules[n] for n in names
                        if n in self._rules
                        and not (n in seen or seen.add(n))]
        present = {r.name for r in selected}
        phase_of = {r.name: r.phase for r in selected}
        from ..core.dag import PHASES
        phase_rank = {p: i for i, p in enumerate(PHASES)}
        # successor edges: a -> b  means  a fires before b. Phases run as
        # separate fixpoints, so a cross-phase constraint is either already
        # satisfied by the phase order (drop the edge) or impossible (error)
        succs: Dict[str, set] = {r.name: set() for r in selected}
        indeg: Dict[str, int] = {r.name: 0 for r in selected}

        def edge(first: str, then: str) -> None:
            d = phase_rank[phase_of[first]] - phase_rank[phase_of[then]]
            if d > 0:
                raise ValueError(
                    f"rule {first!r} (phase {phase_of[first]!r}) is "
                    f"constrained to fire before {then!r} (phase "
                    f"{phase_of[then]!r}), but its phase runs later; move "
                    f"one of them or drop the constraint")
            if d == 0 and then not in succs[first]:
                succs[first].add(then)
                indeg[then] += 1

        for r in selected:
            for b in r.before:
                if b in present:
                    edge(r.name, b)
            for a in r.after:
                if a in present:
                    edge(a, r.name)
        order = {r.name: i for i, r in enumerate(selected)}
        by_name = {r.name: r for r in selected}
        out: List[CobraRule] = []
        ready = [r for r in selected if indeg[r.name] == 0]
        while ready:
            r = ready.pop(0)           # registry-order stable (Kahn)
            out.append(r)
            newly = []
            for s in succs[r.name]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    newly.append(by_name[s])
            ready = sorted(ready + newly, key=lambda x: order[x.name])
        if len(out) != len(selected):
            cyclic = sorted(n for n, d in indeg.items() if d > 0)
            raise ValueError(
                f"rule ordering constraints form a cycle involving "
                f"{cyclic}; relax the before=/after= declarations on these "
                f"rules so a linear firing order exists")
        return out

    def dag_rules(self) -> List[Rule]:
        """The core-engine view, as consumed by ``expand``/``run_search``
        (constraint-resolved firing order)."""
        return [r.to_dag_rule() for r in self.resolve()]

    def __len__(self) -> int:
        return len(self._rules)

    def __contains__(self, name: str) -> bool:
        return name in self._rules

    def __iter__(self):
        return iter(self._rules.values())

    # ------------------------------------------------------------- identity
    def fingerprint(self, names: Optional[Sequence[str]] = None) -> Tuple:
        """Cache-key component: (name, revision, phase) per rule, in
        registry order. ``names`` restricts to a config's selected subset."""
        sel = self._rules.values() if names is None else \
            [self._rules[n] for n in names if n in self._rules]
        return tuple(r.fingerprint() for r in sel)

    def describe(self) -> str:
        lines = [f"RuleSet {self.name!r} ({len(self)} rules):"]
        lines += [f"  {r.describe()}" for r in self._rules.values()]
        return "\n".join(lines)
