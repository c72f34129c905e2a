"""Optimizer configuration for the session API.

``OptimizerConfig`` unifies the three knobs that were previously scattered
across ``optimize()`` keyword arguments and module-level constants in
``core.search``:

  * **rule selection** — which transformation rules participate in memo
    saturation: ``rule_set`` plugs in a :class:`~repro_torch.api.rules.RuleSet`
    (the public registry — user rules registered there fire alongside the
    Fig. 11 built-ins; ``None`` = ``RuleSet.default()``), then ``rules=`` /
    ``exclude_rules=`` select by name within it
    (``exclude_rules=("T3",)`` = the paper's Experiment 1–3 alternative
    space {P0, P1, P2});
  * **cost model** — ``cost_model`` accepts any class implementing the
    :class:`~repro_torch.core.cost.CostModel` protocol, constructed as
    ``cost_model(db, catalog, context)``; ``None`` = the built-in Sec. VI
    model;
  * **cost-choice strategy** — ``"cost"`` (Cobra) or ``"heuristic"``
    (the [4]-style maximal-SQL-push comparator, Fig. 15's baseline);
  * **search budgets** — top-K plans per memo group, the cross-product
    bound at combination points, and the saturation round limit.

Presets mirror the paper's experiments::

    OptimizerConfig.preset("paper-exp1-3")   # no T3: {P0, P1, P2} space
    OptimizerConfig.preset("full")           # every rule (beyond-paper T3∘T4j)
    OptimizerConfig.preset("heuristic")      # Fig. 15 baseline comparator
    OptimizerConfig.preset("wilos")          # Experiment 4: full rules

The config is hashable via :meth:`cache_key` so a ``CobraSession`` can key
its plan cache on it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = ["OptimizerConfig", "PRESETS"]

# fingerprint-only copy of the built-in registry: never handed to callers
# (resolve_rule_set returns fresh copies precisely so user mutation cannot
# leak across sessions), so caching it here is safe
_DEFAULT_RULESET = None


def _default_ruleset():
    global _DEFAULT_RULESET
    if _DEFAULT_RULESET is None:
        from .rules import RuleSet
        _DEFAULT_RULESET = RuleSet.default()
    return _DEFAULT_RULESET


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Rule selection + cost-choice strategy + search budgets.

    Database/network cost-catalog knobs (C_NRT, BW, C_Z, AF_Q, ...) stay in
    ``core.cost.CostCatalog`` — the catalog describes the *environment*, this
    config describes the *optimizer*.
    """

    choice: str = "cost"                      # "cost" | "heuristic"
    rules: Optional[Tuple[str, ...]] = None   # rule names; None = full set
    exclude_rules: Tuple[str, ...] = ()       # subtracted from the above
    rule_set: Optional[object] = None         # api.rules.RuleSet; None = default
    cost_model: Optional[type] = None         # CostModel-protocol class; None = built-in
    topk: int = 4                             # plans kept per memo group
    max_combos: int = 4096                    # combination cross-product bound
    max_rounds: int = 64                      # saturation round limit
    # compile-time saturation budgets (None = unbudgeted). When either
    # trips mid-saturation the search degrades to greedy best-first over
    # the partial memo and the plan reports `budget_exhausted` — never an
    # error. Budgets change which plan can be found, so they are part of
    # cache_key(); the unbudgeted result is unchanged.
    node_budget: Optional[int] = None         # cap on memo AND-nodes
    wall_budget_s: Optional[float] = None     # cap on saturation wall clock
    use_plan_cache: bool = True               # sessions may bypass the cache
    # promote a (program, plan, context) pair to the compiled execution tier
    # after this many interpreted invocations (None = compiled tier off).
    # An EXECUTION-tier knob, not plan identity: compiled and interpreted
    # executions are bit-identical, so it is deliberately NOT part of
    # cache_key() — flipping it must not invalidate cached/stored plans.
    compile_hot_plans: Optional[int] = None

    def __post_init__(self):
        if self.choice not in ("cost", "heuristic"):
            raise ValueError(f"choice must be 'cost' or 'heuristic', got {self.choice!r}")
        if self.compile_hot_plans is not None and self.compile_hot_plans < 1:
            raise ValueError("compile_hot_plans must be >= 1 (or None: "
                             "compiled tier disabled)")
        if self.node_budget is not None and self.node_budget < 1:
            raise ValueError("node_budget must be >= 1 (or None: unbudgeted)")
        if self.wall_budget_s is not None and self.wall_budget_s <= 0:
            raise ValueError("wall_budget_s must be > 0 (or None: "
                             "unbudgeted)")
        if isinstance(self.rules, list):
            object.__setattr__(self, "rules", tuple(self.rules))
        if isinstance(self.exclude_rules, list):
            object.__setattr__(self, "exclude_rules", tuple(self.exclude_rules))
        if self.cost_model is not None and not callable(self.cost_model):
            raise TypeError("cost_model must be a CostModel-protocol class "
                            "(constructed as cost_model(db, catalog, context))")

    # ------------------------------------------------------------ resolution
    def resolve_rule_set(self):
        """The :class:`~repro_torch.api.rules.RuleSet` this config draws from."""
        from .rules import RuleSet
        if self.rule_set is not None:
            if not isinstance(self.rule_set, RuleSet):
                raise TypeError(f"rule_set must be a repro_torch.api.RuleSet, got "
                                f"{type(self.rule_set).__name__}")
            return self.rule_set
        return RuleSet.default()

    def resolve_rules(self) -> List:
        """Materialize the (core-engine) rule objects this config selects,
        in constraint-resolved firing order (declared ``before``/``after``
        on the selected rules are honored via ``RuleSet.resolve``)."""
        rs = self.resolve_rule_set()
        by_name = {r.name: r for r in rs}
        if self.rules is None:
            names = list(rs.names())
        else:
            unknown = [n for n in self.rules if n not in by_name]
            if unknown:
                raise ValueError(f"unknown rule name(s): {unknown}; "
                                 f"available: {sorted(by_name)}")
            names = list(self.rules)
        names = [n for n in names if n not in self.exclude_rules]
        return [r.to_dag_rule() for r in rs.resolve(names)]

    def rule_names(self) -> Tuple[str, ...]:
        return tuple(r.name for r in self.resolve_rules())

    def _rules_key(self) -> Tuple:
        """(name, revision, phase) triples of the selected rules — a user
        rule's revision is a source hash, so editing its body (or moving it
        to another saturation phase) changes every cache key it
        participated in.

        Runs on EVERY compile (plan-cache hits included), so it avoids
        materializing rule objects: for the default registry a module-level
        read-only copy is fingerprinted (rebuilding it per call doubled the
        warm-compile wall clock); a custom ``rule_set`` is fingerprinted
        live, since its registry is mutable (latest-wins ``register``)."""
        rs = _default_ruleset() if self.rule_set is None \
            else self.resolve_rule_set()     # type-checks, returns it as-is
        names = rs.names() if self.rules is None else self.rules
        return rs.fingerprint(tuple(n for n in names
                                    if n not in self.exclude_rules))

    def _cost_model_key(self) -> Tuple:
        if self.cost_model is None:
            return ("cost-model", "builtin")
        cm = self.cost_model
        rev = getattr(cm, "revision", None)
        if rev is None:
            # same safeguard user rules get: editing the model's body must
            # invalidate every (persistent) plan it costed; set a `revision`
            # class attribute to pin identity across cosmetic edits
            from .rules import _source_revision
            rev = _source_revision(cm)
        return ("cost-model",
                f"{cm.__module__}.{getattr(cm, '__qualname__', cm)}", rev)

    def budget(self):
        """The :class:`~repro_torch.core.dag.Budget` this config implies, or
        ``None`` when unbudgeted."""
        if self.node_budget is None and self.wall_budget_s is None:
            return None
        from ..core.dag import Budget
        return Budget(node_budget=self.node_budget,
                      wall_budget_s=self.wall_budget_s)

    def cache_key(self) -> Tuple:
        """Stable identity for plan-cache keying."""
        return ("cfg", self.choice, self._rules_key(), self._cost_model_key(),
                self.topk, self.max_combos, self.max_rounds,
                self.node_budget, self.wall_budget_s)

    # --------------------------------------------------------------- presets
    @classmethod
    def preset(cls, name: str, **overrides) -> "OptimizerConfig":
        try:
            base = PRESETS[name]
        except KeyError:
            raise ValueError(f"unknown preset {name!r}; "
                             f"available: {sorted(PRESETS)}") from None
        return dataclasses.replace(base, **overrides) if overrides else base


PRESETS = {
    # Full Fig. 11 rule set, cost-based choice (includes the beyond-paper
    # T3 ∘ T4j projection-pushed join).
    "full": OptimizerConfig(),
    # Experiments 1-3: the paper's alternative space {P0, P1, P2} is
    # generated without rule composition via T3.
    "paper-exp1-3": OptimizerConfig(exclude_rules=("T3",)),
    # Fig. 15 "Heuristic" bars: push as much into SQL as possible, never
    # prefetch.
    "heuristic": OptimizerConfig(choice="heuristic"),
    # Experiment 4 (Wilos patterns A-F): full rules, cost-based.
    "wilos": OptimizerConfig(),
}
