"""Cobra's public API: session, config, tracing frontend, plan cache.

    from repro_torch.api import CobraSession, OptimizerConfig, ProgramBuilder, q

    session = CobraSession(db, CostCatalog(SLOW_REMOTE),
                           config=OptimizerConfig.preset("paper-exp1-3"))
    exe = session.compile(program)     # memo search once, then cached
    out = exe.run()                    # execute-many

See ``examples/quickstart.py`` for the end-to-end walkthrough and
``repro_torch.api.builder`` for the tracing program frontend.
"""

from ..core.context import ExecutionContext, ONE_SHOT, StatsProfile
from ..core.cost import CostModel
from .builder import Expr, ProgramBuilder, Q, VarHandle, col, param, q
from .cache import (PlanCache, PlanCacheKey, program_fingerprint,
                    program_param_sites, program_read_tables, program_sites,
                    program_tables, program_write_tables, query_tables)
from .config import OptimizerConfig, PRESETS
from .lift import (LiftError, cache_by_column, cache_lookup, lift_program,
                   lift_source, load_all, noop, prefetch, query_values,
                   scalar_query, update_row)
from .rules import (CobraRule, RuleSet, SlotView, add_slot_variant,
                    cobra_rule, slot_view)
from .session import CobraSession, Executable, ExecutionResult, PlanReport

__all__ = [
    "CobraSession", "Executable", "ExecutionResult", "PlanReport",
    "OptimizerConfig", "PRESETS",
    "ExecutionContext", "ONE_SHOT", "StatsProfile", "CostModel",
    "RuleSet", "CobraRule", "cobra_rule", "SlotView", "slot_view",
    "add_slot_variant",
    "ProgramBuilder", "Expr", "VarHandle", "Q", "q", "col", "param",
    "LiftError", "lift_program", "lift_source",
    "load_all", "cache_lookup", "scalar_query", "query_values",
    "prefetch", "update_row", "cache_by_column", "noop",
    "PlanCache", "PlanCacheKey", "program_fingerprint", "program_sites",
    "program_param_sites", "program_read_tables", "program_tables",
    "program_write_tables", "query_tables",
]
