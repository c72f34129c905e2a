"""Cobra core: regions, F-IR, Region AND-OR DAG, rules, cost model, search.

The paper's primary contribution — cost-based rewriting of database
applications via a Volcano/Cascades memo over program regions.
"""

from .regions import (Assign, BasicBlock, BreakStmt, CacheByColumn,
                      CollectionAdd, CondRegion, ContinueStmt, IBin,
                      ICacheLookup, ICall, IConst, IEmptyList, IEmptyMap,
                      IField, IIndex, ILoadAll, INav, Interpreter, IQuery,
                      IQueryValues, IScalarQuery, IVar, LoopRegion, MapPut,
                      NoOp, Prefetch, Program, Region, ReturnStmt, SeqRegion,
                      UpdateRow, WhileRegion, register_function, seq)
from .fir import (FIRConversionError, eval_fir, fir_to_region, loop_to_fir)
from .dag import AndNode, Memo, Rule, expand
from .rules import RuleContext, build_memo, default_rules
from .context import (ExecutionContext, ONE_SHOT, StatsProfile,
                      loop_site_key, param_group_key, query_site_key,
                      while_site_key)
from .cost import CostCatalog, CostModel, query_has_params
from .search import OptimizationResult, Plan, optimize, run_search

__all__ = [
    "Assign", "BasicBlock", "BreakStmt", "CacheByColumn", "CollectionAdd",
    "CondRegion", "ContinueStmt", "IBin", "ICacheLookup", "ICall", "IConst",
    "IEmptyList", "IEmptyMap", "IField", "IIndex", "ILoadAll", "INav",
    "Interpreter", "IQuery", "IQueryValues", "IScalarQuery", "IVar",
    "LoopRegion", "MapPut", "NoOp", "Prefetch", "Program", "Region",
    "ReturnStmt", "SeqRegion", "UpdateRow", "WhileRegion",
    "register_function", "seq",
    "FIRConversionError", "eval_fir", "fir_to_region", "loop_to_fir",
    "AndNode", "Memo", "Rule", "expand", "RuleContext", "build_memo",
    "default_rules",
    "ExecutionContext", "ONE_SHOT", "StatsProfile", "loop_site_key",
    "param_group_key", "query_site_key", "while_site_key",
    "CostCatalog", "CostModel", "query_has_params",
    "OptimizationResult", "Plan", "optimize", "run_search",
]
