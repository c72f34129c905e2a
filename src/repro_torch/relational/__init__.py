"""Relational substrate: columnar torch tables, algebra, simulated DB env."""

from .table import Field, Schema, Table, resolve_device
from .algebra import (
    AggSpec, Aggregate, Arith, BoolOp, Cmp, Col, Func, Join, Limit, Lit, Not,
    OrderBy, Param, Project, Query, Scalar, Scan, Select, equi_join_indices,
    register_scalar_func,
)
from .database import (
    ClientEnv, DatabaseServer, FAST_LOCAL, NetworkProfile, QueryEstimate,
    SLOW_REMOTE, ServerModel, TableStats,
)

__all__ = [
    "Field", "Schema", "Table", "resolve_device",
    "AggSpec", "Aggregate", "Arith", "BoolOp", "Cmp", "Col", "Func", "Join",
    "Limit", "Lit", "Not", "OrderBy", "Param", "Project", "Query", "Scalar",
    "Scan", "Select", "equi_join_indices", "register_scalar_func",
    "ClientEnv", "DatabaseServer", "FAST_LOCAL", "NetworkProfile",
    "QueryEstimate", "SLOW_REMOTE", "ServerModel", "TableStats",
]
