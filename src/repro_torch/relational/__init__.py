"""Columnar, fixed-capacity relational engine on torch tensors."""

from repro_torch.relational.relation import (
    Relation,
    Schema,
    SENTINEL_KEY,
    from_arrays,
    from_columns,
    empty,
    compact,
    num_valid,
    to_host,
)
from repro_torch.relational.expr import (
    Col,
    Lit,
    Bin,
    Cmp,
    Boolean,
    IsNotNull,
    eval_expr,
    expr_columns,
)
from repro_torch.relational import ops

__all__ = [
    "Relation",
    "Schema",
    "SENTINEL_KEY",
    "from_arrays",
    "from_columns",
    "empty",
    "compact",
    "num_valid",
    "to_host",
    "Col",
    "Lit",
    "Bin",
    "Cmp",
    "Boolean",
    "IsNotNull",
    "eval_expr",
    "expr_columns",
    "ops",
]
