"""Tiny column-expression AST (copy of ``repro.relational.expr`` for torch).

Used for Select predicates and generalized Projection (Π with arithmetic,
§3.1).  Expressions are hashable/frozen so plans can be compared and the
push-down planner can inspect which columns an expression touches.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Expr:
    pass


@dataclasses.dataclass(frozen=True)
class Col(Expr):
    name: str


@dataclasses.dataclass(frozen=True)
class Lit(Expr):
    value: Any


@dataclasses.dataclass(frozen=True)
class Bin(Expr):
    op: str  # add | sub | mul | div | mod | min | max
    a: Expr
    b: Expr


@dataclasses.dataclass(frozen=True)
class Cmp(Expr):
    op: str  # lt | le | gt | ge | eq | ne
    a: Expr
    b: Expr


@dataclasses.dataclass(frozen=True)
class Boolean(Expr):
    op: str  # and | or | not
    args: Tuple[Expr, ...]


@dataclasses.dataclass(frozen=True)
class IsNotNull(Expr):
    """True where the row's value is considered present.

    In the columnar engine null-ness is carried by per-column presence masks
    created by outer joins (column ``name + '__present'`` when it exists).
    """

    name: str


def _minimum(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = _as_tensor_pair(a, b)
        return torch.minimum(a, b)
    return min(a, b)


def _maximum(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a, b = _as_tensor_pair(a, b)
        return torch.maximum(a, b)
    return max(a, b)


def _as_tensor_pair(a, b):
    ref = a if isinstance(a, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, dtype=ref.dtype, device=ref.device)
    return a, b


_BIN = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "mod": lambda a, b: a % b,
    "min": _minimum,
    "max": _maximum,
}

_CMP = {
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
}


def eval_expr(e: Expr, columns):
    """Evaluate an expression against a dict of torch columns."""
    if isinstance(e, Col):
        return columns[e.name]
    if isinstance(e, Lit):
        return e.value
    if isinstance(e, Bin):
        return _BIN[e.op](eval_expr(e.a, columns), eval_expr(e.b, columns))
    if isinstance(e, Cmp):
        return _CMP[e.op](eval_expr(e.a, columns), eval_expr(e.b, columns))
    if isinstance(e, Boolean):
        vals = [eval_expr(a, columns) for a in e.args]
        if e.op == "and":
            out = vals[0]
            for v in vals[1:]:
                out = out & v
            return out
        if e.op == "or":
            out = vals[0]
            for v in vals[1:]:
                out = out | v
            return out
        if e.op == "not":
            return ~vals[0]
        raise ValueError(e.op)
    if isinstance(e, IsNotNull):
        present = e.name + "__present"
        if present in columns:
            return columns[present].to(torch.bool)
        first = next(iter(columns.values()))
        return torch.ones(first.shape, dtype=torch.bool, device=first.device)
    raise TypeError(f"unknown expr {e!r}")


def expr_columns(e: Expr) -> frozenset:
    """Set of column names an expression reads (for push-down legality)."""
    if isinstance(e, Col):
        return frozenset([e.name])
    if isinstance(e, Lit):
        return frozenset()
    if isinstance(e, (Bin, Cmp)):
        return expr_columns(e.a) | expr_columns(e.b)
    if isinstance(e, Boolean):
        out = frozenset()
        for a in e.args:
            out |= expr_columns(a)
        return out
    if isinstance(e, IsNotNull):
        return frozenset([e.name])
    raise TypeError(f"unknown expr {e!r}")


# -- small sugar -------------------------------------------------------------

def col(name: str) -> Col:
    return Col(name)


def lit(v) -> Lit:
    return Lit(v)


def add(a, b):
    return Bin("add", a, b)


def sub(a, b):
    return Bin("sub", a, b)


def mul(a, b):
    return Bin("mul", a, b)


def gt(a, b):
    return Cmp("gt", a, b)


def ge(a, b):
    return Cmp("ge", a, b)


def lt(a, b):
    return Cmp("lt", a, b)


def le(a, b):
    return Cmp("le", a, b)


def eq(a, b):
    return Cmp("eq", a, b)


def and_(*args):
    return Boolean("and", tuple(args))


def or_(*args):
    return Boolean("or", tuple(args))


def not_(a):
    return Boolean("not", (a,))
