"""Relational expression trees (plans) with primary-key propagation.

This is the symbolic layer of SVC: view definitions and maintenance
strategies (§3.1) are plans; the hash operator η (§4.4) is a plan node; the
push-down optimizer (core/pushdown.py) rewrites plans per Def. 3.

Primary keys propagate by Def. 2 so that every derived row is uniquely
identified — the prerequisite for provenance-respecting sampling (§4.2/4.3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.relational.expr import Col, Expr


@dataclasses.dataclass(frozen=True)
class Plan:
    pass


@dataclasses.dataclass(frozen=True)
class Scan(Plan):
    name: str
    pk: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class SelectNode(Plan):
    child: Plan
    pred: Expr


@dataclasses.dataclass(frozen=True)
class ProjectNode(Plan):
    child: Plan
    # (output name, source): source is an input column name or an Expr
    outputs: Tuple[Tuple[str, object], ...]
    pk: Optional[Tuple[str, ...]] = None  # rename of pk, if projected under new names


@dataclasses.dataclass(frozen=True)
class FKJoin(Plan):
    fact: Plan
    dim: Plan
    fact_key: str
    dim_key: Optional[str] = None
    suffix: str = "_r"


@dataclasses.dataclass(frozen=True)
class OuterJoin(Plan):
    left: Plan
    right: Plan
    on: Tuple[str, ...]
    how: str = "outer"
    suffixes: Tuple[str, str] = ("", "_r")


@dataclasses.dataclass(frozen=True)
class GroupByNode(Plan):
    child: Plan
    keys: Tuple[str, ...]
    # (out name, fn, value col name | Expr | None)
    aggs: Tuple[Tuple[str, str, object], ...]
    num_groups: int


@dataclasses.dataclass(frozen=True)
class UnionNode(Plan):
    left: Plan
    right: Plan


@dataclasses.dataclass(frozen=True)
class IntersectNode(Plan):
    left: Plan
    right: Plan


@dataclasses.dataclass(frozen=True)
class DifferenceNode(Plan):
    left: Plan
    right: Plan


@dataclasses.dataclass(frozen=True)
class HashNode(Plan):
    """η_{a,m}(R): keep rows whose key-hash ≤ m (§4.4).

    ``pin_name`` optionally references an env relation of key values whose
    rows are *always* kept (the outlier-index push-up, Def. 5): the sample
    predicate becomes ``hash(a) ≤ m ∨ a ∈ pin``.  Membership on the same key
    columns obeys exactly the same commutation rules as η itself.
    """

    child: Plan
    cols: Tuple[str, ...]
    m: float
    seed: int = 0
    pin_name: Optional[str] = None


# ---------------------------------------------------------------------------
# Primary-key propagation (Def. 2)
# ---------------------------------------------------------------------------

def plan_pk(p: Plan) -> Tuple[str, ...]:
    if isinstance(p, Scan):
        return p.pk
    if isinstance(p, (SelectNode, HashNode)):
        return plan_pk(p.child)
    if isinstance(p, ProjectNode):
        if p.pk is not None:
            return p.pk
        child_pk = plan_pk(p.child)
        out_names = {name for name, _ in p.outputs}
        # pk must be retained under its own name
        passthrough = set()
        for name, src in p.outputs:
            src_name = src if isinstance(src, str) else (src.name if isinstance(src, Col) else None)
            if src_name is not None and name == src_name:
                passthrough.add(name)
        for k in child_pk:
            if k not in out_names or k not in passthrough:
                raise ValueError(
                    f"projection drops pk column {k!r}; pass pk= to rename (Def. 2)"
                )
        return child_pk
    if isinstance(p, FKJoin):
        fact_pk = plan_pk(p.fact)
        dim_pk = plan_pk(p.dim)
        # dim pk may be renamed by suffix on collision; mirror ops.fk_join
        return fact_pk + tuple(k if k not in _plan_columns_guess(p.fact) else k + p.suffix for k in dim_pk)
    if isinstance(p, OuterJoin):
        # merge-join on key equality: the shared key is the pk
        return p.on
    if isinstance(p, GroupByNode):
        return p.keys
    if isinstance(p, (UnionNode, IntersectNode)):
        return plan_pk(p.left)
    if isinstance(p, DifferenceNode):
        return plan_pk(p.left)
    raise TypeError(p)


def _plan_columns_guess(p: Plan):
    """Best-effort set of output column names (for suffix collision checks)."""
    if isinstance(p, Scan):
        return set(p.pk)  # callers may not know full schema statically
    if isinstance(p, (SelectNode, HashNode)):
        return _plan_columns_guess(p.child)
    if isinstance(p, ProjectNode):
        return {name for name, _ in p.outputs}
    if isinstance(p, GroupByNode):
        return set(p.keys) | {name for name, _, _ in p.aggs}
    if isinstance(p, FKJoin):
        return _plan_columns_guess(p.fact) | _plan_columns_guess(p.dim)
    if isinstance(p, OuterJoin):
        return _plan_columns_guess(p.left) | _plan_columns_guess(p.right) | set(p.on)
    if isinstance(p, (UnionNode, IntersectNode, DifferenceNode)):
        return _plan_columns_guess(p.left)
    raise TypeError(p)


def plan_leaves(p: Plan):
    """All Scan leaves of a plan."""
    if isinstance(p, Scan):
        return [p]
    out = []
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, Plan):
            out.extend(plan_leaves(v))
    return out


def substitute(p: Plan, mapping) -> Plan:
    """Rename Scan leaves: mapping name -> new name (or Plan to splice in)."""
    if isinstance(p, Scan):
        repl = mapping.get(p.name)
        if repl is None:
            return p
        if isinstance(repl, Plan):
            return repl
        return Scan(name=repl, pk=p.pk)
    kw = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        kw[f.name] = substitute(v, mapping) if isinstance(v, Plan) else v
    return type(p)(**kw)
