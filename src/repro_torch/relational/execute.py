"""Plan evaluator: interprets a Plan against an environment of Relations.

PyTorch runs eagerly, so there is no compiled variant: ``execute`` is the
counterpart of both ``execute`` and ``execute_jit`` in the JAX package.
"""

from __future__ import annotations

from typing import Mapping

from repro_torch.relational import ops
from repro_torch.relational.plan import (
    DifferenceNode,
    FKJoin,
    GroupByNode,
    HashNode,
    IntersectNode,
    OuterJoin,
    Plan,
    ProjectNode,
    Scan,
    SelectNode,
    UnionNode,
)
from repro_torch.relational.relation import Relation


def execute(p: Plan, env: Mapping[str, Relation]) -> Relation:
    if isinstance(p, Scan):
        return env[p.name]
    if isinstance(p, SelectNode):
        return ops.select(execute(p.child, env), p.pred)
    if isinstance(p, ProjectNode):
        return ops.project(execute(p.child, env), dict(p.outputs), pk=p.pk)
    if isinstance(p, FKJoin):
        return ops.fk_join(
            execute(p.fact, env),
            execute(p.dim, env),
            fact_key=p.fact_key,
            dim_key=p.dim_key,
            suffix=p.suffix,
        )
    if isinstance(p, OuterJoin):
        return ops.outer_join_unique(
            execute(p.left, env),
            execute(p.right, env),
            on=p.on,
            how=p.how,
            suffixes=p.suffixes,
        )
    if isinstance(p, GroupByNode):
        aggs = {out: (fn, val) for out, fn, val in p.aggs}
        return ops.groupby(execute(p.child, env), p.keys, aggs, num_groups=p.num_groups)
    if isinstance(p, UnionNode):
        return ops.union_keyed(execute(p.left, env), execute(p.right, env))
    if isinstance(p, IntersectNode):
        return ops.intersect_keyed(execute(p.left, env), execute(p.right, env))
    if isinstance(p, DifferenceNode):
        return ops.difference_keyed(execute(p.left, env), execute(p.right, env))
    if isinstance(p, HashNode):
        from repro_torch.core import hashing

        child = execute(p.child, env)
        pin = env.get(p.pin_name) if p.pin_name else None
        return hashing.apply_hash(child, p.cols, p.m, p.seed, pin=pin)
    raise TypeError(p)
