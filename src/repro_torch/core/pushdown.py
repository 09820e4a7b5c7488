"""Hash push-down optimizer (§4.4, Def. 3, Theorem 1).

Rewrites ``η_{a,m}(plan)`` by commuting the hash operator down the expression
tree so that sampling happens *before* expensive operators.  Rules:

  σ       — always push through;
  Π       — push through iff the hashed columns are pass-through projections
            (possibly under a rename);
  γ       — push through iff the hashed columns ⊆ group-by keys;
  ⋈ (FK)  — push to the fact side iff hashed column is the fact join key
            (then also prunes the dim side on its key: equality special
            case);
  ⋈ (eq)  — merge-joins on key equality push to BOTH sides (special case);
  ∪ ∩ −   — push to both sides.

Anything else blocks the push-down and the η stays put (e.g. nested
aggregates — provably NP-hard to push through, §12.4; string-transformed
keys, V22 in §7.3).  ``pushdown_report`` explains where each η landed, which
the fig-7 benchmark uses to show why V21/V22-style views don't speed up.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.relational.expr import Col
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


def push_down(p: Plan) -> Plan:
    """Recursively push every HashNode in ``p`` as deep as legal."""
    if isinstance(p, HashNode):
        pushed = _push_hash(push_down(p.child), p.cols, p.m, p.seed, p.pin_name)
        return pushed
    if isinstance(p, Scan):
        return p
    kw = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        kw[f.name] = push_down(v) if isinstance(v, Plan) else v
    return type(p)(**kw)


def _push_hash(child: Plan, cols: Tuple[str, ...], m: float, seed: int, pin_name=None) -> Plan:
    blocked = HashNode(child=child, cols=cols, m=m, seed=seed, pin_name=pin_name)

    if isinstance(child, SelectNode):
        return SelectNode(child=_push_hash(child.child, cols, m, seed, pin_name), pred=child.pred)

    if isinstance(child, ProjectNode):
        # legal iff every hashed column is a pass-through of an input column
        rename = {}
        for name, src in child.outputs:
            src_name = src if isinstance(src, str) else (src.name if isinstance(src, Col) else None)
            if src_name is not None:
                rename[name] = src_name
        if all(c in rename for c in cols):
            inner_cols = tuple(rename[c] for c in cols)
            return ProjectNode(
                child=_push_hash(child.child, inner_cols, m, seed, pin_name),
                outputs=child.outputs,
                pk=child.pk,
            )
        return blocked

    if isinstance(child, GroupByNode):
        if set(cols) <= set(child.keys):
            return GroupByNode(
                child=_push_hash(child.child, cols, m, seed, pin_name),
                keys=child.keys,
                aggs=child.aggs,
                num_groups=child.num_groups,
            )
        return blocked

    if isinstance(child, FKJoin):
        # Equality special case (Def. 3): the join enforces
        # fact.fact_key == dim.dim_key, so a hashed dim-key column can be
        # *renamed* to the fact key and pushed to the fact side — the hash
        # sees identical values.  Composite hashes push iff every column is
        # fact-side (FK joins never duplicate fact rows, §12.5) or the dim
        # key itself.
        dim_key = child.dim_key
        if dim_key is None:
            dim_pk = _leaf_pk(child.dim)
            dim_key = dim_pk[0] if dim_pk else None
        renamed = tuple(
            child.fact_key if (dim_key is not None and c == dim_key) else c
            for c in cols
        )
        if all(c == child.fact_key or _column_from_fact(child, c) for c in renamed):
            fact = _push_hash(child.fact, renamed, m, seed, pin_name)
            dim = child.dim
            if renamed == (child.fact_key,) and dim_key is not None:
                # pure join-key hash also prunes the dim side (both-sides rule)
                dim = _push_hash(child.dim, (dim_key,), m, seed, pin_name)
            return FKJoin(
                fact=fact, dim=dim, fact_key=child.fact_key, dim_key=child.dim_key,
                suffix=child.suffix,
            )
        return blocked

    if isinstance(child, OuterJoin):
        # merge-join on key equality: push to both sides (Def. 3 equality case)
        if set(cols) <= set(child.on):
            return OuterJoin(
                left=_push_hash(child.left, cols, m, seed, pin_name),
                right=_push_hash(child.right, cols, m, seed, pin_name),
                on=child.on,
                how=child.how,
                suffixes=child.suffixes,
            )
        return blocked

    if isinstance(child, (UnionNode, IntersectNode, DifferenceNode)):
        return type(child)(
            left=_push_hash(child.left, cols, m, seed, pin_name),
            right=_push_hash(child.right, cols, m, seed, pin_name),
        )

    if isinstance(child, (Scan, HashNode)):
        return HashNode(child=child, cols=cols, m=m, seed=seed, pin_name=pin_name)

    return blocked


def _leaf_pk(p: Plan):
    from repro_torch.relational.plan import plan_pk

    try:
        return plan_pk(p)
    except Exception:
        return None


def _column_from_fact(join: FKJoin, colname: str) -> bool:
    """Heuristic schema check: does ``colname`` come from the fact side?"""
    from repro_torch.relational.plan import _plan_columns_guess

    fact_cols = _plan_columns_guess(join.fact)
    dim_cols = _plan_columns_guess(join.dim)
    return colname in fact_cols and colname not in dim_cols


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------

def hash_depths(p: Plan, depth: int = 0) -> List[Tuple[int, Tuple[str, ...]]]:
    """(depth, cols) for every HashNode — deeper is better (more is sampled)."""
    out = []
    if isinstance(p, HashNode):
        out.append((depth, p.cols))
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, Plan):
            out.extend(hash_depths(v, depth + 1))
    return out


def fully_pushed(p: Plan) -> bool:
    """True if every HashNode sits directly above a Scan leaf."""
    ok = True
    if isinstance(p, HashNode):
        ok = isinstance(p.child, Scan)
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, Plan):
            ok = ok and fully_pushed(v)
    return ok


def pushdown_report(original: Plan, optimized: Plan) -> str:
    lines = ["hash push-down report:"]
    lines.append(f"  original hash depths: {hash_depths(original)}")
    lines.append(f"  optimized hash depths: {hash_depths(optimized)}")
    lines.append(f"  fully pushed to leaves: {fully_pushed(optimized)}")
    return "\n".join(lines)
