"""Queries as data: encode a batch of sample-mean queries into tensors.

The per-query estimator path walks a Python ``Expr`` tree per query.  Here
the sum/count/avg × predicate query class is *encoded* — per-query op
codes, one-hot column selectors, and interval bounds packed into two
tensors — so one kernels/multi_agg pass evaluates a whole ``QueryBatch``:

  sel  ((1+P)·C, Q) f32 — row block 0 selects each query's value column
       (zero column for count); blocks 1..P select the column of each
       conjunctive predicate term.
  meta (2+4P, Q) f32 — rows [is_count; is_avg] then (ge, gt, le, lt)
       bounds per term, ±inf for unconstrained sides.

Lowerable predicates are conjunctions of comparisons between a column and
a numeric literal (``ge/gt/le/lt/eq``, either operand order); terms on the
same column merge into one interval.  Anything else (``or``, ``ne``,
column-vs-column, non-numeric literals) raises ``UnsupportedQueryError``
and the caller falls back to the per-query estimators.

Precision caveat: the engine evaluates predicates on an f32 column panel,
so integer columns compare exactly only up to 2^24 — an ``eq`` threshold
above that can match neighboring keys that the per-query path (native
dtypes) would distinguish.  SVC view keys are dense group ids, far below
that bound; re-evaluate before pointing the engine at hash-valued keys.

Q and P are padded to small power-of-two buckets, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.estimators import Query
from repro_torch.relational.expr import Boolean, Cmp, Col, Expr, Lit

SAMPLE_MEAN_AGGS = ("sum", "count", "avg")

_FLIP = {"ge": "le", "gt": "lt", "le": "ge", "lt": "gt", "eq": "eq"}


class UnsupportedQueryError(ValueError):
    """Query not in the encodable sample-mean × interval-predicate class."""


def lower_pred(pred: Expr | None) -> Dict[str, Dict[str, float]]:
    """Lower a predicate into per-column interval bounds.

    Returns {column: {"ge", "gt", "le", "lt"}} with ±inf for open sides.
    Conjunctive terms on the same column merge (max of lower bounds, min
    of upper bounds), preserving exact semantics.
    """
    bounds: Dict[str, Dict[str, float]] = {}

    def term(op: str, name: str, value: float) -> None:
        b = bounds.setdefault(
            name, {"ge": -math.inf, "gt": -math.inf, "le": math.inf, "lt": math.inf}
        )
        if op == "ge":
            b["ge"] = max(b["ge"], value)
        elif op == "gt":
            b["gt"] = max(b["gt"], value)
        elif op == "le":
            b["le"] = min(b["le"], value)
        elif op == "lt":
            b["lt"] = min(b["lt"], value)
        elif op == "eq":
            b["ge"] = max(b["ge"], value)
            b["le"] = min(b["le"], value)
        else:
            raise UnsupportedQueryError(f"comparison {op!r} is not encodable")

    def walk(e: Expr) -> None:
        if isinstance(e, Boolean) and e.op == "and":
            for a in e.args:
                walk(a)
            return
        if isinstance(e, Cmp):
            a, b, op = e.a, e.b, e.op
            if isinstance(a, Lit) and isinstance(b, Col):
                a, b, op = b, a, _FLIP.get(op)
                if op is None:
                    raise UnsupportedQueryError(f"comparison {e.op!r} is not encodable")
            if not (isinstance(a, Col) and isinstance(b, Lit)):
                raise UnsupportedQueryError(f"non column-vs-literal comparison {e!r}")
            try:
                v = float(b.value)
            except (TypeError, ValueError) as exc:
                raise UnsupportedQueryError(f"non-numeric literal {b.value!r}") from exc
            term(op, a.name, v)
            return
        raise UnsupportedQueryError(f"predicate node {type(e).__name__} is not encodable")

    if pred is not None:
        walk(pred)
    return bounds


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _lower_query(q: Query, colidx: Dict[str, int]) -> Dict[str, Dict[str, float]]:
    """Validate one query against the column panel; returns its bounds."""
    if q.agg not in SAMPLE_MEAN_AGGS:
        raise UnsupportedQueryError(f"agg {q.agg!r} is not in the sample-mean class")
    if q.agg != "count":
        if q.col is None:
            raise UnsupportedQueryError(f"agg {q.agg!r} needs a column")
        if q.col not in colidx:
            raise UnsupportedQueryError(f"unknown column {q.col!r}")
    b = lower_pred(q.pred)
    for name in b:
        if name not in colidx:
            raise UnsupportedQueryError(f"unknown predicate column {name!r}")
    return b


@dataclasses.dataclass(frozen=True)
class QueryBatch:
    """An encoded batch of sample-mean queries (see module docstring)."""

    queries: Tuple[Query, ...]
    columns: Tuple[str, ...]
    sel: torch.Tensor  # ((1+P)*C, Qp) f32
    meta: torch.Tensor  # (2+4P, Qp) f32
    n_pred: int
    is_avg: np.ndarray  # (Q,) bool, host copy for estimate assembly
    is_count: np.ndarray  # (Q,) bool

    def __len__(self) -> int:
        return len(self.queries)

    @classmethod
    def encode(cls, queries: Sequence[Query], columns: Sequence[str], device) -> "QueryBatch":
        """Encode ``queries`` against the ordered column panel ``columns``.

        Raises ``UnsupportedQueryError`` if any query falls outside the
        encodable class; use ``is_encodable`` to pre-filter.  ``sel`` and
        ``meta`` are built on the host and placed on ``device``.
        """
        columns = tuple(columns)
        colidx = {c: i for i, c in enumerate(columns)}
        C = len(columns)
        lowered: List[Tuple[Query, Dict[str, Dict[str, float]]]] = [
            (q, _lower_query(q, colidx)) for q in queries
        ]

        P = _next_pow2(max(1, max((len(b) for _, b in lowered), default=1)))
        Qp = _next_pow2(max(8, len(lowered)))
        sel = np.zeros(((1 + P) * C, Qp), np.float32)
        meta = np.zeros((2 + 4 * P, Qp), np.float32)
        # default bounds leave every row unconstrained (±inf), so padded
        # query slots reduce harmlessly (their value column is all-zero)
        for p in range(P):
            meta[2 + 4 * p, :] = -np.inf
            meta[3 + 4 * p, :] = -np.inf
            meta[4 + 4 * p, :] = np.inf
            meta[5 + 4 * p, :] = np.inf
        is_avg = np.zeros(len(lowered), bool)
        is_count = np.zeros(len(lowered), bool)
        for qi, (q, b) in enumerate(lowered):
            if q.agg == "count":
                is_count[qi] = True
                meta[0, qi] = 1.0
            else:
                sel[colidx[q.col], qi] = 1.0
            if q.agg == "avg":
                is_avg[qi] = True
                meta[1, qi] = 1.0
            for p, (name, bb) in enumerate(sorted(b.items())):
                sel[(1 + p) * C + colidx[name], qi] = 1.0
                meta[2 + 4 * p, qi] = bb["ge"]
                meta[3 + 4 * p, qi] = bb["gt"]
                meta[4 + 4 * p, qi] = bb["le"]
                meta[5 + 4 * p, qi] = bb["lt"]
        return cls(
            queries=tuple(queries),
            columns=columns,
            sel=torch.as_tensor(sel, device=device),
            meta=torch.as_tensor(meta, device=device),
            n_pred=P,
            is_avg=is_avg,
            is_count=is_count,
        )


def is_encodable(q: Query, columns: Sequence[str]) -> bool:
    """True when ``q`` can go through the batched engine on ``columns``."""
    try:
        _lower_query(q, {c: i for i, c in enumerate(columns)})
        return True
    except UnsupportedQueryError:
        return False
