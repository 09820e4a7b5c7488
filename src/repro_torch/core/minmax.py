"""min/max correction estimates with Cantelli bounds (appendix 12.1.1).

For max: (1) row-by-row differences between corresponding rows of Ŝ and
Ŝ', (2) c = the largest difference, (3) estimate = max(q_max(S) + c,
max(Ŝ')).  The bound is the Cantelli probability that a larger element
exists in the unsampled portion: P(X ≥ ε + μ) ≤ var/(var + ε²).  min is
the mirror image.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.estimators import Query, _cond_mask, _values, correspondence_diff
from repro_torch.relational.relation import Relation, zeros_where


@dataclasses.dataclass
class MinMaxEstimate:
    value: torch.Tensor
    exceed_prob: torch.Tensor  # Cantelli bound on a more extreme unsampled value
    method: str


def svc_minmax(
    stale_result: torch.Tensor,
    clean_sample: Relation,
    stale_sample: Relation,
    query: Query,
    m: float,
) -> MinMaxEstimate:
    if query.agg not in ("min", "max"):
        raise ValueError(query.agg)
    sign = 1.0 if query.agg == "max" else -1.0
    neg_inf = float("-inf")

    # row-by-row differences over corresponding keys (Ø→0)
    diff_query = Query(agg="avg", col=query.col, pred=query.pred)
    d, mask = correspondence_diff(clean_sample, stale_sample, diff_query, m=1.0)
    c = torch.where(mask, sign * d, torch.full_like(d, neg_inf)).max() * sign

    corrected = stale_result + c
    # the clean sample's own extremum is a certain bound (lower, for max)
    cond = _cond_mask(clean_sample, query)
    vals = _values(clean_sample, query)
    if query.agg == "max":
        sample_ext = torch.where(cond, vals, torch.full_like(vals, neg_inf)).max()
        value = torch.maximum(corrected, sample_ext)
    else:
        sample_ext = torch.where(cond, vals, torch.full_like(vals, float("inf"))).min()
        value = torch.minimum(corrected, sample_ext)

    # Cantelli: P(more extreme value exists) ≤ var/(var + ε²)
    k = cond.to(torch.float32).sum().clamp(min=1.0)
    mu = zeros_where(cond, vals).sum() / k
    var = zeros_where(cond, (vals - mu) ** 2).sum() / (k - 1.0).clamp(min=1.0)
    eps = (value - mu).abs()
    prob = var / (var + eps ** 2)
    return MinMaxEstimate(value, prob, f"SVC+{query.agg}")
