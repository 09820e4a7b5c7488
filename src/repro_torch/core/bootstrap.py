"""Statistical bootstrap bounds for non-sample-mean aggregates (§5.2.5).

Median and percentile estimates cannot be bounded analytically: the
(clean, stale) samples are resampled with replacement B times, the
estimate (or the correction c) is computed per replicate, and empirical
percentiles of the replicates give the interval.

Each replicate draws a row of uniforms ``u`` over the sample relation's
capacity and reads ``floor(u·k)`` from the k condition rows compacted to
the front, in their stable order.  The uniforms are a parameter
(``us=``): ``rng`` (a ``torch.Generator`` on the sample's device, seeded
with 0 when omitted) draws them otherwise.  Torch's generator cannot give
``jax.random``'s stream, so the parity tests feed the same uniforms to
both packages.  Replicates are independent rows of one batched gather,
sort and interpolation, in chunks that bound the scratch memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.estimators import Estimate, Query, _cond_mask, _values, masked_quantile
from repro_torch.relational.relation import Relation

# elements of the (replicates, capacity) gather and sort per chunk
_CHUNK_ELEMS = 1 << 25


def gather_cond(rel: Relation, query: Query) -> Tuple[torch.Tensor, torch.Tensor]:
    """Condition rows' values compacted to the front (stable), and their
    count k (0-d int32)."""
    cond = _cond_mask(rel, query)
    vals = _values(rel, query)
    order = torch.argsort((~cond).to(torch.int8), stable=True)  # cond rows first
    return vals[order], cond.sum(dtype=torch.int32)


def resample_stats(values: torch.Tensor, k: torch.Tensor, us: torch.Tensor,
                   q: float) -> torch.Tensor:
    """(B,) replicate quantiles: replicate b takes the k rows
    ``values[floor(us[b]·max(k, 1))]`` (the first k draws of its row) and
    their q-quantile."""
    n = values.shape[0]
    if us.dim() != 2 or us.shape[1] != n:
        raise ValueError(f"us must be (B, {n}), got {tuple(us.shape)}")
    kf = k.clamp(min=1).to(torch.float32)
    live = torch.arange(n, device=values.device) < k
    chunk = max(1, _CHUNK_ELEMS // max(n, 1))
    out = []
    for u in us.split(chunk):
        idx = (u * kf).to(torch.int32).clamp(0, n - 1)
        out.append(masked_quantile(values[idx.long()], live, q))
    return torch.cat(out) if out else values.new_empty((0,))


def draw_uniforms(rng: Optional[torch.Generator], B: int, n: int,
                  device: torch.device) -> torch.Tensor:
    """(B, n) float32 uniforms in [0, 1) from ``rng`` (seed 0 if None)."""
    if rng is None:
        rng = torch.Generator(device=device).manual_seed(0)
    return torch.rand((B, n), generator=rng, device=device, dtype=torch.float32)


def _quantile_of(query: Query) -> float:
    return 0.5 if query.agg == "median" else query.q


def bootstrap_aqp(
    clean_sample: Relation,
    query: Query,
    rng: Optional[torch.Generator] = None,
    B: int = 200,
    confidence: float = 0.95,
    us: Optional[torch.Tensor] = None,
) -> Estimate:
    """SVC+AQP for median/percentile with a bootstrap interval."""
    q = _quantile_of(query)
    values, k = gather_cond(clean_sample, query)
    n = values.shape[0]
    if us is None:
        us = draw_uniforms(rng, B, n, values.device)
    stats = resample_stats(values, k, us, q)
    alpha = (1.0 - confidence) / 2.0
    lo = torch.quantile(stats, alpha)
    hi = torch.quantile(stats, 1.0 - alpha)
    point = masked_quantile(values, torch.arange(n, device=values.device) < k, q)
    return Estimate(point, stats.std(correction=0), lo, hi, "SVC+AQP(bootstrap)", confidence)


def bootstrap_corr(
    stale_result: torch.Tensor,
    clean_sample: Relation,
    stale_sample: Relation,
    query: Query,
    rng: Optional[torch.Generator] = None,
    B: int = 200,
    confidence: float = 0.95,
    us: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Estimate:
    """SVC+CORR bootstrap (§5.2.5): the empirical distribution of the
    correction c.  Per replicate, Ŝ' and Ŝ are resampled independently
    (``us = (u_new, u_old)``, else drawn from ``rng`` in that order), the
    AQP estimate is taken on each, and c is their difference; the answer
    is q(S) plus the median of c, with c's percentiles as the interval."""
    q = _quantile_of(query)
    v_new, k_new = gather_cond(clean_sample, query)
    v_old, k_old = gather_cond(stale_sample, query)
    if us is None:
        if rng is None:
            rng = torch.Generator(device=v_new.device).manual_seed(0)
        us = (draw_uniforms(rng, B, v_new.shape[0], v_new.device),
              draw_uniforms(rng, B, v_old.shape[0], v_old.device))
    cs = resample_stats(v_new, k_new, us[0], q) - resample_stats(v_old, k_old, us[1], q)
    alpha = (1.0 - confidence) / 2.0
    lo = stale_result + torch.quantile(cs, alpha)
    hi = stale_result + torch.quantile(cs, 1.0 - alpha)
    value = stale_result + torch.quantile(cs, 0.5)  # jnp.median: mean of the middle two
    return Estimate(value, cs.std(correction=0), lo, hi, "SVC+CORR(bootstrap)", confidence)
