"""Select-query correction (appendix 12.1.2).

Run SELECT * WHERE pred on the stale view, then patch it with the clean
sample: overwrite updated rows, union new rows, drop missing rows.  The
approximation error is quantified by rewriting the query as three counts
(updated / added / deleted) with their CLT intervals.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.estimators import Estimate, _gamma
from repro_torch.relational import ops
from repro_torch.relational.expr import Expr
from repro_torch.relational.relation import Relation, zeros_where


@dataclasses.dataclass
class SelectResult:
    patched: Relation  # stale selection with sampled fixes applied
    n_updated: Estimate
    n_added: Estimate
    n_deleted: Estimate


def svc_select(
    stale_view: Relation,
    clean_sample: Relation,
    stale_sample: Relation,
    pred: Expr,
    m: float,
    confidence: float = 0.95,
) -> SelectResult:
    pk = stale_view.schema.pk
    stale_sel = ops.select(stale_view, pred)

    # classify sampled keys: in Ŝ' only (added), in Ŝ only (deleted), both
    j = ops.outer_join_unique(clean_sample, stale_sample, on=pk, how="outer",
                              suffixes=("_new", "_old"))
    lp = j.col("__left_present").to(torch.bool) & j.valid
    rp = j.col("__right_present").to(torch.bool) & j.valid
    changed = torch.zeros_like(lp)
    for c in clean_sample.schema.columns:
        if c in pk or c.startswith("__"):
            continue
        a = j.columns.get(c + "_new", j.columns.get(c))
        b = j.columns.get(c + "_old")
        if a is None or b is None:
            continue
        changed = changed | (lp & rp & (a != b))

    # patch: overwrite updated rows and union added rows (the clean sample
    # restricted to pred), then drop keys sampled as missing
    fixes = ops.select(clean_sample, pred)
    patched = ops.union_keyed(_align_schema(fixes, stale_sel), stale_sel)  # clean rows win
    deleted_keys = Relation(
        {k: j.col(k) for k in pk}, rp & ~lp,
        dataclasses.replace(stale_sample.schema, pk=pk, columns=tuple(sorted(pk))),
    )
    patched = ops.difference_keyed(patched, deleted_keys)

    # error quantification: three scaled counts over the join row space
    n_upd = _scaled_count(j, changed, m, confidence, "updated")
    n_add = _scaled_count(j, lp & ~rp, m, confidence, "added")
    n_del = _scaled_count(j, rp & ~lp, m, confidence, "deleted")
    return SelectResult(patched=patched, n_updated=n_upd, n_added=n_add, n_deleted=n_del)


def _scaled_count(rel: Relation, mask: torch.Tensor, m: float, confidence: float,
                  name: str) -> Estimate:
    g = _gamma(confidence)
    t = torch.where(mask & rel.valid, torch.full(mask.shape, 1.0 / m, device=mask.device),
                    torch.zeros(mask.shape, device=mask.device))
    k = rel.valid.to(torch.float32).sum().clamp(min=1.0)
    s = t.sum()
    mean = s / k
    var = zeros_where(rel.valid, (t - mean) ** 2).sum() / (k - 1.0).clamp(min=1.0)
    stderr = (k * var).sqrt()
    return Estimate(s, stderr, s - g * stderr, s + g * stderr, f"count_{name}", confidence)


def _align_schema(rel: Relation, target: Relation) -> Relation:
    """Project rel onto target's columns (drop extras like __outlier)."""
    cols = {c: rel.col(c) for c in target.schema.columns if c in rel.columns}
    for c in target.schema.columns:
        if c not in cols:
            cols[c] = torch.zeros(rel.valid.shape, dtype=target.col(c).dtype,
                                  device=rel.device)
    return Relation(cols, rel.valid, target.schema)
