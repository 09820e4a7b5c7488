"""Outlier indexing (§6): reduce sampling sensitivity to skew.

An outlier index is a top-k index over an attribute of a *base* relation,
pushed **up** the view plan (Def. 5): evaluating the view with the base
restricted to the indexed records gives the view keys that must be kept
exactly.  The sample predicate becomes ``hash(key) ≤ m OR key ∈
outlier_groups``; pinned rows carry weight 1 and an ``__outlier`` flag
(§6.2), and the estimators merge the deterministic stratum through the
per-row weight (§6.3).

A view's pushed-up pin is a ``PinSet``: the pinned key relation together
with the sorted digest table that the pinned hash probes, built once where
the pin is built and dropped with it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.relational.execute import execute
from repro_torch.relational.plan import Plan, plan_pk
from repro_torch.relational.relation import (
    SENTINEL_KEY,
    Relation,
    from_arrays,
    sentinel_where,
)


@dataclasses.dataclass
class OutlierIndex:
    """Top-k index over ``attr`` of base relation ``base`` (threshold t).

    Invariant: ``records`` rows are sorted DESCENDING by ``attr`` with
    invalid slots at the end (build and the incremental merge both keep it).
    """

    base: str
    attr: str
    capacity: int
    records: Relation  # the indexed base records (≤ capacity valid rows)
    threshold: torch.Tensor  # 0-dim f32


@dataclasses.dataclass(frozen=True)
class PinSet:
    """A view's outlier pin set (Def. 5) and its membership table.

    ``relation`` holds the pinned view keys and ``table`` the sorted 64-bit
    digests (``kernels/outlier_member.pin_table``) that every pinned hash
    of the pin probes.  ``keys``, its pk columns with SENTINEL_KEY on
    invalid rows, is made on first use (the clean's pin mask and
    ``flag_outliers`` read it; the pinned hash does not).  Built by
    ``pin_set`` where the pin is built; the table is not cached anywhere
    else."""

    relation: Relation
    table: torch.Tensor

    @functools.cached_property
    def keys(self) -> Tuple[torch.Tensor, ...]:
        return tuple(sentinel_where(self.relation.valid, self.relation.col(c))
                     for c in self.relation.schema.pk)


def pin_set(pin: Relation) -> PinSet:
    """The pin relation with its digest table (one table build).

    The table digests the valid pinned keys and, when the pin has invalid
    rows, one all-SENTINEL tuple: membership over it is membership over
    the SENTINEL-masked key columns, whose invalid rows all share that
    tuple.  A pushed-up pin holds a few valid keys in an arena of the view's
    group capacity: on a card one launch over the arena builds the table
    and one host wait reads its length."""
    from repro_torch.kernels.outlier_member import ops as _om

    keys = tuple(pin.col(c).contiguous() for c in pin.schema.pk)
    return PinSet(pin, _om.pin_table(keys, pin.valid.contiguous()))


def outlier_index_from_arrays(
    base: str, attr: str, capacity: int, columns: Mapping[str, np.ndarray],
    valid: np.ndarray, pk: Sequence[str], threshold: float, device,
) -> OutlierIndex:
    """Carry an outlier index across from another engine (full capacity)."""
    records = from_arrays(columns, valid, pk, device)
    return OutlierIndex(
        base=base, attr=attr, capacity=int(capacity), records=records,
        threshold=torch.tensor(float(np.float32(threshold)), dtype=torch.float32, device=device),
    )


def _attr_vals(valid: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``attr`` as f32 with invalid rows at -inf (they sort last)."""
    v = v.to(torch.float32)
    return torch.where(valid, v, torch.full_like(v, float("-inf")))


def _min_valid(valid: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Smallest valid value (inf when nothing is valid)."""
    if vals.numel() == 0:
        return torch.tensor(float("inf"), device=vals.device)
    return torch.where(valid, vals, torch.full_like(vals, float("inf"))).min()


def build_outlier_index(rel: Relation, base: str, attr: str, k: int) -> OutlierIndex:
    """Single-pass top-k selection (§6.1): keep the k largest by ``attr``."""
    vals = _attr_vals(rel.valid, rel.col(attr))
    order = torch.sort(-vals, stable=True).indices  # descending, ties by row
    take = order[:k]
    cols = {c: v[take] for c, v in rel.columns.items()}
    valid = rel.valid[take]
    records = Relation(cols, valid, rel.schema)
    return OutlierIndex(base=base, attr=attr, capacity=k, records=records,
                        threshold=_min_valid(valid, vals[take]))


def update_outlier_index(
    index: OutlierIndex, delta: Relation, incremental: bool = True
) -> OutlierIndex:
    """Streaming maintenance (§6.1): threshold-gated incremental top-k.

    When the index is full only rows strictly above the threshold can
    displace a member (an equal value loses the tie to the incumbent, as in
    the rebuild's stable sort), so a sub-threshold batch returns the index
    unchanged.  Survivors are sorted and merged with the descending records
    by a searchsorted position merge.  ``incremental=False`` rebuilds from
    the concatenation (the equivalence oracle).
    """
    if not incremental:
        merged_cols = {
            c: torch.cat([index.records.col(c), delta.col(c)])
            for c in index.records.schema.columns
        }
        merged_valid = torch.cat([index.records.valid, delta.valid])
        merged = Relation(merged_cols, merged_valid, index.records.schema)
        return build_outlier_index(merged, index.base, index.attr, index.capacity)

    vals = _attr_vals(delta.valid, delta.col(index.attr))
    full = index.records.valid.sum() >= index.capacity
    gate = delta.valid & torch.where(full, vals > index.threshold, torch.ones_like(delta.valid))
    gated = torch.where(gate, vals, torch.full_like(vals, float("-inf")))
    if int(gate.sum()) == 0:  # one host sync for the early-out
        return index
    cols, valid, threshold = _topk_merge(index, delta, gated)
    return OutlierIndex(
        base=index.base, attr=index.attr, capacity=index.capacity,
        records=Relation(cols, valid, index.records.schema), threshold=threshold,
    )


def _topk_merge(index: OutlierIndex, delta: Relation, gated: torch.Tensor):
    """Bounded merge of the descending records with the sorted survivors."""
    rec = index.records
    K = rec.capacity
    S = min(index.capacity, gated.shape[0])  # over-capacity survivors never place
    T = min(index.capacity, K + S)  # records may still be growing toward k
    sorder = torch.sort(-gated, stable=True).indices[:S]
    svals = gated[sorder]
    rvals = _attr_vals(rec.valid, rec.col(index.attr))
    dev = gated.device
    # merge positions of two DESCENDING runs; records win ties
    pos_r = torch.arange(K, device=dev) + torch.searchsorted(-svals, -rvals, side="left")
    pos_s = torch.arange(S, device=dev) + torch.searchsorted(-rvals, -svals, side="right")
    out_cols = {}
    for c in rec.schema.columns:
        arena = torch.zeros(K + S, dtype=rec.col(c).dtype, device=dev)
        arena[pos_r] = rec.col(c)
        arena[pos_s] = delta.col(c).to(rec.col(c).dtype)[sorder]
        out_cols[c] = arena[:T]
    varena = torch.zeros(K + S, dtype=torch.bool, device=dev)
    varena[pos_r] = rec.valid
    varena[pos_s] = svals > float("-inf")
    valid = varena[:T]
    nvals = _attr_vals(valid, out_cols[index.attr])
    return out_cols, valid, _min_valid(valid, nvals)


def propagate_outlier_keys(
    view_plan: Plan, base_env, index: OutlierIndex
) -> Tuple[torch.Tensor, ...]:
    """Def. 5 push-up: view pk values of rows derived from indexed records."""
    env = dict(base_env)
    env[index.base] = index.records
    touched = execute(view_plan, env)
    return tuple(sentinel_where(touched.valid, touched.col(k)) for k in plan_pk(view_plan))


def member_keys(probe: Tuple[torch.Tensor, ...], keys: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """probe[i] ∈ keys.

    Single-column keys take the exact sorted search (sort + searchsorted,
    no hashing); composite keys go through kernels/outlier_member's 64-bit
    digest membership.
    """
    if len(keys) == 1:
        sk = torch.sort(keys[0]).values
        pos = torch.searchsorted(sk, probe[0].to(sk.dtype)).clamp(0, sk.shape[0] - 1)
        return (sk[pos] == probe[0]) & (probe[0] != int(SENTINEL_KEY))
    from repro_torch.kernels.outlier_member import ops as _om

    return _om.outlier_member(probe, keys)


def member_keys_loop(probe: Tuple[torch.Tensor, ...], keys: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """The O(N·K) compare unrolled over the index capacity (one chain of
    element-wise ops per indexed key): the oracle of ``member_keys`` in the
    tests, never called on a refresh path."""
    hit = torch.zeros(probe[0].shape, dtype=torch.bool, device=probe[0].device)
    for i in range(keys[0].shape[0]):
        row = torch.ones(probe[0].shape, dtype=torch.bool, device=probe[0].device)
        for p, k in zip(probe, keys):
            row = row & (p == k[i])
        hit = hit | row & (probe[0] != int(SENTINEL_KEY))
    return hit


def flag_outliers(rel: Relation, pin: PinSet | None) -> Relation:
    """(Re)compute the view-level ``__outlier`` flag: pk ∈ pin."""
    if pin is None:
        return rel
    probe = tuple(sentinel_where(rel.valid, rel.col(c)) for c in rel.schema.pk)
    omask = member_keys(probe, pin.keys)
    new_cols = dict(rel.columns)
    new_cols["__outlier"] = (omask & rel.valid).to(torch.int8)
    return Relation(new_cols, rel.valid, rel.schema.with_columns(tuple(new_cols)))


def apply_hash_with_outliers(
    rel: Relation,
    cols: Tuple[str, ...],
    m: float,
    seed: int,
    table: torch.Tensor,
) -> Relation:
    """η ∨ outlier-membership; flags pinned rows with __outlier (weight 1).

    One launch of kernels/outlier_member's pinned hash against the pin's
    digest ``table``: the η hash, the 64-bit membership digest, the flag
    and the validity narrowing in one pass.
    """
    from repro_torch.kernels.outlier_member import ops as _om

    valid, flag = _om.pinned_hash(tuple(rel.col(c) for c in cols), rel.valid, m, seed, table)
    new_cols = dict(rel.columns)
    new_cols["__outlier"] = flag
    schema = rel.schema.with_columns(tuple(new_cols))
    return Relation(new_cols, valid, schema)
