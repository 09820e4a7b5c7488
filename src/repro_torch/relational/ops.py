"""Relational operators on fixed-capacity columnar relations (torch).

The vocabulary of SVC §3.1 — Select (σ), generalized Project (Π), Join (⋈,
including full outer ⟗ and foreign-key joins), Aggregation (γ), Union,
Intersection, Difference — as functions of torch tensors, mirroring
``repro.relational.ops``: sort + searchsorted instead of hash joins.

Conventions:
  * invalid rows carry SENTINEL_KEY in pk columns so sorts push them last;
  * outer joins add ``__left_present`` / ``__right_present`` int8 columns and
    fill absent side values with 0 (exactly the Ø→0 convention of Def. 4);
  * group-by capacity is static; overflowing groups land in a discard slot
    ``num_groups``: the segment sums drop it, and every scatter here targets
    ``num_groups + 1`` slots and slices the last one off.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch

from repro_torch.kernels.segment_aggsum import segment_groupby
from repro_torch.relational.expr import Expr, eval_expr, expr_columns
from repro_torch.relational.relation import (
    SENTINEL_KEY,
    Relation,
    Schema,
    as_column,
    keys_equal,
    lexsort_indices,
    masked_keys,
    next_pow2,
    sentinel_where,
    zeros_where,
)


def _shift_prev(k: torch.Tensor) -> torch.Tensor:
    """``k`` shifted one row down, SENTINEL_KEY in row 0."""
    first = torch.full((1,), int(SENTINEL_KEY), dtype=k.dtype, device=k.device)
    return torch.cat([first, k[:-1]])


# ---------------------------------------------------------------------------
# σ / Π
# ---------------------------------------------------------------------------

def select(rel: Relation, pred: Expr) -> Relation:
    """σ_pred — narrow the validity mask."""
    mask = eval_expr(pred, rel.columns)
    return rel.replace(valid=rel.valid & mask.to(torch.bool))


def project(rel: Relation, outputs: Mapping[str, Expr | str], pk: Sequence[str] | None = None) -> Relation:
    """Π — generalized projection with arithmetic (new attrs allowed)."""
    new_cols: Dict[str, torch.Tensor] = {}
    for name, e in outputs.items():
        if isinstance(e, str):
            new_cols[name] = rel.columns[e]
        else:
            val = as_column(eval_expr(e, rel.columns), rel.device)
            new_cols[name] = val.expand(rel.valid.shape).contiguous()
    out_pk = tuple(pk) if pk is not None else rel.schema.pk
    for k in out_pk:
        if k not in new_cols:
            raise ValueError(f"projection must retain pk column {k!r}")
    schema = Schema(pk=out_pk, columns=tuple(sorted(new_cols)))
    return Relation(new_cols, rel.valid, schema)


# ---------------------------------------------------------------------------
# Joins
# ---------------------------------------------------------------------------

def _dim_lookup(dim: Relation, dim_key: str, probe: torch.Tensor):
    """searchsorted lookup of ``probe`` into dim's (unique) key column."""
    dk = sentinel_where(dim.valid, dim.col(dim_key))
    sorted_dk, order = torch.sort(dk, stable=True)
    pos = torch.searchsorted(sorted_dk, probe.to(sorted_dk.dtype))
    safe = pos.clamp(0, dim.capacity - 1)
    hit = (sorted_dk[safe] == probe) & (probe != int(SENTINEL_KEY))
    src = order[safe]
    return src, hit


def fk_hit(dim: Relation, dim_key: str, probe: torch.Tensor):
    """Public FK-membership probe: (dim row indices, hit mask) for ``probe``
    against dim's unique key column (the fused clean path uses the mask)."""
    return _dim_lookup(dim, dim_key, probe)


def fk_join(
    fact: Relation,
    dim: Relation,
    fact_key: str,
    dim_key: str | None = None,
    suffix: str = "_r",
) -> Relation:
    """Foreign-key join: each fact row matches ≤ 1 dim row (dim pk unique).

    Result capacity = fact capacity.  Result pk = fact.pk + dim.pk (Def. 2).
    """
    if dim_key is None:
        if len(dim.schema.pk) != 1:
            raise ValueError("fk_join dim must have single-column pk")
        dim_key = dim.schema.pk[0]
    probe = sentinel_where(fact.valid, fact.col(fact_key))
    src, hit = _dim_lookup(dim, dim_key, probe)
    cols = dict(fact.columns)
    renames = {}
    for name, v in dim.columns.items():
        out = name if name not in cols else name + suffix
        renames[name] = out
        gathered = v[src]
        if name in dim.schema.pk:
            gathered = sentinel_where(hit, gathered)
        else:
            gathered = zeros_where(hit, gathered)
        cols[out] = gathered
    pk = tuple(fact.schema.pk) + tuple(renames[k] for k in dim.schema.pk)
    schema = Schema(pk=pk, columns=tuple(sorted(cols)))
    return Relation(cols, fact.valid & hit, schema)


def outer_join_unique(
    left: Relation,
    right: Relation,
    on: Sequence[str] | None = None,
    how: str = "outer",  # outer | inner | left
    suffixes: Tuple[str, str] = ("", "_r"),
) -> Relation:
    """Join two relations whose join keys are unique per side.

    The merge shape of change-table IVM (stale view ⟗ delta view) and of
    correspondence subtraction (Def. 4).  Result capacity = |left| +
    |right|; pk = join key.  Adds ``__left_present``/``__right_present``
    int8 columns; absent side values are 0 (Def. 4 Ø→0).
    """
    on = tuple(on) if on is not None else left.schema.pk
    if len(on) != len(right.schema.pk) and not all(c in right.schema.columns for c in on):
        raise ValueError("join columns missing on right")
    n1, n2 = left.capacity, right.capacity
    dev = left.device

    lk = tuple(sentinel_where(left.valid, left.col(c)) for c in on)
    rk = tuple(sentinel_where(right.valid, right.col(c)) for c in on)
    keys = tuple(torch.cat([a, b]) for a, b in zip(lk, rk))
    side = torch.cat([torch.zeros(n1, dtype=torch.int32, device=dev),
                      torch.ones(n2, dtype=torch.int32, device=dev)])
    idx = torch.cat([torch.arange(n1, device=dev), torch.arange(n2, device=dev)])

    order = lexsort_indices(keys, side)  # by key, left rows first within key
    sk = tuple(k[order] for k in keys)
    ss = side[order]
    si = idx[order]

    same_as_prev = keys_equal(sk, tuple(_shift_prev(k) for k in sk))
    is_start = ~same_as_prev
    false1 = torch.zeros(1, dtype=torch.bool, device=dev)
    nxt_same = torch.cat([same_as_prev[1:], false1])
    nxt_side = torch.cat([ss[1:], torch.zeros(1, dtype=ss.dtype, device=dev)])
    nxt_idx = torch.cat([si[1:], torch.zeros(1, dtype=si.dtype, device=dev)])

    key_live = sk[0] != int(SENTINEL_KEY)
    left_here = is_start & (ss == 0)
    right_next = is_start & nxt_same & (nxt_side == 1)
    right_here = is_start & (ss == 1)

    left_present = left_here
    right_present = right_here | right_next
    zero = torch.zeros_like(si)
    left_src = torch.where(left_here, si, zero)
    right_src = torch.where(right_here, si, torch.where(right_next, nxt_idx, zero))

    if how == "outer":
        emit = is_start & key_live & (left_present | right_present)
    elif how == "inner":
        emit = is_start & key_live & left_present & right_present
    elif how == "left":
        emit = is_start & key_live & left_present
    else:
        raise ValueError(how)

    ls, rs = suffixes
    cols: Dict[str, torch.Tensor] = {}
    for c in on:  # join keys: coalesce
        v = torch.where(left_present, left.col(c)[left_src], right.col(c)[right_src])
        cols[c] = sentinel_where(emit, v)
    shared = (set(left.schema.columns) & set(right.schema.columns)) - set(on)
    for c in left.schema.columns:
        if c in on:
            continue
        out = c + ls if c in shared else c
        cols[out] = zeros_where(left_present, left.col(c)[left_src])
    for c in right.schema.columns:
        if c in on:
            continue
        out = c + rs if c in shared else c
        cols[out] = zeros_where(right_present, right.col(c)[right_src])
    cols["__left_present"] = left_present.to(torch.int8)
    cols["__right_present"] = right_present.to(torch.int8)

    schema = Schema(pk=on, columns=tuple(sorted(cols)))
    return Relation(cols, emit, schema)


def nested_join(left: Relation, right: Relation, pred: Expr, suffixes=("", "_r")) -> Relation:
    """General θ-join via dense cross product (capacity n1*n2).

    Only for small relations (tests / non-pushdown baselines); the SVC plans
    use fk/equality joins.
    """
    n1, n2 = left.capacity, right.capacity
    dev = left.device
    li = torch.arange(n1, dtype=torch.int64, device=dev).repeat_interleave(n2)
    ri = torch.arange(n2, dtype=torch.int64, device=dev).repeat(n1)
    shared = set(left.schema.columns) & set(right.schema.columns)
    cols: Dict[str, torch.Tensor] = {}
    for c in left.schema.columns:
        out = c + suffixes[0] if c in shared else c
        cols[out] = left.col(c)[li]
    for c in right.schema.columns:
        out = c + suffixes[1] if c in shared else c
        cols[out] = right.col(c)[ri]
    valid = left.valid[li] & right.valid[ri]
    mask = torch.as_tensor(eval_expr(pred, cols), device=dev).to(torch.bool)
    lpk = tuple(k + suffixes[0] if k in shared else k for k in left.schema.pk)
    rpk = tuple(k + suffixes[1] if k in shared else k for k in right.schema.pk)
    schema = Schema(pk=lpk + rpk, columns=tuple(sorted(cols)))
    return Relation(cols, valid & mask, schema)


# ---------------------------------------------------------------------------
# γ — group-by aggregation
# ---------------------------------------------------------------------------

def group_ids(rel: Relation, keys: Sequence[str], num_groups: int):
    """The group-by's row numbering: ``(order, sorted keys, sorted valid,
    group-start flags, gid)``.  Rows are stably sorted by key; ``gid`` is
    each sorted row's dense group rank (int32, non-decreasing), and invalid
    rows and groups past ``num_groups`` land in the overflow slot
    ``num_groups``."""
    kcols = tuple(sentinel_where(rel.valid, rel.col(c)) for c in keys)
    order = lexsort_indices(kcols)
    sk = tuple(k[order] for k in kcols)
    sv = rel.valid[order]
    first = torch.arange(rel.capacity, device=rel.device) == 0
    is_start = sv & (~keys_equal(sk, tuple(_shift_prev(k) for k in sk)) | first)
    gid = torch.cumsum(is_start, 0, dtype=torch.int32) - 1
    gid = torch.where(sv, gid.clamp(0, num_groups), torch.full_like(gid, num_groups))
    return order, sk, sv, is_start, gid


def _agg_columns(rel: Relation, aggs) -> Tuple[str, ...]:
    """The columns of ``rel`` that the aggregates' values read: named
    columns, and the ``__present`` flag of each ``IsNotNull`` operand."""
    need, exprs = set(), False
    for _fn, value in aggs.values():
        if isinstance(value, str):
            need.add(value)
        elif isinstance(value, Expr):
            exprs = True
            for c in expr_columns(value):
                need.update((c, c + "__present"))
    cols = tuple(c for c in rel.schema.columns if c in need)
    # an IsNotNull without its flag takes its shape from some column
    return cols or (rel.schema.columns[:1] if exprs else ())


def groupby(
    rel: Relation,
    keys: Sequence[str],
    aggs: Mapping[str, Tuple[str, Expr | str | None]],
    num_groups: int,
) -> Relation:
    """γ_{f,A} — group by ``keys``; ``aggs``: out -> (fn, value expr).

    fn ∈ {sum, count, mean, min, max}.  Output capacity = ``num_groups``;
    groups beyond it land in the overflow slot ``num_groups`` and drop.
    Counts and every sum and mean column come from one ``segment_groupby``
    over the sorted group ids (the CUDA reduce-by-key on the card).
    """
    keys = tuple(keys)
    dev = rel.device
    order, sk, sv, is_start, gid = group_ids(rel, keys, num_groups)
    nseg = num_groups + 1

    out_cols: Dict[str, torch.Tensor] = {}
    # group keys: each group's start row writes its key; every other row
    # writes a scratch slot past the overflow slot (dropped below)
    start_slot = torch.where(is_start, gid, torch.full_like(gid, nseg)).long()
    for c, k in zip(keys, sk):
        out = torch.empty(nseg + 1, dtype=k.dtype, device=dev)
        out.index_put_((start_slot,), k)
        out_cols[c] = out[:num_groups]

    sorted_cols = {c: rel.col(c)[order] for c in _agg_columns(rel, aggs)}
    values: Dict[str, torch.Tensor] = {}
    for out, (fn, value) in aggs.items():
        if fn == "count":
            continue
        if fn not in ("sum", "mean", "min", "max"):
            raise ValueError(fn)
        if value is None:
            raise ValueError(f"agg {fn} needs a value expression")
        v = sorted_cols[value] if isinstance(value, str) else eval_expr(value, sorted_cols)
        values[out] = as_column(v, dev).to(torch.float32).expand(sv.shape)
    # every sum and mean column as one (R, C) panel, invalid rows zeroed
    summed = [out for out, (fn, _v) in aggs.items() if fn in ("sum", "mean")]
    panel = torch.empty((sv.shape[0], len(summed)), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for j, out in enumerate(summed):
        torch.where(sv, values[out], zero, out=panel[:, j])
    counts, sums = segment_groupby(gid, panel, num_groups)
    group_valid = counts > 0

    for out, (fn, _value) in aggs.items():
        if fn == "count":
            out_cols[out] = counts.to(torch.float32)
        elif fn in ("sum", "mean"):
            s = sums[:, summed.index(out)]
            out_cols[out] = s if fn == "sum" else s / counts.clamp(min=1)
        else:
            v = values[out]
            init = float("inf") if fn == "min" else float("-inf")
            s = torch.full((nseg,), init, dtype=torch.float32, device=dev)
            s.scatter_reduce_(0, gid.long(), torch.where(sv, v, torch.full_like(v, init)),
                              "amin" if fn == "min" else "amax")
            out_cols[out] = zeros_where(group_valid, s[:num_groups])

    for c in keys:
        out_cols[c] = sentinel_where(group_valid, out_cols[c])
    schema = Schema(pk=keys, columns=tuple(sorted(out_cols)))
    return Relation(out_cols, group_valid, schema)


# ---------------------------------------------------------------------------
# ∪ / ∩ / − on keyed relations
# ---------------------------------------------------------------------------

def _member(rel: Relation, probe_cols: Tuple[torch.Tensor, ...], probe_valid) -> torch.Tensor:
    """Is each probe key present among rel's valid keys? (composite keys).

    EXACT on purpose (∩/− sit on the exact maintenance path): single keys
    use sort + searchsorted, composite keys a lexicographic binary search
    over the sorted key columns — never a probabilistic digest.
    """
    rk = masked_keys(rel)
    if len(rk) == 1:
        srk = torch.sort(rk[0]).values
        pos = torch.searchsorted(srk, probe_cols[0].to(srk.dtype))
        safe = pos.clamp(0, rel.capacity - 1)
        return (srk[safe] == probe_cols[0]) & probe_valid
    order = lexsort_indices(rk)
    srk = tuple(k[order] for k in rk)
    K = rel.capacity
    Kp = next_pow2(max(K, 2))
    if Kp != K:  # sentinel pads sort last and match no valid probe
        srk = tuple(
            torch.cat([k, torch.full((Kp - K,), int(SENTINEL_KEY), dtype=k.dtype,
                                     device=k.device)])
            for k in srk
        )

    def tuple_le(idx):
        """srk[idx] ≤ probe, lexicographically (column cascade)."""
        le = srk[-1][idx] <= probe_cols[-1]
        for c in range(len(srk) - 2, -1, -1):
            le = (srk[c][idx] < probe_cols[c]) | ((srk[c][idx] == probe_cols[c]) & le)
        return le

    pos = torch.full(probe_cols[0].shape, -1, dtype=torch.int64, device=probe_cols[0].device)
    step = Kp
    while step >= 1:
        cand = pos + step
        le = (cand < Kp) & tuple_le(cand.clamp(max=Kp - 1))
        pos = torch.where(le, cand, pos)
        step //= 2
    safe = pos.clamp(0, Kp - 1)
    hit = pos >= 0
    for c in range(len(srk)):
        hit = hit & (srk[c][safe] == probe_cols[c])
    return hit & probe_valid


def union_keyed(left: Relation, right: Relation) -> Relation:
    """Keyed union (dedup on pk, left priority).  Capacity n1+n2."""
    if set(left.schema.columns) != set(right.schema.columns):
        raise ValueError("union requires identical schemas")
    dev = left.device
    cols = {c: torch.cat([left.col(c), right.col(c)]) for c in left.schema.columns}
    valid = torch.cat([left.valid, right.valid])
    merged = Relation(cols, valid, left.schema)
    # dedup: keep first occurrence in (key, side) order
    keys = masked_keys(merged)
    side = torch.cat([torch.zeros(left.capacity, dtype=torch.int32, device=dev),
                      torch.ones(right.capacity, dtype=torch.int32, device=dev)])
    order = lexsort_indices(keys, side)
    sk = tuple(k[order] for k in keys)
    first = torch.arange(valid.shape[0], device=dev) == 0
    is_start = ~keys_equal(sk, tuple(_shift_prev(k) for k in sk)) | first
    keep = torch.zeros_like(valid)
    keep[order] = is_start & valid[order]
    return merged.replace(valid=valid & keep)


def intersect_keyed(left: Relation, right: Relation) -> Relation:
    hit = _member(right, masked_keys(left), left.valid)
    return left.replace(valid=left.valid & hit)


def difference_keyed(left: Relation, right: Relation) -> Relation:
    hit = _member(right, masked_keys(left), left.valid)
    return left.replace(valid=left.valid & ~hit)
