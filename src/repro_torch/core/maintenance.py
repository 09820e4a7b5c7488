"""Maintenance strategies M and sample cleaning C (§3, §4.5).

A *maintenance strategy* is a relational plan whose leaves are the stale
view and the delta relations; executing it yields the up-to-date view
S' = M(S, D, ∂D).  ``cleaning_plan`` derives the optimized expression
C = pushdown(η_pk,m(M)) that materializes the up-to-date *sample*
Ŝ' = C(Ŝ, D, ∂D) — Problem 1.

The strategy is the change-table method of Gupta & Mumick used by the
paper's experiments: apply the view definition to the deltas, full-outer-
join the delta view onto the stale view on the group key, and merge
aggregates with generalized projection (Example 1).

The fleet path (``collect_fused_specs``, ``fleet_clean_merge``) batches
many views' delta aggregations into one ``kernels/fused_clean`` fleet
launch and their merge remainders into one ``kernels/fleet_merge`` launch,
as ``repro.core.maintenance`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.pushdown import push_down
from repro_torch.relational import ops
from repro_torch.relational.execute import execute
from repro_torch.relational.expr import Bin, Col
from repro_torch.relational.plan import (
    FKJoin,
    GroupByNode,
    HashNode,
    OuterJoin,
    Plan,
    ProjectNode,
    Scan,
    plan_pk,
    substitute,
)
from repro_torch.relational.relation import (
    Relation,
    compact,
    from_columns,
    next_pow2,
    sentinel_where,
)

INS = "__ins"
DEL = "__del"


@dataclasses.dataclass(frozen=True)
class ViewDef:
    """A named materialized view: its defining plan over base relations."""

    name: str
    plan: Plan

    @property
    def pk(self) -> Tuple[str, ...]:
        return plan_pk(self.plan)


@dataclasses.dataclass
class DeltaSet:
    """∂D: per-base-relation insert and delete relations."""

    inserts: Dict[str, Relation] = dataclasses.field(default_factory=dict)
    deletes: Dict[str, Relation] = dataclasses.field(default_factory=dict)

    def is_empty(self) -> bool:
        return not self.inserts and not self.deletes


# ---------------------------------------------------------------------------
# Change-table strategy construction
# ---------------------------------------------------------------------------

def change_table_strategy(
    view: ViewDef,
    delta_bases: Tuple[str, ...],
    delta_group_capacity: int,
    with_deletes: bool = False,
) -> Plan:
    """Build M for a group-by-aggregate view (Example 1 generalized).

    The returned plan's leaves are Scan(view.name) plus
    Scan(base + "__ins") / Scan(base + "__del").
    """
    g = _find_groupby(view.plan)
    if g is None:
        raise ValueError("change-table strategy requires a group-by aggregate view")
    keys = g.keys
    agg_names = tuple(out for out, _, _ in g.aggs)
    for _, fn, _ in g.aggs:
        if fn not in ("sum", "count") and with_deletes:
            raise ValueError(f"agg {fn!r} is not self-maintainable under deletes")

    def delta_view(suffix: str) -> Plan:
        mapping = {b: b + suffix for b in delta_bases}
        return _replace_groupby_capacity(substitute(view.plan, mapping), delta_group_capacity)

    plan: Plan = Scan(view.name, pk=keys)
    plan = _merge_delta(plan, delta_view(INS), keys, agg_names, sign=+1, tag="_ins")
    if with_deletes:
        plan = _merge_delta(plan, delta_view(DEL), keys, agg_names, sign=-1, tag="_del")
    return plan


def _merge_delta(
    stale: Plan, delta: Plan, keys: Tuple[str, ...], agg_names: Tuple[str, ...], sign: int, tag: str
) -> Plan:
    joined = OuterJoin(left=stale, right=delta, on=keys, how="outer", suffixes=("", tag))
    outputs = [(k, k) for k in keys]
    for a in agg_names:
        outputs.append((a, Bin("add" if sign > 0 else "sub", Col(a), Col(a + tag))))
    return ProjectNode(child=joined, outputs=tuple(outputs), pk=keys)


def _find_groupby(p: Plan) -> Optional[GroupByNode]:
    if isinstance(p, GroupByNode):
        return p
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if isinstance(v, Plan):
            g = _find_groupby(v)
            if g is not None:
                return g
    return None


def _replace_groupby_capacity(p: Plan, cap: int) -> Plan:
    if isinstance(p, GroupByNode):
        return GroupByNode(
            child=_replace_groupby_capacity(p.child, cap),
            keys=p.keys,
            aggs=p.aggs,
            num_groups=cap,
        )
    if isinstance(p, Scan):
        return p
    kw = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        kw[f.name] = _replace_groupby_capacity(v, cap) if isinstance(v, Plan) else v
    return type(p)(**kw)


# ---------------------------------------------------------------------------
# Problem 1: stale sample view cleaning
# ---------------------------------------------------------------------------

def cleaning_plan(
    strategy: Plan, view_pk: Tuple[str, ...], m: float, seed: int = 0,
    pin_name: Optional[str] = None,
) -> Plan:
    """C = pushdown( η_{pk,m}(M) ) — Theorem 1 guarantees sample identity."""
    return push_down(
        HashNode(child=strategy, cols=tuple(view_pk), m=m, seed=seed, pin_name=pin_name)
    )


def delta_env(view_name: str, view_rel: Relation, deltas: DeltaSet) -> Dict[str, Relation]:
    env = {view_name: view_rel}
    for b, rel in deltas.inserts.items():
        env[b + INS] = rel
    for b, rel in deltas.deletes.items():
        env[b + DEL] = rel
    return env


def full_maintenance(
    strategy: Plan, view_name: str, stale_view: Relation, deltas: DeltaSet,
    extra_env: Optional[Mapping[str, Relation]] = None,
    out_capacity: Optional[int] = None,
) -> Relation:
    """IVM baseline: S' = M(S, D, ∂D), compacted to capacity."""
    env = delta_env(view_name, stale_view, deltas)
    if extra_env:
        env.update(extra_env)
    return compact(execute(strategy, env), out_capacity or stale_view.capacity)


# ---------------------------------------------------------------------------
# Fused delta aggregation (kernels/fused_clean dispatch)
# ---------------------------------------------------------------------------

# Largest dense-key accumulator the fused path will allocate; sparse key
# domains beyond this fall back to the sort-based plan executor.
MAX_FUSED_GROUPS = 1 << 20


@dataclasses.dataclass(frozen=True)
class _FusedSpec:
    """A groupby-sum/count over η-filtered delta rows, fusable in one pass."""

    node: GroupByNode
    fact_name: str  # env name of the delta relation (η already below it)
    key: str  # single int group-key column (dense ids < num_groups)
    m: float
    seed: int
    pin_name: Optional[str]
    dim_name: Optional[str] = None  # FK dim relation filtering fact rows
    dim_key: Optional[str] = None
    fact_key: Optional[str] = None


def _match_fused_groupby(p: Plan, env: Mapping[str, Relation]) -> Optional[_FusedSpec]:
    """Does ``p`` have the canonical SVC delta-aggregation shape?

    GroupByNode(single int key; sum/count aggs over plain fact columns)
    over either η(Scan(delta)) or FKJoin(η(Scan(delta)), dim).  The dim-side
    η the push-down adds in the equality case is subsumed by the fact-side η
    (same cols/m/seed after the join-key rename), so the fused path probes
    the unfiltered dim.
    """
    if not isinstance(p, GroupByNode) or len(p.keys) != 1:
        return None
    key = p.keys[0]
    for _out, fn, val in p.aggs:
        if fn not in ("sum", "count"):
            return None
        if fn == "sum" and not isinstance(val, str):
            return None

    child = p.child
    dim_name = dim_key = fact_key = None
    if isinstance(child, FKJoin):
        fact_side, dim_side = child.fact, child.dim
        dim_inner = dim_side.child if isinstance(dim_side, HashNode) else dim_side
        if not isinstance(dim_inner, Scan):
            return None
        dim_key = child.dim_key or (dim_inner.pk[0] if len(dim_inner.pk) == 1 else None)
        if dim_key is None:
            return None
        if isinstance(dim_side, HashNode):
            # dropping the dim-side η is sound only in the push-down equality
            # case: hash on the join key, group key IS the join key, and
            # both sides hash identically
            if not isinstance(fact_side, HashNode):
                return None
            if key != child.fact_key or dim_side.cols != (dim_key,):
                return None
            if (dim_side.m, dim_side.seed, dim_side.pin_name) != (
                fact_side.m, fact_side.seed, fact_side.pin_name
            ):
                return None
        dim_name = dim_inner.name
        fact_key = child.fact_key
        child = fact_side
    if not (isinstance(child, HashNode) and isinstance(child.child, Scan)
            and child.cols == (key,)):
        return None
    fact_name = child.child.name
    fact = env.get(fact_name)
    if fact is None:
        return None
    needed = {key} | {val for _o, fn, val in p.aggs if fn == "sum"}
    if fact_key is not None:
        needed.add(fact_key)
    if not needed <= set(fact.schema.columns):
        return None
    if fact.col(key).dtype != torch.int32:
        return None
    return _FusedSpec(
        node=p, fact_name=fact_name, key=key, m=child.m, seed=child.seed,
        pin_name=child.pin_name, dim_name=dim_name, dim_key=dim_key,
        fact_key=fact_key,
    )


def _assemble_fused_output(spec: _FusedSpec, num_groups: int,
                           counts: torch.Tensor, sums: torch.Tensor) -> Relation:
    """(counts, sums) → the materialized delta-view relation, compacted to
    the group-by's static capacity."""
    group_valid = counts > 0
    keys = torch.arange(num_groups, dtype=torch.int32, device=counts.device)
    out_cols = {spec.key: sentinel_where(group_valid, keys)}
    i = 0
    for out, fn_name, _val in spec.node.aggs:
        if fn_name == "count":
            out_cols[out] = counts
        else:
            out_cols[out] = sums[:, i].contiguous()
            i += 1
    rel = from_columns(out_cols, pk=(spec.key,), valid=group_valid)
    return compact(rel, spec.node.num_groups)


def _eval_fused_groupby(spec: _FusedSpec, env: Mapping[str, Relation]) -> Optional[Relation]:
    """One fused pass over the delta rows → the delta-view relation.

    Returns None when the key domain is unbounded (falls back to the plan
    executor); one host sync reads both key bounds.
    """
    from repro_torch.core.outliers import member_keys
    from repro_torch.kernels.fused_clean.ops import fused_clean_groupby

    fact = env[spec.fact_name]
    keys = fact.col(spec.key)
    imax = torch.iinfo(torch.int32).max
    lo, hi = torch.stack([
        torch.where(fact.valid, keys, torch.full_like(keys, imax)).min(),
        torch.where(fact.valid, keys, torch.full_like(keys, -1)).max(),
    ]).tolist()
    if lo < 0:  # negative keys never land in the dense accumulator
        return None
    num_groups = next_pow2(max(hi + 1, 64))
    if num_groups > MAX_FUSED_GROUPS:
        return None

    valid = fact.valid
    if spec.dim_name is not None:
        dim = env[spec.dim_name]
        probe = sentinel_where(valid, fact.col(spec.fact_key))
        _src, hit = ops.fk_hit(dim, spec.dim_key, probe)
        valid = valid & hit
    pin_mask = None
    pin = env.get(spec.pin_name) if spec.pin_name is not None else None
    if pin is not None:
        pin_mask = member_keys((sentinel_where(valid, keys),), pin.keys)

    sum_cols = tuple(val for _o, fn, val in spec.node.aggs if fn == "sum")
    vals = (
        torch.stack([fact.col(c).to(torch.float32) for c in sum_cols], dim=1)
        if sum_cols else torch.zeros((keys.shape[0], 0), dtype=torch.float32, device=keys.device)
    )
    counts, sums = fused_clean_groupby(
        keys, vals, valid, spec.m, spec.seed, num_groups, pin_mask=pin_mask
    )
    return _assemble_fused_output(spec, num_groups, counts, sums)


def _fused_scan_name(spec: _FusedSpec) -> str:
    """Deterministic, collision-safe env name for a spliced delta view: every
    field that shapes the fused result participates."""
    aggs = "_".join(f"{o}.{fn}.{val}" for o, fn, val in spec.node.aggs)
    parts = (
        spec.fact_name, spec.key, aggs, str(spec.node.num_groups),
        str(spec.dim_name), str(spec.fact_key),
        repr(spec.m), str(spec.seed), str(spec.pin_name),
    )
    return "__fused__" + "__".join(parts)


def collect_fused_specs(plan: Plan, env: Mapping[str, Relation]):
    """The fusable delta-aggregation sub-trees of a pushed cleaning plan.

    Same walk as ``fuse_delta_groupbys`` but evaluation-free: the fleet
    refresh path batches the specs' η+γ stage across views before splicing
    the results back in through ``precomputed``."""
    out = []

    def walk(p: Plan) -> None:
        spec = _match_fused_groupby(p, env)
        if spec is not None:
            out.append(spec)
            return
        for f in dataclasses.fields(p):
            v = getattr(p, f.name)
            if isinstance(v, Plan):
                walk(v)

    walk(plan)
    return out


def fuse_delta_groupbys(plan: Plan, env: Mapping[str, Relation],
                        precomputed: Optional[Mapping[_FusedSpec, Relation]] = None):
    """Splice fused-kernel results in place of fusable delta aggregations.

    Every sub-tree of the pushed cleaning plan matching the canonical η+γ
    shape is evaluated by ``kernels/fused_clean`` and replaced with a Scan
    of the materialized delta view, leaving only the outer-join merge for
    the plan executor.  ``precomputed`` maps specs to already-evaluated
    delta views (the fleet path batched them); matching specs splice those
    instead of re-evaluating.  Returns (plan, env) unchanged when nothing
    qualifies.
    """
    new_env = dict(env)
    fused_any = False

    def walk(p: Plan) -> Plan:
        nonlocal fused_any
        spec = _match_fused_groupby(p, new_env)
        if spec is not None:
            rel = None if precomputed is None else precomputed.get(spec)
            if rel is None:
                rel = _eval_fused_groupby(spec, new_env)
            if rel is not None:
                name = _fused_scan_name(spec)
                new_env[name] = rel
                fused_any = True
                return Scan(name, pk=(spec.key,))
            return p
        if isinstance(p, Scan):
            return p
        kw = {}
        for f in dataclasses.fields(p):
            v = getattr(p, f.name)
            kw[f.name] = walk(v) if isinstance(v, Plan) else v
        return type(p)(**kw)

    new_plan = walk(plan)
    return (new_plan, new_env) if fused_any else (plan, env)


# ---------------------------------------------------------------------------
# Fleet-batched delta aggregation and merge remainder (svc_refresh_many)
# ---------------------------------------------------------------------------

def fleet_fused_inputs(entries):
    """The launches of a batched fused η+γ over many delta relations.

    ``entries`` is a list of (entry_id, fact, spec).  Entries are grouped by
    (delta arena capacity, value-column count); every group becomes ONE
    ``fused_clean_groupby_fleet`` launch with per-entry ratios and seeds (a
    lone entry still rides the batched kernel).  Entries whose key domain is unbounded
    (negative keys, or past MAX_FUSED_GROUPS) are left out, so one wide-key
    entry does not knock its shape-mates off the batched path.  One host
    sync reads every member's key bounds.

    Returns a list of (entry ids, launch arguments) — the arguments are
    (gid (V, R), vals (V, R, C), valid (V, R), ms, seeds, num_groups).
    """
    groups: Dict[Tuple[int, int], list] = {}
    for eid, fact, spec in entries:
        sum_cols = tuple(val for _o, fn, val in spec.node.aggs if fn == "sum")
        groups.setdefault((fact.capacity, len(sum_cols)), []).append((eid, fact, spec, sum_cols))

    imax = torch.iinfo(torch.int32).max
    launches = []
    for members in groups.values():
        bounds = torch.stack([
            torch.stack([
                torch.where(fact.valid, fact.col(spec.key),
                            torch.full_like(fact.col(spec.key), imax)).min(),
                torch.where(fact.valid, fact.col(spec.key),
                            torch.full_like(fact.col(spec.key), -1)).max(),
            ])
            for _n, fact, spec, _sc in members
        ]).cpu().tolist()
        keep = [i for i, (lo, hi) in enumerate(bounds)
                if lo >= 0 and next_pow2(max(hi + 1, 64)) <= MAX_FUSED_GROUPS]
        if not keep:
            continue
        num_groups = next_pow2(max(max(bounds[i][1] for i in keep) + 1, 64))
        sel = [members[i] for i in keep]
        gid = torch.stack([fact.col(spec.key) for _n, fact, spec, _sc in sel])
        valid = torch.stack([fact.valid for _n, fact, _s, _sc in sel])
        vals = torch.stack([
            torch.stack([fact.col(c).to(torch.float32) for c in sc], dim=1) if sc
            else torch.zeros((fact.capacity, 0), dtype=torch.float32, device=fact.device)
            for _n, fact, _s, sc in sel
        ])
        ms = [spec.m for _n, _f, spec, _sc in sel]
        seeds = [spec.seed for _n, _f, spec, _sc in sel]
        launches.append(([eid for eid, _f, _s, _sc in sel],
                         (gid, vals, valid, ms, seeds, num_groups)))
    return launches


def _fleet_fused_counts(entries):
    """Batched fused η+γ (``fleet_fused_inputs``) → {entry_id: (counts (G,),
    sums (G, n_sum), G)} for the entries that ran; callers fall back for the
    rest."""
    from repro_torch.kernels.fused_clean.ops import fused_clean_groupby_fleet

    out = {}
    for eids, args in fleet_fused_inputs(entries):
        counts, sums = fused_clean_groupby_fleet(*args)
        for i, eid in enumerate(eids):
            out[eid] = (counts[i], sums[i], args[-1])
    return out


def _cap_group_validity(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """Which dense delta groups survive ``_assemble_fused_output``'s compact.

    The per-view path compacts the dense accumulator to the group-by's
    static capacity, keeping the ``cap`` LOWEST-keyed live groups when more
    are live; reproducing that drop keeps the batched merge equal to the
    per-view path even in overflow."""
    nz = counts > 0
    rank = torch.cumsum(nz.to(torch.int32), dim=0)
    return nz & (rank <= cap)


@dataclasses.dataclass
class _MergeJob:
    """One view's inputs to the fleet-batched merge remainder.

    ``stale_*`` come from the fleet panel's merge slot (one padded Rp across
    the fleet, SENTINEL keys / zero values on invalid rows); ``ins``/``dele``
    are (delta fact, fused spec) pairs whose aggregations
    ``fleet_clean_merge`` batches before the single merge launch."""

    name: str
    key: str                       # group-key column name
    agg_cols: Tuple[str, ...]      # aggregate output columns, spec order
    col_dtypes: Mapping[str, torch.dtype]  # clean-sample column dtypes
    stale_keys: torch.Tensor       # (Rp,) int32, SENTINEL on invalid rows
    stale_valid: torch.Tensor      # (Rp,) bool
    stale_vals: torch.Tensor       # (Rp, A) f32, agg_cols order
    ins: Tuple[Relation, _FusedSpec]
    dele: Optional[Tuple[Relation, _FusedSpec]]
    out_capacity: int              # the view's sample arena capacity


def _dense_side(spec: _FusedSpec, counts: torch.Tensor, sums: torch.Tensor,
                num_groups: int, g_pad: int):
    """Raw accumulators → (valid (g_pad,), vals (g_pad, A)) dense panels, value
    columns in ``spec.node.aggs`` order (the layout of
    ``_assemble_fused_output``)."""
    gv = _cap_group_validity(counts, spec.node.num_groups)
    cols = []
    i = 0
    for _out, fn_name, _val in spec.node.aggs:
        if fn_name == "count":
            cols.append(counts.to(torch.float32))
        else:
            cols.append(sums[:, i].to(torch.float32))
            i += 1
    vals = torch.stack(cols, dim=1)
    if g_pad > num_groups:
        gv = torch.nn.functional.pad(gv, (0, g_pad - num_groups))
        vals = torch.nn.functional.pad(vals, (0, 0, 0, g_pad - num_groups))
    return gv, vals


def fleet_merge_inputs(jobs: Sequence[_MergeJob]):
    """Batch every job's delta aggregations and stack the fleet_merge panels.

    The insert side (and delete side) of every job run batched
    (``_fleet_fused_counts``); jobs sharing (Rp, aggregate count) stack into one
    launch.  Returns ``(launches, precomputed)``: a list of (jobs, the seven
    stacked ``fleet_merge`` arguments), and {view name: {spec: relation}}
    for jobs whose key domain kept a side off the batched path — their
    aggregated sides still splice into the per-view fallback."""
    entries = []
    for j in jobs:
        entries.append(((j.name, "ins"), j.ins[0], j.ins[1]))
        if j.dele is not None:
            entries.append(((j.name, "del"), j.dele[0], j.dele[1]))
    raw = _fleet_fused_counts(entries)

    precomputed: Dict[str, Dict[_FusedSpec, Relation]] = {}
    ready = []
    for j in jobs:
        ri = raw.get((j.name, "ins"))
        rd = raw.get((j.name, "del")) if j.dele is not None else None
        if ri is None or (j.dele is not None and rd is None):
            pre = {}
            if ri is not None:
                pre[j.ins[1]] = _assemble_fused_output(j.ins[1], ri[2], ri[0], ri[1])
            if rd is not None:
                pre[j.dele[1]] = _assemble_fused_output(j.dele[1], rd[2], rd[0], rd[1])
            if pre:
                precomputed[j.name] = pre
            continue
        ready.append((j, ri, rd))

    shape_groups: Dict[Tuple[int, int], list] = {}
    for item in ready:
        j = item[0]
        shape_groups.setdefault((int(j.stale_keys.shape[0]), len(j.agg_cols)), []).append(item)

    launches = []
    for (_rp, n_agg), members in shape_groups.items():
        g_pad = max(max(ri[2], rd[2] if rd is not None else 0) for _j, ri, rd in members)
        dev = members[0][0].stale_keys.device
        ins_v, ins_x, del_v, del_x = [], [], [], []
        for j, ri, rd in members:
            gv, gx = _dense_side(j.ins[1], ri[0], ri[1], ri[2], g_pad)
            ins_v.append(gv)
            ins_x.append(gx)
            if rd is not None:
                gv, gx = _dense_side(j.dele[1], rd[0], rd[1], rd[2], g_pad)
            else:
                gv = torch.zeros(g_pad, dtype=torch.bool, device=dev)
                gx = torch.zeros((g_pad, n_agg), dtype=torch.float32, device=dev)
            del_v.append(gv)
            del_x.append(gx)
        args = (torch.stack([j.stale_keys for j, _ri, _rd in members]),
                torch.stack([j.stale_valid for j, _ri, _rd in members]),
                torch.stack([j.stale_vals for j, _ri, _rd in members]),
                torch.stack(ins_v), torch.stack(ins_x), torch.stack(del_v), torch.stack(del_x))
        launches.append(([j for j, _ri, _rd in members], args))
    return launches, precomputed


def fleet_clean_merge(jobs: Sequence[_MergeJob]):
    """The whole epoch's merge remainders in one ``fleet_merge`` launch per
    (Rp, aggregate count) shape (``fleet_merge_inputs``).  Per-view work
    after the launch is slicing the sorted rows back into each view's
    sample arena.

    Returns ``(merged, precomputed)``: ``merged`` maps view name → its
    cleaned sample relation; ``precomputed`` as ``fleet_merge_inputs``.
    """
    from repro_torch.kernels.fleet_merge import fleet_merge

    launches, precomputed = fleet_merge_inputs(jobs)
    merged: Dict[str, Relation] = {}
    for members, args in launches:
        keys, vals, valid = fleet_merge(*args)
        span = int(keys.shape[1])
        for idx, j in enumerate(members):
            n = min(j.out_capacity, span)
            # sorted valid-first ascending ⇒ truncation keeps the lowest-
            # keyed rows, exactly compact's overflow behaviour
            cols = {j.key: keys[idx, :n].to(j.col_dtypes[j.key])}
            for a_i, cname in enumerate(j.agg_cols):
                cols[cname] = vals[idx, :n, a_i].to(j.col_dtypes[cname])
            merged[j.name] = from_columns(cols, pk=(j.key,), valid=valid[idx, :n],
                                          capacity=j.out_capacity)
    return merged, precomputed


def clean_sample(
    strategy: Plan,
    view_name: str,
    view_pk: Tuple[str, ...],
    stale_sample: Relation,
    deltas: DeltaSet,
    m: float,
    seed: int = 0,
    extra_env: Optional[Mapping[str, Relation]] = None,
    out_capacity: Optional[int] = None,
    pin_name: Optional[str] = None,
    fused: bool = True,
    precomputed: Optional[Mapping[_FusedSpec, Relation]] = None,
) -> Relation:
    """Ŝ' = C(Ŝ, D, ∂D) — the up-to-date sample at ratio m (Problem 1).

    With ``fused`` (the default) the η-filtered groupby-sum/count delta
    sub-aggregations run through ``kernels/fused_clean`` — hash threshold
    and per-group accumulation in one pass — and only the merge remainder
    runs through the plan executor.  Plans whose shape or key domain does
    not qualify fall back to the plan executor.  ``precomputed`` splices
    delta aggregations the fleet path already batched.
    """
    plan = cleaning_plan(strategy, view_pk, m, seed, pin_name=pin_name)
    env = delta_env(view_name, stale_sample, deltas)
    if extra_env:
        env.update(extra_env)
    if fused:
        plan, env = fuse_delta_groupbys(plan, env, precomputed=precomputed)
    return compact(execute(plan, env), out_capacity or stale_sample.capacity)


# ---------------------------------------------------------------------------
# Base-relation update primitives
# ---------------------------------------------------------------------------

def upsert(rel: Relation, delta: Relation, capacity: Optional[int] = None) -> Relation:
    """Insert-or-replace by primary key (update = delete + insert, §3.1)."""
    merged = ops.union_keyed(delta, rel)  # left (delta) priority
    return compact(merged, capacity or rel.capacity)


def delete_keys(rel: Relation, gone: Relation) -> Relation:
    """Mask out rows of ``rel`` whose pk appears in ``gone``."""
    return ops.difference_keyed(rel, gone)


def staleness_report(stale: Relation, fresh: Relation) -> Dict[str, torch.Tensor]:
    """Counts of incorrect / missing / superfluous rows (§3.1) — debugging."""
    inner = ops.outer_join_unique(stale, fresh, on=stale.schema.pk, how="outer",
                                  suffixes=("_stale", "_fresh"))
    lp = inner.col("__left_present").to(torch.bool) & inner.valid
    rp = inner.col("__right_present").to(torch.bool) & inner.valid
    both = lp & rp
    changed = torch.zeros_like(both)
    for c in stale.schema.columns:
        if c in stale.schema.pk:
            continue
        a = inner.columns.get(c + "_stale", inner.columns.get(c))
        b = inner.columns.get(c + "_fresh")
        if a is None or b is None:
            continue
        changed = changed | (both & (a != b))
    return {
        "incorrect": changed.sum(dtype=torch.int32),
        "missing": (rp & ~lp).sum(dtype=torch.int32),
        "superfluous": (lp & ~rp).sum(dtype=torch.int32),
    }
