"""ViewManager: the production face of SVC (§3.2 workflow), on torch.

Owns base relations, registered materialized views, their hash samples and
optional outlier indices.  Deltas are ingested continuously; full IVM
(``maintain``) runs only at maintenance periods, while ``svc_refresh``
cleans just the samples in between so that ``query`` always answers from
fresh, bounded estimates.  Estimator selection follows the §5.2.2
break-even analysis (SVC+CORR vs SVC+AQP, or force with ``prefer=``).

The single-view surface of ``repro.views.manager``: streaming, the
planner, the fleet panel, tracing/metrics and fleet health are not ported
yet.  Every relation lives on the manager's ``device`` (CUDA by default);
a manager asked for CUDA on a machine without a card raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.estimators import (
    Estimate,
    Query,
    exact,
    svc_aqp,
    svc_corr,
    variance_comparison,
)
from repro_torch.core.maintenance import (
    DEL,
    DeltaSet,
    ViewDef,
    _replace_groupby_capacity,
    change_table_strategy,
    clean_sample,
    delete_keys,
    full_maintenance,
    upsert,
)
from repro_torch.core.outliers import (
    OutlierIndex,
    build_outlier_index,
    flag_outliers,
    propagate_outlier_keys,
    update_outlier_index,
)
from repro_torch.query import (
    QueryBatch,
    build_correspondence_cache,
    is_encodable,
    run_batch,
    run_batch_aqp,
    sample_columns,
)
from repro_torch.relational.execute import execute
from repro_torch.relational.plan import plan_leaves
from repro_torch.relational.relation import (
    SENTINEL_KEY,
    Relation,
    compact,
    empty,
    from_columns,
    lexsort_indices,
    next_pow2,
)


@dataclasses.dataclass
class ManagedView:
    view: ViewDef
    strategy: object  # maintenance plan M
    sampled_strategy: object  # M with m-scaled group arenas
    m: float
    seed: int
    materialized: Relation  # the (possibly stale) full view S
    stale_sample: Relation  # Ŝ = η(S)
    clean_sample: Relation  # Ŝ' after last svc_refresh
    sample_capacity: int
    delta_bases: Tuple[str, ...]
    outlier_index: Optional[OutlierIndex] = None
    outlier_pin: Optional[Relation] = None  # view-key pin set from push-up
    # per-refresh-window correspondence cache (query.engine), built lazily
    # on the first query of a window and dropped by refresh/maintain
    corr_cache: Optional[object] = None
    # segments [0, applied_seg) are already folded into ``materialized``
    applied_seg: int = 0
    # delta batches offered to the outlier index but not yet merged; flushed
    # as ONE update_outlier_index call per refresh window
    outlier_offers: List[Relation] = dataclasses.field(default_factory=list)


class ViewManager:
    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ViewManager(device={str(device)!r}): no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
        self.base: Dict[str, Relation] = {}
        self.views: Dict[str, ManagedView] = {}
        # pending deltas as an ordered SEGMENT log (one DeltaSet per ingest
        # batch) with per-view cursors; a segment is applied to the base
        # relations once every dependent view has folded it in
        self.pending_segments: List[DeltaSet] = []
        self._merged_cache: Dict[Tuple[int, int], DeltaSet] = {}

    def _sync(self) -> None:
        """Wait for the device, so wall times cover the work, not the enqueue."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def pending(self) -> DeltaSet:
        """All not-yet-base-applied deltas merged per base (read-only view)."""
        return self._pending_from(0)

    # -- registration --------------------------------------------------------
    def register_base(self, name: str, rel: Relation) -> None:
        self.base[name] = rel.to(self.device)

    def register_view(
        self,
        view: ViewDef,
        delta_bases: Tuple[str, ...],
        m: float,
        seed: int = 0,
        delta_group_capacity: int = 1024,
        sample_capacity: Optional[int] = None,
        with_deletes: bool = False,
    ) -> ManagedView:
        strategy = change_table_strategy(
            view, delta_bases, delta_group_capacity, with_deletes=with_deletes
        )
        materialized = compact(execute(view.plan, self.base))
        stale_sample = hashing.apply_hash(materialized, view.pk, m, seed)
        # sample-side arenas are m-scaled (4x slack against binomial
        # overflow) instead of inheriting the full view capacity
        cap = sample_capacity or next_pow2(max(64, int(materialized.capacity * m * 4)))
        sampled_strategy = _replace_groupby_capacity(
            strategy, next_pow2(max(64, int(delta_group_capacity * m * 4)))
        )
        mv = ManagedView(
            view=view,
            strategy=strategy,
            sampled_strategy=sampled_strategy,
            m=m,
            seed=seed,
            materialized=materialized,
            stale_sample=compact(stale_sample, cap),
            clean_sample=compact(stale_sample, cap),
            sample_capacity=cap,
            delta_bases=delta_bases,
        )
        self.views[view.name] = mv
        return mv

    def register_outlier_index(self, view_name: str, base: str, attr: str, k: int) -> None:
        """§6: index top-k of base[attr]; push keys up into the view pin set."""
        mv = self.views[view_name]
        mv.outlier_index = build_outlier_index(self.base[base], base, attr, k)
        self._refresh_pin(mv)

    def _pin_relation(self, mv: ManagedView) -> Relation:
        keys = propagate_outlier_keys(mv.view.plan, self.base, mv.outlier_index)
        pin_cols = {c: keys[i] for i, c in enumerate(mv.view.pk)}
        return from_columns(pin_cols, pk=mv.view.pk, valid=keys[0] != int(SENTINEL_KEY))

    def _refresh_pin(self, mv: ManagedView) -> None:
        if mv.outlier_index is None:
            return
        mv.outlier_pin = self._pin_relation(mv)
        # re-derive both samples with the pin so strata stay consistent
        mv.stale_sample = compact(
            hashing.apply_hash(mv.materialized, mv.view.pk, mv.m, mv.seed, pin=mv.outlier_pin),
            mv.sample_capacity,
        )
        mv.clean_sample = mv.stale_sample
        mv.corr_cache = None

    # -- delta ingestion -----------------------------------------------------
    def ingest(self, base: str, inserts: Optional[Relation] = None,
               deletes: Optional[Relation] = None) -> None:
        """Ingest a delta batch into the pending segment log; the caller
        refreshes (``svc_refresh``) or maintains (``maintain``) when it likes."""
        seg = DeltaSet()
        if inserts is not None:
            inserts = inserts.to(self.device)
            seg.inserts[base] = inserts
        if deletes is not None:
            seg.deletes[base] = deletes.to(self.device)
        if not seg.is_empty():
            self.pending_segments.append(seg)
            self._merged_cache.clear()
        for mv in self.views.values():
            if (mv.outlier_index is not None and mv.outlier_index.base == base
                    and inserts is not None):
                mv.outlier_offers.append(inserts)

    def _pending_from(self, lo: int) -> DeltaSet:
        """Segments [lo:] merged per base (memoized per refresh window)."""
        key = (lo, len(self.pending_segments))
        merged = self._merged_cache.get(key)
        if merged is None:
            ins: Dict[str, List[Relation]] = {}
            dels: Dict[str, List[Relation]] = {}
            for seg in self.pending_segments[lo:]:
                for b, r in seg.inserts.items():
                    ins.setdefault(b, []).append(r)
                for b, r in seg.deletes.items():
                    dels.setdefault(b, []).append(r)
            merged = DeltaSet(
                inserts={b: _concat_many(rs) for b, rs in ins.items()},
                deletes={b: _concat_many(rs) for b, rs in dels.items()},
            )
            self._merged_cache[key] = merged
        return merged

    def _deltas_for(self, mv: ManagedView) -> DeltaSet:
        """Pending deltas beyond the view's applied cursor, with EMPTY
        stand-ins for quiet delta bases so the cleaning/maintenance plans
        always find their Scan leaves (insert and delete leaves alike)."""
        merged = self._pending_from(mv.applied_seg)
        out = DeltaSet(inserts=dict(merged.inserts), deletes=dict(merged.deletes))
        leaves = {leaf.name for leaf in plan_leaves(mv.strategy)}
        for b in mv.delta_bases:
            base = self.base[b]
            dtypes = {c: base.col(c).dtype for c in base.schema.columns}
            if b not in out.inserts:
                out.inserts[b] = empty(dtypes, base.schema.pk, 8, self.device)
            if b + DEL in leaves and b not in out.deletes:
                out.deletes[b] = empty(dtypes, base.schema.pk, 8, self.device)
        return out

    def _flush_outlier_offers(self, mv: ManagedView) -> None:
        """Merge the window's buffered index offers in ONE incremental update
        (offer order preserved, so it equals the per-batch path)."""
        offers, mv.outlier_offers = mv.outlier_offers, []
        if not offers or mv.outlier_index is None:
            return
        if len(offers) == 1:
            delta = offers[0]
        else:
            schema = offers[0].schema
            cols = {c: torch.cat([r.col(c) for r in offers]) for c in schema.columns}
            delta = Relation(cols, torch.cat([r.valid for r in offers]), schema)
        mv.outlier_index = update_outlier_index(mv.outlier_index, delta)

    # -- SVC: clean the samples only (cheap, between maintenance periods) ----
    def svc_refresh(self, view_name: str, fused: bool = True) -> float:
        """Clean the view's sample from the pending deltas (Problem 1).

        ``fused`` routes the delta aggregation through kernels/fused_clean
        (the plan executor takes over when the plan shape does not qualify).
        The clean is TRANSACTIONAL: any failure restores the view's
        pre-clean state and re-raises.  Returns the wall seconds."""
        mv = self.views[view_name]
        snap = _view_snapshot(mv)
        try:
            return self._svc_refresh_inner(mv, view_name, fused)
        except BaseException:
            _restore_view(mv, snap)
            raise

    def _svc_refresh_inner(self, mv: ManagedView, view_name: str, fused: bool) -> float:
        t0 = time.perf_counter()
        if mv.outlier_index is not None:
            self._flush_outlier_offers(mv)
            mv.outlier_pin = self._pin_relation(mv)
        extra = dict(self.base)
        pin_name = None
        if mv.outlier_pin is not None:
            pin_name = "__pin__" + view_name
            extra[pin_name] = mv.outlier_pin
        cleaned = clean_sample(
            mv.sampled_strategy,
            mv.view.name,
            mv.view.pk,
            mv.stale_sample,
            self._deltas_for(mv),
            mv.m,
            mv.seed,
            extra_env=extra,
            out_capacity=mv.sample_capacity,
            pin_name=pin_name,
            fused=fused,
        )
        mv.clean_sample = flag_outliers(cleaned, mv.outlier_pin)
        mv.stale_sample = flag_outliers(mv.stale_sample, mv.outlier_pin)
        mv.corr_cache = None  # samples moved: new correspondence window
        self._sync()
        return time.perf_counter() - t0

    # -- full IVM (the expensive path; runs at maintenance periods) ----------
    def maintain(self, view_name: str) -> float:
        """Full IVM for ONE view: fold the pending segments beyond its cursor
        into the materialized view, advance the cursor, and apply segments
        every dependent view has absorbed to the base relations.
        Transactional like ``svc_refresh``; returns the IVM wall seconds."""
        mv = self.views[view_name]
        snap = _view_snapshot(mv)
        try:
            return self._maintain_inner(mv)
        except BaseException:
            _restore_view(mv, snap)
            raise

    def _maintain_inner(self, mv: ManagedView) -> float:
        self._flush_outlier_offers(mv)
        t0 = time.perf_counter()
        hi = len(self.pending_segments)
        mv.materialized = full_maintenance(
            mv.strategy,
            mv.view.name,
            mv.materialized,
            self._deltas_for(mv),
            extra_env=self.base,
            out_capacity=mv.materialized.capacity,
        )
        self._sync()
        dt = time.perf_counter() - t0
        mv.stale_sample = compact(
            hashing.apply_hash(mv.materialized, mv.view.pk, mv.m, mv.seed, pin=mv.outlier_pin),
            mv.sample_capacity,
        )
        mv.clean_sample = mv.stale_sample
        mv.corr_cache = None
        mv.applied_seg = hi
        self._advance_pending_floor()
        return dt

    def maintain_all(self) -> float:
        total = 0.0
        for name in self.views:
            total += self.maintain(name)
        self._advance_pending_floor()  # no views registered: drain anyway
        return total

    def _advance_pending_floor(self) -> None:
        """Apply and pop every leading segment that all dependent views have
        already folded in; cursors shift with the pop."""
        popped = False
        while self.pending_segments:
            seg = self.pending_segments[0]
            bases = set(seg.inserts) | set(seg.deletes)
            gating = [mv for mv in self.views.values() if bases & set(mv.delta_bases)]
            if any(mv.applied_seg < 1 for mv in gating):
                break
            self._apply_segment_to_base(seg)
            self.pending_segments.pop(0)
            for mv in self.views.values():
                mv.applied_seg = max(0, mv.applied_seg - 1)
            popped = True
        if popped:
            self._merged_cache.clear()

    def _apply_segment_to_base(self, seg: DeltaSet) -> None:
        for b, rel in seg.inserts.items():
            grown = max(self.base[b].capacity,
                        next_pow2(int(self.base[b].valid.sum()) + rel.capacity))
            self.base[b] = upsert(self.base[b], rel, capacity=grown)
        for b, rel in seg.deletes.items():
            self.base[b] = delete_keys(self.base[b], rel)

    # -- query API ------------------------------------------------------------
    def query(
        self,
        view_name: str,
        q: Query,
        confidence: float = 0.95,
        prefer: Optional[str] = None,  # "corr" | "aqp" | None (auto, §5.2.2)
    ) -> Estimate:
        """Estimate one query — a batch of one through the batched engine."""
        return self.query_batch(view_name, [q], confidence=confidence, prefer=prefer)[0]

    def query_batch(
        self,
        view_name: str,
        queries: Sequence[Query],
        confidence: float = 0.95,
        prefer: Optional[str] = None,
    ) -> List[Estimate]:
        """Answer N queries in one fused pass (multi-query optimization).

        Encodable sample-mean queries share one correspondence-cache lookup,
        one kernels/multi_agg moment scan and (only if some query resolves
        to SVC+CORR) one batched exact scan of the materialized view.  The
        others go through ``_query_fallback``; result order matches
        ``queries``."""
        mv = self.views[view_name]
        results: List[Optional[Estimate]] = [None] * len(queries)
        cols = sample_columns(mv.clean_sample)
        batched = [i for i, q in enumerate(queries) if is_encodable(q, cols)]
        fast = set(batched)
        for i, q in enumerate(queries):
            if i not in fast:
                results[i] = self._query_fallback(mv, q, confidence, prefer)
        if batched:
            batch = QueryBatch.encode([queries[i] for i in batched], cols, self.device)
            if prefer == "aqp":
                # AQP never needs the stale side: no correspondence join
                ests = run_batch_aqp(mv.clean_sample, batch, mv.m, confidence=confidence)
            else:
                ests = run_batch(
                    self._corr_cache(mv), batch, confidence=confidence, prefer=prefer,
                    materialized=mv.materialized,
                )
            for i, e in zip(batched, ests):
                results[i] = e
        return results

    def _corr_cache(self, mv: ManagedView):
        if mv.corr_cache is None:
            mv.corr_cache = build_correspondence_cache(mv.clean_sample, mv.stale_sample, mv.m)
        return mv.corr_cache

    def _query_fallback(
        self, mv: ManagedView, q: Query, confidence: float, prefer: Optional[str],
    ) -> Estimate:
        """Per-query estimators for queries outside the engine's class."""
        if q.agg in ("sum", "count", "avg"):
            if prefer is None:
                cmp = variance_comparison(mv.clean_sample, mv.stale_sample, q, mv.m)
                prefer = "corr" if bool(cmp["corr_wins"]) else "aqp"
            if prefer == "corr":
                return svc_corr(exact(mv.materialized, q), mv.clean_sample,
                                mv.stale_sample, q, mv.m, confidence)
            return svc_aqp(mv.clean_sample, q, mv.m, confidence)
        if q.agg in ("median", "percentile", "min", "max"):
            raise NotImplementedError(
                f"{q.agg} queries (bootstrap and min/max estimators) are not ported "
                "yet: ROADMAP queue A.7"
            )
        raise ValueError(q.agg)

    def query_stale(self, view_name: str, q: Query) -> torch.Tensor:
        """No-maintenance baseline answer."""
        return exact(self.views[view_name].materialized, q)

    def query_exact_fresh(self, view_name: str, q: Query) -> torch.Tensor:
        """Ground truth: full IVM into a scratch copy (test/benchmark helper)."""
        mv = self.views[view_name]
        fresh = full_maintenance(
            mv.strategy, mv.view.name, mv.materialized, self._deltas_for(mv),
            extra_env=self.base, out_capacity=mv.materialized.capacity,
        )
        return exact(fresh, q)


def _view_snapshot(mv: ManagedView) -> dict:
    """Field-level snapshot of a ManagedView for rollback.  Relations are
    never mutated in place (every update rebinds the field), so copying the
    fields — and the offer list — is a full transactional checkpoint."""
    snap = {f.name: getattr(mv, f.name) for f in dataclasses.fields(mv)}
    snap["outlier_offers"] = list(mv.outlier_offers)
    return snap


def _restore_view(mv: ManagedView, snap: dict) -> None:
    for k, v in snap.items():
        setattr(mv, k, v)


def _concat_many(rels: List[Relation]) -> Relation:
    """Concatenate delta segments into one size-bucketed arena.

    Capacity is the next power of two ≥ the VALID row count (≥ 4096), so a
    steady ingest stream keeps one arena shape.  Valid rows are stably
    sorted by the composite pk — ``compact``'s order — and padded with
    sentinel keys / zeros, as the JAX package does on the host.
    """
    schema = rels[0].schema
    n_valid = int(sum(int(r.valid.sum()) for r in rels))
    cap = next_pow2(max(n_valid, 4096))
    if len(rels) == 1 and rels[0].capacity == cap:
        return rels[0]
    bodies = {c: torch.cat([r.col(c)[r.valid] for r in rels]) for c in schema.columns}
    order = lexsort_indices(tuple(bodies[k] for k in schema.pk))
    dev = rels[0].device
    cols = {}
    for c in schema.columns:
        fill = int(SENTINEL_KEY) if c in schema.pk else 0
        arena = torch.full((cap,), fill, dtype=bodies[c].dtype, device=dev)
        arena[:n_valid] = bodies[c][order]
        cols[c] = arena
    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    valid[:n_valid] = True
    return Relation(cols, valid, schema)
