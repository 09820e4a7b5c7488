"""ViewManager: the production face of SVC (§3.2 workflow), on torch.

Owns base relations, registered materialized views, their hash samples and
optional outlier indices.  Deltas are ingested continuously; full IVM
(``maintain``) runs only at maintenance periods, while ``svc_refresh``
cleans just the samples in between so that ``query`` always answers from
fresh, bounded estimates.  Estimator selection follows the §5.2.2
break-even analysis (SVC+CORR vs SVC+AQP, or force with ``prefer=``).

The fleet surface rides along: ``svc_refresh_many`` cleans many views in
one fused-clean fleet launch and one fleet_merge launch, ``fleet_panel``
stacks every view's samples for the planner's moment pass, ``health``
quarantines views whose clean or maintenance failed, and a ``cost_model``
(``repro_torch.planner``) hears every refresh, maintenance and query.
``configure_streaming`` routes ``ingest`` through bounded out-of-order
micro-batch logs that refresh on size and age watermarks
(``repro_torch.streaming``); ``metrics`` is the registry every streaming
and serving counter lands in.  Median, percentile, min and max queries
take the bootstrap and Cantelli estimators.  Every relation lives on the
manager's ``device`` (CUDA by default); a manager asked for CUDA on a
machine without a card raises.

Observability and chaos: with a tracer installed (``repro_torch.obs.
trace``) the manager opens JAX's ``clean``, ``merge``, ``maintain`` and
``estimate`` spans, and a ``FaultPlan`` attached as ``fault_plan``
(``repro_torch.robustness.faults``) fires at the designed failure points:
``refresh`` and ``maintain`` at the top of each clean and maintenance,
``kernel`` around the batched clean's launches.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hashing
from repro_torch.core.bootstrap import bootstrap_aqp, bootstrap_corr
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
    INS,
    DeltaSet,
    ViewDef,
    _MergeJob,
    _replace_groupby_capacity,
    change_table_strategy,
    clean_sample,
    cleaning_plan,
    collect_fused_specs,
    delete_keys,
    delta_env,
    fleet_clean_merge,
    full_maintenance,
    upsert,
)
from repro_torch.core.minmax import svc_minmax
from repro_torch.core.outliers import (
    OutlierIndex,
    PinSet,
    build_outlier_index,
    flag_outliers,
    pin_set,
    propagate_outlier_keys,
    update_outlier_index,
)
from repro_torch.kernels._build import cuda_device
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.registry import MetricsRegistry, counter_attr
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
from repro_torch.robustness.faults import FaultInjected
from repro_torch.robustness.health import FleetHealth


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
    # view-key pin set from push-up, with the digest table its pinned hash
    # probes; ``pin_source`` is what it was derived from (the index object
    # and the manager's base epoch), so a refresh rebuilds it only when
    # either moved
    outlier_pin: Optional[PinSet] = None
    pin_source: Optional[Tuple[object, int]] = None
    # per-refresh-window correspondence cache (query.engine), built lazily
    # on the first query of a window and dropped by refresh/maintain
    corr_cache: Optional[object] = None
    # segments [0, applied_seg) are already folded into ``materialized``
    applied_seg: int = 0
    # delta batches offered to the outlier index but not yet merged; flushed
    # as ONE update_outlier_index call per refresh window
    outlier_offers: List[Relation] = dataclasses.field(default_factory=list)
    maintenance_s: float = 0.0  # last timed op (refresh OR maintain) wall time
    refresh_s: float = 0.0  # last svc_refresh wall time (cost-model seed)
    ivm_s: float = 0.0  # last full-maintenance wall time (cost-model seed)
    # per-base lifetime delta-row counts at the last maintain / svc_refresh
    # (drift counters: pending rows = ViewManager.ingested_rows − these)
    applied_rows: Dict[str, int] = dataclasses.field(default_factory=dict)
    cleaned_rows: Dict[str, int] = dataclasses.field(default_factory=dict)
    # bumped whenever either sample moves (planner snapshot, panel slots)
    sample_version: int = 0
    # bumped only when the STALE sample is re-derived (maintain, ratio
    # retune, pin refresh): the fleet panel's merge slots survive cleans
    stale_version: int = 0
    # planner-recommended sampling ratio (fleet scorer REC_M); applied by
    # svc_refresh only when ViewManager.adaptive_m is on
    recommended_m: Optional[float] = None
    delta_group_capacity: int = 1024  # registration-time arena bound


class ViewManager:
    # batched fleet launches that failed and fell back to per-view cleans
    # (any failure on a CPU manager; on the card only an injected
    # ``kernel_error``): a count here means the fleet path is degraded.
    # A view over the metrics registry, as in the JAX package.
    fleet_merge_failures = counter_attr()

    def __init__(self, device="cuda", clock: Optional[Callable[[], float]] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ViewManager(device={str(device)!r}): no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
        # "cuda" is the card current now: the manager's tensors stay there
        self.device = cuda_device(self.device)
        # every wall time of the manager and the planner reads THIS clock
        # (tests inject a fake); each closing read follows a device sync
        self.clock: Callable[[], float] = clock or time.perf_counter
        # the registry of the whole pipeline: the streaming and serving
        # instruments of configure_streaming land here too
        self.metrics = MetricsRegistry()
        self.base: Dict[str, Relation] = {}
        self._base_epoch = 0  # bumped whenever a base relation is replaced
        self.views: Dict[str, ManagedView] = {}
        # pending deltas as an ordered SEGMENT log (one DeltaSet per ingest
        # batch) with per-view cursors; a segment is applied to the base
        # relations once every dependent view has folded it in
        self.pending_segments: List[DeltaSet] = []
        self._merged_cache: Dict[Tuple[int, int], DeltaSet] = {}
        self.ingested_rows: Dict[str, int] = {}  # lifetime delta rows per base
        self._base_applied_rows: Dict[str, int] = {}  # rows folded into base
        self.stream = None  # StreamingViewService once configure_streaming ran
        self.cost_model = None  # planner.CostModel once attached
        self._panel = None  # FleetPanel once fleet_panel() ran
        # svc_refresh honours planner-recommended ratios only when on
        # (MaintenancePlanner(adapt_m=True) turns it on)
        self.adaptive_m = False
        # per-view quarantine/backoff registry of clean/maintain outcomes
        self.health = FleetHealth()
        # chaos-test injection point (robustness.faults.FaultPlan.attach);
        # None in production — the hooks below are single attribute checks
        self.fault_plan = None
        # extra attributes stamped onto every span this manager opens
        self.obs_attrs: Dict[str, object] = {}
        self._c_fleet_merge_failures = self.metrics.counter("fleet_merge_failures")

    def _inject_fault(self, point: str, name: Optional[str]) -> float:
        """Fire the chaos hook at a designed failure point; returns injected
        latency seconds (0.0 in production — one None check)."""
        if self.fault_plan is None:
            return 0.0
        return self.fault_plan.fire(point, name)

    def _sync(self) -> None:
        """Wait for the device, so wall times cover the work, not the enqueue."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _elapsed(self, t0: float) -> float:
        """Clock seconds since ``t0``, read after the device finished."""
        self._sync()
        return self.clock() - t0

    @property
    def pending(self) -> DeltaSet:
        """All not-yet-base-applied deltas merged per base (read-only view)."""
        return self._pending_from(0)

    # -- streaming -----------------------------------------------------------
    def configure_streaming(self, config=None, clock=None):
        """Route ``ingest`` through the streaming engine: micro-batches are
        buffered in bounded DeltaLogs and the samples refresh on size/age
        watermarks instead of manual calls (``repro_torch.streaming``).
        ``clock`` is injectable for deterministic age and throttle tests."""
        from repro_torch.streaming import StreamConfig, StreamingViewService

        self.stream = StreamingViewService(self, config or StreamConfig(),
                                           clock=clock or time.monotonic)
        return self.stream

    # -- registration --------------------------------------------------------
    def register_base(self, name: str, rel: Relation) -> None:
        self.base[name] = rel.to(self.device)
        self._base_epoch += 1

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
            # drift counters start at the base-applied watermark: rows
            # already folded into the base are part of ``materialized``
            applied_rows={b: self._base_applied_rows.get(b, 0) for b in delta_bases},
            cleaned_rows={b: self._base_applied_rows.get(b, 0) for b in delta_bases},
            delta_group_capacity=delta_group_capacity,
        )
        self.views[view.name] = mv
        return mv

    # -- the fleet panel ------------------------------------------------------
    def fleet_panel(self):
        """The stacked (V, R) clean/stale sample panel of the whole fleet
        (``repro_torch.views.panel.FleetPanel``), created lazily; slots are
        invalidated per view as samples move."""
        if self._panel is None:
            from repro_torch.views.panel import FleetPanel

            self._panel = FleetPanel(self)
        return self._panel

    def _bump_sample_version(self, mv: ManagedView) -> None:
        mv.sample_version += 1
        if self._panel is not None:
            self._panel.invalidate(mv.view.name)

    def register_outlier_index(self, view_name: str, base: str, attr: str, k: int) -> None:
        """§6: index top-k of base[attr]; push keys up into the view pin set."""
        mv = self.views[view_name]
        mv.outlier_index = build_outlier_index(self.base[base], base, attr, k)
        self._refresh_pin(mv)

    def _build_pin(self, mv: ManagedView) -> None:
        """Push the index up to the view's keys and build their digest table."""
        keys = propagate_outlier_keys(mv.view.plan, self.base, mv.outlier_index)
        pin_cols = {c: keys[i] for i, c in enumerate(mv.view.pk)}
        mv.outlier_pin = pin_set(
            from_columns(pin_cols, pk=mv.view.pk, valid=keys[0] != int(SENTINEL_KEY)))
        mv.pin_source = (mv.outlier_index, self._base_epoch)

    def _pin_is_current(self, mv: ManagedView) -> bool:
        """The pin still derives from the view's index and the bases as they are."""
        src = mv.pin_source
        return (mv.outlier_pin is not None and src is not None and src[0] is mv.outlier_index
                and src[1] == self._base_epoch)

    def _refresh_pin(self, mv: ManagedView) -> None:
        if mv.outlier_index is None:
            return
        self._build_pin(mv)
        # re-derive both samples with the pin so strata stay consistent
        mv.stale_sample = compact(
            hashing.apply_hash(mv.materialized, mv.view.pk, mv.m, mv.seed, pin=mv.outlier_pin),
            mv.sample_capacity,
        )
        mv.clean_sample = mv.stale_sample
        mv.corr_cache = None
        mv.stale_version += 1
        self._bump_sample_version(mv)

    # -- delta ingestion -----------------------------------------------------
    def ingest(self, base: str, inserts: Optional[Relation] = None,
               deletes: Optional[Relation] = None, seq: Optional[int] = None, key=None):
        """Ingest a delta batch.  With streaming configured, the batch lands
        in the DeltaLog (``seq`` orders out-of-order producers, ``key`` is an
        optional idempotency key for at-least-once replays) and the samples
        refresh on watermarks; returns whether this offer refreshed.
        Otherwise it goes straight into the pending segment log and the
        caller refreshes (``svc_refresh``) or maintains (``maintain``)."""
        if self.stream is not None:
            return self.stream.offer(base, inserts=inserts, deletes=deletes, seq=seq, key=key)
        return self._ingest_pending(base, inserts=inserts, deletes=deletes)

    def _ingest_pending(self, base: str, inserts: Optional[Relation] = None,
                        deletes: Optional[Relation] = None) -> None:
        seg = DeltaSet()
        n_rows = 0
        if inserts is not None:
            inserts = inserts.to(self.device)
            seg.inserts[base] = inserts
            n_rows += int(inserts.valid.sum())
        if deletes is not None:
            seg.deletes[base] = deletes.to(self.device)
            n_rows += int(seg.deletes[base].valid.sum())
        if not seg.is_empty():
            self.pending_segments.append(seg)
            self._merged_cache.clear()
            self.ingested_rows[base] = self.ingested_rows.get(base, 0) + n_rows
            obs_trace.event("ingest", base=base, rows=n_rows)
        for mv in self.views.values():
            if (mv.outlier_index is not None and mv.outlier_index.base == base
                    and inserts is not None):
                mv.outlier_offers.append(inserts)
        if self.cost_model is not None and n_rows:
            self.cost_model.observe_ingest(base, n_rows)

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

    def drift_rows(self, view_name: str, since: str = "ivm") -> int:
        """Delta rows a view has not yet absorbed: ``since="ivm"`` not folded
        by full maintenance, ``since="clean"`` not yet in the clean sample.
        Counter reads only — the planner's drift signal costs no scan."""
        mv = self.views[view_name]
        snap = mv.applied_rows if since == "ivm" else mv.cleaned_rows
        return sum(max(self.ingested_rows.get(b, 0) - snap.get(b, 0), 0)
                   for b in mv.delta_bases)

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
    def svc_refresh(self, view_name: str, fused: bool = True, _precomputed=None,
                    _extra_s: float = 0.0, _retuned: bool = False) -> float:
        """Clean the view's sample from the pending deltas (Problem 1).

        ``fused`` routes the delta aggregation through kernels/fused_clean
        (the plan executor takes over when the plan shape does not qualify).
        With ``adaptive_m`` on, a planner-recommended ratio is applied first.
        ``_precomputed``/``_extra_s``/``_retuned`` are ``svc_refresh_many``'s
        internals: delta aggregations it already batched, this view's share
        of the batched wall time, and whether it already retuned the ratio.

        The clean is TRANSACTIONAL: any failure restores the view's
        pre-clean state, records the failure in ``health`` and re-raises.
        Returns the wall seconds."""
        mv = self.views[view_name]
        snap = _view_snapshot(mv)
        with obs_trace.span("clean", view=view_name, **self.obs_attrs) as sp:
            try:
                dt = self._svc_refresh_inner(mv, view_name, fused, _precomputed, _extra_s,
                                             _retuned)
            except BaseException as e:
                self._roll_back(mv, snap, e)
                raise
            self.health.record_success(view_name)
            sp.set(wall_s=dt, sample_version=mv.sample_version)
        return dt

    def _roll_back(self, mv: ManagedView, snap: dict, error: BaseException) -> None:
        _restore_view(mv, snap)
        if self._panel is not None:
            self._panel.invalidate(mv.view.name)
        if isinstance(error, Exception):
            self.health.record_failure(mv.view.name, error)

    def _svc_refresh_inner(self, mv: ManagedView, view_name: str, fused: bool, precomputed,
                           extra_s: float, retuned: bool) -> float:
        lat_s = self._inject_fault("refresh", view_name)
        t0 = self.clock()  # a retune below is part of the clean's cost
        if self._wants_retune(mv):
            self._retune_sample_ratio(mv, mv.recommended_m)
            retuned = True
        if mv.outlier_index is not None:
            self._flush_outlier_offers(mv)
            if not self._pin_is_current(mv):
                self._build_pin(mv)
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
            precomputed=precomputed,
        )
        mv.clean_sample = flag_outliers(cleaned, mv.outlier_pin)
        mv.stale_sample = flag_outliers(mv.stale_sample, mv.outlier_pin)
        mv.corr_cache = None  # samples moved: new correspondence window
        dt = self._elapsed(t0) + float(extra_s) + lat_s
        self._after_clean(mv, view_name, dt, retuned)
        return dt

    def _after_clean(self, mv: ManagedView, view_name: str, dt: float, retuned: bool) -> None:
        """The bookkeeping tail of every clean, per view or batched."""
        mv.maintenance_s = dt
        mv.refresh_s = dt
        self._bump_sample_version(mv)
        for b in mv.delta_bases:  # the clean sample now reflects all deltas
            mv.cleaned_rows[b] = self.ingested_rows.get(b, 0)
        if self.cost_model is not None:
            if retuned:
                self.cost_model.observe_retune(view_name, dt)
            else:
                self.cost_model.observe_refresh(view_name, dt)

    def _retune_sample_ratio(self, mv: ManagedView, new_m: float) -> None:
        """Planner-driven m adaptation: re-derive the sample pair from the
        materialized view at the new ratio (Ŝ = η(S) stays true, so stepping
        m up recovers rows the old sample dropped); the following clean folds
        every pending delta.  The sample arena scales from its current size,
        never below the registration-time formula, and the m-scaled group
        capacities are re-bucketed."""
        new_m = float(new_m)
        old_m = mv.m
        mv.m = new_m
        mv.sample_capacity = next_pow2(max(
            64,
            int(mv.sample_capacity * (new_m / old_m)),
            int(mv.materialized.capacity * new_m * 4),
        ))
        mv.sampled_strategy = _replace_groupby_capacity(
            mv.strategy, next_pow2(max(64, int(mv.delta_group_capacity * new_m * 4))))
        mv.stale_sample = compact(
            hashing.apply_hash(mv.materialized, mv.view.pk, new_m, mv.seed, pin=mv.outlier_pin),
            mv.sample_capacity,
        )
        mv.clean_sample = mv.stale_sample
        mv.corr_cache = None
        mv.recommended_m = None
        mv.stale_version += 1
        self._bump_sample_version(mv)

    def _wants_retune(self, mv: ManagedView) -> bool:
        return (self.adaptive_m and mv.recommended_m is not None
                and abs(mv.recommended_m - mv.m) > 1e-9)

    def _merge_job(self, name: str, mv: ManagedView, panel) -> Optional[_MergeJob]:
        """The view's inputs to the batched clean, or None when its cleaning
        plan does not reduce to the canonical fused specs: a pin-free single
        int group key with exactly [ins] (or [ins, del] for with_deletes)."""
        if len(mv.view.pk) != 1:
            return None
        plan = cleaning_plan(mv.sampled_strategy, mv.view.pk, mv.m, mv.seed)
        env = delta_env(mv.view.name, mv.stale_sample, self._deltas_for(mv))
        env.update(self.base)
        specs = collect_fused_specs(plan, env)
        # the merge remainder is bypassed wholesale, so EVERY delta layer of
        # the strategy must have fused (collect order = OuterJoin nesting)
        has_del = any(leaf.name.endswith(DEL) for leaf in plan_leaves(mv.strategy))
        if len(specs) != (2 if has_del else 1):
            return None
        if any(s.dim_name is not None or s.pin_name is not None or s.key != mv.view.pk[0]
               for s in specs):
            return None
        if not specs[0].fact_name.endswith(INS):
            return None
        if has_del and not specs[1].fact_name.endswith(DEL):
            return None
        agg_cols = tuple(o for o, _fn, _v in specs[0].node.aggs)
        skeys, svalid, svals = panel.merge_slot(name, mv.view.pk[0], agg_cols)
        return _MergeJob(
            name=name,
            key=mv.view.pk[0],
            agg_cols=agg_cols,
            col_dtypes={c: mv.stale_sample.col(c).dtype for c in mv.stale_sample.schema.columns},
            stale_keys=skeys,
            stale_valid=svalid,
            stale_vals=svals,
            ins=(env[specs[0].fact_name], specs[0]),
            dele=(env[specs[1].fact_name], specs[1]) if has_del else None,
            out_capacity=mv.sample_capacity,
        )

    def svc_refresh_many(self, names: Sequence[str], fused: bool = True,
                         isolate: bool = True) -> Dict[str, float]:
        """Refresh several views' samples through two fleet launches.

        The η-filtered delta group-bys of every qualifying view run in ONE
        kernels/fused_clean fleet launch (per-view seeds and ratios), and
        their merge remainders — upserting the dense deltas into the
        panel-backed stale samples with delete-cancellation — in ONE
        kernels/fleet_merge launch per (Rp, aggregate count) shape.  Views
        that do not qualify (outlier pins, composite keys, non-canonical
        plans, unbounded key domains, ``fused=False``) clean per view,
        reusing any side that did aggregate on the batched path.  Returns
        per-view wall seconds (each member carries its share of the batched
        launches).

        With ``isolate`` (the default) a failed per-view clean is quarantined
        in ``health`` and reported as 0.0 seconds while the other views
        commit.  A failure of the batched launch itself falls the whole
        epoch back to per-view cleans, counted in ``fleet_merge_failures``:
        on a CPU manager any failure, on the card only a ``FaultInjected``
        fired at the ``kernel`` point (a designed failure point, and the
        per-view cleans it falls back to launch the card's kernels too).
        Any other failure on the card propagates, because a kernel that
        fails to build or launch must never hand its work to plain
        PyTorch.  ``isolate=False`` propagates every failure."""
        names = list(names)
        out: Dict[str, float] = {}
        jobs: List[_MergeJob] = []
        retune_s: Dict[str, float] = {}
        retuned: set = set()
        if fused and len(names) > 1:
            panel = self.fleet_panel()
            for name in names:
                mv = self.views[name]
                if mv.outlier_index is not None or mv.outlier_pin is not None:
                    continue
                if self._wants_retune(mv):
                    tr = self.clock()  # charge the retune to this view
                    self._retune_sample_ratio(mv, mv.recommended_m)
                    retune_s[name] = self._elapsed(tr)
                    retuned.add(name)
                job = self._merge_job(name, mv, panel)
                if job is not None:
                    jobs.append(job)
        merged, precomputed = {}, {}
        with obs_trace.span("merge", jobs=len(jobs), **self.obs_attrs) as sp:
            t0 = self.clock()
            if jobs:
                try:
                    self._inject_fault("kernel", None)
                    merged, precomputed = fleet_clean_merge(jobs)
                    self._sync()
                except Exception as e:
                    if not isolate or (self.device.type != "cpu"
                                       and not isinstance(e, FaultInjected)):
                        raise
                    # the batched launch failed as a unit: every view cleans
                    # on its own (panel slots were only read: nothing to
                    # restore)
                    self.fleet_merge_failures += 1
                    merged, precomputed = {}, {}
            share = (self.clock() - t0) / len(merged) if merged else 0.0
            sp.set(merged=len(merged), fell_back=len(names) - len(merged))
        for name in names:
            try:
                if name in merged:
                    out[name] = self._finish_batched_refresh(
                        name, merged[name], share + retune_s.get(name, 0.0), name in retuned)
                else:
                    out[name] = self.svc_refresh(
                        name, fused=fused, _precomputed=precomputed.get(name),
                        _extra_s=retune_s.get(name, 0.0), _retuned=name in retuned)
            except Exception:
                if not isolate:
                    raise
                # quarantined by the per-view guard; the view keeps serving
                # its last good sample and the epoch commits
                out[name] = 0.0
        return out

    def _finish_batched_refresh(self, view_name: str, rel: Relation, dt: float,
                                retuned: bool) -> float:
        """Install one fleet-merged clean sample: the bookkeeping tail of
        ``svc_refresh`` without the plan execution.  Guarded the same way."""
        mv = self.views[view_name]
        snap = _view_snapshot(mv)
        with obs_trace.span("clean", view=view_name, batched=True, **self.obs_attrs) as sp:
            try:
                dt = dt + self._inject_fault("refresh", view_name)
                mv.clean_sample = flag_outliers(rel, mv.outlier_pin)
                mv.stale_sample = flag_outliers(mv.stale_sample, mv.outlier_pin)
                mv.corr_cache = None  # samples moved: new correspondence window
                self._after_clean(mv, view_name, dt, retuned)
            except BaseException as e:
                self._roll_back(mv, snap, e)
                raise
            self.health.record_success(view_name)
            sp.set(wall_s=dt, sample_version=mv.sample_version)
        return dt

    # -- full IVM (the expensive path; runs at maintenance periods) ----------
    def maintain(self, view_name: str) -> float:
        """Full IVM for ONE view: fold the pending segments beyond its cursor
        into the materialized view, advance the cursor, and apply segments
        every dependent view has absorbed to the base relations.
        Transactional like ``svc_refresh``; returns the IVM wall seconds."""
        mv = self.views[view_name]
        snap = _view_snapshot(mv)
        with obs_trace.span("maintain", view=view_name, **self.obs_attrs) as sp:
            try:
                dt = self._maintain_inner(mv, view_name)
            except BaseException as e:
                self._roll_back(mv, snap, e)
                raise
            self.health.record_success(view_name)
            sp.set(wall_s=dt, sample_version=mv.sample_version)
        return dt

    def _maintain_inner(self, mv: ManagedView, view_name: str) -> float:
        lat_s = self._inject_fault("maintain", view_name)
        self._flush_outlier_offers(mv)
        t0 = self.clock()
        hi = len(self.pending_segments)
        mv.materialized = full_maintenance(
            mv.strategy,
            mv.view.name,
            mv.materialized,
            self._deltas_for(mv),
            extra_env=self.base,
            out_capacity=mv.materialized.capacity,
        )
        dt = self._elapsed(t0) + lat_s
        mv.stale_sample = compact(
            hashing.apply_hash(mv.materialized, mv.view.pk, mv.m, mv.seed, pin=mv.outlier_pin),
            mv.sample_capacity,
        )
        mv.clean_sample = mv.stale_sample
        mv.corr_cache = None
        mv.maintenance_s = dt
        mv.ivm_s = dt
        mv.stale_version += 1
        self._bump_sample_version(mv)
        mv.applied_seg = hi
        for b in mv.delta_bases:
            mv.applied_rows[b] = self.ingested_rows.get(b, 0)
            mv.cleaned_rows[b] = self.ingested_rows.get(b, 0)
        self._advance_pending_floor()
        if self.cost_model is not None:
            self.cost_model.observe_maintain(view_name, dt)
        return dt

    def maintain_all(self) -> float:
        if self.stream is not None:  # fold still-buffered micro-batches in
            for base, log in self.stream.logs.items():
                ins, dels = log.drain()
                if ins is not None or dels is not None:
                    self._ingest_pending(base, inserts=ins, deletes=dels)
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
            self._base_epoch += 1
            self._base_applied_rows[b] = self._base_applied_rows.get(b, 0) + int(rel.valid.sum())
        for b, rel in seg.deletes.items():
            self.base[b] = delete_keys(self.base[b], rel)
            self._base_epoch += 1
            self._base_applied_rows[b] = self._base_applied_rows.get(b, 0) + int(rel.valid.sum())

    # -- query API ------------------------------------------------------------
    def query(
        self,
        view_name: str,
        q: Query,
        confidence: float = 0.95,
        prefer: Optional[str] = None,  # "corr" | "aqp" | None (auto, §5.2.2)
        rng: Optional[torch.Generator] = None,
        record_traffic: bool = True,
    ) -> Estimate:
        """Estimate one query — a batch of one through the batched engine.

        Sample-mean queries (sum/count/avg with encodable predicates) take
        the batched engine; median/percentile (bootstrap, drawing from
        ``rng``), min/max (Cantelli) and other predicates take the
        per-query estimators."""
        return self.query_batch(view_name, [q], confidence=confidence, prefer=prefer, rng=rng,
                                record_traffic=record_traffic)[0]

    def query_batch(
        self,
        view_name: str,
        queries: Sequence[Query],
        confidence: float = 0.95,
        prefer: Optional[str] = None,
        rng: Optional[torch.Generator] = None,
        record_traffic: bool = True,
    ) -> List[Estimate]:
        """Answer N queries in one fused pass (multi-query optimization).

        Encodable sample-mean queries share one correspondence-cache lookup,
        one kernels/multi_agg moment scan and (only if some query resolves
        to SVC+CORR) one batched exact scan of the materialized view.  The
        others go through ``_query_fallback``; result order matches
        ``queries``.  ``rng`` (a ``torch.Generator`` on the manager's
        device) draws the bootstrap's uniforms, seeded with 0 when omitted.
        ``record_traffic=False`` answers without feeding the planner's
        traffic counter (evaluation probes are not demand)."""
        if self.cost_model is not None and record_traffic:
            self.cost_model.observe_traffic(view_name, len(queries))
        mv = self.views[view_name]
        with obs_trace.span("estimate", view=view_name, n=len(queries),
                            sample_version=mv.sample_version, **self.obs_attrs):
            results: List[Optional[Estimate]] = [None] * len(queries)
            cols = sample_columns(mv.clean_sample)
            batched = [i for i, q in enumerate(queries) if is_encodable(q, cols)]
            fast = set(batched)
            for i, q in enumerate(queries):
                if i not in fast:
                    results[i] = self._query_fallback(mv, q, confidence, prefer, rng)
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
        rng: Optional[torch.Generator],
    ) -> Estimate:
        """Per-query estimators for queries outside the engine's class.
        Only the correction-side estimators scan the materialized view for
        q(S)."""
        if q.agg in ("sum", "count", "avg"):
            if prefer is None:
                cmp = variance_comparison(mv.clean_sample, mv.stale_sample, q, mv.m)
                prefer = "corr" if bool(cmp["corr_wins"]) else "aqp"
            if prefer == "corr":
                return svc_corr(exact(mv.materialized, q), mv.clean_sample, mv.stale_sample, q,
                                mv.m, confidence)
            return svc_aqp(mv.clean_sample, q, mv.m, confidence)
        if q.agg in ("median", "percentile"):  # rng None: the bootstrap seeds 0
            if prefer == "aqp":
                return bootstrap_aqp(mv.clean_sample, q, rng, confidence=confidence)
            return bootstrap_corr(exact(mv.materialized, q), mv.clean_sample, mv.stale_sample,
                                  q, rng, confidence=confidence)
        if q.agg in ("min", "max"):
            mm = svc_minmax(exact(mv.materialized, q), mv.clean_sample, mv.stale_sample, q, mv.m)
            return Estimate(mm.value, mm.exceed_prob, mm.value, mm.value, mm.method, confidence)
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
    fields — and the mutable containers — is a full transactional
    checkpoint."""
    snap = {f.name: getattr(mv, f.name) for f in dataclasses.fields(mv)}
    snap["outlier_offers"] = list(mv.outlier_offers)
    snap["applied_rows"] = dict(mv.applied_rows)
    snap["cleaned_rows"] = dict(mv.cleaned_rows)
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
