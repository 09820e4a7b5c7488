"""Streaming refresh engine: DeltaLog → watermark → fleet clean.

``StreamingViewService`` is the continuous-traffic face of the §3.2
workflow.  Producers ``offer`` micro-batches (possibly out of order); the
service buffers them in per-base DeltaLogs and refreshes whenever a size
or age watermark trips: the drained windows enter the manager's pending
segments and the affected views clean through ``svc_refresh_many`` (or a
``MaintenancePlanner`` epoch, once attached).  Queries are answered from
the freshest clean sample and carry staleness metadata.

Correctness under reordering is free: a clean recomputes Ŝ' from the
stale sample plus the FULL pending delta set (§4.5), so a late
micro-batch that misses one window folds into the next.

Failure axis: the drain is transactional per base (a window whose apply
fails is requeued into its DeltaLog), a per-view clean failure
quarantines only that view (it serves stale with a widened CI), ring
overflow takes a non-blocking shed policy, and micro-batches with
non-finite floats are rejected at offer time.  Overload axis: admission
control (``serving.admission``) and the staleness-keyed result cache
(``serving.result_cache``) sit in front of the estimators.  Every offered
relation moves to the manager's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Hashable, List, Optional, Sequence

from repro_torch.core.estimators import Estimate, Query
from repro_torch.obs import trace
from repro_torch.obs.registry import counter_attr
from repro_torch.robustness.degrade import widen_estimate
from repro_torch.serving.admission import ADMIT, SHED, AdmissionController
from repro_torch.serving.result_cache import ResultCache, query_key
from repro_torch.streaming.delta_log import Backpressure, CorruptBatch, DeltaLog

# ring-overflow shed policies (StreamConfig.shed_policy)
SHED_POLICIES = ("spill", "drop_oldest")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Watermark and buffering knobs for the streaming refresh loop."""

    max_rows: int = 4096  # size watermark: refresh once this many rows pend
    max_age_s: float = 0.5  # age watermark: refresh once a batch is this old
    max_batches: int = 64  # DeltaLog ring bound (shed policy beyond it)
    auto_refresh: bool = True  # refresh inline when a watermark trips
    # ring-overflow policy — producers stay non-blocking:
    #   "spill"       coalesce the ring in place (lossless; frees slots)
    #   "drop_oldest" shed the oldest micro-batch with accounting
    shed_policy: str = "spill"
    # -- serving plane (overload axis) ---------------------------------------
    # admission control: None serves every query at full cost; an
    # AdmissionConfig (repro_torch.serving.admission) throttles
    # over-budget tenants and sheds under fleet overload — both degrade to
    # serve-stale-with-wider-CI instead of queueing or raising
    admission: Optional[object] = None
    # staleness-keyed result cache (repro_torch.serving.result_cache): entries
    # keyed on (view, sample_version, predicate digest) so svc_refresh /
    # maintain version bumps invalidate for free; 0 disables
    cache_capacity: int = 256
    # under SHED, a stale-version cache entry may answer (widened CI,
    # "+shed" method) instead of recomputing; False forces a fresh scan
    cache_serve_stale: bool = True


@dataclasses.dataclass
class BaseStaleness:
    """Per-base-relation view of the buffered (pre-drain) delta log."""

    pending_rows: int
    pending_batches: int
    oldest_pending_s: float
    shed_rows: int = 0  # rows dropped by the drop-oldest shed policy
    corrupt_batches: int = 0  # offers rejected by finite-validation
    spills: int = 0  # lossless in-place ring coalesces
    deduped_batches: int = 0  # at-least-once replays absorbed by key
    deduped_rows: int = 0


@dataclasses.dataclass
class StalenessInfo:
    """What the latest refreshed sample does NOT yet reflect."""

    pending_rows: int
    pending_batches: int
    oldest_pending_s: float
    refresh_age_s: float  # seconds since the last svc_refresh (-1: never)
    refreshed_through_seq: Dict[str, int]  # per base: highest seq cleaned in
    watermark_due: bool
    # per-base breakdown of the global counters above, so planner decisions
    # (which base's traffic is backing up) are observable from telemetry
    per_base: Dict[str, BaseStaleness] = dataclasses.field(default_factory=dict)
    # -- failure axis --------------------------------------------------------
    degraded: bool = False  # any view quarantined, or the last refresh failed
    degraded_views: Dict[str, str] = dataclasses.field(default_factory=dict)
    refresh_error: Optional[str] = None  # last failed auto-refresh (cleared
    # by the next successful refresh)
    shed_rows: int = 0  # fleet-wide rows shed by overload policies
    corrupt_batches: int = 0  # fleet-wide rejected offers
    # -- overload axis (admission + cache + ingest leveling) -----------------
    # WHY an answer was widened is observable here: admission verdicts,
    # cache traffic, and at-least-once dedupe accounting, fleet-wide
    spills: int = 0
    deduped_batches: int = 0
    deduped_rows: int = 0
    throttled_queries: int = 0  # tenant-budget verdicts ("+throttled")
    shed_queries: int = 0  # fleet-overload verdicts ("+shed")
    admitted_queries: int = 0
    overloaded: bool = False  # admission controller's live overload state
    cache_hits: int = 0  # exact-version result-cache hits (bit-equal serves)
    cache_stale_hits: int = 0  # stale-version entries served under SHED
    cache_poison_rejected: int = 0  # version-mismatched entries refused


@dataclasses.dataclass
class StreamedEstimate:
    """An Estimate plus the staleness metadata it was answered under."""

    estimate: Estimate
    staleness: StalenessInfo

    @property
    def value(self):
        return self.estimate.value

    def __iter__(self):  # (value, lo, hi) convenience, like Estimate
        return iter(self.estimate)


class StreamingViewService:
    """Wraps a ViewManager with log-buffered ingest + watermark refresh."""

    # bit-compatible counter views over the ViewManager's metrics registry
    # (the one snapshot every serving/streaming instrument lands in)
    refresh_count = counter_attr()
    queries_issued = counter_attr()  # lifetime queries through query_batch

    def __init__(self, vm, config: Optional[StreamConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.vm = vm
        self.config = config or StreamConfig()
        if self.config.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy must be one of {SHED_POLICIES}, "
                f"got {self.config.shed_policy!r}"
            )
        self._clock = clock
        self.logs: Dict[str, DeltaLog] = {}
        self._last_refresh: Optional[float] = None
        self._c_refresh_count = vm.metrics.counter("stream_refreshes")
        self._c_queries_issued = vm.metrics.counter("stream_queries")
        self.planner = None  # MaintenancePlanner once attach_planner ran
        self._refresh_error: Optional[str] = None  # last degraded refresh
        # -- serving plane (overload axis) -----------------------------------
        self.admission = None
        if self.config.admission is not None:
            self.admission = AdmissionController(self.config.admission, clock,
                                                 registry=vm.metrics)
        self.result_cache = None
        if self.config.cache_capacity > 0:
            self.result_cache = ResultCache(self.config.cache_capacity,
                                            registry=vm.metrics)

    def attach_planner(self, planner):
        """Route watermark refreshes through the budgeted control plane:
        each drain becomes a ``planner.step()`` epoch (clean/maintain/
        serve-stale per view under the budget) instead of clean-everything."""
        self.planner = planner
        return planner

    def _log(self, base: str) -> DeltaLog:
        if base not in self.logs:
            self.logs[base] = DeltaLog(
                base, max_batches=self.config.max_batches, clock=self._clock,
                registry=self.vm.metrics,
            )
        return self.logs[base]

    # -- producer side -------------------------------------------------------
    def offer(self, base: str, inserts=None, deletes=None,
              seq: Optional[int] = None,
              key: Optional[Hashable] = None) -> bool:
        """Buffer a micro-batch; returns True if this offer triggered a
        refresh (a watermark trip, or a full ring that spilling cannot
        free).

        Producers stay non-blocking: a full ring is handled by the
        configured shed policy (spill-and-coalesce or drop-oldest) instead
        of an inline refresh; a micro-batch with non-finite float values is
        rejected with accounting (``CorruptBatch`` counters on the log,
        surfaced in staleness metadata) so one bit-flipped transmission
        cannot poison the coalesced window.  A batch that cannot fit the
        ring even after shedding (``max_batches`` too small for one batch)
        is rejected with a clear ``ValueError`` instead of an uncaught
        ``Backpressure``.

        ``key`` is an optional producer idempotency key: a replay of an
        already-accepted key is absorbed with accounting (at-least-once
        retries stay safe under spikes; the drain is bit-equal to a
        once-delivered stream).  An attached ``FaultPlan`` may expand the
        offer into duplicate or NaN-corrupt copies under the same ``seq``
        and ``key`` (``mutate_offer``).
        """
        dev = self.vm.device
        inserts = None if inserts is None else inserts.to(dev)
        deletes = None if deletes is None else deletes.to(dev)
        fault_plan = getattr(self.vm, "fault_plan", None)
        if fault_plan is None:
            return self._offer_one(base, inserts, deletes, seq, key)
        triggered = False
        for ins, dels, s, k in fault_plan.mutate_offer(base, inserts, deletes, seq, key):
            triggered |= self._offer_one(base, ins, dels, s, k)
        return triggered

    def _offer_one(self, base: str, inserts, deletes, seq, key=None) -> bool:
        log = self._log(base)
        try:
            refreshed = self._offer_bounded(log, inserts, deletes, seq, key)
        except CorruptBatch:
            # rejected with accounting (log.corrupt_batches/corrupt_rows);
            # the producer's retry of the uncorrupted batch carries the data
            return False
        if not refreshed and self.config.auto_refresh and self.watermark_due():
            self.refresh()
            return True
        return refreshed

    def _offer_bounded(self, log: DeltaLog, inserts, deletes, seq,
                       key=None) -> bool:
        """Offer under the ring bound, applying the shed policy on overflow;
        returns True iff the overflow ran an inline refresh."""
        try:
            log.offer(inserts=inserts, deletes=deletes, seq=seq, key=key)
            return False
        except Backpressure:
            pass
        refreshed = False
        if self.config.shed_policy == "drop_oldest":
            log.shed_oldest()
        else:  # spill: lossless in-place coalesce; if the ring is already
            # one coalesced batch at bound (max_batches == 1), fall back to
            # a draining refresh rather than dropping rows
            if log.spill() == 0:
                self.refresh()
                refreshed = True
        try:
            log.offer(inserts=inserts, deletes=deletes, seq=seq, key=key)
        except Backpressure as e:
            raise ValueError(
                f"micro-batch cannot fit DeltaLog[{log.base}] "
                f"(max_batches={log.max_batches}): a single batch must fit "
                f"an empty ring — raise StreamConfig.max_batches"
            ) from e
        return refreshed

    # -- watermarks ----------------------------------------------------------
    def watermark_due(self) -> bool:
        now = self._clock()
        for log in self.logs.values():
            if log.pending_batches() == 0:
                continue
            if log.pending_rows() >= self.config.max_rows:
                return True
            if log.oldest_age_s(now) >= self.config.max_age_s:
                return True
        return False

    # -- refresh -------------------------------------------------------------
    def refresh(self, plan=None) -> float:
        """Drain every log into the ViewManager and refresh the fleet;
        returns total refresh/maintain wall time (seconds).

        Without a planner, every affected sample is cleaned (the paper's
        clean-all workflow).  With one — passed as ``plan`` or attached via
        ``attach_planner`` — the drain becomes a control-plane epoch: the
        planner picks clean/maintain/serve-stale per view under its budget
        (repro_torch.planner.MaintenancePlanner).

        Failure semantics: the drain is transactional per base — a window
        whose ``_ingest_pending`` fails is requeued into its DeltaLog
        (bit-equal re-drain later) before the error propagates.  Per-view
        clean failures never abort the epoch: ``svc_refresh_many`` isolates
        them (the failed view quarantines into ``vm.health`` and serves
        stale; the rest commit).  Quarantined views sit out their
        exponential backoff and re-enter the drain when a retry is due.

        Outlier-index maintenance (§6.1) rides the same drain: the window's
        offers are buffered by ``_ingest_pending`` and flushed as ONE
        threshold-gated ``update_outlier_index`` merge per refresh window —
        a sub-threshold window costs O(|∂D|) and never touches the index —
        before ``svc_refresh`` re-derives the pin set for cleaning."""
        planner = plan if plan is not None else self.planner
        health = self.vm.health
        with trace.span("epoch") as ep:
            touched = set()
            for base, log in self.logs.items():
                if log.pending_batches() == 0:
                    continue
                with trace.span("drain", base=base):
                    ins, dels = log.drain()
                    if ins is None and dels is None:
                        continue
                    try:
                        self.vm._ingest_pending(base, inserts=ins, deletes=dels)
                    except Exception:
                        # drained-but-unapplied deltas are NEVER stranded:
                        # the window goes back into the ring for an
                        # idempotent re-drain
                        log.requeue(ins, dels)
                        raise
                    touched.add(base)
            total = 0.0
            if planner is not None:
                total = planner.step().actual_spend_s
            else:
                # clean-all epoch: every affected sample refreshes through
                # the fleet path, so delta aggregations sharing a plan shape
                # run as ONE batched fused dispatch instead of V sequential
                # calls.  Quarantined views inside their backoff window sit
                # out; ones whose retry is due re-enter even if this window
                # left their bases untouched (drift is from earlier windows).
                health.begin_epoch()
                affected = [
                    name for name, mv in self.vm.views.items()
                    if not health.blocked(name)
                    and (touched & set(mv.delta_bases)
                         or (health.retry_due(name)
                             and self.vm.drift_rows(name, since="clean") > 0))
                ]
                if affected:
                    total = sum(self.vm.svc_refresh_many(affected).values())
            fault_plan = getattr(self.vm, "fault_plan", None)
            if fault_plan is not None:
                # slow_drain chaos: report extra wall seconds without
                # sleeping — the admission controller's overload EWMA sees
                # an expensive drain, deterministically
                total += fault_plan.drain_latency_s()
            if self.admission is not None:
                self.admission.note_drain(total)
            self._last_refresh = self._clock()
            self.refresh_count += 1
            self._refresh_error = None
            ep.set(bases=len(touched), total_s=total,
                   planned=planner is not None)
        return total

    def _maybe_refresh(self) -> None:
        """Honor a due watermark before answering; a failing refresh
        degrades the answer (widened CI, degraded staleness) instead of
        raising out of ``query``/``query_batch``."""
        if not (self.config.auto_refresh and self.watermark_due()):
            return
        try:
            self.refresh()
        except Exception as e:  # noqa: BLE001 — the degrade path IS the API
            self._refresh_error = f"{type(e).__name__}: {e}"

    # -- consumer side -------------------------------------------------------
    def staleness(self) -> StalenessInfo:
        now = self._clock()
        per_base = {
            b: BaseStaleness(
                pending_rows=l.pending_rows(),
                pending_batches=l.pending_batches(),
                oldest_pending_s=l.oldest_age_s(now),
                shed_rows=l.shed_rows,
                corrupt_batches=l.corrupt_batches,
                spills=l.spills,
                deduped_batches=l.deduped_batches,
                deduped_rows=l.deduped_rows,
            )
            for b, l in self.logs.items()
        }
        adm, cache = self.admission, self.result_cache
        degraded_views = self.vm.health.degraded_views()
        return StalenessInfo(
            per_base=per_base,
            pending_rows=sum(l.pending_rows() for l in self.logs.values()),
            pending_batches=sum(l.pending_batches() for l in self.logs.values()),
            oldest_pending_s=max(
                (l.oldest_age_s(now) for l in self.logs.values()), default=0.0
            ),
            refresh_age_s=(
                -1.0 if self._last_refresh is None
                else max(0.0, now - self._last_refresh)
            ),
            refreshed_through_seq={
                b: l.drained_through_seq for b, l in self.logs.items()
            },
            watermark_due=self.watermark_due(),
            degraded=bool(degraded_views) or self._refresh_error is not None,
            degraded_views=degraded_views,
            refresh_error=self._refresh_error,
            shed_rows=sum(l.shed_rows for l in self.logs.values()),
            corrupt_batches=sum(l.corrupt_batches for l in self.logs.values()),
            spills=sum(l.spills for l in self.logs.values()),
            deduped_batches=sum(l.deduped_batches for l in self.logs.values()),
            deduped_rows=sum(l.deduped_rows for l in self.logs.values()),
            throttled_queries=adm.throttled if adm is not None else 0,
            shed_queries=adm.shed if adm is not None else 0,
            admitted_queries=adm.admitted if adm is not None else 0,
            overloaded=adm.overloaded() if adm is not None else False,
            cache_hits=cache.hits if cache is not None else 0,
            cache_stale_hits=cache.stale_hits if cache is not None else 0,
            cache_poison_rejected=(
                cache.poison_rejected if cache is not None else 0),
        )

    def _degrade_estimate(self, view_name: str, est: Estimate,
                          st: StalenessInfo) -> Estimate:
        """Widen a degraded view's answer by the pending-delta bound.

        Applies when the view itself is quarantined, or when the whole
        refresh failed (no per-view attribution): the answer's value is the
        best available estimate; its interval additionally covers every
        delta row the failed cleans never folded in."""
        if view_name not in st.degraded_views and st.refresh_error is None:
            return est
        # The bound must cover BOTH staleness stores: delta rows already
        # ingested but never cleaned into this view's sample, and rows still
        # buffered (or requeued after a failed ingest) in the delta log.
        pending = self.vm.drift_rows(view_name, since="clean")
        for b in self.vm.views[view_name].delta_bases:
            bs = st.per_base.get(b)
            if bs is not None:
                pending += bs.pending_rows
        return widen_estimate(est, self.vm.views[view_name], pending)

    def query(self, view_name: str, q: Query, tenant: str = "default",
              **kw) -> StreamedEstimate:
        """Answer from the freshest refreshed sample, with staleness attached.

        The serving decision ladder:
        admission first (an over-budget tenant or an overloaded fleet skips
        all refresh work and degrades to serve-stale-with-wider-CI, method
        tagged ``"+throttled"`` / ``"+shed"``), then the staleness-keyed
        result cache (an exact ``sample_version`` hit is bit-identical to
        the recompute it replaced), then compute.  With ``auto_refresh``,
        an ADMITTED query honors a due watermark before answering.  A
        failed refresh or a quarantined view degrades the answer (widened
        CI, ``degraded`` staleness) rather than raising — queries stay
        available under failure AND under load."""
        return self.query_batch(view_name, [q], tenant=tenant, **kw)[0]

    def query_batch(self, view_name: str, queries, tenant: str = "default",
                    **kw) -> list:
        """Answer N dashboard queries in one fused engine pass
        (``ViewManager.query_batch``) under ONE staleness snapshot and ONE
        admission verdict: the watermark is honored once up front (admitted
        batches only) and every estimate in the batch carries the same
        ``StalenessInfo`` — the whole dashboard refers to a single
        consistent refresh window (degraded or not)."""
        queries = list(queries)
        with trace.span("query", view=view_name, tenant=tenant,
                        n=len(queries)) as sp:
            self.queries_issued += len(queries)
            decision = ADMIT
            if self.admission is not None:
                with trace.span("admit", tenant=tenant):
                    decision = self.admission.decide(tenant, len(queries))
            sp.set(verdict=decision)
            if decision == ADMIT and (self.config.auto_refresh
                                      and self.watermark_due()):
                # span only when a refresh will actually run: a due
                # watermark honored inline before the batch answers
                with trace.span("refresh"):
                    self._maybe_refresh()
            ests = self._answer_batch(view_name, queries, decision, kw)
            st = self.staleness()
            return [
                StreamedEstimate(
                    estimate=self._degrade_estimate(view_name, e, st),
                    staleness=st)
                for e in ests
            ]

    # -- the cache + degrade rungs of the ladder -----------------------------
    def _answer_batch(self, view_name: str, queries: Sequence[Query],
                      decision: str, kw: dict) -> List[Estimate]:
        """Resolve a batch under an admission verdict: result-cache lookups
        (exact version always; stale version under SHED), one batched
        compute for the misses, cache fills, and — for non-admitted
        verdicts — CI widening + method tagging.  Order matches
        ``queries``; every query resolves in bounded work."""
        mv = self.vm.views[view_name]
        cache = self.result_cache
        fault_plan = getattr(self.vm, "fault_plan", None)
        if cache is not None and fault_plan is not None:
            fault_plan.poison_cache(cache, view_name)
        version = mv.sample_version

        if cache is None:
            results: List[Optional[Estimate]] = list(
                self.vm.query_batch(view_name, queries, **kw)
            )
            stale_version: Dict[int, int] = {}
        else:
            confidence = kw.get("confidence", 0.95)
            prefer = kw.get("prefer")
            record_traffic = kw.get("record_traffic", True)
            keys = [
                None if kw.get("rng") is not None
                else query_key(q, confidence, prefer)
                for q in queries
            ]
            results = [None] * len(queries)
            stale_version = {}  # index -> version a stale hit was served at
            misses: List[int] = []
            hits = 0
            with trace.span("cache", view=view_name,
                            sample_version=version) as csp:
                for i, (q, key) in enumerate(zip(queries, keys)):
                    if key is None:
                        misses.append(i)
                        continue
                    est = cache.get(view_name, version, key)
                    if est is not None:
                        results[i] = est
                        hits += 1
                        continue
                    if decision == SHED and self.config.cache_serve_stale:
                        stale = cache.get_any(view_name, key)
                        if stale is not None:
                            results[i], stale_version[i] = stale
                            hits += 1
                            continue
                    misses.append(i)
                csp.set(hits=hits, misses=len(misses))
            # cache hits are real demand: the planner's traffic counter must
            # see them even though vm.query_batch never ran for them
            if hits and record_traffic and self.vm.cost_model is not None:
                self.vm.cost_model.observe_traffic(view_name, hits)
            if misses:
                computed = self.vm.query_batch(
                    view_name, [queries[i] for i in misses], **kw
                )
                for i, est in zip(misses, computed):
                    results[i] = est
                    if keys[i] is not None:
                        cache.put(view_name, version, keys[i], est)

        if decision == ADMIT:
            return results  # type: ignore[return-value]
        return [
            self._widen_for_load(view_name, est, decision,
                                 stale=(i in stale_version))
            for i, est in enumerate(results)
        ]

    def _widen_for_load(self, view_name: str, est: Estimate, decision: str,
                        stale: bool) -> Estimate:
        """Serve-stale-under-load answer: widen by the pending-delta bound
        (buffered log rows + rows never cleaned in) and tag the method with
        the admission verdict.  A stale-VERSION cache entry additionally
        covers everything since the last full maintenance (``since="ivm"``
        dominates ``since="clean"``) — we cannot know which rows its window
        had absorbed, so the bound is the conservative superset."""
        suffix = "+shed" if decision == SHED else "+throttled"
        pending = self.vm.drift_rows(
            view_name, since="ivm" if stale else "clean"
        )
        for b in self.vm.views[view_name].delta_bases:
            log = self.logs.get(b)
            if log is not None:
                pending += log.pending_rows()
        return widen_estimate(est, self.vm.views[view_name], pending,
                              suffix=suffix)
