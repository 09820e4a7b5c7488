"""DeltaLog: bounded ring buffer of out-of-order delta micro-batches.

Producers emit micro-batches with sequence numbers that can be reordered
in flight.  The DeltaLog absorbs them into a bounded ring, tracks size and
age watermarks, and, when drained, coalesces everything back into ONE
insert and ONE delete relation in sequence order, so the cleaning plan
sees the batch semantics it was built for (later sequence numbers win per
primary key: update = delete + insert, §3.1).

The ring holds at most ``max_batches`` micro-batches; offering into a full
ring raises ``Backpressure`` (the streaming service applies its shed
policy).  Each accepted offer reads its valid-row count on the host (one
device sync per relation), and a float column with a non-finite value on
a valid row rejects the batch.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Callable, Hashable, List, Optional, Tuple

import torch

from repro_torch.obs import trace
from repro_torch.obs.registry import MetricsRegistry, counter_attr
from repro_torch.relational.relation import (
    SENTINEL_KEY,
    Relation,
    compact,
    keys_equal,
    lexsort_indices,
    masked_keys,
    next_pow2,
)

# idempotency keys remembered per base for at-least-once producers
DEDUPE_WINDOW = 4096


class Backpressure(RuntimeError):
    """The ring is full; drain (refresh) before offering more batches."""


class CorruptBatch(ValueError):
    """A micro-batch carried non-finite float values (a bit-flipped or
    truncated transmission).  Rejected at offer time — BEFORE it can win a
    newest-wins coalesce against the clean copy of the same rows."""


@dataclasses.dataclass
class MicroBatch:
    seq: int
    inserts: Optional[Relation]
    deletes: Optional[Relation]
    t_arrival: float
    n_rows: int = 0  # valid-row count, cached at offer time (one host sync)

    def rows(self) -> int:
        return self.n_rows


def _host_count(rel: Relation) -> int:
    return int(rel.valid.sum())


def _host_scan(rel: Relation) -> Tuple[int, Optional[str]]:
    """(valid rows, the first float column holding a non-finite value on a
    valid row, or None), read with one device sync."""
    floats = [c for c in rel.schema.columns if rel.col(c).is_floating_point()]
    stats = [rel.valid.sum()] + [(rel.valid & ~torch.isfinite(rel.col(c))).any()
                                 for c in floats]
    got = torch.stack([s.to(torch.int64) for s in stats]).tolist()
    return got[0], next((c for c, bad in zip(floats, got[1:]) if bad), None)


class DeltaLog:
    """Per-base-relation bounded log of out-of-order micro-batches.

    Accounting is a set of bit-compatible counter views over a
    ``repro_torch.obs`` MetricsRegistry (labeled by base relation), and every
    lifecycle step — offer, drain, shed, spill, requeue — additionally
    emits a structured trace event carrying the affected sequence numbers,
    so trace reconciliation can account for every offered batch (a shed
    used to be a local tally only: a dropped batch was visible as a count,
    not as WHICH batch)."""

    total_offered = counter_attr()  # rows, lifetime
    deduped_batches = counter_attr()  # replayed offers absorbed by their key
    deduped_rows = counter_attr()
    shed_rows = counter_attr()  # rows dropped by the drop-oldest shed policy
    shed_batches = counter_attr()
    corrupt_batches = counter_attr()  # offers rejected by finite-validation
    corrupt_rows = counter_attr()
    spills = counter_attr()  # in-place ring coalesces (spill-and-coalesce)
    requeues = counter_attr()  # drained windows given back after failed apply

    def __init__(
        self,
        base: str,
        max_batches: int = 64,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.base = base
        self.max_batches = int(max_batches)
        self._clock = clock
        self._ring: List[MicroBatch] = []
        self._auto_seq = 0
        self.high_seq = -1  # highest sequence number ever offered
        self.drained_through_seq = -1  # highest seq included in a drain
        self.metrics = registry or MetricsRegistry()

        def _c(name: str):
            return self.metrics.counter(name, base=base)

        self._c_total_offered = _c("log_offered_rows")
        # -- at-least-once idempotency (queue-based load leveling) ------------
        # producer idempotency keys of ACCEPTED offers, newest-last; a replay
        # of an accepted key is absorbed (not an error) so a spiking producer
        # can retry blindly.  The window survives drains: a retry arriving
        # after the original's window was drained still dedupes, keeping
        # re-drains bit-equal to a once-delivered stream.
        self._seen_keys: "OrderedDict[Hashable, int]" = OrderedDict()
        self._c_deduped_batches = _c("log_deduped_batches")
        self._c_deduped_rows = _c("log_deduped_rows")
        # -- failure-axis accounting (surfaced in StalenessInfo) -------------
        self._c_shed_rows = _c("log_shed_rows")
        self._c_shed_batches = _c("log_shed_batches")
        self._c_corrupt_batches = _c("log_corrupt_batches")
        self._c_corrupt_rows = _c("log_corrupt_rows")
        self._c_spills = _c("log_spills")
        self._c_requeues = _c("log_requeues")
        # (prior drained_through_seq, oldest arrival, max seq) of the last
        # drain — what requeue() needs to give the window back losslessly
        self._last_drain: Optional[Tuple[int, float, int]] = None

    # -- producer side -------------------------------------------------------
    def offer(
        self,
        inserts: Optional[Relation] = None,
        deletes: Optional[Relation] = None,
        seq: Optional[int] = None,
        key: Optional[Hashable] = None,
    ) -> Optional[MicroBatch]:
        """Append a micro-batch; ``seq`` may arrive out of order (coalescing
        restores sequence order).  Raises Backpressure when the ring is full.

        ``key`` is the producer's idempotency key: a replay of an already-
        ACCEPTED key is absorbed silently (returns None, counted in
        ``deduped_batches``/``deduped_rows``) so at-least-once producers can
        retry under spikes without double-counting rows.  Keys are recorded
        only on acceptance — a batch rejected as corrupt or bounced by
        Backpressure may retry the same key — and the seen-window survives
        drains, so a late replay of a drained window still dedupes and the
        next drain stays bit-equal to a once-delivered stream."""
        if inserts is None and deletes is None:
            raise ValueError("empty micro-batch")
        scans = [_host_scan(r) for r in (inserts, deletes) if r is not None]
        n = sum(rows for rows, _ in scans)
        if key is not None and key in self._seen_keys:
            self.deduped_batches += 1
            self.deduped_rows += n
            trace.event("offer", base=self.base, seq=self._seen_keys[key],
                        rows=n, outcome="deduped")
            return None
        bad = next((c for _, c in scans if c is not None), None)
        if bad is not None:
            self.corrupt_batches += 1
            self.corrupt_rows += n
            trace.event("offer", base=self.base, seq=seq, rows=n,
                        outcome="corrupt")
            raise CorruptBatch(
                f"DeltaLog[{self.base}] rejected micro-batch: non-finite {bad!r}"
            )
        if len(self._ring) >= self.max_batches:
            raise Backpressure(
                f"DeltaLog[{self.base}] full ({self.max_batches} batches); drain first"
            )
        if seq is None:
            seq = self._auto_seq
        self._auto_seq = max(self._auto_seq, seq) + 1
        mb = MicroBatch(int(seq), inserts, deletes, self._clock(), n_rows=n)
        self._ring.append(mb)
        self.high_seq = max(self.high_seq, mb.seq)
        self.total_offered += mb.rows()
        trace.event("offer", base=self.base, seq=mb.seq, rows=mb.rows(),
                    outcome="accepted")
        if key is not None:
            self._seen_keys[key] = mb.seq
            while len(self._seen_keys) > DEDUPE_WINDOW:
                self._seen_keys.popitem(last=False)
        return mb

    # -- watermark state -----------------------------------------------------
    def pending_batches(self) -> int:
        return len(self._ring)

    def pending_rows(self) -> int:
        return sum(mb.rows() for mb in self._ring)

    def pending_seqs(self) -> List[int]:
        """Seq numbers still in the ring (trace reconciliation's end-state
        term: accepted == drained ⊎ shed ⊎ spilled ⊎ THESE)."""
        return sorted(mb.seq for mb in self._ring)

    def oldest_age_s(self, now: Optional[float] = None) -> float:
        if not self._ring:
            return 0.0
        now = self._clock() if now is None else now
        # clamped: a backwards clock step (skew, NTP slew) must not produce
        # a negative age that poisons watermark/deadline math downstream
        return max(0.0, now - min(mb.t_arrival for mb in self._ring))

    # -- consumer side -------------------------------------------------------
    def drain(self) -> Tuple[Optional[Relation], Optional[Relation]]:
        """Coalesce and clear the ring: (inserts, deletes) in seq order.

        Insert-only windows keep the one-sort newest-wins dedup.  Windows
        with deletes run the SIGNED coalesce (_coalesce_signed): per primary
        key the insert and delete event streams are interleaved in sequence
        order so that a delete cancels an insert from EARLIER in the same
        window instead of leaving both sides to double-count — the signed
        delete+insert algebra of §3.1 becomes invariant to where watermark
        boundaries fall.
        """
        if not self._ring:
            return None, None
        batches = sorted(self._ring, key=lambda mb: mb.seq)
        self._ring = []
        self._last_drain = (
            self.drained_through_seq,
            min(mb.t_arrival for mb in batches),
            batches[-1].seq,
        )
        self.drained_through_seq = max(self.drained_through_seq, batches[-1].seq)
        trace.event("drain", base=self.base,
                    seqs=[mb.seq for mb in batches],
                    rows=sum(mb.rows() for mb in batches))
        return _coalesce_batches(batches)

    def requeue(self, inserts: Optional[Relation],
                deletes: Optional[Relation]) -> None:
        """Give the last drained window back: the apply step failed, so the
        coalesced relations re-enter the ring as ONE micro-batch under the
        window's max sequence number and original oldest arrival time, and
        ``drained_through_seq`` rolls back — the next drain re-drains them
        bit-equally (coalescing is idempotent on an already-coalesced
        window).  The ring bound is bypassed: a failed drain only returns
        rows the ring already held."""
        if inserts is None and deletes is None:
            return
        if self._last_drain is None:
            raise RuntimeError(f"DeltaLog[{self.base}]: no drain to requeue")
        prev_seq, oldest_t, max_seq = self._last_drain
        n = sum(_host_count(r) for r in (inserts, deletes) if r is not None)
        self._ring.insert(0, MicroBatch(max_seq, inserts, deletes, oldest_t,
                                        n_rows=n))
        self.drained_through_seq = prev_seq
        self._last_drain = None
        self.requeues += 1
        trace.event("requeue", base=self.base, seq=max_seq, rows=n)

    # -- overload shedding (non-blocking producers) --------------------------
    def shed_oldest(self, n: int = 1) -> int:
        """Drop the ``n`` oldest-arrival micro-batches with accounting;
        returns rows shed.  Bounded loss: every shed row is counted in
        ``shed_rows`` and surfaced through staleness metadata — dropped,
        never silently."""
        shed = 0
        shed_seqs: List[int] = []
        for _ in range(min(n, len(self._ring))):
            oldest = min(self._ring, key=lambda mb: (mb.t_arrival, mb.seq))
            self._ring.remove(oldest)
            shed += oldest.rows()
            shed_seqs.append(oldest.seq)
            self.shed_batches += 1
        self.shed_rows += shed
        if shed_seqs:
            trace.event("shed", base=self.base, seqs=shed_seqs, rows=shed)
        return shed

    def spill(self) -> int:
        """Coalesce the ring IN PLACE into one micro-batch (lossless shed):
        frees ``len(ring) - 1`` slots without dropping a row or blocking the
        producer.  The spilled batch keeps the window's max seq and oldest
        arrival, so seq ordering and the age watermark are preserved."""
        if len(self._ring) <= 1:
            return 0
        batches = sorted(self._ring, key=lambda mb: mb.seq)
        freed = len(batches) - 1
        ins, dels = _coalesce_batches(batches)
        n = sum(_host_count(r) for r in (ins, dels) if r is not None)
        self._ring = [MicroBatch(
            batches[-1].seq, ins, dels,
            min(mb.t_arrival for mb in batches), n_rows=n,
        )]
        self.spills += 1
        trace.event("spill", base=self.base,
                    absorbed=[mb.seq for mb in batches[:-1]],
                    survivor=batches[-1].seq, freed=freed)
        return freed


def _coalesce_batches(
    batches: List[MicroBatch],
) -> Tuple[Optional[Relation], Optional[Relation]]:
    """Seq-ordered batches → ONE (inserts, deletes) pair (drain/spill core)."""
    ins = [(mb.seq, mb.inserts) for mb in batches if mb.inserts is not None]
    dels = [(mb.seq, mb.deletes) for mb in batches if mb.deletes is not None]
    if not dels:
        return _coalesce([r for _, r in ins]), None
    return _coalesce_signed(ins, dels)


def _shifted(k: torch.Tensor, forward: bool) -> torch.Tensor:
    """``k`` moved one row (next row if ``forward``, else previous), the
    vacated end filled with SENTINEL_KEY."""
    pad = torch.full((1,), int(SENTINEL_KEY), dtype=k.dtype, device=k.device)
    return torch.cat([k[1:], pad]) if forward else torch.cat([pad, k[:-1]])


def _compacted(rel: Relation, keep: torch.Tensor) -> Relation:
    """The kept rows, compacted into a pow2 arena (one host sync)."""
    n = int(keep.sum())
    return compact(Relation(dict(rel.columns), keep, rel.schema), next_pow2(max(n, 1)))


def _coalesce(rels: List[Relation]) -> Optional[Relation]:
    """Merge batches oldest→newest in ONE pass: newer rows win per pk.

    All rows concatenate with a per-batch priority; one lexsort by
    (pk, priority) groups duplicates with the newest last, which a
    run-boundary mask then keeps — one sort + one compact + one host sync
    regardless of batch count."""
    if not rels:
        return None
    if len(rels) == 1:
        return rels[0]
    schema = rels[0].schema
    cols = {c: torch.cat([r.col(c) for r in rels]) for c in schema.columns}
    valid = torch.cat([r.valid for r in rels])
    prio = torch.cat([torch.full((r.capacity,), i, dtype=torch.int32, device=valid.device)
                      for i, r in enumerate(rels)])
    keys = masked_keys(Relation(cols, valid, schema))
    order = lexsort_indices(keys, prio)  # by pk, newest (highest prio) last
    sk = tuple(k[order] for k in keys)
    nxt = tuple(_shifted(k, True) for k in sk)
    keep = valid[order] & ~keys_equal(sk, nxt)  # last occurrence per pk wins
    return _compacted(Relation({c: v[order] for c, v in cols.items()}, keep, schema), keep)


def _coalesce_signed(
    ins: List[Tuple[int, Relation]], dels: List[Tuple[int, Relation]]
) -> Tuple[Optional[Relation], Optional[Relation]]:
    """Coalesce interleaved insert/delete micro-batches per primary key.

    Events per pk replay in (seq, kind) order — a delete at seq s applies
    BEFORE an insert at the same s (update = delete + insert, §3.1).  Per
    pk:

      * the surviving insert is the LAST event iff that event is an insert
        (every earlier insert was superseded or cancelled by a delete);
      * the surviving delete is the FIRST event iff that event is a delete
        (it refers to a pre-window row; a later delete cancels an in-window
        insert and must NOT be emitted, else the window double-subtracts a
        row the dropped insert never added).

    Both are run boundaries of ONE lexsort over (pk, seq, kind, arena
    position), so the result does not depend on where the drain
    (watermark) boundaries fell.
    """
    if not ins:
        # delete-only window: every delete refers to a pre-window row;
        # duplicates are retries — keep the OLDEST per pk (reversed batch
        # order turns _coalesce's newest-wins into oldest-wins)
        return None, _coalesce([r for _, r in reversed(dels)])

    def _side(batches: List[Tuple[int, Relation]]):
        schema = batches[0][1].schema
        cols = {c: torch.cat([r.col(c) for _, r in batches]) for c in schema.columns}
        valid = torch.cat([r.valid for _, r in batches])
        seq = torch.cat([torch.full((r.capacity,), s, dtype=torch.int32, device=valid.device)
                         for s, r in batches])
        return Relation(cols, valid, schema), seq

    ins_rel, ins_seq = _side(ins)
    del_rel, del_seq = _side(dels)
    n_ins = ins_rel.capacity
    dev = ins_rel.device

    keys = tuple(torch.cat([a, b]) for a, b in zip(masked_keys(ins_rel), masked_keys(del_rel)))
    seq = torch.cat([ins_seq, del_seq])
    kind = torch.cat([  # 0 = delete, 1 = insert: delete first at equal seq
        torch.ones(n_ins, dtype=torch.int32, device=dev),
        torch.zeros(del_rel.capacity, dtype=torch.int32, device=dev),
    ])
    valid = torch.cat([ins_rel.valid, del_rel.valid])
    arena = torch.arange(valid.shape[0], dtype=torch.int32, device=dev)

    order = lexsort_indices(keys, arena, kind, seq)  # least → most: arena, kind, seq, pk
    sk = tuple(k[order] for k in keys)
    first = ~keys_equal(sk, tuple(_shifted(k, False) for k in sk))
    last = ~keys_equal(sk, tuple(_shifted(k, True) for k in sk))
    emit = valid[order] & torch.where(kind[order] == 1, last, first)
    keep = torch.zeros_like(valid)
    keep[order] = emit
    return (_compacted(ins_rel, ins_rel.valid & keep[:n_ins]),
            _compacted(del_rel, del_rel.valid & keep[n_ins:]))


class PartitionedDeltaLog:
    """§7.5: one DeltaLog per data shard, drained per partition (into a
    shard's manager by ``distributed.ShardedFleet``, or flattened by
    ``core.distributed_svc.stack_shard_deltas`` for the sharded group-bys).

    Every single-log robustness contract holds PER PARTITION: offer keys
    dedupe within their partition, ``requeue`` rolls one partition's failed
    drain back bit-equally, ``shed_oldest``/``spill`` account their loss in
    that partition's own counters.  The sharded fleet drains only the
    partitions whose owning shard is alive — a lost shard's partition keeps
    queueing until the shard rejoins and its drain catches up."""

    def __init__(self, base: str, n_shards: int, max_batches: int = 64,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[MetricsRegistry] = None):
        self.base = base
        self.shards = [
            DeltaLog(f"{base}[{i}]", max_batches=max_batches, clock=clock,
                     registry=registry)
            for i in range(n_shards)
        ]

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def __getitem__(self, shard: int) -> DeltaLog:
        return self.shards[shard]

    def offer(self, shard: int, inserts: Optional[Relation] = None,
              deletes: Optional[Relation] = None, seq: Optional[int] = None,
              key: Optional[Hashable] = None):
        return self.shards[shard].offer(inserts=inserts, deletes=deletes,
                                        seq=seq, key=key)

    def pending_rows(self) -> int:
        return sum(s.pending_rows() for s in self.shards)

    def pending_batches(self) -> int:
        return sum(s.pending_batches() for s in self.shards)

    def pending_seqs(self) -> List[List[int]]:
        """Per-partition seq lists (reconciliation end-state, shard-keyed)."""
        return [s.pending_seqs() for s in self.shards]

    def drain(self) -> List[Tuple[Optional[Relation], Optional[Relation]]]:
        return [s.drain() for s in self.shards]

    def drain_shard(self, shard: int
                    ) -> Tuple[Optional[Relation], Optional[Relation]]:
        """Drain ONE partition (the fleet epoch path: live owners only)."""
        return self.shards[shard].drain()

    def requeue(self, shard: int, inserts: Optional[Relation],
                deletes: Optional[Relation]) -> None:
        """Roll one partition's failed drain back (same bit-equality
        contract as the single log: next drain_shard re-drains it)."""
        self.shards[shard].requeue(inserts, deletes)

    def shed_oldest(self, shard: int, n: int = 1) -> int:
        return self.shards[shard].shed_oldest(n)

    def spill(self, shard: int) -> int:
        return self.shards[shard].spill()
