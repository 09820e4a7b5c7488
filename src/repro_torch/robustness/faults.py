"""Deterministic fault injection for the epoch pipeline (chaos layer).

A ``FaultPlan`` is a seeded, epoch-indexed schedule of failures injected at
the pipeline's designed failure points — not monkeypatching from outside,
but explicit hooks the production code exposes precisely so its failure
behaviour is a tested surface:

  * ``refresh_error`` / ``maintain_error`` — raise ``FaultInjected`` inside
    a chosen view's clean / full maintenance (``ViewManager`` fires the
    hook at the top of ``svc_refresh`` / ``_finish_batched_refresh`` /
    ``maintain``);
  * ``kernel_error`` — raise inside the batched fleet-merge dispatch of
    ``svc_refresh_many`` (the whole epoch batch fails at once; recovery
    must isolate per view via the fallback path);
  * ``latency`` — report ``magnitude`` extra wall seconds for a view's
    action (drives the planner's deadline/overrun path without real
    sleeps, so tests stay deterministic);
  * ``nan_panel`` — poison a view's row of the planner feature panel with
    NaN (``CostModel.features`` must sanitize + quarantine, not raise);
  * ``corrupt_batch`` — re-offer a NaN-poisoned copy of a producer's
    micro-batch under the SAME sequence number (ingest validation must
    reject the copy; the original already carries the data);
  * ``duplicate_batch`` — re-offer an identical copy under the same seq
    (the coalescer's newest-wins dedup must absorb it bit-equally);
  * ``clock_skew`` — shift the harness clock by ``magnitude`` seconds
    (negative allowed; age/heartbeat math must clamp, not explode);
  * ``traffic_spike`` — multiply the epoch's offered query load by
    ``magnitude`` (the soak harness consults ``traffic_multiplier()``;
    the admission layer must shed/degrade, never queue or raise);
  * ``slow_drain`` — report ``magnitude`` extra wall seconds for the
    streaming drain (feeds the admission controller's overload EWMA
    without real sleeps: refreshes look expensive, queries must degrade
    to serve-stale);
  * ``cache_poison`` — tamper a view's result-cache entries so their
    self-described sample_version no longer matches their key (read
    validation must reject and recompute, never serve the entry).

The plan's epoch cursor is advanced explicitly by the harness
(``advance()``), so a given (specs, seed) pair replays identically —
the differential chaos tests rely on that.  A copy of
``repro.robustness.faults``: ``FaultPlan.random`` draws from numpy's
``default_rng(seed)`` as the JAX package does, so the same arguments give
the same plan in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.obs import trace

FAULT_KINDS = (
    "refresh_error",
    "maintain_error",
    "kernel_error",
    "latency",
    "nan_panel",
    "corrupt_batch",
    "duplicate_batch",
    "clock_skew",
    "traffic_spike",
    "slow_drain",
    "cache_poison",
)


class FaultInjected(RuntimeError):
    """The exception every error-kind fault raises (never caught blindly:
    the hardening code catches ``Exception`` at isolation boundaries, so a
    real defect takes the same designed path)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fires when the plan's epoch cursor hits
    ``epoch`` and the pipeline touches ``target`` (view name for action
    faults, base name for batch faults, ``"*"`` for any)."""

    epoch: int
    kind: str
    target: str = "*"
    magnitude: float = 0.0  # latency / clock-skew seconds

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """Seeded epoch-indexed fault schedule + injection log."""

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = int(seed)
        self.epoch = 0
        # every fault that actually fired: (epoch, spec, where)
        self.injected: List[Tuple[int, FaultSpec, str]] = []

    @classmethod
    def random(
        cls,
        views: Sequence[str],
        epochs: Sequence[int],
        rate: float,
        seed: int = 0,
        kinds: Sequence[str] = ("refresh_error", "latency", "nan_panel"),
        magnitude: float = 1.0,
        bases: Optional[Sequence[str]] = None,
    ) -> "FaultPlan":
        """Deterministic Bernoulli schedule: at each (epoch, kind) with
        probability ``rate`` a fault is scheduled on a uniformly drawn
        target.  Same (views, epochs, rate, seed, kinds) → same plan."""
        import numpy as np

        rng = np.random.default_rng(seed)
        specs: List[FaultSpec] = []
        for epoch in epochs:
            for kind in kinds:
                if rng.random() >= rate:
                    continue
                if kind in ("corrupt_batch", "duplicate_batch"):
                    pool = list(bases) if bases else list(views)
                else:
                    pool = list(views)
                target = pool[int(rng.integers(len(pool)))]
                specs.append(FaultSpec(epoch=epoch, kind=kind, target=target,
                                       magnitude=magnitude))
        return cls(specs, seed=seed)

    # -- lifecycle -----------------------------------------------------------
    def attach(self, vm) -> "FaultPlan":
        """Install on a ViewManager: its ``_inject_fault`` hook (and the
        planner feature panel) consult this plan."""
        vm.fault_plan = self
        return self

    def advance(self) -> int:
        self.epoch += 1
        return self.epoch

    def _active(self, kind: str, target: Optional[str] = None) -> List[FaultSpec]:
        return [
            s for s in self.specs
            if s.epoch == self.epoch and s.kind == kind
            and (target is None or s.target == "*" or s.target == target)
        ]

    def _record(self, spec: FaultSpec, where: str) -> None:
        """One fault fired: append to the injection log AND emit a trace
        event, so an exported trace carries exactly as many ``fault``
        events as ``len(self.injected)`` (the reconciliation invariant)."""
        self.injected.append((self.epoch, spec, where))
        trace.event("fault", kind=spec.kind, target=spec.target, where=where,
                    epoch=self.epoch)

    # -- action-path hooks (ViewManager._inject_fault) -----------------------
    def fire(self, point: str, name: str) -> float:
        """Called at an action's start: ``point`` is "refresh" | "maintain" |
        "kernel".  Raises ``FaultInjected`` for a scheduled error, returns
        extra latency seconds for a scheduled spike (0.0 otherwise)."""
        for spec in self._active(point + "_error", name):
            self._record(spec, f"{point}:{name}")
            raise FaultInjected(
                f"injected {spec.kind} on {name!r} at epoch {self.epoch}"
            )
        extra = 0.0
        if point in ("refresh", "maintain"):
            for spec in self._active("latency", name):
                self._record(spec, f"{point}:{name}")
                extra += float(spec.magnitude)
        return extra

    # -- planner feature panel (CostModel.features) --------------------------
    def poison_features(self, names: Sequence[str], panel):
        """NaN-poison the rows of actively targeted views (returns a copy;
        no-op when no ``nan_panel`` fault is scheduled this epoch)."""
        import numpy as np

        active = self._active("nan_panel")
        if not active:
            return panel
        out = np.array(panel, copy=True)
        for spec in active:
            idx = [i for i, n in enumerate(names)
                   if spec.target in ("*", n)]
            for i in idx:
                out[i, :] = np.nan
            if idx:
                self._record(spec, "features")
        return out

    # -- producer-path hooks (streaming offer) -------------------------------
    def mutate_offer(self, base: str, inserts, deletes, seq, key=None):
        """Expand one producer offer into the list of offers that actually
        reach the service: the original, plus any scheduled duplicate or
        NaN-corrupt copy under the SAME sequence number and idempotency key
        (a retried / bit-flipped transmission — the duplicate exercises the
        at-least-once dedupe when the producer set a key)."""
        offers = [(inserts, deletes, seq, key)]
        for spec in self._active("duplicate_batch", base):
            offers.append((inserts, deletes, seq, key))
            self._record(spec, f"offer:{base}")
        for spec in self._active("corrupt_batch", base):
            offers.append((
                _corrupt_copy(inserts) if inserts is not None else None,
                _corrupt_copy(deletes) if deletes is not None else None,
                seq,
                key,
            ))
            self._record(spec, f"offer:{base}")
        return offers

    # -- serving-plane hooks (admission / cache / drain) ---------------------
    def traffic_multiplier(self) -> float:
        """Offered-load multiplier for this epoch (product of active
        ``traffic_spike`` magnitudes; 1.0 when none scheduled).  The load
        harness multiplies its per-epoch query count by this."""
        mult = 1.0
        for spec in self._active("traffic_spike"):
            self._record(spec, "traffic")
            mult *= max(float(spec.magnitude), 0.0)
        return mult

    def drain_latency_s(self) -> float:
        """Extra wall seconds to REPORT for this epoch's streaming drain
        (``slow_drain``): inflates the admission controller's drain-cost
        EWMA without real sleeps, so overload paths test deterministically."""
        extra = 0.0
        for spec in self._active("slow_drain"):
            self._record(spec, "drain")
            extra += float(spec.magnitude)
        return extra

    def poison_cache(self, cache, view: str) -> int:
        """Fire any scheduled ``cache_poison`` fault against ``view``:
        tampers the result cache's stored entries (wrong internal version)
        via ``ResultCache.poison``.  Returns entries tampered; the cache's
        read validation must reject every one."""
        n = 0
        for spec in self._active("cache_poison", view):
            n += cache.poison(view)
            self._record(spec, f"cache:{view}")
        return n

    # -- clock (harness-owned) -----------------------------------------------
    def clock_skew_s(self) -> float:
        """Net clock shift scheduled for this epoch (the harness adds it to
        its injectable clock; may be negative)."""
        skew = 0.0
        for spec in self._active("clock_skew"):
            self._record(spec, "clock")
            skew += float(spec.magnitude)
        return skew


def _corrupt_copy(rel):
    """A bit-flipped transmission: the first non-key float column becomes
    NaN (ingest validation rejects the whole batch)."""
    import torch

    from repro_torch.relational.relation import Relation

    cols = dict(rel.columns)
    for c in rel.schema.columns:
        if c in rel.schema.pk:
            continue
        if rel.col(c).is_floating_point():
            cols[c] = torch.full_like(rel.col(c), float("nan"))
            break
    return Relation(cols, rel.valid, rel.schema)
