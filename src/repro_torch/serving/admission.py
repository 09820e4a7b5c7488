"""Admission control for the serving plane: throttle, shed, never queue.

SVC's staleness axis lets an over-budget or overloaded query be answered
now, from the last clean sample, with a wider interval.  Three verdicts:

  * ``ADMIT``    — full service: a due watermark refresh runs, the result
    is cached.
  * ``THROTTLE`` — the tenant's token bucket is empty: answer from the
    current clean sample with no refresh, widened by the pending-delta
    bound (``robustness.degrade``), method tagged ``"+throttled"``.
  * ``SHED``     — the fleet is overloaded (global bucket empty, or the
    drain-cost EWMA over budget): answer from the result cache when
    possible, even a stale-version entry, else one bounded scan; widened
    and tagged ``"+shed"``.

Buckets refill continuously over an injectable clock; a backwards clock
step refills nothing.  Pure Python, a copy of ``repro.serving.admission``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

from repro_torch.obs.registry import MetricsRegistry, counter_attr

# admission verdicts (the serving ladder's top rung)
ADMIT = "admit"
THROTTLE = "throttle"
SHED = "shed"


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Knobs for the serving-plane admission controller.

    Rates are queries/second against the controller's clock; bursts are
    bucket capacities (the instantaneous spike the plane absorbs at full
    service before degrading).  ``drain_overload_s`` is the EWMA of
    refresh/drain wall seconds above which the plane declares itself
    overloaded regardless of arrival rate (a slow drain is load too)."""

    tenant_qps: float = 50.0  # per-tenant sustained budget
    tenant_burst: float = 100.0  # per-tenant burst allowance
    fleet_qps: float = 500.0  # global sustained capacity
    fleet_burst: float = 1000.0  # global burst allowance
    drain_overload_s: float = float("inf")  # EWMA drain cost => overload
    drain_ewma_alpha: float = 0.3  # smoothing for the drain-cost signal


class TokenBucket:
    """Continuous-refill token bucket over an injectable clock."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self.tokens = float(burst)
        self._last = clock()

    def _refill(self) -> None:
        now = self._clock()
        # clamp: a backwards clock step (skew) must not drain the bucket
        elapsed = max(0.0, now - self._last)
        self._last = now
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)

    def take(self, n: float = 1.0) -> bool:
        """Atomically take ``n`` tokens; False (and no tokens consumed)
        when the bucket cannot cover the request."""
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def peek(self) -> float:
        self._refill()
        return self.tokens


@dataclasses.dataclass
class TenantStats:
    admitted: int = 0
    throttled: int = 0
    shed: int = 0


class AdmissionController:
    """Load-aware admission: one global bucket, one bucket per tenant.

    ``decide`` is the only hot-path call: two bucket reads and a float
    compare.  Decision order is shed-first — a fleet-wide overload degrades
    every tenant uniformly (per-tenant budgets are not charged for shed
    queries), then per-tenant budgets throttle the individually greedy."""

    # fleet-wide verdict tallies: bit-compatible views over the metrics
    # registry (per-tenant splits ride the labeled admission_verdicts
    # counter and the TenantStats mirror)
    admitted = counter_attr()
    throttled = counter_attr()
    shed = counter_attr()

    def __init__(self, config: Optional[AdmissionConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[MetricsRegistry] = None):
        self.config = config or AdmissionConfig()
        self._clock = clock
        self.fleet_bucket = TokenBucket(
            self.config.fleet_qps, self.config.fleet_burst, clock
        )
        self._tenants: Dict[str, TokenBucket] = {}
        self.tenant_stats: Dict[str, TenantStats] = {}
        self.metrics = registry or MetricsRegistry()
        self._c_admitted = self.metrics.counter("admission_admitted")
        self._c_throttled = self.metrics.counter("admission_throttled")
        self._c_shed = self.metrics.counter("admission_shed")
        self._drain_ewma = 0.0

    def _verdict_counter(self, tenant: str, verdict: str):
        return self.metrics.counter("admission_verdicts", tenant=tenant,
                                    verdict=verdict)

    def _tenant_bucket(self, tenant: str) -> TokenBucket:
        b = self._tenants.get(tenant)
        if b is None:
            b = TokenBucket(
                self.config.tenant_qps, self.config.tenant_burst, self._clock
            )
            self._tenants[tenant] = b
        return b

    def _stats(self, tenant: str) -> TenantStats:
        s = self.tenant_stats.get(tenant)
        if s is None:
            s = TenantStats()
            self.tenant_stats[tenant] = s
        return s

    # -- load signal ---------------------------------------------------------
    def note_drain(self, seconds: float) -> None:
        """Feed one refresh/drain wall cost into the overload EWMA (the
        streaming service calls this after every drain, including injected
        ``slow_drain`` fault seconds — a slow drain IS load)."""
        a = self.config.drain_ewma_alpha
        self._drain_ewma = (1.0 - a) * self._drain_ewma + a * float(seconds)

    @property
    def drain_ewma_s(self) -> float:
        return self._drain_ewma

    def overloaded(self) -> bool:
        """True while the plane should degrade rather than serve at full
        cost: drain EWMA past the budget, or the global bucket empty."""
        if self._drain_ewma > self.config.drain_overload_s:
            return True
        return self.fleet_bucket.peek() < 1.0

    # -- the decision --------------------------------------------------------
    def decide(self, tenant: str = "default", n: int = 1) -> str:
        """ADMIT / THROTTLE / SHED for a batch of ``n`` queries from
        ``tenant``.  Shed decisions charge no budget (their serving cost is
        a cache read or one bounded scan); throttled queries still charge
        the fleet bucket (they do run a scan, just no refresh)."""
        stats = self._stats(tenant)
        if self._drain_ewma > self.config.drain_overload_s:
            verdict = SHED
        elif not self.fleet_bucket.take(n):
            verdict = SHED
        elif not self._tenant_bucket(tenant).take(n):
            verdict = THROTTLE
        else:
            verdict = ADMIT
        if verdict == SHED:
            self.shed += n
            stats.shed += n
        elif verdict == THROTTLE:
            self.throttled += n
            stats.throttled += n
        else:
            self.admitted += n
            stats.admitted += n
        self._verdict_counter(tenant, verdict).inc(n)
        return verdict
