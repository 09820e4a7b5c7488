"""FleetHealth: the per-view quarantine / retry-backoff registry.

SVC's degradation story has two axes.  The *staleness* axis is the paper's:
between maintenance, queries answer from a cleaned sample with explicit
error bounds.  This module adds the *failure* axis: when a view's clean or
maintenance throws, overruns its deadline, or its planner features go
non-finite, the view is **quarantined** — it keeps answering queries from
its last good sample while the rest of the epoch commits.

Quarantined views are not hammered every epoch: each consecutive failure
doubles an epoch-denominated backoff (1, 2, 4, … epochs, capped), and a
finite retry budget bounds total attempts — an exhausted view stays
serve-stale until an operator ``reset()``.  A successful clean/maintain
clears the quarantine and restores the budget.

The registry lives on ``ViewManager.health``; ``svc_refresh_many``,
``maintain`` and the planner's deadline check report through it.  The
arithmetic is that of ``repro.robustness.health``; its trace events wait
for the port's observability layer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class ViewHealth:
    """One view's failure-axis state."""

    degraded: bool = False
    failures: int = 0  # lifetime failure count
    consecutive: int = 0  # consecutive failures (backoff exponent)
    retries_left: int = 0  # attempts remaining before permanent serve-stale
    backoff_until_epoch: int = 0  # epoch at which a retry is allowed again
    last_error: str = ""
    last_failure_epoch: int = -1
    recovered_epoch: int = -1  # epoch of the last quarantine-clearing success
    suspended: bool = False  # host-level quarantine (shard lost, not view bug)


def _describe(error: object) -> str:
    if isinstance(error, BaseException):
        return f"{type(error).__name__}: {error}"
    return str(error)


class FleetHealth:
    """Per-view quarantine registry with exponential retry backoff."""

    def __init__(self, max_retries: int = 5, backoff_base: int = 1,
                 backoff_cap: int = 16):
        self.max_retries = int(max_retries)
        self.backoff_base = int(backoff_base)
        self.backoff_cap = int(backoff_cap)
        self.epoch = 0
        self.views: Dict[str, ViewHealth] = {}

    def configure(self, max_retries: Optional[int] = None,
                  backoff_base: Optional[int] = None,
                  backoff_cap: Optional[int] = None) -> "FleetHealth":
        if max_retries is not None:
            self.max_retries = int(max_retries)
        if backoff_base is not None:
            self.backoff_base = int(backoff_base)
        if backoff_cap is not None:
            self.backoff_cap = int(backoff_cap)
        return self

    def _h(self, name: str) -> ViewHealth:
        h = self.views.get(name)
        if h is None:
            h = ViewHealth(retries_left=self.max_retries)
            self.views[name] = h
        return h

    # -- epoch clock ---------------------------------------------------------
    def begin_epoch(self) -> int:
        """Advance the failure-axis epoch counter (one call per control-plane
        epoch: ``MaintenancePlanner.step``)."""
        self.epoch += 1
        return self.epoch

    # -- event ingestion -----------------------------------------------------
    def record_failure(self, name: str, error: object) -> ViewHealth:
        """A clean/maintain attempt failed (exception, deadline overrun, or
        poisoned features): quarantine the view and schedule its retry with
        exponential backoff."""
        h = self._h(name)
        h.degraded = True
        h.failures += 1
        h.consecutive += 1
        if h.retries_left > 0:
            h.retries_left -= 1
        delay = min(self.backoff_cap,
                    self.backoff_base * (2 ** (h.consecutive - 1)))
        h.backoff_until_epoch = self.epoch + delay
        h.last_error = _describe(error)
        h.last_failure_epoch = self.epoch
        return h

    def record_success(self, name: str) -> ViewHealth:
        """A clean/maintain committed: clear the quarantine and restore the
        retry budget."""
        h = self._h(name)
        if h.degraded:
            h.recovered_epoch = self.epoch
        h.degraded = False
        h.suspended = False
        h.consecutive = 0
        h.retries_left = self.max_retries
        h.backoff_until_epoch = 0
        return h

    def suspend(self, name: str, reason: object) -> ViewHealth:
        """Host-level quarantine: the view serves stale until ``resume`` — no
        retry backoff, since the view itself did nothing wrong.  Accounted
        like a failure (failures += 1)."""
        h = self._h(name)
        h.degraded = True
        h.suspended = True
        h.failures += 1
        h.last_error = _describe(reason)
        h.last_failure_epoch = self.epoch
        return h

    def resume(self, name: str) -> ViewHealth:
        """Lift a suspension.  The view stays degraded (serve-stale) until its
        next successful clean or maintain — resume only re-admits it to
        planning."""
        h = self._h(name)
        h.suspended = False
        return h

    # -- queries -------------------------------------------------------------
    def is_degraded(self, name: str) -> bool:
        h = self.views.get(name)
        return bool(h is not None and h.degraded)

    def blocked(self, name: str) -> bool:
        """True while the view must NOT be retried this epoch: quarantined
        and either inside its backoff window or out of retry budget."""
        h = self.views.get(name)
        if h is None or not h.degraded:
            return False
        if h.suspended:
            return True
        if h.retries_left <= 0 and h.consecutive >= self.max_retries:
            return True  # budget exhausted: permanent serve-stale until reset
        return self.epoch < h.backoff_until_epoch

    def retry_due(self, name: str) -> bool:
        """True when a quarantined view's backoff has expired and it still
        has retry budget — it should re-enter the epoch's candidate set."""
        h = self.views.get(name)
        return bool(h is not None and h.degraded and not self.blocked(name))

    def degraded_views(self) -> Dict[str, str]:
        """{view: last error} for every currently quarantined view."""
        return {n: h.last_error for n, h in self.views.items() if h.degraded}

    def quarantined(self) -> List[str]:
        return sorted(n for n, h in self.views.items() if h.degraded)

    def failed_this_epoch(self, name: str) -> bool:
        h = self.views.get(name)
        return bool(h is not None and h.last_failure_epoch == self.epoch)

    def reset(self, name: str) -> None:
        """Operator override: forget a view's failure history entirely."""
        self.views.pop(name, None)
