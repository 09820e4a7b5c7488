"""Failure axis of the fleet: deterministic fault injection (the chaos
layer), per-view quarantine and retry backoff, and the CI widening of
answers served stale."""

from repro_torch.robustness.degrade import pending_delta_bound, widen_estimate
from repro_torch.robustness.faults import FAULT_KINDS, FaultInjected, FaultPlan, FaultSpec
from repro_torch.robustness.health import FleetHealth, ViewHealth

__all__ = [
    "FAULT_KINDS",
    "FaultInjected",
    "FaultPlan",
    "FaultSpec",
    "FleetHealth",
    "ViewHealth",
    "pending_delta_bound",
    "widen_estimate",
]
