"""Failure axis of the fleet: per-view quarantine and retry backoff."""

from repro_torch.robustness.health import FleetHealth, ViewHealth

__all__ = ["FleetHealth", "ViewHealth"]
