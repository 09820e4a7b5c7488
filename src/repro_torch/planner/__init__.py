"""Budgeted maintenance control plane (the fleet-level §5.2.2 decision).

The paper decides clean-vs-maintain per query; serving a fleet of views
under finite compute needs that decision per view, per epoch, under an
explicit budget.  Three parts:

  costs.py      — online per-view cost models: EWMA refresh/maintain wall
                  times, drift and traffic counters, moment snapshots from
                  one kernels/fleet_moments launch
  score.py      — one kernels/fleet_score launch prices every
                  (view, action) pair: expected error reduction per second
  scheduler.py  — MaintenancePlanner: greedy knapsack under the epoch
                  budget + a staleness-age starvation guard; executes the
                  plan through svc_refresh_many / maintain
"""

from repro_torch.planner.costs import CostModel, ViewCostStats, canonical_query
from repro_torch.planner.scheduler import (
    MaintenancePlanner,
    PlannedAction,
    PlanReport,
    greedy_knapsack,
)
from repro_torch.planner.score import FleetScores, score_fleet

__all__ = [
    "CostModel",
    "FleetScores",
    "MaintenancePlanner",
    "PlanReport",
    "PlannedAction",
    "ViewCostStats",
    "canonical_query",
    "greedy_knapsack",
    "score_fleet",
]
