"""Budgeted maintenance scheduler: greedy knapsack over (view, action).

``MaintenancePlanner.step()`` is the control-plane epoch: score the fleet
(one kernels/fleet_score launch over the kernels/fleet_moments snapshot),
pick the best-scoring actions whose predicted cost fits the per-epoch time
budget, then execute them — ``svc_refresh_many`` for *clean* and *retune*,
``maintain`` for *maintain* — feeding the observed wall times back into
the cost EWMAs.  Views the budget cannot reach serve stale this epoch.

With ``adapt_m``, a view whose recommended ratio differs from its current
one swaps its *clean* candidate for a *retune* candidate priced at the
retune EWMA; the recommendation is armed onto the view only when that
retune wins the knapsack.

The **starvation guard** bounds how long "serve stale" can win: a view
whose full-maintenance age exceeds ``age_cap_s`` while it still carries
unapplied deltas is forced into the plan as a maintain, ahead of the
knapsack and regardless of remaining budget.

The decisions are those of ``repro.planner.scheduler``, and so are its
spans: ``snapshot`` (the scoring pass), ``schedule`` (the knapsack) and
``act`` (the epoch's maintains and cleans, whose ``clean``/``merge``/
``maintain`` spans nest inside it); ``snapshot_s``, ``schedule_s`` and
``act_s`` are read from ``vm.clock``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

from repro_torch.kernels.fleet_score import A_CLEAN, A_MAINTAIN, A_RETUNE
from repro_torch.obs import trace
from repro_torch.planner.costs import CostModel
from repro_torch.planner.score import FleetScores, score_fleet

COST_FIT_EPS = 1e-9  # float slack when charging predicted costs
TRAFFIC_DECAY = 0.5  # per-epoch decay of the traffic counters
# an action running past DEADLINE_FACTOR × its EWMA prediction (never below
# DEADLINE_FLOOR_S: cold EWMAs must not quarantine healthy views) fails
DEADLINE_FACTOR = 10.0
DEADLINE_FLOOR_S = 0.5


def greedy_knapsack(cands, remaining: float, chosen: Dict[str, "PlannedAction"]) -> float:
    """The planner's greedy fill: walk ``(score, view, action, cost)``
    candidates sorted by (-score, view, action) — the deterministic
    tie-break that keeps plans reproducible — charging each chosen action
    against ``remaining``.  Mutates ``chosen`` (one action per view;
    pre-seeded entries such as forced maintains are respected) and returns
    the budget left."""
    for score, name, action, cost in sorted(cands, key=lambda c: (-c[0], c[1], c[2])):
        if score <= 0.0 or name in chosen:
            continue
        if cost <= remaining + COST_FIT_EPS:
            chosen[name] = PlannedAction(view=name, action=action, score=score, predicted_s=cost)
            remaining -= cost
    return remaining


@dataclasses.dataclass
class PlannedAction:
    view: str
    action: str  # "clean" | "maintain" | "retune"
    score: float
    predicted_s: float
    forced: bool = False  # starvation guard, not knapsack
    actual_s: float = 0.0  # observed wall time once executed
    deadline_s: float = 0.0  # per-action timeout derived from the EWMA cost
    overrun: bool = False  # ran past its deadline → view degraded
    failed: bool = False  # raised during execution → view quarantined

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PlanReport:
    """One epoch's decisions + accounting."""

    epoch: int
    budget_s: float
    actions: List[PlannedAction]
    skipped: List[str]  # views left to serve stale this epoch
    corr_wins: Dict[str, bool]  # §5.2.2 estimator flip per view
    recommended_m: Dict[str, float] = dataclasses.field(default_factory=dict)
    # views the quarantine registry kept out of the knapsack
    quarantined: List[str] = dataclasses.field(default_factory=list)
    predicted_spend_s: float = 0.0
    actual_spend_s: float = 0.0
    # where the epoch's wall time went: the fleet snapshot + scoring pass,
    # the knapsack, and the executed actions
    snapshot_s: float = 0.0
    schedule_s: float = 0.0
    act_s: float = 0.0

    def to_dict(self) -> Dict:
        return {
            "epoch": self.epoch,
            "budget_s": self.budget_s,
            "predicted_spend_s": self.predicted_spend_s,
            "actual_spend_s": self.actual_spend_s,
            "snapshot_s": self.snapshot_s,
            "schedule_s": self.schedule_s,
            "act_s": self.act_s,
            "actions": [a.to_dict() for a in self.actions],
            "skipped": list(self.skipped),
            "corr_wins": dict(self.corr_wins),
            "recommended_m": dict(self.recommended_m),
            "quarantined": list(self.quarantined),
        }


class MaintenancePlanner:
    """Cost-model-driven clean/retune/maintain/serve-stale scheduler."""

    def __init__(
        self,
        vm,
        budget_s: float = 0.25,
        age_cap_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
        cost_model: Optional[CostModel] = None,
        adapt_m: bool = False,
        max_retries: Optional[int] = None,
        backoff_base: Optional[int] = None,
        backoff_cap: Optional[int] = None,
    ):
        self.vm = vm
        self.budget_s = float(budget_s)
        self.age_cap_s = float(age_cap_s)
        vm.health.configure(max_retries=max_retries, backoff_base=backoff_base,
                            backoff_cap=backoff_cap)
        self.cost_model = (cost_model or CostModel(vm, clock=clock)).attach()
        self.adapt_m = bool(adapt_m)
        if self.adapt_m:
            vm.adaptive_m = True
        self.epoch = 0
        self.last_report: Optional[PlanReport] = None

    # -- decision ------------------------------------------------------------
    def plan(self, budget_s: Optional[float] = None) -> PlanReport:
        """Score the fleet and pick this epoch's actions (no execution)."""
        clock = self.vm.clock
        t0 = clock()
        with trace.span("snapshot", epoch=self.epoch):
            fs = score_fleet(self.cost_model)
        snapshot_s = clock() - t0
        t0 = clock()
        with trace.span("schedule", epoch=self.epoch) as sp:
            report = self.choose(fs, budget_s)
            report.schedule_s = clock() - t0
            sp.set(chosen=len(report.actions), skipped=len(fs.names) - len(report.actions))
        report.snapshot_s = snapshot_s
        return report

    def choose(self, fs: FleetScores, budget_s: Optional[float] = None) -> PlanReport:
        """This epoch's actions from one scoring pass: the starvation guard,
        then the greedy knapsack over the remaining candidates.  Reads the
        fleet's state and changes none of it."""
        budget = self.budget_s if budget_s is None else float(budget_s)
        rec_m = fs.recommended_m()
        chosen: Dict[str, PlannedAction] = {}
        remaining = budget
        # quarantined views sit the epoch out until their backoff expires;
        # feature sanitization may have just quarantined some, so this
        # check follows the scoring pass
        health = self.vm.health
        blocked = {n for n in fs.names if health.blocked(n)}

        # starvation guard: overdue drifting views maintain unconditionally
        for name in fs.names:
            if name in blocked:
                continue
            if (self.cost_model.age_s(name) > self.age_cap_s
                    and self.vm.drift_rows(name, since="ivm") > 0):
                cost = self.cost_model._stat(name).maintain_s
                chosen[name] = PlannedAction(
                    view=name, action="maintain", forced=True,
                    score=float(fs.scores[fs.names.index(name), A_MAINTAIN]), predicted_s=cost)
                remaining -= cost

        cands = []
        for i, name in enumerate(fs.names):
            if name in chosen or name in blocked:
                continue
            st = self.cost_model._stat(name)
            rm = rec_m.get(name, 0.0)
            if self.adapt_m and rm > 0.0 and rm != self.vm.views[name].m:
                # the clean slot BECOMES a retune, priced at the retune EWMA
                cands.append((float(fs.scores[i, A_RETUNE]), name, "retune", st.retune_s))
            else:
                cands.append((float(fs.scores[i, A_CLEAN]), name, "clean", st.refresh_s))
            cands.append((float(fs.scores[i, A_MAINTAIN]), name, "maintain", st.maintain_s))
        greedy_knapsack(cands, remaining, chosen)

        actions = [chosen[n] for n in fs.names if n in chosen]
        for act in actions:
            act.deadline_s = max(DEADLINE_FLOOR_S, DEADLINE_FACTOR * act.predicted_s)
        return PlanReport(
            epoch=self.epoch,
            budget_s=budget,
            actions=actions,
            skipped=[n for n in fs.names if n not in chosen],
            corr_wins=fs.corr_wins(),
            recommended_m=rec_m,
            quarantined=sorted(blocked),
            predicted_spend_s=sum(a.predicted_s for a in actions),
        )

    # -- the control-plane epoch ---------------------------------------------
    def step(self, budget_s: Optional[float] = None, execute: bool = True) -> PlanReport:
        """One epoch: plan, then execute under the budget.

        ``execute=False`` is a pure preview (no state moves, no traffic
        decay, no epoch advance).  Execution is failure-isolated: an action
        that throws or overruns its deadline quarantines ITS view and the
        rest of the epoch commits."""
        if execute:
            self.vm.health.begin_epoch()
        report = self.plan(budget_s=budget_s)
        if not execute:
            return report
        if self.adapt_m:
            # only a scheduled retune pays the retune price: the ratio rides
            # onto a view iff its retune action won the knapsack
            for act in report.actions:
                rm = report.recommended_m.get(act.view, 0.0)
                if act.action == "retune" and rm > 0.0:
                    self.vm.views[act.view].recommended_m = rm
        clock = self.vm.clock
        t0 = clock()
        with trace.span("act", epoch=self.epoch, actions=len(report.actions)) as act_sp:
            cleans = [a for a in report.actions if a.action != "maintain"]
            for act in report.actions:
                if act.action == "maintain":
                    try:
                        act.actual_s = self.vm.maintain(act.view)
                    except Exception:
                        # maintain() restored the view and recorded the failure
                        act.failed = True
                        act.actual_s = 0.0
            if cleans:
                # the epoch's cleans go through the fleet refresh path: one
                # fused fleet launch and one fleet_merge launch per shape
                dts = self.vm.svc_refresh_many([a.view for a in cleans], isolate=True)
                for act in cleans:
                    act.actual_s = dts[act.view]
                    if self.vm.health.failed_this_epoch(act.view):
                        act.failed = True
            # an action past its deadline degrades its view to serve-stale;
            # its wall time is already in the cost EWMA
            for act in report.actions:
                if not act.failed and act.deadline_s > 0.0 and act.actual_s > act.deadline_s:
                    act.overrun = True
                    self.vm.health.record_failure(act.view, TimeoutError(
                        f"{act.action} ran {act.actual_s:.3f}s > deadline {act.deadline_s:.3f}s"))
            report.act_s = clock() - t0
            act_sp.set(act_s=report.act_s, failed=sum(1 for a in report.actions if a.failed))
        report.actual_spend_s = sum(a.actual_s for a in report.actions)
        self.cost_model.decay_traffic(TRAFFIC_DECAY)
        self.epoch += 1
        self.last_report = report
        return report
