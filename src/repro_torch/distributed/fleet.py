"""ShardedFleet: the device mesh as the unit of fleet execution.

The port of ``repro.distributed.fleet``: the same decisions, spans and
kprof scopes, driven by one process over a list of devices (a
``launch.mesh.LocalMesh``).  Shard s lives on the mesh's s-th device along
``mesh_axis`` when that axis has ``n_shards`` devices, otherwise every
shard lives on ``device``; the score combine is
``kernels.fleet_score.fleet_scores_sharded_host`` (one launch per shard on
its card, or one launch over the stack when every shard lives on
``device``).  A shard's bases, ingest partitions and samples stay on its
card; the feature panels and their scores stay on the host, in one mapped
staging pair that every shard's card reads and writes.

SVC §7.5 observes that hashed sampling is deterministic and row-local, so
sampled cleaning parallelizes trivially across data partitions — only the
small aggregated decision panel needs combining.  This module cashes that
in for the epoch path: registered views are sharded across a mesh axis,
each shard owning its views end to end —

  * its slice of the ingest plane (one ``PartitionedDeltaLog`` partition
    per base, drained shard-locally, never shuffled),
  * its own ``ViewManager`` (fleet-panel slice, samples, health registry)
    and ``CostModel`` (feature gather stays local),
  * its per-shard act pass: the scheduled ``fleet_clean_merge`` /
    ``svc_refresh_many`` / ``maintain`` dispatches run against shard-local
    state only, wrapped in a ``shard_act`` span and a kprof
    ``shard_scope`` so the observatory reconciles one ledger per shard.

The planner closes exactly ONE global decision per epoch: per-shard
feature panels are scored in place and combined with a single
all_gather (``kernels.fleet_score.fleet_scores_sharded_host``) into one
greedy knapsack over the whole fleet — the same ``greedy_knapsack`` the
single-device ``MaintenancePlanner`` runs, fed the same candidate tuples,
so a sharded fleet's plan is bit-identical to the flat plan on the same
schedule.  The only cross-shard traffic all epoch is the (S, Vmax,
N_SCORES) score panel: raw delta rows never leave their shard.

Failure axis: ``distributed.ft.FleetMonitor`` watches the shards.  A dead
or straggling shard is excluded from the mesh plan and every view it owns
is **suspended** (``FleetHealth.suspend`` — quarantine-style accounting,
serve-stale with widened CI) instead of erroring; its ingest partitions
keep queueing.  ``revive_shard`` re-admits the shard, resumes its views,
and the next epoch drains the backlog — the lost-shard drain epoch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

import torch

from repro_torch.distributed.ft import FleetMonitor
from repro_torch.kernels.fleet_score import (
    A_CLEAN,
    A_MAINTAIN,
    N_FEATURES,
    N_SCORES,
    fleet_scores_sharded_host,
)
from repro_torch.obs import kprof, trace
from repro_torch.planner.costs import CostModel
from repro_torch.planner.scheduler import PlannedAction, greedy_knapsack
from repro_torch.streaming.delta_log import PartitionedDeltaLog
from repro_torch.views.manager import ViewManager


class ShardLostError(RuntimeError):
    """Raised into the health registry (never to callers) when a view's
    owning shard drops out of the mesh."""


@dataclasses.dataclass
class ShardedAction(PlannedAction):
    shard: int = -1


@dataclasses.dataclass
class FleetPlanReport:
    """One sharded epoch's global decision + per-shard accounting."""

    epoch: int
    budget_s: float
    actions: List[ShardedAction]
    skipped: List[str]
    quarantined: List[str]
    excluded_shards: List[int]  # shards outside this epoch's mesh plan
    suspended: List[str]  # views serving stale because their shard is gone
    shard_wall_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    predicted_spend_s: float = 0.0
    actual_spend_s: float = 0.0
    snapshot_s: float = 0.0
    schedule_s: float = 0.0
    act_s: float = 0.0

    def to_dict(self) -> Dict:
        return {
            "epoch": self.epoch,
            "budget_s": self.budget_s,
            "actions": [a.to_dict() for a in self.actions],
            "skipped": list(self.skipped),
            "quarantined": list(self.quarantined),
            "excluded_shards": list(self.excluded_shards),
            "suspended": list(self.suspended),
            "shard_wall_s": dict(self.shard_wall_s),
            "predicted_spend_s": self.predicted_spend_s,
            "actual_spend_s": self.actual_spend_s,
            "snapshot_s": self.snapshot_s,
            "schedule_s": self.schedule_s,
            "act_s": self.act_s,
        }


class ShardedFleet:
    """Views sharded across a mesh axis; one psum-closed plan per epoch.

    ``mesh`` (optional, e.g. ``launch.mesh.make_local_mesh(data=S,
    device="cpu")``) places shard s on its s-th device along ``mesh_axis``
    and scores each shard's panel there when that axis has ``n_shards``
    devices; without one every shard lives on ``device`` and the stacked
    panel is scored in one call — bit-equal either way.
    """

    def __init__(self, n_shards: int, budget_s: float = 0.25,
                 age_cap_s: float = 60.0,
                 clock: Optional[Callable[[], float]] = None,
                 mesh=None, mesh_axis: str = "data",
                 heartbeat_timeout_s: float = 60.0,
                 straggler_factor: float = 2.0,
                 traffic_decay: float = 0.5,
                 max_batches: int = 64,
                 device="cuda"):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = int(n_shards)
        self.budget_s = float(budget_s)
        self.age_cap_s = float(age_cap_s)
        self.clock: Callable[[], float] = clock or time.perf_counter
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.traffic_decay = float(traffic_decay)
        self.max_batches = int(max_batches)
        if mesh is not None and mesh.shape.get(mesh_axis, 1) == self.n_shards:
            self.devices = list(mesh.axis_devices(mesh_axis))
        else:
            self.devices = [torch.device(device)] * self.n_shards
        # fleet_scores_sharded_host's per-device branch: each shard's card
        # reads its panel from the host and writes its scores there
        self._score_per_device = mesh is not None and self.n_shards > 1 and \
            mesh.shape.get(mesh_axis, 1) == self.n_shards
        # one full view stack per shard: manager + cost model + health, all
        # reading the fleet's single injectable clock
        self.vms: List[ViewManager] = []
        self.cost_models: List[CostModel] = []
        for s in range(self.n_shards):
            vm = ViewManager(device=self.devices[s], clock=self.clock)
            vm.obs_attrs = {"shard": s}
            self.vms.append(vm)
            self.cost_models.append(CostModel(vm, clock=self.clock).attach())
        self.devices = [vm.device for vm in self.vms]  # "cuda" as the card it named
        self.view_shard: Dict[str, int] = {}
        self.base_owner: Dict[str, int] = {}
        self._bases: Dict[str, object] = {}
        self.plogs: Dict[str, PartitionedDeltaLog] = {}
        self.monitor = FleetMonitor(self.n_shards,
                                    timeout_s=heartbeat_timeout_s,
                                    straggler_factor=straggler_factor,
                                    clock=self.clock)
        self._killed: Set[int] = set()
        self._suspended_shards: Set[int] = set()
        self.epoch = 0
        self.last_report: Optional[FleetPlanReport] = None

    # -- registration --------------------------------------------------------
    def register_base(self, name: str, rel) -> None:
        """Register a base relation fleet-wide; it lands in a shard's
        ``ViewManager`` when a view on that shard claims it."""
        self._bases[name] = rel

    def _claim_base(self, base: str, shard: int) -> None:
        owner = self.base_owner.get(base)
        if owner is not None:
            if owner != shard:
                raise ValueError(
                    f"base {base!r} is owned by shard {owner}; a view on "
                    f"shard {shard} cannot ingest through it (co-locate the "
                    f"view or pass shard={owner})")
            return
        self.base_owner[base] = shard
        self.plogs[base] = PartitionedDeltaLog(
            base, self.n_shards, max_batches=self.max_batches,
            clock=self.clock, registry=self.vms[shard].metrics)

    def register_view(self, view, delta_bases: Tuple[str, ...], m: float,
                      seed: int = 0, shard: Optional[int] = None, **kw):
        """Place a view on a shard and register it there.

        Placement: an explicit ``shard``, else co-location with the first
        already-owned delta base (two bases owned by different shards is a
        registration error — deltas never cross shards), else the
        deterministic least-loaded shard.  View names are fleet-global.
        """
        name = view.name
        if name in self.view_shard:
            raise ValueError(f"view {name!r} already registered")
        if shard is None:
            for b in delta_bases:
                if b in self.base_owner:
                    shard = self.base_owner[b]
                    break
        if shard is None:
            shard = min(range(self.n_shards),
                        key=lambda s: (len(self.vms[s].views), s))
        shard = int(shard)
        if not (0 <= shard < self.n_shards):
            raise ValueError(f"shard {shard} out of range")
        for b in delta_bases:
            self._claim_base(b, shard)
        vm = self.vms[shard]
        # the view's plan reads base relations by name: materialize every
        # registered base into the owning shard's manager on first need
        for b, rel in self._bases.items():
            if b not in vm.base:
                vm.register_base(b, rel)
        mv = vm.register_view(view, delta_bases, m, seed=seed, **kw)
        self.view_shard[name] = shard
        return mv

    def shard_of(self, view_name: str) -> int:
        return self.view_shard[view_name]

    def vm_of(self, view_name: str) -> ViewManager:
        return self.vms[self.view_shard[view_name]]

    def shard_views(self, shard: int) -> List[str]:
        return [n for n, s in self.view_shard.items() if s == shard]

    # -- ingest plane --------------------------------------------------------
    def ingest(self, base: str, inserts=None, deletes=None,
               seq: Optional[int] = None, key=None):
        """Offer a delta batch into the owning shard's partition of the
        base's ``PartitionedDeltaLog``.  Rows stay queued until that shard's
        next live epoch drains them — including across a shard loss."""
        owner = self.base_owner.get(base)
        if owner is None:
            raise KeyError(f"base {base!r} has no registered view over it")
        dev = self.devices[owner]  # the partition queues on its shard's card
        return self.plogs[base].offer(
            owner, inserts=None if inserts is None else inserts.to(dev),
            deletes=None if deletes is None else deletes.to(dev), seq=seq, key=key)

    def pending_rows(self, base: Optional[str] = None) -> int:
        logs = [self.plogs[base]] if base is not None else self.plogs.values()
        return sum(p.pending_rows() for p in logs)

    def _drain_shard_bases(self, shard: int) -> None:
        """Drain every partition this shard owns into its manager's pending
        set; a failed apply rolls the partition back (requeue) bit-equally."""
        vm = self.vms[shard]
        for base, owner in self.base_owner.items():
            if owner != shard:
                continue
            plog = self.plogs[base]
            if plog[shard].pending_batches() == 0:
                continue
            ins, dels = plog.drain_shard(shard)
            if ins is None and dels is None:
                continue
            try:
                vm.ingest(base, inserts=ins, deletes=dels)
            except Exception:
                plog.requeue(shard, ins, dels)
                raise

    # -- failure axis --------------------------------------------------------
    def kill_shard(self, shard: int) -> None:
        """Chaos hook: the shard stops heartbeating and is excluded from the
        next plan (its views suspend to serve-stale, its partitions queue)."""
        self._killed.add(int(shard))

    def revive_shard(self, shard: int) -> None:
        """Re-admit a recovered shard: fresh liveness record, its views
        resume planning (still degraded until their next successful clean),
        and the next epoch drains the partition backlog."""
        shard = int(shard)
        self._killed.discard(shard)
        self.monitor.revive(shard)
        self._suspended_shards.discard(shard)
        vm = self.vms[shard]
        for name in self.shard_views(shard):
            vm.health.resume(name)
        trace.event("shard_revive", shard=shard, epoch=self.epoch)

    def _sweep_mesh(self) -> List[int]:
        """Heartbeat live shards, sweep the monitor, suspend views on newly
        excluded shards; returns this epoch's excluded shard list."""
        for s in range(self.n_shards):
            if s not in self._killed:
                self.monitor.heartbeat(s)
        failed, stragglers = self.monitor.sweep()
        alive = set(self.monitor.alive_hosts())
        excluded = sorted((set(range(self.n_shards)) - alive)
                          | set(stragglers) | self._killed)
        for s in excluded:
            if s in self._suspended_shards:
                continue
            self._suspended_shards.add(s)
            vm = self.vms[s]
            reason = ShardLostError(
                f"shard {s} excluded from the mesh plan (dead or straggler)")
            for name in self.shard_views(s):
                vm.health.suspend(name, reason)
            trace.event("shard_lost", shard=s, epoch=self.epoch,
                        views=len(self.shard_views(s)))
        return excluded

    # -- the psum-closed epoch -----------------------------------------------
    def epoch_step(self, budget_s: Optional[float] = None,
                   execute: bool = True,
                   fused: bool = True) -> FleetPlanReport:
        """One fleet epoch: sweep the mesh, drain live shards' ingest
        partitions, score every shard's panel locally, close ONE global
        knapsack, and run each shard's action slice shard-locally.

        ``execute=False`` is the pure preview: no drains, no state moves,
        no epoch advance — just the global decision (the parity surface the
        tests compare against the single-device planner)."""
        budget = self.budget_s if budget_s is None else float(budget_s)
        clock = self.clock
        if execute:
            for vm in self.vms:
                vm.health.begin_epoch()
        excluded = self._sweep_mesh() if execute else sorted(
            self._suspended_shards | self._killed)
        live = [s for s in range(self.n_shards) if s not in excluded]

        if execute:
            for s in live:
                self._drain_shard_bases(s)

        # -- snapshot: shard-local feature panels, one global score combine
        t0 = clock()
        with trace.span("snapshot", epoch=self.epoch, shards=len(live)):
            shard_names: Dict[int, List[str]] = {
                s: self.shard_views(s) for s in live}
            vmax = max((len(n) for n in shard_names.values()), default=0)
            feats = np.zeros((self.n_shards, max(vmax, 1), N_FEATURES),
                             np.float32)
            for s in live:
                names = shard_names[s]
                if names:
                    feats[s, :len(names)] = self.cost_models[s].features(names)
            shard_rows = [len(shard_names.get(s, ())) for s
                          in range(self.n_shards)]
            scores = fleet_scores_sharded_host(
                feats, self.devices if self._score_per_device else self.devices[0],
                shard_views=shard_rows)
            assert scores.shape[2] == N_SCORES
        snapshot_s = clock() - t0

        # -- schedule: ONE greedy knapsack over every live shard's views
        t0 = clock()
        with trace.span("schedule", epoch=self.epoch) as sched_sp:
            chosen: Dict[str, PlannedAction] = {}
            remaining = budget
            blocked: List[str] = []
            cands: List[Tuple[float, str, str, float]] = []
            owner: Dict[str, int] = {}
            for s in live:
                vm, cm = self.vms[s], self.cost_models[s]
                for i, name in enumerate(shard_names[s]):
                    owner[name] = s
                    if vm.health.blocked(name):
                        blocked.append(name)
                        continue
                    st = cm._stat(name)
                    # starvation guard, per shard: overdue drifting views
                    # maintain ahead of the knapsack
                    if (cm.age_s(name) > self.age_cap_s
                            and vm.drift_rows(name, since="ivm") > 0):
                        chosen[name] = PlannedAction(
                            view=name, action="maintain", forced=True,
                            score=float(scores[s, i, A_MAINTAIN]),
                            predicted_s=st.maintain_s)
                        remaining -= st.maintain_s
                        continue
                    cands.append((float(scores[s, i, A_CLEAN]), name,
                                  "clean", st.refresh_s))
                    cands.append((float(scores[s, i, A_MAINTAIN]), name,
                                  "maintain", st.maintain_s))
            remaining = greedy_knapsack(cands, remaining, chosen)
            all_names = [n for s in live for n in shard_names[s]]
            actions = [
                ShardedAction(shard=owner[n], **dataclasses.asdict(chosen[n]))
                for n in all_names if n in chosen
            ]
            sched_sp.set(chosen=len(actions),
                         skipped=len(all_names) - len(actions))
        schedule_s = clock() - t0

        suspended = sorted(
            n for s in excluded
            for n in self.shard_views(s))
        report = FleetPlanReport(
            epoch=self.epoch, budget_s=budget, actions=actions,
            skipped=[n for n in all_names if n not in chosen],
            quarantined=sorted(blocked), excluded_shards=excluded,
            suspended=suspended,
            predicted_spend_s=sum(a.predicted_s for a in actions),
            snapshot_s=snapshot_s, schedule_s=schedule_s)
        if not execute:
            return report

        # -- act: each shard runs ITS slice of the plan, shard-locally
        t0 = clock()
        with trace.span("act", epoch=self.epoch,
                        actions=len(actions)) as act_sp:
            for s in live:
                mine = [a for a in actions if a.shard == s]
                if not mine and not shard_names[s]:
                    continue
                vm = self.vms[s]
                t_shard = clock()
                with trace.span("shard_act", shard=s, epoch=self.epoch,
                                actions=len(mine)), kprof.shard_scope(s):
                    for act in mine:
                        if act.action != "maintain":
                            continue
                        try:
                            act.actual_s = vm.maintain(act.view)
                        except Exception:
                            act.failed = True
                            act.actual_s = 0.0
                    cleans = [a for a in mine if a.action != "maintain"]
                    if cleans:
                        dts = vm.svc_refresh_many(
                            [a.view for a in cleans], fused=fused,
                            isolate=True)
                        for act in cleans:
                            act.actual_s = dts[act.view]
                            if vm.health.failed_this_epoch(act.view):
                                act.failed = True
                wall = clock() - t_shard
                report.shard_wall_s[s] = wall
                self.monitor.report_step(s, wall)
            report.act_s = clock() - t0
            act_sp.set(act_s=report.act_s,
                       failed=sum(1 for a in actions if a.failed))
        report.actual_spend_s = sum(a.actual_s for a in actions)
        for s in live:
            self.cost_models[s].decay_traffic(self.traffic_decay)
        self.epoch += 1
        self.last_report = report
        return report

    # -- serving -------------------------------------------------------------
    def query(self, view_name: str, q, **kw):
        """Route a query to the owning shard's manager.  A suspended view
        answers from its last good sample (serve-stale, CI widened by the
        pending-delta bound) — shard loss costs freshness, not
        availability."""
        return self.vm_of(view_name).query(view_name, q, **kw)

    def query_batch(self, view_name: str, queries: Sequence, **kw):
        return self.vm_of(view_name).query_batch(view_name, queries, **kw)

    def is_degraded(self, view_name: str) -> bool:
        return self.vm_of(view_name).health.is_degraded(view_name)

    def degraded_views(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for vm in self.vms:
            out.update(vm.health.degraded_views())
        return out
