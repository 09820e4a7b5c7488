"""Fault tolerance: heartbeats, straggler mitigation, elastic re-meshing.

A pure-Python copy of ``repro.distributed.ft``.  Host liveness is driven
by the caller (heartbeats and step timings, an injectable clock), and the
decision logic is the production logic: a monitor ingests per-host
heartbeats and step timings, declares failures/stragglers, and the elastic
planner recomputes the largest viable (data, model) mesh from the
surviving hosts.  ``distributed.fleet.ShardedFleet`` wires the monitor into
its per-epoch mesh plan; the tests inject failures.

Policies:
  * failure: no heartbeat for ``timeout_s`` → host dead;
  * straggler: step time > ``straggler_factor`` × rolling median, for
    ``strikes`` consecutive steps → host demoted (treated like a failure —
    on real fleets this is "cordon and replace"; at minimum the planner
    excludes it so the synchronous step stops being gated on it);
  * elastic plan: keep the model axis intact (TP must match the lowered
    program), shrink the data axis to the largest divisor covered by the
    surviving host count; global batch is preserved by raising the
    per-shard microbatch factor.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class HostState:
    last_beat: float
    step_times: deque
    strikes: int = 0
    alive: bool = True


class FleetMonitor:
    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 straggler_factor: float = 2.0, strikes: int = 3,
                 clock: Callable[[], float] = time.time):
        # injectable clock: deterministic liveness tests and chaos harnesses
        # drive simulated time instead of sleeping through timeout windows
        self.clock = clock
        now = self.clock()
        self.hosts: Dict[int, HostState] = {
            h: HostState(last_beat=now, step_times=deque(maxlen=32)) for h in range(n_hosts)
        }
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.strikes = strikes

    def heartbeat(self, host: int, t: Optional[float] = None) -> None:
        self.hosts[host].last_beat = t if t is not None else self.clock()

    def report_step(self, host: int, duration_s: float) -> None:
        self.hosts[host].step_times.append(duration_s)

    def _median_step(self) -> float:
        all_times = sorted(
            t for h in self.hosts.values() if h.alive for t in h.step_times
        )
        return all_times[len(all_times) // 2] if all_times else 0.0

    def sweep(self, now: Optional[float] = None) -> Tuple[List[int], List[int]]:
        """Returns (newly_failed, stragglers) and updates liveness."""
        now = now if now is not None else self.clock()
        med = self._median_step()
        failed, stragglers = [], []
        for hid, st in self.hosts.items():
            if not st.alive:
                continue
            # max(0, ·): a skewed clock (sweep time behind the host's last
            # heartbeat) must read as "fresh", never as a spurious timeout
            if max(0.0, now - st.last_beat) > self.timeout_s:
                st.alive = False
                failed.append(hid)
                continue
            if med > 0 and st.step_times and st.step_times[-1] > self.straggler_factor * med:
                st.strikes += 1
                if st.strikes >= self.strikes:
                    st.alive = False
                    stragglers.append(hid)
            else:
                st.strikes = 0
        return failed, stragglers

    def alive_hosts(self) -> List[int]:
        return [h for h, st in self.hosts.items() if st.alive]

    def revive(self, host: int) -> None:
        """Re-admit a replaced/recovered host: fresh heartbeat, strikes and
        step history cleared (its old straggler record must not poison the
        rolling median it rejoins)."""
        st = self.hosts[host]
        st.alive = True
        st.strikes = 0
        st.step_times.clear()
        st.last_beat = self.clock()


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data_parallel: int
    model_parallel: int
    hosts_used: Tuple[int, ...]
    microbatch_factor: int  # multiplier to preserve global batch


def plan_elastic_mesh(
    alive: List[int],
    chips_per_host: int,
    model_parallel: int,
    target_data_parallel: int,
) -> Optional[ElasticPlan]:
    """Largest power-of-two data axis that the surviving chips support.

    The model axis is pinned (the lowered program's TP degree); data
    parallelism shrinks; the global batch is preserved by scaling the
    gradient-accumulation factor.
    """
    chips = len(alive) * chips_per_host
    if chips < model_parallel:
        return None
    max_dp = chips // model_parallel
    dp = 1
    while dp * 2 <= max_dp and dp * 2 <= target_data_parallel:
        dp *= 2
    hosts_needed = (dp * model_parallel + chips_per_host - 1) // chips_per_host
    micro = max(1, target_data_parallel // dp)
    return ElasticPlan(
        data_parallel=dp,
        model_parallel=model_parallel,
        hosts_used=tuple(sorted(alive)[:hosts_needed]),
        microbatch_factor=micro,
    )
