"""Online per-view cost and signal models for the budgeted control plane.

The planner prices every (view, action) pair each epoch; this module keeps
the inputs fresh at counter-read cost, as ``repro.planner.costs``:

  * **Action costs** — EWMA estimates of ``svc_refresh``, ``maintain`` and
    retune-then-clean wall seconds per view, observed through the hooks
    ``ViewManager`` fires after every timed refresh/maintenance and seeded
    from the view's last timers.  ``pin_costs`` freezes them (deterministic
    tests, equal-price policy comparisons).
  * **Drift** — per-view pending delta rows, read from ``ViewManager``'s
    per-base counters (``drift_rows``).
  * **Traffic** — decayed query hit counts per view, observed through the
    ``query``/``query_batch`` hook.
  * **Moment snapshots** — the §5.2.2 statistics of each view's canonical
    query, recomputed only when the view's samples moved.

``features()`` stacks everything into the (V, N_FEATURES) panel the fleet
scorer (kernels/fleet_score) consumes.  The moment columns come from ONE
``kernels/fleet_moments`` launch over the ViewManager's fleet panel;
``CostModel(use_panel=False)`` keeps the per-view ``snapshot()`` loop over
``variance_comparison`` as the parity reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.estimators import _weights, variance_comparison
from repro_torch.kernels.fleet_moments import M_HT_AQP, M_HT_CORR, M_N, M_S1, M_S2
from repro_torch.kernels.fleet_score import (
    F_AGE,
    F_COST_CLEAN,
    F_COST_MAINTAIN,
    F_COST_RETUNE,
    F_DRIFT_CLEAN,
    F_DRIFT_IVM,
    F_EX2,
    F_HT_AQP,
    F_HT_CORR,
    F_M,
    F_MEAN,
    F_N,
    F_TRAFFIC,
    N_FEATURES,
)
from repro_torch.views.panel import canonical_query

ALPHA = 0.3  # EWMA weight of a new wall-time observation
# default cost seeds (seconds) before the first observed timer
DEFAULT_REFRESH_S = 0.05
DEFAULT_MAINTAIN_S = 0.25
# a never-maintained view falls back to this clean-to-maintain cost ratio
MAINTAIN_OVER_REFRESH_SEED = 4.0
# a never-retuned view prices a retune-then-clean at this multiple of a
# plain clean (the retune re-derives both samples before cleaning)
RETUNE_OVER_REFRESH_SEED = 2.0

__all__ = ["CostModel", "ViewCostStats", "canonical_query"]


@dataclasses.dataclass
class ViewCostStats:
    """Per-view EWMA costs, traffic, and the last moment snapshot."""

    refresh_s: float
    maintain_s: float
    retune_s: float
    traffic: float
    last_maintain_t: float
    snapshot_version: int = -1
    n_rows: float = 0.0
    ex2: float = 0.0
    mean: float = 0.0
    ht_aqp: float = 0.0
    ht_corr: float = 0.0


class CostModel:
    """Fleet-wide signal store; attach to a ViewManager to receive hooks."""

    def __init__(self, vm, clock: Callable[[], float] = time.monotonic, use_panel: bool = True):
        self.vm = vm
        self._clock = clock
        # cost seeds of views not seen yet (pin_costs sets them)
        self.default_refresh_s = DEFAULT_REFRESH_S
        self.default_maintain_s = DEFAULT_MAINTAIN_S
        self.frozen = False  # pin_costs: ignore observed wall times
        # False keeps the per-view variance_comparison snapshot loop (the
        # fleet panel's parity reference)
        self.use_panel = bool(use_panel)
        self.stats: Dict[str, ViewCostStats] = {}
        # views whose feature rows were non-finite on the LAST features()
        # pass (sanitized + quarantined, see _sanitize)
        self.last_poisoned: List[str] = []

    def attach(self) -> "CostModel":
        self.vm.cost_model = self
        return self

    def _stat(self, name: str) -> ViewCostStats:
        st = self.stats.get(name)
        if st is None:
            mv = self.vm.views[name]
            # seed from the per-op timers ViewManager already records: a
            # view whose last timed op was a maintain must NOT price its
            # cleans at the full-maintenance cost
            r_seed = float(mv.refresh_s) if mv.refresh_s > 0 else 0.0
            m_seed = float(mv.ivm_s) if mv.ivm_s > 0 else 0.0
            refresh = r_seed or self.default_refresh_s
            st = ViewCostStats(
                refresh_s=refresh,
                maintain_s=(m_seed or r_seed * MAINTAIN_OVER_REFRESH_SEED
                            or self.default_maintain_s),
                retune_s=refresh * RETUNE_OVER_REFRESH_SEED,
                traffic=1.0,
                last_maintain_t=self._clock(),
            )
            self.stats[name] = st
        return st

    # -- observation hooks (fired by ViewManager) ----------------------------
    def _ewma(self, cur: float, obs: float) -> float:
        return (1.0 - ALPHA) * cur + ALPHA * obs

    def observe_refresh(self, name: str, dt: float) -> None:
        st = self._stat(name)
        if not self.frozen:
            st.refresh_s = self._ewma(st.refresh_s, float(dt))

    def observe_maintain(self, name: str, dt: float) -> None:
        st = self._stat(name)
        if not self.frozen:
            st.maintain_s = self._ewma(st.maintain_s, float(dt))
        st.last_maintain_t = self._clock()

    def observe_retune(self, name: str, dt: float) -> None:
        """A retune-then-clean's wall time prices FUTURE retunes, not plain
        cleans."""
        st = self._stat(name)
        if not self.frozen:
            st.retune_s = self._ewma(st.retune_s, float(dt))

    def observe_traffic(self, name: str, n_queries: int) -> None:
        self._stat(name).traffic += float(n_queries)

    def decay_traffic(self, factor: float) -> None:
        for st in self.stats.values():
            st.traffic *= factor

    def pin_costs(self, refresh_s: float, maintain_s: float,
                  retune_s: Optional[float] = None) -> None:
        """Fix every view's action prices; observed wall times stop moving the
        EWMAs.  ``retune_s`` defaults to refresh × RETUNE_OVER_REFRESH_SEED."""
        self.default_refresh_s = float(refresh_s)
        self.default_maintain_s = float(maintain_s)
        rt = (float(retune_s) if retune_s is not None
              else float(refresh_s) * RETUNE_OVER_REFRESH_SEED)
        for name in self.vm.views:
            st = self._stat(name)
            st.refresh_s = float(refresh_s)
            st.maintain_s = float(maintain_s)
            st.retune_s = rt
        self.frozen = True

    # -- moment snapshots ----------------------------------------------------
    def snapshot(self, name: str) -> ViewCostStats:
        """Refresh the §5.2.2 moment snapshot iff the samples moved (the
        per-view reference loop)."""
        mv = self.vm.views[name]
        st = self._stat(name)
        if st.snapshot_version == mv.sample_version:
            return st
        q = canonical_query(mv)
        cmp = variance_comparison(mv.clean_sample, mv.stale_sample, q, mv.m)
        w = _weights(mv.clean_sample, mv.m)
        valid = mv.clean_sample.valid
        zero = torch.zeros_like(w)
        n_hat = float(torch.where(valid, w, zero).sum())
        if q.col is not None:
            x = mv.clean_sample.col(q.col).to(torch.float32)
        else:
            x = torch.ones(valid.shape, dtype=torch.float32, device=valid.device)
        s1 = float(torch.where(valid, w * x, zero).sum())
        s2 = float(torch.where(valid, w * x * x, zero).sum())
        st.n_rows = n_hat
        st.mean = s1 / max(n_hat, 1.0)
        st.ex2 = s2 / max(n_hat, 1.0)
        st.ht_aqp = float(cmp["var_aqp"])
        st.ht_corr = float(cmp["var_corr"])
        st.snapshot_version = mv.sample_version
        return st

    # -- the stacked feature panel ------------------------------------------
    def age_s(self, name: str) -> float:
        # clamped: a rewound clock must not produce negative ages
        return max(0.0, self._clock() - self._stat(name).last_maintain_t)

    def features(self, names: Optional[Sequence[str]] = None) -> np.ndarray:
        """(V, N_FEATURES) f32 panel for kernels/fleet_score, view order =
        ``names`` (default: registration order)."""
        names = list(names) if names is not None else list(self.vm.views)
        now = self._clock()
        out = np.zeros((len(names), N_FEATURES), np.float32)
        if self.use_panel and names:
            mom = self.vm.fleet_panel().moments(names)
            for i, name in enumerate(names):
                st = self._stat(name)
                n_hat = float(mom[i, M_N])
                st.n_rows = n_hat
                st.mean = float(mom[i, M_S1]) / max(n_hat, 1.0)
                st.ex2 = float(mom[i, M_S2]) / max(n_hat, 1.0)
                st.ht_aqp = float(mom[i, M_HT_AQP])
                st.ht_corr = float(mom[i, M_HT_CORR])
                st.snapshot_version = self.vm.views[name].sample_version
        else:
            for name in names:
                self.snapshot(name)
        for i, name in enumerate(names):
            st = self.stats[name]
            out[i, F_N] = st.n_rows
            out[i, F_EX2] = st.ex2
            out[i, F_MEAN] = st.mean
            out[i, F_HT_AQP] = st.ht_aqp
            out[i, F_HT_CORR] = st.ht_corr
            out[i, F_DRIFT_CLEAN] = self.vm.drift_rows(name, since="clean")
            out[i, F_DRIFT_IVM] = self.vm.drift_rows(name, since="ivm")
            out[i, F_TRAFFIC] = st.traffic
            out[i, F_COST_CLEAN] = st.refresh_s
            out[i, F_COST_MAINTAIN] = st.maintain_s
            out[i, F_COST_RETUNE] = st.retune_s
            out[i, F_AGE] = max(0.0, now - st.last_maintain_t)
            out[i, F_M] = self.vm.views[name].m
        fault_plan = getattr(self.vm, "fault_plan", None)
        if fault_plan is not None:  # the nan_panel chaos hook, before the sanitizer
            out = fault_plan.poison_features(names, out)
        self.last_poisoned = self._sanitize(names, out)
        return out

    def _sanitize(self, names: Sequence[str], out: np.ndarray) -> List[str]:
        """A non-finite feature row must not crash the epoch or feed garbage
        to the knapsack: it becomes a neutral serve-stale row (zero drift,
        traffic and moments; EWMA costs kept), the view is quarantined, and
        its cached snapshot is dropped."""
        bad = np.flatnonzero(~np.all(np.isfinite(out), axis=1))
        poisoned: List[str] = []
        for i in bad:
            name = names[i]
            st = self._stat(name)
            row = np.zeros(N_FEATURES, np.float32)
            row[F_COST_CLEAN] = st.refresh_s
            row[F_COST_MAINTAIN] = st.maintain_s
            row[F_COST_RETUNE] = st.retune_s
            row[F_M] = self.vm.views[name].m
            out[i] = row
            st.snapshot_version = -1
            for fld in ("n_rows", "ex2", "mean", "ht_aqp", "ht_corr"):
                if not np.isfinite(getattr(st, fld)):
                    setattr(st, fld, 0.0)
            poisoned.append(name)
            self.vm.health.record_failure(name, ValueError("non-finite planner features"))
        return poisoned
