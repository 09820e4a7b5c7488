"""Fleet scoring: stack the cost-model features, score in ONE launch.

The per-view feature gather (counter reads + lazily refreshed moment
snapshots) stacks into a (V, N_FEATURES) numpy panel, and
kernels/fleet_score prices every (view, action) candidate at once on the
manager's device: on a card one launch reads the panel from mapped host
memory and writes the scores there (``fleet_scores_host``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.kernels.fleet_score import (
    A_CLEAN,
    A_MAINTAIN,
    A_RETUNE,
    A_SKIP,
    CORR_WINS,
    REC_M,
    fleet_scores_host,
)
from repro_torch.planner.costs import CostModel


@dataclasses.dataclass
class FleetScores:
    """Host-side view of one scoring pass, in fleet order."""

    names: List[str]
    features: np.ndarray  # (V, N_FEATURES) f32, the scorer's exact input
    scores: np.ndarray    # (V, N_SCORES) f32

    def score(self, name: str, action: str) -> float:
        """View ``name``'s score for ``action``: skip, clean, maintain or retune."""
        i = self.names.index(name)
        col = {"skip": A_SKIP, "clean": A_CLEAN, "maintain": A_MAINTAIN,
               "retune": A_RETUNE}[action]
        return float(self.scores[i, col])

    def corr_wins(self) -> Dict[str, bool]:
        """Per-view §5.2.2 estimator flip (CORR while ht_corr ≤ ht_aqp)."""
        return {n: bool(self.scores[i, CORR_WINS] > 0.5) for i, n in enumerate(self.names)}

    def recommended_m(self) -> Dict[str, float]:
        """Per-view sampling-ratio recommendation (REC_M)."""
        return {n: float(self.scores[i, REC_M]) for i, n in enumerate(self.names)}


def score_fleet(cost_model: CostModel, names: Optional[Sequence[str]] = None) -> FleetScores:
    """Gather features and price the whole fleet in one launch."""
    names = list(names) if names is not None else list(cost_model.vm.views)
    feats = cost_model.features(names)
    return FleetScores(names=names, features=feats,
                       scores=fleet_scores_host(feats, cost_model.vm.device))
