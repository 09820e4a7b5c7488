"""Fleet scorer: one launch prices every (view, action) pair."""

from repro_torch.kernels.fleet_score.ops import (
    fleet_scores,
    fleet_scores_host,
    fleet_scores_sharded,
    fleet_scores_sharded_host,
)
from repro_torch.kernels.fleet_score.ref import (
    A_CLEAN,
    A_MAINTAIN,
    A_RETUNE,
    A_SKIP,
    CORR_WINS,
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
    M_MAX,
    M_MIN,
    M_REL_HI,
    M_REL_LO,
    M_STEP,
    N_FEATURES,
    N_SCORES,
    REC_M,
    fleet_score_ref,
)

__all__ = [
    "A_CLEAN", "A_MAINTAIN", "A_RETUNE", "A_SKIP", "CORR_WINS",
    "F_AGE", "F_COST_CLEAN", "F_COST_MAINTAIN", "F_COST_RETUNE", "F_DRIFT_CLEAN",
    "F_DRIFT_IVM", "F_EX2", "F_HT_AQP", "F_HT_CORR", "F_M", "F_MEAN", "F_N", "F_TRAFFIC",
    "M_MAX", "M_MIN", "M_REL_HI", "M_REL_LO", "M_STEP", "N_FEATURES", "N_SCORES", "REC_M",
    "fleet_score_ref", "fleet_scores", "fleet_scores_host", "fleet_scores_sharded",
    "fleet_scores_sharded_host",
]
