"""SVC core: hashing, push-down, cleaning, outlier indexing, estimation."""

from repro_torch.core import hashing
from repro_torch.core.estimators import Estimate, Query, exact, svc_aqp, svc_corr, variance_comparison
from repro_torch.core.maintenance import (
    DeltaSet,
    ViewDef,
    change_table_strategy,
    clean_sample,
    cleaning_plan,
    full_maintenance,
    upsert,
    delete_keys,
)
from repro_torch.core.pushdown import push_down, fully_pushed, pushdown_report
from repro_torch.core.outliers import (
    OutlierIndex,
    apply_hash_with_outliers,
    build_outlier_index,
    propagate_outlier_keys,
    update_outlier_index,
)
