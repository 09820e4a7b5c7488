"""Batched query engine (multi-query SVC estimation) on torch."""

from repro_torch.query.batch import (
    SAMPLE_MEAN_AGGS,
    QueryBatch,
    UnsupportedQueryError,
    is_encodable,
    lower_pred,
)
from repro_torch.query.engine import (
    CorrespondenceCache,
    build_correspondence_cache,
    exact_batch,
    run_batch,
    run_batch_aqp,
    sample_columns,
    sample_panel,
    variance_report,
)

__all__ = [
    "SAMPLE_MEAN_AGGS",
    "QueryBatch",
    "UnsupportedQueryError",
    "is_encodable",
    "lower_pred",
    "CorrespondenceCache",
    "build_correspondence_cache",
    "exact_batch",
    "run_batch",
    "run_batch_aqp",
    "sample_columns",
    "sample_panel",
    "variance_report",
]
