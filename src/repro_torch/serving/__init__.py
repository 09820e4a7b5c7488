"""Serving plane: admission control and the staleness-keyed result cache."""

from repro_torch.serving.admission import (
    ADMIT,
    SHED,
    THROTTLE,
    AdmissionConfig,
    AdmissionController,
    TokenBucket,
)
from repro_torch.serving.result_cache import ResultCache, predicate_digest, query_key

__all__ = [
    "ADMIT",
    "SHED",
    "THROTTLE",
    "AdmissionConfig",
    "AdmissionController",
    "ResultCache",
    "TokenBucket",
    "predicate_digest",
    "query_key",
]
