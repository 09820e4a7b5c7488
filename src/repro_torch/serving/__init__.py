"""Serving plane: admission control, the staleness-keyed result cache, and the
LM serving engine with SVC telemetry."""

from repro_torch.serving.admission import (
    ADMIT,
    SHED,
    THROTTLE,
    AdmissionConfig,
    AdmissionController,
    TokenBucket,
)
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.result_cache import ResultCache, predicate_digest, query_key

__all__ = [
    "ADMIT",
    "SHED",
    "THROTTLE",
    "AdmissionConfig",
    "AdmissionController",
    "Request",
    "ResultCache",
    "ServeEngine",
    "TokenBucket",
    "predicate_digest",
    "query_key",
]
