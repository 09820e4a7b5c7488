"""repro_torch.obs — the metrics registry and the span tracer.

``registry`` holds typed counters, gauges and histograms with label sets;
the streaming and serving counters (``DeltaLog``, ``ResultCache``,
``AdmissionController``, ``StreamingViewService``) and
``ViewManager.fleet_merge_failures`` are ``counter_attr`` views over the
manager's registry.  ``trace`` records the streaming epoch and the query
path as nested spans.
"""

from repro_torch.obs import trace
from repro_torch.obs.registry import Counter, Gauge, Histogram, MetricsRegistry, counter_attr
from repro_torch.obs.trace import Tracer, event, get_tracer, set_tracer, span

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Tracer",
    "counter_attr",
    "event",
    "get_tracer",
    "set_tracer",
    "span",
    "trace",
]
