"""repro_torch.obs — the staleness observatory.

``registry`` holds typed counters, gauges and histograms with label sets;
the streaming and serving counters (``DeltaLog``, ``ResultCache``,
``AdmissionController``, ``StreamingViewService``) and
``ViewManager.fleet_merge_failures`` are ``counter_attr`` views over the
manager's registry.  ``trace`` records the streaming epoch, the planner
epoch (snapshot → schedule → act → clean/merge/maintain) and the query
path (query → admit → cache → refresh → estimate) as nested spans.
``kprof`` profiles every kernel wrapper's dispatch (compile vs execute
wall, dispatch and fallback counts, occupancy), toggled through
``repro_torch.kernels.set_profiler``.
``opcount`` marks the loops the dry run's analysis counts once and
multiplies (``launch.op_analysis``).

``reconcile`` closes the loop: an exported trace is checked against the
pipeline's own end-state counters (every offered batch, query verdict,
and fault/quarantine event must be accounted for).  Surfacing:
``ServeEngine.dashboard("observatory")`` (``observatory_panel``) and
``export_service_trace``.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.obs import trace
from repro_torch.obs.kprof import KernelProfiler, get_profiler, profiled, set_profiler
from repro_torch.obs.reconcile import load_jsonl, reconcile
from repro_torch.obs.registry import Counter, Gauge, Histogram, MetricsRegistry, counter_attr
from repro_torch.obs.trace import Tracer, event, get_tracer, set_tracer, span

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "KernelProfiler",
    "MetricsRegistry",
    "Tracer",
    "counter_attr",
    "event",
    "export_service_trace",
    "get_profiler",
    "get_tracer",
    "load_jsonl",
    "observatory_panel",
    "profiled",
    "reconcile",
    "set_profiler",
    "set_tracer",
    "span",
    "trace",
]


def export_service_trace(svc, path: str, extra_meta: Optional[Dict] = None) -> int:
    """Export the installed tracer's ring as JSONL with the reconciliation
    anchors a ``StreamingViewService`` can vouch for: the metrics
    snapshot, per-base still-pending seqs, the FaultPlan injection count,
    and the FleetHealth failure count.  Returns records written."""
    tracer = trace.get_tracer()
    if tracer is None:
        raise RuntimeError("no tracer installed (repro_torch.obs.trace.enable())")
    vm = svc.vm
    meta: Dict = {
        "metrics": vm.metrics.snapshot(),
        "pending": {b: log.pending_seqs() for b, log in svc.logs.items()},
        "quarantines": sum(h.failures for h in vm.health.views.values()),
    }
    fault_plan = getattr(vm, "fault_plan", None)
    if fault_plan is not None:
        meta["faults_injected"] = len(fault_plan.injected)
    if extra_meta:
        meta.update(extra_meta)
    return tracer.export_jsonl(path, meta=meta)


def observatory_panel(svc) -> Dict:
    """The ``dashboard("observatory")`` payload: the unified metrics
    snapshot, tracer state, kernel profile, and a live reconciliation of
    the admission ledger (admitted + throttled + shed == issued)."""
    vm = svc.vm
    tracer = trace.get_tracer()
    profiler = get_profiler()
    issued = vm.metrics.total("stream_queries")
    adm = svc.admission
    panel: Dict = {
        "metrics": vm.metrics.snapshot(),
        "trace": tracer.summary() if tracer is not None else {"enabled": False},
        "kernels": profiler.summary() if profiler is not None else None,
        "staleness": _staleness_dict(svc),
    }
    if adm is not None:
        verdicts = adm.admitted + adm.throttled + adm.shed
        panel["reconciliation"] = {"issued": int(issued), "verdicts": verdicts,
                                   "queries_ok": verdicts == int(issued)}
    else:
        panel["reconciliation"] = {"issued": int(issued), "verdicts": None,
                                   "queries_ok": True}
    return panel


def _staleness_dict(svc) -> Dict:
    import dataclasses

    st = svc.staleness()
    out = dataclasses.asdict(st)
    out["per_base"] = {b: dataclasses.asdict(bs) for b, bs in st.per_base.items()}
    return out
