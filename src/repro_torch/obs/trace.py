"""Span tracer: a causally ordered record of the SVC pipeline.

A pure-Python copy of ``repro.obs.trace``.  Spans carry explicit parent
ids, so the streaming epoch (epoch → drain) and the query path (query →
admit → cache → refresh) nest:

    with trace.span("epoch", refresh=n) as sp:
        with trace.span("drain", base=b):
            ...
        sp.set(total_s=total)          # attributes can land after the fact
    trace.event("shed", base=b, seqs=[...])  # zero-duration, parented

Disabled (the default), the module-level ``span()``/``event()`` are a
None check returning a shared no-op.  Retention is a bounded ring
(``capacity`` completed records, oldest evicted, counted in ``dropped``);
``export_jsonl`` writes one record per line after a ``meta`` header.  The
clock is injectable, so a run on a fake clock gets deterministic
timestamps.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, Dict, List, Optional

KIND_SPAN = "span"
KIND_EVENT = "event"


class Span:
    """One open span; records itself into the tracer ring on exit."""

    __slots__ = ("_tracer", "name", "attrs", "span_id", "parent_id",
                 "t0", "t1")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict,
                 span_id: int, parent_id: Optional[int], t0: float):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = span_id
        self.parent_id = parent_id
        self.t0 = t0
        self.t1: Optional[float] = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self._tracer._close(self)
        return False


class _NoopSpan:
    """Shared do-nothing span for the disabled path."""

    __slots__ = ()

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Ring-buffered span/event recorder with an injectable clock."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 capacity: int = 65536):
        self._clock = clock
        self.capacity = int(capacity)
        self.records: deque = deque(maxlen=self.capacity)
        self._stack: List[Span] = []
        self._next_id = 1
        self.dropped = 0  # completed records evicted by the ring bound

    # -- recording ------------------------------------------------------------
    def span(self, name: str, **attrs) -> Span:
        parent = self._stack[-1].span_id if self._stack else None
        sp = Span(self, name, attrs, self._next_id, parent, self._clock())
        self._next_id += 1
        self._stack.append(sp)
        return sp

    def event(self, name: str, **attrs) -> None:
        parent = self._stack[-1].span_id if self._stack else None
        self._append({
            "kind": KIND_EVENT,
            "name": name,
            "id": self._next_id,
            "parent": parent,
            "t0": self._clock(),
            "attrs": attrs,
        })
        self._next_id += 1

    def _close(self, sp: Span) -> None:
        sp.t1 = self._clock()
        # tolerate mis-nested exits (an exception unwinding several spans):
        # pop through the stack until this span is gone
        while self._stack:
            top = self._stack.pop()
            if top is sp:
                break
        self._append({
            "kind": KIND_SPAN,
            "name": sp.name,
            "id": sp.span_id,
            "parent": sp.parent_id,
            "t0": sp.t0,
            "t1": sp.t1,
            "dur_s": max(0.0, sp.t1 - sp.t0),
            "attrs": sp.attrs,
        })

    def _append(self, rec: Dict) -> None:
        if len(self.records) == self.capacity:
            self.dropped += 1
        self.records.append(rec)

    # -- inspection / export --------------------------------------------------
    def __len__(self) -> int:
        return len(self.records)

    def drain(self) -> List[Dict]:
        out = list(self.records)
        self.records.clear()
        return out

    def summary(self) -> Dict:
        spans = sum(1 for r in self.records if r["kind"] == KIND_SPAN)
        return {
            "enabled": True,
            "records": len(self.records),
            "spans": spans,
            "events": len(self.records) - spans,
            "dropped": self.dropped,
            "open_spans": len(self._stack),
        }

    def export_jsonl(self, path: str, meta: Optional[Dict] = None) -> int:
        """Write the ring as JSONL: one ``meta`` header line (metrics
        snapshot, harness end-state — the reconciliation anchors) followed
        by one line per record.  Returns records written."""
        records = sorted(self.records, key=lambda r: r["id"])
        with open(path, "w") as f:
            header = {"kind": "meta", "dropped": self.dropped,
                      "records": len(records)}
            if meta:
                header.update(meta)
            f.write(json.dumps(header, default=str) + "\n")
            for rec in records:
                f.write(json.dumps(rec, default=str) + "\n")
        return len(records)


_TRACER: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    global _TRACER
    _TRACER = tracer
    return tracer


def enable(clock: Callable[[], float] = time.perf_counter,
           capacity: int = 65536) -> Tracer:
    """Install (and return) a fresh process-wide tracer."""
    return set_tracer(Tracer(clock=clock, capacity=capacity))


def disable() -> None:
    set_tracer(None)


def span(name: str, **attrs):
    """Open a span on the installed tracer; a shared no-op when disabled."""
    t = _TRACER
    if t is None:
        return NOOP_SPAN
    return t.span(name, **attrs)


def event(name: str, **attrs) -> None:
    """Record a zero-duration event parented to the current span."""
    t = _TRACER
    if t is not None:
        t.event(name, **attrs)
