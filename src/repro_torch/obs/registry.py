"""MetricsRegistry: one typed instrument store for the SVC pipeline.

A pure-Python copy of ``repro.obs.registry`` (the port imports nothing of
the JAX package).  Three instruments:

  * **Counter**   — monotone non-decreasing float (``inc``); a decrease
    raises.
  * **Gauge**     — last-write-wins float (``set``/``inc``).
  * **Histogram** — streaming count/sum/min/max/last of observations.

Instruments are interned by ``(name, sorted(labels))``, so
``registry.counter("cache_hits", view="v3")`` returns the same object on
every call.  Names follow ``<subsystem>_<noun>[_<unit>]`` with labels for
the dimension that varies (``view=``, ``tenant=``, ``base=``).

``counter_attr`` keeps plain attribute APIs: a class declares
``hits = counter_attr()`` and binds ``self._c_hits`` to a registry counter;
``obj.hits`` reads as an int and ``obj.hits += 1`` routes the delta
through the counter (a decrease raises).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


class Counter:
    """Monotone non-decreasing counter."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelKey):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(
                f"counter {self.name}{dict(self.labels)} cannot decrease "
                f"(inc {n})"
            )
        self.value += n


class Gauge:
    """Last-write-wins level."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: LabelKey):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Streaming moments of observations (count / sum / min / max / last)."""

    __slots__ = ("name", "labels", "count", "sum", "min", "max", "last")

    def __init__(self, name: str, labels: LabelKey):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.last = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if v < self.min else self.min
        self.max = v if v > self.max else self.max
        self.last = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Interned counters/gauges/histograms with label sets."""

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._instruments: Dict[Tuple[str, str, LabelKey], object] = {}

    def _intern(self, kind: str, cls, name: str, labels: Dict[str, str]):
        key = (kind, name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        inst = self._instruments.get(key)
        if inst is None:
            other = next(
                (k[0] for k in self._instruments if k[1] == name and k[0] != kind),
                None,
            )
            if other is not None:
                raise TypeError(
                    f"metric {name!r} already registered as a {other}"
                )
            inst = cls(name, key[2])
            self._instruments[key] = inst
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._intern("counter", Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._intern("gauge", Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._intern("histogram", Histogram, name, labels)

    def now(self) -> float:
        return self._clock()

    # -- export ---------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Flat JSON-serializable dump: ``name{k=v,...}`` -> value(s)."""
        out: Dict[str, object] = {}
        for (kind, name, labels), inst in sorted(self._instruments.items()):
            key = name
            if labels:
                key += "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"
            if kind == "histogram":
                h = inst  # type: Histogram
                out[key] = {
                    "count": h.count,
                    "sum": h.sum,
                    "min": h.min if h.count else 0.0,
                    "max": h.max if h.count else 0.0,
                    "last": h.last,
                }
            else:
                out[key] = inst.value
        return out

    def total(self, name: str) -> float:
        """Sum of one metric's value across every label set."""
        return sum(
            inst.value
            for (kind, n, _), inst in self._instruments.items()
            if n == name and kind in ("counter", "gauge")
        )


class counter_attr:
    """Descriptor exposing a registry Counter as a bit-compatible int
    attribute.  The owning class declares ``hits = counter_attr()`` and
    binds ``self._c_hits = registry.counter(...)`` in ``__init__``; reads
    return ``int`` and ``obj.hits += n`` increments the counter (any
    decrease raises — counters are monotone)."""

    def __set_name__(self, owner, name):
        self._slot = "_c_" + name

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return int(getattr(obj, self._slot).value)

    def __set__(self, obj, value):
        c = getattr(obj, self._slot)
        c.inc(float(value) - c.value)


def get_global_registry() -> MetricsRegistry:
    """Fallback registry for instruments created outside a ViewManager
    (standalone caches/controllers in tests).  One per process."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = MetricsRegistry()
    return _GLOBAL


_GLOBAL: Optional[MetricsRegistry] = None
