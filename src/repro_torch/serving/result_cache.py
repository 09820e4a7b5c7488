"""Staleness-keyed result cache: invalidation for free via sample_version.

A cache-aside layer for the serving plane's answers.  The key is

    (view, ManagedView.sample_version, predicate digest)

so invalidation costs nothing: ``svc_refresh``, ``maintain`` and a ratio
retune bump ``sample_version`` whenever either sample moves, which strands
every entry of the old window.  Between bumps the estimators are
deterministic, so a hit returns the very ``Estimate`` the recompute would
give (the same object, launching no kernel).

The predicate digest folds the answer-shaping signature (the frozen
``Query``, confidence, estimator preference) through
``core.hashing.key_digest``, memoized per signature.

Stale-version entries are kept: under overload the admission layer may
serve the latest stored version (``get_any``), widened and tagged.  Every
read validates the entry's own version against its key; a mismatch is
refused with accounting (``poison_rejected``), never served.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.estimators import Estimate, Query
from repro_torch.obs.registry import MetricsRegistry, counter_attr


@functools.lru_cache(maxsize=8192)
def predicate_digest(signature: str) -> Tuple[int, int]:
    """64-bit (hi, lo) digest of a query signature string via
    ``core.hashing.key_digest``: each uint32 word of the UTF-8 bytes is one
    key column of a single-row composite key, folded on the CPU.  Memoized
    per signature, so the per-request cost is a dict lookup."""
    import torch

    from repro_torch.core import hashing

    raw = signature.encode("utf-8")
    pad = (-len(raw)) % 4
    words = np.frombuffer(raw + b"\0" * pad, dtype=np.uint32).astype(np.int64)
    # the word count itself is a column: "a" and "a\0\0\0\0" must differ
    cols = [torch.tensor([len(raw)], dtype=torch.int64)]
    cols += [torch.from_numpy(words[i:i + 1].copy()) for i in range(words.shape[0])]
    hi, lo = hashing.key_digest(cols)
    return int(hi[0]), int(lo[0])


def query_key(q: Query, confidence: float,
              prefer: Optional[str]) -> Optional[Tuple[int, int]]:
    """Digest for one query, or None when the answer is not cacheable.

    Only the CLT sample-mean class caches: sum/count/avg answers are pure
    functions of (samples, query, confidence, prefer).  Bootstrap
    (median/percentile) answers depend on a caller-held random generator and
    min/max on exceedance machinery — both stay on the compute path."""
    if q.agg not in ("sum", "count", "avg"):
        return None
    # the last slot is the JAX package's engine flag, which the port's
    # query_batch does not take: None keeps the digests equal to JAX's
    return predicate_digest(repr((q, float(confidence), prefer, None)))


@dataclasses.dataclass
class CacheEntry:
    view: str
    version: int  # the sample_version the estimate was computed at
    digest: Tuple[int, int]
    estimate: Estimate


class ResultCache:
    """Bounded LRU of query answers keyed on (view, sample_version, digest).

    Cache-aside: the serving layer looks up, computes misses, and ``put``s.
    ``get`` demands an exact version match (bit-equal serving); ``get_any``
    returns the latest stored version for (view, digest) regardless of
    staleness — the overload path's serve-stale source.  Both validate the
    entry's self-described version against its key and reject mismatches
    (``poison_rejected``): a poisoned entry costs one recompute, never a
    wrong answer."""

    hits = counter_attr()
    misses = counter_attr()
    stale_hits = counter_attr()  # get_any answers served from an older version
    evictions = counter_attr()
    puts = counter_attr()
    poison_rejected = counter_attr()  # version-mismatched entries refused

    def __init__(self, capacity: int = 256,
                 registry: Optional[MetricsRegistry] = None):
        self.capacity = int(capacity)
        self._entries: "OrderedDict[Tuple[str, int, Tuple[int, int]], CacheEntry]" = OrderedDict()
        # (view, digest) -> newest stored version (the serve-stale index)
        self._latest: Dict[Tuple[str, Tuple[int, int]], int] = {}
        # counters are bit-compatible views over a repro_torch.obs registry (pass
        # the service-wide one to correlate with the rest of the plane)
        self.metrics = registry or MetricsRegistry()
        self._c_hits = self.metrics.counter("cache_hits")
        self._c_misses = self.metrics.counter("cache_misses")
        self._c_stale_hits = self.metrics.counter("cache_stale_hits")
        self._c_evictions = self.metrics.counter("cache_evictions")
        self._c_puts = self.metrics.counter("cache_puts")
        self._c_poison_rejected = self.metrics.counter("cache_poison_rejected")

    def __len__(self) -> int:
        return len(self._entries)

    def _validated(self, key, entry: Optional[CacheEntry]) -> Optional[CacheEntry]:
        if entry is None:
            return None
        if entry.view != key[0] or entry.version != key[1] or entry.digest != key[2]:
            # a wrong-version (poisoned / corrupted) entry: evict + refuse
            self._entries.pop(key, None)
            if self._latest.get((key[0], key[2])) == key[1]:
                self._latest.pop((key[0], key[2]), None)
            self.poison_rejected += 1
            return None
        return entry

    # -- cache-aside API -----------------------------------------------------
    def get(self, view: str, version: int,
            digest: Tuple[int, int]) -> Optional[Estimate]:
        """Exact-version lookup: the bit-equal fast path."""
        key = (view, int(version), digest)
        entry = self._validated(key, self._entries.get(key))
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry.estimate

    def get_any(self, view: str,
                digest: Tuple[int, int]) -> Optional[Tuple[Estimate, int]]:
        """Latest stored version for (view, digest), any staleness: the
        overload serve-stale source.  Returns (estimate, version) or None;
        counts as a ``stale_hit`` (the caller widens + tags the answer)."""
        v = self._latest.get((view, digest))
        if v is None:
            return None
        key = (view, v, digest)
        entry = self._validated(key, self._entries.get(key))
        if entry is None:
            return None
        self._entries.move_to_end(key)
        self.stale_hits += 1
        return entry.estimate, v

    def put(self, view: str, version: int, digest: Tuple[int, int],
            estimate: Estimate) -> None:
        key = (view, int(version), digest)
        self._entries[key] = CacheEntry(view, int(version), digest, estimate)
        self._entries.move_to_end(key)
        self.puts += 1
        latest_key = (view, digest)
        if version >= self._latest.get(latest_key, -1):
            self._latest[latest_key] = int(version)
        while len(self._entries) > self.capacity:
            old_key, _ = self._entries.popitem(last=False)
            self.evictions += 1
            if self._latest.get((old_key[0], old_key[2])) == old_key[1]:
                self._latest.pop((old_key[0], old_key[2]), None)

    # -- chaos hook ----------------------------------------------------------
    def poison(self, view: str) -> int:
        """The ``cache_poison`` fault: tamper every stored entry of ``view``
        so its self-described version no longer matches its key — the shape
        a buggy writer or a torn update would leave behind.  Read
        validation must reject every tampered entry (counted in
        ``poison_rejected``); returns how many entries were tampered."""
        n = 0
        for key, entry in self._entries.items():
            if key[0] == view:
                entry.version = entry.version - 1
                n += 1
        return n

    def stats(self) -> Dict[str, int]:
        return {
            "size": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "stale_hits": self.stale_hits,
            "puts": self.puts,
            "evictions": self.evictions,
            "poison_rejected": self.poison_rejected,
        }
