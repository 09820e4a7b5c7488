"""Kernel profiling hooks: per-op compile/execute split + occupancy.

Every kernel wrapper of ``repro_torch.kernels`` (the ``ops.py`` of each
kernel) routes its launch through ``profiled(op, fn, *args, ...)``, under
the JAX package's op name where it has one.  With no profiler installed
(the default) that is one global read and a tail call.  With a profiler
installed (``set_profiler(KernelProfiler())``) each dispatch records:

  * **compile vs execute time** — the first call per ``(op, shape key)``
    (each tensor's shape and dtype, inside tuples and lists too) is
    charged to ``compile_s``, repeat calls to ``execute_s``, as in the JAX
    package.  The port compiles no kernel per shape, but the first launch
    of a process builds ``libsvc_kernels.so`` (``kernels/_build.py``:
    ``nvcc`` on every ``csrc/*.cu``), and that build lands in the first
    op's ``compile_s``: it is the port's compile.  Every CUDA device that
    holds a tensor of the output is synchronized before the clock stops
    (where JAX calls ``block_until_ready``), so a profiled dispatch is
    timed to completion at the cost of serializing the stream — the cost
    of opting in.  A CPU output needs no synchronize.
  * **dispatch counts** and **fallback takes** — ``fallback`` means the
    wrapper took its plain PyTorch version (``ref.py``), which it does only
    for CPU tensors; a dispatch on the card never sets it.
  * **padded-vs-real row occupancy** — the port's wrappers launch over
    exactly the rows they are given and pad nothing, so they pass
    ``padded = rows`` and occupancy reads 1.0 (JAX's Pallas wrappers pad
    to their block multiples and read less).
  * **per-shard attribution** — a dispatch that passes ``shards=[...]``
    with per-shard row splits, or runs inside ``shard_scope(s)``, also
    lands in a per-shard ledger whose sums must equal the fleet totals
    (``obs.reconcile.check_shard_accounting``).

``repro_torch.kernels`` re-exports ``set_profiler``/``get_profiler``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional, Sequence, Set, Tuple


class OpStats:
    """Accumulated profile of one kernel op."""

    __slots__ = ("dispatches", "fallbacks", "compiles", "compile_s",
                 "execute_s", "rows_real", "rows_padded")

    def __init__(self):
        self.dispatches = 0
        self.fallbacks = 0
        self.compiles = 0
        self.compile_s = 0.0
        self.execute_s = 0.0
        self.rows_real = 0
        self.rows_padded = 0

    @property
    def occupancy(self) -> float:
        """Real rows / padded rows across every dispatch (1.0 = no waste)."""
        return self.rows_real / self.rows_padded if self.rows_padded else 1.0

    def to_dict(self) -> Dict:
        return {
            "dispatches": self.dispatches,
            "fallbacks": self.fallbacks,
            "compiles": self.compiles,
            "compile_s": self.compile_s,
            "execute_s": self.execute_s,
            "rows_real": self.rows_real,
            "rows_padded": self.rows_padded,
            "occupancy": self.occupancy,
        }


def _sync_outputs(out) -> None:
    """Synchronize every CUDA device that holds a tensor of ``out``
    (tensors inside tuples, lists and dicts included); nothing for CPU
    tensors or non-tensors."""
    devices = set()
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        else:
            dev = getattr(x, "device", None)
            if dev is not None and getattr(dev, "type", None) == "cuda":
                devices.add(dev)
    if devices:
        import torch

        for dev in devices:
            torch.cuda.synchronize(dev)


class KernelProfiler:
    """Per-op dispatch recorder with an injectable wall clock."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self._clock = clock
        self.ops: Dict[str, OpStats] = {}
        self._seen: Set[Tuple[str, Tuple]] = set()
        # per-shard ledger: only dispatches that carried shard attribution
        # land here, mirrored by ``fleet_ops`` at the op level so the two
        # sides reconcile exactly (check_shard_accounting)
        self.shard_ops: Dict[Tuple[str, int], OpStats] = {}
        self.fleet_ops: Dict[str, OpStats] = {}

    def _stat(self, op: str) -> OpStats:
        st = self.ops.get(op)
        if st is None:
            st = self.ops[op] = OpStats()
        return st

    def _shard_stat(self, op: str, shard: int) -> OpStats:
        st = self.shard_ops.get((op, shard))
        if st is None:
            st = self.shard_ops[(op, shard)] = OpStats()
        return st

    def _fleet_stat(self, op: str) -> OpStats:
        st = self.fleet_ops.get(op)
        if st is None:
            st = self.fleet_ops[op] = OpStats()
        return st

    @staticmethod
    def _shape_key(args, kwargs) -> Tuple:
        def one(a):
            if isinstance(a, (tuple, list)):
                return ("seq", tuple(one(x) for x in a))
            shape = getattr(a, "shape", None)
            if shape is not None:
                return ("arr", tuple(shape), str(getattr(a, "dtype", "")))
            return ("val", a if isinstance(a, (int, float, str, bool, type(None)))
                    else type(a).__name__)

        return (tuple(one(a) for a in args),
                tuple((k, one(v)) for k, v in sorted(kwargs.items())))

    def call(self, op: str, fn: Callable, *args, fallback: bool = False,
             rows: Optional[int] = None, padded: Optional[int] = None,
             shards: Optional[Sequence[int]] = None,
             shard_rows: Optional[Sequence[int]] = None,
             shard_padded: Optional[Sequence[int]] = None,
             **kwargs):
        """Run ``fn(*args, **kwargs)`` under the profile: times the call
        (synchronized to completion), classifies it compile vs execute by
        shape novelty, and accrues occupancy.

        ``shards`` fans ONE dispatch out across shards: per-shard counters
        accrue from ``shard_rows`` / ``shard_padded`` (wall time splits
        evenly).  Without ``shards``, an ambient ``shard_scope``
        attributes the whole dispatch to the scoped shard."""
        st = self._stat(op)
        st.dispatches += 1
        if fallback:
            st.fallbacks += 1
        if rows is not None:
            st.rows_real += int(rows)
            st.rows_padded += int(padded if padded is not None else rows)
        key = (op, self._shape_key(args, kwargs))
        first = key not in self._seen
        self._seen.add(key)
        t0 = self._clock()
        out = fn(*args, **kwargs)
        _sync_outputs(out)
        dt = self._clock() - t0
        if first:
            st.compiles += 1
            st.compile_s += dt
        else:
            st.execute_s += dt
        self._attribute(op, shards, shard_rows, shard_padded, rows, padded,
                        dt, first, fallback)
        return out

    def _attribute(self, op: str, shards, shard_rows, shard_padded,
                   rows, padded, dt: float, first: bool,
                   fallback: bool) -> None:
        """Mirror one dispatch into the per-shard + fleet ledgers."""
        if shards is None:
            ambient = _SHARD_SCOPE
            if ambient is None:
                return
            shards = (ambient,)
            shard_rows = (rows,) if rows is not None else None
            shard_padded = (padded,) if padded is not None else None
        shards = list(shards)
        if not shards:
            return
        fl = self._fleet_stat(op)
        fl.dispatches += 1
        if fallback:
            fl.fallbacks += 1
        if first:
            fl.compiles += 1
            fl.compile_s += dt
        else:
            fl.execute_s += dt
        if rows is not None:
            fl.rows_real += int(rows)
            fl.rows_padded += int(padded if padded is not None else rows)
        share = dt / len(shards)
        for i, shard in enumerate(shards):
            ss = self._shard_stat(op, int(shard))
            ss.dispatches += 1
            if fallback:
                ss.fallbacks += 1
            if first:
                ss.compiles += 1
                ss.compile_s += share
            else:
                ss.execute_s += share
            if shard_rows is not None and shard_rows[i] is not None:
                sr = int(shard_rows[i])
                sp = int(shard_padded[i]) if (
                    shard_padded is not None and shard_padded[i] is not None
                ) else sr
                ss.rows_real += sr
                ss.rows_padded += sp

    def summary(self) -> Dict[str, Dict]:
        return {op: st.to_dict() for op, st in sorted(self.ops.items())}

    def shard_summary(self) -> Dict[str, Dict]:
        """The per-shard ledger and its op-level fleet mirror:
        ``{"fleet": {op: stats}, "shards": {op: {shard: stats}}}`` —
        exactly what ``obs.reconcile.check_shard_accounting`` consumes."""
        shards: Dict[str, Dict[int, Dict]] = {}
        for (op, shard), st in sorted(self.shard_ops.items()):
            shards.setdefault(op, {})[shard] = st.to_dict()
        return {
            "fleet": {op: st.to_dict()
                      for op, st in sorted(self.fleet_ops.items())},
            "shards": shards,
        }


_PROFILER: Optional[KernelProfiler] = None
_SHARD_SCOPE: Optional[int] = None


def get_profiler() -> Optional[KernelProfiler]:
    return _PROFILER


def set_profiler(profiler: Optional[KernelProfiler]) -> Optional[KernelProfiler]:
    global _PROFILER
    _PROFILER = profiler
    return profiler


@contextlib.contextmanager
def shard_scope(shard: Optional[int]):
    """Ambient per-shard attribution: every profiled dispatch inside the
    scope lands in the installed profiler's shard ledger under ``shard``.
    Scopes nest; ``None`` clears attribution inside an outer scope."""
    global _SHARD_SCOPE
    prev = _SHARD_SCOPE
    _SHARD_SCOPE = shard if shard is None else int(shard)
    try:
        yield
    finally:
        _SHARD_SCOPE = prev


def current_shard() -> Optional[int]:
    return _SHARD_SCOPE


def profiled(op: str, fn: Callable, *args, fallback: bool = False,
             rows: Optional[int] = None, padded: Optional[int] = None,
             shards: Optional[Sequence[int]] = None,
             shard_rows: Optional[Sequence[int]] = None,
             shard_padded: Optional[Sequence[int]] = None,
             **kwargs):
    """The wrappers' dispatch hook: tail-calls ``fn`` when no profiler is
    installed, else records the dispatch through it."""
    prof = _PROFILER
    if prof is None:
        return fn(*args, **kwargs)
    return prof.call(op, fn, *args, fallback=fallback, rows=rows,
                     padded=padded, shards=shards, shard_rows=shard_rows,
                     shard_padded=shard_padded, **kwargs)
