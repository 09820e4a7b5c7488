"""Trace reconciliation: prove the causal record is complete.

A trace you cannot cross-check is a story, not a record.  These checks
tie the exported span/event stream back to the pipeline's own end-state
counters so every offered batch, query verdict, and fault/quarantine
event is accounted for:

  * **parentage** — every record's parent id resolves to a span in the
    file, and a child span's interval sits inside its parent's.
  * **batch accounting** — per base relation, the set of accepted offer
    seqs equals drained ⊎ shed ⊎ spill-absorbed ⊎ still-pending (the
    DeltaLog's structured events; a seq that appears nowhere is a
    silently dropped batch, a seq that appears from nowhere is phantom).
  * **verdict accounting** — Σ query-span ``n`` equals the service's
    issued-query counter, and the per-verdict sums equal the admission
    controller's admitted/throttled/shed counters.
  * **span accounting** — each ``act`` span's duration matches the sum of
    its direct children within tolerance (wall time cannot hide between
    spans).
  * **fault/quarantine accounting** — the trace carries exactly as many
    ``fault`` / ``quarantine`` events as the FaultPlan injection log and
    FleetHealth failure counters recorded.
  * **shard accounting** — per op, the kernel profiler's per-shard
    counter sums (rows, wall) equal the fleet totals of the
    shard-attributed dispatches: a shard-mapped dispatch counted once at
    the call site must fan out to per-shard ledgers that cover exactly
    its row count, no more and no less.

Each check returns a list of problem strings (empty = reconciled); the
``reconcile`` function aggregates them for the ``dashboard("observatory")``
panel and ``chip_smoke.py``'s chaos phases.  A pure-Python copy of
``repro.obs.reconcile``: the same records give the same problems.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

ACT_REL_TOL = 0.5  # act_s vs Σ children: relative slack for loop overhead
ACT_ABS_TOL = 0.05  # ... and absolute slack (seconds)
EPS_S = 1e-6  # interval-containment slack for clock granularity


def load_jsonl(path: str) -> Tuple[Dict, List[Dict]]:
    """Read an exported trace: (meta header, records)."""
    meta: Dict = {}
    records: List[Dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("kind") == "meta":
                meta = rec
            else:
                records.append(rec)
    return meta, records


def check_parentage(records: List[Dict]) -> List[str]:
    problems = []
    spans = {r["id"]: r for r in records if r["kind"] == "span"}
    for r in records:
        pid = r.get("parent")
        if pid is None:
            continue
        parent = spans.get(pid)
        if parent is None:
            problems.append(
                f"{r['kind']} {r['name']!r} (id {r['id']}) has dangling "
                f"parent {pid}"
            )
            continue
        t0, t1 = r["t0"], r.get("t1", r["t0"])
        if t0 < parent["t0"] - EPS_S or t1 > parent["t1"] + EPS_S:
            problems.append(
                f"{r['kind']} {r['name']!r} (id {r['id']}) escapes parent "
                f"{parent['name']!r} interval"
            )
    return problems


def _offer_events(records: List[Dict]) -> Dict[str, Dict[str, set]]:
    """Per-base seq sets from the DeltaLog's structured events."""
    bases: Dict[str, Dict[str, set]] = {}

    def b(base):
        if base not in bases:
            bases[base] = {"accepted": set(), "drained": set(), "shed": set(),
                           "absorbed": set()}
        return bases[base]

    for r in records:
        if r["kind"] != "event":
            continue
        a = r.get("attrs", {})
        name = r["name"]
        if name == "offer" and a.get("outcome", "accepted") == "accepted":
            b(a["base"])["accepted"].add(a["seq"])
        elif name == "drain":
            b(a["base"])["drained"].update(a.get("seqs", ()))
        elif name == "shed":
            b(a["base"])["shed"].update(a.get("seqs", ()))
        elif name == "spill":
            side = b(a["base"])
            side["absorbed"].update(a.get("absorbed", ()))
            side["absorbed"].add(a.get("survivor"))
    return bases


def check_batch_accounting(records: List[Dict],
                           pending: Optional[Dict[str, List[int]]] = None
                           ) -> List[str]:
    """Every accepted offer seq must be covered by a drain, a shed, a
    spill absorption, or the end-state pending set — and no drain/shed may
    name a seq that was never offered."""
    problems = []
    pending = pending or {}
    for base, s in _offer_events(records).items():
        end = set(pending.get(base, ()))
        covered = s["drained"] | s["shed"] | s["absorbed"] | end
        lost = s["accepted"] - covered
        if lost:
            problems.append(
                f"base {base!r}: offered seqs {sorted(lost)} never drained, "
                f"shed, spilled, or pending — silently dropped"
            )
        phantom = (s["drained"] | s["shed"]) - s["accepted"] - s["absorbed"]
        if phantom:
            problems.append(
                f"base {base!r}: seqs {sorted(phantom)} drained/shed but "
                f"never offered"
            )
    return problems


def _metric(meta: Dict, name: str) -> Optional[float]:
    """Sum a metric over every label set in the meta snapshot."""
    metrics = meta.get("metrics")
    if metrics is None:
        return None
    vals = [v for k, v in metrics.items()
            if (k == name or k.startswith(name + "{"))
            and isinstance(v, (int, float))]
    return sum(vals) if vals else None


def check_verdict_accounting(records: List[Dict], meta: Dict) -> List[str]:
    problems = []
    by_verdict: Dict[str, int] = {}
    issued = 0
    for r in records:
        if r["kind"] == "span" and r["name"] == "query":
            a = r.get("attrs", {})
            n = int(a.get("n", 0))
            v = a.get("verdict")
            if v is None:
                problems.append(f"query span id {r['id']} carries no verdict")
                continue
            issued += n
            by_verdict[v] = by_verdict.get(v, 0) + n
    total = _metric(meta, "stream_queries")
    if total is not None and issued != int(total):
        problems.append(
            f"query spans cover {issued} queries but the service issued "
            f"{int(total)}"
        )
    for verdict, counter in (("admit", "admission_admitted"),
                             ("throttle", "admission_throttled"),
                             ("shed", "admission_shed")):
        want = _metric(meta, counter)
        if want is None:
            continue
        got = by_verdict.get(verdict, 0)
        if got != int(want):
            problems.append(
                f"verdict {verdict!r}: trace shows {got} queries, admission "
                f"counted {int(want)}"
            )
    return problems


def check_span_accounting(records: List[Dict], span_name: str = "act",
                          rel_tol: float = ACT_REL_TOL,
                          abs_tol: float = ACT_ABS_TOL) -> List[str]:
    """Each ``act`` span's wall time must match Σ direct child spans."""
    problems = []
    children: Dict[int, float] = {}
    for r in records:
        if r["kind"] == "span" and r.get("parent") is not None:
            children[r["parent"]] = children.get(r["parent"], 0.0) + r["dur_s"]
    for r in records:
        if r["kind"] != "span" or r["name"] != span_name:
            continue
        dur = r["dur_s"]
        child_sum = children.get(r["id"], 0.0)
        tol = max(rel_tol * max(dur, child_sum), abs_tol)
        if abs(dur - child_sum) > tol:
            problems.append(
                f"{span_name} span id {r['id']}: {dur:.4f}s vs Σ children "
                f"{child_sum:.4f}s exceeds tolerance {tol:.4f}s"
            )
    return problems


def check_fault_accounting(records: List[Dict], meta: Dict) -> List[str]:
    problems = []
    n_fault = sum(1 for r in records
                  if r["kind"] == "event" and r["name"] == "fault")
    n_quar = sum(1 for r in records
                 if r["kind"] == "event" and r["name"] == "quarantine")
    want_fault = meta.get("faults_injected")
    if want_fault is not None and n_fault != int(want_fault):
        problems.append(
            f"trace carries {n_fault} fault events, plan injected "
            f"{int(want_fault)}"
        )
    want_quar = meta.get("quarantines")
    if want_quar is not None and n_quar != int(want_quar):
        problems.append(
            f"trace carries {n_quar} quarantine events, health recorded "
            f"{int(want_quar)}"
        )
    return problems


SHARD_WALL_REL_TOL = 1e-6  # even wall split must re-sum exactly (float eps)


def check_shard_accounting(shard_summary: Dict) -> List[str]:
    """Per-shard kprof ledger vs its fleet mirror (KernelProfiler.
    shard_summary()): for every op with shard-attributed dispatches, the
    per-shard row and wall sums must equal the fleet totals, and neither
    side may carry an op the other lacks."""
    problems: List[str] = []
    fleet = shard_summary.get("fleet", {})
    shards = shard_summary.get("shards", {})
    for op in sorted(set(fleet) | set(shards)):
        fl = fleet.get(op)
        per = shards.get(op)
        if fl is None:
            problems.append(f"op {op!r}: shard entries with no fleet total")
            continue
        if per is None:
            problems.append(f"op {op!r}: fleet total with no shard entries")
            continue
        for field in ("rows_real", "rows_padded"):
            got = sum(s[field] for s in per.values())
            want = fl[field]
            if got != want:
                problems.append(
                    f"op {op!r}: Σ shard {field} = {got} but fleet total is "
                    f"{want}"
                )
        got_wall = sum(s["compile_s"] + s["execute_s"] for s in per.values())
        want_wall = fl["compile_s"] + fl["execute_s"]
        tol = max(SHARD_WALL_REL_TOL * max(got_wall, want_wall), 1e-9)
        if abs(got_wall - want_wall) > tol:
            problems.append(
                f"op {op!r}: Σ shard wall {got_wall:.6f}s vs fleet "
                f"{want_wall:.6f}s exceeds tolerance"
            )
        if sum(s["dispatches"] for s in per.values()) < fl["dispatches"]:
            problems.append(
                f"op {op!r}: fewer shard dispatches than fleet dispatches"
            )
    return problems


def reconcile(meta: Dict, records: List[Dict],
              shard_summary: Optional[Dict] = None) -> Dict:
    """Run every check; ``ok`` iff the trace reconciles exactly.

    ``shard_summary`` (KernelProfiler.shard_summary(), when a profiler ran
    alongside the trace) additionally cross-checks the per-shard kernel
    ledger against its fleet mirror."""
    if meta.get("dropped", 0):
        # an evicted record can no longer be accounted for — say so rather
        # than reporting spurious coverage gaps
        return {"ok": False, "problems": [
            f"ring dropped {meta['dropped']} records; raise tracer capacity"
        ]}
    checks = {
        "parentage": check_parentage(records),
        "batches": check_batch_accounting(records, meta.get("pending")),
        "verdicts": check_verdict_accounting(records, meta),
        "act_spans": check_span_accounting(records),
        "faults": check_fault_accounting(records, meta),
    }
    if shard_summary is not None:
        checks["shards"] = check_shard_accounting(shard_summary)
    problems = [p for ps in checks.values() for p in ps]
    return {
        "ok": not problems,
        "problems": problems,
        "checks": {k: len(v) for k, v in checks.items()},
        "records": len(records),
    }
