"""Bounded answers under failure: CI widening by the pending-delta bound.

A quarantined view serves from its last good clean sample.  That answer is
still a valid SVC estimate of the state it reflects; what it misses is
every delta row the failed cleans never folded in.  The degrade path widens
its interval by a deterministic worst-case bound on what those rows could
move the answer:

    Δ ≤ |value| · pending_rows / max(N̂, 1)

where ``N̂`` is the Horvitz–Thompson population estimate of the clean
sample (valid rows / m) and ``pending_rows`` the view's delta rows not yet
in the clean sample (``ViewManager.drift_rows(since="clean")``, a counter
read).  The value never moves; the method gains a suffix naming why the
answer degraded (``"+degraded"``, ``"+throttled"``, ``"+shed"``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.estimators import Estimate


def pending_delta_bound(mv, pending_rows: int) -> float:
    """Relative worst-case shift of the view's aggregates from
    ``pending_rows`` unapplied delta rows (uniform per-row mass)."""
    n_valid = float(mv.clean_sample.valid.sum())
    n_hat = n_valid / max(float(mv.m), 1e-9)
    return float(pending_rows) / max(n_hat, 1.0)


def widen_estimate(est: Estimate, mv, pending_rows: int,
                   suffix: str = "+degraded") -> Estimate:
    """Widen ``est``'s interval by the pending-delta bound.

    Zero pending rows widen nothing; the value itself never moves.  An
    already-suffixed method is left alone (idempotent under repeated
    widening)."""
    rel = pending_delta_bound(mv, pending_rows)
    extra = abs(float(est.value)) * rel
    method = est.method if est.method.endswith(suffix) else est.method + suffix
    return dataclasses.replace(
        est,
        stderr=est.stderr + extra,
        ci_low=est.ci_low - extra,
        ci_high=est.ci_high + extra,
        method=method,
    )
