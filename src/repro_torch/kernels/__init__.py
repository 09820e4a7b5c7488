"""Hand-written CUDA kernels for the SVC hot loops (``csrc/*.cu``).

Each kernel ships ``ops.py`` (checks, padding-free dispatch, the launch)
and ``ref.py`` (its plain PyTorch version).  A wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises — there is no fallback.  Every wrapper carries a plain
integer ``launches`` that it bumps where it launches its kernel, so a run
can show that the main path went through the kernels; hash_threshold and
corr_moments also count the launches of each of their kernel's two routes
in ``routes`` (vector: aligned 16-byte streams; scalar: any alignment),
slstm_fwd and slstm_bwd theirs (resident: one launch a call; step: one a
time step), outlier_digest its (block: digest and sort in one block;
sort: a digest launch and a torch sort) and outlier_pin_table its (arena:
the launch over the arena; sort: the composed table's digest launch past
2,048 entries).

  hash_threshold  — η_{a,m} mask
  fused_clean     — η + per-group count/sum over delta rows in one pass
  outlier_member  — the pinned hash: η ∨ outlier-index digest membership,
                    narrowed validity and the __outlier flag in one pass
  outlier_digest  — the sorted digest table of K key tuples (outlier_member's
                    digest entry): one block digests and sorts them up to
                    2,048, else a launch and a torch sort
  outlier_pin_table — the sorted digest table of a pin's key arena, built
                    once per pin: one launch over the arena and one host
                    wait for the table's length
  multi_agg       — all Q queries' moments in one panel scan (two kernels:
                    two-sided clean ∥ stale ∥ diff, and one-sided)
  fused_clean_fleet — fused_clean for V views in one launch (svc_refresh_many)
  fleet_merge     — every view's merge remainder (stale + ins) − del
  fleet_moments   — every view's planner moments from the fleet panel
  fleet_score     — every view's action scores for the planner's knapsack,
                    on a device panel (JAX's op)
  fleet_score_host — the same kernel as the planner calls it: a numpy panel
                    in, numpy scores out, through a card's mapped staging
                    pair (one launch and one wait a score)
  fleet_score_sharded — the same kernel over a sharded fleet's (S, Vmax, F)
                    stack of per-shard panels (one launch on one card; over
                    a mesh, one a shard through the staging pair)
  fleet_score_sharded_host — the sharded fleet's score combine through the
                    staging pair: one launch over the stack, or one a shard
                    on its own card
  segment_aggsum  — the group-by's reduce-by-key over sorted ids: int32
                    counts and float32 sums, out-of-range ids dropped
                    (segment_groupby, and segment_sum with
                    indices_are_sorted=True)
  segment_aggsum_unsorted — segment_sum over ids in any order
  corr_moments    — the SVC+CORR moments (Σd, Σd², count) in one pass
                    (corr_diff)
  flash_attention — online-softmax GQA attention, causal or masked at T
                    (the LM transformer's attention)
  flash_attention_bwd — its gradient (dq, dk, dv from the forward's output
                    and log-sum-exp), on every train step on the card
  adamw_norm      — AdamW's global norm over every trainable leaf and the
                    step's scalars (lr, clip scale, bias corrections), one
                    launch a step
  adamw_update    — AdamW's update of every leaf's p, m and v, one launch a
                    step (both on every train step on the card; JAX has no
                    op name for either, XLA fuses its update)
  slstm_fwd       — the sLSTM's recurrence over a sequence, one
                    cooperative launch a call (the resident route: every
                    xlstm forward and recompute on the card) or one launch
                    a time step (the per-step route: decode)
  slstm_bwd       — its gradient, on the same two routes, then dR as one
                    batched product (JAX has no op name for either: XLA
                    compiles its lax.scan)
  cross_entropy_fwd — the float32 cross-entropy over the vocabulary: each
                    row's log-sum-exp and nll, one launch (every train
                    step's loss on the card)
  cross_entropy_bwd — its gradient into the logits, one launch (JAX has no
                    op name for either: XLA fuses its composition)

Every wrapper dispatches through ``obs.kprof.profiled`` under the JAX
package's op name where it has one (``op_names``); ``set_profiler`` /
``get_profiler`` install and read the process's ``KernelProfiler``.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.obs.kprof import get_profiler, set_profiler

__all__ = ["get_profiler", "launch_counts", "op_names", "reset_launches", "route_counts",
           "set_profiler", "wrappers"]

# kernel name (``wrappers()``) → the op its wrapper dispatches as
_OPS = {
    "hash_threshold": "hash_threshold",
    "fused_clean": "fused_clean",
    "outlier_member": "outlier_member",
    "outlier_digest": "outlier_digest",
    "outlier_pin_table": "outlier_digest",
    "multi_agg_two": "multi_agg",
    "multi_agg_one": "multi_agg",
    "fused_clean_fleet": "fused_clean_fleet",
    "fleet_merge": "fleet_merge",
    "fleet_moments": "fleet_moments",
    "fleet_score": "fleet_score",
    "fleet_score_host": "fleet_score",
    "fleet_score_sharded": "fleet_score_sharded",
    "fleet_score_sharded_host": "fleet_score_sharded",
    "segment_aggsum": "segment_aggsum",
    "segment_aggsum_unsorted": "segment_aggsum",
    "corr_diff": "corr_diff",
    "flash_attention": "flash_attention",
    "flash_attention_bwd": "flash_attention_bwd",
    "adamw_norm": "adamw_norm",
    "adamw_update": "adamw_update",
    "slstm_fwd": "slstm_fwd",
    "slstm_bwd": "slstm_bwd",
    "cross_entropy_fwd": "cross_entropy_fwd",
    "cross_entropy_bwd": "cross_entropy_bwd",
}


def wrappers() -> Dict[str, object]:
    """Kernel name → the wrapper that launches it."""
    from repro_torch.kernels.adamw.ops import adamw_apply, adamw_norm
    from repro_torch.kernels.corr_diff.ops import corr_moments
    from repro_torch.kernels.cross_entropy.ops import cross_entropy_bwd, cross_entropy_fwd
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
    from repro_torch.kernels.fleet_merge.ops import fleet_merge
    from repro_torch.kernels.fleet_moments.ops import fleet_moments
    from repro_torch.kernels.fleet_score.ops import (fleet_scores, fleet_scores_host,
                                                     fleet_scores_sharded,
                                                     fleet_scores_sharded_host)
    from repro_torch.kernels.fused_clean.ops import fused_clean_groupby, fused_clean_groupby_fleet
    from repro_torch.kernels.hash_threshold.ops import hash_threshold
    from repro_torch.kernels.multi_agg.ops import multi_agg_one, multi_agg_two
    from repro_torch.kernels.outlier_member.ops import digest_table, pin_table, pinned_hash
    from repro_torch.kernels.segment_aggsum.ops import segment_groupby, segment_sum
    from repro_torch.kernels.slstm.ops import slstm_bwd, slstm_fwd

    return {
        "hash_threshold": hash_threshold,
        "fused_clean": fused_clean_groupby,
        "outlier_member": pinned_hash,
        "outlier_digest": digest_table,
        "outlier_pin_table": pin_table,
        "multi_agg_two": multi_agg_two,
        "multi_agg_one": multi_agg_one,
        "fused_clean_fleet": fused_clean_groupby_fleet,
        "fleet_merge": fleet_merge,
        "fleet_moments": fleet_moments,
        "fleet_score": fleet_scores,
        "fleet_score_host": fleet_scores_host,
        "fleet_score_sharded": fleet_scores_sharded,
        "fleet_score_sharded_host": fleet_scores_sharded_host,
        "segment_aggsum": segment_groupby,
        "segment_aggsum_unsorted": segment_sum,
        "corr_diff": corr_moments,
        "flash_attention": flash_attention,
        "flash_attention_bwd": flash_attention_bwd,
        "adamw_norm": adamw_norm,
        "adamw_update": adamw_apply,
        "slstm_fwd": slstm_fwd,
        "slstm_bwd": slstm_bwd,
        "cross_entropy_fwd": cross_entropy_fwd,
        "cross_entropy_bwd": cross_entropy_bwd,
    }


def op_names() -> Dict[str, str]:
    """Kernel name → the ``KernelProfiler`` op its wrapper's calls land in."""
    return dict(_OPS)


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        for route in getattr(fn, "routes", ()):
            fn.routes[route] = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def route_counts() -> Dict[str, Dict[str, int]]:
    """Launches by route (vector or scalar; resident or step; block or
    sort; arena or sort) of the wrappers that have two."""
    return {name: dict(fn.routes) for name, fn in wrappers().items() if hasattr(fn, "routes")}
