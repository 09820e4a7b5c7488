"""Score every view's {skip, clean, maintain, retune} in one launch.

``fleet_scores`` is the op the budgeted scheduler (``repro_torch.planner``)
calls once per epoch; ``fleet_scores_sharded`` is the sharded fleet's
(``distributed.ShardedFleet``): every shard's (Vmax, F) panel of an
(S, Vmax, F) stack.  CPU tensors take the plain version (``ref.py``);
CUDA tensors launch ``csrc/fleet_score.cu`` or raise.  Calls dispatch
through ``obs.kprof.profiled`` as ``"fleet_score"`` and
``"fleet_score_sharded"``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.fleet_score.ref import N_FEATURES, N_SCORES, fleet_score_ref
from repro_torch.obs.kprof import profiled

_ARGS = (B.P, B.I64, B.P, B.P)


def fleet_scores(features: torch.Tensor) -> torch.Tensor:
    """(V, N_FEATURES) f32 per-view features → (V, N_SCORES) f32 scores."""
    if features.dim() != 2 or features.shape[1] != N_FEATURES:
        raise ValueError(f"expected (V, {N_FEATURES}) features, got {tuple(features.shape)}")
    dev = features.device
    B.check(features, "features", torch.float32, dev)
    V = features.shape[0]
    if dev.type == "cpu":
        return profiled("fleet_score", fleet_score_ref, features, fallback=True, rows=V,
                        padded=V)
    B.check_cuda(dev)
    return profiled("fleet_score", _launch, features, V, dev, rows=V, padded=V)


def _enqueue(features: torch.Tensor, V: int, dev: torch.device, counter) -> torch.Tensor:
    """One launch over the (V, F) panel; ``counter`` is the wrapper that counts it."""
    out = torch.empty((V, N_SCORES), dtype=torch.float32, device=dev)
    if V == 0:
        return out
    card = dev.index
    B.launch_on(card, "svc_fleet_score", _ARGS, features.data_ptr(), V, out.data_ptr())
    counter.launches += 1
    return out


def _launch(features: torch.Tensor, V: int, dev: torch.device) -> torch.Tensor:
    return _enqueue(features, V, dev, fleet_scores)


fleet_scores.launches = 0


def fleet_scores_sharded(stacked: torch.Tensor, mesh=None, axis: str = "data",
                         shard_views=None) -> torch.Tensor:
    """(S, Vmax, N_FEATURES) f32 per-shard feature panels → (S, Vmax, N_SCORES).

    With a mesh (``launch.mesh.LocalMesh``) whose ``axis`` size equals S,
    shard s is scored on the mesh's s-th device along ``axis`` (its slice
    copied there from wherever the stack lies, on the host or a card) and
    the panels are gathered onto the first (a copy each, then one stack).
    Otherwise the stack is scored where it lies: on the card, one launch
    over the (S·Vmax, F) rows.  The score is elementwise per view, so every
    branch is bit-equal to scoring shard by shard.

    ``shard_views`` (optional per-shard real view counts) feeds the
    profiler's per-shard ledger; padded lanes carry all-zero features and
    score 0.
    """
    if stacked.dim() != 3 or stacked.shape[2] != N_FEATURES:
        raise ValueError(
            f"expected (S, Vmax, {N_FEATURES}) stacked features, got {tuple(stacked.shape)}")
    dev = stacked.device
    B.check(stacked, "stacked", torch.float32, dev)
    S, Vmax = stacked.shape[0], stacked.shape[1]
    rows = [int(v) for v in shard_views] if shard_views is not None else [Vmax] * S
    prof = dict(shards=list(range(S)), shard_rows=rows, shard_padded=[Vmax] * S,
                rows=sum(rows), padded=S * Vmax)
    if mesh is not None and mesh.shape.get(axis, 1) == S and S > 1:
        devices = mesh.axis_devices(axis)
        for d in devices:
            if d.type != "cpu":
                B.check_cuda(d)
        return profiled("fleet_score_sharded", _per_device, stacked, devices,
                        fallback=any(d.type == "cpu" for d in devices), **prof)
    if dev.type == "cpu":
        return profiled("fleet_score_sharded", _sharded_ref, stacked, fallback=True, **prof)
    B.check_cuda(dev)
    return profiled("fleet_score_sharded", _launch_sharded, stacked, dev, **prof)


def _sharded_ref(stacked: torch.Tensor) -> torch.Tensor:
    S, Vmax = stacked.shape[0], stacked.shape[1]
    return fleet_score_ref(stacked.reshape(S * Vmax, N_FEATURES)).reshape(S, Vmax, N_SCORES)


def _launch_sharded(stacked: torch.Tensor, dev: torch.device) -> torch.Tensor:
    S, Vmax = stacked.shape[0], stacked.shape[1]
    out = _enqueue(stacked.reshape(S * Vmax, N_FEATURES), S * Vmax, dev, fleet_scores_sharded)
    return out.reshape(S, Vmax, N_SCORES)


def _per_device(stacked: torch.Tensor, devices) -> torch.Tensor:
    """Shard s scored on ``devices[s]``, then gathered onto ``devices[0]``
    in shard order.  Every shard's launch is enqueued on its card before
    the first copy back; a host stack is pinned first, so that no slice's
    copy to its card waits on the host."""
    if stacked.device.type == "cpu" and any(d.type == "cuda" for d in devices):
        stacked = stacked.pin_memory()
    parts = []
    for s, d in enumerate(devices):
        x = stacked[s].to(d, non_blocking=True).contiguous()
        parts.append(fleet_score_ref(x) if d.type == "cpu"
                     else _enqueue(x, x.shape[0], d, fleet_scores_sharded))
    return torch.stack([p.to(devices[0]) for p in parts])


fleet_scores_sharded.launches = 0
