"""Score every view's {skip, clean, maintain, retune} in one launch.

``fleet_scores`` is JAX's op on a device panel; ``fleet_scores_host`` is
the budgeted scheduler's (``repro_torch.planner.score_fleet``), once per
epoch, from a numpy feature panel to numpy scores.  ``fleet_scores_sharded``
and ``fleet_scores_sharded_host`` are the same for the sharded fleet's
(S, Vmax, F) stack of per-shard panels (``distributed.ShardedFleet`` calls
the second).  CPU tensors and CPU devices take the plain version
(``ref.py``); on a card each launches ``csrc/fleet_score.cu`` or raises.
Calls dispatch through ``obs.kprof.profiled`` as ``"fleet_score"`` and
``"fleet_score_sharded"``.

The host entries keep the panel out of device memory.  A view has 13
features in and 6 scores out, and both ends of the planner's call are on
the host, so a copy to the card, an allocation and a copy back cost more
than the kernel.  Each card has a persistent staging pair of mapped,
page-locked host memory (``_build.mapped``): the host writes the panel
into its input half, one launch reads it over the bus and writes the
scores into the output half, the host waits on that card's current stream
and copies the scores out.  One device operation a score, no allocation,
no copy launch.  The pair is written over by the next call, so what a call
returns is a copy.
"""

from __future__ import annotations

import numpy as np
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
    shard s is scored on the mesh's s-th device along ``axis``, as
    ``fleet_scores_sharded_host`` scores it (the stack read from the host),
    and the scores are put on the first.  Otherwise the stack is scored
    where it lies: on the card, one launch over the (S·Vmax, F) rows.  The
    score is elementwise per view, so every branch is bit-equal to scoring
    shard by shard.

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
        devices = [B.cuda_device(d) for d in mesh.axis_devices(axis)]
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
    """Shard s scored on ``devices[s]`` through the staged route (each
    card reads its shard's slice of one staging pair and writes its scores
    there, one launch a card; a CPU device takes the plain version), the
    scores put on ``devices[0]``."""
    if all(d.type == "cpu" for d in devices):
        return _sharded_ref(stacked.cpu()).to(devices[0])
    scores = _staged(stacked.cpu().numpy(), devices, "fleet_score_sharded", fleet_scores_sharded)
    return torch.from_numpy(scores).to(devices[0])


fleet_scores_sharded.launches = 0


def _check_panel(features, dims: int, what: str) -> None:
    shape = "(S, Vmax, " if dims == 3 else "(V, "
    if not isinstance(features, np.ndarray):
        raise TypeError(f"{what}: expected a numpy array, got {type(features).__name__}")
    if features.ndim != dims or features.shape[-1] != N_FEATURES:
        raise ValueError(f"expected {shape}{N_FEATURES}) {what}, got {features.shape}")
    if features.dtype != np.float32:
        raise TypeError(f"{what}: dtype {features.dtype}, expected float32")


def fleet_scores_host(features: np.ndarray, device) -> np.ndarray:
    """(V, N_FEATURES) float32 numpy panel → (V, N_SCORES) float32 numpy
    scores, computed on ``device``: the planner's score.  On a card, one
    launch over the card's staging pair and one wait on its current
    stream; on the CPU, the plain version."""
    _check_panel(features, 2, "features")
    dev = B.cuda_device(device)
    V = features.shape[0]
    if dev.type == "cpu":
        return profiled("fleet_score", _host_ref, features, fallback=True, rows=V, padded=V)
    return profiled("fleet_score", _launch_host, features, B.check_cuda(dev), rows=V, padded=V)


def _host_ref(features: np.ndarray) -> np.ndarray:
    return fleet_score_ref(torch.from_numpy(features)).numpy()


def _launch_host(features: np.ndarray, index: int) -> np.ndarray:
    return _staged(features, [torch.device("cuda", index)], "fleet_score", fleet_scores_host)


fleet_scores_host.launches = 0


def _score_staged(dev: torch.device, features: int, rows: int, out: int, counter) -> None:
    """One launch over ``rows`` staged views at the mapped addresses
    ``features`` and ``out``, on ``dev``'s card; ``counter`` is the
    wrapper that counts it."""
    card = dev.index
    B.launch_on(card, "svc_fleet_score", _ARGS, features, rows, out)
    counter.launches += 1


def _staged(features: np.ndarray, devs, key: str, counter) -> np.ndarray:
    """Score ``features`` through a staging pair: the first card among
    ``devs`` owns the pair, the host writes the panel into its input half,
    each device scores an equal run of rows (a card by one launch that
    reads and writes the pair over the bus, the CPU by the plain version
    straight into the output half), the host waits on each card's current
    stream once and copies the scores out."""
    rows = features.size // N_FEATURES
    if rows == 0:
        return np.zeros(features.shape[:-1] + (N_SCORES,), np.float32)
    home = next(d for d in devs if d.type == "cuda").index
    fin = B.mapped((key, "features", home), rows * N_FEATURES * 4, home)
    fout = B.mapped((key, "scores", home), rows * N_SCORES * 4, home)
    x = fin.host.view(np.float32)[:rows * N_FEATURES].reshape(rows, N_FEATURES)
    y = fout.host.view(np.float32)[:rows * N_SCORES].reshape(rows, N_SCORES)
    x[:] = features.reshape(rows, N_FEATURES)
    run = rows // len(devs)
    for s, d in enumerate(devs):
        lo = s * run
        if d.type == "cpu":
            y[lo:lo + run] = fleet_score_ref(torch.from_numpy(x[lo:lo + run])).numpy()
        elif run:
            _score_staged(d, fin.device + lo * N_FEATURES * 4, run, fout.device + lo * N_SCORES * 4,
                          counter)
    for d in dict.fromkeys(d for d in devs if d.type == "cuda"):
        B.wait(d.index)
    return y.reshape(features.shape[:-1] + (N_SCORES,)).copy()


def fleet_scores_sharded_host(stacked: np.ndarray, devices, shard_views=None) -> np.ndarray:
    """(S, Vmax, N_FEATURES) float32 numpy stack → (S, Vmax, N_SCORES)
    float32 numpy scores: the sharded fleet's score combine.

    ``devices`` is one device, where the whole stack is scored (one launch
    over its S·Vmax rows on a card), or S devices, shard s scored on
    ``devices[s]``: every card reads its shard's slice of one staging pair
    (that of the first card among them) and writes its rows of the pair's
    output half, and the host waits on each card once.  No shard's panel
    or scores are copied between devices.  ``shard_views`` (optional
    per-shard real view counts) feeds the profiler's per-shard ledger, as
    for ``fleet_scores_sharded``."""
    _check_panel(stacked, 3, "stacked")
    S, Vmax = stacked.shape[0], stacked.shape[1]
    rows = [int(v) for v in shard_views] if shard_views is not None else [Vmax] * S
    prof = dict(shards=list(range(S)), shard_rows=rows, shard_padded=[Vmax] * S,
                rows=sum(rows), padded=S * Vmax)
    if isinstance(devices, (list, tuple)):
        if len(devices) != S:
            raise ValueError(f"{len(devices)} devices for {S} shards")
        devs = [B.cuda_device(d) for d in devices]
    else:
        devs = [B.cuda_device(devices)]
    for d in devs:
        if d.type != "cpu":
            B.check_cuda(d)
    if all(d.type == "cpu" for d in devs):
        return profiled("fleet_score_sharded", _sharded_host_ref, stacked, fallback=True,
                        **prof)
    return profiled("fleet_score_sharded", _staged, stacked, devs, "fleet_score_sharded",
                    fleet_scores_sharded_host, fallback=any(d.type == "cpu" for d in devs),
                    **prof)


def _sharded_host_ref(stacked: np.ndarray) -> np.ndarray:
    return _sharded_ref(torch.from_numpy(stacked)).numpy()


fleet_scores_sharded_host.launches = 0
