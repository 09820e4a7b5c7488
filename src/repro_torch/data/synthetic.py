"""Synthetic video-log workload (§2.1 running example, Conviva-shaped logs).

A numpy-only copy of ``make_log_video`` and ``grow_log`` from
``repro.data.synthetic``: the same generator calls in the same order, so
one ``numpy.random.Generator`` seed gives both packages identical data.
The columns are built on the host and placed on ``device``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.relational.relation import Relation, from_columns


def zipf_magnitudes(rng: np.random.Generator, n: int, z: float, scale: float = 100.0) -> np.ndarray:
    """Long-tailed positive magnitudes: scale / rank^z of a random rank."""
    ranks = rng.integers(1, 10_000, size=n).astype(np.float64)
    vals = scale * 10_000.0 / np.power(ranks, z)
    return vals.astype(np.float32)


def make_log_video(
    rng: np.random.Generator, n_videos: int, n_logs: int, capacity_slack: float = 1.5,
    device="cuda",
) -> Tuple[Relation, Relation]:
    video = from_columns(
        {
            "videoId": np.arange(n_videos, dtype=np.int32),
            "ownerId": rng.integers(0, max(2, n_videos // 8), n_videos).astype(np.int32),
            "duration": rng.exponential(30.0, n_videos).astype(np.float32),
        },
        pk=["videoId"],
        device=device,
    )
    # popularity is zipfian: a few videos get most visits
    pop = rng.zipf(1.6, size=n_logs).astype(np.int64)
    vid = (pop % n_videos).astype(np.int32)
    log = from_columns(
        {
            "sessionId": np.arange(n_logs, dtype=np.int32),
            "videoId": vid,
            "bytes": zipf_magnitudes(rng, n_logs, 1.2, 10.0),
        },
        pk=["sessionId"],
        capacity=int(n_logs * capacity_slack),
        device=device,
    )
    return log, video


def grow_log(
    rng: np.random.Generator, n_videos: int, start_session: int, n_new: int,
    hot_fraction: float = 0.5, device="cuda",
) -> Relation:
    """New log records; ``hot_fraction`` of them hit the newest 10% of videos
    (the paper's point that staleness is non-uniform, §2.1)."""
    hot = rng.random(n_new) < hot_fraction
    vid_hot = rng.integers(int(n_videos * 0.9), n_videos, n_new)
    vid_all = (rng.zipf(1.6, size=n_new) % n_videos).astype(np.int64)
    vid = np.where(hot, vid_hot, vid_all).astype(np.int32)
    return from_columns(
        {
            "sessionId": (start_session + np.arange(n_new)).astype(np.int32),
            "videoId": vid,
            "bytes": zipf_magnitudes(rng, n_new, 1.2, 10.0),
        },
        pk=["sessionId"],
        device=device,
    )
