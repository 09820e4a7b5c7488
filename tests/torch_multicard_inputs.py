"""Seeded inputs of ``tests/test_torch_multicard.py``, shared with its JAX
child process; imports numpy alone."""

from __future__ import annotations

import numpy as np

SHARDS, G, PER, M, SEED = 4, 64, 512, 0.3, 7
N_VIEWS = 8
N_FEATURES = 13  # kernels/fleet_score's feature columns


def inputs():
    """(stacked (SHARDS, 16, N_FEATURES) features, a delta's columns of
    SHARDS·PER sessions, N_VIEWS base and delta column sets)."""
    rng = np.random.default_rng(11)
    stacked = rng.exponential(5.0, (SHARDS, 16, N_FEATURES)).astype(np.float32)
    stacked[2, 10:] = 0.0  # padding lanes
    R = SHARDS * PER
    delta = {"sessionId": np.arange(R, dtype=np.int32),
             "videoId": rng.integers(0, G, R).astype(np.int32),
             "bytes": rng.exponential(10.0, R).astype(np.float32)}
    bases = [{"k": np.arange(300, dtype=np.int32),
              "g": rng.integers(0, 8, 300).astype(np.int32),
              "v": rng.exponential(5.0, 300).astype(np.float32)} for _ in range(N_VIEWS)]
    deltas = [{"k": np.arange(1000, 1040, dtype=np.int32),
               "g": rng.integers(0, 8, 40).astype(np.int32),
               "v": rng.exponential(5.0, 40).astype(np.float32)} for _ in range(N_VIEWS)]
    return stacked, delta, bases, deltas
