"""Synthetic workloads: the video log (§2.1 running example, Conviva-shaped
logs) and the TPCD-Skew-shaped star schema.

A numpy-only copy of ``make_log_video``, ``grow_log``,
``make_lineitem_orders`` and ``grow_lineitem`` from ``repro.data.synthetic``:
the same generator calls in the same order, so one
``numpy.random.Generator`` seed gives both packages identical data.  The
columns are built on the host and placed on ``device``.
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


# ---------------------------------------------------------------------------
# TPCD-Skew-shaped star schema
# ---------------------------------------------------------------------------

N_NATIONS = 25
N_REGIONS = 5


def make_lineitem_orders(
    rng: np.random.Generator,
    n_orders: int,
    n_items: int,
    n_customers: int,
    n_parts: int,
    z: float = 2.0,
    capacity_slack: float = 1.5,
    device="cuda",
):
    """Returns (lineitem, orders, customer, nation, region) relations."""
    region = from_columns(
        {"r_regionkey": np.arange(N_REGIONS, dtype=np.int32)}, pk=["r_regionkey"],
        device=device,
    )
    nation = from_columns(
        {
            "n_nationkey": np.arange(N_NATIONS, dtype=np.int32),
            "n_regionkey": (np.arange(N_NATIONS) % N_REGIONS).astype(np.int32),
        },
        pk=["n_nationkey"],
        device=device,
    )
    customer = from_columns(
        {
            "c_custkey": np.arange(n_customers, dtype=np.int32),
            "c_nationkey": rng.integers(0, N_NATIONS, n_customers).astype(np.int32),
        },
        pk=["c_custkey"],
        device=device,
    )
    orders = from_columns(
        {
            "o_orderkey": np.arange(n_orders, dtype=np.int32),
            "o_custkey": rng.integers(0, n_customers, n_orders).astype(np.int32),
            "o_orderdate": rng.integers(0, 2400, n_orders).astype(np.int32),
            "o_totalprice": zipf_magnitudes(rng, n_orders, z),
        },
        pk=["o_orderkey"],
        capacity=int(n_orders * capacity_slack),
        device=device,
    )
    lineitem = from_columns(
        {
            "l_linekey": np.arange(n_items, dtype=np.int32),
            "l_orderkey": rng.integers(0, n_orders, n_items).astype(np.int32),
            "l_partkey": rng.integers(0, n_parts, n_items).astype(np.int32),
            "l_extendedprice": zipf_magnitudes(rng, n_items, z),
            "l_quantity": rng.integers(1, 50, n_items).astype(np.float32),
            "l_discount": (rng.integers(0, 10, n_items).astype(np.float32) / 100.0),
            "l_shipdate": rng.integers(0, 2400, n_items).astype(np.int32),
        },
        pk=["l_linekey"],
        capacity=int(n_items * capacity_slack),
        device=device,
    )
    return lineitem, orders, customer, nation, region


def grow_lineitem(
    rng: np.random.Generator,
    n_orders: int,
    n_parts: int,
    start_key: int,
    n_new: int,
    z: float = 2.0,
    device="cuda",
) -> Relation:
    """New lineitem rows (shipped after every base row) for ``n_orders`` orders."""
    return from_columns(
        {
            "l_linekey": (start_key + np.arange(n_new)).astype(np.int32),
            "l_orderkey": rng.integers(0, n_orders, n_new).astype(np.int32),
            "l_partkey": rng.integers(0, n_parts, n_new).astype(np.int32),
            "l_extendedprice": zipf_magnitudes(rng, n_new, z),
            "l_quantity": rng.integers(1, 50, n_new).astype(np.float32),
            "l_discount": (rng.integers(0, 10, n_new).astype(np.float32) / 100.0),
            "l_shipdate": rng.integers(2400, 2500, n_new).astype(np.int32),
        },
        pk=["l_linekey"],
        device=device,
    )
