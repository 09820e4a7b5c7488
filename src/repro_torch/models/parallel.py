"""Parallelism context threaded through the models: the port of ``repro.models.parallel``.

``ParallelCtx`` names a mesh's axes so that a model can place its
per-shard regions (the MoE dispatch) and its sharding pins without global
state; ``None`` means one device, as in JAX.  ``P`` is the port's
``PartitionSpec``: one entry per dim, each ``None``, an axis name or a
tuple of axis names, a tuple that compares entry for entry with JAX's.

``constrain`` is where JAX calls ``with_sharding_constraint``.  One
process has no partitioner, so the port's ``constrain`` returns ``x``
unchanged and checks only that the spec has ``x.ndim`` entries (ROADMAP
C: a deliberate difference).  What a ctx changes in what is computed is
the MoE's per-shard routing (``models.moe.moe_ffn_sharded``) and the K/V
repeat (``transformer.maybe_repeat_kv``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


class P(tuple):
    """A partition spec: ``P("data", None)``; ``P()`` replicates.  A
    one-axis tuple entry is stored as the axis, as ``PartitionSpec`` does."""

    def __new__(cls, *parts):
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1 else a
                                     for a in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    mesh: object  # a ``launch.mesh.LocalMesh``: ``mesh.shape[axis]`` is all the ctx reads
    dp_axes: Tuple[str, ...]  # batch axes, e.g. ("data",) or ("pod", "data")
    tp_axis: str = "model"

    @property
    def dp_size(self) -> int:
        return math.prod(self.mesh.shape[a] for a in self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self.mesh.shape[self.tp_axis]

    def batch_spec(self, *rest) -> P:
        return P(self.dp_axes, *rest)


def constrain(x: torch.Tensor, ctx: Optional[ParallelCtx], spec: Optional[P]) -> torch.Tensor:
    """``x`` itself; raises if ``spec`` (under a ctx) has not ``x.ndim`` entries."""
    if ctx is None or spec is None:
        return x
    if len(spec) != x.ndim:
        raise ValueError(f"constrain: spec {spec} has {len(spec)} entries for a tensor of "
                         f"shape {tuple(x.shape)}")
    return x
