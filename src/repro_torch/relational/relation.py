"""Fixed-capacity columnar relations on torch tensors.

A relation is a set of equal-length columns plus a boolean ``valid`` mask,
as in ``repro.relational.relation``.  Deleted rows are masked out;
capacities are explicit because they size every sort, join and arena
downstream.  Columns keep the JAX package's 32-bit types (int32 keys,
float32 values); int64 appears only as an index type.  Primary-key columns
are int32 and the reserved value ``SENTINEL_KEY`` (int32 max) marks invalid
keys so that sorts push dead rows to the end.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

# Largest int32; real keys must be < SENTINEL_KEY.
SENTINEL_KEY = np.int32(np.iinfo(np.int32).max)

DEFAULT_DEVICE = "cuda"

# JAX runs with x64 disabled: 64-bit inputs land as their 32-bit types.
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32}


@dataclasses.dataclass(frozen=True)
class Schema:
    """Static relation metadata."""

    pk: Tuple[str, ...]  # primary-key column names (composite allowed)
    columns: Tuple[str, ...]  # all column names, sorted

    def __post_init__(self):
        for k in self.pk:
            if k not in self.columns:
                raise ValueError(f"pk column {k!r} not in columns {self.columns}")

    def with_columns(self, columns: Sequence[str]) -> "Schema":
        return Schema(pk=self.pk, columns=tuple(sorted(columns)))


@dataclasses.dataclass
class Relation:
    """Columnar relation: dict of (capacity,) tensors + validity mask."""

    columns: Dict[str, torch.Tensor]
    valid: torch.Tensor  # bool (capacity,)
    schema: Schema

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    def col(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def pk_columns(self) -> Tuple[torch.Tensor, ...]:
        return tuple(self.columns[k] for k in self.schema.pk)

    def replace(self, **kw) -> "Relation":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Relation":
        return Relation(
            {k: v.to(device) for k, v in self.columns.items()},
            self.valid.to(device), self.schema,
        )

    def __repr__(self):  # pragma: no cover - debugging aid
        return (
            f"Relation(pk={self.schema.pk}, cols={self.schema.columns}, "
            f"capacity={self.capacity}, device={self.device})"
        )


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def as_column(v, device) -> torch.Tensor:
    """Host or device data → a column tensor on ``device`` (32-bit types).

    Host data is copied, never aliased: relations have value semantics.
    """
    if isinstance(v, torch.Tensor):
        t = v
    else:
        a = np.asarray(v)
        t = torch.from_numpy(a.copy() if device.type == "cpu" or not a.flags.writeable else a)
    t = t.to(device=device, dtype=_NARROW.get(t.dtype, t.dtype))
    return t.contiguous()


def _infer_device(columns, device):
    if device is not None:
        return torch.device(device)
    for v in columns.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device(DEFAULT_DEVICE)


def from_columns(
    columns: Mapping[str, object],
    pk: Sequence[str],
    valid=None,
    capacity: int | None = None,
    device=None,
) -> Relation:
    """Build a relation from host or device columns, padding to ``capacity``.

    ``device`` defaults to the device of the first tensor column, else CUDA.
    """
    device = _infer_device(columns, device)
    cols = {k: as_column(v, device) for k, v in columns.items()}
    n = next(iter(cols.values())).shape[0] if cols else 0
    for k, v in cols.items():
        if v.shape[0] != n:
            raise ValueError(f"ragged column {k!r}: {v.shape[0]} != {n}")
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=device)
    else:
        valid = as_column(valid, device).to(torch.bool)
    cap = capacity if capacity is not None else n
    if cap < n:
        raise ValueError(f"capacity {cap} < data rows {n}")
    if cap > n:
        cols = {k: _pad(v, cap, k in tuple(pk)) for k, v in cols.items()}
        valid = _pad(valid, cap, False)
    schema = Schema(pk=tuple(pk), columns=tuple(sorted(cols)))
    return Relation(columns=cols, valid=valid, schema=schema)


def from_arrays(
    columns: Mapping[str, np.ndarray], valid: np.ndarray, pk: Sequence[str], device
) -> Relation:
    """Carry a relation across from another engine at FULL capacity.

    ``columns`` is ``{name: np.asarray(col)}`` over every slot (invalid
    rows included) and ``valid`` the slot mask, so capacities — which size
    ``compact`` and the arenas — survive the move unchanged.
    """
    return from_columns(columns, pk, valid=valid, device=device)


def _pad(v: torch.Tensor, cap: int, is_key: bool) -> torch.Tensor:
    fill = SENTINEL_KEY if is_key else 0
    out = torch.full((cap,), fill, dtype=v.dtype, device=v.device)
    out[: v.shape[0]] = v
    return out


def empty(column_dtypes: Mapping[str, torch.dtype], pk: Sequence[str], capacity: int,
          device) -> Relation:
    cols = {}
    for k, dt in column_dtypes.items():
        fill = SENTINEL_KEY if k in tuple(pk) else 0
        cols[k] = torch.full((capacity,), fill, dtype=dt, device=device)
    valid = torch.zeros((capacity,), dtype=torch.bool, device=device)
    return Relation(cols, valid, Schema(pk=tuple(pk), columns=tuple(sorted(cols))))


# ---------------------------------------------------------------------------
# Key utilities
# ---------------------------------------------------------------------------

def sentinel_where(mask: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``c`` where ``mask``, else SENTINEL_KEY (in ``c``'s dtype)."""
    return torch.where(mask, c, torch.full_like(c, int(SENTINEL_KEY)))


def zeros_where(mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v`` where ``mask``, else 0 (the Ø→0 fill of Def. 4)."""
    return torch.where(mask, v, torch.zeros_like(v))


def masked_keys(rel: Relation) -> Tuple[torch.Tensor, ...]:
    """PK columns with invalid rows replaced by the sentinel (sorts last)."""
    return tuple(sentinel_where(rel.valid, rel.columns[k]) for k in rel.schema.pk)


def lexsort_indices(keys: Tuple[torch.Tensor, ...], *tiebreak: torch.Tensor) -> torch.Tensor:
    """Stable sort order by composite key (keys[0] = primary key).

    ``jnp.lexsort`` semantics: stable sorts chained from the least
    significant array (the first tiebreak) to the primary key.
    """
    arrays = tuple(tiebreak) + tuple(reversed(keys))
    order = None
    for a in arrays:
        if order is None:
            order = torch.sort(a, stable=True).indices
        else:
            order = order[torch.sort(a[order], stable=True).indices]
    return order


def keys_equal(a: Tuple[torch.Tensor, ...], b: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    eq = torch.ones(a[0].shape, dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        eq = eq & (x == y)
    return eq


def num_valid(rel: Relation) -> torch.Tensor:
    return rel.valid.sum(dtype=torch.int32)


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ n (arena/tile sizing; ≥ 1)."""
    p = 1
    while p < n:
        p <<= 1
    return p


def compact(rel: Relation, capacity: int | None = None) -> Relation:
    """Sort valid rows (by key) to the front and optionally resize capacity."""
    cap = capacity if capacity is not None else rel.capacity
    order = lexsort_indices(masked_keys(rel))
    take = order[:cap] if cap <= rel.capacity else order
    cols = {k: v[take] for k, v in rel.columns.items()}
    valid = rel.valid[take]
    if cap > rel.capacity:  # grow: pad
        cols = {k: _pad(v, cap, k in rel.schema.pk) for k, v in cols.items()}
        valid = _pad(valid, cap, False)
    return Relation(cols, valid, rel.schema)


def to_host(rel: Relation) -> Dict[str, np.ndarray]:
    """Valid rows as host arrays (test/debug helper)."""
    mask = rel.valid.cpu().numpy()
    return {k: v.cpu().numpy()[mask] for k, v in rel.columns.items()}
