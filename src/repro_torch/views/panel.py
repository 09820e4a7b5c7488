"""FleetPanel: the stacked, padded clean/stale sample panel of a fleet.

The planner's moment snapshot (planner/costs) wants one device-side view
of the fleet: every registered view's correspondence-aligned clean/stale
sample pair for its canonical planner query, stacked along a leading view
axis and padded to one common row count, so that one launch
(kernels/fleet_moments) reduces all of them at once.  ``ViewManager`` owns
one ``FleetPanel`` (``ViewManager.fleet_panel()``), and the panel is
invalidated per view: every slot records the ``ManagedView.sample_version``
it was built from, and only moved views rebuild on the next access.

Padding contract: each slot holds eight row-aligned f32 channels —
x/valid/weight/1−π per side over the Def. 4 outer-join row space — padded
with zeros to ``pad_rows`` (a power-of-two bucket of the fleet's largest
joined capacity).  All-zero padding rows reduce to zero in every moment;
§6.3 outlier-pinned rows carry w = 1 / ompi = 0 as in the query engine's
correspondence cache.

A slot reuses ``ManagedView.corr_cache`` when the query engine already
built the window's alignment; otherwise a single-column join builds just
the canonical channels.  ``merge_slot`` serves the stale-sample panels of
kernels/fleet_merge, as ``repro.views.panel`` does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.estimators import OUTLIER_COL, Query
from repro_torch.query.engine import _gather_side, _rows_only
from repro_torch.relational import ops
from repro_torch.relational.relation import Relation, compact, next_pow2, sentinel_where

N_CHANNELS = 8  # x/valid/w/ompi per side


def canonical_query(mv) -> Query:
    """The view's planner probe: sum over its first value column (the first
    non-key, non-flag column of the clean-sample schema; count() when the
    view carries no value column)."""
    pk = set(mv.clean_sample.schema.pk)
    for c in mv.clean_sample.schema.columns:
        if c not in pk and c != OUTLIER_COL:
            return Query(agg="sum", col=c)
    return Query(agg="count")


def _gather_channels(rel: Relation, idx: torch.Tensor, present: torch.Tensor,
                     col: Optional[str], m: float):
    """(x, valid, w, ompi) single-column channels on the joined row space,
    through the query engine's ``_gather_side`` (one implementation of the
    Def. 4 channel semantics); a count() probe gathers a throwaway pk column
    and takes the presence mask as its value."""
    cols = (col,) if col is not None else rel.schema.pk[:1]
    x, v, w, ompi = _gather_side(rel, idx, present, cols, m)
    vf = v.to(torch.float32)
    return (x[:, 0] if col is not None else vf), vf, w, ompi


def _pad_cols(chan: torch.Tensor, pad_rows: int) -> torch.Tensor:
    return torch.nn.functional.pad(chan, (0, pad_rows - chan.shape[1]))


def _slot_from_samples(clean: Relation, stale: Relation, col: Optional[str], m: float,
                       pad_rows: int) -> torch.Tensor:
    """One (N_CHANNELS, pad_rows) slot straight from the sample pair: the Def. 4
    outer join of the correspondence cache, narrowed to the canonical column."""
    joined = ops.outer_join_unique(_rows_only(clean), _rows_only(stale),
                                   on=clean.schema.pk, how="outer", suffixes=("_new", "_old"))
    lp = joined.col("__left_present").to(torch.bool) & joined.valid
    rp = joined.col("__right_present").to(torch.bool) & joined.valid
    new = _gather_channels(clean, joined.col("__row_new"), lp, col, m)
    old = _gather_channels(stale, joined.col("__row_old"), rp, col, m)
    return _pad_cols(torch.stack(new + old), pad_rows)


def _slot_from_cache(cache, ci: Optional[int], pad_rows: int) -> torch.Tensor:
    """The slot from the query engine's per-window correspondence cache: the
    canonical column (ones on present rows for count probes) and the row
    channels."""
    def side(x_panel, valid, w, ompi):
        v = valid.to(torch.float32)
        return (v if ci is None else x_panel[:, ci]), v, w, ompi

    chan = torch.stack(side(cache.x_new, cache.valid_new, cache.w_new, cache.ompi_new)
                       + side(cache.x_old, cache.valid_old, cache.w_old, cache.ompi_old))
    return _pad_cols(chan, pad_rows)


def _merge_slot(stale: Relation, key: str, cols: Tuple[str, ...], pad_rows: int):
    """One view's stale sample as fleet_merge panel rows: its valid rows
    first (``compact``; ``pad_rows`` is at least their count), then padding.
    (keys (pad_rows,) i32 SENTINEL on invalid, valid (pad_rows,) bool, vals
    (pad_rows, A) f32 zeroed on invalid)."""
    rel = compact(stale, pad_rows)
    v = rel.valid
    k = sentinel_where(v, rel.col(key).to(torch.int32))
    vals = (torch.stack([rel.col(c).to(torch.float32) for c in cols], dim=1) if cols
            else torch.zeros((pad_rows, 0), dtype=torch.float32, device=v.device))
    vals = torch.where(v[:, None], vals, torch.zeros_like(vals))
    return k, v, vals


class FleetPanel:
    """Stacked per-view channel slots + the one-launch fleet moment pass."""

    def __init__(self, vm):
        self.vm = vm
        self.pad_rows = 0
        self._slots: Dict[str, torch.Tensor] = {}
        self._versions: Dict[str, int] = {}
        self._stacked: Optional[Tuple[torch.Tensor, ...]] = None
        self._stacked_names: Optional[Tuple[str, ...]] = None
        # merge slots feed kernels/fleet_merge; their lifetime differs from
        # the moment slots' (see merge_slot)
        self.merge_pad_rows = 0
        self._merge_slots: Dict[str, Tuple[tuple, tuple]] = {}
        self._merge_live: Dict[str, Tuple[int, int]] = {}  # (stale_version, valid rows)

    # -- invalidation --------------------------------------------------------
    def invalidate(self, name: str) -> None:
        """Drop one view's moment slot.  Merge slots stay: they derive from
        the STALE sample only and self-invalidate through
        ``ManagedView.stale_version``, so a clean keeps them warm."""
        self._slots.pop(name, None)
        self._versions.pop(name, None)
        self._stacked = None

    def _joined_rows(self, mv) -> int:
        return mv.clean_sample.capacity + mv.stale_sample.capacity

    def _ensure(self, names: Sequence[str]) -> None:
        views = self.vm.views
        # bucket over EVERY registered view, so a per-view access lands in
        # the same bucket as the planner's full-fleet pass
        target = next_pow2(max((self._joined_rows(mv) for mv in views.values()), default=1))
        if target != self.pad_rows:  # capacity bucket moved: rebuild all
            self.pad_rows = target
            self._slots.clear()
            self._versions.clear()
            self._stacked = None
        for n in names:
            mv = views[n]
            if self._versions.get(n) == mv.sample_version:
                continue
            self._slots[n] = self._build_slot(mv)
            self._versions[n] = mv.sample_version
            self._stacked = None

    def _build_slot(self, mv) -> torch.Tensor:
        q = canonical_query(mv)
        cache = mv.corr_cache
        if cache is not None:  # the query window already paid for the join
            ci = cache.columns.index(q.col) if q.col is not None else None
            return _slot_from_cache(cache, ci, self.pad_rows)
        return _slot_from_samples(mv.clean_sample, mv.stale_sample, q.col, mv.m, self.pad_rows)

    # -- merge slots ---------------------------------------------------------
    def _merge_rows(self) -> int:
        """The fleet's largest count of valid stale rows.  Counted once per
        ``stale_version``, all views that moved in one host sync."""
        views = self.vm.views
        moved = [n for n, mv in views.items()
                 if self._merge_live.get(n, (None,))[0] != mv.stale_version]
        if moved:
            counts = torch.stack([views[n].stale_sample.valid.sum() for n in moved]).cpu()
            for n, c in zip(moved, counts.tolist()):
                self._merge_live[n] = (views[n].stale_version, int(c))
        return max((self._merge_live[n][1] for n in views), default=0)

    def merge_slot(self, name: str, key: str, cols: Sequence[str]):
        """The view's stale sample as (keys, valid, vals) fleet_merge rows.

        Merge slots key on ``ManagedView.stale_version`` — bumped wherever
        the stale sample is re-derived (maintain, ratio retune, pin refresh)
        and NOT by cleans — so a fleet that cleans every epoch pays the slot
        build once.  ``merge_pad_rows`` is one pow2 bucket over the fleet's
        largest count of valid stale rows (not its arena capacity), so all
        slots stack into one (V, Rp) panel that holds no more padding than
        the bucket needs."""
        views = self.vm.views
        target = next_pow2(max(self._merge_rows(), 1))
        if target != self.merge_pad_rows:  # the bucket moved
            self.merge_pad_rows = target
            self._merge_slots.clear()
        mv = views[name]
        tag = (mv.stale_version, key, tuple(cols))
        hit = self._merge_slots.get(name)
        if hit is not None and hit[0] == tag:
            return hit[1]
        slot = _merge_slot(mv.stale_sample, key, tuple(cols), self.merge_pad_rows)
        self._merge_slots[name] = (tag, slot)
        return slot

    # -- accessors -----------------------------------------------------------
    def channels(self, names: Optional[Sequence[str]] = None) -> Tuple[torch.Tensor, ...]:
        """Eight (V, pad_rows) f32 channel panels in ``names`` order (default:
        registration order): x/valid/w/ompi for the clean side then the stale
        side — the kernels/fleet_moments input.  They are views of one
        stacked (V, 8, pad_rows) slab."""
        names = tuple(names) if names is not None else tuple(self.vm.views)
        self._ensure(names)
        if self._stacked is not None and self._stacked_names == names:
            return self._stacked
        if not names:
            empty = torch.zeros((0, max(self.pad_rows, 1)), dtype=torch.float32,
                                device=self.vm.device)
            stacked = (empty,) * N_CHANNELS
        else:
            slabs = torch.stack([self._slots[n] for n in names])  # (V, 8, R)
            stacked = tuple(slabs.unbind(1))
        self._stacked = stacked
        self._stacked_names = names
        return stacked

    def moments(self, names: Optional[Sequence[str]] = None) -> np.ndarray:
        """(V, fleet_moments.N_MOMENTS) host array — every view's snapshot
        moments from ONE launch over the stacked panel."""
        from repro_torch.kernels.fleet_moments import fleet_moments

        return fleet_moments(*self.channels(names)).cpu().numpy()
