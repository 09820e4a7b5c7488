"""Batched serving engine with continuous batching: the port of ``repro.serving.engine``.

A fixed pool of ``max_batch`` slots decodes per tick: one ``decode_step``
per distinct cache position (exactly one for the uniform pools of the
common case).  Finished or empty slots are refilled from the request
queue; each admission feeds that slot's prompt token by token through
``decode_step``.

Where JAX's ``decode_step`` writes every batch row at its position and the
engine then keeps only the decoded slots' rows with a masked cache merge,
the port's ``decode_step`` takes those slots as ``rows`` and writes the
cache in place at them alone.  Both leave the same cache; the decoded
slots' logits are the same, since a row attends only its own cache rows.

Serving telemetry (per-tick active slots, emitted tokens, queue length)
streams into a ``repro_torch.streaming.StreamingViewService`` passed as
``telemetry``: every decode tick offers one micro-batch row to its
DeltaLog, and ``dashboard()`` answers from the watermark-refreshed sample
with staleness metadata instead of scanning raw logs.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_done: Optional[float] = None


class ServeEngine:
    """``model`` is a ``repro_torch.models.Model`` (or anything with its
    ``device``, ``init_cache`` and ``decode_step(params, cache, tokens, pos,
    rows)``); ``params`` what its ``init`` returned."""

    def __init__(self, model, params, max_batch: int, max_seq: int,
                 eos_id: Optional[int] = None, telemetry=None,
                 telemetry_base: str = "ServeLog"):
        self.telemetry = telemetry  # StreamingViewService (optional)
        self.telemetry_base = telemetry_base
        self.model = model
        self.params = params
        self.B = max_batch
        self.T = max_seq
        self.eos_id = eos_id
        self.device = torch.device(model.device)
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.pos = np.zeros(max_batch, np.int32)  # next cache position per slot
        self.budget = np.zeros(max_batch, np.int32)
        self.cache = model.init_cache(max_batch, max_seq)
        self.last_tok = np.zeros(max_batch, np.int32)
        self.completed: List[Request] = []
        self.ticks = 0

    def _decode(self, tokens: np.ndarray, pos: int, rows: List[int]):
        """One ``decode_step`` at ``pos`` writing the cache at ``rows``;
        returns the greedy next token of each of ``rows``."""
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, torch.from_numpy(tokens).to(self.device), pos, rows)
        idx = torch.as_tensor(rows, dtype=torch.long, device=logits.device)
        return logits[idx, -1].argmax(dim=-1).cpu().numpy()

    # -- admission -------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _admit(self) -> None:
        for slot in range(self.B):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            P = len(req.prompt)
            # prefill the slot: feed prompt tokens one by one through
            # decode_step (simple and uniform across families), writing the
            # cache at this slot's row only — the sibling slots keep their
            # KV at positions 0..P-1
            last = None
            for i, tok in enumerate(req.prompt):
                tokens = np.zeros((self.B, 1), np.int32)
                tokens[slot, 0] = tok
                last = self._decode(tokens, i, [slot])[0]
            self.slots[slot] = req
            self.pos[slot] = P
            self.budget[slot] = req.max_new
            if last is None:
                # empty prompt: nothing prefilled; decode starts from a
                # zero token at position 0 instead of a prompt continuation
                self.last_tok[slot] = 0
            else:
                self.last_tok[slot] = last
                req.out_tokens.append(int(last))

    # -- decode tick -------------------------------------------------------------
    def step(self) -> int:
        """One decode tick over the pool; returns #tokens emitted."""
        self._admit()
        active = [i for i in range(self.B) if self.slots[i] is not None]
        if not active:
            return 0
        self.ticks += 1
        tokens = self.last_tok.reshape(self.B, 1).astype(np.int32)
        # Per-slot positions differ under continuous batching, but
        # decode_step takes ONE position: group the active slots by
        # position and decode each group, writing only its rows.
        nxt = np.zeros(self.B, np.int64)
        for pos in sorted({int(self.pos[i]) for i in active}):
            group = [i for i in active if int(self.pos[i]) == pos]
            nxt[group] = self._decode(tokens, pos, group)
        emitted = 0
        for i in active:
            req = self.slots[i]
            tok = int(nxt[i])
            req.out_tokens.append(tok)
            self.last_tok[i] = tok
            self.pos[i] += 1
            self.budget[i] -= 1
            emitted += 1
            done = self.budget[i] <= 0 or (self.eos_id is not None and tok == self.eos_id)
            if done or self.pos[i] >= self.T - 1:
                req.t_done = time.perf_counter()
                self.completed.append(req)
                self.slots[i] = None
        if self.telemetry is not None:
            self._offer_telemetry(len(active), emitted)
        return emitted

    def _offer_telemetry(self, active: int, emitted: int) -> None:
        """One micro-batch row per decode tick into the streaming DeltaLog;
        the watermark decides when the telemetry view's sample refreshes."""
        from repro_torch.relational.relation import from_columns

        row = from_columns(
            {
                "tickId": np.array([self.ticks], np.int32),
                "active": np.array([active], np.float32),
                "emitted": np.array([emitted], np.float32),
                "queued": np.array([len(self.queue)], np.float32),
            },
            pk=["tickId"],
            device=self.telemetry.vm.device,
        )
        self.telemetry.offer(self.telemetry_base, inserts=row, seq=self.ticks)

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        while (self.queue or any(s is not None for s in self.slots)) and max_ticks:
            self.step()
            max_ticks -= 1
        return self.completed

    # -- telemetry dashboard -----------------------------------------------------
    def dashboard(self, view_name: Optional[str] = None, queries=None) -> Dict:
        """The serving-telemetry dashboard panel, answered in ONE batched
        engine pass (``StreamingViewService.query_batch``): every stat shares
        one staleness snapshot and one multi_agg scan.

        ``queries`` maps stat name -> ``repro_torch.core.Query``; the default
        panel covers whichever of the per-tick telemetry columns (active,
        emitted, queued) the registered view retains.  ``view_name``
        defaults to the first registered view fed by ``telemetry_base``.
        Returns {name: StreamedEstimate}, plus the planner's last report
        under "planner" when the service has a planner.
        """
        if self.telemetry is None:
            raise RuntimeError("dashboard() requires a telemetry StreamingViewService")
        if view_name == "observatory":
            raise NotImplementedError(
                "the staleness observatory panel (obs/reconcile.py) is not ported: ROADMAP A.11")
        from repro_torch.core import Query

        vm = self.telemetry.vm
        if view_name is None:
            for name, mv in vm.views.items():
                if self.telemetry_base in mv.delta_bases:
                    view_name = name
                    break
            else:
                raise ValueError(f"no view registered over {self.telemetry_base!r}")
        if queries is None:
            cols = set(vm.views[view_name].clean_sample.schema.columns)
            queries = {"ticks": Query(agg="count")}
            for stat, col in (("avg_active", "active"), ("tokens_emitted", "emitted"),
                              ("avg_queued", "queued")):
                if col in cols:
                    agg = "sum" if stat.startswith("tokens") else "avg"
                    queries[stat] = Query(agg=agg, col=col)
        names = list(queries)
        ests = self.telemetry.query_batch(view_name, [queries[n] for n in names])
        out = dict(zip(names, ests))
        planner = getattr(self.telemetry, "planner", None)
        if planner is not None and planner.last_report is not None:
            out["planner"] = planner.last_report.to_dict()
        return out
