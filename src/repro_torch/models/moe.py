"""Mixture-of-Experts FFN with capacity-based local dispatch: the port of ``repro.models.moe``.

Each call routes its T tokens alone: a float32 router softmax, top-k and
renormalise, a stable sort of the (token, slot) pairs by expert, the rank
within each expert and the capacity cut (an overflowing pair goes to the
slot E·cap and is dropped), the pack into (E, cap, d), the expert GLU as
three batched products, and the gather back weighted by the gate.  Under a
``ParallelCtx`` (``moe_ffn_sharded``) each data shard routes its own
tokens at its own capacity and the loads are summed over the shards, as
JAX's ``shard_map`` over the data axes does; the JAX module's ``tp_axis``
(d_ff partials summed over the model axis) has no counterpart, since one
process holds the whole d_ff.

Differences from the JAX module, both deliberate:
  * the k weighted expert outputs of a token are gathered back through the
    inverse of the sort into (T, k, d) and summed over k in float32, then
    rounded once to x's dtype; JAX scatter-adds them into y in x's dtype
    (on the card ``index_add_`` would be atomic and not deterministic);
  * nothing here synchronizes with the host: the sort, ``searchsorted``
    and the scatters stay on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    cap = int(np.ceil(n_tokens * cfg.moe_top_k / cfg.moe_experts * cfg.moe_capacity_factor))
    return max(8, cap)


class Routing(NamedTuple):
    top_e: torch.Tensor  # (T, k) int64 routed experts, by descending gate
    order: torch.Tensor  # (T·k,) the stable sort of the flattened pairs by expert
    gate: torch.Tensor   # (T·k,) f32 renormalised gates, in sorted order
    token: torch.Tensor  # (T·k,) int64 token of each sorted pair
    slot: torch.Tensor   # (T·k,) int64 slot in the (E·cap) buffer, E·cap when dropped
    keep: torch.Tensor   # (T·k,) bool, in sorted order


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: ArchConfig, capacity: int) -> Routing:
    """The dispatch of ``moe_ffn_local``: x (T, d), router_w (d, E) float32.

    The router product runs in float32 (JAX promotes x to the f32 master
    router).  ``torch.topk`` promises no order among equal gates, where
    ``jax.lax.top_k`` takes the lower index: ties have measure zero for
    float inputs, and the tests draw theirs from a seed."""
    T = x.shape[0]
    E, k = cfg.moe_experts, cfg.moe_top_k
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)  # (T, E)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    flat_e = top_e.reshape(-1)
    se, order = torch.sort(flat_e, stable=True)
    token = torch.div(order, k, rounding_mode="floor")  # flat index t·k + j → t
    first_of_e = torch.searchsorted(se, torch.arange(E, dtype=se.dtype, device=se.device))
    pos_in_e = torch.arange(se.numel(), device=se.device) - first_of_e[se]
    keep = pos_in_e < capacity
    slot = torch.where(keep, se * capacity + pos_in_e, torch.full_like(se, E * capacity))
    return Routing(top_e, order, top_p.reshape(-1)[order], token, slot, keep)


def moe_ffn_local(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
                  w_up: torch.Tensor, w_down: torch.Tensor, cfg: ArchConfig,
                  capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, d); router_w (d, E); w_gate/w_up (E, d, F); w_down (E, F, d).

    Returns (y (T, d) in x's dtype, load (E,) float32): ``load`` counts the
    top-k picks of each expert, dropped ones included."""
    T, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    r = route(x, router_w, cfg, capacity)
    # the pack: kept slots are distinct; every dropped pair writes the spare row
    buf = torch.zeros((E * capacity + 1, d), dtype=x.dtype, device=x.device)
    buf[r.slot] = x[r.token]
    blk = buf[:-1].view(E, capacity, d)
    g = torch.bmm(blk, w_gate.to(x.dtype))
    u = torch.bmm(blk, w_up.to(x.dtype))
    h = F.silu(g) * u if cfg.act == "swiglu" else F.gelu(g, approximate="tanh") * u
    out = torch.bmm(h, w_down.to(x.dtype)).view(E * capacity, d)
    out = torch.cat([out, out.new_zeros((1, d))])  # a dropped pair reads zeros
    contrib = out[r.slot] * r.gate[:, None].to(x.dtype)  # (T·k, d), sorted order
    unsorted = torch.empty_like(contrib)
    unsorted[r.order] = contrib
    y = unsorted.view(T, k, d).float().sum(dim=1).to(x.dtype)
    flat_e = r.top_e.reshape(-1)
    load = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    return y, load.float()


def moe_ffn_sharded(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor, cfg: ArchConfig,
                    dp: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) split into ``dp`` data shards of B/dp rows, each routed on
    its own at the capacity of its (B/dp)·S tokens (JAX's ``_ffn`` under a
    ctx); returns (y (B, S, d), load (E,) summed over the shards in shard
    order).  With a binding capacity this drops other tokens than one
    routing of all B·S."""
    B, S, d = x.shape
    if B % dp:
        raise ValueError(f"moe_ffn_sharded: batch {B} does not split into {dp} data shards")
    local = (B // dp) * S
    cap = moe_capacity(cfg, local)
    xs = x.reshape(dp, local, d)
    outs = [moe_ffn_local(xs[i], router_w, w_gate, w_up, w_down, cfg, cap) for i in range(dp)]
    load = outs[0][1]
    for _y, ld in outs[1:]:
        load = load + ld
    return torch.cat([y for y, _ in outs]).view(B, S, d), load
