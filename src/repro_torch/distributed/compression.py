"""Gradient compression: int8 quantization with error feedback, and a ring
all-reduce that applies it per hop: the port of
``repro.distributed.compression``.

Error feedback (1-bit Adam / EF-SGD lineage): the quantization residual is
kept locally and added to the next step's gradient, so compression error
does not accumulate.

The ring runs over a ``launch.mesh.LocalMesh``: one process drives every
device of the axis (as the sharded fleet does), and JAX's ``ppermute`` to
the next device in ring order is a copy there.  Each shard's hops follow
JAX's schedule exactly (a reduce-scatter of n − 1 hops, then an all-gather
of n − 1), so the sums are added in JAX's order.  Multi-process
``torch.distributed`` runs are not here: they need more than one card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import LocalMesh


# ---------------------------------------------------------------------------
# int8 quantization with error feedback
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8; returns (q, scale)."""
    amax = x.abs().max()
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(grads: Dict[str, torch.Tensor], error_state: Optional[Dict[str, torch.Tensor]]
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Compress named gradients with error feedback.

    Returns (dequantized grads to feed the optimizer or the collective,
    new error state).  The caller treats the output as the wire format's
    result."""
    if error_state is None:
        error_state = {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                       for k, g in grads.items()}
    deq, err = {}, {}
    for k, g in grads.items():
        corrected = g.to(torch.float32) + error_state[k]
        q, s = quantize_int8(corrected)
        deq[k] = dequantize_int8(q, s)
        err[k] = corrected - deq[k]
    return deq, err


# ---------------------------------------------------------------------------
# explicit ring all-reduce (reduce-scatter + all-gather)
# ---------------------------------------------------------------------------

def ring_allreduce(shards: Sequence[torch.Tensor], devices: Sequence,
                   quantize: bool = False) -> List[torch.Tensor]:
    """Bandwidth-optimal ring all-reduce over ``shards`` (one full array
    per ring member, member i on ``devices[i]``); returns each member's
    copy of the sum.  With ``quantize`` every hop's payload is int8 (plus
    an f32 scale), at the cost of quantization noise per hop."""
    n = len(shards)
    if n != len(devices):
        raise ValueError(f"{n} shards for {len(devices)} devices")
    if n == 1:
        return [shards[0]]
    shape = shards[0].shape
    if shards[0].numel() % n:
        raise ValueError(f"an array of {shards[0].numel()} elements does not split {n} ways")
    chunks = [x.reshape(n, -1) for x in shards]  # (n, len/n)

    def send(vals: List[torch.Tensor]) -> List[torch.Tensor]:
        """Member i's value arrives at member i + 1 (mod n)."""
        if quantize:
            qs = [quantize_int8(v) for v in vals]
            return [dequantize_int8(*(t.to(devices[i]) for t in qs[(i - 1) % n]))
                    for i in range(n)]
        return [vals[(i - 1) % n].to(devices[i]) for i in range(n)]

    # reduce-scatter: after n−1 hops member i holds the full sum of chunk
    # (i+1) mod n (at hop k it receives the running partial of chunk
    # (i−k−1) mod n from its left neighbour and adds its own piece)
    acc = [chunks[i][i] for i in range(n)]
    for k in range(n - 1):
        incoming = send(acc)
        acc = [incoming[i] + chunks[i][(i - k - 1) % n] for i in range(n)]
    # all-gather around the ring: at hop k member i receives the full sum
    # of chunk (i−k) mod n
    outs = [torch.zeros_like(c) for c in chunks]
    for i in range(n):
        outs[i][(i + 1) % n] = acc[i]
    cur = acc
    for k in range(n - 1):
        cur = send(cur)
        for i in range(n):
            outs[i][(i - k) % n] = cur[i]
    return [o.reshape(shape) for o in outs]


def make_compressed_allreduce(mesh: LocalMesh, axis: str,
                              quantize: bool = True) -> Callable[[torch.Tensor], torch.Tensor]:
    """f(x) -> the sum over ``axis``: x is the global array, split on its
    first dim into one shard per device of the axis (JAX's ``P(axis)``);
    every shard of the result holds the sum, gathered back in order."""
    devices = mesh.axis_devices(axis)
    n = len(devices)

    def f(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over {n} devices")
        shards = [s.to(d) for s, d in zip(torch.chunk(x, n), devices)]
        out = ring_allreduce(shards, devices, quantize=quantize)
        return torch.cat([o.to(x.device) for o in out])

    return f
