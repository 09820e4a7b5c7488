"""Flash attention over (B, S, H, hd) queries and (B, T, K, hd) keys/values.

``flash_attention`` is the port of ``repro.kernels.flash_attention.ops.
flash_attention``, and the port's transformer computes all its attention
with it: causal over the prompt in ``forward``/``prefill``, non-causal
against the cache slice ``[:, :pos+1]`` in ``decode_step``.  CPU tensors
take the plain version (``ref.py``); CUDA tensors launch
``csrc/flash_attention.cu`` or raise.  The route follows the dtype:
bfloat16 runs on the tensor cores, one launch per call; float32 on the
CUDA cores, with a second launch when the keys are split.

``plan`` is the host side of a launch as a pure function of the shapes:
route, tile, key split and workspace sizes.  The key-split partials live
in one persistent workspace per device, and the tensor-core route's
arrival counters in another (zeroed once; every launch leaves them at 0),
both grown on demand and never shrunk.  They serve one stream: two calls
in flight on different streams would share them.  Every call dispatches
through ``obs.kprof.profiled`` as ``"flash_attention"`` (the JAX package
has no profiled attention: its flash kernel is on no path).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.obs.kprof import profiled

HEAD_DIMS = (16, 32, 64, 96, 128, 256)  # the kernel's instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132  # the H100's streaming multiprocessors
SMEM_PER_SM = 232448  # bytes of shared memory one SM gives its blocks
_ARGS = ((B.P, B.P, B.P, B.P) + (B.I64,) * 9 + (B.I32,) * 7 + (B.F32,) + (B.I32,) * 5
         + (B.P,) * 4)


class Plan(NamedTuple):
    route: str            # "tensor_cores" (bfloat16) or "cuda_cores" (float32)
    rows_per_tile: int    # (query, group head) rows of a block
    keys_per_tile: int    # keys a block stages per step
    row_tiles: int
    chunk: int            # keys per split, a multiple of keys_per_tile
    nsplit: int
    workspace_bytes: int  # (m, l) and acc partials, f32
    counters: int         # int32 arrival counters (tensor-core route, split keys)


def tc_smem_bytes(hd: int, rows_per_tile: int) -> int:
    """Shared memory of a tensor-core block (``tc::Cfg`` in the source)."""
    decode = rows_per_tile == 16
    keys = 64 if decode or hd != 256 else 32
    ld = hd + 8
    stage = 2 * keys * ld * 2
    q = rows_per_tile * ld * 2
    stages = 3 if decode or 3 * stage + q <= 116 * 1024 else 2
    return stages * stage + q


def plan(dtype: torch.dtype, B_: int, S: int, T: int, H: int, K: int, hd: int,
         causal: bool) -> Plan:
    """How ``flash_attention`` launches (B_, S, T, H, K, hd) inputs of ``dtype``.

    Keys are split when the (row tile, b, kv head) blocks alone cannot fill
    the card's SMs: into as many splits as fit one wave, at most one per
    key tile."""
    rows = S * (H // K)
    if dtype == torch.bfloat16:
        route, rpt = "tensor_cores", (16 if rows <= 16 else 64)
        kpt = 64 if rpt == 16 or hd != 256 else 32
        fill = SMS * max(1, min(2, SMEM_PER_SM // (tc_smem_bytes(hd, rpt) + 1024)))
    elif dtype == torch.float32:
        route, rpt, kpt, fill = "cuda_cores", (8 if rows <= 8 else 32), 32, 2 * SMS
    else:
        raise TypeError(f"flash_attention: dtype {dtype}, the kernel takes float32 or bfloat16")
    row_tiles = -(-rows // rpt)
    base = row_tiles * B_ * K
    tiles = max(1, -(-(min(T, S) if causal else T) // kpt))
    if route == "cuda_cores":  # aims at two blocks an SM
        want = 1 if base >= fill // 2 else min(tiles, -(-fill // base))
    else:
        want = 1 if base >= fill else max(1, min(tiles, fill // base))
    per = -(-tiles // want)
    nsplit = -(-tiles // per)
    ws = counters = 0
    if nsplit > 1:
        ws = 4 * nsplit * B_ * K * rows * (2 + hd)
        counters = row_tiles * B_ * K if route == "tensor_cores" else 0
    return Plan(route, rpt, kpt, row_tiles, per * kpt, nsplit, ws, counters)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"{name}: expected 4 dims, got shape {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name}: on {t.device}, expected {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {q.dtype} (q's)")
    Bq, _S, H, hd = q.shape
    Bk, T, K, hdk = k.shape
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v: shape {tuple(v.shape)}, expected {tuple(k.shape)} (k's)")
    if Bk != Bq or hdk != hd or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: need the same B and "
                         "head_dim and H % K == 0")


def _check_cuda(q, k, v, causal):
    """What a CUDA launch checks beyond ``_check``: (plan, whether every
    stride allows 16-byte loads)."""
    B.check_cuda(q.device)
    Bn, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd}, the kernel takes {HEAD_DIMS}")
    if Bn * K > 65535:
        raise ValueError(f"flash_attention: B·K = {Bn * K}, the grid takes at most 65535")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k, v: the last dim must be contiguous")
    pl = plan(q.dtype, Bn, S, T, H, K, hd, causal)  # raises on any other dtype
    width = 16 // q.element_size()
    return pl, all(st % width == 0 for t in (q, k, v) for st in t.stride()[:3])


_workspace: dict = {}


def workspace(device: torch.device, n: int, kind: str = "partials") -> torch.Tensor:
    """The device's persistent buffer of ``kind``, at least ``n`` long:
    "partials" (bytes) or "counters" (int32).  Grown zeroed, at least
    doubling: the arrival counters must start at 0, and every launch
    leaves them so."""
    key = (device, kind)
    ws = _workspace.get(key)
    if ws is None or ws.numel() < n:
        dtype = torch.uint8 if kind == "partials" else torch.int32
        ws = _workspace[key] = torch.zeros(max(n, 2 * (0 if ws is None else ws.numel())),
                                           dtype=dtype, device=device)
    return ws


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q (B,S,H,hd); k/v (B,T,K,hd) with H % K == 0 → (B,S,H,hd) in q's dtype.

    Query head h attends KV head h // (H/K).  ``causal``: key j is kept
    for query i when j ≤ i (i from 0); otherwise all T keys are kept.
    Inputs may be strided views (the last dim contiguous).
    """
    _check(q, k, v)
    rows = q.shape[0] * q.shape[1]
    if q.device.type == "cpu":
        return profiled("flash_attention", flash_attention_ref, q, k, v, causal, fallback=True,
                        rows=rows, padded=rows)
    pl, strides_vec = _check_cuda(q, k, v, causal)
    return profiled("flash_attention", _launch, q, k, v, causal, pl, strides_vec, rows=rows,
                    padded=rows)


def _launch(q, k, v, causal, pl, strides_vec):
    Bn, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty((Bn, S, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if T == 0:
        return out.zero_()
    arrivals = part_ml = part_acc = None
    if pl.nsplit > 1:
        part_ml = workspace(q.device, pl.workspace_bytes).data_ptr()
        part_acc = part_ml + 8 * pl.nsplit * Bn * S * H  # after (nsplit, B·K, S·G, 2)
        if pl.counters:
            arrivals = workspace(q.device, pl.counters, "counters").data_ptr()
    vec = strides_vec and (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0
    B.launch("svc_flash_attention", _ARGS, q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
             Bn, S, T, H, K, hd, int(causal), 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
             pl.rows_per_tile, pl.chunk, pl.nsplit, int(vec), part_ml, part_acc, arrivals,
             B.stream())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
