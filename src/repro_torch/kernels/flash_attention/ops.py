"""Flash attention over (B, S, H, hd) queries and (B, T, K, hd) keys/values.

``flash_attention`` is the port of ``repro.kernels.flash_attention.ops.
flash_attention``, and the port's models compute all their attention
with it: causal over the prompt in ``forward``/``prefill``, non-causal
against the cache slice ``[:, :pos+1]`` in ``decode_step``.  The hybrid
family's local attention adds the two masks JAX computes outside its
kernel: a banded causal window over the prompt (``window``), and the
ring-buffer decode mask over the slots' positions (``key_pos``, ``qpos``,
``window``).  CPU tensors
take the plain version (``ref.py``); CUDA tensors launch
``csrc/flash_attention.cu`` or raise.  Meta tensors (the dry run's
trace, ``launch.dryrun``) take the plain version too: they hold no data,
so nothing runs and no card is passed over, and ``launches`` does not
move.  The route follows the dtype:
bfloat16 runs on the tensor cores, one launch per call; float32 on the
CUDA cores, with a second launch when the keys are split.

``plan`` is the host side of a launch as a pure function of the shapes:
route, tile, key split and workspace sizes.  The key-split partials live
in one persistent workspace per device, and the tensor-core route's
arrival counters in another (zeroed once; every launch leaves them at 0),
both grown on demand and never shrunk.  They serve one stream: two calls
in flight on different streams would share them.  Every call dispatches
through ``obs.kprof.profiled`` as ``"flash_attention"`` (the JAX package
has no profiled attention: its flash kernel is on no path).  With grad on
and an input that requires it, the call goes through
``autograd.FlashAttention``: the same dispatch forward, and the plain
version's gradient backward (``"flash_attention_bwd"``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.flash_attention.autograd import FlashAttention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.obs.kprof import profiled

HEAD_DIMS = (16, 32, 64, 96, 128, 256)  # the kernel's instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132  # the H100's streaming multiprocessors
SMEM_PER_SM = 232448  # bytes of shared memory one SM gives its blocks
_ARGS = ((B.P, B.P, B.P, B.P) + (B.I64,) * 9 + (B.I32,) * 9 + (B.F32,) + (B.I32,) * 5
         + (B.P,) * 5)


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
         causal: bool, window: int = 0, key_pos: bool = False, qpos: int = 0) -> Plan:
    """How ``flash_attention`` launches (B_, S, T, H, K, hd) inputs of ``dtype``
    (``key_pos``: whether the call passes slot positions).

    Keys are split when the (row tile, b, kv head) blocks alone cannot fill
    the card's SMs: into as many splits as fit one wave, at most one per
    key tile.  A block's keys are those its rows can keep: [0, T), cut at
    the last query's position when causal by index, and, under a window,
    from the first query's position − window + 1 (the splits start
    there)."""
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
    keys = T
    if causal and not key_pos:
        keys = min(T, qpos + S)
        if window > 0:  # a tile's queries span at most (rpt - 1) // G + 2 positions
            keys = min(keys, window + (rpt - 1) // (H // K) + 1)
    tiles = max(1, -(-keys // kpt))
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


def _check_mask(q, k, causal, window, key_pos, qpos):
    if not causal and (window or key_pos is not None or qpos):
        raise ValueError("flash_attention: window, key_pos and qpos refine the causal mask; "
                         "pass causal=True")
    if window < 0 or qpos < 0:
        raise ValueError(f"flash_attention: window {window} and qpos {qpos} must be >= 0")
    if key_pos is None and window > 0 and qpos + q.shape[1] - window >= k.shape[1]:
        # the last row keeps keys (qpos + S − 1 − window, qpos + S − 1], all
        # past the T keys: the plain version raises, the kernel must not run
        raise ValueError("flash_attention: a query row keeps no key under window="
                         f"{window}, qpos={qpos}")
    if key_pos is not None:
        if not isinstance(key_pos, torch.Tensor) or key_pos.dtype != torch.int32:
            raise TypeError("key_pos: expected an int32 tensor")
        if tuple(key_pos.shape) != (k.shape[1],):
            raise ValueError(f"key_pos: shape {tuple(key_pos.shape)}, expected ({k.shape[1]},)")
        if key_pos.device != q.device:
            raise ValueError(f"key_pos: on {key_pos.device}, expected {q.device}")


def _check_cuda(q, k, v, causal, window=0, key_pos=None, qpos=0):
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
    if key_pos is not None and key_pos.stride(0) != 1:
        raise ValueError("key_pos: must be contiguous")
    # raises on any other dtype
    pl = plan(q.dtype, Bn, S, T, H, K, hd, causal, window, key_pos is not None, qpos)
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
                    causal: bool = True, window: int = 0,
                    key_pos: Optional[torch.Tensor] = None, qpos: int = 0) -> torch.Tensor:
    """q (B,S,H,hd); k/v (B,T,K,hd) with H % K == 0 → (B,S,H,hd) in q's dtype.

    Query head h attends KV head h // (H/K).  ``causal``: key j is kept
    for query i when 0 ≤ p_j ≤ qpos + i and, if ``window`` > 0, p_j >
    qpos + i − window, where p_j is ``key_pos[j]`` (an int32 (T,) tensor of
    slot positions, −1 for an empty slot; shared by the batch) or j.  With
    the defaults that is j ≤ i.  Otherwise all T keys are kept.  Inputs
    may be strided views (the last dim contiguous).  Differentiable in q,
    k and v (``autograd.FlashAttention``).
    """
    _check(q, k, v)
    window, qpos = int(window), int(qpos)
    _check_mask(q, k, causal, window, key_pos, qpos)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(_dispatch, q, k, v, bool(causal), window, key_pos, qpos)
    return _dispatch(q, k, v, causal, window, key_pos, qpos)


def _dispatch(q, k, v, causal, window, key_pos, qpos):
    """The checked call's forward: the plain version on the CPU and on
    the meta device, the kernel's launch on the card."""
    rows = q.shape[0] * q.shape[1]
    if q.device.type in ("cpu", "meta"):
        return profiled("flash_attention", flash_attention_ref, q, k, v, causal, window,
                        key_pos, qpos, fallback=True, rows=rows, padded=rows)
    pl, strides_vec = _check_cuda(q, k, v, causal, window, key_pos, qpos)
    return profiled("flash_attention", _launch, q, k, v, causal, pl, strides_vec, window,
                    key_pos, qpos, rows=rows, padded=rows)


def _launch(q, k, v, causal, pl, strides_vec, window=0, key_pos=None, qpos=0):
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
             Bn, S, T, H, K, hd, int(causal), window, qpos, 1.0 / math.sqrt(hd),
             _DTYPES[q.dtype], pl.rows_per_tile, pl.chunk, pl.nsplit, int(vec),
             None if key_pos is None else key_pos.data_ptr(), part_ml, part_acc, arrivals,
             B.stream())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
