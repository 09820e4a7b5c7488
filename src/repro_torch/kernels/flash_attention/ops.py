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
``autograd.FlashAttention``: on the card its forward is the same launch
writing each row's log-sum-exp beside the output (the ``lse`` pointer,
null on every other call), and its backward is ``flash_attention_bwd``,
the hand-written backward (``csrc/flash_attention_bwd.cu``: D, then the
dK/dV and dQ passes, and the sum of the dK/dV partials where that pass
splits its rows; bfloat16 at head_dim 64, 128 and 256 runs both passes in
one launch on Hopper's warpgroups (wgmma, TMA), other bf16 head dims in
two on mma.sync; ``bwd_plan`` is its host plan as a pure function),
counted in its own ``launches`` and profiled as
``"flash_attention_bwd"``.  CPU and meta tensors keep autograd through
the plain version.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build as B
from repro_torch.kernels.flash_attention.autograd import FlashAttention
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref
from repro_torch.obs.kprof import profiled

HEAD_DIMS = (16, 32, 64, 96, 128, 256)  # the kernel's instantiations
WG_HEAD_DIMS = (64, 128, 256)  # bf16 head dims of the backward's warpgroup route
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132  # the H100's streaming multiprocessors
SMEM_PER_SM = 232448  # bytes of shared memory one SM gives its blocks
_ARGS = ((B.P, B.P, B.P, B.P) + (B.I64,) * 9 + (B.I32,) * 9 + (B.F32,) + (B.I32,) * 5
         + (B.P,) * 6)
_BWD_ARGS = ((B.P,) * 10 + (B.I64,) * 9 + (B.I32,) * 9 + (B.F32, B.I32, B.P) + (B.I32,) * 6
             + (B.P, B.P))


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
    device = B.cuda_device(device)
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
        return FlashAttention.apply(_dispatch, flash_attention_bwd, q, k, v, bool(causal),
                                    window, key_pos, qpos)
    return _dispatch(q, k, v, causal, window, key_pos, qpos)


def _dispatch(q, k, v, causal, window, key_pos, qpos, lse=None):
    """The checked call's forward: the plain version on the CPU and on
    the meta device, the kernel's launch on the card.  ``lse``: a (B, H,
    S) float32 tensor that the call fills with each row's log-sum-exp (the
    training forward's on the card), or None."""
    rows = q.shape[0] * q.shape[1]
    if q.device.type in ("cpu", "meta"):
        if lse is not None:
            return profiled("flash_attention", _ref_into, q, k, v, causal, window, key_pos,
                            qpos, lse, fallback=True, rows=rows, padded=rows)
        return profiled("flash_attention", flash_attention_ref, q, k, v, causal, window,
                        key_pos, qpos, fallback=True, rows=rows, padded=rows)
    pl, strides_vec = _check_cuda(q, k, v, causal, window, key_pos, qpos)
    return profiled("flash_attention", _launch, q, k, v, causal, pl, strides_vec, window,
                    key_pos, qpos, lse, rows=rows, padded=rows)


def _ref_into(q, k, v, causal, window, key_pos, qpos, lse):
    """The plain version's output, its log-sum-exp copied into ``lse``."""
    out, got = flash_attention_ref(q, k, v, causal, window, key_pos, qpos, return_lse=True)
    lse.copy_(got)
    return out


def _launch(q, k, v, causal, pl, strides_vec, window=0, key_pos=None, qpos=0, lse=None):
    Bn, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty((Bn, S, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if T == 0:
        if lse is not None:
            lse.fill_(float("-inf"))  # no key: the log of an empty sum
        return out.zero_()
    arrivals = part_ml = part_acc = None
    if pl.nsplit > 1:
        part_ml = workspace(q.device, pl.workspace_bytes).data_ptr()
        part_acc = part_ml + 8 * pl.nsplit * Bn * S * H  # after (nsplit, B·K, S·G, 2)
        if pl.counters:
            arrivals = workspace(q.device, pl.counters, "counters").data_ptr()
    vec = strides_vec and (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0
    card = q.device.index
    B.launch_on(card, "svc_flash_attention", _ARGS, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                Bn, S, T, H, K, hd, int(causal), window, qpos, 1.0 / math.sqrt(hd),
                _DTYPES[q.dtype], pl.rows_per_tile, pl.chunk, pl.nsplit, int(vec),
                None if key_pos is None else key_pos.data_ptr(), part_ml, part_acc, arrivals,
                B.ptr(lse))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# The backward: csrc/flash_attention_bwd.cu
# ---------------------------------------------------------------------------

class BwdPlan(NamedTuple):
    route: str          # "wgmma" (bf16 at WG_HEAD_DIMS), "tensor_cores" (other bf16,
    #                     mma.sync) or "cuda_cores" (float32)
    dq_rows: int        # rows of a dQ block: flat (query, group head) rows, or on the
    #                     wgmma route queries of one head
    dq_keys: int        # keys a dQ block takes a step
    kv_keys: int        # keys of a dK/dV block
    kv_rows: int        # rows a dK/dV block takes a step (wgmma: queries of one head)
    kv_cols: int        # head_dim columns of dK and dV a dK/dV block writes: all
    dq_blocks: int      # row tiles × B·K (wgmma: query tiles × B·H)
    kv_blocks: int      # key tiles × B·K × kv_splits
    smem: Tuple[int, int]  # shared memory of a (dQ, dK/dV) block: wg::DqSmem and
    #                        wg::KvSmem, tc::DqCfg and tc::DkvCfg (bf16) or cc::Dims (f32)
    kv_splits: int      # runs each key tile's rows are cut into (bf16), 1 for none
    workspace_bytes: int  # the (kv_splits, 2, B, T, K, hd) f32 partials, 0 for none
    scratch: int        # f32 scratch of D (and on the wgmma route lse · log2 e)


def _bwd_pitch(S: int) -> int:
    """The row pitch of the wgmma route's (B, H, pitch) D and lse · log2 e
    (``wg::pitch`` in the source): whole 64-query tiles and two more."""
    return -(-S // 64) * 64 + 128


def bwd_plan(dtype: torch.dtype, B_: int, S: int, T: int, H: int, K: int, hd: int) -> BwdPlan:
    """How ``flash_attention_bwd`` launches (B_, S, T, H, K, hd) inputs of
    ``dtype``: the tiles of ``wg`` (bf16 at WG_HEAD_DIMS), ``tc::Tiles``
    (other bf16) or ``cc`` (f32) in the source, which refuses any other;
    the blocks of its two passes.  On the bf16 routes, where the dK/dV
    pass's blocks cannot fill two waves of the card's SMs (one KV head:
    gemma-2b, the hybrid), each key tile's steps are cut into as many runs
    as fill them, at most 8 and at least 4 steps a run.  The route follows
    the dtype and the head_dim alone."""
    rows = S * (H // K)
    G = H // K
    if dtype == torch.bfloat16 and hd in WG_HEAD_DIMS:
        route = "wgmma"
        # wg::Cfg: at head_dim 64 each warpgroup owns 64 of a block's 128 keys
        # (or queries); else the two share 64.  64 queries (keys) a step.
        solo = hd == 64
        bm, br = (128 if solo else 64), 64
        stages = {64: 4, 128: 3, 256: 2}[hd]  # the ring's slots
        dq_rows = kv_keys = bm
        dq_keys = kv_rows = br
        kv_cols = hd
        tm, tn = bm * hd * 2, br * hd * 2  # resident Q or K, and a ring tile
        smem = (2 * tm + 2 * stages * tn + (0 if solo else 2 * 64 * br * 4) + 64 + 1024,
                2 * tm + 2 * stages * tn + 2 * stages * br * 4 + (0 if solo else 64 * br * 4)
                + 64 + 1024)
        per_block = 1  # 384 threads at 168 registers (240 a consumer): one block an SM
        steps = G * -(-S // br)  # a key tile's steps when every query keeps it
        dq_blocks = -(-S // bm) * B_ * H
    elif dtype == torch.bfloat16:
        dq_rows, kv_keys = 64, 64
        dq_keys = kv_rows = 64 if hd <= 64 else 32
        kv_cols = hd
        ld = (hd + 8) * 2
        smem = (2 * dq_rows * ld + 4 * dq_keys * ld,
                2 * kv_keys * ld + 2 * (2 * kv_rows * ld + 8 * kv_rows))
        route = "tensor_cores"
        per_block = max(1, min(2, SMEM_PER_SM // (smem[1] + 1024)))
        steps = rows // kv_rows
        dq_blocks = -(-rows // dq_rows) * B_ * K
    elif dtype == torch.float32:
        dq_rows = kv_rows = 16
        dq_keys = kv_keys = 32
        kv_cols = hd
        ls, ps = -(-hd // 32) * 32 + 1, 33
        kv = 4 * (2 * 16 * ls + 2 * 32 * ls + 2 * 16 * ps + 2 * 16)
        smem = (kv - 4 * 16 * ps, kv)
        route = "cuda_cores"
        dq_blocks = -(-rows // dq_rows) * B_ * K
    else:
        raise TypeError(f"flash_attention_bwd: dtype {dtype}, the kernel takes float32 or "
                        "bfloat16")
    kv_blocks = -(-T // kv_keys) * B_ * K
    splits = 1
    if route != "cuda_cores":
        fill = SMS * per_block
        if kv_blocks < 2 * fill:
            splits = max(1, min(8, -(-2 * fill // kv_blocks), steps // 4))
    scratch = 2 * B_ * H * _bwd_pitch(S) if route == "wgmma" else B_ * H * S
    return BwdPlan(route, dq_rows, dq_keys, kv_keys, kv_rows, kv_cols, dq_blocks,
                   kv_blocks * splits, smem, splits,
                   0 if splits == 1 else 4 * splits * 2 * B_ * T * K * hd, scratch)


def bwd_products(route: str) -> int:
    """Products over the head_dim that a kept (query, key) pair takes in the
    backward's two passes, each counted at the full head_dim (the bound
    counts 5: S, dO·Vᵀ, dV, dK, dQ).  The bf16 routes: the dK/dV pass
    computes S and dO·Vᵀ once and dV and dK from bf16 hi + lo operands
    (6), the dQ pass S, dO·Vᵀ and dQ as hi + lo (4).  (Before the wgmma
    route, head_dim 256 ran on mma.sync with two column blocks a key tile,
    each computing S and dO·Vᵀ: 12.)  CUDA cores: S and dO·Vᵀ in both
    passes, dV, dK and dQ once in f32 (7)."""
    return 7 if route == "cuda_cores" else 10


def key_range(row0: int, row_end: int, T: int, G: int, causal: bool, window: int = 0,
              key_pos: bool = False, qpos: int = 0) -> Tuple[int, int]:
    """The keys [lo, hi) a block of flat rows [row0, row_end) visits:
    ``causal_range`` of ``csrc/flash_common.cuh`` (the forward's blocks and
    the backward's dQ pass)."""
    if not causal or key_pos:
        return 0, T
    hi = min(T, qpos + (row_end - 1) // G + 1)
    lo = max(0, qpos + row0 // G - window + 1) if window > 0 else 0
    return lo, hi


def row_range(k0: int, k1: int, S: int, G: int, causal: bool, window: int = 0,
              key_pos: bool = False, qpos: int = 0) -> Tuple[int, int]:
    """The flat rows [r0, r1) a block of keys [k0, k1) visits in the
    backward's dK/dV pass: ``causal_rows`` of ``csrc/flash_common.cuh``."""
    if not causal or key_pos:
        return 0, S * G
    r0 = min(S, max(0, k0 - qpos)) * G
    r1 = max(r0, min(S, max(0, k1 - 1 + window - qpos)) * G) if window > 0 else S * G
    return r0, r1


def row_runs(r0: int, r1: int, splits: int, step: int):
    """The runs [a, b) the dK/dV pass cuts a key tile's rows [r0, r1) into
    for ``splits`` blocks: whole ``step``-row steps, in order, the last ones
    possibly empty."""
    run = -(-max(0, -(-(r1 - r0) // splits)) // step) * step
    return [(min(r1, r0 + z * run), min(r1, r0 + (z + 1) * run)) for z in range(splits)]


def wg_schedule(S: int, T: int, G: int, causal: bool, window: int = 0, key_pos: bool = False,
                qpos: int = 0, splits: int = 1, tile: int = 64):
    """The wgmma route's two passes for one (b, kv head), as the source
    walks them: (the dK/dV pass: for each key tile k0 and run z, the
    (group head, first query) of each step in order; the dQ pass: for each
    query tile m0, the first key of each step in order).  A block covers
    ``tile`` keys or queries (``wg::Cfg::BM``: the plan's ``kv_keys`` and
    ``dq_rows``); a dK/dV step is 64 queries of one group head from
    ``row_range``'s first query rounded down to a multiple of 4
    (``s0 &= ~3``); a dQ step is 64 keys over ``key_range``."""
    step = 64
    kv = {}
    for k0 in range(0, T, tile):
        s0, s1 = row_range(k0, min(k0 + tile, T), S, 1, causal, window, key_pos, qpos)
        s0 &= ~3
        per_head = -(-(s1 - s0) // step) if s1 > s0 else 0
        total = G * per_head
        run = -(-total // splits)
        for z in range(splits):
            it0 = min(total, z * run)
            kv[k0, z] = [(it // per_head, s0 + it % per_head * step)
                         for it in range(it0, min(total, it0 + run))]
    dq = {}
    for m0 in range(0, S, tile):
        lo, hi = key_range(m0, min(m0 + tile, S), T, 1, causal, window, key_pos, qpos)
        dq[m0] = list(range(lo, hi, step)) if hi > lo else []
    return kv, dq


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` when its data pointer and every stride allow 16-byte loads of a
    row (the backward's loads all are), else a contiguous copy."""
    width = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(st % width == 0 for st in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, causal: bool = True,
                        window: int = 0, key_pos: Optional[torch.Tensor] = None,
                        qpos: int = 0):
    """(dq, dk, dv) of ``flash_attention(q, k, v, causal, window, key_pos,
    qpos)`` against the output gradient ``dout``, from its output ``o`` and
    the (B, H, S) float32 log-sum-exp ``lse`` the forward wrote; each in
    its input's dtype and contiguous.  CPU and meta tensors take the plain
    version (``ref.flash_attention_bwd_ref``); CUDA tensors launch
    ``csrc/flash_attention_bwd.cu`` or raise.  Dispatched through
    ``profiled`` as ``"flash_attention_bwd"``."""
    _check(q, k, v)
    window, qpos = int(window), int(qpos)
    _check_mask(q, k, causal, window, key_pos, qpos)
    Bn, S, H, hd = q.shape
    for name, t, shape, dtype in (("o", o, q.shape, q.dtype), ("dout", dout, q.shape, q.dtype),
                                  ("lse", lse, (Bn, H, S), torch.float32)):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != tuple(shape) \
                or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be a {dtype} tensor of shape "
                             f"{tuple(shape)} on {q.device}")
    rows = Bn * S
    if q.device.type in ("cpu", "meta"):
        return profiled("flash_attention_bwd", flash_attention_bwd_ref, q, k, v, o, lse, dout,
                        causal, window, key_pos, qpos, fallback=True, rows=rows, padded=rows)
    _check_cuda(q, k, v, causal, window, key_pos, qpos)
    pl = bwd_plan(q.dtype, Bn, S, k.shape[1], H, k.shape[2], hd)
    return profiled("flash_attention_bwd", _launch_bwd, q, k, v, o, lse, dout, causal, window,
                    key_pos, qpos, pl, rows=rows, padded=rows)


def _launch_bwd(q, k, v, o, lse, dout, causal, window, key_pos, qpos, pl):
    Bn, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    dq = torch.empty((Bn, S, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((Bn, T, K, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((Bn, T, K, hd), dtype=v.dtype, device=q.device)
    if dq.numel() == 0 or T == 0:  # no query or no key: every gradient is 0
        return dq.zero_(), dk.zero_(), dv.zero_()
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o, dout = _aligned(o.contiguous()), _aligned(dout.contiguous())
    lse = lse.contiguous()
    delta = torch.empty(pl.scratch, dtype=torch.float32, device=q.device)
    part = (torch.empty(pl.workspace_bytes // 4, dtype=torch.float32, device=q.device)
            if pl.kv_splits > 1 else None)
    card = q.device.index
    B.launch_on(card, "svc_flash_attention_bwd", _BWD_ARGS, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], Bn, S, T, H, K, hd, int(causal), window, qpos,
                1.0 / math.sqrt(hd), _DTYPES[q.dtype],
                None if key_pos is None else key_pos.data_ptr(), pl.dq_rows, pl.dq_keys,
                pl.kv_keys, pl.kv_rows, pl.kv_cols, pl.kv_splits, B.ptr(part))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def bwd_tensor_map_us() -> float:
    """Host µs the last call on the wgmma route spent encoding its four
    TMA tensor maps (part of its enqueue; 0 before any such call)."""
    return B.function("svc_flash_bwd_tmap_ns", ())() / 1e3


flash_attention_bwd.launches = 0
