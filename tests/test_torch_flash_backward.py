"""The attention's backward: its plain version in the kernel's form, the
forward's log-sum-exp, and the backward kernel's host plan.

The kernel (``csrc/flash_attention_bwd.cu``) computes dq, dk and dv from
q, k, v, the forward's output o, its per-row log-sum-exp lse and dO, as
``ref.flash_attention_bwd_ref`` does in plain PyTorch.  Here, on the CPU:
the plain lse against numpy's log-sum-exp of the same scaled, masked
scores (float32, within 1e-5 relative plus 1e-5: one f32 reduction in
another order); that plain function against ``jax.grad`` of
``repro.models.layers.gqa_attention`` under each mask (float32, within
1e-5 of each gradient's largest magnitude: the same f32 sums in other
orders); and the host plan (``ops.bwd_plan``, ``key_range``,
``row_range``, ``wg_schedule``, mirrors of the source's tiles and of its
``causal_range`` and ``causal_rows``), which must visit every kept
(query, key) pair exactly once in each of the kernel's two passes, and
on the warpgroup route give each dQ query tile its key tiles in one
fixed order.  The kernel itself is
held to the plain backward on the card (``tests/test_torch_cuda.py -k
flash_bwd``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import causal_mask as jax_causal_mask
from repro.models.layers import gqa_attention as jax_gqa_attention
from repro.models.layers import local_mask as jax_local_mask
from repro_torch.kernels.flash_attention import (flash_attention_bwd, flash_attention_bwd_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention.ops import (HEAD_DIMS, SMEM_PER_SM, WG_HEAD_DIMS,
                                                     _bwd_pitch, _dispatch, bwd_plan, key_range,
                                                     row_range, row_runs, wg_schedule)
from repro_torch.kernels.flash_attention.ref import keep_mask


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU ops run faster on one thread than through the intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring(W, pos, holes, seed):
    """A (W,) int32 ring of slot positions after decodes up to ``pos``,
    ``holes`` slots other than pos's emptied (-1)."""
    buf = np.full(W, -1, np.int32)
    for p in range(max(0, pos - W + 1), pos + 1):
        buf[p % W] = p
    rng = np.random.default_rng(seed)
    others = np.array([s for s in range(W) if s != pos % W])
    buf[rng.permutation(others)[:holes]] = -1
    return torch.from_numpy(buf)


# mode → (S, T, causal, window, qpos, ring)
MODES = {
    "causal": (24, 24, True, 0, 0, False),
    "causal_qpos": (9, 30, True, 0, 21, False),
    "cross": (11, 29, False, 0, 0, False),
    "window": (40, 40, True, 7, 0, False),
    "ring": (3, 16, True, 16, 37, True),
}


def _mask_args(mode):
    S, T, causal, window, qpos, ring = MODES[mode]
    key_pos = _ring(T, qpos + S - 1, 3, S + T) if ring else None
    return S, T, dict(causal=causal, window=window, key_pos=key_pos, qpos=qpos)


@pytest.mark.parametrize("mode", list(MODES))
def test_plain_lse_is_the_logsumexp_of_the_scaled_masked_scores(mode):
    S, T, mask = _mask_args(mode)
    B, H, K, hd = 2, 4, 2, 16
    rng = np.random.default_rng(7)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    out, lse = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), **mask,
                                   return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    kk = np.repeat(k, H // K, axis=2)
    s = np.einsum("bshd,bthd->bhst", q.astype(np.float64), kk) / np.sqrt(hd)
    if mask["causal"]:
        keep = keep_mask(S, T, mask["window"], mask["key_pos"], mask["qpos"]).numpy()
        s = np.where(keep, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    # the call with lse gives the same output
    plain = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), **mask)
    assert torch.equal(out, plain)


@pytest.mark.parametrize("mode", ["causal", "cross", "window"])
@pytest.mark.parametrize("H,K", [(4, 1), (4, 4)], ids=["K1", "KH"])
def test_kernel_form_backward_matches_jax_grad_of_gqa_attention(mode, H, K):
    """dq, dk, dv of ``flash_attention_bwd_ref`` from the plain output and
    lse against ``jax.grad`` of ``gqa_attention`` under ``causal_mask``
    (causal), no mask (cross: S_tgt queries against S_src keys) or
    ``local_mask`` (window), float32, within 1e-5 of each gradient's
    largest magnitude."""
    S, T, mask = _mask_args(mode)
    B, hd = 2, 16
    rng = np.random.default_rng(H * 10 + K + S)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, K, hd)).astype(np.float32)
    g = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    jmask = {"causal": lambda: jax_causal_mask(S, T), "cross": lambda: None,
             "window": lambda: jax_local_mask(S, T, mask["window"])}[mode]()

    def loss(q, k, v):
        return jnp.sum(jax_gqa_attention(q, k, v, jmask) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = flash_attention_ref(tq, tk, tv, **mask, return_lse=True)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, tg, **mask)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert a.dtype == torch.float32 and tuple(a.shape) == w.shape
        assert np.abs(a.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_form_backward_equals_autograd_of_the_plain_version(mode):
    """Every mask mode, the ring slots included (which JAX computes outside
    any attention function): the kernel's form against autograd of
    ``flash_attention_ref``, float32, within 1e-5 of each largest."""
    from repro_torch.kernels.flash_attention.autograd import plain_grad

    S, T, mask = _mask_args(mode)
    g = torch.Generator().manual_seed(S * T)
    q, k, v, dout = (torch.randn(shape, generator=g) for shape in
                     ((2, S, 4, 32), (2, T, 1, 32), (2, T, 1, 32), (2, S, 4, 32)))
    o, lse = flash_attention_ref(q, k, v, **mask, return_lse=True)
    got = flash_attention_bwd_ref(q, k, v, o, lse, dout, **mask)
    want = plain_grad(q, k, v, dout, mask["causal"], mask["window"], mask["key_pos"],
                      mask["qpos"])
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_the_wrapper_takes_the_plain_version_on_the_cpu_and_meta():
    """On CPU tensors ``flash_attention_bwd`` is the plain version (a
    fallback dispatch under ``"flash_attention_bwd"``) and counts no
    launch; on meta tensors it returns meta tensors of the inputs' shapes
    and runs nothing; a forward asked for lse on the CPU fills it with the
    plain one; a wrong lse is refused."""
    from repro_torch.kernels import set_profiler
    from repro_torch.obs.kprof import KernelProfiler

    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(s, generator=g) for s in
                     ((2, 12, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16), (2, 12, 4, 16)))
    lse = torch.full((2, 4, 12), float("nan"))
    o = _dispatch(q, k, v, True, 0, None, 0, lse)
    want_o, want_lse = flash_attention_ref(q, k, v, return_lse=True)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    before = flash_attention_bwd.launches
    prof = set_profiler(KernelProfiler())
    try:
        got = flash_attention_bwd(q, k, v, o, lse, dout)
    finally:
        set_profiler(None)
    st = prof.summary()["flash_attention_bwd"]
    assert (st["dispatches"], st["fallbacks"]) == (1, 1)
    assert flash_attention_bwd.launches == before
    for a, b in zip(got, flash_attention_bwd_ref(q, k, v, o, lse, dout)):
        assert torch.equal(a, b)
    meta = [t.to("meta") for t in (q, k, v, o, lse, dout)]
    dq, dk, dv = flash_attention_bwd(*meta)
    assert [t.device.type for t in (dq, dk, dv)] == ["meta"] * 3
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert flash_attention_bwd.launches == before
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, lse[:, :, :-1], dout)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q, k, v, o, lse, dout.double())


# ---------------------------------------------------------------------------
# the backward kernel's host plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_bwd_plan_mirrors_the_source_tiles(hd):
    """bf16 at head_dim 64, 128 and 256 (``wg``): dQ blocks of 64 queries
    of one head (128 at hd 64) against 64 keys a step, dK/dV blocks of 64
    keys (128 at hd 64) over every column, 64 queries a step.  Other bf16 head dims (``tc::Tiles``): dQ
    blocks of 64 flat rows against 64 keys a step (32 at hd 96); dK/dV
    blocks of 64 keys over at most 128 of the columns, 64 rows a step (32
    at 96 columns).  float32 (``cc``): 16 rows × 32 keys, every column."""
    bf = bwd_plan(torch.bfloat16, 8, 512, 512, 8, 1, hd)
    if hd in WG_HEAD_DIMS:
        assert bf.route == "wgmma"
        bm = 128 if hd == 64 else 64
        assert (bf.dq_rows, bf.dq_keys, bf.kv_keys, bf.kv_rows, bf.kv_cols) == (bm, 64, bm, 64, hd)
        assert bf.dq_blocks == 512 // bm * 8 * 8  # query tiles × B·H
        assert bf.scratch == 2 * 8 * 8 * _bwd_pitch(512)
    else:
        assert bf.route == "tensor_cores"
        assert (bf.dq_rows, bf.kv_keys) == (64, 64)
        assert bf.dq_keys == {16: 64, 32: 64, 96: 32}[hd]
        assert bf.kv_rows == {16: 64, 32: 64, 96: 32}[hd]
        assert bf.dq_blocks == 512 * 8 // 64 * 8
        assert bf.scratch == 8 * 8 * 512
    assert bf.kv_cols == hd  # a block writes every column
    assert bf.kv_blocks == 512 // bf.kv_keys * 8 * bf.kv_splits
    f32 = bwd_plan(torch.float32, 8, 512, 512, 8, 1, hd)
    assert (f32.route, f32.dq_rows, f32.dq_keys, f32.kv_keys, f32.kv_rows, f32.kv_cols) == \
        ("cuda_cores", 16, 32, 32, 16, hd)
    assert (f32.kv_splits, f32.workspace_bytes) == (1, 0)


def test_bwd_plan_splits_the_rows_only_where_the_blocks_cannot_fill_the_card():
    """gemma-2b's and the hybrid's training shapes (one KV head, 64 dK/dV
    blocks of 210 KB, one an SM) cut each key tile's steps into 5 runs
    of f32 partials; seamless's (1,024 blocks) and every float32 call do
    not; a run is at least 4 steps, so short sequences split less."""
    for shape in ((8, 512, 512, 8, 1, 256), (1, 4096, 4096, 16, 1, 256)):
        pl = bwd_plan(torch.bfloat16, *shape)
        B_, S, T, H, K, hd = shape
        assert (pl.route, pl.kv_splits, pl.kv_blocks) == ("wgmma", 5, 320)
        assert pl.workspace_bytes == 4 * 5 * 2 * B_ * T * K * hd
    assert bwd_plan(torch.bfloat16, 8, 512, 512, 16, 16, 64).kv_splits == 1
    assert bwd_plan(torch.float32, 8, 512, 512, 8, 1, 256).kv_splits == 1
    # 4 heads × 2 query tiles: 8 steps a key tile, two runs of 4
    assert bwd_plan(torch.bfloat16, 2, 77, 77, 4, 1, 64).kv_splits == 2
    assert bwd_plan(torch.bfloat16, 2, 77, 77, 4, 1, 256).kv_splits == 2
    assert bwd_plan(torch.bfloat16, 2, 77, 77, 4, 1, 96).kv_splits == 2  # 308 rows: 9 steps of 32
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bwd_plan(torch.float16, 1, 1, 1, 1, 1, 256)


def test_bwd_shared_memory_matches_the_source():
    """``wg::DqSmem::SMEM`` (Q and dO of 128 rows at head_dim 64 and of 64
    above, the ring's slots of K and V: four at 64, three at 128, two at
    256; the P and dP exchange where the warpgroups share rows, the
    barriers, the base's alignment) and ``wg::KvSmem::SMEM`` (K and V, the
    ring's slots of Q, dO, lse and D, the Pᵀ exchange), ``tc::DqCfg::SMEM``, ``tc::DkvCfg::SMEM`` and
    ``cc::Dims::SMEM``, each within the 227 KB a block may use."""
    def smem(dtype, hd):
        return bwd_plan(dtype, 1, 1, 1, 1, 1, hd).smem

    for hd, bm, stages, x in ((64, 128, 4, 0), (128, 64, 3, 1), (256, 64, 2, 1)):
        tm, tn = bm * hd * 2, 64 * hd * 2
        assert smem(torch.bfloat16, hd) == (2 * tm + 2 * stages * tn + x * 2 * 64 * 64 * 4
                                            + 64 + 1024,
                                            2 * tm + 2 * stages * tn + 2 * stages * 64 * 4
                                            + x * 64 * 64 * 4 + 64 + 1024)
    assert smem(torch.bfloat16, 256) == (230464, 215104)
    assert smem(torch.bfloat16, 96) == (2 * 64 * 104 * 2 + 4 * 32 * 104 * 2,
                                        2 * 64 * 104 * 2 + 2 * (2 * 32 * 104 * 2 + 8 * 32))
    assert smem(torch.bfloat16, 32) == (2 * 64 * 40 * 2 + 4 * 64 * 40 * 2,
                                        2 * 64 * 40 * 2 + 2 * (2 * 64 * 40 * 2 + 8 * 64))
    ls = 256 + 1
    kv = 4 * (2 * 16 * ls + 2 * 32 * ls + 2 * 16 * 33 + 2 * 16)
    assert smem(torch.float32, 256) == (kv - 4 * 16 * 33, kv)
    for dtype in (torch.bfloat16, torch.float32):
        for hd in HEAD_DIMS:
            assert max(smem(dtype, hd)) <= SMEM_PER_SM


PLAN_CASES = [  # (B, S, T, H, K, hd) and a mode
    ((1, 300, 300, 4, 1, 256), "causal"), ((2, 77, 77, 8, 2, 64), "causal"),
    ((8, 512, 512, 8, 1, 256), "causal"),  # gemma-2b's training shape: 5 runs
    ((1, 40, 100, 4, 1, 128), "causal_qpos"), ((1, 3, 40, 16, 1, 16), "causal_qpos"),
    ((2, 77, 130, 4, 4, 96), "cross"), ((1, 150, 150, 4, 1, 256), "window"),
    ((1, 500, 500, 16, 1, 32), "window_wide"), ((1, 100, 100, 2, 1, 16), "window_one"),
    ((2, 4, 64, 4, 1, 16), "ring"),
]
PLAN_MASKS = {"causal": dict(causal=True), "causal_qpos": dict(causal=True, qpos=None),
              "cross": dict(causal=False), "window": dict(causal=True, window=40),
              "window_wide": dict(causal=True, window=200),
              "window_one": dict(causal=True, window=1),
              "ring": dict(causal=True, window=64, ring=True)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,mode", PLAN_CASES)
def test_bwd_plan_visits_every_kept_pair_once_per_pass(dtype, shape, mode):
    """The dQ pass (row tiles × ``key_range``) and the dK/dV pass (key tiles
    × ``row_range``, per column slice) each visit every kept (flat row,
    key) pair exactly once; the pairs they visit and do not keep are
    masked in the kernel."""
    B_, S, T, H, K, hd = shape
    m = dict(PLAN_MASKS[mode])
    ring = m.pop("ring", False)
    causal, window = m["causal"], m.get("window", 0)
    qpos = T - S if "qpos" in m else 0
    key_pos = _ring(T, qpos + S - 1 + 97, 5, S) if ring else None
    if ring:
        qpos += 97
    G, rows = H // K, S * (H // K)
    keep = (keep_mask(S, T, window, key_pos, qpos).numpy() if causal
            else np.ones((S, T), bool))
    keep = np.repeat(keep, G, axis=0)  # flat rows: s·G + g
    assert keep.any(1).all()
    pl = bwd_plan(dtype, B_, S, T, H, K, hd)
    dq = np.zeros((rows, T), int)
    kv = np.zeros((rows, T), int)
    if pl.route == "wgmma":  # 64 queries of one head a tile; flat row s·G + g
        br, bm = pl.kv_rows, pl.kv_keys
        kv_steps, dq_steps = wg_schedule(S, T, G, causal, window, ring, qpos, pl.kv_splits, bm)
        for m0, starts in dq_steps.items():
            lo, hi = key_range(m0, min(m0 + bm, S), T, 1, causal, window, ring, qpos)
            for t0 in starts:  # masked at hi
                for g in range(G):
                    dq[np.arange(m0, min(m0 + bm, S)) * G + g, t0:min(t0 + br, hi)] += 1
        for (k0, _z), steps in kv_steps.items():
            for g, s0 in steps:
                kv[np.arange(s0, min(s0 + br, S)) * G + g, k0:min(k0 + bm, T)] += 1
    else:
        for row0 in range(0, rows, pl.dq_rows):
            row_end = min(row0 + pl.dq_rows, rows)
            lo, hi = key_range(row0, row_end, T, G, causal, window, ring, qpos)
            for t0 in range(lo, hi, pl.dq_keys):  # the kernel's steps, masked at hi
                dq[row0:row_end, t0:min(t0 + pl.dq_keys, hi)] += 1
        for k0 in range(0, T, pl.kv_keys):
            k1 = min(k0 + pl.kv_keys, T)
            for a, b in row_runs(*row_range(k0, k1, S, G, causal, window, ring, qpos),
                                 pl.kv_splits, pl.kv_rows):  # one block each
                for b0 in range(a, b, pl.kv_rows):
                    kv[b0:min(b0 + pl.kv_rows, b), k0:k1] += 1
    assert (dq[keep] == 1).all()
    assert dq.max() <= 1
    assert (kv[keep] == 1).all()
    assert kv.max() <= 1
    if window and not ring:  # a band's bounds skip the tiles it does not reach
        assert dq.sum() < rows * T and kv.sum() < rows * T


WG_MODES = {  # (S, T, G, mask): causal, causal after cached keys, banded, ring, non-causal
    "causal": (300, 300, 8, dict(causal=True)),
    "causal_qpos": (70, 200, 3, dict(causal=True, qpos=130)),
    "banded": (500, 500, 16, dict(causal=True, window=200)),
    "banded_narrow": (150, 150, 2, dict(causal=True, window=7)),
    "ring": (4, 128, 8, dict(causal=True, window=128, ring=True)),
    "noncausal": (100, 230, 1, dict(causal=False)),
}


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("splits", [1, 3, 5])
@pytest.mark.parametrize("mode", list(WG_MODES))
def test_wg_schedule_visits_every_kept_pair_once_in_a_fixed_order(mode, splits, tile):
    """The warpgroup route's schedule (``wg_schedule``, the source's
    loops): each pass visits every kept (query, head, key) pair exactly
    once, whatever the dK/dV pass's split; a dK/dV key tile's runs are
    consecutive slices of one step sequence (heads in order, each over its
    queries in order, a first query aligned to 4 for the lse and D copies);
    each dQ query tile takes its key tiles in one fixed order, ascending
    and a step (64) apart from the first its queries can keep.  Blocks of
    64 (head_dim 128 and 256) and 128 keys or queries (head_dim 64)."""
    S, T, G, m = WG_MODES[mode]
    m = dict(m)
    ring = m.pop("ring", False)
    causal, window, qpos = m["causal"], m.get("window", 0), m.get("qpos", 0)
    key_pos = None
    if ring:
        qpos = 1000
        key_pos = _ring(T, qpos + S - 1, 9, T)
    keep = (keep_mask(S, T, window, key_pos, qpos).numpy() if causal
            else np.ones((S, T), bool))
    step = 64
    kv_steps, dq_steps = wg_schedule(S, T, G, causal, window, ring, qpos, splits, tile)
    one = wg_schedule(S, T, G, causal, window, ring, qpos, 1, tile)[0]
    kv = np.zeros((G, S, T), int)
    for k0 in range(0, T, tile):
        runs = [kv_steps[k0, z] for z in range(splits)]
        assert sum(runs, []) == one[k0, 0]  # the split keeps the order
        for g, s0 in one[k0, 0]:
            assert s0 % 4 == 0 and 0 <= g < G
            kv[g, s0:s0 + step, k0:k0 + tile] += 1
    dq = np.zeros((G, S, T), int)
    for m0, starts in dq_steps.items():
        assert starts == sorted(starts) and all(b - a == step for a, b in zip(starts, starts[1:]))
        lo, hi = key_range(m0, min(m0 + tile, S), T, 1, causal, window, ring, qpos)
        for t0 in starts:
            dq[:, m0:m0 + tile, t0:min(t0 + step, hi)] += 1
    for got in (kv, dq):
        assert (got[:, keep] == 1).all(), mode
        assert got.max() <= 1
    assert wg_schedule(S, T, G, causal, window, ring, qpos, splits, tile)[1] == dq_steps
