"""flash_attention: the port's plain version against the JAX package.

The same numpy inputs go through JAX's ``flash_attention`` (the Pallas
kernel in interpret mode, K/V repeated to H) and its ``flash_ref``, and
through the port's ``flash_attention_ref`` and wrapper (which takes the
plain version on CPU tensors and counts no launch).  Shapes are the JAX
sweep of tests/test_kernels.py, plus one-token decode against the cache
slice ``[:, :pos+1]`` (the port's decode) at head_dim 96 and 256.

Tolerances are the JAX sweep's own: 2e-3 in float32 (the two sum the
scores and P·V in other orders; observed ~1e-6), 3e-2 in bfloat16 (the
output is rounded to bf16, ~2^-8 relative, and the two may round one
element to neighbouring values).  The CUDA kernel is held to this plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import flash_ref as jax_flash_ref
from repro.models.layers import decode_mask as jax_decode_mask
from repro.models.layers import gqa_attention as jax_gqa_attention
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

SWEEP = [(2, 128, 4, 4, 64), (1, 300, 8, 2, 32), (2, 256, 4, 1, 128), (1, 64, 2, 2, 16)]
TOL = {"float32": 2e-3, "bfloat16": 3e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU ops run faster on one thread than through the intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rng, B, S, T, H, K, hd, dtype):
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ([jnp.asarray(a, jdt) for a in (q, k, v)],
            [torch.from_numpy(a).to(tdt) for a in (q, k, v)])


def _jax_ref(q, k, v, causal):
    """JAX's flash_ref over (B·H, S, hd), K/V repeated as its ops.py does."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]

    def bh(x, n):
        return jnp.moveaxis(jnp.repeat(x, H // K, 2) if x.shape[2] != H else x, 2, 1).reshape(
            B * H, n, hd)

    o = np.asarray(jax_flash_ref(bh(q, S), bh(k, T), bh(v, T), causal=causal), np.float32)
    return np.moveaxis(o.reshape(B, H, S, hd), 1, 2)


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_sweep(shape, dtype):
    B, S, H, K, hd = shape
    (jq, jk, jv), (q, k, v) = _inputs(np.random.default_rng(S + H), B, S, S, H, K, hd, dtype)
    got = flash_attention_ref(q, k, v, causal=True)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, S, H, hd)
    tol = TOL[dtype]
    want_pallas = np.asarray(jax_flash_attention(jq, jk, jv), np.float32)
    np.testing.assert_allclose(_f32(got), want_pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _jax_ref(jq, jk, jv, True), rtol=tol, atol=tol)


@pytest.mark.parametrize("hd", [96, 256])
@pytest.mark.parametrize("H,K", [(8, 1), (4, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_against_cache_slice_matches_jax(hd, H, K, dtype):
    """S = 1 against the first pos+1 rows of a longer cache: the port's
    non-causal call on the slice view equals JAX's t_valid-masked kernel
    on the same slice and the JAX model's decode_mask attention."""
    B, T, pos = 3, 160, 133
    (jq, jk, jv), (q, k, v) = _inputs(np.random.default_rng(hd + H), B, 1, T, H, K, hd, dtype)
    ks, vs = k[:, :pos + 1], v[:, :pos + 1]
    assert not ks.is_contiguous()  # the decode input is a strided view
    before = flash_attention.launches
    got = flash_attention(q, ks, vs, causal=False)
    assert flash_attention.launches == before  # CPU tensors never launch
    assert torch.equal(got, flash_attention_ref(q, ks, vs, causal=False))
    tol = TOL[dtype]
    want = np.asarray(jax_flash_attention(jq, jk[:, :pos + 1], jv[:, :pos + 1], causal=False),
                      np.float32)
    np.testing.assert_allclose(_f32(got), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _jax_ref(jq, jk[:, :pos + 1], jv[:, :pos + 1], False),
                               rtol=tol, atol=tol)
    model_attn = np.asarray(jax_gqa_attention(jq, jk, jv, jax_decode_mask(T, pos)), np.float32)
    np.testing.assert_allclose(_f32(got), model_attn, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SWEEP)
def test_wrapper_on_cpu_tensors_returns_the_plain_result(shape):
    B, S, H, K, hd = shape
    _, (q, k, v) = _inputs(np.random.default_rng(1), B, S, S, H, K, hd, "float32")
    before = flash_attention.launches
    for causal in (True, False):
        assert torch.equal(flash_attention(q, k, v, causal=causal),
                           flash_attention_ref(q, k, v, causal=causal))
    assert flash_attention.launches == before


def test_causal_prefill_with_fewer_queries_than_keys():
    """Query i keeps keys j ≤ i counted from 0 (the kernel's top-left
    alignment), as JAX's kernel does when S < T."""
    (jq, jk, jv), (q, k, v) = _inputs(np.random.default_rng(5), 2, 40, 72, 4, 2, 32, "float32")
    got = flash_attention(q, k, v, causal=True)
    want = np.asarray(jax_flash_attention(jq, jk, jv, causal=True), np.float32)
    np.testing.assert_allclose(_f32(got), want, rtol=2e-3, atol=2e-3)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 4, 4, 16)
    kv = torch.zeros(1, 4, 3, 16)
    with pytest.raises(ValueError, match="H % K"):
        flash_attention(q, kv, kv)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, torch.zeros(1, 4, 2, 16, dtype=torch.float64),
                        torch.zeros(1, 4, 2, 16, dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, torch.zeros(1, 4, 2, 16), torch.zeros(1, 5, 2, 16))
    with pytest.raises(ValueError, match="4 dims"):
        flash_attention(q[0], kv[0], kv[0])


# ---------------------------------------------------------------------------
# The wrapper's host-side plan (route, tiles, key split, workspace), a pure
# function of the shapes: what a CUDA launch would be given
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    HEAD_DIMS, SMEM_PER_SM, plan, tc_smem_bytes, workspace)

# (B, S, T, H, K, hd, causal): the smoke's shapes and the serve decode
PLAN_SHAPES = [
    (8, 1, 249, 8, 1, 256, False), (32, 1, 32768, 8, 1, 256, False),
    (1, 4096, 4096, 8, 1, 256, True), (2, 1024, 1024, 32, 8, 64, True),
    (2, 1024, 1024, 32, 32, 96, True), (4, 1, 4096, 64, 8, 128, False),
    (3, 1, 1, 16, 1, 64, False), (2, 40, 72, 4, 2, 96, True), (1, 2, 4097, 16, 2, 32, False)]


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_cores"),
                                         (torch.float32, "cuda_cores")])
def test_plan_routes_by_dtype(dtype, route):
    assert plan(dtype, 8, 1, 249, 8, 1, 256, False).route == route
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        plan(torch.float16, 8, 1, 249, 8, 1, 256, False)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plan_tiles_per_head_dim(hd):
    """bf16: a 16-row decode tile (≤ 16 rows) against 64-key tiles, else
    64 rows against 64 keys (32 at hd 256); f32 keeps 8/32 rows × 32 keys."""
    dec = plan(torch.bfloat16, 4, 1, 500, 16, 1, hd, False)
    pre = plan(torch.bfloat16, 1, 300, 300, 8, 2, hd, True)
    assert (dec.rows_per_tile, dec.keys_per_tile) == (16, 64)
    assert (pre.rows_per_tile, pre.keys_per_tile) == (64, 32 if hd == 256 else 64)
    assert pre.row_tiles == -(-300 * 4 // 64)
    f32 = [plan(torch.float32, 4, s, 500, 8, 1, hd, s > 1) for s in (1, 2)]
    assert [(p.rows_per_tile, p.keys_per_tile) for p in f32] == [(8, 32), (32, 32)]
    for rows in (16, 64):
        assert tc_smem_bytes(hd, rows) <= SMEM_PER_SM


def test_tc_shared_memory_matches_the_source():
    """tc::Cfg's stages: three unless two blocks of the prefill tile would
    no longer fit an SM (hd 128, 256); decode always three."""
    assert tc_smem_bytes(256, 64) == 2 * 2 * 32 * 264 * 2 + 64 * 264 * 2
    assert tc_smem_bytes(128, 64) == 2 * 2 * 64 * 136 * 2 + 64 * 136 * 2
    assert tc_smem_bytes(96, 64) == 3 * 2 * 64 * 104 * 2 + 64 * 104 * 2
    assert tc_smem_bytes(256, 16) == 3 * 2 * 64 * 264 * 2 + 16 * 264 * 2


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_splits_cover_the_keys(shape, dtype):
    """Every split holds keys, the splits cover the key span, a chunk is a
    whole number of tiles, the workspace holds the partials, and the
    tensor-core route has one arrival counter per (b·kv, row tile)."""
    B_, S, T, H, K, hd, causal = shape
    p = plan(dtype, B_, S, T, H, K, hd, causal)
    span = min(T, S) if causal else T
    rows = S * (H // K)
    assert p.chunk % p.keys_per_tile == 0
    assert p.chunk * (p.nsplit - 1) < span <= p.chunk * p.nsplit or (p.nsplit == 1 and span <= p.chunk)
    assert p.row_tiles == -(-rows // p.rows_per_tile)
    if p.nsplit == 1:
        assert p.workspace_bytes == p.counters == 0
    else:
        assert p.workspace_bytes == 4 * p.nsplit * B_ * K * rows * (2 + hd)
        assert p.counters == (p.row_tiles * B_ * K if dtype == torch.bfloat16 else 0)


def test_plan_fills_the_card_at_decode_only():
    """The serve decode and DECODE_32K split their keys to fill the SMs in
    one wave; a long prefill has blocks enough and does not split."""
    serve = plan(torch.bfloat16, 8, 1, 249, 8, 1, 256, False)
    assert (serve.chunk, serve.nsplit) == (64, 4)  # one 64-key tile per split
    d32k = plan(torch.bfloat16, 32, 1, 32768, 8, 1, 256, False)
    assert (d32k.chunk, d32k.nsplit) == (8192, 4)  # 32 × 4 = 128 blocks of 132 SMs
    qwen = plan(torch.bfloat16, 4, 1, 4096, 64, 8, 128, False)
    assert qwen.nsplit * 4 * 8 <= 2 * 132 and qwen.nsplit == 8  # two blocks per SM
    assert plan(torch.bfloat16, 1, 4096, 4096, 8, 1, 256, True).nsplit == 1
    # the f32 route: 8 splits of 32 keys, no counters
    f32 = plan(torch.float32, 8, 1, 249, 8, 1, 256, False)
    assert (f32.chunk, f32.nsplit, f32.counters) == (32, 8, 0)


@pytest.mark.parametrize("kind,dtype", [("partials", torch.uint8), ("counters", torch.int32)])
def test_workspace_grows_zeroed_and_is_reused(kind, dtype):
    """Partials and counters are separate buffers: the f32 route's
    partials never overwrite the tensor-core route's counters."""
    dev = torch.device("cpu")
    a = workspace(dev, 100, kind)
    assert a.dtype == dtype and a.numel() >= 100 and not bool(a.any())
    assert workspace(dev, 50, kind) is a
    b = workspace(dev, a.numel() + 1, kind)
    assert b.numel() >= 2 * a.numel() and not bool(b.any())
    assert workspace(dev, 10, kind) is b
    other = "counters" if kind == "partials" else "partials"
    assert workspace(dev, 10, other).data_ptr() != b.data_ptr()


# ---------------------------------------------------------------------------
# The local-attention masks (the hybrid family): a banded causal window over
# the prompt, and the ring-buffer decode mask over slot positions
# ---------------------------------------------------------------------------

from repro.models.layers import local_mask as jax_local_mask  # noqa: E402
from repro_torch.kernels.flash_attention.ref import keep_mask  # noqa: E402


def _ring(W, pos, holes, seed):
    """A (W,) int32 pos_buf after decodes up to ``pos`` wrapped the ring
    (slot p % W holds the newest p), with ``holes`` slots emptied (-1)."""
    buf = np.full(W, -1, np.int32)
    for p in range(pos + 1):
        buf[p % W] = p
    rng = np.random.default_rng(seed)
    empty = rng.choice([s for s in range(W) if s != pos % W], holes, replace=False)
    buf[empty] = -1
    return buf


@pytest.mark.parametrize("S,window", [(40, 16), (33, 1), (24, 64), (300, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_banded_window_matches_jax_local_mask(S, window, dtype):
    """causal=True, window=w equals JAX's gqa_attention under
    local_mask(S, S, w) (rglru's chunked_attention), and keep_mask is
    boolean-equal to local_mask, also at a position offset."""
    (jq, jk, jv), (q, k, v) = _inputs(np.random.default_rng(S + window), 2, S, S, 4, 2, 16,
                                      dtype)
    got = flash_attention(q, k, v, causal=True, window=window)
    want = np.asarray(jax_gqa_attention(jq, jk, jv, jax_local_mask(S, S, window)), np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), want, rtol=tol, atol=tol)
    for off in (0, 7):
        assert np.array_equal(keep_mask(S, S + off, window, qpos=off).numpy(),
                              np.asarray(jax_local_mask(S, S + off, window, offset=off))[0, 0, 0])


@pytest.mark.parametrize("W,pos,holes", [(16, 37, 3), (16, 15, 0), (2048, 4095, 5), (8, 8, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_decode_mask_matches_jax(W, pos, holes, dtype):
    """One query at ``pos`` against a ring of W slots whose pos_buf wrapped
    and has holes: key_pos=pos_buf, qpos=pos, window=W equals JAX's
    gqa_attention under rglru's decode mask (models/rglru.py:208-209)."""
    buf = _ring(W, pos, holes, pos)
    (jq, jk, jv), (q, k, v) = _inputs(np.random.default_rng(W + pos), 2, 1, W, 16, 1, 32, dtype)
    got = flash_attention(q, k, v, key_pos=torch.from_numpy(buf), qpos=pos, window=W)
    pb = jnp.asarray(buf)
    ok = (pb <= pos) & (pb > pos - W) & (pb >= 0)
    want = np.asarray(jax_gqa_attention(jq, jk, jv, ok[None, None, None, None, :]), np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), want, rtol=tol, atol=tol)
    assert np.array_equal(keep_mask(1, W, W, torch.from_numpy(buf), pos)[0].numpy(),
                          np.asarray(ok))


def test_default_masks_are_unchanged():
    """window 0, no key_pos and qpos 0 give the causal result bit for bit,
    and the non-causal mode ignores nothing it used to use."""
    _, (q, k, v) = _inputs(np.random.default_rng(9), 2, 30, 30, 4, 2, 16, "float32")
    base = flash_attention_ref(q, k, v, True)
    assert torch.equal(flash_attention(q, k, v, True, 0, None, 0), base)
    assert torch.equal(flash_attention(q, k, v, True, key_pos=torch.arange(30, dtype=torch.int32)),
                       base)
    assert torch.equal(flash_attention(q, k, v, True, window=30), base)


def test_mask_arguments_are_checked():
    q, kv = torch.zeros(1, 1, 4, 16), torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="causal=True"):
        flash_attention(q, kv, kv, causal=False, window=4)
    with pytest.raises(ValueError, match="causal=True"):
        flash_attention(q, kv, kv, causal=False, key_pos=torch.zeros(8, dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        flash_attention(q, kv, kv, key_pos=torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, kv, kv, key_pos=torch.zeros(7, dtype=torch.int32))
    with pytest.raises(ValueError, match=">= 0"):
        flash_attention(q, kv, kv, window=-1)
    with pytest.raises(ValueError, match="keeps no key"):  # every slot empty
        flash_attention(q, kv, kv, key_pos=torch.full((8,), -1, dtype=torch.int32), qpos=3)


@pytest.mark.parametrize("S,T,window", [(1, 8, 4), (3, 40, 5), (40, 40, 16)])
def test_index_window_past_the_keys_raises(S, T, window):
    """Without key_pos, a window whose last row starts past the T keys
    (qpos + S − window ≥ T) leaves that row no key: the wrapper raises
    before the plain version or a launch, and one position earlier the
    last row keeps key T − 1 alone."""
    q, kv = torch.zeros(1, S, 4, 16), torch.randn(1, T, 2, 16)
    edge = T - S + window  # the first qpos that empties the last row
    with pytest.raises(ValueError, match="keeps no key"):
        flash_attention(q, kv, kv, window=window, qpos=edge)
    before = flash_attention.launches
    out = flash_attention(q, kv, kv, window=window, qpos=edge - 1)
    assert flash_attention.launches == before  # a CPU tensor takes the plain version
    torch.testing.assert_close(out[0, -1], kv[0, -1].repeat_interleave(2, 0))


def _block_ranges(p, S, T, H, K, window, qpos):
    """The kernel's (causal_range) key range of each row tile and split, as
    ``csrc/flash_attention.cu`` computes them (key_pos null)."""
    G, rows = H // K, S * (H // K)
    for tile in range(p.row_tiles):
        row0 = tile * p.rows_per_tile
        row_end = min(row0 + p.rows_per_tile, rows)
        hi = min(T, qpos + (row_end - 1) // G + 1)
        lo = max(0, qpos + row0 // G - window + 1) if window > 0 else 0
        yield row0, row_end, [(lo + z * p.chunk, min(lo + (z + 1) * p.chunk, hi))
                              for z in range(p.nsplit)]


@pytest.mark.parametrize("shape", [(1, 4096, 4096, 16, 1, 256), (2, 40, 40, 4, 1, 16),
                                   (4, 3, 40, 16, 1, 16), (1, 1, 2048, 16, 1, 256),
                                   (3, 17, 80, 8, 2, 64)])
@pytest.mark.parametrize("window,qpos", [(16, 0), (2048, 0), (5, 23), (1, 0)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_window_splits_cover_every_kept_key(shape, window, qpos, dtype):
    """Under a window the splits start at each tile's first kept key: the
    tile's splits, laid end to end, cover every key any of its rows keeps."""
    B_, S, T, H, K, hd = shape
    if qpos + S > T:
        qpos = T - S
    p = plan(dtype, B_, S, T, H, K, hd, True, window, False, qpos)
    keep = keep_mask(S, T, window, qpos=qpos).numpy()
    G = H // K
    for row0, row_end, splits in _block_ranges(p, S, T, H, K, window, qpos):
        covered = np.zeros(T, bool)
        for k0, k1 in splits:
            covered[k0:max(k0, k1)] = True
        need = keep[row0 // G:(row_end - 1) // G + 1].any(0)
        assert not (need & ~covered).any(), (row0, splits)
    assert plan(dtype, B_, S, T, H, K, hd, True, 0, True, 0).chunk * \
        plan(dtype, B_, S, T, H, K, hd, True, 0, True, 0).nsplit >= T  # key_pos: all T slots


# ---------------------------------------------------------------------------
# the gradient (autograd.FlashAttention): the plain version's, which is the
# gradient XLA's autodiff takes of the JAX model's attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,K", [(4, 4), (8, 2), (8, 1)], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("window", [0, 5])
def test_gradients_match_jax_grad_of_gqa_attention(H, K, window):
    """dq, dk, dv of ``flash_attention`` (causal; banded under ``window``)
    on the CPU against ``jax.grad`` of ``repro.models.layers.gqa_attention``
    under ``causal_mask``/``local_mask``, float32, within 1e-5 of each
    gradient's largest magnitude (the same f32 sums in other orders)."""
    import jax

    from repro.models.layers import causal_mask as jax_causal_mask
    from repro.models.layers import local_mask as jax_local_mask

    rng = np.random.default_rng(H * 10 + K + window)
    B, S, hd = 2, 24, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(rng, B, S, S, H, K, hd, "float32")
    g = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    mask = jax_local_mask(S, S, window) if window else jax_causal_mask(S, S)

    def loss(q, k, v):
        return jnp.sum(jax_gqa_attention(q, k, v, mask) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    ins = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = flash_attention(*ins, causal=True, window=window)
    out.backward(torch.from_numpy(g))
    for name, t, w in zip("qkv", ins, want):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max(), name


def test_gradient_launches_once_forward_and_labels_its_backward():
    """With grad on, the forward is the wrapper's one dispatch (as
    ``"flash_attention"``, counting no launch on the CPU); the backward
    dispatches as ``"flash_attention_bwd"``, a kernel-path dispatch
    (fallback False), and leaves the launch count alone.  Without an input
    that requires grad no graph is built."""
    from repro_torch.kernels import set_profiler
    from repro_torch.obs.kprof import KernelProfiler

    rng = np.random.default_rng(3)
    _, (q, k, v) = _inputs(rng, 1, 12, 12, 4, 2, 16, "float32")
    assert not flash_attention(q, k, v).requires_grad
    launches = flash_attention.launches
    prof = KernelProfiler()
    set_profiler(prof)
    try:
        qq = q.clone().requires_grad_(True)
        out = flash_attention(qq, k, v)
        assert out.requires_grad and out.grad_fn is not None
        out.sum().backward()
    finally:
        set_profiler(None)
    ops = prof.summary()
    assert ops["flash_attention"]["dispatches"] == 1
    assert ops["flash_attention_bwd"]["dispatches"] == 1
    assert ops["flash_attention_bwd"]["fallbacks"] == 0
    assert flash_attention.launches == launches
    assert qq.grad is not None and k.grad is None
    with torch.no_grad():
        assert not flash_attention(qq, k, v).requires_grad
