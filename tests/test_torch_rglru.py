"""The hybrid family (recurrentgemma, ``repro_torch.models.rglru``) against the JAX package.

JAX's ``init`` makes the parameters and ``models.convert.from_jax_params``
carries them into the port, so both compute the same function; the layer
functions take the same numpy inputs.  Tolerance: 1e-5 relative in float32
(atol 1e-6 for values near 0), where the two differ in summation order
only (the scan's tree, the matrix products, the attention's softmax); the
whole model's logits (~1 in magnitude, after 5 layers and a 512-way
unembedding) are held to rtol 1e-5, atol 1e-5.  The port's own decode
against its forward at JAX's dense 2e-2 (``tests/test_models_smoke.py``).
The smoke config has window 16: S = 40 runs the banded mask, and a decode
past position 16 wraps the ring buffer.  Tests set torch to one thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rglru as JR
import repro_torch.models.rglru as TR
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import get_model as jax_get_model
from repro.models.transformer import build_positions as jax_build_positions
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params
from repro_torch.models.transformer import build_positions
from torch_bf16 import compiled, compiled_fn, hold_bf16, jax_activations_in_f32

ARCH = "recurrentgemma-9b"
RTOL, ATOL = 1e-5, 1e-6
LOGIT_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params, cfg) on the smoke config."""
    jm = jax_get_model(jax_get_smoke_config(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, get_model(cfg, device="cpu"), tp, cfg


@pytest.fixture(scope="module")
def jax_decode(pair):
    """JAX's decode_step, jitted as its serving engine jits it."""
    jm = pair[0]
    return jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _x(rng, *shape):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _layer(jp, tp, stack, i):
    """Layer ``i`` of JAX's stacked ``stack`` and the port's block."""
    return jax.tree.map(lambda a: a[i], jp[stack]), getattr(tp, stack)[i]


@pytest.mark.parametrize("S", [64, 257])
def test_conv_gates_and_scan_match_jax(pair, S):
    """The depthwise causal conv, the RG-LRU gates and the log-depth scan
    (Hillis–Steele here, XLA's associative_scan in JAX)."""
    _, jp, _, tp, cfg = pair
    jlp, blk = _layer(jp, tp, "rec1", 0)
    jx, tx = _x(np.random.default_rng(S), 2, S, cfg.d_model)
    jc, tc = JR._causal_conv1d(jx, jlp["conv_w"]), TR.causal_conv1d(tx, blk.conv_w)
    _close(tc, jc)
    (ja, jb), (ta, tb) = JR._rglru_gates(jc, jlp, jnp.float32), TR.rglru_gates(tc, blk)
    _close(ta, ja)
    _close(tb, jb)
    _close(TR.rglru_scan(ta, tb), JR._rglru_scan(ja, jb), atol=1e-5)
    # the scan is the recurrence h_t = a_t h_{t-1} + b_t
    h, want = torch.zeros_like(tb[:, 0]), []
    for t in range(S):
        h = ta[:, t] * h + tb[:, t]
        want.append(h)
    torch.testing.assert_close(TR.rglru_scan(ta, tb), torch.stack(want, 1), rtol=RTOL, atol=1e-5)


def test_rec_block_full_and_decode_match_jax(pair):
    _, jp, _, tp, cfg = pair
    jlp, blk = _layer(jp, tp, "rec2", 0)
    rng = np.random.default_rng(1)
    jx, tx = _x(rng, 2, 24, cfg.d_model)
    _close(blk.full(tx), JR._rec_block_full(jx, jlp, cfg), atol=1e-5)
    Wc = cfg.rglru_conv_width - 1
    (jh, th), (jcb, tcb) = _x(rng, 2, cfg.d_model), _x(rng, 2, Wc, cfg.d_model)
    jy, (jh2, jcb2) = JR._rec_block_decode(jx[:, :1], jlp, (jh, jcb), cfg)
    ty = blk.decode(tx[:, :1], th, tcb)  # the state in place
    _close(ty, jy, atol=1e-5)
    _close(th, jh2)
    _close(tcb, jcb2)


def test_attn_block_full_runs_the_banded_window(pair):
    """S = 40 > window 16: the flash kernel's window mode equals JAX's
    chunked_attention under local_mask, and K/V equal."""
    _, jp, _, tp, cfg = pair
    jlp, blk = _layer(jp, tp, "attn", 0)
    jx, tx = _x(np.random.default_rng(2), 2, 40, cfg.d_model)
    jy, (jk, jv) = JR._attn_block_full(jx, jlp, jax_build_positions(cfg, 2, 40), cfg)
    ty, tk, tv = blk.full(tx, build_positions(cfg, 2, 40))
    _close(ty, jy, atol=1e-5)
    _close(tk, jk)
    _close(tv, jv)


def test_attn_block_decode_across_the_ring_wrap(pair):
    """Positions 0..39 through a 16-slot ring: each step's output, K/V
    ring and pos_buf equal JAX's."""
    _, jp, _, tp, cfg = pair
    jlp, blk = _layer(jp, tp, "attn", 0)
    B, W = 2, cfg.attn_window
    kv = (B, W, cfg.n_kv_heads, cfg.head_dim)
    jstate = (jnp.zeros(kv), jnp.zeros(kv), jnp.full((W,), -1, jnp.int32))
    tk, tv, tpos = torch.zeros(kv), torch.zeros(kv), torch.full((W,), -1, dtype=torch.int32)
    rng = np.random.default_rng(3)
    for pos in range(40):
        jx, tx = _x(rng, B, 1, cfg.d_model)
        jy, jstate = JR._attn_block_decode(jx, jlp, jstate, jnp.int32(pos), cfg)
        ty = blk.decode(tx, tk, tv, tpos, pos, build_positions(cfg, B, 1, offset=pos))
        _close(ty, jy, atol=1e-5)
    _close(tk, jstate[0])
    _close(tv, jstate[1])
    assert np.array_equal(tpos.numpy(), np.asarray(jstate[2]))
    assert sorted(tpos.tolist()) == list(range(24, 40))  # the ring wrapped


def test_init_cache_matches_jax_shapes(pair):
    jm, _, tm, _, cfg = pair
    for T in (8, 64):
        jc, tc = jm.init_cache(3, T), tm.init_cache(3, T)
        assert set(tc) == set(jc)
        jl, tl = jax.tree.leaves(jc), [t for t in jax.tree.leaves(tc)]
        assert [tuple(t.shape) for t in tl] == [tuple(a.shape) for a in jl]
        assert [str(t.dtype).split(".")[-1] for t in tl] == [str(a.dtype) for a in jl]
        assert int(tc["attn_pos"].min()) == -1 and tc["attn_pos"].shape[1] == min(16, T)


def test_forward_and_decode_steps_match_jax(pair, jax_decode):
    """forward over 40 tokens, then 40 decode steps from an empty cache
    (the ring wraps at 16), logits and every cache leaf."""
    jm, jp, tm, tp, cfg = pair
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert aux == {} and tuple(tl.shape) == (2, 40, cfg.vocab)
    _close(tl, jl, atol=LOGIT_ATOL)
    jc, tc = jm.init_cache(2, 64), tm.init_cache(2, 64)
    for i in range(40):
        jlg, jc = jax_decode(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        tlg, tc2 = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]), i)
        assert tc2 is tc  # in place
        _close(tlg, jlg, atol=LOGIT_ATOL)
    for jleaf, tleaf in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        _close(tleaf, jleaf, atol=1e-5)


def test_decode_matches_forward(pair):
    """The port's token-by-token decode against its forward at JAX's dense
    tolerance (the ring decode and the banded prefill are one function)."""
    _, _, tm, tp, cfg = pair
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (1, 24))
                            .astype(np.int32))
    full, _ = tm.forward(tp, {"tokens": toks})
    cache, outs = tm.init_cache(1, 24), []
    for i in range(24):
        lg, cache = tm.decode_step(tp, cache, toks[:, i:i + 1], i)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), rtol=2e-2, atol=2e-2)


def test_prefill_returns_the_forward_and_a_fresh_cache(pair):
    """A property of the reference kept as it is: prefill's cache is
    ``init_cache``, not the prompt's state."""
    jm, jp, tm, tp, cfg = pair
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=20)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=20)
    _close(tl, jl, atol=LOGIT_ATOL)
    fresh = tm.init_cache(2, 20)
    for got, want, jleaf in zip(jax.tree.leaves(tc), jax.tree.leaves(fresh), jax.tree.leaves(jc)):
        assert torch.equal(got, want)
        assert np.array_equal(got.numpy(), np.asarray(jleaf))


def test_decode_rows_write_state_at_rows_and_pos_buf_always(pair, jax_decode):
    """``rows`` writes K/V and the recurrent states at those rows only and
    ``attn_pos`` on every call: the cache JAX's full-batch decode plus its
    engine's masked merge leaves (a leaf without a batch axis comes from
    the newest decode), and the decoded rows' logits equal JAX's."""
    jm, jp, tm, tp, cfg = pair
    rng = np.random.default_rng(7)
    B = 3
    jc, tc = jm.init_cache(B, 64), tm.init_cache(B, 64)
    for i in range(20):  # fill past the window
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        _, jc = jax_decode(jp, jc, jnp.asarray(tok), jnp.int32(i))
        tm.decode_step(tp, tc, torch.from_numpy(tok), i)
    before = [t.clone() for t in jax.tree.leaves(tc)]
    tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    jl, jnew = jax_decode(jp, jc, jnp.asarray(tok), jnp.int32(20))
    tl, _ = tm.decode_step(tp, tc, torch.from_numpy(tok), 20, rows=[0, 2])
    _close(tl[[0, 2]], np.asarray(jl)[[0, 2]], atol=LOGIT_ATOL)
    mask = np.array([True, False, True])
    for old, new, got, was in zip(jax.tree.leaves(jc), jax.tree.leaves(jnew),
                                  jax.tree.leaves(tc), before):
        old, new = np.asarray(old), np.asarray(new)
        if got.dim() == 2:  # attn_pos (sb, W): no batch axis, the newest decode's
            assert np.array_equal(got.numpy(), new)
            continue
        shape = [1] * old.ndim
        shape[1] = B
        _close(got, np.where(mask.reshape(shape), new, old), atol=1e-5)
        assert torch.equal(got[:, 1], was[:, 1])  # row 1 untouched


def test_from_jax_params_carries_every_leaf(pair):
    """Every leaf of the JAX tree lands in the port at its dtype: matrices
    in compute_dtype, lam, b_a, b_i, conv_w and the norms in f32."""
    _, jp, _, tp, cfg = pair
    n = 0
    for stack in ("rec1", "rec2", "attn", "rec_tail"):
        for name, arr in jp[stack].items():
            for i, blk in enumerate(getattr(tp, stack)):
                assert np.array_equal(getattr(blk, name).numpy(), np.asarray(arr[i])), (stack, name)
                n += 1
    assert np.array_equal(tp.embed.numpy(), np.asarray(jp["embed"]))
    assert n + 2 == len(list(tp.parameters()))
    bf16 = from_jax_params(jax.tree.map(np.asarray, jp),
                           dataclasses.replace(cfg, compute_dtype="bfloat16"), device="cpu")
    blk = bf16.rec1[0]
    assert {blk.lam.dtype, blk.b_a.dtype, blk.b_i.dtype, blk.conv_w.dtype, blk.ln.dtype} == \
        {torch.float32}
    assert blk.w_a.dtype == blk.w_in.dtype == bf16.attn[0].wq.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="keys"):
        from_jax_params({k: v for k, v in jax.tree.map(np.asarray, jp).items() if k != "rec_tail"},
                        cfg, device="cpu")


# ---------------------------------------------------------------------------
# bfloat16, the served dtype: JAX compiled with the casts its source states
# and its activations rounded once (tests/torch_bf16.py)
# ---------------------------------------------------------------------------

BF16_ATTN_NORM = 2.0 ** -6  # the flash plain version's f32 P·V against JAX's bf16 probabilities
BF16_MODEL_NORM = 2.0 ** -5


@pytest.fixture(scope="module")
def pair16():
    """``pair`` with compute_dtype bfloat16 in both packages."""
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), compute_dtype="bfloat16")
    jm = jax_get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="bfloat16")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, get_model(cfg, device="cpu"), tp, cfg, jcfg


def test_bf16_activations_round_once_in_torch():
    """torch's bf16 sigmoid, silu and gelu(tanh) are the float32 function
    rounded once; XLA's, expanded with bf16 intermediates, lie within two
    bf16 steps of them (2^-6 relative), or 2^-8 where XLA's gelu cancels to
    0 in its negative tail.  Under ``jax_activations_in_f32`` sigmoid and
    silu are equal, and gelu 95% equal and within one bf16 step or 2^-16
    (the two float32 gelus differ in their last bits, most where 1 + tanh
    cancels in the negative tail)."""
    x = np.random.default_rng(0).normal(size=20000).astype(np.float32) * 3
    xb = torch.from_numpy(x).bfloat16()
    jb = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    fns = {"sigmoid": (torch.sigmoid, lambda a: jax.nn.sigmoid(a)),
           "silu": (torch.nn.functional.silu, lambda a: jax.nn.silu(a)),
           "gelu": (lambda a: torch.nn.functional.gelu(a, approximate="tanh"),
                    lambda a: jax.nn.gelu(a, approximate=True))}
    for name, (tf, jf) in fns.items():
        got = tf(xb)
        assert torch.equal(got, tf(xb.float()).bfloat16()), name
        xla = np.asarray(compiled(jf, jb), np.float32)
        near = np.abs(got.float().numpy()) * 2.0 ** -6 + 2.0 ** -8
        assert (np.abs(xla - got.float().numpy()) <= near).all(), name
        assert not np.array_equal(xla, got.float().numpy()), name
        with jax_activations_in_f32():
            once = np.asarray(compiled(jf, jb), np.float32)
        got = got.float().numpy()
        assert (once == got).mean() >= (0.95 if name == "gelu" else 1.0), name
        assert (np.abs(once - got) <= np.abs(got) * 2.0 ** -7 + 2.0 ** -16).all(), name


@pytest.mark.parametrize("S", [64, 257])
def test_conv_gates_and_scan_bf16_match_jax(pair16, S):
    """bf16 activations: conv_w cast to bf16 in the conv, b_a and b_i cast
    to bf16 in the gates, lam and the gates' outputs and the scan in f32."""
    _, jp, _, tp, cfg, _ = pair16
    jlp, blk = _layer(jp, tp, "rec1", 0)
    x = np.random.default_rng(S).normal(size=(2, S, cfg.d_model)).astype(np.float32)
    jc = compiled(JR._causal_conv1d, jnp.asarray(x, jnp.bfloat16), jlp["conv_w"])
    tc = TR.causal_conv1d(torch.from_numpy(x).bfloat16(), blk.conv_w)
    hold_bf16(tc, jc, "conv")
    with jax_activations_in_f32():
        ja, jb = compiled(lambda c, lp: JR._rglru_gates(c, lp, jnp.bfloat16), jc, jlp)
    ta, tb = TR.rglru_gates(tc, blk)
    assert ta.dtype == tb.dtype == torch.float32
    _close(ta, ja)
    _close(tb, jb)
    _close(TR.rglru_scan(ta, tb), compiled(JR._rglru_scan, ja, jb), atol=1e-5)


def test_rec_block_bf16_matches_jax(pair16):
    """The rec block in bf16, full (S = 64) and one decode step, where
    conv_w is contracted in f32 and h kept in f32."""
    _, jp, _, tp, cfg, jcfg = pair16
    jlp, blk = _layer(jp, tp, "rec2", 0)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    h = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
    cb = rng.normal(size=(2, cfg.rglru_conv_width - 1, cfg.d_model)).astype(np.float32)
    with jax_activations_in_f32():
        want = compiled(lambda a, lp: JR._rec_block_full(a, lp, jcfg),
                        jnp.asarray(x, jnp.bfloat16), jlp)
        jy, (jh, jcb) = compiled(lambda a, lp, s: JR._rec_block_decode(a, lp, s, jcfg),
                                 jnp.asarray(x[:, :1], jnp.bfloat16), jlp,
                                 (jnp.asarray(h), jnp.asarray(cb, jnp.bfloat16)))
    hold_bf16(blk.full(torch.from_numpy(x).bfloat16()), want, "rec full")
    th, tcb = torch.from_numpy(h.copy()), torch.from_numpy(cb).bfloat16()
    hold_bf16(blk.decode(torch.from_numpy(x[:, :1]).bfloat16(), th, tcb), jy, "rec decode")
    assert th.dtype == torch.float32 and tcb.dtype == torch.bfloat16
    _close(th, jh)
    hold_bf16(tcb, jcb, "conv history")


def test_attn_block_bf16_matches_jax(pair16):
    """The attention block in bf16, full at S = 40 > window 16 and 40
    decode steps across the ring's wrap: K/V within ``hold_bf16``, the
    block's output within 2^-6 of its largest magnitude (the flash plain
    version keeps the probabilities in f32 for P·V, JAX rounds them to
    bf16)."""
    _, jp, _, tp, cfg, jcfg = pair16
    jlp, blk = _layer(jp, tp, "attn", 0)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    jy, (jk, jv) = compiled(lambda a, lp: JR._attn_block_full(
        a, lp, jax_build_positions(jcfg, 2, 40), jcfg), jnp.asarray(x, jnp.bfloat16), jlp)
    ty, tk, tv = blk.full(torch.from_numpy(x).bfloat16(), build_positions(cfg, 2, 40))
    hold_bf16(ty, jy, "attn full", norm=BF16_ATTN_NORM, same=0.0)
    hold_bf16(tk, jk, "attn full k")
    hold_bf16(tv, jv, "attn full v")
    B, W = 2, cfg.attn_window
    kv = (B, W, cfg.n_kv_heads, cfg.head_dim)
    jstate = (jnp.zeros(kv, jnp.bfloat16), jnp.zeros(kv, jnp.bfloat16),
              jnp.full((W,), -1, jnp.int32))
    tk, tv = torch.zeros(kv, dtype=torch.bfloat16), torch.zeros(kv, dtype=torch.bfloat16)
    tpos = torch.full((W,), -1, dtype=torch.int32)
    step = compiled_fn(lambda a, lp, s, pos: JR._attn_block_decode(a, lp, s, pos, jcfg))
    for pos in range(40):
        x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        jy, jstate = step(jnp.asarray(x, jnp.bfloat16), jlp, jstate, jnp.int32(pos))
        ty = blk.decode(torch.from_numpy(x).bfloat16(), tk, tv, tpos, pos,
                        build_positions(cfg, B, 1, offset=pos))
        hold_bf16(ty, jy, f"attn decode {pos}", norm=BF16_ATTN_NORM, same=0.0)
    hold_bf16(tk, jstate[0], "k ring")
    hold_bf16(tv, jstate[1], "v ring")
    assert np.array_equal(tpos.numpy(), np.asarray(jstate[2]))


def test_bf16_forward_and_decode_steps_match_jax(pair16):
    """The model in bf16: the forward over 40 tokens and 40 decode steps
    (the ring wraps at 16) within 2^-5 of the largest |logit| (every
    attention layer's 2^-6, above, carried through 5 layers and the
    unembedding)."""
    jm, jp, tm, tp, cfg, _ = pair16
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    step = compiled_fn(lambda p, c, t, pos: jm.decode_step(p, c, t, pos))
    with jax_activations_in_f32():
        want = compiled(lambda p, t: jm.forward(p, {"tokens": t})[0], jp, jnp.asarray(toks))
        hold_bf16(tm.forward(tp, {"tokens": torch.from_numpy(toks)})[0], want, "forward",
                  norm=BF16_MODEL_NORM, same=0.0)
        jc, tc = jm.init_cache(2, 64), tm.init_cache(2, 64)
        for i in range(40):
            jlg, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
            tlg, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]), i)
            hold_bf16(tlg, jlg, f"decode step {i}", norm=BF16_MODEL_NORM, same=0.0)
