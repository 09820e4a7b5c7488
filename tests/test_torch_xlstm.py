"""The ssm family (xLSTM, ``repro_torch.models.xlstm``) against the JAX package.

JAX's ``init`` makes the parameters and ``models.convert.from_jax_params``
carries them into the port; the layer functions take the same numpy
inputs.  Tolerance: 1e-5 relative in float32 (atol 1e-6 near 0), where the
two differ in summation order only.  The mLSTM's normalizer divides by a
sum that cancels (max(|Σ scores|, exp(−m)) in the parallel form, max(|q·n|,
exp(−m)) at decode), so a last-bit difference in that sum moves the output
by up to ~2e-5 of its largest magnitude in both packages (each is that far
from a float64 evaluation; the port nearer).  There the port is held to
JAX normwise, max |port − jax| ≤ 1e-4 · max |jax| (the parallel form, also
no further than JAX from the float64 evaluation), and the decode's state
after 24 steps to rtol 1e-4.  The port's own decode against its forward at JAX's 5e-2
(``tests/test_models_smoke.py``): the mLSTM decode's stabilizer starts at
m = 0 where the parallel form uses the row max.  Tests set torch to one
thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.xlstm as JX
import repro_torch.models.xlstm as TX
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params
from torch_bf16 import compiled, compiled_fn, hold_bf16, jax_activations_in_f32

ARCH = "xlstm-1.3b"
RTOL, ATOL = 1e-5, 1e-6
NORM_TOL = 1e-4  # where the mLSTM's parallel form runs (see above)


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


def _close_norm(got, want, tol=NORM_TOL):
    """max |got − want| ≤ tol · max |want| (normwise)."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"max |got - want| {err} > {tol} * {scale}"


def _x(rng, *shape, scale=1.0):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def test_head_dim_is_twice_d_model_over_the_heads():
    """MLSTM_PF = 2: hd = 2·d_model / mlstm_heads, 1,024 at full size (not
    the config's head_dim)."""
    cfg = get_config(ARCH)
    assert TX.head_dim(cfg) == JX._head_dim(cfg) == 1024 != cfg.head_dim
    assert TX.CHUNK == JX.CHUNK and TX.MLSTM_PF == JX.MLSTM_PF


@pytest.mark.parametrize("S", [1, 40, 256, 512])
def test_mlstm_parallel_matches_jax(S):
    """The stabilized parallel form, one chunk (S ≤ 256) and two (S = 512)."""
    rng = np.random.default_rng(S)
    B, H, hd = 2, 4, 8
    (jq, tq), (jk, tk), (jv, tv) = (_x(rng, B, S, H, hd) for _ in range(3))
    ji, ti = _x(rng, B, S, H)
    jf, tf = _x(rng, B, S, H, scale=2.0)
    jlogf, tlogf = jax.nn.log_sigmoid(jf + 3.0), torch.nn.functional.logsigmoid(tf + 3.0)
    _close(tlogf, jlogf)
    got = TX.mlstm_parallel(tq, tk, tv, ti, tlogf)
    want = np.asarray(JX._mlstm_parallel(jq, jk, jv, ji, jlogf))
    _close_norm(got, want)
    f64 = TX.mlstm_parallel(*(t.double() for t in (tq, tk, tv, ti, tlogf))).numpy()
    assert np.abs(got.numpy() - f64).max() <= np.abs(want - f64).max()
    if S == 512:
        with pytest.raises(ValueError, match="multiple"):
            TX.mlstm_parallel(tq[:, :300], tk[:, :300], tv[:, :300], ti[:, :300], tlogf[:, :300])


def test_activations_match_jax():
    from repro_torch.models import layers as TL

    jx, tx = _x(np.random.default_rng(0), 4000, scale=30.0)
    _close(TL.softplus(tx), jax.nn.softplus(jx))
    _close(TL.log_sigmoid(tx), jax.nn.log_sigmoid(jx))
    _close(TL.gelu(tx), jax.nn.gelu(jx, approximate=True))


def test_mlstm_block_full_and_decode_match_jax(pair):
    _, jp, _, tp, cfg = pair
    jlp = jax.tree.map(lambda a: a[0, 0], jp["mlstm"])
    blk = tp.mlstm[0]
    rng = np.random.default_rng(1)
    jx, tx = _x(rng, 2, 24, cfg.d_model)
    _close_norm(blk.full(tx), JX._mlstm_block_full(jx, jlp, cfg))
    H, hd = cfg.mlstm_heads, TX.head_dim(cfg)
    (jC, tC), (jn, tn), (jm_, tm_) = (_x(rng, 2, H, hd, hd), _x(rng, 2, H, hd),
                                     _x(rng, 2, H, scale=0.5))
    jy, (jC2, jn2, jm2) = JX._mlstm_block_decode(jx[:, :1], jlp, (jC, jn, jm_), cfg)
    ty = blk.decode(tx[:, :1], tC, tn, tm_)  # the state in place
    _close(ty, jy, atol=1e-5)
    for got, want in ((tC, jC2), (tn, jn2), (tm_, jm2)):
        _close(got, want, atol=1e-5)


def test_slstm_block_full_and_decode_match_jax(pair):
    _, jp, _, tp, cfg = pair
    jlp = jax.tree.map(lambda a: a[1], jp["slstm"])
    blk = tp.slstm[1]
    assert blk.R.dtype == blk.b.dtype == torch.float32
    rng = np.random.default_rng(2)
    jx, tx = _x(rng, 2, 30, cfg.d_model)
    _close(blk.full(tx), JX._slstm_block_full(jx, jlp, cfg), atol=1e-5)
    states = [_x(rng, 2, cfg.d_model, scale=0.5) for _ in range(4)]
    jy, jnew = JX._slstm_block_decode(jx[:, :1], jlp, tuple(j for j, _ in states), cfg)
    tstates = [t for _, t in states]
    ty = blk.decode(tx[:, :1], tstates)
    _close(ty, jy, atol=1e-5)
    for got, want in zip(tstates, jnew):
        _close(got, want, atol=1e-5)


def test_init_cache_matches_jax_shapes(pair):
    jm, _, tm, _, cfg = pair
    jc, tc = jm.init_cache(3, 16), tm.init_cache(3, 16)
    assert set(tc) == set(jc)
    jl, tl = jax.tree.leaves(jc), jax.tree.leaves(tc)
    assert [tuple(t.shape) for t in tl] == [tuple(a.shape) for a in jl]
    assert {t.dtype for t in tl} == {torch.float32}
    assert not any(bool(t.any()) for t in tl)


def test_forward_and_decode_steps_match_jax(pair, jax_decode):
    """forward over 40 tokens and 24 decode steps from an empty cache,
    logits and every state leaf."""
    jm, jp, tm, tp, cfg = pair
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert aux == {} and tuple(tl.shape) == (2, 40, cfg.vocab)
    _close_norm(tl, jl)
    jc, tc = jm.init_cache(2, 24), tm.init_cache(2, 24)
    for i in range(24):
        jlg, jc = jax_decode(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        tlg, tc2 = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]), i)
        assert tc2 is tc  # in place
        _close(tlg, jlg, atol=1e-5)
    for jleaf, tleaf in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        _close(tleaf, jleaf, rtol=1e-4, atol=1e-5)


def test_forward_over_two_chunks_matches_jax(pair):
    jm, jp, tm, tp, cfg = pair
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, 512)).astype(np.int32)
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close_norm(tl, jl)


def test_decode_matches_forward(pair):
    """The port's decode against its forward at JAX's 5e-2."""
    _, _, tm, tp, cfg = pair
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (1, 16))
                            .astype(np.int32))
    full, _ = tm.forward(tp, {"tokens": toks})
    cache, outs = tm.init_cache(1, 16), []
    for i in range(16):
        lg, cache = tm.decode_step(tp, cache, toks[:, i:i + 1], i)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), rtol=5e-2, atol=5e-2)


def test_prefill_returns_the_forward_and_a_fresh_cache(pair):
    """A property of the reference kept as it is: prefill's cache is
    ``init_cache``, not the prompt's state."""
    jm, jp, tm, tp, cfg = pair
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=20)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=20)
    _close_norm(tl, jl)
    for got, jleaf in zip(jax.tree.leaves(tc), jax.tree.leaves(jc)):
        assert not bool(got.any()) and got.shape == jleaf.shape and not np.asarray(jleaf).any()


def test_decode_rows_write_only_their_state_rows(pair, jax_decode):
    """``rows`` writes every state leaf at those rows only: the cache JAX's
    full-batch decode plus its engine's masked merge leaves."""
    jm, jp, tm, tp, cfg = pair
    rng = np.random.default_rng(7)
    B = 3
    jc, tc = jm.init_cache(B, 16), tm.init_cache(B, 16)
    for i in range(5):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        _, jc = jax_decode(jp, jc, jnp.asarray(tok), jnp.int32(i))
        tm.decode_step(tp, tc, torch.from_numpy(tok), i)
    before = [t.clone() for t in jax.tree.leaves(tc)]
    tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    jl, jnew = jax_decode(jp, jc, jnp.asarray(tok), jnp.int32(5))
    tl, _ = tm.decode_step(tp, tc, torch.from_numpy(tok), 5, rows=[2])
    _close(tl[[2]], np.asarray(jl)[[2]], atol=1e-5)
    for old, new, got, was in zip(jax.tree.leaves(jc), jax.tree.leaves(jnew),
                                  jax.tree.leaves(tc), before):
        ax = 2 if got.dim() >= 4 else 1  # mLSTM (sb, m_per, B, …), sLSTM (sb, B, d)
        shape = [1] * got.dim()
        shape[ax] = B
        mask = np.array([False, False, True]).reshape(shape)
        _close(got, np.where(mask, np.asarray(new), np.asarray(old)), atol=1e-5)
        assert torch.equal(got.narrow(ax, 0, 2), was.narrow(ax, 0, 2))


def test_from_jax_params_carries_every_leaf(pair):
    """Every leaf lands in the port: the (sb, m_per, …) mLSTM stack super-
    block major, matrices in compute_dtype, b_f, b and R in f32."""
    _, jp, _, tp, cfg = pair
    sb, m_per = TX.n_superblocks(cfg), cfg.slstm_every - 1
    n = 0
    for name, arr in jp["mlstm"].items():
        for s in range(sb):
            for j in range(m_per):
                got = getattr(tp.mlstm[s * m_per + j], name)
                assert np.array_equal(got.numpy(), np.asarray(arr[s, j])), name
                n += 1
    for name, arr in jp["slstm"].items():
        for s in range(sb):
            assert np.array_equal(getattr(tp.slstm[s], name).numpy(), np.asarray(arr[s]))
            n += 1
    assert n + 2 == len(list(tp.parameters()))
    bf16 = from_jax_params(jax.tree.map(np.asarray, jp),
                           dataclasses.replace(cfg, compute_dtype="bfloat16"), device="cpu")
    m, s = bf16.mlstm[0], bf16.slstm[0]
    assert m.b_f.dtype == s.b.dtype == s.R.dtype == m.ln.dtype == torch.float32
    assert m.wq.dtype == m.w_up.dtype == s.W.dtype == s.w_out.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# bfloat16, the served dtype: JAX compiled with the casts its source states
# and its activations rounded once (tests/torch_bf16.py)
# ---------------------------------------------------------------------------

BF16_FORWARD_NORM, BF16_FORWARD_SAME = 2.0 ** -5, 0.8


@pytest.fixture(scope="module")
def pair16():
    """``pair`` with compute_dtype bfloat16 in both packages."""
    jcfg = dataclasses.replace(jax_get_smoke_config(ARCH), compute_dtype="bfloat16")
    jm = jax_get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_smoke_config(ARCH), compute_dtype="bfloat16")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, get_model(cfg, device="cpu"), tp, cfg, jcfg


@pytest.mark.parametrize("S", [40, 256, 512])
def test_mlstm_parallel_bf16_matches_jax(S):
    """The parallel form in bf16: decay and scores materialized in bf16,
    both contractions and the row max in f32, one chunk and two."""
    rng = np.random.default_rng(S)
    B, H, hd = 2, 4, 8
    q, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(3))
    itil = rng.normal(size=(B, S, H)).astype(np.float32)
    logf = np.array(jax.nn.log_sigmoid(jnp.asarray(rng.normal(size=(B, S, H)) * 2.0 + 3.0,
                                                     jnp.float32)))
    want = compiled(JX._mlstm_parallel, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    jnp.asarray(itil), jnp.asarray(logf))
    got = TX.mlstm_parallel(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                            torch.from_numpy(itil), torch.from_numpy(logf))
    hold_bf16(got, want, f"mlstm_parallel S={S}")


@pytest.mark.parametrize("S", [24, 512])
def test_mlstm_block_bf16_matches_jax(pair16, S):
    """One mLSTM layer in bf16, full (one chunk and two) and one decode
    step from a random state: the output within ``hold_bf16``, the f32
    state C, n, m at 1e-5."""
    _, jp, _, tp, cfg, jcfg = pair16
    jlp = jax.tree.map(lambda a: a[0, 0], jp["mlstm"])
    blk = tp.mlstm[0]
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    H, hd = cfg.mlstm_heads, TX.head_dim(cfg)
    C, n = (rng.normal(size=s).astype(np.float32) for s in ((2, H, hd, hd), (2, H, hd)))
    m = (rng.normal(size=(2, H)) * 0.5).astype(np.float32)
    with jax_activations_in_f32():
        want = compiled(lambda a, lp: JX._mlstm_block_full(a, lp, jcfg),
                        jnp.asarray(x, jnp.bfloat16), jlp)
        jy, jstate = compiled(lambda a, lp, s: JX._mlstm_block_decode(a, lp, s, jcfg),
                              jnp.asarray(x[:, :1], jnp.bfloat16), jlp,
                              tuple(map(jnp.asarray, (C, n, m))))
    hold_bf16(blk.full(torch.from_numpy(x).bfloat16()), want, f"mLSTM full S={S}")
    state = [torch.from_numpy(a.copy()) for a in (C, n, m)]
    hold_bf16(blk.decode(torch.from_numpy(x[:, :1]).bfloat16(), *state), jy, "mLSTM decode")
    for got, want_s in zip(state, jstate):
        assert got.dtype == torch.float32
        _close(got, want_s)


def test_slstm_block_bf16_matches_jax(pair16):
    """One sLSTM layer in bf16 (R and b used in f32), full and decode."""
    _, jp, _, tp, cfg, jcfg = pair16
    jlp = jax.tree.map(lambda a: a[1], jp["slstm"])
    blk = tp.slstm[1]
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 30, cfg.d_model)).astype(np.float32)
    states = [(rng.normal(size=(2, cfg.d_model)) * 0.5).astype(np.float32) for _ in range(4)]
    with jax_activations_in_f32():
        want = compiled(lambda a, lp: JX._slstm_block_full(a, lp, jcfg),
                        jnp.asarray(x, jnp.bfloat16), jlp)
        jy, jnew = compiled(lambda a, lp, s: JX._slstm_block_decode(a, lp, s, jcfg),
                            jnp.asarray(x[:, :1], jnp.bfloat16), jlp,
                            tuple(map(jnp.asarray, states)))
    hold_bf16(blk.full(torch.from_numpy(x).bfloat16()), want, "sLSTM full")
    tstates = [torch.from_numpy(s.copy()) for s in states]
    hold_bf16(blk.decode(torch.from_numpy(x[:, :1]).bfloat16(), tstates), jy, "sLSTM decode")
    for got, want_s in zip(tstates, jnew):
        _close(got, want_s)


def test_bf16_forward_and_decode_steps_match_jax(pair16):
    """The model in bf16: 24 decode steps from an empty cache within
    ``hold_bf16`` at every step; the forward over 40 tokens within
    2^-5 of the largest |logit| with 80% of the logits bit-equal (each
    layer's last-bit differences in the parallel form, ``hold_bf16`` at
    block level, carried through 4 layers and the unembedding)."""
    jm, jp, tm, tp, cfg, _ = pair16
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    step = compiled_fn(lambda p, c, t, pos: jm.decode_step(p, c, t, pos))
    with jax_activations_in_f32():
        want = compiled(lambda p, t: jm.forward(p, {"tokens": t})[0], jp, jnp.asarray(toks))
        hold_bf16(tm.forward(tp, {"tokens": torch.from_numpy(toks)})[0], want, "forward",
                  norm=BF16_FORWARD_NORM, same=BF16_FORWARD_SAME)
        jc, tc = jm.init_cache(2, 24), tm.init_cache(2, 24)
        for i in range(24):
            jlg, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
            tlg, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]), i)
            hold_bf16(tlg, jlg, f"decode step {i}")
    for jleaf, tleaf in zip(jax.tree.leaves(jc), jax.tree.leaves(tc)):
        _close(tleaf, jleaf, rtol=1e-4, atol=1e-5)
