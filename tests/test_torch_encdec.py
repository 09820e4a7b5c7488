"""The port's encoder-decoder (``repro_torch.models.encdec``) against the JAX package's.

JAX's ``init`` makes the seamless-m4t smoke config's parameters and
``models.convert`` carries them over; frames and tokens come from a numpy
seed.  ``encode`` (bidirectional: the flash kernel's non-causal mode at
S = T), ``forward`` (causal self-attention and cross attention at
S_tgt ≠ S_src), ``prefill`` (logits and all four cache leaves) and 8
``decode_step``s agree with JAX within rtol 1e-4 / atol 2e-5 (float32;
the attention sums in another order).  ``decode_step`` with ``rows``
writes the self-attention cache at those rows only and never the memory's
K/V, and the port's decode reproduces its own teacher-forced forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.encdec as JED
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params

ARCH = "seamless-m4t-large-v2"
RTOL, ATOL = 1e-4, 2e-5
LEAVES = ("k", "v", "mem_k", "mem_v")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU ops run faster on one thread than through the intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_smoke_config(ARCH)
    jm = jax_get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = get_smoke_config(ARCH)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, jcfg, get_model(cfg, device="cpu"), tp, cfg


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def _inputs(cfg, B, S_src, S_tgt, seed):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, S_src, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S_tgt)).astype(np.int32)
    return rng, frames, toks


@pytest.mark.parametrize("B,S_src", [(2, 24), (1, 7), (3, 64)])
def test_encode_matches_jax(pair, B, S_src):
    jm, jp, jcfg, tm, tp, cfg = pair
    _, frames, _ = _inputs(cfg, B, S_src, 1, S_src)
    mem = tp.encode(torch.from_numpy(frames))
    assert tuple(mem.shape) == (B, S_src, cfg.d_model)
    _close(mem, JED.encode(jp, jnp.asarray(frames), jcfg))


@pytest.mark.parametrize("S_src,S_tgt", [(24, 9), (5, 12), (16, 1)])
def test_forward_matches_jax(pair, S_src, S_tgt):
    jm, jp, jcfg, tm, tp, cfg = pair
    _, frames, toks = _inputs(cfg, 2, S_src, S_tgt, 1)
    jl, jaux = jm.forward(jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks)})
    assert tuple(tl.shape) == (2, S_tgt, cfg.vocab) and aux == jaux == {}
    _close(tl, jl)


def test_prefill_and_decode_match_jax(pair):
    jm, jp, jcfg, tm, tp, cfg = pair
    rng, frames, toks = _inputs(cfg, 2, 24, 6, 2)
    T = 20
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    jl, jc = jm.prefill(jp, jb, cache_len=T)
    tl, tc = tm.prefill(tp, {"frames": torch.from_numpy(frames),
                             "tokens": torch.from_numpy(toks)}, cache_len=T)
    _close(tl, jl)
    assert tuple(tc["k"].shape) == (cfg.dec_layers, 2, T, cfg.n_kv_heads, cfg.head_dim)
    assert tuple(tc["mem_k"].shape) == (cfg.dec_layers, 2, 24, cfg.n_kv_heads, cfg.head_dim)
    for leaf in LEAVES:
        _close(tc[leaf], jc[leaf])
    assert not tc["k"][:, :, 6:].any() and not tc["v"][:, :, 6:].any()
    mem = {leaf: tc[leaf].clone() for leaf in ("mem_k", "mem_v")}
    for i in range(8):
        tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(6 + i))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), 6 + i)
        assert tuple(tl.shape) == (2, 1, cfg.vocab)
        _close(tl, jl)
    for leaf in LEAVES:
        _close(tc[leaf], jc[leaf])
    for leaf in ("mem_k", "mem_v"):
        assert torch.equal(tc[leaf], mem[leaf])


def test_decode_matches_forward(pair):
    """The prefix's prefill then token-by-token decode reproduce the
    teacher-forced forward over the whole target (the port's own paths:
    causal flash over the prefix, the cache slice after)."""
    _, _, _, tm, tp, cfg = pair
    _, frames, toks = _inputs(cfg, 2, 16, 10, 3)
    fr, tk = torch.from_numpy(frames), torch.from_numpy(toks)
    full, _ = tm.forward(tp, {"frames": fr, "tokens": tk})
    pre, cache = tm.prefill(tp, {"frames": fr, "tokens": tk[:, :3]}, cache_len=10)
    outs = [pre]
    for i in range(3, 10):
        lg, cache = tm.decode_step(tp, cache, tk[:, i:i + 1], i)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=RTOL, atol=ATOL)


def test_decode_rows_write_only_their_cache_rows(pair):
    """``rows`` writes the self-attention cache at those batch rows only
    (JAX's full-batch update plus the engine's masked merge), leaves the
    memory's K/V as they were, and the decoded rows' logits equal JAX's."""
    jm, jp, jcfg, tm, tp, cfg = pair
    rng, frames, toks = _inputs(cfg, 3, 12, 5, 4)
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    _, jc = jm.prefill(jp, jb, cache_len=16)
    _, tc = tm.prefill(tp, {"frames": torch.from_numpy(frames),
                            "tokens": torch.from_numpy(toks)}, cache_len=16)
    before = {leaf: tc[leaf].clone() for leaf in LEAVES}
    tok = rng.integers(0, cfg.vocab, (3, 1)).astype(np.int32)
    jl, jnew = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(5))
    tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok), 5, rows=[0, 2])
    assert tc2 is tc
    keep = np.array([True, False, True])[None, :, None, None, None]
    for leaf in ("k", "v"):
        _close(tc[leaf], np.where(keep, np.asarray(jnew[leaf]), np.asarray(jc[leaf])))
        assert torch.equal(tc[leaf][:, 1], before[leaf][:, 1])
    for leaf in ("mem_k", "mem_v"):
        assert torch.equal(tc[leaf], before[leaf])
    _close(tl[[0, 2]], np.asarray(jl)[[0, 2]])


def test_init_cache_matches_jax_with_and_without_mem_len(pair):
    jm, jp, jcfg, tm, tp, cfg = pair
    from repro_torch.models.encdec import init_cache

    for mem_len in (None, 7):
        jc = JED.init_cache(jcfg, 3, 11, mem_len)
        tc = init_cache(cfg, 3, 11, mem_len)
        assert set(tc) == set(jc)
        for leaf in LEAVES:
            assert tuple(tc[leaf].shape) == jc[leaf].shape and not tc[leaf].any()
    engine_cache = tm.init_cache(2, 9)  # the engine's: a zero memory of length T
    assert tuple(engine_cache["mem_k"].shape) == (cfg.dec_layers, 2, 9, cfg.n_kv_heads,
                                                  cfg.head_dim)


def test_cross_attention_is_the_unmasked_attention():
    """Cross attention and the encoder call the kernel's non-causal mode:
    with S ≠ T it equals gqa_attention with no mask."""
    import repro_torch.models.layers as TL
    from repro_torch.kernels.flash_attention import flash_attention

    g = torch.Generator().manual_seed(0)
    for S, T in ((8, 40), (1, 40), (40, 40)):
        q = torch.randn(2, S, 4, 16, generator=g)
        k, v = torch.randn(2, T, 4, 16, generator=g), torch.randn(2, T, 4, 16, generator=g)
        torch.testing.assert_close(flash_attention(q, k, v, causal=False),
                                   TL.gqa_attention(q, k, v, None), rtol=RTOL, atol=ATOL)


def test_encdec_builds_on_the_card_unless_asked_for_the_cpu():
    import inspect

    from repro_torch.models.encdec import EncDec, EncDecBlock

    for fn in (EncDec.__init__, EncDecBlock.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    cfg = get_smoke_config(ARCH)
    assert {p.device.type for p in EncDec(cfg, "cpu").parameters()} == {"cpu"}
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            EncDec(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            get_model(cfg)


def test_init_draws_from_the_generator():
    cfg = get_smoke_config(ARCH)
    m = get_model(cfg, device="cpu")
    a, b = m.init(0), m.init(torch.Generator().manual_seed(0))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert torch.equal(a.dec[0].ln_x, torch.ones(cfg.d_model))
    assert abs(float(a.embed.std()) - 0.02) < 2e-3
    assert abs(float(a.enc[0].w_down.std()) - cfg.d_ff ** -0.5) < 0.01
    assert abs(float(a.dec[1].xq.std()) - cfg.d_model ** -0.5) < 0.02
