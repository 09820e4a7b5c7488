"""The port's transformer (dense, moe and vlm families) against the JAX package.

JAX's ``init`` makes the parameters; ``repro_torch.models.convert`` carries
them (as numpy arrays) into the port, so both packages compute the same
function.  Over the dense smoke configs (float32), the port's ``forward``
logits, ``prefill`` logits and cache, and 8 ``decode_step``s (logits and
cache) agree with JAX within rtol 1e-4, atol 2e-5: the two sum the
matrix products and the attention in other orders (the port's attention
is the flash kernel's plain version, JAX's the XLA softmax); the observed
gap is ~1e-6 on logits of magnitude ~1.  The port's own decode path
agrees with its forward within the same tolerance, and each layer
function agrees with JAX's on the same inputs (masks exactly).
``param_counts`` equals JAX's exactly for the four dense full configs
and for granite-moe-3b-a800m, grok-1-314b, qwen2-vl-72b,
seamless-m4t-large-v2, recurrentgemma-9b (9,396,301,824) and xlstm-1.3b
(1,840,990,376) (meta device, no allocation).  ``get_model`` serves every
config; the hybrid and ssm families have their own parity files
(``test_torch_rglru.py``, ``test_torch_xlstm.py``).

The moe and vlm smoke configs (granite-moe, grok-1, qwen2-vl with and
without its vision stub) hold ``forward`` (logits and the (L, E)
``moe_load``, exactly), ``prefill`` and 8 ``decode_step``s to JAX at the
same tolerance.  M-RoPE positions are held exactly and ``apply_mrope``
within it.  A MoE call's capacity comes from all B·S tokens, so forward
and prefill may drop pairs where token-by-token decode does not: the
port's decode is held to its own forward only where B·S ≤ 8 (capacity
is at least 8, and a token sends at most one pair to each expert).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
import repro_torch.models.layers as TL
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import get_model as jax_get_model
from repro.models.api import param_counts as jax_param_counts
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.api import param_counts
from repro_torch.models.convert import from_jax_params

DENSE = ["gemma-2b", "gemma-7b", "granite-3-2b", "phi3-mini-3.8b"]
MOE = ["granite-moe-3b-a800m", "grok-1-314b"]
VLM = "qwen2-vl-72b"
RTOL, ATOL = 1e-4, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU ops run faster on one thread than through the intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, seed=0):
    jm = jax_get_model(jax_get_smoke_config(arch))
    jp = jm.init(jax.random.PRNGKey(seed))
    cfg = get_smoke_config(arch)
    params = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, get_model(cfg, device="cpu"), params, cfg


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_layers_match_jax(act):
    """Each layer function on the same numpy inputs: norms, rope, the
    plain attention under each mask, the GLU MLP and the q/k/v split.
    The masks are boolean-equal."""
    rng = np.random.default_rng(0)
    B, S, H, K, hd, d, F = 2, 12, 4, 2, 16, 32, 48

    def pair(*shape):
        a = rng.normal(size=shape).astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a)

    (jx, tx), (jw, tw) = pair(B, S, d), pair(d)
    _close(TL.rmsnorm(tx, tw, 1e-6), JL.rmsnorm(jx, jw, 1e-6))
    (jq, tq), (jk, tk), (jv, tv) = pair(B, S, H, hd), pair(B, S, K, hd), pair(B, S, K, hd)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32) + 5, (B, S))
    _close(TL.apply_rope(tq, torch.from_numpy(pos.copy()), 1e4),
           JL.apply_rope(jq, jnp.asarray(pos), 1e4))
    masks = [(TL.causal_mask(S, S), JL.causal_mask(S, S)),
             (TL.causal_mask(S, S, offset=3), JL.causal_mask(S, S, offset=3)),
             (TL.local_mask(S, S, 4), JL.local_mask(S, S, 4)),
             (TL.decode_mask(S, 7), JL.decode_mask(S, 7)),
             (TL.decode_mask(S, 7, window=3), JL.decode_mask(S, 7, window=3)),
             (None, None)]
    for tm, jm in masks:
        if tm is not None:
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        _close(TL.gqa_attention(tq, tk, tv, tm), JL.gqa_attention(jq, jk, jv, jm))
    (jg, tg), (ju, tu), (jd, td) = pair(d, F), pair(d, F), pair(F, d)
    _close(TL.glu_mlp(tx, tg, tu, td, act), JL.glu_mlp(jx, jg, ju, jd, act))
    (jwq, twq), (jwk, twk), (jwv, twv) = pair(d, H * hd), pair(d, K * hd), pair(d, K * hd)
    for t, j in zip(TL.qkv_project(tx, twq, twk, twv, H, K, hd),
                    JL.qkv_project(jx, jwq, jwk, jwv, H, K, hd)):
        _close(t, j)


def test_flash_attention_is_the_models_masked_attention():
    """The transformer's two calls of flash_attention compute the model's
    masked attention: causal over the prompt equals gqa_attention under
    causal_mask, and the non-causal call on the cache slice [:, :pos+1]
    equals gqa_attention under decode_mask(T, pos) on the whole cache."""
    from repro_torch.kernels.flash_attention import flash_attention

    g = torch.Generator().manual_seed(0)
    B, S, T, H, K, hd, pos = 2, 24, 40, 8, 2, 32, 29
    q, k, v = (torch.randn(shape, generator=g) for shape in
               ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    torch.testing.assert_close(flash_attention(q, k, v, causal=True),
                               TL.gqa_attention(q, k, v, TL.causal_mask(S, S)),
                               rtol=RTOL, atol=ATOL)
    kc, vc = torch.randn(B, T, K, hd, generator=g), torch.randn(B, T, K, hd, generator=g)
    torch.testing.assert_close(flash_attention(q[:, :1], kc[:, :pos + 1], vc[:, :pos + 1],
                                               causal=False),
                               TL.gqa_attention(q[:, :1], kc, vc, TL.decode_mask(T, pos)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_and_decode_match_jax(arch):
    jm, jp, tm, tp, cfg = _pair(arch)
    rng = np.random.default_rng(0)
    B, S, T = 2, 20, 32
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)

    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tuple(tl.shape) == (B, S, cfg.vocab) and tl.dtype == torch.float32
    assert tuple(aux["moe_load"].shape) == (cfg.n_layers, 1)
    _close(tl, jl)

    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=T)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=T)
    _close(tl, jl)
    for leaf in ("k", "v"):
        assert tuple(tc[leaf].shape) == (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.head_dim)
        _close(tc[leaf], jc[leaf])
        assert not tc[leaf][:, :, S:].any()  # padded past the prompt with zeros

    for i in range(8):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(S + i))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), S + i)
        assert tuple(tl.shape) == (B, 1, cfg.vocab)
        _close(tl, jl)
    for leaf in ("k", "v"):
        _close(tc[leaf], jc[leaf])


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """Token-by-token decode from an empty cache reproduces the
    teacher-forced forward (the port's own paths, causal vs cache slice)."""
    _, _, tm, tp, cfg = _pair(arch, seed=3)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (1, 8)).astype(np.int32))
    full, _ = tm.forward(tp, {"tokens": toks})
    cache = tm.init_cache(1, 8)
    outs = []
    for i in range(8):
        lg, cache = tm.decode_step(tp, cache, toks[:, i:i + 1], i)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), rtol=RTOL, atol=ATOL)


def test_decode_rows_write_only_their_cache_rows():
    """``rows`` writes the cache in place at those batch rows only: the
    cache JAX's full-batch update plus the engine's masked merge gives, and
    the decoded rows' logits equal JAX's."""
    jm, jp, tm, tp, cfg = _pair("granite-3-2b")
    rng = np.random.default_rng(4)
    B, S, T = 3, 6, 16
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=T)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=T)
    before = {leaf: tc[leaf].clone() for leaf in ("k", "v")}
    tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    jl, jnew = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(S))
    tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok), S, rows=[0, 2])
    assert tc2 is tc  # in place
    keep = np.array([True, False, True])[None, :, None, None, None]
    for leaf in ("k", "v"):
        merged = np.where(keep, np.asarray(jnew[leaf]), np.asarray(jc[leaf]))
        _close(tc[leaf], merged)
        assert torch.equal(tc[leaf][:, 1], before[leaf][:, 1])
    _close(tl[[0, 2]], np.asarray(jl)[[0, 2]])


@pytest.mark.parametrize("arch", DENSE + MOE + [VLM, "seamless-m4t-large-v2",
                                  "recurrentgemma-9b", "xlstm-1.3b"])
def test_param_counts_equal_jax(arch):
    assert param_counts(get_config(arch)) == jax_param_counts(jax_get_config(arch))


def test_init_draws_from_the_generator():
    cfg = get_smoke_config("gemma-2b")
    m = get_model(cfg, device="cpu")
    a, b = m.init(0), m.init(torch.Generator().manual_seed(0))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.embed, m.init(1).embed)
    assert torch.equal(a.layers[0].ln1, torch.ones(cfg.d_model))
    assert abs(float(a.embed.std()) - 0.02) < 2e-3
    assert abs(float(a.layers[0].w_gate.std()) - cfg.d_model ** -0.5) < 0.01


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_get_model_serves_every_dense_moe_vlm_and_encdec_config(arch):
    """Every config of every family (the hybrid and ssm ones too) gets its
    module on the CPU when asked for it."""
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.rglru import RecurrentGemma
    from repro_torch.models.transformer import Transformer
    from repro_torch.models.xlstm import XLSTM

    cfg = get_smoke_config(arch)
    params = get_model(cfg, device="cpu").init(0)
    module = {"encdec": EncDec, "hybrid": RecurrentGemma, "ssm": XLSTM}.get(cfg.family,
                                                                          Transformer)
    assert isinstance(params, module)
    assert {p.device.type for p in params.parameters()} == {"cpu"}


def test_modules_build_on_the_card_unless_asked_for_the_cpu():
    """``Block`` and ``Transformer`` default to the card, as ``get_model``
    and ``from_jax_params`` do; ``device="cpu"`` still builds on the CPU."""
    import inspect

    from repro_torch.models import rglru, xlstm
    from repro_torch.models.convert import from_jax_params as convert
    from repro_torch.models.transformer import Block, Transformer

    for fn in (Block.__init__, Transformer.__init__, get_model, convert,
               rglru.RecurrentGemma.__init__, rglru.RecBlock.__init__, rglru.AttnBlock.__init__,
               xlstm.XLSTM.__init__, xlstm.MLSTMBlock.__init__, xlstm.SLSTMBlock.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    cfg = get_smoke_config("gemma-2b")
    assert {p.device.type for p in Transformer(cfg, "cpu").parameters()} == {"cpu"}
    params = get_model(cfg, device="cpu").init(0)
    assert {p.device.type for p in params.parameters()} == {"cpu"}
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            Transformer(cfg)


# ---------------------------------------------------------------------------
# moe and vlm (M-RoPE, the vision stub)
# ---------------------------------------------------------------------------

def _batches(cfg, toks, vision, rng):
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if vision:
        ve = rng.normal(size=(toks.shape[0], cfg.n_vision_tokens, 1024)).astype(np.float32)
        jb["vision_embeds"], tb["vision_embeds"] = jnp.asarray(ve), torch.from_numpy(ve)
    return jb, tb


@pytest.mark.parametrize("arch,vision", [(MOE[0], False), (MOE[1], False), (VLM, False),
                                         (VLM, True)])
def test_moe_and_vlm_forward_prefill_and_decode_match_jax(arch, vision):
    """B·S = 40 tokens: the granite-moe and grok-1 capacity binds in
    forward and prefill, so dropped pairs are held too."""
    jm, jp, tm, tp, cfg = _pair(arch)
    rng = np.random.default_rng(0)
    B, S, T = 2, 20, 32
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb, tb = _batches(cfg, toks, vision, rng)

    jl, jaux = jm.forward(jp, jb)
    tl, aux = tm.forward(tp, tb)
    assert tuple(tl.shape) == (B, S, cfg.vocab)
    _close(tl, jl)
    E = cfg.moe_experts or 1
    assert tuple(aux["moe_load"].shape) == (cfg.n_layers, E)
    np.testing.assert_array_equal(aux["moe_load"].numpy(), np.asarray(jaux["moe_load"]))
    if cfg.moe_experts:
        assert float(aux["moe_load"][0].sum()) == B * S * cfg.moe_top_k

    jl, jc = jm.prefill(jp, jb, cache_len=T)
    tl, tc = tm.prefill(tp, tb, cache_len=T)
    _close(tl, jl)
    for leaf in ("k", "v"):
        _close(tc[leaf], jc[leaf])
        assert not tc[leaf][:, :, S:].any()
    for i in range(8):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(S + i))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), S + i)
        _close(tl, jl)
    for leaf in ("k", "v"):
        _close(tc[leaf], jc[leaf])


def test_vision_stub_overwrites_the_first_positions():
    """The projected stub replaces the first n_vis token embeddings: the
    logits change with the stub, and tokens under it do not matter."""
    _, _, tm, tp, cfg = _pair(VLM)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (1, 10)).astype(np.int32)
    ve = torch.from_numpy(rng.normal(size=(1, cfg.n_vision_tokens, 1024)).astype(np.float32))
    other = toks.copy()
    other[:, :cfg.n_vision_tokens] = (other[:, :cfg.n_vision_tokens] + 1) % cfg.vocab
    a = tm.forward(tp, {"tokens": torch.from_numpy(toks), "vision_embeds": ve})[0]
    b = tm.forward(tp, {"tokens": torch.from_numpy(other), "vision_embeds": ve})[0]
    c = tm.forward(tp, {"tokens": torch.from_numpy(toks)})[0]
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    with pytest.raises(ValueError, match="vision_embeds"):
        tm.forward(tp, {"tokens": torch.from_numpy(toks[:, :2]), "vision_embeds": ve})


@pytest.mark.parametrize("B,S,offset", [(2, 9, 0), (3, 1, 0), (3, 1, 2), (3, 1, 3), (2, 1, 4),
                                        (1, 1, 40), (2, 5, 1)])
def test_mrope_positions_and_rotation_match_jax(B, S, offset):
    """M-RoPE positions are exactly JAX's, offsets below n_vision_tokens
    (a decode token in the vision grid) included; ``apply_mrope`` rotates
    within the dense tests' tolerance."""
    from repro.models.transformer import build_positions as jax_positions
    from repro_torch.models.transformer import build_positions

    jcfg, cfg = jax_get_smoke_config(VLM), get_smoke_config(VLM)
    tpos = build_positions(cfg, B, S, offset=offset)
    jpos = jax_positions(jcfg, B, S, offset=offset)
    assert tuple(tpos.shape) == (3, B, S) and tpos.dtype == torch.int32
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    dense = get_smoke_config("granite-3-2b")
    np.testing.assert_array_equal(build_positions(dense, B, S, offset=offset).numpy(),
                                  np.asarray(jax_positions(jax_get_smoke_config("granite-3-2b"),
                                                           B, S, offset=offset)))
    x = np.random.default_rng(offset).normal(size=(B, S, 4, cfg.head_dim)).astype(np.float32)
    _close(TL.apply_mrope(torch.from_numpy(x), tpos, cfg.mrope_sections, cfg.rope_theta),
           JL.apply_mrope(jnp.asarray(x), jpos, jcfg.mrope_sections, jcfg.rope_theta))


def test_apply_mrope_needs_sections_summing_to_half_the_head():
    x = torch.zeros(1, 2, 1, 16)
    pos = torch.zeros(3, 1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="sections"):
        TL.apply_mrope(x, pos, (2, 3, 2))
    # with one section per axis equal to the plain rope's bands, axis 0's
    # positions alone rotate like apply_rope
    p = torch.arange(2, dtype=torch.int32)[None].expand(1, 2)
    y = torch.randn(1, 2, 3, 16, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(TL.apply_mrope(y, torch.stack([p, p, p]), (8, 0, 0)),
                               TL.apply_rope(y, p))


@pytest.mark.parametrize("arch", MOE + [VLM])
def test_moe_and_vlm_decode_matches_forward(arch):
    """B·S = 8 tokens: no expert overflows, so token-by-token decode from
    an empty cache reproduces the teacher-forced forward."""
    _, _, tm, tp, cfg = _pair(arch, seed=3)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (1, 8)).astype(np.int32))
    full, _ = tm.forward(tp, {"tokens": toks})
    cache = tm.init_cache(1, 8)
    outs = []
    for i in range(8):
        lg, cache = tm.decode_step(tp, cache, toks[:, i:i + 1], i)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_rows_route_every_row(arch, monkeypatch):
    """With ``rows``, a MoE decode still routes all B rows (the capacity
    binds at B = 24: an expert gets more picks than slots), each row
    attending its own new K/V as JAX's full-batch update does; the cache
    changes only at ``rows``, and the decoded rows' logits equal JAX's."""
    import repro_torch.models.transformer as T

    jm, jp, tm, tp, cfg = _pair(arch)
    rng = np.random.default_rng(6)
    B, S, Tc = 24, 4, 16
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, cache_len=Tc)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, cache_len=Tc)
    before = {leaf: tc[leaf].clone() for leaf in ("k", "v")}
    routed = []
    real = T.moe_ffn_local

    def spy(x, router, wg, wu, wd, c, cap):
        from repro_torch.models.moe import route

        routed.append((x.shape[0], bool(route(x, router, c, cap).keep.all())))
        return real(x, router, wg, wu, wd, c, cap)

    monkeypatch.setattr(T, "moe_ffn_local", spy)
    rows = [0, 3, 4, 9]
    tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    jl, jnew = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(S))
    tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok), S, rows=rows)
    assert tc2 is tc
    assert [n for n, _ in routed] == [B] * cfg.n_layers  # every row routed, in every layer
    assert not all(kept for _, kept in routed)  # and the capacity bound
    keep = np.isin(np.arange(B), rows)[None, :, None, None, None]
    for leaf in ("k", "v"):
        _close(tc[leaf], np.where(keep, np.asarray(jnew[leaf]), np.asarray(jc[leaf])))
        others = [b for b in range(B) if b not in rows]
        assert torch.equal(tc[leaf][:, others], before[leaf][:, others])
    _close(tl, jl)  # every row's logits: the routing saw JAX's batch


def test_moe_init_scales_w_down_and_keeps_the_router_in_f32():
    cfg = get_smoke_config(MOE[0])
    p = get_model(cfg, device="cpu").init(0)
    blk = p.layers[0]
    E, d, F = cfg.moe_experts, cfg.d_model, cfg.d_ff
    assert tuple(blk.router.shape) == (d, E) and blk.router.dtype == torch.float32
    assert tuple(blk.w_gate.shape) == (E, d, F) and tuple(blk.w_down.shape) == (E, F, d)
    assert abs(float(blk.w_down.std()) - F ** -0.5) < 0.01
    assert abs(float(blk.router.std()) - d ** -0.5) < 0.02
    vlm = get_model(get_smoke_config(VLM), device="cpu").init(0)
    assert tuple(vlm.vision_proj.shape) == (1024, vlm.cfg.d_model)
    assert get_model(get_smoke_config("gemma-2b"), device="cpu").init(0).vision_proj is None


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-9b", "xlstm-1.3b",
                                  "seamless-m4t-large-v2"])
def test_entry_points_accumulate_bf16_products_in_f32(arch):
    """forward, prefill and decode_step run with cuBLAS's reduced-precision
    bf16 reduction off (JAX's dots accumulate in f32) and restore it after."""
    from repro_torch.models.layers import f32_accumulation

    matmul = torch.backends.cuda.matmul
    model = get_model(get_smoke_config(arch), device="cpu")
    params = model.init(0)
    seen = []

    def record(*args, **kwargs):
        seen.append(matmul.allow_bf16_reduced_precision_reduction)
        return "done"

    for name in ("forward", "prefill", "decode_step"):
        setattr(params, name, record)
    batch = {"frames": None, "tokens": None}
    was = matmul.allow_bf16_reduced_precision_reduction
    try:
        for flag in (True, False):
            matmul.allow_bf16_reduced_precision_reduction = flag
            assert model.forward(params, batch) == "done"
            assert model.prefill(params, batch, cache_len=4) == "done"
            assert model.decode_step(params, None, None, 0) == "done"
            assert matmul.allow_bf16_reduced_precision_reduction is flag
            with pytest.raises(ZeroDivisionError), f32_accumulation():
                1 / 0
            assert matmul.allow_bf16_reduced_precision_reduction is flag
    finally:
        matmul.allow_bf16_reduced_precision_reduction = was
    assert seen == [False] * 6
