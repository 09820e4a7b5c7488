"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's.

The same float32 inputs, drawn from a numpy seed, go through JAX's
``moe_ffn_local`` and the port's at the granite-moe and grok-1 smoke
configs, with JAX's ``init`` weights for a layer.  ``load`` (the per-expert
top-k counts) and the keep mask of the capacity cut are held exactly;
y within rtol 1e-4 / atol 2e-5, the dense tests' tolerance (the port sums
a token's k expert outputs over k in float32, JAX scatter-adds them in
routing order).  Gates are seeded floats, so ties, which ``torch.topk``
and ``jax.lax.top_k`` may break differently, have measure zero.
Token counts include ones where the capacity binds (an expert gets more
picks than ``moe_capacity`` slots) and the cut drops pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as JMOE
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import get_model as jax_get_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import moe as TMOE

RTOL, ATOL = 1e-4, 2e-5
ARCHS = ["granite-moe-3b-a800m", "grok-1-314b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU ops run faster on one thread than through the intra-op pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer(arch, seed=0):
    """Layer 0's router and expert stacks from JAX's ``init``, as numpy."""
    jp = jax_get_model(jax_get_smoke_config(arch)).init(jax.random.PRNGKey(seed))
    return {n: np.array(jp["layers"][n][0]) for n in ("router", "w_gate", "w_up", "w_down")}


def _jax_keep(x, router, cfg, cap):
    """JAX's routing steps (``repro.models.moe``, its lines up to the keep
    mask), in jnp: the keep mask in sorted (expert, token) order."""
    probs = jax.nn.softmax((x @ router).astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, cfg.moe_top_k)
    se = top_e.reshape(-1)[jnp.argsort(top_e.reshape(-1), stable=True)]
    first = jnp.searchsorted(se, jnp.arange(cfg.moe_experts, dtype=jnp.int32))
    return np.asarray(jnp.arange(se.shape[0]) - first[se] < cap)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_tokens", [1, 8, 40, 96])
@pytest.mark.parametrize("capacity", ["moe_capacity", "tight"])
def test_moe_ffn_local_matches_jax(arch, n_tokens, capacity):
    """At ``moe_capacity`` and at a tight capacity of 8 slots, which binds
    (an expert gets more picks than slots) from 40 tokens on; at 40 tokens
    ``moe_capacity`` binds too, for both configs."""
    cfg = get_smoke_config(arch)
    w = _layer(arch)
    x = np.random.default_rng(n_tokens).normal(size=(n_tokens, cfg.d_model)).astype(np.float32)
    cap = TMOE.moe_capacity(cfg, n_tokens) if capacity == "moe_capacity" else 8
    jy, jload = JMOE.moe_ffn_local(jnp.asarray(x), *(jnp.asarray(w[n]) for n in
                                   ("router", "w_gate", "w_up", "w_down")), cfg, cap)
    tw = {n: torch.from_numpy(a) for n, a in w.items()}
    ty, tload = TMOE.moe_ffn_local(torch.from_numpy(x), tw["router"], tw["w_gate"], tw["w_up"],
                                   tw["w_down"], cfg, cap)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == (n_tokens, cfg.d_model)
    np.testing.assert_array_equal(tload.numpy(), np.asarray(jload))
    assert tload.dtype == torch.float32 and float(tload.sum()) == n_tokens * cfg.moe_top_k
    keep = TMOE.route(torch.from_numpy(x), tw["router"], cfg, cap).keep
    np.testing.assert_array_equal(keep.numpy(), _jax_keep(jnp.asarray(x), jnp.asarray(w["router"]),
                                                          cfg, cap))
    binds = int(tload.max()) > cap  # an expert got more picks than slots
    assert bool(keep.all()) != binds
    assert binds or n_tokens < 40 or capacity == "moe_capacity"
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_binds_and_drops_pairs(arch):
    """At 40 tokens and 8 slots an expert gets more picks than it has
    slots: the cut keeps the first 8 of each expert in token order, sends
    the rest to the spare slot, and a token with every pair dropped comes
    out as zeros."""
    cfg = get_smoke_config(arch)
    w = {n: torch.from_numpy(a) for n, a in _layer(arch).items()}
    x = torch.from_numpy(np.random.default_rng(40).normal(size=(40, cfg.d_model)).astype(np.float32))
    cap = 8
    r = TMOE.route(x, w["router"], cfg, cap)
    assert not bool(r.keep.all())
    assert int(r.keep.sum()) == int(torch.clamp(torch.bincount(r.top_e.reshape(-1),
                                                               minlength=cfg.moe_experts),
                                                max=cap).sum())
    assert bool((r.slot[~r.keep] == cfg.moe_experts * cap).all())
    for e in range(cfg.moe_experts):  # the stable sort keeps the lowest tokens
        toks = r.token[r.slot // cap == e]
        assert torch.equal(toks, torch.sort(toks).values)
    y, _ = TMOE.moe_ffn_local(x, w["router"], w["w_gate"], w["w_up"], w["w_down"], cfg, cap)
    dropped = torch.ones(40, dtype=torch.bool)
    dropped[r.token[r.keep]] = False
    assert bool(dropped.any())
    assert bool((y[dropped] == 0).all())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("n_tokens", [1, 7, 8, 64, 4096])
def test_moe_capacity_matches_jax(arch, size, n_tokens):
    if size == "full":
        cfg, jcfg = get_config(arch), jax_get_config(arch)
    else:
        cfg, jcfg = get_smoke_config(arch), jax_get_smoke_config(arch)
    assert TMOE.moe_capacity(cfg, n_tokens) == JMOE.moe_capacity(jcfg, n_tokens) >= 8


def test_bf16_combine_sums_over_k_in_float32_then_rounds_once():
    """The deliberate difference from JAX (ROADMAP C): in bf16, a token's k
    weighted expert outputs (each product rounded to bf16, as in JAX) are
    summed in float32 and rounded once, in a fixed order."""
    cfg = get_smoke_config("granite-moe-3b-a800m")
    w = {n: torch.from_numpy(a) for n, a in _layer("granite-moe-3b-a800m").items()}
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(24, cfg.d_model)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    cap = TMOE.moe_capacity(cfg, 24)
    y, _ = TMOE.moe_ffn_local(xb, w["router"], *(w[n].to(torch.bfloat16) for n in
                                                 ("w_gate", "w_up", "w_down")), cfg, cap)
    assert y.dtype == torch.bfloat16
    r = TMOE.route(xb, w["router"], cfg, cap)
    want = torch.zeros(24, cfg.d_model)
    for e in range(cfg.moe_experts):
        rows = r.token[(r.slot // cap == e) & r.keep]
        if not len(rows):
            continue
        h = xb[rows]
        g = h @ w["w_gate"][e].to(torch.bfloat16)
        u = h @ w["w_up"][e].to(torch.bfloat16)
        out = (torch.nn.functional.silu(g) * u) @ w["w_down"][e].to(torch.bfloat16)
        gate = r.gate[(r.slot // cap == e) & r.keep].to(torch.bfloat16)
        want.index_add_(0, rows, (out * gate[:, None]).float())
    # the same bf16 terms; only the f32 order of the k-term sums may differ
    torch.testing.assert_close(y.float(), want.to(torch.bfloat16).float(), rtol=2 ** -7, atol=1e-6)
