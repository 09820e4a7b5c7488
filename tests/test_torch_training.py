"""The port's trainer (``repro_torch.training``) against the JAX package's.

JAX's ``init`` makes the parameters, and ``models.convert.from_jax_params``
carries them into the port's float32-master form, so one step of both
packages starts from the same state on the same numpy batch.  Held:

* AdamW, the cosine schedule and clipping on the same numpy leaves,
  within 1e-6 relative (float32, the same operations; the norm sums its
  terms in another order).  The decay rule follows JAX's leaf rank: the
  port's per-layer ``ln1``/``ln2`` are (d,) but JAX's are (L, d), so both
  decay them; ``final_norm`` (d,) decays in neither.
* ``cross_entropy`` within 1e-6 relative.
* One ``make_train_step`` step of the phi3-mini, gemma-2b and grok-1-314b
  smoke configs (f32) against ``jax.jit(make_train_step(...))``: loss,
  grad norm, clip scale, lr and the domain sums within 1e-5 relative,
  ``moe_load`` exactly, ``moe_balance`` within 1e-6; every gradient
  (JAX's, from its ``value_and_grad``, captured where the step hands it to
  ``adamw_update``) within 1e-4 of its leaf's largest |gradient| (the same
  f32 sums in other orders: ~2e-6 observed); every parameter after the
  step within 1e-2 of its leaf's update norm (AdamW's first step is nearly
  a sign update, lr·m̂/√v̂ ≈ ±lr, so a gradient near 0 may move its
  parameter by ±lr in one package and not the other).
* Two microbatches against one batch (JAX's own 2e-3/2e-4 of
  ``tests/test_training_infra.py``) and against JAX's two, ``remat="full"``
  equal to ``"none"`` bit for bit, and the loss falling on a tiny model.
  (The hybrid, ssm and encdec families and remat "dots":
  ``tests/test_torch_train_families.py``.)
* One bf16 step (gemma-2b's smoke config in bf16) against JAX compiled
  with the casts its source states and its attention computed as the
  port's (``tests/torch_bf16.py``), at limits that a cast moved on a copy
  of the port fails (``test_bf16_train_step_matches_jax``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training.train_step as JT
from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model as jax_get_model
from repro.training import AdamWConfig as JAdamW
from repro.training import adamw_init as jax_adamw_init
from repro.training import adamw_update as jax_adamw_update
from repro.training import cosine_schedule as jax_cosine
from repro.training import init_train_state as jax_init_state
from repro.training import make_train_step as jax_make_step
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params, jax_leaves, layout, to_jax_params
from repro_torch.training import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    init_train_state,
    make_train_step,
)
from repro_torch.training.train_step import TrainState, cross_entropy, trainable
from torch_bf16 import compiled_fn, jax_activations_in_f32, jax_attention_as_port

ARCHS = ["phi3-mini-3.8b", "gemma-2b", "grok-1-314b"]
GRAD_TOL, PARAM_TOL = 1e-4, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _leaves(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_adamw_update_matches_jax(clip):
    """Five updates of three leaves (a matrix, a vector, a 3-d stack) from
    the same numpy values: parameters, m, v and the metrics."""
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 5), "b": (5,), "e": (2, 3, 4)}
    p0 = _leaves(rng, shapes)
    kw = dict(lr=0.05, weight_decay=0.1, clip_norm=clip, warmup_steps=2, total_steps=5)
    jp, js = {k: jnp.asarray(v) for k, v in p0.items()}, None
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jax_adamw_init(jp), adamw_init(tp)
    for _ in range(5):
        g = _leaves(rng, shapes)
        jp, js, jm = jax_adamw_update(JAdamW(**kw), jp, {k: jnp.asarray(v) for k, v in g.items()},
                                      js)
        _, ts, tm = adamw_update(AdamWConfig(**kw), tp, {k: torch.from_numpy(v) for k, v in
                                                         g.items()}, ts,
                                 {k: len(s) for k, s in shapes.items()})
        for k in ("lr", "grad_norm", "clip_scale"):
            assert _rel(tm[k], jm[k]) <= 1e-6, k
        for k in shapes:
            assert _rel(tp[k], jp[k]) <= 1e-6, k
            assert _rel(ts["m"][k], js["m"][k]) <= 1e-6, k
            assert _rel(ts["v"][k], js["v"][k]) <= 1e-6, k
    assert int(ts["step"]) == int(js["step"]) == 5 and ts["step"].dtype == torch.int32


@pytest.mark.parametrize("step", [0, 1, 7, 10, 11, 55, 100, 250])
def test_cosine_schedule_matches_jax(step):
    for cfg in (dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1),
                dict(lr=3e-4, warmup_steps=0, total_steps=6)):
        got = cosine_schedule(AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        want = jax_cosine(JAdamW(**cfg), jnp.int32(step))
        assert got.dtype == torch.float32
        assert _rel(got, want) <= 1e-6


def test_grad_clipping_matches_jax():
    cfg = dict(clip_norm=0.1, warmup_steps=0, total_steps=1)
    p, g = np.ones(4, np.float32), np.full(4, 100.0, np.float32)
    _, _, jm = jax_adamw_update(JAdamW(**cfg), {"w": jnp.asarray(p)}, {"w": jnp.asarray(g)},
                                jax_adamw_init({"w": jnp.asarray(p)}))
    tp = {"w": torch.from_numpy(p.copy())}
    _, _, tm = adamw_update(AdamWConfig(**cfg), tp, {"w": torch.from_numpy(g)}, adamw_init(tp),
                            {"w": 1})
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    assert float(tm["clip_scale"]) == pytest.approx(float(jm["clip_scale"]), rel=1e-6)
    assert float(tm["clip_scale"]) < 1e-2


def test_layer_norms_decay_as_in_jax():
    """Zero gradients isolate the decay: JAX's (L, d) ``ln1`` decays (rank
    2), its (d,) ``final_norm`` does not.  The port's (d,) ``ln1`` decays
    through its JAX rank."""
    cfg = get_smoke_config("gemma-2b")
    model = get_model(cfg, device="cpu", train=True).init(0)
    leaves = trainable(model)
    ranks = {n: r for n, (_k, _i, r) in jax_leaves(model).items()}
    assert ranks["layers.0.ln1"] == 2 and ranks["final_norm"] == 1
    assert leaves["layers.0.ln1"].ndim == 1
    jparams = to_jax_params(model)
    opt = dict(lr=0.5, weight_decay=0.1, warmup_steps=0, total_steps=10)
    zeros = jax.tree.map(jnp.zeros_like, jparams)
    jnew, _, _ = jax_adamw_update(JAdamW(**opt), jparams, zeros, jax_adamw_init(jparams))
    grads = {n: torch.zeros_like(p) for n, p in leaves.items()}
    with torch.no_grad():
        adamw_update(AdamWConfig(**opt), leaves, grads, adamw_init(leaves), ranks)
    got = to_jax_params(model)
    for path, want in jax.tree_util.tree_leaves_with_path(jnew):
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(want), rtol=1e-6, err_msg=str(path))
    assert not np.array_equal(got["layers"]["ln1"], jparams["layers"]["ln1"])
    np.testing.assert_array_equal(got["final_norm"], jparams["final_norm"])


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    jl, jn = JT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    tl, tn = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert _rel(tl, jl) <= 1e-6
    assert _rel(tn, jn) <= 1e-6


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------

def _batch(cfg, B=4, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1),
            "domain": rng.integers(0, 16, B).astype(np.int32)}


def _jax_step(jcfg, batch, opt, microbatches=1, monkeypatch=None, seed=0, compile_fn=jax.jit):
    """JAX's initial state and its jitted step's (state, metrics), the
    gradients captured where the step hands them to ``adamw_update``."""
    real = JT.adamw_update

    def capture(cfg, params, grads, opt_state):
        new_p, new_o, metrics = real(cfg, params, grads, opt_state)
        return new_p, new_o, dict(metrics, grads=grads)

    monkeypatch.setattr(JT, "adamw_update", capture)
    jm = jax_get_model(jcfg)
    state = jax_init_state(jm, jax.random.PRNGKey(seed))
    step = compile_fn(jax_make_step(jm, JAdamW(**opt), microbatches=microbatches))
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return state, new, metrics


def _port_state(jstate, cfg):
    params = from_jax_params(jax.tree.map(np.asarray, jstate.params), cfg, device="cpu",
                             masters=True)
    return TrainState(params, adamw_init(trainable(params)), torch.zeros((), dtype=torch.int32))


def _port_grads(params):
    out = {}
    for leaf in layout(params):
        g = np.stack([t.grad.numpy() for t in leaf.tensors])
        node = out
        for name in leaf.path[:-1]:
            node = node.setdefault(name, {})
        node[leaf.path[-1]] = g.reshape(leaf.shape) if leaf.lead else g[0]
    return out


def _pairs(port_tree, jax_tree):
    for path, want in jax.tree_util.tree_leaves_with_path(jax_tree):
        node = port_tree
        for p in path:
            node = node[p.key]
        yield "/".join(p.key for p in path), node, np.asarray(want, np.float32)


def _hold_step(cfg, p0, tstate, tmet, jnew, jmet, grad_tol=GRAD_TOL, metric_tol=1e-5,
               param_tol=PARAM_TOL):
    for k in jmet:
        if k == "grads":
            continue
        if k == "moe_load":
            np.testing.assert_array_equal(tmet[k].numpy(), np.asarray(jmet[k]))
        else:
            assert _rel(tmet[k], jmet[k]) <= metric_tol, (k, float(tmet[k]), np.asarray(jmet[k]))
    assert sorted(tmet) == sorted(k for k in jmet if k != "grads")
    for key, got, want in _pairs(_port_grads(tstate.params), jmet["grads"]):
        assert np.abs(got - want).max() <= grad_tol * np.abs(want).max(), key
    for key, got, want in _pairs(to_jax_params(tstate.params), jnew.params):
        start = dict((k, v) for k, _g, v in _pairs(p0, p0))[key]
        update = np.linalg.norm(want - start)
        assert np.linalg.norm(got - want) <= param_tol * update, key
    assert int(tstate.step) == int(jnew.step) == 1
    assert int(tstate.opt_state["step"]) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    batch = _batch(cfg)
    opt = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    jstate, jnew, jmet = _jax_step(jax_smoke(arch), batch, opt, monkeypatch=monkeypatch)
    tstate = _port_state(jstate, cfg)
    p0 = to_jax_params(tstate.params)
    step = make_train_step(get_model(cfg, device="cpu", train=True), AdamWConfig(**opt))
    tstate, tmet = step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    _hold_step(cfg, p0, tstate, tmet, jnew, jmet)
    if cfg.moe_experts:
        assert tmet["moe_load"].shape == (cfg.moe_experts,) and float(tmet["moe_balance"]) > 0


def test_microbatches_match_one_batch_and_jax(monkeypatch):
    """granite-3-2b's smoke config, as JAX's test: two microbatches against
    one batch at JAX's tolerance, and against JAX's two microbatches."""
    arch = "granite-3-2b"
    cfg = get_smoke_config(arch)
    batch = _batch(cfg, B=4, S=16, seed=3)
    opt = dict(lr=1e-2)
    jstate, jnew, jmet = _jax_step(jax_smoke(arch), batch, opt, microbatches=2,
                                   monkeypatch=monkeypatch)
    model = get_model(cfg, device="cpu", train=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    one = _port_state(jstate, cfg)
    one, _ = make_train_step(model, AdamWConfig(**opt), microbatches=1)(one, tb)
    two = _port_state(jstate, cfg)
    p0 = to_jax_params(two.params)
    two, tmet = make_train_step(model, AdamWConfig(**opt), microbatches=2)(two, tb)
    for a, b in zip(one.params.parameters(), two.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-3, atol=2e-4)
    _hold_step(cfg, p0, two, tmet, jnew, jmet)


@pytest.mark.parametrize("arch", ["gemma-2b", "grok-1-314b"])
def test_remat_full_equals_none(arch):
    """Recomputing every layer in the backward gives the same loss and
    gradients bit for bit (the same operations on the same inputs)."""
    cfg = get_smoke_config(arch)
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    grads = []
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        model = get_model(c, device="cpu", train=True)
        state = init_train_state(model, 0)
        state, met = make_train_step(model, AdamWConfig(lr=1e-2))(state, tb)
        grads.append((float(met["loss"]), [p.grad.clone() for p in state.params.parameters()]))
    assert grads[0][0] == grads[1][0]
    for a, b in zip(grads[0][1], grads[1][1]):
        assert torch.equal(a, b)


def test_init_train_state_needs_masters_and_remat_is_known():
    """A served model has no masters to train; an unknown remat raises at
    the step.  (remat "dots" and the hybrid, ssm and encdec families train:
    ``tests/test_torch_train_families.py``.)"""
    with pytest.raises(ValueError, match="train=True"):
        init_train_state(get_model(get_smoke_config("gemma-2b"), device="cpu"), 0)
    cfg = dataclasses.replace(get_smoke_config("gemma-2b"), remat="everything")
    model = get_model(cfg, device="cpu", train=True)
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with pytest.raises(ValueError, match="remat"):
        make_train_step(model, AdamWConfig())(init_train_state(model, 0), tb)


def test_loss_decreases_tiny_model():
    """As ``tests/test_training_infra.py:73`` holds JAX's."""
    cfg = get_smoke_config("phi3-mini-3.8b")
    model = get_model(cfg, device="cpu", train=True)
    state = init_train_state(model, 0)
    step = make_train_step(model, AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=30))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 64, (4, 32)).astype(np.int32))  # low entropy
    losses = []
    for _ in range(15):
        state, metrics = step(state, {"tokens": tokens, "labels": tokens})
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses


def test_masters_round_to_the_served_weights():
    """The same draws in both forms: a bf16 model's served matrices are
    its float32 masters rounded, its norms equal."""
    cfg = dataclasses.replace(get_smoke_config("grok-1-314b"), compute_dtype="bfloat16")
    served = get_model(cfg, device="cpu").init(7)
    masters = get_model(cfg, device="cpu", train=True).init(7)
    for (name, s), (_, m) in zip(served.named_parameters(), masters.named_parameters()):
        assert m.dtype == torch.float32 and m.requires_grad and not s.requires_grad
        assert torch.equal(m.detach().to(s.dtype), s), name


def test_bf16_train_step_matches_jax(monkeypatch):
    """gemma-2b's smoke config in bf16 (float32 masters, each matrix cast at
    use), one step against JAX compiled with the casts its source states,
    its activations rounded once (``tests/torch_bf16.py``) and its
    attention computed as the port's (``jax_attention_as_port``: the one
    deliberate difference, P kept in float32, taken out).  What is left is
    the products' summation order.

    The limits sit between the readings of this step and of controls that
    move a cast, each on a copy of the port (``tests/torch_bf16_casts.py``;
    max over leaves; batch seed 5, and over seeds 1, 2, 3 and 5 in
    brackets):

    ============  ===========================  ========  =========  ============
    run           gradient, normwise per leaf  loss      grad norm  parameters
    ============  ===========================  ========  =========  ============
    sound         2.7e-3 (2.7e-3–5.6e-3)       9.9e-7    7.5e-5     0.034
    step in f32   1.9e-2 (1.7e-2–2.1e-2)       5.9e-5    2.2e-4     0.18
    rmsnorm bf16  2.4e-2 (2.2e-2–2.5e-2)       2.5e-5    1.5e-3     0.19
    rope in bf16  1.7e-2 (1.5e-2–1.7e-2)       3.2e-5    5.5e-4     0.18
    GeGLU in f32  1.2e-2 (1.1e-2–1.2e-2)       2.8e-5    2.1e-4     0.13
    head in f32   9.2e-3 (9.1e-3–9.6e-3)       2.9e-6    3.5e-4     0.18
    ============  ===========================  ========  =========  ============

    So each leaf's gradient is held within 7.5e-3 of its norm (every
    control fails it at every seed), the loss within 2^-18 and the grad
    norm within 2^-12 relative.  The cross entropy's cast dropped raises.
    The parameters after the step separate nothing (a sign update flips
    where a gradient is within a bf16 step of 0: the sound step reads
    0.034–0.175 over the seeds), so each is held within 0.25 of its
    update's norm, a bound on gross error only.  Without
    ``jax_attention_as_port`` the sound step reads 1.6e-2 and the controls
    1.6e-2–2.4e-2 on the gradients: the attention's difference hides the
    casts."""
    arch = "gemma-2b"
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_smoke(arch), compute_dtype="bfloat16")
    batch = _batch(cfg, seed=5)
    opt = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    with jax_activations_in_f32(), jax_attention_as_port():
        jstate, jnew, jmet = _jax_step(jcfg, batch, opt, monkeypatch=monkeypatch,
                                       compile_fn=compiled_fn)
    tstate = _port_state(jstate, cfg)
    p0 = to_jax_params(tstate.params)
    step = make_train_step(get_model(cfg, device="cpu", train=True), AdamWConfig(**opt))
    tstate, tmet = step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert _rel(tmet["loss"], jmet["loss"]) <= 2.0 ** -18
    assert _rel(tmet["grad_norm"], jmet["grad_norm"]) <= 2.0 ** -12
    for key, got, want in _pairs(_port_grads(tstate.params), jmet["grads"]):
        assert np.linalg.norm(got - want) <= 7.5e-3 * np.linalg.norm(want), key
    _hold_step(cfg, p0, tstate, {k: tmet[k] for k in ("loss",)}, jnew,
               {"loss": jmet["loss"], "grads": jmet["grads"]}, grad_tol=2.0 ** -6,
               metric_tol=2.0 ** -18, param_tol=0.25)


@pytest.mark.parametrize("arch", ["gemma-2b", "grok-1-314b", "qwen2-vl-72b"])
def test_served_module_casts_no_parameter(arch):
    """Cast at use is free for the served module: in a bf16 served model's
    forward, prefill and decode step no ``aten._to_copy`` reads a
    parameter (``.to`` of a leaf already in the activations' dtype returns
    the leaf), and no graph is built; the master form casts each matrix."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="bfloat16")
    read = []

    class Casts(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._to_copy.default:
                read.append(args[0].data_ptr())
            return func(*args, **(kwargs or {}))

    for train in (False, True):
        model = get_model(cfg, device="cpu", train=train)
        params = model.init(0)
        matrices = {p.data_ptr() for p in params.parameters() if p.ndim >= 2}
        toks = torch.zeros((2, 6), dtype=torch.int32)
        read.clear()
        with Casts():
            logits, _ = model.forward(params, {"tokens": toks})
            _, cache = model.prefill(params, {"tokens": toks}, cache_len=8)
            model.decode_step(params, cache, toks[:, :1], 6)
        assert logits.dtype == torch.bfloat16 and logits.requires_grad == train
        assert bool(matrices & set(read)) == train
