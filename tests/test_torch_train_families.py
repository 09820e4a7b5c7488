"""Training the hybrid, ssm and encdec families, and remat "dots", against JAX.

JAX's ``init`` makes the parameters and ``models.convert.from_jax_params(...,
masters=True)`` carries them into the port's float32-master modules
(``rglru.RecurrentGemma``, ``xlstm.XLSTM``, ``encdec.EncDec``), so one step
of both packages starts from one state on one numpy batch (with seeded
``frames`` for the encdec arch).  Held, at the limits of
``test_torch_training.py`` (smoke configs, float32):

* one ``make_train_step`` step of recurrentgemma-9b, xlstm-1.3b and
  seamless-m4t-large-v2 against ``jax.jit(make_train_step(...))``: loss,
  grad norm, clip scale, lr and the domain sums within 1e-5 relative,
  every gradient within 1e-4 of its leaf's largest |gradient|, every
  parameter after the step within 1e-2 of its leaf's update norm;
* two microbatches of the encdec arch against one batch (JAX's own
  2e-3/2e-4) and against JAX's two microbatches;
* ``remat="full"`` and ``"dots"`` equal to ``"none"`` bit for bit, for the
  three families and the dense transformer; ``"dots"`` against JAX's
  ``"dots"`` step for one arch of each module; and in the backward,
  ``"dots"`` recomputes no ``aten.mm`` while ``"full"`` recomputes every
  one its rematerialised bodies ran forward;
* the masters round to the served weights, a served bf16 module casts no
  parameter held in the compute dtype, and every per-layer leaf decays as
  JAX's stacked leaf does (JAX rank >= 2);
* the gradients of ``rglru_scan`` (Hillis–Steele doubling against
  ``associative_scan``) and ``causal_conv1d`` against ``jax.grad`` of
  JAX's functions within 1e-5 of each gradient's largest, and of
  ``mlstm_parallel`` (over one and two chunks, and with every stabiliser
  maximum tied) within 1e-4 of it, and of the port's own float64
  gradient: its normalizer divides by a sum that cancels, so a last-bit
  difference moves an output by ~2e-5 of the largest in either package,
  and the forward is held so too (``tests/test_torch_xlstm.py``).  Read:
  the port 2.6e-6 (one chunk) and 1.3e-5 (two) from float64, JAX 9.1e-7
  and 1.3e-5, the two 2.6e-6 and 1.8e-5 apart.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro.configs import get_smoke_config as jax_smoke
from repro.models import rglru as jax_rglru
from repro.models import xlstm as jax_xlstm
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models.convert import jax_leaves, layout, to_jax_params
from repro_torch.models.rglru import causal_conv1d, rglru_scan
from repro_torch.models.xlstm import CHUNK, mlstm_parallel
from repro_torch.training import AdamWConfig, init_train_state, make_train_step
from test_torch_training import _hold_step, _jax_step, _port_state

FAMILY_ARCHS = ["recurrentgemma-9b", "xlstm-1.3b", "seamless-m4t-large-v2"]
MODULE_ARCHS = ["gemma-2b"] + FAMILY_ARCHS  # one arch of each module
FN_TOL = 1e-5
NORM_TOL = 1e-4  # the mLSTM parallel form's (tests/test_torch_xlstm.py)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, B=4, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, 1),
           "domain": rng.integers(0, 16, B).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_step(jstate, cfg, batch, opt, microbatches=1):
    tstate = _port_state(jstate, cfg)
    p0 = to_jax_params(tstate.params)
    step = make_train_step(get_model(cfg, device="cpu", train=True), AdamWConfig(**opt),
                           microbatches=microbatches)
    tstate, tmet = step(tstate, _torch(batch))
    return p0, tstate, tmet


# ---------------------------------------------------------------------------
# one step against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_train_step_matches_jax(arch, monkeypatch):
    cfg = get_smoke_config(arch)
    batch = _batch(cfg)
    opt = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    jstate, jnew, jmet = _jax_step(jax_smoke(arch), batch, opt, monkeypatch=monkeypatch)
    p0, tstate, tmet = _port_step(jstate, cfg, batch, opt)
    _hold_step(cfg, p0, tstate, tmet, jnew, jmet)


def test_encdec_microbatches_match_one_batch_and_jax(monkeypatch):
    """Two microbatches split ``frames`` with the tokens: against one batch
    at JAX's tolerance, and against JAX's two microbatches."""
    arch = "seamless-m4t-large-v2"
    cfg = get_smoke_config(arch)
    batch = _batch(cfg, seed=3)
    opt = dict(lr=1e-2)
    jstate, jnew, jmet = _jax_step(jax_smoke(arch), batch, opt, microbatches=2,
                                   monkeypatch=monkeypatch)
    _, one, _ = _port_step(jstate, cfg, batch, opt)
    p0, two, tmet = _port_step(jstate, cfg, batch, opt, microbatches=2)
    for a, b in zip(one.params.parameters(), two.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=2e-3, atol=2e-4)
    _hold_step(cfg, p0, two, tmet, jnew, jmet)


@pytest.mark.parametrize("arch", MODULE_ARCHS)
def test_remat_dots_matches_jax_dots(arch, monkeypatch):
    """remat="dots" (JAX's ``dots_with_no_batch_dims_saveable``) in both
    packages, one step."""
    cfg = dataclasses.replace(get_smoke_config(arch), remat="dots")
    batch = _batch(cfg, seed=1)
    opt = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    jcfg = dataclasses.replace(jax_smoke(arch), remat="dots")
    jstate, jnew, jmet = _jax_step(jcfg, batch, opt, monkeypatch=monkeypatch)
    p0, tstate, tmet = _port_step(jstate, cfg, batch, opt)
    _hold_step(cfg, p0, tstate, tmet, jnew, jmet)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _grads(cfg, remat, batch):
    c = dataclasses.replace(cfg, remat=remat)
    model = get_model(c, device="cpu", train=True)
    state, met = make_train_step(model, AdamWConfig(lr=1e-2))(init_train_state(model, 0), batch)
    return float(met["loss"]), [p.grad.clone() for p in state.params.parameters()]


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", MODULE_ARCHS)
def test_remat_equals_none(arch, remat):
    """Recomputing in the backward (every op, or all but the saved
    ``aten.mm`` outputs) gives the loss and gradients of no remat bit for
    bit: the same operations on the same inputs."""
    cfg = get_smoke_config(arch)
    batch = _torch(_batch(cfg))
    (l0, g0), (l1, g1) = _grads(cfg, "none", batch), _grads(cfg, remat, batch)
    assert l0 == l1
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", MODULE_ARCHS)
def test_remat_dots_recomputes_no_mm(arch, monkeypatch):
    """``aten.mm`` calls in the backward: "dots" makes as many as no remat
    (its recompute takes every product from the saved outputs), "full" as
    many more as the rematerialised bodies made in the forward.  Counted
    with the checkpoint's early stop off: by default the recompute stops
    once it has every tensor the backward reads, before a body's last
    product, whose output no gradient needs."""
    cfg = get_smoke_config(arch)
    batch = _torch(_batch(cfg))
    inside = {"on": False}
    real = L.checkpoint

    def flagged(fn, *args, **kw):
        inside["on"] = True
        try:
            return real(fn, *args, **kw)
        finally:
            inside["on"] = False

    monkeypatch.setattr(L, "checkpoint", flagged)
    backward, forward_in_bodies = {}, {}
    for remat in ("none", "dots", "full"):
        model = get_model(dataclasses.replace(cfg, remat=remat), device="cpu", train=True)
        params = model.init(0)

        class Forward(_CountMM):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func is torch.ops.aten.mm.default and inside["on"]:
                    self.n += 1
                return func(*args, **(kwargs or {}))

        with set_checkpoint_early_stop(False):
            with Forward() as fwd:
                logits, _ = model.forward(params, batch)
            loss = logits.float().square().mean()
            with _CountMM() as bwd:
                loss.backward()
        backward[remat], forward_in_bodies[remat] = bwd.n, fwd.n
    assert forward_in_bodies["none"] == 0 and forward_in_bodies["full"] > 0
    assert forward_in_bodies["dots"] == forward_in_bodies["full"]
    assert backward["dots"] == backward["none"]
    assert backward["full"] == backward["none"] + forward_in_bodies["full"]


# ---------------------------------------------------------------------------
# masters, casts and decay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_masters_round_to_the_served_weights(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="bfloat16")
    served = get_model(cfg, device="cpu").init(7)
    masters = get_model(cfg, device="cpu", train=True).init(7)
    names = [n for n, _ in served.named_parameters()]
    assert names == [n for n, _ in masters.named_parameters()]
    for (name, s), (_, m) in zip(served.named_parameters(), masters.named_parameters()):
        assert m.dtype == torch.float32 and m.requires_grad and not s.requires_grad
        assert torch.equal(m.detach().to(s.dtype), s), name


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_served_module_casts_no_parameter(arch):
    """In a bf16 served module's forward, prefill and decode step no
    ``aten._to_copy`` reads a leaf held in the compute dtype, and no graph
    is built; the master form casts its matrices (and its forward builds
    a graph)."""
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
        held = {p.data_ptr() for p in params.parameters()
                if p.dtype == (torch.float32 if train else torch.bfloat16) and p.ndim >= 2}
        toks = torch.zeros((2, 6), dtype=torch.int32)
        batch = {"tokens": toks}
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((2, 5, cfg.d_model))
        read.clear()
        with Casts():
            logits, _ = model.forward(params, batch)
            _, cache = model.prefill(params, batch, cache_len=8)
            model.decode_step(params, cache, toks[:, :1], 6)
        assert logits.dtype == torch.bfloat16 and logits.requires_grad == train
        assert bool(held & set(read)) == train


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_leaves_decay_as_in_jax(arch):
    """Each port leaf carries its JAX leaf's rank: every per-layer vector
    (norms, ``b_a``, ``lam``, ``b_f``, ``b``) sits in a stack of rank >= 2,
    so both packages decay it; only the top-level norms are rank 1."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg, device="cpu", train=True).init(0)
    ranks = jax_leaves(model)
    jp = jax.tree.map(np.asarray, jax_smoke_model_init(arch))
    for leaf in layout(model):
        node = jp
        for key in leaf.path:
            node = node[key]
        assert leaf.ndim == node.ndim, leaf.key
    top = {n for n, (_k, _i, r) in ranks.items() if r < 2}
    assert top == {n for n in ("final_norm", "enc_final_norm") if hasattr(model, n)}


def jax_smoke_model_init(arch):
    from repro.models import get_model as jax_get_model

    return jax_get_model(jax_smoke(arch)).init(jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# the recurrent cores' gradients against jax.grad
# ---------------------------------------------------------------------------

def _hold_grads(got, want, tol=FN_TOL, f64=None):
    """Each of ``got`` within ``tol`` of its JAX gradient's largest
    magnitude and, given ``f64``, of its float64 gradient's."""
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.detach().numpy().astype(np.float64)
        for ref in (np.asarray(b, np.float64),) + (() if f64 is None else (f64[i].numpy(),)):
            err = np.abs(a - ref).max()
            assert err <= tol * max(np.abs(ref).max(), 1e-30), (i, err, np.abs(ref).max())


def _port_grads(fn, arrays, cot, dtype=torch.float32):
    """The gradients of sum(fn(*arrays) * cot), zeros where an input is not
    reached (as jax.grad gives)."""
    ins = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrays]
    out = fn(*ins)
    out.backward(torch.from_numpy(cot).to(dtype))
    return [torch.zeros_like(t) if t.grad is None else t.grad for t in ins]


def _jax_grads(fn, arrays, cot):
    """Jitted: op by op, JAX's scans take seconds a call here."""
    return jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) * cot), argnums=tuple(range(len(arrays)))))(
        *[jnp.asarray(a) for a in arrays])


@pytest.mark.parametrize("S", [1, 13, 64])
def test_rglru_scan_gradient_matches_jax(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.05, 0.999, (2, S, 8)).astype(np.float32)
    b = rng.normal(size=(2, S, 8)).astype(np.float32)
    cot = rng.normal(size=(2, S, 8)).astype(np.float32)
    _hold_grads(_port_grads(rglru_scan, [a, b], cot),
                _jax_grads(jax_rglru._rglru_scan, [a, b], cot))


def test_causal_conv1d_gradient_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 11, 8)).astype(np.float32)
    w = rng.normal(size=(4, 8)).astype(np.float32)
    cot = rng.normal(size=(2, 11, 8)).astype(np.float32)
    _hold_grads(_port_grads(causal_conv1d, [x, w], cot),
                _jax_grads(jax_rglru._causal_conv1d, [x, w], cot))


@pytest.mark.parametrize("S,ties", [(40, False), (2 * CHUNK, False), (40, True)])
def test_mlstm_parallel_gradient_matches_jax(S, ties):
    """With ``ties`` every gate is 0 (itil = 0, log f = 0), so each row's
    stabiliser max is reached at every kept key: the gradient through the
    max splits evenly over them in both packages."""
    rng = np.random.default_rng(S + ties)
    B, H, hd = 1, 2, 8
    q, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32) for _ in range(3))
    if ties:
        itil = np.zeros((B, S, H), np.float32)
        logf = np.zeros((B, S, H), np.float32)
    else:
        itil = rng.normal(size=(B, S, H)).astype(np.float32)
        logf = -np.abs(rng.normal(size=(B, S, H))).astype(np.float32) * 0.1
    cot = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    arrays = [q, k, v, itil, logf]
    _hold_grads(_port_grads(mlstm_parallel, arrays, cot),
                _jax_grads(jax_xlstm._mlstm_parallel, arrays, cot), NORM_TOL,
                f64=_port_grads(mlstm_parallel, arrays, cot, torch.float64))
