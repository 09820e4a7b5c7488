"""The sLSTM's recurrence over time (``repro_torch.kernels.slstm``) and the
tie rules of the port's softplus and clamps, against the JAX package.

  * ``slstm_scan_ref`` (the loop the model runs on the CPU) against JAX's
    ``lax.scan`` of ``repro.models.xlstm``'s step (its einsum with R, then
    ``_slstm_cell``), and ``SLSTMBlock.full`` against ``_slstm_block_full``;
  * ``slstm_bwd_ref`` (the backward derived by hand, op for op the CUDA
    kernel's) against ``jax.vjp`` of that scan (dwx, dR) and against torch
    autograd of the plain loop, and, through ``SLSTMScan`` on CPU tensors,
    the block's gradient (x, W, R, b, ln, w_out) against ``jax.vjp`` of
    ``_slstm_block_full``;
  * constructed ties (logf + m == i at several steps, n == 1 at t = 0)
    held to JAX, where only an even split of the gradient agrees;
  * random R, each gate's product held apart: gate hd reads head hd of h;
  * ``layers.softplus``, ``log_sigmoid`` and the two clamps (``maximum``):
    forwards bit-equal to the old ``clamp_min`` forms, gradients at the tie
    0.5, as ``jax.grad``'s;
  * the wrappers on CPU tensors take the plain version and count no launch;
  * the CUDA wrappers' route rule (``ops.route``) on an H100's figures:
    resident (one launch a call) for xlstm-1.3b's training shape, per-step
    for one step, for widths and batches past the resident route's and on
    a card with fewer SMs than its blocks; a width that is no multiple of
    64 raises.

Widths B = 2, S = 16, d = 64 (float32).  Tolerance: each output within
TOL = 1e-5 of its largest magnitude (max |port − jax| ≤ TOL · max |jax|);
the two sum R's products and the cell's gradient in other orders, and
XLA's exp, tanh and log1p round otherwise than torch's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.xlstm as JX
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import launch_counts
from repro_torch.kernels.slstm import (
    Saved,
    SLSTMScan,
    slstm_bwd,
    slstm_bwd_ref,
    slstm_fwd,
    slstm_scan_ref,
)
from repro_torch.kernels.slstm import ops as slstm_ops
from repro_torch.kernels.slstm import ref as slstm_ref
from repro_torch.models import layers as L
from repro_torch.models.xlstm import SLSTMBlock

B, S, D = 2, 16, 64
TOL = 1e-5
TIE_UNITS = 8  # the first units of the tie construction
TIE_I = (0.0, 0.5, 0.5, 0.25, 0.5, 1.0, 1.0, -1.0, 1.0, 1.0, 2.0, 2.0, 0.0, 2.0, 2.0, 2.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, ties=False):
    """numpy wx (B, S, 4D), R (4, D/4, D), dhs (B, S, D).  With ``ties``
    the first TIE_UNITS units take f = 200 (log σ(f) is exactly 0 in
    float32), no recurrence into their i gate, and i from TIE_I, so that
    m_t = max(m_{t−1}, i_t) ties at t = 0, 2, 4, 6, 8, 9, 11, 13, 14, 15
    in both packages; n_0 = 1 there."""
    rng = np.random.default_rng(seed)
    wx = rng.normal(size=(B, S, 4 * D)).astype(np.float32)
    R = (rng.normal(size=(4, D // 4, D)) * 2.0 / np.sqrt(D)).astype(np.float32)
    dhs = rng.normal(size=(B, S, D)).astype(np.float32)
    if ties:
        u = slice(0, TIE_UNITS)
        wx[:, :, 2 * D:3 * D][:, :, u] = 200.0
        wx[:, :, D:2 * D][:, :, u] = np.asarray(TIE_I, np.float32)[None, :, None]
        R[1][:, u] = 0.0
    return wx, R, dhs


def _jax_scan(wx, R):
    """JAX's scan of ``_slstm_block_full``'s step (xlstm.py:242-256) from
    the zero state: (hs (B, S, d), the last carry)."""
    Bn, _, d4 = wx.shape
    d = d4 // 4

    def step(carry, wx_t):
        rec = jnp.einsum("bhd,hde->bhe", carry[0].reshape(Bn, 4, d // 4), R).reshape(Bn, 4 * d)
        return JX._slstm_cell(carry, wx_t + rec)

    init = tuple(jnp.zeros((Bn, d), jnp.float32) for _ in range(4))
    last, hs = jax.lax.scan(step, init, jnp.moveaxis(wx, 1, 0))
    return jnp.moveaxis(hs, 0, 1), last


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hold(got, want, what, tol=TOL):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: max |port - jax| {err} > {tol} * {scale}"
    return err / scale


def _jax_grads(wx, R, dhs):
    _, vjp = jax.vjp(lambda w, r: _jax_scan(w, r)[0], jnp.asarray(wx), jnp.asarray(R))
    return vjp(jnp.asarray(dhs))


def _autograd(wx, R, dhs):
    w, r = _t(wx).requires_grad_(), _t(R).requires_grad_()
    hs, _ = slstm_scan_ref(w, r)
    return torch.autograd.grad(hs, (w, r), _t(dhs))


@pytest.mark.parametrize("seed", [0, 1])
def test_scan_ref_matches_jax_scan(seed):
    wx, R, _ = _inputs(seed)
    hs, last = slstm_scan_ref(_t(wx), _t(R))
    jhs, jlast = _jax_scan(jnp.asarray(wx), jnp.asarray(R))
    _hold(hs, jhs, "hs")
    for name, a, b in zip("hcnm", last, jlast):
        _hold(a, b, f"last {name}")


@pytest.mark.parametrize("seed", [0, 1])
def test_bwd_ref_matches_jax_vjp_and_torch_autograd(seed):
    wx, R, dhs = _inputs(seed)
    hs, _last, saved = slstm_scan_ref(_t(wx), _t(R), save=True)
    dwx, dR = slstm_bwd_ref(_t(dhs), _t(R), hs, saved)
    jdwx, jdR = _jax_grads(wx, R, dhs)
    _hold(dwx, jdwx, "dwx")
    _hold(dR, jdR, "dR")
    awx, aR = _autograd(wx, R, dhs)
    _hold(dwx, awx.numpy(), "dwx vs autograd")
    _hold(dR, aR.numpy(), "dR vs autograd")


def test_constructed_ties_are_held_to_jax(monkeypatch):
    """logf + m == i at ten steps and n == 1 at t = 0 in the tie units:
    the hand backward and autograd of the plain loop both give JAX's
    gradient, which sends half of it down each branch; a rule that sends
    all of it to the first branch does not."""
    wx, R, dhs = _inputs(2, ties=True)
    hs, _last, saved = slstm_scan_ref(_t(wx), _t(R), save=True)
    g = saved.g
    logf = L.log_sigmoid(g[..., 2 * D:3 * D])
    m_prev = torch.cat([torch.zeros_like(saved.m[:, :1]), saved.m[:, :-1]], 1)
    m_ties = (logf + m_prev == g[..., D:2 * D])[..., :TIE_UNITS]
    assert int(m_ties.sum()) == B * TIE_UNITS * 10
    assert bool((saved.n[:, 0, :TIE_UNITS] == 1.0).all())
    jdwx, jdR = _jax_grads(wx, R, dhs)
    dwx, dR = slstm_bwd_ref(_t(dhs), _t(R), hs, saved)
    _hold(dwx, jdwx, "dwx at ties")
    _hold(dR, jdR, "dR at ties")
    awx, aR = _autograd(wx, R, dhs)
    _hold(awx, jdwx, "autograd dwx at ties")
    _hold(aR, jdR, "autograd dR at ties")
    monkeypatch.setattr(slstm_ref, "_tie_split", lambda x, y: (x >= y).float())
    whole, _ = slstm_bwd_ref(_t(dhs), _t(R), hs, saved)
    with pytest.raises(AssertionError):
        _hold(whole, jdwx, "dwx with the whole gradient to one branch")


def test_each_gate_reads_its_own_head():
    """Gate block hd of rec(h) is h's head hd times R[hd] (z ← head 0, i ←
    1, f ← 2, o ← 3), as JAX's einsum over (head, e) flattened; the reading
    "each head has its own four gates" differs on random R."""
    rng = np.random.default_rng(3)
    h = rng.normal(size=(B, D)).astype(np.float32)
    R = rng.normal(size=(4, D // 4, D)).astype(np.float32)
    rec = slstm_ref.recurrent(_t(h), _t(R)).numpy()
    dh = D // 4
    jrec = np.asarray(jnp.einsum("bhd,hde->bhe", h.reshape(B, 4, dh), R).reshape(B, 4 * D))
    per_head_gates = np.concatenate(
        [np.einsum("bk,hke->bhe", h.reshape(B, 4, dh)[:, hd], R)[:, :, hd * dh:(hd + 1) * dh]
         .reshape(B, -1) for hd in range(4)], -1)
    for gate in range(4):
        want = h[:, gate * dh:(gate + 1) * dh] @ R[gate]
        np.testing.assert_allclose(rec[:, gate * D:(gate + 1) * D], want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(jrec[:, gate * D:(gate + 1) * D], want, rtol=1e-5, atol=1e-5)
    assert np.abs(rec - per_head_gates).max() > 1.0


def _block_params(seed):
    rng = np.random.default_rng(seed)
    return {"ln": (1.0 + 0.1 * rng.normal(size=D)).astype(np.float32),
            "W": (rng.normal(size=(D, 4 * D)) / np.sqrt(D)).astype(np.float32),
            "R": (rng.normal(size=(4, D // 4, D)) * 2.0 / np.sqrt(D)).astype(np.float32),
            "b": (0.1 * rng.normal(size=4 * D)).astype(np.float32),
            "w_out": (rng.normal(size=(D, D)) / np.sqrt(D)).astype(np.float32)}


def test_block_and_its_gradient_match_jax():
    """SLSTMBlock.full on the CPU (the plain loop) against
    ``_slstm_block_full``; the block's gradient through ``SLSTMScan`` (its
    forward and ``slstm_bwd_ref``, the plain versions on CPU tensors)
    against ``jax.vjp`` of it, for x and every leaf."""
    cfg = get_smoke_config("xlstm-1.3b")
    assert cfg.d_model == D
    lp = _block_params(4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    dy = rng.normal(size=(B, S, D)).astype(np.float32)
    blk = SLSTMBlock(cfg, device="cpu", masters=True)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            p.copy_(_t(lp[name]))
    jy, vjp = jax.vjp(lambda xx, p: JX._slstm_block_full(xx, p, cfg), jnp.asarray(x),
                      {k: jnp.asarray(v) for k, v in lp.items()})
    jdx, jdp = vjp(jnp.asarray(dy))
    xt = _t(x).requires_grad_()
    _hold(blk.full(xt), jy, "block forward")
    wx = blk._gates_in(xt)
    y = xt + SLSTMScan.apply(wx, blk.R) @ blk.w_out
    _hold(y, jy, "block forward through SLSTMScan")
    names = [n for n, _ in blk.named_parameters()]
    grads = torch.autograd.grad(y, [xt] + [p for _, p in blk.named_parameters()], _t(dy))
    _hold(grads[0], jdx, "dx")
    for name, gr in zip(names, grads[1:]):
        _hold(gr, jdp[name], f"d{name}")


def test_wrappers_on_cpu_take_the_plain_version_and_count_no_launch():
    wx, R, dhs = _inputs(6)
    before = launch_counts()
    hs, last = slstm_fwd(_t(wx), _t(R))
    rhs, rlast = slstm_scan_ref(_t(wx), _t(R))
    assert torch.equal(hs, rhs) and all(torch.equal(a, b) for a, b in zip(last, rlast))
    hs, last, saved = slstm_fwd(_t(wx), _t(R), save=True)
    assert isinstance(saved, Saved)
    assert [tuple(t.shape) for t in saved] == [(B, S, 4 * D)] + [(B, S, D)] * 3
    assert torch.equal(saved.c[:, -1], last[1]) and torch.equal(saved.m[:, -1], last[3])
    dwx, dR = slstm_bwd(_t(dhs), _t(R), hs, saved)
    rwx, rR = slstm_bwd_ref(_t(dhs), _t(R), hs, saved)
    assert torch.equal(dwx, rwx) and torch.equal(dR, rR)
    # from a given state: the loop continues where the first half ended
    h1, mid = slstm_fwd(_t(wx[:, :S // 2]), _t(R))
    h2, end = slstm_fwd(_t(wx[:, S // 2:]), _t(R), [t.contiguous() for t in mid])
    assert torch.equal(torch.cat([h1, h2], 1), hs)
    assert all(torch.equal(a, b) for a, b in zip(end, last))
    w, r = _t(wx).requires_grad_(), _t(R).requires_grad_()
    gwx, gR = torch.autograd.grad(SLSTMScan.apply(w, r), (w, r), _t(dhs))
    assert torch.equal(gwx, rwx) and torch.equal(gR, rR)
    assert launch_counts() == before


@pytest.mark.parametrize("case", ["float64", "strided", "R shape", "state shape", "no steps"])
def test_wrappers_check_their_inputs(case):
    wx, R, _ = (_t(a) for a in _inputs(7))
    state = None
    if case == "float64":
        wx = wx.double()
    elif case == "strided":
        wx = wx.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "R shape":
        R = R[:, :, :D // 2].contiguous()
    elif case == "state shape":
        state = [torch.zeros(B, D + 1)] * 4
    else:
        wx = wx[:, :0]
    with pytest.raises((TypeError, ValueError)):
        slstm_fwd(wx, R, state)


def _old_softplus(x):
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


TIE_RULES = {
    # name: (port function, old form, JAX function, the tie point)
    "softplus": (L.softplus, _old_softplus, jax.nn.softplus, 0.0),
    "log_sigmoid": (L.log_sigmoid, lambda x: -_old_softplus(-x), jax.nn.log_sigmoid, 0.0),
    "slstm max(n, 1)": (lambda n: L.maximum(n, 1.0), lambda n: torch.clamp_min(n, 1.0),
                        lambda n: jnp.maximum(n, 1.0), 1.0),
    "rglru max(1 - a², 1e-6)": (lambda x: L.maximum(x, 1e-6), lambda x: torch.clamp_min(x, 1e-6),
                                lambda x: jnp.maximum(x, 1e-6), float(np.float32(1e-6))),
}


@pytest.mark.parametrize("name", list(TIE_RULES))
def test_tie_rules_forward_bit_equal_and_gradient_as_jax(name):
    port, old, jfn, tie = TIE_RULES[name]
    rng = np.random.default_rng(8)
    x = np.concatenate([(rng.normal(size=100_000) * 4).astype(np.float32),
                        np.float32([0.0, -0.0, 1.0, 1e-6, np.inf, -np.inf, 200.0, -200.0, tie])])
    for dt in (torch.float32, torch.bfloat16):
        xt = _t(x).to(dt)
        assert torch.equal(port(xt).view(torch.int16 if dt == torch.bfloat16 else torch.int32),
                           old(xt).view(torch.int16 if dt == torch.bfloat16 else torch.int32))
    pts = np.float32([tie, tie + 0.75, tie - 0.5])
    xt = _t(pts).requires_grad_()
    got = torch.autograd.grad(port(xt).sum(), xt)[0].numpy()
    want = np.asarray(jax.vmap(jax.grad(jfn))(jnp.asarray(pts)))
    assert got[0] == want[0] == 0.5
    np.testing.assert_allclose(got, want, rtol=1e-6)


H100 = (132, 232_448)  # SMs, opt-in shared memory a block (bytes)


@pytest.mark.parametrize("shape,card,want", [
    ((8, 512, 2048), H100, "resident"),   # xlstm-1.3b's training call
    ((8, 1, 2048), H100, "step"),         # a decode step
    ((8, 512, 4096), H100, "step"),       # 256 blocks, and the slice past the registers
    ((17, 48, 128), H100, "resident"),    # three row tiles
    ((32, 48, 64), H100, "resident"),     # four row tiles, the most a block keeps
    ((33, 48, 64), H100, "step"),         # five
    ((8, 512, 2048), (114, 232_448), "step"),  # 128 blocks on a card of 114 SMs
    ((8, 512, 2048), (132, 65_536), "step"),   # the h tile and partials past the shared memory
])
def test_slstm_route_rule(shape, card, want):
    assert slstm_ops.route(*shape, *card) == want


def test_slstm_route_rule_refuses_a_width_that_is_no_multiple_of_64():
    for d in (96, 32, 2050):
        with pytest.raises(ValueError, match="multiple of 64"):
            slstm_ops.route(8, 512, d, *H100)


def test_slstm_resident_shared_memory_at_xlstm_width():
    """The h tile (8·d floats) and the forward's partials (8,192 floats)."""
    assert slstm_ops.resident_smem(2048) == (8 * 2048 + 8192) * 4 == 98_304
