"""The AdamW wrappers' CPU route (``kernels.adamw``: ``adamw_norm`` and
``adamw_apply``, the plain version in ``ref.py``) against the JAX package's
``repro.training.adamw_update``.

Held: eight steps (three of warm-up, then the cosine) over a tree of odd
sizes with rank-1, rank-2 and rank-3 leaves, from the same numpy values,
the clip off and on: lr, grad_norm and clip_scale within 1e-6 relative,
and every parameter, m and v within 1e-6 of the leaf's largest magnitude
before or after the step (float32, the same operations; the norm sums its
terms in another order, and torch rounds ``add_(…, alpha=)`` and
``addcmul_`` as fused multiply-adds, as the card's kernel does, where XLA
may not: an m whose two terms nearly cancel, as the one-element leaf's
does here, differs by an ulp of its terms, which is far more than 1e-6 of
the small result), with the leaves at their storage's start and at an
offset of one element (where the card takes its scalar route).  A CPU
call dispatches each op once as a fallback and counts no launch; the
wrappers refuse what the kernel does not take; the meta device (the dry
run's) takes the plain version.  The kernel itself runs
only on the card (``tests/test_torch_cuda.py -k adamw``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import AdamWConfig as JAdamW
from repro.training import adamw_init as jax_adamw_init
from repro.training import adamw_update as jax_adamw_update
from repro_torch import kernels
from repro_torch.kernels.adamw import Scalars, adamw_apply, adamw_norm
from repro_torch.obs.kprof import KernelProfiler
from repro_torch.training import AdamWConfig, adamw_init, adamw_update

SHAPES = {"one": (1,), "bias": (7,), "w": (33, 5), "stack": (3, 5, 7)}
STEPS = 8
OPT = dict(lr=0.05, weight_decay=0.1, warmup_steps=3, total_steps=STEPS, min_lr_ratio=0.1)
RTOL = 1e-6


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _hold(got, want, prev, what):
    """max |got − want| within RTOL of the leaf's largest magnitude, before
    (``prev``) or after (``want``) the step."""
    got, want, prev = (np.asarray(x, np.float64) for x in (got, want, prev))
    scale = max(np.abs(want).max(), np.abs(prev).max(), 1e-30)
    assert np.abs(got - want).max() <= RTOL * scale, what


def _at_offset(a: np.ndarray, offset: bool) -> torch.Tensor:
    """``a`` as a contiguous float32 tensor, at its storage's start or one
    element past it."""
    if not offset:
        return torch.from_numpy(a.copy())
    buf = torch.empty(a.size + 1, dtype=torch.float32)
    out = buf[1:].view(a.shape)
    out.copy_(torch.from_numpy(a))
    return out


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_adamw_matches_jax_through_warmup_and_cosine(clip, offset):
    rng = np.random.default_rng(7)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _at_offset(v, offset) for k, v in p0.items()}
    js, ts = jax_adamw_init(jp), adamw_init(tp)
    ts["m"] = {k: _at_offset(np.zeros(s, np.float32), offset) for k, s in SHAPES.items()}
    ts["v"] = {k: _at_offset(np.zeros(s, np.float32), offset) for k, s in SHAPES.items()}
    ranks = {k: len(s) for k, s in SHAPES.items()}
    jcfg, tcfg = JAdamW(clip_norm=clip, **OPT), AdamWConfig(clip_norm=clip, **OPT)
    lrs, clipped = [], []
    for _ in range(STEPS):
        g = {k: rng.normal(scale=0.3, size=s).astype(np.float32) for k, s in SHAPES.items()}
        old_step = ts["step"]
        prev = {k: (np.asarray(jp[k]), np.asarray(js["m"][k]), np.asarray(js["v"][k]))
                for k in SHAPES}
        jp, js, jm = jax_adamw_update(jcfg, jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        _, ts, tm = adamw_update(tcfg, tp, {k: _at_offset(v, offset) for k, v in g.items()}, ts,
                                 ranks)
        assert int(old_step) == int(ts["step"]) - 1  # the counter is a new tensor
        assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
        for k in ("lr", "grad_norm", "clip_scale"):
            assert tm[k].dtype == torch.float32 and tm[k].shape == ()
            assert _rel(tm[k], jm[k]) <= RTOL, k
        for k in SHAPES:
            _hold(tp[k], jp[k], prev[k][0], ("p", k))
            _hold(ts["m"][k], js["m"][k], prev[k][1], ("m", k))
            _hold(ts["v"][k], js["v"][k], prev[k][2], ("v", k))
        lrs.append(float(tm["lr"]))
        clipped.append(float(tm["clip_scale"]) < 1.0)
    assert int(ts["step"]) == int(js["step"]) == STEPS
    # the steps covered the warm-up's rise and the cosine's fall, and the clip
    # acted exactly where it was on
    assert lrs[0] < lrs[1] < lrs[2] and lrs[3] > lrs[-1]
    assert all(clipped) == (clip < 1.0) and any(clipped) == (clip < 1.0)


def test_a_cpu_call_dispatches_each_op_once_as_a_fallback():
    leaves = {"w": torch.ones(3, 4), "b": torch.ones(4)}
    state = adamw_init(leaves)
    grads = {k: torch.full_like(v, 0.5) for k, v in leaves.items()}
    before = kernels.launch_counts()
    prof = kernels.set_profiler(KernelProfiler())
    try:
        adamw_update(AdamWConfig(), leaves, grads, state, {"w": 2, "b": 1})
    finally:
        kernels.set_profiler(None)
    assert kernels.launch_counts() == before
    summary = prof.summary()
    assert sorted(summary) == ["adamw_norm", "adamw_update"]
    for op in summary.values():
        assert (op["dispatches"], op["fallbacks"], op["rows_real"]) == (1, 1, 16)
    assert kernels.op_names()["adamw_norm"] == "adamw_norm"
    assert kernels.op_names()["adamw_update"] == "adamw_update"


def _leaves():
    p, g, m, v = ([torch.ones(5), torch.ones(2, 3)] for _ in range(4))
    sc = adamw_norm(AdamWConfig(), g, torch.zeros((), dtype=torch.int32))
    return p, g, m, v, [False, True], sc


BAD = {
    "a float64 gradient": (lambda p, g, m, v, d, sc: (p, [g[0].double(), g[1]], m, v, d, sc),
                           TypeError, "dtype torch.float64"),
    "a bfloat16 parameter": (lambda p, g, m, v, d, sc: ([p[0], p[1].bfloat16()], g, m, v, d, sc),
                             TypeError, "dtype torch.bfloat16"),
    "a strided m": (lambda p, g, m, v, d, sc: (p, g, [m[0], torch.ones(3, 2).T], v, d, sc),
                    ValueError, "contiguous"),
    "a v of another shape": (lambda p, g, m, v, d, sc: (p, g, m, [v[0], torch.ones(3, 2)], d, sc),
                             ValueError, "shape"),
    "leaves on two devices": (lambda p, g, m, v, d, sc: (p, [g[0], g[1].to("meta")], m, v, d, sc),
                              ValueError, "on meta"),
    "a decay flag short": (lambda p, g, m, v, d, sc: (p, g, m, v, d[:1], sc),
                           ValueError, "decay flags"),
    "no leaves": (lambda p, g, m, v, d, sc: ([], [], [], [], [], sc), ValueError, "no leaves"),
    "a float64 lr": (lambda p, g, m, v, d, sc: (p, g, m, v, d, sc._replace(lr=sc.lr.double())),
                     TypeError, "lr"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_the_update_refuses_what_the_kernel_does_not_take(case):
    edit, err, match = BAD[case]
    with pytest.raises(err, match=match):
        adamw_apply(AdamWConfig(), *edit(*_leaves()))


@pytest.mark.parametrize("case", ["int64 step", "float64 gradient", "two devices", "no leaves"])
def test_the_norm_refuses_what_the_kernel_does_not_take(case):
    g, step = [torch.ones(4), torch.ones(2, 2)], torch.zeros((), dtype=torch.int32)
    err, match = ValueError, None
    if case == "int64 step":
        step, err, match = step.long(), TypeError, "step"
    elif case == "float64 gradient":
        g, err, match = [g[0], g[1].double()], TypeError, "grads"
    elif case == "two devices":
        g, match = [g[0], g[1].to("meta")], "on meta"
    else:
        g, match = [], "no leaves"
    with pytest.raises(err, match=match):
        adamw_norm(AdamWConfig(), g, step)


def test_the_meta_device_takes_the_plain_version():
    leaves = {"w": torch.empty(4, 3, device="meta"), "b": torch.empty(3, device="meta")}
    state = adamw_init(leaves)
    before = kernels.launch_counts()
    _, state, met = adamw_update(AdamWConfig(), leaves, {k: torch.empty_like(v) for k, v in
                                                        leaves.items()}, state, {"w": 2, "b": 1})
    assert kernels.launch_counts() == before
    assert state["step"].device.type == "meta" and state["step"].dtype == torch.int32
    assert all(v.device.type == "meta" and v.shape == () for v in met.values())


def test_the_norm_returns_the_steps_scalars_as_the_plain_version_takes_them():
    """``adamw_norm``'s scalars are the plain version's, field by field:
    the clip, the schedule's warm-up and the bias corrections at step 1."""
    cfg = AdamWConfig(lr=0.5, warmup_steps=4, clip_norm=1.0, b1=0.5, b2=0.75)
    sc = adamw_norm(cfg, [torch.full((4,), 1.5), torch.full((2, 2), 1.5)],
                    torch.zeros((), dtype=torch.int32))
    assert isinstance(sc, Scalars)
    assert int(sc.step) == 1 and sc.step.dtype == torch.int32
    assert float(sc.grad_norm) == pytest.approx(np.sqrt(8 * 1.5 ** 2), rel=1e-6)
    assert float(sc.clip_scale) == pytest.approx(1.0 / np.sqrt(18.0), rel=1e-6)
    assert float(sc.lr) == pytest.approx(0.5 / 4, rel=1e-6)
    assert (float(sc.bc1), float(sc.bc2)) == (0.5, 0.25)
