"""The gradient norm of a deep random xLSTM's first train step, in JAX and in the port.

On the CPU, at the smoke config's widths (d_model 64, 4 heads of 16,
vocabulary 512) or, with ``--published-width``, at xlstm-1.3b's own
(d_model 2,048, 4 heads, vocabulary 50,304), with the published layer
pattern (one sLSTM every 8 layers) at several depths (``--depths``; the
published 48 at the smoke widths), on one seeded batch of two mLSTM chunks
(512 tokens): JAX's ``init`` makes the parameters,
``models.convert.from_jax_params(..., masters=True)`` carries them into the
port, and each package takes the gradient of the train step's loss (the
token-mean cross-entropy with its z-loss) on the batch, reporting the loss,
the global grad norm (the train step's ``grad_norm``, before clipping) and
its largest leaf gradients.  Beside them, each package's ulp control: its
own loss and gradient again from parameters each moved by ULP relative
(seeded), the order of a sum taken in another order.  Where a package's
control lies as far from its run as the port lies from JAX, the two differ
by what rounding does at that depth, not by a defect; the control's loss
change over ULP is how far the package's loss amplifies a rounding-sized
change.  This shows whether the port's gradient at depth is JAX's: the
parity tests hold the 4-layer smoke config only.

JAX's functions are compiled with ``xla_allow_excess_precision`` off (as
``tests/torch_bf16.py`` does; it matters for ``--dtype bfloat16`` only).
Prints one JSON object per depth:

    PYTHONPATH=src:tests python tests/torch_xlstm_train_depth.py [--dtype bfloat16]
        [--published-width --depths 8 16]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import get_model as jax_get_model
from repro.training.train_step import cross_entropy as jax_cross_entropy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params
from repro_torch.models.layers import f32_accumulation
from repro_torch.training.train_step import cross_entropy, trainable
from torch_bf16 import compiled_fn

DEPTHS = (8, 16, 48)  # layers, one sLSTM every 8 as published
SEQ, BATCH = 512, 1  # two mLSTM chunks
ULP = 1e-7
TOP_LEAVES = 4


def _norm(grads) -> float:
    return float(np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum() for g in grads)))


def step_norms(n_layers: int, dtype: str, published: bool = False, seed: int = 0) -> dict:
    shape = dict(n_layers=n_layers, slstm_every=8, compute_dtype=dtype)
    jbase = jax_get_config if published else jax_get_smoke_config
    base = get_config if published else get_smoke_config
    jcfg = dataclasses.replace(jbase("xlstm-1.3b"), **shape)
    cfg = dataclasses.replace(base("xlstm-1.3b"), **shape)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    jm = jax_get_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(seed))

    def jloss(p, t, lab):
        return jax_cross_entropy(jm.forward(p, {"tokens": t})[0], lab)[0]

    jgrad = compiled_fn(jax.value_and_grad(jloss))
    jt, jl = jnp.asarray(toks), jnp.asarray(labels)

    def jax_run(p):
        loss, g = jgrad(p, jt, jl)
        leaves = jax.tree_util.tree_flatten_with_path(g)[0]
        named = sorted(((float(jnp.linalg.norm(v.astype(jnp.float32))), jax.tree_util.keystr(k))
                        for k, v in leaves), reverse=True)
        return float(loss), _norm(v for _k, v in leaves), named[:TOP_LEAVES]

    moved = np.random.default_rng(seed + 1)
    jctrl = jax.tree.map(lambda p: p * (1 + ULP * moved.standard_normal(p.shape)).astype(p.dtype),
                         jparams)
    host, host_ctrl = jax.tree.map(np.asarray, jparams), jax.tree.map(np.asarray, jctrl)
    jrun, jcrun = jax_run(jparams), jax_run(jctrl)
    del jparams, jctrl, jgrad
    model = get_model(cfg, device="cpu", train=True)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}

    def port_run(hparams):
        params = from_jax_params(hparams, cfg, device="cpu", masters=True)
        with f32_accumulation(), torch.enable_grad():
            loss = cross_entropy(model.forward(params, batch)[0], batch["labels"])[0]
            loss.backward()
        leaves = trainable(params)
        named = sorted(((float(p.grad.norm()), n) for n, p in leaves.items()), reverse=True)
        norm = _norm(p.grad.numpy() for p in leaves.values())
        return float(loss.detach()), norm, named[:TOP_LEAVES]

    trun = port_run(host)
    tcrun = port_run(host_ctrl)
    (jl_, jn, jtop), (jcl, jcn, _), (tl, tn, ttop), (tcl, tcn, _) = jrun, jcrun, trun, tcrun
    return {"d_model": cfg.d_model, "vocab": cfg.vocab, "n_layers": n_layers, "seq": SEQ,
            "batch": BATCH, "dtype": dtype, "jax_loss": jl_, "port_loss": tl,
            "loss_rel_diff": abs(tl - jl_) / abs(jl_),
            "jax_ulp_control_loss_rel_diff": abs(jcl - jl_) / abs(jl_),
            "port_ulp_control_loss_rel_diff": abs(tcl - tl) / abs(tl),
            "jax_grad_norm": jn, "port_grad_norm": tn, "grad_norm_rel_diff": abs(tn - jn) / jn,
            "jax_ulp_control_rel_diff": abs(jcn - jn) / jn,
            "port_ulp_control_rel_diff": abs(tcn - tn) / tn,
            "jax_largest_leaf_grad_norms": [[n, g] for g, n in jtop],
            "port_largest_leaf_grad_norms": [[n, g] for g, n in ttop]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--published-width", action="store_true",
                    help="xlstm-1.3b's own widths and vocabulary, not the smoke's")
    ap.add_argument("--depths", type=int, nargs="+", default=list(DEPTHS))
    args = ap.parse_args()
    torch.set_num_threads(4)
    for n_layers in args.depths:
        print(json.dumps(step_norms(n_layers, args.dtype, args.published_width)), flush=True)
