"""The gradient norm of a deep random xLSTM's first train step, in JAX and in the port.

On the CPU, at the smoke config's widths (d_model 64, 4 heads of 16,
vocabulary 512) with the published layer pattern (one sLSTM every 8
layers) at several depths up to the published 48, and a sequence of two
mLSTM chunks (512 tokens): JAX's ``init`` makes the parameters,
``models.convert.from_jax_params(..., masters=True)`` carries them into the
port, and one ``make_train_step`` step of each package on one seeded batch
reports its loss and its grad norm (the global norm before clipping), with
the port's largest leaf gradients.  Beside them, each package's ulp
control: its own step again from parameters each moved by ULP relative
(seeded), the order of a sum taken in another order.  Where a package's
control lies as far from its run as the port lies from JAX, the two differ
by what rounding does at that depth, not by a defect.  This shows whether
the port's gradient at depth is JAX's: the parity tests hold the 4-layer
smoke config only.

JAX's step is compiled with ``xla_allow_excess_precision`` off (as
``tests/torch_bf16.py`` does; it matters for ``--dtype bfloat16`` only).
Prints one JSON object per depth:

    PYTHONPATH=src:tests python tests/torch_xlstm_train_depth.py [--dtype bfloat16]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import get_model as jax_get_model
from repro.training import AdamWConfig as JAdamW
from repro.training import init_train_state as jax_init_state
from repro.training import make_train_step as jax_make_step
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params
from repro_torch.training import AdamWConfig, adamw_init, make_train_step
from repro_torch.training.train_step import TrainState, trainable
from torch_bf16 import compiled_fn

DEPTHS = (8, 16, 48)  # layers, one sLSTM every 8 as published
SEQ, BATCH = 512, 1  # two mLSTM chunks
ULP = 1e-7


def step_norms(n_layers: int, dtype: str, seed: int = 0) -> dict:
    shape = dict(n_layers=n_layers, slstm_every=8, compute_dtype=dtype)
    jcfg = dataclasses.replace(jax_get_smoke_config("xlstm-1.3b"), **shape)
    cfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"), **shape)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "domain": rng.integers(0, 16, BATCH).astype(np.int32)}
    jm = jax_get_model(jcfg)
    jstate = jax_init_state(jm, jax.random.PRNGKey(seed))
    jstep = compiled_fn(jax_make_step(jm, JAdamW()))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jmet = jstep(jstate, jbatch)
    moved = np.random.default_rng(seed + 1)
    jctrl = jax.tree.map(lambda p: p * (1 + ULP * moved.standard_normal(p.shape)).astype(p.dtype),
                         jstate.params)
    _, jcmet = jstep(dataclasses.replace(jstate, params=jctrl), jbatch)
    step = make_train_step(get_model(cfg, device="cpu", train=True), AdamWConfig())

    def port_step(jparams):
        params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu",
                                 masters=True)
        state = TrainState(params, adamw_init(trainable(params)),
                           torch.zeros((), dtype=torch.int32))
        return step(state, {k: torch.from_numpy(v) for k, v in batch.items()})

    state, tmet = port_step(jstate.params)
    leaves = sorted(((float(p.grad.norm()), n) for n, p in state.params.named_parameters()),
                    reverse=True)
    _, tcmet = port_step(jctrl)
    jn, tn = float(jmet["grad_norm"]), float(tmet["grad_norm"])
    return {"d_model": cfg.d_model, "n_layers": n_layers, "seq": SEQ, "batch": BATCH,
            "dtype": dtype, "jax_loss": float(jmet["loss"]), "port_loss": float(tmet["loss"]),
            "jax_grad_norm": jn, "port_grad_norm": tn, "grad_norm_rel_diff": abs(tn - jn) / jn,
            "jax_ulp_control_rel_diff": abs(float(jcmet["grad_norm"]) - jn) / jn,
            "port_ulp_control_rel_diff": abs(float(tcmet["grad_norm"]) - tn) / tn,
            "port_largest_leaf_grad_norms": [[n, g] for g, n in leaves[:4]]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    args = ap.parse_args()
    torch.set_num_threads(4)
    for n_layers in DEPTHS:
        print(json.dumps(step_norms(n_layers, args.dtype)), flush=True)
