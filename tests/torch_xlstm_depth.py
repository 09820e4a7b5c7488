"""How far a deep xLSTM's decode and forward drift apart, in JAX and in the port.

On the CPU, JAX's weights carried into the port: for each (d_model,
n_layers) the largest |decode − forward| of each package over its first 16
positions, and the largest |port − JAX| of the forwards and of the
decodes, each over the reference's largest |logit|.  With ``--dtype
bfloat16`` both packages also run the same weights in float32, and each
package's bf16 forward is compared with its own float32 forward.  The
parity tests hold the 4-layer smoke config; this shows what depth does to
the same function (the mLSTM's normalizer divides by a sum that cancels,
and every layer compounds the rounding).

JAX's functions are compiled with ``xla_allow_excess_precision`` off, so
XLA rounds to bf16 where the JAX source casts (by default XLA's CPU
compiler drops a bf16 round trip inside a fusion); ``--jax-excess-precision``
keeps XLA's default.  Prints one JSON object per configuration:

    PYTHONPATH=src:tests python tests/torch_xlstm_depth.py [--dtype bfloat16]
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
from repro_torch.configs import get_smoke_config
from repro_torch.models import get_model
from repro_torch.models.convert import from_jax_params
from torch_bf16 import compiled_fn

CONFIGS = ((1024, 8), (256, 48), (512, 48))  # (d_model, n_layers), one sLSTM every 8
POSITIONS = 16


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def run(d_model: int, n_layers: int, dtype: str, excess_precision: bool, seed: int = 4):
    """(JAX forward, JAX decodes, port forward, port decodes), float32 numpy."""
    shape = dict(d_model=d_model, n_layers=n_layers, slstm_every=8, compute_dtype=dtype)
    jm = jax_get_model(dataclasses.replace(jax_get_smoke_config("xlstm-1.3b"), **shape))
    cfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"), **shape)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tm = get_model(cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, POSITIONS)).astype(np.int32)
    fwd = compiled_fn(lambda p, t: jm.forward(p, {"tokens": t})[0], excess_precision)
    jfwd = np.asarray(fwd(jp, jnp.asarray(toks)), np.float32)
    tfwd = tm.forward(tp, {"tokens": torch.from_numpy(toks)})[0].float().numpy()
    step = compiled_fn(lambda p, c, t, pos: jm.decode_step(p, c, t, pos), excess_precision)
    jc, tc, jdec, tdec = jm.init_cache(1, POSITIONS), tm.init_cache(1, POSITIONS), [], []
    for i in range(POSITIONS):
        lg, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        jdec.append(np.asarray(lg[:, 0], np.float32))
        lg, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]), i)
        tdec.append(lg[:, 0].float().numpy())
    return jfwd, np.stack(jdec, 1), tfwd, np.stack(tdec, 1)


def drift(d_model: int, n_layers: int, dtype: str = "float32",
          excess_precision: bool = False) -> dict:
    jfwd, jdec, tfwd, tdec = run(d_model, n_layers, dtype, excess_precision)
    out = {"d_model": d_model, "n_layers": n_layers, "dtype": dtype,
           "jax_excess_precision": excess_precision,
           "jax_decode_vs_forward": _rel(jdec, jfwd), "port_decode_vs_forward": _rel(tdec, tfwd),
           "port_vs_jax_forward": _rel(tfwd, jfwd), "port_vs_jax_decode": _rel(tdec, jdec)}
    if dtype != "float32":
        jf32, _, tf32, _ = run(d_model, n_layers, "float32", excess_precision)
        out.update(jax_forward_vs_its_f32=_rel(jfwd, jf32), port_forward_vs_its_f32=_rel(tfwd, tf32))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--jax-excess-precision", action="store_true",
                    help="compile JAX with XLA's default (bf16 round trips dropped in fusions)")
    args = ap.parse_args()
    torch.set_num_threads(4)
    for d_model, n_layers in CONFIGS:
        print(json.dumps(drift(d_model, n_layers, args.dtype, args.jax_excess_precision)),
              flush=True)
