"""What ``test_bf16_train_step_matches_jax``'s limits separate: the step's
readings for the port and for controls that move one cast.

On the CPU, gemma-2b's smoke config in bf16, one train step of the port
against JAX's (``tests/test_torch_training.py``'s helpers, JAX compiled as
the test compiles it).  Each control is a copy of ``src/`` under
``build/bf16_casts/<name>/`` with one cast moved, run in its own process;
``f32_step`` is the unchanged port stepping in float32.  Readings, each the
largest over the leaves where there are leaves: the gradient's
|port − JAX| over its norm (``grad_normwise``) and over its largest
|value| (``grad_max_abs``), the loss's and the grad norm's relative
difference, and each parameter's distance after the step over its
update's norm.  ``--jax-attention-as-is`` keeps JAX's own attention
(scores and probabilities rounded to bf16) instead of
``torch_bf16.jax_attention_as_port``.  Prints one JSON object per control
and seed:

    PYTHONPATH=src:tests python tests/torch_bf16_casts.py [--seeds 5 1 2 3]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> (file under src/, [(text, replacement)]): one cast moved
CONTROLS = {
    "rmsnorm_bf16": ("repro_torch/models/layers.py", [(
        "    xf = x.float()\n    var = (xf * xf).mean(dim=-1, keepdim=True)\n"
        "    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)",
        "    xf = x\n    var = (xf * xf).mean(dim=-1, keepdim=True)\n"
        "    return (xf * torch.rsqrt(var + eps) * w.to(x.dtype)).to(x.dtype)")]),
    "rope_bf16": ("repro_torch/models/layers.py", [(
        "    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, hd/2)\n"
        "    sin = torch.sin(ang)[..., None, :]\n    x1, x2 = x.float().chunk(2, dim=-1)\n"
        "    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)\n\n\n",
        "    cos = torch.cos(ang).to(x.dtype)[..., None, :]  # (..., S, 1, hd/2)\n"
        "    sin = torch.sin(ang).to(x.dtype)[..., None, :]\n    x1, x2 = x.chunk(2, dim=-1)\n"
        "    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)\n\n\n")]),
    "glu_f32": ("repro_torch/models/layers.py", [(
        "        h = gelu(g) * u\n", "        h = (gelu(g.float()) * u.float()).to(g.dtype)\n")]),
    "head_f32": ("repro_torch/models/transformer.py", [(
        "        return x @ head.to(x.dtype)\n", "        return x.float() @ head.float()\n")]),
    "ce_bf16": ("repro_torch/training/train_step.py", [(
        "    lf = logits.float()\n", "    lf = logits\n")]),
}


def readings(port_dtype: str, seed: int, attention_as_port: bool) -> dict:
    import dataclasses

    import numpy as np
    import torch
    from _pytest.monkeypatch import MonkeyPatch

    import test_torch_training as T
    from torch_bf16 import compiled_fn, jax_activations_in_f32, jax_attention_as_port

    torch.set_num_threads(1)
    arch = "gemma-2b"
    cfg = dataclasses.replace(T.get_smoke_config(arch), compute_dtype=port_dtype)
    jcfg = dataclasses.replace(T.jax_smoke(arch), compute_dtype="bfloat16")
    batch = T._batch(cfg, seed=seed)
    opt = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    attention = jax_attention_as_port if attention_as_port else contextlib.nullcontext
    mp = MonkeyPatch()
    try:
        with jax_activations_in_f32(), attention():
            jstate, jnew, jmet = T._jax_step(jcfg, batch, opt, monkeypatch=mp,
                                             compile_fn=compiled_fn)
    finally:
        mp.undo()
    tstate = T._port_state(jstate, cfg)
    p0 = T.to_jax_params(tstate.params)
    step = T.make_train_step(T.get_model(cfg, device="cpu", train=True), T.AdamWConfig(**opt))
    try:
        tstate, tmet = step(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    except RuntimeError as e:
        return {"raises": str(e).splitlines()[0]}
    grads = list(T._pairs(T._port_grads(tstate.params), jmet["grads"]))
    start = {k: v for k, _g, v in T._pairs(p0, p0)}
    return {
        "grad_normwise": max(float(np.linalg.norm(g - w) / np.linalg.norm(w)) for _k, g, w in grads),
        "grad_max_abs": max(float(np.abs(g - w).max() / np.abs(w).max()) for _k, g, w in grads),
        "loss": T._rel(tmet["loss"], jmet["loss"]),
        "grad_norm": T._rel(tmet["grad_norm"], jmet["grad_norm"]),
        "params": max(float(np.linalg.norm(g - w) / np.linalg.norm(w - start[k]))
                      for k, g, w in T._pairs(T.to_jax_params(tstate.params), jnew.params)),
    }


def copy_with(name: str) -> Path:
    """``src/`` copied under build/bf16_casts/<name>/ with the control's cast moved."""
    dst = ROOT / "build" / "bf16_casts" / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst / "src", ignore=shutil.ignore_patterns("__pycache__"))
    rel, edits = CONTROLS[name]
    path = dst / "src" / rel
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to change is not in {rel} once")
        text = text.replace(old, new)
    path.write_text(text)
    return dst / "src"


def run(name: str, src: Path, seed: int, as_is: bool) -> dict:
    cmd = [sys.executable, __file__, "--child", "--seeds", str(seed),
           "--dtype", "float32" if name == "f32_step" else "bfloat16"]
    if as_is:
        cmd.append("--jax-attention-as-is")
    env = dict(os.environ, PYTHONPATH=f"{src}{os.pathsep}{ROOT / 'tests'}", JAX_PLATFORMS="cpu")
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, check=True)
    return {"control": name, "seed": seed, **json.loads(out.stdout.splitlines()[-1])}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[5])
    ap.add_argument("--jax-attention-as-is", action="store_true")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(readings(args.dtype, args.seeds[0], not args.jax_attention_as_is)))
        return
    srcs = {"sound": ROOT / "src", "f32_step": ROOT / "src",
            **{name: copy_with(name) for name in CONTROLS}}  # each copy made once, up front
    jobs = [(n, s) for s in args.seeds for n in srcs]
    with ThreadPoolExecutor(args.workers) as pool:
        for row in pool.map(lambda j: run(j[0], srcs[j[0]], j[1], args.jax_attention_as_is), jobs):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
