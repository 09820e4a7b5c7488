"""Dry run: trace every (arch × shape × mesh) cell on the meta device, the
port of ``repro.launch.dryrun``.

For every cell the dry run

  1. builds the production mesh (16×16 or 2×16×16, ``torch.device("meta")``
     placeholders: ``launch.mesh.make_production_mesh``),
  2. builds every input on the meta device with its spec (``launch.specs``),
  3. traces the cell's step under ``launch.op_analysis`` (the train step
     with ``TRAIN_MICROBATCHES``, ``prefill``, or one ``decode_step`` at the
     cache's last position), each model under the cell's ``ParallelCtx``,
  4. records the per-device figures (FLOPs, bytes, collective traffic,
     the arguments' and the temporaries' bytes) and the loop multipliers,
  5. writes the record to ``<out>/<arch>__<shape>__<mesh>.json``.

Where JAX lowers and compiles (``lower_s``, ``compile_s``,
``memory_analysis`` and ``hlo_analysis`` from XLA), the port traces
(``trace_s``; ``memory_analysis`` from the specs and the traced live set;
``analysis`` from ``op_analysis``).  Failures are recorded, not
swallowed, as JAX records them; the CLI exits 1 if any cell failed.
Nothing runs on a card: the trace reaches the flash attention's plain
version (meta tensors), and no kernel launches.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

from repro_torch.configs import ALL_SHAPES, ARCH_IDS, get_config
from repro_torch.configs.base import ShapeCell, shape_applicable
from repro_torch.distributed import sharding as shd
from repro_torch.launch import op_analysis, specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import get_model, param_counts
from repro_torch.training.optim import AdamWConfig
from repro_torch.training.train_step import make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "dryrun_torch")

TRAIN_MICROBATCHES = 4  # gradient accumulation: bounds the live activation
                        # set (incl. the vocab-sharded logits block) per micro


def build_step(arch, cell: ShapeCell, ctx, microbatches: int = TRAIN_MICROBATCHES):
    """The cell's step on the meta device under ``ctx`` (``arch``: an id or
    an ``ArchConfig``)."""
    cfg = S.config(arch)
    if cell.kind == "train":
        return make_train_step(get_model(cfg, S.META, train=True), AdamWConfig(), ctx=ctx,
                               microbatches=microbatches)
    model = get_model(cfg, S.META)
    if cell.kind == "prefill":
        return lambda params, batch: model.prefill(params, batch, cache_len=cell.seq_len, ctx=ctx)
    if cell.kind == "decode":
        return lambda params, cache, tokens, pos: model.decode_step(params, cache, tokens, pos,
                                                                    ctx=ctx)
    raise ValueError(cell.kind)


def trace_cell(arch, cell: ShapeCell, mesh, multi_pod: bool,
               microbatches: int = TRAIN_MICROBATCHES) -> Dict[str, Any]:
    """Trace one cell's step on ``mesh`` (``arch``: an id or an
    ``ArchConfig``); returns the record's ``trace_s``, ``memory_analysis``
    (per device; ``temp_size_in_bytes`` is the peak live set beside the
    arguments less the outputs, which XLA counts apart), ``analysis`` (per
    device) and ``analysis_global``."""
    cfg = S.config(arch)
    t0 = time.time()
    ctx = S.make_ctx(mesh, multi_pod)
    mb = microbatches if cell.kind == "train" else 1
    step = build_step(arch, cell, ctx, mb)
    ins = S.input_specs(arch, cell, mesh, multi_pod)
    batch = {k: v.tensor for k, v in ins.get("batch", {}).items()}
    if cell.kind == "train":
        state, sspecs = ins["state"]
        args_sh = S.state_leaves(state, sspecs, mesh) + list(ins["batch"].values())
        params = dict(zip(sspecs.params, S.param_leaves(state.params, sspecs.params, mesh)))
        call = (step, state, batch)
    elif cell.kind == "prefill":
        module, pspecs = ins["params"]
        params = dict(zip(pspecs, S.param_leaves(module, pspecs, mesh)))
        args_sh = list(params.values()) + list(ins["batch"].values())
        call = (step, module, batch)
    else:
        module, pspecs = ins["params"]
        params = dict(zip(pspecs, S.param_leaves(module, pspecs, mesh)))
        cache, cspecs = ins["cache"]
        pos, _ = ins["pos"]
        args_sh = (list(params.values()) + list(shd.leaves(shd.with_sharding(cache, cspecs, mesh)))
                   + [ins["tokens"]])
        call = (step, module, cache, ins["tokens"].tensor, pos)
    _, glob = op_analysis.analyze(*call, arguments=[s.tensor for s in args_sh])
    trace_s = time.time() - t0
    coll = op_analysis.collective_traffic(cfg, cell, params, mesh, multi_pod, mb)
    per = op_analysis.per_device(glob, cell, mesh, multi_pod)
    per.update(collectives=coll, collective_bytes=sum(coll.values()))
    memory = {"argument_size_in_bytes": sum(s.local_bytes for s in args_sh),
              "temp_size_in_bytes": int(max(per["peak_live_bytes"] - per["output_bytes"], 0)),
              "output_size_in_bytes": int(per["output_bytes"])}
    return {"trace_s": round(trace_s, 2), "microbatches": mb, "memory_analysis": memory,
            "analysis": per, "analysis_global": glob,
            "per_device_rule": op_analysis.PER_DEVICE_RULE}


def run_cell(arch: str, cell: ShapeCell, multi_pod: bool, out_dir: str,
             skip_existing: bool = False) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    cell_id = f"{arch}__{cell.name}__{mesh_name}"
    path = os.path.join(out_dir, cell_id + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    rec = {
        "arch": arch, "shape": cell.name, "mesh": mesh_name,
        "kind": cell.kind, "seq_len": cell.seq_len,
        "global_batch": cell.global_batch,
        "chips": 512 if multi_pod else 256,
        "params": param_counts(cfg),
        "status": "pending",
    }
    ok, reason = shape_applicable(cfg, cell)
    if not ok:
        rec["status"] = "skipped"
        rec["skip_reason"] = reason
        _write(path, rec)
        return rec
    t0 = time.time()
    try:
        rec.update(trace_cell(arch, cell, make_production_mesh(multi_pod=multi_pod), multi_pod))
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record and continue
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    _write(path, rec)
    return rec


def _write(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape cell name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=os.path.abspath(OUT_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else (args.arch,)
    shapes = ALL_SHAPES if args.shape == "all" else tuple(
        s for s in ALL_SHAPES if s.name == args.shape
    )
    meshes = {"single": (False,), "multi": (True,), "both": (False, True)}[args.mesh]

    n_ok = n_skip = n_err = 0
    t0 = time.time()
    for arch in archs:
        for cell in shapes:
            for mp in meshes:
                rec = run_cell(arch, cell, mp, args.out, args.skip_existing)
                tag = rec["status"]
                n_ok += tag == "ok"
                n_skip += tag == "skipped"
                n_err += tag == "error"
                msg = f"[{tag:7s}] {arch} × {cell.name} × {rec['mesh']}"
                if tag == "ok":
                    a = rec["analysis"]
                    msg += (f"  flops={a['flops']:.3e} coll={a['collective_bytes']:.3e}B"
                            f" trace={rec['trace_s']}s")
                elif tag == "error":
                    msg += "  " + rec["error"][:120]
                print(msg, flush=True)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_err} errors in {time.time() - t0:.1f} s")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
