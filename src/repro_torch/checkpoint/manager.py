"""Checkpointing: atomic, async, with retention: the port of
``repro.checkpoint.manager``, in JAX's layout and under JAX's leaf keys.

Layout (one directory per step):

    <root>/step_00000042/
        manifest.json         # leaf keys, shapes, dtypes, host count, extra
        host_0000.npz         # this host's leaves (flattened keys)
        COMMITTED             # written last; partial checkpoints are ignored

Writes go to ``step_X.tmp`` and are renamed after COMMITTED is placed, so
a crash mid-write never corrupts the restore path.  An async manager
hands the host arrays to a writer thread, so the train loop blocks only
on the device→host copy, not on disk.

A tree is a ``training.TrainState`` or a dict of tensors (nested dicts,
lists and tuples allowed).  A ``TrainState`` is flattened as JAX flattens
its own (``_flatten``): ``0/<param>`` for the parameters, ``1/m/<param>``,
``1/v/<param>`` and ``1/step`` for the optimizer, ``2`` for the step,
where ``<param>`` is JAX's key (``layers/wq``) and the port's per-layer
leaves are stacked to JAX's (L, …) shapes (``models.convert.layout``);
bf16 widens to float32 (npz has no bf16).  So a checkpoint written by
either package restores in the other.  ``restore`` copies the saved
values into the template's tensors in place (the port's parameters are a
module) and returns the template; JAX's returns a new tree.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.convert import Leaf, layout, read_leaf, write_leaf


def _walk(prefix: Tuple[str, ...], node) -> List[Leaf]:
    if isinstance(node, dict):
        return [leaf for k in sorted(node) for leaf in _walk(prefix + (str(k),), node[k])]
    if isinstance(node, (list, tuple)):
        return [leaf for i, v in enumerate(node) for leaf in _walk(prefix + (str(i),), v)]
    if isinstance(node, torch.Tensor):
        return [Leaf(prefix, [node], ())]
    raise TypeError(f"{'/'.join(prefix)}: cannot checkpoint a {type(node).__name__}")


def leaves(tree) -> List[Leaf]:
    """Every leaf of ``tree`` in JAX's flatten order, keyed as JAX's
    ``_flatten`` keys it (``Leaf.key``)."""
    from repro_torch.training.train_step import TrainState

    if not isinstance(tree, TrainState):
        return _walk((), tree)
    params = layout(tree.params)
    names = {id(p): n for n, p in tree.params.named_parameters()}
    out = [leaf._replace(path=("0",) + leaf.path) for leaf in params]
    opt = tree.opt_state
    for part in sorted(opt):
        if isinstance(opt[part], dict):  # m, v: one tensor per parameter
            out += [Leaf(("1", part) + leaf.path,
                         [opt[part][names[id(t)]] for t in leaf.tensors], leaf.lead)
                    for leaf in params]
        else:
            out += _walk(("1", part), opt[part])
    return out + _walk(("2",), tree.step)


def host_leaves(tree) -> List[Tuple[str, np.ndarray]]:
    """(key, host array) for every leaf of ``tree``: what ``save`` writes."""
    return [(leaf.key, read_leaf(leaf)) for leaf in leaves(tree)]


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, host_id: int = 0, n_hosts: int = 1,
                 async_write: bool = False):
        self.root = root
        self.keep = keep
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(root, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        flat = host_leaves(tree)  # device→host here
        if self.async_write:
            self.wait()
            self._thread = threading.Thread(target=self._write, args=(step, flat, extra),
                                            daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, extra)
        return self._dir(step)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def _write(self, step: int, flat, extra) -> None:
        final = self._dir(step)
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"host_{self.host_id:04d}.npz"), **dict(flat))
        if self.host_id == 0:
            manifest = {
                "step": step,
                "n_hosts": self.n_hosts,
                "leaves": [{"key": k, "shape": list(v.shape), "dtype": str(v.dtype)}
                           for k, v in flat],
                "extra": extra or {},
                "time": time.time(),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
        open(os.path.join(tmp, "COMMITTED"), "w").close()
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def list_steps(self) -> List[int]:
        out = []
        for d in sorted(os.listdir(self.root)):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, d, "COMMITTED")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def restore(self, template: Any, step: Optional[int] = None) -> Tuple[Any, dict]:
        """Load step ``step`` (the latest by default) into ``template``'s
        tensors in place; returns (template, the save's ``extra``)."""
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no committed checkpoints under {self.root}")
        step = step if step is not None else steps[-1]
        d = self._dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data: Dict[str, np.ndarray] = {}
        for fn in sorted(os.listdir(d)):
            if fn.startswith("host_") and fn.endswith(".npz"):
                with np.load(os.path.join(d, fn)) as z:
                    for k in z.files:
                        data[k] = z[k]
        todo = leaves(template)
        for leaf in todo:  # every leaf checked before any is written
            if leaf.key not in data:
                raise KeyError(f"checkpoint missing leaf {leaf.key}")
            if tuple(data[leaf.key].shape) != leaf.shape:
                raise ValueError(f"{leaf.key}: checkpoint shape {data[leaf.key].shape} != "
                                 f"{leaf.shape}")
        for leaf in todo:
            write_leaf(leaf, data[leaf.key])
        return template, manifest.get("extra", {})


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = CheckpointManager(root).list_steps()
    return steps[-1] if steps else None
