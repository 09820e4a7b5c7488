"""Device meshes: the local one of the single-controller fleet paths and
the production one of the dry run.

The port's counterpart of ``repro.launch.mesh``.  One
process drives every device of a ``LocalMesh``; callers read
``mesh.shape[axis]`` as they do on a JAX mesh.  ``ShardedFleet`` and
``fleet_scores_sharded`` place shard ``s`` on ``mesh.axis_devices(axis)[s]``
when the axis size equals their shard count, and combine the shards'
results on the first of those devices (an all-gather is a copy there and a
``torch.stack``; a psum a sum of the shards' tensors in shard order).
"""

from __future__ import annotations

import argparse
import contextlib
import math
from typing import Dict, List, Mapping, Sequence

import torch

from repro_torch.kernels._build import cuda_device


class LocalMesh:
    """``devices`` (a flat list, row-major over ``axes``) named by ``axes``
    (axis name → size, in order)."""

    def __init__(self, devices: Sequence, axes: Mapping[str, int]):
        self.shape: Dict[str, int] = {str(a): int(n) for a, n in axes.items()}
        if any(n < 1 for n in self.shape.values()):
            raise ValueError(f"mesh axes must be ≥ 1, got {self.shape}")
        # "cuda" without an index is the card current now
        self.devices: List[torch.device] = [
            cuda_device(d) if torch.device(d).type == "cuda" and torch.cuda.is_available()
            else torch.device(d) for d in devices]
        if len(self.devices) != math.prod(self.shape.values()):
            raise ValueError(f"{len(self.devices)} devices for a mesh of shape {self.shape}")

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, every other axis at index 0."""
        names = list(self.shape)
        k = names.index(axis)
        stride = math.prod(self.shape[a] for a in names[k + 1:])
        return [self.devices[i * stride] for i in range(self.shape[axis])]


def make_local_mesh(data: int = 1, model: int = 1, device="cuda") -> LocalMesh:
    """A (data, model) mesh over this process's devices: ``cuda`` takes
    ``cuda:0 … cuda:{data·model − 1}`` (raises if fewer are visible);
    ``cpu`` repeats the CPU, which the tests use to drive the multi-device
    branch on one host."""
    n = int(data) * int(model)
    kind = torch.device(device).type
    if kind == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"make_local_mesh(data={data}, model={model}) needs {n} "
                               f"CUDA devices, {have} visible; pass device='cpu' for the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif kind == "cpu":
        devices = [torch.device("cpu")] * n
    else:
        raise ValueError(f"unsupported device {device!r}")
    return LocalMesh(devices, {"data": data, "model": model})


def device_arg(text: str) -> torch.device:
    """The launchers' ``--device``: ``cpu``, ``cuda`` (the current card) or
    ``cuda:N`` (card N)."""
    try:
        dev = torch.device(text)
    except RuntimeError as e:
        raise argparse.ArgumentTypeError(str(e)) from None
    if dev.type not in ("cpu", "cuda") or (dev.type == "cpu" and dev.index is not None):
        raise argparse.ArgumentTypeError(f"expected cpu, cuda or cuda:N, got {text!r}")
    return dev


def on_device(device) -> contextlib.AbstractContextManager:
    """The context a launcher runs in: card N current for ``cuda:N``, so that
    whatever lands on the current card lands there; nothing otherwise.
    Raises for a card this process does not see."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is None:
        return contextlib.nullcontext()
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if dev.index >= have:
        raise RuntimeError(f"{dev} is not a visible CUDA device: this process sees {have}")
    return torch.cuda.device(dev.index)


def make_production_mesh(*, multi_pod: bool = False) -> LocalMesh:
    """JAX's production mesh: ``(data 16, model 16)``, or ``(pod 2, data 16,
    model 16)`` with ``multi_pod``, over ``torch.device("meta")``
    placeholders.

    These are the counterpart of the forced host devices JAX's dry run
    compiles against: the dry run (``launch.dryrun``) reads only the axes'
    names and sizes, traces on the meta device and runs nothing, so this is
    no fallback.  The shapes are JAX's TPU pods (256 and 512 chips), not an
    H100 cluster, and no time is derived from them."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    return LocalMesh([torch.device("meta")] * math.prod(shape.values()), shape)
