"""Operation counts of a step traced on the meta device: the counterpart of
``repro.launch.hlo_analysis``.

JAX's dry run compiles each cell and reads its figures from the optimized
HLO.  The port has no compiler to ask: it traces the cell's step once on
``torch.device("meta")`` (shapes and dtypes, no storage, nothing runs)
under a ``TorchDispatchMode`` that sees every aten operation, the
backward's included.  This is not an HLO parser; it fills the record's
``analysis`` with JAX's keys:

  * ``flops``: the matrix-product operations of the step, from
    ``torch.utils.flop_counter``'s formulas (mm, bmm, addmm, the einsums'
    products, …), the remat recompute and autograd's products included;
    elementwise work is not counted, as in JAX.  It is an operation count
    of the function, not of a kernel's work: on meta the flash attention
    is its plain version (``kernels/flash_attention/ref.py``), whose two
    einsums count the full S×T products, the causally masked pairs
    included, as ``hlo_analysis`` counts JAX's XLA attention.  The plain
    backward's recompute of the forward, which the function's gradient
    does not need, is counted apart under ``flops_aside``;
  * ``memory_bytes``: Σ (inputs + outputs) over every aten operation that
    is not a view (an upper bound on traffic: nothing is fused);
  * ``peak_live_bytes``: the largest sum of live storages the step
    allocates besides its arguments (the counterpart of XLA's
    ``temp_size_in_bytes``);
  * ``loop_multipliers``: each counted loop (``obs.opcount``: the
    microbatches, the sLSTM's steps over time) by name, with the trips it
    multiplies its body by, nested loops multiplied, as JAX's analyzer
    records a while body's multiplier;
  * ``collective_bytes`` (with ``collectives`` by kind): reckoned from the
    specs by ``distributed.sharding``'s scheme, not from a partitioner
    (``collective_traffic``).

Every figure of ``analyze`` is global, for the whole step;
``per_device`` divides them by the extents that split them
(``PER_DEVICE_RULE``, which says where that misses work).
"""

from __future__ import annotations

import math
import weakref
from typing import Any, Callable, Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.models.moe import moe_capacity
from repro_torch.obs import opcount

_aten = torch.ops.aten
# operations that allocate or alias without moving a byte
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
               _aten._unsafe_view.default}

PER_DEVICE_RULE = ("flops, memory_bytes, temp and output bytes: the global figure over "
                   "dp x tp, dp the data extent when it divides the batch (else 1), tp the "
                   "model extent; arguments: each tensor's bytes over the extents its spec "
                   "names; collectives: per device from the specs. Against JAX's partitioned "
                   "train step on a (data 2, model 4) mesh: equal for dense models, heads "
                   "dividing the model axis or not; low by the products of weights that "
                   "model does not split (the MoE router, 2-3%; the sLSTM's R and more, "
                   "23% for xlstm at the smoke widths)")


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the operations dispatched while it is open (see the module's
    docstring); ``arguments``' storages are not the step's temporaries."""

    def __init__(self, arguments: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.flops = self.flops_aside = self.memory_bytes = 0.0
        self.dispatches = 0
        self.loops: Dict[str, int] = {}
        self._args = {t.untyped_storage()._cdata for t in arguments}
        self._live: Dict[int, int] = {}
        self.live_bytes = self.peak_live_bytes = 0

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args or key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live_bytes += st.nbytes()
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.dispatches += 1
        trips, aside = opcount.current()
        name = opcount.path()
        if name:
            self.loops[name] = trips
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            flops = trips * count(*args, **kwargs, out_val=out)
            if aside:
                self.flops_aside += flops
            else:
                self.flops += flops
        outs = _tensors(out)
        if not (getattr(func, "is_view", False) or func in _NO_TRAFFIC):
            moved = sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
            self.memory_bytes += trips * moved
        for t in outs:
            if t.device.type == "meta" and t.layout == torch.strided:
                self._track(t)
        return out


def analyze(fn: Callable, *args, arguments: Iterable[torch.Tensor] = ()) -> Dict[str, Any]:
    """Trace ``fn(*args)`` (meta tensors) under an ``OpCounter``; returns
    (fn's output, the global figures).  ``arguments``: the tensors that are
    the step's inputs (the state, parameters, cache and batch), whose
    storages are not temporaries."""
    arguments = list(arguments)
    with OpCounter(arguments) as c:
        out = fn(*args)
    arg_keys = {t.untyped_storage()._cdata for t in arguments}
    seen = set()
    output_bytes = 0
    for t in _tensors(out):
        key = t.untyped_storage()._cdata
        if key not in arg_keys and key not in seen:
            seen.add(key)
            output_bytes += t.untyped_storage().nbytes()
    return out, {"flops": c.flops, "flops_aside": c.flops_aside, "memory_bytes": c.memory_bytes,
                 "peak_live_bytes": c.peak_live_bytes, "output_bytes": output_bytes,
                 "dispatches": c.dispatches, "loop_multipliers": dict(c.loops)}


def _axes(spec) -> set:
    out = set()
    for a in spec:
        if isinstance(a, tuple):
            out.update(a)
        elif a is not None:
            out.add(a)
    return out


def collective_traffic(cfg: ArchConfig, cell: ShapeCell, params: Dict[str, shd.Sharded], mesh,
                       multi_pod: bool, microbatches: int = 1) -> Dict[str, float]:
    """Per-device collective bytes of one step, by kind, from the specs
    (``distributed.sharding``'s scheme; result bytes per device, as
    ``hlo_analysis`` counts a collective):

      * all-gather: each data-sharded weight, gathered over ``data`` (still
        split over ``model``) in its stored dtype, once per forward — and
        again per remat recompute;
      * reduce-scatter: each data-sharded weight's float32 gradient shard,
        once per microbatch (train);
      * all-reduce over ``model``: each down/out projection's output
        (tokens on the device × its output width, in ``compute_dtype``)
        when its contracting dim is model-sharded, once per forward; the
        MoE's expert output is (E · capacity of the shard's tokens) rows;
      * all-reduce over ``pod`` (multi-pod, train): each gradient shard,
        float32, once a step.

    ``params``: {name: Sharded} of the step's parameters."""
    train, decode = cell.kind == "train", cell.kind == "decode"
    tp = mesh.shape["model"]
    dp_ext = shd.axis_extent(mesh, shd.dp_axes(multi_pod))
    B = cell.global_batch // microbatches
    b_local = B // dp_ext if B % dp_ext == 0 else B
    S = 1 if decode else cell.seq_len
    forwards = microbatches * (2 if train and cfg.remat != "none" else 1)
    act = {"float32": 4, "bfloat16": 2}[cfg.compute_dtype]
    out = {"all-gather": 0.0, "reduce-scatter": 0.0, "all-reduce": 0.0}
    pod = 0.0
    for name, sh in params.items():
        axes = _axes(sh.spec)
        if decode and name.startswith("enc."):
            continue  # decode runs no encoder
        if "data" in axes:
            gathered = math.prod(shd.local_shape(tuple(sh.tensor.shape),
                                                 shd.P(*[None if a == "data" else a
                                                         for a in sh.spec]), mesh))
            out["all-gather"] += forwards * gathered * sh.tensor.element_size()
            if train:
                out["reduce-scatter"] += microbatches * math.prod(sh.local_shape) * 4
        if train and multi_pod:
            pod += math.prod(sh.local_shape) * 4
        leaf = name.rsplit(".", 1)[-1]
        if leaf in shd._DOWN_NAMES and len(sh.spec) >= 2 and sh.spec[-2] == "model":
            width = sh.tensor.shape[-1]
            rows = b_local * S
            if sh.tensor.dim() == 3 and cfg.moe_experts:  # (E, F, d): the packed experts
                rows = cfg.moe_experts * moe_capacity(cfg, rows)
            out["all-reduce"] += forwards * rows * width * act
    if multi_pod:
        out["all-reduce"] += pod
    return out


def per_device(analysis: Dict[str, Any], cell: ShapeCell, mesh, multi_pod: bool) -> Dict[str, Any]:
    """The figures of ``analyze`` per device (``PER_DEVICE_RULE``)."""
    dp_ext = shd.axis_extent(mesh, shd.dp_axes(multi_pod))
    split = (dp_ext if cell.global_batch % dp_ext == 0 else 1) * mesh.shape["model"]
    out = dict(analysis)
    for k in ("flops", "flops_aside", "memory_bytes", "peak_live_bytes", "output_bytes"):
        out[k] = analysis[k] / split
    out["split"] = split
    return out
