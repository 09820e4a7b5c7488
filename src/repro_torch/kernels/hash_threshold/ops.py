"""η_{a,m} keep-mask over 1-D (composite) int32 key columns.

CPU tensors take the plain version (``ref.py``); CUDA tensors launch
``csrc/hash_threshold.cu`` or raise.  With ``valid`` (the relation's bool
validity) the same launch writes ``valid & keep``: ``core.hashing.
apply_hash`` narrows a validity in one pass.  The wrapper takes the
kernel's vector route when every key column is 16-byte aligned and the
validity 4-byte aligned, else its scalar route (a column viewed at a
storage offset); ``hash_threshold.routes`` counts the launches of each.
Every call dispatches through ``obs.kprof.profiled`` as ``"hash_threshold"``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.hashing import seed_mix
from repro_torch.kernels import _build as B
from repro_torch.kernels.hash_threshold.ref import hash_threshold_ref
from repro_torch.obs.kprof import profiled

MAX_COLS = 4
_ARGS = (B.P, B.P, B.P, B.P, B.I32, B.I64, B.U32, B.F32, B.P, B.P, B.I32, B.P)


def hash_threshold(cols: Sequence[torch.Tensor], m: float, seed: int = 0,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bool keep-mask: True where u(hash(cols)) < float32(m); given
    ``valid`` (bool, one per row), ``valid & keep``."""
    cols = tuple(cols)
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"hash_threshold takes 1..{MAX_COLS} key columns, got {len(cols)}")
    dev = cols[0].device
    n = cols[0].shape[0]
    for i, c in enumerate(cols):
        B.check(c, f"cols[{i}]", torch.int32, dev, (n,))
    if valid is not None:
        B.check(valid, "valid", torch.bool, dev, (n,))
    if dev.type == "cpu":
        return profiled("hash_threshold", _plain, cols, m, seed, valid, fallback=True, rows=n,
                        padded=n)
    B.check_cuda(dev)
    return profiled("hash_threshold", _launch, cols, m, seed, valid, n, dev, rows=n, padded=n)


def _plain(cols, m, seed, valid):
    keep = hash_threshold_ref(cols, m, seed)
    return keep if valid is None else valid & keep


def _launch(cols, m, seed, valid, n, dev):
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    ptrs = [c.data_ptr() for c in cols]
    vptr = B.ptr(valid)
    vec = all(p % 16 == 0 for p in ptrs) and (vptr or 0) % 4 == 0
    # ctypes rounds m to the nearest float32, as np.float32(m) does
    card = dev.index
    B.launch_on(card, "svc_hash_threshold", _ARGS, *ptrs, *(None,) * (MAX_COLS - len(cols)),
                len(cols), n, seed_mix(seed), float(m), vptr, out.data_ptr(), vec)
    hash_threshold.launches += 1
    hash_threshold.routes["vector" if vec else "scalar"] += 1
    return out


hash_threshold.launches = 0
hash_threshold.routes = {"vector": 0, "scalar": 0}
