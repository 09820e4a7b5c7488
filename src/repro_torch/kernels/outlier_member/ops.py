"""Fused η ∨ outlier-index membership over a sorted digest table.

``pin_table`` builds a pin's table from its key arena in one launch
(``svc_outlier_pin_table``: the valid slots' digests and one all-SENTINEL
tuple's, sorted by the last block) and one host wait that reads its
length; a table past ``MAX_SMEM_KEYS`` entries is then composed as before
(the compacted keys through ``digest_table``).  ``digest_table`` builds
the table of K key tuples (as the JAX package's ``_sorted_digests``): one
block digests and sorts them when K ≤ ``MAX_SMEM_KEYS``
(``svc_outlier_digest_sorted``), else one launch digests them
(``svc_outlier_digest``) and a torch sort orders them.  ``table_route``
names digest_table's route before its launch, ``pin_launches`` pin_table's
launches from its table's length; each wrapper's ``routes`` counts its
launches by route.  ``core.outliers.PinSet`` owns the table of a view's
pin, so the pinned hash builds none per call.
``pinned_hash`` is the pinned clean's one launch: η ∨ membership narrowed
to the relation's validity, and the ``__outlier`` flag.  ``outlier_codes``
(int32 codes, bit0 keep, bit1 member) and the membership-only
``outlier_member`` build the table from key columns first.  CPU tensors
take the plain versions (``ref.py``); CUDA tensors launch
``csrc/outlier_member.cu`` or raise.  Every call dispatches through
``obs.kprof.profiled``: the digest tables as ``"outlier_digest"`` (the
JAX package builds its table in XLA, unprofiled), the probes as
``"outlier_member"``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hashing import DIGEST_SEED_HI, DIGEST_SEED_LO, seed_mix
from repro_torch.kernels import _build as B
from repro_torch.kernels.outlier_member.ref import (
    compact_pin_keys,
    outlier_codes_ref,
    pin_table_ref,
    pinned_hash_ref,
    sorted_digest_table,
)
from repro_torch.obs.kprof import profiled

MAX_COLS = 4
# Tables up to this many keys (16 KiB of digests) are staged in shared
# memory by the kernel; larger ones are searched in device memory.
MAX_SMEM_KEYS = 2048
_DIGEST_ARGS = (B.P, B.P, B.P, B.P, B.I32, B.I64, B.U32, B.U32, B.P, B.P)
_PIN_ARGS = (B.P, B.P, B.P, B.P, B.I32, B.P, B.I64, B.U32, B.U32, B.P, B.P, B.P, B.I32, B.P)
_CODES_ARGS = (B.P, B.P, B.P, B.P, B.I32, B.I64, B.P, B.I64, B.U32, B.U32, B.U32, B.F32,
               B.P, B.P)
_PINNED_ARGS = (B.P, B.P, B.P, B.P, B.I32, B.P, B.I64, B.P, B.I64, B.U32, B.U32, B.U32, B.F32,
                B.P, B.P, B.P)


def _check_cols(cols, what: str) -> Tuple[torch.device, int]:
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"need 1..{MAX_COLS} {what} columns, got {len(cols)}")
    dev = cols[0].device
    n = cols[0].shape[0]
    for i, c in enumerate(cols):
        B.check(c, f"{what}[{i}]", torch.int32, dev, (n,))
    return dev, n


def _col_ptrs(cols):
    return [c.data_ptr() for c in cols] + [None] * (MAX_COLS - len(cols))


def _check_table(table: torch.Tensor, dev: torch.device) -> int:
    if table.dim() != 1:
        raise ValueError("the digest table is one-dimensional")
    B.check(table, "table", torch.int64, dev)
    return table.shape[0]


def table_route(entries: int) -> str:
    """digest_table's route for ``entries`` key tuples: ``"block"`` (one
    launch digests and sorts them in one block's shared memory) up to
    MAX_SMEM_KEYS, else ``"sort"`` (one launch digests them, a torch sort
    orders them)."""
    return "block" if entries <= MAX_SMEM_KEYS else "sort"


def pin_launches(length: int) -> int:
    """pin_table's launches of the digest kernels for a table of
    ``length`` entries: the one over the arena, and past MAX_SMEM_KEYS
    the composed table's digest launch (on digest_table's sort route)."""
    return 1 if length <= MAX_SMEM_KEYS else 2


def digest_table(key_cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Packed (hi, lo) digests of the K key tuples, sorted ascending: (K,) int64."""
    key_cols = tuple(key_cols)
    dev, K = _check_cols(key_cols, "key_cols")
    if dev.type == "cpu":
        return profiled("outlier_digest", sorted_digest_table, key_cols, fallback=True, rows=K,
                        padded=K)
    B.check_cuda(dev)
    return profiled("outlier_digest", _launch_digest, key_cols, rows=K, padded=K)


def _launch_digest(key_cols, counter=digest_table) -> torch.Tensor:
    K = key_cols[0].shape[0]
    dev = key_cols[0].device
    out = torch.empty(K, dtype=torch.int64, device=dev)
    if not K:
        return out
    card = dev.index
    route = table_route(K)
    entry = "svc_outlier_digest_sorted" if route == "block" else "svc_outlier_digest"
    B.launch_on(card, entry, _DIGEST_ARGS, *_col_ptrs(key_cols), len(key_cols), K,
                seed_mix(DIGEST_SEED_HI), seed_mix(DIGEST_SEED_LO), out.data_ptr())
    counter.launches += 1
    counter.routes[route] += 1
    return out if route == "block" else torch.sort(out).values


digest_table.launches = 0
digest_table.routes = {"block": 0, "sort": 0}

_pin_workspace: dict = {}


def _pin_ws(card: int, stream: int):
    """(workspace, mapped length word) of a card and stream: the kernel's
    two uint64 and two uint32 counters, zeroed once (every launch leaves
    them at 0), and the host word its last block writes the length to."""
    key = (card, stream)
    ws = _pin_workspace.get(key)
    if ws is None:
        ws = _pin_workspace[key] = (
            torch.zeros(3, dtype=torch.int64, device=torch.device("cuda", card)),
            B.mapped(("outlier_pin_table", "length", card, stream), 8, card))
    return ws


def pin_table(keys: Sequence[torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
    """A pin's sorted digest table, from its key arena: the packed digests
    of its valid slots' key tuples and, when any slot is invalid, of one
    all-SENTINEL tuple, sorted ascending (``ref.pin_table_ref``).

    keys: the arena's 1 to 4 int32 key columns; valid: the slots'
    validity.  On a card: one launch over the arena and one host wait,
    which reads the table's length; a table longer than MAX_SMEM_KEYS is
    then composed as before (``compact_pin_keys`` through
    ``digest_table``'s sort route)."""
    keys = tuple(keys)
    dev, n = _check_cols(keys, "keys")
    B.check(valid, "valid", torch.bool, dev, (n,))
    if dev.type == "cpu":
        return profiled("outlier_digest", pin_table_ref, keys, valid, fallback=True, rows=n,
                        padded=n)
    B.check_cuda(dev)
    return profiled("outlier_digest", _launch_pin, keys, valid, rows=n, padded=n)


def _launch_pin(keys, valid) -> torch.Tensor:
    n = keys[0].shape[0]
    dev = keys[0].device
    if not n:
        return torch.empty(0, dtype=torch.int64, device=dev)
    card = dev.index
    ws, length = _pin_ws(card, B.stream(card))
    table = torch.empty(MAX_SMEM_KEYS, dtype=torch.int64, device=dev)
    B.launch_on(card, "svc_outlier_pin_table", _PIN_ARGS, *_col_ptrs(keys), len(keys),
                valid.data_ptr(), n, seed_mix(DIGEST_SEED_HI), seed_mix(DIGEST_SEED_LO),
                table.data_ptr(), ws.data_ptr(), length.device, B.sm_count(card))
    pin_table.launches += 1
    pin_table.routes["arena"] += 1
    B.wait(card)
    k = int(length.host.view(np.int64)[0])
    if k <= MAX_SMEM_KEYS:
        return table[:k]
    return _launch_digest(compact_pin_keys(keys, valid), pin_table)  # routes["sort"]


pin_table.launches = 0
pin_table.routes = {"arena": 0, "sort": 0}


def pinned_hash(
    cols: Sequence[torch.Tensor], valid: torch.Tensor, m: float, seed: int, table: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pinned hash of a relation in one pass: (valid ∧ (η ∨ member) bool,
    member ∧ valid as the int8 ``__outlier`` flag).

    cols: its 1-D int32 key columns; valid: its validity; table: the pin's
    ``digest_table``.  A row whose first key is SENTINEL_KEY is never a
    member."""
    cols = tuple(cols)
    dev, R = _check_cols(cols, "cols")
    B.check(valid, "valid", torch.bool, dev, (R,))
    _check_table(table, dev)
    if dev.type == "cpu":
        return profiled("outlier_member", pinned_hash_ref, cols, valid, m, seed, table,
                        fallback=True, rows=R, padded=R)
    B.check_cuda(dev)
    return profiled("outlier_member", _launch_pinned, cols, valid, m, seed, table, rows=R,
                    padded=R)


def _launch_pinned(cols, valid, m, seed, table):
    dev = valid.device
    R = valid.shape[0]
    out_valid = torch.empty(R, dtype=torch.bool, device=dev)
    out_flag = torch.empty(R, dtype=torch.int8, device=dev)
    card = dev.index
    B.launch_on(card, "svc_outlier_pinned", _PINNED_ARGS, *_col_ptrs(cols), len(cols),
                valid.data_ptr(), R, table.data_ptr(), table.shape[0], seed_mix(seed),
                seed_mix(DIGEST_SEED_HI), seed_mix(DIGEST_SEED_LO), float(np.float32(m)),
                out_valid.data_ptr(), out_flag.data_ptr())
    pinned_hash.launches += 1
    return out_valid, out_flag


pinned_hash.launches = 0


def outlier_codes(
    cols: Sequence[torch.Tensor], key_cols: Sequence[torch.Tensor], m: float, seed: int
) -> torch.Tensor:
    """Per probe row: bit0 = hash(cols) < f32(m) ∨ member, bit1 = member.

    cols: 1-D int32 composite key columns of the probe rows (SENTINEL_KEY
    marks invalid rows); key_cols: the index key columns, same arity.
    """
    cols, key_cols = tuple(cols), tuple(key_cols)
    if len(key_cols) != len(cols):
        raise ValueError("need as many key columns as probe columns")
    dev, R = _check_cols(cols, "cols")
    _check_cols(key_cols, "key_cols")
    if key_cols[0].device != dev:
        raise ValueError(f"key_cols: on {key_cols[0].device}, expected {dev}")
    if dev.type == "cpu":
        return profiled("outlier_member", outlier_codes_ref, cols, key_cols, m, seed,
                        fallback=True, rows=R, padded=R)
    B.check_cuda(dev)
    table = digest_table(key_cols)  # its own dispatch, outside the probe's
    return profiled("outlier_member", _launch_codes, cols, table, m, seed, rows=R, padded=R)


def _launch_codes(cols, table, m, seed):
    R = cols[0].shape[0]
    dev = cols[0].device
    out = torch.empty(R, dtype=torch.int32, device=dev)
    card = dev.index
    B.launch_on(card, "svc_outlier_member", _CODES_ARGS, *_col_ptrs(cols), len(cols), R,
                table.data_ptr(), table.shape[0], seed_mix(seed), seed_mix(DIGEST_SEED_HI),
                seed_mix(DIGEST_SEED_LO), float(np.float32(m)), out.data_ptr())
    outlier_codes.launches += 1
    return out


outlier_codes.launches = 0


def fused_hash_member(
    cols: Sequence[torch.Tensor], m: float, seed: int, key_cols: Sequence[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(η ∨ membership, membership) bool masks in one fused pass."""
    code = outlier_codes(cols, key_cols, m, seed)
    return (code & 1) > 0, (code & 2) > 0


def outlier_member(probe_cols: Sequence[torch.Tensor], key_cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Membership-only probe: probe tuple ∈ key tuples (digest identity)."""
    return (outlier_codes(probe_cols, key_cols, 0.0, 0) & 2) > 0
