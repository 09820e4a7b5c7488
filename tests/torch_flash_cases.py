"""flash_attention's causal and non-causal modes on fixed inputs, as byte digests.

``DIGESTS`` holds what the kernel gave for each case before its window and
``key_pos`` masks were added (both routes, with and without key splits, a
strided cache slice and an unaligned view); ``tests/test_torch_cuda.py``
holds the current kernel to them byte for byte.  ``flash_digests`` only
calls ``flash_attention(q, k, v, causal)``, so it runs on any version of
the package:

    PYTHONPATH=<checkout>/src:tests python -c \\
        "from torch_flash_cases import flash_digests; print(flash_digests())"

It imports only torch and repro_torch's flash wrapper.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import torch

# label -> (B, S, T, H, K, hd, causal, dtype)
CASES = {
    "causal_prefill_gqa": (2, 300, 300, 8, 2, 32, True, "bfloat16"),
    "causal_prefill_hd256": (1, 256, 256, 8, 1, 256, True, "bfloat16"),
    "causal_fewer_queries": (2, 40, 72, 4, 2, 96, True, "bfloat16"),
    "causal_key_split": (1, 1024, 1024, 2, 2, 64, True, "bfloat16"),
    "decode_split": (8, 1, 249, 8, 1, 256, False, "bfloat16"),
    "decode_long": (2, 1, 4097, 16, 1, 256, False, "bfloat16"),
    "noncausal_encoder": (2, 128, 128, 16, 16, 64, False, "bfloat16"),
    "f32_causal": (2, 128, 128, 4, 4, 64, True, "float32"),
    "f32_decode_split": (8, 1, 249, 8, 1, 256, False, "float32"),
    "f32_causal_hd16": (1, 64, 64, 2, 2, 16, True, "float32"),
}


# what the kernel gave before its window and key_pos masks were added, on
# an NVIDIA H100 80GB HBM3 with torch 2.11.0+cu128 (the inputs are drawn on
# the card from the seeds in flash_digests)
DIGESTS = {
    "causal_prefill_gqa": "2c48ef4c12038f04",
    "causal_prefill_hd256": "892d97034e2f2773",
    "causal_fewer_queries": "49650126aa178dc9",
    "causal_key_split": "e8fb7b486fe8c4c4",
    "decode_split": "1ace0c824c766bdd",
    "decode_long": "feb531a3d6459910",
    "noncausal_encoder": "f0418a1d0626bb3c",
    "f32_causal": "fb6df84370e91dee",
    "f32_decode_split": "9ad3dee7d99cae28",
    "f32_causal_hd16": "5a942a1ae26e23a2",
    "cache_slice_bfloat16": "f8e596f24589d1ed",
    "unaligned_bfloat16": "76f65399be8c4bc0",
    "cache_slice_float32": "22e1a5ec9f779c17",
    "unaligned_float32": "b3633d2e6c80b5e3",
}


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def flash_digests(device: str = "cuda") -> Dict[str, str]:
    """label -> the first 16 hex digits of sha256 over the output's bytes."""
    from repro_torch.kernels.flash_attention import flash_attention

    out = {}
    for i, (label, (B, S, T, H, K, hd, causal, dt)) in enumerate(CASES.items()):
        g = torch.Generator(device=device).manual_seed(1000 + i)
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(shape, generator=g, device=device).to(dtype)
                   for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hd)))
        out[label] = _digest(flash_attention(q, k, v, causal))
    # a strided cache slice and an unaligned view (scalar loads)
    g = torch.Generator(device=device).manual_seed(7)
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        cache = torch.randn(2, 4, 300, 1, 128, generator=g, device=device).to(dtype)
        q = torch.randn(4, 1, 8, 128, generator=g, device=device).to(dtype)
        out[f"cache_slice_{dt}"] = _digest(flash_attention(q, cache[0, :, :211], cache[1, :, :211],
                                                           False))
        wide = torch.randn(2, 50, 2, 65, generator=g, device=device).to(dtype)
        qq = torch.randn(2, 50, 4, 64, generator=g, device=device).to(dtype)
        out[f"unaligned_{dt}"] = _digest(flash_attention(qq, wide[..., 1:], wide[..., 1:], True))
    return out
