from repro_torch.kernels.hash_threshold.ops import hash_threshold
from repro_torch.kernels.hash_threshold.ref import hash_threshold_ref

__all__ = ["hash_threshold", "hash_threshold_ref"]
