"""The float32 cross-entropy over the vocabulary, forward and backward, one
launch each."""

from repro_torch.kernels.cross_entropy.ops import (
    CrossEntropy,
    cross_entropy_bwd,
    cross_entropy_fwd,
)
from repro_torch.kernels.cross_entropy.ref import cross_entropy_bwd_ref, cross_entropy_ref

__all__ = ["CrossEntropy", "cross_entropy_bwd", "cross_entropy_bwd_ref", "cross_entropy_fwd",
           "cross_entropy_ref"]
