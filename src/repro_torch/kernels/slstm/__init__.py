"""The sLSTM's recurrence over time, forward and backward: one launch a
call (resident route) or one a time step (per-step route)."""

from repro_torch.kernels.slstm.ops import SLSTMScan, slstm_bwd, slstm_fwd
from repro_torch.kernels.slstm.ref import Saved, slstm_bwd_ref, slstm_scan_ref

__all__ = ["SLSTMScan", "Saved", "slstm_bwd", "slstm_bwd_ref", "slstm_fwd", "slstm_scan_ref"]
