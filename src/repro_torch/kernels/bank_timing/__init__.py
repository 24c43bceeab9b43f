from repro_torch.kernels.bank_timing.ops import frfcfs_select
from repro_torch.kernels.bank_timing.ref import N_SCALARS, select_plain

__all__ = ["frfcfs_select", "select_plain", "N_SCALARS"]
