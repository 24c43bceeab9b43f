from repro_torch.kernels.flash_attention.ops import flash_attention, route
from repro_torch.kernels.flash_attention.ref import default_scale, mha_plain

__all__ = ["flash_attention", "route", "mha_plain", "default_scale"]
