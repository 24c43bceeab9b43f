from repro_torch.kernels.addr_decode.ops import decode_packed
from repro_torch.kernels.addr_decode.ref import decode_packed_plain, unpack

__all__ = ["decode_packed", "decode_packed_plain", "unpack"]
