"""Wrapper of the Skylake address-decode kernel (``csrc/addr_decode.cu``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  ``decode_packed.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.addr_decode.ref import (decode_packed_plain,
                                                 to_int32_bits)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p]


def decode_packed(lines):
    """int64 line indices in ``[0, 2**32)``, any shape -> packed words.

    The result has the shape of ``lines`` and holds each packed uint32
    as its int32 bit pattern (`unpack` reads the fields back).
    """
    if lines.device.type == "cpu":
        return decode_packed_plain(lines)
    if lines.device.type != "cuda":
        raise ValueError(f"decode_packed runs on cuda or cpu, "
                         f"not {lines.device}")
    if lines.dtype != torch.int64:
        raise TypeError(f"lines must be int64, got {lines.dtype}")
    # the kernel reads the low 32 bits of each line as uint32
    bits = to_int32_bits(lines.reshape(-1) & 0xFFFFFFFF).contiguous()
    out = torch.empty_like(bits)
    fn = _build.function("decode_packed_launch", _ARGTYPES)
    # the runtime launches on the current device: make it the tensors'
    with torch.cuda.device(lines.device):
        stream = torch.cuda.current_stream(lines.device).cuda_stream
        err = fn(bits.data_ptr(), out.data_ptr(), bits.numel(), stream)
    if err:
        raise RuntimeError(f"decode_packed launch failed: CUDA error {err}")
    decode_packed.launches += 1
    return out.view(lines.shape)


decode_packed.launches = 0
