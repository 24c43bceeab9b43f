"""Wrapper of the flash-attention kernels.

Two hand-written kernels compute the same function; `route` picks one
by a fixed rule, never by trying:

* ``"sm90_bf16"`` (``csrc/flash_attention_sm90.cu``): bf16 inputs with
  head dim 64, 80 or 128 (tinyllama's and whisper's; zamba2's shared
  block; deepseek's, minitron's, qwen2's, grok-1's and arctic's), on
  Hopper's tensor cores (TMA + ``wgmma``).  It rounds the probabilities
  to bf16 before the P.V product.  TMA needs 16-byte aligned base
  addresses and strides; such an input that breaks that raises.
* ``"cuda_core"`` (``csrc/flash_attention.cu``): everything else, fp32
  at any head dim and bf16 at 16, 32, 48, 96, 112; fp32 FMAs on the
  CUDA cores, the exact route.

A CPU tensor takes the plain version; a CUDA tensor launches its route's
kernel or raises.  Neither kernel has a backward, as the reference's
Pallas kernel has none: a call that autograd would differentiate raises
on both devices (``use_flash_kernel=False``, the chunked route, is the
one to train through).  ``flash_attention.launches`` counts kernel
launches, ``flash_attention.launches_by_route`` the same per route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import default_scale, mha_plain

#: the kernels take head dims that are multiples of 16 up to this
MAX_HEAD_DIM = 128
#: bf16 inputs with these head dims take the Hopper kernel
SM90_HEAD_DIMS = (64, 80, 128)
ROUTES = ("sm90_bf16", "cuda_core")

# q, k, v, o pointers; 3 strides (b, h, s) for each of q, k, v, o;
# b, hq, hkv, sq, sk, d, [is_bf16,] causal; scale; stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 12
             + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
_SM90_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 12
                  + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(name, x, device, dtype, ndim=4):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must be 4-d (B, H, S, D), got "
                         f"{tuple(x.shape)}")
    if x.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous along D "
                         f"(strides {x.stride()})")


def route(q, k, v) -> str:
    """The kernel that a CUDA call on these inputs launches.

    ``"sm90_bf16"`` for bf16 with D in `SM90_HEAD_DIMS` and at least one
    key, else ``"cuda_core"``.  Raises ValueError for an ``sm90_bf16``
    input whose base address or (b, h, s) strides are not multiples of
    16 bytes: the tensor maps cannot describe it.  A pure function of
    dtype, shape, strides and address, so it answers for CPU tensors too.
    """
    if (q.dtype != torch.bfloat16 or q.shape[-1] not in SM90_HEAD_DIMS
            or k.shape[2] == 0):
        return "cuda_core"
    for name, x in (("q", q), ("k", k), ("v", v)):
        size = x.element_size()
        if x.data_ptr() % 16 or any(s * size % 16 for s in x.stride()[:3]):
            raise ValueError(
                f"{name}: the sm90_bf16 route reads by TMA, which needs a "
                f"16-byte aligned address and (b, h, s) strides that are "
                f"multiples of 16 bytes; got strides {x.stride()} at "
                f"address {x.data_ptr():#x}")
    return "sm90_bf16"


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: float | None = None):
    """GQA flash attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D), Hq % Hkv == 0; fp32 or
    bf16, any strides with D innermost (the model's transposed views are
    read in place).  Returns (B, Hq, Sq, D) in q.dtype; on the card it
    is a view of a (B, Sq, Hq, D) buffer, the layout the model reads.
    """
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward (nor has the reference's "
            "kernel): call it under torch.no_grad() or "
            "torch.inference_mode(), or train through the chunked route "
            "(use_flash_kernel=False)")
    if q.device.type == "cpu":
        return mha_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, "
                         f"not {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, q.device, q.dtype)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} unsupported: the kernel takes "
                         f"multiples of 16 up to {MAX_HEAD_DIM}")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    which = route(q, k, v)
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    if which == "sm90_bf16":
        fn = _build.function("flash_attention_sm90_launch", _SM90_ARGTYPES)
        flags = (int(causal),)
    else:
        fn = _build.function("flash_attention_launch", _ARGTYPES)
        flags = (_DTYPES[q.dtype], int(causal))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             *strides, b, hq, hkv, sq, sk, d, *flags,
             default_scale(d) if scale is None else float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention ({which}) launch failed: "
                           f"error {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[which] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
