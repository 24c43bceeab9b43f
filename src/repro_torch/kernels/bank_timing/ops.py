"""Wrapper of the FR-FCFS select kernel (``csrc/bank_timing.cu``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.  ``frfcfs_select.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bank_timing.ref import N_SCALARS, select_plain

_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check(name, x, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def frfcfs_select(arrived, is_write, row, open_e, nrd_e, nwr_e, nact_e,
                  npre_e, faw_ok, hit_pend, arrival, ch_scalars, *,
                  row_hit_cap: int = 0):
    """Per row: the FR-FCFS winner's queue slot and command code.

    Per-entry planes: (R, Q) int32 (masks 0/1); ``ch_scalars``: (R, 8)
    int32 with columns (t, bus_free, wtr_until, rtw_until, drain,
    hit_streak).  Returns ``(sel, cmd)``, each (R,) int32.
    """
    planes = (arrived, is_write, row, open_e, nrd_e, nwr_e, nact_e, npre_e,
              faw_ok, hit_pend, arrival)
    if arrived.device.type == "cpu":
        return select_plain(*planes, ch_scalars, row_hit_cap=row_hit_cap)
    if arrived.device.type != "cuda":
        raise ValueError(f"frfcfs_select runs on cuda or cpu, "
                         f"not {arrived.device}")
    rows, q = arrived.shape
    names = ("arrived", "is_write", "row", "open_e", "nrd_e", "nwr_e",
             "nact_e", "npre_e", "faw_ok", "hit_pend", "arrival")
    for name, x in zip(names, planes):
        _check(name, x, (rows, q), arrived.device)
    _check("ch_scalars", ch_scalars, (rows, N_SCALARS), arrived.device)
    out = torch.empty((rows, 2), dtype=torch.int32, device=arrived.device)
    fn = _build.function("frfcfs_select_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(arrived.device).cuda_stream
    err = fn(*(x.data_ptr() for x in planes), ch_scalars.data_ptr(),
             out.data_ptr(), rows, q, int(row_hit_cap), stream)
    if err:
        raise RuntimeError(f"frfcfs_select launch failed: CUDA error {err}")
    frfcfs_select.launches += 1
    return out[:, 0], out[:, 1]


frfcfs_select.launches = 0
