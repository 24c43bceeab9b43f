"""Wrapper of the interface-window kernel (``csrc/window_inject.cu``).

One launch runs one window's bound phase and interface hand-off for
every point of a batched `MessFrontend`: the MSHR budget and
``l_ir_cycles``, `workload.generate`, the address decode of every
candidate (``simple``, the Skylake XOR body of ``decode_packed``, or
``xor_fold``; then the partitioned-socket override), the admission and
queue scatter of `workload.inject_queue`, and `MessFrontend.update`.

Its plain version is the platform's eager route,
`repro_torch.core.platform._bound_inject_eager` (``generate`` ->
``inject_queue`` -> ``update``), which the CPU runs and which the kernel
matches bit for bit.  (It is not called from here: `core` imports the
kernels package, so this module imports nothing of `core`.)  The wrapper
runs on the card only: a CPU tensor raises, and the platform routes CPU
state to the eager route.

``window_inject.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the packed parameter vector, in the order the kernel's ``Params`` reads
#: it (repeated in the comment of ``window_inject.cu``)
PARAM_NAMES = (
    "n_cores", "n_traffic", "n_channels", "q", "ranks", "banks_per_rank",
    "lines_per_row", "row_mask", "mapping", "channels_per_socket",
    "window_cycles", "w_cycles", "cache_path_cycles", "noc_req_cycles",
    "noc_resp_cycles", "prefetch", "pf_shift", "c2t_num", "c2t_den",
    "c2t_round")
#: the decode each candidate takes, by its code in the kernel (0, 1, 2)
MAPPINGS = ("simple", "skylake_xor", "xor_fold")
#: queue slots and channels a point, candidates a point (two sockets)
MAX_Q, MAX_C, MAX_CAND = 512, 32, 4096
CAND = 80                  # candidates a core a window (workload.CAND)
MSHR_CAP = 24              # workload.MSHR_CAP
_SKYLAKE_CHANNELS = 6      # the Skylake XOR body decodes to 6 channels
_I32 = (-(1 << 31), (1 << 31) - 1)

_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_float, ctypes.c_int,
                                        ctypes.c_void_p])


def pack_params(wcfg, clock, *, mapping: str, w: int, window_cycles: int,
                q: int) -> tuple:
    """The kernel's parameter vector (`PARAM_NAMES` order) as ints.

    ``wcfg`` is the `WorkloadConfig`, ``clock`` the `ClockModel`,
    ``mapping`` one of `MAPPINGS` (``addrmap.decode_route``).
    """
    if mapping not in MAPPINGS:
        raise ValueError(f"mapping must be one of {MAPPINGS}, got "
                         f"{mapping!r}")
    d = wcfg.dram
    if mapping == "skylake_xor" and d.n_channels != _SKYLAKE_CHANNELS:
        raise ValueError(f"the Skylake XOR decode has "
                         f"{_SKYLAKE_CHANNELS} channels, not {d.n_channels}")
    cps = 0
    if wcfg.n_sockets > 1 and wcfg.socket_channels == "partitioned":
        if d.n_channels % wcfg.n_sockets:
            raise ValueError(
                f"partitioned ownership needs n_channels ({d.n_channels}) "
                f"divisible by n_sockets ({wcfg.n_sockets})")
        cps = d.n_channels // wcfg.n_sockets
    if clock.window_cycles != window_cycles:
        raise ValueError(f"the clock's window ({clock.window_cycles} "
                         f"cycles) is not the bound phase's "
                         f"({window_cycles})")
    values = dict(
        n_cores=wcfg.n_cores, n_traffic=wcfg.n_traffic,
        n_channels=d.n_channels, q=q, ranks=d.ranks_per_channel,
        banks_per_rank=d.banks_per_rank, lines_per_row=d.lines_per_row,
        row_mask=d.rows_per_bank - 1, mapping=MAPPINGS.index(mapping),
        channels_per_socket=cps, window_cycles=window_cycles,
        w_cycles=w * window_cycles,
        cache_path_cycles=wcfg.cache_path_cycles,
        noc_req_cycles=wcfg.noc_req_cycles,
        noc_resp_cycles=wcfg.noc_resp_cycles,
        prefetch=int(bool(wcfg.prefetch)), pf_shift=wcfg.pf_shift,
        c2t_num=clock.c2t_num, c2t_den=clock.c2t_den,
        c2t_round=clock.c2t_round)
    out = tuple(int(values[n]) for n in PARAM_NAMES)
    bad = [n for n, v in zip(PARAM_NAMES, out)
           if not _I32[0] <= v <= _I32[1]]
    if bad:
        raise ValueError(f"window_inject parameters out of int32: {bad}")
    return out


def _check(queue, cores, pace, wr_num, l_ir, lat_est, wcfg):
    B, C, Q = queue.valid.shape
    N = wcfg.n_cores
    if Q > MAX_Q or Q % 32:
        raise ValueError(f"window_inject takes a multiple of 32 queue slots "
                         f"up to {MAX_Q}, got {Q}")
    if C > MAX_C or C != wcfg.dram.n_channels:
        raise ValueError(f"window_inject takes the device's "
                         f"{wcfg.dram.n_channels} channels, at most "
                         f"{MAX_C}; the queue has {C}")
    if N * CAND > MAX_CAND:
        raise ValueError(f"window_inject ranks at most {MAX_CAND} "
                         f"candidates a point (two sockets), got "
                         f"{N} cores x {CAND}")
    dev = queue.valid.device
    i32, f32 = torch.int32, torch.float32
    fields = [(f"queue.{n}", x, (B, C, Q), i32)
              for n, x in queue._asdict().items()]
    fields += [("cores.seq", cores.seq, (B, N), i32),
               ("cores.backlog", cores.backlog, (B, N), i32),
               ("cores.chase_carry", cores.chase_carry, (B,), i32),
               ("pace", pace, (B,), i32), ("wr_num", wr_num, (B,), i32),
               ("l_ir", l_ir, (B,), f32), ("lat_est", lat_est, (B,), f32)]
    for name, x, shape, dtype in fields:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
    if dev.type == "cpu":
        raise ValueError("window_inject runs on the card only; CPU state "
                         "takes the eager route")
    if dev.type != "cuda":
        raise ValueError(f"window_inject runs on cuda, not {dev}")


def prepare(queue, cores, pace, wr_num, l_ir, lat_est, *, w: int, wcfg,
            clock, mapping: str, window_cycles: int, window_ps: int):
    """Check the inputs; the C entry point's arguments (but the stream)
    and the freshly allocated outputs.

    The kernel reads the inputs where they lie (fields that share
    storage, like ``init_queue``'s one zero tensor, are harmless) and
    writes only the outputs, which come from ``torch.empty`` and share
    storage with nothing.  Returns ``(args, outputs)``.
    """
    _check(queue, cores, pace, wr_num, l_ir, lat_est, wcfg)
    B, C, Q = queue.valid.shape
    N = wcfg.n_cores
    params = pack_params(wcfg, clock, mapping=mapping, w=w,
                         window_cycles=window_cycles, q=Q)
    ins = [x.contiguous() for x in (*queue, cores.seq, cores.backlog,
                                    cores.chase_carry, pace, wr_num, l_ir,
                                    lat_est)]
    empty = dict(dtype=torch.int32, device=queue.valid.device)
    outputs = dict(queue=torch.empty((7, B, C, Q), **empty),
                   core=torch.empty((2, B, N), **empty),
                   point=torch.empty((3, B), **empty),
                   inputs=ins)      # kept alive with the pointers
    q_ptrs = (ctypes.c_void_p * 7)(*(x.data_ptr() for x in ins[:7]))
    c_params = (ctypes.c_int * len(params))(*params)
    args = (q_ptrs, *(x.data_ptr() for x in ins[7:]),
            outputs["queue"].data_ptr(), outputs["core"].data_ptr(),
            outputs["point"].data_ptr(), c_params, len(params),
            float(MSHR_CAP * window_ps), B)
    return args, outputs


def launch(args, stream) -> None:
    """One launch of the kernel on ``stream`` (not counted)."""
    fn = _build.function("window_inject_launch", _ARGTYPES)
    err = fn(*args, stream)
    if err:
        raise RuntimeError(f"window_inject launch failed: CUDA error {err}")


def window_inject(queue, cores, pace, wr_num, l_ir, lat_est, *, w: int,
                  wcfg, clock, mapping: str, window_cycles: int,
                  window_ps: int):
    """Window ``w``'s bound phase and injection on the card.

    Args:
        queue: the batched ``QueueState`` after window ``w - 1``'s weave,
            (B, C, Q) int32 planes on a CUDA device.
        cores: the Mess frontend's ``CoreState`` (seq, backlog (B, N),
            chase_carry (B,)).
        pace, wr_num: the frontend's (B,) int32 operating points.
        l_ir, lat_est: (B,) float32 immediate-response latency (cycles)
            and the closed-loop latency estimate (ps).
        w: the window index.
        wcfg, clock: ``WorkloadConfig`` and ``ClockModel``.
        mapping: the decode route (`MAPPINGS`, ``addrmap.decode_route``).
        window_cycles, window_ps: the CPU window in cycles and in ps.
    Returns:
        ``(queue', cores', injected, l_ir_cycles)``: the new state (same
        NamedTuple types, the queue planes views of one (7, B, C, Q)
        tensor) and two (B,) int32 tensors.
    """
    args, out = prepare(queue, cores, pace, wr_num, l_ir, lat_est, w=w,
                        wcfg=wcfg, clock=clock, mapping=mapping,
                        window_cycles=window_cycles, window_ps=window_ps)
    launch(args, torch.cuda.current_stream(queue.valid.device).cuda_stream)
    window_inject.launches += 1
    core, point = out["core"], out["point"]
    return (queue._make(out["queue"].unbind(0)),
            cores._make((core[0], core[1], point[0])), point[1], point[2])


window_inject.launches = 0
