"""Wrappers of the interface-window kernel (``csrc/window_inject.cu``).

One launch runs one window's bound phase and interface hand-off for
every point of a batch: the MSHR budget and ``l_ir_cycles``, the
frontend's bound phase, the address decode of every candidate
(``simple``, the Skylake XOR body of ``decode_packed``, or
``xor_fold``; then the partitioned-socket override), the admission and
queue scatter of `workload.inject_queue`, and the frontend's update.
The kernel is a template over the frontend, with two instances:

* `window_inject` -- a batched `MessFrontend` (`workload.generate`,
  `MessFrontend.update`);
* `window_inject_trace` -- a batched `TraceFrontend` over a `Trace` or
  a `TraceMix` (`TraceFrontend.bound` and `update`).

Their plain version is the platform's eager route,
`repro_torch.core.platform._bound_inject_eager` (``bound`` ->
``inject_queue`` -> ``update``), which the CPU runs and which the kernel
matches bit for bit.  (It is not called from here: `core` imports the
kernels package, so this module imports nothing of `core` or `traces`.)
The wrappers run on the card only: a CPU tensor raises, and the platform
routes CPU state to the eager route.

``window_inject.launches`` and ``window_inject_trace.launches`` count
each instance's launches.
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
#: queue slots and channels a point, candidates a point (two sockets).
#: The admission key ``ch * 2^26 + key`` is int32 and invalid entries
#: take ``ch = C``: at 32 channels their key is 2^31 and wraps negative,
#: so 31 is the most channels the key ranks (``kMaxC`` sizes the
#: kernel's shared arrays at 32 all the same)
MAX_Q, MAX_C, MAX_CAND = 512, 31, 4096
CAND = 80                  # candidates a core a window (workload.CAND)
CAP_DEMAND = 64            # accesses a trace core reads (workload.CAP_DEMAND)
MSHR_CAP = 24              # workload.MSHR_CAP
_SKYLAKE_CHANNELS = 6      # the Skylake XOR body decodes to 6 channels
_I32 = (-(1 << 31), (1 << 31) - 1)

_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_float, ctypes.c_int,
                                        ctypes.c_void_p])
# q_in[7], state[5], trace[6], l_ir, lat_est, q_out, core_out, point_out,
# params, n_params, budget_num, n_slots, is_mix, batch, stream
_TRACE_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])


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


def _check_fields(fields, dev):
    """Each ``(name, tensor, shape, dtype)`` on ``dev`` as given; then
    ``dev`` must be a card."""
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


def _check_queue(queue, wcfg):
    B, C, Q = queue.valid.shape
    N = wcfg.n_cores
    if Q > MAX_Q or Q % 32:
        raise ValueError(f"window_inject takes a multiple of 32 queue slots "
                         f"up to {MAX_Q}, got {Q}")
    if C > MAX_C:
        raise ValueError(f"window_inject ranks at most {MAX_C} channels: "
                         f"the int32 admission key ch * 2^26 + key wraps "
                         f"at 32 (invalid entries take ch = C); the queue "
                         f"has {C}")
    if C != wcfg.dram.n_channels:
        raise ValueError(f"window_inject takes the device's "
                         f"{wcfg.dram.n_channels} channels; the queue has "
                         f"{C}")
    if N * CAND > MAX_CAND:
        raise ValueError(f"window_inject ranks at most {MAX_CAND} "
                         f"candidates a point (two sockets), got "
                         f"{N} cores x {CAND}")
    return [(f"queue.{n}", x, (B, C, Q), torch.int32)
            for n, x in queue._asdict().items()]


def _check(queue, cores, pace, wr_num, l_ir, lat_est, wcfg):
    fields = _check_queue(queue, wcfg)
    B, N = queue.valid.shape[0], wcfg.n_cores
    i32, f32 = torch.int32, torch.float32
    fields += [("cores.seq", cores.seq, (B, N), i32),
               ("cores.backlog", cores.backlog, (B, N), i32),
               ("cores.chase_carry", cores.chase_carry, (B,), i32),
               ("pace", pace, (B,), i32), ("wr_num", wr_num, (B,), i32),
               ("l_ir", l_ir, (B,), f32), ("lat_est", lat_est, (B,), f32)]
    _check_fields(fields, queue.valid.device)


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


def _trace_fields(trace, N):
    """The trace's arrays in the kernel's order (delta, is_write, dep,
    length, footprint, region stride), whether it is a mix, and the
    checks of their shapes."""
    is_mix = trace.delta.dim() == 3
    B, L = trace.delta.shape[0], trace.delta.shape[-1]
    rows, per_core = ((B, N, L), (B, N)) if is_mix else ((B, L), (B,))
    region = trace.region_lines if is_mix else trace.footprint_lines
    arrays = (trace.delta, trace.is_write, trace.dep, trace.length,
              trace.footprint_lines, region)
    names = ("delta", "is_write", "dep", "length", "footprint_lines",
             "region_lines" if is_mix else "footprint_lines")
    shapes = (rows, rows, rows, per_core, per_core, (B,))
    return is_mix, L, arrays, [
        (f"trace.{n}", x, shape, torch.int32)
        for n, x, shape in zip(names, arrays, shapes)]


def prepare_trace(queue, state, trace, l_ir, lat_est, *, w: int, wcfg,
                  clock, mapping: str, window_cycles: int, window_ps: int):
    """`prepare` for the trace instance: check the inputs; the C entry
    point's arguments (but the stream) and the fresh outputs."""
    fields = _check_queue(queue, wcfg)
    B, C, Q = queue.valid.shape
    N = wcfg.n_cores
    i32, f32 = torch.int32, torch.float32
    is_mix, L, arrays, trace_fields = _trace_fields(trace, N)
    if L < CAP_DEMAND:
        raise ValueError(f"window_inject_trace reads {CAP_DEMAND} accesses "
                         f"at each cursor: the trace needs at least "
                         f"{CAP_DEMAND} slots, got {L}")
    fields += [(f"state.{n}", x, shape, i32) for (n, x), shape in zip(
        state._asdict().items(), [(B, N)] * 3 + [(B,)] * 2)]
    fields += trace_fields
    fields += [("l_ir", l_ir, (B,), f32), ("lat_est", lat_est, (B,), f32)]
    _check_fields(fields, queue.valid.device)
    params = pack_params(wcfg, clock, mapping=mapping, w=w,
                         window_cycles=window_cycles, q=Q)
    ins = [x.contiguous() for x in (*queue, *state, *arrays, l_ir,
                                    lat_est)]
    empty = dict(dtype=i32, device=queue.valid.device)
    outputs = dict(queue=torch.empty((7, B, C, Q), **empty),
                   core=torch.empty((3, B, N), **empty),
                   point=torch.empty((4, B), **empty),
                   inputs=ins)      # kept alive with the pointers
    q_ptrs = (ctypes.c_void_p * 7)(*(x.data_ptr() for x in ins[:7]))
    s_ptrs = (ctypes.c_void_p * 5)(*(x.data_ptr() for x in ins[7:12]))
    t_ptrs = (ctypes.c_void_p * 6)(*(x.data_ptr() for x in ins[12:18]))
    c_params = (ctypes.c_int * len(params))(*params)
    args = (q_ptrs, s_ptrs, t_ptrs, ins[18].data_ptr(), ins[19].data_ptr(),
            outputs["queue"].data_ptr(), outputs["core"].data_ptr(),
            outputs["point"].data_ptr(), c_params, len(params),
            float(MSHR_CAP * window_ps), L, int(is_mix), B)
    return args, outputs


def launch_trace(args, stream) -> None:
    """One launch of the trace instance on ``stream`` (not counted)."""
    fn = _build.function("window_inject_trace_launch", _TRACE_ARGTYPES)
    err = fn(*args, stream)
    if err:
        raise RuntimeError(f"window_inject_trace launch failed: CUDA "
                           f"error {err}")


def window_inject_trace(queue, state, trace, l_ir, lat_est, *, w: int,
                        wcfg, clock, mapping: str, window_cycles: int,
                        window_ps: int):
    """Window ``w``'s bound phase and injection of a trace replay on the
    card.

    Args:
        queue: the batched ``QueueState`` after window ``w - 1``'s weave,
            (B, C, Q) int32 planes on a CUDA device.
        state: the trace frontend's ``TraceState`` (pos, line_cum, carry
            (B, N); chase_seq, chase_carry (B,)); cursors >= 0.
        trace: the frontend's batched ``Trace`` (delta, is_write, dep (B,
            L); length, footprint_lines (B,)) or ``TraceMix`` (the same
            with a core axis after the batch axis, and region_lines (B,)),
            L >= 64.
        l_ir, lat_est: (B,) float32 immediate-response latency (cycles)
            and the closed-loop latency estimate (ps).
        w, wcfg, clock, mapping, window_cycles, window_ps: as
            `window_inject`.
    Returns:
        ``(queue', state', injected, l_ir_cycles)``: the new state (same
        NamedTuple types, the queue planes views of one (7, B, C, Q)
        tensor) and two (B,) int32 tensors.
    """
    args, out = prepare_trace(queue, state, trace, l_ir, lat_est, w=w,
                              wcfg=wcfg, clock=clock, mapping=mapping,
                              window_cycles=window_cycles,
                              window_ps=window_ps)
    launch_trace(args,
                 torch.cuda.current_stream(queue.valid.device).cuda_stream)
    window_inject_trace.launches += 1
    core, point = out["core"], out["point"]
    return (queue._make(out["queue"].unbind(0)),
            state._make((core[0], core[1], core[2], point[0], point[1])),
            point[2], point[3])


window_inject_trace.launches = 0
