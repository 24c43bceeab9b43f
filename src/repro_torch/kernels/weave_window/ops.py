"""Wrapper of the whole-window weave kernel (``csrc/weave_window.cu``).

One launch runs one window of the weave phase, dense or event-horizon,
for every (point, channel) row of a batched ``QueueState`` /
``BankState``: the refresh, write-drain, FR-FCFS select, command apply
and stats of every step, and on the event engine every ``next_event``.

Its plain version is the stepwise loop of the platform:
`repro_torch.core.platform._weave_dense` / `_weave_event` over
`repro_torch.core.dram.tick` / `next_event`, which the CPU runs and
which the kernel matches bit for bit.  (It is not called from here:
`core.dram` imports the kernels package, so this module imports nothing
of `core`.)  The wrapper runs on the card only: a CPU tensor raises, and
the platform routes CPU state to the stepwise loop.

With ``telemetry`` or ``cmd_trace`` the launch takes the recording
instance of the same kernel (``weave_window_record_launch``: the
reference's telemetry planes and per-step command records, bit for bit
those of `dram.tick` with the flags); there is no fallback to another
route.

``weave_window.launches`` counts launches (every instance),
``weave_window.launches_by_instance`` them per instance (``plain``,
``telemetry``, ``cmd_trace``, ``telemetry+cmd_trace``) and
``weave_window.steps`` the weave steps they ran (launches x steps per
window).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: the packed timing / policy / clock vector, in the order the kernel's
#: ``Params`` reads it (repeated in the comment of ``weave_window.cu``)
PARAM_NAMES = (
    "tCL", "tRCD", "tRP", "tRAS", "tBL", "tCCD_S", "tCCD_L", "tWR",
    "tWTR_L", "tRTP", "tRRD_S", "tRRD_L", "tFAW", "tCWL", "tRTRS", "tREFI",
    "tRFC", "tRC", "banks_per_rank", "banks_per_group", "same_bank_refresh",
    "drain_hi", "drain_lo", "row_hit_cap", "mc_extra_ticks",
    "tick2cpu_num", "tick2cpu_den", "cpu_ps_per_clk")
_FROM_DRAM = PARAM_NAMES[:21]       # DramParams
_FROM_POLICY = PARAM_NAMES[21:25]   # SchedulerPolicy
_FROM_CLOCK = PARAM_NAMES[25:]      # ClockModel / CpuParams

#: the largest row the kernel sizes: queue slots (threads a block),
#: banks and ranks of a channel
MAX_Q, MAX_RB, MAX_RANKS = 512, 64, 4

_BANK_PLANES = ("open_row", "next_act", "next_rd", "next_wr", "next_pre")
_CHANNEL_REGS = ("bus_free", "wtr_until", "rtw_until", "last_rank", "drain",
                 "hit_streak")
_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_void_p]
             + [ctypes.c_int] * 10 + [ctypes.c_void_p])
_RECORD_ARGTYPES = ([ctypes.c_void_p] * 22 + [ctypes.c_void_p]
                    + [ctypes.c_int] * 12 + [ctypes.c_void_p])

#: log2 latency buckets of the telemetry histograms (`dram.N_HIST`)
N_HIST = 24
#: the telemetry counters of the kernel's (7, rows) output, in
#: `dram.TickTele`'s order (its other fields: busy, two histograms)
TELE_COUNTERS = ("n_act", "n_pre", "n_cas_rd", "n_cas_wr", "n_ref",
                 "drain_enter", "drain_ticks")


def pack_params(dram, policy, *, tick2cpu_num: int, tick2cpu_den: int,
                cpu_ps_per_clk: int) -> tuple:
    """The kernel's parameter vector (`PARAM_NAMES` order) as ints."""
    clock = dict(tick2cpu_num=tick2cpu_num, tick2cpu_den=tick2cpu_den,
                 cpu_ps_per_clk=cpu_ps_per_clk)
    return (tuple(int(getattr(dram, n)) for n in _FROM_DRAM)
            + tuple(int(getattr(policy, n)) for n in _FROM_POLICY)
            + tuple(int(clock[n]) for n in _FROM_CLOCK))


def pack_inputs(queue, banks):
    """The kernel's packed int32 inputs and freshly allocated outputs.

    Inputs are copies (``torch.stack``), so fields that share storage
    (``init_queue``'s one zero tensor, expanded views) are harmless;
    outputs come from ``torch.empty`` and share storage with nothing.
    Returns ``(inputs, outputs)``, two dicts of tensors.
    """
    B, C, _ = queue.valid.shape
    dev = queue.valid.device
    inputs = dict(
        queue=torch.stack(tuple(queue)),                       # (7,B,C,Q)
        banks=torch.stack([getattr(banks, n) for n in _BANK_PLANES]),
        faw=banks.faw.clone(memory_format=torch.contiguous_format),
        refresh=torch.stack([banks.next_ref, banks.ref_slot]),
        channel=torch.stack([getattr(banks, n).to(torch.int32)
                             for n in _CHANNEL_REGS]))
    empty = dict(dtype=torch.int32, device=dev)
    outputs = dict(
        queue=torch.empty_like(inputs["queue"]),
        banks=torch.empty_like(inputs["banks"]),
        faw=torch.empty_like(inputs["faw"]),
        refresh=torch.empty_like(inputs["refresh"]),
        channel=torch.empty_like(inputs["channel"]),
        stats_i=torch.empty((5, B, C), **empty),
        stats_f=torch.empty((B, C), dtype=torch.float32, device=dev),
        live=torch.empty((B, C), **empty),
        sat=torch.empty((B, C), **empty))
    return inputs, outputs


def instance(telemetry: bool, cmd_trace: bool) -> str:
    """The kernel instance a flag pair runs."""
    return "+".join(n for n, on in (("telemetry", telemetry),
                                    ("cmd_trace", cmd_trace)) if on) \
        or "plain"


def pack_recorder(tele, B: int, C: int, RB: int, R: int, n_steps: int,
                  dev, *, telemetry: bool, cmd_trace: bool):
    """The recorders' packed inputs and fresh outputs (dicts of int32
    tensors; the keys of an unset flag are absent).  ``tele`` is the
    `TeleState` (int32 ``opened_at`` and ``last_wr_t``, bool
    ``wr_burst``) and is copied, never aliased."""
    empty = dict(dtype=torch.int32, device=dev)
    inputs, outputs = {}, {}
    if telemetry:
        inputs.update(opened=tele[0].clone(
                          memory_format=torch.contiguous_format),
                      burst=torch.stack([tele[1], tele[2].to(torch.int32)]))
        outputs.update(opened=torch.empty((B, C, RB), **empty),
                       burst=torch.empty((2, B, C), **empty),
                       counters=torch.empty((len(TELE_COUNTERS), B, C),
                                            **empty),
                       busy=torch.empty((B, C, RB), **empty),
                       hist=torch.empty((2, B, C, N_HIST), **empty))
    if cmd_trace:
        outputs["rec"] = torch.empty((n_steps, B * C, 4 + 2 * R), **empty)
    return inputs, outputs


def _check_tele(tele, B, C, RB, dev):
    if tele is None:
        raise ValueError("telemetry=True needs the TeleState carry (tele)")
    for name, x, shape, dtype in (
            ("tele.opened_at", tele[0], (B, C, RB), torch.int32),
            ("tele.last_wr_t", tele[1], (B, C), torch.int32),
            ("tele.wr_burst", tele[2], (B, C), torch.bool)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")


def _check(queue, banks, dram, n_steps):
    B, C, Q = queue.valid.shape
    RB, R = dram.banks_per_channel, dram.ranks_per_channel
    if Q > MAX_Q or Q % 32:
        raise ValueError(f"weave_window takes a multiple of 32 queue slots "
                         f"up to {MAX_Q}, got {Q}")
    if RB > MAX_RB or RB > Q or R > MAX_RANKS:
        raise ValueError(f"weave_window sizes at most {MAX_RB} banks (and "
                         f"no more than the {Q} slots) and {MAX_RANKS} "
                         f"ranks a channel, got {RB} banks, {R} ranks")
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    dev = queue.valid.device
    if dev.type == "cpu":
        raise ValueError("weave_window runs on the card only; CPU state "
                         "takes the stepwise weave route")
    if dev.type != "cuda":
        raise ValueError(f"weave_window runs on cuda, not {dev}")
    shapes = dict(open_row=(B, C, RB), next_act=(B, C, RB),
                  next_rd=(B, C, RB), next_wr=(B, C, RB),
                  next_pre=(B, C, RB), faw=(B, C, R, 4), next_ref=(B, C, R),
                  ref_slot=(B, C, R))
    fields = [(f"queue.{n}", x, (B, C, Q), torch.int32)
              for n, x in queue._asdict().items()]
    fields += [(f"banks.{n}", x, shapes.get(n, (B, C)),
                torch.bool if n == "drain" else torch.int32)
               for n, x in banks._asdict().items()]
    for name, x, shape, dtype in fields:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")


def weave_window(queue, banks, *, start: int, end: int, horizon: int,
                 n_steps: int, event: bool, dram, policy,
                 tick2cpu_num: int, tick2cpu_den: int, cpu_ps_per_clk: int,
                 telemetry: bool = False, tele=None, cmd_trace: bool = False):
    """Run one weave window on the card.

    Args:
        queue, banks: the batched ``QueueState`` / ``BankState`` after the
            window's injection, on a CUDA device.
        start, end: the window's first DRAM tick and its end (exclusive).
        horizon: ``start`` + the static ticks per window.
        n_steps: dense: ticks stepped from ``start`` (active while
            ``t < end``); event: the event budget.
        event: the event-horizon engine instead of the dense one.
        dram, policy: ``DramParams`` / ``SchedulerPolicy``.
        tick2cpu_num, tick2cpu_den, cpu_ps_per_clk: the clock's mapping
            of DRAM ticks to CPU picoseconds.
        telemetry: record the telemetry planes; ``tele`` is then the
            `TeleState` carry ``(opened_at, last_wr_t, wr_burst)``.
        cmd_trace: record every step's command.
    Returns:
        ``(queue', banks', stats, live_steps, sat)``: the new state (same
        NamedTuple types), the six ``TickStats`` fields per (B, C) in
        their order, the (B, C) int32 count of steps before ``end``
        (event: ``tn < end``) and the (B, C) bool saturation flag (event
        budget spent with an event pending before ``horizon``).  With a
        recorder flag, a sixth item ``(tele_inc, tele', cmds)``, None
        for an unset flag: the window's `TickTele` fields ((B, C), busy
        (B, C, RB), histograms (B, C, N_HIST)), the new `TeleState`
        fields, and the `TickCmd` fields of every step, ``(B, n_steps,
        C)`` (``ref`` / ``ref_bank`` ``(B, n_steps, C, R)``).
    """
    _check(queue, banks, dram, n_steps)
    B, C, Q = queue.valid.shape
    RB, R = dram.banks_per_channel, dram.ranks_per_channel
    dev = queue.valid.device
    recording = bool(telemetry or cmd_trace)
    if telemetry:
        _check_tele(tele, B, C, RB, dev)
    inp, out = pack_inputs(queue, banks)
    rin, rout = pack_recorder(tele, B, C, RB, R, n_steps, dev,
                              telemetry=telemetry, cmd_trace=cmd_trace)
    params = pack_params(dram, policy, tick2cpu_num=tick2cpu_num,
                         tick2cpu_den=tick2cpu_den,
                         cpu_ps_per_clk=cpu_ps_per_clk)
    c_params = (ctypes.c_int * len(params))(*params)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [inp[k].data_ptr() for k in ("queue", "banks", "faw", "refresh",
                                        "channel")]
    ptrs += [out[k].data_ptr() for k in ("queue", "banks", "faw", "refresh",
                                         "channel", "stats_i", "stats_f",
                                         "live", "sat")]
    window = (B * C, Q, RB, R, int(start), int(end), int(horizon),
              int(n_steps), int(bool(event)))
    if recording:
        fn = _build.function("weave_window_record_launch", _RECORD_ARGTYPES)
        ptrs += [rin[k].data_ptr() if k in rin else None
                 for k in ("opened", "burst")]
        ptrs += [rout[k].data_ptr() if k in rout else None
                 for k in ("opened", "burst", "counters", "busy", "hist",
                           "rec")]
        args = (*ptrs, ctypes.addressof(c_params), len(params), *window,
                int(bool(telemetry)), int(bool(cmd_trace)), stream)
    else:
        fn = _build.function("weave_window_launch", _ARGTYPES)
        args = (*ptrs, ctypes.addressof(c_params), len(params), *window,
                stream)
    # the runtime launches on the current device: make it the tensors'
    with torch.cuda.device(dev):
        err = fn(*args)
    if err:
        raise RuntimeError(f"weave_window launch failed: CUDA error {err}")
    weave_window.launches += 1
    weave_window.launches_by_instance[instance(telemetry, cmd_trace)] += 1
    weave_window.steps += int(n_steps)

    bank_planes = dict(zip(_BANK_PLANES, out["banks"].unbind(0)))
    ch = dict(zip(_CHANNEL_REGS, out["channel"].unbind(0)))
    ch["drain"] = ch["drain"] != 0
    banks_out = banks._make(
        (bank_planes | ch | dict(faw=out["faw"],
                                 next_ref=out["refresh"][0],
                                 ref_slot=out["refresh"][1]))[n]
        for n in banks._fields)
    si = out["stats_i"]
    stats = (si[0], si[1], si[2], out["stats_f"], si[3], si[4])
    result = (queue._make(out["queue"].unbind(0)), banks_out, stats,
              out["live"], out["sat"] != 0)
    if not recording:
        return result
    tele_inc = tele_out = cmds = None
    if telemetry:
        tele_inc = (tuple(rout["counters"].unbind(0))
                    + (rout["busy"],) + tuple(rout["hist"].unbind(0)))
        tele_out = (rout["opened"], rout["burst"][0], rout["burst"][1] != 0)
    if cmd_trace:
        rec = rout["rec"].view(n_steps, B, C, -1).transpose(0, 1)
        cmds = (rec[..., 0], rec[..., 1], rec[..., 2], rec[..., 3],
                rec[..., 4:4 + R] != 0, rec[..., 4 + R:])
    return result + ((tele_inc, tele_out, cmds),)


weave_window.launches = 0
weave_window.launches_by_instance = dict.fromkeys(
    ("plain", "telemetry", "cmd_trace", "telemetry+cmd_trace"), 0)
weave_window.steps = 0
