"""The integrated simulation platform: bound/weave windows + interface.

One `run_point` simulates the platform for a fixed number of 1000-cycle
windows at a batch of Mess operating points (pace, read/write mix) and
returns the three memory-performance views.  Per window:

1. **Bound phase** (`workload.generate`): every core's requests against
   the immediate-response latency (1 CPU cycle in the DAMOV baseline,
   PI-controlled from stage 04).
2. **Interface** (`workload.inject_queue` + `clocking`): requests cross
   the CPU->memory clock domain under the selected clock model.
3. **Weave phase**: the cycle-accurate `dram.tick` over the window's
   DRAM ticks — densely, one step per tick, or on the event horizon
   (`dram.next_event`), one step per tick where something can change.
4. **PI update**: ``l_ir' = 0.95 * l_ir + 0.05 * avg weave latency``.

The window loop is a Python loop over batched tensors (the batch axis
replaces the reference's ``vmap``).  Steps 1-2 and the weave phase each
have two routes.  Bound phase and interface (`_inject_route`, by where
the state lies and the frontend's type): on the card the Mess frontend
takes one `window_inject` launch (`_bound_inject_fused`) and the trace
frontend the eager route on card tensors (the trace route, whose
Skylake decode is one `decode_packed` launch); any other frontend on
the card raises.  On the CPU every frontend takes the eager
``bound`` -> ``inject_queue`` -> ``update`` (`_bound_inject_eager`,
also the kernel's plain version).  Weave (`_weave_route`): on the card
one `weave_window` launch runs the whole window (`_weave_fused`); on
the CPU the stepwise loops `_weave_dense` / `_weave_event` run one
`dram.tick` per step (also that kernel's plain version).  Entry points
take ``device=None``, which means ``"cuda"``; without a card they
raise.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import addrmap, dram, workload
from repro_torch.core.clocking import ClockModel, make_clock
from repro_torch.core.dram import SchedulerPolicy
from repro_torch.core.noc import NocModel, make_noc
from repro_torch.core.timing import DEFAULT_PLATFORM, PlatformParams
from repro_torch.core.workload import WorkloadConfig
from repro_torch.kernels.weave_window import weave_window
from repro_torch.kernels.window_inject import window_inject

PI_KEEP = 0.95       # paper: 95% previous estimate
PI_BLEND = 0.05      # paper: 5% new cycle-accurate average

_I32 = torch.int32
_F32 = torch.float32


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """Full static configuration of one simulation stage.

    ``l_ir_init_cycles`` is CPU cycles; ``windows``/``warmup`` count
    1000-cycle windows.  ``weave`` is ``"event"`` (default; bit-identical
    to ``"dense"`` while the per-window event budget covers the window,
    flagged in ``weave_sat`` otherwise) or ``"dense"``.
    ``weave_events`` overrides the clock-derived event budget.
    ``telemetry`` and ``cmd_trace`` are the reference's recorder flags;
    they are not ported yet and must stay False.
    """

    name: str = "01-baseline"
    clock_mode: str = "broken_noscale"
    mapping: str = "simple"
    pi_latency: bool = False          # stage 04 model correction
    noc: str = "fixed"                # stage 06
    prefetch: bool = False            # stage 07
    policy: SchedulerPolicy = dataclasses.field(default_factory=SchedulerPolicy)
    l_ir_init_cycles: float = 1.0     # DAMOV immediate-response latency
    windows: int = 96
    warmup: int = 32
    weave: str = "event"
    weave_events: int = 0
    n_sockets: int = 1
    socket_channels: str = "interleaved"
    telemetry: bool = False
    cmd_trace: bool = False
    platform: PlatformParams = dataclasses.field(
        default_factory=lambda: DEFAULT_PLATFORM)

    def __post_init__(self):
        if self.weave not in ("dense", "event"):
            raise ValueError(
                f"weave must be 'dense' or 'event', got {self.weave!r}")
        for flag in ("telemetry", "cmd_trace"):
            if getattr(self, flag):
                raise ValueError(f"{flag}=True is not ported yet")

    def clock(self) -> ClockModel:
        return make_clock(self.clock_mode, self.platform)

    def event_budget(self) -> int:
        """Event-scan steps per window (override or clock-derived)."""
        return self.weave_events or self.clock().events_per_window_static

    def noc_model(self) -> NocModel:
        return make_noc(self.noc)

    def workload_config(self) -> WorkloadConfig:
        n = self.noc_model()
        return WorkloadConfig(
            mapping=self.mapping, prefetch=self.prefetch,
            cache_path_cycles=self.platform.cpu.cache_path_cycles,
            noc_req_cycles=n.req_cycles, noc_resp_cycles=n.resp_cycles,
            dram=self.platform.dram, n_sockets=self.n_sockets,
            socket_channels=self.socket_channels)


class WindowOut(NamedTuple):
    """One window's results, each (B,) (stacked: (W, B))."""

    served_rd: torch.Tensor
    served_wr: torch.Tensor
    sum_rd_lat_ticks: torch.Tensor
    sum_if_lat_ps: torch.Tensor
    chase_rd: torch.Tensor
    sum_chase_lat_ticks: torch.Tensor
    app_lat_cycles: torch.Tensor    # bound-phase load-to-use (app view)
    l_ir: torch.Tensor
    injected: torch.Tensor
    ticks: torch.Tensor
    progress: torch.Tensor


def _fma32(a, b: float, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    The reference's XLA program contracts ``lat_w`` and the PI update
    into fused multiply-adds; float64 holds the product of two float32
    values exactly, so one rounding of the float64 sum reproduces them.
    """
    return (a.double() * float(np.float32(b)) + c.double()).float()


def _ordered_sum(x, dim: int):
    """Sum along ``dim`` in index order (one fixed float32 order on every
    device)."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _add_stats(acc: dram.TickStats, s: dram.TickStats) -> dram.TickStats:
    return dram.TickStats(*(a + b for a, b in zip(acc, s)))


def _weave_dense(cfg, clock, tick_kw, queue, banks, w):
    """Reference engine: one step per DRAM tick of the window."""
    start, end = clock.window_start_tick(w), clock.window_end_tick(w)
    B = queue.valid.shape[0]
    dev = queue.valid.device
    acc = dram.zero_stats(cfg.platform.dram, B, dev)
    for t in range(start, start + clock.ticks_per_window_static):
        queue, banks, s = dram.tick(queue, banks, t, active=t < end,
                                    **tick_kw)
        acc = _add_stats(acc, s)
    events = torch.full((B,), end - start, dtype=_I32, device=dev)
    sat = torch.zeros((B,), dtype=torch.bool, device=dev)
    return queue, banks, acc, events, sat


def _weave_event(cfg, clock, tick_kw, queue, banks, w):
    """Event-horizon engine: each step jumps every channel to its own
    next tick where eligibility can change.  A channel whose events are
    exhausted parks at ``horizon - 1`` with ``active=False``."""
    start, end = clock.window_start_tick(w), clock.window_end_tick(w)
    horizon = start + clock.ticks_per_window_static
    d = cfg.platform.dram
    B = queue.valid.shape[0]
    dev = queue.valid.device
    nev_kw = dict(dram=d, policy=cfg.policy, planes=tick_kw["planes"])
    acc = dram.zero_stats(d, B, dev)
    t = torch.full((B, d.n_channels), start - 1, dtype=_I32, device=dev)
    live_steps = torch.zeros((B, d.n_channels), dtype=_I32, device=dev)
    for _ in range(cfg.event_budget()):
        tn = dram.next_event(queue, banks, t, horizon, **nev_kw)
        tau = torch.clamp(tn, max=horizon - 1)
        queue, banks, s = dram.tick(queue, banks, tau,
                                    active=(tn < horizon) & (tau < end),
                                    **tick_kw)
        acc = _add_stats(acc, s)
        live_steps = live_steps + (tn < end).to(_I32)
        t = tau
    # the busiest channel's event count binds
    events = live_steps.amax(1)
    # budget exhausted with events still pending before the horizon
    # (not `end`: a pending tail arrival carries a drain update): flag
    sat = (dram.next_event(queue, banks, t, horizon, **nev_kw)
           < horizon).any(1)
    return queue, banks, acc, events, sat


def _weave_stepwise(cfg, clock, tick_kw, queue, banks, w):
    """The stepwise route: `_weave_dense` or `_weave_event`."""
    weave = _weave_dense if cfg.weave == "dense" else _weave_event
    return weave(cfg, clock, tick_kw, queue, banks, w)


def _weave_fused(cfg, clock, tick_kw, queue, banks, w):
    """The card's route: the window in one `weave_window` launch, equal
    bit for bit to `_weave_stepwise`."""
    start, end = clock.window_start_tick(w), clock.window_end_tick(w)
    event = cfg.weave == "event"
    queue, banks, st, live_steps, sat = weave_window(
        queue, banks, start=start, end=end,
        horizon=start + clock.ticks_per_window_static,
        n_steps=(cfg.event_budget() if event
                 else clock.ticks_per_window_static),
        event=event, dram=tick_kw["dram"], policy=tick_kw["policy"],
        tick2cpu_num=tick_kw["tick2cpu_num"],
        tick2cpu_den=tick_kw["tick2cpu_den"],
        cpu_ps_per_clk=tick_kw["cpu_ps_per_clk"])
    if event:
        events = live_steps.amax(1)
    else:
        events = torch.full((queue.valid.shape[0],), end - start,
                            dtype=_I32, device=queue.valid.device)
    return queue, banks, dram.TickStats(*st), events, sat.any(1)


def _weave_route(queue):
    """Card state takes the fused kernel, CPU state the stepwise loop."""
    return _weave_fused if queue.valid.device.type == "cuda" \
        else _weave_stepwise


def _bound_inject_eager(cfg, clock, wcfg, frontend, carry, w: int):
    """The eager route of the window's bound phase and interface hand-off
    (MSHR closed-loop budget, the frontend's ``bound``, ``inject_queue``,
    ``update``): ``(queue', fstate', injected, l_ir_cycles)``.  The CPU's
    route, the trace frontend's route on the card, and the
    `window_inject` kernel's plain version."""
    queue, _, fstate, l_ir, lat_est = carry
    cpu = cfg.platform.cpu
    l_ir_cycles = torch.clamp(torch.round(l_ir).to(_I32), min=1)
    window_ps = cpu.window_cycles * cpu.cpu_ps_per_clk
    budget = workload.littles_law_budget(lat_est, window_ps)
    cand, aux = frontend.bound(fstate, l_ir_cycles, budget,
                               cpu.window_cycles)
    queue, acc_demand, injected = workload.inject_queue(queue, cand, clock,
                                                        w, wcfg)
    return (queue, frontend.update(fstate, aux, acc_demand), injected,
            l_ir_cycles)


def _bound_inject_fused(cfg, clock, wcfg, frontend, carry, w: int):
    """The Mess frontend's route on the card: the same in one
    `window_inject` launch, equal bit for bit to `_bound_inject_eager`."""
    if type(frontend) is not workload.MessFrontend:
        raise NotImplementedError(
            f"{type(frontend).__name__} on the card: only the Mess "
            f"frontend has the window_inject kernel")
    queue, _, fstate, l_ir, lat_est = carry
    cpu = cfg.platform.cpu
    return window_inject(
        queue, fstate, frontend.pace, frontend.wr_num, l_ir, lat_est, w=w,
        wcfg=wcfg, clock=clock,
        mapping=addrmap.decode_route(wcfg.mapping, wcfg.dram),
        window_cycles=cpu.window_cycles,
        window_ps=cpu.window_cycles * cpu.cpu_ps_per_clk)


def _inject_route(queue, frontend):
    """The route of the bound phase and interface hand-off, by rule: CPU
    state takes the eager route; card state takes the fused kernel with
    the Mess frontend and the eager route on card tensors (the trace
    route) with the trace frontend.  Any other frontend on the card
    raises: the choice is by type, never a fallback."""
    if queue.valid.device.type != "cuda":
        return _bound_inject_eager
    if type(frontend) is workload.MessFrontend:
        return _bound_inject_fused
    # imported here: the traces package imports this module
    from repro_torch.traces.frontend import TraceFrontend
    if type(frontend) is TraceFrontend:
        return _bound_inject_eager
    raise NotImplementedError(
        f"{type(frontend).__name__} on the card: the card's bound phase "
        f"has a route for MessFrontend (window_inject) and TraceFrontend "
        f"(the trace route) only")


def _bound_inject(cfg, clock, wcfg, frontend, carry, w: int):
    """The window's bound phase and interface hand-off on the route
    `_inject_route` gives: ``(queue', fstate', injected, l_ir_cycles)``."""
    return _inject_route(carry[0], frontend)(cfg, clock, wcfg, frontend,
                                             carry, w)


def _tick_kw(cfg: StageConfig, clock: ClockModel, device) -> dict:
    """The static keywords of `dram.tick` (and of the weave routes)."""
    d = cfg.platform.dram
    return dict(dram=d, policy=cfg.policy,
                tick2cpu_num=clock.tick_to_cpu_ps_num,
                tick2cpu_den=clock.tick_to_cpu_ps_den,
                cpu_ps_per_clk=cfg.platform.cpu.cpu_ps_per_clk,
                planes=dram.bank_planes(d, device))


def _window_step(cfg: StageConfig, clock: ClockModel, wcfg: WorkloadConfig,
                 frontend, carry, w: int):
    _, banks, _, l_ir, lat_est = carry
    cpu = cfg.platform.cpu
    d = cfg.platform.dram
    queue, fstate, injected, l_ir_cycles = _bound_inject(
        cfg, clock, wcfg, frontend, carry, w)

    # weave phase
    tick_kw = _tick_kw(cfg, clock, queue.valid.device)
    queue, banks, st, events, sat = _weave_route(queue)(
        cfg, clock, tick_kw, queue, banks, w)

    n_rd = st.served_rd.sum(1, dtype=_I32)
    sum_rd_lat = st.sum_rd_lat_ticks.sum(1, dtype=_I32)
    sum_if = _ordered_sum(st.sum_if_lat_ps, 1)     # channel-index order

    # closed-loop latency estimate for the next window's MSHR budget
    n1 = torch.clamp(n_rd, min=1)
    lat_w = _fma32(sum_rd_lat / n1, d.dram_ps_per_clk,
                   torch.full_like(lat_est, float(wcfg.cache_path_cycles
                                                  * cpu.cpu_ps_per_clk)))
    lat_est = torch.where(n_rd > 0, 0.5 * lat_est + 0.5 * lat_w, lat_est)

    # PI controller (Sec. 3.4): blend in the weave-phase average latency
    if cfg.pi_latency:
        avg_if_cycles = sum_if / (cpu.cpu_ps_per_clk * n1)
        l_ir_next = torch.where(
            n_rd > 0, _fma32(l_ir, PI_KEEP, PI_BLEND * avg_if_cycles), l_ir)
    else:
        l_ir_next = l_ir

    noc_rt = wcfg.noc_req_cycles + wcfg.noc_resp_cycles
    app_lat_cycles = (wcfg.cache_path_cycles + noc_rt
                      + l_ir_cycles).to(_F32)
    ticks = clock.window_end_tick(w) - clock.window_start_tick(w)
    out = WindowOut(
        served_rd=n_rd, served_wr=st.served_wr.sum(1, dtype=_I32),
        sum_rd_lat_ticks=sum_rd_lat, sum_if_lat_ps=sum_if,
        chase_rd=st.chase_rd.sum(1, dtype=_I32),
        sum_chase_lat_ticks=st.sum_chase_lat_ticks.sum(1, dtype=_I32),
        app_lat_cycles=app_lat_cycles, l_ir=l_ir_next,
        injected=injected, ticks=torch.full_like(n_rd, ticks),
        progress=frontend.progress(fstate))
    diag = dict(weave_events=events, weave_sat=sat)
    return (queue, banks, fstate, l_ir_next, lat_est), (out, diag)


def _init_carry(cfg: StageConfig, frontend, batch: int, dev):
    """The window loop's first carry: empty queues, precharged banks,
    the frontend's initial state, ``l_ir`` and the latency estimate."""
    d = cfg.platform.dram
    queue = dram.init_queue(d, cfg.policy, n_sockets=cfg.n_sockets,
                            batch=batch, device=dev)
    banks = dram.init_banks(d, batch=batch, device=dev)
    l_ir = torch.full((batch,), cfg.l_ir_init_cycles, dtype=_F32, device=dev)
    # optimistic unloaded estimate; the EMA converges within warmup
    lat_est = torch.full(
        (batch,), float(cfg.platform.cpu.cache_path_cycles
                        * cfg.platform.cpu.cpu_ps_per_clk
                        + (d.tCL + d.tBL) * d.dram_ps_per_clk),
        dtype=_F32, device=dev)
    return (queue, banks, frontend.init_state(), l_ir, lat_est)


def run_frontend(cfg: StageConfig, frontend, *, batch: int, device=None):
    """Simulate the platform driven by any bound-phase frontend.

    Args:
        cfg: static stage configuration.
        frontend: follows the protocol of `workload.MessFrontend`; its
            tensors live on ``device`` and cover ``batch`` points.
        batch: number of operating points the frontend drives.
        device: ``None`` means ``"cuda"``.
    Returns:
        ``(views, outs)``: the aggregated three-view dict of (B,)
        tensors (see `_aggregate`) and the per-window `WindowOut`
        trajectory, each field (W, B).
    """
    dev = resolve_device(device)
    clock = cfg.clock()
    wcfg = cfg.workload_config()
    carry = _init_carry(cfg, frontend, batch, dev)
    outs, diags = [], []
    # the simulator never differentiates: skip autograd bookkeeping
    with torch.inference_mode():
        for w in range(cfg.windows):
            carry, (out, diag) = _window_step(cfg, clock, wcfg, frontend,
                                              carry, w)
            outs.append(out)
            diags.append(diag)
        outs = WindowOut(*(torch.stack(f) for f in zip(*outs)))
        diag = {k: torch.stack([x[k] for x in diags]) for k in diags[0]}
        return _aggregate(cfg, outs, diag), outs


def run_point(cfg: StageConfig, pace, wr_num, *, device=None):
    """Simulate Mess operating points; returns the three views.

    Args:
        cfg: static stage configuration.
        pace: demand requests / traffic core / window — an int or a
            sequence (one batch entry per point).
        wr_num: write-fraction numerator out of 64 — an int (shared by
            every point) or a sequence like ``pace``.
        device: ``None`` means ``"cuda"``; ``"cpu"`` runs on the CPU.
    Returns:
        The three-view dict: ``sim_bw_gbs`` / ``if_bw_gbs`` /
        ``app_bw_gbs`` (GB/s), ``sim_lat_ns`` / ``if_lat_ns`` /
        ``app_lat_ns`` / ``chase_lat_ns`` (ns), plus ``n_rd``, ``n_wr``,
        ``l_ir_final``, ``injected``, ``weave_events``, ``weave_sat``.
        Values are (B,) tensors, or 0-d when ``pace`` is an int.
    """
    dev = resolve_device(device)
    scalar = isinstance(pace, int)
    pace_t = torch.as_tensor(pace, dtype=_I32).reshape(-1).to(dev)
    wr_t = torch.as_tensor(wr_num, dtype=_I32).reshape(-1).to(dev)
    wr_t = wr_t.expand_as(pace_t).contiguous()
    frontend = workload.MessFrontend(pace_t, wr_t, cfg.workload_config())
    views, _ = run_frontend(cfg, frontend, batch=pace_t.shape[0],
                            device=dev)
    if scalar:
        views = {k: v[0] for k, v in views.items()}
    return views


def _aggregate(cfg: StageConfig, outs: WindowOut, diag):
    """Post-warmup aggregation of the three views, each (B,).

    View 1 (simulator) counts DRAM ticks x ``dram_ps_per_clk``; view 2
    (interface) CPU-perceived picoseconds; view 3 (application) CPU
    cycles of bound-phase load-to-use.  Bandwidths GB/s, latencies ns.
    """
    W = outs.l_ir.shape[0]
    dev = outs.l_ir.device
    keep = (torch.arange(W, device=dev) >= cfg.warmup)[:, None]     # (W,1)
    n_keep = max(W - cfg.warmup, 0)
    d = cfg.platform.dram
    cpu = cfg.platform.cpu

    def ksum(x):
        if x.is_floating_point():
            return _ordered_sum(torch.where(keep, x, 0.0), 0)
        return torch.where(keep, x, 0).sum(0, dtype=_I32)

    def per_point(value):
        return torch.full((outs.l_ir.shape[1],), float(value), dtype=_F32,
                          device=dev)

    n_rd = ksum(outs.served_rd)
    n_wr = ksum(outs.served_wr)
    bytes_served = (n_rd + n_wr).to(_F32) * d.line_bytes
    ticks = ksum(outs.ticks).to(_F32)
    cpu_ps = per_point(n_keep * cpu.window_cycles * cpu.cpu_ps_per_clk)
    sim_ps = ticks * d.dram_ps_per_clk
    nz = torch.clamp(n_rd, min=1).to(_F32)
    return dict(
        sim_bw_gbs=bytes_served / sim_ps * 1e3,
        sim_lat_ns=ksum(outs.sum_rd_lat_ticks).to(_F32)
        * (d.dram_ps_per_clk * 1e-3) / nz,
        if_bw_gbs=bytes_served / cpu_ps * 1e3,
        if_lat_ns=ksum(outs.sum_if_lat_ps) * 1e-3 / nz,
        app_bw_gbs=bytes_served / cpu_ps * 1e3,
        app_lat_ns=ksum(outs.app_lat_cycles) / per_point(max(n_keep, 1))
        * (cpu.cpu_ps_per_clk * 1e-3),
        n_rd=n_rd, n_wr=n_wr,
        l_ir_final=outs.l_ir[-1],
        chase_lat_ns=ksum(outs.sum_chase_lat_ticks).to(_F32)
        * (d.dram_ps_per_clk * 1e-3)
        / torch.clamp(ksum(outs.chase_rd), min=1).to(_F32),
        injected=ksum(outs.injected),
        weave_events=ksum(diag["weave_events"]),
        weave_sat=diag["weave_sat"].to(_I32).sum(0, dtype=_I32),
    )
