"""Cycle-accurate DRAM device + memory-controller model (the weave backend).

Per-bank state machines with the full DDRx timing set, FR-FCFS
scheduling with open-page policy, watermark write draining, rank-aware
bus turnaround and per-rank (all-bank) or rotating per-bank (DDR5
REFsb) refresh.  Geometry and timings come from a `DramParams`.

Every tensor carries an explicit leading batch axis ``B`` (one entry per
simulated operating point): queue planes are ``(B, C, Q)``, bank planes
``(B, C, RB)``, per-channel registers ``(B, C)``.  Dynamic structures
map to static shapes: request queues are slot arrays with a ``valid``
mask, FR-FCFS is a masked argmax over a priority score, the FAW window
is a 4-deep shift register of ACT ticks.

The eligibility + FR-FCFS select block of `tick` is the ``bank_timing``
kernel (`repro_torch.kernels.bank_timing.frfcfs_select`): the gathers
that feed it stay here, the select runs in the kernel on the card (its
plain version on the CPU), and the command apply follows here.

`tick`'s two recorder flags are the reference's: ``telemetry`` returns
the step's event-accounted counter planes (`TickTele`) and threads the
`TeleState`; ``cmd_trace`` returns the step's command record
(`TickCmd`).  With both off the step is the same computation as before.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.timing import DramParams
from repro_torch.kernels.bank_timing import N_SCALARS, frfcfs_select

# command codes (REF is never selected: refresh is deadline-driven in
# `tick`; the command recorder and the legality checker use it)
NONE, RD, WR, ACT, PRE, REF = 0, 1, 2, 3, 4, 5

#: log2 latency-histogram buckets: bucket ``b`` counts values in
#: ``[2^b, 2^(b+1))``; values past the top edge clip into the last one
N_HIST = 24

_BIG = 1 << 28
_I32 = torch.int32


class BankPlanes(NamedTuple):
    """Loop-invariant index planes of one device geometry (on a device)."""

    rank_of: torch.Tensor       # (RB,) rank of each flat bank
    grp_of: torch.Tensor        # (RB,) bank group of each flat bank
    bank_in_rank: torch.Tensor  # (RB,) bank index within its rank
    bank_ids: torch.Tensor      # (RB,) flat bank index
    rank_ids: torch.Tensor      # (R,)  rank index


@functools.lru_cache(maxsize=None)
def bank_planes(dram: DramParams, device: torch.device | str = "cpu"
                ) -> BankPlanes:
    """The `BankPlanes` of one device on ``device`` (cached)."""
    RB = dram.banks_per_channel
    nbanks = dram.banks_per_rank
    bank = torch.arange(RB, dtype=_I32, device=device)
    return BankPlanes(
        rank_of=bank // nbanks,
        grp_of=(bank % nbanks) // dram.banks_per_group,
        bank_in_rank=bank % nbanks,
        bank_ids=bank,
        rank_ids=torch.arange(dram.ranks_per_channel, dtype=_I32,
                              device=device),
    )


@functools.lru_cache(maxsize=None)
def _slot_ids(q: int, device) -> torch.Tensor:
    return torch.arange(q, dtype=_I32, device=device)


@dataclasses.dataclass(frozen=True)
class SchedulerPolicy:
    """Backend-flavor knobs (Ramulator / Ramulator2 / DRAMsim3).

    ``queue_depth`` slots per channel double as the staging buffer for
    requests issued later in the window, so the depth covers a full
    window of offered traffic (23 cores x 64 req / 6 channels ~ 245).
    """

    name: str = "ramulator"
    queue_depth: int = 256
    drain_hi: int = 20             # write-drain high watermark
    drain_lo: int = 6              # write-drain low watermark
    row_hit_cap: int = 0           # 0 = pure FR-FCFS; >0 caps hit streaks
    mc_extra_ticks: int = 0        # stage-10 delay buffer (MC pipe + PHY)


class QueueState(NamedTuple):
    """Per-channel request queue; all fields (B, C, Q) int32."""

    valid: torch.Tensor
    is_write: torch.Tensor
    arrival: torch.Tensor      # DRAM tick at which the request is visible
    issue_cycle: torch.Tensor  # CPU cycle at which the core issued it
    fbank: torch.Tensor        # rank * banks_per_rank + bank
    row: torch.Tensor
    is_chase: torch.Tensor     # pointer-chase (latency-probe) request


class BankState(NamedTuple):
    """Per-bank / per-channel controller state; times in DRAM ticks."""

    open_row: torch.Tensor     # (B, C, RB) int32, -1 = precharged
    next_act: torch.Tensor     # (B, C, RB) earliest tick for ACT
    next_rd: torch.Tensor      # (B, C, RB)
    next_wr: torch.Tensor      # (B, C, RB)
    next_pre: torch.Tensor     # (B, C, RB)
    faw: torch.Tensor          # (B, C, R, 4) last four ACT ticks
    next_ref: torch.Tensor     # (B, C, R) next refresh deadline
    ref_slot: torch.Tensor     # (B, C, R) rotating REFsb bank (DDR5)
    bus_free: torch.Tensor     # (B, C) data-bus free tick
    wtr_until: torch.Tensor    # (B, C) reads blocked until
    rtw_until: torch.Tensor    # (B, C) writes blocked until
    last_rank: torch.Tensor    # (B, C) rank of last data burst
    drain: torch.Tensor        # (B, C) bool: write-drain mode
    hit_streak: torch.Tensor   # (B, C) consecutive row-hit grants


class TickStats(NamedTuple):
    """One tick's completion statistics, per channel ``(B, C)``.

    ``sum_rd_lat_ticks`` is DRAM ticks (simulator view);
    ``sum_if_lat_ps`` is CPU-perceived picoseconds (interface view,
    float32).  The weave loops add them per channel in time order.
    """

    served_rd: torch.Tensor
    served_wr: torch.Tensor
    sum_rd_lat_ticks: torch.Tensor
    sum_if_lat_ps: torch.Tensor
    chase_rd: torch.Tensor
    sum_chase_lat_ticks: torch.Tensor


def zero_stats(dram: DramParams, batch: int = 1,
               device="cpu") -> TickStats:
    """A zeroed per-channel `TickStats` accumulator."""
    zi = torch.zeros((batch, dram.n_channels), dtype=_I32, device=device)
    return TickStats(served_rd=zi, served_wr=zi, sum_rd_lat_ticks=zi,
                     sum_if_lat_ps=torch.zeros_like(zi, dtype=torch.float32),
                     chase_rd=zi, sum_chase_lat_ticks=zi)


class TickTele(NamedTuple):
    """One step's telemetry increments, per channel ``(B, C)`` unless
    noted; every field int32.

    Event counts and event-accounted time integrals only (never a
    per-step sample), so both weave engines accumulate the same window
    totals.  Row locality follows from the command mix (``hits = cas -
    act``, ``misses = act - pre``, ``conflicts = pre``).
    """

    n_act: torch.Tensor          # ACT commands issued
    n_pre: torch.Tensor          # PRE commands issued
    n_cas_rd: torch.Tensor       # read CAS (== TickStats.served_rd)
    n_cas_wr: torch.Tensor       # write CAS
    n_ref: torch.Tensor          # refresh events (per rank deadline)
    drain_enter: torch.Tensor    # write-drain service bursts entered
    drain_ticks: torch.Tensor    # drain service dwell (burst spans)
    busy_ticks: torch.Tensor     # (B, C, RB) row-open time, at row close
    hist_rd_ticks: torch.Tensor  # (B, C, N_HIST) read latency, DRAM ticks
    hist_if_ps: torch.Tensor     # (B, C, N_HIST) CPU-perceived read ps


class TeleState(NamedTuple):
    """Telemetry carry across steps and windows: each bank's last ACT
    tick (busy time accrues when the row closes) and the channel's
    current write-CAS burst (drain dwell accrues at each write grant)."""

    opened_at: torch.Tensor      # (B, C, RB) int32 tick of the last ACT
    last_wr_t: torch.Tensor      # (B, C) int32 tick of the last write CAS
    wr_burst: torch.Tensor       # (B, C) bool: the last CAS was a write


class TickCmd(NamedTuple):
    """One step's command record (``cmd_trace``), per channel ``(B, C)``.

    ``cmd`` is the granted `NONE`/`RD`/`WR`/`ACT`/`PRE`; ``t`` the
    evaluated tick; ``fbank`` the flat bank of the selected slot (slot 0
    when nothing is granted, as the reference's argmax over zero scores
    picks); ``row`` the ACT/CAS row, else -1; ``ref`` (B, C, R) bool the
    ranks whose refresh deadline fired; ``ref_bank`` (B, C, R) the
    pre-rotation REFsb bank of each firing, -1 otherwise and for
    all-bank refresh.
    """

    cmd: torch.Tensor
    t: torch.Tensor
    fbank: torch.Tensor
    row: torch.Tensor
    ref: torch.Tensor
    ref_bank: torch.Tensor


def zero_tele(dram: DramParams, batch: int = 1, device="cpu") -> TickTele:
    """A zeroed per-channel `TickTele` accumulator."""
    B, C, RB = batch, dram.n_channels, dram.banks_per_channel
    zc = torch.zeros((B, C), dtype=_I32, device=device)
    zh = torch.zeros((B, C, N_HIST), dtype=_I32, device=device)
    return TickTele(n_act=zc, n_pre=zc, n_cas_rd=zc, n_cas_wr=zc, n_ref=zc,
                    drain_enter=zc, drain_ticks=zc,
                    busy_ticks=torch.zeros((B, C, RB), dtype=_I32,
                                           device=device),
                    hist_rd_ticks=zh, hist_if_ps=zh)


def init_tele(dram: DramParams, batch: int = 1, device="cpu") -> TeleState:
    """Fresh telemetry carry (no bank opened, no write burst)."""
    B, C, RB = batch, dram.n_channels, dram.banks_per_channel
    return TeleState(
        opened_at=torch.zeros((B, C, RB), dtype=_I32, device=device),
        last_wr_t=torch.zeros((B, C), dtype=_I32, device=device),
        wr_burst=torch.zeros((B, C), dtype=torch.bool, device=device))


@functools.lru_cache(maxsize=None)
def _hist_edges(device) -> torch.Tensor:
    return torch.tensor([1 << b for b in range(1, N_HIST)], dtype=_I32,
                        device=device)


def log2_bucket(v: torch.Tensor) -> torch.Tensor:
    """``floor(log2(max(v, 1)))`` clipped to ``[0, N_HIST - 1]``, int32.

    Integer-exact (the count of powers of two 2^1..2^(N_HIST-1) at or
    below ``v``; no float log), so bucket edges land on powers of two.
    """
    v = v.to(_I32)
    return (v[..., None] >= _hist_edges(v.device)).sum(-1, dtype=_I32)


def init_queue(dram: DramParams, policy: SchedulerPolicy,
               n_sockets: int = 1, *, batch: int = 1,
               device="cpu") -> QueueState:
    """Empty request queues: (B, C, queue_depth * n_sockets) int32 slots."""
    shape = (batch, dram.n_channels, policy.queue_depth * n_sockets)
    z = torch.zeros(shape, dtype=_I32, device=device)
    return QueueState(valid=z, is_write=z, arrival=z, issue_cycle=z,
                      fbank=z, row=z - 1, is_chase=z)


def init_banks(dram: DramParams, *, batch: int = 1,
               device="cpu") -> BankState:
    """All banks precharged, refresh deadlines staggered across ranks."""
    B, C = batch, dram.n_channels
    RB, R = dram.banks_per_channel, dram.ranks_per_channel
    zi = torch.zeros((B, C, RB), dtype=_I32, device=device)
    zc = torch.zeros((B, C), dtype=_I32, device=device)
    ranks = torch.arange(R, dtype=_I32, device=device)
    return BankState(
        open_row=zi - 1,
        next_act=zi, next_rd=zi, next_wr=zi, next_pre=zi,
        faw=torch.full((B, C, R, 4), -(1 << 20), dtype=_I32, device=device),
        next_ref=(dram.tREFI + ranks * (dram.tREFI // R)).expand(
            B, C, R).contiguous(),
        ref_slot=torch.zeros((B, C, R), dtype=_I32, device=device),
        bus_free=zc, wtr_until=zc, rtw_until=zc, last_rank=zc,
        drain=torch.zeros((B, C), dtype=torch.bool, device=device),
        hit_streak=zc,
    )


def _per_channel(x, B: int, C: int, dtype, device) -> torch.Tensor:
    """A scalar, (C,) or (B, C) value as a (B, C) tensor."""
    if not isinstance(x, torch.Tensor):
        return torch.full((B, C), x, dtype=dtype, device=device)
    return x.to(device=device, dtype=dtype).expand(B, C)


def _gather(field, idx):
    """(B, C, K) field gathered per queue entry -> (B, C, Q)."""
    return torch.gather(field, 2, idx)


def tick(queue: QueueState, banks: BankState, t, *,
         dram: DramParams, policy: SchedulerPolicy,
         tick2cpu_num: int, tick2cpu_den: int, cpu_ps_per_clk: int,
         active=True, planes: BankPlanes | None = None,
         telemetry: bool = False, tele: TeleState | None = None,
         cmd_trace: bool = False):
    """Advance the memory system by one DRAM tick.

    Args:
        queue, banks: current `QueueState` / `BankState` (batched).
        t: current DRAM tick — an int, or a (B, C) / (C,) int32 tensor
            (channels are decoupled inside a window, so the event engine
            advances each channel along its own event times).
        dram, policy: static device timings + controller flavor.
        tick2cpu_num, tick2cpu_den: DRAM tick -> CPU-perceived ps
            (``cpu_ps = tick * num // den``).
        cpu_ps_per_clk: CPU picoseconds per CPU cycle.
        active: gates ticks past the window's exact tick count (inactive
            ticks grant nothing and refresh nothing; the drain flag still
            settles); bool or (B, C).
        planes: the device's `BankPlanes`; defaults to `bank_planes`.
        telemetry: also return the step's `TickTele` and the threaded
            `TeleState` (``tele``, or `init_tele`'s when None).
        tele: the telemetry carry; read only with ``telemetry=True``.
        cmd_trace: also return the step's `TickCmd`.
    Returns:
        ``(queue', banks', TickStats)``; ``telemetry=True`` appends
        ``(TickTele, TeleState)`` and ``cmd_trace=True`` a trailing
        `TickCmd` (in that order when both are on).
    """
    B, C, Q = queue.valid.shape
    dev = queue.valid.device
    nbanks = dram.banks_per_rank
    if planes is None:
        planes = bank_planes(dram, dev)
    t = _per_channel(t, B, C, _I32, dev)
    active = _per_channel(active, B, C, torch.bool, dev)
    t_r = t[..., None]
    open_row_pre = banks.open_row       # telemetry: busy at refresh close
    ref_slot_pre = banks.ref_slot       # cmd_trace: the REFsb bank

    # ---- refresh: all-bank closes the rank, REFsb one rotating bank ----
    ref_due = active[..., None] & (t_r >= banks.next_ref)          # (B,C,R)
    refmask = ref_due.repeat_interleave(nbanks, dim=2)             # (B,C,RB)
    if dram.same_bank_refresh:
        target = banks.ref_slot.repeat_interleave(nbanks, dim=2)
        refmask = refmask & (planes.bank_in_rank == target)
        ref_slot = torch.where(ref_due, (banks.ref_slot + 1) % nbanks,
                               banks.ref_slot)
    else:
        ref_slot = banks.ref_slot
    open_row = torch.where(refmask, -1, banks.open_row)
    next_act = torch.where(refmask,
                           torch.maximum(banks.next_act, t_r + dram.tRFC),
                           banks.next_act)
    next_ref = torch.where(ref_due, banks.next_ref + dram.tREFI,
                           banks.next_ref)

    # ---- write-drain hysteresis ----------------------------------------
    arrived = (queue.valid == 1) & (queue.arrival <= t_r)          # (B,C,Q)
    is_wr = queue.is_write == 1
    nw = (arrived & is_wr).sum(2)
    nr = (arrived & ~is_wr).sum(2)
    drain = torch.where(banks.drain, nw > policy.drain_lo,
                        nw >= policy.drain_hi)
    drain = drain | ((nr == 0) & (nw > 0))

    # ---- per-entry planes for the select kernel --------------------------
    fb = queue.fbank.long()
    open_e = _gather(open_row, fb)
    row_hit = open_e == queue.row
    faw_ok_rank = t_r >= banks.faw[..., 0] + dram.tFAW             # (B,C,R)
    faw_ok_e = _gather(faw_ok_rank, fb // nbanks)
    # FR-FCFS guard: a row with pending hits on the active drain side is
    # not precharged
    hit_pend = torch.zeros_like(open_row).scatter_reduce_(
        2, fb, (arrived & row_hit & (is_wr == drain[..., None])).to(_I32),
        "amax")
    # inactive ticks issue nothing: with no arrived entry every score is
    # 0, so the select yields slot 0 and NONE, as the reference's masked
    # score does
    live = arrived & active[..., None]
    scalars = torch.stack(
        [t, banks.bus_free, banks.wtr_until, banks.rtw_until,
         drain.to(_I32), banks.hit_streak]
        + [torch.zeros_like(t)] * (N_SCALARS - 6), dim=2)
    sel, cmd = frfcfs_select(
        *(x.reshape(B * C, Q) for x in (
            live.to(_I32), queue.is_write, queue.row, open_e,
            _gather(banks.next_rd, fb), _gather(banks.next_wr, fb),
            _gather(next_act, fb), _gather(banks.next_pre, fb),
            faw_ok_e.to(_I32), _gather(hit_pend, fb), queue.arrival)),
        scalars.reshape(B * C, N_SCALARS), row_hit_cap=policy.row_hit_cap)
    sel = sel.reshape(B, C)
    cmd = cmd.reshape(B, C)

    s_rd = cmd == RD
    s_wr = cmd == WR
    s_cas = s_rd | s_wr
    s_act = cmd == ACT
    s_pre = cmd == PRE
    any_cmd = cmd != NONE
    sel_i = sel.long()[..., None]

    def pick(field):
        return torch.gather(field, 2, sel_i)[..., 0]

    s_fb = pick(queue.fbank)
    s_row = pick(queue.row)
    s_arr = pick(queue.arrival)
    s_issue = pick(queue.issue_cycle)
    s_chase = pick(queue.is_chase) == 1
    s_rank = s_fb // nbanks
    s_bg = (s_fb % nbanks) // dram.banks_per_group

    # ---- apply the selected command per channel -------------------------
    at_sel = planes.bank_ids == s_fb[..., None]                    # (B,C,RB)
    same_rank = planes.rank_of == s_rank[..., None]
    same_grp = (planes.grp_of == s_bg[..., None]) & same_rank
    act_c = s_act[..., None]
    act_sel = at_sel & act_c

    # ACT
    open_row = torch.where(act_sel, s_row[..., None], open_row)
    nact = torch.where(act_c & same_rank,
                       torch.maximum(next_act, t_r + dram.tRRD_S), next_act)
    nact = torch.where(act_c & same_grp,
                       torch.maximum(nact, t_r + dram.tRRD_L), nact)
    nact = torch.where(act_sel, torch.maximum(nact, t_r + dram.tRC), nact)
    nrd = torch.where(act_sel, t_r + dram.tRCD, banks.next_rd)
    nwr = torch.where(act_sel, t_r + dram.tRCD, banks.next_wr)
    npre = torch.where(act_sel, t_r + dram.tRAS, banks.next_pre)
    # FAW shift-register push on the activated rank
    faw_new = torch.cat([banks.faw[..., 1:],
                         t[..., None, None].expand_as(banks.faw[..., :1])],
                        dim=3)
    act_rank = (planes.rank_ids == s_rank[..., None]) & act_c      # (B,C,R)
    faw = torch.where(act_rank[..., None], faw_new, banks.faw)

    # CAS (RD/WR): bus + tCCD (bank-group aware, channel-wide) + turnaround
    burst = dram.tBL + (s_rank != banks.last_rank).to(_I32) * dram.tRTRS
    bus_free = torch.where(s_cas, t + burst, banks.bus_free)
    last_rank = torch.where(s_cas, s_rank, banks.last_rank)
    ccd = dram.tCCD_S + same_grp.to(_I32) * (dram.tCCD_L - dram.tCCD_S)
    cas_c = s_cas[..., None]
    nrd = torch.where(cas_c, torch.maximum(nrd, t_r + ccd), nrd)
    nwr = torch.where(cas_c, torch.maximum(nwr, t_r + ccd), nwr)
    npre = torch.where(at_sel & s_rd[..., None],
                       torch.maximum(npre, t_r + dram.tRTP), npre)
    npre = torch.where(at_sel & s_wr[..., None],
                       torch.maximum(npre, t_r + (dram.tCWL + dram.tBL
                                                  + dram.tWR)), npre)
    wtr_until = torch.where(s_wr, t + (dram.tCWL + dram.tBL + dram.tWTR_L),
                            banks.wtr_until)
    rtw_until = torch.where(s_rd, t + (dram.tCL + dram.tBL + dram.tRTRS
                                       - dram.tCWL), banks.rtw_until)

    # PRE
    pre_sel = at_sel & s_pre[..., None]
    open_row = torch.where(pre_sel, -1, open_row)
    nact = torch.where(pre_sel, torch.maximum(nact, t_r + dram.tRP), nact)

    hit_streak = torch.where(s_cas, banks.hit_streak + 1,
                             torch.where(any_cmd, 0, banks.hit_streak))

    banks = BankState(open_row=open_row, next_act=nact, next_rd=nrd,
                      next_wr=nwr, next_pre=npre, faw=faw, next_ref=next_ref,
                      ref_slot=ref_slot, bus_free=bus_free,
                      wtr_until=wtr_until, rtw_until=rtw_until,
                      last_rank=last_rank, drain=drain,
                      hit_streak=hit_streak)

    # retire CAS'd entries
    served = (_slot_ids(Q, dev) == sel[..., None]) & cas_c
    queue = queue._replace(valid=torch.where(served, 0, queue.valid))

    # ---- stats ------------------------------------------------------------
    done_t = t + (dram.tCL + dram.tBL + policy.mc_extra_ticks)
    rd_lat = done_t - s_arr                                         # ticks
    if_lat_i = (done_t * tick2cpu_num // tick2cpu_den
                - s_issue * cpu_ps_per_clk)                         # ps
    s_chase_rd = s_rd & s_chase
    stats = TickStats(
        served_rd=s_rd.to(_I32),
        served_wr=s_wr.to(_I32),
        sum_rd_lat_ticks=torch.where(s_rd, rd_lat, 0),
        sum_if_lat_ps=torch.where(s_rd, if_lat_i.to(torch.float32), 0.0),
        chase_rd=s_chase_rd.to(_I32),
        sum_chase_lat_ticks=torch.where(s_chase_rd, rd_lat, 0),
    )
    if not telemetry and not cmd_trace:
        return queue, banks, stats

    extras = ()
    if telemetry:
        # accounted at events (grants, refresh deadlines, row closes),
        # never sampled per step, so both engines give the same planes
        if tele is None:
            tele = init_tele(dram, B, dev)
        # row-open time when the row closes: a refresh over an open row,
        # or a PRE of the selected bank (ACT and PRE never share a step)
        busy = torch.where(refmask & (open_row_pre >= 0),
                           t_r - tele.opened_at, 0)
        opened_at = torch.where(act_sel, t_r, tele.opened_at)
        busy = busy + torch.where(pre_sel, t_r - opened_at, 0)
        # a maximal run of write CAS is one drain burst; its dwell (first
        # to last write grant, plus one burst) accrues at each write
        enter = s_wr & ~tele.wr_burst
        dwell = torch.where(s_wr, torch.where(tele.wr_burst,
                                              t - tele.last_wr_t, dram.tBL),
                            0)
        last_wr_t = torch.where(s_wr, t, tele.last_wr_t)
        wr_burst = torch.where(s_cas, s_wr, tele.wr_burst)
        hist = torch.arange(N_HIST, dtype=_I32, device=dev)
        rd_c = s_rd[..., None]
        tele_inc = TickTele(
            n_act=s_act.to(_I32), n_pre=s_pre.to(_I32),
            n_cas_rd=s_rd.to(_I32), n_cas_wr=s_wr.to(_I32),
            n_ref=ref_due.sum(2, dtype=_I32),
            drain_enter=enter.to(_I32), drain_ticks=dwell.to(_I32),
            busy_ticks=busy.to(_I32),
            hist_rd_ticks=(rd_c & (log2_bucket(rd_lat)[..., None] == hist))
            .to(_I32),
            hist_if_ps=(rd_c & (log2_bucket(if_lat_i)[..., None] == hist))
            .to(_I32))
        extras = (tele_inc, TeleState(opened_at, last_wr_t, wr_burst))
    if cmd_trace:
        no_bank = torch.full_like(ref_slot_pre, -1)
        extras += (TickCmd(
            cmd=cmd.to(_I32), t=t, fbank=s_fb,
            row=torch.where(s_act | s_cas, s_row, -1),
            ref=ref_due,
            ref_bank=(torch.where(ref_due, ref_slot_pre, no_bank)
                      if dram.same_bank_refresh else no_bank)),)
    return (queue, banks, stats) + extras


def next_event(queue: QueueState, banks: BankState, t, end: int, *,
               dram: DramParams, policy: SchedulerPolicy,
               planes: BankPlanes | None = None):
    """The exact event horizon: earliest tick > ``t`` where `tick` can act.

    Evaluated on the post-tick state at ``t``, per channel: the next
    arrival, a forced ``t + 1`` when the drain hysteresis would flip,
    the earliest CAS / ACT / PRE readiness of an issuable entry on the
    settled drain side, and the next refresh deadline, clamped into
    ``[t + 1, end]``.  Returns (B, C) int32.
    """
    B, C, Q = queue.valid.shape
    dev = queue.valid.device
    nbanks = dram.banks_per_rank
    t = _per_channel(t, B, C, _I32, dev)
    t_r = t[..., None]

    valid = queue.valid == 1
    arrived = valid & (queue.arrival <= t_r)
    is_wr = queue.is_write == 1

    pending = valid & (queue.arrival > t_r)
    ev = torch.where(pending, queue.arrival, _BIG).amin(2)

    nw = (arrived & is_wr).sum(2)
    nr = (arrived & ~is_wr).sum(2)
    drain = torch.where(banks.drain, nw > policy.drain_lo,
                        nw >= policy.drain_hi)
    drain = drain | ((nr == 0) & (nw > 0))
    ev = torch.minimum(ev, torch.where(drain != banks.drain, t + 1, _BIG))
    drain_c = drain[..., None]

    fb = queue.fbank.long()
    open_e = _gather(banks.open_row, fb)
    row_hit = open_e == queue.row
    closed = open_e < 0
    side_ok = torch.where(is_wr, drain_c, ~drain_c)

    cas_ready = torch.where(
        is_wr,
        torch.maximum(_gather(banks.next_wr, fb), banks.rtw_until[..., None]),
        torch.maximum(_gather(banks.next_rd, fb), banks.wtr_until[..., None]))
    cas_ready = torch.maximum(cas_ready, banks.bus_free[..., None])
    ev = torch.minimum(ev, torch.where(arrived & row_hit & side_ok,
                                       cas_ready, _BIG).amin(2))

    faw_ready = banks.faw[..., 0] + dram.tFAW                      # (B,C,R)
    act_ready = torch.maximum(_gather(banks.next_act, fb),
                              _gather(faw_ready, fb // nbanks))
    ev = torch.minimum(ev, torch.where(arrived & closed & side_ok,
                                       act_ready, _BIG).amin(2))

    hit_pend = torch.zeros_like(banks.open_row).scatter_reduce_(
        2, fb, (arrived & row_hit & (is_wr == drain_c)).to(_I32), "amax")
    elig_pre = (arrived & ~closed & ~row_hit & side_ok
                & (_gather(hit_pend, fb) == 0))
    ev = torch.minimum(ev, torch.where(elig_pre, _gather(banks.next_pre, fb),
                                       _BIG).amin(2))

    ev = torch.minimum(ev, banks.next_ref.amin(2))
    return torch.clamp(torch.maximum(ev, t + 1), max=end)


# ---- state carried across from the reference (numpy) ---------------------

#: unbatched rank of each state field (a leading batch axis adds one)
_QUEUE_RANK = dict.fromkeys(QueueState._fields, 2)
_BANK_RANK = dict(open_row=2, next_act=2, next_rd=2, next_wr=2, next_pre=2,
                  faw=3, next_ref=2, ref_slot=2, bus_free=1, wtr_until=1,
                  rtw_until=1, last_rank=1, drain=1, hit_streak=1)


def _to_tensor(a, rank, device):
    a = np.ascontiguousarray(a)
    if a.ndim == rank:
        a = a[None]
    dtype = torch.bool if a.dtype == np.bool_ else _I32
    return torch.as_tensor(a.astype(np.bool_ if dtype == torch.bool
                                    else np.int32)).to(device)


def state_from_numpy(queue: dict, banks: dict, device="cpu"):
    """Reference ``QueueState``/``BankState`` fields (numpy) -> port state.

    Unbatched fields (``(C, Q)``, ``(C, RB)``, ...) gain a batch axis of
    one; batched ones keep theirs.
    """
    q = QueueState(**{k: _to_tensor(queue[k], _QUEUE_RANK[k], device)
                      for k in QueueState._fields})
    b = BankState(**{k: _to_tensor(banks[k], _BANK_RANK[k], device)
                     for k in BankState._fields})
    return q, b


def state_to_numpy(queue: QueueState, banks: BankState,
                   batched: bool = True):
    """Port state -> dicts of numpy arrays (inverse of `state_from_numpy`).

    ``batched=False`` drops the batch axis of a one-point state.
    """
    def conv(x):
        a = x.detach().cpu().numpy()
        return a if batched else a[0]

    return ({k: conv(v) for k, v in queue._asdict().items()},
            {k: conv(v) for k, v in banks._asdict().items()})
