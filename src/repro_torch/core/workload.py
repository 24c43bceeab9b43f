"""Mess-style workload generation and request injection (bound phase).

N-1 traffic-generator cores sweep the used bandwidth at a controlled
pace and read/write mix while one pointer-chase core measures the
load-to-use latency.  Per window this module generates every core's
candidate requests and injects them into the per-channel queues.

Issue cycles are computed against the *immediate-response* latency
(1 CPU cycle in the DAMOV baseline, PI-controlled from stage 04): the
bound-phase decoupling the paper analyzes.  Traffic streams are
64-line sequential segments at hashed bases; a full queue turns excess
demand into a per-core backlog; the stage-07 stride prefetcher adds
overfetch traffic at the traffic cores only.

Every tensor has a leading batch axis ``B`` (one operating point per
entry).  Line indices are int64 holding uint32 values: the reference's
uint32 wrap-around becomes ``& 0xFFFFFFFF``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import addrmap
from repro_torch.core.dram import QueueState
from repro_torch.core.timing import DramParams

N_CORES_PER_SOCKET = 24
N_CORES = N_CORES_PER_SOCKET
CAP_DEMAND = 64            # max demand candidates / core / window
CAP_PF = 16                # max prefetch candidates / core / window
CAND = CAP_DEMAND + CAP_PF
SEGMENT_LINES = 64         # traffic stream segment length
BACKLOG_MAX = 192
CHASE_REGION_BITS = 26     # 4 GB pointer-chase region
#: per-core outstanding-miss bound (Skylake L2 superqueue): the closed loop
MSHR_CAP = 24

_I32 = torch.int32
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Bound-phase knobs shared by every frontend.

    ``n_sockets`` adds 24 cores per socket (one shared chase probe on
    the last core); ``socket_channels`` is ``"interleaved"`` (every
    socket addresses every channel) or ``"partitioned"`` (each socket
    owns ``n_channels / n_sockets`` channels).
    """

    mapping: str = "simple"
    prefetch: bool = False
    pf_shift: int = 2          # extra pf traffic = quota >> pf_shift (25%)
    cache_path_cycles: int = 50
    noc_req_cycles: int = 0
    noc_resp_cycles: int = 0
    dram: DramParams = dataclasses.field(default_factory=DramParams)
    n_sockets: int = 1
    socket_channels: str = "interleaved"

    def __post_init__(self):
        if self.socket_channels not in ("interleaved", "partitioned"):
            raise ValueError(
                f"socket_channels must be 'interleaved' or 'partitioned', "
                f"got {self.socket_channels!r}")
        if self.n_sockets < 1:
            raise ValueError(f"n_sockets must be >= 1, got {self.n_sockets}")

    @property
    def n_cores(self) -> int:
        return N_CORES_PER_SOCKET * self.n_sockets

    @property
    def n_traffic(self) -> int:
        return self.n_cores - 1

    @property
    def chase_core(self) -> int:
        return self.n_cores - 1


class CoreState(NamedTuple):
    seq: torch.Tensor          # (B, N) per-core stream position
    backlog: torch.Tensor      # (B, N) pending ungranted demand
    chase_carry: torch.Tensor  # (B,) leftover CPU cycles of the chase loop


def init_cores(n_cores: int = N_CORES, *, batch: int = 1,
               device="cpu") -> CoreState:
    z = torch.zeros((batch, n_cores), dtype=_I32, device=device)
    return CoreState(seq=z, backlog=z,
                     chase_carry=torch.zeros((batch,), dtype=_I32,
                                             device=device))


def littles_law_budget(lat_est_ps, window_ps) -> torch.Tensor:
    """Per-core per-window demand budget ``MSHR_CAP * window / latency``.

    float32 throughout, truncated to int32 like the reference.
    """
    lat = torch.clamp(lat_est_ps, min=1.0)
    # a tensor numerator: ``number / tensor`` would multiply by the
    # reciprocal, which is not the reference's true division
    num = torch.full_like(lat, float(MSHR_CAP * window_ps))
    return torch.clamp(num / lat, min=1.0).to(_I32)


def _mul_u32(x, m: int):
    """``(x * m) mod 2**32`` for int64 ``x`` in [0, 2**32), no overflow."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _lcg(x):
    return (_mul_u32(x & _U32, 2654435761) + 0x9E3779B9) & _U32


def _segment_line(core, k):
    """Traffic stream: 64-line sequential segments at hashed bases."""
    core = core.to(torch.int64)
    k = k.to(torch.int64)
    seg = k >> 6
    h = _lcg((_mul_u32(seg, 31) + core * 97) & _U32)
    return ((core << 22) | ((h & 0xFFFF) << 6) | (k & 63)) & _U32


def _chase_line(k):
    h = _lcg(_lcg(k.to(torch.int64) & _U32))
    return (1 << 31) | (h >> (32 - CHASE_REGION_BITS))


class Candidates(NamedTuple):
    """(B, n_cores, CAND) candidate requests for one window."""

    valid: torch.Tensor        # bool
    line: torch.Tensor         # int64 cache-line index in [0, 2**32)
    is_write: torch.Tensor     # bool
    issue_cycle: torch.Tensor  # int32 within-window CPU cycle
    is_chase: torch.Tensor     # bool
    is_pf: torch.Tensor        # bool: speculative prefetch (not demand)


def chase_probe(seq, carry, l_ir_cycles, cfg: WorkloadConfig,
                window_cycles):
    """Pointer-chase latency probe: one window of serialized loads.

    ``seq``, ``carry``, ``l_ir_cycles``: (B,) int32.  Returns
    ``(valid, line, issue, iters, new_carry, iter_cycles)`` with the
    first three (B, CAND).
    """
    j = torch.arange(CAND, dtype=_I32, device=seq.device)
    noc_rt = cfg.noc_req_cycles + cfg.noc_resp_cycles
    iter_cycles = torch.clamp(cfg.cache_path_cycles + noc_rt + l_ir_cycles,
                              min=1)
    budget = window_cycles + carry
    iters = torch.clamp(budget // iter_cycles, max=CAND)
    new_carry = budget - iters * iter_cycles
    valid = j < iters[:, None]
    line = _chase_line(seq[:, None] + j)
    issue = j * iter_cycles[:, None]
    return valid, line, issue, iters, new_carry, iter_cycles


def generate(cores: CoreState, pace, wr_num, l_ir_cycles,
             cfg: WorkloadConfig, window_cycles: int = 1000,
             budget=CAP_DEMAND):
    """Bound phase: all cores' candidate requests for one window.

    ``pace``, ``wr_num``, ``l_ir_cycles``, ``budget``: (B,) int32 —
    demand per traffic core per window, write numerator out of 64, the
    immediate-response latency and the MSHR closed-loop cap.  Returns
    ``(Candidates, aux)``.
    """
    dev = cores.seq.device
    n_cores = cfg.n_cores
    cid = torch.arange(n_cores, dtype=_I32, device=dev)[:, None]   # (N,1)
    j = torch.arange(CAND, dtype=_I32, device=dev)                  # (CAND,)
    is_traffic = cid < cfg.n_traffic                                # (N,1)
    budget = torch.as_tensor(budget, dtype=_I32, device=dev)

    # ---- traffic demand (closed loop: capped by the MSHR budget) --------
    want = pace[:, None] + cores.backlog                            # (B,N)
    quota = torch.minimum(torch.clamp(want, max=CAP_DEMAND),
                          budget.reshape(-1, 1))                    # (B,N)
    quota_c = quota[..., None]                                      # (B,N,1)
    k = cores.seq[..., None] + j                                    # (B,N,CAND)
    t_valid = is_traffic & (j < quota_c)
    t_line = _segment_line(cid, k)
    wr = wr_num[:, None, None]
    t_write = ((k + 1) * wr) // 64 - (k * wr) // 64 > 0
    t_issue = j * window_cycles // torch.clamp(quota_c, min=1)

    # ---- stride-prefetcher extra traffic (stage 07) ----------------------
    pf_valid = torch.zeros_like(t_valid)
    if cfg.prefetch:
        pf_quota = torch.clamp(quota >> cfg.pf_shift, max=CAP_PF)[..., None]
        jp = j - CAP_DEMAND
        pf_valid = is_traffic & (jp >= 0) & (jp < pf_quota)
        pf_line = _segment_line(cid, cores.seq[..., None] + quota_c + jp)
        t_valid = t_valid | pf_valid
        t_line = torch.where(pf_valid, pf_line, t_line)
        t_write = t_write & ~pf_valid
        t_issue = torch.where(
            pf_valid, jp * window_cycles // torch.clamp(pf_quota, min=1),
            t_issue)

    # ---- pointer chase (the latency probe) -------------------------------
    cv, c_line, c_issue, chase_iters, chase_carry, iter_cycles = chase_probe(
        cores.seq[:, cfg.chase_core], cores.chase_carry, l_ir_cycles, cfg,
        window_cycles)
    c_valid = (cid == cfg.chase_core) & cv[:, None, :]

    cand = Candidates(
        valid=(t_valid & is_traffic) | c_valid,
        line=torch.where(is_traffic, t_line, c_line[:, None, :]),
        is_write=t_write & is_traffic,
        issue_cycle=torch.where(is_traffic, t_issue,
                                c_issue[:, None, :]).to(_I32),
        is_chase=c_valid,
        is_pf=pf_valid & is_traffic,
    )
    aux = dict(quota=quota, want=want, chase_iters=chase_iters,
               chase_carry=chase_carry, iter_cycles=iter_cycles)
    return cand, aux


def inject_queue(queue: QueueState, cand: Candidates, clock, w: int,
                 cfg: WorkloadConfig):
    """Scatter candidates into per-channel queue slots (bounded admit).

    Admission is chase-first, then issue order, then core id, into each
    channel's free slots (invalid-first).  Returns ``(queue',
    acc_demand, n_accepted)``: (B, n_cores) accepted demand per core and
    (B,) accepted requests.
    """
    B, C, Q = queue.valid.shape
    dev = queue.valid.device
    n_cores = cand.valid.shape[1]
    n = n_cores * CAND
    flat = Candidates(*(x.reshape(B, n) for x in cand))
    core_of = torch.arange(n_cores, dtype=_I32,
                           device=dev).repeat_interleave(CAND)      # (n,)

    dec = addrmap.decode(flat.line, cfg.mapping, dram=cfg.dram)
    channel = dec.channel
    if cfg.n_sockets > 1 and cfg.socket_channels == "partitioned":
        if C % cfg.n_sockets:
            raise ValueError(
                f"partitioned ownership needs n_channels ({C}) divisible "
                f"by n_sockets ({cfg.n_sockets})")
        cps = C // cfg.n_sockets
        channel = (core_of // N_CORES_PER_SOCKET) * cps + channel % cps
    ch = torch.where(flat.valid, channel, C)              # invalid -> ch C
    # admission key: chase first, then issue order, then core id (the
    # core stride 64 covers two sockets)
    key = ((1 - flat.is_chase.to(_I32)) * (1 << 24)
           + flat.issue_cycle * 64 + core_of)
    order = torch.argsort(ch * (1 << 26) + key, dim=1, stable=True)
    ch_s = torch.gather(ch, 1, order)
    ch_l = ch_s.long()

    counts = torch.zeros((B, C + 1), dtype=_I32, device=dev).scatter_add_(
        1, ch_l, torch.ones_like(ch_s))
    start = torch.cumsum(counts, dim=1, dtype=_I32) - counts
    r = (torch.arange(n, dtype=_I32, device=dev)
         - torch.gather(start, 1, ch_l))                  # rank in channel

    # free queue slots, invalid-first
    free_order = torch.argsort(queue.valid, dim=2, stable=True)     # (B,C,Q)
    n_free = Q - queue.valid.sum(2, dtype=_I32)                     # (B,C)
    ch_c = torch.clamp(ch_l, max=C - 1)
    accepted = (ch_s < C) & (r < torch.gather(n_free, 1, ch_c))
    free_at = torch.gather(free_order.reshape(B, C * Q), 1,
                           ch_c * Q + torch.clamp(r, max=Q - 1).long())
    # flat slot index; rejected requests land in a drop slot at C * Q
    dest = torch.where(accepted, ch_c * Q + free_at, C * Q)

    issue_s = torch.gather(flat.issue_cycle, 1, order)
    arrival_cycle = (w * clock.window_cycles + issue_s
                     + (cfg.cache_path_cycles + cfg.noc_req_cycles))
    arrival_tick = clock.cycle_to_tick(arrival_cycle)
    issue_abs = w * clock.window_cycles + issue_s

    def put(qf, val):
        buf = torch.cat([qf.reshape(B, C * Q),
                         qf.new_zeros((B, 1))], dim=1)
        buf.scatter_(1, dest, val.to(qf.dtype))
        # contiguous, so the weave steps hand the planes to the kernel as
        # they are
        return buf[:, :C * Q].reshape(B, C, Q).contiguous()

    def sorted_(x):
        return torch.gather(x, 1, order)

    queue = QueueState(
        valid=put(queue.valid, torch.ones_like(ch_s)),
        is_write=put(queue.is_write, sorted_(flat.is_write)),
        arrival=put(queue.arrival, arrival_tick),
        issue_cycle=put(queue.issue_cycle, issue_abs),
        fbank=put(queue.fbank, sorted_(dec.flat_bank_for(cfg.dram))),
        row=put(queue.row, sorted_(dec.row)),
        is_chase=put(queue.is_chase, sorted_(flat.is_chase)),
    )

    demand = (accepted & ~sorted_(flat.is_pf)).to(_I32)
    acc_demand = torch.zeros((B, n_cores), dtype=_I32,
                             device=dev).scatter_add_(
        1, core_of.long()[order], demand)
    return queue, acc_demand, accepted.sum(1, dtype=_I32)


class MessFrontend:
    """The Mess pace generator as a pluggable bound-phase frontend.

    Protocol (duck-typed): ``init_state()``, ``bound(state, l_ir_cycles,
    budget, window_cycles) -> (Candidates, aux)``, ``update(state, aux,
    acc_demand)`` and ``progress(state)``.  ``pace`` and ``wr_num`` are
    (B,) int32 tensors: one frontend drives a batch of operating points.
    """

    def __init__(self, pace, wr_num, cfg: WorkloadConfig):
        self.pace = pace
        self.wr_num = wr_num
        self.cfg = cfg

    def init_state(self) -> CoreState:
        return init_cores(self.cfg.n_cores, batch=self.pace.shape[0],
                          device=self.pace.device)

    def bound(self, state: CoreState, l_ir_cycles, budget, window_cycles):
        return generate(state, self.pace, self.wr_num, l_ir_cycles,
                        self.cfg, window_cycles, budget)

    def update(self, state: CoreState, aux, acc_demand) -> CoreState:
        traffic = torch.arange(self.cfg.n_cores,
                               device=acc_demand.device) < self.cfg.n_traffic
        demanded = torch.where(traffic, aux["want"], 0)
        backlog = torch.clamp(
            demanded - torch.minimum(acc_demand, demanded), 0, BACKLOG_MAX)
        seq = state.seq + torch.where(traffic, aux["quota"],
                                      aux["chase_iters"][:, None])
        return CoreState(seq=seq.to(_I32), backlog=backlog,
                         chase_carry=aux["chase_carry"])

    def progress(self, state: CoreState):
        return torch.zeros(state.seq.shape[0], dtype=_I32,
                           device=state.seq.device)
