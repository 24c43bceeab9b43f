"""Trace-replay bound-phase frontend (the application perspective).

`TraceFrontend` plugs into `platform.run_frontend` where the Mess pace
generator does (`workload.MessFrontend`), so replayed applications run
under the same bound/weave windows, immediate-response latency, PI
controller and MSHR closed loop.

Replay model, with per-core cursors and a leading batch axis ``B`` (one
application, or one mix, per entry) where the reference maps with
``vmap``:

* a solo `Trace` batch (fields (B, L), scalars (B,)): every traffic core
  replays the same delta sequence against its own base region
  (``core * footprint``) — a multi-threaded kernel with per-core shards;
* a `TraceMix` batch (fields (B, N, L), per-core scalars (B, N)): each
  core prices its own stream — a multiprogrammed workload.

Per window each core's next `CAP_DEMAND` accesses at its cursor (one
``gather``) are priced in CPU cycles: an independent access costs the
MSHR closed-loop issue interval (``window_cycles // budget``), a
dependent one the bound-phase load-to-use latency (one probe
iteration).  The consumed prefix is the accesses whose cumulative cost
fits the window plus the core's carry.  The pointer-chase probe core
keeps running (`workload.chase_probe`).  Demand rejected by a full
channel queue is dropped, not replayed (the pace generator's policy).

The running delta sum and the phase hash wrap as the reference's int32
and uint32 do: they are carried in int64 and wrapped explicitly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import workload
from repro_torch.core.workload import (CAND, CAP_DEMAND, Candidates,
                                       WorkloadConfig)
from repro_torch.traces.mix import TraceMix
from repro_torch.traces.trace import Trace

_I32 = torch.int32
_U32 = 0xFFFFFFFF


def _wrap32(x):
    """int64 -> the int32 value with two's-complement wrap-around."""
    return (((x + (1 << 31)) & _U32) - (1 << 31)).to(_I32)


class TraceState(NamedTuple):
    pos: torch.Tensor          # (B, n_cores) int32 per-core trace cursor
    line_cum: torch.Tensor     # (B, n_cores) int32 running delta sum
    carry: torch.Tensor        # (B, n_cores) int32 leftover CPU cycles
    chase_seq: torch.Tensor    # (B,) int32 probe stream position
    chase_carry: torch.Tensor  # (B,) int32 probe loop carry


class TraceFrontend:
    """Replay a batch of application traces (or of per-core mixes)
    through the bound phase.

    ``trace`` is a batched `Trace` (``stack_traces``) or `TraceMix`
    (``stack_mixes``) on the device the platform runs on.
    """

    def __init__(self, trace: Trace | TraceMix, cfg: WorkloadConfig):
        self.trace = trace
        self.cfg = cfg
        self.is_mix = isinstance(trace, TraceMix)
        if trace.delta.dim() != (3 if self.is_mix else 2):
            raise ValueError(
                f"{type(trace).__name__} needs a leading batch axis, got "
                f"delta of shape {tuple(trace.delta.shape)}")
        if self.is_mix and trace.delta.shape[-2] != cfg.n_cores:
            raise ValueError(
                f"mix has {trace.delta.shape[-2]} cores but the platform "
                f"has {cfg.n_cores} ({cfg.n_sockets} socket(s))")

    @property
    def batch(self) -> int:
        return self.trace.delta.shape[0]

    # ---- per-core views of the trace arrays ---------------------------

    def _per_core_slice(self, pos):
        """(B, N, CAP_DEMAND) delta/write/dep slices at each cursor."""
        tr = self.trace
        idx = (pos[..., None].long()
               + torch.arange(CAP_DEMAND, device=pos.device))
        B, N = pos.shape

        def take(a):
            if not self.is_mix:
                a = a[:, None, :].expand(B, N, a.shape[-1])
            return torch.gather(a, 2, idx)

        return take(tr.delta), take(tr.is_write), take(tr.dep)

    def _targets(self):
        """(B, N) per-core access counts (0 = idle / chase core)."""
        if self.is_mix:
            return self.trace.length
        cid = torch.arange(self.cfg.n_cores, device=self.trace.length.device)
        return torch.where(cid < self.cfg.n_traffic,
                           self.trace.length[:, None], 0).to(_I32)

    def _footprints(self):
        """(B, N) per-core footprints and the (B,) region stride."""
        if self.is_mix:
            return self.trace.footprint_lines, self.trace.region_lines
        f = self.trace.footprint_lines
        return f[:, None].expand(-1, self.cfg.n_cores), f

    def init_state(self) -> TraceState:
        """Fresh per-core cursors (at each core's phase offset)."""
        dev = self.trace.delta.device
        z = torch.zeros((self.batch, self.cfg.n_cores), dtype=_I32,
                        device=dev)
        zs = torch.zeros((self.batch,), dtype=_I32, device=dev)
        if self.is_mix:
            return TraceState(pos=self.trace.pos0,
                              line_cum=self.trace.line_cum0,
                              carry=z, chase_seq=zs, chase_carry=zs)
        return TraceState(pos=z, line_cum=z, carry=z,
                          chase_seq=zs, chase_carry=zs)

    def bound(self, state: TraceState, l_ir_cycles, budget, window_cycles):
        """One window's bound phase: price and emit each core's slice.

        Args:
            state: per-core replay cursors (`TraceState`).
            l_ir_cycles: (B,) int32 immediate-response latency, CPU
                cycles.
            budget: (B,) int32 per-core MSHR closed-loop demand budget
                (`workload.littles_law_budget`).
            window_cycles: window length in CPU cycles.
        Returns:
            ``(Candidates, aux)``: the (B, n_cores, CAND) candidates
            (issue cycles within the window) and what `update` folds
            into the next state.
        """
        cfg = self.cfg
        dev = state.pos.device
        cid = torch.arange(cfg.n_cores, dtype=_I32, device=dev)[:, None]
        jj = torch.arange(CAP_DEMAND, dtype=_I32, device=dev)
        is_traffic = cid < cfg.n_traffic                          # (N,1)

        # ---- each core's next CAP_DEMAND accesses at its cursor --------
        target = self._targets()                                  # (B,N)
        pos = torch.clamp(state.pos, max=self.trace.n_slots - CAP_DEMAND)
        delta, is_wr, dep = self._per_core_slice(pos)             # (B,N,CAP)
        in_range = pos[..., None] + jj < target[..., None]

        # ---- the shared latency probe ----------------------------------
        cv, c_line, c_issue, chase_iters, chase_carry, iter_cycles = \
            workload.chase_probe(state.chase_seq, state.chase_carry,
                                 l_ir_cycles, cfg, window_cycles)
        c_valid = (cid == cfg.chase_core) & cv[:, None, :]        # (B,N,CAND)

        # ---- cycle pricing under the MSHR closed loop ------------------
        # a dep-marked access is priced like one probe iteration;
        # independents at the Little's-law issue interval
        ind_cycles = torch.clamp(
            window_cycles // torch.clamp(budget, min=1), min=1)
        cost = torch.where(dep == 1, iter_cycles[:, None, None],
                           ind_cycles[:, None, None]).to(_I32)
        fin = torch.cumsum(cost, dim=2, dtype=_I32)  # finish of the k-th
        start_c = fin - cost
        avail = (window_cycles + state.carry)[..., None]          # (B,N,1)
        take = in_range & (fin <= avail)             # prefix by monotone fin
        n_take = take.sum(2, dtype=_I32)
        used = torch.where(take, cost, 0).sum(2, dtype=_I32)
        # carry at most one window of slack; none once a stream is done
        new_carry = torch.clamp(
            torch.where(in_range.any(2), avail[..., 0] - used, 0),
            0, window_cycles).to(_I32)

        # ---- absolute lines: per-core region base + wrapped delta sum --
        # each core gets a hashed phase within its footprint, so the
        # data-parallel cores do not hit the same channel residues in
        # lockstep
        foot, region = self._footprints()
        foot = torch.clamp(foot, min=1).long()                    # (B,N)
        cum = _wrap32(state.line_cum[..., None].long()
                      + torch.cumsum(delta.long(), dim=2))
        phase = ((cid[:, 0].long() * 2654435761) & _U32) % foot   # (B,N)
        idx = torch.remainder(_wrap32(cum.long() + phase[..., None]).long(),
                              foot[..., None])                    # (B,N,CAP)
        base = (cid[:, 0].long() * region.long()[:, None]) & _U32  # (B,N)
        t_line = (base[..., None] + idx) & _U32
        t_valid = is_traffic & take
        t_issue = torch.clamp(start_c, max=window_cycles - 1)

        # pad the demand slice up to CAND slots (no prefetch slots used)
        def pad(a):
            return torch.nn.functional.pad(a, (0, CAND - CAP_DEMAND))

        cand = Candidates(
            valid=pad(t_valid) | c_valid,
            line=torch.where(is_traffic, pad(t_line), c_line[:, None, :]),
            is_write=is_traffic & (pad(is_wr) == 1),
            issue_cycle=torch.where(is_traffic, pad(t_issue),
                                    c_issue[:, None, :]).to(_I32),
            is_chase=c_valid,
            is_pf=torch.zeros_like(c_valid),
        )
        aux = dict(n_take=n_take, new_carry=new_carry,
                   line_cum_next=_wrap32(
                       state.line_cum.long()
                       + torch.where(take, delta, 0).sum(2)),
                   chase_iters=chase_iters, chase_carry=chase_carry)
        return cand, aux

    def update(self, state: TraceState, aux, acc_demand) -> TraceState:
        """Advance each cursor past the accesses consumed this window.

        ``acc_demand`` is unused: rejected demand is dropped, so the
        cursors move by the bound-phase take, not the accept count.
        """
        del acc_demand
        return TraceState(
            pos=state.pos + aux["n_take"],
            line_cum=aux["line_cum_next"],
            carry=aux["new_carry"],
            chase_seq=(state.chase_seq + aux["chase_iters"]).to(_I32),
            chase_carry=aux["chase_carry"].to(_I32),
        )

    def progress(self, state: TraceState):
        """(B, n_cores) monotone per-core trace positions (accesses
        consumed); the replay engine compares them with the per-core
        targets to find each core's completion window."""
        return state.pos
