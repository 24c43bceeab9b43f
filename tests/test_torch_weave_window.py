"""The whole-window weave kernel (`kernels.weave_window`) and its route.

On the CPU: the route rule (CPU state takes the stepwise loop), the
wrapper's refusals, its packing (fresh outputs that share no storage
with the inputs; the parameter vector in the order the kernel reads it),
and a numpy emulation of the kernel's restructured step for one row
(registers per slot, per-bank pending-hit flags, warp-ballot counts, the
64-bit argmax key, ``next_event`` as one block minimum) held bit for bit
against the stepwise `dram.tick` / `next_event` loops over a few windows
on ddr4, ddr5 and hbm2e, with ``row_hit_cap`` 0 and 4, both engines.

On the card (``gpu``): the fused route against the stepwise route over
the same case matrix, and ``run_point`` on the card against the CPU.
``python -m pytest -m gpu tests/test_torch_weave_window.py`` runs them
on a machine with a card.
"""
import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import dram, platform, workload
from repro_torch.core.backends import make_policy
from repro_torch.core.presets import PRESETS
from repro_torch.core.stages import get_stage
from repro_torch.core.timing import PlatformParams
from repro_torch.kernels.weave_window import (MAX_Q, PARAM_NAMES,
                                              pack_inputs, pack_params,
                                              weave_window)
from repro_torch.kernels.weave_window.ops import (N_HIST, TELE_COUNTERS,
                                                  pack_recorder)

torch.set_num_threads(1)

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "csrc" / "weave_window.cu")
BIG = 1 << 28
NONE, RD, WR, ACT, PRE = 0, 1, 2, 3, 4
MASK32 = 0xFFFFFFFF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _w32(x: int) -> int:
    """Python int -> int32 with wrap-around."""
    x &= MASK32
    return x - (1 << 32) if x >= 1 << 31 else x


def _stage(preset, backend="ramulator", *, window_cycles=200, **kw):
    """Stage 07 on ``preset`` with a short window (fewer DRAM ticks)."""
    cfg = get_stage("07-prefetch", preset=preset, **kw)
    cpu = dataclasses.replace(cfg.platform.cpu, window_cycles=window_cycles)
    policy = (make_policy("ramulator", delay_buffer=True)
              if backend == "delay" else make_policy(backend))
    return dataclasses.replace(
        cfg, policy=policy,
        platform=PlatformParams(cpu=cpu, dram=cfg.platform.dram))


# ---- the route and the wrapper -------------------------------------------

def test_route_rule_cpu_takes_stepwise():
    cfg = get_stage("07-prefetch", windows=2, warmup=0)
    q = dram.init_queue(cfg.platform.dram, cfg.policy)
    assert platform._weave_route(q) is platform._weave_stepwise
    kernels.reset_launch_counts()
    out = platform.run_point(cfg, [4], 16, device="cpu")
    assert kernels.launch_counts()["weave_window"] == 0
    assert weave_window.steps == 0
    assert int(out["n_rd"][0]) > 0


def _raises_for(dram_params, policy, n_sockets=1, match="card only"):
    q = dram.init_queue(dram_params, policy, n_sockets=n_sockets)
    b = dram.init_banks(dram_params)
    with pytest.raises(ValueError, match=match):
        weave_window(q, b, start=0, end=10, horizon=12, n_steps=12,
                     event=False, dram=dram_params, policy=policy,
                     tick2cpu_num=750, tick2cpu_den=1, cpu_ps_per_clk=476)


def test_wrapper_raises_on_cpu_and_unsized_shapes():
    d = PRESETS["ddr4_2666"]
    pol = make_policy("ramulator")
    _raises_for(d, pol)                                    # CPU tensors
    _raises_for(d, pol, n_sockets=2)                       # Q = 512 sized
    _raises_for(d, dataclasses.replace(pol, queue_depth=1040),
                match="queue slots")                       # Q > 1024
    _raises_for(d, dataclasses.replace(pol, queue_depth=2 * MAX_Q),
                match="queue slots")                       # Q = 1024
    _raises_for(d, dataclasses.replace(pol, queue_depth=100),
                match="queue slots")                       # not 32k
    wide = dataclasses.replace(d, ranks_per_channel=4, banks_per_rank=32,
                               bank_groups=8)             # RB = 128
    _raises_for(wide, pol, match="banks")
    q = dram.init_queue(d, pol)
    b = dram.init_banks(d)
    with pytest.raises(ValueError, match="runs on cuda"):
        weave_window(*(x._make(t.to("meta") for t in x) for x in (q, b)),
                     start=0, end=10, horizon=12, n_steps=12, event=False,
                     dram=d, policy=pol, tick2cpu_num=750, tick2cpu_den=1,
                     cpu_ps_per_clk=476)


def _storages(tensors):
    return {t.untyped_storage().data_ptr() for t in tensors}


@pytest.mark.parametrize("preset,sockets", [("ddr4_2666", 1),
                                            ("ddr5_4800", 2), ("hbm2e", 1)])
def test_outputs_share_no_storage_with_inputs(preset, sockets):
    d = PRESETS[preset]
    q = dram.init_queue(d, make_policy("ramulator"), n_sockets=sockets,
                        batch=3)
    b = dram.init_banks(d, batch=3)
    # init_queue gives one tensor to six fields: the inputs alias
    assert len(_storages(q)) < len(q)
    inp, out = pack_inputs(q, b)
    state = _storages(list(q) + list(b))
    packed_in = _storages(inp.values())
    packed_out = _storages(out.values())
    assert len(packed_out) == len(out)           # no two outputs share
    assert not packed_out & (state | packed_in)
    assert not packed_in & state
    # the packed inputs carry the state as it is
    assert torch.equal(inp["queue"][5], q.row)
    assert torch.equal(inp["refresh"][0], b.next_ref)
    assert torch.equal(inp["channel"][4], b.drain.to(torch.int32))
    assert inp["queue"].shape == (7, 3, d.n_channels, 256 * sockets)
    assert inp["banks"].shape == (5, 3, d.n_channels, d.banks_per_channel)


def test_param_vector_matches_fields_and_kernel_order():
    src = CSRC.read_text()
    block = src.split("Packed parameter vector")[1].split("#include")[0]
    names = re.findall(r"[A-Za-z_][A-Za-z0-9_]*", block.split(":", 1)[1])
    assert tuple(names) == PARAM_NAMES
    struct = src.split("struct Params {")[1].split("};")[0]
    assert tuple(re.findall(r"([A-Za-z_][A-Za-z0-9_]*)[,;]", struct)) \
        == PARAM_NAMES
    assert f"kNParams = {len(PARAM_NAMES)}" in src
    for preset, backend in (("ddr4_2666", "ramulator"),
                            ("ddr5_4800", "ramulator2"), ("hbm2e", "delay")):
        cfg = _stage(preset, backend)
        clock = cfg.clock()
        d, pol = cfg.platform.dram, cfg.policy
        got = pack_params(d, pol, tick2cpu_num=clock.tick_to_cpu_ps_num,
                          tick2cpu_den=clock.tick_to_cpu_ps_den,
                          cpu_ps_per_clk=cfg.platform.cpu.cpu_ps_per_clk)
        want = dict(
            tCL=d.tCL, tRCD=d.tRCD, tRP=d.tRP, tRAS=d.tRAS, tBL=d.tBL,
            tCCD_S=d.tCCD_S, tCCD_L=d.tCCD_L, tWR=d.tWR, tWTR_L=d.tWTR_L,
            tRTP=d.tRTP, tRRD_S=d.tRRD_S, tRRD_L=d.tRRD_L, tFAW=d.tFAW,
            tCWL=d.tCWL, tRTRS=d.tRTRS, tREFI=d.tREFI, tRFC=d.tRFC,
            tRC=d.tRAS + d.tRP, banks_per_rank=d.banks_per_rank,
            banks_per_group=d.banks_per_rank // d.bank_groups,
            same_bank_refresh=int(d.same_bank_refresh),
            drain_hi=pol.drain_hi, drain_lo=pol.drain_lo,
            row_hit_cap=pol.row_hit_cap, mc_extra_ticks=pol.mc_extra_ticks,
            tick2cpu_num=clock.tick_to_cpu_ps_num,
            tick2cpu_den=clock.tick_to_cpu_ps_den,
            cpu_ps_per_clk=cfg.platform.cpu.cpu_ps_per_clk)
        assert got == tuple(want[n] for n in PARAM_NAMES)
        assert all(isinstance(v, int) for v in got)


# ---- the kernel's step, emulated in numpy --------------------------------

class RowBlock:
    """One block of ``weave_window.cu`` (one (point, channel) row).

    Slot fields are per-thread registers (arrays indexed by thread), the
    bank planes, pending-hit flags and FAW registers are the block's
    shared memory, and the channel registers are the copies every thread
    keeps.  Each method follows the kernel's phases in order.
    """

    def __init__(self, q, b, p, tele=None, record=False, broken=None):
        self.p = p
        self.broken = broken
        self.valid, self.is_write, self.arrival, self.issue, self.fbank, \
            self.row, self.chase = (q[k].astype(np.int64) for k in
                                    dram.QueueState._fields)
        self.Q = self.valid.shape[0]
        for k in ("open_row", "next_act", "next_rd", "next_wr", "next_pre"):
            setattr(self, k, b[k].astype(np.int64))
        self.RB = self.open_row.shape[0]
        self.faw = b["faw"].astype(np.int64)
        self.R = self.faw.shape[0]
        self.hit_pend = np.zeros(self.RB, bool)
        self.next_ref = [int(x) for x in b["next_ref"]]
        self.ref_slot = [int(x) for x in b["ref_slot"]]
        self.bus_free, self.wtr, self.rtw, self.last_rank, self.streak = (
            int(b[k]) for k in ("bus_free", "wtr_until", "rtw_until",
                                "last_rank", "hit_streak"))
        self.drain = bool(b["drain"])
        self.stats = dict(served_rd=0, served_wr=0, sum_rd_lat_ticks=0,
                          sum_if_lat_ps=np.float32(0.0), chase_rd=0,
                          sum_chase_lat_ticks=0)
        self.bank = np.arange(self.RB)
        self.slot = np.arange(self.Q)
        # telemetry: counters and write-burst state kept by the last warp,
        # busy and last-ACT planes owned by each bank's thread, the two
        # histograms added to by the last thread
        self.tele = tele is not None
        if self.tele:
            self.counters = dict.fromkeys(TELE_COUNTERS, 0)
            self.opened_at = tele[0].astype(np.int64)
            self.last_wr_t, self.wr_burst = int(tele[1]), bool(tele[2])
            self.busy = np.zeros(self.RB, np.int64)
            self.hist = np.zeros((2, N_HIST), np.int64)
        self.record = [] if record else None

    # block reductions as the kernel takes them: per warp, then across
    def _counts(self, arrived, is_wr):
        bw = (arrived & is_wr).reshape(-1, 32).sum(1)
        br = (arrived & ~is_wr).reshape(-1, 32).sum(1)
        total = int(((bw << 16) | br).sum())
        return total >> 16, total & 0xFFFF

    def _settle(self, nw, nr):
        p = self.p
        d = nw > p["drain_lo"] if self.drain else nw >= p["drain_hi"]
        return d or (nr == 0 and nw > 0)

    def next_event(self, t, end):
        p = self.p
        self.hit_pend[:] = False
        valid = self.valid == 1
        is_wr = self.is_write == 1
        arrived = valid & (self.arrival <= t)
        drain = self._settle(*self._counts(arrived, is_wr))
        fb = self.fbank
        open_e = self.open_row[fb]
        row_hit = open_e == self.row
        self.hit_pend[fb[arrived & row_hit & (is_wr == drain)]] = True
        ev = np.where(valid & (self.arrival > t), self.arrival, BIG)
        side_ok = np.where(is_wr, drain, not drain)
        closed = open_e < 0
        ready = np.maximum(np.where(is_wr,
                                    np.maximum(self.next_wr[fb], self.rtw),
                                    np.maximum(self.next_rd[fb], self.wtr)),
                           self.bus_free)
        ev = np.where(arrived & row_hit & side_ok, np.minimum(ev, ready), ev)
        act = np.maximum(self.next_act[fb],
                         self.faw[fb // p["banks_per_rank"], 0] + p["tFAW"])
        ev = np.where(arrived & closed & side_ok, np.minimum(ev, act), ev)
        pre = arrived & ~closed & ~row_hit & side_ok & ~self.hit_pend[fb]
        ev = np.where(pre, np.minimum(ev, self.next_pre[fb]), ev)
        m = int(ev.reshape(-1, 32).min(1).min())
        if drain != self.drain:
            m = min(m, t + 1)
        m = min([m] + self.next_ref)
        return min(max(m, t + 1), end)

    def _score(self, t, arrived, is_wr, open_e, drain):
        p = self.p
        fb = self.fbank
        capped = p["row_hit_cap"] > 0 and self.streak >= p["row_hit_cap"]
        row_hit = (open_e == self.row) & arrived
        closed = (open_e < 0) & arrived
        side_ok = np.where(is_wr, drain, not drain)
        bus_ok, wtr_ok, rtw_ok = (t >= self.bus_free, t >= self.wtr,
                                  t >= self.rtw)
        rd = (row_hit & ~is_wr & (t >= self.next_rd[fb]) & bus_ok & wtr_ok
              & (not drain))
        wr = row_hit & is_wr & (t >= self.next_wr[fb]) & bus_ok & rtw_ok \
            & drain
        faw_ok = t >= self.faw[fb // p["banks_per_rank"], 0] + p["tFAW"]
        act = closed & (t >= self.next_act[fb]) & faw_ok & side_ok
        pre = (arrived & (open_e >= 0) & (open_e != self.row)
               & (t >= self.next_pre[fb]) & ~self.hit_pend[fb] & side_ok)
        age = (BIG - self.arrival) & MASK32
        sc = np.where(rd | wr, 3 * BIG + age,
                      np.where(act, 2 * BIG + age,
                               np.where(pre, BIG + age, 0)))
        if capped:
            sc = np.where(rd | wr, BIG + age, sc)
            sc = np.where(act, 3 * BIG + age, sc)
        sc = (sc & MASK32).astype(np.uint32).view(np.int32).astype(np.int64)
        bits = (rd * 1) | (wr * 2) | (act * 4) | (pre * 8) | (is_wr * 16)
        return sc, bits, capped

    def tick(self, t, active):
        p = self.p
        nb = p["banks_per_rank"]
        rank_b = self.bank // nb
        # refresh by each bank's owner
        self.hit_pend[:] = False
        if active:
            due = t >= np.asarray(self.next_ref)[rank_b]
            if p["same_bank_refresh"]:
                due &= self.bank % nb == np.asarray(self.ref_slot)[rank_b]
            if self.tele:
                closes = due if self.broken == "busy_closed_rows" \
                    else due & (self.open_row >= 0)
                self.busy[closes] += t - self.opened_at[closes]
            self.open_row[due] = -1
            self.next_act[due] = np.maximum(self.next_act[due],
                                            t + p["tRFC"])
        is_wr = self.is_write == 1
        arrived = (self.valid == 1) & (self.arrival <= t)
        drain = self._settle(*self._counts(arrived, is_wr))
        if not active:
            if self.record is not None and self.broken != "no_idle_record":
                self._record(t, NONE, 0, False)
            self.drain = drain
            return
        fb = self.fbank
        open_e = self.open_row[fb]
        self.hit_pend[fb[arrived & (open_e == self.row)
                         & (is_wr == drain)]] = True
        sc, bits, capped = self._score(t, arrived, is_wr, open_e, drain)
        key = sc * (1 << 32) + (((1023 - self.slot) << 8) | bits)
        key = int(key.reshape(-1, 32).max(1).max())
        best, low = key >> 32, key & MASK32
        sel, bits = 1023 - (low >> 8), low & 0xFF
        cmd = self._command(best, bits, capped)
        if self.record is not None:
            self._record(t, cmd, sel, True)
        if self.tele:
            self._count(t, cmd)
        self._apply(t, cmd, sel, drain)

    def _record(self, t, cmd, sel, active):
        """The record row (one field a lane of the last warp): refresh
        fields before the step moves the deadlines and REFsb slots."""
        p = self.p
        due = [active and t >= r for r in self.next_ref]
        slot = self.ref_slot
        if self.broken == "ref_bank_post":
            slot = [(r + 1) % p["banks_per_rank"] for r in slot]
        self.record.append(
            [cmd, t, int(self.fbank[sel]),
             int(self.row[sel]) if cmd in (RD, WR, ACT) else -1]
            + [int(d) for d in due]
            + [slot[k] if p["same_bank_refresh"] and due[k] else -1
               for k in range(self.R)])

    def _count(self, t, cmd):
        """The counters and write-burst state the last warp keeps."""
        c = self.counters
        c["n_act"] += cmd == ACT
        c["n_pre"] += cmd == PRE
        c["n_cas_rd"] += cmd == RD
        c["n_cas_wr"] += cmd == WR
        if cmd == WR:
            c["drain_enter"] += not self.wr_burst
            c["drain_ticks"] += (t - self.last_wr_t if self.wr_burst
                                 else self.p["tBL"])
            self.last_wr_t = t
        if cmd in (RD, WR):
            self.wr_burst = cmd == WR

    @staticmethod
    def _command(best, bits, capped):
        any_cmd = best > 0
        s_cas = any_cmd and bool(bits & 3) and not (capped and bits & 4)
        s_act = any_cmd and bool(bits & 4) and not s_cas
        s_pre = any_cmd and bool(bits & 8) and not s_cas and not s_act
        if s_cas:
            return WR if bits & 16 else RD
        return ACT if s_act else PRE if s_pre else NONE

    def _apply(self, t, cmd, sel, drain):
        p = self.p
        nb = p["banks_per_rank"]
        s_rd, s_wr = cmd == RD, cmd == WR
        s_cas, s_act, s_pre = s_rd or s_wr, cmd == ACT, cmd == PRE
        s_fb = int(self.fbank[sel])
        s_rank, s_bg = s_fb // nb, (s_fb % nb) // p["banks_per_group"]
        if cmd != NONE:
            at_sel = self.bank == s_fb
            same_rank = self.bank // nb == s_rank
            same_grp = same_rank & ((self.bank % nb) // p["banks_per_group"]
                                    == s_bg)
            mx = np.maximum
            if s_act:
                self.next_act = np.where(same_rank,
                                         mx(self.next_act, t + p["tRRD_S"]),
                                         self.next_act)
                self.next_act = np.where(same_grp,
                                         mx(self.next_act, t + p["tRRD_L"]),
                                         self.next_act)
                if self.tele:
                    self.opened_at[at_sel] = t
                self.open_row[at_sel] = self.row[sel]
                self.next_act[at_sel] = mx(self.next_act[at_sel],
                                           t + p["tRC"])
                self.next_rd[at_sel] = t + p["tRCD"]
                self.next_wr[at_sel] = t + p["tRCD"]
                self.next_pre[at_sel] = t + p["tRAS"]
                self.faw[s_rank] = np.r_[self.faw[s_rank, 1:], t]
            if s_cas:
                ccd = np.where(same_grp, p["tCCD_L"], p["tCCD_S"])
                self.next_rd = mx(self.next_rd, t + ccd)
                self.next_wr = mx(self.next_wr, t + ccd)
                lat = p["tRTP"] if s_rd else p["tCWL"] + p["tBL"] + p["tWR"]
                self.next_pre[at_sel] = mx(self.next_pre[at_sel], t + lat)
            if s_pre:
                if self.tele:
                    self.busy[at_sel] += t - self.opened_at[at_sel]
                self.open_row[at_sel] = -1
                self.next_act[at_sel] = mx(self.next_act[at_sel],
                                           t + p["tRP"])
        if s_cas:
            self.bus_free = t + p["tBL"] + (p["tRTRS"] if s_rank
                                            != self.last_rank else 0)
            self.last_rank = s_rank
        if s_wr:
            self.wtr = t + p["tCWL"] + p["tBL"] + p["tWTR_L"]
        if s_rd:
            self.rtw = t + p["tCL"] + p["tBL"] + p["tRTRS"] - p["tCWL"]
        self.streak = (self.streak + 1 if s_cas
                       else 0 if cmd != NONE else self.streak)
        self.drain = drain
        for k in range(self.R):
            if t >= self.next_ref[k]:
                if self.tele:
                    self.counters["n_ref"] += 1
                self.next_ref[k] += p["tREFI"]
                if p["same_bank_refresh"]:
                    self.ref_slot[k] = (self.ref_slot[k] + 1) % nb
        if s_cas:
            self.valid[sel] = 0
        st = self.stats
        done_t = t + p["tCL"] + p["tBL"] + p["mc_extra_ticks"]
        rd_lat = _w32(done_t - int(self.arrival[sel]))
        if_lat = _w32(_w32(done_t * p["tick2cpu_num"]) // p["tick2cpu_den"]
                      - _w32(int(self.issue[sel]) * p["cpu_ps_per_clk"]))
        st["served_rd"] += int(s_rd)
        st["served_wr"] += int(s_wr)
        if self.tele and s_rd:
            self.hist[0, _bucket(rd_lat)] += 1
            self.hist[1, _bucket(if_lat)] += 1
        if s_rd:
            st["sum_rd_lat_ticks"] = _w32(st["sum_rd_lat_ticks"] + rd_lat)
            st["sum_if_lat_ps"] = np.float32(st["sum_if_lat_ps"]
                                             + np.float32(if_lat))
            if self.chase[sel] == 1:
                st["chase_rd"] += 1
                st["sum_chase_lat_ticks"] = _w32(
                    st["sum_chase_lat_ticks"] + rd_lat)

    def window(self, start, end, horizon, n_steps, event):
        live, sat = 0, False
        if not event:
            for i in range(n_steps):
                self.tick(start + i, start + i < end)
                live += start + i < end
            return live, sat
        t = start - 1
        for _ in range(n_steps):
            tn = self.next_event(t, horizon)
            tau = min(tn, horizon - 1)
            self.tick(tau, tn < horizon and tau < end)
            live += tn < end
            t = tau
        return live, self.next_event(t, horizon) < horizon

    def state(self):
        q = dict(valid=self.valid, is_write=self.is_write,
                 arrival=self.arrival, issue_cycle=self.issue,
                 fbank=self.fbank, row=self.row, is_chase=self.chase)
        b = dict(open_row=self.open_row, next_act=self.next_act,
                 next_rd=self.next_rd, next_wr=self.next_wr,
                 next_pre=self.next_pre, faw=self.faw,
                 next_ref=np.asarray(self.next_ref),
                 ref_slot=np.asarray(self.ref_slot), bus_free=self.bus_free,
                 wtr_until=self.wtr, rtw_until=self.rtw,
                 last_rank=self.last_rank, drain=self.drain,
                 hit_streak=self.streak)
        return q, b


def _bucket(v: int) -> int:
    """The kernel's ``log2_bucket``: 31 - clz(max(v, 1)), clipped."""
    return min(max(v, 1).bit_length() - 1, N_HIST - 1)


def fused_emulation(cfg, clock, queue, banks, w, tele=None, broken=None):
    """`_weave_fused`'s outputs, row by row through `RowBlock`; with a
    recorder flag of ``cfg`` also its sixth item, as numpy."""
    d = cfg.platform.dram
    start, end = clock.window_start_tick(w), clock.window_end_tick(w)
    event = cfg.weave == "event"
    n_steps = (cfg.event_budget() if event
               else clock.ticks_per_window_static)
    p = dict(zip(PARAM_NAMES, pack_params(
        d, cfg.policy, tick2cpu_num=clock.tick_to_cpu_ps_num,
        tick2cpu_den=clock.tick_to_cpu_ps_den,
        cpu_ps_per_clk=cfg.platform.cpu.cpu_ps_per_clk)))
    qn, bn = dram.state_to_numpy(queue, banks)
    B, C = qn["valid"].shape[:2]
    q_out = {k: np.empty_like(v) for k, v in qn.items()}
    b_out = {k: np.empty_like(v) for k, v in bn.items()}
    stats = {k: np.zeros((B, C), np.float32 if k == "sum_if_lat_ps"
                         else np.int32) for k in dram.TickStats._fields}
    live = np.zeros((B, C), np.int32)
    sat = np.zeros((B, C), bool)
    tn = ([x.numpy() for x in tele] if cfg.telemetry else None)
    RB, R = d.banks_per_channel, d.ranks_per_channel
    n_steps_rec = []
    tele_inc = dict(**{k: np.zeros((B, C), np.int32)
                       for k in TELE_COUNTERS},
                    busy_ticks=np.zeros((B, C, RB), np.int32),
                    hist_rd_ticks=np.zeros((B, C, N_HIST), np.int32),
                    hist_if_ps=np.zeros((B, C, N_HIST), np.int32))
    tele_out = [np.zeros((B, C, RB), np.int32), np.zeros((B, C), np.int32),
                np.zeros((B, C), bool)]
    for b in range(B):
        for c in range(C):
            blk = RowBlock({k: v[b, c] for k, v in qn.items()},
                           {k: v[b, c] for k, v in bn.items()}, p,
                           tele=(None if tn is None
                                 else [x[b, c] for x in tn]),
                           record=cfg.cmd_trace, broken=broken)
            live[b, c], sat[b, c] = blk.window(
                start, end, start + clock.ticks_per_window_static, n_steps,
                event)
            qs, bs = blk.state()
            for k, v in qs.items():
                q_out[k][b, c] = v
            for k, v in bs.items():
                b_out[k][b, c] = v
            for k, v in blk.stats.items():
                stats[k][b, c] = v
            if blk.tele:
                for k, v in blk.counters.items():
                    tele_inc[k][b, c] = v
                tele_inc["busy_ticks"][b, c] = blk.busy
                tele_inc["hist_rd_ticks"][b, c] = blk.hist[0]
                tele_inc["hist_if_ps"][b, c] = blk.hist[1]
                tele_out[0][b, c] = blk.opened_at
                tele_out[1][b, c] = blk.last_wr_t
                tele_out[2][b, c] = blk.wr_burst
            if blk.record is not None:
                n_steps_rec.append(np.asarray(blk.record, np.int64))
    events = live.max(1) if event else np.full(B, end - start, np.int32)
    out = (q_out, b_out, stats, events, sat.any(1))
    if not (cfg.telemetry or cfg.cmd_trace):
        return out
    cmds = None
    if cfg.cmd_trace:
        if len({len(r) for r in n_steps_rec}) != 1:
            return out + ((tele_inc, tele_out, "ragged record"),)
        rec = np.stack(n_steps_rec).reshape(B, C, -1, 4 + 2 * R)
        rec = rec.transpose(0, 2, 1, 3)                 # (B, steps, C, F)
        cmds = dict(cmd=rec[..., 0], t=rec[..., 1], fbank=rec[..., 2],
                    row=rec[..., 3], ref=rec[..., 4:4 + R] != 0,
                    ref_bank=rec[..., 4 + R:])
    return out + ((tele_inc if cfg.telemetry else None,
                   tele_out if cfg.telemetry else None, cmds),)


def _fill(rng, queue, banks, d, start, end, frac, first, tail=0):
    """Random requests into free slots, arriving around [start, end +
    tail); on the first window also a mid-flight bank state with refresh
    due."""
    qn, bn = dram.state_to_numpy(queue, banks)
    B, C, Q = qn["valid"].shape
    free = (qn["valid"] == 0) & (rng.random((B, C, Q)) < frac)
    span = end - start
    new = dict(valid=1, is_write=rng.random((B, C, Q)) < 0.4,
               arrival=rng.integers(start - span // 8,
                                    end + span // 8 + tail, (B, C, Q)),
               issue_cycle=rng.integers(0, 2 * end + 1, (B, C, Q)),
               fbank=rng.integers(0, d.banks_per_channel, (B, C, Q)),
               row=rng.integers(0, 4, (B, C, Q)),
               is_chase=rng.random((B, C, Q)) < 0.1)
    for k, v in new.items():
        qn[k] = np.where(free, v, qn[k]).astype(np.int32)
    if first:
        RB, R = d.banks_per_channel, d.ranks_per_channel
        bn["open_row"] = rng.integers(-1, 4, (B, C, RB)).astype(np.int32)
        for k in ("next_act", "next_rd", "next_wr", "next_pre"):
            bn[k] = rng.integers(start - 10, start + 30,
                                 (B, C, RB)).astype(np.int32)
        bn["faw"] = np.sort(rng.integers(start - 60, start, (B, C, R, 4)),
                            axis=3).astype(np.int32)
        bn["next_ref"] = rng.integers(start, end, (B, C, R)).astype(np.int32)
        bn["ref_slot"] = rng.integers(0, d.banks_per_rank,
                                      (B, C, R)).astype(np.int32)
        bn["drain"] = rng.random((B, C)) < 0.3
        bn["hit_streak"] = rng.integers(0, 6, (B, C)).astype(np.int32)
    return dram.state_from_numpy(qn, bn)


EMULATION_CASES = [
    # preset, backend, engine, event budget override (0: the clock's),
    # extra static ticks past the window's end (inactive steps), share of
    # free slots filled per window
    ("ddr4_2666", "ramulator", "dense", 0, 0, 0.3),
    ("ddr4_2666", "ramulator2", "event", 0, 0, 0.3),
    ("ddr5_4800", "ramulator", "event", 0, 0, 0.3),
    ("ddr5_4800", "ramulator2", "dense", 0, 0, 0.3),
    ("hbm2e", "ramulator", "dense", 0, 0, 0.3),
    ("hbm2e", "ramulator2", "event", 0, 0, 0.3),
    ("ddr4_2666", "delay", "event", 24, 0, 0.3),    # budget runs out: sat
    # light load past the end: the drain flips on inactive steps
    ("ddr4_2666", "ramulator", "dense", 0, 24, 0.02),
    ("hbm2e", "ramulator2", "event", 0, 24, 0.02),
]


@pytest.mark.parametrize("preset,backend,engine,budget,tail,frac",
                         EMULATION_CASES)
def test_kernel_step_emulation_matches_stepwise(preset, backend, engine,
                                                budget, tail, frac):
    cfg = dataclasses.replace(_stage(preset, backend, window_cycles=120),
                              weave=engine, weave_events=budget)
    clock = cfg.clock()
    # a longer static window: the steps past `end` are inactive, and
    # arrivals there still settle the write drain
    clock = dataclasses.replace(
        clock, ticks_per_window_static=clock.ticks_per_window_static + tail)
    d = cfg.platform.dram
    kw = platform._tick_kw(cfg, clock, "cpu")
    rng = np.random.default_rng(len(preset) * 7 + len(backend) + budget
                                + tail)
    queue = dram.init_queue(d, cfg.policy)
    banks = dram.init_banks(d)
    served = sat_seen = refreshed = 0
    for w in range(5, 8):
        start, end = clock.window_start_tick(w), clock.window_end_tick(w)
        queue, banks = _fill(rng, queue, banks, d, start, end, frac,
                             w == 5, tail)
        want = platform._weave_stepwise(cfg, clock, kw, queue, banks, w)
        got = fused_emulation(cfg, clock, queue, banks, w)
        wq, wb = dram.state_to_numpy(want[0], want[1])
        for name, ref in {**wq, **wb}.items():
            emu = got[0][name] if name in got[0] else got[1][name]
            np.testing.assert_array_equal(emu, ref,
                                          err_msg=f"{name}, window {w}")
        for name, ref in want[2]._asdict().items():
            np.testing.assert_array_equal(got[2][name], ref.numpy(),
                                          err_msg=f"stats.{name}, window {w}")
        np.testing.assert_array_equal(got[3], want[3].numpy())
        np.testing.assert_array_equal(got[4], want[4].numpy())
        served += int(want[2].served_rd.sum() + want[2].served_wr.sum())
        sat_seen += int(want[4].sum())
        refreshed += int((want[1].next_ref != banks.next_ref).sum())
        queue, banks = want[0], want[1]
    assert served > 0 and refreshed > 0      # the windows did real work
    if budget:
        assert sat_seen > 0                  # the budget ran out


def _recorded_windows(preset, backend, engine, budget, tail, frac,
                      broken=None):
    """`_emulation_windows` with both recorder flags on: the emulation's
    recorder outputs beside the stepwise loop's, window by window, the
    telemetry carry threaded through the stepwise route."""
    cfg = dataclasses.replace(_stage(preset, backend, window_cycles=120),
                              weave=engine, weave_events=budget,
                              telemetry=True, cmd_trace=True)
    clock = cfg.clock()
    clock = dataclasses.replace(
        clock, ticks_per_window_static=clock.ticks_per_window_static + tail)
    d = cfg.platform.dram
    kw = platform._tick_kw(cfg, clock, "cpu")
    rng = np.random.default_rng(len(preset) * 7 + len(backend) + budget
                                + tail)
    queue = dram.init_queue(d, cfg.policy)
    banks = dram.init_banks(d)
    tele = dram.init_tele(d)
    for w in range(5, 8):
        start, end = clock.window_start_tick(w), clock.window_end_tick(w)
        queue, banks = _fill(rng, queue, banks, d, start, end, frac,
                             w == 5, tail)
        if w == 5:      # mid-flight: banks opened at various ticks
            tele = tele._replace(opened_at=torch.as_tensor(rng.integers(
                start - 200, start, tuple(tele.opened_at.shape)),
                dtype=torch.int32))
        want = platform._weave_stepwise(cfg, clock, kw, queue, banks, w, tele)
        got = fused_emulation(cfg, clock, queue, banks, w, tele, broken)
        yield w, want, got
        queue, banks, tele = want[0], want[1], want[5][1]


def _recorder_diff(want, got):
    """The first recorder field where the emulation and the stepwise loop
    differ, or None."""
    tacc, tstate, cmds = want[5]
    g_inc, g_out, g_cmds = got[5]
    if isinstance(g_cmds, str):
        return g_cmds
    pairs = [(f"tele.{k}", v.numpy(), g_inc[k])
             for k, v in tacc._asdict().items()]
    pairs += [(f"tele_state.{k}", v.numpy(), g)
              for (k, v), g in zip(tstate._asdict().items(), g_out)]
    pairs += [(f"cmd.{k}", v.numpy(), g_cmds[k])
              for k, v in cmds._asdict().items()]
    for name, ref, emu in pairs:
        if ref.shape != emu.shape or not np.array_equal(ref, emu):
            return name
    return None


@pytest.mark.parametrize("preset,backend,engine,budget,tail,frac",
                         EMULATION_CASES)
def test_kernel_recorder_emulation_matches_stepwise(preset, backend, engine,
                                                    budget, tail, frac):
    """The recording instance's algorithm (counters in the last warp,
    bank-owned busy planes, the last thread's histograms, one record row a
    step, inactive steps included) against `dram.tick` with both flags,
    bit for bit, with the state, stats, events and saturation flags."""
    n_cmd = n_ref = n_idle = 0
    for w, want, got in _recorded_windows(preset, backend, engine, budget,
                                          tail, frac):
        wq, wb = dram.state_to_numpy(want[0], want[1])
        for name, ref in {**wq, **wb}.items():
            emu = got[0][name] if name in got[0] else got[1][name]
            np.testing.assert_array_equal(emu, ref,
                                          err_msg=f"{name}, window {w}")
        for name, ref in want[2]._asdict().items():
            np.testing.assert_array_equal(got[2][name], ref.numpy(),
                                          err_msg=f"stats.{name}, window {w}")
        np.testing.assert_array_equal(got[3], want[3].numpy())
        np.testing.assert_array_equal(got[4], want[4].numpy())
        assert _recorder_diff(want, got) is None, \
            f"{_recorder_diff(want, got)}, window {w}"
        tacc, _, cmds = want[5]
        # every served read lands in one bucket of each histogram
        np.testing.assert_array_equal(tacc.hist_rd_ticks.sum(2),
                                      want[2].served_rd)
        np.testing.assert_array_equal(tacc.hist_if_ps.sum(2),
                                      want[2].served_rd)
        n_cmd += int((cmds.cmd != NONE).sum())
        n_ref += int(cmds.ref.sum())
        n_idle += int((cmds.cmd == NONE).sum())
    assert n_cmd > 0 and n_ref > 0 and n_idle > 0


@pytest.mark.parametrize("broken,case", [
    ("busy_closed_rows", EMULATION_CASES[2]),
    ("ref_bank_post", EMULATION_CASES[2]),      # REFsb
    ("no_idle_record", EMULATION_CASES[7]),     # inactive steps past end
])
def test_broken_recorder_emulation_fails(broken, case):
    """Each deliberately broken recorder (busy added for refreshed banks
    that were closed; the REFsb bank read after its rotation; no record
    on inactive steps) must disagree with the stepwise loop."""
    diffs = [_recorder_diff(want, got)
             for _, want, got in _recorded_windows(*case, broken)]
    assert any(d is not None for d in diffs)


def test_recorder_outputs_are_fresh_and_sized():
    d = PRESETS["ddr5_4800"]
    B, C, RB, R = 2, d.n_channels, d.banks_per_channel, d.ranks_per_channel
    tele = dram.init_tele(d, B)
    inp, out = pack_recorder(tele, B, C, RB, R, 7, "cpu", telemetry=True,
                             cmd_trace=True)
    assert len(_storages(out.values())) == len(out)
    assert not _storages(out.values()) & (_storages(inp.values())
                                          | _storages(tele))
    assert not _storages(inp.values()) & _storages(tele)
    assert out["counters"].shape == (len(TELE_COUNTERS), B, C)
    assert out["hist"].shape == (2, B, C, N_HIST) and N_HIST == dram.N_HIST
    assert TELE_COUNTERS == dram.TickTele._fields[:7]
    assert out["rec"].shape == (7, B * C, 4 + 2 * R)
    _, only_cmd = pack_recorder(None, B, C, RB, R, 7, "cpu",
                                telemetry=False, cmd_trace=True)
    assert set(only_cmd) == {"rec"}
    src = CSRC.read_text()
    assert f"kNHist = {N_HIST}" in src
    assert f"kNCounters = {len(TELE_COUNTERS)}" in src


# ---- on the card ---------------------------------------------------------

CARD_CASES = [
    # stage, preset, sockets, engine: chip_smoke.py's weave phase, and
    # hbm2e on two sockets
    ("07-prefetch", "ddr4_2666", 1, "dense"),
    ("07-prefetch", "ddr4_2666", 1, "event"),
    ("07-prefetch", "ddr4_2666", 2, "dense"),
    ("07-prefetch", "ddr4_2666", 2, "event"),
    ("09-ramulator2", "ddr5_4800", 1, "dense"),
    ("09-ramulator2", "ddr5_4800", 1, "event"),
    ("10-delay-buffer", "hbm2e", 1, "dense"),
    ("10-delay-buffer", "hbm2e", 1, "event"),
    ("10-delay-buffer", "hbm2e", 2, "event"),
]


def _tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return all(_tree_equal(a[k], b[k]) for k in a)
    return all(_tree_equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("stage,preset,sockets,engine", CARD_CASES)
def test_fused_matches_stepwise_on_card(cuda, stage, preset, sockets,
                                        engine):
    cfg = get_stage(stage, preset=preset, n_sockets=sockets, weave=engine,
                    windows=3, warmup=0)
    paces = torch.tensor([4, 48], dtype=torch.int32, device=cuda)
    frontend = workload.MessFrontend(paces, torch.full_like(paces, 16),
                                     cfg.workload_config())
    clock, wcfg = cfg.clock(), cfg.workload_config()
    carry = platform._init_carry(cfg, frontend, 2, cuda)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        for w in range(cfg.windows):
            queue = platform._bound_inject(cfg, clock, wcfg, frontend, carry,
                                           w)[0]
            args = (cfg, clock, platform._tick_kw(cfg, clock, cuda), queue,
                    carry[1], w)
            fused = platform._weave_fused(*args)
            step = platform._weave_stepwise(*args)
            torch.cuda.synchronize()
            assert _tree_equal(fused, step), f"window {w}"
            carry, _ = platform._window_step(cfg, clock, wcfg, frontend,
                                             carry, w)
    counts = kernels.launch_counts()
    assert counts["weave_window"] == 2 * cfg.windows   # compared + loop
    assert counts["frfcfs_select"] > 0


@pytest.mark.gpu
def test_run_point_on_card_matches_cpu(cuda):
    cfg = get_stage("07-prefetch", windows=6, warmup=2)
    kernels.reset_launch_counts()
    on_card = platform.run_point(cfg, [1, 48], 16)
    counts = kernels.launch_counts()
    on_cpu = platform.run_point(cfg, [1, 48], 16, device="cpu")
    assert counts["weave_window"] == cfg.windows
    assert counts["frfcfs_select"] == 0
    for k, ref in on_cpu.items():
        got = on_card[k].cpu()
        if got.is_floating_point():
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
        else:
            assert torch.equal(got, ref), k


def _tree_equal_or_none(a, b):
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return all(_tree_equal_or_none(a[k], b[k]) for k in a)
    return len(a) == len(b) and all(_tree_equal_or_none(x, y)
                                    for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [(True, False), (False, True),
                                   (True, True)])
@pytest.mark.parametrize("stage,preset,sockets,engine", CARD_CASES[::3])
def test_recording_fused_matches_stepwise_on_card(cuda, stage, preset,
                                                  sockets, engine, flags):
    """The recording instances of the kernel against the stepwise loop
    with the flags, on the card, in every output and recorder field."""
    telemetry, cmd_trace = flags
    cfg = get_stage(stage, preset=preset, n_sockets=sockets, weave=engine,
                    windows=3, warmup=0, telemetry=telemetry,
                    cmd_trace=cmd_trace)
    paces = torch.tensor([4, 48], dtype=torch.int32, device=cuda)
    frontend = workload.MessFrontend(paces, torch.full_like(paces, 16),
                                     cfg.workload_config())
    clock, wcfg = cfg.clock(), cfg.workload_config()
    carry = platform._init_carry(cfg, frontend, 2, cuda)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        for w in range(cfg.windows):
            queue = platform._bound_inject(cfg, clock, wcfg, frontend, carry,
                                           w)[0]
            args = (cfg, clock, platform._tick_kw(cfg, clock, cuda), queue,
                    carry[1], w, carry[5])
            fused = platform._weave_fused(*args)
            step = platform._weave_stepwise(*args)
            torch.cuda.synchronize()
            assert len(fused) == 6
            assert _tree_equal_or_none(fused, step), f"window {w}"
            carry, _ = platform._window_step(cfg, clock, wcfg, frontend,
                                             carry, w)
    name = "+".join(n for n, on in (("telemetry", telemetry),
                                    ("cmd_trace", cmd_trace)) if on)
    assert weave_window.launches_by_instance[name] == 2 * cfg.windows
    assert weave_window.launches_by_instance["plain"] == 0
