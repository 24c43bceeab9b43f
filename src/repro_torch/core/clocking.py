"""Cross-simulator clocking — the paper's central interface correction.

* ``broken_noscale`` — DAMOV release state: the DRAM simulator ticks
  once per CPU cycle (memory looks 1.575x too fast).
* ``damov_ceil`` — integer ``freqRatio = ceil(2.1/1.333) = 2``
  (Code Listing 1a): ~25% bandwidth loss at the interface.
* ``picosecond`` — the paper's corrected interface (Listing 1b).

Each model gives the DRAM ticks of a 1000-cycle window, the mapping
from CPU-cycle timestamps to DRAM ticks and back; all integer-exact.
The mappings are plain integer arithmetic, so they apply unchanged to
Python ints and to int32 tensors.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.timing import DEFAULT_PLATFORM, PlatformParams

CLOCK_MODES = ("broken_noscale", "damov_ceil", "picosecond")


@dataclasses.dataclass(frozen=True)
class ClockModel:
    """Static description of one cross-simulator clocking scheme."""

    mode: str
    cpu_ps_per_clk: int
    dram_ps_per_clk: int
    window_cycles: int
    ticks_per_window_static: int        # dense scan length (upper bound)
    # tick -> CPU-perceived picoseconds:  cpu_ps = tick * num // den
    tick_to_cpu_ps_num: int
    tick_to_cpu_ps_den: int
    # cpu cycle -> DRAM tick:  tick = (cycle*c2t_num + c2t_round) // c2t_den
    c2t_num: int
    c2t_den: int
    c2t_round: int = 0
    #: event-horizon weave engine steps per window (`event_budget`)
    events_per_window_static: int = 0

    def window_start_tick(self, w):
        return self.cycle_to_tick(w * self.window_cycles)

    def window_end_tick(self, w):
        return self.cycle_to_tick((w + 1) * self.window_cycles)

    def cycle_to_tick(self, cycle):
        """First DRAM tick at which a request issued at ``cycle`` is visible."""
        return (cycle * self.c2t_num + self.c2t_round) // self.c2t_den

    def tick_to_cpu_ps(self, tick):
        return tick * self.tick_to_cpu_ps_num // self.tick_to_cpu_ps_den


def event_budget(ticks: int, dram) -> int:
    """Static event-scan length for one window of ``ticks`` DRAM ticks.

    CAS slots (``ticks // tBL``) + refresh deadlines + headroom
    (``max(32, ticks // 16)``), clamped to ``ticks``.
    """
    cas_slots = ticks // dram.tBL
    refresh = dram.ranks_per_channel * (ticks // max(dram.tREFI, 1) + 1)
    headroom = max(32, ticks // 16)
    return min(ticks, cas_slots + refresh + headroom)


def make_clock(mode: str,
               platform: PlatformParams = DEFAULT_PLATFORM) -> ClockModel:
    cpu, dram = platform.cpu, platform.dram
    cp, dp, wc = cpu.cpu_ps_per_clk, dram.dram_ps_per_clk, cpu.window_cycles
    if mode == "broken_noscale":
        return ClockModel(mode, cp, dp, wc,
                          ticks_per_window_static=wc,
                          tick_to_cpu_ps_num=cp, tick_to_cpu_ps_den=1,
                          c2t_num=1, c2t_den=1,
                          events_per_window_static=event_budget(wc, dram))
    if mode == "damov_ceil":
        r = platform.freq_ratio_ceil
        return ClockModel(mode, cp, dp, wc,
                          ticks_per_window_static=wc // r,
                          tick_to_cpu_ps_num=cp * r, tick_to_cpu_ps_den=1,
                          c2t_num=1, c2t_den=r,
                          events_per_window_static=event_budget(wc // r,
                                                                dram))
    if mode == "picosecond":
        tmax = math.ceil(wc * cp / dp)
        return ClockModel(mode, cp, dp, wc,
                          ticks_per_window_static=tmax,
                          tick_to_cpu_ps_num=dp, tick_to_cpu_ps_den=1,
                          c2t_num=cp, c2t_den=dp, c2t_round=dp - 1,
                          events_per_window_static=event_budget(tmax, dram))
    raise ValueError(f"unknown clock mode {mode!r}; one of {CLOCK_MODES}")


def reference_listing_1b(n_cpu_cycles: int,
                         platform: PlatformParams = DEFAULT_PLATFORM):
    """Direct transliteration of the paper's Code Listing 1(b).

    Returns the (cpuPs, dramPs, dramCycle) trajectory after each CPU
    cycle — the oracle for the aggregated `ClockModel`.
    """
    cpu_ps = dram_ps = dram_cycle = 0
    traj = []
    for _ in range(n_cpu_cycles):
        cpu_ps += platform.cpu.cpu_ps_per_clk
        while cpu_ps > dram_ps:
            dram_ps += platform.dram.dram_ps_per_clk
            dram_cycle += 1
        traj.append((cpu_ps, dram_ps, dram_cycle))
    return traj
