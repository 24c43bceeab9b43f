"""Timing constants for the simulated platform.

The platform mirrors the paper's experimental environment (Table 1):
an Intel Skylake server with 24 cores @ 2.1 GHz and 6 channels of
DDR4-2666, 2 ranks/DIMM, 16 banks/device.

All DRAM timings are *memory bus cycles* (tCK = 750 ps for DDR4-2666);
CPU-side latencies are CPU cycles (476 ps at 2.1 GHz).  The paper's
picosecond clocking (Listing 1b) uses exactly these integer periods.
These are plain frozen dataclasses (host-side, hashable): one value is
one static configuration of the simulator.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class CpuParams:
    """CPU-side parameters (paper Table 1, left column)."""

    n_cores: int = 24
    freq_ghz: float = 2.1
    cpu_ps_per_clk: int = 476          # 1 / 2.1 GHz, as in the paper
    window_cycles: int = 1000          # bound/weave window length
    # Load-to-use path (CPU cycles) excluding the memory system; the sum
    # reproduces the paper's flat 24 ns baseline application view.
    core_issue_cycles: int = 4         # AGU + LSQ + ROB path
    l1_lookup_cycles: int = 4          # private 32 KB L1-D
    l2_lookup_cycles: int = 12         # private 1 MB L2
    llc_lookup_cycles: int = 30        # shared LLC incl. fixed NOC delay

    @property
    def cache_path_cycles(self) -> int:
        return (self.core_issue_cycles + self.l1_lookup_cycles
                + self.l2_lookup_cycles + self.llc_lookup_cycles)


@dataclasses.dataclass(frozen=True)
class DramParams:
    """One memory device's geometry + timing set.

    Defaults are JEDEC DDR4-2666U (19-19-19).  All ``t*`` fields are
    bus cycles of ``dram_ps_per_clk`` picoseconds; ``mt_per_s`` counts
    two transfers per bus cycle.  A *channel* is an independently
    scheduled interface (DDR4 channel, DDR5 sub-channel, HBM
    pseudo-channel).  ``same_bank_refresh`` selects DDR5's REFsb
    rotation (one bank per rank blocked for ``tRFC`` every ``tREFI``).
    """

    n_channels: int = 6
    ranks_per_channel: int = 2
    banks_per_rank: int = 16           # 4 bank groups x 4 banks
    bank_groups: int = 4
    rows_per_bank: int = 1 << 17
    cols_per_row: int = 1 << 10        # 1024 columns x 8B = 8KB row
    line_bytes: int = 64
    bus_bytes: int = 8                 # channel data-bus width
    dram_ps_per_clk: int = 750         # 1 / 1.333 GHz
    mt_per_s: int = 2666
    same_bank_refresh: bool = False    # DDR5 REFsb rotation

    tCL: int = 19
    tRCD: int = 19
    tRP: int = 19
    tRAS: int = 43
    tBL: int = 4                       # burst 8, DDR -> 4 bus cycles
    tCCD_S: int = 4
    tCCD_L: int = 7
    tWR: int = 20
    tWTR_S: int = 4
    tWTR_L: int = 10
    tRTP: int = 10
    tRRD_S: int = 4
    tRRD_L: int = 7
    tFAW: int = 28
    tCWL: int = 14
    tRTRS: int = 2                     # rank-to-rank switch
    tREFI: int = 10400                 # 7.8 us
    tRFC: int = 467                    # 350 ns (16 Gb devices)

    @property
    def tRC(self) -> int:
        return self.tRAS + self.tRP

    @property
    def peak_gbs(self) -> float:
        """Theoretical peak bandwidth: channels x bus width x MT/s."""
        return self.n_channels * self.bus_bytes * self.mt_per_s * 1e6 / 1e9

    @property
    def banks_per_channel(self) -> int:
        return self.ranks_per_channel * self.banks_per_rank

    @property
    def banks_per_group(self) -> int:
        return self.banks_per_rank // self.bank_groups

    @property
    def lines_per_row(self) -> int:
        """Cache lines per DRAM row (row-buffer reach of the open page)."""
        return self.cols_per_row * 8 // self.line_bytes


@dataclasses.dataclass(frozen=True)
class PlatformParams:
    cpu: CpuParams = dataclasses.field(default_factory=CpuParams)
    dram: DramParams = dataclasses.field(default_factory=DramParams)

    @property
    def freq_ratio_ceil(self) -> int:
        """DAMOV's integer rounding of the ratio (Code Listing 1a)."""
        return math.ceil(self.dram.dram_ps_per_clk / self.cpu.cpu_ps_per_clk)


DEFAULT_PLATFORM = PlatformParams()
