"""Memory-device preset registry: DDR4-2666, DDR5-4800, HBM2e.

* ``ddr4_2666`` — the paper's platform, identical to ``DramParams()``.
* ``ddr5_4800`` — 6 DIMMs as 12 independent 32-bit sub-channels,
  2 ranks x 32 banks, BL16, tCK ~ 417 ps, same-bank refresh (REFsb).
* ``hbm2e`` — one HBM2e stack as 16 pseudo-channels, 1 rank x 16
  banks, tCK = 625 ps.

The CPU side (24-core Skylake socket) is fixed across presets; the
socket count is a `StageConfig` knob (``n_sockets``).
"""
from __future__ import annotations

from repro_torch.core.clocking import CLOCK_MODES, make_clock
from repro_torch.core.timing import CpuParams, DramParams, PlatformParams

DDR4_2666 = DramParams()

#: JEDEC DDR5-4800B (40-39-39), 16 Gb devices, modeled per sub-channel.
DDR5_4800 = DramParams(
    n_channels=12, ranks_per_channel=2, banks_per_rank=32, bank_groups=8,
    rows_per_bank=1 << 16, cols_per_row=512, bus_bytes=4,
    dram_ps_per_clk=417, mt_per_s=4800, same_bank_refresh=True,
    tCL=40, tRCD=39, tRP=39, tRAS=76, tBL=8, tCCD_S=8, tCCD_L=16,
    tWR=72, tWTR_S=12, tWTR_L=24, tRTP=18, tRRD_S=8, tRRD_L=12,
    tFAW=32, tCWL=38, tRTRS=2, tREFI=292, tRFC=312,
)

#: One HBM2e stack at 3.2 Gbps/pin, modeled per pseudo-channel.
HBM2E = DramParams(
    n_channels=16, ranks_per_channel=1, banks_per_rank=16, bank_groups=4,
    rows_per_bank=1 << 16, cols_per_row=256, bus_bytes=8,
    dram_ps_per_clk=625, mt_per_s=3200, same_bank_refresh=False,
    tCL=23, tRCD=23, tRP=23, tRAS=53, tBL=4, tCCD_S=2, tCCD_L=4,
    tWR=26, tWTR_S=6, tWTR_L=13, tRTP=6, tRRD_S=6, tRRD_L=7,
    tFAW=26, tCWL=7, tRTRS=0, tREFI=6240, tRFC=416,
)

PRESETS: dict[str, DramParams] = {
    "ddr4_2666": DDR4_2666,
    "ddr5_4800": DDR5_4800,
    "hbm2e": HBM2E,
}

PRESET_ORDER = tuple(PRESETS)


def get_preset(name: str) -> DramParams:
    """The frozen `DramParams` of device preset ``name``."""
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown device preset {name!r}; one of {list(PRESETS)}"
        ) from None


def platform_for(preset: str, cpu: CpuParams | None = None) -> PlatformParams:
    """The paper's Skylake CPU frontend attached to a device preset."""
    return PlatformParams(cpu=cpu or CpuParams(), dram=get_preset(preset))


def stage_for(stage: str, preset: str = "ddr4_2666", **overrides):
    """Alias of ``get_stage(stage, preset=preset, **overrides)``."""
    from repro_torch.core.stages import get_stage

    return get_stage(stage, preset=preset, **overrides)


def weave_budgets(preset: str) -> dict:
    """Per-clock-mode weave scan lengths of one device preset.

    Returns ``{clock_mode: (ticks_per_window, events_per_window)}``: the
    dense engine's steps per window against the event engine's static
    budget (`clocking.event_budget`: burst length, refresh cadence and
    tick period all enter), e.g. 635 ticks against 199 events for the
    DDR4 picosecond model.
    """
    plat = platform_for(preset)
    out = {}
    for mode in CLOCK_MODES:
        clock = make_clock(mode, plat)
        out[mode] = (clock.ticks_per_window_static,
                     clock.events_per_window_static)
    return out
