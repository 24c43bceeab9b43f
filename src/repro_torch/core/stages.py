"""The artifact's experiment-stage progression as first-class configs.

| stage               | figure | delta vs previous                       |
|---------------------|--------|-----------------------------------------|
| 00-damov-native     | Fig. 2 | alias of 01 (DAMOV release state)       |
| 01-baseline         | Fig. 2 | broken clock scaling, L_ir = 1 cycle    |
| 02-clock-scale      | Fig. 3 | clock scaling on, integer freqRatio     |
| 03-ps-clock         | Fig. 4 | picosecond clocking (Listing 1b)        |
| 04-model-correct    | Fig. 5 | + PI-controlled immediate response      |
| 05-addrmap          | Fig. 6a| + Skylake XOR address mapping           |
| 06-noc              | Fig. 6b| + 2-D mesh NOC model                    |
| 07-prefetch         | Fig. 6c| + stride prefetchers (full paper stack) |
| 08-dramsim3         | Fig. 7 | full stack on the DRAMsim3 flavor       |
| 09-ramulator2       | Fig. 7 | full stack on the Ramulator 2 flavor    |
| 10-delay-buffer     | Sec. 5 | beyond-paper: + MC-pipeline/PHY delay   |
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.backends import make_policy
from repro_torch.core.dram import SchedulerPolicy
from repro_torch.core.platform import StageConfig
from repro_torch.core.timing import CpuParams, DramParams, PlatformParams

_FULL = dict(clock_mode="picosecond", pi_latency=True,
             mapping="skylake_xor", noc="mesh", prefetch=True)

STAGES: dict[str, StageConfig] = {
    "00-damov-native": StageConfig(name="00-damov-native"),
    "01-baseline": StageConfig(name="01-baseline"),
    "02-clock-scale": StageConfig(
        name="02-clock-scale", clock_mode="damov_ceil"),
    "03-ps-clock": StageConfig(
        name="03-ps-clock", clock_mode="picosecond"),
    "04-model-correct": StageConfig(
        name="04-model-correct", clock_mode="picosecond", pi_latency=True),
    "05-addrmap": StageConfig(
        name="05-addrmap", clock_mode="picosecond", pi_latency=True,
        mapping="skylake_xor"),
    "06-noc": StageConfig(
        name="06-noc", clock_mode="picosecond", pi_latency=True,
        mapping="skylake_xor", noc="mesh"),
    "07-prefetch": StageConfig(name="07-prefetch", **_FULL),
    "08-dramsim3": StageConfig(
        name="08-dramsim3", policy=make_policy("dramsim3"), **_FULL),
    "09-ramulator2": StageConfig(
        name="09-ramulator2", policy=make_policy("ramulator2"), **_FULL),
    "10-delay-buffer": StageConfig(
        name="10-delay-buffer",
        policy=make_policy("ramulator", delay_buffer=True), **_FULL),
}

STAGE_ORDER = tuple(STAGES)


def get_stage(name: str, preset: str | None = None,
              **overrides) -> StageConfig:
    """Fetch a stage config, optionally on another device preset and
    with overridden fields (``windows=32, warmup=8``, ...)."""
    try:
        cfg = STAGES[name]
    except KeyError:
        raise ValueError(
            f"unknown stage {name!r}; one of {list(STAGES)}") from None
    if preset is not None and preset != "ddr4_2666":
        from repro_torch.core.presets import get_preset
        plat = overrides.get("platform", cfg.platform)
        overrides["platform"] = dataclasses.replace(
            plat, dram=get_preset(preset))
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def stage_from_dict(d: dict) -> StageConfig:
    """A `StageConfig` from ``dataclasses.asdict`` of a stage config.

    The nested ``platform`` (``cpu``, ``dram``) and ``policy`` dicts
    become their dataclasses; every other key is a field as it is.
    """
    d = dict(d)
    plat = d.pop("platform")
    policy = SchedulerPolicy(**d.pop("policy"))
    return StageConfig(
        **d, policy=policy,
        platform=PlatformParams(cpu=CpuParams(**plat["cpu"]),
                                dram=DramParams(**plat["dram"])))
