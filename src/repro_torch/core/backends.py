"""Memory-simulator backend flavors (paper Sec. 5, Fig. 7).

``ramulator`` (FR-FCFS, open page, watermark drain), ``ramulator2``
(+ row-hit starvation cap) and ``dramsim3`` (wider drain band) are
`SchedulerPolicy` values over the same `dram.tick`; ``delay_buffer``
adds the paper's future-work MC-pipeline/PHY delay (stage 10).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.dram import SchedulerPolicy

#: MC-pipeline + PHY + IO time the studied simulators omit (~22 ns).
MC_PHY_TICKS = 29

BACKENDS = {
    "ramulator": SchedulerPolicy(
        name="ramulator", queue_depth=256, drain_hi=20, drain_lo=6,
        row_hit_cap=0),
    "ramulator2": SchedulerPolicy(
        name="ramulator2", queue_depth=256, drain_hi=20, drain_lo=6,
        row_hit_cap=4),
    "dramsim3": SchedulerPolicy(
        name="dramsim3", queue_depth=256, drain_hi=30, drain_lo=10,
        row_hit_cap=0),
}


def make_policy(backend: str = "ramulator",
                delay_buffer: bool = False) -> SchedulerPolicy:
    try:
        base = BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; one of {sorted(BACKENDS)}"
        ) from None
    if delay_buffer:
        base = dataclasses.replace(base, mc_extra_ticks=MC_PHY_TICKS)
    return base
