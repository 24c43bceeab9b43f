"""Scenario fuzzer: random platform runs for the command oracle.

Each seed draws a random scenario: preset, ladder stage, workload (a
Mess operating point, a 1-3 app trace mix with random kernels, lengths
and per-core phase offsets, or an LLM-serving trace from a random model
config x arrival process), socket count, weave engine, and now and then
a synthetic device geometry (2-6 channels).  `run` replays it with
``StageConfig(cmd_trace=True)`` on a device; `check` pushes the recorded
stream through `repro_torch.oracle.check_stream`.

The draws are the reference's ``tests/test_fuzz_oracle.py``: the same
``np.random.default_rng(0xC0FFEE + seed)``, the same calls in the same
order, so seed ``s`` here is seed ``s`` there.  A failing seed reproduces
alone with ``REPRO_FUZZ_N=<s+1> pytest tests/test_torch_fuzz_oracle.py
-k <s>``.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.core import get_stage
from repro_torch.core.platform import run_frontend
from repro_torch.core.presets import PRESETS
from repro_torch.core.workload import MessFrontend
from repro_torch.oracle import check_stream, extract_stream
from repro_torch.traces import (TraceFrontend, assign_traces, split_cores,
                                stack_mixes, to)
from repro_torch.traces.kernels import (bfs_frontier, gups, pointer_chase,
                                        spmv, stencil3d, stream)

#: seeds per run: ``REPRO_FUZZ_N``, 8 by default
N_SEEDS = int(os.environ.get("REPRO_FUZZ_N", "8"))
SEED_BASE = 0xC0FFEE

KERNELS = (stream, gups, stencil3d, spmv, pointer_chase, bfs_frontier)

#: stages drawn for standard presets; geometry draws stick to the stages
#: before the address map (the synthetic channel counts are not what the
#: stage-05+ decoders were pinned against)
STAGES = ("01-baseline", "02-clock-scale", "03-ps-clock",
          "04-model-correct", "05-addrmap", "07-prefetch",
          "08-dramsim3", "09-ramulator2", "10-delay-buffer")
GEO_STAGES = ("01-baseline", "02-clock-scale", "04-model-correct")


@dataclasses.dataclass
class Scenario:
    """One drawn scenario: its description (the reference's string), its
    workload ``kind`` (``mess``, ``serve`` or ``mix``), its stage config
    and ``frontend(device)``, the bound-phase frontend of one point on
    ``device``."""

    seed: int
    desc: str
    kind: str
    cfg: object
    frontend: object


def draw_scenario(seed: int) -> Scenario:
    """Seed ``seed``'s scenario, drawn as the reference draws it."""
    rng = np.random.default_rng(SEED_BASE + seed)
    preset = str(rng.choice(list(PRESETS)))
    geo = rng.random() < 0.25
    stage = str(rng.choice(GEO_STAGES if geo else STAGES))
    n_sockets = 2 if (not geo and rng.random() < 0.2) else 1
    weave = str(rng.choice(["dense", "event"]))
    cfg = get_stage(stage, preset=preset, n_sockets=n_sockets,
                    windows=4, warmup=1, weave=weave, cmd_trace=True)
    if geo:
        d = dataclasses.replace(
            cfg.platform.dram,
            n_channels=int(rng.choice([2, 3, 4, 6])),
            ranks_per_channel=int(rng.choice([1, 2])),
            banks_per_rank=int(rng.choice([8, 16])))
        cfg = dataclasses.replace(
            cfg, platform=dataclasses.replace(cfg.platform, dram=d))

    draw = rng.random()
    if draw < 0.35:
        pace = int(rng.integers(1, 49))
        wr = int(rng.integers(0, 65))
        desc = f"mess p={pace} wr={wr}"

        def frontend(cfg, device):
            p = torch.tensor([pace], dtype=torch.int32, device=device)
            return MessFrontend(p, torch.full_like(p, wr),
                                cfg.workload_config())
    elif draw < 0.65:
        from repro_torch.configs.registry import ARCH_ORDER, get_smoke
        from repro_torch.traces import ServeScenario, lower_scenario
        model = str(rng.choice(ARCH_ORDER))
        arrival = str(rng.choice(["poisson", "uniform", "burst"]))
        scn = ServeScenario(
            model=get_smoke(model), arrival=arrival,
            rate=float(rng.choice([0.25, 0.5, 1.0, 2.0])),
            n_requests=int(rng.integers(4, 17)),
            n_slots=int(rng.integers(1, 7)),
            seed=int(rng.integers(0, 1 << 16)))
        trace, _, _ = lower_scenario(scn)
        desc = f"serve {model} {arrival} r={scn.rate} s={scn.n_slots}"
        if cfg.weave == "event":       # MSHR-hot: a covering budget
            cfg = dataclasses.replace(
                cfg, weave_events=cfg.clock().ticks_per_window_static)

        def frontend(cfg, device):
            batch = type(trace)(*(x[None] for x in trace))
            return TraceFrontend(to(batch, device), cfg.workload_config())
    else:
        n_apps = int(rng.integers(1, 4))
        picks = rng.choice(len(KERNELS), size=n_apps, replace=False)
        apps = [KERNELS[i](n=int(rng.integers(64, 513)),
                           seed=int(rng.integers(0, 1 << 16)))
                for i in picks]
        desc = "mix " + "+".join(KERNELS[i].__name__ for i in picks)
        if cfg.weave == "event":       # saturation-hot: a covering budget
            cfg = dataclasses.replace(
                cfg, weave_events=cfg.clock().ticks_per_window_static)
        # the reference draws the phase offsets when it builds the
        # frontend, which is the next draw
        n_cores = cfg.workload_config().n_cores
        offs = [int(rng.integers(0, 4096)) for _ in range(n_cores)]
        mix = stack_mixes([assign_traces(
            apps, split_cores(n_apps, n_cores), phase_offsets=offs)])

        def frontend(cfg, device):
            return TraceFrontend(to(mix, device), cfg.workload_config())

    kind = desc.split()[0]
    desc = (f"{preset}/{stage}/{cfg.weave}/{n_sockets}s "
            f"C={cfg.platform.dram.n_channels} {desc}")
    return Scenario(seed, desc, kind, cfg,
                    lambda device, cfg=cfg: frontend(cfg, device))


def run(scn: Scenario, device=None):
    """The scenario's views (one point: row 0 of each) on ``device``."""
    views, _ = run_frontend(scn.cfg, scn.frontend(device), batch=1,
                            device=device)
    return {k: v[0] for k, v in views.items()}


def end_tick(scn: Scenario) -> int:
    return int(scn.cfg.clock().window_end_tick(scn.cfg.windows - 1))


def check(scn: Scenario, views):
    """``(stream, report)``: the recorded command stream and its
    `LegalityReport` over the run's span."""
    s = extract_stream({k: v.cpu() for k, v in views.items()},
                       scn.cfg.platform.dram)
    return s, check_stream(s, end_tick=end_tick(scn))
