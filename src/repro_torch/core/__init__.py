"""The paper's three-view memory-simulation methodology, in PyTorch.

Public API (the same as the JAX reference's ``repro.core``):

* `StageConfig`, `run_point` — the integrated platform.
* `run_frontend`              — the platform under any bound-phase
                                frontend.
* `STAGES`, `get_stage`       — the artifact's stage progression.
* `PRESETS`, `get_preset`, `stage_for` — DDR4/DDR5/HBM2e presets.
* `sweep`                     — Mess bandwidth-latency characterization.
* `make_policy`               — Ramulator/Ramulator2/DRAMsim3 flavors.

Entry points take ``device=None`` (the card); ``device="cpu"`` runs the
same code on the CPU with the kernels' plain versions.
"""
from repro_torch.core.backends import BACKENDS, make_policy
from repro_torch.core.mess import SweepResult, sweep
from repro_torch.core.platform import StageConfig, run_frontend, run_point
from repro_torch.core.presets import (PRESET_ORDER, PRESETS, get_preset,
                                      platform_for, stage_for)
from repro_torch.core.stages import STAGES, STAGE_ORDER, get_stage

__all__ = [
    "BACKENDS", "make_policy", "SweepResult", "sweep",
    "StageConfig", "run_frontend", "run_point",
    "STAGES", "STAGE_ORDER", "get_stage",
    "PRESETS", "PRESET_ORDER", "get_preset", "platform_for", "stage_for",
]
