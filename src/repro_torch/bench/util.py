"""Shared machinery of the port's figure scripts: the Mess sweep at the
figures' settings, the artifact CSV and the benchmark output line.

The port's counterpart of the JAX package's ``benchmarks/util.py``; the
CSVs go to an output directory of the caller's choosing (by default
``reports/torch/``, never the reference's ``reports/benchmarks/``).
"""
from __future__ import annotations

import csv
import pathlib
import time

from repro_torch.bench.app_validation import OUT_DIR
from repro_torch.core import get_stage, sweep
from repro_torch.core.mess import DEFAULT_PACES, WRITE_MIXES
from repro_torch.core.shard import resolve_devices

#: CI-speed defaults; ``full=True`` runs the paper-resolution sweeps
FAST_PACES = (1, 4, 12, 24, 48, 64)
FAST_MIXES = (0, 16, 32)
FAST_WINDOWS = dict(windows=48, warmup=16)


def preset_suffix(preset: str) -> str:
    """Artifact/metric-name suffix: empty for the paper's DDR4 device."""
    return "" if preset == "ddr4_2666" else f"_{preset}"


def run_sweep(stage: str, *, full: bool = False,
              preset: str = "ddr4_2666", device=None):
    """One stage's Mess sweep at the figures' settings on ``device``
    (``None``: the card; as `mess.sweep`); ``(SweepResult, us per
    simulated point)``.

    Prints a ``sweep.<stage>[_<preset>]`` line with the sweep's wall.
    """
    devices = resolve_devices(device)
    kw = {} if full else FAST_WINDOWS
    cfg = get_stage(stage, preset=preset, **kw)
    t0 = time.perf_counter()
    res = sweep(cfg, paces=DEFAULT_PACES if full else FAST_PACES,
                write_mixes=WRITE_MIXES if full else FAST_MIXES,
                device=devices)
    wall = time.perf_counter() - t0           # the views are on the host
    n_points = len(res.paces) * len(res.write_mixes)
    us = wall / n_points * 1e6
    emit(f"sweep.{stage}{preset_suffix(preset)}", us,
         f"wall_s={wall:.6f} points={n_points} windows={cfg.windows}")
    return res, us


def write_csv(res, name: str, out_dir=OUT_DIR) -> pathlib.Path:
    """The artifact's bandwidth_latency.csv rows of one sweep, as
    ``<out_dir>/<name>.csv``."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.csv"
    rows = res.to_rows()
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return path


def emit(name: str, us_per_call: float, derived: str):
    """Print one ``name,us,derived`` line; returns ``(name, derived)``."""
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)
    return name, derived
