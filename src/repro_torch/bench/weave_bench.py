"""Dense vs event-horizon weave engine on the card.

The port's counterpart of the JAX package's weave benchmark: times the
stage-10 Mess sweep under both weave engines (``StageConfig.weave``)
and records, per device preset:

* wall-clock per simulated window (the sweep runs twice and the second,
  steady-state run is reported: the first builds or loads the kernels);
* scan steps per window — the dense engine's ``ticks_per_window`` vs
  the event engine's static budget (`clocking.event_budget`);
* per-pace evaluated events per window and budget-saturation counts
  (``weave_events`` / ``weave_sat`` views) of one batched event-engine
  `run_point` over the paces, and a linear fit ``events/window ~
  per_pace * pace + fixed`` over the unsaturated paces — the form
  `repro_torch.core.mess.load_event_calibration` reads.

As the reference's, the event sweep is knee-routed (`mess.sweep`: the
points its budget covers on the event engine, the rest and any
saturated point dense) and the dense sweep runs every point dense.

Artifact: ``BENCH_weave.json`` in the output directory (by default
``reports/torch/``; the calibration the sweeps load is the reference's
``reports/benchmarks/BENCH_weave.json``, which this never writes).

Usage (on the card; ``--device cpu`` runs the plain versions, slowly):
    python -m repro_torch.bench.weave_bench [--full] [--preset P]
                                            [--readme]
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch.bench.util import OUT_DIR, emit
from repro_torch.core import get_stage, sweep
from repro_torch.core.platform import run_point
from repro_torch.core.shard import resolve_devices

STAGE = "10-delay-buffer"
SMOKE = dict(windows=16, warmup=4, presets=("ddr4_2666",),
             paces=(2, 8, 24), mixes=(0,))
FULL = dict(windows=48, warmup=16,
            presets=("ddr4_2666", "ddr5_4800", "hbm2e"),
            paces=(1, 2, 4, 8, 12, 16, 24, 48, 64), mixes=(0, 16))

REPORT = "BENCH_weave.json"


def _time_sweep(cfg, paces, mixes, devices):
    """Steady-state sweep wall-clock (the second of two runs)."""
    sweep(cfg, paces=paces, write_mixes=mixes, device=devices)
    t0 = time.perf_counter()
    sweep(cfg, paces=paces, write_mixes=mixes, device=devices)
    return time.perf_counter() - t0           # the views are on the host


def _event_diag(cfg, paces, dev):
    """Per-pace evaluated events/window, budget occupancy (events used
    over the static budget) and saturated windows of the event engine,
    all paces in one batched `run_point` at write mix 0, and the
    least-squares fit of events/window on pace over the unsaturated
    paces (a saturated window truncates its count at the budget)."""
    out = run_point(cfg, list(paces), 0, device=dev)
    events = out["weave_events"].cpu().numpy()
    sat = out["weave_sat"].cpu().numpy()
    span = cfg.windows - cfg.warmup
    budget = cfg.event_budget()
    epw = [float(events[i]) / span for i in range(len(paces))]
    diag = {
        str(p): dict(
            events_per_window=round(epw[i], 1),
            budget_occupancy=round(epw[i] / budget, 3),
            sat_windows=int(sat[i]))
        for i, p in enumerate(paces)
    }
    ok = [i for i in range(len(paces)) if not int(sat[i])]
    fit = None
    if len(ok) >= 2:
        a, b = np.polyfit([paces[i] for i in ok], [epw[i] for i in ok], 1)
        fit = dict(per_pace=round(float(a), 3), fixed=round(float(b), 1))
    return diag, fit


def bench_preset(preset: str, windows: int, warmup: int, paces, mixes,
                 device=None) -> dict:
    devices = resolve_devices(device)
    base = get_stage(STAGE, preset=preset, windows=windows, warmup=warmup)
    cfg_d = dataclasses.replace(base, weave="dense")
    cfg_e = dataclasses.replace(base, weave="event")
    clock = base.clock()
    n_windows = len(paces) * len(mixes) * windows

    wall_d = _time_sweep(cfg_d, paces, mixes, devices)
    wall_e = _time_sweep(cfg_e, paces, mixes, devices)
    pace_diag, rate_fit = _event_diag(cfg_e, paces, devices[0])
    row = dict(
        ticks_per_window=clock.ticks_per_window_static,
        event_budget=base.event_budget(),
        step_reduction=round(
            clock.ticks_per_window_static / base.event_budget(), 2),
        dense_wall_s=round(wall_d, 3),
        event_wall_s=round(wall_e, 3),
        speedup=round(wall_d / wall_e, 2),
        us_per_window=dict(
            dense=round(wall_d / n_windows * 1e6, 1),
            event=round(wall_e / n_windows * 1e6, 1)),
        paces=pace_diag,
        event_rate_fit=rate_fit,
    )
    emit(f"weave.{preset}", wall_e / n_windows * 1e6,
         f"speedup={row['speedup']}x vs dense; "
         f"steps/window {base.event_budget()} vs "
         f"{clock.ticks_per_window_static} "
         f"({row['step_reduction']}x fewer)")
    return row


def main(full: bool = False, preset: str | None = None, device=None,
         out_dir=OUT_DIR) -> dict:
    devices = resolve_devices(device)
    knobs = dict(FULL if full else SMOKE)
    if preset:
        knobs["presets"] = (preset,)
    presets = {
        p: bench_preset(p, knobs["windows"], knobs["warmup"],
                        knobs["paces"], knobs["mixes"], device)
        for p in knobs["presets"]
    }
    report = dict(
        mode="full" if full else "smoke",
        stage=STAGE,
        windows=knobs["windows"],
        paces=list(knobs["paces"]),
        write_mixes=list(knobs["mixes"]),
        device=(torch.cuda.get_device_name(devices[0])
                if devices[0].type == "cuda" else devices[0].type),
        presets=presets,
    )
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / REPORT, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    return report


def readme_table(report: dict) -> str:
    """The README perf table, rendered from a `main` report."""
    lines = [
        "| preset | scan steps/window (dense → event) | sweep "
        "wall-clock (dense → event) | speedup |",
        "|--------|------------------------------------|----------------"
        "------------------------|---------|",
    ]
    for name, row in report["presets"].items():
        lines.append(
            f"| `{name}` | {row['ticks_per_window']} → "
            f"{row['event_budget']} ({row['step_reduction']}× fewer) | "
            f"{row['dense_wall_s']} s → {row['event_wall_s']} s | "
            f"**{row['speedup']}×** |")
    return "\n".join(lines)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--preset", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--readme", action="store_true",
                    help="print the table of the last report in the "
                         "output directory")
    args = ap.parse_args()
    if args.readme:
        print(readme_table(json.loads((OUT_DIR / REPORT).read_text())))
    else:
        main(full=args.full, preset=args.preset, device=args.device)
