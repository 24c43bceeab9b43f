"""Command-level differential oracle: both engines, every DRAM rule.

The port's counterpart of the JAX package's command-oracle benchmark.
For a grid of preset x stage x app cells it replays the same workload
through the dense and the event-horizon weave engines with
``StageConfig(cmd_trace=True)``, flattens both recorded streams
(`repro_torch.oracle.extract_stream`), and asserts:

* **stream equality** — `diff_streams` finds no divergence between the
  engines, row for row;
* **protocol legality** — `check_stream` replays the stream against the
  preset's `DramParams` and every rule of `RULES` holds, refresh
  deadlines included;
* **stats agreement** — per-channel bandwidth and command mixes
  (`stream_stats`) match between the engines.

On the card each window runs in the command-recording instance of
`weave_window`.  The DDR4 cells run enough windows to cross ``tREFI``;
DDR5 fires per-bank refreshes (REFsb) within a handful of windows.

Artifacts (``reports/torch/``): ``cmd_oracle.json``, the per-cell report,
and ``cmd_oracle_ddr4_2666.cmd.trace``, one exported command trace
schema-checked by `repro_torch.obs.export.validate_cmd_trace`.

Usage (on the card; ``--device cpu`` runs the plain versions, slowly):
    python -m repro_torch.bench.cmd_oracle [--full]
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.bench.app_validation import OUT_DIR, emit
from repro_torch.core import get_stage
from repro_torch.core.platform import resolve_device, run_frontend
from repro_torch.core.workload import MessFrontend
from repro_torch.obs.export import to_cmd_trace, validate_cmd_trace
from repro_torch.oracle import (check_stream, diff_streams, extract_stream,
                                stream_stats)
from repro_torch.traces import (TraceFrontend, assign_traces, split_cores,
                                stack_mixes, stack_traces, to)
from repro_torch.traces.kernels import gups, stream


def mess(pace, wr):
    """A Mess operating point: ``build(cfg, dev)`` runs it."""
    def build(cfg, dev):
        p = torch.tensor([pace], dtype=torch.int32, device=dev)
        fe = MessFrontend(p, torch.full_like(p, wr), cfg.workload_config())
        return run_frontend(cfg, fe, batch=1, device=dev)

    build.app = f"mess-p{pace}w{wr}"
    return build


def solo(n):
    """One STREAM trace on every traffic core."""
    trace = stream(n=n)

    def build(cfg, dev):
        fe = TraceFrontend(to(stack_traces([trace]), dev),
                           cfg.workload_config())
        return run_frontend(cfg, fe, batch=1, device=dev)

    build.app = "solo-stream"
    build.full_budget = True
    return build


def mix(n):
    """STREAM and GUPS on two halves of the traffic cores."""
    apps = [stream(n=n), gups(n=n)]

    def build(cfg, dev):
        m = assign_traces(apps, split_cores(2, cfg.workload_config().n_cores),
                          phase_offsets=None)
        fe = TraceFrontend(to(stack_mixes([m]), dev), cfg.workload_config())
        return run_frontend(cfg, fe, batch=1, device=dev)

    build.app = "mix-stream-gups"
    build.full_budget = True
    return build


#: (stage, preset, app builder, windows) — windows chosen so every
#: preset crosses its refresh interval at least once (DDR4's
#: tREFI=10400 ticks needs ~17 windows of ~635 ticks; HBM2e ~9;
#: DDR5's per-bank tREFI=292 fires within the first window).
SMOKE = [
    ("01-baseline", "ddr4_2666", mess(8, 16), 20),
    ("10-delay-buffer", "ddr4_2666", mix(192), 20),
    ("04-model-correct", "ddr5_4800", solo(256), 6),
    ("09-ramulator2", "ddr5_4800", mess(8, 32), 6),
    ("04-model-correct", "hbm2e", mix(192), 12),
    ("10-delay-buffer", "hbm2e", mess(16, 0), 12),
]
FULL = SMOKE + [
    ("02-clock-scale", "ddr4_2666", solo(512), 24),
    ("05-addrmap", "ddr4_2666", mess(4, 0), 24),
    ("08-dramsim3", "ddr5_4800", mix(256), 12),
    ("09-ramulator2", "hbm2e", solo(512), 16),
]


def cell_config(stage, preset, frontend, windows, weave):
    """The recording `StageConfig` of one cell on one engine."""
    cfg = get_stage(stage, preset=preset, windows=windows,
                    warmup=max(windows // 5, 1), weave=weave,
                    cmd_trace=True)
    if weave == "event" and getattr(frontend, "full_budget", False):
        cfg = dataclasses.replace(
            cfg, weave_events=cfg.clock().ticks_per_window_static)
    return cfg


def record(stage, preset, frontend, windows, weave, device=None):
    """One engine's run of a cell: ``(cfg, views, stream)``, the views of
    the one point on the host."""
    dev = resolve_device(device)
    cfg = cell_config(stage, preset, frontend, windows, weave)
    views, _ = frontend(cfg, dev)
    views = {k: v[0].cpu() for k, v in views.items()}
    return cfg, views, extract_stream(views, cfg.platform.dram)


def run_cell(stage, preset, frontend, windows, device=None):
    """One preset x stage x app cell: record on both engines, check."""
    streams, views, walls = {}, {}, {}
    for weave in ("dense", "event"):
        t0 = time.perf_counter()
        cfg, views[weave], streams[weave] = record(
            stage, preset, frontend, windows, weave, device)
        walls[weave] = time.perf_counter() - t0
    end_tick = int(cfg.clock().window_end_tick(cfg.windows - 1))

    diff = diff_streams(streams["dense"], streams["event"])
    rep = check_stream(streams["dense"], end_tick=end_tick)
    stats = {w: stream_stats(s, span_ticks=end_tick)
             for w, s in streams.items()}
    bw_delta = float(np.max(np.abs(stats["dense"]["bw_gbs"]
                                   - stats["event"]["bw_gbs"])))
    mix_agree = all(
        (stats["dense"][k] == stats["event"][k]).all()
        for k in ("RD", "WR", "ACT", "PRE", "REF"))
    sat = sum(int(v["weave_sat"].sum()) for v in views.values())
    cell = dict(
        stage=stage, preset=preset, app=frontend.app, windows=windows,
        end_tick=end_tick, n_commands=len(streams["dense"]),
        counts=streams["dense"].counts(), n_checked=rep.n_checked,
        violation_counts=rep.violation_counts,
        streams_identical=diff is None, diff=diff,
        legal_ok=rep.ok, mix_agree=bool(mix_agree),
        bw_delta_gbs=bw_delta, weave_sat=sat,
        bw_gbs=[round(float(x), 3)
                for x in stats["dense"]["bw_gbs"]],
        wall_s=walls,
        ok=bool(diff is None and rep.ok and mix_agree
                and bw_delta == 0.0 and sat == 0))
    return cell, streams["dense"]


def main(full: bool = False, device=None) -> dict:
    """Every cell of `SMOKE` (or `FULL`); writes the artifacts.  Raises
    when a cell fails."""
    dev = resolve_device(device)
    cells, export_stream = [], None
    for stage, preset, frontend, windows in (FULL if full else SMOKE):
        cell, s = run_cell(stage, preset, frontend, windows, dev)
        cells.append(cell)
        if preset == "ddr4_2666" and export_stream is None:
            export_stream = (s, preset)
        emit(f"cmd_oracle/{preset}/{stage}/{cell['app']}",
             sum(cell["wall_s"].values()) * 1e6,
             f"{'ok' if cell['ok'] else 'FAIL'} cmds={cell['n_commands']} "
             f"checked={sum(cell['n_checked'].values())} "
             f"ref={cell['counts']['REF']}")

    report = dict(schema="repro.oracle/cmd-oracle-v1",
                  mode="full" if full else "smoke",
                  all_ok=all(c["ok"] for c in cells), cells=cells)
    # one exported Ramulator2-style trace, schema-gated
    s, preset = export_stream
    path = OUT_DIR / f"cmd_oracle_{preset}.cmd.trace"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with open(OUT_DIR / "cmd_oracle.json", "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    text = to_cmd_trace(s, path=path, preset=preset)
    report["exported_rows"] = validate_cmd_trace(text)
    emit("cmd_oracle", 0.0, f"all_ok={report['all_ok']} cells={len(cells)} "
         f"exported={path.name}")
    if not report["all_ok"]:
        raise SystemExit("cmd_oracle: a grid cell failed "
                         f"(see {OUT_DIR / 'cmd_oracle.json'})")
    return report


def cli(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    return main(full=args.full, device=args.device)


if __name__ == "__main__":
    cli()
