"""The three-perspective divergence report across the correction ladder.

The port's counterpart of the JAX package's perspectives benchmark: for
every stage 01-10 replay one multiprogrammed mix (STREAM + GUPS on two
halves of the traffic cores: one bandwidth-bound app, one latency-bound)
with telemetry on, collect the per-window latency series each
perspective reports, and rank-correlate them
(`repro_torch.obs.perspectives`).  In the broken stages the application
view is constant (rho ~ 0); the stage-04 PI correction feeds the weave
latency back into the bound phase and the correlation jumps toward 1.

On the card every window runs one launch of `window_inject_trace` (bound
phase and injection) and one of the recording instance of
`weave_window` (telemetry).

Artifacts (``reports/torch/``, the port's output directory):

* ``perspectives[_<preset>].json`` — the divergence ladder
  (`divergence_report`), per-stage summaries (`obs.summarize`), and the
  port's wall-clock and kernel launches per stage;
* ``perspectives[_<preset>]_trace.json`` — a Perfetto / Chrome-trace
  timeline of the final stage, schema-checked by `validate_perfetto`.

Usage (on the card; ``--device cpu`` runs the plain versions, slowly):
    python -m repro_torch.bench.perspectives [--full] [--preset P]
                                             [--table]
"""
from __future__ import annotations

import json
import time

from repro_torch import kernels, obs
from repro_torch.bench.app_validation import OUT_DIR, emit
from repro_torch.core import get_stage
from repro_torch.core.platform import resolve_device, run_frontend
from repro_torch.obs.perspectives import divergence_report
from repro_torch.traces import (TraceFrontend, assign_traces, split_cores,
                                stack_mixes, to)
from repro_torch.traces.kernels import gups, stream

#: the correction ladder (00 is the native DAMOV reference, not a
#: correction step; the report starts at the reproduced baseline)
LADDER = ("01-baseline", "02-clock-scale", "03-ps-clock",
          "04-model-correct", "05-addrmap", "06-noc", "07-prefetch",
          "08-dramsim3", "09-ramulator2", "10-delay-buffer")

#: long enough that no core's trace completes inside the run (a
#: finished core's constant cursor would fake an app-view flatline)
SMOKE = dict(windows=24, warmup=8, n=1 << 14)
FULL = dict(windows=96, warmup=32, n=1 << 17)


def _suffix(preset: str) -> str:
    return "" if preset == "ddr4_2666" else f"_{preset}"


def stage_run(stage: str, preset: str, windows: int, warmup: int, n: int,
              device=None):
    """One telemetry-on mix replay: ``(cfg, views, outs)`` of
    `run_frontend` (a batch of one)."""
    dev = resolve_device(device)
    cfg = get_stage(stage, preset=preset, windows=windows, warmup=warmup,
                    telemetry=True)
    wcfg = cfg.workload_config()
    mix = assign_traces([stream(n=n), gups(n=n)],
                        split_cores(2, wcfg.n_cores), phase_offsets=None)
    fe = TraceFrontend(to(stack_mixes([mix]), dev), wcfg)
    views, outs = run_frontend(cfg, fe, batch=1, device=dev)
    return cfg, views, outs


def run_stage(stage: str, preset: str, windows: int, warmup: int, n: int,
              device=None) -> obs.TelemetryRecord:
    """One telemetry-on mix replay; returns the collected record."""
    cfg, views, outs = stage_run(stage, preset, windows, warmup, n, device)
    return obs.collect(cfg, views, outs, row=0)


def main(full: bool = False, preset: str = "ddr4_2666", device=None,
         stages=LADDER, write: bool = True) -> dict:
    """The divergence ladder over ``stages``; writes the artifacts unless
    ``write`` is False.  Returns the report (the reference's keys, plus
    ``wall_s`` and ``launches`` per stage)."""
    dev = resolve_device(device)
    knobs = FULL if full else SMOKE
    records, walls, launches = {}, {}, {}
    by_instance = kernels.weave_window.launches_by_instance
    for stage in stages:
        before, by0 = kernels.launch_counts(), dict(by_instance)
        t0 = time.perf_counter()
        records[stage] = run_stage(stage, preset, device=dev, **knobs)
        walls[stage] = time.perf_counter() - t0   # the record is on the host
        after = kernels.launch_counts()
        launches[stage] = {k: after[k] - before[k] for k in after}
        launches[stage]["weave_window_by_instance"] = {
            k: by_instance[k] - by0[k] for k in by0}
    report = divergence_report(records)
    report.update(mode="full" if full else "smoke", preset=preset,
                  **{k: knobs[k] for k in ("windows", "warmup", "n")},
                  summaries={s: obs.summarize(r)
                             for s, r in records.items()},
                  wall_s=walls, launches=launches)
    row = report["ladder"][-1]
    emit(f"perspectives{_suffix(preset)}", sum(walls.values()) * 1e6,
         f"rho_sim_app {report['ladder'][0]['rho_sim_app']:.2f} -> "
         f"{row['rho_sim_app']:.2f} across {len(stages)} stages; "
         f"monotone_ok={report['monotone_ok']}")
    if not write:
        return report
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sfx = _suffix(preset)
    with open(OUT_DIR / f"perspectives{sfx}.json", "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    # the final stage's timeline, schema-checked
    trace = obs.to_perfetto(records[stages[-1]],
                            path=OUT_DIR / f"perspectives{sfx}_trace.json")
    obs.validate_perfetto(trace)
    return report


def ladder_table(report: dict) -> str:
    """A divergence report as a markdown ladder table."""
    lines = ["| stage | rho(sim,app) | rho(sim,if) | rho(if,app) | "
             "sim lat ns | app lat ns |",
             "|-------|--------------|-------------|-------------|"
             "------------|------------|"]
    for row in report["ladder"]:
        lines.append(
            f"| {row['stage']} | {row['rho_sim_app']:+.3f} | "
            f"{row['rho_sim_if']:+.3f} | {row['rho_if_app']:+.3f} | "
            f"{row['sim_lat_ns_mean']:.1f} | {row['app_lat_ns_mean']:.1f} |")
    lines.append(f"\nmonotone_ok={report['monotone_ok']} "
                 f"end_to_end_gain={report['end_to_end_gain']} "
                 f"exceptions={report['exceptions']}")
    return "\n".join(lines)


def cli(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--preset", default="ddr4_2666")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--table", action="store_true",
                    help="print the saved report as a markdown table")
    args = ap.parse_args(argv)
    if args.table:
        path = OUT_DIR / f"perspectives{_suffix(args.preset)}.json"
        print(ladder_table(json.loads(path.read_text())))
        return None
    return main(full=args.full, preset=args.preset, device=args.device)


if __name__ == "__main__":
    cli()
