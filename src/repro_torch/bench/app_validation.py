"""Application-perspective validation: per-app runtime MAPE by stage.

The paper's application validation on the port: replay the DAMOV-style
application suite (`repro_torch.traces`) through the stage progression
and report, per stage, each application's predicted runtime and the
MAPE against the runtime anchors derived from the measured Mess curves
of the device preset.  Each (preset, stage) cell is one batched replay
over the application axis.  The expected shape is the paper's: the
baseline's decoupled application view makes latency-bound apps run far
too fast, and the interface corrections (stages 03-04) bring the MAPE
down.

``--mix`` runs the multiprogrammed validation instead: the named per-core
mixes of `MIXES` stacked into one batched replay per stage, each app's
in-mix runtime and MAPE against the joint mix anchors next to its solo
runtime.  ``--sockets 2`` runs either on the two-socket frontend.

Every replay runs with telemetry on, as the reference's does, so each
row also carries the interface-latency percentiles (``if_p50_ns`` /
``if_p95_ns`` / ``if_p99_ns``, per mix ``mix_if_p*_ns``) from the
``tele_hist_if_ps`` histogram; on the card the weave is then the
telemetry instance of `weave_window`.

CSV: ``<out_dir>/app_validation[_<preset>][_2s].csv`` (by default
``reports/torch/``), one row per (stage, app), and
``app_validation_mix[...]``, one row per (stage, mix, app), with the JAX
benchmark's columns.  ``main`` and ``main_mix`` are the reference's
entry points (`bench.registry`'s ``app_validation`` and ``app_mix``);
``--grid`` runs every preset.

Usage (on the card; ``--device cpu`` runs the plain versions):
    python -m repro_torch.bench.app_validation [--full] [--preset P]
        [--grid] [--mix] [--sockets N] [--device D] [--out-dir DIR]
"""
from __future__ import annotations

import csv
import pathlib
import time

from repro_torch import kernels
from repro_torch.core import get_stage
from repro_torch.core.presets import PRESET_ORDER
from repro_torch.core.shard import resolve_devices
from repro_torch.core.workload import N_CORES_PER_SOCKET
from repro_torch.obs.telemetry import hist_percentiles
from repro_torch.traces import (anchor_mix_ms, anchor_suite_ms,
                                assign_traces, make_suite, mape,
                                replay_mixes, replay_suite, split_cores,
                                stack_mixes, stack_traces, to)

STAGES = ("01-baseline", "03-ps-clock", "04-model-correct",
          "07-prefetch", "10-delay-buffer")
FAST = dict(windows=32, warmup=8, n=2048)
FULL = dict(windows=96, warmup=24, n=8192)

#: named multiprogrammed mixes (kernel names; traffic cores split
#: evenly across the apps of a mix by `split_cores`)
MIXES = (
    ("stream+chase", ("stream", "pointer_chase")),
    ("stream+gups", ("stream", "gups")),
    ("bfs+spmv+stencil", ("bfs_frontier", "spmv", "stencil3d")),
)
MIX_STAGES = ("01-baseline", "10-delay-buffer")

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "reports" / "torch"


def emit(name: str, us_per_call: float, derived: str):
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def _if_percentiles_ns(out, warmup: int, i: int):
    """p50/p95/p99 of the CPU-perceived read latency for one batch row,
    from the interface-view histogram ``tele_hist_if_ps`` (W', C, B)
    after warm-up, in ns."""
    hist = out["tele_hist_if_ps"][i, warmup:]
    return hist_percentiles(hist) * 1e-3               # ps -> ns


def _suffix(preset: str, sockets: int) -> str:
    return ("" if preset == "ddr4_2666" else f"_{preset}") + (
        "" if sockets == 1 else f"_{sockets}s")


def _write_csv(rows, name: str, out_dir=None) -> pathlib.Path:
    out_dir = pathlib.Path(OUT_DIR if out_dir is None else out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return path


def _timed(fn):
    """``fn()``'s result, its wall-clock seconds (the device synchronised)
    and the kernel launches it made."""
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0           # results are on the host
    after = kernels.launch_counts()
    return out, wall, {k: after[k] - before[k] for k in after}


def run_preset(preset: str = "ddr4_2666", full: bool = False,
               stages=STAGES, sockets: int = 1, device=None,
               out_dir=None) -> dict:
    """Validate one device preset across the stage progression.

    ``device``: as `replay.replay_suite` (``None``: the card; a list
    spreads the app axis over its devices).  Returns ``{stage:
    replay_suite(...)}``, each result with ``apps`` (the app names),
    ``anchor_ms``, ``mape_pct``, ``wall_s`` (the stage's replay, dense
    re-runs included) and ``launches`` (kernel launches during the
    stage) added.
    """
    devices = resolve_devices(device)
    knobs = FULL if full else FAST
    names, traces = make_suite(n=knobs["n"])
    batch = to(stack_traces(traces), devices[0])
    anchors = anchor_suite_ms(traces, preset, n_sockets=sockets)

    tag = f"app_validation{_suffix(preset, sockets)}"
    mtag = preset if sockets == 1 else f"{preset}_{sockets}s"
    rows, results = [], {}
    for stage in stages:
        cfg = get_stage(stage, preset=preset, windows=knobs["windows"],
                        warmup=knobs["warmup"], n_sockets=sockets,
                        telemetry=True)
        out, wall, launches = _timed(
            lambda: replay_suite(cfg, batch, device=devices))
        err = mape(out["runtime_ms"], anchors)
        out.update(apps=names, anchor_ms=anchors, mape_pct=err,
                   wall_s=wall, launches=launches)
        results[stage] = out
        emit(f"app_validation.{mtag}.{stage}.mape_pct",
             wall / len(names) * 1e6, f"{err:.1f}")
        for i, nm in enumerate(names):
            p50, p95, p99 = _if_percentiles_ns(out, knobs["warmup"], i)
            rows.append(dict(
                preset=preset, stage=stage, app=nm, sockets=sockets,
                runtime_ms=f"{out['runtime_ms'][i]:.5f}",
                anchor_ms=f"{anchors[i]:.5f}",
                err_pct=f"{100 * (out['runtime_ms'][i] / anchors[i] - 1):.1f}",
                sim_lat_ns=f"{out['sim_lat_ns'][i]:.1f}",
                if_lat_ns=f"{out['if_lat_ns'][i]:.1f}",
                if_p50_ns=f"{p50:.1f}", if_p95_ns=f"{p95:.1f}",
                if_p99_ns=f"{p99:.1f}",
                app_lat_ns=f"{out['app_lat_ns'][i]:.1f}",
                sim_bw_gbs=f"{out['sim_bw_gbs'][i]:.1f}",
            ))
    _write_csv(rows, tag, out_dir)
    first, last = (results[s]["mape_pct"] for s in (stages[0], stages[-1]))
    emit(f"app_validation.{mtag}.baseline_vs_corrected",
         sum(r["wall_s"] for r in results.values())
         / (len(stages) * len(names)) * 1e6,
         f"{first:.1f} -> {last:.1f} (MAPE %, decoupling fixed)")
    return results


def run_mixes(preset: str = "ddr4_2666", full: bool = False,
              stages=MIX_STAGES, sockets: int = 1, device=None,
              out_dir=None) -> dict:
    """Multiprogrammed validation: per-app-in-mix runtime MAPE.

    All mixes of `MIXES` replay as one batched call per stage, and each
    app's in-mix runtime is reported next to its solo runtime from the
    same stage.  Returns ``{stage: replay_mixes(...)}``, each with
    ``mix_mape_pct`` (one MAPE per mix), ``anchor_ms`` (per mix), the
    solo replay's ``solo_runtime_ms`` and ``wall_s`` added.
    """
    devices = resolve_devices(device)
    knobs = FULL if full else FAST
    n_cores = N_CORES_PER_SOCKET * sockets

    built = []          # (mix_name, app_names, traces, cores_per_app)
    for mix_name, names in MIXES:
        names, traces = make_suite(n=knobs["n"], names=names)
        asn = split_cores(len(traces), n_cores)
        cores = [asn.count(a) for a in range(len(traces))]
        built.append((mix_name, names, traces, cores,
                      assign_traces(traces, asn)))
    mix_batch = to(stack_mixes([b[4] for b in built]), devices[0])
    anchors = [anchor_mix_ms(traces, cores, preset, n_sockets=sockets)
               for _, _, traces, cores, _ in built]

    # solo baselines: only the kernels that appear in a mix
    used = tuple(dict.fromkeys(k for _, ks in MIXES for k in ks))
    solo_names, solo_traces = make_suite(n=knobs["n"], names=used)
    solo_batch = to(stack_traces(solo_traces), devices[0])
    solo_anchor = dict(zip(solo_names, anchor_suite_ms(
        solo_traces, preset, n_sockets=sockets)))

    mtag = preset if sockets == 1 else f"{preset}_{sockets}s"
    rows, results = [], {}
    for stage in stages:
        cfg = get_stage(stage, preset=preset, windows=knobs["windows"],
                        warmup=knobs["warmup"], n_sockets=sockets,
                        telemetry=True)
        (out, solo), wall, _ = _timed(lambda: (
            replay_mixes(cfg, mix_batch, device=devices),
            replay_suite(cfg, solo_batch, device=devices)))
        us = wall / len(built) * 1e6
        solo_rt = dict(zip(solo_names, solo["runtime_ms"]))
        errs = []
        for m, (mix_name, names, _, cores, _) in enumerate(built):
            pred = out["app_runtime_ms"][m, :len(names)]
            errs.append(mape(pred, anchors[m]))
            emit(f"app_mix.{mtag}.{stage}.{mix_name}.mape_pct", us,
                 f"{errs[-1]:.1f}")
            p50, p95, p99 = _if_percentiles_ns(out, knobs["warmup"], m)
            for a, nm in enumerate(names):
                rows.append(dict(
                    preset=preset, stage=stage, mix=mix_name, app=nm,
                    sockets=sockets, cores=cores[a],
                    runtime_ms=f"{pred[a]:.5f}",
                    anchor_ms=f"{anchors[m][a]:.5f}",
                    err_pct=f"{100 * (pred[a] / anchors[m][a] - 1):.1f}",
                    solo_runtime_ms=f"{solo_rt[nm]:.5f}",
                    solo_anchor_ms=f"{solo_anchor[nm]:.5f}",
                    mix_bw_gbs=f"{out['sim_bw_gbs'][m]:.1f}",
                    mix_if_p50_ns=f"{p50:.1f}", mix_if_p95_ns=f"{p95:.1f}",
                    mix_if_p99_ns=f"{p99:.1f}",
                ))
        out.update(mixes=[(b[0], b[1]) for b in built], anchor_ms=anchors,
                   mix_mape_pct=errs, solo_runtime_ms=solo_rt, wall_s=wall)
        results[stage] = out
    _write_csv(rows, f"app_validation_mix{_suffix(preset, sockets)}",
               out_dir)
    return results


def main(full: bool = False, preset: str = "ddr4_2666", grid: bool = False,
         mix: bool = False, sockets: int = 1, device=None,
         out_dir=None) -> dict:
    """The reference's entry point: ``{preset: run_preset(...)}`` (or
    `run_mixes` with ``mix``) for ``preset``, or every preset with
    ``grid``."""
    presets = PRESET_ORDER if grid else (preset,)
    run = run_mixes if mix else run_preset
    return {p: run(p, full=full, sockets=sockets, device=device,
                   out_dir=out_dir)
            for p in presets}


def main_mix(full: bool = False, **kw) -> dict:
    """The multiprogrammed-mix entry point (``app_mix``): `main` with
    ``mix``, over every preset unless ``grid=False``."""
    kw.setdefault("grid", True)
    return main(full=full, mix=True, **kw)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--preset", default="ddr4_2666",
                    choices=list(PRESET_ORDER))
    ap.add_argument("--grid", action="store_true",
                    help="run the full preset x stage x app grid")
    ap.add_argument("--mix", action="store_true",
                    help="multiprogrammed per-core trace mixes")
    ap.add_argument("--sockets", type=int, default=1, choices=(1, 2))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out-dir", default=OUT_DIR,
                    help="directory of the CSVs (default: reports/torch)")
    args = ap.parse_args()
    main(full=args.full, preset=args.preset, grid=args.grid, mix=args.mix,
         sockets=args.sockets, device=args.device, out_dir=args.out_dir)
