"""LLM inference serving replayed through the memory presets.

The port's counterpart of the JAX package's serving benchmark: for each
device preset, lower a model x arrival-rate grid of continuous-batching
serving scenarios (`repro_torch.traces.llm`) into traces and replay
them through the platform in ONE batched `replay_suite` call: the
scenario axis is the batch axis, so every cell of a preset shares one
launch of each kernel per window.  The replay runs stage 10 with
telemetry on the event engine under a budget that covers a whole
window's ticks (serving traffic is MSHR-hot: the covering-budget
contract keeps it bit-identical to the dense engine).  On the card each
window is one launch of `window_inject_trace` (bound phase and
injection) and one of the telemetry instance of `weave_window`.

Reported per cell (the application + interface perspectives):

* ``req_p50/p95/p99_ms`` — per-request arrival-to-completion latency
  under memory contention (`request_latencies_ms`: scheduler steps
  priced at the replayed service rate).
* ``if_p50/p95/p99_ns``  — memory interface latency percentiles from
  the in-kernel telemetry histograms (`repro_torch.obs.hist_percentiles`).
* ``runtime_ms``, ``gbps`` — schedule service time and achieved
  traffic bandwidth.
* beside the reference's keys: ``replay_wall_s``, the preset's whole
  replay wall, and ``launches``, its kernel launches by kernel and by
  `weave_window` instance.

Artifact: ``BENCH_serve.json`` (schema ``serving-v1``, the reference's
keys) in the output directory, by default ``reports/torch/``.

Usage (on the card; ``--device cpu`` runs the plain versions, slowly):
    python -m repro_torch.bench.serving [--full] [--device D]
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import numpy as np

from repro_torch import kernels
from repro_torch.bench.util import OUT_DIR, emit
from repro_torch.configs.registry import get_config
from repro_torch.core import get_stage
from repro_torch.core.platform import resolve_device
from repro_torch.kernels.weave_window import weave_window
from repro_torch.obs import hist_percentiles
from repro_torch.traces import (ServeScenario, lower_scenario,
                                request_latencies_ms, replay_suite,
                                stack_traces, to)

#: smoke grid (CI): 2 models x 2 presets x 2 arrival rates
SMOKE_MODELS = ("tinyllama-1.1b", "qwen2-72b")
SMOKE_PRESETS = ("ddr5_4800", "hbm2e")
SMOKE_RATES = (0.25, 1.0)

FULL_MODELS = ("tinyllama-1.1b", "qwen2-72b", "arctic-480b",
               "zamba2-2.7b")
FULL_PRESETS = ("ddr4_2666", "ddr5_4800", "hbm2e")
FULL_RATES = (0.25, 0.5, 1.0)

STAGE = "10-delay-buffer"
QS = (0.5, 0.95, 0.99)


def _stage_cfg(preset: str, *, windows: int, telemetry: bool = True):
    """Serving replay runs MSHR-hot: an event budget of a whole window's
    ticks (the covering-budget contract of the serving golden grid)."""
    cfg = get_stage(STAGE, preset=preset, windows=windows,
                    warmup=max(2, windows // 3), telemetry=telemetry)
    return dataclasses.replace(
        cfg, weave_events=cfg.clock().ticks_per_window_static)


def cell_percentiles(out: dict, a: int) -> dict:
    """Interface-latency percentiles for stacked-trace row ``a`` (every
    window and channel of its ``tele_hist_if_ps``)."""
    hist = np.asarray(out["tele_hist_if_ps"][a])
    ps = hist_percentiles(hist, QS)
    return {f"if_p{int(q * 100)}_ns": float(v) / 1e3
            for q, v in zip(QS, ps)}


def kernel_launches() -> dict:
    """Launch counters by kernel, and `weave_window`'s by instance
    (``weave_window.<instance>``)."""
    out = kernels.launch_counts()
    out.update({f"weave_window.{k}": v for k, v in
                weave_window.launches_by_instance.items()})
    return out


def lower_grid(models, rates, *, arrival: str = "poisson",
               n_requests: int = 12, n_slots: int = 4):
    """The grid's scenarios (model-major, then rate) and their lowerings,
    ``(scenarios, [(trace, schedule, info), ...])``; CPU traces."""
    scns = [ServeScenario(model=get_config(m), arrival=arrival, rate=r,
                          n_requests=n_requests, n_slots=n_slots,
                          seed=17 * i)
            for i, (m, r) in enumerate(
                (m, r) for m in models for r in rates)]
    return scns, [lower_scenario(s) for s in scns]


def serve_grid(models, presets, rates, *, arrival: str = "poisson",
               n_requests: int = 12, n_slots: int = 4,
               windows: int = 6, device=None) -> list[dict]:
    """Lower + replay the grid; one batched replay per preset on
    ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    cells = []
    scns, lowered = lower_grid(models, rates, arrival=arrival,
                               n_requests=n_requests, n_slots=n_slots)
    batch = to(stack_traces([tr for tr, _, _ in lowered]), dev)
    for preset in presets:
        cfg = _stage_cfg(preset, windows=windows)
        before = kernel_launches()
        t0 = time.perf_counter()
        out = replay_suite(cfg, batch, device=dev)
        wall = time.perf_counter() - t0       # the results are on the host
        after = kernel_launches()
        launches = {k: after[k] - before[k] for k in after}
        for a, (scn, (tr, sched, info)) in enumerate(zip(scns, lowered)):
            rt = float(out["runtime_ms"][a])
            lat = request_latencies_ms(sched, info, rt)
            p50, p95, p99 = np.percentile(lat, [50, 95, 99])
            cell = dict(
                model=scn.model.name, preset=preset,
                arrival=scn.arrival, rate=scn.rate,
                n_requests=scn.n_requests, n_slots=scn.n_slots,
                steps=int(sched.steps), accesses=int(info["accesses"]),
                shard=int(info["shard"]),
                bytes_modeled=int(info["bytes_modeled"]),
                runtime_ms=rt,
                gbps=info["bytes_modeled"] / info["shard"] / (rt * 1e6),
                req_p50_ms=float(p50), req_p95_ms=float(p95),
                req_p99_ms=float(p99),
                wall_s_cell=wall / len(scns),
                **cell_percentiles(out, a),
                replay_wall_s=wall, launches=launches)
            cells.append(cell)
    return cells


def main(full: bool = False, device=None, out_dir=OUT_DIR) -> list[dict]:
    models = FULL_MODELS if full else SMOKE_MODELS
    presets = FULL_PRESETS if full else SMOKE_PRESETS
    rates = FULL_RATES if full else SMOKE_RATES
    n_requests = 24 if full else 12
    windows = 12 if full else 6
    cells = serve_grid(models, presets, rates, n_requests=n_requests,
                       windows=windows, device=device)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "BENCH_serve.json"
    with open(path, "w") as f:
        json.dump(dict(schema="serving-v1", stage=STAGE,
                       models=list(models), presets=list(presets),
                       rates=list(rates), cells=cells), f, indent=1)
    for c in cells:
        emit(f"serve_{c['model']}_{c['preset']}_r{c['rate']}",
             c["wall_s_cell"] * 1e6,
             f"req_p50={c['req_p50_ms']:.3f}ms "
             f"req_p99={c['req_p99_ms']:.3f}ms "
             f"if_p99={c['if_p99_ns']:.0f}ns "
             f"bw={c['gbps']:.1f}GB/s")
    print(f"wrote {path} ({len(cells)} cells)")
    return cells


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    main(full=args.full, device=args.device)
