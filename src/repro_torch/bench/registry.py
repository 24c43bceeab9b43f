"""One registry of the port's benchmark entry points.

The port's counterpart of the JAX package's ``benchmarks/registry.py``:
every benchmark module under ``repro_torch.bench`` exposes
``main(full: bool = False, **kw)``, and `bench.run` runs them by name
(``--only``) or lists them (``--list``).  The artifacts go to the
caller's output directory (``out_dir``; by default ``reports/torch/``),
never to the reference's tracked ``reports/benchmarks/``.

The names and descriptions are the reference's, but for two: there is
no ``roofline`` yet (its records come from the dry-run, which the port
does not have), and ``kernels`` times the hand-written CUDA kernels on
the card.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable


@dataclasses.dataclass(frozen=True)
class BenchSpec:
    """One benchmark entry point.

    ``module`` is imported lazily (the benchmarks' imports stay off the
    registry's import path); ``reports`` are the CSV / JSON artifact
    globs the benchmark writes into its output directory.
    """

    name: str
    module: str                       # dotted module with main(full=...)
    description: str
    reports: tuple = ()               # artifact globs in the output dir
    main_attr: str = "main"           # entry point inside the module

    @property
    def main(self) -> Callable:
        return getattr(importlib.import_module(self.module),
                       self.main_attr)


#: sorted by name, so `run --list` prints a stable alphabetized listing
BENCHMARKS: dict[str, BenchSpec] = {s.name: s for s in sorted((
    BenchSpec("cmd_oracle", "repro_torch.bench.cmd_oracle",
              "command-level differential oracle: dense vs event "
              "cmd_trace streams identical + JEDEC-legal across the "
              "preset x stage x app grid",
              ("cmd_oracle*.json", "cmd_oracle*.cmd.trace")),
    BenchSpec("fig2", "repro_torch.bench.fig2_baseline",
              "baseline three-view characterization (per preset)",
              ("fig2_baseline*.csv",)),
    BenchSpec("fig3_fig4", "repro_torch.bench.fig3_fig4_clocking",
              "clock-scaling progression (Fig. 3/4)",
              ("fig3*.csv", "fig4*.csv")),
    BenchSpec("fig5", "repro_torch.bench.fig5_model_correct",
              "PI-controlled immediate response (Fig. 5)",
              ("fig5*.csv",)),
    BenchSpec("fig6", "repro_torch.bench.fig6_enhancements",
              "addrmap / NOC / prefetch enhancements (Fig. 6)",
              ("fig6*.csv",)),
    BenchSpec("fig7", "repro_torch.bench.fig7_portability",
              "backend-flavor portability (Fig. 7)",
              ("fig7*.csv",)),
    BenchSpec("kernels", "repro_torch.bench.kernels_bench",
              "hand-written CUDA kernel micro-benchmarks on the card",
              ()),
    BenchSpec("serving", "repro_torch.bench.serving",
              "LLM-serving traffic on the memory platform: model x "
              "preset x arrival-rate grid, per-request latency and "
              "interface p50/p95/p99 under contention",
              ("BENCH_serve.json",)),
    BenchSpec("app_validation", "repro_torch.bench.app_validation",
              "per-app runtime MAPE vs per-preset anchors "
              "(--preset / --grid / --sockets)",
              ("app_validation.csv", "app_validation_[0-9]s.csv",
               "app_validation_ddr5*.csv", "app_validation_hbm2e*.csv")),
    BenchSpec("app_mix", "repro_torch.bench.app_validation",
              "multiprogrammed per-core trace mixes: per-app-in-mix "
              "runtime MAPE next to solo numbers (--mix mode)",
              ("app_validation_mix*.csv",), main_attr="main_mix"),
    BenchSpec("perspectives", "repro_torch.bench.perspectives",
              "three-perspective divergence ladder: per-window rank "
              "correlation of sim/if/app views across stages 01->10, "
              "plus a Perfetto timeline of the final stage",
              ("perspectives*.json",)),
    BenchSpec("weave", "repro_torch.bench.weave_bench",
              "dense vs event-horizon weave engine: compiled sweep "
              "wall-clock, scan steps/window, event-budget headroom",
              ("BENCH_weave.json",)),
), key=lambda s: s.name)}


def get_benchmark(name: str) -> BenchSpec:
    try:
        return BENCHMARKS[name]
    except KeyError:
        raise ValueError(
            f"unknown benchmark {name!r}; one of {list(BENCHMARKS)}"
        ) from None
