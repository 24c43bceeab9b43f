"""Benchmark aggregator: one section per paper figure / table.

The port's counterpart of the JAX package's ``benchmarks/run.py``.
Prints ``name,us_per_call,derived`` CSV rows, and the total on stderr.
``--full`` runs the paper-resolution sweeps (14 paces x 5 mixes, 96
windows); the default is CI-speed (6 paces x 3 mixes, 48 windows).  The
benchmark set comes from `bench.registry` (``--list`` shows it; an
unknown ``--only`` name raises).  ``--preset``, ``--device`` and
``--out-dir`` go to each benchmark whose ``main`` takes them: the
artifacts land in ``--out-dir`` (by default each benchmark's
``reports/torch/``, never the reference's ``reports/benchmarks/``), and
``roofline`` reads the dry-run's records from it (its ``report_dir``).

Usage (on the card; ``--device cpu`` runs the CPU)::

    python -m repro_torch.bench.run --list
    python -m repro_torch.bench.run --only fig5,kernels --out-dir DIR
"""
from __future__ import annotations

import argparse
import inspect
import sys
import time

from repro_torch.bench.registry import BENCHMARKS, get_benchmark


def _takes(fn, name: str) -> bool:
    params = inspect.signature(fn).parameters
    return name in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated bench names (fig2,...)")
    ap.add_argument("--preset", default=None,
                    help="device preset for preset-aware benchmarks")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--out-dir", default=None,
                    help="directory of the artifacts (default: each "
                         "benchmark's reports/torch; for roofline, the "
                         "dry-run's records)")
    ap.add_argument("--list", action="store_true",
                    help="list registered benchmarks and exit")
    args = ap.parse_args(argv)

    if args.list:
        for spec in BENCHMARKS.values():
            print(f"{spec.name:16s} {spec.description}")
        return

    names = args.only.split(",") if args.only else list(BENCHMARKS)
    specs = [get_benchmark(n) for n in names]
    print("name,us_per_call,derived", flush=True)
    t0 = time.time()
    for spec in specs:
        print(f"# --- {spec.name} ---", file=sys.stderr)
        fn = spec.main
        kw = {k: v for k, v in (("preset", args.preset),
                                ("device", args.device),
                                ("out_dir", args.out_dir))
              if v is not None and _takes(fn, k)}
        # the roofline bench reads the dry-run's records from --out-dir
        if (args.out_dir is not None
                and "report_dir" in inspect.signature(fn).parameters):
            kw["report_dir"] = args.out_dir
        fn(full=args.full, **kw)
    print(f"# total {time.time() - t0:.0f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
