"""Roofline bench: summarize the dry-run records.

The port's counterpart of the JAX package's
``benchmarks/roofline_bench.py``.  Reads ``<report_dir>/<mesh>/*.json``
(written by ``python -m repro_torch.launch.dryrun``; by default under
``reports/torch/dryrun/``) for the ``pod``, ``multipod`` and ``host``
meshes and emits one row per record with its roofline terms, or a
``NO RECORDS`` row for a mesh that has none; each row names its
record's partition (``exact``, ``dtensor`` or ``ideal``).  It counts
nothing itself: the dry-run is the expensive step, and its records are
cached.
``bench.run --only roofline --out-dir D`` reads the records under ``D``.
"""
from __future__ import annotations

from repro_torch.bench.util import emit
from repro_torch.perfmodel.report import DEFAULT_DIR, load_records

MESHES = ("pod", "multipod", "host")


def main(full: bool = False, report_dir=None):
    for mesh in MESHES:
        recs = load_records(report_dir or DEFAULT_DIR, mesh=mesh)
        if not recs:
            emit(f"roofline.{mesh}", 0.0,
                 "NO RECORDS — run python -m repro_torch.launch.dryrun "
                 "--all")
            continue
        for r in recs:
            dom = max(r["compute_s"], r["memory_s"], r["collective_s"])
            emit(f"roofline.{mesh}.{r['arch']}.{r['shape']}",
                 r["compile_s"] * 1e6,
                 f"bound={r['bottleneck']} "
                 f"compute={r['compute_s'] * 1e3:.1f}ms "
                 f"memory={r['memory_s'] * 1e3:.1f}ms "
                 f"collective={r['collective_s'] * 1e3:.1f}ms "
                 f"useful={r['useful_ratio']:.2f} "
                 f"frac={r['compute_s'] / dom if dom else 0:.3f} "
                 f"GiB/dev={r['bytes_per_device'] / 2 ** 30:.2f} "
                 f"partition={r.get('partition', '?')}")


if __name__ == "__main__":
    main()
