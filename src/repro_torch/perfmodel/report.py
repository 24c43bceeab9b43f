"""Roofline report from the dry-run's JSON records.

The reference's ``perfmodel/report.py`` over the port's records
(`launch.dryrun`, by default under ``reports/torch/dryrun/<mesh>/``):
the same columns and formats, the cells in ``ARCH_ORDER`` x
``SHAPE_ORDER``.  A record of a cell outside that grid (a cut shape,
as ``chip_smoke.py`` writes) follows them, by file name.

The table adds a last column, each record's ``partition`` (``exact``
on the host, ``dtensor`` for the dense and MoE families' ``pod`` /
``multipod`` cells, ``ideal`` for the others; see `launch.dryrun`).

Usage: ``python -m repro_torch.perfmodel.report [--mesh host] [--dir D]``
"""
from __future__ import annotations

import json
import pathlib

from repro_torch.configs import registry as cfgs
from repro_torch.configs.shapes import SHAPE_ORDER

DEFAULT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "reports"
               / "torch" / "dryrun")


def load_records(report_dir=DEFAULT_DIR, mesh: str = "pod") -> list:
    d = pathlib.Path(report_dir) / mesh
    if not d.is_dir():
        return []
    names = [f"{arch}__{shape}.json" for arch in cfgs.ARCH_ORDER
             for shape in SHAPE_ORDER]
    names = [n for n in names if (d / n).exists()]
    names += sorted(p.name for p in d.glob("*.json") if p.name not in names)
    return [json.loads((d / n).read_text()) for n in names]


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:7.2f}s "
    return f"{x * 1e3:7.2f}ms"


def roofline_table(records: list, *, markdown: bool = True) -> str:
    """The roofline table: three terms, bottleneck, useful ratio, and the
    record's partition."""
    hdr = ("arch", "shape", "GiB/dev", "compute", "memory", "collective",
           "bound", "useful", "frac-of-roof", "partition")
    rows = []
    for r in records:
        dom = max(r["compute_s"], r["memory_s"], r["collective_s"])
        frac = r["compute_s"] / dom if dom else 0.0
        rows.append((
            r["arch"], r["shape"],
            f"{r['bytes_per_device'] / 2 ** 30:6.2f}",
            _fmt_s(r["compute_s"]), _fmt_s(r["memory_s"]),
            _fmt_s(r["collective_s"]), r["bottleneck"],
            f"{r['useful_ratio']:5.2f}", f"{frac:5.2f}",
            r.get("partition", "?"),
        ))
    if markdown:
        lines = ["| " + " | ".join(hdr) + " |",
                 "|" + "---|" * len(hdr)]
        lines += ["| " + " | ".join(str(c) for c in row) + " |"
                  for row in rows]
        return "\n".join(lines)
    w = [max(len(str(x)) for x in col) for col in zip(hdr, *rows)]
    lines = ["  ".join(str(h).ljust(wi) for h, wi in zip(hdr, w))]
    lines += ["  ".join(str(c).ljust(wi) for c, wi in zip(row, w))
              for row in rows]
    return "\n".join(lines)


def skipped_cells() -> list:
    out = []
    for a in cfgs.ARCH_ORDER:
        for s in cfgs.skip_shapes(a):
            out.append((a, s))
    return out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--dir", default=str(DEFAULT_DIR))
    args = ap.parse_args(argv)
    recs = load_records(args.dir, args.mesh)
    print(roofline_table(recs, markdown=False))
    print(f"\n{len(recs)} cells; skipped (by design): "
          f"{skipped_cells()}")


if __name__ == "__main__":
    main()
