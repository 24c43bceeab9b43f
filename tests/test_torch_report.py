"""The port's roofline report (`repro_torch.perfmodel.report`) against
the JAX package's on the same synthetic records: `roofline_table` in
both forms returns the reference's text with one column more, each
record's partition, last; `load_records` the reference's records in its
order (a cut cell's record after them), `skipped_cells` and `main` the
reference's (the table's last column aside)."""
import json
import sys

import numpy as np
import pytest

from repro.perfmodel import report as ref
from repro_torch.configs import registry as cfgs
from repro_torch.perfmodel import report


def synthetic_records(seed=0):
    """One record per dry-run cell with random terms: seconds on both
    sides of 1 s, every bottleneck, a zero row."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (arch, shape) in enumerate(cfgs.cells()):
        terms = 10.0 ** rng.uniform(-6, 1.5, 3)
        if i == 3:
            terms[:] = 0.0
        names = ("compute", "memory", "collective")
        out.append(dict(
            arch=arch, shape=shape, mesh="pod", chips=256,
            compute_s=float(terms[0]), memory_s=float(terms[1]),
            collective_s=float(terms[2]),
            bottleneck=names[int(np.argmax(terms))],
            useful_ratio=float(rng.uniform(0, 1.2)),
            bytes_per_device=float(rng.uniform(0, 80) * 2 ** 30),
            compile_s=float(rng.uniform(0, 100))))
    return out


def without_partition(text: str, markdown: bool) -> str:
    """``text`` (the port's table, maybe followed by other lines) with
    its last column, ``partition``, taken out."""
    lines = text.split("\n")
    if markdown:
        return "\n".join(
            line[:-len("---|")] if line.startswith("|---") else
            line.rsplit(" | ", 1)[0] + " |" if line.startswith("| ") else
            line for line in lines)
    cut = lines[0].rindex("partition") - 2
    n = next((i for i, line in enumerate(lines) if not line), len(lines))
    return "\n".join([line[:cut] for line in lines[:n]] + lines[n:])


@pytest.mark.parametrize("markdown", [True, False])
def test_roofline_table_is_the_references(markdown):
    recs = synthetic_records()
    for i, r in enumerate(recs):
        r["partition"] = ("exact", "dtensor", "ideal")[i % 3]
    got = report.roofline_table(recs, markdown=markdown)
    assert without_partition(got, markdown) == \
        ref.roofline_table(recs, markdown=markdown)
    rows = got.splitlines()[1 + markdown:]
    assert len(rows) == len(recs)
    assert [row.split()[-1 - markdown] for row in rows] == \
        [r["partition"] for r in recs]
    assert without_partition(report.roofline_table([], markdown=markdown),
                             markdown) == \
        ref.roofline_table([], markdown=markdown)


def test_skipped_cells_are_the_references():
    assert report.skipped_cells() == ref.skipped_cells()


def _write(d, mesh, recs):
    (d / mesh).mkdir(parents=True, exist_ok=True)
    for r in recs:
        (d / mesh / f"{r['arch']}__{r['shape']}.json").write_text(
            json.dumps(r))


def test_load_records_and_main_are_the_references(tmp_path, capsys,
                                                  monkeypatch):
    recs = synthetic_records(1)
    rng = np.random.default_rng(2)
    picked = [recs[i] for i in sorted(rng.choice(len(recs), 12,
                                                 replace=False))]
    # written out of order: the readers sort by ARCH_ORDER x SHAPE_ORDER
    _write(tmp_path, "pod", picked[::-1])
    assert report.load_records(tmp_path, "pod") == \
        ref.load_records(str(tmp_path), "pod") == picked
    assert report.load_records(tmp_path, "multipod") == \
        ref.load_records(str(tmp_path), "multipod") == []

    report.main(["--mesh", "pod", "--dir", str(tmp_path)])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["report", "--mesh", "pod", "--dir",
                                      str(tmp_path)])
    ref.main()
    assert got.split("\n")[0].split()[-1] == "partition"
    assert without_partition(got, markdown=False) == capsys.readouterr().out

    # a cut shape's record (as chip_smoke.py writes) follows the grid
    cut = dict(picked[0], shape="train_2k_b4")
    _write(tmp_path, "pod", [cut])
    assert report.load_records(tmp_path, "pod") == picked + [cut]
    assert ref.load_records(str(tmp_path), "pod") == picked
