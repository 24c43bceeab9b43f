"""The paper's figure sweeps on the port: `weave_budgets`, the figure
scripts' derived numbers and CSVs, `run_sweep` and the weave-engine
bench against the JAX package's.

The reference's figure scripts write into the repository's tracked
``reports/benchmarks/``, so they are never run as they stand: each is
fed a prepared `SweepResult` through its own module namespace
(``run_sweep``, ``write_csv`` and ``emit`` replaced), and the port's
script the same arrays, writing its CSVs to a temporary directory.
"""
import csv
import importlib
import io
import os
import sys
import zlib

import numpy as np
import pytest
import torch

from repro.core import get_stage as ref_get_stage
from repro.core import mess as ref_mess
from repro.core import presets as ref_presets
from repro_torch.bench import util, weave_bench
from repro_torch.core import get_stage, mess, presets

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6
VIEWS = ("sim_bw", "sim_lat", "if_bw", "if_lat", "app_bw", "app_lat",
         "chase_lat")


def _reference(name):
    """A module of the reference's ``benchmarks`` package."""
    sys.path.insert(0, ROOT)
    try:
        return importlib.import_module(f"benchmarks.{name}")
    finally:
        sys.path.remove(ROOT)


@pytest.mark.parametrize("preset", presets.PRESET_ORDER)
def test_weave_budgets_match_reference(preset):
    assert presets.weave_budgets(preset) == ref_presets.weave_budgets(preset)


def test_unloaded_ns_matches_reference():
    from repro.core import reference as ref_reference
    from repro_torch.core import reference

    assert reference.UNLOADED_NS == ref_reference.UNLOADED_NS


# ------------------------------------------------------ figure scripts

def _views(stage, preset):
    """Seeded positive (mixes, paces) arrays for one stage and preset."""
    rng = np.random.default_rng(zlib.crc32(f"{stage}/{preset}".encode()))
    shape = (len(util.FAST_MIXES), len(util.FAST_PACES))
    return {v: rng.uniform(20.0, 400.0, shape).astype(np.float32)
            for v in VIEWS}


def _fake_sweep(result_cls, calls):
    def run_sweep(stage, *, full=False, preset="ddr4_2666", **kw):
        calls.append((stage, full, preset))
        return result_cls(stage=stage, write_mixes=util.FAST_MIXES,
                          paces=util.FAST_PACES,
                          **_views(stage, preset)), 12.5
    return run_sweep


def _csv_text(rows):
    f = io.StringIO(newline="")
    w = csv.DictWriter(f, fieldnames=list(rows[0]))
    w.writeheader()
    w.writerows(rows)
    return f.getvalue()


def _read(path):
    with open(path, newline="") as f:
        return f.read()


FIGURES = [("fig2_baseline", dict(preset=p)) for p in presets.PRESET_ORDER]
FIGURES += [(f, {}) for f in ("fig3_fig4_clocking", "fig5_model_correct",
                              "fig6_enhancements", "fig7_portability")]


@pytest.mark.parametrize("fig,kw", FIGURES,
                         ids=[f + "".join(f"-{v}" for v in kw.values())
                              for f, kw in FIGURES])
def test_figure_script_matches_reference(fig, kw, monkeypatch, tmp_path):
    ref = _reference(fig)
    ref_calls, ref_emitted, ref_csvs = [], [], {}
    monkeypatch.setattr(ref, "run_sweep",
                        _fake_sweep(ref_mess.SweepResult, ref_calls))
    monkeypatch.setattr(ref, "write_csv", lambda res, name: ref_csvs.update(
        {name: _csv_text(res.to_rows())}))
    monkeypatch.setattr(ref, "emit", lambda name, us, derived:
                        ref_emitted.append((name, derived)))
    ref.main(full=True, **kw)

    port = importlib.import_module(f"repro_torch.bench.{fig}")
    calls = []
    monkeypatch.setattr(port, "run_sweep", _fake_sweep(mess.SweepResult,
                                                       calls))
    _, emitted = port.main(full=True, device="cpu", out_dir=tmp_path, **kw)

    assert calls == ref_calls
    assert emitted == ref_emitted
    assert len(emitted) >= 3
    written = {p.stem: _read(p) for p in tmp_path.glob("*.csv")}
    assert written == ref_csvs


# ---------------------------------------------------------- run_sweep

TINY = dict(paces=(1, 24), mixes=(0,), windows=dict(windows=2, warmup=1))


def _tiny(monkeypatch, module):
    monkeypatch.setattr(module, "FAST_PACES", TINY["paces"])
    monkeypatch.setattr(module, "FAST_MIXES", TINY["mixes"])
    monkeypatch.setattr(module, "FAST_WINDOWS", TINY["windows"])


@pytest.mark.parametrize("stage", ["01-baseline", "02-clock-scale",
                                   "03-ps-clock"])
def test_run_sweep_matches_reference(stage, monkeypatch):
    """One stage per clock model (broken_noscale, damov_ceil,
    picosecond) on a tiny FAST grid: the same rows."""
    ref_util = _reference("util")
    _tiny(monkeypatch, ref_util)
    _tiny(monkeypatch, util)
    want, _ = ref_util.run_sweep(stage)
    got, us = util.run_sweep(stage, device="cpu")
    assert us > 0
    assert (got.stage, got.paces, got.write_mixes) == (
        want.stage, want.paces, want.write_mixes)
    for f in VIEWS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)
    assert got.to_rows() == pytest.approx(want.to_rows(), rel=RTOL)


def test_write_csv_writes_the_artifact_rows(tmp_path):
    res = _fake_sweep(mess.SweepResult, [])("05-addrmap")[0]
    path = util.write_csv(res, "fig6a_addrmap", tmp_path / "out")
    assert path == tmp_path / "out" / "fig6a_addrmap.csv"
    assert _read(path) == _csv_text(res.to_rows())


# -------------------------------------------------------- weave bench

def test_event_diag_matches_reference():
    """Per-pace events/window, occupancy, saturated windows and the
    rate fit of one batched event-engine run, as the reference's."""
    ref_bench = _reference("weave_bench")
    cfg = get_stage(weave_bench.STAGE, windows=2, warmup=1, weave="event")
    ref_cfg = ref_get_stage(weave_bench.STAGE, windows=2, warmup=1,
                            weave="event")
    paces = (1, 2, 24, 64)
    assert (weave_bench._event_diag(cfg, paces, "cpu")
            == ref_bench._event_diag(ref_cfg, paces))


def test_weave_bench_report(monkeypatch, tmp_path):
    """`main` on a tiny grid: the reference's report keys, the step
    reduction of `weave_budgets`, the table, the output directory."""
    monkeypatch.setattr(weave_bench, "SMOKE", dict(
        windows=1, warmup=0, presets=("ddr4_2666",), paces=(2, 24),
        mixes=(0,)))
    report = weave_bench.main(device="cpu", out_dir=tmp_path)
    assert report["device"] == "cpu"
    assert (tmp_path / weave_bench.REPORT).exists()
    row = report["presets"]["ddr4_2666"]
    ticks, events = presets.weave_budgets("ddr4_2666")["picosecond"]
    assert (row["ticks_per_window"], row["event_budget"]) == (ticks, events)
    assert row["step_reduction"] == round(ticks / events, 2)
    assert set(row) == {"ticks_per_window", "event_budget", "step_reduction",
                        "dense_wall_s", "event_wall_s", "speedup",
                        "us_per_window", "paces", "event_rate_fit"}
    assert set(row["paces"]) == {"2", "24"}
    table = weave_bench.readme_table(report)
    assert "`ddr4_2666` | 635 → 199 (3.19× fewer)" in table
