"""The command recorder and `repro_torch.oracle` against the JAX package.

On the CPU, from the same inputs, over the grid of
``tests/test_cmd_oracle.py`` (6 windows, 2 warm-up; a Mess point on
ddr4_2666, a two-app mix on ddr5_4800 with REFsb refresh, a solo trace
on hbm2e; both weave engines) at a 200-cycle window:

* the raw ``cmd_*`` records equal the reference's bit for bit; turning
  ``cmd_trace`` on moves no semantic view;
* `extract_stream`, `diff_streams`, `stream_stats`, `check_stream` and
  `to_cmd_trace` / `validate_cmd_trace` give the reference's results on
  the recorded streams: dense == event, protocol-legal;
* `check_stream` gives the reference's `LegalityReport` on a legal
  hand-built stream and on a corrupted stream for each rule of `RULES`;
* `bench.cmd_oracle`'s cells and export on the CPU at a cut setting.

JAX is imported by the fixtures that compare with it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import get_stage
from repro_torch.core.dram import ACT, PRE, RD, REF, WR
from repro_torch.core.platform import run_frontend
from repro_torch.core.presets import platform_for
from repro_torch.core.workload import MessFrontend
from repro_torch.obs.export import to_cmd_trace, validate_cmd_trace
from repro_torch.oracle import (RULES, CommandStream, check_stream,
                                diff_streams, extract_stream, stream_stats)
from repro_torch.oracle import stream as port_stream
from repro_torch.oracle.stream import CMD_KEYS
from repro_torch.traces import (TraceFrontend, assign_traces, split_cores,
                                stack_mixes, stack_traces)
from repro_torch.traces import kernels as tk

torch.set_num_threads(1)

FAST = dict(windows=6, warmup=2)
WINDOW_CYCLES = 200
SEMANTIC_VIEWS = ("sim_bw_gbs", "sim_lat_ns", "if_bw_gbs", "if_lat_ns",
                  "app_bw_gbs", "app_lat_ns", "chase_lat_ns",
                  "n_rd", "n_wr", "l_ir_final", "injected", "weave_events",
                  "weave_sat")
D4 = platform_for("ddr4_2666").dram
D5 = platform_for("ddr5_4800").dram

# stage, preset, frontend
GRID = [("10-delay-buffer", "ddr4_2666", "mess"),
        ("04-model-correct", "ddr5_4800", "mix"),
        ("09-ramulator2", "hbm2e", "solo")]
ENGINES = ("dense", "event")
_IDS = [f"{s}-{p}-{f}" for s, p, f in GRID]


def _cut(cfg, weave):
    cpu = dataclasses.replace(cfg.platform.cpu, window_cycles=WINDOW_CYCLES)
    cfg = dataclasses.replace(
        cfg, platform=dataclasses.replace(cfg.platform, cpu=cpu))
    if weave == "event":
        cfg = dataclasses.replace(
            cfg, weave_events=cfg.clock().ticks_per_window_static)
    return cfg


def _apps(mod, frontend):
    return ([mod.stream(n=256)] if frontend == "solo"
            else [mod.stream(n=192), mod.gups(n=192)])


def port_run(stage, preset, frontend, weave, cmd_trace=True):
    cfg = _cut(get_stage(stage, preset=preset, weave=weave,
                         cmd_trace=cmd_trace, **FAST), weave)
    wcfg = cfg.workload_config()
    if frontend == "mess":
        p = torch.tensor([8], dtype=torch.int32)
        fe = MessFrontend(p, torch.full_like(p, 16), wcfg)
    elif frontend == "solo":
        fe = TraceFrontend(stack_traces(_apps(tk, frontend)), wcfg)
    else:
        fe = TraceFrontend(stack_mixes([assign_traces(
            _apps(tk, frontend), split_cores(2, wcfg.n_cores),
            phase_offsets=None)]), wcfg)
    views, _ = run_frontend(cfg, fe, batch=1, device="cpu")
    return cfg, views


def ref_run(stage, preset, frontend, weave):
    import jax
    import jax.numpy as jnp
    from repro.core import get_stage as ref_get_stage
    from repro.core.platform import run_frontend as ref_run_frontend
    from repro.core.workload import MessFrontend as RefMess
    from repro.traces import assign_traces as ref_assign
    from repro.traces import kernels as rk
    from repro.traces import split_cores as ref_split
    from repro.traces.frontend import TraceFrontend as RefTrace

    cfg = _cut(ref_get_stage(stage, preset=preset, weave=weave,
                             cmd_trace=True, **FAST), weave)
    wcfg = cfg.workload_config()
    if frontend == "mess":
        fe = RefMess(jnp.int32(8), jnp.int32(16), wcfg)
    elif frontend == "solo":
        fe = RefTrace(_apps(rk, frontend)[0], wcfg)
    else:
        fe = RefTrace(ref_assign(_apps(rk, frontend),
                                 ref_split(2, wcfg.n_cores),
                                 phase_offsets=None), wcfg)
    views, _ = jax.device_get(jax.jit(lambda: ref_run_frontend(cfg, fe))())
    return cfg, views


@pytest.fixture(scope="module")
def grid():
    return {(cell, weave): (port_run(*cell, weave), ref_run(*cell, weave))
            for cell in GRID for weave in ENGINES}


def _ref_oracle():
    from repro.obs import export as ref_export
    from repro import oracle as ref_oracle
    return ref_oracle, ref_export


def _stream_equal(got, want):
    for f in ("t", "cmd", "channel", "rank", "bank", "row"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("weave", ENGINES)
@pytest.mark.parametrize("cell", GRID, ids=_IDS)
def test_records_and_streams_equal_reference(grid, cell, weave):
    ref_oracle, ref_export = _ref_oracle()
    (cfg, views), (ref_cfg, ref_views) = grid[cell, weave]
    assert {k for k in views if k.startswith("cmd_")} == set(CMD_KEYS)
    for k in CMD_KEYS:
        got, want = views[k][0].numpy(), np.asarray(ref_views[k])
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    d = cfg.platform.dram
    got = extract_stream({k: v[0] for k, v in views.items()}, d)
    want = ref_oracle.extract_stream(ref_views, ref_cfg.platform.dram)
    _stream_equal(got, want)
    assert len(got) > 0 and got.counts() == want.counts()
    end_tick = int(cfg.clock().window_end_tick(cfg.windows - 1))
    st, ref_st = (stream_stats(got, span_ticks=end_tick),
                  ref_oracle.stream_stats(want, span_ticks=end_tick))
    assert set(st) == set(ref_st)
    for k in st:
        np.testing.assert_array_equal(st[k], ref_st[k], err_msg=k)
    rep = check_stream(got, end_tick=end_tick)
    assert rep.to_dict() == ref_oracle.check_stream(
        want, end_tick=end_tick).to_dict()
    assert rep.ok, rep.summary()
    text = to_cmd_trace(got, preset=cell[1])
    assert text == ref_export.to_cmd_trace(want, preset=cell[1])
    assert validate_cmd_trace(text) == ref_export.validate_cmd_trace(
        text) == len(got)


@pytest.mark.parametrize("cell", GRID, ids=_IDS)
def test_engines_record_one_stream(grid, cell):
    (cfg, dense), _ = grid[cell, "dense"]
    (_, event), _ = grid[cell, "event"]
    d = cfg.platform.dram
    a = extract_stream({k: v[0] for k, v in dense.items()}, d)
    b = extract_stream({k: v[0] for k, v in event.items()}, d)
    assert diff_streams(a, b) is None
    if d.same_bank_refresh:
        assert a.counts()["REF"] > 0            # REFsb exercised
    b.row[len(b) // 2] += 1
    assert diff_streams(a, b)["index"] == len(b) // 2


def test_cmd_trace_moves_no_semantic_view(grid):
    cell = GRID[1]
    (_, on), _ = grid[cell, "event"]
    _, off = port_run(*cell, "event", cmd_trace=False)
    assert not any(k.startswith("cmd_") for k in off)
    for k in SEMANTIC_VIEWS:
        assert torch.equal(on[k], off[k]), k


def test_extract_stream_refuses_what_the_reference_refuses(grid):
    with pytest.raises(ValueError, match="cmd_trace=True"):
        extract_stream({}, D4)
    (_, views), _ = grid[GRID[0], "dense"]
    doubled = {k: torch.cat([views[k][0]] * 2) for k in CMD_KEYS}
    with pytest.raises(ValueError, match="strictly increasing"):
        extract_stream(doubled, D4)


# ---- the checker on hand-built streams -----------------------------------

def mk(mod, d, rows):
    """A single-channel stream of ``mod.CommandStream`` from rows (t, cmd,
    rank, bank, row)."""
    a = np.asarray(rows, np.int64).reshape(-1, 5)
    return mod.CommandStream(
        dram=d, t=a[:, 0], cmd=a[:, 1].astype(np.int32),
        channel=np.zeros(len(a), np.int32),
        rank=a[:, 2].astype(np.int32), bank=a[:, 3].astype(np.int32),
        row=a[:, 4].astype(np.int32))


LEGAL = (D4, [(100, ACT, 0, 0, 5), (119, RD, 0, 0, 5), (143, PRE, 0, 0, -1),
              (162, ACT, 0, 0, 7), (181, WR, 0, 0, 7), (219, PRE, 0, 0, -1)])

#: rule -> (device, rows, end_tick): a stream where the rule must fire
CORRUPTED = {
    "state-act-closed": (D4, [(100, ACT, 0, 0, 5), (110, ACT, 0, 0, 6)]),
    "state-cas-open": (D4, [(100, RD, 0, 0, 5)]),
    "state-pre-open": (D4, [(100, PRE, 0, 0, -1)]),
    "trcd": (D4, [(100, ACT, 0, 0, 5), (110, RD, 0, 0, 5)]),
    "tras": (D4, [(100, ACT, 0, 0, 5), (130, PRE, 0, 0, -1)]),
    "trp": (D4, [(100, ACT, 0, 0, 5), (119, RD, 0, 0, 5),
                 (143, PRE, 0, 0, -1), (155, ACT, 0, 0, 6)]),
    "trc": (D4, [(100, ACT, 0, 0, 5), (119, RD, 0, 0, 5),
                 (143, PRE, 0, 0, -1), (161, ACT, 0, 0, 6)]),
    "trtp": (D4, [(100, ACT, 0, 0, 5), (119, RD, 0, 0, 5),
                  (128, PRE, 0, 0, -1)]),
    "twr": (D4, [(100, ACT, 0, 0, 5), (119, WR, 0, 0, 5),
                 (150, PRE, 0, 0, -1)]),
    "tccd-s": (D4, [(100, ACT, 0, 0, 5), (101, ACT, 1, 0, 5),
                    (120, RD, 0, 0, 5), (122, RD, 1, 0, 5)]),
    "tccd-l": (D4, [(100, ACT, 0, 0, 5), (107, ACT, 0, 1, 5),
                    (126, RD, 0, 0, 5), (131, RD, 0, 1, 5)]),
    "bus": (D4, [(100, ACT, 0, 0, 5), (102, ACT, 1, 0, 5),
                 (119, RD, 0, 0, 5), (125, RD, 1, 0, 5),
                 (130, RD, 0, 0, 5)]),
    "twtr": (D4, [(100, ACT, 0, 0, 5), (105, ACT, 0, 4, 5),
                  (119, WR, 0, 0, 5), (130, RD, 0, 4, 5)]),
    "trtw": (D4, [(100, ACT, 0, 0, 5), (105, ACT, 0, 4, 5),
                  (124, RD, 0, 0, 5), (130, WR, 0, 4, 5)]),
    "trrd-s": (D4, [(100, ACT, 0, 0, 5), (102, ACT, 0, 8, 5)]),
    "trrd-l": (D4, [(100, ACT, 0, 0, 5), (105, ACT, 0, 1, 5)]),
    "tfaw": (D4, [(100, ACT, 0, 0, 5), (107, ACT, 0, 4, 5),
                  (114, ACT, 0, 8, 5), (121, ACT, 0, 12, 5),
                  (126, ACT, 0, 2, 5)]),
    "trfc": (D4, [(10400, REF, 0, -1, -1), (10500, ACT, 0, 0, 5)]),
    "trefi": (D4, [(10401, REF, 0, -1, -1)]),
    "ref-missed": (D4, [(100, ACT, 0, 0, 5)]),
    "ref-rotation": (D5, [(292, REF, 0, 1, -1)]),
}


def test_corruption_table_covers_every_rule():
    assert set(CORRUPTED) == set(RULES)
    ref_oracle, _ = _ref_oracle()
    assert RULES == ref_oracle.RULES


@pytest.mark.parametrize("rule", [None] + sorted(CORRUPTED))
def test_checker_reports_equal_reference(rule):
    from repro.oracle import stream as ref_stream

    ref_oracle, _ = _ref_oracle()
    d, rows = LEGAL if rule is None else CORRUPTED[rule]
    end = int(d.tREFI) + 100 if rule == "ref-missed" else None
    got = check_stream(mk(port_stream, d, rows), end_tick=end)
    want = ref_oracle.check_stream(mk(ref_stream, d, rows), end_tick=end)
    assert got.to_dict() == want.to_dict()
    assert got.summary() == want.summary()
    if rule is None:
        assert got.ok
    else:
        assert got.violation_counts[rule] > 0 and not got.ok


def test_stream_type_and_export_round_trip(tmp_path):
    from repro.oracle import stream as ref_stream

    _, ref_export = _ref_oracle()
    rows = [(100, ACT, 0, 0, 5), (119, RD, 0, 0, 5), (143, PRE, 0, 0, -1),
            (10400, REF, 0, -1, -1)]
    s = mk(port_stream, D4, rows)
    assert isinstance(s, CommandStream) and len(s) == 4
    path = tmp_path / "t.cmd.trace"
    text = to_cmd_trace(s, path=path, preset="ddr4_2666")
    assert path.read_text() == text == ref_export.to_cmd_trace(
        mk(ref_stream, D4, rows), preset="ddr4_2666")
    for bad in (text.replace("ACT", "XYZ"),
                text.replace("119,0,RD", "99,0,RD"),
                "\n".join(text.splitlines()[:3]) + "\n"):
        with pytest.raises(ValueError):
            validate_cmd_trace(bad)
        with pytest.raises(ValueError):
            ref_export.validate_cmd_trace(bad)


# ---- bench.cmd_oracle -----------------------------------------------------

def test_bench_cmd_oracle_cells_at_a_cut_setting(tmp_path, monkeypatch):
    """Two cells of `bench.cmd_oracle` on the CPU at a short window:
    equal dense and event streams, no violation, one valid export."""
    from repro_torch.bench import cmd_oracle

    assert [c[:2] for c in cmd_oracle.SMOKE] == [
        ("01-baseline", "ddr4_2666"), ("10-delay-buffer", "ddr4_2666"),
        ("04-model-correct", "ddr5_4800"), ("09-ramulator2", "ddr5_4800"),
        ("04-model-correct", "hbm2e"), ("10-delay-buffer", "hbm2e")]
    base = cmd_oracle.cell_config

    def short(*args):
        cfg = base(*args)
        cpu = dataclasses.replace(cfg.platform.cpu,
                                  window_cycles=WINDOW_CYCLES)
        return dataclasses.replace(
            cfg, platform=dataclasses.replace(cfg.platform, cpu=cpu))

    monkeypatch.setattr(cmd_oracle, "cell_config", short)
    monkeypatch.setattr(cmd_oracle, "OUT_DIR", tmp_path)
    monkeypatch.setattr(cmd_oracle, "SMOKE", [
        ("01-baseline", "ddr4_2666", cmd_oracle.mess(8, 16), 4),
        ("09-ramulator2", "ddr5_4800", cmd_oracle.mess(8, 32), 4)])
    report = cmd_oracle.main(device="cpu")
    assert report["all_ok"] and len(report["cells"]) == 2
    assert all(c["legal_ok"] and c["streams_identical"]
               for c in report["cells"])
    assert report["exported_rows"] == validate_cmd_trace(
        (tmp_path / "cmd_oracle_ddr4_2666.cmd.trace").read_text()) > 0
    assert (tmp_path / "cmd_oracle.json").exists()
