"""The telemetry recorder and `repro_torch.obs` against the JAX package.

On the CPU, from the same inputs, over the grid of ``tests/test_obs.py``
(6 windows, 2 warm-up; a Mess point, a solo trace and a two-app mix;
ddr4_2666, ddr5_4800 and hbm2e; both weave engines) at a 200-cycle
window, since the port's stepwise loop costs ~2 ms a step on the CPU:

* every ``tele_*`` plane of `run_frontend` with ``telemetry=True`` (and
  the ``cmd_*`` records riding along) equals the reference's bit for
  bit, dtype and shape included, batch axis first;
* turning the flags on moves no semantic view and no `WindowOut` field;
* the dense and event planes are equal, and each histogram's total is
  the reads served;
* `log2_bucket` at the powers of two; `collect` (one row of the batch),
  `summarize`, `window_series`, `divergence`, `divergence_report`,
  `to_json` and `to_perfetto` / `validate_perfetto` equal the reference's
  on the same planes;
* the replay's telemetry planes after dense re-runs, and
  `bench.app_validation`'s interface percentiles, equal the reference's;
* `bench.perspectives` at a cut setting equals the reference's
  ``run_stage`` + ``divergence_report``.

JAX is imported by the fixtures that compare with it.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import dram, get_stage
from repro_torch.core.platform import run_frontend
from repro_torch.core.workload import MessFrontend
from repro_torch.obs.perspectives import divergence, divergence_report
from repro_torch.traces import (TraceFrontend, assign_traces, make_suite,
                                replay_suite, split_cores, stack_mixes,
                                stack_traces)
from repro_torch.traces import kernels as tk

torch.set_num_threads(1)

FAST = dict(windows=6, warmup=2)
WINDOW_CYCLES = 200
SEMANTIC_VIEWS = ("sim_bw_gbs", "sim_lat_ns", "if_bw_gbs", "if_lat_ns",
                  "app_bw_gbs", "app_lat_ns", "chase_lat_ns",
                  "n_rd", "n_wr", "l_ir_final", "injected", "weave_events",
                  "weave_sat")

# stage, preset, frontend (test_obs.py's grid)
GRID = [("10-delay-buffer", "ddr4_2666", "mess"),
        ("04-model-correct", "ddr4_2666", "solo"),
        ("10-delay-buffer", "ddr5_4800", "mix"),
        ("01-baseline", "hbm2e", "mix")]
ENGINES = ("dense", "event")
_IDS = [f"{s}-{p}-{f}" for s, p, f in GRID]


def _cut(cfg, frontend, weave):
    """The grid's config: a short window, and on the event engine a budget
    that covers it (the clock's budget, scaled to the short window, runs
    out at the Mess cell's load)."""
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


def port_run(stage, preset, frontend, weave, **flags):
    cfg = _cut(get_stage(stage, preset=preset, weave=weave, **flags,
                         **FAST), frontend, weave)
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
    views, outs = run_frontend(cfg, fe, batch=1, device="cpu")
    return cfg, views, outs


def ref_run(stage, preset, frontend, weave, **flags):
    import jax
    import jax.numpy as jnp
    from repro.core import get_stage as ref_get_stage
    from repro.core.platform import run_frontend as ref_run_frontend
    from repro.core.workload import MessFrontend as RefMess
    from repro.traces import assign_traces as ref_assign
    from repro.traces import kernels as rk
    from repro.traces import split_cores as ref_split
    from repro.traces.frontend import TraceFrontend as RefTrace

    cfg = _cut(ref_get_stage(stage, preset=preset, weave=weave, **flags,
                             **FAST), frontend, weave)
    wcfg = cfg.workload_config()
    if frontend == "mess":
        fe = RefMess(jnp.int32(8), jnp.int32(16), wcfg)
    elif frontend == "solo":
        fe = RefTrace(_apps(rk, frontend)[0], wcfg)
    else:
        fe = RefTrace(ref_assign(_apps(rk, frontend),
                                 ref_split(2, wcfg.n_cores),
                                 phase_offsets=None), wcfg)
    views, outs = jax.device_get(jax.jit(
        lambda: ref_run_frontend(cfg, fe))())
    return cfg, views, outs


@pytest.fixture(scope="module")
def grid():
    """Every grid cell on both engines, both packages, both flags on."""
    flags = dict(telemetry=True, cmd_trace=True)
    return {(cell, weave): (port_run(*cell, weave, **flags),
                            ref_run(*cell, weave, **flags))
            for cell in GRID for weave in ENGINES}


@pytest.mark.parametrize("weave", ENGINES)
@pytest.mark.parametrize("cell", GRID, ids=_IDS)
def test_recorded_planes_equal_reference(grid, cell, weave):
    (_, views, outs), (_, ref_views, ref_outs) = grid[cell, weave]
    recorded = [k for k in ref_views if k.startswith(("tele_", "cmd_"))]
    assert set(recorded) == set(obs.TELE_KEYS) | {
        f"cmd_{f}" for f in dram.TickCmd._fields}
    assert set(recorded) == {k for k in views
                             if k.startswith(("tele_", "cmd_"))}
    for k in recorded:
        got, want = views[k][0].numpy(), np.asarray(ref_views[k])
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k, want in ref_outs._asdict().items():
        np.testing.assert_array_equal(getattr(outs, k)[:, 0].numpy(),
                                      np.asarray(want), err_msg=k)


@pytest.mark.parametrize("cell", GRID, ids=_IDS)
def test_flags_move_no_semantic_view(grid, cell):
    weave = ENGINES[GRID.index(cell) % 2]
    (_, on, outs_on), _ = grid[cell, weave]
    _, off, outs_off = port_run(*cell, weave)
    assert not any(k.startswith(("tele_", "cmd_")) for k in off)
    for k in SEMANTIC_VIEWS:
        assert torch.equal(on[k], off[k]), k
    for f, a, b in zip(outs_on._fields, outs_on, outs_off):
        assert torch.equal(a, b), f


@pytest.mark.parametrize("cell", GRID, ids=_IDS)
def test_engines_agree_and_histograms_count_reads(grid, cell):
    (_, dense, outs), _ = grid[cell, "dense"]
    (_, event, _), _ = grid[cell, "event"]
    assert int(dense["weave_sat"].sum()) == int(event["weave_sat"].sum()) \
        == 0
    for k in obs.TELE_KEYS:
        assert torch.equal(dense[k], event[k]), k
    served = outs.served_rd[:, 0]                       # (W,)
    for k in ("tele_hist_rd_ticks", "tele_hist_if_ps"):
        assert torch.equal(dense[k][0].sum((1, 2)), served), k
    assert torch.equal(dense["tele_n_cas_rd"][0].sum(1), served)
    assert torch.equal(dense["tele_n_cas_wr"][0].sum(1),
                       outs.served_wr[:, 0])
    assert int(served.sum()) > 0


def test_log2_bucket_at_powers_of_two():
    import jax.numpy as jnp
    from repro.core import dram as ref_dram

    assert dram.N_HIST == ref_dram.N_HIST
    rng = np.random.default_rng(0)
    v = np.concatenate([
        [-(1 << 31), -7, -1, 0, 1],
        [(1 << k) + d for k in range(31) for d in (-1, 0, 1)],
        [(1 << 31) - 1], rng.integers(-(1 << 31), 1 << 31, 200)])
    v = v.clip(-(1 << 31), (1 << 31) - 1).astype(np.int32)
    got = dram.log2_bucket(torch.from_numpy(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ref_dram.log2_bucket(jnp.asarray(v))))
    powers = dram.log2_bucket(torch.tensor([1 << k for k in range(31)],
                                           dtype=torch.int32))
    assert powers.tolist() == [min(k, dram.N_HIST - 1) for k in range(31)]


def _ref_obs():
    from repro import obs as ref_obs
    from repro.obs import perspectives as ref_persp
    return ref_obs, ref_persp


def _records(grid, cell, weave="dense"):
    ref_obs, _ = _ref_obs()
    (cfg, views, outs), (ref_cfg, ref_views, ref_outs) = grid[cell, weave]
    return (obs.collect(cfg, views, outs, row=0),
            ref_obs.collect(ref_cfg, ref_views, ref_outs))


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got), path
    else:
        assert got == want, path


@pytest.mark.parametrize("cell", GRID, ids=_IDS)
def test_collect_summarize_and_series_equal_reference(grid, cell):
    rec, ref = _records(grid, cell)
    for f in dataclasses.fields(ref):
        _assert_tree_equal(getattr(rec, f.name), getattr(ref, f.name),
                           f.name)
    _, ref_persp = _ref_obs()
    ref_obs, _ = _ref_obs()
    _assert_tree_equal(obs.summarize(rec), ref_obs.summarize(ref))
    _assert_tree_equal(obs.window_series(rec), ref_persp.window_series(ref))
    _assert_tree_equal(divergence(rec), ref_persp.divergence(ref))
    # one row of the batch, or a run's own (W, ...) series
    (cfg, views, outs), _ = grid[cell, "dense"]
    one = obs.collect(cfg, {k: v[0] for k, v in views.items()}, row=None)
    _assert_tree_equal(one.series, rec.series)
    with pytest.raises(ValueError, match="telemetry is off"):
        obs.collect(dataclasses.replace(cfg, telemetry=False), views)


def test_divergence_report_equals_reference(grid):
    _, ref_persp = _ref_obs()
    pairs = {f"{c[0]}/{c[1]}": _records(grid, c) for c in GRID}
    got = divergence_report({k: r for k, (r, _) in pairs.items()})
    want = ref_persp.divergence_report({k: w for k, (_, w) in pairs.items()})
    _assert_tree_equal(got, want)
    json.dumps(got)


def test_json_and_perfetto_export_equal_reference(grid, tmp_path):
    ref_obs, _ = _ref_obs()
    rec, ref = _records(grid, GRID[2])
    _assert_tree_equal(obs.to_json(rec, tmp_path / "t.json"),
                       ref_obs.to_json(ref))
    trace = obs.to_perfetto(rec, tmp_path / "trace.json")
    _assert_tree_equal(trace, ref_obs.to_perfetto(ref))
    n = obs.validate_perfetto(trace)
    assert n == ref_obs.validate_perfetto(trace) == obs.validate_perfetto(
        json.loads((tmp_path / "trace.json").read_text()))
    for bad in ({}, dict(traceEvents=[]),
                dict(traceEvents=[dict(ph="Z", pid=1, name="x")])):
        with pytest.raises(ValueError):
            obs.validate_perfetto(bad)


def test_percentiles_and_spearman_equal_reference():
    ref_obs, ref_persp = _ref_obs()
    rng = np.random.default_rng(1)
    h = rng.integers(0, 50, (5, 3, dram.N_HIST))
    h[..., 12:] = 0
    np.testing.assert_array_equal(obs.hist_percentiles(h),
                                  ref_obs.hist_percentiles(h))
    np.testing.assert_array_equal(obs.hist_edges(750.0),
                                  ref_obs.hist_edges(750.0))
    assert np.isnan(obs.hist_percentiles(np.zeros(dram.N_HIST))).all()
    for a, b in ((rng.normal(size=30), rng.normal(size=30)),
                 (np.r_[1, 1, 2, 3], np.r_[10, 10, 20, 30]),
                 (np.full(8, 5.0), np.arange(8.0))):
        assert obs.spearman(a, b) == ref_persp.spearman(a, b)
    with pytest.raises(ValueError):
        obs.spearman([1, 2], [1, 2, 3])


# ---- replay and the bench modules ----------------------------------------

@pytest.fixture(scope="module")
def ref_replay():
    """The reference's replay held at one device."""
    from repro.core import shard
    from repro.traces import replay

    mp = pytest.MonkeyPatch()
    mp.setattr(replay, "sharded_vmap",
               functools.partial(shard.sharded_vmap, n_devices=1))
    replay._replay_fn.cache_clear()
    yield replay
    mp.undo()
    replay._replay_fn.cache_clear()


def test_replay_telemetry_merges_dense_reruns(ref_replay):
    """A budget small enough that some rows are re-run dense: the merged
    planes equal the reference's, and the interface percentiles that
    `bench.app_validation` writes equal the JAX benchmark's."""
    from benchmarks.app_validation import _if_percentiles_ns as ref_pct
    from repro.core import get_stage as ref_get_stage
    from repro.traces import kernels as rk
    from repro.traces import trace as rt
    from repro_torch.bench.app_validation import _if_percentiles_ns

    kw = dict(preset="ddr4_2666", windows=3, warmup=1, telemetry=True)
    names = ("gups", "pointer_chase")       # gups exhausts the budget
    got = replay_suite(get_stage("07-prefetch", **kw),
                       stack_traces(make_suite(n=256, names=names)[1]),
                       device="cpu")
    want = ref_replay.replay_suite(
        ref_get_stage("07-prefetch", **kw),
        rt.stack_traces(rk.make_suite(n=256, names=names)[1]))
    sat = got["weave_sat"] > 0
    assert sat.any() and not sat.all()          # some rows re-run dense
    tele = [k for k in want if k.startswith("tele_")]
    assert set(tele) == set(obs.TELE_KEYS) == {
        k for k in got if k.startswith("tele_")}
    for k in tele:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    for i in range(len(names)):
        np.testing.assert_array_equal(_if_percentiles_ns(got, 1, i),
                                      ref_pct(want, 1, i))


def test_bench_perspectives_equals_reference_at_a_cut_setting():
    from benchmarks.perspectives import run_stage as ref_run_stage
    from repro_torch.bench import perspectives

    _, ref_persp = _ref_obs()
    stages = ("01-baseline", "04-model-correct")
    knobs = dict(windows=6, warmup=2, n=2048)
    assert perspectives.LADDER[0] == stages[0] and len(
        perspectives.LADDER) == 10
    assert perspectives.SMOKE == dict(windows=24, warmup=8, n=1 << 14)
    assert perspectives.FULL == dict(windows=96, warmup=32, n=1 << 17)
    old = perspectives.SMOKE
    perspectives.SMOKE = knobs
    try:
        got = perspectives.main(device="cpu", stages=stages, write=False)
    finally:
        perspectives.SMOKE = old
    want = ref_persp.divergence_report(
        {s: ref_run_stage(s, "ddr4_2666", **knobs) for s in stages})
    for k in ("ladder", "monotone_ok", "end_to_end_gain", "exceptions"):
        _assert_tree_equal(got[k], want[k], k)
    assert got["launches"]["01-baseline"]["weave_window"] == 0  # CPU
