"""LLM-serving traffic: the port's HLO cost model, renderer, scheduler,
lowering and serving bench against the JAX package's, on the same
configs and seeds.

The lowering, schedules, traces and `analyze` outputs must be equal
exactly (they are numpy and Python integers on both sides); replayed
floats within ``RTOL``, as in ``tests/test_torch_mess.py``.
"""
import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.core import get_stage as ref_get_stage
from repro.core.platform import run_frontend as ref_run_frontend
from repro.perfmodel import hlo as ref_hlo
from repro.perfmodel import hlo_cost as ref_hlo_cost
from repro.traces import llm as ref_llm
from repro.traces.frontend import TraceFrontend as RefTraceFrontend
from repro_torch.bench import serving
from repro_torch.configs import registry
from repro_torch.core import get_stage, run_frontend
from repro_torch.perfmodel import hlo, hlo_cost
from repro_torch.traces import TraceFrontend, llm

from test_perfmodel import SAMPLE_HLO

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6
ARCHS = registry.ARCH_ORDER
#: two (pool size, context) points per config
BS = ((1, 1), (3, 250))


def _configs(arch):
    """(port config, reference config) pairs: full and smoke."""
    return [(registry.get_config(arch), ref_registry.get_config(arch)),
            (registry.get_smoke(arch), ref_registry.get_smoke(arch))]


def _trace_arrays(tr):
    return {f: np.asarray(getattr(tr, f)) for f in tr._fields}


def assert_traces_equal(got, want):
    g, w = _trace_arrays(got), _trace_arrays(want)
    assert g.keys() == w.keys()
    for f in g:
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)


def assert_info_equal(got, want):
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


# ---------------------------------------------------------- HLO cost model

def test_hlo_text_parsers_match_reference():
    assert hlo.DTYPE_BYTES == ref_hlo.DTYPE_BYTES
    assert hlo.COLLECTIVES == ref_hlo.COLLECTIVES
    assert hlo_cost.analyze(SAMPLE_HLO) == ref_hlo_cost.analyze(SAMPLE_HLO)
    assert (hlo.collective_bytes(SAMPLE_HLO)
            == ref_hlo.collective_bytes(SAMPLE_HLO))
    assert (hlo.collective_bytes_scaled(SAMPLE_HLO)
            == ref_hlo.collective_bytes_scaled(SAMPLE_HLO))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_hlo_and_analyze_match_reference(arch):
    for cfg, ref_cfg in _configs(arch):
        for B, S in BS:
            text = llm.decode_hlo(cfg, B, S)
            assert text == ref_llm.decode_hlo(ref_cfg, B, S), (cfg.name, B)
            assert hlo_cost.analyze(text) == ref_hlo_cost.analyze(text)


# ------------------------------------------------------- decode lowering

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cost_and_lower_decode_match_reference(arch):
    for cfg, ref_cfg in _configs(arch):
        for B, S in BS:
            assert (llm.decode_cost(cfg, B, S)
                    == ref_llm.decode_cost(ref_cfg, B, S)), (cfg.name, B, S)
            tr, info = llm.lower_decode(cfg, B, S, steps=2,
                                        target_lines=1024)
            ref_tr, ref_info = ref_llm.lower_decode(ref_cfg, B, S, steps=2,
                                                    target_lines=1024)
            assert_traces_equal(tr, ref_tr)
            assert_info_equal(info, ref_info)


@pytest.mark.parametrize("dtype,ref_dtype", [
    (torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32),
    (torch.float16, jnp.float16)])
def test_every_dtype_renders_as_the_reference(dtype, ref_dtype):
    """The element type keyed by torch dtype: f32 / f16 configs render
    the reference's bytes, not a silent bf16 default."""
    cfg = dataclasses.replace(registry.get_smoke("qwen2-72b"), dtype=dtype)
    ref_cfg = dataclasses.replace(ref_registry.get_smoke("qwen2-72b"),
                                  dtype=ref_dtype)
    assert llm.decode_hlo(cfg, 2, 9) == ref_llm.decode_hlo(ref_cfg, 2, 9)
    assert llm.decode_cost(cfg, 2, 9) == ref_llm.decode_cost(ref_cfg, 2, 9)


def test_config_dtypes_are_mapped_and_unmapped_ones_raise():
    for arch in ARCHS:
        for cfg, _ in _configs(arch):
            assert cfg.dtype in llm._DT_NAMES, (cfg.name, cfg.dtype)
    cfg = dataclasses.replace(registry.get_smoke("tinyllama-1.1b"),
                              dtype=torch.float64)
    with pytest.raises(ValueError, match="no HLO element type"):
        llm.decode_hlo(cfg, 1, 1)


# ------------------------------------------------------------ scheduling

def _scenarios(arrival, model="tinyllama-1.1b", **kw):
    kw = dict(dict(arrival=arrival, rate=0.5, n_requests=16, n_slots=4,
                   seed=3), **kw)
    return (llm.ServeScenario(model=registry.get_smoke(model), **kw),
            ref_llm.ServeScenario(model=ref_registry.get_smoke(model), **kw))


def assert_schedules_equal(got, want):
    np.testing.assert_array_equal(got.n_active, want.n_active)
    np.testing.assert_array_equal(got.ctx_sum, want.ctx_sum)
    assert ([dataclasses.astuple(r) for r in got.requests]
            == [dataclasses.astuple(r) for r in want.requests])
    np.testing.assert_array_equal(got.latency_steps, want.latency_steps)
    np.testing.assert_array_equal(got.queue_delay_steps,
                                  want.queue_delay_steps)


@pytest.mark.parametrize("arrival", ["poisson", "uniform", "burst"])
def test_schedule_matches_reference(arrival):
    scn, ref_scn = _scenarios(arrival)
    np.testing.assert_array_equal(llm.arrival_steps(scn),
                                  ref_llm.arrival_steps(ref_scn))
    assert_schedules_equal(llm.simulate_schedule(scn),
                           ref_llm.simulate_schedule(ref_scn))


def test_bad_arrivals_raise_like_reference():
    for arrival, rate in (("pareto", 0.5), ("poisson", 0.0)):
        scn, ref_scn = _scenarios(arrival, rate=rate)
        with pytest.raises(ValueError):
            ref_llm.arrival_steps(ref_scn)
        with pytest.raises(ValueError):
            llm.arrival_steps(scn)


# ---------------------------------------------------- serving lowering

@pytest.mark.parametrize("model", ["tinyllama-1.1b", "arctic-480b",
                                   "zamba2-2.7b", "xlstm-1.3b"])
def test_serving_terms_are_exact(model):
    """The bilinear model equals the reference's coefficients and, at
    any occupancy, `decode_cost`'s per-stream bytes exactly."""
    cfg = registry.get_smoke(model)
    terms = llm.serving_terms(cfg)
    assert terms == ref_llm.serving_terms(ref_registry.get_smoke(model))
    for B, S in ((1, 1), (3, 7), (6, 250)):
        want = llm.decode_cost(cfg, B, S)["stream_bytes"]
        got = llm.step_stream_bytes(terms, B, B * S)
        assert got == {s: want[s] for s in llm.STREAMS}, (model, B, S)


@pytest.mark.parametrize("arrival,model", [
    ("poisson", "tinyllama-1.1b"), ("uniform", "xlstm-1.3b"),
    ("burst", "arctic-480b"), ("poisson", "zamba2-2.7b")])
def test_lower_scenario_matches_reference_and_conserves_bytes(arrival,
                                                              model):
    scn, ref_scn = _scenarios(arrival, model, n_requests=10, n_slots=3)
    tr, sched, info = llm.lower_scenario(scn, target_step_lines=256)
    ref_tr, ref_sched, ref_info = ref_llm.lower_scenario(
        ref_scn, target_step_lines=256)
    assert_traces_equal(tr, ref_tr)
    assert_schedules_equal(sched, ref_sched)
    assert_info_equal(info, ref_info)
    emitted = int(tr.length) * info["line_bytes"] * info["shard"]
    tol = len(llm.STREAMS) * info["line_bytes"] * info["shard"]
    assert abs(emitted - info["bytes_modeled"]) <= tol
    assert info["bytes_modeled"] == sum(info["stream_bytes"].values())
    assert info["bytes_modeled"] == sum(info["phase_bytes"].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_serving_traces_match_reference(arch):
    """Every config at full width, at the serving bench's FULL scenario
    settings (24 requests on 4 slots): equal schedule, trace and info."""
    kw = dict(rate=0.5, n_requests=24, n_slots=4, seed=17)
    got = llm.lower_scenario(llm.ServeScenario(
        model=registry.get_config(arch), **kw))
    want = ref_llm.lower_scenario(ref_llm.ServeScenario(
        model=ref_registry.get_config(arch), **kw))
    assert_traces_equal(got[0], want[0])
    assert_schedules_equal(got[1], want[1])
    assert_info_equal(got[2], want[2])


def test_request_latencies_match_reference():
    scn, ref_scn = _scenarios("poisson")
    _, sched, info = llm.lower_scenario(scn)
    _, ref_sched, ref_info = ref_llm.lower_scenario(ref_scn)
    for runtime_ms in (0.3462, 10.0):
        np.testing.assert_array_equal(
            llm.request_latencies_ms(sched, info, runtime_ms),
            ref_llm.request_latencies_ms(ref_sched, ref_info, runtime_ms))


def _ref_serving():
    sys.path.insert(0, ROOT)
    try:
        from benchmarks import serving as ref_serving
    finally:
        sys.path.remove(ROOT)
    return ref_serving


def test_cell_percentiles_match_reference():
    """The same (A, W, C, N_HIST) histograms give the same if_p*_ns."""
    ref_serving = _ref_serving()
    rng = np.random.default_rng(18)
    hist = rng.integers(0, 50, size=(3, 6, 12, 24)).astype(np.int32)
    hist[2] = 0
    hist[2, 1, 3, 9] = 5                              # one bucket only
    out = {"tele_hist_if_ps": hist}
    for a in range(3):
        assert (serving.cell_percentiles(out, a)
                == ref_serving.cell_percentiles(out, a))


# -------------------------------------------------------------- replay

CELL_KEYS_EXACT = ("model", "preset", "arrival", "rate", "n_requests",
                   "n_slots", "steps", "accesses", "shard", "bytes_modeled")
CELL_KEYS_FLOAT = ("runtime_ms", "gbps", "req_p50_ms", "req_p95_ms",
                   "req_p99_ms", "if_p50_ns", "if_p95_ns", "if_p99_ns")


def test_serve_grid_cells_match_reference():
    """Two full-width cells (tinyllama-1.1b at two rates: traces of
    unequal length stacked in one batch) on hbm2e, telemetry on, the
    covering event budget, replayed by both benches."""
    ref_serving = _ref_serving()
    kw = dict(n_requests=6, windows=3)
    grid = (("tinyllama-1.1b",), ("hbm2e",), (0.25, 1.0))
    got = serving.serve_grid(*grid, device="cpu", **kw)
    want = ref_serving.serve_grid(*grid, **kw)
    assert len(got) == len(want) == 2
    assert got[0]["accesses"] != got[1]["accesses"]
    for g, w in zip(got, want):
        assert set(w) <= set(g)
        for k in CELL_KEYS_EXACT:
            assert g[k] == w[k], k
        for k in CELL_KEYS_FLOAT:
            assert g[k] == pytest.approx(w[k], rel=RTOL), k
        assert g["launches"]["weave_window"] == 0      # the CPU route
        assert g["replay_wall_s"] == pytest.approx(2 * g["wall_s_cell"])


def test_serving_replay_dense_equals_covering_event():
    """The serving golden grid's contract on the port (CPU): a serving
    trace replays bit-identically on the dense engine and on the event
    engine whose budget covers the window, with no saturated window;
    and equal to the reference's dense replay."""
    scn, ref_scn = _scenarios("poisson", n_requests=10, n_slots=3)
    tr, _, _ = llm.lower_scenario(scn)
    ref_tr, _, _ = ref_llm.lower_scenario(ref_scn)
    kw = dict(windows=2, warmup=1)
    views = {}
    for weave in ("dense", "event"):
        cfg = get_stage("10-delay-buffer", preset="ddr4_2666", weave=weave,
                        **kw)
        if weave == "event":
            cfg = dataclasses.replace(
                cfg, weave_events=cfg.clock().ticks_per_window_static)
        batch = type(tr)(*(x[None] for x in tr))
        views[weave], _ = run_frontend(
            cfg, TraceFrontend(batch, cfg.workload_config()), batch=1,
            device="cpu")
    assert int(views["event"]["weave_sat"].sum()) == 0
    for k, v in views["dense"].items():
        if k not in ("weave_events", "weave_sat"):
            assert torch.equal(v, views["event"][k]), k
    ref_cfg = ref_get_stage("10-delay-buffer", preset="ddr4_2666",
                            weave="dense", **kw)
    ref_views, _ = ref_run_frontend(
        ref_cfg, RefTraceFrontend(ref_tr, ref_cfg.workload_config()))
    for k in ("n_rd", "n_wr", "injected"):
        np.testing.assert_array_equal(views["dense"][k][0].numpy(),
                                      np.asarray(ref_views[k]), err_msg=k)
    for k in ("sim_bw_gbs", "sim_lat_ns", "if_lat_ns", "app_lat_ns"):
        np.testing.assert_allclose(views["dense"][k][0].numpy(),
                                   np.asarray(ref_views[k]), rtol=RTOL,
                                   err_msg=k)
