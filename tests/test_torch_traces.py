"""The application perspective: the port's traces, trace frontend, replay
engine and anchors against the JAX reference on the CPU.

From the same numpy inputs: the generators' arrays and the trace
containers are equal; `TraceFrontend.bound` / `update` give equal
candidates and state window by window (one case with a footprint that
is not a power of two and deltas that wrap the int32 running sum);
`replay_suite` gives equal integers and float views within ``rtol=1e-6``
on stages 01 and 07 on ddr4_2666 and 07 on ddr5_4800 (``xor_fold``),
the last with an event budget small enough that every row is re-run
through the dense engine; the anchors agree within 1e-12.  Then the
route rule of the bound phase (a fake card device, as in
``test_torch_window_inject.py``), the replay drivers and guards.

The reference is held at one device (``n_devices=1``).  JAX and the
reference are imported only by the tests that compare with them, so on a
machine with a card ``python -m pytest -m gpu tests/test_torch_traces.py``
runs the card-against-CPU replay without JAX.
"""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import dram, get_stage, platform, workload
from repro_torch.traces import (KERNELS, TraceFrontend, anchor_mix_ms,
                                anchor_runtime_ms, anchor_suite_ms,
                                make_suite, make_trace, mape, replay_grid,
                                replay_stages, replay_suite, stack_traces,
                                trace_stats)
from repro_torch.traces.kernels import mess_traffic
from repro_torch.traces.trace import MAX_FOOTPRINT_LINES

torch.set_num_threads(1)

RTOL = 1e-6
INT_KEYS = ("n_rd", "n_wr", "runtime_windows", "done", "progress_final",
            "weave_sat")
FLOAT_KEYS = ("sim_bw_gbs", "sim_lat_ns", "if_bw_gbs", "if_lat_ns",
              "app_bw_gbs", "app_lat_ns", "chase_lat_ns", "runtime_ms")
REPLAY_N = 512
# stage, preset, event budget (0: the clock's), windows, warm-up; the
# ddr5_4800 case forces every row through the dense re-run
REPLAY_CASES = [("01-baseline", "ddr4_2666", 0, 6, 2),
                ("07-prefetch", "ddr4_2666", 0, 6, 2),
                ("07-prefetch", "ddr5_4800", 48, 3, 1)]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's traces API, its replay held at one device."""
    from repro.core import get_stage as ref_get_stage
    from repro.core import shard
    from repro.core.workload import WorkloadConfig
    from repro.traces import anchors, frontend, kernels as rkernels
    from repro.traces import replay, trace

    mp = pytest.MonkeyPatch()
    mp.setattr(replay, "sharded_vmap",
               functools.partial(shard.sharded_vmap, n_devices=1))
    replay._replay_fn.cache_clear()
    yield types.SimpleNamespace(
        get_stage=ref_get_stage, WorkloadConfig=WorkloadConfig,
        anchors=anchors, frontend=frontend, kernels=rkernels,
        replay=replay, trace=trace)
    mp.undo()
    replay._replay_fn.cache_clear()


def _assert_trace_equal(got, want):
    for f, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
        assert g.dtype == torch.int32, f


# ---- generators and containers -------------------------------------------

@pytest.mark.parametrize("name", list(KERNELS) + ["mess_traffic"])
def test_generators_equal_reference(ref, name):
    for n, foot, seed in ((700, 1 << 20, 0), (300, 999_983, 3)):
        if name == "mess_traffic":
            got = mess_traffic(n, foot, seed, write_num=16)
            want = ref.kernels.mess_traffic(n, foot, seed, write_num=16)
        else:
            got = KERNELS[name](n, foot, seed)
            want = ref.kernels.KERNELS[name](n, foot, seed)
        _assert_trace_equal(got, want)
        assert trace_stats(got) == ref.trace.trace_stats(want)


def test_make_suite_equals_reference_and_refuses_unknown(ref):
    names, traces = make_suite(n=256, seed=5)
    ref_names, ref_traces = ref.kernels.make_suite(n=256, seed=5)
    assert names == ref_names
    for got, want in zip(traces, ref_traces):
        _assert_trace_equal(got, want)
    with pytest.raises(ValueError) as mine:
        make_suite(names=("stream", "nope"))
    with pytest.raises(ValueError) as theirs:
        ref.kernels.make_suite(names=("stream", "nope"))
    assert str(mine.value) == str(theirs.value)


BAD_TRACES = [([1, 2], [0], [0], 1024),            # length mismatch
              ([[1]], [[0]], [[0]], 1024),         # not 1-D
              ([1], [0], [0], 0),                  # footprint 0
              ([1], [0], [0], MAX_FOOTPRINT_LINES + 1)]


@pytest.mark.parametrize("args", BAD_TRACES)
def test_make_trace_refuses_what_the_reference_refuses(ref, args):
    with pytest.raises(ValueError) as mine:
        make_trace(*args)
    with pytest.raises(ValueError) as theirs:
        ref.trace.make_trace(*args)
    assert str(mine.value) == str(theirs.value)


def test_make_and_stack_traces_equal_reference(ref):
    rng = np.random.default_rng(0)
    args = [(rng.integers(-50, 50, n), rng.integers(0, 2, n),
             rng.integers(0, 2, n), foot)
            for n, foot in ((100, 1 << 12), (37, 1000), (250, 1 << 16))]
    mine = [make_trace(*a) for a in args]
    theirs = [ref.trace.make_trace(*a) for a in args]
    for got, want in zip(mine, theirs):
        _assert_trace_equal(got, want)
    _assert_trace_equal(stack_traces(mine), ref.trace.stack_traces(theirs))


# ---- the frontend ----------------------------------------------------------

def _wrap_trace(n=400, foot=1_000_003):
    """Deltas near +-2^30 (the running int32 sum wraps within a window)
    over a footprint that is not a power of two, with dependent runs."""
    rng = np.random.default_rng(7)
    delta = rng.integers(-(1 << 30), 1 << 30, n) | (1 << 29)
    return (delta, rng.integers(0, 2, n), (rng.random(n) < 0.3), foot)


FRONTEND_CASES = {
    # stage, socket count, the trace arguments of each batch row
    "suite": ("06-noc", 1, None),
    "int32_wrap": ("04-model-correct", 2, "wrap"),
}


@pytest.mark.parametrize("case", list(FRONTEND_CASES))
def test_frontend_bound_and_update_match_reference(ref, case):
    import jax.numpy as jnp

    stage, sockets, kind = FRONTEND_CASES[case]
    if kind is None:
        args = [(np.asarray(t.delta)[:int(t.length)],
                 np.asarray(t.is_write)[:int(t.length)],
                 np.asarray(t.dep)[:int(t.length)], int(t.footprint_lines))
                for t in ref.kernels.make_suite(n=300)[1]]
    else:
        args = [_wrap_trace(), _wrap_trace(90, 999_999)]
    wcfg = get_stage(stage, n_sockets=sockets).workload_config()
    ref_wcfg = ref.get_stage(stage, n_sockets=sockets).workload_config()
    batch = stack_traces([make_trace(*a) for a in args])
    ref_rows = [ref.trace.make_trace(*a) for a in args]
    # the stacked rows share the batch's padded length, as under vmap
    ref_rows = [ref.trace.Trace(*(x[i] for x in ref.trace.stack_traces(
        ref_rows))) for i in range(len(args))]
    fe = TraceFrontend(batch, wcfg)
    ref_fes = [ref.frontend.TraceFrontend(t, ref_wcfg) for t in ref_rows]
    state = fe.init_state()
    ref_states = [f.init_state() for f in ref_fes]
    B = len(args)
    l_ir = torch.tensor([1, 37, 120, 5, 9, 60][:B], dtype=torch.int32)
    budget = torch.tensor([24, 300, 2, 64, 1, 90][:B], dtype=torch.int32)
    for w in range(3):
        cand, aux = fe.bound(state, l_ir + w, budget, 1000)
        acc = torch.zeros((B, wcfg.n_cores), dtype=torch.int32)
        state = fe.update(state, aux, acc)
        for i, (f, st) in enumerate(zip(ref_fes, ref_states)):
            rc, raux = f.bound(st, jnp.int32(int(l_ir[i]) + w),
                               jnp.int32(int(budget[i])), 1000)
            ref_states[i] = f.update(st, raux, None)
            for k, g, r in zip(rc._fields, cand, rc):
                np.testing.assert_array_equal(
                    g[i].numpy().astype(np.int64),
                    np.asarray(r).astype(np.int64), err_msg=f"{k} w{w}")
            for k, g, r in zip(ref_states[i]._fields, state,
                               ref_states[i]):
                np.testing.assert_array_equal(g[i].numpy(), np.asarray(r),
                                              err_msg=f"{k} w{w}")
    assert int(cand.valid.sum()) > 0
    if kind == "wrap":
        # the running sums did wrap: some cursor's line_cum went negative
        assert bool((state.line_cum < 0).any())


def test_frontend_refuses_unbatched_traces_and_wrong_core_counts():
    wcfg = get_stage("01-baseline").workload_config()
    t = make_trace(np.ones(10), np.zeros(10), np.zeros(10), 64)
    with pytest.raises(ValueError, match="leading batch axis"):
        TraceFrontend(t, wcfg)
    from repro_torch.traces import assign_traces, stack_mixes
    mix = stack_mixes([assign_traces([t], [0, 0, -1])])
    with pytest.raises(ValueError, match="mix has 3 cores"):
        TraceFrontend(mix, wcfg)


# ---- replay ----------------------------------------------------------------

@pytest.fixture(scope="module")
def replays(ref):
    """Each case of REPLAY_CASES replayed by both packages."""
    _, traces = make_suite(n=REPLAY_N)
    _, ref_traces = ref.kernels.make_suite(n=REPLAY_N)
    batch, ref_batch = stack_traces(traces), ref.trace.stack_traces(
        ref_traces)
    out = {}
    for case in REPLAY_CASES:
        stage, preset, events, windows, warmup = case
        kw = dict(preset=preset, weave_events=events, windows=windows,
                  warmup=warmup)
        out[case] = (
            replay_suite(get_stage(stage, **kw), batch, device="cpu"),
            ref.replay.replay_suite(ref.get_stage(stage, **kw), ref_batch))
    return out


@pytest.mark.parametrize("case", REPLAY_CASES, ids=lambda c: f"{c[0]}-"
                         f"{c[1]}-ev{c[2]}")
def test_replay_suite_matches_reference(replays, case):
    got, want = replays[case]
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=RTOL,
                                   atol=0, err_msg=k)
    assert set(want) <= set(got)
    A = len(KERNELS)
    assert got["progress"].shape == (A, case[3], 24)
    np.testing.assert_array_equal(got["progress"][:, -1, :23].min(1),
                                  got["progress_final"])
    assert (got["n_rd"] > 0).all()


def test_dense_reruns_merge_by_row(replays):
    """07-prefetch on ddr4 flags some rows (re-run dense) and not others;
    the small budget on ddr5_4800 flags every row.  Both matched the
    reference above, so the merged rows are the dense engine's."""
    partial, forced = (replays[c][0]["weave_sat"] > 0
                       for c in REPLAY_CASES[1:])
    assert partial.any() and not partial.all()
    assert forced.all()


def test_replay_stages_and_grid_equal_replay_suite():
    _, traces = make_suite(n=128, names=("stream", "pointer_chase"))
    batch = stack_traces(traces)
    kw = dict(windows=2, warmup=0)
    grid = replay_grid(["ddr4_2666"], ["03-ps-clock"], batch,
                       device="cpu", **kw)
    stages = replay_stages([get_stage("03-ps-clock", **kw)], batch,
                           device="cpu")
    one = replay_suite(get_stage("03-ps-clock", **kw), batch, device="cpu")
    for res in (grid["ddr4_2666"]["03-ps-clock"], stages["03-ps-clock"]):
        assert res.keys() == one.keys()
        for k, v in one.items():
            np.testing.assert_array_equal(res[k], v, err_msg=k)


def test_footprint_guard_matches_reference(ref):
    t = make_trace(np.ones(8), np.zeros(8), np.zeros(8), MAX_FOOTPRINT_LINES)
    rt = ref.trace.make_trace(np.ones(8), np.zeros(8), np.zeros(8),
                              MAX_FOOTPRINT_LINES)
    with pytest.raises(ValueError) as mine:
        replay_suite(get_stage("01-baseline", n_sockets=2),
                     stack_traces([t]), device="cpu")
    with pytest.raises(ValueError) as theirs:
        ref.replay.replay_suite(ref.get_stage("01-baseline", n_sockets=2),
                                ref.trace.stack_traces([rt]))
    assert str(mine.value) == str(theirs.value)


# ---- anchors ---------------------------------------------------------------

@pytest.mark.parametrize("preset", ["ddr4_2666", "ddr5_4800", "hbm2e"])
def test_anchors_match_reference(ref, preset):
    _, traces = make_suite(n=2048)
    _, ref_traces = ref.kernels.make_suite(n=2048)
    for sockets in (1, 2):
        got = anchor_suite_ms(traces, preset, n_sockets=sockets)
        want = ref.anchors.anchor_suite_ms(ref_traces, preset,
                                           n_sockets=sockets)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert anchor_runtime_ms(traces[0], preset, iters=3) == \
            pytest.approx(ref.anchors.anchor_runtime_ms(ref_traces[0],
                                                        preset, iters=3),
                          abs=1e-12)
        cores = [11, 7, 4] if sockets == 1 else [20, 17, 10]
        mix = anchor_mix_ms(traces[:3], cores, preset, n_sockets=sockets)
        np.testing.assert_allclose(
            mix, ref.anchors.anchor_mix_ms(ref_traces[:3], cores, preset,
                                           n_sockets=sockets),
            rtol=0, atol=1e-12)
        pred = got * np.linspace(0.5, 1.5, len(got))
        assert mape(pred, got) == pytest.approx(ref.anchors.mape(pred, want),
                                                abs=1e-12)
    with pytest.raises(ValueError, match="cores assigned"):
        anchor_mix_ms(traces[:2], [20, 20], preset)


# ---- the route rule --------------------------------------------------------

def _on_card():
    return types.SimpleNamespace(
        valid=types.SimpleNamespace(device=torch.device("cuda")))


class _OtherTraceFrontend(TraceFrontend):
    """A frontend the rule does not know (a subclass counts as another)."""


def test_route_rule_by_device_and_frontend_type():
    cfg = get_stage("07-prefetch", windows=2, warmup=0)
    wcfg = cfg.workload_config()
    _, traces = make_suite(n=64, names=("stream",))
    trace_fe = TraceFrontend(stack_traces(traces), wcfg)
    pace = torch.tensor([4], dtype=torch.int32)
    mess_fe = workload.MessFrontend(pace, pace, wcfg)
    on_cpu = dram.init_queue(cfg.platform.dram, cfg.policy)
    assert platform._inject_route(_on_card(), trace_fe) \
        is platform._bound_inject_eager
    assert platform._inject_route(_on_card(), mess_fe) \
        is platform._bound_inject_fused
    for fe in (trace_fe, mess_fe):
        assert platform._inject_route(on_cpu, fe) \
            is platform._bound_inject_eager
    other = _OtherTraceFrontend(stack_traces(traces), wcfg)
    with pytest.raises(NotImplementedError,
                       match="_OtherTraceFrontend on the card"):
        platform._inject_route(_on_card(), other)
    assert platform._inject_route(on_cpu, other) \
        is platform._bound_inject_eager


def test_trace_replay_on_cpu_launches_no_kernel():
    _, traces = make_suite(n=128, names=("gups",))
    kernels.reset_launch_counts()
    out = replay_suite(get_stage("07-prefetch", windows=2, warmup=0),
                       stack_traces(traces), device="cpu")
    assert not any(kernels.launch_counts().values())
    assert int(out["injected"][0]) > 0


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the trace route's kernels have no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_replay_on_card_matches_cpu(cuda):
    _, traces = make_suite(n=512)
    batch = stack_traces(traces)
    cfg = get_stage("07-prefetch", windows=2, warmup=0)
    kernels.reset_launch_counts()
    on_card = replay_suite(cfg, batch)
    counts = kernels.launch_counts()
    on_cpu = replay_suite(cfg, batch, device="cpu")
    reruns = int((on_card["weave_sat"] > 0).any())
    assert counts["weave_window"] == cfg.windows * (1 + reruns)
    assert counts["decode_packed"] == cfg.windows * (1 + reruns)
    assert counts["window_inject"] == 0
    for k, v in on_cpu.items():
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(on_card[k], v, rtol=RTOL, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(on_card[k], v, err_msg=k)
