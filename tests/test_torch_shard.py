"""The batch axis over several devices (`repro_torch.core.shard`): the
splitting rules of `sharded_vmap`, the device list an entry point
resolves, and the Mess sweep and the trace replay split into chunks,
bit for bit equal to the unsplit run and to the reference's.

The CPU stands in for the cards: ``device=[cpu] * k`` runs the chunked
route (one chunk per entry), as the reference's test forces 4 host
devices.  The reference is held at one device (``n_devices=1``): its
own 4-device test fails in this environment.  On a machine with a card,
``python -m pytest -m gpu tests/test_torch_shard.py`` runs the sweep
chunked on the card and over every card, each asked for by a list.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import get_stage, mess, shard
from repro_torch.traces import make_suite, replay_suite, stack_traces

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture
def cards(monkeypatch):
    """Pretend the host has three cards (nothing may launch on them)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    return [torch.device("cuda", i) for i in range(3)]


def _recorder(calls):
    """A batched function that records each chunk it is given."""
    def fn(tree, dev):
        rows = tree[0] if isinstance(tree, tuple) else tree
        calls.append((len(rows), dev))
        return dict(s=tree[0] + tree[1], d=tree[0] - tree[1])
    return fn


def test_single_device_is_the_unsplit_call():
    calls = []
    batch = (np.arange(7), np.arange(7) * 3)
    out = shard.sharded_vmap(_recorder(calls), [CPU])(batch)
    assert calls == [(7, CPU)]
    np.testing.assert_array_equal(out["s"], np.arange(7) * 4)


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_tuple_batch_and_dict_output(kind):
    a = torch.arange(5.0) if kind == "tensor" else np.arange(5.0)
    calls = []
    out = shard.sharded_vmap(_recorder(calls), [CPU] * 4)((a, a * 3))
    assert [n for n, _ in calls] == [2, 1, 1, 1]
    assert type(out["s"]) is type(a) and tuple(out["d"].shape) == (5,)
    np.testing.assert_array_equal(np.asarray(out["s"]), np.arange(5.0) * 4)
    np.testing.assert_array_equal(np.asarray(out["d"]), -np.arange(5.0) * 2)


@pytest.mark.parametrize("n,k,sizes", [
    (3, 4, [1, 1, 1]),           # 3 rows on 4 devices: 3 chunks
    (18, 4, [5, 5, 4, 4]), (12, 3, [4, 4, 4]), (6, 4, [2, 2, 1, 1]),
    (1, 4, [1]), (7, 1, [7])])
def test_no_chunk_is_empty(n, k, sizes):
    bounds = shard.chunk_bounds(n, k)
    assert [b - a for a, b in bounds] == sizes
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    calls = []
    x = np.arange(n)
    out = shard.sharded_vmap(_recorder(calls), [CPU] * k)((x, x))
    assert [m for m, _ in calls] == sizes
    np.testing.assert_array_equal(out["s"], 2 * x)


def test_devices_beyond_the_cards_raise(cards):
    """The reference's ``n_devices`` beyond the cards present: here a
    device list naming a card that is not there."""
    with pytest.raises(ValueError, match="not present"):
        shard.resolve_devices("cuda:3")
    with pytest.raises(ValueError, match="not present"):
        shard.resolve_devices(cards + ["cuda:3"])
    with pytest.raises(ValueError, match="not present"):
        shard.sharded_vmap(_recorder([]), ["cuda:0", "cuda:5"])
    with pytest.raises(ValueError, match="empty"):
        shard.resolve_devices([])
    with pytest.raises(ValueError, match="empty"):
        shard.sharded_vmap(_recorder([]), [])


def test_no_card_raises_and_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    for call in (lambda: shard.resolve_devices(),
                 lambda: shard.resolve_devices("cuda:0"),
                 lambda: shard.sharded_vmap(_recorder([]), [CPU, "cuda"]),
                 lambda: shard.resolve_devices([CPU, "cuda:0"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_device_none_is_one_card_and_a_list_spreads(cards, monkeypatch):
    """``None`` means the card (one device, whatever the host has), an
    explicit device that device, a list every device in it; the sweep
    then hands one chunk to each.  The chunks run here through the CPU
    (the card is pretended), and nothing launches."""
    assert shard.resolve_devices() == [torch.device("cuda")]
    assert shard.resolve_devices("cuda:1") == [cards[1]]
    assert shard.resolve_devices("cpu") == [CPU]
    assert shard.resolve_devices(cards) == cards
    assert shard.resolve_devices(("cuda:0",) * 2) == [cards[0]] * 2
    assert shard.device_count() == 3
    calls = []
    out = shard.sharded_vmap(_recorder(calls), cards)((np.arange(5),) * 2)
    assert calls == [(2, cards[0]), (2, cards[1]), (1, cards[2])]
    np.testing.assert_array_equal(out["d"], np.zeros(5))

    run_point = mess.run_point
    seen = []

    def on_cpu(cfg, pace, wr, *, device):
        seen.append((tuple(pace), device))
        return run_point(cfg, pace, wr, device="cpu")

    monkeypatch.setattr(mess, "run_point", on_cpu)
    kernels.reset_launch_counts()
    cfg = get_stage("01-baseline", windows=1, warmup=0, weave="dense")
    kw = dict(paces=(1, 8, 24), write_mixes=(0, 16))
    got = mess.sweep(cfg, device=cards, **kw)
    assert [d for _, d in seen] == cards
    assert [p for p, _ in seen] == [(1, 8), (24, 1), (8, 24)]
    seen.clear()
    one = mess.sweep(cfg, **kw)
    assert seen == [((1, 8, 24) * 2, torch.device("cuda"))]
    assert not any(kernels.launch_counts().values())
    monkeypatch.setattr(mess, "run_point", run_point)
    want = mess.sweep(cfg, device="cpu", **kw)
    for f in ("sim_bw", "sim_lat", "if_bw", "if_lat", "app_bw", "app_lat",
              "chase_lat"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(getattr(one, f), getattr(want, f))


# ---- the main path's two batch axes, split ---------------------------------

SWEEP_PACES, SWEEP_MIXES = (2, 16, 48, 64), (0, 16)


@pytest.fixture(scope="module")
def sweep_points():
    """The stage-04 grid at 2 windows with the knee routing patched so
    that pace 48 runs the event engine, where it runs out of budget at
    write mix 16 and is re-run dense; the unsplit result and the engine
    batches it ran."""
    cfg = get_stage("04-model-correct", windows=2, warmup=0)
    grid_p = [p for _ in SWEEP_MIXES for p in SWEEP_PACES]
    grid_w = [w for w in SWEEP_MIXES for _ in SWEEP_PACES]
    mp = pytest.MonkeyPatch()
    mp.setattr(mess, "event_covers", lambda cfg, pace: pace <= 48)
    batches = []
    batch = mess._batch

    def spy(cfg, paces, wrs, devices):
        batches.append((cfg.weave, list(paces)))
        return batch(cfg, paces, wrs, devices)

    mp.setattr(mess, "_batch", spy)
    whole = mess._run_points(cfg, grid_p, grid_w, device="cpu")
    mp.setattr(mess, "_batch", batch)
    yield mp, cfg, grid_p, grid_w, whole, batches
    mp.undo()


def test_sweep_reruns_a_saturated_event_point_dense(sweep_points):
    _, _, _, _, whole, batches = sweep_points
    assert batches[0] == ("event", [2, 16, 48, 2, 16, 48])
    assert batches[1] == ("dense", [64, 64, 48])
    assert not whole["weave_sat"].any()


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sweep_split_k_ways_is_bit_identical(sweep_points, k):
    _, cfg, grid_p, grid_w, whole, _ = sweep_points
    kernels.reset_launch_counts()
    got = mess._run_points(cfg, grid_p, grid_w, [CPU] * k)
    assert got.keys() == whole.keys()
    for key, want in whole.items():
        assert got[key].dtype == want.dtype, key
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert not any(kernels.launch_counts().values())    # the CPU's routes


@pytest.fixture(scope="module")
def ref_replay():
    """The reference's replay of the reference's own 4-device case,
    held at one device."""
    from repro.core import get_stage as ref_get_stage
    from repro.core import shard as ref_shard
    from repro.traces import make_suite as ref_make_suite
    from repro.traces import replay, stack_traces as ref_stack

    mp = pytest.MonkeyPatch()
    mp.setattr(replay, "sharded_vmap",
               functools.partial(ref_shard.sharded_vmap, n_devices=1))
    replay._replay_fn.cache_clear()
    cfg = ref_get_stage("03-ps-clock", windows=6, warmup=2)
    _, traces = ref_make_suite(n=256, names=("stream", "gups",
                                             "pointer_chase"))
    out = replay.replay_suite(cfg, ref_stack(traces))
    mp.undo()
    replay._replay_fn.cache_clear()
    return {k: np.asarray(v) for k, v in out.items()}


def test_replay_on_four_devices_equals_one_and_the_reference(ref_replay):
    """The reference's 4-device case (3 apps on 4 devices: 3 chunks)."""
    cfg = get_stage("03-ps-clock", windows=6, warmup=2)
    _, traces = make_suite(n=256, names=("stream", "gups", "pointer_chase"))
    batch = stack_traces(traces)
    one = replay_suite(cfg, batch, device="cpu")
    four = replay_suite(cfg, batch, device=[CPU] * 4)
    assert four.keys() == one.keys()
    for k, v in one.items():
        np.testing.assert_array_equal(four[k], v, err_msg=k)
    for k, want in ref_replay.items():
        assert four[k].dtype == want.dtype, k
        np.testing.assert_array_equal(four[k], want, err_msg=k)


def test_replay_dense_rerun_rows_merge_across_chunks():
    """Every row saturates a tiny event budget and is re-run dense; the
    re-run rows split over the devices and merge back by row."""
    cfg = dataclasses.replace(get_stage("07-prefetch", windows=3, warmup=1,
                                        telemetry=True), weave_events=48)
    _, traces = make_suite(n=256, names=("stream", "gups", "spmv"))
    batch = stack_traces(traces)
    one = replay_suite(cfg, batch, device="cpu")
    assert one["weave_sat"].all()
    split = replay_suite(cfg, batch, device=[CPU] * 2)
    assert split.keys() == one.keys()
    for k, v in one.items():
        np.testing.assert_array_equal(split[k], v, err_msg=k)


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_sweep_chunked_on_the_card_is_bit_identical(cuda):
    cfg = get_stage("07-prefetch", windows=4, warmup=1)
    kw = dict(paces=(1, 4, 12, 48), write_mixes=(0, 32))
    whole = mess.sweep(cfg, device=cuda, **kw)
    runs = [[cuda] * 3]
    if torch.cuda.device_count() > 1:           # every card
        runs.append([torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())])
    for devices in runs:
        got = mess.sweep(cfg, device=devices, **kw)
        for f in ("sim_bw", "sim_lat", "if_bw", "if_lat", "app_bw",
                  "app_lat", "chase_lat"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(whole, f), err_msg=f)
