"""Multiprogrammed replay: the port's mixes, mix frontend and
`replay_mixes` against the JAX reference on the CPU.

From the same numpy inputs: `assign_traces` (rotation with
``wrap=True``, truncation with ``wrap=False``), `split_cores`,
`stack_mixes` and `mix_stats` give equal fields and refuse the same
inputs with the same errors; the mix frontend's ``bound`` / ``update``
give equal candidates and state over 3 windows from phase-offset
cursors; `replay_mixes` on two stacked mixes (one socket) and
`replay_mix` on one two-socket mix (48 cores, partitioned channels) give
equal integers and float views within ``rtol=1e-6``.  The reference is
held at one device (``n_devices=1``).
"""
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.core import get_stage
from repro_torch.traces import (TraceFrontend, assign_traces, make_suite,
                                make_trace, mix_stats, replay_mix,
                                replay_mixes, split_cores, stack_mixes)

torch.set_num_threads(1)

RTOL = 1e-6
N = 512
KW = dict(windows=6, warmup=2)
MIXES = (("stream", "pointer_chase"), ("bfs_frontier", "spmv", "stencil3d"))
TWO_SOCKET = dict(stage="10-delay-buffer", preset="ddr4_2666", n_sockets=2,
                  socket_channels="partitioned", apps=("stream", "gups"))
VIEW_KEYS = ("sim_bw_gbs", "sim_lat_ns", "if_bw_gbs", "if_lat_ns",
             "app_bw_gbs", "app_lat_ns", "chase_lat_ns")
INT_KEYS = ("n_rd", "n_wr", "weave_sat", "core_done", "app_done")
FLOAT_KEYS = VIEW_KEYS + ("core_runtime_windows", "app_runtime_windows",
                          "app_runtime_ms")


@pytest.fixture(scope="module")
def ref():
    """The JAX package's traces API, its replay held at one device."""
    from repro.core import get_stage as ref_get_stage
    from repro.core import shard
    from repro.traces import frontend, kernels, mix, replay, trace

    mp = pytest.MonkeyPatch()
    mp.setattr(replay, "sharded_vmap",
               functools.partial(shard.sharded_vmap, n_devices=1))
    replay._replay_fn.cache_clear()
    yield types.SimpleNamespace(get_stage=ref_get_stage, frontend=frontend,
                                kernels=kernels, mix=mix, replay=replay,
                                trace=trace)
    mp.undo()
    replay._replay_fn.cache_clear()


def _assert_fields_equal(got, want):
    assert got._fields == want._fields
    for f, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f)
        assert g.dtype == torch.int32, f


def _pair(ref, names, n=N):
    """The same apps from both packages: (port traces, reference traces)."""
    return (make_suite(n=n, names=names)[1],
            ref.kernels.make_suite(n=n, names=names)[1])


def _small(ref):
    """Three short apps of both packages, one with large deltas over a
    footprint that is not a power of two."""
    rng = np.random.default_rng(3)
    args = [(rng.integers(-(1 << 30), 1 << 30, 70), rng.integers(0, 2, 70),
             rng.integers(0, 2, 70), 999_983),
            (np.ones(40), np.zeros(40), np.zeros(40), 1 << 12),
            (np.full(100, 3), np.ones(100), rng.integers(0, 2, 100), 1000)]
    return ([make_trace(*a) for a in args],
            [ref.trace.make_trace(*a) for a in args])


# ---- construction ----------------------------------------------------------

ASSIGNMENTS = [
    # assignment, phase offsets
    ([0, 0, 1, 2, 2, -1], None),
    ([0, 0, 1, 2, 2, -1], [0, 35, 7, 130, 50, 0]),
    ([2, 1, 0, -1, 1, -1], [-4, 41, 71, 3, 9, 5]),
]


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("i", range(len(ASSIGNMENTS)))
def test_assign_traces_equals_reference(ref, wrap, i):
    mine, theirs = _small(ref)
    asn, offs = ASSIGNMENTS[i]
    got = assign_traces(mine, asn, offs, wrap=wrap)
    want = ref.mix.assign_traces(theirs, asn, offs, wrap=wrap)
    _assert_fields_equal(got, want)
    assert mix_stats(got) == ref.mix.mix_stats(want)


BAD_ASSIGNMENTS = [
    ([0, 1, 2, 0], None),                  # the chase core is busy
    ([0, 1, 3, -1], None),                 # app out of range
    ([0, 1, -2, -1], None),
    ([0, 0, 1, -1], None),                 # app 2 has no core
    ([0, 1, 2, -1], [0, 0, 0]),            # offsets of the wrong length
]


@pytest.mark.parametrize("asn,offs", BAD_ASSIGNMENTS)
def test_assign_traces_refuses_what_the_reference_refuses(ref, asn, offs):
    mine, theirs = _small(ref)
    with pytest.raises(ValueError) as got:
        assign_traces(mine, asn, offs)
    with pytest.raises(ValueError) as want:
        ref.mix.assign_traces(theirs, asn, offs)
    assert str(got.value) == str(want.value)


def test_assign_traces_refuses_footprints_past_the_chase_region(ref):
    args = (np.ones(8), np.zeros(8), np.zeros(8), 1 << 26)
    asn = [0] * 40 + [-1]                  # 41 cores x 2^26 > 2^31
    with pytest.raises(ValueError) as got:
        assign_traces([make_trace(*args)], asn)
    with pytest.raises(ValueError) as want:
        ref.mix.assign_traces([ref.trace.make_trace(*args)], asn)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_apps,n_cores", [(1, 24), (2, 24), (3, 24),
                                            (5, 48), (23, 24), (0, 24),
                                            (24, 24)])
def test_split_cores_equals_reference(ref, n_apps, n_cores):
    try:
        want = ref.mix.split_cores(n_apps, n_cores)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            split_cores(n_apps, n_cores)
    else:
        assert split_cores(n_apps, n_cores) == want


def test_stack_mixes_equals_reference_and_refuses_core_counts(ref):
    mine, theirs = _small(ref)
    got = stack_mixes([assign_traces(mine[:2], [0, 1, 0, -1]),
                       assign_traces(mine, [2, 1, 0, -1], [0, 5, 9, 0],
                                     wrap=False)])
    want = ref.mix.stack_mixes([
        ref.mix.assign_traces(theirs[:2], [0, 1, 0, -1]),
        ref.mix.assign_traces(theirs, [2, 1, 0, -1], [0, 5, 9, 0],
                              wrap=False)])
    _assert_fields_equal(got, want)
    with pytest.raises(ValueError, match="same core count"):
        stack_mixes([assign_traces(mine[:1], [0, -1]),
                     assign_traces(mine[:1], [0, 0, -1])])


# ---- the mix frontend -------------------------------------------------------

@pytest.mark.parametrize("wrap", [True, False])
def test_mix_frontend_bound_and_update_match_reference(ref, wrap):
    import jax.numpy as jnp

    mine, theirs = _small(ref)
    cfg = get_stage("06-noc")
    ref_cfg = ref.get_stage("06-noc")
    asn = split_cores(3, 24)
    offs = [(17 * c) % 90 for c in range(24)]
    mixes = [assign_traces(mine, asn, offs, wrap=wrap),
             assign_traces(mine[::-1], asn, offs[::-1], wrap=wrap)]
    ref_mixes = [ref.mix.assign_traces(theirs, asn, offs, wrap=wrap),
                 ref.mix.assign_traces(theirs[::-1], asn, offs[::-1],
                                       wrap=wrap)]
    fe = TraceFrontend(stack_mixes(mixes), cfg.workload_config())
    ref_fes = [ref.frontend.TraceFrontend(m, ref_cfg.workload_config())
               for m in ref_mixes]
    state = fe.init_state()
    ref_states = [f.init_state() for f in ref_fes]
    l_ir = torch.tensor([3, 90], dtype=torch.int32)
    budget = torch.tensor([40, 7], dtype=torch.int32)
    for w in range(3):
        cand, aux = fe.bound(state, l_ir, budget, 1000)
        state = fe.update(state, aux, None)
        for i, (f, st) in enumerate(zip(ref_fes, ref_states)):
            rc, raux = f.bound(st, jnp.int32(int(l_ir[i])),
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


# ---- replay ------------------------------------------------------------------

def _assert_replay_equal(got, want):
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    for k in FLOAT_KEYS:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=RTOL,
                                   atol=0, err_msg=k, equal_nan=True)
    assert set(want) <= set(got)


def test_replay_mixes_matches_reference(ref):
    built, ref_built = [], []
    for names in MIXES:
        mine, theirs = _pair(ref, names)
        asn = split_cores(len(names), 24)
        built.append(assign_traces(mine, asn))
        ref_built.append(ref.mix.assign_traces(theirs, asn))
    cfg = get_stage("07-prefetch", **KW)
    got = replay_mixes(cfg, stack_mixes(built), device="cpu")
    want = ref.replay.replay_mixes(ref.get_stage("07-prefetch", **KW),
                                   ref.mix.stack_mixes(ref_built))
    _assert_replay_equal(got, want)
    assert got["app_runtime_ms"].shape == (2, 3)
    assert np.isnan(got["app_runtime_ms"][0, 2])       # a two-app mix
    assert got["progress"].shape == (2, KW["windows"], 24)


def test_two_socket_mix_matches_reference(ref):
    c = TWO_SOCKET
    mine, theirs = _pair(ref, c["apps"])
    asn = split_cores(len(c["apps"]), 48)
    offs = [(37 * i) % N for i in range(48)]
    kw = dict(preset=c["preset"], n_sockets=c["n_sockets"],
              socket_channels=c["socket_channels"], **KW)
    got = replay_mix(get_stage(c["stage"], **kw),
                     assign_traces(mine, asn, offs, wrap=False),
                     device="cpu")
    want = ref.replay.replay_mix(
        ref.get_stage(c["stage"], **kw),
        ref.mix.assign_traces(theirs, asn, offs, wrap=False))
    _assert_replay_equal(got, want)
    assert got["core_runtime_windows"].shape == (48,)
    assert got["core_runtime_windows"][-1] == 0        # the chase probe
