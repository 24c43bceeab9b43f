"""Bound phase + interface: `generate`, `inject_queue` and the Mess
frontend's update, window by window, against the reference.

Two operating points run as one batch in the port and one at a time in
the reference.  Every window starts from the reference's state (queue
slots are freed at random between windows, standing in for the weave
phase), and the candidates, queue contents, accepted demand and the
injected count must be equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dram as ref_dram
from repro.core import workload as ref_workload
from repro.core.stages import get_stage as ref_get_stage
from repro_torch.core import dram, workload
from repro_torch.core.stages import get_stage

torch.set_num_threads(1)

CASES = [
    # stage, preset, sockets, channel ownership
    ("07-prefetch", "ddr4_2666", 1, "interleaved"),   # prefetch, skylake_xor
    ("04-model-correct", "ddr4_2666", 2, "interleaved"),
    ("07-prefetch", "ddr4_2666", 2, "partitioned"),
    ("07-prefetch", "hbm2e", 2, "partitioned"),       # xor_fold fallback
]
POINTS = ((12, 16), (64, 32))                         # (pace, wr_num)


@functools.lru_cache(maxsize=None)
def _ref_fns(cfg):
    wcfg, clock = cfg.workload_config(), cfg.clock()
    gen = jax.jit(lambda cores, p, wr, lir, budget: ref_workload.generate(
        cores, p, wr, lir, wcfg, 1000, budget))
    inj = jax.jit(lambda q, cand, w: ref_workload.inject_queue(
        q, cand, clock, w, wcfg))

    @jax.jit
    def upd(cores, aux, acc, p, wr):
        return ref_workload.MessFrontend(p, wr, wcfg).update(cores, aux, acc)

    return gen, inj, upd


def _stack(trees):
    """Reference NamedTuples, one per point -> dict of (B, ...) tensors."""
    return {k: torch.from_numpy(np.stack([np.asarray(getattr(t, k))
                                          for t in trees]))
            for k in trees[0]._fields}


def _check(port, refs, what):
    for k in refs[0]._fields if hasattr(refs[0], "_fields") else refs[0]:
        ref = np.stack([np.asarray(r[k] if isinstance(r, dict)
                                   else getattr(r, k)) for r in refs])
        got = (port[k] if isinstance(port, dict) else getattr(port, k))
        np.testing.assert_array_equal(got.numpy(), ref.astype(
            got.numpy().dtype), err_msg=f"{what}.{k}")


@pytest.mark.parametrize("stage,preset,sockets,owner", CASES)
def test_generate_and_inject_match_reference(stage, preset, sockets, owner):
    kw = dict(preset=preset, n_sockets=sockets, socket_channels=owner)
    ref_cfg, cfg = ref_get_stage(stage, **kw), get_stage(stage, **kw)
    gen, inj, upd = _ref_fns(ref_cfg)
    wcfg, clock = cfg.workload_config(), cfg.clock()
    rng = np.random.default_rng(sockets * 7 + len(stage) + len(preset))
    d = ref_cfg.platform.dram
    cores = [ref_workload.init_cores(wcfg.n_cores) for _ in POINTS]
    queues = [ref_dram.init_queue(d, ref_cfg.policy, sockets)
              for _ in POINTS]
    pace = torch.tensor([p for p, _ in POINTS], dtype=torch.int32)
    wr = torch.tensor([w for _, w in POINTS], dtype=torch.int32)
    frontend = workload.MessFrontend(pace, wr, wcfg)
    accepted = 0
    for w in range(6):
        lir = rng.integers(1, 300, len(POINTS)).astype(np.int32)
        budget = rng.integers(1, 80, len(POINTS)).astype(np.int32)
        cs = _stack(cores)
        port_cores = workload.CoreState(**cs)
        cand, aux = frontend.bound(port_cores, torch.from_numpy(lir),
                                   torch.from_numpy(budget), 1000)
        q_port = dram.QueueState(**_stack(queues))
        q2, acc, n_inj = workload.inject_queue(q_port, cand, clock, w, wcfg)
        new_cores = frontend.update(port_cores, aux, acc)

        refs = [gen(cores[i], jnp.int32(p), jnp.int32(wn),
                    jnp.int32(lir[i]), jnp.int32(budget[i]))
                for i, (p, wn) in enumerate(POINTS)]
        _check(cand, [r[0] for r in refs], "cand")
        _check(aux, [r[1] for r in refs], "aux")
        injected = [inj(queues[i], refs[i][0], jnp.int32(w))
                    for i in range(len(POINTS))]
        _check(q2, [r[0] for r in injected], "queue")
        _check({"acc": acc, "n": n_inj},
               [{"acc": r[1], "n": r[2]} for r in injected], "inject")
        cores = [upd(cores[i], refs[i][1], injected[i][1], jnp.int32(p),
                     jnp.int32(wn)) for i, (p, wn) in enumerate(POINTS)]
        _check(new_cores, cores, "cores")
        accepted += int(n_inj.sum())
        # free a random part of each queue, as the weave phase would
        queues = []
        for r in injected:
            q = {k: np.array(v) for k, v in r[0]._asdict().items()}
            q["valid"] &= (rng.random(q["valid"].shape) < 0.6)
            queues.append(ref_dram.QueueState(
                **{k: jnp.asarray(v) for k, v in q.items()}))
    assert accepted > 0


def test_littles_law_budget_matches_reference():
    lat = np.random.default_rng(0).uniform(0.0, 2e6, 20000).astype(
        np.float32)
    lat[:3] = [0.0, 1.0, 476000.0]
    for window_ps in (476000, 1000 * 417):
        np.testing.assert_array_equal(
            workload.littles_law_budget(torch.from_numpy(lat),
                                        window_ps).numpy(),
            np.asarray(ref_workload.littles_law_budget(jnp.asarray(lat),
                                                       window_ps)))


def test_stream_hashes_match_reference_over_uint32():
    k = np.random.default_rng(1).integers(-64, 1 << 30, 4096).astype(
        np.int32)
    core = np.arange(4096, dtype=np.int32) % 48
    np.testing.assert_array_equal(
        workload._segment_line(torch.from_numpy(core),
                               torch.from_numpy(k)).numpy(),
        np.asarray(ref_workload._segment_line(jnp.asarray(core),
                                              jnp.asarray(k))).astype(
            np.int64))
    np.testing.assert_array_equal(
        workload._chase_line(torch.from_numpy(np.abs(k))).numpy(),
        np.asarray(ref_workload._chase_line(jnp.asarray(np.abs(k)))).astype(
            np.int64))
