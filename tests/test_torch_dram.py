"""One weave step: the port's `tick` and `next_event` against the
reference's, on live states carried across step by step.

The reference drives the trajectory; at every step its state goes to
the port (`state_from_numpy`), and the port's next state, `TickStats`
and event ticks must equal the reference's exactly.  The cases cover
all-bank (DDR4, HBM2e) and same-bank (DDR5 REFsb) refresh, the
row-hit-capped Ramulator2 flavor, scalar and per-channel ``t``, and
mixed ``active``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dram as ref_dram
from repro.core.backends import make_policy as ref_make_policy
from repro.core.presets import PRESETS as REF_PRESETS
from repro_torch.core import dram
from repro_torch.core.backends import make_policy
from repro_torch.core.dram import state_from_numpy, state_to_numpy
from repro_torch.core.presets import PRESETS

torch.set_num_threads(1)

TICK_KW = dict(tick2cpu_num=750, tick2cpu_den=1, cpu_ps_per_clk=476)


@functools.lru_cache(maxsize=None)
def _ref_fns(preset, backend):
    d, pol = REF_PRESETS[preset], ref_make_policy(backend)
    tick = jax.jit(lambda q, b, t, a: ref_dram.tick(
        q, b, t, dram=d, policy=pol, active=a, **TICK_KW))
    nev = jax.jit(lambda q, b, t, end: ref_dram.next_event(
        q, b, t, end, dram=d, policy=pol))
    return tick, nev


def _np(tree):
    return {k: np.array(v) for k, v in tree._asdict().items()}


def _random_state(rng, preset, t0):
    """A mid-flight reference state: a part-filled queue with arrivals
    around ``t0``, open rows, pending timers, refresh deadlines close."""
    d = REF_PRESETS[preset]
    C, RB, R = d.n_channels, d.banks_per_channel, d.ranks_per_channel
    Q = 256
    q = dict(
        valid=(rng.random((C, Q)) < 0.35).astype(np.int32),
        is_write=(rng.random((C, Q)) < 0.4).astype(np.int32),
        arrival=rng.integers(t0 - 40, t0 + 40, (C, Q)).astype(np.int32),
        issue_cycle=rng.integers(0, 2 * t0 + 1, (C, Q)).astype(np.int32),
        fbank=rng.integers(0, RB, (C, Q)).astype(np.int32),
        row=rng.integers(0, 4, (C, Q)).astype(np.int32),
        is_chase=(rng.random((C, Q)) < 0.1).astype(np.int32))
    b = _np(ref_dram.init_banks(d))
    b.update(
        open_row=rng.integers(-1, 4, (C, RB)).astype(np.int32),
        next_act=rng.integers(t0 - 10, t0 + 30, (C, RB)).astype(np.int32),
        next_rd=rng.integers(t0 - 10, t0 + 20, (C, RB)).astype(np.int32),
        next_wr=rng.integers(t0 - 10, t0 + 20, (C, RB)).astype(np.int32),
        next_pre=rng.integers(t0 - 10, t0 + 30, (C, RB)).astype(np.int32),
        faw=np.sort(rng.integers(t0 - 60, t0, (C, R, 4)),
                    axis=2).astype(np.int32),
        next_ref=rng.integers(t0, t0 + 40, (C, R)).astype(np.int32),
        ref_slot=rng.integers(0, d.banks_per_rank, (C, R)).astype(np.int32),
        bus_free=rng.integers(t0 - 5, t0 + 5, C).astype(np.int32),
        wtr_until=rng.integers(t0 - 5, t0 + 10, C).astype(np.int32),
        rtw_until=rng.integers(t0 - 5, t0 + 10, C).astype(np.int32),
        last_rank=rng.integers(0, R, C).astype(np.int32),
        drain=rng.random(C) < 0.3,
        hit_streak=rng.integers(0, 6, C).astype(np.int32))
    return q, b


def _crafted_state(preset):
    """A reference-test style queue: hits, a conflict, a FAW burst and a
    write batch past the drain watermark, from a fresh controller."""
    d = REF_PRESETS[preset]
    q = _np(ref_dram.init_queue(d, ref_dram.SchedulerPolicy()))
    entries = ([(0, i, 7, 0, 0) for i in range(6)]            # FAW burst
               + [(1, 0, 3, 0, 0), (1, 0, 5, 0, 2)]           # conflict
               + [(2, i % 4, 1, 1, i) for i in range(24)]     # drain
               + [(3, 2, 9, 0, 30), (3, 2, 9, 1, 31)])
    for slot, (c, fb, row, wr, arr) in enumerate(entries):
        q["valid"][c, slot] = 1
        q["fbank"][c, slot] = fb
        q["row"][c, slot] = row
        q["is_write"][c, slot] = wr
        q["arrival"][c, slot] = arr
    b = _np(ref_dram.init_banks(d))
    b["next_ref"][:, 0] = 20                   # a refresh mid-run
    return q, b


CASES = [
    # preset, backend, t mode, active mode, initial state
    ("ddr4_2666", "ramulator", "scalar", "all", "crafted"),
    ("ddr4_2666", "ramulator", "scalar", "mixed", "random"),
    ("ddr4_2666", "ramulator2", "channel", "mixed", "random"),
    ("ddr5_4800", "ramulator", "channel", "all", "random"),
    ("ddr5_4800", "dramsim3", "scalar", "mixed", "random"),
    ("hbm2e", "ramulator2", "channel", "mixed", "random"),
]


@pytest.mark.parametrize("preset,backend,t_mode,active_mode,init", CASES)
def test_tick_and_next_event_match_reference(preset, backend, t_mode,
                                             active_mode, init):
    rng = np.random.default_rng(len(preset) + len(backend) + len(t_mode))
    d, pol = PRESETS[preset], make_policy(backend)
    C = d.n_channels
    ref_tick, ref_nev = _ref_fns(preset, backend)
    t0 = 0 if init == "crafted" else 200
    q_np, b_np = (_crafted_state(preset) if init == "crafted"
                  else _random_state(rng, preset, t0))
    q_ref = ref_dram.QueueState(**{k: jnp.asarray(v) for k, v in q_np.items()})
    b_ref = ref_dram.BankState(**{k: jnp.asarray(v) for k, v in b_np.items()})
    offsets = rng.integers(0, 6, C).astype(np.int32)
    served = refreshed = 0
    for step in range(60):
        if t_mode == "scalar":
            t = np.int32(t0 + step)
        else:
            t = (t0 + step + offsets).astype(np.int32)
        active = (np.ones(C, bool) if active_mode == "all" or step % 3 == 0
                  else rng.random(C) < 0.7)
        q_port, b_port = state_from_numpy(*_state_np(q_ref, b_ref))
        q2, b2, st = dram.tick(q_port, b_port, torch.as_tensor(t), dram=d,
                               policy=pol, active=torch.as_tensor(active),
                               **TICK_KW)
        q_ref, b_ref_next, st_ref = ref_tick(q_ref, b_ref, jnp.asarray(t),
                                             jnp.asarray(active))
        refreshed += int((np.asarray(b_ref_next.next_ref)
                          != np.asarray(b_ref.next_ref)).sum())
        b_ref = b_ref_next
        qn, bn = state_to_numpy(q2, b2, batched=False)
        for name, ref in {**_np(q_ref), **_np(b_ref)}.items():
            port = qn[name] if name in qn else bn[name]
            np.testing.assert_array_equal(port, ref,
                                          err_msg=f"{name} at step {step}")
        for name, ref in _np(st_ref).items():
            np.testing.assert_array_equal(getattr(st, name).numpy()[0], ref,
                                          err_msg=f"stats.{name} @ {step}")
        served += int(st.served_rd.sum() + st.served_wr.sum())
        end = int(np.max(t)) + 200
        ev = dram.next_event(q2, b2, torch.as_tensor(t), end, dram=d,
                             policy=pol)
        ev_ref = ref_nev(q_ref, b_ref, jnp.asarray(t), jnp.int32(end))
        np.testing.assert_array_equal(ev.numpy()[0], np.asarray(ev_ref),
                                      err_msg=f"next_event at step {step}")
    assert served > 0 and refreshed > 0     # the run exercised the model


def _state_np(q, b):
    return _np(q), _np(b)


def test_state_round_trips_through_numpy():
    d = REF_PRESETS["ddr5_4800"]
    q_np = _np(ref_dram.init_queue(d, ref_dram.SchedulerPolicy(), 2))
    b_np = _np(ref_dram.init_banks(d))
    q, b = state_from_numpy(q_np, b_np)
    assert q.valid.shape == (1, 12, 512) and b.faw.shape == (1, 12, 2, 4)
    assert b.drain.dtype == torch.bool and q.row.dtype == torch.int32
    q2, b2 = state_to_numpy(q, b, batched=False)
    for k in q_np:
        np.testing.assert_array_equal(q2[k], q_np[k])
    for k in b_np:
        np.testing.assert_array_equal(b2[k], b_np[k])
    # the port's own initial state equals the reference's
    pq = dram.init_queue(PRESETS["ddr5_4800"], dram.SchedulerPolicy(), 2)
    pb = dram.init_banks(PRESETS["ddr5_4800"])
    q3, b3 = state_to_numpy(pq, pb, batched=False)
    for k in q_np:
        np.testing.assert_array_equal(q3[k], q_np[k])
    for k in b_np:
        np.testing.assert_array_equal(b3[k], b_np[k])
