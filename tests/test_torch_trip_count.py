"""The dry-run's trip count (`launch.dryrun.StepCounter`, `trips=True`)
against the same step counted op by op, at small sizes on the CPU.

The sLSTM's loop over time (`models.common.scan`) runs its first four
steps and its last under the counter, which holds steps 2 and 3 alike
and stands them in for the steps left out, as the reference's cost model
counts a ``lax.scan`` body by its trip count.  Every field of the count
equals the op-by-op count's (``count_step(..., _trips=False)``):
FLOPs, bytes, ``temp`` (the peak), ``output``, ``args`` and the
collectives (bytes and counts by op, and the log in order), on
xlstm-1.3b's toy (d 256, 4 heads, vocab 512, one mLSTM and one sLSTM
layer) at prefill and train on the pod, train on the multipod and on the
host, and prefill on the host, each at two sequence lengths (a per-step
term that grows with the sequence, as the backward's whole-input
``select_backward`` zeros do, is told from one that does not), and on
xlstm-1.3b at full width cut to one segment (7 mLSTM + 1 sLSTM layers),
a train step over 256 tokens on the pod, and the toy's train step on
the pod under ``REPRO_NO_SP`` (the sLSTM on the whole rows).  A loop whose middle steps
differ, forward or backward, raises, naming the loop and the field.
"""
import dataclasses

import pytest
import torch

from _trip_count_check import FIELDS, count
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.models import common as cm

TOY = dict(d_model=256, n_heads=4, n_kv_heads=4, d_ff=0, vocab=512,
           n_layers=2, slstm_every=2)
#: (kind, mesh, accum): the pod's and multipod's rank 0 under DTensor,
#: and the host's whole step (two microbatches: two calls of the loop)
CELLS = (("prefill", "pod", 1), ("train", "pod", 1), ("train", "multipod", 1),
         ("train", "host", 2), ("prefill", "host", 1))
SEQS = (32, 128)


def _held(cfg, shape, mesh, accum):
    trip = count(cfg, shape, mesh, True, accum)
    plain = count(cfg, shape, mesh, False, accum)
    s = shape.seq_len
    calls = cfg.n_layers // cfg.slstm_every * (
        accum if shape.kind == "train" else 1)
    assert trip["loops"] == {"slstm": dict(
        trip=s, run_steps=[0, 1, 2, 3, s - 1], calls=calls)}
    assert plain["loops"] == {}
    for field in FIELDS:
        assert trip.get(field) == plain.get(field), field
    return trip


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("kind,mesh,accum", CELLS)
def test_trip_count_equals_op_by_op(kind, mesh, accum, seq):
    cfg = dataclasses.replace(get_smoke("xlstm-1.3b"), **TOY)
    rec = _held(cfg, ShapeConfig("toy", kind, seq, 32), mesh, accum)
    assert rec["flops"] > 0 and rec["temp"] > 0
    if mesh != "host":
        assert rec["collectives"]["counts"]["all-gather"] > seq


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("mesh", ("host", "pod"))
def test_two_segment_prefill_trip_count_equals_op_by_op(mesh, seq):
    """Two segments at prefill: the first loop's left-out outputs die
    with the stack that reads them, before the second segment's peak
    (autograd records nothing, so no backward gives their bytes back)."""
    cfg = dataclasses.replace(get_smoke("xlstm-1.3b"), **dict(
        TOY, n_layers=4))
    rec = _held(cfg, ShapeConfig("toy", "prefill", seq, 32), mesh, 1)
    assert rec["loops"]["slstm"]["calls"] == 2


def test_whole_rows_trip_count_equals_op_by_op():
    """The sLSTM's plan on the whole rows (past one mLSTM chunk, and so
    under ``REPRO_NO_SP`` at any length), whose steps return the rank's
    share of h, which no later step saves: the left-out steps' shares
    die with the stack that reads them, so the trip count's peak equals
    op by op's (a train step over 32 tokens on the pod)."""
    cfg = dataclasses.replace(get_smoke("xlstm-1.3b"), **TOY)
    with dryrun.knobs_set({"REPRO_NO_SP": "1"}):
        _held(cfg, ShapeConfig("toy", "train", 32, 32), "pod", 1)


def test_full_width_segment_trip_count_equals_op_by_op():
    """xlstm-1.3b at full width cut to one segment, a train step of 32 x
    256 tokens on the pod (rank 0)."""
    cfg = dataclasses.replace(get_config("xlstm-1.3b"), n_layers=8)
    _held(cfg, ShapeConfig("train_256", "train", 256, 32), "pod", 1)


def _toy_loop(differ: str, trips: bool = True, t_diff: int = 3,
              trip: int = 12):
    """A recurrence of ``trip`` steps on the CPU, its step ``t_diff``
    unlike the others in ``differ`` (``"none"``: all alike), its forward
    and backward counted by a `StepCounter`."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(8, 8, generator=gen, requires_grad=True)
    xs = torch.randn(trip, 4, 8, generator=gen, requires_grad=True)
    kept = []

    def body(state, x):
        h, t = state
        # a detached weight: the same forward, no gradient into it
        ww = w.detach() if differ == "backward" and t == t_diff else w
        a = x + h @ ww
        if t == t_diff and differ == "flops":
            a = a + (h @ w) * 0
        elif t == t_diff and differ == "bytes":
            a = a * 1.0
        elif t == t_diff and differ == "alive":
            kept.append(a)          # freed at the step's end in the others
        y = torch.tanh(a)
        return (y, t + 1), y

    with dryrun.StepCounter(trips=trips) as counter:
        _, ys = cm.scan("toy", body, (torch.zeros(4, 8), 0), xs)
        torch.stack(ys).sum().backward()
    return counter


@pytest.mark.parametrize("differ,field,phase", [
    ("flops", "flops", "forward"), ("bytes", "bytes", "forward"),
    ("alive", "alive", "forward"), ("backward", "flops", "backward")])
def test_loop_whose_middle_steps_differ_raises(differ, field, phase):
    _toy_loop(differ, trips=False)          # op by op it counts
    with pytest.raises(RuntimeError, match=(
            rf"loop 'toy' \(trip 12\): its {phase} steps 2 and 3 differ "
            rf"in '{field}'")):
        _toy_loop(differ)


def test_alike_toy_loop_counts_as_op_by_op():
    got, want = _toy_loop("none"), _toy_loop("none", trips=False)
    assert got.loops == {"toy": dict(trip=12, run_steps=[0, 1, 2, 3, 11],
                                     calls=1)}
    assert (got.flops, got.bytes, got.peak) == \
        (want.flops, want.bytes, want.peak)


def test_scan_outside_a_count_runs_every_step():
    """Outside a count every step runs: the values equal a plain loop's,
    bit for bit, and the body sees every step; under a trip-counting
    counter it sees the first four and the last."""
    gen = torch.Generator().manual_seed(1)
    w = torch.randn(8, 8, generator=gen)
    xs = torch.randn(9, 4, 8, generator=gen)
    seen = []

    def body(h, x):
        seen.append(len(seen))
        h = torch.tanh(x + h @ w)
        return h, h

    h, ys = cm.scan("toy", body, torch.zeros(4, 8), xs)
    hp, yp = torch.zeros(4, 8), []
    for t in range(9):
        hp = torch.tanh(xs[t] + hp @ w)
        yp.append(hp)
    assert torch.equal(h, hp) and torch.equal(torch.stack(ys),
                                              torch.stack(yp))
    assert seen == list(range(9))
    seen.clear()
    with dryrun.StepCounter():
        cm.scan("toy", body, torch.zeros(4, 8), xs)
    assert len(seen) == 5


def test_records_name_their_loops():
    """A record names what was trip-counted: xlstm's sLSTM, once a
    segment; a model with no loop names none."""
    cfg = dataclasses.replace(get_smoke("xlstm-1.3b"), **dict(
        TOY, n_layers=4))
    rec = dryrun.cell_record(cfg, ShapeConfig("toy", "prefill", 64, 2),
                             "host")
    assert rec["loops"] == {"slstm": dict(trip=64, run_steps=[0, 1, 2, 3, 63],
                                          calls=2)}
    rec = dryrun.cell_record(get_smoke("tinyllama-1.1b"),
                             ShapeConfig("toy", "prefill", 64, 2), "host")
    assert rec["loops"] == {}
