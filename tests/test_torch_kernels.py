"""The port's kernels: plain versions vs the reference oracles (CPU), and
the CUDA kernels vs their plain versions (card only).

Integer outputs must be equal.  The bank_timing grid mirrors
``tests/test_kernels.py`` (arrival drawn from a narrow range so score
ties occur) over every channel count, queue depth and ``row_hit_cap``
of the main path, and compares ``sel`` on every row, including rows
that issue no command.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.addr_decode import decode_reference
from repro.kernels.addr_decode.kernel import decode_packed as ref_decode
from repro.kernels.bank_timing import (frfcfs_select as ref_select,
                                       pack_scalars, scalars_tuple,
                                       select_reference)
from repro_torch.kernels.addr_decode import (decode_packed,
                                             decode_packed_plain, unpack)
from repro_torch.kernels.bank_timing import frfcfs_select, select_plain

torch.set_num_threads(1)

NONE = 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _select_inputs(rng, C, Q, *, idle_rows=0):
    """Eleven (C, Q) int32 planes + a (C, 8) scalar plane."""
    def grid(lo, hi):
        return rng.integers(lo, hi, size=(C, Q), dtype=np.int32)

    planes = [grid(0, 2), grid(0, 2), grid(0, 8), grid(-1, 8),
              grid(0, 100), grid(0, 100), grid(0, 100), grid(0, 100),
              grid(0, 2), grid(0, 2), grid(0, 20)]
    planes[0][:idle_rows] = 0          # rows with nothing arrived
    scal = np.zeros((C, 8), np.int32)
    scal[:, 0] = 50
    scal[:, 1:6] = rng.integers(0, 100, size=(C, 5), dtype=np.int32)
    scal[:, 4] &= 1                    # drain flag
    return planes, scal


def _ref_select(planes, scal, cap, interpret):
    args = [jnp.asarray(p) for p in planes]
    ch = pack_scalars(jnp.asarray(scal[:, 0]),
                      *(jnp.asarray(scal[:, i]) for i in range(1, 6)))
    if interpret:
        out = ref_select(*args, ch, row_hit_cap=cap)
    else:
        out = select_reference(*args, scalars_tuple(ch), row_hit_cap=cap)
    return tuple(np.asarray(x) for x in out)


@pytest.mark.parametrize("cap", [0, 4])
@pytest.mark.parametrize("C,Q", [(6, 256), (12, 256), (16, 256),
                                 (6, 512), (12, 512), (16, 512)])
def test_select_plain_matches_reference(C, Q, cap):
    rng = np.random.default_rng(1000 * C + Q + cap)
    for case in range(4):
        planes, scal = _select_inputs(rng, C, Q, idle_rows=case % 3)
        sel, cmd = select_plain(*map(torch.from_numpy, planes),
                                torch.from_numpy(scal), row_hit_cap=cap)
        sel_r, cmd_r = _ref_select(planes, scal, cap, interpret=False)
        np.testing.assert_array_equal(cmd.numpy(), cmd_r)
        np.testing.assert_array_equal(sel.numpy(), sel_r)   # every row
        if case == 0:
            # the Pallas kernel itself, in interpret mode
            sel_k, cmd_k = _ref_select(planes, scal, cap, interpret=True)
            np.testing.assert_array_equal(cmd.numpy(), cmd_k)
            np.testing.assert_array_equal(sel.numpy(), sel_k)


def test_select_ties_pick_lowest_slot():
    """Equal scores everywhere: the first slot wins, like jnp.argmax."""
    C, Q = 6, 256
    planes = [np.zeros((C, Q), np.int32) for _ in range(11)]
    planes[0][:] = 1                   # arrived
    planes[2][:] = 3                   # row == open row: all row hits
    planes[3][:] = 3
    planes[10][:] = 7                  # one arrival tick for every slot
    planes[0][2, :5] = 0               # row 2: the first hit is slot 5
    scal = np.zeros((C, 8), np.int32)
    scal[:, 0] = 50
    sel, cmd = select_plain(*map(torch.from_numpy, planes),
                            torch.from_numpy(scal))
    sel_r, cmd_r = _ref_select(planes, scal, 0, interpret=False)
    np.testing.assert_array_equal(sel.numpy(), sel_r)
    np.testing.assert_array_equal(cmd.numpy(), cmd_r)
    assert sel.tolist() == [0, 0, 5, 0, 0, 0]
    assert (cmd.numpy() == 1).all()    # RD


def test_select_inactive_rows_fold_into_arrived():
    """`dram.tick` masks inactive ticks by clearing the arrived plane:
    with nothing eligible every score is 0, which gives slot 0 and NONE
    — what the reference's ``where(active, score, 0)`` gives."""
    rng = np.random.default_rng(7)
    planes, scal = _select_inputs(rng, 6, 256)
    sel_live, cmd_live = _ref_select(planes, scal, 0, interpret=False)
    assert (cmd_live != NONE).any()    # the rows would have issued
    planes[0][:] = 0
    for cap in (0, 4):
        sel, cmd = select_plain(*map(torch.from_numpy, planes),
                                torch.from_numpy(scal), row_hit_cap=cap)
        assert (sel.numpy() == 0).all() and (cmd.numpy() == NONE).all()


def _lines(rng, n):
    lines = rng.integers(0, 2 ** 32, n, dtype=np.uint64)
    lines[::3] |= np.uint64(1 << 31)   # pointer-chase lines set bit 31
    return lines.astype(np.uint32)


@pytest.mark.parametrize("n", [1, 100, 1024, 4097])
def test_decode_plain_matches_reference(n):
    lines = _lines(np.random.default_rng(n), n)
    packed = decode_packed_plain(torch.from_numpy(lines.astype(np.int64)))
    packed_u32 = packed.numpy().view(np.uint32)
    np.testing.assert_array_equal(
        packed_u32, np.asarray(ref_decode(jnp.asarray(lines))))
    ref = decode_reference(jnp.asarray(lines))
    for name, field in zip(("channel", "rank", "bank", "row", "col"),
                           unpack(packed)):
        np.testing.assert_array_equal(field.numpy(),
                                      np.asarray(getattr(ref, name)), name)
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(
        decode_packed(torch.from_numpy(lines.astype(np.int64))), packed)


def test_wrappers_reject_other_devices():
    x = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_packed(x)
    p = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        frfcfs_select(*[p] * 11, torch.zeros((2, 8), dtype=torch.int32,
                                              device="meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [0, 4])
@pytest.mark.parametrize("C,Q", [(6, 256), (12, 256), (16, 512)])
def test_select_kernel_matches_plain(cuda, C, Q, cap):
    rng = np.random.default_rng(C + Q + cap)
    planes, scal = _select_inputs(rng, 8 * C, Q, idle_rows=C)
    dev = [torch.from_numpy(p).to(cuda) for p in planes]
    scal_d = torch.from_numpy(scal).to(cuda)
    sel, cmd = frfcfs_select(*dev, scal_d, row_hit_cap=cap)
    sel_p, cmd_p = select_plain(*dev, scal_d, row_hit_cap=cap)
    torch.cuda.synchronize()
    assert torch.equal(sel, sel_p) and torch.equal(cmd, cmd_p)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 100, 4097, 1 << 20])
def test_decode_kernel_matches_plain(cuda, n):
    lines = torch.from_numpy(
        _lines(np.random.default_rng(n), n).astype(np.int64)).to(cuda)
    out = decode_packed(lines)
    torch.cuda.synchronize()
    assert torch.equal(out, decode_packed_plain(lines))
