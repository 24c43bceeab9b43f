"""Plain PyTorch version of the FR-FCFS eligibility + select kernel.

Mirrors ``select_reference`` of the JAX package input for input: the
same eligibility rules, the same int32 score, ``argmax`` with the first
(lowest) slot winning ties, and the same command decode.  The wrapper
runs it for CPU tensors; on the card it is only the kernel's yardstick.
"""
from __future__ import annotations

import torch

_BIG = 1 << 28
NONE, RD, WR, ACT, PRE = 0, 1, 2, 3, 4

# scalar plane columns
T, BUS_FREE, WTR, RTW, DRAIN, STREAK = range(6)
N_SCALARS = 8   # padded


def select_plain(arrived, is_write, row, open_e, nrd_e, nwr_e, nact_e,
                 npre_e, faw_ok, hit_pend, arrival, ch_scalars, *,
                 row_hit_cap: int = 0):
    """(R, Q) int32 planes + (R, 8) int32 scalars -> (sel, cmd), (R,) int32."""
    t = ch_scalars[:, T, None]
    bus_ok = ch_scalars[:, BUS_FREE, None] <= t
    wtr_ok = ch_scalars[:, WTR, None] <= t
    rtw_ok = ch_scalars[:, RTW, None] <= t
    drain = ch_scalars[:, DRAIN, None] == 1
    streak = ch_scalars[:, STREAK]

    arr = arrived == 1
    is_wr = is_write == 1
    row_hit = (open_e == row) & arr
    closed = (open_e < 0) & arr
    side_ok = torch.where(is_wr, drain, ~drain)
    elig_rd = row_hit & ~is_wr & (t >= nrd_e) & bus_ok & wtr_ok & ~drain
    elig_wr = row_hit & is_wr & (t >= nwr_e) & bus_ok & rtw_ok & drain
    elig_act = closed & (t >= nact_e) & (faw_ok == 1) & side_ok
    elig_pre = (arr & (open_e >= 0) & (open_e != row) & (t >= npre_e)
                & (hit_pend == 0) & side_ok)

    age = _BIG - arrival
    zero = torch.zeros_like(age)
    score = torch.where(elig_rd | elig_wr, 3 * _BIG + age,
             torch.where(elig_act, 2 * _BIG + age,
              torch.where(elig_pre, _BIG + age, zero)))
    capped = torch.zeros_like(streak, dtype=torch.bool)
    if row_hit_cap > 0:
        capped = streak >= row_hit_cap
        score = torch.where(capped[:, None] & (elig_rd | elig_wr),
                            _BIG + age, score)
        score = torch.where(capped[:, None] & elig_act, 3 * _BIG + age, score)

    sel = torch.argmax(score, dim=1)            # first maximum on ties
    idx = sel[:, None]

    def pick(f):
        return torch.gather(f, 1, idx)[:, 0]

    any_cmd = pick(score) > 0
    s_cas = any_cmd & pick(elig_rd | elig_wr) & ~(capped & pick(elig_act))
    s_act = any_cmd & pick(elig_act) & ~s_cas
    s_pre = any_cmd & pick(elig_pre) & ~s_cas & ~s_act
    s_iswr = pick(is_wr)
    cmd = torch.where(s_cas, torch.where(s_iswr, WR, RD),
           torch.where(s_act, ACT, torch.where(s_pre, PRE, NONE)))
    return sel.to(torch.int32), cmd.to(torch.int32)
