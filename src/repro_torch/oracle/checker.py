"""Vectorized DDRx protocol-legality checker for command streams.

Replays a recorded `CommandStream` against the device's `DramParams`
and asserts every timing window and bank state-machine rule the
controller model (`repro_torch.core.dram.tick`) is supposed to respect —
from the stream alone, with no access to the simulator's internal
timers.  A clean report is machine-checked evidence that the granted
command sequence is protocol-legal; any violation is a bug in
`repro_torch.core.dram`, never something to suppress here.

The rule set (`RULES`) mirrors the model's semantics exactly:

* bus turnaround is accounted on the *switching* burst (a rank switch
  extends that burst's bus occupancy by ``tRTRS``, delaying the next
  CAS), with rank 0 as the power-on "previous" rank;
* a refresh closes every covered bank (one bank for DDR5 REFsb, the
  whole rank otherwise) and blocks it for ``tRFC``;
* refresh deadlines are staggered per rank
  (``tREFI + r * (tREFI // R)``) and advance by exactly ``tREFI`` —
  window boundaries are contiguous in tick space, so a deadline fires
  at exactly its tick (``ref_slack`` loosens this for experiments).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dram import ACT, PRE, RD, REF, WR
from repro_torch.core.timing import DramParams
from repro_torch.oracle.stream import CMD_NAMES, CommandStream

#: rule id -> human description (drives the docs/VALIDATION.md table)
RULES = {
    "state-act-closed": "ACT only targets a precharged bank "
                        "(no double-ACT)",
    "state-cas-open": "RD/WR only targets the bank's open row "
                      "(no CAS to a closed or mismatched row)",
    "state-pre-open": "PRE only targets an open bank",
    "trcd": "CAS >= same-bank ACT + tRCD",
    "tras": "PRE >= same-bank ACT + tRAS",
    "trp": "ACT >= same-bank PRE + tRP",
    "trc": "ACT >= same-bank ACT + tRC (= tRAS + tRP)",
    "trtp": "PRE >= same-bank RD + tRTP",
    "twr": "PRE >= same-bank WR + tCWL + tBL + tWR (write recovery)",
    "tccd-s": "CAS >= previous same-channel CAS + tCCD_S",
    "tccd-l": "CAS >= same-(rank, bank-group) CAS + tCCD_L",
    "bus": "CAS >= previous CAS + tBL (+ tRTRS when that burst "
           "switched ranks)",
    "twtr": "RD >= same-channel WR + tCWL + tBL + tWTR_L "
            "(write-to-read turnaround)",
    "trtw": "WR >= same-channel RD + tCL + tBL + tRTRS - tCWL "
            "(read-to-write turnaround)",
    "trrd-s": "ACT >= same-rank ACT + tRRD_S",
    "trrd-l": "ACT >= same-(rank, bank-group) ACT + tRRD_L",
    "tfaw": "ACT >= 4th-previous same-rank ACT + tFAW "
            "(rolling four-activate window)",
    "trfc": "ACT >= last refresh covering the bank + tRFC",
    "trefi": "k-th refresh of rank r fires at exactly "
             "tREFI + r * (tREFI // R) + k * tREFI (+ ref_slack)",
    "ref-missed": "every refresh deadline before end_tick has fired",
    "ref-rotation": "DDR5 REFsb walks banks round-robin from 0; "
                    "all-bank refresh records bank -1",
}

_NEG = -(1 << 40)          # "no predecessor" sentinel time
MAX_EXAMPLES = 20          # violation examples kept per rule


@dataclasses.dataclass
class LegalityReport:
    """Outcome of `check_stream`: per-rule check and violation counts.

    ``violations`` keeps at most `MAX_EXAMPLES` example rows per rule
    (``violation_counts`` always counts all of them); ``ok`` is True
    iff no rule fired anywhere.
    """

    n_commands: int
    counts: dict
    n_checked: dict
    violation_counts: dict
    violations: list

    @property
    def ok(self) -> bool:
        return not any(self.violation_counts.values())

    def summary(self) -> str:
        mix = " ".join(f"{k}={v}" for k, v in self.counts.items())
        n_bad = sum(self.violation_counts.values())
        head = (f"{self.n_commands} events ({mix}); "
                f"{sum(self.n_checked.values())} checks, "
                f"{n_bad} violations")
        if not n_bad:
            return head + " — protocol-legal"
        worst = [f"{r}:{n}" for r, n in self.violation_counts.items() if n]
        return head + " [" + " ".join(worst) + "]"

    def to_dict(self) -> dict:
        return dict(ok=self.ok, n_commands=self.n_commands,
                    counts=dict(self.counts),
                    n_checked=dict(self.n_checked),
                    violation_counts={k: v for k, v
                                      in self.violation_counts.items() if v},
                    violations=list(self.violations))


class _Acc:
    """Check/violation accumulator shared by the per-channel passes."""

    def __init__(self):
        self.n_checked = {r: 0 for r in RULES}
        self.violation_counts = {r: 0 for r in RULES}
        self.violations = []

    def check(self, rule, ch, bad, times, detail):
        """Record ``len(bad)`` comparisons, flagging the True ones."""
        bad = np.asarray(bad, bool)
        self.n_checked[rule] += int(bad.size)
        n_bad = int(bad.sum())
        if not n_bad:
            return
        self.violation_counts[rule] += n_bad
        room = MAX_EXAMPLES - min(
            sum(1 for v in self.violations if v["rule"] == rule),
            MAX_EXAMPLES)
        for i in np.flatnonzero(bad)[:room]:
            self.violations.append(dict(
                rule=rule, channel=int(ch), t=int(times[i]),
                detail=detail(int(i))))


def _last_idx(mask):
    """Exclusive index of the most recent True before each position."""
    if mask.size == 0:
        return np.zeros(0, np.int64)
    idx = np.where(mask, np.arange(mask.size), -1)
    return np.concatenate([[-1], np.maximum.accumulate(idx)[:-1]])


def _last_time(mask, t):
    """Exclusive most-recent time of a masked event (`_NEG` if none)."""
    li = _last_idx(mask)
    return np.where(li >= 0, t[np.maximum(li, 0)], _NEG)


def _window(acc, rule, ch, sel, t, ref_t, gap, name):
    """Flag ``t[sel] < ref_t[sel] + gap`` (a violated timing window)."""
    tv, rv = t[sel], ref_t[sel]
    bad = tv < rv + gap
    acc.check(rule, ch, bad, tv,
              lambda i: f"{name}: gap {int(tv[i] - rv[i])} < {int(gap)}")


def _check_bank(acc, d: DramParams, ch, t, k, row):
    """Per-bank pass: state machine + same-bank timing windows.

    ``t``/``k``/``row`` are one bank's event subsequence (time-ordered;
    ``k == REF`` rows are the refreshes covering this bank).
    """
    is_act, is_pre = k == ACT, k == PRE
    is_rd, is_wr = k == RD, k == WR
    is_close = is_pre | (k == REF)
    la, lc = _last_idx(is_act), _last_idx(is_close)
    is_open = la > lc
    open_row = np.where(is_open, row[np.maximum(la, 0)], -1)

    acc.check("state-act-closed", ch, is_open[is_act], t[is_act],
              lambda i: "ACT to an already-open bank")
    cas = is_rd | is_wr
    bad_cas = cas & (~is_open | (open_row != row))
    acc.check("state-cas-open", ch, bad_cas[cas], t[cas],
              lambda i, b=bad_cas, o=open_row, r=row, c=np.flatnonzero(cas):
              f"CAS row {int(r[c[i]])} vs open {int(o[c[i]])}")
    acc.check("state-pre-open", ch, ~is_open[is_pre], t[is_pre],
              lambda i: "PRE to a precharged bank")

    last_act_t = _last_time(is_act, t)
    _window(acc, "trcd", ch, cas, t, last_act_t, d.tRCD, "ACT->CAS")
    _window(acc, "tras", ch, is_pre, t, last_act_t, d.tRAS, "ACT->PRE")
    _window(acc, "trc", ch, is_act, t, last_act_t, d.tRC, "ACT->ACT")
    _window(acc, "trp", ch, is_act, t, _last_time(is_pre, t), d.tRP,
            "PRE->ACT")
    _window(acc, "trtp", ch, is_pre, t, _last_time(is_rd, t), d.tRTP,
            "RD->PRE")
    _window(acc, "twr", ch, is_pre, t, _last_time(is_wr, t),
            d.tCWL + d.tBL + d.tWR, "WR->PRE")
    _window(acc, "trfc", ch, is_act, t, _last_time(k == REF, t), d.tRFC,
            "REF->ACT")


def _check_channel_cas(acc, d: DramParams, ch, t, k, rank, grp):
    """Channel-wide CAS sequencing: tCCD, bus occupancy, turnarounds."""
    cas = (k == RD) | (k == WR)
    ct, cr = t[cas], rank[cas]
    if ct.size > 1:
        gap = np.diff(ct)
        acc.check("tccd-s", ch, gap < d.tCCD_S, ct[1:],
                  lambda i: f"CAS gap {int(gap[i])} < {d.tCCD_S}")
        # the bus charge of burst k includes tRTRS when *it* switched
        # ranks (power-on previous rank is 0, as in `init_banks`)
        prev = np.concatenate([[0], cr[:-1]])
        occ = d.tBL + np.where(cr != prev, d.tRTRS, 0)
        acc.check("bus", ch, gap < occ[:-1], ct[1:],
                  lambda i: f"CAS gap {int(gap[i])} < bus {int(occ[i])}")
    else:
        acc.check("tccd-s", ch, np.zeros(0, bool), ct, None)
        acc.check("bus", ch, np.zeros(0, bool), ct, None)
    # same-(rank, bank-group) CAS pairs: the long tCCD
    cg = (rank * d.bank_groups + grp)[cas]
    for g in np.unique(cg):
        gt = ct[cg == g]
        ggap = np.diff(gt)
        acc.check("tccd-l", ch, ggap < d.tCCD_L, gt[1:],
                  lambda i: f"same-group CAS gap {int(ggap[i])}"
                            f" < {d.tCCD_L}")
    # channel-wide write<->read turnarounds
    _window(acc, "twtr", ch, k == RD, t, _last_time(k == WR, t),
            d.tCWL + d.tBL + d.tWTR_L, "WR->RD")
    _window(acc, "trtw", ch, k == WR, t, _last_time(k == RD, t),
            d.tCL + d.tBL + d.tRTRS - d.tCWL, "RD->WR")


def _check_rank_act(acc, d: DramParams, ch, t, k, rank, grp):
    """Per-rank ACT pacing: tRRD_S/L and the tFAW sliding window."""
    act = k == ACT
    at, ar, ag = t[act], rank[act], grp[act]
    for r in range(d.ranks_per_channel):
        rt = at[ar == r]
        gap = np.diff(rt)
        acc.check("trrd-s", ch, gap < d.tRRD_S, rt[1:],
                  lambda i: f"rank {r} ACT gap {int(gap[i])}"
                            f" < {d.tRRD_S}")
        if rt.size > 4:
            fgap = rt[4:] - rt[:-4]
            acc.check("tfaw", ch, fgap < d.tFAW, rt[4:],
                      lambda i: f"rank {r} four-ACT span {int(fgap[i])}"
                                f" < {d.tFAW}")
    rg = ar * d.bank_groups + ag
    for g in np.unique(rg):
        gt = at[rg == g]
        ggap = np.diff(gt)
        acc.check("trrd-l", ch, ggap < d.tRRD_L, gt[1:],
                  lambda i: f"same-group ACT gap {int(ggap[i])}"
                            f" < {d.tRRD_L}")


def _check_refresh(acc, d: DramParams, ch, t, k, rank, bank,
                   end_tick, ref_slack):
    """Refresh cadence, coverage accounting, and REFsb rotation."""
    nbanks = d.banks_per_rank
    for r in range(d.ranks_per_channel):
        m = (k == REF) & (rank == r)
        rt, rb = t[m], bank[m]
        kk = np.arange(rt.size, dtype=np.int64)
        deadline = d.tREFI + r * (d.tREFI // d.ranks_per_channel)
        expect = deadline + kk * d.tREFI
        late = (rt < expect) | (rt > expect + ref_slack)
        acc.check("trefi", ch, late, rt,
                  lambda i: f"rank {r} REF #{int(kk[i])} at {int(rt[i])}"
                            f", deadline {int(expect[i])}"
                            + (f" (+{ref_slack})" if ref_slack else ""))
        if end_tick is not None:
            # integer ceil((end_tick - deadline) / tREFI), clamped at 0
            n_due = max(-((deadline - end_tick) // d.tREFI), 0)
            missed = rt.size < n_due
            acc.check("ref-missed", ch, np.asarray([missed]),
                      np.asarray([end_tick]),
                      lambda i: f"rank {r}: {rt.size} refreshes fired, "
                                f"{n_due} due before tick {end_tick}")
        if d.same_bank_refresh:
            bad = rb != (kk % nbanks)
            acc.check("ref-rotation", ch, bad, rt,
                      lambda i: f"rank {r} REFsb #{int(kk[i])} hit bank "
                                f"{int(rb[i])}, expected "
                                f"{int(kk[i] % nbanks)}")
        else:
            acc.check("ref-rotation", ch, rb != -1, rt,
                      lambda i: f"rank {r} all-bank REF recorded bank "
                                f"{int(rb[i])} (expected -1)")


def check_stream(stream: CommandStream, dram: DramParams | None = None,
                 *, end_tick: int | None = None,
                 ref_slack: int = 0) -> LegalityReport:
    """Check a recorded command stream for DDRx protocol legality.

    Args:
        stream: a `CommandStream` (`repro_torch.oracle.extract_stream`).
        dram: device timings to check against; defaults to the
            stream's own `DramParams`.
        end_tick: total evaluated tick horizon of the run
            (``cfg.clock().window_end_tick(cfg.windows - 1)``); enables
            the missed-refresh rule.
        ref_slack: allowed lateness (ticks) past each refresh deadline;
            the default 0 asserts the model's exact-deadline firing.

    Returns:
        A `LegalityReport`; ``report.ok`` means every rule in `RULES`
        held everywhere.
    """
    d = dram or stream.dram
    nbanks = d.banks_per_rank
    acc = _Acc()
    for ch in range(d.n_channels):
        m = stream.channel == ch
        t = stream.t[m]
        k = stream.cmd[m]
        rank, bank, row = stream.rank[m], stream.bank[m], stream.row[m]
        grp = np.where(bank >= 0, bank, 0) // d.banks_per_group
        _check_channel_cas(acc, d, ch, t, k, rank, grp)
        _check_rank_act(acc, d, ch, t, k, rank, grp)
        _check_refresh(acc, d, ch, t, k, rank, bank, end_tick, ref_slack)
        # per-bank pass over an expanded view: an all-bank refresh
        # (bank == -1) becomes one close/block event per covered bank
        exp = k == REF if not d.same_bank_refresh else np.zeros_like(m[m])
        rep_n = np.where(exp, nbanks, 1).astype(np.int64)
        et = np.repeat(t, rep_n)
        ek = np.repeat(k, rep_n)
        erank = np.repeat(rank, rep_n)
        erow = np.repeat(row, rep_n)
        ebank = np.repeat(bank, rep_n)
        # walk each expanded refresh across its rank's banks
        pos = np.arange(et.size) - np.repeat(
            np.cumsum(rep_n) - rep_n, rep_n)
        ebank = np.where(np.repeat(exp, rep_n), pos, ebank)
        fb = erank * nbanks + ebank
        for f in np.unique(fb):
            bm = fb == f
            _check_bank(acc, d, ch, et[bm], ek[bm], erow[bm])
    counts = {name: int(np.sum(stream.cmd == code))
              for code, name in CMD_NAMES.items()}
    return LegalityReport(
        n_commands=len(stream), counts=counts,
        n_checked=acc.n_checked, violation_counts=acc.violation_counts,
        violations=acc.violations)
