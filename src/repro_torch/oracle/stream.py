"""Command-stream extraction from ``cmd_trace=True`` runs.

`repro_torch.core.platform.run_frontend` with ``StageConfig.cmd_trace=True``
emits the raw per-step `repro_torch.core.dram.TickCmd` records as ``cmd_*``
views — dense in weave-scan steps, sparse in commands.  This module
flattens them into a `CommandStream`: one row per granted DRAM command
or refresh firing, time-ordered per channel, ready for the protocol
checker (`repro_torch.oracle.checker`) and the ``.cmd.trace`` exporter
(`repro_torch.obs.export.to_cmd_trace`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dram import ACT, NONE, PRE, RD, REF, WR
from repro_torch.core.timing import DramParams

#: the raw per-step record series a ``cmd_trace=True`` views dict
#: carries (`repro_torch.core.dram.TickCmd` fields, stacked ``(W, S, ...)``)
CMD_KEYS = ("cmd_cmd", "cmd_t", "cmd_fbank", "cmd_row",
            "cmd_ref", "cmd_ref_bank")

#: command-code -> mnemonic (the ``.cmd.trace`` vocabulary); REF splits
#: into REFab / REFsb at export time by the recorded bank
CMD_NAMES = {RD: "RD", WR: "WR", ACT: "ACT", PRE: "PRE", REF: "REF"}


@dataclasses.dataclass
class CommandStream:
    """A flattened DRAM command stream (host-side numpy, row-per-event).

    Rows are sorted by ``(channel, t)`` with a same-tick refresh
    ordered *before* a same-tick command grant — matching `dram.tick`,
    where the refresh deadline applies ahead of the FR-FCFS select.
    ``bank`` is the bank-in-rank index; a refresh row carries the
    refreshed bank (DDR5 REFsb) or ``-1`` for an all-bank refresh, and
    ``row`` is the ACT/CAS target row (``-1`` for PRE and REF).
    """

    dram: DramParams
    t: np.ndarray          # (N,) int64 absolute DRAM tick
    cmd: np.ndarray        # (N,) int32 RD/WR/ACT/PRE/REF
    channel: np.ndarray    # (N,) int32
    rank: np.ndarray       # (N,) int32
    bank: np.ndarray       # (N,) int32 bank-in-rank (-1: all-bank REF)
    row: np.ndarray        # (N,) int32 (-1 for PRE/REF)

    def __len__(self) -> int:
        return int(self.t.shape[0])

    def counts(self) -> dict:
        """Total command mix: ``{"RD": n, "WR": n, ...}``."""
        return {name: int(np.sum(self.cmd == code))
                for code, name in CMD_NAMES.items()}


def extract_stream(views, dram: DramParams) -> CommandStream:
    """Flatten one run's ``cmd_*`` views into a `CommandStream`.

    Args:
        views: the ``cmd_*`` views of a single ``cmd_trace=True`` run
            (``(W, steps, C, ...)``; NOT a batch — the port's
            `repro_torch.core.platform.run_frontend` returns (B, W, ...),
            so index the batch axis down to one run first).  Numpy
            arrays or CPU tensors.
        dram: the run's device (``cfg.platform.dram``).

    Raises:
        ValueError: if the ``cmd_*`` keys are missing (the run was not
            recorded) or per-channel grant times are not strictly
            increasing (the views are not a single run's).
    """
    missing = [k for k in CMD_KEYS if k not in views]
    if missing:
        raise ValueError(
            f"views dict lacks command-record keys {missing}; rerun "
            "with StageConfig(cmd_trace=True) to record the stream")
    C = dram.n_channels
    R = dram.ranks_per_channel
    nbanks = dram.banks_per_rank
    cmd = np.asarray(views["cmd_cmd"]).reshape(-1, C)
    t = np.asarray(views["cmd_t"], np.int64).reshape(-1, C)
    fbank = np.asarray(views["cmd_fbank"]).reshape(-1, C)
    rowv = np.asarray(views["cmd_row"]).reshape(-1, C)
    ref = np.asarray(views["cmd_ref"]).reshape(-1, C, R)
    ref_bank = np.asarray(views["cmd_ref_bank"]).reshape(-1, C, R)

    # command grants: the steps where a channel issued something
    i, c = np.nonzero(cmd != NONE)
    parts = [(t[i, c], cmd[i, c], c, fbank[i, c] // nbanks,
              fbank[i, c] % nbanks, rowv[i, c])]
    # refresh firings: one row per (channel, rank) deadline hit
    i, c, r = np.nonzero(ref)
    parts.append((t[i, c], np.full(i.shape, REF), c, r,
                  ref_bank[i, c, r], np.full(i.shape, -1)))
    ts, cs, chs, rks, bks, rws = (
        np.concatenate([np.asarray(p[k]) for p in parts])
        for k in range(6))
    # channel-major, time-ordered; a refresh sorts before a same-tick
    # command grant (inside `tick` the deadline applies first), and the
    # rank index breaks the tie between two same-tick refreshes
    order = np.lexsort((rks, (cs != REF).astype(np.int8), ts, chs))
    out = CommandStream(
        dram=dram, t=ts[order].astype(np.int64),
        cmd=cs[order].astype(np.int32), channel=chs[order].astype(np.int32),
        rank=rks[order].astype(np.int32), bank=bks[order].astype(np.int32),
        row=rws[order].astype(np.int32))
    # single-run invariant: each evaluated tick grants at most one
    # command per channel, and no tick is evaluated twice
    for ch in range(C):
        tc = out.t[(out.channel == ch) & (out.cmd != REF)]
        if tc.size > 1 and not (np.diff(tc) > 0).all():
            raise ValueError(
                f"channel {ch} grant times are not strictly increasing"
                " — views are not a single run's cmd_trace record")
    return out


def stream_stats(stream: CommandStream, span_ticks: int | None = None):
    """Per-channel command mix (and bandwidth, given the tick span).

    Returns a dict with ``(C,)`` int arrays per mnemonic plus
    ``bytes``; ``span_ticks`` (total evaluated DRAM ticks) adds
    ``bw_gbs`` — the per-channel data bandwidth in GB/s, in the same
    unit convention as `repro_torch.core.platform` (bytes/ps x 1e3).
    """
    d = stream.dram
    out = {}
    for code, name in CMD_NAMES.items():
        m = stream.cmd == code
        out[name] = np.bincount(stream.channel[m],
                                minlength=d.n_channels).astype(np.int64)
    out["bytes"] = (out["RD"] + out["WR"]) * d.line_bytes
    if span_ticks is not None:
        span_ps = float(span_ticks) * d.dram_ps_per_clk
        out["bw_gbs"] = out["bytes"] / max(span_ps, 1.0) * 1e3
    return out


def diff_streams(a: CommandStream, b: CommandStream):
    """First divergence between two streams, or ``None`` if identical.

    The differential harness's equality probe: returns a dict naming
    the first differing row (field values from both streams) or the
    length mismatch; ``None`` means the streams agree row-for-row.
    """
    fields = ("t", "cmd", "channel", "rank", "bank", "row")
    n = min(len(a), len(b))
    neq = np.zeros(n, bool)
    for f in fields:
        neq |= getattr(a, f)[:n] != getattr(b, f)[:n]
    at = lambda s, i: {f: int(getattr(s, f)[i]) for f in fields}
    if neq.any():
        i = int(np.flatnonzero(neq)[0])
        return dict(index=i, a=at(a, i), b=at(b, i),
                    n_a=len(a), n_b=len(b))
    if len(a) != len(b):
        i = n
        longer = a if len(a) > len(b) else b
        return dict(index=i, a=at(a, i) if len(a) > n else None,
                    b=at(b, i) if len(b) > n else None,
                    n_a=len(a), n_b=len(b))
    return None
