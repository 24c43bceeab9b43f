"""Exporters: structured JSON and Chrome-trace / Perfetto timelines.

`to_json` flattens a `TelemetryRecord` plus its `summarize` reduction
into one JSON-serializable report.  `to_perfetto` renders the record
as a Chrome trace-event timeline (the JSON array format both
``chrome://tracing`` and https://ui.perfetto.dev open directly):

* **pid 1 "memory"** — one thread per channel.  Per window, a counter
  event with the command mix (``act``/``pre``/``cas_rd``/``cas_wr``/
  ``ref``) and queue depth; write-drain phases render as complete
  slices (``X`` events) with their accounted dwell as duration.
* **pid 2 "cores"** — one thread per core with a per-window progress
  counter (the application view), when the record carries a replay
  ``progress`` history.
* **pid 3 "interface"** — MSHR budget and the PI latency estimate.

Timestamps are window starts on the CPU clock
(`ClockModel.window_cpu_ps`-style: ``w * window_cycles *
cpu_ps_per_clk``), converted to the format's microseconds.

`validate_perfetto` is the schema check CI runs on exported traces.

`to_cmd_trace` / `validate_cmd_trace` export and schema-check the
command-level view: a recorded `repro_torch.oracle.CommandStream` rendered
as the Ramulator2-compatible ``.cmd.trace`` text format (one granted
DRAM command or refresh per line), for differential replay against an
external simulator.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.obs.telemetry import TelemetryRecord, summarize

#: trace-event process ids (one per perspective)
PID_MEMORY, PID_CORES, PID_INTERFACE = 1, 2, 3


def to_json(rec: TelemetryRecord, path=None) -> dict:
    """Structured JSON report: summary + full per-window series.

    Args:
        rec: a collected `TelemetryRecord`.
        path: optional file to write (indent-2 JSON, trailing newline).
    Returns:
        The report dict (JSON-serializable).
    """
    report = dict(
        schema="repro.obs/telemetry-v1",
        stage=rec.stage, windows=rec.windows, warmup=rec.warmup,
        n_channels=rec.n_channels, window_ps=rec.window_ps(),
        dram_ps_per_clk=rec.dram_ps_per_clk,
        summary=summarize(rec),
        series={k: np.asarray(v).tolist() for k, v in rec.series.items()},
    )
    if rec.app_lat_cycles is not None:
        report["app_lat_cycles"] = np.asarray(rec.app_lat_cycles).tolist()
    if path is not None:
        with open(path, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    return report


def _meta(pid, name, tid=None, tname=None):
    ev = [dict(ph="M", pid=pid, name="process_name",
               args=dict(name=name))]
    if tid is not None:
        ev.append(dict(ph="M", pid=pid, tid=tid, name="thread_name",
                       args=dict(name=tname)))
    return ev


def to_perfetto(rec: TelemetryRecord, path=None, max_cores: int = 8):
    """Render a record as a Chrome trace-event / Perfetto timeline.

    Args:
        rec: a collected `TelemetryRecord`.
        path: optional file to write the JSON trace to.
        max_cores: cap on per-core progress tracks (mixes run 24+
            cores; the first ``max_cores`` keep the timeline legible).
    Returns:
        The trace dict: ``{"traceEvents": [...], "displayTimeUnit":
        "ms"}``.
    """
    s = rec.series
    W, C = rec.windows, rec.n_channels
    wps = rec.window_ps()
    us = lambda w: w * wps / 1e6            # window start, microseconds
    events = _meta(PID_MEMORY, "memory")[:1]
    for c in range(C):
        events += _meta(PID_MEMORY, "memory", c, f"channel {c}")[1:]
        for w in range(W):
            events.append(dict(
                ph="C", pid=PID_MEMORY, tid=c, ts=us(w),
                name=f"ch{c} commands",
                args=dict(act=int(s["tele_n_act"][w, c]),
                          pre=int(s["tele_n_pre"][w, c]),
                          cas_rd=int(s["tele_n_cas_rd"][w, c]),
                          cas_wr=int(s["tele_n_cas_wr"][w, c]),
                          ref=int(s["tele_n_ref"][w, c]))))
            events.append(dict(
                ph="C", pid=PID_MEMORY, tid=c, ts=us(w),
                name=f"ch{c} queue depth",
                args=dict(depth=int(s["tele_queue_depth"][w, c]))))
            # drain service dwell (accrued at write-CAS grants):
            # render one slice per window with nonzero dwell, ending
            # at the window boundary
            dt = int(s["tele_drain_ticks"][w, c])
            if dt > 0:
                dur = dt * rec.dram_ps_per_clk / 1e6
                events.append(dict(
                    ph="X", pid=PID_MEMORY, tid=c,
                    ts=max(us(w + 1) - dur, 0.0), dur=dur,
                    name="write drain",
                    args=dict(entries=int(s["tele_drain_enter"][w, c]))))
    events += _meta(PID_INTERFACE, "interface", 0, "mshr / latency")[0:]
    for w in range(W):
        events.append(dict(
            ph="C", pid=PID_INTERFACE, tid=0, ts=us(w), name="interface",
            args=dict(mshr_budget=int(s["tele_mshr_budget"][w]),
                      lat_est_ns=float(s["tele_lat_est_ps"][w]) * 1e-3)))
    if rec.progress is not None:
        prog = np.asarray(rec.progress)
        events += _meta(PID_CORES, "cores")[:1]
        for core in range(min(prog.shape[-1], max_cores)):
            events += _meta(PID_CORES, "cores", core, f"core {core}")[1:]
            for w in range(W):
                events.append(dict(
                    ph="C", pid=PID_CORES, tid=core, ts=us(w),
                    name=f"core {core} progress",
                    args=dict(pos=int(prog[w, core]))))
    trace = dict(traceEvents=events, displayTimeUnit="ms")
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
            f.write("\n")
    return trace


def validate_perfetto(obj) -> int:
    """Schema-check a Chrome trace-event object; the CI gate.

    Verifies the trace is loadable by Perfetto / chrome://tracing:
    a ``traceEvents`` list whose entries carry a valid ``ph`` with the
    fields that phase requires (counters need ``ts`` + numeric
    ``args``; complete slices need ``ts`` + ``dur``), and that at
    least one per-channel command counter track exists.

    Returns the number of events checked; raises `ValueError` on any
    violation.
    """
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a trace object: missing 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("'traceEvents' must be a non-empty list")
    n_cmd_tracks = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        ph = ev.get("ph")
        if ph not in ("M", "C", "X", "B", "E", "i"):
            raise ValueError(f"event {i}: unsupported phase {ph!r}")
        if "pid" not in ev or "name" not in ev:
            raise ValueError(f"event {i}: missing pid/name")
        if ph in ("C", "X"):
            if not isinstance(ev.get("ts"), (int, float)):
                raise ValueError(f"event {i}: {ph!r} needs numeric ts")
        if ph == "C":
            args = ev.get("args")
            if (not isinstance(args, dict) or not args or
                    not all(isinstance(v, (int, float))
                            for v in args.values())):
                raise ValueError(f"event {i}: counter args must be a "
                                 "non-empty numeric dict")
            if "commands" in ev["name"]:
                n_cmd_tracks += 1
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            raise ValueError(f"event {i}: 'X' slice needs numeric dur")
    if n_cmd_tracks == 0:
        raise ValueError("no per-channel command counter tracks found")
    return len(events)


#: the ``.cmd.trace`` format marker (line 1) and row header (line 3)
CMD_TRACE_HEADER = "# repro.oracle cmd-trace-v1"
CMD_TRACE_COLUMNS = "# tick,channel,cmd,rank,bank_group,bank,row"
#: command vocabulary: refresh splits by coverage (all-bank / same-bank)
CMD_TRACE_CMDS = ("ACT", "PRE", "RD", "WR", "REFab", "REFsb")


def to_cmd_trace(stream, path=None, preset: str = "") -> str:
    """Render a `repro_torch.oracle.CommandStream` as ``.cmd.trace`` text.

    The format (the reference's, documented in docs/VALIDATION.md,
    checked by `validate_cmd_trace`): a version marker, a geometry metadata
    comment, a column header, then one CSV row per granted command or
    refresh — the Ramulator2 command vocabulary (``ACT``/``PRE``/
    ``RD``/``WR``/``REFab``/``REFsb``) with absolute DRAM-tick
    timestamps, ready for replay against an external simulator.  Rows
    are channel-major and time-ordered per channel (a refresh precedes
    a same-tick grant); ``-1`` marks fields a command does not carry
    (``row`` for PRE/REF, ``bank_group``/``bank`` for REFab).

    Args:
        stream: the recorded `repro_torch.oracle.CommandStream`.
        path: optional file to write the text to.
        preset: device-preset name for the metadata line.
    Returns:
        The full trace text (newline-terminated).
    """
    from repro_torch.core.dram import ACT, PRE, RD, REF, WR
    d = stream.dram
    bpg = d.banks_per_group
    lines = [
        CMD_TRACE_HEADER,
        (f"# preset={preset or 'custom'} channels={d.n_channels}"
         f" ranks={d.ranks_per_channel} banks={d.banks_per_rank}"
         f" bank_groups={d.bank_groups} tck_ps={d.dram_ps_per_clk}"),
        CMD_TRACE_COLUMNS,
    ]
    names = {ACT: "ACT", PRE: "PRE", RD: "RD", WR: "WR"}
    for i in range(len(stream)):
        cmd, bank = int(stream.cmd[i]), int(stream.bank[i])
        if cmd == REF:
            name = "REFsb" if bank >= 0 else "REFab"
        else:
            name = names[cmd]
        grp = bank // bpg if bank >= 0 else -1
        lines.append(f"{int(stream.t[i])},{int(stream.channel[i])},"
                     f"{name},{int(stream.rank[i])},{grp},{bank},"
                     f"{int(stream.row[i])}")
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


def validate_cmd_trace(text: str) -> int:
    """Schema-check ``.cmd.trace`` text; the CI gate for exports.

    Verifies the version marker, the geometry metadata, the column
    header, and every row: known command mnemonic, fields in range for
    the declared geometry, ``-1`` conventions respected (REFab carries
    no group/bank/row, PRE no row, ACT/RD/WR a real row), and grant
    times strictly increasing per channel (refreshes may share the
    tick of a grant, never regress).

    Returns the number of command rows; raises `ValueError` on any
    violation.
    """
    lines = text.splitlines()
    if len(lines) < 4:
        raise ValueError("truncated trace: header + at least one row "
                         "required")
    if lines[0] != CMD_TRACE_HEADER:
        raise ValueError(f"line 1: expected {CMD_TRACE_HEADER!r}")
    if not lines[1].startswith("# "):
        raise ValueError("line 2: missing metadata comment")
    meta = {}
    for tok in lines[1][2:].split():
        if "=" not in tok:
            raise ValueError(f"line 2: malformed metadata token {tok!r}")
        key, _, val = tok.partition("=")
        meta[key] = val
    geom = {}
    for key in ("channels", "ranks", "banks", "bank_groups", "tck_ps"):
        if key not in meta:
            raise ValueError(f"line 2: metadata lacks {key!r}")
        try:
            geom[key] = int(meta[key])
        except ValueError:
            raise ValueError(f"line 2: {key} must be an int, "
                             f"got {meta[key]!r}") from None
    if lines[2] != CMD_TRACE_COLUMNS:
        raise ValueError(f"line 3: expected {CMD_TRACE_COLUMNS!r}")
    bpg = geom["banks"] // geom["bank_groups"]
    last_t = {}
    n = 0
    for ln, line in enumerate(lines[3:], start=4):
        fields = line.split(",")
        if len(fields) != 7:
            raise ValueError(f"line {ln}: expected 7 fields, "
                             f"got {len(fields)}")
        cmd = fields[2]
        if cmd not in CMD_TRACE_CMDS:
            raise ValueError(f"line {ln}: unknown command {cmd!r}")
        try:
            t, ch, rank, grp, bank, row = (
                int(fields[i]) for i in (0, 1, 3, 4, 5, 6))
        except ValueError:
            raise ValueError(
                f"line {ln}: non-integer field in {line!r}") from None
        if not 0 <= ch < geom["channels"]:
            raise ValueError(f"line {ln}: channel {ch} out of range")
        if not 0 <= rank < geom["ranks"]:
            raise ValueError(f"line {ln}: rank {rank} out of range")
        if cmd == "REFab":
            if (grp, bank, row) != (-1, -1, -1):
                raise ValueError(f"line {ln}: REFab must carry "
                                 "group/bank/row = -1")
        else:
            if not 0 <= bank < geom["banks"]:
                raise ValueError(f"line {ln}: bank {bank} out of range")
            if grp != bank // bpg:
                raise ValueError(f"line {ln}: bank_group {grp} "
                                 f"inconsistent with bank {bank}")
            if cmd in ("ACT", "RD", "WR") and row < 0:
                raise ValueError(f"line {ln}: {cmd} needs a row >= 0")
            if cmd in ("PRE", "REFsb") and row != -1:
                raise ValueError(f"line {ln}: {cmd} must carry row -1")
        # per-channel ordering: grants strictly increase; a refresh may
        # share a grant's tick but then must precede it (refresh
        # applies first inside a tick), and refresh ticks never regress
        lc, lr = last_t.get(ch, (-1, -1))
        if t <= lc or t < lr:
            raise ValueError(f"line {ln}: channel {ch} tick {t} not "
                             f"after previous grant {lc} / refresh {lr}")
        last_t[ch] = (lc, t) if cmd.startswith("REF") else (t, lr)
        n += 1
    if n == 0:
        raise ValueError("trace carries no command rows")
    return n
