"""Command-level differential oracle (the port's copy of ``repro.oracle``).

The third leg of the fidelity argument: the golden grid proves the two
weave engines are bit-identical to *each other*, the telemetry planes
expose what the controller did, and this package checks that what it
did is **DDRx-protocol legal** — every timing window and every bank
state-machine rule — from the recorded command stream alone, with no
access to the simulator's internal bookkeeping.

* `extract_stream` — flatten a ``cmd_trace=True`` run's raw ``cmd_*``
  views into a time-ordered per-channel `CommandStream`.
* `check_stream` — replay a stream against the device's `DramParams`
  and report every violation (`LegalityReport`, rules in `RULES`).
* `diff_streams` / `stream_stats` — engine-agreement helpers for the
  differential harness (`repro_torch.bench.cmd_oracle`).

Export to the Ramulator2-compatible ``.cmd.trace`` text format lives
in `repro_torch.obs.export` (`to_cmd_trace` / `validate_cmd_trace`).
These modules are numpy only.
"""
from repro_torch.oracle.stream import (CommandStream, diff_streams,
                                 extract_stream, stream_stats)
from repro_torch.oracle.checker import RULES, LegalityReport, check_stream

__all__ = [
    "CommandStream", "extract_stream", "stream_stats", "diff_streams",
    "RULES", "LegalityReport", "check_stream",
]
