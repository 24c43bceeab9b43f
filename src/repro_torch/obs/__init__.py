"""Three-perspective observability (the port's copy of ``repro.obs``).

The paper's thesis is that the *simulator*, *CPU-memory interface*,
and *application* perspectives of the same run can diverge — and that
the correction ladder (stages 01→10) re-couples them.  This package
turns the platform's in-kernel telemetry planes (enabled with
``StageConfig(telemetry=True)``) into inspectable artifacts:

* `repro_torch.obs.telemetry` — collect the raw ``tele_*`` view series into
  a `TelemetryRecord`; reduce to command mixes, row-locality splits,
  bank utilization, and latency percentiles.
* `repro_torch.obs.export` — structured JSON reports and a Chrome-trace /
  Perfetto JSON timeline (per-channel command tracks, write-drain
  phase slices, per-core progress tracks), plus the Ramulator2-
  compatible ``.cmd.trace`` exporter for recorded `repro_torch.oracle`
  command streams.
* `repro_torch.obs.perspectives` — per-window rank correlation between the
  three views' latency/progress series: the machine-readable
  "perspectives diverge, corrections re-couple them" report.

Telemetry is a `StageConfig` flag: when off (default) every output is
as without it.  When on, every counter is *event-accounted* inside
`repro_torch.core.dram.tick` (and the recording instance of the
`weave_window` kernel on the card), so both weave engines (dense and
event-horizon) produce identical planes.  The views carry a leading
batch axis, so `collect` takes one row of them (``row=``).  These
modules are numpy only.
"""
from repro_torch.obs.telemetry import (TELE_KEYS, TelemetryRecord,
                                       collect, hist_edges,
                                       hist_percentiles, summarize)
from repro_torch.obs.export import (to_cmd_trace, to_json, to_perfetto,
                                    validate_cmd_trace, validate_perfetto)
from repro_torch.obs.perspectives import (divergence_report, spearman,
                                          window_series)

__all__ = [
    "TELE_KEYS", "TelemetryRecord", "collect", "hist_edges",
    "hist_percentiles", "summarize", "to_json", "to_perfetto",
    "validate_perfetto", "to_cmd_trace", "validate_cmd_trace",
    "divergence_report", "spearman", "window_series",
]
