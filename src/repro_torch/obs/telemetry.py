"""Telemetry collection and reduction (the simulator-view numbers).

`collect` snapshots a telemetry-enabled run (the flat ``tele_*`` keys
of the views dict) into a host-side `TelemetryRecord`; `summarize`
reduces it to the classical memory-controller statistics the Mess
methodology validates against: command mixes, row-buffer locality,
bank utilization, drain behavior, and latency percentiles.

Series conventions
------------------

All per-window series carry the **full** window axis ``W`` (warmup
included) so timelines start at t=0; reductions here slice
``warmup:`` themselves.  Keys and shapes (``C`` channels, ``RB``
banks/channel, ``B = dram.N_HIST`` log2 buckets):

==================== ============== =====================================
key                  shape          meaning
==================== ============== =====================================
``tele_n_act``       ``(W, C)``     ACT commands issued
``tele_n_pre``       ``(W, C)``     PRE commands issued (demand)
``tele_n_cas_rd``    ``(W, C)``     read CAS (== served reads)
``tele_n_cas_wr``    ``(W, C)``     write CAS (== served writes)
``tele_n_ref``       ``(W, C)``     refresh events (per-rank deadlines)
``tele_drain_enter`` ``(W, C)``     write-drain service bursts entered
``tele_drain_ticks`` ``(W, C)``     drain dwell (burst spans, at CAS)
``tele_busy_ticks``  ``(W, C, RB)`` row-open time (accounted at close)
``tele_hist_rd_ticks`` ``(W, C, B)`` read latency histogram, DRAM ticks
``tele_hist_if_ps``  ``(W, C, B)``  CPU-perceived read latency, ps
``tele_queue_depth`` ``(W, C)``     inject-queue depth after injection
``tele_mshr_budget`` ``(W,)``       MSHR closed-loop budget (requests)
``tele_lat_est_ps``  ``(W,)``       PI latency estimate (float ps)
==================== ============== =====================================

Histogram bucket ``b`` counts latencies in ``[2^b, 2^(b+1))`` —
integer-exact edges (`repro_torch.core.dram.log2_bucket`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dram import N_HIST

#: the per-window telemetry series every telemetry-enabled views dict
#: carries (see the module docstring for shapes)
TELE_KEYS = (
    "tele_n_act", "tele_n_pre", "tele_n_cas_rd", "tele_n_cas_wr",
    "tele_n_ref", "tele_drain_enter", "tele_drain_ticks",
    "tele_busy_ticks", "tele_hist_rd_ticks", "tele_hist_if_ps",
    "tele_queue_depth", "tele_mshr_budget", "tele_lat_est_ps",
)


@dataclasses.dataclass
class TelemetryRecord:
    """One run's telemetry: host-side numpy series plus static context.

    ``series`` maps `TELE_KEYS` to arrays; ``app_lat_cycles`` /
    ``progress`` carry the application view when an `outs`
    (`repro_torch.core.platform.WindowOut`) was supplied to `collect`.
    """

    stage: str
    windows: int
    warmup: int
    n_channels: int
    window_cycles: int
    cpu_ps_per_clk: int
    dram_ps_per_clk: int
    series: dict
    app_lat_cycles: np.ndarray | None = None   # (W,) bound-phase cycles
    progress: np.ndarray | None = None         # (W, n_cores) cursors

    def window_ps(self) -> int:
        """CPU picoseconds per window (the timeline step)."""
        return self.window_cycles * self.cpu_ps_per_clk


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


def collect(cfg, views, outs=None, *, row: int | None = 0) -> TelemetryRecord:
    """Snapshot one run of a telemetry-enabled batch as a `TelemetryRecord`.

    Args:
        cfg: the run's `StageConfig` (must have ``telemetry=True``).
        views: the views dict from `repro_torch.core.platform.run_frontend`
            (``tele_*`` series (B, W, ...)), or any dict carrying the
            ``tele_*`` keys, e.g. a replay result (numpy, (A, W, ...)).
        outs: optionally the run's `WindowOut` trajectory (fields
            (W, B, ...)); adds the application view (``app_lat_cycles``,
            ``progress``).
        row: the batch row to take: ``views[k][row]`` and
            ``outs.<field>[:, row]``.  ``None`` takes ``views`` and
            ``outs`` as one run's (W, ...) series, as `run_point` with
            an int pace returns them.
    """
    if not getattr(cfg, "telemetry", False):
        raise ValueError("telemetry is off in this StageConfig; rerun "
                         "with telemetry=True to collect planes")
    missing = [k for k in TELE_KEYS if k not in views]
    if missing:
        raise KeyError(f"views dict lacks telemetry keys {missing}")
    pick = (lambda x: _host(x)) if row is None else (
        lambda x: _host(x[row]))
    series = {k: pick(views[k]) for k in TELE_KEYS}
    progress = app_lat = None
    if outs is not None:
        def window_axis(x):
            x = _host(x)
            return x if row is None else x[:, row]

        # trace replay yields (W, n_cores) cursors; the Mess frontend a
        # scalar per-window marker — normalize to (W, K) for exporters
        progress = window_axis(outs.progress)
        progress = progress.reshape(progress.shape[0], -1)
        app_lat = window_axis(outs.app_lat_cycles)
    return TelemetryRecord(
        stage=cfg.name, windows=cfg.windows, warmup=cfg.warmup,
        n_channels=cfg.platform.dram.n_channels,
        window_cycles=cfg.platform.cpu.window_cycles,
        cpu_ps_per_clk=cfg.platform.cpu.cpu_ps_per_clk,
        dram_ps_per_clk=cfg.platform.dram.dram_ps_per_clk,
        series=series, app_lat_cycles=app_lat, progress=progress)


def hist_edges(unit_ps: float = 1.0) -> np.ndarray:
    """The ``N_HIST + 1`` log2 bucket edges, scaled to picoseconds.

    Bucket ``b`` spans ``[edges[b], edges[b+1])``; pass the DRAM tick
    length to get simulator-view edges in ps, or 1.0 to keep the raw
    integer domain.
    """
    return (2.0 ** np.arange(N_HIST + 1)) * unit_ps


def hist_percentiles(hist, qs=(0.50, 0.95, 0.99)) -> np.ndarray:
    """Percentiles from a log2 histogram, linear within buckets.

    Args:
        hist: ``(..., N_HIST)`` integer counts; leading axes reduce
            by summation (e.g. windows and channels).
        qs: quantiles in ``(0, 1]``.
    Returns:
        ``(len(qs),)`` float estimates in the histogram's own unit
        (DRAM ticks or picoseconds); ``nan`` for an empty histogram.

    Buckets only bound each sample to ``[2^b, 2^(b+1))``, so the
    estimate interpolates the quantile's position linearly inside its
    bucket — exact at bucket boundaries, <= 2x off in the worst case
    (the bucket width), which is the standard log2-histogram
    trade-off (HdrHistogram-style).
    """
    h = np.asarray(hist, np.float64).reshape(-1, N_HIST).sum(axis=0)
    total = h.sum()
    if total <= 0:
        return np.full(len(tuple(qs)), np.nan)
    cum = np.cumsum(h)
    lo = 2.0 ** np.arange(N_HIST)
    out = []
    for q in qs:
        target = q * total
        b = int(np.searchsorted(cum, target))
        b = min(b, N_HIST - 1)
        prev = cum[b - 1] if b > 0 else 0.0
        frac = (target - prev) / max(h[b], 1e-12)
        out.append(lo[b] * (1.0 + min(max(frac, 0.0), 1.0)))
    return np.asarray(out)


def summarize(rec: TelemetryRecord) -> dict:
    """Reduce a record to the classical controller statistics.

    Post-warmup totals and rates: command mix, row-locality split by
    the one-CAS-per-request identity (``hits = cas - act``,
    ``misses = act - pre``, ``conflicts = pre``; refresh-forced
    re-ACTs can push per-window hits slightly negative, so the split
    is clamped at zero and the raw commands are reported alongside),
    bank-busy fraction, write-drain behavior, and latency percentiles
    from both latency histograms.
    """
    s = rec.series
    w0 = rec.warmup
    tot = lambda k: int(np.sum(s[k][w0:]))
    n_act, n_pre = tot("tele_n_act"), tot("tele_n_pre")
    n_rd, n_wr = tot("tele_n_cas_rd"), tot("tele_n_cas_wr")
    n_cas = n_rd + n_wr
    span = rec.windows - w0
    # simulator-view wall time of the reduced span, in DRAM ticks
    span_ticks = span * (rec.window_ps() // rec.dram_ps_per_clk)
    busy = np.asarray(s["tele_busy_ticks"][w0:], np.float64)
    p_rd = hist_percentiles(s["tele_hist_rd_ticks"][w0:])
    p_if = hist_percentiles(s["tele_hist_if_ps"][w0:])
    return dict(
        stage=rec.stage, windows=rec.windows, warmup=rec.warmup,
        commands=dict(act=n_act, pre=n_pre, cas_rd=n_rd, cas_wr=n_wr,
                      ref=tot("tele_n_ref")),
        row_locality=dict(
            hits=max(n_cas - n_act, 0),
            misses=max(n_act - n_pre, 0),
            conflicts=n_pre,
            hit_rate=(max(n_cas - n_act, 0) / n_cas) if n_cas else 0.0),
        bank_busy_frac=float(busy.sum(axis=0).mean()) / max(span_ticks, 1),
        drain=dict(entries=tot("tele_drain_enter"),
                   ticks=tot("tele_drain_ticks")),
        queue_depth_mean=float(np.mean(np.sum(
            s["tele_queue_depth"][w0:], axis=-1))),
        mshr_budget_mean=float(np.mean(s["tele_mshr_budget"][w0:])),
        lat_est_ns_final=float(s["tele_lat_est_ps"][-1]) * 1e-3,
        # percentiles: simulator view in ns (ticks x 750 ps), interface
        # view in ns (the histogram is already in CPU-perceived ps)
        sim_lat_ns=dict(zip(("p50", "p95", "p99"),
                            (p_rd * rec.dram_ps_per_clk * 1e-3).tolist())),
        if_lat_ns=dict(zip(("p50", "p95", "p99"), (p_if * 1e-3).tolist())),
    )
