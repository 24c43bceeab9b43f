"""Mess-style bandwidth-latency characterization (paper Sec. 2, Fig. 2-7).

The Mess benchmark profiles a memory system as a family of
bandwidth-latency curves: per read/write mix, sweep the injected
bandwidth from unloaded to saturation and record what a pointer-chase
probe observes.  `sweep` drives `platform.run_point` over the
(pace x write-mix) grid.  The points are independent, so every point
that one weave engine serves runs in **one batched call**, across all
mixes — the batch axis takes the place of the reference's per-mix
``vmap`` — and `shard.sharded_vmap` spreads that batch over the devices
it is given, as the reference shards it over its devices.  Results are
plain numpy arrays.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from repro_torch.core.platform import StageConfig, run_point
from repro_torch.core.shard import resolve_devices, sharded_vmap

#: write-fraction numerators out of 64 -> read fractions 100..50%
WRITE_MIXES = (0, 8, 16, 24, 32)
#: demand requests per traffic core per window (pace 64 ~ 198 GB/s
#: offered on one socket)
DEFAULT_PACES = (1, 2, 4, 6, 8, 12, 16, 20, 24, 28, 32, 40, 48, 64)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """One stage's Mess characterization, all three views."""

    stage: str
    write_mixes: tuple
    paces: tuple
    # each (n_mixes, n_paces) float arrays
    sim_bw: np.ndarray
    sim_lat: np.ndarray
    if_bw: np.ndarray
    if_lat: np.ndarray
    app_bw: np.ndarray
    app_lat: np.ndarray
    chase_lat: np.ndarray

    def view(self, which: str):
        """(bw GB/s, lat ns) arrays for 'sim' | 'if' | 'app'."""
        return (getattr(self, f"{which}_bw"), getattr(self, f"{which}_lat"))

    def read_fraction(self, i: int) -> float:
        return 1.0 - self.write_mixes[i] / 64.0

    def to_rows(self):
        """Rows in the artifact's bandwidth_latency.csv format."""
        rows = []
        for i, wr in enumerate(self.write_mixes):
            for j, pace in enumerate(self.paces):
                rows.append(dict(
                    stage=self.stage, read_pct=round(100 * (1 - wr / 64)),
                    pace=pace,
                    sim_bw_gbs=self.sim_bw[i, j], sim_lat_ns=self.sim_lat[i, j],
                    if_bw_gbs=self.if_bw[i, j], if_lat_ns=self.if_lat[i, j],
                    app_bw_gbs=self.app_bw[i, j], app_lat_ns=self.app_lat[i, j],
                ))
        return rows


#: measured events/window fits keyed on (DramParams, stage name):
#: ``(per_pace, fixed)``.  Routing only — the exact ``weave_sat``
#: backstop means a stale entry costs speed, never correctness.
_EVENT_CAL: dict = {}

#: safety margin over the measured fit
CAL_MARGIN = 1.35

#: the checked-in calibration report (data; read as JSON)
CALIBRATION_REPORT = (pathlib.Path(__file__).resolve().parents[3]
                      / "reports" / "benchmarks" / "BENCH_weave.json")


def load_event_calibration(path: str | None = None) -> int:
    """Register the events/window fits of a ``BENCH_weave.json`` report.

    Returns the number of entries registered (0 when the report is
    missing or carries no fits: routing keeps the closed-form bound).
    """
    from repro_torch.core.presets import PRESETS, platform_for

    path = pathlib.Path(path) if path is not None else CALIBRATION_REPORT
    if not path.exists():
        return 0
    report = json.loads(path.read_text())
    stage = report.get("stage", "")
    n = 0
    for preset, row in report.get("presets", {}).items():
        fit = row.get("event_rate_fit")
        if not fit or preset not in PRESETS:
            continue
        _EVENT_CAL[(platform_for(preset).dram, stage)] = (
            float(fit["per_pace"]), float(fit["fixed"]))
        n += 1
    return n


_CAL_LOADED = False


def _ensure_calibration():
    """Register the checked-in calibration once per process (a malformed
    or missing report falls back to the closed-form bound)."""
    global _CAL_LOADED
    if not _CAL_LOADED:
        _CAL_LOADED = True
        try:
            load_event_calibration()
        except (OSError, ValueError, KeyError, TypeError):
            pass


def event_covers(cfg: StageConfig, pace: int) -> bool:
    """Static estimate: does the event budget cover this pace's events?

    ``3 * pace * n_traffic / C + pace + 64`` commands per channel per
    window, or the measured fit (x `CAL_MARGIN`) where one is
    registered for this device and stage.
    """
    wcfg = cfg.workload_config()
    d = cfg.platform.dram
    cal = _EVENT_CAL.get((d, cfg.name))
    if cal is not None:
        a, b = cal
        est = int((a * pace + max(b, 0.0)) * CAL_MARGIN) + 1
    else:
        est = (3 * pace * wcfg.n_traffic) // d.n_channels + pace + 64
    return est <= cfg.event_budget()


def _batch(cfg: StageConfig, paces, wrs, devices) -> dict:
    """One engine batch of points, split over ``devices``; numpy arrays,
    one row per point."""
    def chunk(pw, dev):
        return run_point(cfg, pw[0].tolist(), pw[1].tolist(), device=dev)

    pw = (np.asarray(paces, np.int32), np.asarray(wrs, np.int32))
    out = sharded_vmap(chunk, devices)(pw)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _run_points(cfg: StageConfig, paces, wrs, device=None) -> dict:
    """Independent (pace, wr) points, knee-routed between the engines.

    With ``cfg.weave == "event"``, points whose event budget provably
    suffices (`event_covers`) run the event engine in one batch; the
    rest, and any event point that still reports ``weave_sat``, run the
    dense reference in one batch.  The result is bit-identical to an
    all-dense run by construction.  Each batch spreads over ``device``
    (`shard.resolve_devices`: a list spreads, anything else is one
    device).  Returns one array per view key, one row per point.
    """
    n = len(paces)
    devices = resolve_devices(device)
    if cfg.weave != "event":
        return _batch(cfg, paces, wrs, devices)
    _ensure_calibration()
    ev = [i for i in range(n) if event_covers(cfg, paces[i])]
    dn = [i for i in range(n) if i not in ev]
    parts = []
    if ev:
        out = _batch(cfg, [paces[i] for i in ev], [wrs[i] for i in ev],
                     devices)
        sat = out["weave_sat"] > 0
        if sat.any():                       # estimator missed: go exact
            dn += [ev[j] for j in np.flatnonzero(sat)]
            ev = [ev[j] for j in np.flatnonzero(~sat)]
            out = {k: v[~sat] for k, v in out.items()}
        if ev:
            parts.append((ev, out))
    if dn:
        parts.append((dn, _batch(dataclasses.replace(cfg, weave="dense"),
                                 [paces[i] for i in dn],
                                 [wrs[i] for i in dn], devices)))
    merged = {}
    for k, proto in parts[0][1].items():
        col = np.empty((n,) + proto.shape[1:], proto.dtype)
        for idx, v in parts:
            col[np.asarray(idx, int)] = v[k]
        merged[k] = col
    return merged


def _run_mix(cfg: StageConfig, paces, wr, device=None) -> dict:
    """One write-mix row, knee-routed (see `_run_points`)."""
    return _run_points(cfg, tuple(paces), (wr,) * len(paces), device)


def sweep(cfg: StageConfig, paces=DEFAULT_PACES, write_mixes=WRITE_MIXES,
          *, device=None) -> SweepResult:
    """Run the Mess characterization of one simulation stage.

    Every (mix, pace) point of the grid is knee-routed by `_run_points`
    in one pass, so each weave engine runs once for the whole grid, its
    batch on ``device``: ``None`` means the card, an explicit device
    (``"cuda:k"``, ``"cpu"``) that device, a list of devices spreads the
    batch over them (a device may repeat: chunks on one card).  The
    result is bit-identical however the batch is split.
    ``cfg.telemetry`` runs through the merge (its planes are per window,
    shaped alike on both engines); ``cfg.cmd_trace`` raises, as the
    reference's does.
    """
    if cfg.cmd_trace:
        # the per-step `cmd_*` records have engine-dependent step axes
        # (dense: ticks per window, event: the budget), so the knee-routed
        # merge cannot stack them; record command streams through
        # `platform.run_frontend` on one engine instead
        raise ValueError("cmd_trace is unsupported in mess.sweep's "
                         "knee-routed engine mix; run run_frontend "
                         "with an explicit weave engine instead")
    devices = resolve_devices(device)
    paces, write_mixes = tuple(paces), tuple(write_mixes)
    grid_p = [p for _ in write_mixes for p in paces]
    grid_w = [wr for wr in write_mixes for _ in paces]
    out = _run_points(cfg, grid_p, grid_w, devices)
    shape = (len(write_mixes), len(paces))
    views = dict(sim_bw="sim_bw_gbs", sim_lat="sim_lat_ns",
                 if_bw="if_bw_gbs", if_lat="if_lat_ns",
                 app_bw="app_bw_gbs", app_lat="app_lat_ns",
                 chase_lat="chase_lat_ns")
    return SweepResult(
        stage=cfg.name, write_mixes=write_mixes, paces=paces,
        **{k: out[v].reshape(shape) for k, v in views.items()})


def unloaded_latency_ns(res: SweepResult, view: str = "app") -> float:
    """Latency of the lowest-bandwidth 100%-read point."""
    _, lat = res.view(view)
    return float(lat[0, 0])


def max_bandwidth_gbs(res: SweepResult, view: str = "app",
                      mix_index: int = 0) -> float:
    bw, _ = res.view(view)
    return float(np.max(bw[mix_index]))


def saturated_latency_ns(res: SweepResult, view: str = "app",
                         mix_index: int = 0) -> float:
    bw, lat = res.view(view)
    return float(lat[mix_index, int(np.argmax(bw[mix_index]))])
