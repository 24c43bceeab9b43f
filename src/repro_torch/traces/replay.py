"""Batched multi-application replay engine.

One batched `platform.run_frontend` call replays a whole application
suite: the stacked `Trace` batch is the frontend's batch axis (the
reference maps with a device-sharded ``vmap``; here one call covers the
batch on one device), the same pattern `mess.sweep` uses for pace
points.  Stages and device presets iterate in Python; `replay_grid`
wraps that iteration, so a (preset x stage x app) grid is one call.

Multiprogrammed workloads ride the same machinery: a `TraceMix` replays
through `replay_mix`, a stack of mixes through `replay_mixes` — the mix
axis is the batch axis, like the app axis of a solo suite.  Per-app
runtimes in a mix come back per core and are reduced by ``app_id``.

On the card the bound phase and injection take one `window_inject_trace`
launch per window and the weave one `weave_window` launch
(`platform._inject_route`, `platform._weave_route`).

Outputs per application (numpy):

* the three views (simulator / interface / application bandwidth and
  latency) and the served counts, keyed by `VIEW_KEYS`;
* a predicted runtime: the window at which the trace was fully consumed
  (or an extrapolation from the final replay rate when the configured
  window count ends first);
* with ``cfg.telemetry``, the ``tele_*`` planes, (A, W, ...);
* beside the reference's keys: ``progress`` (the per-window per-core
  cursors, (A, W, n_cores)), ``injected`` and ``weave_events``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.platform import (StageConfig, resolve_device,
                                       run_frontend)
from repro_torch.traces.frontend import TraceFrontend
from repro_torch.traces.mix import TraceMix
from repro_torch.traces.trace import Trace, to

#: per-app result keys that are plain per-window scalars in the views
VIEW_KEYS = ("sim_bw_gbs", "sim_lat_ns", "if_bw_gbs", "if_lat_ns",
             "app_bw_gbs", "app_lat_ns", "chase_lat_ns", "n_rd", "n_wr")
#: further per-app keys the port keeps from the views
DIAG_KEYS = ("injected", "weave_events", "weave_sat")


def _replay(cfg: StageConfig, batch, dev) -> dict:
    """One batched replay of ``batch`` (on ``dev``); numpy arrays, one
    row per entry."""
    frontend = TraceFrontend(batch, cfg.workload_config())
    views, outs = run_frontend(cfg, frontend, batch=frontend.batch,
                               device=dev)
    out = {k: views[k] for k in VIEW_KEYS + DIAG_KEYS}
    out["progress"] = outs.progress.transpose(0, 1)      # (B, W, n_cores)
    if cfg.telemetry:
        # the telemetry planes, (B, W, ...): the dense re-run's rows
        # merge into them like every other key
        out.update({k: v for k, v in views.items() if k.startswith("tele_")})
    return {k: v.cpu().numpy() for k, v in out.items()}


def _replay_exact(cfg: StageConfig, batch, dev) -> dict:
    """Replay a batch, re-running event-budget-saturated rows dense.

    Under the event weave engine, a row whose windows exhaust the event
    budget (``weave_sat``, the exact divergence detector) is replayed
    through the dense engine and merged back by row, so the results are
    bit-identical to an all-dense replay.  ``weave_sat`` keeps the first
    pass's flag (how many rows were re-run).  The batch is moved to
    ``dev`` first, so the re-run rows are indexed there.
    """
    batch = to(batch, dev)
    out = _replay(cfg, batch, dev)
    sat = np.flatnonzero(out["weave_sat"] > 0)
    if sat.size and cfg.weave == "event":
        rows = torch.as_tensor(sat, device=batch.delta.device)
        sub = type(batch)(*(x[rows] for x in batch))
        fixed = _replay(dataclasses.replace(cfg, weave="dense"), sub, dev)
        for k, v in fixed.items():
            if k != "weave_sat":           # keep the diagnostic flag
                out[k][sat] = v
    return out


def _runtime_windows(progress, target, pos0=None):
    """Per-stream completion from a (..., W, n_cores) progress history.

    Args:
        progress: per-window per-core cursor positions.
        target: (..., n_cores) per-core access counts (0 = idle).
        pos0: (..., n_cores) per-core phase offsets (cursor start);
            extrapolation measures replay rate from here, not from 0.
    Returns:
        ``(runtime_windows, done)`` per core: the 1-based window at
        which the core's stream completed, extrapolated from the final
        replay rate when it did not; idle cores report 0 windows.
    """
    if pos0 is None:
        pos0 = np.zeros_like(target)
    W = progress.shape[-2]
    done = progress >= target[..., None, :]          # (..., W, N)
    any_done = done.any(axis=-2)
    first_done = np.where(any_done, done.argmax(axis=-2) + 1, W)
    advanced = np.maximum(progress[..., -1, :] - pos0, 1)
    est = W * (target - pos0) / advanced
    rt = np.where(any_done, first_done, est).astype(np.float64)
    return np.where(target > 0, rt, 0.0), any_done | (target == 0)


def _window_ms(cfg: StageConfig) -> float:
    cpu = cfg.platform.cpu
    return cpu.window_cycles * cpu.cpu_ps_per_clk * 1e-9


def replay_suite(cfg: StageConfig, traces: Trace, *, device=None) -> dict:
    """Replay a stacked trace batch through one stage; host-side dict.

    Args:
        cfg: the stage configuration (clock model, policy, platform).
        traces: a `Trace` with a leading application axis
            (`stack_traces`), on any device: it is moved to ``device``.
        device: ``None`` means ``"cuda"``.  The reference's ``donate``
            has no counterpart: the batch is never consumed.
    Returns:
        Numpy arrays keyed by `VIEW_KEYS` (bandwidth GB/s, latency ns)
        plus ``runtime_ms`` / ``runtime_windows`` / ``done`` /
        ``progress_final`` per application, and the port's
        ``progress`` / ``injected`` / ``weave_events`` / ``weave_sat``.
    """
    dev = resolve_device(device)
    wcfg = cfg.workload_config()
    length = traces.length.cpu().numpy()              # (A,)
    # per-core regions must stay below the chase-probe region (bit 31):
    # with two sockets (48 cores) large footprints can reach it
    fmax = int(traces.footprint_lines.max())
    if wcfg.n_cores * fmax > 1 << 31:
        raise ValueError(
            f"{wcfg.n_cores} cores x footprint {fmax} lines overflows "
            f"the 2^31-line traffic address space (the chase-probe "
            f"region starts at bit 31); shrink the footprint")

    out = _replay_exact(cfg, traces, dev)
    progress = out["progress"]                         # (A, W, n_cores)
    cid = np.arange(wcfg.n_cores)
    target = np.where(cid[None, :] < wcfg.n_traffic,
                      length[:, None], 0)             # (A, n_cores)
    rt, done = _runtime_windows(progress, target)
    traffic = cid < wcfg.n_traffic
    # the app finishes when its slowest core does (lockstep in solo mode)
    runtime_windows = rt[:, traffic].max(axis=1)

    out["done"] = done[:, traffic].all(axis=1)
    out["runtime_windows"] = runtime_windows
    out["runtime_ms"] = runtime_windows * _window_ms(cfg)
    out["progress_final"] = progress[:, -1, :][:, traffic].min(axis=1)
    return out


def replay_mix(cfg: StageConfig, mix: TraceMix, *, device=None) -> dict:
    """Replay one multiprogrammed mix; per-app and per-core results.

    Args:
        cfg: the stage configuration; ``cfg.n_sockets`` must match the
            mix's core count (24 cores per socket).
        mix: an unbatched `TraceMix` (`assign_traces`).
        device: ``None`` means ``"cuda"``.
    Returns:
        `replay_mixes`'s dict with the mix axis dropped.
    """
    out = replay_mixes(cfg, TraceMix(*(x[None] for x in mix)),
                       device=device)
    return {k: v[0] for k, v in out.items()}


def replay_mixes(cfg: StageConfig, mixes: TraceMix, *, device=None) -> dict:
    """Replay a stack of mixes (leading mix axis) in one batched call.

    Args:
        cfg: the stage configuration.
        mixes: a `TraceMix` batch from `stack_mixes`; all mixes share
            the platform's core count.
        device: ``None`` means ``"cuda"``.
    Returns:
        Host-side dict: views (M,), per-core arrays (M, n_cores), and
        per-app arrays (M, A) where A is the largest app count across
        the batch (``nan`` / False padding for mixes with fewer apps).
    """
    dev = resolve_device(device)
    target = mixes.length.cpu().numpy()                # (M, n_cores)
    app_id = mixes.app_id.cpu().numpy()                # (M, n_cores)
    pos0 = mixes.pos0.cpu().numpy()                    # (M, n_cores)
    out = _replay_exact(cfg, mixes, dev)
    rt, done = _runtime_windows(out["progress"], target, pos0)

    M = app_id.shape[0]
    n_apps = int(app_id.max()) + 1 if app_id.size else 0
    app_rt = np.full((M, n_apps), np.nan)
    app_done = np.zeros((M, n_apps), bool)
    for m in range(M):
        for a in range(n_apps):
            cores = app_id[m] == a
            if cores.any():
                # an app finishes when its slowest core does
                app_rt[m, a] = rt[m, cores].max()
                app_done[m, a] = done[m, cores].all()

    out["core_runtime_windows"] = rt
    out["core_done"] = done
    out["app_runtime_windows"] = app_rt
    out["app_runtime_ms"] = app_rt * _window_ms(cfg)
    out["app_done"] = app_done
    return out


def replay_stages(stages, traces: Trace, preset: str | None = None, *,
                  device=None, **overrides) -> dict:
    """Replay one trace batch across several stages.

    Args:
        stages: iterable of stage names or `StageConfig`s.
        traces: stacked `Trace` batch (leading application axis).
        preset: optional device preset applied to every named stage.
        device: ``None`` means ``"cuda"``.
        **overrides: `StageConfig` field overrides applied to every
            named stage (``windows``, ``warmup``, ``n_sockets``, ...).
    Returns:
        ``{stage_name: replay_suite(...)}``.
    """
    from repro_torch.core import get_stage

    dev = resolve_device(device)
    batch = to(traces, dev)           # moved once, shared by every stage
    results = {}
    for st in stages:
        cfg = st if isinstance(st, StageConfig) else get_stage(
            st, preset=preset, **overrides)
        results[cfg.name] = replay_suite(cfg, batch, device=dev)
    return results


def replay_grid(presets, stages, traces: Trace, *, device=None,
                **overrides) -> dict:
    """One scenario grid: preset x stage x application.

    Each (preset, stage) cell is one batched replay over the application
    axis; presets and stages iterate in Python.

    Returns:
        ``{preset: {stage: replay_suite(...)}}``.
    """
    return {p: replay_stages(stages, traces, preset=p, device=device,
                             **overrides)
            for p in presets}
