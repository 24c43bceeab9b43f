"""Per-window divergence between the three perspectives.

The paper's narrative, made machine-readable: for one run, build the
per-window latency series each perspective reports —

* **simulator view** — mean read latency out of the DRAM histograms
  (DRAM ticks x 750 ps);
* **interface view** — mean CPU-perceived read latency (the
  ``tele_hist_if_ps`` histogram);
* **application view** — the bound-phase load-to-use latency
  (``WindowOut.app_lat_cycles``) and the per-window progress *rate*
  (application throughput);

— and rank-correlate them window by window (`spearman`).  In the
broken stages the application series is *constant* (the DAMOV
immediate-response latency never moves, whatever the memory system
does), so its correlation with the simulator view is ~0: the
perspectives have decoupled.  The stage-04 PI controller feeds the
weave-phase latency back into the bound phase, and the correlation
jumps toward 1 — `divergence_report` tabulates that re-coupling
across the correction ladder.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.dram import N_HIST


def _ranks(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties share their mean rank), 1-based."""
    x = np.asarray(x, np.float64)
    order = np.argsort(x, kind="stable")
    ranks = np.empty_like(x)
    ranks[order] = np.arange(1, len(x) + 1, dtype=np.float64)
    # average the ranks inside each tie group
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = ranks[order[i:j + 1]].mean()
        i = j + 1
    return ranks


def spearman(a, b) -> float:
    """Spearman rank correlation with average-rank tie handling.

    A zero-variance series (every value identical — the decoupled
    application view in the broken stages) correlates with nothing:
    returns 0.0 rather than nan, which is exactly the "application
    perspective carries no information about the memory system"
    reading the report wants.
    """
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError(f"series shapes differ: {a.shape} vs {b.shape}")
    ra, rb = _ranks(a), _ranks(b)
    sa, sb = ra.std(), rb.std()
    if sa == 0.0 or sb == 0.0:
        return 0.0
    return float(np.mean((ra - ra.mean()) * (rb - rb.mean())) / (sa * sb))


def window_series(rec) -> dict:
    """Post-warmup per-window series of the three perspectives.

    Args:
        rec: a `TelemetryRecord` collected with ``outs`` (the
            application view needs ``app_lat_cycles``; ``app_rate``
            additionally needs a replay ``progress`` history and is
            omitted for Mess-style synthetic frontends).
    Returns:
        dict of aligned ``(W - warmup,)`` float arrays:
        ``sim_lat_ns`` / ``if_lat_ns`` / ``app_lat_ns`` (+
        ``app_rate`` when available: summed per-window progress
        increments, accesses/window).
    """
    s, w0 = rec.series, rec.warmup
    centers = 1.5 * (2.0 ** np.arange(N_HIST))     # bucket midpoints
    h_rd = np.asarray(s["tele_hist_rd_ticks"][w0:], np.float64).sum(axis=1)
    h_if = np.asarray(s["tele_hist_if_ps"][w0:], np.float64).sum(axis=1)
    n = np.maximum(h_rd.sum(axis=-1), 1.0)
    out = dict(
        sim_lat_ns=(h_rd @ centers) / n * rec.dram_ps_per_clk * 1e-3,
        if_lat_ns=(h_if @ centers) / np.maximum(h_if.sum(axis=-1), 1.0)
            * 1e-3,
    )
    if rec.app_lat_cycles is None:
        raise ValueError("record lacks the application view; pass "
                         "outs=... to repro.obs.collect")
    out["app_lat_ns"] = (np.asarray(rec.app_lat_cycles[w0:], np.float64)
                         * rec.cpu_ps_per_clk * 1e-3)
    if rec.progress is not None:
        prog = np.asarray(rec.progress, np.float64).sum(axis=-1)
        inc = np.diff(prog, prepend=0.0)
        out["app_rate"] = inc[w0:]
    return out


def divergence(rec) -> dict:
    """One run's rank correlations between perspectives.

    The headline ``rho_sim_app`` is a *response* correlation: the
    stage-04 PI correction couples the application view to memory as
    an exponential smoother, so the app-view latency **level** is an
    integral of past memory latency (it rank-correlates poorly with
    the instantaneous series even when perfectly coupled, and is
    exactly constant in the broken stages), while its per-window
    **change** is proportional to the previous window's measured
    latency — `spearman(sim_lat[w], app_lat[w+1] - app_lat[w])` is ~0
    when the perspectives are decoupled (the app view never moves, no
    matter what the memory system does) and ~1 once the correction
    re-couples them.  The level correlations are reported alongside
    (``*_level``), as is the application *progress* coupling
    (``rho_sim_rate``: sim latency vs negated per-window progress
    rate, so "1 = re-coupled" reads the same in every column).
    """
    ser = window_series(rec)
    sim, ifl, app = (ser["sim_lat_ns"], ser["if_lat_ns"],
                     ser["app_lat_ns"])
    inno = np.diff(app)                        # app-view response
    out = dict(
        rho_sim_if=spearman(sim, ifl),
        rho_sim_app=spearman(sim[:-1], inno),
        rho_if_app=spearman(ifl[:-1], inno),
        rho_sim_app_level=spearman(sim, app),
        rho_if_app_level=spearman(ifl, app),
        sim_lat_ns_mean=float(sim.mean()),
        if_lat_ns_mean=float(ifl.mean()),
        app_lat_ns_mean=float(app.mean()),
    )
    if "app_rate" in ser:
        out["rho_sim_rate"] = spearman(sim, -ser["app_rate"])
    return out


def divergence_report(records_by_stage: dict, tol: float = 0.05) -> dict:
    """The correction-ladder divergence table (stages 01→10).

    Args:
        records_by_stage: ``{stage_name: TelemetryRecord}`` in ladder
            order (insertion order is kept).
        tol: tolerated per-step dip in ``rho_sim_app`` before the
            ladder is called non-monotone.
    Returns:
        ``{"ladder": [{stage, rho_sim_app, ...}, ...],
        "monotone_ok": bool, "exceptions": [...]}`` — the acceptance
        artifact: ``rho_sim_app`` must improve (weakly, within
        ``tol``) from the broken baseline to the fully-corrected
        stage, and any local dip is listed explicitly rather than
        hidden in an aggregate.
    """
    ladder = []
    for stage, rec in records_by_stage.items():
        row = dict(stage=stage)
        row.update(divergence(rec))
        ladder.append(row)
    exceptions = []
    for prev, cur in zip(ladder, ladder[1:]):
        if cur["rho_sim_app"] < prev["rho_sim_app"] - tol:
            exceptions.append(dict(
                from_stage=prev["stage"], to_stage=cur["stage"],
                drop=round(prev["rho_sim_app"] - cur["rho_sim_app"], 4)))
    first, last = ladder[0]["rho_sim_app"], ladder[-1]["rho_sim_app"]
    return dict(
        schema="repro.obs/perspectives-v1",
        ladder=ladder,
        monotone_ok=not exceptions and last >= first,
        end_to_end_gain=round(last - first, 4),
        exceptions=exceptions,
        tol=tol,
    )
