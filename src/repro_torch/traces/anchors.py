"""Reference runtime anchors: what each application *should* take.

The paper validates simulators against the measured machine; for the
application perspective that means per-application runtime on the real
server.  We derive analytic anchors from the per-preset measured Mess
curve families in `repro_torch.core.reference` with a small closed-system
model:

* dependent accesses serialize at the measured load-to-use latency
  (a pointer chase runs at exactly one access per latency);
* independent accesses stream at the Little's-law rate of `MSHR_CAP`
  outstanding lines per core, capped by (a) the machine's per-mix
  maximum bandwidth share and (b) the frontend issue ceiling — a core
  retires at most `CAP_DEMAND` demands per 1000-cycle window, the same
  bound the platform's bound phase enforces.  Both caps are
  socket-aware: ``n_sockets`` sockets carry ``24 * n_sockets - 1``
  traffic cores, so per-core bandwidth share shrinks while total
  frontend capacity grows — on HBM2e a second socket is what lets the
  anchors (and the platform) reach the device knee at all;
* latency and bandwidth are solved as a fixed point (more traffic ->
  higher latency -> fewer outstanding-lines per second).

Multiprogrammed mixes get the same treatment (`anchor_mix_ms`): one
*joint* fixed point where every application contributes traffic to the
shared curve, so a latency-bound app's anchor inherits the queueing
delay its streaming neighbours create — the real-machine behaviour a
per-app solo anchor cannot express.

These anchors are *references*, not measurements — they inherit the
per-preset anchor points (e.g. 89 ns unloaded / 120 GB/s saturation
for the paper's DDR4-2666 Skylake) and serve as the ground truth for
the benchmark's MAPE, playing the role of the paper's real-hardware
column.  Adding a new device preset means adding its curve family to
`repro_torch.core.reference._FAMILIES`; this module picks it up by
name.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import reference
from repro_torch.core.timing import CpuParams
from repro_torch.core.workload import CAP_DEMAND, MSHR_CAP, N_CORES_PER_SOCKET

LINE_BYTES = 64

_CPU = CpuParams()
#: frontend issue ceiling: lines / ns / core the bound phase can retire
_WINDOW_RATE = CAP_DEMAND / (_CPU.window_cycles * _CPU.cpu_ps_per_clk * 1e-3)


def n_traffic_cores(n_sockets: int = 1) -> int:
    """Traffic cores of an ``n_sockets`` frontend (one shared probe)."""
    return N_CORES_PER_SOCKET * n_sockets - 1


def anchor_runtime_ms(trace, preset: str = "ddr4_2666",
                      iters: int = 8, n_sockets: int = 1) -> float:
    """Analytic real-system runtime of one (unbatched) trace, in ms.

    Args:
        trace: an unbatched `repro_torch.traces.Trace`.
        preset: device preset whose reference curves anchor the model.
        iters: fixed-point iterations (converges in a handful).
        n_sockets: traffic sockets of the modeled machine (matches the
            platform's `StageConfig.n_sockets`).
    Returns:
        Runtime in milliseconds.  The trace is sharded across all
        traffic cores exactly as the replay frontend does, so anchor
        and prediction describe the same execution.
    """
    from repro_torch.traces.trace import trace_stats

    st = trace_stats(trace)
    n = st["accesses"]
    if n == 0:
        return 0.0
    n_traffic = n_traffic_cores(n_sockets)
    read_frac = 1.0 - st["write_frac"]
    n_dep = st["dep_frac"] * n
    n_ind = n - n_dep

    bw = 1.0                                   # GB/s, fixed-point seed
    t_ns = 1.0
    for _ in range(iters):
        lat = float(reference.latency_ns(bw, read_frac, preset))
        # per-core independent service rate (lines/ns), Little's law
        rate_core = MSHR_CAP / lat
        bw_cap = reference.max_bandwidth_gbs(read_frac, preset)
        rate_cap = bw_cap / (n_traffic * LINE_BYTES)  # GB/s -> lines/ns/core
        rate = min(rate_core, rate_cap, _WINDOW_RATE)
        # every core replays the full stream against its own shard
        t_ns = n_dep * lat + n_ind / rate
        bw = n_traffic * n * LINE_BYTES / t_ns         # bytes/ns = GB/s
    return t_ns * 1e-6


def anchor_suite_ms(traces, preset: str = "ddr4_2666",
                    n_sockets: int = 1) -> np.ndarray:
    """Per-trace `anchor_runtime_ms` over a list of traces (ms array)."""
    return np.asarray([anchor_runtime_ms(t, preset, n_sockets=n_sockets)
                       for t in traces])


def anchor_mix_ms(traces, cores_per_app, preset: str = "ddr4_2666",
                  iters: int = 12, n_sockets: int = 1) -> np.ndarray:
    """Per-app real-system runtimes of a multiprogrammed mix, in ms.

    One joint fixed point over the shared bandwidth-latency curve:
    every app's cores contribute traffic, the aggregate bandwidth sets
    the latency every app observes, and each app's independent-stream
    rate is capped by its *share* of the machine's saturation
    bandwidth (proportional to its core count — the fair-share outcome
    of per-channel FR-FCFS under symmetric demand).

    Args:
        traces: the mix's applications (unbatched `Trace`s).
        cores_per_app: traffic cores running each app (same order);
            the total must fit the ``n_sockets`` frontend.
        preset: device preset whose curve family anchors the model.
        iters: fixed-point iterations.
        n_sockets: traffic sockets of the modeled machine.
    Returns:
        (n_apps,) runtimes in milliseconds — each entry comparable to
        `anchor_runtime_ms` of the same trace when run *alone*, except
        for the contention the rest of the mix adds.
    """
    from repro_torch.traces.trace import trace_stats

    stats = [trace_stats(t) for t in traces]
    cores = np.asarray(cores_per_app, np.int64)
    if len(stats) != len(cores):
        raise ValueError("need one core count per trace")
    n_traffic = n_traffic_cores(n_sockets)
    if cores.sum() > n_traffic:
        raise ValueError(f"{cores.sum()} cores assigned but the "
                         f"{n_sockets}-socket frontend has {n_traffic}")

    n = np.asarray([s["accesses"] for s in stats], np.float64)
    n_dep = np.asarray([s["dep_frac"] for s in stats]) * n
    n_ind = n - n_dep
    read_frac = float(np.average(
        [1.0 - s["write_frac"] for s in stats],
        weights=np.maximum(n * cores, 1)))

    t_ns = np.ones(len(stats))
    bw_total = 1.0
    for _ in range(iters):
        lat = float(reference.latency_ns(bw_total, read_frac, preset))
        bw_cap = reference.max_bandwidth_gbs(read_frac, preset)
        rate_core = MSHR_CAP / lat
        # per-core share of saturation bandwidth: proportional split
        # across every *active* traffic core of the mix
        active = max(int(cores.sum()), 1)
        rate_cap = bw_cap / (active * LINE_BYTES)
        rate = min(rate_core, rate_cap, _WINDOW_RATE)
        t_ns = n_dep * lat + n_ind / rate
        with np.errstate(divide="ignore", invalid="ignore"):
            bw_app = np.where(t_ns > 0,
                              cores * n * LINE_BYTES / t_ns, 0.0)
        bw_total = float(bw_app.sum())
    return t_ns * 1e-6


def mape(predicted_ms, anchor_ms) -> float:
    """Mean absolute percentage error of predicted vs anchor runtimes."""
    p = np.asarray(predicted_ms, np.float64)
    a = np.asarray(anchor_ms, np.float64)
    return float(np.mean(np.abs(p - a) / np.maximum(a, 1e-12)) * 100.0)
