"""Fig. 6: further enhancements — address mapping, NOC, prefetchers.

6a (stage 05): the Skylake XOR mapping restores the read/write-mix
    gradient the simple mapping hides.
6b (stage 06): the 2-D mesh NOC adds ~10 ns across the range.
6c (stage 07): stride prefetchers add traffic -> higher saturated
    latency (paper: up to +37 ns).

Usage (on the card; ``--device cpu`` runs the plain versions):
    python -m repro_torch.bench.fig6_enhancements [--full]
"""
from __future__ import annotations

from repro_torch.bench.util import OUT_DIR, emit, run_sweep, write_csv


def main(full: bool = False, device=None, out_dir=OUT_DIR):
    """Returns ``((res5, res6, res7), [(name, derived), ...])``."""
    res4, us4 = run_sweep("04-model-correct", full=full, device=device)
    res5, us5 = run_sweep("05-addrmap", full=full, device=device)
    res6, us6 = run_sweep("06-noc", full=full, device=device)
    res7, us7 = run_sweep("07-prefetch", full=full, device=device)
    for r, n in ((res5, "fig6a_addrmap"), (res6, "fig6b_noc"),
                 (res7, "fig6c_prefetch")):
        write_csv(r, n, out_dir)

    # 6a: gradient = read-only saturation bw over most-write mix
    grad_simple = float(res4.sim_bw[0].max() / res4.sim_bw[-1].max())
    grad_xor = float(res5.sim_bw[0].max() / res5.sim_bw[-1].max())
    # 6b: NOC latency delta at low load
    delta = float(res6.app_lat[0, 0] - res5.app_lat[0, 0])
    # 6c: prefetcher saturated-latency delta
    d7 = float(res7.app_lat[0].max() - res6.app_lat[0].max())
    emitted = [
        emit("fig6a.rw_gradient_simple", us5,
             f"{grad_simple:.2f}x (flat = gradient hidden)"),
        emit("fig6a.rw_gradient_xor", us5,
             f"{grad_xor:.2f}x (actual system: ~1.2x, gradient restored)"),
        emit("fig6b.noc_delta_ns", us6, f"+{delta:.1f} (paper: +10)"),
        emit("fig6c.prefetch_saturated_delta_ns", us7,
             f"{d7:+.1f} (paper: up to +37)"),
    ]
    return (res5, res6, res7), emitted


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    main(full=args.full, device=args.device)
