"""Fig. 3 + Fig. 4: the two clocking corrections.

Fig. 3 (stage 02): enabling clock scaling removes the >theoretical
bandwidth, but DAMOV's integer freqRatio rounding leaves the interface
~21% below the memory simulator (1.05 vs 1.333 GHz).
Fig. 4 (stage 03): the picosecond interface (Listing 1b) aligns the
interface and simulator views exactly.

Usage (on the card; ``--device cpu`` runs the plain versions):
    python -m repro_torch.bench.fig3_fig4_clocking [--full]
"""
from __future__ import annotations

from repro_torch.bench.util import OUT_DIR, emit, run_sweep, write_csv
from repro_torch.core import get_stage


def main(full: bool = False, device=None, out_dir=OUT_DIR):
    """Returns ``((res3, res4), [(name, derived), ...])``."""
    res3, us3 = run_sweep("02-clock-scale", full=full, device=device)
    write_csv(res3, "fig3_clock_scale", out_dir)
    ratio3 = float((res3.if_bw / res3.sim_bw).mean())
    peak = get_stage("02-clock-scale").platform.dram.peak_gbs
    emitted = [
        emit("fig3.if_over_sim_bw", us3,
             f"{ratio3:.4f} (expected 0.7875 = 1.05/1.333 GHz)"),
        emit("fig3.if_bw_over_theoretical", us3,
             f"{res3.if_bw.max() / peak:.2f}x (must be <= 1)"),
    ]

    res4, us4 = run_sweep("03-ps-clock", full=full, device=device)
    write_csv(res4, "fig4_ps_clock", out_dir)
    ratio4 = float((res4.if_bw / res4.sim_bw).mean())
    emitted += [
        emit("fig4.if_over_sim_bw", us4, f"{ratio4:.4f} (expected 1.0000)"),
        emit("fig4.sim_saturation_gbs", us4,
             f"{res4.sim_bw.max():.1f} (matches actual: 100-120)"),
    ]
    return (res3, res4), emitted


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    main(full=args.full, device=args.device)
