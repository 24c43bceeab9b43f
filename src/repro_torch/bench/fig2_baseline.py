"""Fig. 2: baseline (DAMOV-native) three-view characterization.

Reproduces the paper's headline finding: the application view sits
flat at ~24 ns across the whole bandwidth range, decoupled from the
memory simulator's own statistics, while the interface view's
bandwidth exceeds the theoretical maximum.

The decoupling is a property of the bound/weave interface, not of one
memory device — ``--preset ddr5_4800`` / ``--preset hbm2e`` rerun the
characterization on the other device presets and report the same
interface-inflation ratio plus each curve's deviation (MAPE) from that
preset's measured reference curve.

Usage (on the card; ``--device cpu`` runs the plain versions):
    python -m repro_torch.bench.fig2_baseline [--full] [--preset P]
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.util import (OUT_DIR, emit, preset_suffix,
                                    run_sweep, write_csv)
from repro_torch.core import get_preset, reference
from repro_torch.core.presets import PRESET_ORDER


def main(full: bool = False, preset: str = "ddr4_2666", device=None,
         out_dir=OUT_DIR):
    """Returns ``(SweepResult, [(name, derived), ...])``."""
    res, us = run_sweep("01-baseline", full=full, preset=preset,
                        device=device)
    suffix = preset_suffix(preset)
    write_csv(res, f"fig2_baseline{suffix}", out_dir)
    peak = get_preset(preset).peak_gbs

    app_flat = float(np.ptp(res.app_lat[0]))
    emitted = [
        emit(f"fig2{suffix}.app_latency_ns", us,
             f"{res.app_lat[0, 0]:.1f} (paper: 24; flat +/-{app_flat:.2f})"),
        emit(f"fig2{suffix}.sim_unloaded_ns", us,
             f"{res.sim_lat[0, 0]:.1f} (paper: 43)"),
        emit(f"fig2{suffix}.if_bw_over_theoretical", us,
             f"{res.if_bw.max() / peak:.2f}x (paper: 1.4x; >1 = bug "
             f"visible)"),
        emit(f"fig2{suffix}.sim_saturation_gbs", us,
             f"{res.sim_bw.max():.1f} (reference: "
             f"{reference.max_bandwidth_gbs(1.0, preset):.0f})"),
    ]

    # per-mix deviation of the simulator-view curve from the preset's
    # measured reference curve (the Mess-style validation number)
    errs = []
    for i in range(len(res.write_mixes)):
        rf = res.read_fraction(i)
        ref_lat = reference.latency_ns(res.sim_bw[i], rf, preset)
        errs.append(np.mean(np.abs(res.sim_lat[i] - ref_lat)
                            / np.maximum(ref_lat, 1e-9)) * 100.0)
    emitted.append(emit(f"fig2{suffix}.sim_curve_mape_pct", us,
                        f"{float(np.mean(errs)):.1f} (vs {preset} "
                        f"reference curves)"))
    return res, emitted


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--preset", default="ddr4_2666",
                    choices=list(PRESET_ORDER))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    main(full=args.full, preset=args.preset, device=args.device)
