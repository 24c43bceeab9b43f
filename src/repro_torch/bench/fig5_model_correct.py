"""Fig. 5: PI-controlled immediate-response latency (Sec. 3.4).

The application view recouples to the memory simulator: unloaded app
latency rises from ~24 ns to the corrected value (paper: 67 ns, actual
HW: 89 ns), and the loaded app curve tracks the interface view.

Usage (on the card; ``--device cpu`` runs the plain versions):
    python -m repro_torch.bench.fig5_model_correct [--full]
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.util import OUT_DIR, emit, run_sweep, write_csv


def main(full: bool = False, device=None, out_dir=OUT_DIR):
    """Returns ``(SweepResult, [(name, derived), ...])``."""
    res, us = run_sweep("04-model-correct", full=full, device=device)
    write_csv(res, "fig5_model_correct", out_dir)
    # coupling: correlation between app and interface latency curves
    a, i = res.app_lat.ravel(), res.if_lat.ravel()
    corr = float(np.corrcoef(a, i)[0, 1])
    emitted = [
        emit("fig5.app_unloaded_ns", us,
             f"{res.app_lat[0, 0]:.1f} (paper: 67; actual HW: 89)"),
        emit("fig5.app_if_correlation", us,
             f"{corr:.3f} (baseline: ~0 — decoupled)"),
        emit("fig5.app_saturated_ns", us,
             f"{res.app_lat[0].max():.0f} (views now move together)"),
    ]
    return res, emitted


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    main(full=args.full, device=args.device)
