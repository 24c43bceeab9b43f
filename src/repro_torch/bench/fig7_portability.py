"""Fig. 7: portability — the interface fixes on other backends, plus
the beyond-paper stage 10 (MC-pipeline/PHY delay buffer, the paper's
future-work suggestion).

Usage (on the card; ``--device cpu`` runs the plain versions):
    python -m repro_torch.bench.fig7_portability [--full]
"""
from __future__ import annotations

from repro_torch.bench.util import OUT_DIR, emit, run_sweep, write_csv
from repro_torch.core import reference

#: (stage, backend name) of each curve
BACKENDS = (("07-prefetch", "ramulator"), ("08-dramsim3", "dramsim3"),
            ("09-ramulator2", "ramulator2"),
            ("10-delay-buffer", "delay_buffer"))


def main(full: bool = False, device=None, out_dir=OUT_DIR):
    """Returns ``({name: SweepResult}, [(name, derived), ...])``."""
    out, emitted = {}, []
    for stage, name in BACKENDS:
        res, us = run_sweep(stage, full=full, device=device)
        write_csv(res, f"fig7_{name}", out_dir)
        out[name] = res
        emitted += [
            emit(f"fig7.{name}.unloaded_ns", us,
                 f"{res.app_lat[0, 0]:.1f} (actual: "
                 f"{reference.UNLOADED_NS})"),
            emit(f"fig7.{name}.saturation_gbs", us,
                 f"{res.app_bw[0].max():.1f} "
                 f"(actual: {reference.max_bandwidth_gbs(1.0):.0f})"),
            emit(f"fig7.{name}.saturated_ns", us,
                 f"{res.app_lat[0].max():.0f} (actual: 240-390; "
                 f"paper: sims underpredict by up to 214)"),
        ]
    return out, emitted


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    main(full=args.full, device=args.device)
