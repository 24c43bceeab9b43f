"""Real-system memory curves per device preset — the ground truth.

One Mess curve family per device preset (numpy): unloaded latency, and
per read fraction the saturation bandwidth and saturated latency, with
a closed-system queueing knee (``u^2 / (1 - u)``) between them.

* ``ddr4_2666`` — the paper's measured Skylake curves (89 ns unloaded,
  100-120 GB/s saturation, 240-390 ns saturated latency).
* ``ddr5_4800`` — a DDR5-4800 server socket (12 sub-channels).
* ``hbm2e`` — one HBM2e stack (~330 GB/s at 100% read).

Units: bandwidth GB/s, latency ns (load-to-use, application level).
"""
from __future__ import annotations

import numpy as np

#: per-preset (unloaded latency ns,
#:             {read_fraction: (saturation GB/s, saturated latency ns)})
_FAMILIES: dict[str, tuple[float, dict[float, tuple[float, float]]]] = {
    "ddr4_2666": (89.0, {
        1.00: (120.0, 240.0),
        0.87: (115.0, 280.0),
        0.75: (110.0, 320.0),
        0.62: (105.0, 355.0),
        0.50: (100.0, 390.0),
    }),
    "ddr5_4800": (92.0, {
        1.00: (210.0, 175.0),
        0.87: (200.0, 200.0),
        0.75: (190.0, 225.0),
        0.62: (180.0, 250.0),
        0.50: (170.0, 275.0),
    }),
    "hbm2e": (108.0, {
        1.00: (330.0, 160.0),
        0.87: (322.0, 175.0),
        0.75: (314.0, 190.0),
        0.62: (306.0, 205.0),
        0.50: (298.0, 220.0),
    }),
}


def _family(preset: str):
    try:
        return _FAMILIES[preset]
    except KeyError:
        raise ValueError(f"unknown reference preset {preset!r}; "
                         f"one of {list(_FAMILIES)}") from None


def unloaded_ns(preset: str = "ddr4_2666") -> float:
    """Unloaded load-to-use latency (ns) of the preset's real system."""
    return _family(preset)[0]


def _interp_anchor(read_frac: float,
                   preset: str = "ddr4_2666") -> tuple[float, float]:
    anchors = _family(preset)[1]
    fracs = np.array(sorted(anchors))
    bws = np.array([anchors[f][0] for f in fracs])
    lats = np.array([anchors[f][1] for f in fracs])
    return (float(np.interp(read_frac, fracs, bws)),
            float(np.interp(read_frac, fracs, lats)))


def latency_ns(bw_gbs, read_frac: float = 1.0, preset: str = "ddr4_2666"):
    """Real-system load-to-use latency (ns) at ``bw_gbs`` used bandwidth.

    Bandwidth past the per-mix saturation point is clamped; latency
    saturates at the per-mix maximum.
    """
    unloaded = _family(preset)[0]
    bw_sat, lat_sat = _interp_anchor(read_frac, preset)
    bw = np.minimum(np.asarray(bw_gbs, dtype=np.float64), bw_sat * 0.999)
    u = bw / bw_sat
    k = (lat_sat - unloaded) * 0.08
    lat = unloaded + k * (u ** 2) / np.maximum(1.0 - u, 0.02)
    return np.minimum(lat, lat_sat)


def max_bandwidth_gbs(read_frac: float = 1.0,
                      preset: str = "ddr4_2666") -> float:
    """Per-mix saturation bandwidth (GB/s) of the preset's real system."""
    return _interp_anchor(read_frac, preset)[0]


def curve(read_frac: float = 1.0, n: int = 64, preset: str = "ddr4_2666"):
    """(bandwidth GB/s, latency ns) arrays for one measured Mess curve."""
    bw_sat, _ = _interp_anchor(read_frac, preset)
    bw = np.linspace(0.0, bw_sat, n)
    return bw, latency_ns(bw, read_frac, preset)
