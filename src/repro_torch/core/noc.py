"""Network-on-chip models (paper Sec. 4, Fig. 6b).

``fixed`` folds the NOC into the LLC latency (baseline).  ``mesh`` is a
Skylake-like 6x4 2-D mesh (core -> address-hashed LLC slice -> IMC on
the die edge -> core), evaluated analytically over the uniform slice
hash at 4 core cycles per hop; the extra round trip over the baseline's
fixed delay is ~21 CPU cycles (~10 ns, the paper's measurement).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

MESH_COLS = 6
MESH_ROWS = 4
CYCLES_PER_HOP = 4


@dataclasses.dataclass(frozen=True)
class NocModel:
    kind: str                 # "fixed" | "mesh"
    req_cycles: int           # extra request-path cycles vs. baseline
    resp_cycles: int          # extra response-path cycles vs. baseline


def _tiles():
    return list(itertools.product(range(MESH_ROWS), range(MESH_COLS)))


def _manhattan(a, b):
    return abs(a[0] - b[0]) + abs(a[1] - b[1])


def mesh_hop_stats() -> dict:
    """Expected hop counts for core->slice->IMC->core paths."""
    tiles = _tiles()
    imcs = [(1, 0), (2, MESH_COLS - 1)]
    h_cs = np.mean([_manhattan(c, s) for c in tiles for s in tiles])
    h_sm = np.mean([min(_manhattan(s, m) for m in imcs) for s in tiles])
    h_mc = np.mean([min(_manhattan(m, c) for m in imcs) for c in tiles])
    return dict(core_to_slice=h_cs, slice_to_imc=h_sm, imc_to_core=h_mc)


def make_noc(kind: str) -> NocModel:
    if kind == "fixed":
        return NocModel("fixed", 0, 0)
    if kind == "mesh":
        h = mesh_hop_stats()
        req = round((h["core_to_slice"] + h["slice_to_imc"])
                    * CYCLES_PER_HOP)
        resp = round(h["imc_to_core"] * CYCLES_PER_HOP)
        baseline_rt = 10          # fixed delay the baseline already charges
        extra = max(req + resp - baseline_rt, 0)
        req_extra = int(round(extra * (req / (req + resp))))
        return NocModel("mesh", req_cycles=req_extra,
                        resp_cycles=int(extra - req_extra))
    raise ValueError(f"unknown NOC kind {kind!r}")
