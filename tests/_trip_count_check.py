"""A cell's count by its trip count against the same count op by op.

Run as ``PYTHONPATH=src python tests/_trip_count_check.py ARCH SHAPE
MESH [LAYERS]`` (``MESH``: ``host``, ``pod`` or ``multipod``; ``LAYERS``
cuts the config's depth): prints each count's wall time and its
FLOPs, bytes, ``temp``, ``output`` and ``args``, then the fields that
differ (none where the trip count is exact).  Op by op, a long loop
takes minutes (xlstm-1.3b's ``train_4k`` at 8 layers on the pod: ~10
minutes on a CPU).
"""
import dataclasses
import sys
import time

from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.registry import get_model

FIELDS = ("flops", "bytes", "temp", "output", "args", "collectives",
          "coll_log")


def count(cfg, shape, mesh: str, trips: bool, accum: int | None = None
          ) -> dict:
    """The `count_step` of ``shape``'s step of ``cfg`` on ``mesh`` (rank
    0's on the ``pod`` / ``multipod``), by its trip count or op by op;
    ``accum`` overrides the arch's train accumulation."""
    if mesh == "host":
        cell = dryrun.build_cell(get_model(cfg), shape, accum=accum)
        return dryrun.count_step(cell, _trips=trips)
    m = make_production_mesh(multi_pod=mesh == "multipod")
    with dryrun.partitioned_cell(get_model(cfg), shape, m,
                                 accum=accum) as cell:
        return dryrun.count_step(cell, local=True, _trips=trips)


def main(argv):
    arch, shape, mesh = argv[:3]
    cfg = get_config(arch)
    if len(argv) > 3:
        cfg = dataclasses.replace(cfg, n_layers=int(argv[3]))
    got = {}
    for trips in (True, False):
        t0 = time.perf_counter()
        got[trips] = c = count(cfg, SHAPES[shape], mesh, trips)
        print(f"{'trip count' if trips else 'op by op'}: "
              f"{time.perf_counter() - t0:.1f} s",
              {k: c[k] for k in FIELDS[:5]}, flush=True)
    print("loops", got[True]["loops"])
    print("differ", [k for k in FIELDS
                     if got[True].get(k) != got[False].get(k)])


if __name__ == "__main__":
    main(sys.argv[1:])
