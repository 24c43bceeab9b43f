"""How many elements XLA's windowed re-layouts move against the port's.

Run as ``PYTHONPATH=src python tests/_relayout_gap.py [cell ...]`` (cells:
``train_4k``, ``decode_32k``, ``prefill_32k`` of zamba2-2.7b on the pod;
default ``train_4k decode_32k``).  For each cell it compiles the
reference's partitioned step (``tests/_ref_partition.py``, one
subprocess), sums the per-device elements of the collectives XLA issues
for its ``split`` and ``concatenate`` ops (``RELAYOUT_OPS``: the windowed
re-layout of the Mamba2 in-projection's output into z, x, B and C, dt
and of the conv's input and output), kind by kind, checks that they equal
`test_torch_partition.relayout_windows` at the cell's dims (the bare
block's permutes and the concatenation's gathers and all-to-alls, per
layer, pass and microbatch, as the toy cells hold them array by array),
and sets them against the port's counterpart (`models.mamba2._pieces`:
one all-to-all of the windows each rank reads, forward, recompute and
backward, for each of the step's microbatches, as
`test_torch_partition._zamba2_terms` states them).

Prints one JSON line per cell: XLA's elements by kind (and the function's,
equal), the port's, their ratio, and both as bf16 bytes and seconds at the
NVLink rate of `perfmodel.roofline` (``NVLINK_BW``, one card's rate each
way).
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch.dryrun import DEFAULT_ACCUM, TRAIN_ACCUM  # noqa: E402
from repro_torch.perfmodel.roofline import NVLINK_BW  # noqa: E402
from test_torch_partition import (_zamba2_terms,  # noqa: E402
                                  relayout_windows)

ARCH = "zamba2-2.7b"
#: XLA's ops whose collectives re-lay the Mamba2 block's pieces
RELAYOUT_OPS = ("split", "concatenate")


def xla_relayout(rec) -> dict:
    out = {}
    for kind, dtype, dims, runs, op in rec["arrays"]:
        if op in RELAYOUT_OPS:
            n = math.prod(int(x) for x in dims.split(",")) if dims else 1
            out[kind] = out.get(kind, 0) + n * runs
    return out


def dims(shape) -> tuple:
    """``(D, cfg, accum)``: `test_torch_partition._dims`' dims of the full
    config's pod cell at ``shape`` (rank 0), the config's fields and the
    step's microbatches."""
    cfg = dataclasses.asdict(get_config(ARCH))
    R, M = 16, 16
    train = shape.kind == "train"
    a = TRAIN_ACCUM.get(ARCH, DEFAULT_ACCUM) if train else 1
    D = dict(b=max(shape.global_batch // (a * R), 1),
             T=1 if shape.kind == "decode" else shape.seq_len,
             d=cfg["d_model"], L=cfg["n_layers"], M=M, R=R, square=False,
             kind=shape.kind)
    return D, cfg, a


def function_relayout(shape, relayout) -> dict:
    """`relayout_windows` for the whole step: each microbatch's."""
    D, cfg, a = dims(shape)
    out = {}
    for kind, sizes in relayout_windows(D, cfg, shape.kind == "train",
                                        relayout).items():
        if sizes:
            out[kind] = a * sum(sizes)
    return out


def port_relayout(shape) -> int:
    """The port's re-layout all-to-all elements per device (rank 0), from
    `_zamba2_terms` with the mesh taken as not square (which leaves out
    ``w_cat``'s permuted shard, not a re-layout)."""
    D, cfg, a = dims(shape)
    ref = {k: [] for k in ("all-gather", "all-reduce", "reduce-scatter",
                           "all-to-all", "collective-permute")}
    port = {k: [] for k in ref}
    _zamba2_terms(D, cfg, shape.kind == "train", ref, port,
                  {"forward": [], "grad": []})
    return a * sum(port["all-to-all"])


def main(names):
    cells = [dict(arch=ARCH, shape=n, mesh="pod") for n in names]
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(HERE / "_ref_partition.py"),
                          json.dumps(cells)], capture_output=True, text=True,
                         env=env, check=True).stdout
    rate = NVLINK_BW
    for name, rec in zip(names, json.loads(out.splitlines()[-1])):
        xla = xla_relayout(rec)
        fn = function_relayout(SHAPES[name], rec["relayout"])
        port = port_relayout(SHAPES[name])
        total = sum(xla.values())
        print(json.dumps(dict(
            cell=f"{ARCH} pod {name}", xla_elements=xla,
            function_elements=fn, function_equal=fn == xla,
            xla_total=total, port_elements=port,
            port_over_xla=port / total,
            xla_bf16_bytes=2 * total, port_bf16_bytes=2 * port,
            xla_s=2 * total / rate, port_s=2 * port / rate)), flush=True)
        if fn != xla:
            raise SystemExit(f"{name}: relayout_windows gives {fn}, XLA "
                             f"{xla}")


if __name__ == "__main__":
    main(sys.argv[1:] or ["train_4k", "decode_32k"])
