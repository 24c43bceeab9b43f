"""XLA's collective-permutes for one sliced array, in isolation.

Run as ``PYTHONPATH=src python tests/_relayout_probe.py '[[M, B, lo, w],
...]'``: for each case, an array of 2 x (M*B) split over M forced host
devices is cut at ``[lo, lo + M*w)`` and the slice laid out over the same
M devices; prints each collective-permute XLA issues (its width and its
(source, target) pairs) and each (source, target) overlap of the input's
blocks with the slice's (``s, t``, the source-local range, the
target-local range).  The Mamba2 block's re-layouts in the reference's
compile are such slices' (``tests/_ref_partition.py``'s ``relayouts``
compiles the block's); how XLA groups a slice's overlaps into permutes
(its compact halo exchange) shows here: for ``[16, 68, 512, 32]``
(zamba2's x piece at the toy's widths) it issues five permutes for 20
overlaps that three could carry.
"""
import json
import os
import re
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

_PERMUTE = re.compile(r"= (\w+)\[([\d,]*)\]\S* collective-permute\(")


def probe(M, B, lo, w):
    """``(width, pairs)`` of each collective-permute XLA issues."""
    mesh = jax.make_mesh((M,), ("m",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:M])
    split = NamedSharding(mesh, P(None, "m"))
    x = jax.ShapeDtypeStruct((2, M * B), jnp.float32, sharding=split)
    f = jax.jit(lambda a: a[:, lo:lo + M * w], out_shardings=split)
    out = []
    for line in f.lower(x).compile().as_text().split("\n"):
        m = _PERMUTE.search(line)
        if m:
            pairs = re.search(r"source_target_pairs=\{(.*?)\}\}", line)
            out.append((int(m.group(2).split(",")[1]), sorted(
                tuple(map(int, p.split(",")))
                for p in re.findall(r"\{(\d+,\d+)", pairs.group(0)))))
    return sorted(out)


def overlaps(M, B, lo, w):
    """Each (source, target) overlap of the input's blocks with the
    slice's: ``(s, t, ls, le, ds, de)``, the source- and target-local
    ranges."""
    out = []
    for t in range(M):
        a0, b0 = lo + w * t, lo + w * (t + 1)
        for s in range(M):
            a, b = max(a0, B * s), min(b0, B * (s + 1))
            if a < b and s != t:
                out.append((s, t, a - B * s, b - B * s, a - a0, b - a0))
    return out


def main(cases):
    for spec in cases:
        print("CASE M, B, lo, w =", spec)
        for width, pairs in probe(*spec):
            print("   permute", width, pairs)
        print("    overlaps (s, t, ls, le, ds, de):", overlaps(*spec))


if __name__ == "__main__":
    main(json.loads(sys.argv[1]) if len(sys.argv) > 1
         else [[16, 68, 512, 32]])
