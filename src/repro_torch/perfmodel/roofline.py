"""Three-term roofline of one step on one H100, and MODEL_FLOPS.

The reference prices its dry-run at TPU v5e constants.  The port prices
the step it runs at the NVIDIA H100 SXM's, from NVIDIA's H100 data sheet
at the full 700 W board power; no TPU number is kept:

    PEAK_FLOPS  989e12 FLOP/s dense bf16 on the tensor cores
    HBM_BW      3.35e12 B/s HBM3
    NVLINK_BW   450e9 B/s   NVLink 4, each way, between the eight cards
                            of one host
    IB_BW       50e9 B/s    one 400 Gb/s InfiniBand port per card, the
                            link of the production meshes (32 or 64
                            hosts of eight cards)

Terms (seconds, per step, per card):

    compute    = hlo_flops_dev / PEAK_FLOPS
    memory     = hlo_bytes_dev / HBM_BW
    collective = collective_bytes_dev / LINK_BW[mesh]

plus MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N the active
parameters for MoE, and the useful ratio MODEL_FLOPS / (hlo_flops_dev ×
chips).  The field names keep the reference's (``hlo_*``) so that the
report and the bench read either kind of record; the port's counts come
from `launch.dryrun`, not from an HLO module.
"""
from __future__ import annotations

import dataclasses

from repro_torch.tree import leaves

PEAK_FLOPS = 989e12       # bf16 / card, dense
HBM_BW = 3.35e12          # bytes/s / card
NVLINK_BW = 450e9         # bytes/s / card, each way, within one host
IB_BW = 50e9              # bytes/s / card across hosts (400 Gb/s)

#: the collective link of each mesh: the host mesh is one card (no
#: collective), the production meshes span 32 or 64 hosts
LINK_BW = {"host": NVLINK_BW, "pod": IB_BW, "multipod": IB_BW}


@dataclasses.dataclass(frozen=True)
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_dev: float
    hlo_bytes_dev: float
    collective_bytes_dev: float
    model_flops: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_ratio: float
    bytes_per_device: float        # peak memory: args + temp

    def as_dict(self):
        return dataclasses.asdict(self)


def make(arch: str, shape: str, mesh: str, chips: int, *,
         cost: dict, collectives: dict, model_flops: float,
         bytes_per_device: float) -> Roofline:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    coll = float(collectives["total_bytes"])
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = coll / LINK_BW[mesh]
    terms = dict(compute=compute_s, memory=memory_s,
                 collective=collective_s)
    bottleneck = max(terms, key=terms.get)
    denom = flops * chips
    return Roofline(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops_dev=flops, hlo_bytes_dev=byts,
        collective_bytes_dev=coll, model_flops=model_flops,
        compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, bottleneck=bottleneck,
        useful_ratio=(model_flops / denom) if denom else 0.0,
        bytes_per_device=bytes_per_device)


# ---------------------------------------------------------------------------
# MODEL_FLOPS


def count_params_struct(tree) -> int:
    """Elements of every tensor leaf (meta tensors included)."""
    return sum(int(x.numel()) if hasattr(x, "numel") else 0
               for x in leaves(tree))


def _named_leaves(tree, key=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], k)
    else:
        yield key, tree


def count_active_params(tree, top_k: int, n_experts: int) -> int:
    """MoE-aware: expert tensors (key holds 'we_') count top_k / E,
    rounded down per leaf."""
    total = 0
    for key, leaf in _named_leaves(tree):
        size = int(leaf.numel())
        if "we_" in key and n_experts > 0:
            size = size * top_k // n_experts
        total += size
    return total


def model_flops(kind: str, n_active: int, tokens: int) -> float:
    """6·N·D for training, 2·N·D for forward/decode."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens
