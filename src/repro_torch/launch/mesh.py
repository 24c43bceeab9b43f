"""Meshes without devices: the production shapes and the host mesh.

The reference builds its meshes with ``jax.make_mesh`` over 256 or 512
(forced host) devices.  The port never holds 256 cards on one host, so a
`Mesh` here is names and sizes, which is all `parallel.axes` and
`launch.dryrun` read: the production meshes carry no devices, and the
1x1 host mesh carries the one device the port's program runs on.
Importing this module touches no device state.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.platform import resolve_device
from repro_torch.parallel.axes import (multi_pod_rules, serve_rules,
                                       single_pod_rules)


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: tuple
    devices: tuple | None = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The 16x16 ``pod`` (data, model) or the 2x16x16 ``multipod``
    (pod, data, model), as the reference's."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def rules_for(mesh: Mesh, *, serving: bool = False) -> dict:
    multi = "pod" in mesh.axis_names
    if serving:
        return serve_rules(multi_pod=multi)
    return multi_pod_rules() if multi else single_pod_rules()


def make_host_mesh(device=None) -> Mesh:
    """The degenerate 1x1 (data, model) mesh over one device: the card
    unless the caller asks for another (``device="cpu"``)."""
    return Mesh(("data", "model"), (1, 1), (resolve_device(device),))
