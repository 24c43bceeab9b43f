"""Meshes without devices: the production shapes and the host mesh.

The reference builds its meshes with ``jax.make_mesh`` over 256 or 512
(forced host) devices.  The port never holds 256 cards on one host, so a
`Mesh` here is names and sizes, which is all `parallel.axes` and
`launch.dryrun` read: the production meshes carry no devices, and the
1x1 host mesh carries the one device the port's program runs on.

`device_mesh` turns a `Mesh` into a torch ``DeviceMesh`` for DTensor:
the production meshes over the ``"fake"`` process group (this process
is rank 0 of ``mesh.size``; its collectives move no data), the host mesh
over a one-rank real group.  Importing this module touches no device
state and starts no process group.
"""
from __future__ import annotations

import contextlib
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


def axis_groups(mesh: Mesh, rules: dict | None = None,
                splits=()) -> list:
    """``mesh``'s axes in runs of neighbours that every rule of ``rules``
    and every tuple of axes in ``splits`` (the axes a dim is split over
    where the divisibility fallback of `parallel.axes.resolve` drops
    some of a rule's) names together or not at all (under the
    multipod's training rules, ``pod`` and ``data``: ``batch``, ``fsdp``
    and ``embed`` take both); each run is one dim of `device_mesh`'s
    DeviceMesh.  Without rules, one axis a run."""
    values = [set(v) for v in (rules or {}).values()]
    values += [set(v) for v in splits]
    groups = [[mesh.axis_names[0]]]
    for ax in mesh.axis_names[1:]:
        if rules and all((ax in v) == (groups[-1][-1] in v) for v in values):
            groups[-1].append(ax)
        else:
            groups.append([ax])
    return [tuple(g) for g in groups]


@contextlib.contextmanager
def device_mesh(mesh: Mesh, device_type: str = "cpu",
                rules: dict | None = None, splits=()):
    """A torch ``DeviceMesh`` of ``mesh``'s devices, for the enclosed
    scope; the process group it needs is started here and destroyed on
    exit, so no later test or phase inherits it.

    Its dims are `axis_groups` of ``rules`` and ``splits``, each named
    by its axes joined with ``"_"`` (``pod_data``): a dim of an array
    split over a group moves in one collective over the group, as in the
    reference's partitioned program, and DTensor plans over fewer mesh
    dims.  Every
    run of two or more of its dims is also flattened (``_flatten``), so
    that DTensor can move a dim split over several of them in one
    collective.

    A mesh of one device is one dim (``data_model`` for the host mesh)
    over a one-rank real group (``gloo`` on the CPU, ``nccl`` on the
    card; with every placement ``Replicate`` it issues no collective).
    A larger one runs over the ``"fake"`` group of ``mesh.size`` ranks,
    as rank 0: DTensor computes rank 0's local shards, and the
    collectives it issues return at once without moving data.  Raises if
    a default process group already exists.
    """
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if dist.is_initialized():
        raise RuntimeError("a default process group already exists; "
                           "device_mesh starts and ends its own")
    if mesh.size == 1:
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=mesh.size)
    try:
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        # one device: one dim (every spec resolves to P() on it)
        groups = ([tuple(mesh.axis_names)] if mesh.size == 1
                  else axis_groups(mesh, rules, splits))
        names = tuple("_".join(g) for g in groups)
        dm = DeviceMesh(device_type, torch.arange(mesh.size).reshape(
            [math.prod(sizes[ax] for ax in g) for g in groups]),
            mesh_dim_names=names)
        if mesh.size > 1:
            for i in range(len(names)):
                for j in range(i + 2, len(names) + 1):
                    dm[names[i:j]]._flatten("_".join(names[i:j]))
        yield dm
    finally:
        dist.destroy_process_group()
