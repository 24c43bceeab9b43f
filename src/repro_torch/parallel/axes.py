"""Logical-axis rules: logical axis names -> mesh axes, as pure logic.

The reference's ``parallel/axes.py`` without JAX.  Models name each
array dim with a *logical* axis; a launcher installs rules that map the
names onto the axes of a mesh (`launch.mesh`).  The same names resolve
on a 1x1 host mesh, the 16x16 ``pod`` or the (2, 16, 16) ``multipod``:
scaling the pod count is a change of rules, not of code.

Logical axes used across the framework:

* ``batch``    — data-parallel batch dim -> ('pod', 'data')
* ``fsdp``     — parameter / optimizer-state sharding (ZeRO-3) -> 'data'
  (+ 'pod' on the multi-pod mesh)
* ``embed``    — the d_model dim of a weight: 'fsdp' under training
  rules, kept 'data'-sharded (weights resident) under serving rules
* ``heads``    — attention-head tensor parallelism -> 'model'
* ``kv_heads`` — GQA KV heads -> 'model' *only if divisible*
* ``mlp``      — FFN hidden dim -> 'model'
* ``vocab``    — embedding / logits vocab dim -> 'model'
* ``experts``  — MoE expert dim -> 'model' if divisible (EP), else the
  per-expert ``mlp`` dim carries the TP (grok-style 8e on 16-way TP)
* ``seq`` / ``kv_seq`` — sequence-parallel activations / sharded KV cache
* ``state``    — SSM value-dim tensor parallelism (xLSTM / Mamba2)

`resolve` keeps every rule of the reference: a mesh axis whose size does
not divide the dim is dropped (replication instead of uneven sharding),
a mesh axis already taken by an earlier dim is not given again (the
first dim wins), trailing ``None`` entries are trimmed, and with no rules
installed every spec is ``P()``.  `resolve_tree` maps a spec tree to a
tree of `P` (the reference's ``spec_tree_to_shardings`` without the
``NamedSharding``).

**By design, not ported:** the SPMD annotations ``shard``,
``named_sharding`` and ``NamedSharding``, and with them the reference's
``models.common.serving_matmul`` and ``heads_tp_available`` (and the
``REPRO_NO_SP`` knob, which acts only through the latter).  Without a
mesh of devices they are the identity, which is what the reference does
without one, and the port has no partitioner that could give them a
meaning: it runs on one card.  The rules here price the production
meshes in `launch.dryrun` (each leaf's local shape and the weight
collectives).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Mapping, Sequence

_state = threading.local()


class P(tuple):
    """A partition spec: one entry per array dim, each ``None``, a mesh
    axis name, or a tuple of names (the dim split over several axes).
    ``tuple(P(...))`` equals ``tuple`` of the reference's ``P(...)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _rules() -> Mapping[str, tuple[str, ...]]:
    return getattr(_state, "rules", {})


def _mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def sharding_rules(mesh, rules: Mapping[str, Sequence[str]]):
    """Install logical->mesh axis rules (and the mesh whose axis sizes
    `resolve` divides by) for the enclosed scope, on this thread."""
    prev = (_mesh(), _rules())
    _state.mesh = mesh
    _state.rules = {k: tuple(v) if not isinstance(v, str) else (v,)
                    for k, v in rules.items()}
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


# ---------------------------------------------------------------------------
# rules presets


def single_pod_rules() -> dict:
    # kv_seq lists both axes: under the first-dim-wins dedup in
    # resolve(), a batch-sharded decode cache gets seq over 'model'
    # (flash-decoding split-KV), while the batch=1 long-context cell
    # gets seq over BOTH axes (256-way KV sharding).
    return dict(batch=("data",), fsdp=("data",), embed=("data",),
                heads=("model",), kv_heads=("model",), mlp=("model",),
                vocab=("model",), experts=("model",), seq=("model",),
                state=("model",), kv_seq=("data", "model"))


def multi_pod_rules() -> dict:
    r = single_pod_rules()
    r["batch"] = ("pod", "data")
    r["fsdp"] = ("pod", "data")
    r["embed"] = ("pod", "data")
    r["kv_seq"] = ("pod", "data", "model")
    return r


def serve_rules(multi_pod: bool = False) -> dict:
    """Weight-stationary serving layout.

    Training shards parameters over 'data' (ZeRO/FSDP) and gathers them
    again per layer, which a big batch amortises; at decode that moves
    the whole model across the mesh every step.  For serving the weights
    are sharded over both mesh axes and never gathered: 'fsdp' maps to
    nothing and the FFN / expert hidden dim takes the 'data' axis too.
    The ``__serving__`` key marks the preset (`serving_mode`).
    """
    r = single_pod_rules()
    r["fsdp"] = ()
    r["embed"] = ("data",)     # weights stay resident, 256-way with TP
    r["mlp"] = ("data", "model")
    r["state"] = ("data", "model")
    r["__serving__"] = ()          # mode marker, see serving_mode()
    if multi_pod:
        r["batch"] = ("pod", "data")
        r["kv_seq"] = ("pod", "data", "model")
        r["mlp"] = ("pod", "data", "model")
    return r


def serving_mode() -> bool:
    """True when the installed rules are the serving preset."""
    return "__serving__" in _rules()


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh (anything with ``axis_names`` and
    ``shape``, as `launch.mesh.Mesh`)."""
    return dict(zip(mesh.axis_names, mesh.shape))


def resolve(names: Sequence[str | None],
            shape: Sequence[int] | None = None) -> P:
    """Logical axis names -> `P` under the installed rules.

    With ``shape`` given, any mesh axis whose size does not divide the
    corresponding dim (what is left of it after the axes before) is
    dropped (replication fallback).
    """
    rules, mesh = _rules(), _mesh()
    if not rules:
        return P()
    sizes = axis_sizes(mesh) if mesh is not None else {}
    out, used = [], set()
    for i, name in enumerate(names):
        if name is None:
            out.append(None)
            continue
        axes = tuple(ax for ax in rules.get(name, ()) if ax not in used)
        if shape is not None and sizes:
            keep, dim = [], shape[i]
            for ax in axes:
                sz = sizes.get(ax, 1)
                if sz > 1 and dim % sz == 0:
                    keep.append(ax)
                    dim //= sz
            axes = tuple(keep)
        used.update(axes)
        out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def is_spec_leaf(x) -> bool:
    """A spec tree's leaf: a tuple of logical names (or ``None``), one
    per array dim (``()`` for a scalar)."""
    return isinstance(x, tuple) and all(
        isinstance(n, (str, type(None))) for n in x)


def _shape(x):
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def resolve_tree(spec_tree, shape_tree):
    """A tree of `P`, one per leaf of ``spec_tree`` (dicts whose leaves
    are tuples of logical names), each resolved against the matching
    leaf of ``shape_tree`` (tensors, meta tensors included, or shapes)
    under the installed rules."""
    if is_spec_leaf(spec_tree):
        return resolve(spec_tree, _shape(shape_tree))
    return {k: resolve_tree(v, shape_tree[k]) for k, v in spec_tree.items()}


def local_shape(spec: P, shape: Sequence[int], mesh) -> tuple:
    """One device's shape of an array of ``shape`` split by ``spec`` over
    ``mesh``: each dim divided by the sizes of the axes of its entry."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            out[i] //= sizes[ax]
    return tuple(out)
