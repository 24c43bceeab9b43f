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

The SPMD side runs on DTensor: `placements` turns a `P` into DTensor
placements over a torch ``DeviceMesh`` (`launch.mesh.device_mesh`),
`distribute_tree` makes each leaf of a tree a DTensor from its local
shard, and `shard` (the reference's ``with_sharding_constraint`` by
logical names) redistributes a DTensor to the resolved spec.  Without
rules, or on a plain tensor, `shard` is the identity, as the reference's
is without a mesh.  The reference's ``named_sharding`` and
``spec_tree_to_shardings`` have no counterpart: a DTensor carries its
placements itself.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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
    """{axis name: size} of a mesh: a `launch.mesh.Mesh` or a torch
    ``DeviceMesh``."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    return dict(zip(names, mesh.shape))


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


# ---------------------------------------------------------------------------
# DTensor


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` over the torch ``DeviceMesh``
    ``mesh``, one per mesh dim: ``Shard(i)`` on each mesh dim that
    splits array dim ``i``, ``Replicate()`` on the others.  A dim of the
    ``DeviceMesh`` may stand for a run of mesh axes, named by them joined
    with ``"_"`` (`launch.mesh.device_mesh`): an entry of ``spec`` must
    then name whole runs.

    A dim split over several mesh dims (``batch`` over ``("pod",
    "data")``, ``kv_seq`` over ``("data", "model")``) is split major to
    minor in the order the spec lists them, which DTensor does in mesh
    order: a spec that lists them otherwise raises.
    """
    names = list(mesh.mesh_dim_names)
    runs = [n.split("_") for n in names]
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        axes, dims = list(_axes(entry)), []
        while axes:
            run = next((d for d, r in enumerate(runs)
                        if r == axes[:len(r)]), None)
            if run is None or (dims and run < dims[-1]):
                raise ValueError(
                    f"{spec}: the axes {entry} of dim {i} are not whole runs "
                    f"of the mesh's dims {tuple(names)} in their order")
            dims.append(run)
            axes = axes[len(runs[run]):]
        for m in dims:
            out[m] = Shard(i)
    return out


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def distribute_tree(spec_tree, tree, mesh, device=None):
    """Each leaf of ``tree`` (tensors, meta tensors included) as a
    DTensor over the ``DeviceMesh`` ``mesh``, placed by its spec in
    ``spec_tree`` resolved under the installed rules and mesh.

    A leaf that the spec leaves whole (every placement ``Replicate``, as
    on the 1x1 host mesh) and that has storage is wrapped as it is: the
    DTensor holds its values.  Any other leaf gets a zero local shard of
    `local_shape` on ``device`` (default: the mesh's device type;
    ``"meta"``: shapes without storage).
    """
    if not is_spec_leaf(spec_tree):
        return {k: distribute_tree(v, tree[k], mesh, device)
                for k, v in spec_tree.items()}
    spec = resolve(spec_tree, tree.shape)
    shape = local_shape(spec, tree.shape, _mesh()) if spec else \
        tuple(tree.shape)
    if shape == tuple(tree.shape) and not tree.is_meta:
        local = tree
    else:
        local = torch.zeros(shape, dtype=tree.dtype,
                            device=device or mesh.device_type)
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=tree.shape,
                              stride=tree.stride())


#: the logical names of a weight's ZeRO-3 dims
FSDP_NAMES = ("fsdp", "embed")


def gather_fsdp(w, names: Sequence[str | None]):
    """ZeRO-3's gather: the DTensor weight ``w`` (logical ``names``)
    redistributed so that its ``fsdp`` / ``embed`` dims are whole, its
    other dims split as the rules say.  The reference's partitioner
    gathers an FSDP weight before each product that uses it; DTensor,
    left to choose per op, may move the activations instead.  Its
    backward brings the gradient back onto the shards.  The identity
    on a plain tensor, with no rules, and under the serving rules, whose
    weights stay resident (`models.common.serving_matmul`)."""
    if not is_dtensor(w) or not _rules() or serving_mode():
        return w
    spec = resolve(tuple(None if n in FSDP_NAMES else n for n in names),
                   w.shape)
    want = placements(spec, w.device_mesh)
    if list(w.placements) == want:
        return w
    return w.redistribute(w.device_mesh, want)


def reduce_partial(x):
    """``x`` with every pending partial sum (a ``Partial`` placement)
    all-reduced, its other placements kept: the reference's partitioner
    reduces a product's partial sums where they arise, where DTensor
    would carry them on and gather the next weight whole to multiply
    them.  The identity on a plain tensor."""
    if not is_dtensor(x):
        return x
    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in x.placements])


def einsum(eq: str, a, b, product=None):
    """``torch.einsum(eq, a, b)`` (or ``product(eq, a, b)``), on DTensors
    computed per rank with the placements stated, not chosen by DTensor:
    over each mesh dim, the label one operand splits is split in the
    other operand too where it has it (a local slice), the output is
    split on it where it keeps it, else the output is a ``Partial`` sum;
    an operand without the label gets a ``Partial`` gradient there.  Two
    operands splitting different labels over one mesh dim raise.  The
    same products run whichever torch version plans them, and no
    DTensor view of a split dim is needed.  On plain tensors the plain
    product."""
    product = product or torch.einsum
    if not is_dtensor(a):
        return product(eq, a, b)
    mesh = a.device_mesh
    ins, out = eq.split("->")
    la, lb = ins.split(",")

    def label(x, labels, p):
        if isinstance(p, Partial):
            raise ValueError(f"{eq}: an operand holds partial sums")
        return labels[p.dim % x.ndim] if isinstance(p, Shard) else None

    pa, pb, ga, gb, po = [], [], [], [], []
    for m, (xa, xb) in enumerate(zip(a.placements, b.placements)):
        sa, sb = label(a, la, xa), label(b, lb, xb)
        if sa and sb and sa != sb:
            raise ValueError(f"{eq}: mesh dim {m} splits {sa} and {sb}")
        lab = sa or sb
        if lab is None:
            pa.append(xa), pb.append(xb), ga.append(xa), gb.append(xb)
            po.append(Replicate())
            continue
        for labels, pl, gl in ((la, pa, ga), (lb, pb, gb)):
            if lab in labels:
                pl.append(Shard(labels.index(lab)))
                gl.append(pl[-1])
            else:
                pl.append(Replicate())
                gl.append(Partial())
        po.append(Shard(out.index(lab)) if lab in out else Partial())
    al = a.redistribute(mesh, pa).to_local(grad_placements=ga)
    bl = b.redistribute(mesh, pb).to_local(grad_placements=gb)
    return DTensor.from_local(product(eq, al, bl), mesh, po, run_check=False)


class _ReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_partial(g)


def reduce_grad_partial(x):
    """``x`` itself, whose gradient's partial sums are all-reduced in the
    backward pass where they arise: the transpose of `reduce_partial`.
    An activation that products over a split dim consume (the
    projections' input) gets a gradient of partial sums; the reference's
    partitioner reduces it at once, where DTensor would carry it into
    the next product and gather that product's other operand whole.
    The identity on a plain tensor or outside autograd."""
    if not is_dtensor(x) or not (torch.is_grad_enabled() and
                                 x.requires_grad):
        return x
    return _ReduceGrad.apply(x)


def shard(x, *names: str | None, shape=None):
    """The reference's ``shard``: ``x`` redistributed to the spec its
    logical ``names`` resolve to under the installed rules, against
    ``shape`` where given (default ``x.shape``).  The identity with no
    rules installed or on a plain tensor."""
    if not is_dtensor(x) or not _rules() or _mesh() is None:
        return x
    want = placements(resolve(names, shape or x.shape), x.device_mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
